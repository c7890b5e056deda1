"""The collectives a rank-local model issues, each one recorded.

The reference leaves its collectives to GSPMD and counts them afterwards in
the compiled HLO (``repro/launch/hlo_analysis.collective_stats``).  The
port's rank-local model (``runtime/sharding.py``, ``models/``) issues them
itself, through one :class:`Collectives` per mesh, which counts every
call and its bytes by kind, axis and tag as it goes (a bounded tally, so a
serving loop may run on with it).  The bytes are the reference's
measure: those of each op's *result* (an all-gather's gathered tensor, an
all-reduce's tensor, a reduce-scatter's shard, an all-to-all's received
blocks, a collective-permute's received tensor), in the result's dtype.

Routes:

* ``"dist"``: ``torch.distributed`` over the mesh axis's process group.
  With ``stage`` (gloo and tensors on a card) each call moves its tensor to
  page-locked host memory and back; gloo has no reduce-scatter, so that one runs as an
  all-reduce and keeps this rank's block (recorded as the reduce-scatter it
  stands for).  An all-reduce of 16-bit floats sums in fp32.
* ``"meta"``: records and returns a meta tensor of the result's shape; sends
  nothing (the dry-run's rank on the meta device).

A collective over an axis of size 1 is no collective: the tensor comes back
as it went in and nothing is recorded.

The train step differentiates through them.  GSPMD derives the reference's
transposes; the port writes them here, as autograd functions over a
:class:`Collectives`, one for each way the gradient arriving at a call site
lies (Megatron's f / g pairs, and their sequence-parallel forms):

* :func:`sum_over`: all-reduce forward, identity backward (the gradient
  arriving is the same on every rank: a row-parallel product's output);
* :func:`copy_to`: identity forward, all-reduce backward (a replicated input
  entering a column-parallel product, whose gradient each rank holds a part
  of);
* :func:`gather` with ``grad="sum"``: all-gather forward, reduce-scatter
  backward (a weight gathered at use, the keys and values of other
  positions, the sequence before a vocab-parallel head: partial gradients);
  with ``grad="own"``: the backward keeps this rank's block (the gradient
  is the same on every rank, as after the WSP -> ISP transition);
* :func:`scatter_sum`: reduce-scatter forward, all-gather backward;
* :func:`own_block`: this rank's block forward, all-gather backward (a
  replicated tensor cut into the ranks' positions);
* :func:`all_to_all`: all-to-all forward, the all-to-all back backward
  (its split and concatenated dims swapped: MoE's dispatch and combine).

Each backward's collective is recorded under its forward's tag with
``":grad"`` appended.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.tensor([], dtype=dtype).element_size()


class Collectives:
    """All-reduce, all-gather, reduce-scatter, all-to-all and permute over
    the axes of one rank's mesh, whose coordinate on each axis is ``index``;
    ``calls`` maps ``(kind, axis, tag)`` to ``[calls, bytes]`` since the
    last :meth:`reset` (kind ``"all-gather"``, ``"all-reduce"``,
    ``"reduce-scatter"``, ``"all-to-all"`` or ``"collective-permute"``; tag
    the caller's)."""

    def __init__(self, sizes: dict[str, int], groups: dict, route: str = "dist",
                 stage: bool = False, index: dict[str, int] | None = None):
        if route not in ("dist", "meta"):
            raise ValueError(f"route {route!r}: 'dist' or 'meta'")
        self.sizes = dict(sizes)
        self.index = dict(index or {a: 0 for a in sizes})
        self.groups = groups
        self.route = route
        self.stage = stage
        self.calls: dict[tuple[str, str, str], list[int]] = {}

    def reset(self) -> None:
        self.calls = {}

    def stats(self) -> dict:
        """``{"bytes_by_kind", "count_by_kind"}`` of the calls, as the
        reference's ``CollectiveStats``."""
        by_bytes: dict[str, int] = {}
        by_count: dict[str, int] = {}
        for (kind, _, _), (n, b) in self.calls.items():
            by_bytes[kind] = by_bytes.get(kind, 0) + b
            by_count[kind] = by_count.get(kind, 0) + n
        return {"bytes_by_kind": by_bytes, "count_by_kind": by_count}

    # ------------------------------------------------------------ plumbing

    def _size(self, axis: str) -> int:
        if axis not in self.sizes:
            raise ValueError(f"no mesh axis {axis!r} in {tuple(self.sizes)}")
        return self.sizes[axis]

    def _record(self, kind, axis, tag, shape, dtype) -> None:
        tally = self.calls.setdefault((kind, axis, tag), [0, 0])
        tally[0] += 1
        tally[1] += _nbytes(shape, dtype)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself, or with ``stage`` a copy in page-locked host memory
        (the card's copy engines move it without an extra host pass)."""
        if not self.stage:
            return x
        out = self._empty(x.shape, x.dtype, x)
        out.copy_(x)
        return out

    def _empty(self, shape, dtype, like: torch.Tensor) -> torch.Tensor:
        """A buffer the backend sends from or receives into: on ``like``'s
        device (a card's under NCCL), or with ``stage`` in page-locked host
        memory."""
        if self.stage:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    def _back(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(like.device, non_blocking=False) if self.stage else y

    # --------------------------------------------------------- collectives

    def all_reduce(self, x: torch.Tensor, axis: str = "model", op: str = "sum",
                   tag: str = "") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of ``x`` over the ranks of
        ``axis``, on every one of them (a new tensor)."""
        n = self._size(axis)
        if n == 1:
            return x
        self._record("all-reduce", axis, tag, x.shape, x.dtype)
        if self.route == "meta":
            return torch.empty_like(x)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        y = self._host(x)
        if x.dtype in (torch.bfloat16, torch.float16):
            y = y.float()
        elif y is x:
            y = y.clone()
        dist.all_reduce(y, op=red, group=self.groups[axis])
        return self._back(y, x).to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = 0, axis: str = "model",
                   tag: str = "") -> torch.Tensor:
        """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in the
        axis's order, on every one of them."""
        n = self._size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] *= n
        self._record("all-gather", axis, tag, shape, x.dtype)
        if self.route == "meta":
            return x.new_empty(shape)
        src = self._host(x).contiguous()
        # 16-bit floats travel as their bytes (every backend gathers uint8)
        raw = src.is_floating_point() and src.element_size() == 2 and src.dim() > 0
        view = src.view(torch.uint8) if raw else src
        parts = [self._empty(view.shape, view.dtype, x) for _ in range(n)]
        dist.all_gather(parts, view, group=self.groups[axis])
        # joined on x's device (with ``stage`` the parts cross back one by one)
        parts = [self._back(p.view(src.dtype) if raw else p, x) for p in parts]
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0, axis: str = "model",
                       tag: str = "") -> torch.Tensor:
        """Block ``i`` (along ``dim``, ``x.shape[dim] / n`` wide) of the sum of
        the ranks' ``x`` over ``axis``, on the axis's rank ``i``."""
        n = self._size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        if x.shape[dim] % n:
            raise ValueError(f"reduce-scatter of {tuple(x.shape)} along dim {dim} over {n} "
                             "ranks: the dim is no multiple of the ranks")
        shape = list(x.shape)
        shape[dim] //= n
        self._record("reduce-scatter", axis, tag, shape, x.dtype)
        if self.route == "meta":
            return x.new_empty(shape)
        group = self.groups[axis]
        me = dist.get_group_rank(group, dist.get_rank())
        wide = x.dtype in (torch.bfloat16, torch.float16)
        src = self._host(x).float() if wide else self._host(x)
        if dist.get_backend(group) == "gloo":
            y = src.clone() if src is x else src
            dist.all_reduce(y, group=group)
            out = y.narrow(dim, me * shape[dim], shape[dim]).contiguous()
        else:
            moved = src.movedim(dim, 0).contiguous()
            out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
            dist.reduce_scatter_tensor(out, moved, group=group)
            out = out.movedim(0, dim).contiguous()
        return self._back(out, x).to(x.dtype)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int, axis: str = "model",
                   tag: str = "") -> torch.Tensor:
        """``x`` cut into ``n`` equal blocks along ``split_dim``, block ``j``
        sent to the axis's rank ``j``; the blocks arriving from ranks ``0 ..
        n - 1`` concatenated along ``concat_dim`` (a new tensor, ``split_dim``
        ``n`` times narrower, ``concat_dim`` ``n`` times wider).  Every rank
        sends and receives blocks of one shape: a caller with uneven parts
        pads them.  Recorded with the bytes of the result."""
        n = self._size(axis)
        if n == 1:
            return x
        split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
        if x.shape[split_dim] % n:
            raise ValueError(f"all-to-all of {tuple(x.shape)} split along dim {split_dim} over "
                             f"{n} ranks: the dim is no multiple of the ranks")
        block = list(x.shape)
        block[split_dim] //= n
        shape = list(block)
        shape[concat_dim] *= n
        self._record("all-to-all", axis, tag, shape, x.dtype)
        if self.route == "meta":
            return x.new_empty(shape)
        # the blocks to send side by side on a leading dim, in the ranks' order
        # (arranged on x's device; with ``stage`` only the contiguous blocks
        # cross to the host and back)
        send = x.unflatten(split_dim, (n, block[split_dim])).movedim(split_dim, 0).contiguous()
        send = self._host(send)
        # 16-bit floats travel as their bytes, as all_gather sends them
        raw = send.is_floating_point() and send.element_size() == 2
        view = send.view(torch.uint8) if raw else send
        recv = self._empty(view.shape, view.dtype, x)
        dist.all_to_all_single(recv, view, group=self.groups[axis])
        recv = self._back(recv.view(send.dtype) if raw else recv, x)
        return torch.cat(list(recv.unbind(0)), dim=concat_dim)

    def permute(self, x: torch.Tensor, axis: str, pairs, tag: str = "") -> torch.Tensor | None:
        """``jax.lax.ppermute`` over ``axis``: for each ``(src, dst)`` of
        ``pairs`` (coordinates on the axis; each at most once a source and
        once a destination) the ``x`` of rank ``src`` arrives at rank
        ``dst``.  Returns what this rank receives, a new tensor of ``x``'s
        shape and dtype, or ``None`` where no pair ends here (ppermute's
        zeros, left out).  A receiving rank's ``x`` gives only the shape and
        dtype.  Recorded on each receiving rank, with the bytes it receives."""
        n = self._size(axis)
        pairs = [(int(s), int(d)) for s, d in pairs]
        for end in (0, 1):
            ranks = [p[end] for p in pairs]
            if len(set(ranks)) != len(ranks) or not all(0 <= r < n for r in ranks):
                raise ValueError(f"permute pairs {pairs} over the {n} ranks of {axis!r}: "
                                 "each rank at most once a source and once a destination")
        me = self.index[axis]
        dst = next((d for s, d in pairs if s == me), None)
        src = next((s for s, d in pairs if d == me), None)
        if src == me:                        # a rank's edge to itself moves nothing
            return x
        if src is None and dst is None:
            return None
        if src is not None:
            self._record("collective-permute", axis, tag, x.shape, x.dtype)
        if self.route == "meta":
            return None if src is None else torch.empty_like(x)
        group = self.groups[axis]
        # 16-bit floats travel as their bytes, as all_gather sends them
        raw = x.is_floating_point() and x.element_size() == 2 and x.dim() > 0
        works, buf = [], None
        if src is not None:
            shape = (*x.shape[:-1], 2 * x.shape[-1]) if raw else x.shape
            buf = self._empty(shape, torch.uint8 if raw else x.dtype, x)
            works.append(dist.irecv(buf, src=dist.get_global_rank(group, src), group=group))
        if dst is not None:
            out = self._host(x.detach()).contiguous()
            works.append(dist.isend(out.view(torch.uint8) if raw else out,
                                    dst=dist.get_global_rank(group, dst), group=group))
        for w in works:
            w.wait()
        if buf is None:
            return None
        return self._back(buf.view(x.dtype) if raw else buf, x)


# ------------------------------------------------- collectives with gradients

def _grad_tag(tag: str) -> str:
    return f"{tag}:grad"


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, tag):
        return comm.all_reduce(x, axis=axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, tag):
        ctx.args = (comm, axis, tag)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        comm, axis, tag = ctx.args
        return comm.all_reduce(g, axis=axis, tag=_grad_tag(tag)), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axis, tag, grad):
        ctx.args = (comm, dim, axis, tag, grad, x.shape[dim])
        return comm.all_gather(x, dim=dim, axis=axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        comm, dim, axis, tag, grad, n = ctx.args
        if grad == "sum":
            g = comm.reduce_scatter(g, dim=dim, axis=axis, tag=_grad_tag(tag))
        else:
            g = g.narrow(dim, comm.index[axis] * n, n)
        return g, None, None, None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axis, tag):
        ctx.args = (comm, dim, axis, tag)
        return comm.reduce_scatter(x, dim=dim, axis=axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        comm, dim, axis, tag = ctx.args
        return comm.all_gather(g, dim=dim, axis=axis, tag=_grad_tag(tag)), None, None, None, None


class _OwnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axis, tag):
        ctx.args = (comm, dim, axis, tag)
        n = x.shape[dim] // comm.sizes[axis]
        return x.narrow(dim, comm.index[axis] * n, n)

    @staticmethod
    def backward(ctx, g):
        comm, dim, axis, tag = ctx.args
        return comm.all_gather(g, dim=dim, axis=axis, tag=_grad_tag(tag)), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim, axis, tag):
        ctx.args = (comm, split_dim, concat_dim, axis, tag)
        return comm.all_to_all(x, split_dim, concat_dim, axis=axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        comm, split_dim, concat_dim, axis, tag = ctx.args
        return (comm.all_to_all(g, concat_dim, split_dim, axis=axis, tag=_grad_tag(tag)),
                None, None, None, None, None)


def sum_over(comm: Collectives, x: torch.Tensor, axis: str = "model", tag: str = "") -> torch.Tensor:
    """All-reduce (sum) of ``x`` over ``axis``; its gradient passes through
    unchanged (each rank receives the whole gradient of the sum)."""
    return x if comm.sizes.get(axis, 1) == 1 else _SumOver.apply(x, comm, axis, tag)


def copy_to(comm: Collectives, x: torch.Tensor, axis: str = "model", tag: str = "") -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axis`` (each rank's
    column-parallel product gives a part of it)."""
    return x if comm.sizes.get(axis, 1) == 1 else _CopyTo.apply(x, comm, axis, tag)


def gather(comm: Collectives, x: torch.Tensor, dim: int, axis: str = "model", tag: str = "",
           grad: str = "sum") -> torch.Tensor:
    """All-gather of ``x`` along ``dim`` over ``axis``.  ``grad="sum"``: the
    gradient arriving is a part on each rank, reduce-scattered back to this
    rank's block; ``grad="own"``: it is the same on every rank, and this
    rank's block is kept."""
    if grad not in ("sum", "own"):
        raise ValueError(f"grad {grad!r}: 'sum' or 'own'")
    if comm.sizes.get(axis, 1) == 1:
        return x
    return _Gather.apply(x, comm, dim % x.dim(), axis, tag, grad)


def scatter_sum(comm: Collectives, x: torch.Tensor, dim: int, axis: str = "model",
                tag: str = "") -> torch.Tensor:
    """Reduce-scatter of ``x`` along ``dim`` over ``axis``; the gradient of
    this rank's block is all-gathered back."""
    if comm.sizes.get(axis, 1) == 1:
        return x
    return _ScatterSum.apply(x, comm, dim % x.dim(), axis, tag)


def own_block(comm: Collectives, x: torch.Tensor, dim: int, axis: str = "model",
              tag: str = "") -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim`` (a multiple of
    the ranks); the blocks' gradients are all-gathered back."""
    n = comm.sizes.get(axis, 1)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"block of {tuple(x.shape)} along dim {dim} over {n} ranks: the dim "
                         "is no multiple of the ranks")
    return _OwnBlock.apply(x, comm, dim % x.dim(), axis, tag)


def all_to_all(comm: Collectives, x: torch.Tensor, split_dim: int, concat_dim: int,
               axis: str = "model", tag: str = "") -> torch.Tensor:
    """:meth:`Collectives.all_to_all` of ``x``; its gradient goes back by the
    all-to-all with the two dims swapped (each block's gradient returns to
    the rank that sent the block)."""
    if comm.sizes.get(axis, 1) == 1:
        return x
    return _AllToAll.apply(x, comm, split_dim % x.dim(), concat_dim % x.dim(), axis, tag)
