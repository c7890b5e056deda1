"""The collectives a rank-local model issues, each one recorded.

The reference leaves its collectives to GSPMD and counts them afterwards in
the compiled HLO (``repro/launch/hlo_analysis.collective_stats``).  The
port's rank-local model (``runtime/sharding.py``, ``models/``) issues them
itself, through one :class:`Collectives` per mesh, which counts every
call and its bytes by kind, axis and tag as it goes (a bounded tally, so a
serving loop may run on with it).  The bytes are the reference's
measure: those of each op's *result* (an all-gather's gathered tensor, an
all-reduce's tensor, a reduce-scatter's shard), in the result's dtype.

Routes:

* ``"dist"``: ``torch.distributed`` over the mesh axis's process group.
  With ``stage`` (gloo and tensors on a card) each call moves its tensor to
  the host and back; gloo has no reduce-scatter, so that one runs as an
  all-reduce and keeps this rank's block (recorded as the reduce-scatter it
  stands for).  An all-reduce of 16-bit floats sums in fp32.
* ``"meta"``: records and returns a meta tensor of the result's shape; sends
  nothing (the dry-run's rank on the meta device).

A collective over an axis of size 1 is no collective: the tensor comes back
as it went in and nothing is recorded.
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
    """All-reduce, all-gather and reduce-scatter over the axes of one rank's
    mesh; ``calls`` maps ``(kind, axis, tag)`` to ``[calls, bytes]`` since
    the last :meth:`reset` (kind ``"all-gather"``, ``"all-reduce"`` or
    ``"reduce-scatter"``; tag the caller's)."""

    def __init__(self, sizes: dict[str, int], groups: dict, route: str = "dist",
                 stage: bool = False):
        if route not in ("dist", "meta"):
            raise ValueError(f"route {route!r}: 'dist' or 'meta'")
        self.sizes = dict(sizes)
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
        return x.cpu() if self.stage else x

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
        parts = [torch.empty_like(view) for _ in range(n)]
        dist.all_gather(parts, view, group=self.groups[axis])
        out = torch.cat(parts, dim=dim)
        return self._back(out.view(src.dtype) if raw else out, x)

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
