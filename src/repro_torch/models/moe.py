"""Mixture-of-Experts FFN with sort-based capacity dispatch (PyTorch port of
``repro/models/moe.py``).

The same grouped local dispatch as the reference, token for token: the
``T`` tokens are cut into ``G`` groups, each group sorts its ``(token, k)``
choices by expert (stable), ranks them inside their expert, and scatters the
first ``Cg`` of each expert into a dense ``[E, Cg]`` buffer; the rest go to
an overflow row and are dropped (standard capacity-factor semantics).  The
reference ``vmap``s one group; here every step is one batched tensor
operation over ``[G, ...]`` (no Python loop over groups).  The expert
products are batched matrix products over ``[E, ...]``, as the reference
leaves them to XLA; the first-layer products are fp32 from bf16 operands, as
the reference's ``preferred_element_type`` keeps them.

On a mesh (``shard=``) a rank runs its block of the groups, as GSPMD
partitions the reference's ``moe:groups`` / ``moe:buffers`` constraints:
the dispatch and combine are all-to-alls over ``model`` (``plan.ep``), the
expert banks gathered over ``data`` at use (``runtime/sharding.py``).  The
kept and dropped choices are the one-rank run's: they depend on the groups,
never on the mesh.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..runtime.collectives import all_to_all, copy_to, gather, own_block
from .config import ModelConfig


_routing_log: list | None = None


@contextlib.contextmanager
def routing_log():
    """Inside: every :func:`moe_ffn` call appends ``(tag, first token,
    logits, experts)`` of the real tokens it routes: the index of its first
    token in the global ``(b, s)`` order, and the top ``K + 1`` router
    logits ``[n, K + 1]`` (fp32, in the softmax gates' order) with the
    experts, on the host.  The first ``K`` experts are the call's choices;
    the gap between neighbouring logits says how near a tie each choice
    was.  For checks that hold a mesh run's routing to one rank's; nothing
    is kept outside."""
    global _routing_log
    outer, _routing_log = _routing_log, []
    try:
        yield _routing_log
    finally:
        _routing_log = outer


def dispatch_shape(cfg: ModelConfig, T: int) -> tuple[int, int, int]:
    """(G groups, Tg tokens per group, Cg capacity per expert and group) for
    ``T`` tokens, as the reference computes them."""
    moe = cfg.moe
    G = min(moe.dispatch_groups, T)
    while T % G:
        G -= 1
    Tg = T // G
    return G, Tg, max(1, int(moe.capacity_factor * Tg * moe.top_k / moe.n_experts))


def _route(params, xf: torch.Tensor, cfg: ModelConfig):
    """xf [T,d] -> (gates [T,K] fp32, renormalised; sel [T,K] expert ids)."""
    logits = xf.float() @ params["router"]
    gates, sel = torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), sel


class _BmmFp32(torch.autograd.Function):
    """``bmm`` with an fp32 output from operands in their own dtype (CUDA
    only), which has no derivative of its own: the backward multiplies in
    fp32 and returns each gradient in its operand's dtype, as autograd of
    the CPU form below does."""

    @staticmethod
    def forward(ctx, xe, w):
        ctx.save_for_backward(xe, w)
        return torch.bmm(xe, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xe, w = ctx.saved_tensors
        return (torch.bmm(g, w.float().transpose(1, 2)).to(xe.dtype),
                torch.bmm(xe.float().transpose(1, 2), g).to(w.dtype))


def _products_fp32(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe [E, M, d] @ w [E, d, f] -> [E, M, f] fp32, from operands in their own
    dtype.  On the card a bf16 product accumulates and returns fp32 on the
    tensor cores (``bmm`` with ``out_dtype``, which exists only for CUDA); the
    CPU multiplies the operands cast to fp32, the same function up to the
    order of the sum.  Meta tensors (the dry-run) take the card's form."""
    if xe.device.type == "cpu":
        return torch.matmul(xe.float(), w.float())
    return _BmmFp32.apply(xe, w)


def _expert_hidden(params, xe: torch.Tensor, gated: bool) -> torch.Tensor:
    """xe [E, M, d] -> the fp32 hidden activations [E, M, f] of every expert."""
    h = _products_fp32(xe, params["w1"])
    if gated:
        return F.silu(h) * _products_fp32(xe, params["w3"])
    return F.gelu(h, approximate="tanh")


def _expert_ffn(params, xe: torch.Tensor, gated: bool) -> torch.Tensor:
    """xe [E, M, d] -> [E, M, d]: every expert on its own rows."""
    return torch.matmul(_expert_hidden(params, xe, gated).to(xe.dtype), params["w2"])


def _rank_groups(G: int, shard) -> tuple[int, int, int]:
    """(c, i, n): the groups a rank's block holds (``ceil(G / n)``; the last
    blocks padded, some perhaps empty), this rank's index and the ranks
    over ``moe:groups``' axes ``(*dp, "model")``."""
    if shard is None:
        return G, 0, 1
    n = shard.dp * shard.m
    return -(-G // n), shard.dpi * shard.m + shard.r, n


def _pad0(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` padded with zeros along dim 0 to ``n``."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])


def _block_tokens(xf: torch.Tensor, shard, rows: int, i: int, n: int, local: bool,
                  tag: str) -> torch.Tensor:
    """This rank's block of ``rows`` token rows (``[rows, d]``, padding rows
    zero) from its data slice's tokens ``xf`` (whole over ``model``; their
    gradient comes back whole on every model rank).  ``local``: every
    rank's block lies in its data slice, taken by ``own_block`` over
    ``model``; else the slices are gathered over the data axes first."""
    comm = shard.comm
    if local:
        return own_block(comm, _pad0(xf, shard.m * rows), dim=0, tag=f"{tag}:moe_tokens")
    xf = copy_to(comm, xf, tag=f"{tag}:moe_tokens")
    for axis in reversed(shard.plan.dp):
        xf = gather(comm, xf, dim=0, axis=axis, tag=f"{tag}:moe_tokens")
    return _pad0(xf, n * rows)[i * rows:(i + 1) * rows]


def _slice_tokens(out: torch.Tensor, shard, Tl: int, local: bool, wsp: bool,
                  tag: str) -> torch.Tensor:
    """The data slice's ``Tl`` token rows from every rank's block ``out``:
    gathered over ``model`` (and over the data axes where blocks cross the
    slices).  The gradient arriving is the same on every model rank (ISP:
    each keeps its block's) or a part on each (WSP: summed)."""
    comm = shard.comm
    out = gather(comm, out, dim=0, tag=f"{tag}:moe_out", grad="sum" if wsp else "own")
    if local:
        return out[:Tl]
    for axis in reversed(shard.plan.dp):
        out = gather(comm, out, dim=0, axis=axis, tag=f"{tag}:moe_out")
    return out[shard.dpi * Tl:(shard.dpi + 1) * Tl]


def _expert_weights(params, cfg: ModelConfig, shard, tag: str) -> dict:
    """The expert banks a rank multiplies by: under ``ep`` its experts with
    dim 1 all-gathered over ``data`` where it is cut (the FSDP gather, whose
    transpose reduce-scatters the gradient); without ``ep`` every expert,
    its ``d_ff`` all-gathered over ``model``."""
    names = [n for n in ("w1", "w2", "w3") if n in params]
    if shard is None:
        return {n: params[n] for n in names}
    comm = shard.comm
    if shard.plan.ep:
        whole = {"w1": cfg.d_model, "w3": cfg.d_model, "w2": cfg.moe.d_ff or cfg.d_ff}
        return {n: params[n] if params[n].shape[1] == whole[n] else
                gather(comm, params[n], dim=1, axis="data", tag=f"{tag}:{n}") for n in names}
    return {n: gather(comm, params[n], dim=1 if n == "w2" else 2, tag=f"{tag}:{n}")
            for n in names}


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, shard=None, wsp_seq: int | None = None,
            tag: str = "moe") -> torch.Tensor:
    """x [B,S,d] -> [B,S,d] through the top-k experts, capacity-limited per
    dispatch group.

    ``shard`` (a rank's :class:`~repro_torch.runtime.sharding.RankShard`):
    ``x`` is the rank's rows of the global batch (whole over ``model``), or
    in a WSP zone its positions of the ``wsp_seq``-long sequence, gathered
    here first (the padding dropped: it never reaches the router).  The
    groups are the reference's, over the global ``T = B S`` tokens in ``(b,
    s)`` order; the rank takes its block of them as ``moe:groups`` places
    them, ``P((*dp, "model"))`` (``ceil(G / n)`` each, a rank may hold
    none), and routes, sorts and drops per group as one rank does.  With
    ``plan.ep`` the dispatch is an all-to-all over ``model`` (every rank's
    blocks padded to one count), each rank's experts run on the rows of its
    data slice's groups, and the combine is the all-to-all back; without
    it the rank runs every expert on its own groups.  The outputs are
    gathered back to the rank's rows (or positions).  One rank is the same
    code with every collective left out."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dtype = x.dtype
    wsp = wsp_seq is not None
    if wsp:
        x = gather(shard.comm, x, dim=1, tag=f"{tag}:moe_in", grad="own")[:, :wsp_seq]
    B, S, d = x.shape
    Tl = B * S
    G, Tg, Cg = dispatch_shape(cfg, Tl * (1 if shard is None else shard.dp))
    c, i, n = _rank_groups(G, shard)
    Gl = max(0, min(c, G - i * c))              # the rank's real groups
    local = shard is None or shard.dp == 1 or G % n == 0
    xf = x.reshape(Tl, d)
    if shard is not None:
        xf = _block_tokens(xf, shard, c * Tg, i, n, local, tag)
    xf = xf[:Gl * Tg]
    gates, sel = _route(params, xf, cfg)
    if _routing_log is not None:
        with torch.no_grad():
            top = torch.topk(xf.float() @ params["router"], min(K + 1, E), dim=-1)
        _routing_log.append((tag, i * c * Tg, top.values.cpu(),
                             torch.cat([sel, top.indices[:, K:]], dim=1).cpu()))

    # Per group: sort the Tg*K choices by expert, rank each inside its expert,
    # then hand each choice (in choice order, token-major) its slot.
    dev = x.device
    sel_g = sel.reshape(Gl, Tg * K)
    order = torch.argsort(sel_g, dim=1, stable=True)
    sel_sorted = torch.gather(sel_g, 1, order)
    counts = torch.zeros(Gl, E, dtype=torch.int64, device=dev).scatter_add_(
        1, sel_g, torch.ones_like(sel_g))
    start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(Tg * K, device=dev) - torch.gather(start, 1, sel_sorted)
    slot_sorted = torch.where(pos < Cg, sel_sorted * Cg + pos, E * Cg)   # E*Cg: overflow row
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)

    # Scatter into [G, E*Cg + 1, d], experts on [E, G*Cg, d], and back.
    gi = torch.arange(Gl, device=dev)[:, None]
    buf = xf.new_zeros(Gl, E * Cg + 1, d)
    buf[gi, slot] = xf.reshape(Gl, Tg, d).repeat_interleave(K, dim=1)
    eb = buf[:, :E * Cg].reshape(Gl, E, Cg, d)
    ep = shard is not None and shard.plan.ep
    if ep:      # dispatch: [c groups, E, ...] -> [m c groups of the slice, this rank's E / m, ...]
        eb = all_to_all(shard.comm, _pad0(eb, c), split_dim=1, concat_dim=0,
                        tag=f"{tag}:dispatch")
    Gr, El = eb.shape[:2]
    xe = eb.transpose(0, 1).reshape(El, Gr * Cg, d)
    out_e = _expert_ffn(_expert_weights(params, cfg, shard, tag), xe, cfg.ffn_gated)
    og = out_e.reshape(El, Gr, Cg, d).transpose(0, 1)
    if ep:      # combine: the all-to-all back
        og = all_to_all(shard.comm, og.contiguous(), split_dim=0, concat_dim=1,
                        tag=f"{tag}:combine")[:Gl]
    og = og.reshape(Gl, E * Cg, d)
    og = torch.cat([og, og.new_zeros(Gl, 1, d)], dim=1)   # the overflow row reads zeros
    # Every token has exactly K choices: sum them in a fixed order (no atomics).
    contrib = og[gi, slot] * gates.reshape(Gl, Tg * K, 1).to(dtype)
    out = contrib.reshape(Gl * Tg, K, d).sum(1)
    if shard is None:
        return out.reshape(B, S, d)
    out = _slice_tokens(_pad0(out, c * Tg), shard, Tl, local, wsp, tag).reshape(B, S, d)
    return shard.own_positions(out) if wsp else out


def moe_ffn_dense_fallback(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every-token-through-every-expert oracle (tests only: exact, slow).  As
    in the reference, the per-expert outputs stay fp32 (the second product
    of the hidden activations, cast to x's dtype, returns fp32) and only the
    combined sum is cast to x's dtype."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, sel = _route(params, xf, cfg)
    hidden = _expert_hidden(params, xf.expand(cfg.moe.n_experts, -1, -1), cfg.ffn_gated)
    per_e = _products_fp32(hidden.to(x.dtype), params["w2"])          # [E, T, d] fp32
    w = torch.zeros(xf.shape[0], cfg.moe.n_experts, device=x.device).scatter_add_(
        1, sel, gates)                                    # [T, E]
    out = torch.einsum("etd,te->td", per_e, w)
    return out.reshape(B, S, d).to(x.dtype)
