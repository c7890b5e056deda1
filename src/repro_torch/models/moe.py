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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig


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


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x [B,S,d] -> [B,S,d] through the top-k experts, capacity-limited per
    dispatch group."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    B, S, d = x.shape
    T = B * S
    G, Tg, Cg = dispatch_shape(cfg, T)
    xf = x.reshape(T, d)
    gates, sel = _route(params, xf, cfg)

    # Per group: sort the Tg*K choices by expert, rank each inside its expert,
    # then hand each choice (in choice order, token-major) its slot.
    dev = x.device
    sel_g = sel.reshape(G, Tg * K)
    order = torch.argsort(sel_g, dim=1, stable=True)
    sel_sorted = torch.gather(sel_g, 1, order)
    counts = torch.zeros(G, E, dtype=torch.int64, device=dev).scatter_add_(
        1, sel_g, torch.ones_like(sel_g))
    start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(Tg * K, device=dev) - torch.gather(start, 1, sel_sorted)
    slot_sorted = torch.where(pos < Cg, sel_sorted * Cg + pos, E * Cg)   # E*Cg: overflow row
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)

    # Scatter into [G, E*Cg + 1, d], experts on [E, G*Cg, d], and back.
    gi = torch.arange(G, device=dev)[:, None]
    buf = x.new_zeros(G, E * Cg + 1, d)
    buf[gi, slot] = xf.reshape(G, Tg, d).repeat_interleave(K, dim=1)
    xe = buf[:, :E * Cg].reshape(G, E, Cg, d).transpose(0, 1).reshape(E, G * Cg, d)
    out_e = _expert_ffn(params, xe, cfg.ffn_gated)
    og = out_e.reshape(E, G, Cg, d).transpose(0, 1).reshape(G, E * Cg, d)
    og = torch.cat([og, x.new_zeros(G, 1, d)], dim=1)     # the overflow row reads zeros
    # Every token has exactly K choices: sum them in a fixed order (no atomics).
    contrib = og[gi, slot] * gates.reshape(G, Tg * K, 1).to(x.dtype)
    out = contrib.reshape(T, K, d).sum(1)
    return out.reshape(B, S, d)


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
