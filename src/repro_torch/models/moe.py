"""Mixture-of-Experts FFN with sort-based capacity dispatch (PyTorch port of
``repro/models/moe.py``).

The same grouped local dispatch as the reference, token for token: the
``T`` tokens are cut into ``G`` groups, each group sorts its ``(token, k)``
choices by expert (stable), ranks them inside their expert, and scatters the
first ``Cg`` of each expert into a dense ``[E, Cg]`` buffer; the rest go to
an overflow row and are dropped (standard capacity-factor semantics).  The
reference ``vmap``s one group; here every step is one batched tensor
operation over ``[G, ...]`` (no Python loop over groups).  The expert
products are batched ``torch.matmul`` over ``[E, ...]``, as the reference
leaves them to XLA.

One rounding differs in bf16: the reference keeps the first-layer products
``h`` in fp32 (``preferred_element_type``); ``torch.matmul`` rounds them to
bf16 before the fp32 silu and product.  In fp32 the two are the same.
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


def _expert_ffn(params, xe: torch.Tensor, gated: bool) -> torch.Tensor:
    """xe [E, M, d] -> [E, M, d]: every expert on its own rows."""
    h = torch.matmul(xe, params["w1"]).float()
    if gated:
        h = F.silu(h) * torch.matmul(xe, params["w3"]).float()
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h.to(xe.dtype), params["w2"])


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
    """Every-token-through-every-expert oracle (tests only: exact, slow)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, sel = _route(params, xf, cfg)
    per_e = _expert_ffn(params, xf.expand(cfg.moe.n_experts, -1, -1), cfg.ffn_gated)
    w = torch.zeros(xf.shape[0], cfg.moe.n_experts, device=x.device).scatter_add_(
        1, sel, gates)                                    # [T, E]
    out = torch.einsum("etd,te->td", per_e.float(), w)
    return out.reshape(B, S, d).to(x.dtype)
