"""Plain PyTorch WKV-6 recurrence (port of ``repro/kernels/rwkv6/ref.py``).

The CPU path of :func:`..ops.wkv6` and the oracle the CUDA kernel is held
against on the card: the sequential recurrence, token by token, in fp32
(float64 inputs stay float64, the yardstick for fp32 rounding).
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u):
    """r,k,v,logw [B,H,S,hd]; u [H,hd] -> (out [B,H,S,hd], S_last [B,H,hd,hd]), fp32.

    Per head, from a zero state: ``out_t = r_t . (S + (u * k_t) v_t^T)``,
    ``S = diag(exp(logw_t)) S + k_t v_t^T``.
    """
    B, H, S, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    r, k, v, u = (x.to(dt) for x in (r, k, v, u))
    w = torch.exp(logw.to(dt))
    state = torch.zeros(B, H, hd, hd, dtype=dt, device=r.device)
    out = torch.empty(B, H, S, hd, dtype=dt, device=r.device)
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        out[:, :, t] = torch.einsum("bhi,bhij->bhj", r[:, :, t], state + u[None, :, :, None] * kv)
        state = w[:, :, t, :, None] * state + kv
    return out, state
