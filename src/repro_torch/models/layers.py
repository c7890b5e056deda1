"""Shared primitive layers (PyTorch port of ``repro/models/layers.py``).

Weights keep the JAX layout ``[d_in, d_out]``, so ``dense`` is ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> (cos, sin) of shape [..., head_dim//2], fp32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n, head_dim]; cos/sin [..., S, head_dim//2] (half-split form)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d_in] @ [d_in, d_out] in x's dtype.

    ``torch.matmul`` accumulates bf16 products in fp32 and rounds the result
    once, as the reference's ``preferred_element_type=float32`` then cast does;
    like the reference (which leaves it to XLA) this is no hand-written kernel.
    """
    return torch.matmul(x, w)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def ffn(params: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        h = F.silu(dense(x, params["w1"])) * dense(x, params["w3"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, params["w1"]), approximate="tanh")
    return dense(h, params["w2"])
