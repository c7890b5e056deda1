"""Mamba-1 selective-state-space block (PyTorch port of ``repro/models/ssm.py``).

Prefill runs the scan through :func:`repro_torch.kernels.mamba.ops.mamba_scan`
-- the hand-written CUDA kernel on the card, its plain version on the CPU --
from a zero state.  The kernel forms the decay ``exp(dt A)`` and the input
``dt x B`` itself, so the ``[B,S,d_inner,N]`` tensors of the reference's
chunked scan are never built, and it takes any ``S`` (the reference shrinks
its chunk until it divides ``S``).  Decode is one plain state update.

State cache for serving: {"h": [B, d_inner, N] fp32, "conv": [B, d_conv-1, d_inner]}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba.ops import mamba_scan
from ..kernels.mamba.ref import scan_step
from .config import ModelConfig
from .layers import dense


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, init_state=None):
    """Depthwise causal conv along S.  x [B,S,di], w [d_conv, di].

    Returns (out [B,S,di], the last ``d_conv - 1`` rows of the padded input,
    which is the state for the next call)."""
    d_conv = w.shape[0]
    if init_state is None:
        pad = x.new_zeros(x.shape[0], d_conv - 1, x.shape[2])
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, d_conv):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(d_conv - 1):] if d_conv > 1 else pad
    return out + b, new_state


def _ssm_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,di] -> (dt [B,S,di] fp32, A [di,N] fp32, Bc, Cc [B,S,N]).

    The reference's ``_ssm_params`` up to the decay and input terms, which
    the kernel forms itself.  ``Bc`` and ``Cc`` are column slices of the
    ``x_proj`` output in x's dtype (views, no copy).
    """
    N = cfg.mamba_d_state
    R = params["dt_proj"].shape[0]
    dt_r, Bc, Cc = dense(x, params["x_proj"]).split([R, N, N], dim=-1)
    dt = F.softplus(dense(dt_r, params["dt_proj"]).float() + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"]), Bc, Cc


def _in_proj(params, x: torch.Tensor, cfg: ModelConfig, conv_state=None):
    xi, z = dense(x, params["in_proj"]).chunk(2, dim=-1)
    xi, conv_state = _causal_conv(xi, params["conv_w"], params["conv_b"], conv_state)
    return F.silu(xi), z, conv_state


def _out_proj(params, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    return dense((y * F.silu(z.float())).to(dtype), params["out_proj"])


def mamba_prefill(params, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,d] -> (out [B,S,d], {"h", "conv"}), from a zero state."""
    xi, z, conv_state = _in_proj(params, x, cfg)
    dt, A, Bc, Cc = _ssm_inputs(params, xi, cfg)
    y, h_last = mamba_scan(dt, xi, A, Bc, Cc, params["D"])
    return _out_proj(params, y, z, x.dtype), {"h": h_last, "conv": conv_state}


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """Single-token step from ``state`` {"h", "conv"}.  x [B,1,d] ->
    (out [B,1,d], new {"h", "conv"})."""
    xi, z, conv_state = _in_proj(params, x, cfg, state["conv"])
    dt, A, Bc, Cc = _ssm_inputs(params, xi, cfg)
    x0 = xi[:, 0].float()
    h, y = scan_step(state["h"], dt[:, 0], x0, A, Bc[:, 0].float(), Cc[:, 0].float())
    y = (y + params["D"] * x0)[:, None]
    return _out_proj(params, y, z, x.dtype), {"h": h, "conv": conv_state}
