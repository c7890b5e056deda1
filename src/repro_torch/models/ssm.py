"""Mamba-1 selective-state-space block (PyTorch port of ``repro/models/ssm.py``).

Prefill runs the scan through :func:`repro_torch.kernels.mamba.ops.mamba_scan`
-- the hand-written CUDA kernel on the card, its plain version on the CPU --
from a zero state.  The kernel forms the decay ``exp(dt A)`` and the input
``dt x B`` itself, so the ``[B,S,d_inner,N]`` tensors of the reference's
chunked scan are never built, and it takes any ``S`` (the reference shrinks
its chunk until it divides ``S``).  Decode is one plain state update.

State cache for serving: {"h": [B, d_inner, N] fp32, "conv": [B, d_conv-1, d_inner]}.

On a model axis (``shard``, a :class:`~repro_torch.runtime.sharding.RankShard`)
a rank holds a block of the channels: its columns of ``in_proj``'s x half and
z half (``runtime/sharding.Spans``), of ``conv_w`` / ``dt_proj``, its rows
of ``x_proj`` / ``A_log`` / ``out_proj``, its entries of ``conv_b`` /
``dt_bias`` / ``D``, and its channels of ``h`` / ``conv``; the scan runs
on them.  ``x_proj`` is row-parallel and every rank uses all of its output
(dt's rank and B, C) on its own channels, so the partial sums are added
over the ranks both ways (the gradient arriving is a part on each rank
too).  ``out_proj`` ends in its partial sums added over the ranks, or, under
``wsp_seq`` (the input is the rank's positions of a WSP zone of that many
positions, gathered first: the scan needs every earlier position; the
padding left out), reduce-scattered over the sequence back into the
rank's positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba.ops import mamba_scan
from ..kernels.mamba.ref import scan_step
from ..runtime.collectives import copy_to, sum_over
from .config import ModelConfig
from .layers import dense, dense_fp32, mixer_in, mixer_out


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


def _ssm_inputs(params, x: torch.Tensor, cfg: ModelConfig, shard=None, tag: str = ""):
    """x [B,S,di] -> (dt [B,S,di] fp32, A [di,N] fp32, Bc, Cc [B,S,N]).

    The reference's ``_ssm_params`` up to the decay and input terms, which
    the kernel forms itself.  ``Bc`` and ``Cc`` are column slices of the
    ``x_proj`` output in x's dtype (views, no copy).
    """
    N = cfg.mamba_d_state
    R = params["dt_proj"].shape[0]
    if shard is None:
        proj = dense(x, params["x_proj"])
    else:
        part = sum_over(shard.comm, dense_fp32(x, params["x_proj"]), tag=f"{tag}:x_proj")
        proj = copy_to(shard.comm, part, tag=f"{tag}:x_proj").to(x.dtype)
    dt_r, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dense(dt_r, params["dt_proj"]).float() + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"]), Bc, Cc


def _in_proj(params, x: torch.Tensor, cfg: ModelConfig, conv_state=None):
    xi, z = dense(x, params["in_proj"]).chunk(2, dim=-1)
    xi, conv_state = _causal_conv(xi, params["conv_w"], params["conv_b"], conv_state)
    return F.silu(xi), z, conv_state


def _out_proj(params, y: torch.Tensor, z: torch.Tensor, dtype, shard=None, tag: str = "",
              wsp_seq: int | None = None) -> torch.Tensor:
    gated = (y * F.silu(z.float())).to(dtype)
    if shard is None:
        return dense(gated, params["out_proj"])
    return mixer_out(dense_fp32(gated, params["out_proj"]), shard, wsp_seq, f"{tag}:mamba", dtype)


def mamba_prefill(params, x: torch.Tensor, cfg: ModelConfig, shard=None, tag: str = "",
                  wsp_seq: int | None = None):
    """x [B,S,d] -> (out [B,S,d], {"h", "conv"}), from a zero state; with a
    ``shard`` this rank's channels (module docstring)."""
    dtype = x.dtype
    x = mixer_in(x, shard, wsp_seq, f"{tag}:mamba_in")
    xi, z, conv_state = _in_proj(params, x, cfg)
    dt, A, Bc, Cc = _ssm_inputs(params, xi, cfg, shard, tag)
    y, h_last = mamba_scan(dt, xi, A, Bc, Cc, params["D"])
    return (_out_proj(params, y, z, dtype, shard, tag, wsp_seq),
            {"h": h_last, "conv": conv_state})


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig, state: dict, shard=None,
                 tag: str = ""):
    """Single-token step from ``state`` {"h", "conv"}.  x [B,1,d] ->
    (out [B,1,d], new {"h", "conv"}); with a ``shard`` this rank's channels."""
    xi, z, conv_state = _in_proj(params, x, cfg, state["conv"])
    dt, A, Bc, Cc = _ssm_inputs(params, xi, cfg, shard, tag)
    x0 = xi[:, 0].float()
    h, y = scan_step(state["h"], dt[:, 0], x0, A, Bc[:, 0].float(), Cc[:, 0].float())
    y = (y + params["D"] * x0)[:, None]
    return _out_proj(params, y, z, x.dtype, shard, tag), {"h": h, "conv": conv_state}
