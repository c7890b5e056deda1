"""Plain PyTorch selective scan (port of ``repro/kernels/mamba/ref.py``).

The CPU path of :func:`..ops.mamba_scan` and the oracle the CUDA kernel is
held against on the card: the sequential recurrence, token by token, in fp32
(float64 inputs stay float64, the yardstick for fp32 rounding).  The decay
``exp(dt_t * A)`` is formed per step, never as a ``[B,S,di,N]`` tensor, so
the plain version also runs on the card at the full prefill shape.
"""
from __future__ import annotations

import torch


def scan_step(h, dt_t, x_t, A, B_t, C_t):
    """One step of the recurrence.  h [B,di,N]; dt_t, x_t [B,di]; A [di,N];
    B_t, C_t [B,N] -> (h_t, C_t . h_t [B,di]), without the ``D x_t`` skip."""
    h = torch.exp(dt_t[:, :, None] * A) * h + (dt_t * x_t)[:, :, None] * B_t[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, C_t)


def mamba_scan_ref(dt, x, A, Bc, Cc, D):
    """dt, x [B,S,di]; A [di,N]; Bc, Cc [B,S,N]; D [di] ->
    (y [B,S,di], h_last [B,di,N]), fp32.

    From a zero state: ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
    ``y_t = C_t . h_t + D x_t``.
    """
    B, S, di = x.shape
    ft = torch.promote_types(torch.promote_types(dt.dtype, x.dtype), torch.float32)
    dt, x, A, Bc, Cc, D = (t.to(ft) for t in (dt, x, A, Bc, Cc, D))
    h = torch.zeros(B, di, A.shape[1], dtype=ft, device=x.device)
    y = torch.empty(B, S, di, dtype=ft, device=x.device)
    for t in range(S):
        h, y[:, t] = scan_step(h, dt[:, t], x[:, t], A, Bc[:, t], Cc[:, t])
    return y + D * x, h
