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


def mamba_scan_lanes_ref(dt, x, A, Bc, Cc, D):
    """The CUDA kernel's order of operations, in plain PyTorch: the same
    ``(y, h_last)`` as :func:`mamba_scan_ref`, computed as
    ``csrc/mamba_scan.cu`` computes it.  Only the tests use it, to hold that
    order against the reference on the CPU.

    The states of a channel are split into groups of 4 (one lane each on the
    card).  Each group runs the recurrence token by token in the reference's
    order, with the decay ``exp2(dt * (A log2 e))`` and ``A log2 e`` rounded
    to fp32 first, and sums ``C . h`` over its 4 states; y adds the groups'
    sums pairwise, ``(p_0 + p_2) + (p_1 + p_3)`` for 4 groups and ``p_0 + p_1``
    for 2 (the lanes' reduce-scatter), then ``D x``.
    """
    B, S, di = x.shape
    N = A.shape[1]
    if N % 4 or N // 4 not in (1, 2, 4):
        raise ValueError(f"state size {N}: the kernel's lanes take N = 4, 8 or 16")
    dt, x, A, Bc, Cc, D = (t.to(torch.float32) for t in (dt, x, A, Bc, Cc, D))
    A2 = A * torch.tensor(1.4426950408889634, dtype=torch.float32)
    h = torch.zeros(B, di, N, dtype=torch.float32, device=x.device)
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    for t in range(S):
        dt_t = dt[:, t, :, None]
        h = torch.exp2(dt_t * A2) * h + (dt[:, t] * x[:, t])[:, :, None] * Bc[:, t, None, :]
        ch = (h * Cc[:, t, None, :]).reshape(B, di, N // 4, 4)      # [B, di, group, state]
        part = ((ch[..., 0] + ch[..., 1]) + ch[..., 2]) + ch[..., 3]   # [B, di, N/4]
        if N == 16:
            y[:, t] = (part[..., 0] + part[..., 2]) + (part[..., 1] + part[..., 3])
        elif N == 8:
            y[:, t] = part[..., 0] + part[..., 1]
        else:
            y[:, t] = part[..., 0]
    return y + D * x, h
