"""Plain PyTorch selective scan (port of ``repro/kernels/mamba/ref.py``) and
its gradient.

The CPU path of :func:`..ops.mamba_scan` and the oracle the CUDA kernels are
held against on the card: the sequential recurrence, token by token, in fp32
(float64 inputs stay float64, the yardstick for fp32 rounding).  The decay
``exp(dt_t * A)`` is formed per step, never as a ``[B,S,di,N]`` tensor, so
the plain version also runs on the card at the full prefill shape.

:func:`mamba_scan_bwd_ref` is the gradient as a reverse sweep, token by
token; :func:`mamba_scan_bwd_chunked_ref` computes it as
``csrc/mamba_scan_bwd.cu`` does, from the chunk states the forward keeps.
"""
from __future__ import annotations

import torch

CHUNK = 64      # tokens a chunk: csrc/mamba_scan.cu's and mamba_scan_bwd.cu's kT
SUB = 8         # tokens a sub-chunk of the backward's recompute: its kSub
BLOCK = 128     # channels a block of the backward: its kCB
LOG2E = 1.4426950408889634


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


def mamba_scan_lanes_ref(dt, x, A, Bc, Cc, D, with_states: bool = False):
    """The CUDA kernel's order of operations, in plain PyTorch: the same
    ``(y, h_last)`` as :func:`mamba_scan_ref`, computed as
    ``csrc/mamba_scan.cu`` computes it.  Only the tests use it, to hold that
    order against the reference on the CPU.  ``with_states`` also returns
    the state at the start of every ``CHUNK``-token chunk but the first,
    ``[B, di, n_chunks - 1, N]`` (what the kernel keeps for the backward).

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
    A2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    h = torch.zeros(B, di, N, dtype=torch.float32, device=x.device)
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    states = []
    for t in range(S):
        if t and t % CHUNK == 0:
            states.append(h)
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
    if not with_states:
        return y + D * x, h
    return y + D * x, h, _stack_states(states, B, di, N, x.device)


def _stack_states(states, B, di, N, device, dtype=torch.float32):
    if not states:
        return torch.zeros(B, di, 0, N, dtype=dtype, device=device)
    return torch.stack(states, dim=2)


def _promoted(dt, x, A, Bc, Cc, D, dy, dh_last):
    ft = torch.promote_types(torch.promote_types(dt.dtype, x.dtype), torch.float32)
    dh = None if dh_last is None else dh_last.to(ft)
    return ft, [t.to(ft) for t in (dt, x, A, Bc, Cc, D, dy)], dh


def mamba_scan_bwd_ref(dt, x, A, Bc, Cc, D, dy, dh_last=None):
    """The gradient of :func:`mamba_scan_ref`'s ``(y, h_last)`` at ``(dy,
    dh_last)`` (``None``: a zero cotangent), as (ddt, dx, dA, dB, dC, dD) in
    fp32 (float64 inputs stay float64).

    The forward's states are kept, then a reverse sweep, token by token, with
    ``a_t = exp(dt_t A)`` and g_t the gradient of h_t:
    ``g_t = a_{t+1} g_{t+1} + dy_t C_t`` (``g`` past the last token is
    dh_last), ``dC_t = sum_c dy_t h_t``, ``dB_t = sum_c g_t dt_t x_t``,
    ``ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)``, ``dx_t = D dy_t + dt_t
    sum_n g_t B_t``, ``dA = sum_{b,t} g_t dt_t a_t h_{t-1}``, ``dD = sum_{b,t}
    dy_t x_t``.  Nothing divides by a_t, which underflows on strong decays.
    dA and dD, sums over B*S tokens, and dB and dC, sums over di channels,
    are accumulated in float64: in fp32 they drift past 2e-4 at jamba's
    B*S = 8,192 and di = 8,192 (scripts/mamba_bwd_conditioning.py).
    """
    B, S, di = x.shape
    N = A.shape[1]
    ft, (dt, x, A, Bc, Cc, D, dy), dh_last = _promoted(dt, x, A, Bc, Cc, D, dy, dh_last)
    h = torch.zeros(B, di, N, dtype=ft, device=x.device)
    hs = []
    for t in range(S):
        h, _ = scan_step(h, dt[:, t], x[:, t], A, Bc[:, t], Cc[:, t])
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.clone()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty(B, S, N, dtype=ft, device=x.device), torch.empty(B, S, N, dtype=ft,
                                                                           device=x.device)
    dA = torch.zeros(A.shape, dtype=torch.float64, device=x.device)
    dD = torch.zeros(D.shape, dtype=torch.float64, device=x.device)
    for t in range(S - 1, -1, -1):
        dt_t, x_t, dy_t = dt[:, t], x[:, t], dy[:, t]
        g = g + dy_t[:, :, None] * Cc[:, t, None, :]
        a = torch.exp(dt_t[:, :, None] * A)
        term = g * a * hs[t - 1] if t else torch.zeros_like(g)
        dA += (term * dt_t[:, :, None]).sum(0).double()
        gB = torch.einsum("bdn,bn->bd", g, Bc[:, t])
        ddt[:, t] = (term * A).sum(-1) + x_t * gB
        dx[:, t] = D * dy_t + dt_t * gB
        dB[:, t] = torch.einsum("bdn,bd->bn", g.double(), (dt_t * x_t).double())
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t].double(), dy_t.double())
        dD += (dy_t * x_t).sum(0).double()
        g = a * g
    return ddt, dx, dA.to(ft), dB, dC, dD.to(ft)


def mamba_scan_bwd_chunked_ref(dt, x, A, Bc, Cc, D, states, dy, dh_last=None,
                               acc_dtype=torch.float64):
    """The backward kernel's order of operations (``csrc/mamba_scan_bwd.cu``),
    in plain PyTorch: the same gradients as :func:`mamba_scan_bwd_ref`, from
    ``states``, the chunk states :func:`mamba_scan_lanes_ref` keeps
    (``[B, di, n_chunks - 1, N]``).  The tests and
    ``scripts/mamba_bwd_conditioning.py`` use it; nothing else does.

    Chunks of ``CHUNK`` tokens run last to first.  Each runs forward from its
    state (zero for the first), keeping the state at the start of each
    ``SUB``-token sub-chunk; the sub-chunks then run last to first, each
    recomputing its tokens' ``a_t`` and ``h_{t-1}`` and sweeping back through
    them: ``g += dy_t C_t``, ``ah = a_t h_{t-1}``, ``h_t = ah + dt_t x_t B_t``
    (the forward's update, so h_t is the forward's own), ``term = g ah``,
    then ``g *= a_t``.  The decay is ``exp2(dt A log2 e)``.  dB and dC are
    summed over each warp's channels (32 lanes of N/4 lanes a channel) in
    the computing dtype, then in float64 over the warps of a
    ``BLOCK``-channel block and over the blocks in order; dA and dD are
    summed over each sub-chunk's tokens in the
    computing dtype, those sums over each batch row's sub-chunks in
    ``acc_dtype`` (float64 as in the kernel; float32 for
    ``scripts/mamba_bwd_conditioning.py``'s comparison), then over the rows.
    """
    B, S, di = x.shape
    N = A.shape[1]
    ft, (dt, x, A, Bc, Cc, D, dy), dh_last = _promoted(dt, x, A, Bc, Cc, D, dy, dh_last)
    acc = torch.promote_types(acc_dtype, ft)
    n_chunks = max(1, -(-S // CHUNK))
    if tuple(states.shape) != (B, di, n_chunks - 1, N):
        raise ValueError(f"states {tuple(states.shape)} is not {(B, di, n_chunks - 1, N)}")
    pad, cpad = n_chunks * CHUNK - S, -di % BLOCK
    dt, x, dy = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, x, dy))
    Bc, Cc = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bc, Cc))
    A2 = A * torch.tensor(LOG2E, dtype=ft)
    g = torch.zeros(B, di, N, dtype=ft, device=x.device) if dh_last is None else dh_last.clone()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    n_blocks = (di + cpad) // BLOCK
    per_warp = 32 // (N // 4)               # channels a warp
    f64 = torch.promote_types(ft, torch.float64)
    pB = torch.empty(B, S + pad, n_blocks, N, dtype=f64, device=x.device)
    pC = torch.empty_like(pB)
    dA = torch.zeros(B, di, N, dtype=acc, device=x.device)
    dD = torch.zeros(B, di, dtype=acc, device=x.device)

    def blocks(v):                          # [B, di, N] -> [B, n_blocks, N], block sums
        v = torch.nn.functional.pad(v, (0, 0, 0, cpad))
        warps = v.reshape(B, n_blocks, BLOCK // per_warp, per_warp, N).sum(3)
        return warps.to(f64).sum(2)

    for k in range(n_chunks - 1, -1, -1):
        h = states[:, :, k - 1].to(ft) if k else torch.zeros_like(g)
        starts = []
        for t in range(k * CHUNK, (k + 1) * CHUNK):
            if t % SUB == 0:
                starts.append(h)
            h = torch.exp2(dt[:, t, :, None] * A2) * h + (dt[:, t] * x[:, t])[:, :, None] * Bc[:, t, None, :]
        for j in range(CHUNK // SUB - 1, -1, -1):
            t0 = k * CHUNK + j * SUB
            h, hp, av = starts[j], [], []
            for t in range(t0, t0 + SUB):
                a = torch.exp2(dt[:, t, :, None] * A2)
                hp.append(h)
                av.append(a)
                h = a * h + (dt[:, t] * x[:, t])[:, :, None] * Bc[:, t, None, :]
            dA_sub = torch.zeros_like(g)
            dD_sub = torch.zeros(B, di, dtype=ft, device=x.device)
            for i in range(SUB - 1, -1, -1):
                t = t0 + i
                dt_t, x_t, dy_t = dt[:, t], x[:, t], dy[:, t]
                g = g + dy_t[:, :, None] * Cc[:, t, None, :]
                ah = av[i] * hp[i]
                dxt = dt_t * x_t
                h_t = ah + dxt[:, :, None] * Bc[:, t, None, :]
                term = g * ah
                dA_sub = dA_sub + term * dt_t[:, :, None]
                gB = (g * Bc[:, t, None, :]).sum(-1)
                ddt[:, t] = (A * term).sum(-1) + x_t * gB
                dx[:, t] = D * dy_t + dt_t * gB
                pB[:, t] = blocks(g * dxt[:, :, None])
                pC[:, t] = blocks(dy_t[:, :, None] * h_t)
                dD_sub = dD_sub + dy_t * x_t
                g = av[i] * g
            dA += dA_sub.to(acc)
            dD += dD_sub.to(acc)
    dB, dC = pB[:, :S, 0].clone(), pC[:, :S, 0].clone()
    for b in range(1, n_blocks):
        dB += pB[:, :S, b]
        dC += pC[:, :S, b]
    return (ddt[:, :S], dx[:, :S], dA.sum(0).to(ft), dB.to(ft), dC.to(ft), dD.sum(0).to(ft))
