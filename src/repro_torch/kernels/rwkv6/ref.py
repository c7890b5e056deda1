"""Plain PyTorch WKV-6 recurrence (port of ``repro/kernels/rwkv6/ref.py``).

The CPU path of :func:`..ops.wkv6` and the oracle the CUDA kernel is held
against on the card: the sequential recurrence, token by token, in fp32
(float64 inputs stay float64, the yardstick for fp32 rounding).  Its
gradient, written out (:func:`wkv6_bwd_ref`), is the oracle of the
backward kernel.
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


def wkv6_segmented_ref(r, k, v, logw, u, segment):
    """The CUDA kernel's split of the sequence, in plain PyTorch: the same
    ``(out, S_last)`` as :func:`wkv6_ref`, computed by segments of ``segment``
    tokens as ``csrc/wkv6.cu`` does.  Only the tests use it, to hold the split
    against the reference on the CPU.

    Pass 1 runs every segment from a zero state to its end state and total
    decay ``exp(sum logw)``; pass 2 carries the state across segments,
    ``S_in[s+1] = diag(decay[s]) S_in[s] + end[s]``; pass 3 runs every segment
    from its ``S_in`` for the outputs.  A ragged tail is padded with
    ``k = v = logw = r = 0``, which leaves the state as it is.
    """
    B, H, S, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    n_seg = max(1, -(-S // segment))
    pad = n_seg * segment - S

    def split(x):
        x = torch.nn.functional.pad(x.to(dt), (0, 0, 0, pad))
        return x.reshape(B, H, n_seg, segment, hd)

    r, k, v, logw = (split(x) for x in (r, k, v, logw))
    u = u.to(dt)[None, :, None, :, None]
    w = torch.exp(logw)
    end = torch.zeros(B, H, n_seg, hd, hd, dtype=dt, device=r.device)
    for t in range(segment):                                    # pass 1
        end = w[:, :, :, t, :, None] * end + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
    decay = torch.exp(logw.sum(dim=3))
    s_in = torch.empty_like(end)
    carry = torch.zeros(B, H, hd, hd, dtype=dt, device=r.device)
    for s in range(n_seg):                                      # pass 2
        s_in[:, :, s] = carry
        carry = decay[:, :, s, :, None] * carry + end[:, :, s]
    out = torch.empty(B, H, n_seg, segment, hd, dtype=dt, device=r.device)
    state = s_in
    for t in range(segment):                                    # pass 3
        kv = k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
        out[:, :, :, t] = torch.einsum("bhsi,bhsij->bhsj", r[:, :, :, t], state + u * kv)
        state = w[:, :, :, t, :, None] * state + kv
    return out.reshape(B, H, n_seg * segment, hd)[:, :, :S], carry


def wkv6_chunked_ref(r, k, v, logw, u, chunk=32, block=4, strong_logw=-2.0):
    """The CUDA kernel's arithmetic inside a chunk, in plain PyTorch: the
    same ``(out, S_last)`` as :func:`wkv6_ref`, by chunks of ``chunk``
    tokens as ``csrc/wkv6.cu`` computes them.  Only the tests use it, to hold
    the chunk form and its strong-decay guard against the reference on the
    CPU.

    A pair ``s < t`` of a chunk carries ``exp(D)``, ``D`` the sum of
    ``logw`` over ``s+1 .. t-1``.  A head whose chunk has every ``logw >=
    strong_logw`` takes it factored over the chunk's cumulative sums ``C``
    (inclusive) and ``Cx`` (exclusive), ``r exp(Cx)`` against ``k exp(-C)``.
    Otherwise (strong decays, where ``exp(-C)`` overflows) ``D`` comes from
    sums inside ``block``-token blocks, ``c`` and ``cx``, with ``T_b`` a
    block's total: ``cx_t + (T_bs - c_s) + (the totals of the blocks
    between)`` for ``s`` in an earlier block, ``exp(cx_t)`` on ``r`` and the
    rest on ``k``; ``cx_t - c_s`` pair by pair inside a block.  Every
    exponent is ``<= 0``.  ``strong_logw = -inf`` gives the factored form
    everywhere, which overflows under strong decays.  The state across
    chunks: ``S = diag(exp(C_T)) S + (k exp(C_T - C))^T v``, the decay of
    ``k`` summed from the chunk's end in a strong chunk.
    """
    B, H, S, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    n = max(1, -(-S // chunk))
    pad = n * chunk - S
    r, k, v, logw = (torch.nn.functional.pad(x.to(dt), (0, 0, 0, pad)) for x in (r, k, v, logw))
    u = u.to(dt)
    T, nb = chunk, chunk // block
    tt = torch.arange(T)
    tb = tt // block                                             # each token's block
    lower = tt[None, :] < tt[:, None]                            # [t, s]: s < t
    same = lower & (tb[None, :] == tb[:, None])                  # s, t in one block
    # [t-block, s-block, b]: block b lies strictly between
    bi = torch.arange(nb)
    between = (bi[None, None, :] > bi[None, :, None]) & (bi[None, None, :] < bi[:, None, None])
    state = torch.zeros(B, H, hd, hd, dtype=dt, device=r.device)
    out = torch.empty(B, H, n * T, hd, dtype=dt, device=r.device)
    for ci in range(n):
        sl = slice(ci * T, (ci + 1) * T)
        rc, kc, vc, wc = r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl]
        C = torch.cumsum(wc, dim=2)
        total = C[:, :, -1:]
        # factored form
        a_fast = torch.einsum("bhti,bhsi->bhts", rc * torch.exp(C - wc), kc * torch.exp(-C))
        # strong-decay form, from sums inside the blocks
        c = torch.cumsum(wc.reshape(B, H, nb, block, hd), dim=3)     # [B,H,nb,block,hd]
        cx = torch.nn.functional.pad(c[:, :, :, :-1], (0, 0, 1, 0)).reshape(B, H, T, hd)
        tot_b = c[:, :, :, -1]                                       # [B,H,nb,hd]
        c = c.reshape(B, H, T, hd)
        mid = torch.einsum("xyz,bhzi->bhxyi", between.to(dt), tot_b)   # [B,H,t-block,s-block,hd]
        # k-side exponent for t-block bt and token s: (T_bs - c_s) + mid[bt, bs]
        ks = (tot_b[:, :, tb] - c)[:, :, None] + mid[:, :, :, tb]   # [B,H,nb(t),T(s),hd]
        kf = kc[:, :, None] * torch.exp(ks)
        a_off = torch.einsum("bhti,bhtsi->bhts", rc * torch.exp(cx), kf[:, :, tb])
        e = cx[:, :, :, None] - c[:, :, None]                        # [B,H,t,s,hd]
        e = torch.where(same[None, None, :, :, None], e, torch.full_like(e, -torch.inf))
        a_same = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, torch.exp(e))
        a_strong = torch.where(same, a_same, a_off)
        strong = (wc.amin(dim=(2, 3)) < strong_logw)[:, :, None, None]
        a = torch.where(lower, torch.where(strong, a_strong, a_fast), torch.zeros((), dtype=dt))
        bonus = (rc * u[None, :, None] * kc).sum(-1, keepdim=True)   # the u term, s == t
        rt = rc * torch.exp(C - wc)
        out[:, :, sl] = a @ vc + bonus * vc + rt @ state
        suffix = torch.flip(torch.cumsum(torch.flip(wc, [2]), dim=2), [2])        # logw over t ..
        after = torch.nn.functional.pad(suffix[:, :, 1:], (0, 0, 0, 1))           # over t+1 ..
        kd = kc * torch.exp(torch.where(strong, after, total - C))
        state = torch.exp(total).transpose(-1, -2) * state + kd.transpose(-1, -2) @ vc
    return out[:, :, :S], state


def _bwd_cotangents(dt, B, H, hd, ds_last, device):
    if ds_last is None:
        return torch.zeros(B, H, hd, hd, dtype=dt, device=device)
    return ds_last.to(dt)


def wkv6_bwd_ref(r, k, v, logw, u, dout, ds_last=None):
    """The gradient of :func:`wkv6_ref`'s ``(out, S_last)`` at ``(dout,
    ds_last)`` (``None``: zero), token by token: (dr, dk, dv, dlogw
    [B,H,S,hd], du [H,hd]), fp32 (float64 inputs stay float64).

    A forward sweep keeps every state ``S_{t-1}``; the reverse sweep
    carries the state's gradient ``G`` from ``G = ds_last``:
    ``dr_t = S_{t-1} dout_t + u k_t (v_t . dout_t)``, ``dk_t = G v_t + u r_t
    (v_t . dout_t)``, ``dv_t = G^T k_t + (sum r u k) dout_t``, ``dlogw_t =
    w_t sum_j G * S_{t-1}``, then ``G = diag(w_t) G + r_t dout_t^T``; ``du``
    sums ``r k (v . dout)`` over b and t.  dlogw is the per-token product
    (autograd's form), not the kernel's running sums, which in fp32 are
    ill-conditioned (``csrc/wkv6_bwd.cu``).  It keeps all S states, so it
    holds ``B H S hd^2`` values at once.
    """
    B, H, S, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    r, k, v, dout, u = (x.to(dt) for x in (r, k, v, dout, u))
    w = torch.exp(logw.to(dt))
    vd = (v * dout).sum(-1, keepdim=True)                       # v_t . dout_t
    states = []
    state = torch.zeros(B, H, hd, hd, dtype=dt, device=r.device)
    for t in range(S):
        states.append(state)
        state = w[:, :, t, :, None] * state + k[:, :, t, :, None] * v[:, :, t, None, :]
    G = _bwd_cotangents(dt, B, H, hd, ds_last, r.device)
    drs, dks, dv, dlogw = (torch.empty(B, H, S, hd, dtype=dt, device=r.device) for _ in range(4))
    for t in range(S - 1, -1, -1):
        prev = states.pop()
        drs[:, :, t] = torch.einsum("bhij,bhj->bhi", prev, dout[:, :, t])
        dks[:, :, t] = torch.einsum("bhij,bhj->bhi", G, v[:, :, t])
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", G, k[:, :, t])
        dlogw[:, :, t] = w[:, :, t] * (G * prev).sum(-1)
        G = w[:, :, t, :, None] * G + r[:, :, t, :, None] * dout[:, :, t, None, :]
    dv = dv + (r * u[None, :, None] * k).sum(-1, keepdim=True) * dout
    dr = drs + u[None, :, None] * k * vd
    dk = dks + u[None, :, None] * r * vd
    du = (r * k * vd).sum((0, 2))
    return dr, dk, dv, dlogw, du


def wkv6_bwd_segmented_ref(r, k, v, logw, u, dout, ds_last, segment):
    """The backward kernel's split of the sequence and its arithmetic, in
    plain PyTorch: the same gradient as :func:`wkv6_bwd_ref`, computed by
    segments of ``segment`` tokens as ``csrc/wkv6_bwd.cu`` does.  Only the
    tests use it, to hold the split against the reference on the CPU.

    The forward's split (:func:`wkv6_segmented_ref`'s passes 1-2) gives the
    state at each segment's end.  Pass 1 runs every segment's ``G`` in
    reverse from zero to its start, with the segment's decay ``prod w``;
    pass 2 carries ``G_end[s-1] = diag(decay[s]) G_end[s] + local[s]`` from
    ``G_end[last] = ds_last``.  Passes 3-4 run in float64 from those fp32
    states, as the kernel's do: forward from each segment's input state for
    ``drs`` and ``a = r drs``, in reverse from ``G_end`` for ``dks`` and
    ``dv``, and ``dlogw_tau = P_e + sum_{tau<t<=e} a_t - sum_{tau<=t<=e}
    b_t`` inside each segment, ``P_e = sum_j G_end * S_end`` (``ds_last *
    S_last`` in the last), ``b = k dks``; du sums over b and the segments.
    A ragged tail is padded with ``r = k = v = dout = logw = 0``, which
    leaves both states as they are.
    """
    B, H, S, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    f64 = torch.float64
    n = max(1, -(-S // segment))
    pad = n * segment - S

    def split(x):
        return torch.nn.functional.pad(x.to(dt), (0, 0, 0, pad)).reshape(B, H, n, segment, hd)

    r, k, v, logw, dout = (split(x) for x in (r, k, v, logw, dout))
    w = torch.exp(logw)
    zeros = torch.zeros(B, H, n, hd, hd, dtype=dt, device=r.device)
    # the forward's states at the segments' ends (wkv6_segmented_ref, passes 1-2)
    end = zeros
    for t in range(segment):
        end = w[:, :, :, t, :, None] * end + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
    fdecay = torch.exp(logw.sum(dim=3))
    s_end = torch.empty_like(end)
    carry = torch.zeros(B, H, hd, hd, dtype=dt, device=r.device)
    for s in range(n):
        carry = fdecay[:, :, s, :, None] * carry + end[:, :, s]
        s_end[:, :, s] = carry
    s_in = torch.cat([torch.zeros_like(s_end[:, :, :1]), s_end[:, :, :-1]], dim=2)
    # pass 1: each segment's G from zero at its end to its start
    local, gdecay = zeros, torch.ones(B, H, n, hd, dtype=dt, device=r.device)
    for t in range(segment - 1, -1, -1):
        local = w[:, :, :, t, :, None] * local + r[:, :, :, t, :, None] * dout[:, :, :, t, None, :]
        gdecay = gdecay * w[:, :, :, t]
    # pass 2: G at each segment's end
    g_end = torch.empty_like(local)
    cur = _bwd_cotangents(dt, B, H, hd, ds_last, r.device)
    for s in range(n - 1, -1, -1):
        g_end[:, :, s] = cur
        cur = gdecay[:, :, s, :, None] * cur + local[:, :, s]
    # passes 3-4 in float64
    r, k, v, dout, w = (x.to(f64) for x in (r, k, v, dout, w))
    u = u.to(f64)[None, :, None, None, :]
    state, drs = s_in.to(f64), torch.empty_like(r)
    for t in range(segment):
        drs[:, :, :, t] = torch.einsum("bhsij,bhsj->bhsi", state, dout[:, :, :, t])
        state = w[:, :, :, t, :, None] * state + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
    s_end = torch.cat([s_end[:, :, :-1].to(f64), state[:, :, -1:]], dim=2)   # S_last in fp64
    G = g_end.to(f64)
    p_end = (G * s_end).sum(-1)                                  # [B,H,n,hd]
    dks, dv = torch.empty_like(r), torch.empty_like(r)
    for t in range(segment - 1, -1, -1):
        dks[:, :, :, t] = torch.einsum("bhsij,bhsj->bhsi", G, v[:, :, :, t])
        dv[:, :, :, t] = torch.einsum("bhsij,bhsi->bhsj", G, k[:, :, :, t])
        G = w[:, :, :, t, :, None] * G + r[:, :, :, t, :, None] * dout[:, :, :, t, None, :]
    vd = (v * dout).sum(-1, keepdim=True)
    dv = dv + (r * u * k).sum(-1, keepdim=True) * dout
    dr = drs + u * k * vd
    dk = dks + u * r * vd
    du = (r * k * vd).sum((0, 2, 3))
    suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, [3]), 3), [3])   # noqa: E731
    a_after = torch.nn.functional.pad(suffix(r * drs)[:, :, :, 1:], (0, 0, 0, 1))
    dlogw = p_end[:, :, :, None] + a_after - suffix(k * dks)
    back = lambda x: x.reshape(B, H, n * segment, hd)[:, :, :S].to(dt)   # noqa: E731
    return back(dr), back(dk), back(dv), back(dlogw), du.to(dt)
