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
    ill-conditioned (``csrc/wkv6_bwd.cu``; the chunked fp32 form tried in its
    place is :func:`wkv6_bwd_chunked_ref`).  It keeps all S states, so it
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


def _segment_input_states(k, v, logw, segment):
    """The state at the start of every ``segment``-token segment, as the
    forward's split computes it (:func:`wkv6_segmented_ref`, passes 1-2):
    ``[B,H,n_seg,hd,hd]``, zero for the first."""
    B, H, S, hd = k.shape
    n_seg = max(1, -(-S // segment))
    pad = n_seg * segment - S

    def split(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(B, H, n_seg, segment, hd)

    k, v, logw = (split(x) for x in (k, v, logw))
    w = torch.exp(logw)
    end = torch.zeros(B, H, n_seg, hd, hd, dtype=k.dtype, device=k.device)
    for t in range(segment):
        end = w[:, :, :, t, :, None] * end + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
    decay = torch.exp(logw.sum(dim=3))
    s_in = torch.empty_like(end)
    carry = torch.zeros(B, H, hd, hd, dtype=k.dtype, device=k.device)
    for s in range(n_seg):
        s_in[:, :, s] = carry
        carry = decay[:, :, s, :, None] * carry + end[:, :, s]
    return s_in


def _exclusive_cumprod(x, dim, reverse=False):
    """The product of ``x`` over the entries before each one along ``dim``
    (after it with ``reverse``), 1 at the first, multiplied one entry at a
    time as a running product."""
    if reverse:
        return torch.flip(_exclusive_cumprod(torch.flip(x, [dim]), dim), [dim])
    first = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([first, x.narrow(dim, 0, x.shape[dim] - 1)], dim), dim)


def tf32_split(x):
    """x's (hi, lo) in TF32 as ``scripts/wkv6_bwd_chunked.cu`` splits it for
    its tensor-core products: ``hi`` x with its 13 low mantissa bits cleared,
    ``lo`` the rest (exact in fp32) with its 13 low bits cleared; hi + lo is
    x within 2^-20 of it."""
    def trunc(y):
        return (y.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    hi = trunc(x)
    return hi, trunc(x - hi)


def matmul_3xtf32(a, b):
    """``a @ b`` for fp32 operands as that kernel's tensor cores take it:
    each operand split in TF32 (:func:`tf32_split`) and ``lo_a hi_b + hi_a
    lo_b + hi_a hi_b`` summed in fp32 (TF32 products are exact in fp32),
    ``lo_a lo_b`` left out.  Other types: ``a @ b``."""
    if a.dtype != torch.float32:
        return a @ b
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_bwd_chunked_ref(r, k, v, logw, u, dout, ds_last=None, chunk=16, block=128,
                         segment=256, mm=torch.matmul):
    """The chunked fp32 backward tried in place of the port's kernel
    (``scripts/wkv6_bwd_chunked.cu``, not kept: slower on the card), its split
    of the sequence and its chunk arithmetic in plain PyTorch: the same
    gradient as :func:`wkv6_bwd_ref`, in the inputs' type (fp32 as that
    kernel).  Only the tests and ``scripts/`` use it, to hold the arithmetic
    against the reference on the CPU.

    The sequence is cut into blocks of ``block`` tokens (half the forward's
    ``segment``), each into chunks of ``chunk`` tokens.  Each block but the
    first runs the state's gradient G from zero at its end back to its
    start, with the block's decay; a carry makes G at every block's end
    from ``G = ds_last`` (zero when None).  S at each chunk's start runs
    forward from the input state of the chunk's segment (what the forward
    keeps).  Inside a chunk, with S0 the state before it, G_c the gradient
    after it, ``D(a..b)`` the product of w over tokens a..b (1 when empty),
    ``pre_t = D(0..t-1)``, ``suf_t = D(t+1..c-1)`` and ``vd[s,s'] = v_s .
    dout_s'``, every term carries the decay that spans it:

    * ``E[s,s'] = D(s+1..s'-1) vd[s,s']`` (s < s'; D a running product along
      s'); ``dr_t = pre_t (S0 dout_t) + sum_{s<t} k_s E[s,t] + u k_t vd[t,t]``,
      ``dk_t = suf_t (G_c v_t) + sum_{s'>t} r_s' E[t,s'] + u r_t vd[t,t]``;
    * ``dv_t = (k_t suf_t) G_c + sum_{s'>t} F[t,s'] dout_s' + (sum r_t u
      k_t) dout_t``, ``F[t,s'] = sum_i k_t r_s' exp(L_{s'-1} - L_t)`` with L
      the inclusive sum of log w inside the chunk (every exponent <= 0);
    * ``dlogw_t = sum_{s<t<s'} k_s r_s' E[s,s'] + sum_{s<t} k_s suf_s (G_c
      v_s) + sum_{s'>t} r_s' pre_s' (S0 dout_s') + D(0..c-1) sum_j S0 G_c``:
      the exact expansion of ``w_t sum_j G_t S_{t-1}``, with no term that
      cancels against a larger one;
    * across chunks ``S <- D(0..c-1) S + (k suf)^T v`` and ``G <-
      D(0..c-1) G + (r pre)^T dout``.

    ``mm`` takes every product over j, i or a chunk's tokens (that kernel's
    tensor-core products): ``torch.matmul``, or :func:`matmul_3xtf32` for
    its split of each operand into TF32 terms.  A ragged tail is
    padded with ``r = k = v = dout = logw = 0``, which leaves both states
    as they are.
    """
    B, H, S, hd = r.shape
    if block % chunk or segment % block:
        raise ValueError(f"chunk {chunk} | block {block} | segment {segment} must divide")
    dt = torch.promote_types(r.dtype, torch.float32)
    c, cpb, spc = chunk, block // chunk, segment // chunk
    nb = max(1, -(-S // block))
    nc = nb * cpb
    r, k, v, logw, dout = (x.to(dt) for x in (r, k, v, logw, dout))
    s_seg = _segment_input_states(k, v, logw, segment)
    pad = nb * block - S

    def split(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(B, H, nc, c, hd)

    r, k, v, logw, dout = (split(x) for x in (r, k, v, logw, dout))
    u = u.to(dt)[None, :, None, None, :]
    w = torch.exp(logw)
    pre = _exclusive_cumprod(w, 3)                       # D(0..t-1)
    suf = _exclusive_cumprod(w, 3, reverse=True)         # D(t+1..c-1)
    dc = pre[:, :, :, -1] * w[:, :, :, -1]               # D(0..c-1), [B,H,nc,hd]
    kt, rt = k * suf, r * pre
    # S at every chunk's start, forward from its segment's input state
    s0 = torch.empty(B, H, nc, hd, hd, dtype=dt, device=r.device)
    for ci in range(nc):
        if ci % spc == 0:
            state = s_seg[:, :, ci // spc]
        s0[:, :, ci] = state
        state = dc[:, :, ci, :, None] * state + mm(kt[:, :, ci].transpose(-1, -2), v[:, :, ci])
    # G: each block's local part from zero, the carry, then every chunk's end
    by_block = lambda x: x.reshape(B, H, nb, cpb, *x.shape[3:])   # noqa: E731
    dc_b, rt_b, do_b = by_block(dc), by_block(rt), by_block(dout)

    def g_step(g, p):
        return dc_b[:, :, :, p, :, None] * g + mm(rt_b[:, :, :, p].transpose(-1, -2), do_b[:, :, :, p])

    local = torch.zeros(B, H, nb, hd, hd, dtype=dt, device=r.device)
    gdecay = torch.ones(B, H, nb, hd, dtype=dt, device=r.device)
    for p in reversed(range(cpb)):
        local = g_step(local, p)
        gdecay = gdecay * dc_b[:, :, :, p]
    g_end = torch.empty_like(local)
    cur = _bwd_cotangents(dt, B, H, hd, ds_last, r.device)
    for q in reversed(range(nb)):
        g_end[:, :, q] = cur
        cur = gdecay[:, :, q, :, None] * cur + local[:, :, q]
    gc = torch.empty(B, H, nb, cpb, hd, hd, dtype=dt, device=r.device)
    g = g_end
    for p in reversed(range(cpb)):
        gc[:, :, :, p] = g
        g = g_step(g, p)
    gc = gc.reshape(B, H, nc, hd, hd)
    # the terms through S0 and G_c
    drs_inter = pre * mm(dout, s0.transpose(-1, -2))     # pre_t (S0 dout_t)
    dks_inter = suf * mm(v, gc.transpose(-1, -2))        # suf_t (G_c v_t)
    dv = mm(kt, gc)
    psig = dc * (s0 * gc).sum(-1)                        # D(0..c-1) sum_j S0 G_c
    # the pairs inside a chunk, [.., s, s', hd]
    tri = torch.arange(c, device=r.device)
    upper = tri[None, :] > tri[:, None]                  # s' > s
    vd = mm(v, dout.transpose(-1, -2))                   # [.., s, s']
    run = torch.cumprod(torch.where(upper[:, :, None], w[:, :, :, None], 1.0), dim=4)
    d_pair = torch.cat([torch.ones_like(run[:, :, :, :, :1]), run[:, :, :, :, :-1]], dim=4)
    e = torch.where(upper[:, :, None], d_pair * vd[..., None], 0.0)
    dr = drs_inter + (k[:, :, :, :, None] * e).sum(3)
    dk = dks_inter + (r[:, :, :, None] * e).sum(4)
    p_pair = k[:, :, :, :, None] * r[:, :, :, None] * e
    after = torch.flip(torch.cumsum(torch.flip(p_pair, [4]), 4), [4])   # sum over s' >= x
    after = torch.nn.functional.pad(after[:, :, :, :, 1:], (0, 0, 0, 1))  # over s' > t
    dlogw = torch.where(upper[:, :, None], after, 0.0).sum(3)            # over s < t
    dlogw = dlogw + _exclusive_cumsum(k * dks_inter, 3) \
        + _exclusive_cumsum(r * drs_inter, 3, reverse=True) + psig[:, :, :, None]
    # F and the u terms
    lsum = torch.cumsum(logw, 3)
    expo = (lsum - logw)[:, :, :, None] - lsum[:, :, :, :, None]        # L_{s'-1} - L_t
    expo = torch.where(upper[:, :, None], expo, -torch.inf)
    f = (k[:, :, :, :, None] * r[:, :, :, None] * torch.exp(expo)).sum(-1)
    diag = torch.diagonal(vd, dim1=3, dim2=4)[..., None]                 # vd[t, t]
    # F above the diagonal, sum_i r_t u k_t on it: one product with dout
    ruk = (r * u * k).sum(-1)
    f = f + torch.diag_embed(ruk)
    dv = dv + mm(f, dout)
    dr = dr + u * k * diag
    dk = dk + u * r * diag
    du = (r * k * diag).sum((0, 2, 3))
    back = lambda x: x.reshape(B, H, nb * block, hd)[:, :, :S]   # noqa: E731
    return back(dr), back(dk), back(dv), back(dlogw), du


def _exclusive_cumsum(x, dim, reverse=False):
    """The sum of ``x`` over the entries before each one along ``dim`` (after
    it with ``reverse``), 0 at the first, added one entry at a time."""
    if reverse:
        return torch.flip(_exclusive_cumsum(torch.flip(x, [dim]), dim), [dim])
    first = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cumsum(torch.cat([first, x.narrow(dim, 0, x.shape[dim] - 1)], dim), dim)
