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
