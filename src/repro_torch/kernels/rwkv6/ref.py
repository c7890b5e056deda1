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
