"""Plain PyTorch flash attention (port of ``repro/kernels/flash_attention/ref.py``).

The CPU path of :func:`..ops.flash_attention` and the oracle the CUDA kernel
is held against on the card.  Identical masking semantics to the kernel: key
positions count from 0, query positions from ``q_offset`` (0 in the
reference, which has no offset; a rank of a sequence-sharded prefill passes
its first position), masked logits are ``NEG_INF``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def attention_ref(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    g = H // KV
    # upcast before repeating: autograd then sums a group's heads in fp32
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vf)
    return out.to(q.dtype)


def attention_bwd_ref(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    do: torch.Tensor,     # gradient of the output, [B, H, Sq, hd]
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` by autograd, each in its input's
    dtype: computed in fp32 (``attention_ref`` upcasts q, k, v, so a GQA
    group's dk, dv are summed in fp32) and rounded once.  A key no query
    sees (under ``q_offset``) gets dk = dv = 0.

    The plain backward the CUDA backward kernel is held against on the card;
    the reference has no backward kernel and differentiates its jnp attention
    the same way.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal, window, softcap, q_offset)
        return torch.autograd.grad(out, leaves, do)


# Query heads a kv head above which the bf16 backward adds the products of
# P's and dS's bf16 residuals to dk and dv (csrc/flash_attention_bwd.cu
# kResidualGroup): at S=2048 a group of 32 stays inside the bounds without
# them by a hair and 48 (granite-20b's MQA) does not.
RESIDUAL_GROUP = 16


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def attention_bwd_emulated(
    q: torch.Tensor,      # [B, H, Sq, hd], bf16
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    do: torch.Tensor,     # [B, H, Sq, hd]
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    residual: bool | None = None,
    o_residual: bool = True,
    p_residual: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) with the bf16 kernels' rounding points, in fp32 elsewhere.

    The forward as the bf16 forward kernel's training instantiation runs it
    (online softmax in base 2 over key tiles of 128, 64 at hd 256; P v as
    bf16(P) v plus the product of P's bf16 residual) gives o, its bf16
    residual ``o_fp32 - bf16(o_fp32)`` and each row's base-2 log-sum-exp.
    The backward takes D = rowsum(dO (o + o_res)), P from the log-sum-exp,
    dS = P (dP - D) f, and rounds P and dS to bf16 where the products take
    them: dq = scale bf16(dS) k, dv = sum bf16(P)^T dO, dk = scale sum
    bf16(dS)^T q over a group's heads, plus the residuals' products where
    ``residual`` (default: the kernels' rule: a group above RESIDUAL_GROUP, a
    softcap, or hd 256).  ``o_residual=False`` models D from the bf16 output
    alone, ``p_residual=False`` a forward whose P v rounds P once.  Sums are
    fp32; each gradient is rounded to its input's dtype once.  A plain model
    of the arithmetic, for the CPU tests and scripts/flash_bwd_emulation.py;
    nothing on the main path calls it.
    """
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    g = H // KV
    if residual is None:
        residual = hd == 256 or softcap > 0.0 or g > RESIDUAL_GROUP
    scale, log2e = 1.0 / math.sqrt(hd), 1.0 / math.log(2.0)
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    s = qf @ kf.transpose(-1, -2)
    if softcap > 0.0:
        u = torch.tanh(s * (scale / softcap))
        y2, f = (softcap * log2e) * u, 1.0 - u * u
    else:
        y2, f = s * (scale * log2e), 1.0
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    y2 = torch.where(mask, y2, -math.inf)

    # the forward: online softmax over key tiles
    tile = 64 if hd == 256 else 128
    m = torch.full((B, H, Sq, 1), -math.inf)
    l = torch.zeros(B, H, Sq, 1)
    o = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Skv, tile):
        t = y2[..., k0:k0 + tile]
        mn = torch.maximum(m, t.amax(-1, keepdim=True))
        base = torch.where(mn == -math.inf, 0.0, mn)
        alpha, p = torch.exp2(m - base), torch.exp2(t - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = _bf16(p)
        if p_residual:   # the training forward: P's residual product too
            pv = pv + _bf16(p - pv)
        o = o * alpha + pv @ vf[..., k0:k0 + tile, :]
        m = mn
    o = o / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log2(l), math.inf)
    o_bf = _bf16(o)
    o_full = o_bf + _bf16(o - o_bf) if o_residual else o_bf

    delta = (dof * o_full).sum(-1, keepdim=True)
    p = torch.exp2(y2 - lse)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * f
    dq = scale * (_bf16(ds) @ kf)
    dv = _bf16(p).transpose(-1, -2) @ dof
    dk = _bf16(ds).transpose(-1, -2) @ qf
    if residual:
        dv = dv + _bf16(p - _bf16(p)).transpose(-1, -2) @ dof
        dk = dk + _bf16(ds - _bf16(ds)).transpose(-1, -2) @ qf
    dk = scale * dk.view(B, KV, g, Skv, hd).sum(2)
    dv = dv.view(B, KV, g, Skv, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
