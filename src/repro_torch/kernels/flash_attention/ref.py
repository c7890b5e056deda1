"""Plain PyTorch flash attention (port of ``repro/kernels/flash_attention/ref.py``).

The CPU path of :func:`..ops.flash_attention` and the oracle the CUDA kernel
is held against on the card.  Identical masking semantics to the kernel:
query and key positions both count from 0, masked logits are ``NEG_INF``.
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
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    g = H // KV
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
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
