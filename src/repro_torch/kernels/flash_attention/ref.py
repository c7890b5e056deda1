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
    # upcast before repeating: autograd then sums a group's heads in fp32
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
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


def attention_bwd_ref(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    do: torch.Tensor,     # gradient of the output, [B, H, Sq, hd]
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` by autograd, each in its input's
    dtype: computed in fp32 (``attention_ref`` upcasts q, k, v, so a GQA
    group's dk, dv are summed in fp32) and rounded once.

    The plain backward the CUDA backward kernel is held against on the card;
    the reference has no backward kernel and differentiates its jnp attention
    the same way.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal, window, softcap)
        return torch.autograd.grad(out, leaves, do)
