"""Public flash-attention entry: the CUDA kernels on the card, the plain
PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import flash_attention_bwd_kernel, flash_attention_kernel
from .ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """Forward through the forward kernel, backward through the backward
    kernel; nothing in between runs the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, do, causal=causal, window=window,
                                                softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,KV,Skv,hd] -> [B,H,Sq,hd] in q's dtype.

    A CPU tensor goes to :func:`attention_ref` (differentiated by autograd);
    any other goes to the kernels, which launch or raise (there is no
    fallback to the plain version): the forward kernel, and the backward
    kernel when a gradient flows back through the call.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, softcap)
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
