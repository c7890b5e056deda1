"""Public flash-attention entry: the CUDA kernels on the card, the plain
PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import SavedForward, flash_attention_bwd_kernel, flash_attention_kernel
from .ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """Forward through the forward kernel, backward through the backward
    kernel; nothing in between runs the plain version.  ``keep`` (a
    gradient will be asked for) makes the forward keep what the backward
    takes; without it the forward writes its output alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, keep):
        ctx.mask = (causal, window, softcap, q_offset)
        if not keep:
            return flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                                          q_offset=q_offset)
        saved = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                                       with_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, *saved)
        return saved.o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, o_res = ctx.saved_tensors
        causal, window, softcap, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, do, SavedForward(o, lse, o_res),
                                                causal=causal, window=window, softcap=softcap,
                                                q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,KV,Skv,hd] -> [B,H,Sq,hd] in q's dtype.

    A CPU tensor goes to :func:`attention_ref` (differentiated by autograd);
    any other goes to the kernels, which launch or raise (there is no
    fallback to the plain version): the forward kernel, and the backward
    kernel when a gradient flows back through the call.  A meta tensor
    takes the kernels' route too, which allocates and launches nothing.
    ``q_offset`` puts query row 0 at that position (keys start at 0), in
    the forward and the backward.
    """
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, softcap, q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, q_offset, keep)
