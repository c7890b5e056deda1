"""Public flash-attention entry: the CUDA kernel on the card, the plain
PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import flash_attention_kernel
from .ref import attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,KV,Skv,hd] -> [B,H,Sq,hd] in q's dtype.

    A CPU tensor goes to :func:`attention_ref`; any other goes to the kernel,
    which launches or raises (there is no fallback to the plain version).
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, softcap)
    return flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap)
