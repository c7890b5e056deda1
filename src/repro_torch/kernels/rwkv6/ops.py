"""Public WKV-6 entry: the CUDA kernel on the card, the plain PyTorch version
on the CPU."""
from __future__ import annotations

import torch

from .kernel import wkv6_kernel
from .ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw [B,H,S,hd], u [H,hd] -> (out [B,H,S,hd], S_last [B,H,hd,hd]), fp32.

    A CPU tensor goes to :func:`wkv6_ref`; any other goes to the kernel, which
    launches or raises (there is no fallback to the plain version).  On the
    card a call whose inputs need a gradient raises ``NotImplementedError``
    (no backward kernel yet; the plain version on the CPU is
    differentiable).  The reference's ``chunk`` is a tiling choice that does
    not change the result (its chunk-invariance test); the kernel's chunk is
    fixed at 32 tokens.
    """
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u)):
        raise NotImplementedError(
            "wkv6 on the card has no backward kernel yet, so a gradient through it "
            "would be lost: ROADMAP A17")
    return wkv6_kernel(r, k, v, logw, u)
