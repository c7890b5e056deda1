"""Public selective-scan entry: the CUDA kernel on the card, the plain
PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import mamba_scan_kernel
from .ref import mamba_scan_ref


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dt, x [B,S,di]; A [di,N]; Bc, Cc [B,S,N]; D [di] ->
    (y [B,S,di], h_last [B,di,N]), fp32, from a zero state.

    A CPU tensor goes to :func:`mamba_scan_ref`; any other goes to the
    kernel, which launches or raises (there is no fallback to the plain
    version).  The reference's ``block_d`` and ``chunk`` are tiling choices
    that do not change the result; the kernel's are fixed, and it takes any
    ``S``.
    """
    if x.device.type == "cpu":
        return mamba_scan_ref(dt, x, A, Bc, Cc, D)
    return mamba_scan_kernel(dt, x, A, Bc, Cc, D)
