"""Public int8 matrix-product entry (port of ``repro/kernels/qmatmul/ops.py``):
the CUDA kernel on the card, the plain PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import check_blocks, qmatmul_kernel
from .ref import qmatmul_ref, quantize_cols, quantize_rows  # noqa: F401


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor, block_m: int = 128, block_n: int = 128,
            block_k: int = 128, impl: str = "kernel") -> torch.Tensor:
    """x_q [M,K] int8, w_q [K,N] int8, x_scale [M], w_scale [N] fp32 ->
    [M,N] fp32: ``(float(x_q @ w_q) * x_scale[:, None]) * w_scale[None, :]``
    with the int32 sum exact over all of K.

    ``impl="ref"`` is the plain version on any device.  Otherwise a CPU
    tensor goes to :func:`qmatmul_ref`, and any other to the kernel, which
    launches or raises (there is no fallback to the plain version); a meta
    tensor takes the kernel's route too, which allocates and launches nothing.

    The blocks are checked as the reference checks them (each dimension a
    multiple of ``min(block, dim)``, so M = 100 passes with the default 128
    and M = 200 does not), then ignored: they are the TPU kernel's tiling and
    do not change an exact int32 sum.  The kernel itself takes any M, N,
    K >= 1.
    """
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl {impl!r}: 'kernel' or 'ref'")
    check_blocks(block_m, block_n, block_k)
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"expected x_q [M,K] and w_q [K,N]; got {tuple(x_q.shape)}, "
                         f"{tuple(w_q.shape)}")
    (M, K), N = x_q.shape, w_q.shape[1]
    for name, dim, block in (("M", M, block_m), ("N", N, block_n), ("K", K, block_k)):
        if dim < 1 or dim % min(block, dim):
            raise ValueError(f"{name} = {dim} is not a multiple of min(block, {name}) = "
                             f"{min(block, dim)}, as the reference requires")
    if impl == "ref" or x_q.device.type == "cpu":
        return qmatmul_ref(x_q, w_q, x_scale, w_scale)
    return qmatmul_kernel(x_q, w_q, x_scale, w_scale, block_m, block_n, block_k)
