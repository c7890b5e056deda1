"""Plain PyTorch int8 matrix product and symmetric quantizers (port of
``repro/kernels/qmatmul/ref.py``).

The CPU path of :func:`..ops.qmatmul` and the oracle the CUDA kernel is held
against on the card, bit for bit.  The quantizers follow JAX's promotion: the
Python scalars are weak, so a bf16 input keeps ``amax``, the ``1e-8`` floor
and the ``/ 127`` in bf16 and only the scale is cast to fp32; ``torch.round``
rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization.  x [M, K] float ->
    (q [M, K] int8, scale [M] fp32)."""
    amax = x.abs().amax(dim=1)
    scale = torch.maximum(amax, torch.tensor(1e-8, dtype=x.dtype, device=x.device)) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column int8 quantization.  w [K, N] float ->
    (q [K, N] int8, contiguous as the kernel takes it; scale [N] fp32)."""
    q, s = quantize_rows(w.t())
    return q.t().contiguous(), s


def int_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``x_q @ w_q`` of int8 [M,K] and [K,N].

    The CPU multiplies in int32.  CUDA has no int32 matrix product, so on the
    card the product runs in float64 and is cast back: every partial sum is
    an integer of magnitude at most 128 * 128 * K, exactly representable in
    float64 (< 2^53), so every addition is exact in any order and the result
    equals the int32 sum wherever that does not overflow (K < 131072).
    """
    if x_q.device.type == "cpu":
        return torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def qmatmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_q [M,K] int8, w_q [K,N] int8, x_scale [M], w_scale [N] fp32 ->
    ``(acc.float() * x_scale[:, None]) * w_scale[None, :]`` [M,N] in
    ``out_dtype``, with acc the exact int32 product."""
    acc = int_matmul(x_q, w_q)
    return (acc.float() * x_scale[:, None] * w_scale[None, :]).to(out_dtype)
