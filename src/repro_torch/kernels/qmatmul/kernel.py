"""Binding of the hand-written Hopper int8 matrix-product kernel.

``csrc/qmatmul.cu`` replaces the Pallas TPU kernel
``repro/kernels/qmatmul/kernel.py:43`` (``qmatmul_kernel``); its header says
what bounds it and how its design answers that.  Built with ``nvcc`` at
first use (``kernels/_build.py``) and called through ``ctypes``.

Layout as in the reference: x [M,K] and w [K,N] int8, both contiguous;
x_scale [M] and w_scale [N] fp32.  Any M, N, K >= 1 is taken: the kernel
zero-fills ragged tiles, where the reference asserts that each dimension is
a multiple of its block (or smaller than it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    fn = load_library("qmatmul.cu").repro_qmatmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_blocks(block_m: int, block_n: int, block_k: int) -> None:
    for name, b in (("block_m", block_m), ("block_n", block_n), ("block_k", block_k)):
        if not isinstance(b, int) or b < 1:
            raise ValueError(f"{name} = {b!r}: blocks are positive integers")


def _check(x, w, x_scale, w_scale, out_dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x [M,K] and w [K,N]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"empty product: M={M}, N={N}, K={K}")
    if tuple(x_scale.shape) != (M,) or tuple(w_scale.shape) != (N,):
        raise ValueError(f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)} "
                         f"are not [M] = {(M,)}, [N] = {(N,)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.int8:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes int8")
    for name, t in (("x_scale", x_scale), ("w_scale", w_scale)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes float32 or bfloat16")
    tensors = (("x", x), ("w", w), ("x_scale", x_scale), ("w_scale", w_scale))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device")


def qmatmul_kernel(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, block_m: int = 128, block_n: int = 128,
                   block_k: int = 128, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on x's current stream; raises on any input the
    kernel does not take and on any launch error.  Returns
    ``(float(x @ w) * x_scale[:, None]) * w_scale[None, :]`` [M,N] in
    ``out_dtype``, the int32 sum exact over all of K.

    ``block_m``, ``block_n``, ``block_k`` are the reference's VMEM tiling;
    they do not change an exact int32 sum, and the kernel's own tiles are
    fixed (128 x 128, K steps of 64), so they are checked and ignored.
    """
    check_blocks(block_m, block_n, block_k)
    _check(x, w, x_scale, w_scale, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    vec = int(K % 16 == 0 and N % 4 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fwd()(x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                     out.data_ptr(), M, N, K, _OUT_DTYPES[out_dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"qmatmul kernel launch failed (cudaError {err})")
    qmatmul_kernel.launches += 1
    return out


qmatmul_kernel.launches = 0   # kernel launches since the last reset
