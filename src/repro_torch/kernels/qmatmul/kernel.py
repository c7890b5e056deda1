"""Binding of the hand-written Hopper int8 matrix-product kernel.

``csrc/qmatmul.cu`` replaces the Pallas TPU kernel
``repro/kernels/qmatmul/kernel.py:43`` (``qmatmul_kernel``); its header says
what bounds it and how its design answers that.  Built with ``nvcc`` at
first use (``kernels/_build.py``) and called through ``ctypes``.

Layout as in the reference: x [M,K] and w [K,N] int8, both contiguous;
x_scale [M] and w_scale [N] fp32.  Any M, N, K >= 1 is taken: the kernels
zero-fill ragged tiles, where the reference asserts that each dimension is
a multiple of its block (or smaller than it).

A call takes one of two paths, chosen by :func:`tma_path` from the shape and
x's alignment alone: the transpose of w into an [N,K] scratch and the
``wgmma`` / TMA kernel where TMA can describe x (K % 16 == 0, x 16-byte
aligned), else the byte-staged ``mma.sync`` kernel.

On meta tensors (the dry-run) the wrapper runs its checks and allocations,
the transposed ``wt`` included, then returns before the launch
(``kernels/cost.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library
from ..cost import KernelCost, meta_call, nbytes

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    fn = load_library("qmatmul.cu").repro_qmatmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tma_path(K: int, x_ptr: int) -> bool:
    """Whether a call goes through the ``wgmma`` / TMA kernel: TMA needs each
    row of x and of the transposed w (K bytes) and x's base on 16-byte
    bounds.  Otherwise the byte-staged ``mma.sync`` kernel takes it."""
    return K % 16 == 0 and x_ptr % 16 == 0


def qmatmul_cost(x, w, out_dtype: torch.dtype = torch.float32) -> KernelCost:
    """The least work: 2 M N K int8 operations; x, w and the two scales read,
    the [M, N] output written once."""
    (M, K), N = x.shape, w.shape[1]
    return KernelCost(2 * M * N * K, nbytes(x, w) + 4 * (M + N) + out_dtype.itemsize * M * N,
                      "int8")


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
        if t.device.type not in ("cuda", "meta") or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device (or meta)")


def qmatmul_kernel(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, block_m: int = 128, block_n: int = 128,
                   block_k: int = 128, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernels of one path (:func:`tma_path`) on x's current
    stream; raises on any input they do not take and on any launch error.
    Returns
    ``(float(x @ w) * x_scale[:, None]) * w_scale[None, :]`` [M,N] in
    ``out_dtype``, the int32 sum exact over all of K.

    ``block_m``, ``block_n``, ``block_k`` are the reference's VMEM tiling;
    they do not change an exact int32 sum, and the kernels' own tiles are
    fixed (``wgmma`` path: 128 x 256 output tiles, K slices of 128 bytes;
    ``mma.sync`` path: 128 x 128, K steps of 64), so they are checked and
    ignored.
    """
    check_blocks(block_m, block_n, block_k)
    _check(x, w, x_scale, w_scale, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    tma = tma_path(K, x.data_ptr())
    # w transposed by the first launch: the K-major B operand of 8-bit wgmma
    wt = torch.empty(N, K, dtype=torch.int8, device=x.device) if tma else None
    if x.device.type == "meta":
        meta_call("qmatmul_kernel", qmatmul_cost(x, w, out_dtype))
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fwd()(x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                     out.data_ptr(), wt.data_ptr() if tma else None, M, N, K,
                     _OUT_DTYPES[out_dtype], int(tma), stream)
    if err != 0:
        raise RuntimeError(f"qmatmul kernel launch failed (error {err}: a cudaError, "
                           "or -2 for a tensor map TMA does not take)")
    qmatmul_kernel.launches += 1
    return out


qmatmul_kernel.launches = 0   # op calls that launched on the card since the last reset
