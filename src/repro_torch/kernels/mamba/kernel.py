"""Binding of the hand-written Hopper selective-scan kernel.

``csrc/mamba_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/mamba/kernel.py:61`` (``mamba_scan_kernel``); its header says
what bounds it and how its design answers that.  Built with ``nvcc`` at
first use (``kernels/_build.py``) and called through ``ctypes``.

Layout: dt, x ``[B,S,di]``, A ``[di,N]``, Bc, Cc ``[B,S,N]``, D ``[di]``, as
in the reference.  dt, A and D are fp32; x, Bc and Cc share one dtype, fp32
or bf16, as the model holds them.  Bc and Cc may be any strided view (the
model passes column slices of the ``x_proj`` output), so nothing is copied.
Any ``S`` and any ``di`` are taken.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library

STATE_SIZES = (4, 8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    fn = load_library("mamba_scan.cu").repro_mamba_scan_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(dt, x, A, Bc, Cc, D) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"expected dt, x [B,S,di] of one shape; got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, S, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A {tuple(A.shape)} is not [di, N] with di = {di}")
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size N = {N} has no kernel instantiation {STATE_SIZES}")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != (B, S, N):
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, S, N] = {(B, S, N)}")
    if tuple(D.shape) != (di,):
        raise ValueError(f"D {tuple(D.shape)} is not [di] = {(di,)}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x is {x.dtype}: the kernel takes float32 or bfloat16")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}: the kernel takes "
                             "one dtype for x, Bc and Cc")
    for name, t in (("dt", dt), ("x", x), ("A", A), ("Bc", Bc), ("Cc", Cc), ("D", D)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device")
    for name, t in (("dt", dt), ("x", x)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: the channel dim must be "
                             "unit-stride")
    for name, t in (("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid")


def mamba_scan_kernel(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                      Cc: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on x's current stream; raises on any input the
    kernel does not take and on any launch error.  Returns (y [B,S,di],
    h_last [B,di,N]), contiguous fp32, from a zero state."""
    _check(dt, x, A, Bc, Cc, D)
    B, S, di = x.shape
    N = A.shape[1]
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    h_last = torch.empty(B, di, N, dtype=torch.float32, device=x.device)
    if B * di == 0:
        return y, h_last
    strides = (ctypes.c_longlong * 10)(
        *dt.stride()[:2], *x.stride()[:2], *Bc.stride(), *Cc.stride(),
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fwd()(N, _DTYPE_CODES[x.dtype], dt.data_ptr(), x.data_ptr(), A.data_ptr(),
                     Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), B, S, di, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed (cudaError {err})")
    mamba_scan_kernel.launches += 1
    return y, h_last


mamba_scan_kernel.launches = 0   # kernel launches since the last reset
