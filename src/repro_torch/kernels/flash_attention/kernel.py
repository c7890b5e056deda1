"""Binding of the hand-written Hopper flash-attention kernels.

``csrc/flash_attention.cu`` (forward) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:96`` (``flash_attention_kernel``);
its header says what bounds it and how its design answers that.  Built with
``nvcc`` at first use (``kernels/_build.py``) and called through ``ctypes``.

Layout: q ``[B,H,Sq,hd]``, k/v ``[B,KV,Skv,hd]``, as in the reference.  The
kernel takes strides, so a transposed view of the model's ``[B,S,H,hd]``
tensors is passed without a copy; the output has q's strides and dtype.  In
bf16 the C function encodes a TMA tensor map of each input's strided view per
call (``cuTensorMapEncodeTiled``, reached through the CUDA runtime's driver
entry point, so the library links no ``libcuda``).

``csrc/flash_attention_bwd.cu`` is its gradient (the reference has no
backward kernel; it differentiates its jnp attention): three launches a
call, no atomics, the same bits on every run.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import load_library

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bwd():
    fn = load_library("flash_attention_bwd.cu").repro_flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fwd():
    fn = load_library("flash_attention.cu").repro_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _layout_ok(t: torch.Tensor) -> bool:
    """16-byte vector loads: unit-stride head dim, other strides multiples of
    8 elements, 16-byte aligned base."""
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,Sq,hd] and k, v [B,KV,Skv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         "(batch, head dim, or H not a multiple of KV)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes "
                         "float32 or bfloat16, the same for q, k and v")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instantiation {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device")
        if not _layout_ok(t):
            raise ValueError(f"{name} strides {t.stride()} / alignment not supported: "
                             "head dim must be unit-stride, other strides multiples of 8")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} / heads {H} exceed the launch grid")


def flash_attention_kernel(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the CUDA kernel on q's current stream; raises on any input the
    kernel does not take and on any launch error."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)       # same strides as q (dense, non-overlapping)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fwd()(
            _DTYPE_CODES[q.dtype], hd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KV, Sq, Skv, strides, int(causal), int(window),
            float(softcap), 1.0 / math.sqrt(hd), stream,
        )
    if err == -2:
        raise RuntimeError("flash attention: the TMA tensor maps could not be encoded "
                           f"(strides {list(strides)})")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (cudaError {err})")
    flash_attention_kernel.launches += 1
    return o


flash_attention_kernel.launches = 0   # kernel launches since the last reset


def flash_attention_bwd_kernel(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    do: torch.Tensor,     # gradient of the output, any strides
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward kernel's output, each in its input's dtype
    and layout, from the CUDA backward kernels on q's current stream (they
    recompute what they use from q, k, v, so the output is not an input);
    raises on any input they do not take and on any launch error.  A ``do``
    whose strides the kernels do not take (an expanded or transposed
    gradient) is copied contiguous first."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device} does not match "
                         f"q {tuple(q.shape)} {q.dtype} on {q.device}")
    _check(q, k, v)
    if not _layout_ok(do):
        do = do.contiguous()
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    tensors = (q, k, v, do, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 21)(*(s for t in tensors for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bwd()(
            _DTYPE_CODES[q.dtype], hd, ptrs, lse.data_ptr(), delta.data_ptr(),
            B, H, KV, Sq, Skv, strides, int(causal), int(window),
            float(softcap), 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed (cudaError {err})")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0   # calls (three kernels each) since the last reset
