"""Binding of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:96`` (``flash_attention_kernel``);
its header says what bounds it and how its design answers that.  Built with
``nvcc`` at first use (``kernels/_build.py``) and called through ``ctypes``.

Layout: q ``[B,H,Sq,hd]``, k/v ``[B,KV,Skv,hd]``, as in the reference.  The
kernel takes strides, so a transposed view of the model's ``[B,S,H,hd]``
tensors is passed without a copy; the output has q's strides and dtype.
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
        # 16-byte vector loads: unit-stride head dim, aligned rows
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
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
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (cudaError {err})")
    flash_attention_kernel.launches += 1
    return o


flash_attention_kernel.launches = 0   # kernel launches since the last reset
