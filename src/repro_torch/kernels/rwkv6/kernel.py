"""Binding of the hand-written Hopper WKV-6 kernel.

``csrc/wkv6.cu`` replaces the Pallas TPU kernel
``repro/kernels/rwkv6/kernel.py:82`` (``wkv6_kernel``); its header says what
bounds it and how its design answers that.  Built with ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes``.

Layout: r, k, v, logw ``[B,H,S,hd]`` and u ``[H,hd]``, fp32, as in the
reference.  The kernel takes strides, so a transposed view of the model's
``[B,S,H,hd]`` tensors is passed without a copy; ``out`` has r's strides.
Any ``S`` is taken: the last chunk may be ragged.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library

HEAD_DIMS = (16, 32, 64)


@functools.cache
def _fwd():
    fn = load_library("wkv6.cu").repro_wkv6_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, logw, u) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"expected r, k, v, logw [B,H,S,hd] of one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, _, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} is not [H, hd] = {(H, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instantiation {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device")
        # 16-byte vector loads: unit-stride head dim, aligned rows
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} / alignment not supported: "
                             "head dim must be unit-stride, other strides multiples of 4")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} / heads {H} exceed the launch grid")


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on r's current stream; raises on any input the
    kernel does not take and on any launch error.  Returns (out [B,H,S,hd]
    with r's strides, S_last [B,H,hd,hd]), fp32, from a zero state."""
    _check(r, k, v, logw, u)
    B, H, S, hd = r.shape
    out = torch.empty_like(r)      # same strides as r (dense, non-overlapping)
    s_last = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    if B * H == 0:
        return out, s_last
    strides = (ctypes.c_longlong * 16)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
        *out.stride()[:3], u.stride(0),
    )
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _fwd()(hd, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                     u.data_ptr(), out.data_ptr(), s_last.data_ptr(), B, H, S, strides,
                     stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (cudaError {err})")
    wkv6_kernel.launches += 1
    return out, s_last


wkv6_kernel.launches = 0   # kernel launches since the last reset
