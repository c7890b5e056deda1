"""Binding of the hand-written Hopper WKV-6 kernel.

``csrc/wkv6.cu`` replaces the Pallas TPU kernel
``repro/kernels/rwkv6/kernel.py:82`` (``wkv6_kernel``); its header says what
bounds it and how its design answers that.  Built with ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes``.

Layout: r, k, v, logw ``[B,H,S,hd]`` and u ``[H,hd]``, fp32, as in the
reference.  The kernel takes strides, so a transposed view of the model's
``[B,S,H,hd]`` tensors is passed without a copy; ``out`` has r's strides.
Any ``S`` is taken: the last chunk may be ragged.

One call runs three CUDA kernels over segments of ``SEGMENT`` tokens (the
segment states, their carry, the outputs; ``csrc/wkv6.cu``); the wrapper
allocates their scratch and counts the call once in ``launches``.

The backward (``csrc/wkv6_bwd.cu``, :func:`wkv6_bwd_kernel`) takes the
segments' input states the forward computes on its way
(``with_states=True``) and runs five CUDA kernels over the same segments
(its header says what bounds it and why its sweeps run in float64); it
too counts a call once.

On meta tensors (the dry-run) both wrappers run their checks and
allocations, then return before the launch (``kernels/cost.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library
from ..cost import KernelCost, meta_call, nbytes

HEAD_DIMS = (16, 32, 64)
SEGMENT = 256   # tokens per segment: a multiple of the kernel's 32-token chunk
CHUNK = 32      # tokens per chunk of the kernel's chunk form


def n_segment_slots(S: int) -> int:
    """Segment input states the forward keeps: one per segment but the first."""
    return max(1, -(-S // SEGMENT)) - 1


def wkv6_cost(r, k, v, logw, u, with_states: bool = False) -> KernelCost:
    """The forward's least work, fp32: the chunk form at chunk T = min(32,
    S), 4 T hd + 4 hd^2 operations a token and head; r, k, v, logw and u
    read, the output and S_last (and the segment states) written once."""
    B, H, S, hd = r.shape
    T = min(CHUNK, S)
    states = 4 * B * H * n_segment_slots(S) * hd * hd if with_states else 0
    return KernelCost(B * H * S * (4 * T * hd + 4 * hd * hd),
                      nbytes(r, k, v, logw, u, r) + 4 * B * H * hd * hd + states, "fp32")


def wkv6_bwd_cost(r, k, v, logw, u, seg_state) -> KernelCost:
    """The backward's least work, fp32: dr, dk, dv (three mat-vecs) and the
    S and G updates, 2 hd^2 operations each a token and head; r, k, v, logw,
    dout, u and the segment states read, dr, dk, dv, dlogw and du written
    once."""
    B, H, S, hd = r.shape
    return KernelCost(10 * B * H * S * hd * hd,
                      4 * (9 * B * H * S * hd + seg_state.numel() + 2 * H * hd), "fp32")


@functools.cache
def _fwd():
    fn = load_library("wkv6.cu").repro_wkv6_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    fn = load_library("wkv6_bwd.cu").repro_wkv6_bwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
    if t.device.type not in ("cuda", "meta") or t.device != device:
        raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                         "one CUDA device (or meta)")
    # 16-byte vector loads: unit-stride head dim, aligned rows
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} strides {t.stride()} / alignment not supported: "
                         "head dim must be unit-stride, other strides multiples of 4")


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
        _check_operand(name, t, r.device)
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} / heads {H} exceed the launch grid")


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, with_states: bool = False):
    """Launch the CUDA kernels on r's current stream; raises on any input
    they do not take and on any launch error.  Returns (out [B,H,S,hd] with
    r's strides, S_last [B,H,hd,hd]), fp32, from a zero state; with
    ``with_states`` also the input state of every segment but the first,
    ``[B,H,n_seg-1,hd,hd]`` (what :func:`wkv6_bwd_kernel` takes; the
    forward computes them anyway).

    ``launches`` counts calls, one per call however many kernels the call
    runs, so it reads as calls per prefill.
    """
    _check(r, k, v, logw, u)
    B, H, S, hd = r.shape
    out = torch.empty_like(r)      # same strides as r (dense, non-overlapping)
    s_last = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    slots = n_segment_slots(S)
    seg_state = torch.empty(B, H, slots, hd, hd, dtype=torch.float32, device=r.device)
    if B * H == 0:
        return (out, s_last, seg_state) if with_states else (out, s_last)
    seg_decay = torch.empty(B, H, slots, hd, dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        meta_call("wkv6_kernel", wkv6_cost(r, k, v, logw, u, with_states))
        return (out, s_last, seg_state) if with_states else (out, s_last)
    strides = (ctypes.c_longlong * 16)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
        *out.stride()[:3], u.stride(0),
    )
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _fwd()(hd, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                     u.data_ptr(), out.data_ptr(), s_last.data_ptr(), seg_state.data_ptr(),
                     seg_decay.data_ptr(), B, H, S, SEGMENT, strides, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (cudaError {err})")
    wkv6_kernel.launches += 1
    return (out, s_last, seg_state) if with_states else (out, s_last)


wkv6_kernel.launches = 0   # calls that launched the kernels, since the last reset


def wkv6_bwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    u: torch.Tensor, seg_state: torch.Tensor, dout: torch.Tensor,
                    ds_last: torch.Tensor | None = None):
    """The gradient of :func:`wkv6_kernel`'s (out, S_last) at (dout,
    ds_last), ``ds_last=None`` a zero cotangent: (dr, dk, dv, dlogw) with
    their inputs' strides and du [H, hd], fp32.  ``seg_state`` is what the
    forward returned with ``with_states=True`` for the same inputs.  Runs
    on r's current stream; raises on any input it does not take and on any
    launch error.  ``launches`` counts calls.
    """
    _check(r, k, v, logw, u)
    B, H, S, hd = r.shape
    if dout.shape != r.shape:
        raise ValueError(f"dout {tuple(dout.shape)} is not {tuple(r.shape)}")
    if dout.stride(-1) != 1 or any(s % 4 for s in dout.stride()[:-1]) or dout.data_ptr() % 16:
        dout = dout.contiguous()
    _check_operand("dout", dout, r.device)
    slots = n_segment_slots(S)
    if tuple(seg_state.shape) != (B, H, slots, hd, hd) or not seg_state.is_contiguous():
        raise ValueError(f"seg_state {tuple(seg_state.shape)} is not a contiguous "
                         f"{(B, H, slots, hd, hd)}")
    _check_operand("seg_state", seg_state, r.device)
    if ds_last is not None:
        if tuple(ds_last.shape) != (B, H, hd, hd):
            raise ValueError(f"ds_last {tuple(ds_last.shape)} is not {(B, H, hd, hd)}")
        ds_last = ds_last.contiguous()
        _check_operand("ds_last", ds_last, r.device)
    grads = [torch.empty_like(t) for t in (r, k, v, logw)]   # the inputs' strides
    du = torch.empty(H, hd, dtype=torch.float32, device=r.device)
    if B * H * S == 0:
        for g in grads:
            g.zero_()
        return (*grads, du.zero_())
    n_seg = slots + 1
    f32 = dict(dtype=torch.float32, device=r.device)
    f64 = dict(dtype=torch.float64, device=r.device)
    gstate = torch.empty(B, H, slots, hd, hd, **f32)
    gdecay = torch.empty(B, H, slots, hd, **f32)
    ptot = torch.empty(B, H, hd, **f64) if ds_last is not None else None
    abuf = torch.empty(B, H, S, hd, **f64)
    du_part = torch.empty(B, H, n_seg, hd, **f64)
    if r.device.type == "meta":
        meta_call("wkv6_bwd_kernel", wkv6_bwd_cost(r, k, v, logw, u, seg_state))
        return (*grads, du)
    strides = (ctypes.c_longlong * 28)(
        *(s for t in (r, k, v, logw, dout, *grads) for s in t.stride()[:3]), u.stride(0))
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _bwd()(hd, *(ptr(t) for t in (r, k, v, logw, u, dout, ds_last, seg_state,
                                            *grads, du, gstate, gdecay, ptot, abuf, du_part)),
                     B, H, S, SEGMENT, strides, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward kernel launch failed (cudaError {err})")
    wkv6_bwd_kernel.launches += 1
    return (*grads, du)


wkv6_bwd_kernel.launches = 0   # calls that launched the backward kernels, since the last reset
