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

The backward (``csrc/mamba_scan_bwd.cu``, :func:`mamba_scan_bwd_kernel`)
takes the state at the start of every ``CHUNK``-token chunk, which the
forward writes on its way with ``with_states=True``, and runs two CUDA
kernels (the reverse sweep per block of channels, then the fixed-order sums
of its partials); it counts a call once.  Its header says what bounds it.

On meta tensors (the dry-run) both wrappers run their checks and
allocations, then return before the launch (``kernels/cost.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library
from ..cost import KernelCost, meta_call, nbytes
from .ref import BLOCK, CHUNK

STATE_SIZES = (4, 8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    fn = load_library("mamba_scan.cu").repro_mamba_scan_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    fn = load_library("mamba_scan_bwd.cu").repro_mamba_scan_bwd
    fn.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def n_state_slots(S: int) -> int:
    """Chunk states the forward keeps: one per ``CHUNK``-token chunk but the first."""
    return max(1, -(-S // CHUNK)) - 1


def mamba_scan_cost(dt, x, A, Bc, Cc, D, with_states: bool = False) -> KernelCost:
    """The forward's least work, fp32: per state update dt*A, exp, a*h + bx,
    (dt x)*B and y += C h (7 operations), per channel-token dt*x and y + D x;
    every input read once (B, C: the views' own elements), y and h_last
    (and the chunk states) written once."""
    B, S, di = x.shape
    N = A.shape[1]
    states = 4 * B * di * n_state_slots(S) * N if with_states else 0
    return KernelCost(B * S * di * (7 * N + 3),
                      nbytes(dt, x, A, Bc, Cc, D) + 4 * (B * S * di + B * di * N) + states,
                      "fp32")


def mamba_scan_bwd_cost(dt, x, A, Bc, Cc, D, states, grad_dtype=None) -> KernelCost:
    """The backward's least work, fp32: per state-token a_t (2), g (2), a h
    and h_t (3), the term and its dA (3), the sums over n for ddt and dx (4)
    and over the channels for dB and dC (4); per channel-token dt x, ddt, dx
    and dD (8).  Every input read once (B, C: the views' own elements), the
    chunk states and dy read, every gradient written once."""
    B, S, di = x.shape
    N = A.shape[1]
    g = (grad_dtype or x.dtype).itemsize
    grads = 4 * B * S * di + g * (B * S * di + 2 * B * S * N) + 4 * (di * N + di)
    return KernelCost(B * S * di * (18 * N + 8),
                      nbytes(dt, x, A, Bc, Cc, D, states) + 4 * B * S * di + grads, "fp32")


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
        if t.device.type not in ("cuda", "meta") or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device (or meta)")
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
                      Cc: torch.Tensor, D: torch.Tensor, with_states: bool = False):
    """Launch the CUDA kernel on x's current stream; raises on any input the
    kernel does not take and on any launch error.  Returns (y [B,S,di],
    h_last [B,di,N]), contiguous fp32, from a zero state; with
    ``with_states`` also h at the start of every ``CHUNK``-token chunk but
    the first, ``[B, di, n_chunks - 1, N]`` fp32 (what
    :func:`mamba_scan_bwd_kernel` takes)."""
    _check(dt, x, A, Bc, Cc, D)
    B, S, di = x.shape
    N = A.shape[1]
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    h_last = torch.empty(B, di, N, dtype=torch.float32, device=x.device)
    states = (torch.empty(B, di, n_state_slots(S), N, dtype=torch.float32, device=x.device)
              if with_states else None)
    out = (y, h_last, states) if with_states else (y, h_last)
    if B * di == 0:
        return out
    if x.device.type == "meta":
        meta_call("mamba_scan_kernel", mamba_scan_cost(dt, x, A, Bc, Cc, D, with_states))
        return out
    strides = (ctypes.c_longlong * 10)(
        *dt.stride()[:2], *x.stride()[:2], *Bc.stride(), *Cc.stride(),
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fwd()(N, _DTYPE_CODES[x.dtype], dt.data_ptr(), x.data_ptr(), A.data_ptr(),
                     Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), None if states is None else states.data_ptr(),
                     B, S, di, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed (cudaError {err})")
    mamba_scan_kernel.launches += 1
    return out


mamba_scan_kernel.launches = 0   # kernel launches since the last reset


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} {tuple(t.shape)} is not {shape}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on one CUDA "
                         "device")


def mamba_scan_bwd_kernel(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                          Cc: torch.Tensor, D: torch.Tensor, states: torch.Tensor,
                          dy: torch.Tensor, dh_last: torch.Tensor | None = None,
                          grad_dtype: torch.dtype | None = None):
    """The gradient of :func:`mamba_scan_kernel`'s (y, h_last) at (dy,
    dh_last), ``dh_last=None`` a zero cotangent: (ddt, dx, dA, dB, dC, dD),
    contiguous.  ddt, dA and dD are fp32; dx, dB and dC are in x's dtype, or
    in ``grad_dtype`` (float32, for the checks: the kernel computes them in
    fp32 and converts only as it stores them).  ``states`` is what the
    forward returned with ``with_states=True`` for the same inputs.  Runs on
    x's current stream; raises on any input it does not take and on any
    launch error.  ``launches`` counts calls (two CUDA kernels each).
    """
    _check(dt, x, A, Bc, Cc, D)
    B, S, di = x.shape
    N = A.shape[1]
    dev = x.device
    out_dtype = grad_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"grad_dtype {out_dtype}: the kernel writes x's dtype or float32")
    _check_f32("states", states, (B, di, n_state_slots(S), N), dev)
    if not states.is_contiguous():
        raise ValueError("states must be contiguous")
    _check_f32("dy", dy, (B, S, di), dev)
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dh_last is not None:
        _check_f32("dh_last", dh_last, (B, di, N), dev)
        dh_last = dh_last.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    grads = (torch.empty(B, S, di, **f32), torch.empty(B, S, di, dtype=out_dtype, device=dev),
             torch.empty(di, N, **f32), torch.empty(B, S, N, dtype=out_dtype, device=dev),
             torch.empty(B, S, N, dtype=out_dtype, device=dev), torch.empty(di, **f32))
    if B * S * di == 0:
        return tuple(g.zero_() for g in grads)
    n_blocks = -(-di // BLOCK)
    f64 = dict(dtype=torch.float64, device=dev)
    pB, pC = (torch.empty(B, S, n_blocks, N, **f64) for _ in range(2))   # per-block dB, dC
    pA, pD = torch.empty(B, di, N, **f64), torch.empty(B, di, **f64)     # per-row dA, dD
    if dev.type == "meta":
        meta_call("mamba_scan_bwd_kernel",
                  mamba_scan_bwd_cost(dt, x, A, Bc, Cc, D, states, out_dtype))
        return grads
    strides = (ctypes.c_longlong * 12)(
        *dt.stride()[:2], *x.stride()[:2], *Bc.stride(), *Cc.stride(), *dy.stride()[:2])
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    ddt, dx, dA, dB, dC, dD = grads
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _bwd()(N, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                     *(ptr(t) for t in (dt, x, A, Bc, Cc, D, states, dy, dh_last,
                                        ddt, dx, dB, dC, dA, dD, pB, pC, pA, pD)),
                     B, S, di, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan backward kernel launch failed (cudaError {err})")
    mamba_scan_bwd_kernel.launches += 1
    return grads


mamba_scan_bwd_kernel.launches = 0   # calls that launched the backward, since the last reset
