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
backward kernel; it differentiates its jnp attention): a pass for D, then dq
and dk / dv in two kernels, no atomics, the same bits on every run.  It
takes what a training forward (``with_lse=True``) keeps: the output, each
row's log-sum-exp and, in bf16, the output's residual.

On meta tensors (the dry-run) both wrappers run their checks and
allocations, then return before the launch (``kernels/cost.py``); the
backward sizes its split scratch from :func:`kv_split`, a copy of the C
rule at the card's SM count.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .._build import load_library
from ..cost import KernelCost, meta_call, nbytes, unit_of, visible_pairs

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132   # the SMs of an H100 SXM, which the C rule reads from the device


class SavedForward(NamedTuple):
    """What a training forward hands the backward kernel."""

    o: torch.Tensor              # the output
    lse: torch.Tensor            # fp32 [B, H, lse_rows(Sq)]: each row's base-2 log-sum-exp
    o_res: torch.Tensor | None   # bf16: o_fp32 - o, o's strides; None in fp32


def lse_rows(sq: int) -> int:
    """Rows of the log-sum-exp buffer: Sq rounded up to the kernels' 128-row
    tiles (the backward writes the rows past Sq)."""
    return -(-sq // 128) * 128


def kv_split(dtype: torch.dtype, head_dim: int, B: int, H: int, KV: int, Skv: int) -> int:
    """Chunks of a group's heads the bf16 dk / dv kernel splits into: a copy
    of ``kv_split`` in ``csrc/flash_attention_bwd.cu`` (which reads the SM
    count from the device; here ``H100_SMS``) for meta tensors, held to it on
    the card by ``chip_smoke.py`` phase 20."""
    if dtype != torch.bfloat16 or head_dim not in (64, 128):
        return 1
    tiles = -(-Skv // 128) * B * KV
    if tiles >= H100_SMS:
        return 1
    return min(-(-H100_SMS // tiles), H // KV)


def flash_attention_cost(q, k, v, causal: bool = True, window: int = 0,
                         with_lse: bool = False, q_offset: int = 0) -> KernelCost:
    """The forward's least work: q k^T and P v over the visible pairs (2
    products of 2 hd operations a pair and head; query positions from
    ``q_offset``); q, k, v read and the output written once (with
    ``with_lse`` also the log-sum-exp and, in bf16, the residual)."""
    B, H, Sq, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[2], causal, window, q_offset)
    out = nbytes(q) * (2 if with_lse and q.dtype == torch.bfloat16 else 1)
    lse = 4 * B * H * lse_rows(Sq) if with_lse else 0
    return KernelCost(4 * B * H * hd * pairs, nbytes(q, k, v) + out + lse, unit_of(q.dtype))


def flash_attention_bwd_cost(q, k, v, causal: bool = True, window: int = 0,
                             q_offset: int = 0) -> KernelCost:
    """The backward's least work: q k^T, dO v^T, P^T dO, dS^T q and dS k
    over the visible pairs (5 products; query positions from
    ``q_offset``); q, k, v and dO read, dq, dk and dv written once."""
    B, H, Sq, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[2], causal, window, q_offset)
    return KernelCost(10 * B * H * hd * pairs, nbytes(q, k, v, q) + nbytes(q, k, v),
                      unit_of(q.dtype))


@functools.cache
def _bwd_split():
    fn = load_library("flash_attention_bwd.cu").repro_flash_attention_bwd_split
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    fn = load_library("flash_attention_bwd.cu").repro_flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fwd():
    fn = load_library("flash_attention.cu").repro_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
        + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
        if t.device.type not in ("cuda", "meta") or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes tensors on "
                             "one CUDA device (or meta)")
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
    with_lse: bool = False,
    q_offset: int = 0,
) -> torch.Tensor | SavedForward:
    """Launch the CUDA kernel on q's current stream; raises on any input the
    kernel does not take and on any launch error.

    With ``with_lse`` (training) the kernel also writes what the backward
    kernel takes, and the call returns it as a :class:`SavedForward`; bf16
    then runs the forward's training instantiation, whose P v also takes
    the product of P's bf16 residual.  Without it (serving) nothing else is
    written.  ``q_offset`` is the position of query row 0 (keys start at
    0): a rank of a sequence-sharded (WSP) zone passes its first position.
    """
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset}: query positions start at 0 or later")
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)       # same strides as q (dense, non-overlapping)
    lse = o_res = None
    if with_lse:
        lse = torch.empty(B, H, lse_rows(Sq), dtype=torch.float32, device=q.device)
        if q.dtype == torch.bfloat16:
            o_res = torch.empty_like(o)
    if o.numel() == 0:
        return SavedForward(o, lse, o_res) if with_lse else o
    if q.device.type == "meta":
        meta_call("flash_attention_kernel",
                  flash_attention_cost(q, k, v, causal, window, with_lse, q_offset))
        return SavedForward(o, lse, o_res) if with_lse else o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fwd()(
            _DTYPE_CODES[q.dtype], hd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if o_res is None else o_res.data_ptr(), lse_rows(Sq),
            B, H, KV, Sq, Skv, strides, int(causal), int(window), int(q_offset),
            float(softcap), 1.0 / math.sqrt(hd), stream,
        )
    if err == -2:
        raise RuntimeError("flash attention: the TMA tensor maps could not be encoded "
                           f"(strides {list(strides)})")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (cudaError {err})")
    flash_attention_kernel.launches += 1
    return SavedForward(o, lse, o_res) if with_lse else o


flash_attention_kernel.launches = 0   # kernel launches since the last reset


def _check_saved(q: torch.Tensor, saved: SavedForward) -> None:
    o, lse, o_res = saved
    B, H, Sq, _ = q.shape
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device or not _layout_ok(o):
        raise ValueError(f"saved output {tuple(o.shape)} {o.dtype} on {o.device} (strides "
                         f"{o.stride()}) does not match q {tuple(q.shape)} {q.dtype}")
    if (lse is None or lse.shape != (B, H, lse_rows(Sq)) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("saved log-sum-exp must be the forward's fp32 "
                         f"[{B}, {H}, {lse_rows(Sq)}]: flash_attention_kernel(..., "
                         "with_lse=True)")
    if (o_res is None) != (q.dtype != torch.bfloat16) or (
            o_res is not None and (o_res.shape != o.shape or o_res.dtype != o.dtype
                                   or o_res.stride() != o.stride()
                                   or o_res.device != q.device)):
        raise ValueError("the saved output's residual must be given in bf16 (o's shape "
                         "and strides) and only there")


def flash_attention_bwd_kernel(
    q: torch.Tensor,      # [B, H, Sq, hd]
    k: torch.Tensor,      # [B, KV, Skv, hd]
    v: torch.Tensor,
    do: torch.Tensor,     # gradient of the output, any strides
    saved: SavedForward,  # flash_attention_kernel(q, k, v, ..., with_lse=True)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward kernel's output, each in its input's dtype
    and layout, from the CUDA backward kernels on q's current stream (they
    recompute P from q, k and the forward's log-sum-exp, and take D from its
    output); raises on any input they do not take and on any launch error.
    A ``do`` whose strides the kernels do not take (an expanded or
    transposed gradient) is copied contiguous first.  The rows of
    ``saved.lse`` past Sq are scratch.  ``q_offset`` is the forward's: a
    key no query sees gets dk = dv = 0."""
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset}: query positions start at 0 or later")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device} does not match "
                         f"q {tuple(q.shape)} {q.dtype} on {q.device}")
    _check(q, k, v)
    _check_saved(q, saved)
    if not _layout_ok(do):
        do = do.contiguous()
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, *saved.lse.shape), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, do, saved.o, saved.o_res, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 9)(*(None if t is None else t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 27)(*(s for t in tensors
                                         for s in (t.stride()[:3] if t is not None else (0,) * 3)))
    # a group too few blocks cover is split over more, into fp32 partial sums
    meta = q.device.type == "meta"
    if meta:
        split = kv_split(q.dtype, hd, B, H, KV, Skv)
    else:
        with torch.cuda.device(q.device):
            split = _bwd_split()(_DTYPE_CODES[q.dtype], hd, B, H, KV, Skv)
    part = (torch.empty(2 * split * B * KV * Skv * hd, dtype=torch.float32, device=q.device)
            if split > 1 else None)
    if meta:
        meta_call("flash_attention_bwd_kernel",
                  flash_attention_bwd_cost(q, k, v, causal, window, q_offset))
        return dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bwd()(
            _DTYPE_CODES[q.dtype], hd, ptrs, saved.lse.data_ptr(), stats.data_ptr(),
            lse_rows(Sq), None if part is None else part.data_ptr(), B, H, KV, Sq, Skv,
            strides, int(causal), int(window), int(q_offset), float(softcap),
            1.0 / math.sqrt(hd), stream,
        )
    if err == -2:
        raise RuntimeError("flash attention backward: the TMA tensor maps could not be "
                           f"encoded (strides {list(strides)})")
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed (cudaError {err})")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0   # calls (three kernels each) since the last reset
