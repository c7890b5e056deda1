"""Gradient compression: symmetric int8 quantization with error feedback.

Port of ``repro/runtime/compression.py``.  ``compress_decompress`` is the
stateless quantize -> dequantize the train step applies with
``compress=True``; its scale comes from the amax over the reference's whole
leaf, so a stacked leaf (one pattern slot's R layers) is passed as the list
of its layers and shares one scale.  ``ef_compress`` is the error-feedback
variant; ``psum_compressed``, the compressed data-parallel all-reduce,
runs over a mesh's data axis and comes with the pipeline runtime (ROADMAP
A13b).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _round(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = _scale(xf.abs().amax())
    return _round(xf, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(g: torch.Tensor | Sequence[torch.Tensor]):
    """Quantize -> dequantize one leaf: a tensor, or the layers of a stacked
    leaf (a list, returned as a list) under one scale, their joint amax."""
    layers = list(g) if isinstance(g, Sequence) else [g]
    if layers[0].dtype == torch.int32 or sum(t.numel() for t in layers) <= 1:
        return g
    scale = _scale(torch.stack([t.float().abs().amax() for t in layers]).amax())
    out = [(_round(t.float(), scale) * scale).to(t.dtype) for t in layers]
    return out if isinstance(g, Sequence) else out[0]


def ef_compress(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compression: returns (q, scale, new_residual)."""
    corrected = g.float() + residual
    q, s = quantize_int8(corrected)
    return q, s, corrected - dequantize_int8(q, s)


def psum_compressed(g: torch.Tensor, residual: torch.Tensor, axis_name: str):
    """Compressed DP all-reduce with error feedback: needs a process group
    (multi-GPU), not ported yet."""
    raise NotImplementedError("psum_compressed over a mesh's data axis: ROADMAP A13b")
