"""Each hand kernel's count of work, and the dry-run's tally of meta calls.

A kernel module's ``*_cost`` function counts, from its call's own tensors,
the operations the work needs and the bytes it must move (each input read
once, each output written once).  Two callers read it: ``chip_smoke.py``'s
``bound_ms`` (on the card's tensors) and the dry-run's roofline
(``launch/dryrun.py``, on meta tensors), so the two cannot disagree.

On meta tensors a kernel wrapper runs its checks and its allocations, then
hands its cost to :func:`meta_call` and returns before the launch: it loads
no library, touches no CUDA state and leaves its ``launches`` count alone.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch


class KernelCost(NamedTuple):
    flops: float    # operations the work needs
    bytes: float    # bytes it must move: each input read once, each output written once
    unit: str       # what runs the operations: "bf16", "fp32" or "int8"


def nbytes(*tensors: torch.Tensor | None) -> int:
    """Bytes of the tensors' own elements (a view counts its elements only)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def unit_of(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the causal / window masks leave visible, query and key
    positions both counted from 0."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Skv - 1) if causal else np.full(Sq, Skv - 1, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


_calls: list | None = None


def meta_call(name: str, cost: KernelCost) -> None:
    """A wrapper's call on meta tensors, tallied where a dry run counts."""
    if _calls is not None:
        _calls.append((name, cost))


@contextlib.contextmanager
def tally():
    """Collect ``(kernel name, KernelCost)`` of every meta call in the block."""
    global _calls
    prev, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = prev
