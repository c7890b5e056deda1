"""Per-layer partition search (paper SSIV-B, third dimension).

A copy of the JAX package's ``core/partition.py``, which is JAX-free.

Observation exploited by the paper: shallow layers have large activations
(=> WSP avoids replicating them) while deep layers have large weights
(=> ISP avoids replicating those).  The per-layer 2^L choice collapses to a
single WSP->ISP transition index: layers [0, idx) use WSP, layers [idx, L)
use ISP -- L+1 candidates, linear complexity.

Beyond-paper extension (``ep_for_moe``): MoE FFN layers may use EP (expert
parallelism) instead of the transition-dictated choice; the DSE tries both.
"""
from __future__ import annotations

from itertools import product
from typing import Iterator

from .graph import PARTITION_EP, PARTITION_ISP, PARTITION_WSP, LayerGraph


def transition_partitions(L: int, idx: int) -> tuple[str, ...]:
    """WSP for the first ``idx`` layers, ISP for the rest."""
    return tuple([PARTITION_WSP] * idx + [PARTITION_ISP] * (L - idx))


def enumerate_transition_points(L: int) -> Iterator[tuple[str, ...]]:
    for idx in range(L + 1):
        yield transition_partitions(L, idx)


def enumerate_exhaustive(L: int) -> Iterator[tuple[str, ...]]:
    """All 2^L assignments -- only for the validation experiment (Fig. 8)."""
    yield from product((PARTITION_WSP, PARTITION_ISP), repeat=L)


def apply_ep(graph: LayerGraph, partitions: tuple[str, ...], lo: int = 0) -> tuple[str, ...]:
    """Flip MoE FFN layers to EP (beyond-paper, DESIGN.md SS7)."""
    out = list(partitions)
    for k in range(len(partitions)):
        if graph.layers[lo + k].n_experts > 1:
            out[k] = PARTITION_EP
    return tuple(out)
