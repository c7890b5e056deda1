"""Segment division (shared by Scope and the segmented-pipeline baseline).

A copy of the JAX package's ``core/segments.py``, which is JAX-free.

Per paper SSV-A, Scope "uses an identical segment allocation method as the
segmented pipeline to isolate performance gains" -- so both schedulers call
this module.  A division into S segments is a contiguous split of the layer
chain that (a) is weight-capacity feasible (a segment's parameters must fit
on-package, in the best case fully sharded: sum W / C <= cap/chip) and
(b) balances per-segment compute load (min-max FLOPs, classic linear
partitioning DP).
"""
from __future__ import annotations

from .graph import LayerGraph
from .hw import HardwareModel

Split = tuple[tuple[int, int], ...]


def segment_feasible(graph: LayerGraph, lo: int, hi: int, hw: HardwareModel, chips: int) -> bool:
    """Best-case (fully sharded) weight fit.  Must stay consistent with the
    inlined prefix-sum check in :func:`divide_segments`."""
    w = sum(graph.layers[i].weight_bytes for i in range(lo, hi))
    return w <= hw.weight_capacity_per_chip * chips


def divide_segments(
    graph: LayerGraph, hw: HardwareModel, chips: int, n_segments: int
) -> Split | None:
    """Min-max-FLOPs contiguous split into ``n_segments`` feasible segments."""
    L = len(graph)
    if n_segments > L:
        return None
    flops = [l.flops for l in graph.layers]
    prefix = [0.0]
    for f in flops:
        prefix.append(prefix[-1] + f)
    wpre = [0.0]
    for l in graph.layers:
        wpre.append(wpre[-1] + l.weight_bytes)
    w_cap = hw.weight_capacity_per_chip * chips

    def load(lo, hi):
        return prefix[hi] - prefix[lo]

    INF = float("inf")
    # dp[s][i] = best achievable max-load splitting layers[:i] into s segments
    dp = [[INF] * (L + 1) for _ in range(n_segments + 1)]
    cut = [[-1] * (L + 1) for _ in range(n_segments + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_segments + 1):
        for i in range(s, L + 1):
            for j in range(s - 1, i):
                if dp[s - 1][j] == INF:
                    continue
                if wpre[i] - wpre[j] > w_cap:   # segment_feasible via prefix
                    continue
                cand = max(dp[s - 1][j], load(j, i))
                if cand < dp[s][i]:
                    dp[s][i] = cand
                    cut[s][i] = j
    if dp[n_segments][L] == INF:
        return None
    # reconstruct
    bounds = []
    i = L
    for s in range(n_segments, 0, -1):
        j = cut[s][i]
        bounds.append((j, i))
        i = j
    return tuple(reversed(bounds))


def min_segments(graph: LayerGraph, hw: HardwareModel, chips: int, cap: int = 16) -> int | None:
    for s in range(1, min(cap, len(graph)) + 1):
        if divide_segments(graph, hw, chips, s) is not None:
            return s
    return None


def candidate_segment_counts(
    graph: LayerGraph, hw: HardwareModel, chips: int, extra: int = 4
) -> list[int]:
    """The sweep the DSE explores: minimal feasible count plus a few more."""
    base = min_segments(graph, hw, chips)
    if base is None:
        return []
    return list(range(base, min(base + extra, len(graph)) + 1))
