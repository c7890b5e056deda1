"""Cluster Merge Table (paper Alg. 1, ``GenCMT``).

A copy of the JAX package's ``core/cmt.py``, which is JAX-free.

Start with every layer as its own cluster (N_cluster = L).  Repeatedly merge
the adjacent pair of clusters whose *parallelism* is most similar
(``parallelOffset = |parallel[:-1] / parallel[1:] - 1|``), recording the
clustering for every N_cluster.  One pass yields cluster divisions for all
N_cluster in 1..L -- this is the exponential->linear reduction for the
cluster dimension.

Cluster parallelism = geometric mean of its layers' ``parallel_metric``
(output pixels for convs, tokens for LM layers): layers sharing a region
should split along similar dimensions to keep the region utilized.
"""
from __future__ import annotations

from .graph import LayerGraph, geomean

# A clustering is a tuple of (lo, hi) half-open layer index ranges.
Clustering = tuple[tuple[int, int], ...]


def cluster_parallelism(graph: LayerGraph, lo: int, hi: int) -> float:
    return geomean([graph.layers[i].parallel_metric for i in range(lo, hi)])


def gen_cmt(graph: LayerGraph) -> dict[int, Clustering]:
    """Build the CMT for a (sub)graph: {N_cluster: clustering}."""
    L = len(graph)
    current: list[tuple[int, int]] = [(i, i + 1) for i in range(L)]
    cmt: dict[int, Clustering] = {L: tuple(current)}
    parallel = [cluster_parallelism(graph, lo, hi) for lo, hi in current]
    for n_cluster in range(L, 1, -1):
        # offset between adjacent clusters
        best_idx, best_off = 0, float("inf")
        for i in range(len(current) - 1):
            off = abs(parallel[i] / max(parallel[i + 1], 1e-30) - 1.0)
            if off < best_off:
                best_off, best_idx = off, i
        lo, _ = current[best_idx]
        _, hi = current[best_idx + 1]
        current[best_idx : best_idx + 2] = [(lo, hi)]
        parallel[best_idx : best_idx + 2] = [cluster_parallelism(graph, lo, hi)]
        cmt[n_cluster - 1] = tuple(current)
    return cmt


def validate_clustering(clustering: Clustering, n_layers: int) -> bool:
    cursor = 0
    for lo, hi in clustering:
        if lo != cursor or hi <= lo:
            return False
        cursor = hi
    return cursor == n_layers
