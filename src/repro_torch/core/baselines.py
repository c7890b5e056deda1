"""The paper's three baseline scheduling families (SSI / SSV-A).

A copy of the JAX package's ``core/baselines.py``, which is JAX-free.

* fully sequential ([6] Simba, [7] NN-Baton, [21]): every layer runs on the
  whole package, one layer at a time; weights streamed from DRAM per layer,
  amortized over the batch.
* fully pipelined ([15] DNNBuilder, [16] TGPA): one segment, one layer per
  cluster across the package; invalid when L > C or weights overflow.
* segmented pipeline ([17] Tangram, [18] DeepBurning-SEG, [19] Gemini), the
  SOTA Scope compares against: segments of single-layer clusters -- i.e.
  Scope with the cluster-merge dimension disabled.  Shares segment division
  and the region/partition search with Scope so that measured gains isolate
  the merge contribution (paper SSV-A).
"""
from __future__ import annotations

from .costmodel import INF, CostModel
from .graph import LayerGraph, ScopeSchedule, SegmentSchedule
from .partition import enumerate_transition_points
from .regions import RegionMode
from .search import SegmentResult, search, search_segment
from .segments import candidate_segment_counts, divide_segments


def schedule_sequential(graph: LayerGraph, cost: CostModel, chips: int) -> ScopeSchedule:
    """Layer-at-a-time on all C chips; batch of m streams through each layer.

    Per layer: weights loaded once from DRAM (not resident across layers),
    then m samples each pay max(T_comm, T_comp) (Eq. 7 overlap still applies);
    inter-layer traffic is an on-package redistribution (Case1 with n = C).
    """
    hw, m = cost.hw, cost.m
    total = 0.0
    for i, layer in enumerate(graph.layers):
        best = INF
        nxt = graph.layers[i + 1] if i + 1 < len(graph.layers) else None
        for p in ("WSP", "ISP"):
            for p_next in (("WSP", "ISP") if nxt is not None else (None,)):
                t = cost.layer_time(layer, p, chips, p_next, chips, same_region=True)
                beat = t.total if cost.overlap else t.unoverlapped
                cand = layer.weight_bytes / hw.dram_bw_total + m * beat
                best = min(best, cand)
        total += best
    # single "segment" covering everything on the full package, no pipelining
    return ScopeSchedule(
        workload=graph.name, chips=chips,
        segments=(), latency=total, meta={"method": "sequential"},
    )


def schedule_full_pipeline(graph: LayerGraph, cost: CostModel, chips: int) -> ScopeSchedule | None:
    """One segment, every layer its own cluster, pipelined across the package."""
    L = len(graph)
    if L > chips:
        return None
    fixed = tuple((i, i + 1) for i in range(L))
    res = search_segment(
        cost, graph, 0, L, chips, mode=RegionMode.FREE, fixed_clustering=fixed
    )
    if res is None or res.latency == INF:
        return None
    return ScopeSchedule(
        workload=graph.name, chips=chips,
        segments=(SegmentSchedule(res.clusters, res.latency, res.cluster_times),),
        latency=res.latency, meta={"method": "full_pipeline"},
    )


def schedule_segmented(
    graph: LayerGraph, cost: CostModel, chips: int,
    segment_counts: list[int] | None = None,
) -> ScopeSchedule | None:
    """Segmented pipeline: Scope minus the merge dimension (1 layer/cluster)."""
    hw = cost.hw
    counts = segment_counts or candidate_segment_counts(graph, hw, chips)
    best = None
    for n_seg in counts:
        split = divide_segments(graph, hw, chips, n_seg)
        if split is None:
            continue
        segs, total, ok = [], 0.0, True
        for lo, hi in split:
            if hi - lo > chips:       # can't give every layer its own region
                ok = False
                break
            fixed = tuple((i, i + 1) for i in range(hi - lo))
            res = search_segment(
                cost, graph, lo, hi, chips, mode=RegionMode.FREE,
                fixed_clustering=fixed,
            )
            if res is None or res.latency == INF:
                ok = False
                break
            segs.append(SegmentSchedule(res.clusters, res.latency, res.cluster_times))
            total += res.latency
        if not ok:
            continue
        if best is None or total < best.latency:
            best = ScopeSchedule(
                workload=graph.name, chips=chips, segments=tuple(segs),
                latency=total,
                meta={"method": "segmented", "n_segments": n_seg},
            )
    return best


def schedule_scope(
    graph: LayerGraph, cost: CostModel, chips: int,
    mode: RegionMode = RegionMode.FREE, ep_for_moe: bool = False,
    segment_counts: list[int] | None = None,
) -> ScopeSchedule | None:
    sched = search(
        graph, cost, chips, mode=mode, ep_for_moe=ep_for_moe,
        segment_counts=segment_counts,
    )
    if sched is not None:
        sched.meta["method"] = "scope"
    return sched


ALL_METHODS = {
    "sequential": schedule_sequential,
    "full_pipeline": schedule_full_pipeline,
    "segmented": schedule_segmented,
    "scope": schedule_scope,
}
