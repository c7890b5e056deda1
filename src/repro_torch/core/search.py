"""Scope DSE: paper Algorithm 1, plus exhaustive/random search for validation.

A copy of the JAX package's ``core/search.py``, which is JAX-free.

Per segment, three nested dimensions are explored:
  * WSP->ISP transition index (linear, L+1 candidates)       [partition.py]
  * N_cluster via the cluster merge table (linear, L rows)   [cmt.py]
  * region allocation: proportional seed + chip-rebalance    [regions.py]

On heterogeneous packages a fourth dimension opens up (``search_mixed`` /
``search_segment_mixed``): contiguous *runs* of clusters are assigned to
chip flavors under per-flavor chip budgets, so one pipeline can start on
big chips and finish on little ones (SCAR / Odema et al.).  Flavors occupy
contiguous areas of the mesh, so a pipeline crosses at most one seam per
flavor change; the cost model charges those boundary hand-offs through
``HardwareModel.seam_link_bw``.  Run boundaries are pruned to a window
around the compute-proportional cut (per-flavor proportional seeds), and
the rebalance walk only moves chips within a flavor pool.

The pseudocode's inner ``while tmpLatency < minLatency`` only rebalances while
beating the global best; we run the (strictly stronger) local-improvement
rebalance and track the global best across it -- this can only find better
schedules and keeps the same asymptotics.

System level: sweep segment counts from the minimal feasible value
(segments.py) and run Algorithm 1 independently per segment (paper SSV-A uses
an identical segment allocation for Scope and the segmented baseline).
"""
from __future__ import annotations

import bisect
import itertools
import math
import random
from dataclasses import dataclass

from ..obs import current_tracer
from .cmt import Clustering, gen_cmt
from .costmodel import INF, CostModel, _flavor_tuple
from .graph import (
    ClusterAssignment,
    LayerGraph,
    ScopeSchedule,
    SegmentSchedule,
)
from .partition import (
    apply_ep,
    enumerate_exhaustive,
    enumerate_transition_points,
    transition_partitions,
)
from .regions import (
    RegionMode,
    proportional_allocate,
    rebalance,
    uniform_allocate,
)
from .segments import candidate_segment_counts, divide_segments


def build_clusters(
    seg_lo: int,
    clustering: Clustering,
    partitions: tuple[str, ...],
    regions: list[int],
    chip_type=None,
) -> tuple[ClusterAssignment, ...]:
    """Assemble ClusterAssignments from segment-relative pieces.

    ``chip_type`` is one flavor name for every cluster, or a per-cluster
    flavor sequence (mixed-flavor pipelines).
    """
    types = _flavor_tuple(chip_type, len(clustering))
    out = []
    for (lo, hi), chips, ctype in zip(clustering, regions, types):
        out.append(
            ClusterAssignment(
                layer_lo=seg_lo + lo,
                layer_hi=seg_lo + hi,
                region_chips=chips,
                partitions=partitions[lo:hi],
                chip_type=ctype,
            )
        )
    return tuple(out)


def evaluate_segment(
    cost: CostModel,
    graph: LayerGraph,
    seg_lo: int,
    clustering: Clustering,
    partitions: tuple[str, ...],
    regions: list[int],
    chip_type=None,
) -> tuple[float, list[float]]:
    clusters = build_clusters(seg_lo, clustering, partitions, regions, chip_type)
    lat, times = cost.segment_time(graph, clusters)
    return lat, times


@dataclass
class SegmentResult:
    clusters: tuple[ClusterAssignment, ...]
    latency: float
    cluster_times: tuple[float, ...]


def _partition_sets(
    graph: LayerGraph, seg_lo: int, L: int, ep_for_moe: bool
) -> dict[tuple[str, ...], tuple[int, bool]]:
    """Candidate partition sets, each with a (transition_idx, ep) hint that
    lets FastCostModel key its memo by small int tuples (see fastcost.py)."""
    partition_sets: dict[tuple[str, ...], tuple[int, bool]] = {}
    for idx in range(L + 1):
        partition_sets[transition_partitions(L, idx)] = (idx, False)
    if ep_for_moe:
        for idx in range(L + 1):
            p = transition_partitions(L, idx)
            pe = apply_ep(graph, p, lo=seg_lo)
            if pe != p and pe not in partition_sets:  # dedupe, keep order
                partition_sets[pe] = (idx, True)
    return partition_sets


def search_segment(
    cost: CostModel,
    graph: LayerGraph,
    seg_lo: int,
    seg_hi: int,
    chips: int,
    mode: RegionMode = RegionMode.FREE,
    ep_for_moe: bool = False,
    max_clusters: int | None = None,
    fixed_clustering: Clustering | None = None,
    chip_type: str | None = None,
    paper_strict: bool = False,
) -> SegmentResult | None:
    """Algorithm 1 over one segment.

    ``fixed_clustering`` short-circuits the CMT (used by the segmented-pipeline
    baseline, where every layer is its own cluster).  ``chip_type`` runs the
    whole segment on one flavor of a heterogeneous package; ``paper_strict``
    replicates the pseudocode's rebalance exactly (regions.rebalance).
    """
    sub = graph.slice(seg_lo, seg_hi)
    L = len(sub)
    cmt = {len(fixed_clustering): fixed_clustering} if fixed_clustering else gen_cmt(sub)
    best: SegmentResult | None = None
    partition_sets = _partition_sets(graph, seg_lo, L, ep_for_moe)

    # Seed allocations depend only on the clustering (not on partitions), so
    # compute them once per CMT row instead of once per (partitions x row).
    seeds: dict[int, list[int] | None] = {}
    for n_cluster, clustering in cmt.items():
        if max_clusters is not None and n_cluster > max_clusters:
            continue
        if n_cluster > chips:
            continue
        if mode is RegionMode.UNIFORM:
            seeds[n_cluster] = uniform_allocate(n_cluster, chips)
        else:
            seeds[n_cluster] = proportional_allocate(
                [sum(graph.layers[seg_lo + i].flops for i in range(lo, hi))
                 for lo, hi in clustering],
                chips,
            )

    # Clustering-outer, partitions-inner: one sweeper per CMT row carries the
    # allocation-independent precomputation through the whole transition
    # sweep (FastCostModel updates it incrementally per transition step).
    for n_cluster, clustering in cmt.items():
        seed = seeds.get(n_cluster)
        if seed is None:
            continue
        sweeper = cost.segment_sweeper(graph, seg_lo, clustering, chip_type)
        # Seed-phase batch fill (fastcost 2D (k x layer) vectorization): every
        # transition slice's body at the seed allocation in one array pass.
        prefill = getattr(sweeper, "prefill", None)
        if prefill is not None:
            prefill(seed)
        # Batched transition sweep (fastcost.sweep_transitions): every
        # candidate's seed score as one gather over per-slot value tables,
        # instead of K x n_cl scalar probes.  Each candidate's rebalance
        # walk then starts from its batch row (times0) without re-evaluating
        # the seed allocation.
        sweep_batch = getattr(sweeper, "sweep_transitions", None)
        seed_lats = seed_times = heads = None
        if sweep_batch is not None:
            if mode is RegionMode.FREE and not paper_strict:
                # Also batch the first rebalance iteration: most walks end
                # right there (both donors fail), and the rest resume the
                # scalar walk from their post-move state.
                seed_lats, seed_times, heads = sweep_batch(
                    seed, list(partition_sets.values()), first_moves=True
                )
            else:
                seed_lats, seed_times = sweep_batch(
                    seed, list(partition_sets.values())
                )
        for r, (partitions, hint) in enumerate(partition_sets.items()):

            if mode is RegionMode.UNIFORM:
                if seed_lats is not None:
                    lat, times = float(seed_lats[r]), seed_times[r]
                else:
                    lat, times = sweeper(partitions, transition=hint)(seed)
                alloc = seed
            else:
                head = None if heads is None else heads[r]
                if head is not None and head[0] == "done":
                    # Batched first iteration proved no donor move improves:
                    # the walk terminates at the seed without configuring.
                    alloc, lat, times = seed, float(seed_lats[r]), seed_times[r]
                    if lat < (best.latency if best else INF):
                        best = SegmentResult(
                            clusters=build_clusters(
                                seg_lo, clustering, partitions, alloc, chip_type
                            ),
                            latency=lat,
                            cluster_times=tuple(times),
                        )
                    continue
                # One evaluator per (clustering, partitions): FastCostModel
                # memoizes cluster costs, so the rebalance walk below only
                # ever computes the clusters a chip move actually changed.
                eval_fn = sweeper(partitions, transition=hint)
                if head is not None:
                    # ("cont", alloc2, lat2, times2): resume after the one
                    # accepted move (max_iters=255: iteration 1 is spent).
                    alloc, lat, times = rebalance(
                        head[1], eval_fn, max_iters=255,
                        paper_strict=paper_strict,
                        times0=(head[2], head[3]),
                    )
                else:
                    t0 = (
                        None if seed_lats is None
                        else (float(seed_lats[r]), seed_times[r])
                    )
                    alloc, lat, times = rebalance(seed, eval_fn,
                                                  paper_strict=paper_strict,
                                                  times0=t0)
            if lat < (best.latency if best else INF):
                best = SegmentResult(
                    clusters=build_clusters(
                        seg_lo, clustering, partitions, alloc, chip_type
                    ),
                    latency=lat,
                    cluster_times=tuple(times),
                )
    return best


# ---------------------------------------------------------------------------
# Mixed-flavor pipelines: chip_type as a per-cluster search dimension
# ---------------------------------------------------------------------------

def _flavor_sequences(n_flavors: int, max_runs: int):
    """Ordered tuples of distinct flavor indices: the flavor each contiguous
    cluster run lands on, in pipeline order.  Flavors occupy contiguous mesh
    areas, so revisiting a flavor would tear a region apart -- runs use each
    flavor at most once, in either direction."""
    for r in range(1, min(n_flavors, max_runs) + 1):
        yield from itertools.permutations(range(n_flavors), r)


def _run_cut_candidates(
    loads: list[float], capacities: list[float], window: int
) -> list[tuple[int, ...]]:
    """Candidate cut index tuples splitting ``len(loads)`` clusters into
    ``len(capacities)`` contiguous non-empty runs.

    Small segments are cut exhaustively.  Larger ones are pruned to a
    ``window`` around the compute-proportional cuts (run r's cumulative
    cluster load tracks its cumulative effective capacity) -- the same
    proportionality the region seed allocation uses, applied one level up.
    """
    n = len(loads)
    R = len(capacities)
    if R == 1:
        return [()]
    if n < R:
        return []
    exhaustive = math.comb(n - 1, R - 1)
    if exhaustive <= (2 * window + 1) ** (R - 1):
        return list(itertools.combinations(range(1, n), R - 1))
    prefix = [0.0]
    for l in loads:
        prefix.append(prefix[-1] + l)
    total_load = prefix[-1] or 1.0
    total_cap = sum(capacities) or 1.0
    targets, acc = [], 0.0
    for c in capacities[:-1]:
        acc += c
        s = bisect.bisect_left(prefix, (acc / total_cap) * total_load, 1, n)
        targets.append(min(max(s, 1), n - 1))
    ranges = [
        range(max(1, t - window), min(n - 1, t + window) + 1) for t in targets
    ]
    return [
        cut for cut in itertools.product(*ranges)
        if all(a < b for a, b in zip(cut, cut[1:]))
    ]


def search_segment_mixed(
    cost: CostModel,
    graph: LayerGraph,
    seg_lo: int,
    seg_hi: int,
    flavor_budgets: list[tuple[str | None, int]],
    mode: RegionMode = RegionMode.FREE,
    ep_for_moe: bool = False,
    max_clusters: int | None = None,
    fixed_clustering: Clustering | None = None,
    paper_strict: bool = False,
    cut_window: int = 2,
) -> SegmentResult | None:
    """Algorithm 1 over one segment with per-cluster chip flavors.

    On top of the three paper dimensions, a flavor-run assignment layer
    maps contiguous runs of clusters onto package flavors under the
    per-flavor chip budgets in ``flavor_budgets`` (``[(chip_type, chips)]``).
    Seeds are proportional *within* each run's budget and the rebalance
    walk is constrained to within-flavor chip moves (a chip physically
    belongs to one flavor).  Single-run assignments are included, so the
    result is never worse than running the whole segment on the best
    single flavor at these budgets.
    """
    sub = graph.slice(seg_lo, seg_hi)
    L = len(sub)
    cmt = {len(fixed_clustering): fixed_clustering} if fixed_clustering else gen_cmt(sub)
    partition_sets = _partition_sets(graph, seg_lo, L, ep_for_moe)
    hw = cost.hw
    scales = [
        1.0 if t is None else hw.chip_type(t).flops_scale
        for t, _ in flavor_budgets
    ]
    best: SegmentResult | None = None

    for n_cluster, clustering in cmt.items():
        if max_clusters is not None and n_cluster > max_clusters:
            continue
        loads = [
            sum(graph.layers[seg_lo + i].flops for i in range(lo, hi))
            for lo, hi in clustering
        ]
        for seq in _flavor_sequences(len(flavor_budgets), n_cluster):
            eff_caps = [flavor_budgets[f][1] * scales[f] for f in seq]
            # Materialize every feasible cut of this flavor assignment first,
            # so the whole candidate set can be scored as one population:
            # each cut re-seeds the same cluster spans at different region
            # sizes, and FastCostModel.prefill_spans batch-fills all those
            # bodies in one matrix pass per span before the per-cut sweeps.
            cut_plans = []
            for cuts in _run_cut_candidates(loads, eff_caps, cut_window):
                bounds = (0, *cuts, n_cluster)
                runs = list(zip(bounds[:-1], bounds[1:]))
                if any(
                    hi - lo > flavor_budgets[f][1]
                    for (lo, hi), f in zip(runs, seq)
                ):
                    continue   # a run needs >= 1 chip per cluster
                ctypes, groups, seed = [], [], []
                feasible = True
                for r, ((lo, hi), f) in enumerate(zip(runs, seq)):
                    budget = flavor_budgets[f][1]
                    ctypes += [flavor_budgets[f][0]] * (hi - lo)
                    groups += [r] * (hi - lo)
                    if mode is RegionMode.UNIFORM:
                        alloc_r = uniform_allocate(hi - lo, budget)
                        if alloc_r is None:
                            feasible = False
                            break
                        seed += alloc_r
                    else:
                        seed += proportional_allocate(loads[lo:hi], budget)
                if feasible:
                    cut_plans.append((tuple(ctypes), groups, seed))
            if not cut_plans:
                continue
            prefill_spans = getattr(cost, "prefill_spans", None)
            if prefill_spans is not None and len(cut_plans) > 1:
                span_ns: dict[tuple, set] = {}
                for ctypes, _g, seed in cut_plans:
                    for j, (lo, hi) in enumerate(clustering):
                        key = (seg_lo + lo, seg_lo + hi, ctypes[j])
                        span_ns.setdefault(key, set()).add(seed[j])
                prefill_spans(graph, [
                    (lo, hi, sorted(ns), ct)
                    for (lo, hi, ct), ns in span_ns.items()
                ])
            for ctypes, groups, seed in cut_plans:
                sweeper = cost.segment_sweeper(graph, seg_lo, clustering, ctypes)
                prefill = getattr(sweeper, "prefill", None)
                if prefill is not None:
                    prefill(seed)
                sweep_batch = getattr(sweeper, "sweep_transitions", None)
                seed_lats = seed_times = None
                if sweep_batch is not None:
                    seed_lats, seed_times = sweep_batch(
                        seed, list(partition_sets.values())
                    )
                for r, (partitions, hint) in enumerate(partition_sets.items()):
                    if mode is RegionMode.UNIFORM:
                        if seed_lats is not None:
                            lat, times = float(seed_lats[r]), seed_times[r]
                        else:
                            lat, times = sweeper(partitions, transition=hint)(seed)
                        alloc = seed
                    else:
                        eval_fn = sweeper(partitions, transition=hint)
                        t0 = (
                            None if seed_lats is None
                            else (float(seed_lats[r]), seed_times[r])
                        )
                        alloc, lat, times = rebalance(
                            seed, eval_fn, paper_strict=paper_strict,
                            groups=groups, times0=t0,
                        )
                    if lat < (best.latency if best else INF):
                        best = SegmentResult(
                            clusters=build_clusters(
                                seg_lo, clustering, partitions, alloc, ctypes
                            ),
                            latency=lat,
                            cluster_times=tuple(times),
                        )
    return best


def search_mixed(
    graph: LayerGraph,
    cost: CostModel,
    flavor_budgets: list[tuple[str | None, int]] | None = None,
    mode: RegionMode = RegionMode.FREE,
    ep_for_moe: bool = False,
    segment_counts: list[int] | None = None,
    max_clusters: int | None = None,
    paper_strict: bool = False,
    cut_window: int = 2,
    include_single_flavor: bool = True,
) -> ScopeSchedule | None:
    """Full Scope DSE with ``chip_type`` as a per-cluster dimension.

    ``flavor_budgets`` caps how many chips of each flavor the schedule may
    use (default: every chip of every flavor of ``cost.hw``); the multimodel
    quota search passes partial budgets so one model can span flavors while
    others keep the rest.  The result is the best of (a) the plain
    single-flavor DSE per flavor at its budget and (b) the mixed sweep, so
    mixed search never returns worse than the best single-flavor schedule.
    """
    hw = cost.hw
    if flavor_budgets is None:
        if hw.region_types:
            flavor_budgets = [(t.name, t.chips) for t in hw.region_types]
        else:
            flavor_budgets = [(None, hw.chips)]
    flavor_budgets = [(t, b) for t, b in flavor_budgets if b > 0]
    if not flavor_budgets:
        return None

    best_sched: ScopeSchedule | None = None
    if include_single_flavor or len(flavor_budgets) == 1:
        for t, b in flavor_budgets:
            s = search(
                graph, cost, b, mode=mode, ep_for_moe=ep_for_moe,
                segment_counts=segment_counts, max_clusters=max_clusters,
                chip_type=t, paper_strict=paper_strict,
            )
            if s is not None and (
                best_sched is None or s.latency < best_sched.latency
            ):
                best_sched = s
    if len(flavor_budgets) == 1:
        return best_sched

    total = sum(b for _, b in flavor_budgets)
    counts = segment_counts or candidate_segment_counts(graph, hw, total)
    tr = current_tracer()
    with tr.span("search:mixed", graph=graph.name, chips=total,
                 flavors=len(flavor_budgets)):
        best_sched = _search_mixed_sweep(
            graph, cost, hw, flavor_budgets, counts, best_sched, mode,
            ep_for_moe, max_clusters, paper_strict, cut_window, tr,
        )
    return best_sched


def _search_mixed_sweep(graph, cost, hw, flavor_budgets, counts, best_sched,
                        mode, ep_for_moe, max_clusters, paper_strict,
                        cut_window, tr):
    total = sum(b for _, b in flavor_budgets)
    for n_seg in counts:
        split = divide_segments(graph, hw, total, n_seg)
        if split is None:
            continue
        segs: list[SegmentSchedule] = []
        total_lat = 0.0
        ok = True
        for lo, hi in split:
            with tr.span("segment:mixed", n_seg=n_seg, lo=lo, hi=hi):
                res = search_segment_mixed(
                    cost, graph, lo, hi, flavor_budgets, mode=mode,
                    ep_for_moe=ep_for_moe, max_clusters=max_clusters,
                    paper_strict=paper_strict, cut_window=cut_window,
                )
            if res is None or res.latency == INF:
                ok = False
                break
            segs.append(
                SegmentSchedule(res.clusters, res.latency, res.cluster_times)
            )
            total_lat += res.latency
        if not ok:
            continue
        if best_sched is None or total_lat < best_sched.latency:
            best_sched = ScopeSchedule(
                workload=graph.name,
                chips=total,
                segments=tuple(segs),
                latency=total_lat,
                meta={
                    "n_segments": n_seg,
                    "mode": mode.value,
                    "mixed_flavors": [[t, b] for t, b in flavor_budgets],
                },
            )
    return best_sched


def search(
    graph: LayerGraph,
    cost: CostModel,
    chips: int,
    mode: RegionMode = RegionMode.FREE,
    ep_for_moe: bool = False,
    segment_counts: list[int] | None = None,
    max_clusters: int | None = None,
    chip_type: str | None = None,
    paper_strict: bool = False,
) -> ScopeSchedule | None:
    """Full Scope DSE: segment sweep x Algorithm 1 per segment (Eq. 1).

    ``chip_type`` schedules onto ``chips`` chips of that flavor of a
    heterogeneous package (multimodel quota search); segment feasibility
    uses package-level weight capacity, which is flavor-independent.
    """
    hw = cost.hw
    counts = segment_counts or candidate_segment_counts(graph, hw, chips)
    best_sched: ScopeSchedule | None = None
    tr = current_tracer()
    with tr.span("search", graph=graph.name, chips=chips,
                 flavor=chip_type or "base") as sp:
        for n_seg in counts:
            split = divide_segments(graph, hw, chips, n_seg)
            if split is None:
                continue
            segs: list[SegmentSchedule] = []
            total = 0.0
            ok = True
            for lo, hi in split:
                with tr.span("segment", n_seg=n_seg, lo=lo, hi=hi):
                    res = search_segment(
                        cost, graph, lo, hi, chips, mode=mode,
                        ep_for_moe=ep_for_moe, max_clusters=max_clusters,
                        chip_type=chip_type, paper_strict=paper_strict,
                    )
                if res is None or res.latency == INF:
                    ok = False
                    break
                segs.append(
                    SegmentSchedule(res.clusters, res.latency, res.cluster_times)
                )
                total += res.latency
            if not ok:
                continue
            if best_sched is None or total < best_sched.latency:
                meta = {"n_segments": n_seg, "mode": mode.value}
                if chip_type:
                    meta["chip_type"] = chip_type
                best_sched = ScopeSchedule(
                    workload=graph.name,
                    chips=chips,
                    segments=tuple(segs),
                    latency=total,
                    meta=meta,
                )
        if best_sched is not None:
            sp.set(latency=best_sched.latency,
                   n_segments=best_sched.meta.get("n_segments"))
    return best_sched


# ---------------------------------------------------------------------------
# Validation searches (paper SSV-B(1), Fig. 8)
# ---------------------------------------------------------------------------

def compositions(total: int, parts: int):
    """All ways to write ``total`` as ``parts`` positive integers (ordered)."""
    for cuts in itertools.combinations(range(1, total), parts - 1):
        prev, out = 0, []
        for c in cuts:
            out.append(c - prev)
            prev = c
        out.append(total - prev)
        yield out


def enumerate_clusterings(L: int):
    for n_cluster in range(1, L + 1):
        for sizes in compositions(L, n_cluster):
            bounds, cursor = [], 0
            for s in sizes:
                bounds.append((cursor, cursor + s))
                cursor += s
            yield tuple(bounds)


def exhaustive_search(
    cost: CostModel, graph: LayerGraph, chips: int, yield_all: bool = False
):
    """Brute force over (clustering x regions x 2^L partitions) for one segment.

    Only tractable for tiny L/C (the paper uses AlexNet x 16 chiplets).
    Yields (latency, clustering, regions, partitions) for every valid config
    when ``yield_all``; otherwise returns the best tuple.
    """
    L = len(graph)
    best = (INF, None, None, None)
    for clustering in enumerate_clusterings(L):
        n_cluster = len(clustering)
        if n_cluster > chips:
            continue
        for regions in compositions(chips, n_cluster):
            for partitions in enumerate_exhaustive(L):
                lat, _ = evaluate_segment(cost, graph, 0, clustering, partitions, list(regions))
                if yield_all and lat < INF:
                    yield lat, clustering, tuple(regions), partitions
                if lat < best[0]:
                    best = (lat, clustering, tuple(regions), partitions)
    if not yield_all:
        yield best


def random_search(
    cost: CostModel,
    graph: LayerGraph,
    chips: int,
    samples: int,
    seed: int = 0,
):
    """Uniform random samples of the full space -- builds Fig. 8's histogram."""
    rng = random.Random(seed)
    L = len(graph)
    out = []
    for _ in range(samples):
        n_cluster = rng.randint(1, min(L, chips))
        cuts = sorted(rng.sample(range(1, L), n_cluster - 1)) if n_cluster > 1 else []
        bounds, cursor = [], 0
        for c in cuts + [L]:
            bounds.append((cursor, c))
            cursor = c
        rcuts = sorted(rng.sample(range(1, chips), n_cluster - 1)) if n_cluster > 1 else []
        regions, prev = [], 0
        for c in rcuts + [chips]:
            regions.append(c - prev)
            prev = c
        partitions = tuple(rng.choice(("WSP", "ISP")) for _ in range(L))
        lat, _ = evaluate_segment(cost, graph, 0, tuple(bounds), partitions, regions)
        if lat < INF:
            out.append(lat)
    return out
