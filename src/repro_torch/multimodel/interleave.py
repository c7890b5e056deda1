"""Merged interleaving: fuse several models into one shared merged pipeline.

A copy of the JAX package's ``multimodel/interleave.py``, which is JAX-free.

Spatial partitioning wastes chips when a small model cannot use even its
minimal quota efficiently.  The alternative the merged-pipeline dimension
opens up: concatenate the models' LayerGraphs into one chain, scale each
model's layers by a per-model batch weighting (``LayerNode.scaled``), and
run a single Scope DSE over the whole package.  One pipeline beat then
produces ``scale_i`` samples of model ``i``; every region serves exactly one
model's layers (clusters never straddle models more than the CMT merge
allows -- straddling is legal and simply means two small adjacent models
share a region, which is the point of merging).

Boundary semantics: consecutive models exchange no activations -- model
outputs leave via DRAM (out/halo sanitized to 0, like any network output)
and the next model's inputs arrive from DRAM.  Each model-initial layer is
marked ``meta["dram_input"]`` and the cost model's segment-level load term
charges its staging wherever the boundary lands (mid-segment entry layers
included, see ``segment_time``) -- partition-independent, so the DSE cannot
dodge the charge by picking a particular boundary partition pair.
"""
from __future__ import annotations

from dataclasses import replace

from ..core.costmodel import INF, CostModel
from ..core.graph import (
    MM_MERGED,
    MM_PARTITIONED,
    LayerGraph,
    ModelAssignment,
    MultiModelSchedule,
    mix_rate,
)
from ..core.search import search


def batch_scales(specs, max_scale: int = 8) -> list[int]:
    """Integer samples-per-beat per model, approximately proportional to the
    traffic weights (capped at ``max_scale`` to keep merged graphs small).
    The achieved mix rate is computed from the *actual* scales, so the
    integer rounding never over-reports throughput."""
    w_min = min(s.weight for s in specs)
    return [
        max(1, min(max_scale, round(s.weight / w_min))) for s in specs
    ]


def merged_graph(specs, scales=None) -> tuple[LayerGraph, list[int]]:
    """Concatenate the specs' graphs with per-model batch weighting."""
    scales = scales or batch_scales(specs)
    layers = []
    for m, (spec, scale) in enumerate(zip(specs, scales)):
        for i, node in enumerate(spec.graph.layers):
            node = node.scaled(scale)
            if i == len(spec.graph) - 1:
                node = replace(node, out_bytes=0.0, halo_bytes=0.0)
            if i == 0 and m > 0:
                node = replace(
                    node, meta={**node.meta, "dram_input": True}
                )
            layers.append(replace(node, name=f"{spec.name}.{node.name}"))
    name = "+".join(
        f"{s.name}x{k}" if k > 1 else s.name for s, k in zip(specs, scales)
    )
    return LayerGraph(name, tuple(layers)), list(scales)


def _set_partitions(items: list):
    """All partitions of ``items`` into non-empty groups (Bell enumeration;
    callers gate on small N, so the growth is harmless)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _set_partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]
        yield [[first]] + part


def search_merged_groups(
    specs,
    cost: CostModel,
    step: int = 1,
    paper_strict: bool = False,
    curves=None,
    max_models: int = 4,
) -> MultiModelSchedule | None:
    """Partitioned quotas over *merged sub-groups* of the model set.

    The all-merged pipeline (:func:`search_merged`) and fully-partitioned
    quotas (:func:`~.quota.search_partitioned`) are the two extremes of a
    spectrum: any partition of the model set into groups -- each group
    merged into one pipeline, the groups sharing the package through the
    quota search -- is a legal co-schedule.  This enumerates the proper
    partitions (at least two groups, at least one of size >= 2; the
    extremes are already separate ``co_schedule`` candidates) for small
    model sets and returns the best, so the co-scheduler's result is by
    construction at least as good as either extreme.

    A merged group enters the quota search as a pseudo-model whose curve
    points are beat rates; its traffic weight is ``max_i(w_i / scale_i)``
    -- the beats each mix unit demands -- so the quota search's
    ``min(tp / weight)`` objective prices the group exactly.  Group curves
    are cached across partitions (the same pair appears in several), and
    singleton models reuse the caller's curves; everything flows through
    the one shared FastCostModel memo.
    """
    from .curves import throughput_curve
    from .quota import package_flavors, search_partitioned
    from .spec import ModelSpec

    hw = cost.hw
    n = len(specs)
    if n < 3 or n > max_models:
        return None
    flavors = package_flavors(hw)
    group_cache: dict[tuple[int, ...], tuple] = {}
    curve_cache: dict[tuple[str, str | None], object] = {}
    best = None
    for part in _set_partitions(list(range(n))):
        if len(part) < 2 or all(len(g) == 1 for g in part):
            continue
        pseudo, expand = [], []
        for g in part:
            if len(g) == 1:
                spec = specs[g[0]]
                pseudo.append(spec)
                expand.append([(spec, 1.0)])
            else:
                key = tuple(sorted(g))
                ent = group_cache.get(key)
                if ent is None:
                    members = [specs[i] for i in g]
                    mg, scales = merged_graph(members)
                    w_unit = max(
                        m.weight / s for m, s in zip(members, scales)
                    )
                    ent = group_cache[key] = (
                        ModelSpec(mg, w_unit), members, scales
                    )
                pseudo.append(ent[0])
                expand.append(list(zip(ent[1], ent[2])))
        pcurves = {}
        for s in pseudo:
            for ctype, cap in flavors:
                ckey = (s.name, ctype)
                if curves is not None and ckey in curves:
                    pcurves[ckey] = curves[ckey]
                    continue
                c = curve_cache.get(ckey)
                if c is None:
                    c = curve_cache[ckey] = throughput_curve(
                        cost, s.graph, cap, ctype, step, paper_strict
                    )
                pcurves[ckey] = c
        res = search_partitioned(pseudo, cost, step, paper_strict,
                                 curves=pcurves)
        if res is None:
            continue
        assignments = []
        for a, members in zip(res.assignments, expand):
            for m, scale in members:
                assignments.append(ModelAssignment(
                    model=m.name, weight=m.weight, chips=a.chips,
                    schedule=a.schedule, chip_type=a.chip_type,
                    samples_per_beat=float(scale),
                ))
        assignments = tuple(assignments)
        lam = mix_rate(assignments)
        wt = lam * sum(s.weight for s in specs)
        if best is None or wt > best.weighted_throughput:
            best = MultiModelSchedule(
                package=hw.name,
                chips=hw.chips,
                mode=MM_PARTITIONED,
                assignments=assignments,
                mix_rate=lam,
                weighted_throughput=wt,
                meta={
                    "family": "partitioned_merged_groups",
                    "merge_groups": [
                        [specs[i].name for i in g] for g in part
                        if len(g) > 1
                    ],
                },
            )
    return best


def search_merged(
    specs,
    cost: CostModel,
    chip_type: str | None = None,
    chips: int | None = None,
    paper_strict: bool = False,
) -> MultiModelSchedule | None:
    """One Scope DSE over the merged graph on the whole package.

    On a heterogeneous package the merged pipeline must live on a single
    flavor (a Scope schedule is single-typed); callers pick the flavor via
    ``chip_type``/``chips`` -- co_schedule tries each.
    """
    hw = cost.hw
    if chips is None:
        chips = hw.chips if not hw.region_types else hw.chip_type(chip_type).chips
    graph, scales = merged_graph(specs)
    sched = search(graph, cost, chips, chip_type=chip_type,
                   paper_strict=paper_strict)
    if sched is None or sched.latency == INF:
        return None
    sched.meta["m_samples"] = cost.m
    sched.meta["batch_scales"] = list(scales)
    assignments = tuple(
        ModelAssignment(
            model=spec.name,
            weight=spec.weight,
            chips=chips,
            schedule=sched,
            chip_type=chip_type,
            samples_per_beat=float(scale),
        )
        for spec, scale in zip(specs, scales)
    )
    lam = mix_rate(assignments)
    return MultiModelSchedule(
        package=hw.name,
        chips=hw.chips,
        mode=MM_MERGED,
        assignments=assignments,
        mix_rate=lam,
        weighted_throughput=lam * sum(s.weight for s in specs),
        meta={"merged_graph": graph.name, "batch_scales": list(scales)},
    )
