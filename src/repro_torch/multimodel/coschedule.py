"""The co-scheduler: best of {partitioned quotas, merged pipeline, time-mux}.

A copy of the JAX package's ``multimodel/coschedule.py``, which is JAX-free.

``co_schedule`` is the subsystem's entry point.  It searches the three
co-scheduling families over one shared FastCostModel (the cluster-cost memo
is what makes the joint sweep affordable -- engine stats land in the result
meta) and returns the best :class:`MultiModelSchedule` by weighted
throughput.  Time multiplexing is itself a legal co-schedule, so the result
is by construction at least as good as either fig11 baseline.
"""
from __future__ import annotations

import time

from ..core.costmodel import CostModel
from ..core.fastcost import FastCostModel
from ..core.graph import MultiModelSchedule, validate_multimodel
from ..core.hw import HardwareModel, validate_region_types
from ..obs import current_tracer
from .baselines import time_multiplexed
from .curves import build_curves
from .interleave import merged_graph, search_merged, search_merged_groups
from .quota import package_flavors, search_partitioned, search_partitioned_mixed
from .spec import ModelSpec


def _warm_fits(warm: MultiModelSchedule, flavors) -> bool:
    """Whether the incumbent's allocation still fits this package's flavor
    capacities.  A degraded re-solve (chips died under the incumbent) must
    re-open the full search -- anchoring quota windows to an allocation the
    surviving package cannot hold would steer the refinement into the dead
    zone's former capacity."""
    used: dict[str | None, int] = {}
    seen: set[tuple] = set()
    for a in warm.assignments:
        # merged groups share one schedule and one resource claim
        key = (id(a.schedule), a.chip_type, a.chips,
               tuple(a.chip_quota or ()))
        if key in seen:
            continue
        seen.add(key)
        if a.chip_quota:
            for t, q in a.chip_quota:
                used[t] = used.get(t, 0) + q
        else:
            used[a.chip_type] = used.get(a.chip_type, 0) + a.chips
    caps = dict(flavors)
    if warm.mode == "time_mux":         # whole-package time slices overlap
        return max(used.values(), default=0) <= max(caps.values(), default=0)
    return all(used.get(t, 0) <= cap for t, cap in caps.items()) and all(
        t in caps for t in used
    )


def co_schedule(
    specs: list[ModelSpec],
    hw: HardwareModel,
    m_samples: int = 16,
    step: int = 1,
    include_merged: bool = True,
    include_time_mux: bool = True,
    include_mixed: bool = True,
    paper_strict: bool = False,
    cost: CostModel | None = None,
    validate: bool = True,
    curve_refine: bool = False,
    mixed_step: int | None = None,
    switch_cost: bool = False,
    switch_period_s: float = 1.0,
    warm_start: MultiModelSchedule | None = None,
) -> MultiModelSchedule | None:
    """Jointly schedule ``specs`` onto one package.

    ``step`` coarsens the quota grid (1 = exhaustive; ``curve_refine``
    re-samples the coarse curves -- 1D *and* mixed F-dimensional -- around
    each argmax); ``cost`` lets callers supply a pre-warmed engine (its
    memo then carries over between calls).  On heterogeneous packages (any
    flavor count >= 2) ``include_mixed`` also searches quotas that span
    flavors -- one model's pipeline on big *and* little chips.
    ``switch_cost`` charges the time-mux mode for per-slice weight
    re-deployment (see ``baselines.time_multiplexed``).

    ``warm_start`` (an incumbent :class:`MultiModelSchedule` for the same
    model set -- e.g. the deployment a serving re-solve is drifting away
    from) turns the search into a local refinement: curves sample only a
    window around each model's incumbent chip count
    (:func:`~.curves.build_curves` ``windows``), and the expensive
    families the incumbent did not use (spanning quotas, merged
    pipelines) are skipped.  The result is a valid co-schedule found in a
    fraction of the cold solve's time, not a certificate of global
    optimality -- interactive re-solves trade exhaustiveness for latency.
    """
    validate_region_types(hw)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate model names in mix: {names}")
    if cost is None:
        cost = FastCostModel(hw, m_samples=m_samples)
    t0 = time.time()
    tr = current_tracer()
    flavors = package_flavors(hw)

    windows = None
    if warm_start is not None:
        inc = {a.model: a.chips for a in warm_start.assignments}
        if set(inc) == set(names) and _warm_fits(warm_start, flavors):
            windows = inc
            # Only re-search the families the incumbent landed in (plus
            # the always-cheap partitioned quotas and time-mux): the warm
            # re-solve's job is tracking a drifted mix, not re-opening
            # every scheduling dimension.
            merged_inc = (warm_start.mode == "merged"
                          or bool(warm_start.meta.get("merge_groups")))
            include_merged = include_merged and merged_inc
            include_mixed = include_mixed and any(
                a.chip_quota for a in warm_start.assignments
            )
    with tr.span("coschedule:curves", models=len(specs),
                 flavors=len(flavors), warm=windows is not None):
        curves = build_curves(specs, cost, flavors, step, paper_strict,
                              refine=curve_refine, windows=windows)

    candidates: list[tuple[str, MultiModelSchedule]] = []
    with tr.span("coschedule:partitioned"):
        part = search_partitioned(specs, cost, step, paper_strict,
                                  curves=curves)
    if part is not None:
        candidates.append((part.mode, part))
    if include_mixed and len(flavors) >= 2:
        with tr.span("coschedule:partitioned-mixed"):
            mixed = search_partitioned_mixed(
                specs, cost, step, paper_strict, curves=curves,
                mixed_step=mixed_step, mixed_refine=curve_refine,
            )
        if mixed is not None:
            candidates.append(("partitioned:mixed", mixed))
    if include_merged and len(specs) > 1:
        with tr.span("coschedule:merged", flavors=len(flavors)):
            for ctype, _cap in flavors:
                merged = search_merged(specs, cost, chip_type=ctype,
                                       paper_strict=paper_strict)
                if merged is not None:
                    label = f"{merged.mode}:{ctype}" if ctype else merged.mode
                    candidates.append((label, merged))
        # Between all-merged and fully-partitioned: merged sub-groups
        # sharing the package through the quota search (proper partitions
        # of the model set; gated to small N inside).
        with tr.span("coschedule:merged-groups"):
            grouped = search_merged_groups(
                specs, cost, step=step, paper_strict=paper_strict,
                curves=curves,
            )
        if grouped is not None:
            candidates.append(("partitioned:merged-groups", grouped))
    if include_time_mux:
        with tr.span("coschedule:time-mux"):
            tm = time_multiplexed(specs, cost, curves=curves,
                                  switch_cost=switch_cost,
                                  switch_period_s=switch_period_s)
        if tm is not None:
            candidates.append((tm.mode, tm))
    if not candidates:
        return None

    best = max(candidates, key=lambda c: c[1].weighted_throughput)[1]
    best.meta.update({
        "dse_s": time.time() - t0,
        "engine_stats": dict(cost.stats),
        "warm_start": windows is not None,
        "mode_rates": {
            label: c.weighted_throughput for label, c in candidates
        },
    })
    if validate:
        graphs = {s.name: s.graph for s in specs}
        if best.mode == "merged":
            mg, _ = merged_graph(specs)
            graphs[mg.name] = mg
        by_name = {s.name: s for s in specs}
        for group in best.meta.get("merge_groups", ()):
            # Merged sub-groups validate against their group's merged graph
            # (deterministic rebuild: merged_graph is a pure function of
            # the members and their default batch scales).
            mg, _ = merged_graph([by_name[m] for m in group])
            graphs[mg.name] = mg
        type_capacity = dict(flavors)
        validate_multimodel(best, graphs, type_capacity)
    return best


def describe(sched: MultiModelSchedule) -> list[str]:
    """Human-readable co-schedule summary (CLI / examples)."""
    lines = [
        f"{sched.package}: {sched.n_models} models, mode={sched.mode}, "
        f"mix rate {sched.mix_rate:.1f}/s, "
        f"weighted throughput {sched.weighted_throughput:.1f} samples/s"
    ]
    for a in sched.assignments:
        extras = []
        if a.chip_type:
            extras.append(f"type={a.chip_type}")
        if a.chip_quota:
            extras.append(
                "quota=" + "+".join(f"{c}x{t}" for t, c in a.chip_quota if c)
            )
        if a.samples_per_beat != 1.0:
            extras.append(f"{a.samples_per_beat:g} samples/beat")
        if a.time_share != 1.0:
            extras.append(f"{a.time_share * 100:.0f}% of time")
        lines.append(
            f"  {a.model:12s} w={a.weight:g}  {a.chips:4d} chips  "
            f"{a.throughput:9.1f} samples/s  {' '.join(extras)}"
        )
    return lines
