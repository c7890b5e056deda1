"""Static multi-model baselines the co-scheduler is measured against.

A copy of the JAX package's ``multimodel/baselines.py``, which is JAX-free.

* ``equal_split``: the package is divided into equal per-model quotas up
  front, ignoring the models' sizes and traffic weights (the static spatial
  baseline of the multi-chiplet multi-tenancy literature).
* ``time_multiplexed``: every model gets the whole package for an optimal
  fraction of time.  By default zero switching cost is charged for the
  per-slice weight re-deployment, which makes this a *generous* baseline --
  real packages pay a segment re-load per switch; ``switch_cost=True``
  charges that re-load (model weights through shared DRAM once per
  scheduling period) and keeps the default off so historical numbers stay
  reproducible.

Both produce :class:`MultiModelSchedule` objects with the same figure of
merit as the co-scheduler, so fig11 compares like with like.
"""
from __future__ import annotations

from ..core.costmodel import INF, CostModel
from ..core.graph import (
    MM_PARTITIONED,
    MM_TIME_MUX,
    ModelAssignment,
    MultiModelSchedule,
    mix_rate,
)
from ..core.search import search
from .quota import package_flavors


def _searched_assignment(spec, cost, ctype, chips, **kw):
    sched = search(spec.graph, cost, chips, chip_type=ctype)
    if sched is None or sched.latency == INF:
        return None
    sched.meta["m_samples"] = cost.m
    return ModelAssignment(
        model=spec.name, weight=spec.weight, chips=chips,
        schedule=sched, chip_type=ctype, **kw,
    )


def equal_split(specs, cost: CostModel) -> MultiModelSchedule | None:
    """Equal per-model quotas; models round-robin across flavors (hetero)."""
    hw = cost.hw
    flavors = package_flavors(hw)
    n = len(specs)
    # Round-robin models over flavors, then split each flavor equally among
    # the models it hosts (remainder chips go to the first models).
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(i % len(flavors), []).append(i)
    quota: dict[int, tuple[str | None, int]] = {}
    for t, members in groups.items():
        ctype, cap = flavors[t]
        if cap < len(members):
            return None
        base, rem = divmod(cap, len(members))
        for j, i in enumerate(members):
            quota[i] = (ctype, base + (1 if j < rem else 0))
    assignments = []
    for i, spec in enumerate(specs):
        ctype, chips = quota[i]
        a = _searched_assignment(spec, cost, ctype, chips)
        if a is None:
            return None
        assignments.append(a)
    assignments = tuple(assignments)
    lam = mix_rate(assignments)
    return MultiModelSchedule(
        package=hw.name, chips=hw.chips, mode=MM_PARTITIONED,
        assignments=assignments, mix_rate=lam,
        weighted_throughput=lam * sum(s.weight for s in specs),
        meta={"baseline": "equal_split"},
    )


def time_multiplexed(specs, cost: CostModel,
                     curves=None,
                     switch_cost: bool = False,
                     switch_period_s: float = 1.0) -> MultiModelSchedule | None:
    """Whole-package time slicing with optimal per-model time fractions.

    With full-package throughput ``tp_i`` and weights ``w_i``, the optimal
    slice of model i is ``share_i = (w_i / tp_i) / sum_j (w_j / tp_j)``,
    giving mix rate ``lambda = 1 / sum_j (w_j / tp_j)``.  On a heterogeneous
    package a Scope schedule is single-flavored, so each slice runs on the
    best single flavor for that model (the other flavors idle).

    ``switch_cost=True`` stops pretending slice switches are free: entering
    a model's slice re-deploys its weights through shared DRAM, charging
    ``r_i = weight_bytes_i / dram_bw_total`` per scheduling period of
    ``switch_period_s`` seconds.  The optimum then serves
    ``lambda = (1 - sum_i r_i / T) / sum_i (w_i / tp_i)`` with gross share
    ``share_i = lambda * w_i / tp_i + r_i / T``; assignments carry the
    *useful* fraction in ``time_share`` (gross shares in the meta), so the
    reported throughputs stay consistent.  Default False reproduces the
    historical zero-cost baseline numbers.

    ``curves`` (the quota search's per-(model, flavor) tables) lets
    co_schedule reuse the already-computed full-capacity points instead of
    re-running the most expensive search per model.
    """
    hw = cost.hw
    flavors = package_flavors(hw)
    picks = []
    for spec in specs:
        best = None
        for ctype, cap in flavors:
            pt = None
            if curves is not None:
                pt = curves[(spec.name, ctype)].envelope(cap)[cap]
            if pt is not None:
                tp, sched, used = pt.throughput, pt.schedule, pt.chips
            else:
                sched = search(spec.graph, cost, cap, chip_type=ctype)
                if sched is None or sched.latency == INF:
                    continue
                tp, used = cost.m / sched.latency, cap
            if best is None or tp > best[2]:
                best = (ctype, used, tp, sched)
        if best is None:
            return None
        picks.append(best)
    denom = sum(
        spec.weight / tp for spec, (_, _, tp, _) in zip(specs, picks)
    )
    meta = {"baseline": "time_multiplexed", "switch_cost": switch_cost}
    if switch_cost:
        T = switch_period_s
        reloads = [
            spec.graph.total_weight_bytes / hw.dram_bw_total for spec in specs
        ]
        overhead = sum(reloads) / T
        if overhead >= 1.0:
            return None   # the period is all switching, no useful time left
        lam = (1.0 - overhead) / denom
        meta.update(
            switch_period_s=T,
            reload_s=reloads,
            gross_shares=[
                lam * spec.weight / tp + r / T
                for spec, (_, _, tp, _), r in zip(specs, picks, reloads)
            ],
        )
    else:
        lam = 1.0 / denom
    assignments = []
    for spec, (ctype, cap, tp, sched) in zip(specs, picks):
        sched.meta["m_samples"] = cost.m
        assignments.append(ModelAssignment(
            model=spec.name, weight=spec.weight, chips=cap,
            schedule=sched, chip_type=ctype,
            time_share=lam * spec.weight / tp,   # useful (post-reload) fraction
        ))
    assignments = tuple(assignments)
    return MultiModelSchedule(
        package=hw.name, chips=hw.chips, mode=MM_TIME_MUX,
        assignments=assignments, mix_rate=mix_rate(assignments),
        weighted_throughput=mix_rate(assignments) * sum(s.weight for s in specs),
        meta=meta,
    )
