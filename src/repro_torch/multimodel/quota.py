"""Package partitioning: per-model chip quotas over an (optionally hetero) MCM.

A copy of the JAX package's ``multimodel/quota.py``, which is JAX-free.

The partitioned mode gives every model a dedicated region set drawn from one
chip flavor and runs the models' pipelines concurrently.  The search is
two-level:

1. per-(model, flavor) throughput curves (``curves.py``) -- all Scope
   sub-searches share one FastCostModel memo, so sweeping every quota size
   costs a small multiple of a single search;
2. enumeration over quota assignments: which flavor each model draws from,
   and how each flavor's chips split among its models.  This level is pure
   table lookups over the curves' monotone envelopes; it is exhaustive at
   ``step=1`` (cheap for the benchmark mixes: O(C^(N-1)) lookups) and walks
   a coarsened ``step``-chip grid for large packages / many models, where
   exact compositions would explode combinatorially.

On heterogeneous packages a third level opens up
(:func:`search_partitioned_mixed`): per-model quotas may *span* flavors, so
one model's pipeline starts on big chips and finishes on little ones
(``search_mixed``'s per-cluster flavor dimension).  Per-flavor chip splits
are enumerated independently per flavor (weak compositions, zeros allowed)
and looked up in 2D mixed envelopes (:class:`~.curves.MixedCurve`) that
combine the single-flavor curves with genuinely-mixed DSE points.

``brute_force_partitioned`` re-solves the same problem with fresh reference
searches per candidate -- exponentially slower, used by
``tests/test_multimodel.py`` to pin the table-based search on tiny cases.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from ..core.costmodel import INF, CostModel
from ..core.graph import (
    MM_PARTITIONED,
    ModelAssignment,
    MultiModelSchedule,
    mix_rate,
)
from ..core.hw import HardwareModel
from ..core.search import compositions, search
from .curves import build_curves, mixed_throughput_curve


def package_flavors(hw: HardwareModel) -> list[tuple[str | None, int]]:
    """The quota pools: ``[(chip_type_name, chips)]``; homogeneous packages
    are one anonymous pool."""
    if hw.region_types:
        return [(t.name, t.chips) for t in hw.region_types]
    return [(None, hw.chips)]


def _flavor_splits(cap: int, parts: int, step: int):
    """Splits of ``cap`` chips among ``parts`` models on a ``step`` grid.

    ``step == 1`` is every exact composition.  ``step > 1`` composes
    ``cap // step`` units of ``step`` chips (remainder to the first model) --
    the coarse grid for large packages; the curves' monotone envelope turns
    each quota into "at most this many chips", so coarse quotas stay valid,
    just less finely optimized.
    """
    if step <= 1 or cap < parts * step:
        yield from compositions(cap, parts)
        return
    units, rem = divmod(cap, step)
    for comp in compositions(units, parts):
        yield [c * step + (rem if i == 0 else 0) for i, c in enumerate(comp)]


def search_partitioned(
    specs,
    cost: CostModel,
    step: int = 1,
    paper_strict: bool = False,
    curves=None,
) -> MultiModelSchedule | None:
    """Best spatial partitioning of the package across the specs.

    The quota enumeration is evaluated as array programs, not a per-candidate
    Python loop: for each assignment of models to flavors, every flavor's
    chip splits are scored as one gather over the curves' envelope tables
    (per-split group minimum of weighted throughput).  The mix rate of a
    full candidate is the minimum across flavors, and the per-flavor maxima
    are independent, so the best split combination is recovered per flavor
    -- picking, for parity with the scalar scan this replaces, the *first*
    split on each flavor's grid that achieves the optimum.
    """
    hw = cost.hw
    flavors = package_flavors(hw)
    if curves is None:
        curves = build_curves(specs, cost, flavors, step, paper_strict)
    envelopes = {
        (name, ctype): curve.envelope(dict(flavors)[ctype])
        for (name, ctype), curve in curves.items()
    }
    # Weighted-throughput lookup tables over 0..cap chips, one per
    # (model, flavor): the whole quota grid reads from these via fancy
    # indexing instead of per-candidate attribute chasing.
    tp = {
        (name, ctype): np.array(
            [0.0 if pt is None else pt.throughput for pt in env],
            dtype=np.float64,
        )
        for (name, ctype), env in envelopes.items()
    }
    n = len(specs)
    best_lam, best_quota, n_candidates = -1.0, None, 0
    for type_assign in itertools.product(range(len(flavors)), repeat=n):
        groups: dict[int, list[int]] = {}
        for i, t in enumerate(type_assign):
            groups.setdefault(t, []).append(i)
        if any(len(g) > flavors[t][1] for t, g in groups.items()):
            continue
        # Per flavor: splits matrix (n_splits x group) and the per-split
        # group minimum of throughput/weight, in one vectorized pass.
        per_flavor = []
        count = 1
        for t, g in groups.items():
            splits = np.array(
                list(_flavor_splits(flavors[t][1], len(g), step)),
                dtype=np.int64,
            )
            ctype = flavors[t][0]
            vals = np.full(len(splits), INF)
            for col, i in enumerate(g):
                np.minimum(
                    vals,
                    tp[(specs[i].name, ctype)][splits[:, col]]
                    / specs[i].weight,
                    out=vals,
                )
            per_flavor.append((t, g, splits, vals))
            count *= len(splits)
        n_candidates += count
        # The candidate value is min over flavors; flavors split
        # independently, so the achievable optimum is the min of the
        # per-flavor maxima.
        lam = min(float(vals.max()) for _, _, _, vals in per_flavor)
        if lam > best_lam:
            best_lam = lam
            picks = [None] * n
            for t, g, splits, vals in per_flavor:
                # First split achieving >= lam: reproduces the scalar
                # product scan's pick (its first strict improvement to the
                # optimum is the lexicographically first combination whose
                # every flavor meets the bottleneck rate).
                row = int(np.argmax(vals >= lam))
                ctype = flavors[t][0]
                for col, i in enumerate(g):
                    c = int(splits[row, col])
                    picks[i] = (ctype, envelopes[(specs[i].name, ctype)][c])
            best_quota = picks
    if best_quota is None or best_lam <= 0.0:
        return None
    assignments = tuple(
        ModelAssignment(
            model=spec.name,
            weight=spec.weight,
            chips=pt.chips,
            schedule=pt.schedule,
            chip_type=ctype,
        )
        for spec, (ctype, pt) in zip(specs, best_quota)
    )
    lam = mix_rate(assignments)
    return MultiModelSchedule(
        package=hw.name,
        chips=hw.chips,
        mode=MM_PARTITIONED,
        assignments=assignments,
        mix_rate=lam,
        weighted_throughput=lam * sum(s.weight for s in specs),
        meta={
            "quota_candidates": n_candidates,
            "curve_points": sum(len(c.points) for c in curves.values()),
        },
    )


# Enumeration budget for the spanning quota search's split cross-product;
# beyond it the quota grid is coarsened (doubling steps) until it fits.
_MAX_SPLIT_CANDIDATES = 2_000_000


def _weak_splits(cap: int, parts: int, step: int):
    """Splits of up to ``cap`` chips among ``parts`` models, zeros allowed,
    on a ``step`` grid (exact-unit sums; the envelopes' "at most" semantics
    make exact-total splits lose no generality, and the ``cap % step``
    remainder tops up the first non-zero share)."""
    step = max(1, step)
    units, rem = divmod(cap, step)
    for comp in itertools.product(range(units + 1), repeat=parts - 1):
        head = sum(comp)
        if head > units:
            continue
        split = [c * step for c in comp] + [(units - head) * step]
        if rem:
            for i, c in enumerate(split):
                if c:
                    split[i] = c + rem
                    break
        yield split


def search_partitioned_mixed(
    specs,
    cost: CostModel,
    step: int = 1,
    paper_strict: bool = False,
    curves=None,
    mixed_curves=None,
    mixed_step: int | None = None,
    cut_window: int = 2,
    mixed_refine: bool = False,
) -> MultiModelSchedule | None:
    """Partitioned quotas where a model's quota may span chip flavors.

    Works on any heterogeneous package with two or more flavors (the
    big/little setting of SCAR / Odema et al. is the two-flavor case):
    per-flavor chip splits are enumerated independently per flavor and
    every split combination is scored as one array program over the models'
    F-dimensional mixed envelopes.  ``mixed_step`` walks the mixed curves'
    budget grid (default: quarter-capacity steps -- each point is a full
    mixed DSE, so the grid is deliberately coarser than the single-flavor
    curves'); ``mixed_refine`` adds the F-dimensional coarse-to-fine pass
    around each curve's argmax (:func:`~.curves.mixed_throughput_curve`).
    """
    hw = cost.hw
    flavors = package_flavors(hw)
    F = len(flavors)
    if F < 2:
        return None
    types = [t for t, _ in flavors]
    caps = [cap for _, cap in flavors]
    if curves is None:
        curves = build_curves(specs, cost, flavors, step, paper_strict)
    if mixed_step is None:
        mixed_step = max(1, min(caps) // 4)
    if mixed_curves is None:
        mixed_curves = {
            spec.name: mixed_throughput_curve(
                cost, spec.graph, flavors, step=mixed_step,
                paper_strict=paper_strict, cut_window=cut_window,
                refine=mixed_refine,
            )
            for spec in specs
        }
    env2 = {
        spec.name: mixed_curves[spec.name].envelope(
            tuple(caps),
            *[curves[(spec.name, t)].envelope(c) for t, c in flavors],
        )
        for spec in specs
    }
    n = len(specs)
    # The enumeration is the cross-product of the flavors' weak splits
    # (O((cap/step + 1)^(F(n-1))) candidates): coarsen the quota grid until
    # it is tractable -- the envelopes' "at most" semantics keep every
    # coarse quota valid, just less finely optimized (same policy as
    # _flavor_splits' step grid).
    quota_step = max(1, step)
    while math.prod(
        math.comb(cap // quota_step + n - 1, n - 1) for cap in caps
    ) > _MAX_SPLIT_CANDIDATES:
        quota_step *= 2
    # One splits matrix per flavor; the whole cross-product is scored as a
    # single F-dimensional tensor: per model, gather its envelope value at
    # every (split_0, ..., split_{F-1}) combination with np.ix_, take the
    # weighted min across models, and let the flat argmax (C order = the
    # nested-loop enumeration order this replaces, so first-occurrence
    # tie-breaks match) name the winning combination.
    splits = [
        np.array(list(_weak_splits(caps[f], n, quota_step)), dtype=np.int64)
        for f in range(F)
    ]
    n_candidates = math.prod(len(s) for s in splits)
    val = None
    for i, spec in enumerate(specs):
        env_tp = np.frompyfunc(
            lambda r: 0.0 if r is None else r[0], 1, 1
        )(env2[spec.name]).astype(np.float64) / spec.weight
        t = env_tp[np.ix_(*[splits[f][:, i] for f in range(F)])]
        val = t if val is None else np.minimum(val, t, out=val)
    flat = int(np.argmax(val))
    best_lam = float(val.flat[flat])
    if best_lam <= 0.0:
        return None
    combo = np.unravel_index(flat, val.shape)
    best_picks = [
        env2[spec.name][tuple(int(splits[f][combo[f], i]) for f in range(F))]
        for i, spec in enumerate(specs)
    ]
    assignments = []
    for spec, rec in zip(specs, best_picks):
        _tp, kind, fidx, pt = rec
        if kind == "single":
            assignments.append(ModelAssignment(
                model=spec.name, weight=spec.weight, chips=pt.chips,
                schedule=pt.schedule, chip_type=flavors[fidx][0],
            ))
        else:
            assignments.append(ModelAssignment(
                model=spec.name, weight=spec.weight,
                chips=int(sum(pt.quota)),
                schedule=pt.schedule,
                chip_quota=tuple(
                    (t, int(q)) for t, q in zip(types, pt.quota) if q
                ),
            ))
    assignments = tuple(assignments)
    lam = mix_rate(assignments)
    return MultiModelSchedule(
        package=hw.name,
        chips=hw.chips,
        mode=MM_PARTITIONED,
        assignments=assignments,
        mix_rate=lam,
        weighted_throughput=lam * sum(s.weight for s in specs),
        meta={
            "family": "partitioned_mixed",
            "quota_candidates": n_candidates,
            "quota_step": quota_step,
            "mixed_points": sum(len(c.points) for c in mixed_curves.values()),
            "mixed_step": mixed_step,
            "mixed_refine": mixed_refine,
        },
    )


def brute_force_partitioned(
    specs, hw: HardwareModel, m_samples: int = 16,
    cost_cls=CostModel,
) -> tuple[float, list[tuple[str | None, int]]]:
    """Exhaustive (flavor, chips) assignment with a fresh search per point.

    Idle chips are allowed (per-flavor sums may be < the pool), matching the
    quota search's monotone envelope.  Tiny cases only -- this is the test
    oracle, deliberately sharing no code with the table-based search.
    """
    flavors = package_flavors(hw)
    n = len(specs)
    best_lam, best_assign = 0.0, None
    for type_assign in itertools.product(range(len(flavors)), repeat=n):
        caps = [flavors[t][1] for t in type_assign]
        for chips_assign in itertools.product(
            *[range(1, c + 1) for c in caps]
        ):
            used: dict[int, int] = {}
            for t, c in zip(type_assign, chips_assign):
                used[t] = used.get(t, 0) + c
            if any(u > flavors[t][1] for t, u in used.items()):
                continue
            lam = INF
            for spec, t, c in zip(specs, type_assign, chips_assign):
                cost = cost_cls(hw, m_samples=m_samples)
                sched = search(spec.graph, cost, c, chip_type=flavors[t][0])
                tp = (
                    0.0 if sched is None or sched.latency == INF
                    else m_samples / sched.latency
                )
                lam = min(lam, tp / spec.weight)
            if lam > best_lam:
                best_lam = lam
                best_assign = [
                    (flavors[t][0], c)
                    for t, c in zip(type_assign, chips_assign)
                ]
    return best_lam, best_assign
