"""Per-model throughput curves over chip counts -- the quota search's table.

A copy of the JAX package's ``multimodel/curves.py``, which is JAX-free.

For each (model, chip flavor) the quota search needs ``throughput(c)`` for
every candidate quota ``c``.  Each point is a full Scope DSE
(``search(graph, cost, c, chip_type=t)``); all points share one
:class:`~repro_torch.core.fastcost.FastCostModel`, whose cluster-cost memo is keyed
on ``(graph, layer range, partitions, region_chips, ..., chip_type)`` -- so
consecutive ``c`` values re-solve mostly-cached sub-problems and a whole
curve costs a small multiple of one search (engine stats in the fig11
benchmark demonstrate the reuse).

Scope throughput is *not* monotone in chips (NoP overheads / utilization
collapse, paper Fig. 9), so a quota of ``c`` chips is served by the best
schedule using **at most** ``c`` chips (the rest idle): the curve exposes
that monotone envelope via :meth:`ThroughputCurve.envelope`.

Two extensions for large / heterogeneous packages:

* **Coarse-to-fine sampling** (``refine=True``): sample the coarse ``step``
  grid, then re-sample at step 1 inside one coarse cell around the argmax.
  The envelope stays correct at every quota (coarse points lower-bound it);
  only the peak region gets the exact resolution, which is where the quota
  search's winning candidates live.  ~10x fewer searches on 512+ chip
  packages.
* **Mixed-flavor curves** (:class:`MixedCurve`): throughput over per-flavor
  chip budget *tuples* (any flavor count), each point a full mixed-flavor
  DSE (:func:`repro_torch.core.search.search_mixed`) that may land different
  clusters of the pipeline on different flavors.  The quota search combines
  these with the single-flavor envelopes so one model of a co-schedule can
  span flavors.
"""
from __future__ import annotations

import itertools
import math

from dataclasses import dataclass, field

import numpy as np

from ..core.costmodel import INF, CostModel
from ..core.graph import LayerGraph, ScopeSchedule
from ..core.search import search, search_mixed
from ..obs import current_tracer


@dataclass
class CurvePoint:
    chips: int
    latency: float
    throughput: float
    schedule: ScopeSchedule | None
    # KV-cache concurrency bound at this quota (set by kv_bound_curve when
    # the memory bound binds; None on pure compute-bound points).
    max_seqs: int | None = None


@dataclass
class ThroughputCurve:
    """throughput(c) for one (model, chip flavor), plus monotone envelope."""
    model: str
    chip_type: str | None
    points: dict[int, CurvePoint] = field(default_factory=dict)

    def envelope(self, max_chips: int) -> list[CurvePoint | None]:
        """``envelope()[c]`` = best point using at most ``c`` chips, for
        every c in 0..max_chips (index 0 is None) -- O(1) quota lookups."""
        out: list[CurvePoint | None] = [None] * (max_chips + 1)
        best = None
        for c in range(1, max_chips + 1):
            pt = self.points.get(c)
            if (
                pt is not None and pt.schedule is not None
                and (best is None or pt.throughput > best.throughput)
            ):
                best = pt
            out[c] = best
        return out


def candidate_counts(max_chips: int, step: int = 1) -> list[int]:
    """Curve sample points: all of 1..max_chips at ``step=1``; otherwise the
    same grid ``quota._flavor_splits`` enumerates -- multiples of ``step``
    plus the remainder-shifted multiples (the first model of a flavor group
    absorbs ``max_chips % step``) plus {1, max_chips} -- so every coarse
    quota resolves to a schedule actually sized for it."""
    step = max(1, step)
    if step == 1:
        return list(range(1, max_chips + 1))
    rem = max_chips % step
    pts = set(range(step, max_chips + 1, step)) | {1, max_chips}
    if rem:
        pts |= set(range(step + rem, max_chips + 1, step))
    return sorted(pts)


def warm_counts(center: int, max_chips: int, width: int) -> list[int]:
    """Warm-start sample window: counts within ``width`` of the incumbent's
    ``center`` chips, plus {1, max_chips} so the monotone envelope stays
    defined at every quota (tiny quotas forward-fill from 1; quotas above
    the window forward-fill from its top)."""
    lo = max(1, min(center, max_chips) - width)
    hi = min(max_chips, center + width)
    return sorted({1, max_chips} | set(range(lo, hi + 1)))


def throughput_curve(
    cost: CostModel,
    graph: LayerGraph,
    max_chips: int,
    chip_type: str | None = None,
    step: int = 1,
    paper_strict: bool = False,
    refine: bool = False,
    counts: list[int] | None = None,
) -> ThroughputCurve:
    curve = ThroughputCurve(graph.name, chip_type)

    def sample(c: int) -> None:
        sched = search(graph, cost, c, chip_type=chip_type,
                       paper_strict=paper_strict)
        if sched is None or sched.latency == INF:
            curve.points[c] = CurvePoint(c, INF, 0.0, None)
            return
        sched.meta["m_samples"] = cost.m
        curve.points[c] = CurvePoint(
            c, sched.latency, cost.m / sched.latency, sched
        )

    with current_tracer().span("curve", model=graph.name,
                               flavor=chip_type or "base",
                               max_chips=max_chips, step=step) as sp:
        for c in (counts if counts is not None
                  else candidate_counts(max_chips, step)):
            sample(c)
        if refine and step > 1:
            # Coarse-to-fine: fill the one-coarse-cell neighborhood of the
            # argmax at step 1, where the quota search's winners concentrate.
            best = max(
                (p for p in curve.points.values() if p.schedule is not None),
                key=lambda p: p.throughput,
                default=None,
            )
            if best is not None:
                lo = max(1, best.chips - step + 1)
                hi = min(max_chips, best.chips + step - 1)
                for c in range(lo, hi + 1):
                    if c not in curve.points:
                        sample(c)
        sp.set(points=len(curve.points))
    return curve


def build_curves(
    specs,
    cost: CostModel,
    flavors: list[tuple[str | None, int]],
    step: int = 1,
    paper_strict: bool = False,
    refine: bool = False,
    windows: dict[str, int] | None = None,
) -> dict[tuple[str, str | None], ThroughputCurve]:
    """Curves for every (model, flavor) pair, all through one shared memo.

    ``windows`` maps model name -> incumbent chip count (a warm start):
    each curve samples only :func:`warm_counts` around the incumbent
    instead of the full grid, making a re-solve's curve pass a handful of
    (mostly memo-hit) searches.  The envelopes stay defined everywhere --
    quotas off the window just resolve to the nearest sampled schedule
    below them -- so the quota enumeration is unchanged, merely anchored
    near the incumbent allocation.
    """
    out = {}
    for spec in specs:
        counts_by_cap: dict[int, list[int]] = {}
        if windows is not None and spec.name in windows:
            center = windows[spec.name]
            for _, cap in flavors:
                width = max(2, step, cap // 16)
                counts_by_cap[cap] = warm_counts(center, cap, width)
        for ctype, cap in flavors:
            out[(spec.name, ctype)] = throughput_curve(
                cost, spec.graph, cap, ctype, step, paper_strict, refine,
                counts=counts_by_cap.get(cap),
            )
    return out


# ---------------------------------------------------------------------------
# KV-cache-bounded curves: the memory axis of autoregressive decode
# ---------------------------------------------------------------------------

def service_law(sched: ScopeSchedule) -> tuple[int, float]:
    """``(stages, beat)`` of a solved schedule -- the serving executor's
    inversion ``beat = latency / (stages - 1 + m)`` of the pipeline model,
    so ``(stages - 1 + b) * beat`` is the service time of a ``b``-sample
    batch on this schedule."""
    m = sched.meta.get("m_samples", 1)
    stages = sum(len(seg.clusters) for seg in sched.segments) or 1
    return stages, sched.latency / (stages - 1 + m)


def kv_bound_curve(curve: ThroughputCurve, seq_bytes: float,
                   capacity_per_chip: float) -> ThroughputCurve:
    """KV-capacity-bounded view of a decode throughput curve.

    A quota of ``c`` chips holds at most ``K = floor(c * capacity_per_chip
    / seq_bytes)`` concurrent sequences of KV cache.  A server whose batch
    is capped at ``K`` sustains ``K / ((stages - 1 + K) * beat)`` samples/s
    under the point's own service law, which falls below the compute rate
    ``m / latency`` exactly when ``K < m``.  Points where the memory bound
    does not bind are returned as the *same object* -- with infinite
    capacity (or zero per-sequence state) the result is bit-identical to
    the input curve -- while KV-starved points flatten to the bound
    (``max_seqs`` records ``K``) and quotas too small for even one
    sequence become infeasible.
    """
    if seq_bytes <= 0:
        return curve
    out = ThroughputCurve(curve.model, curve.chip_type)
    for c, pt in curve.points.items():
        cap = capacity_per_chip * pt.chips
        if pt.schedule is None or math.isinf(cap):
            out.points[c] = pt
            continue
        K = int(cap // seq_bytes)
        if K <= 0:
            out.points[c] = CurvePoint(pt.chips, INF, 0.0, None, max_seqs=0)
            continue
        stages, beat = service_law(pt.schedule)
        bound = K / ((stages - 1 + K) * beat)
        if bound >= pt.throughput:
            out.points[c] = pt
        else:
            out.points[c] = CurvePoint(pt.chips, pt.latency, bound,
                                       pt.schedule, max_seqs=K)
    return out


# ---------------------------------------------------------------------------
# Mixed-flavor curves: one model spanning several chip flavors
# ---------------------------------------------------------------------------

@dataclass
class MixedPoint:
    quota: tuple[int, ...]         # chips per flavor, aligned with curve.flavors
    latency: float
    throughput: float
    schedule: ScopeSchedule | None


@dataclass
class MixedCurve:
    """throughput(c_0, ..., c_{F-1}) for one model over F chip flavors."""
    model: str
    flavors: tuple[str | None, ...]
    points: dict[tuple[int, ...], MixedPoint] = field(default_factory=dict)

    def envelope(self, caps, *envs):
        """F-dimensional monotone envelope combining this curve with the
        flavors' 1D envelopes.

        ``table[c_0][c_1]...[c_{F-1}]`` is the best record reachable with
        at most ``c_f`` chips of flavor ``f``: ``(throughput, kind,
        flavor_idx, point)`` where ``kind`` is ``"single"`` (a 1D
        CurvePoint on one flavor) or ``"mixed"`` (a MixedPoint spanning
        flavors), or ``None`` when nothing fits.  The table is an
        object-dtype ndarray (``prod(caps + 1)`` cells, one DP pass in C
        order); 2-flavor callers keep their ``table[a][b]`` indexing.
        """
        def better(x, y):
            return y if x is None or (y is not None and y[0] > x[0]) else x

        shape = tuple(c + 1 for c in caps)
        table = np.empty(shape, dtype=object)
        get_point = self.points.get
        for idx in np.ndindex(shape):
            cand = None
            for f, env in enumerate(envs):
                c = idx[f]
                if c > 0 and env[c] is not None:
                    cand = better(cand, (env[c].throughput, "single", f, env[c]))
            pt = get_point(idx)
            if pt is not None and pt.schedule is not None:
                cand = better(cand, (pt.throughput, "mixed", None, pt))
            for f in range(len(caps)):
                if idx[f] > 0:
                    prev = idx[:f] + (idx[f] - 1,) + idx[f + 1:]
                    cand = better(cand, table[prev])
            table[idx] = cand
        return table


# Refinement cell budget: a window sampled at step 1 may hold at most this
# many budget pairs; larger windows are walked with a coarser stride first
# (successive halving), so refinement cost stays bounded on big packages
# where a full step-1 cell would be (2*step-1)^2 mixed DSEs.
_MAX_REFINE_CELL = 81


def _refine_grid(center: int, span: int, cap: int, stride: int) -> list[int]:
    """Stride-spaced budgets covering ``center +- span``, clipped to [1, cap]
    (both window edges always included so the cell is fully bracketed)."""
    lo, hi = max(1, center - span), min(cap, center + span)
    pts = list(range(lo, hi + 1, stride))
    if pts[-1] != hi:
        pts.append(hi)
    return pts


def mixed_throughput_curve(
    cost: CostModel,
    graph: LayerGraph,
    flavors: list[tuple[str | None, int]],
    step: int = 1,
    paper_strict: bool = False,
    cut_window: int = 2,
    refine: bool = False,
) -> MixedCurve:
    """Sample mixed-flavor DSEs over the flavors' budget grid (any F >= 2).

    Only genuinely mixed budgets (at least two flavors > 0) are sampled --
    pure quotas are covered by the 1D curves, and :meth:`MixedCurve.envelope`
    merges both.  With three or more flavors each axis grid also includes 0,
    so points spanning any flavor *subset* are reachable.  ``step`` walks
    the same coarse grid as the 1D curves (a point's budget tuple is a
    *cap*, so coarse points stay valid under the envelope).

    ``refine=True`` is the F-dimensional analogue of the 1D coarse-to-fine
    curves: after the coarse grid, the one-coarse-cell neighborhood of the
    argmax budget tuple is re-sampled down to step 1.  Small cells are
    filled exactly (mirroring the 1D pass); cells larger than
    ``_MAX_REFINE_CELL`` tuples are narrowed by successive halving --
    re-sample the window at a quarter of the current stride around the
    running argmax until stride 1 -- so the pass stays a bounded multiple
    of the coarse grid even at 512-chip flavors.
    """
    assert len(flavors) >= 2, "mixed curves need at least two flavors"
    types = tuple(t for t, _ in flavors)
    caps = [cap for _, cap in flavors]
    F = len(flavors)
    curve = MixedCurve(graph.name, types)

    def sample(quota: tuple[int, ...]) -> None:
        sched = search_mixed(
            graph, cost, [(t, q) for t, q in zip(types, quota) if q > 0],
            paper_strict=paper_strict, cut_window=cut_window,
            include_single_flavor=False,
        )
        if sched is None or sched.latency == INF:
            curve.points[quota] = MixedPoint(quota, INF, 0.0, None)
            return
        sched.meta["m_samples"] = cost.m
        curve.points[quota] = MixedPoint(
            quota, sched.latency, cost.m / sched.latency, sched
        )

    # Per-axis sample grids: the 1D candidate counts, plus 0 when a third
    # flavor exists (a point may skip flavors; with F == 2 skipping either
    # flavor degenerates to a pure quota the 1D curves already cover).
    grids = [
        ([0] if F > 2 else []) + candidate_counts(cap, step) for cap in caps
    ]
    with current_tracer().span("curve:mixed", model=graph.name,
                               flavors="/".join(str(t) for t in types),
                               step=step) as sp:
        for quota in itertools.product(*grids):
            if sum(1 for q in quota if q > 0) >= 2:
                sample(quota)

        s = step
        while refine and s > 1:
            best = max(
                (p for p in curve.points.values() if p.schedule is not None),
                key=lambda p: p.throughput,
                default=None,
            )
            if best is None:
                break
            span = s - 1
            stride = (
                1 if (2 * span + 1) ** F <= _MAX_REFINE_CELL
                else max(2, s // 4)
            )
            for quota in itertools.product(*[
                _refine_grid(best.quota[f], span, caps[f], stride)
                for f in range(F)
            ]):
                if quota not in curve.points and (
                    sum(1 for q in quota if q > 0) >= 2
                ):
                    sample(quota)
            if stride == 1:
                break
            s = stride
        sp.set(points=len(curve.points))
    return curve
