"""Serving metrics: latency percentiles, goodput, queues, utilization, SLOs.

A copy of the JAX package's ``serving/metrics.py``, which is JAX-free.

The executor feeds per-request completion records and per-server counters
into :func:`summarize`, which produces a :class:`ServingReport` -- the JSON
payload of ``python -m repro serve --json`` and the rows of
``BENCH_serving.json``.

Definitions (per model and aggregated):

* **throughput** -- completed samples / makespan (arrival start to last
  completion);
* **goodput** -- SLO-satisfying completed samples / makespan (== throughput
  when the model has no SLO);
* **latency** -- request sojourn time, arrival to batch completion
  (p50/p95/p99 by nearest-rank on the exact sorted latencies);
* **queue depth** -- time-weighted mean and max of queued samples;
* **utilization** -- busy chip-seconds / (quota chips x makespan); the
  aggregate weights each model by its chip quota, so idle chips of the
  package count against it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..core.costmodel import conserve_components, fold_components
from ..obs import MetricsRegistry, TimeSeries

__all__ = [
    "WATERFALL_COMPONENTS",
    "ModelMetrics",
    "ServingReport",
    "aggregate_waterfalls",
    "conserve_waterfall",
    "percentile",
    "summarize",
]

# Latency-waterfall components (Scope Lens).  Per completed request they
# fold -- in this fixed order -- bit-identically to the measured end-to-end
# latency (same conservation machinery as the DSE CostBreakdown).
WATERFALL_COMPONENTS = ("queue_wait", "batch_delay", "service",
                        "stall_time_mux", "dead_fault", "dead_autoscale")


def conserve_waterfall(components: dict, total: float,
                       order=WATERFALL_COMPONENTS) -> dict:
    """Waterfall components adjusted to fold bit-identically to ``total``."""
    return conserve_components(components, total, order=order)


def aggregate_waterfalls(waterfalls: dict[str, list[dict]],
                         order=WATERFALL_COMPONENTS) -> dict:
    """Aggregate per-request waterfalls into an attribution table.

    Returns per-model and overall rows: request count, mean latency,
    per-component mean seconds + share of total, the dominant component,
    and whether every request's components conserved its latency exactly.
    """
    def rows(wfs: list[dict]) -> dict:
        n = len(wfs)
        sums = dict.fromkeys(order, 0.0)
        total = 0.0
        conserved = True
        for wf in wfs:
            for k in order:
                sums[k] += wf.get(k, 0.0)
            total += wf["total"]
            if fold_components(wf, order) != wf["total"]:
                conserved = False
        comp = {
            k: {"mean_s": sums[k] / n if n else 0.0,
                "share": sums[k] / total if total > 0 else 0.0}
            for k in order
        }
        dominant = (max(order, key=lambda k: sums[k]) if n else None)
        return {"requests": n,
                "latency_mean_s": total / n if n else 0.0,
                "components": comp, "dominant": dominant,
                "conserved": conserved}

    out = {"per_model": {m: rows(wfs) for m, wfs in sorted(waterfalls.items())},
           "overall": rows([wf for wfs in waterfalls.values() for wf in wfs])}
    out["conserved"] = (out["overall"]["conserved"]
                        and all(r["conserved"]
                                for r in out["per_model"].values()))
    return out


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    k = max(1, int(-(-q * len(sorted_vals) // 100)))   # ceil without floats
    return sorted_vals[min(k, len(sorted_vals)) - 1]


def _queue_series(trace: list[tuple[float, int]]) -> TimeSeries:
    """The queue-depth step trace as an obs :class:`TimeSeries`.

    Statistics are time-weighted over the whole run (time 0 to ``t_end``;
    the queue is empty before its first event), so per-model values in one
    report share a denominator."""
    ts = TimeSeries()
    ts.extend(trace)
    return ts


@dataclass
class ModelMetrics:
    model: str
    chips: int
    arrived_requests: int = 0
    arrived_samples: int = 0
    completed_requests: int = 0
    completed_samples: int = 0
    dropped_requests: int = 0
    dropped_samples: int = 0
    # dropped, attributed: cause -> (requests, samples); the per-cause sums
    # equal the aggregate dropped_* fields (strict conservation evidence)
    drop_causes: dict = field(default_factory=dict)
    # samples still queued when the run ended (a failed-and-never-repaired
    # server strands its queue; conservation counts them explicitly)
    queued_end_requests: int = 0
    queued_end_samples: int = 0
    batches: int = 0
    throughput: float = 0.0
    goodput: float = 0.0
    latency_mean_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    latency_p99_s: float = 0.0
    latency_max_s: float = 0.0
    queue_mean: float = 0.0
    queue_max: int = 0
    queue_p95: float = 0.0          # time-weighted p95 of the depth series
    utilization: float = 0.0
    busy_s: float = 0.0
    slo_s: float | None = None
    slo_attainment: float = 1.0    # completed requests meeting the SLO

    def to_json(self) -> dict:
        return dict(self.__dict__)


@dataclass
class ServingReport:
    """Everything one simulated serving run produced."""
    mode: str                       # co-schedule mode the deployment ran
    package: str
    chips: int
    seed: int
    horizon_s: float                # arrival window
    makespan_s: float               # last completion (drain included)
    per_model: dict[str, ModelMetrics] = field(default_factory=dict)
    # aggregates
    total_arrived: int = 0
    total_completed: int = 0
    total_dropped: int = 0
    total_queued_end: int = 0       # samples stranded in queues at run end
    throughput: float = 0.0         # completed samples/s over the makespan
    goodput: float = 0.0            # SLO-satisfying samples/s
    latency_p95_s: float = 0.0      # over all requests
    slo_attainment: float = 1.0
    utilization: float = 0.0        # busy chip-seconds / (package x makespan)
    placement: dict = field(default_factory=dict)   # model -> per-flavor coords
    autoscale: dict | None = None
    faults: dict | None = None      # fault log / recovery metrics (see executor)
    meta: dict = field(default_factory=dict)
    # observability (repro_torch.obs): queue-depth TimeSeries et al live here;
    # report.tracer is set by Solution.serve(tracer=...)
    metrics: Any = None             # MetricsRegistry
    tracer: Any = None              # Tracer
    # per-request latency waterfalls: model -> [ {component: s, total: s} ]
    waterfalls: dict = field(default_factory=dict)

    def explain(self) -> dict:
        """Latency attribution (Scope Lens): per-request waterfalls
        aggregated per model and overall, dead time by cause.  Every
        completed request's components fold bit-identically to its
        measured latency (``["conserved"]``)."""
        out = aggregate_waterfalls(self.waterfalls)
        out["dead_time_s"] = {
            "fault": sum(wf["dead_fault"] for wfs in self.waterfalls.values()
                         for wf in wfs),
            "autoscale": sum(wf["dead_autoscale"]
                             for wfs in self.waterfalls.values()
                             for wf in wfs),
            "time_mux": sum(wf["stall_time_mux"]
                            for wfs in self.waterfalls.values()
                            for wf in wfs),
        }
        return out

    @property
    def conserved(self) -> bool:
        """Strict conservation: every arrived sample was served, is still
        queued, or was dropped for a named cause."""
        if self.total_arrived != (self.total_completed + self.total_dropped
                                  + self.total_queued_end):
            return False
        # every drop must carry a cause that sums back to the aggregate
        for m in self.per_model.values():
            by_cause = sum(s for _, s in m.drop_causes.values())
            if by_cause != m.dropped_samples:
                return False
        return True

    def to_json(self) -> dict:
        out = {
            k: v for k, v in self.__dict__.items()
            if k not in ("per_model", "placement", "autoscale", "meta",
                         "metrics", "tracer", "waterfalls")
        }
        out["conserved"] = self.conserved
        if self.waterfalls:
            out["explain"] = self.explain()
        out["per_model"] = {m: mm.to_json() for m, mm in self.per_model.items()}
        out["placement"] = {
            m: {str(f): len(coords) for f, coords in zones.items()}
            for m, zones in self.placement.items()
        }
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale
        out["meta"] = self.meta
        return out

    def describe(self) -> list[str]:
        lines = [
            f"{self.package} [{self.mode}] seed={self.seed}: "
            f"{self.total_completed}/{self.total_arrived} samples in "
            f"{self.makespan_s:.3f}s -> goodput {self.goodput:.1f}/s "
            f"(throughput {self.throughput:.1f}/s), p95 "
            f"{self.latency_p95_s * 1e3:.2f}ms, util {self.utilization:.0%}"
        ]
        for m in self.per_model.values():
            slo = (f" slo {m.slo_attainment:.0%}@{m.slo_s * 1e3:g}ms"
                   if m.slo_s else "")
            lines.append(
                f"  {m.model:12s} {m.chips:3d} chips  "
                f"{m.completed_samples:6d} done  {m.goodput:8.1f}/s  "
                f"p95 {m.latency_p95_s * 1e3:7.2f}ms  q~{m.queue_mean:.1f}"
                f"{slo}"
            )
        if self.autoscale is not None:
            ev = self.autoscale.get("events", [])
            lines.append(
                f"  autoscale: {len(ev)} re-solve(s), "
                f"cache {self.autoscale.get('solve_cache', {})}"
            )
        if self.faults is not None:
            f = self.faults
            ttr = f.get("mean_ttr_s")
            lines.append(
                f"  faults: {f.get('events', 0)} event(s), availability "
                f"{f.get('availability', 1.0):.1%}, "
                + (f"mean time-to-recover {ttr:.3f}s"
                   if ttr is not None else "no recovery needed")
                + (f", {f['unrecovered']} unrecovered"
                   if f.get("unrecovered") else "")
            )
            pre, post = f.get("goodput_pre_fault"), f.get(
                "goodput_post_recovery")
            if pre is not None and post is not None:
                lines.append(
                    f"    goodput pre-fault {pre:.1f}/s -> post-recovery "
                    f"{post:.1f}/s (through failure windows "
                    f"{f.get('goodput_in_failure') or 0.0:.1f}/s)"
                )
            if self.total_queued_end:
                lines.append(
                    f"    {self.total_queued_end} samples still queued at "
                    "run end (unrepaired capacity)"
                )
        return lines


def summarize(
    *,
    mode: str,
    package: str,
    chips: int,
    seed: int,
    horizon_s: float,
    makespan_s: float,
    arrived: dict[str, tuple[int, int]],          # model -> (requests, samples)
    dropped: dict[str, dict[str, tuple[int, int]]],   # model -> cause -> (r, s)
    latencies: dict[str, list[float]],            # per completed *request*
    request_samples: dict[str, list[int]],        # aligned with latencies
    batches: dict[str, int],
    busy_s: dict[str, float],
    model_chips: dict[str, int],
    queue_traces: dict[str, list[tuple[float, int]]],
    slos: dict[str, float | None],
    placement: dict,
    autoscale: dict | None = None,
    meta: dict | None = None,
    package_busy_chip_s: float | None = None,
    queued_end: dict[str, tuple[int, int]] | None = None,
    faults: dict | None = None,
    waterfalls: dict[str, list[dict]] | None = None,
) -> ServingReport:
    span = max(makespan_s, 1e-12)
    registry = MetricsRegistry()
    rep = ServingReport(mode=mode, package=package, chips=chips, seed=seed,
                        horizon_s=horizon_s, makespan_s=makespan_s,
                        placement=placement, autoscale=autoscale,
                        faults=faults, meta=meta or {}, metrics=registry,
                        waterfalls=waterfalls or {})
    all_lat: list[float] = []
    good_total = busy_chip_s = 0.0
    slo_met = slo_reqs = 0
    for model in sorted(arrived):
        a_req, a_smp = arrived[model]
        causes = dropped.get(model, {})
        d_req = sum(r for r, _ in causes.values())
        d_smp = sum(s for _, s in causes.values())
        q_req, q_smp = (queued_end or {}).get(model, (0, 0))
        lats = sorted(latencies.get(model, []))
        smps = request_samples.get(model, [])
        done_req = len(smps)
        done_smp = sum(smps)
        slo = slos.get(model)
        good = done_smp
        met = done_req
        if slo is not None:
            good = sum(s for lat, s in zip(latencies[model], smps)
                       if lat <= slo)
            met = sum(1 for lat in latencies[model] if lat <= slo)
        q_series = registry.series[f"queue_depth/{model}"] = _queue_series(
            queue_traces.get(model, []))
        q_mean = q_series.mean(makespan_s)
        q_max = q_series.max
        q_p95 = q_series.percentile(95, makespan_s)
        registry.histogram(f"latency_s/{model}").values.extend(lats)
        chips_m = model_chips.get(model, 0)
        busy = busy_s.get(model, 0.0)
        mm = ModelMetrics(
            model=model, chips=chips_m,
            arrived_requests=a_req, arrived_samples=a_smp,
            completed_requests=done_req, completed_samples=done_smp,
            dropped_requests=d_req, dropped_samples=d_smp,
            drop_causes={c: tuple(v) for c, v in causes.items()},
            queued_end_requests=q_req, queued_end_samples=q_smp,
            batches=batches.get(model, 0),
            throughput=done_smp / span,
            goodput=good / span,
            latency_mean_s=sum(lats) / done_req if done_req else 0.0,
            latency_p50_s=percentile(lats, 50),
            latency_p95_s=percentile(lats, 95),
            latency_p99_s=percentile(lats, 99),
            latency_max_s=lats[-1] if lats else 0.0,
            queue_mean=q_mean, queue_max=q_max, queue_p95=q_p95,
            utilization=busy / span if chips_m else 0.0,
            busy_s=busy, slo_s=slo,
            slo_attainment=met / done_req if done_req else 1.0,
        )
        rep.per_model[model] = mm
        rep.total_arrived += a_smp
        rep.total_completed += done_smp
        rep.total_dropped += d_smp
        rep.total_queued_end += q_smp
        all_lat.extend(lats)
        good_total += good
        busy_chip_s += busy * chips_m
        slo_met += met
        slo_reqs += done_req
    all_lat.sort()
    rep.throughput = rep.total_completed / span
    rep.goodput = good_total / span
    rep.latency_p95_s = percentile(all_lat, 95)
    rep.slo_attainment = slo_met / slo_reqs if slo_reqs else 1.0
    # callers whose servers share one physical resource (merged pipelines)
    # pass the de-duplicated busy chip-seconds explicitly
    if package_busy_chip_s is not None:
        busy_chip_s = package_busy_chip_s
    rep.utilization = busy_chip_s / (max(1, chips) * span)
    return rep
