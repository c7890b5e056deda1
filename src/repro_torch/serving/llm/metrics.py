"""Token-level serving metrics: TTFT / TPOT percentiles, KV occupancy,
SLO-gated token goodput.

A copy of the JAX package's ``serving/llm/metrics.py``, which is JAX-free.

Whole-request latency is the wrong yardstick for autoregressive serving --
a request streaming 500 tokens is *supposed* to take long.  The LLM report
gates goodput on the two quantities users actually feel:

* **TTFT** -- time to first token (arrival to the end of the prefill pass,
  hand-off delay included on disaggregated deployments);
* **TPOT** -- time per output token, ``(t_last - t_first) / (n - 1)`` over
  the decode stream.

**Token goodput** counts the output tokens of completed requests that met
*both* SLOs, divided by the makespan.  KV occupancy is recorded as a
time-weighted :class:`~repro_torch.obs.TimeSeries` per model (``kv_bytes/<m>``
in the registry) -- its peak must stay under the searched capacity bound,
which the benchmarks assert.  Conservation is strict at request
granularity: arrived == completed + dropped-by-cause + in-flight at end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ...obs import MetricsRegistry, TimeSeries
from ..metrics import aggregate_waterfalls, percentile

__all__ = ["LLM_WATERFALL_COMPONENTS", "LLMModelMetrics", "LLMReport",
           "summarize_llm"]

#: Per-request latency waterfall for token-level serving, in causal order:
#: arrival -> prefill-batch start -> first token -> decode-eligible ->
#: pool admission -> last token.  Folding the components left-to-right
#: reproduces end-to-end latency bit-exactly (single-token requests stop
#: after ``prefill``).
LLM_WATERFALL_COMPONENTS = (
    "queue_wait", "prefill", "kv_handoff", "admission_wait", "decode")


@dataclass
class LLMModelMetrics:
    model: str
    chips: int                      # prefill + decode quota (shared once
    #                                 when colocated)
    arrived_requests: int = 0
    completed_requests: int = 0
    dropped_requests: int = 0
    drop_causes: dict = field(default_factory=dict)   # cause -> requests
    queued_end_requests: int = 0    # still in flight when the run ended
    prefill_batches: int = 0
    decode_steps: int = 0
    admitted_midbatch: int = 0      # sequences joining a running decode batch
    prompt_tokens: int = 0          # of completed requests
    output_tokens: int = 0
    token_throughput: float = 0.0   # output tokens / s
    token_goodput: float = 0.0      # SLO-gated output tokens / s
    ttft_mean_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    ttft_p99_s: float = 0.0
    tpot_mean_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p95_s: float = 0.0
    tpot_p99_s: float = 0.0
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None
    slo_attainment: float = 1.0     # completed requests meeting both SLOs
    kv_peak_bytes: float = 0.0
    kv_mean_bytes: float = 0.0
    kv_capacity_bytes: float = 0.0

    def to_json(self) -> dict:
        return dict(self.__dict__)


@dataclass
class LLMReport:
    """One token-level serving run, aggregated."""
    mode: str                       # "disaggregated" | "colocated"
    batching: str                   # "continuous" | "static"
    package: str
    chips: int
    seed: int
    horizon_s: float
    makespan_s: float
    per_model: dict[str, LLMModelMetrics] = field(default_factory=dict)
    total_arrived: int = 0          # requests
    total_completed: int = 0
    total_dropped: int = 0
    total_queued_end: int = 0
    prompt_tokens: int = 0
    output_tokens: int = 0
    token_throughput: float = 0.0
    token_goodput: float = 0.0
    ttft_p95_s: float = 0.0
    tpot_p95_s: float = 0.0
    slo_attainment: float = 1.0
    admitted_midbatch: int = 0
    utilization: float = 0.0
    waterfalls: dict = field(default_factory=dict)  # model -> [per-request]
    meta: dict = field(default_factory=dict)
    metrics: Any = None             # MetricsRegistry
    tracer: Any = None

    @property
    def conserved(self) -> bool:
        """Strict request conservation with attributed drops."""
        if self.total_arrived != (self.total_completed + self.total_dropped
                                  + self.total_queued_end):
            return False
        for m in self.per_model.values():
            if m.arrived_requests != (m.completed_requests
                                      + m.dropped_requests
                                      + m.queued_end_requests):
                return False
            if sum(m.drop_causes.values()) != m.dropped_requests:
                return False
        return True

    def explain(self) -> dict:
        """Aggregate per-request waterfalls: where does TTFT+decode time go?"""
        return aggregate_waterfalls(self.waterfalls,
                                    order=LLM_WATERFALL_COMPONENTS)

    def to_json(self) -> dict:
        out = {k: v for k, v in self.__dict__.items()
               if k not in ("per_model", "meta", "metrics", "tracer",
                            "waterfalls")}
        out["conserved"] = self.conserved
        out["per_model"] = {m: mm.to_json() for m, mm in self.per_model.items()}
        out["meta"] = self.meta
        if self.waterfalls:
            out["explain"] = self.explain()
        return out

    def describe(self) -> list[str]:
        lines = [
            f"{self.package} [{self.mode}/{self.batching}] seed={self.seed}: "
            f"{self.total_completed}/{self.total_arrived} requests, "
            f"{self.output_tokens} tokens in {self.makespan_s:.3f}s -> "
            f"goodput {self.token_goodput:.1f} tok/s "
            f"(throughput {self.token_throughput:.1f}), "
            f"TTFT p95 {self.ttft_p95_s * 1e3:.1f}ms, "
            f"TPOT p95 {self.tpot_p95_s * 1e3:.2f}ms"
        ]
        for m in self.per_model.values():
            kv = (f"  KV peak {m.kv_peak_bytes / 2**20:.1f}/"
                  f"{m.kv_capacity_bytes / 2**20:.0f} MiB"
                  if m.kv_capacity_bytes else "")
            lines.append(
                f"  {m.model:20s} {m.chips:3d} chips  "
                f"{m.completed_requests:5d} done  "
                f"{m.token_goodput:8.1f} tok/s  "
                f"TTFT p95 {m.ttft_p95_s * 1e3:7.1f}ms  "
                f"TPOT p95 {m.tpot_p95_s * 1e3:6.2f}ms  "
                f"slo {m.slo_attainment:.0%}  midbatch {m.admitted_midbatch}"
                f"{kv}"
            )
        return lines


def summarize_llm(
    *,
    mode: str,
    batching: str,
    package: str,
    chips: int,
    seed: int,
    horizon_s: float,
    makespan_s: float,
    arrived: dict[str, int],
    dropped: dict[str, dict[str, int]],            # model -> cause -> requests
    queued_end: dict[str, int],
    completions: dict[str, list[tuple]],           # (ttft, tpot|None, prompt, out)
    slos: dict[str, tuple[float | None, float | None]],
    model_chips: dict[str, int],
    prefill_batches: dict[str, int],
    decode_steps: dict[str, int],
    admitted_midbatch: dict[str, int],
    kv_traces: dict[str, list[tuple[float, float]]],
    kv_capacity: dict[str, float],
    busy_chip_s: dict[str, float],
    queue_traces: dict[str, list[tuple[float, float]]] | None = None,
    waterfalls: dict[str, list[dict]] | None = None,
    meta: dict | None = None,
) -> LLMReport:
    span = max(makespan_s, 1e-12)
    registry = MetricsRegistry()
    rep = LLMReport(mode=mode, batching=batching, package=package,
                    chips=chips, seed=seed, horizon_s=horizon_s,
                    makespan_s=makespan_s, waterfalls=waterfalls or {},
                    meta=meta or {}, metrics=registry)
    all_ttft: list[float] = []
    all_tpot: list[float] = []
    good_tokens = 0
    met_total = done_total = 0
    busy_total = 0.0
    for model in sorted(arrived):
        recs = completions.get(model, [])
        ttfts = sorted(r[0] for r in recs)
        tpots = sorted(r[1] for r in recs if r[1] is not None)
        ttft_slo, tpot_slo = slos.get(model, (None, None))
        good = met = 0
        for ttft, tpot, _, out in recs:
            ok = (ttft_slo is None or ttft <= ttft_slo) and (
                tpot_slo is None or tpot is None or tpot <= tpot_slo)
            if ok:
                met += 1
                good += out
        causes = dropped.get(model, {})
        out_tokens = sum(r[3] for r in recs)
        kv = registry.series[f"kv_bytes/{model}"] = TimeSeries()
        kv.extend(kv_traces.get(model, []))
        if queue_traces and queue_traces.get(model):
            qs = registry.series[f"queue_depth/{model}"] = TimeSeries()
            qs.extend(queue_traces[model])
        registry.histogram(f"ttft_s/{model}").values.extend(ttfts)
        registry.histogram(f"tpot_s/{model}").values.extend(tpots)
        registry.counter(f"llm.admitted_midbatch/{model}").set(
            admitted_midbatch.get(model, 0))
        mm = LLMModelMetrics(
            model=model, chips=model_chips.get(model, 0),
            arrived_requests=arrived[model],
            completed_requests=len(recs),
            dropped_requests=sum(causes.values()),
            drop_causes=dict(causes),
            queued_end_requests=queued_end.get(model, 0),
            prefill_batches=prefill_batches.get(model, 0),
            decode_steps=decode_steps.get(model, 0),
            admitted_midbatch=admitted_midbatch.get(model, 0),
            prompt_tokens=sum(r[2] for r in recs),
            output_tokens=out_tokens,
            token_throughput=out_tokens / span,
            token_goodput=good / span,
            ttft_mean_s=sum(ttfts) / len(ttfts) if ttfts else 0.0,
            ttft_p50_s=percentile(ttfts, 50),
            ttft_p95_s=percentile(ttfts, 95),
            ttft_p99_s=percentile(ttfts, 99),
            tpot_mean_s=sum(tpots) / len(tpots) if tpots else 0.0,
            tpot_p50_s=percentile(tpots, 50),
            tpot_p95_s=percentile(tpots, 95),
            tpot_p99_s=percentile(tpots, 99),
            ttft_slo_s=ttft_slo, tpot_slo_s=tpot_slo,
            slo_attainment=met / len(recs) if recs else 1.0,
            kv_peak_bytes=kv.max,
            kv_mean_bytes=kv.mean(makespan_s),
            kv_capacity_bytes=kv_capacity.get(model, 0.0),
        )
        rep.per_model[model] = mm
        rep.total_arrived += mm.arrived_requests
        rep.total_completed += mm.completed_requests
        rep.total_dropped += mm.dropped_requests
        rep.total_queued_end += mm.queued_end_requests
        rep.prompt_tokens += mm.prompt_tokens
        rep.output_tokens += mm.output_tokens
        rep.admitted_midbatch += mm.admitted_midbatch
        all_ttft.extend(ttfts)
        all_tpot.extend(tpots)
        good_tokens += good
        met_total += met
        done_total += len(recs)
        busy_total += busy_chip_s.get(model, 0.0)
    registry.counter("llm.admitted_midbatch").set(rep.admitted_midbatch)
    all_ttft.sort()
    all_tpot.sort()
    rep.token_throughput = rep.output_tokens / span
    rep.token_goodput = good_tokens / span
    rep.ttft_p95_s = percentile(all_ttft, 95)
    rep.tpot_p95_s = percentile(all_tpot, 95)
    rep.slo_attainment = met_total / done_total if done_total else 1.0
    rep.utilization = busy_total / (max(1, chips) * span)
    return rep
