"""Scope Observatory: unified tracing + metrics across the DSE and executor.

A copy of the JAX package's ``obs/__init__.py``, which is JAX-free.

See :mod:`repro_torch.obs.trace` (span tracer, Chrome trace-event export),
:mod:`repro_torch.obs.metrics` (counters / gauges / histograms / time-weighted
series), and :mod:`repro_torch.obs.dashboard` (self-contained HTML rendering of
timelines, sparklines, and explain() breakdowns).  Front doors elsewhere:
``SearchOptions(trace=...)``, ``Solution.serve(tracer=...)``, and
``python -m repro solve/serve --trace ... --dashboard ...``.
"""
from .dashboard import render_dashboard, write_dashboard
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_METRICS,
    NullRegistry,
    TimeSeries,
)
from .trace import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    current_tracer,
    traced,
    use_tracer,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
    "NULL_TRACER",
    "NullRegistry",
    "NullTracer",
    "TimeSeries",
    "Tracer",
    "current_tracer",
    "render_dashboard",
    "traced",
    "use_tracer",
    "validate_chrome_trace",
    "write_dashboard",
]
