"""Serving executor: run a solved Deployment under synthetic traffic.

A copy of the JAX package's ``serving/__init__.py``, which is JAX-free.

The pieces, in data-flow order:

* :mod:`.traffic` -- seeded open-loop request generators (Poisson, bursty
  MMPP, diurnal ramp) producing the merged arrival trace;
* :mod:`.executor` -- the discrete-event engine: per-model FIFO queues, a
  max-batch/max-delay batcher, and servers that enforce exactly the
  resources the co-schedule granted (quota sub-meshes, time-mux slice
  windows with switch cost, merged interleave rates);
* :mod:`.metrics` -- goodput, latency percentiles, queue depths, chip
  utilization, SLO attainment (:class:`~.metrics.ServingReport`);
* :mod:`.autoscale` -- the online re-solve hook (sliding-window mix drift
  -> re-plan through the facade's cached solver);
* :mod:`.faults` -- seeded chip/zone/seam failure injection and the
  degraded-package recovery path (shared with the ft trainer);
* :mod:`.llm` -- token-level LLM serving: prefill/decode phase plans,
  KV-cache-bounded quotas, continuous batching, TTFT/TPOT metrics
  (:class:`~.llm.TokenExecutor` / :class:`~.llm.LLMReport`).

Front doors: :meth:`repro_torch.api.Solution.serve` and
``python -m repro serve`` (``--faults`` for chaos scenarios, ``--llm``
for token-level mixes).
"""
from .autoscale import AutoscalePolicy, Autoscaler
from .faults import FaultEvent, FaultInjector, InjectedFault, parse_faults
from .executor import (
    BatchingPolicy,
    ServiceModel,
    ServingExecutor,
    allocate_submeshes,
    measure_service_models,
    service_from_assignment,
    simulate,
)
from .llm import (
    LLMPlan,
    LLMReport,
    TokenExecutor,
    simulate_tokens,
    solve_phases,
)
from .metrics import ModelMetrics, ServingReport, percentile
from .traffic import (
    MMPP,
    Diurnal,
    Poisson,
    Request,
    TokenLengths,
    phased_trace,
    request_trace,
)

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "BatchingPolicy",
    "Diurnal",
    "FaultEvent",
    "FaultInjector",
    "InjectedFault",
    "LLMPlan",
    "LLMReport",
    "MMPP",
    "ModelMetrics",
    "Poisson",
    "Request",
    "ServiceModel",
    "ServingExecutor",
    "ServingReport",
    "TokenExecutor",
    "TokenLengths",
    "allocate_submeshes",
    "measure_service_models",
    "parse_faults",
    "percentile",
    "phased_trace",
    "request_trace",
    "service_from_assignment",
    "simulate",
    "simulate_tokens",
    "solve_phases",
]
