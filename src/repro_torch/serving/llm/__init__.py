"""Token-level LLM serving: phase DSE, KV-cache bounds, continuous batching.

A copy of the JAX package's ``serving/llm/__init__.py``, which is JAX-free.

The subsystem splits an autoregressive request into its two phases and
makes each a first-class DSE citizen:

* :mod:`.kv` -- per-sequence resident state (KV blocks / SSM state) and
  per-quota capacity, the memory axis the decode search trades against;
* :mod:`.phases` -- disaggregated vs colocated deployment search over
  KV-bounded throughput curves (:func:`solve_phases` -> :class:`LLMPlan`);
* :mod:`.engine` -- :class:`TokenExecutor`, a deterministic DES with
  continuous batching, EDF/SLO-aware queueing, and a static whole-request
  baseline mode;
* :mod:`.metrics` -- TTFT/TPOT percentiles, KV occupancy series, and
  SLO-gated token goodput (:class:`LLMReport`).

Front door: ``scope.solve(..., options=SearchOptions(strategy="llm-phase"))``
on an ``WorkloadSpec.lm`` problem, then ``Solution.serve(...)``.
"""
from .engine import TokenExecutor, simulate_tokens
from .kv import kv_capacity_bytes, kv_seq_bytes, max_concurrent_seqs
from .metrics import LLMModelMetrics, LLMReport, summarize_llm
from .phases import LLMPlan, PhaseAssignment, describe_llm, solve_phases

__all__ = [
    "LLMModelMetrics",
    "LLMPlan",
    "LLMReport",
    "PhaseAssignment",
    "TokenExecutor",
    "describe_llm",
    "kv_capacity_bytes",
    "kv_seq_bytes",
    "max_concurrent_seqs",
    "simulate_tokens",
    "solve_phases",
    "summarize_llm",
]
