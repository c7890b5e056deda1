"""Seeded open-loop request generators for the serving executor.

A copy of the JAX package's ``serving/traffic.py``, which is JAX-free.

Each model of a mix gets an arrival process producing ``Request`` records
``(t_arrive, model, samples)``; the executor replays the merged trace.  All
generators are *open-loop* (arrivals do not react to service) and fully
deterministic under a seed: every model draws from its own
``numpy.random.Generator`` seeded by ``(seed, crc32(model_name))``, so
adding or removing one model never perturbs another model's arrivals.

Three arrival processes, the usual serving-simulator trio:

* :class:`Poisson` -- homogeneous Poisson at ``rate`` requests/s;
* :class:`MMPP` -- a 2-state Markov-modulated Poisson process (bursty
  traffic: exponential dwell in a low-rate and a high-rate state);
* :class:`Diurnal` -- non-homogeneous Poisson with a raised-cosine rate
  ramp between ``rate_trough`` and ``rate_peak`` (one ``period_s`` =
  one simulated "day"), sampled by thinning.

:func:`request_trace` merges per-model streams into one time-sorted trace;
:func:`phased_trace` concatenates traffic phases (the autoscale benchmark's
mix-flip scenario).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "Diurnal",
    "MMPP",
    "Poisson",
    "Request",
    "TokenLengths",
    "model_rng",
    "phased_trace",
    "request_trace",
]


@dataclass(frozen=True, order=True)
class Request:
    """One admitted unit of work: ``samples`` inputs for ``model``.

    Token-level serving stamps each request with its prompt and output
    lengths (seeded draws from a :class:`TokenLengths` distribution); the
    whole-request executor ignores both fields.
    """
    t_arrive: float
    model: str
    samples: int = 1
    seq: int = 0          # global arrival index (deterministic tie-break)
    prompt_tokens: int = 0
    output_tokens: int = 0


def model_rng(seed: int, model: str) -> np.random.Generator:
    """Per-(seed, model) generator: streams are independent and stable."""
    return np.random.default_rng([seed, zlib.crc32(model.encode())])


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Poisson:
    """Homogeneous Poisson arrivals at ``rate`` requests/s."""
    rate: float
    batch_hint: int = 1            # samples per request

    @property
    def mean_rate(self) -> float:
        return self.rate

    def arrival_times(self, rng: np.random.Generator,
                      horizon_s: float) -> list[float]:
        if self.rate <= 0:
            return []
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t >= horizon_s:
                return out
            out.append(t)


@dataclass(frozen=True)
class MMPP:
    """2-state Markov-modulated Poisson process (bursty traffic).

    The process dwells exponentially (means ``mean_low_s`` /
    ``mean_high_s``) in a low-rate and a high-rate state; within a state
    arrivals are Poisson at that state's rate.
    """
    rate_low: float
    rate_high: float
    mean_low_s: float = 1.0
    mean_high_s: float = 0.25
    batch_hint: int = 1

    @property
    def mean_rate(self) -> float:
        return (self.rate_low * self.mean_low_s
                + self.rate_high * self.mean_high_s) / (
            self.mean_low_s + self.mean_high_s)

    def arrival_times(self, rng: np.random.Generator,
                      horizon_s: float) -> list[float]:
        out: list[float] = []
        t, high = 0.0, False
        while t < horizon_s:
            dwell = rng.exponential(self.mean_high_s if high else self.mean_low_s)
            end = min(t + dwell, horizon_s)
            rate = self.rate_high if high else self.rate_low
            if rate > 0:
                at = t
                while True:
                    at += rng.exponential(1.0 / rate)
                    if at >= end:
                        break
                    out.append(at)
            t, high = end, not high
        return out


@dataclass(frozen=True)
class Diurnal:
    """Non-homogeneous Poisson ramp: raised-cosine rate between trough and
    peak over ``period_s`` (thinning / Lewis-Shedler sampling)."""
    rate_peak: float
    rate_trough: float = 0.0
    period_s: float = 60.0
    phase_s: float = 0.0
    batch_hint: int = 1

    @property
    def mean_rate(self) -> float:
        return 0.5 * (self.rate_peak + self.rate_trough)

    def rate_at(self, t: float) -> float:
        x = 2.0 * np.pi * (t + self.phase_s) / self.period_s
        return self.rate_trough + (self.rate_peak - self.rate_trough) * (
            0.5 * (1.0 - np.cos(x))
        )

    def arrival_times(self, rng: np.random.Generator,
                      horizon_s: float) -> list[float]:
        if self.rate_peak <= 0:
            return []
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.rate_peak)
            if t >= horizon_s:
                return out
            if rng.random() * self.rate_peak < self.rate_at(t):
                out.append(t)


@dataclass(frozen=True)
class TokenLengths:
    """Seeded per-request (prompt, output) token-length distribution.

    Lengths are lognormal with the given means and coefficients of
    variation (the long right tail is what makes static whole-request
    batching waste decode slots), rounded to ints and clamped to
    ``[1, *_max]``.  Draws come from a dedicated ``(seed, model)`` stream
    so stamping lengths never perturbs the arrival process.
    """
    prompt_mean: float = 512.0
    output_mean: float = 128.0
    prompt_cv: float = 0.5
    output_cv: float = 0.5
    prompt_max: int | None = None
    output_max: int | None = None

    @staticmethod
    def _draw(rng: np.random.Generator, n: int, mean: float, cv: float,
              cap: int | None) -> np.ndarray:
        if cv <= 0:
            out = np.full(n, mean)
        else:
            sigma2 = np.log1p(cv * cv)
            mu = np.log(mean) - 0.5 * sigma2
            out = rng.lognormal(mu, np.sqrt(sigma2), size=n)
        out = np.maximum(1, np.rint(out)).astype(int)
        return np.minimum(out, cap) if cap is not None else out

    def sample(self, rng: np.random.Generator,
               n: int) -> tuple[np.ndarray, np.ndarray]:
        return (
            self._draw(rng, n, self.prompt_mean, self.prompt_cv,
                       self.prompt_max),
            self._draw(rng, n, self.output_mean, self.output_cv,
                       self.output_max),
        )


def _coerce(model: str, spec) -> object:
    if isinstance(spec, (int, float)):
        return Poisson(rate=float(spec))
    if hasattr(spec, "arrival_times"):
        return spec
    raise TypeError(f"{model}: cannot interpret traffic spec {spec!r}")


# ---------------------------------------------------------------------------
# Trace assembly
# ---------------------------------------------------------------------------

def request_trace(
    traffic: dict[str, object],
    horizon_s: float,
    seed: int = 0,
    t0: float = 0.0,
    seq0: int = 0,
    lengths: "TokenLengths | dict[str, TokenLengths] | None" = None,
) -> list[Request]:
    """Merge per-model arrival streams into one sorted request trace.

    ``traffic`` maps model name -> arrival process (or a bare number,
    taken as a Poisson rate in requests/s).  Ties are broken by model name
    then per-model order, so the trace is bytewise deterministic.

    ``lengths`` (one :class:`TokenLengths` for all models, or a per-model
    dict) stamps each request with seeded prompt/output token counts for
    the token-level executor; length draws use a separate per-model stream
    (``model_rng(seed, model + "/tokens")``), so the same arrivals are
    produced with or without lengths.
    """
    merged: list[tuple[float, str, int]] = []
    for model in sorted(traffic):
        proc = _coerce(model, traffic[model])
        rng = model_rng(seed, model)
        hint = max(1, int(getattr(proc, "batch_hint", 1)))
        merged.extend((t, model, hint)
                      for t in proc.arrival_times(rng, horizon_s))
    merged.sort(key=lambda e: (e[0], e[1]))
    toks: dict[str, tuple] = {}
    if lengths is not None:
        counts: dict[str, int] = {}
        for _, m, _ in merged:
            counts[m] = counts.get(m, 0) + 1
        for model, n in sorted(counts.items()):
            dist = lengths.get(model) if isinstance(lengths, dict) else lengths
            if dist is None:
                continue
            prompts, outs = dist.sample(
                model_rng(seed, model + "/tokens"), n)
            toks[model] = (iter(prompts), iter(outs))
    out = []
    for i, (t, m, s) in enumerate(merged):
        p = o = 0
        if m in toks:
            p, o = int(next(toks[m][0])), int(next(toks[m][1]))
        out.append(Request(t_arrive=t0 + t, model=m, samples=s, seq=seq0 + i,
                           prompt_tokens=p, output_tokens=o))
    return out


def phased_trace(
    phases: Sequence[tuple[dict[str, object], float]],
    seed: int = 0,
) -> list[Request]:
    """Concatenate traffic phases: ``[(traffic_dict, duration_s), ...]``.

    Each phase is generated independently (sub-seeded by its index) and
    shifted onto the global timeline -- the autoscale drift scenario flips
    the mix between phases.
    """
    out: list[Request] = []
    t0 = 0.0
    for i, (traffic, dur) in enumerate(phases):
        reqs = request_trace(traffic, dur, seed=seed * 1_000_003 + i,
                             t0=t0, seq0=len(out))
        out.extend(reqs)
        t0 += dur
    return out


def offered_load(trace: Sequence[Request]) -> dict[str, int]:
    """Samples offered per model (the conservation test's left-hand side)."""
    out: dict[str, int] = {}
    for r in trace:
        out[r.model] = out.get(r.model, 0) + r.samples
    return out
