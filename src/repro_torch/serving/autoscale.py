"""Online re-solve hook: watch the traffic mix, re-plan when it drifts.

A copy of the JAX package's ``serving/autoscale.py``, which is JAX-free.

The executor polls :meth:`Autoscaler.maybe_resolve` on a periodic check
cadence.  The autoscaler keeps a sliding window of admitted samples per
model; when the observed mix's L1 distance from the currently-deployed
weights exceeds ``drift_threshold`` (and the dwell / min-sample guards
pass), it quantizes the observed shares onto a coarse weight grid and asks
its ``resolve_fn`` for a fresh co-schedule at the new mix.

``resolve_fn`` is injected by :meth:`repro_torch.api.Solution.serve`: it rebuilds
the original :class:`~repro_torch.api.Problem` with the new weights and solves it
through a shared :class:`~repro_torch.api.SolutionCache` -- so every re-solve
reuses one ``FastCostModel`` memo, and a mix that flips back to a
previously-seen ratio is a whole-solution cache hit (hit rates land in the
serving report's ``autoscale.solve_cache``).  The executor charges each
applied re-solve as a switch-cost event: the new fleet accepts no work for
the deployment's weight-reload time.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..obs import current_tracer

__all__ = ["AutoscalePolicy", "Autoscaler", "normalize_mix", "quantize_mix"]


def normalize_mix(weights: dict[str, float]) -> dict[str, float]:
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"non-positive mix {weights}")
    return {m: w / total for m, w in weights.items()}


def quantize_mix(shares: dict[str, float], quantum: float) -> dict[str, float]:
    """Snap observed shares onto a ``quantum`` grid (floor at one quantum):
    nearby mixes collapse onto one fingerprint, so the solution cache hits
    when traffic returns to a familiar ratio."""
    return {
        m: max(quantum, round(s / quantum) * quantum)
        for m, s in shares.items()
    }


@dataclass(frozen=True)
class AutoscalePolicy:
    window_s: float = 2.0           # sliding observation window
    check_every_s: float = 0.5      # executor poll cadence
    drift_threshold: float = 0.5    # L1 distance between normalized mixes
    min_requests: int = 16          # don't re-plan on a near-empty window
    min_dwell_s: float = 1.0        # cool-down after a redeploy
    weight_quantum: float = 0.125   # re-solve weight grid

    def __post_init__(self):
        if not (0 < self.drift_threshold <= 2):
            raise ValueError(f"drift_threshold {self.drift_threshold}: the "
                             "L1 distance between mixes lies in (0, 2]")
        if self.check_every_s <= 0 or self.window_s <= 0:
            raise ValueError("window_s / check_every_s must be > 0")


class Autoscaler:
    """Sliding-window mix observer + re-solve trigger.

    ``resolve_fn(weights) -> (MultiModelSchedule | None, info_dict)`` does
    the actual planning; ``info`` should carry ``dse_s`` / ``cache_hit`` /
    ``solve_cache`` (the facade's :class:`~repro_torch.api.SolutionCache` stats).
    """

    def __init__(
        self,
        policy: AutoscalePolicy,
        resolve_fn: Callable[[dict[str, float]], tuple],
        weights0: dict[str, float],
    ):
        self.policy = policy
        self.resolve_fn = resolve_fn
        self.current = normalize_mix(weights0)
        self._window: deque[tuple[float, str, int]] = deque()
        self._last_change = -float("inf")
        self.checks = 0
        self.events: list[dict] = []
        # last drift the check loop computed (0 until the window fills);
        # the executor samples it into the trace's drift counter track
        self.last_drift = 0.0

    # ------------------------------------------------------------ observing
    def observe(self, t: float, model: str, samples: int) -> None:
        self._window.append((t, model, samples))
        self._prune(t)

    def _prune(self, t: float) -> None:
        cutoff = t - self.policy.window_s
        w = self._window
        while w and w[0][0] < cutoff:
            w.popleft()

    def observed_shares(self) -> tuple[dict[str, float], int]:
        counts: dict[str, int] = {}
        for _, m, s in self._window:
            counts[m] = counts.get(m, 0) + s
        total = sum(counts.values())
        if total == 0:
            return {}, 0
        return {m: c / total for m, c in counts.items()}, len(self._window)

    def _l1(self, shares: dict[str, float]) -> float:
        models = set(shares) | set(self.current)
        return sum(
            abs(shares.get(m, 0.0) - self.current.get(m, 0.0))
            for m in models
        )

    def drift(self) -> float:
        """L1 distance between the observed window mix and the deployed
        weights (0 = identical, 2 = disjoint)."""
        shares, n = self.observed_shares()
        return self._l1(shares) if n else 0.0

    # ------------------------------------------------------------ resolving
    def maybe_resolve(self, t: float, hw=None):
        """Executor hook: returns ``(new_mm, event_dict)`` or ``None``.

        ``hw`` (only passed while the executor is running degraded after a
        chip failure) is the surviving package; a resolve_fn that accepts
        it re-plans on the degraded hardware instead of the pristine one.
        """
        self.checks += 1
        self._prune(t)
        pol = self.policy
        if t - self._last_change < pol.min_dwell_s:
            return None
        shares, n_requests = self.observed_shares()
        if n_requests < pol.min_requests:
            return None
        l1 = self._l1(shares)
        self.last_drift = l1
        if l1 < pol.drift_threshold:
            return None
        # Only re-weight models the deployment already serves: a model with
        # zero window traffic keeps a floor quantum so its server survives.
        full = {m: shares.get(m, 0.0) for m in self.current}
        weights = quantize_mix(full, pol.weight_quantum)
        # hw is only forwarded when set, so 1-argument resolve_fns (every
        # pre-fault caller) keep working unchanged
        with current_tracer().span("autoscale:re-solve", drift=round(l1, 6),
                                   degraded=hw is not None):
            mm, info = (self.resolve_fn(weights) if hw is None
                        else self.resolve_fn(weights, hw=hw))
        if mm is None:
            return None
        event = {
            "t": t, "drift": l1,
            "observed": {m: round(s, 6) for m, s in shares.items()},
            "old_weights": dict(self.current),
            "new_weights": weights,
            **info,
        }
        self.events.append(event)
        self.current = normalize_mix(weights)
        self._last_change = t
        return mm, event

    def cache_stats(self) -> dict:
        """Last-known solver cache stats (for the serving report)."""
        if self.events:
            return self.events[-1].get("solve_cache", {})
        return {}
