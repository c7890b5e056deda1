"""Discrete-event serving executor: run a solved co-schedule under load.

A copy of the JAX package's ``serving/executor.py``, which is JAX-free except
``measure_service_models``: here it times the torch prefill steps on one
device, one model there at a time.

The DSE answers *what to deploy*; this engine answers *what that
deployment does to requests*: it admits a seeded open-loop trace
(:mod:`.traffic`), batches per-model FIFO queues (max batch size + max
queue delay), and executes batches on servers whose capacity is exactly
what the solved :class:`~repro_torch.core.graph.MultiModelSchedule` granted:

* **partitioned** quotas run concurrently, each on its own chip sub-mesh
  carved from the package's flavor zones
  (:func:`repro_torch.core.regions.flavor_zones`) -- spanning quotas
  (``chip_quota``) get the seam-adjacent slice of each flavor zone, and
  every assignment's stage flavor runs are re-checked against mesh
  coordinates (:func:`repro_torch.core.regions.zigzag_placement`);
* **time-mux** assignments serialize on the whole package inside periodic
  slice windows, with the time-mux switch cost as dead reload time at each
  slice start (``meta["reload_s"]`` / ``gross_shares``);
* **merged** pipelines interleave at their solved per-model weighted rates
  (``samples_per_beat``).

Service times come from the solved schedule's cost model: a schedule with
``S`` pipeline stages and latency ``L`` for the DSE batch ``m`` is a serial
batch server with beat ``L / (S - 1 + m)`` and service
``(S - 1 + b / samples_per_beat) * beat`` for a ``b``-sample batch -- so a
saturated server reproduces the DSE's throughput figure exactly (batches of
``m`` samples complete every ``L`` seconds).  An optional measured path
(:func:`measure_service_models`) calibrates the service law by timing the
real torch prefill steps from ``build_multimodel_steps`` instead.

The engine is wall-clock-free and fully deterministic under the trace seed.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, field

from ..core.graph import (
    MM_MERGED,
    MM_PARTITIONED,
    MM_TIME_MUX,
    ModelAssignment,
    MultiModelSchedule,
)
from ..core.hw import HardwareModel
from ..core.regions import check_assignments_placement, flavor_zones
from ..multimodel.quota import package_flavors
from .faults import FaultEvent, FaultInjector
from .metrics import WATERFALL_COMPONENTS, ServingReport, conserve_waterfall, summarize
from .traffic import Request

INF = float("inf")
_EPS = 1e-12

__all__ = [
    "BatchingPolicy",
    "ServiceModel",
    "ServingExecutor",
    "allocate_submeshes",
    "measure_service_models",
    "service_from_assignment",
    "simulate",
]


@dataclass(frozen=True)
class BatchingPolicy:
    """Queue -> batch policy: dispatch when ``max_batch`` samples are
    waiting or the oldest request has queued for ``max_delay_s``.

    ``max_batch`` is in *beats*: a merged-mode model whose
    ``samples_per_beat`` is k dispatches up to ``max_batch * k`` samples
    per batch (k = 1 everywhere else), so a saturated server of any mode
    reproduces its DSE throughput when ``max_batch`` equals the DSE batch.

    ``queue_policy`` selects the dequeue order: ``"fifo"`` (arrival order,
    the whole-request executor's only order) or ``"edf"`` -- earliest SLO
    deadline first, honored by the token-level executor
    (:class:`repro_torch.serving.llm.TokenExecutor`), where a colocated server
    also uses the deadlines to arbitrate prefill batches against decode
    steps.
    """
    max_batch: int = 16
    max_delay_s: float = 2e-3
    max_queue_samples: int | None = None    # admission cap (None = unbounded)
    queue_policy: str = "fifo"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} < 1")
        if self.max_delay_s < 0:
            raise ValueError(f"max_delay_s {self.max_delay_s} < 0")
        if self.queue_policy not in ("fifo", "edf"):
            raise ValueError(f"unknown queue_policy {self.queue_policy!r}")


@dataclass(frozen=True)
class ServiceModel:
    """Batch service law ``overhead + (stages - 1 + b / spb) * beat``."""
    beat: float
    stages: int = 1
    samples_per_beat: float = 1.0
    overhead_s: float = 0.0

    def service_s(self, samples: int) -> float:
        return self.overhead_s + (
            self.stages - 1 + samples / self.samples_per_beat
        ) * self.beat


def service_from_assignment(a: ModelAssignment) -> ServiceModel:
    """Service law of one assignment, from its solved schedule.

    ``beat = latency / (S - 1 + m)`` inverts the pipeline fill model the
    cost evaluator uses, so a server saturated with ``m``-sample batches
    serves exactly the schedule's ``m / latency`` samples/s (times the
    merged-mode ``samples_per_beat`` weighting).
    """
    sched = a.schedule
    if sched.latency <= 0 or sched.latency == INF:
        raise ValueError(f"{a.model}: infeasible schedule cannot serve")
    m = sched.meta.get("m_samples", 1)
    stages = sum(len(seg.clusters) for seg in sched.segments) or 1
    beat = sched.latency / (stages - 1 + m)
    return ServiceModel(beat=beat, stages=stages,
                        samples_per_beat=a.samples_per_beat)


@dataclass
class _Server:
    """One model's execution resource: a serial batch server, optionally
    gated by periodic time-mux availability windows."""
    model: str
    chips: int
    service: ServiceModel
    window: tuple[float, float, float] | None = None   # (offset, span, period)
    free_at: float = 0.0
    down: bool = False          # submesh hit by a failure; dispatch skips it

    def advance(self, t: float, work: float) -> float:
        """Absolute completion time of ``work`` busy-seconds started at
        ``t``, walking this server's availability windows."""
        if self.window is None:
            return t + work
        off, span, period = self.window
        if span <= _EPS:
            raise ValueError(f"{self.model}: zero-width time-mux slice")
        # Walk period indices monotonically (a float-exact boundary time
        # must not re-derive the same index and spin).
        k = math.floor((t - off) / period) - 1
        while True:
            w_start = off + k * period
            w_end = w_start + span
            if w_end - _EPS <= t:
                k += 1
                continue
            cur = max(t, w_start)
            avail = w_end - cur
            if work <= avail + _EPS:
                return cur + min(work, avail)
            work -= avail
            k += 1

    def window_time(self, a: float, b: float) -> float:
        """Seconds of ``[a, b]`` inside availability windows (== ``b - a``
        for always-on servers); the slice-enforcement invariant's oracle."""
        if self.window is None:
            return max(0.0, b - a)
        off, span, period = self.window
        total = 0.0
        k = math.floor((a - off) / period) - 1
        while True:
            w_start = off + k * period
            if w_start >= b:
                return total
            total += max(0.0, min(b, w_start + span) - max(a, w_start))
            k += 1


# ---------------------------------------------------------------------------
# Sub-mesh allocation (quota enforcement on mesh coordinates)
# ---------------------------------------------------------------------------

def allocate_submeshes(
    mm: MultiModelSchedule, hw: HardwareModel
) -> dict[str, dict[str | None, list[tuple[int, int]]]]:
    """Carve each partitioned assignment's chip sub-mesh out of the
    package's flavor zones; returns ``{model: {flavor: coords}}``.

    Single-flavor quotas fill their zone front to back; spanning quotas
    (``chip_quota``) take the seam-adjacent end of the earlier zone and the
    seam-adjacent front of the later one, so a pipeline that crosses the
    flavor seam physically straddles it exactly once.  Overcommitted zones
    raise -- this is the executor's quota-enforcement check.  Time-mux and
    merged deployments share the whole package (every model sees all
    zones).
    """
    counts = package_flavors(hw)
    zones = flavor_zones(counts, hw.mesh_shape, dead=hw.dead_chips)
    if mm.mode != MM_PARTITIONED:
        return {a.model: {f: list(z) for f, z in zones.items()}
                for a in mm.assignments}
    front = {f: 0 for f, _ in counts}
    back = {f: len(zones[f]) for f, _ in counts}
    out: dict[str, dict[str | None, list[tuple[int, int]]]] = {}
    shared: dict[tuple, dict[str | None, list[tuple[int, int]]]] = {}
    for a in mm.assignments:
        # Merged sub-group members share one schedule *and* one resource
        # claim; both must match before they share the carved region.
        share_key = (id(a.schedule), a.chip_type, a.chips,
                     tuple(a.chip_quota or ()))
        prior = shared.get(share_key)
        if prior is not None:
            out[a.model] = prior
            continue
        needs = list(a.chip_quota) if a.chip_quota else [(a.chip_type, a.chips)]
        live = [n for n in needs if n[1] > 0]
        spanning = len(live) > 1
        got: dict[str | None, list[tuple[int, int]]] = {}
        for idx, (f, c) in enumerate(live):
            if f not in zones:
                raise ValueError(f"{a.model}: unknown chip flavor {f!r}")
            zone = zones[f]
            if front[f] + c > back[f]:
                raise ValueError(
                    f"{a.model}: quota overcommits flavor {f!r} "
                    f"({c} chips requested, "
                    f"{back[f] - front[f]} free of {len(zone)})"
                )
            if spanning and idx == 0:
                got[f] = zone[back[f] - c:back[f]]      # seam side (zone end)
                back[f] -= c
            else:
                got[f] = zone[front[f]:front[f] + c]    # zone front
                front[f] += c
        out[a.model] = got
        shared[share_key] = got
    return out


def check_stage_contiguity(mm: MultiModelSchedule, hw: HardwareModel) -> None:
    """Re-check every assignment's per-segment stage flavors against mesh
    coordinates: flavor runs must place contiguously inside their zones
    (raises via :func:`check_assignments_placement` otherwise)."""
    check_assignments_placement(mm.assignments, hw.mesh_shape,
                                package_flavors(hw), dead=hw.dead_chips)


# ---------------------------------------------------------------------------
# Server construction
# ---------------------------------------------------------------------------

def build_servers(
    mm: MultiModelSchedule,
    hw: HardwareModel,
    origin: float = 0.0,
    switch_period_s: float | None = None,
    service_override: dict[str, ServiceModel] | None = None,
) -> dict[str, _Server]:
    """One server per assignment.  Time-mux deployments get periodic
    windows laid out back to back over the scheduling period, each slice's
    useful span starting after its reload time (the time-mux switch cost)."""
    servers: dict[str, _Server] = {}
    n = len(mm.assignments)
    if mm.mode == MM_TIME_MUX:
        period = switch_period_s or mm.meta.get("switch_period_s", 1.0)
        reloads = mm.meta.get("reload_s", [0.0] * n)
        gross = mm.meta.get("gross_shares") or [
            a.time_share for a in mm.assignments
        ]
        off = 0.0
        for a, g, r in zip(mm.assignments, gross, reloads):
            service = (service_override or {}).get(a.model) \
                or service_from_assignment(a)
            span = a.time_share * period
            servers[a.model] = _Server(
                model=a.model, chips=a.chips, service=service,
                window=(origin + off + r, span, period), free_at=origin,
            )
            off += g * period
        if off > period * (1 + 1e-9):
            raise ValueError(
                f"time-mux slices overflow the period: {off} > {period}"
            )
    else:
        for a in mm.assignments:
            service = (service_override or {}).get(a.model) \
                or service_from_assignment(a)
            servers[a.model] = _Server(model=a.model, chips=a.chips,
                                       service=service, free_at=origin)
    return servers


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

_ARRIVE, _TIMER, _DONE, _CHECK, _FAULT = 0, 1, 2, 3, 4


class ServingExecutor:
    """Event-driven simulation of one deployment under one request trace.

    ``autoscaler`` (optional, see :mod:`.autoscale`) is polled on periodic
    check events; when it returns a re-solved schedule the executor swaps
    the server fleet, charging ``redeploy_s`` (weight reload through DRAM)
    as dead time before the new servers accept work -- in-flight batches
    finish on the old fleet.

    ``faults`` (a :class:`~.faults.FaultInjector` or a list of
    :class:`~.faults.FaultEvent`) injects chip/zone/seam failures: a
    failure marks every server whose submesh intersects the dead chips
    down, spills its in-flight batch back to the queue front, and -- when
    ``fault_resolver`` is set -- triggers a degraded re-solve:
    ``fault_resolver(degraded_hw) -> (MultiModelSchedule | None, info)``
    plans a fresh deployment on the surviving chips (the facade wires it
    through a shared :class:`~repro_torch.api.SolutionCache`, so the dead-chip
    set lands in the problem fingerprint), and the executor swaps fleets
    charging redeploy dead time exactly like an autoscale event.  Repairs
    re-solve back up.  Without a resolver the run degrades statically:
    down models queue until their own chips are repaired.
    """

    def __init__(
        self,
        mm: MultiModelSchedule,
        hw: HardwareModel,
        batching: BatchingPolicy | None = None,
        slos: dict[str, float | None] | None = None,
        autoscaler=None,
        service_override: dict[str, ServiceModel] | None = None,
        switch_period_s: float | None = None,
        reload_s: dict[str, float] | None = None,
        seed: int = 0,
        faults: FaultInjector | list | None = None,
        fault_resolver=None,
        tracer=None,
    ):
        self.mm = mm
        self.hw = hw                     # pristine package (fault baseline)
        # observability: a repro_torch.obs.Tracer fed *simulated* times only --
        # every guard below is `is not None`, so the hot loop pays one
        # comparison when tracing is off (NullTracer normalizes to None)
        self.tracer = tracer if tracer else None
        self._inflight_t0: dict[str, tuple[float, int]] = {}
        self.batching = batching or BatchingPolicy()
        self.slos = slos or {}
        self.autoscaler = autoscaler
        self.service_override = service_override
        self.switch_period_s = switch_period_s
        self.reload_s = reload_s or {}
        self.seed = seed
        self.faults = faults
        self.fault_resolver = fault_resolver
        check_stage_contiguity(mm, hw)
        self.placement = allocate_submeshes(mm, hw)
        self.servers = build_servers(mm, hw, 0.0, switch_period_s,
                                     service_override)
        # per-model accounting (survives autoscale fleet swaps)
        models = list(self.servers)
        self.queues: dict[str, deque[Request]] = {m: deque() for m in models}
        self.queued_samples = {m: 0 for m in models}
        self.arrived = {m: [0, 0] for m in models}
        # drops are attributed to a named cause (strict conservation)
        self.dropped: dict[str, dict[str, list[int]]] = {
            m: {} for m in models
        }
        self.latencies: dict[str, list[float]] = {m: [] for m in models}
        self.req_samples: dict[str, list[int]] = {m: [] for m in models}
        self.batches = {m: 0 for m in models}
        self.busy_s = {m: 0.0 for m in models}
        self.queue_traces: dict[str, list[tuple[float, int]]] = {
            m: [] for m in models
        }
        # per-batch log: (t_start, t_done, work_s, samples, window) -- the
        # slice-enforcement invariant's evidence
        self.batch_log: dict[str, list[tuple]] = {m: [] for m in models}
        # per-request latency waterfalls (Scope Lens): every completed
        # request's latency decomposed into WATERFALL_COMPONENTS, conserved
        # bit-identically against the measured latency
        self.waterfalls: dict[str, list[dict]] = {m: [] for m in models}
        self._acct: dict[int, dict] = {}     # id(request) -> open accounting
        self.redeploys: list[dict] = []
        self._heap: list[tuple] = []
        self._seq = 0
        self._makespan = 0.0
        self._timer_at: dict[str, float] = {}   # pending batch-delay timer
        # fault machinery: the pristine mm/placement are kept so static
        # repairs can rebuild a revived model's original server
        self._mm0 = mm
        self._placement0 = {m: {f: list(z) for f, z in zones.items()}
                            for m, zones in self.placement.items()}
        self._dead: set[tuple[int, int]] = set()
        self._dead_seams: set[tuple[str, str]] = set()
        # epoch fences stale _DONE events of killed servers; _inflight
        # tracks the (single) in-flight batch per server for spilling
        self._epoch = {m: 0 for m in models}
        self._inflight: dict[str, list[Request] | None] = {
            m: None for m in models
        }
        self._down_since: dict[str, float] = {}
        self._downtime = {m: 0.0 for m in models}
        self._pending_recoveries: list[dict] = []
        self.fault_log: list[dict] = []
        self.recoveries: list[dict] = []
        # (t_done, model, samples, latency) for failure-window goodput
        self._completions: list[tuple[float, str, int, float]] = []

    # ------------------------------------------------------------- plumbing
    def _push(self, t: float, kind: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, kind, self._seq, payload))

    def _trace_queue(self, t: float, model: str) -> None:
        tr = self.queue_traces[model]
        depth = self.queued_samples[model]
        if tr and tr[-1][0] == t:
            tr[-1] = (t, depth)
        else:
            tr.append((t, depth))

    def _drop(self, model: str, cause: str, requests: int,
              samples: int) -> None:
        tally = self.dropped[model].setdefault(cause, [0, 0])
        tally[0] += requests
        tally[1] += samples

    # ------------------------------------------------------------- dispatch
    def _try_dispatch(self, model: str, t: float) -> None:
        q = self.queues[model]
        srv = self.servers[model]
        if srv.down or not q or srv.free_at > t + _EPS:
            return                      # retried when the server frees up
        total = self.queued_samples[model]
        age = t - q[0].t_arrive
        pol = self.batching
        max_batch = max(
            1, round(pol.max_batch * srv.service.samples_per_beat))
        if total < max_batch and age < pol.max_delay_s - _EPS:
            deadline = q[0].t_arrive + pol.max_delay_s
            # one pending timer per model is enough: later arrivals only
            # move the deadline later, and a fired timer re-evaluates
            if self._timer_at.get(model, INF) > deadline + _EPS:
                self._timer_at[model] = deadline
                self._push(deadline, _TIMER, model)
            return
        batch: list[Request] = []
        samples = 0
        while q and samples < max_batch:
            r = q[0]
            if batch and samples + r.samples > max_batch:
                break
            batch.append(q.popleft())
            samples += r.samples
        self.queued_samples[model] -= samples
        self._trace_queue(t, model)
        start = max(t, srv.free_at)
        work = srv.service.service_s(samples)
        # waterfall: older members waited for the newest one (queue_wait);
        # the whole batch then waited for the dispatcher/server (batch_delay)
        t_new = max(self._acct[id(r)]["entry"] for r in batch)
        for r in batch:
            a = self._acct[id(r)]
            a["queue_wait"] += t_new - a["entry"]
            a["batch_delay"] += start - t_new
            a["waits"].append((a["entry"], start))
            a["attempt_start"] = start
            a["work"] = work
        done = srv.advance(start, work)
        srv.free_at = done
        self.busy_s[model] += work
        self.batches[model] += 1
        self.batch_log[model].append((start, done, work, samples, srv.window))
        self._inflight[model] = batch
        if self.tracer is not None:
            self._inflight_t0[model] = (start, samples)
        self._push(done, _DONE, (model, batch, self._epoch[model]))

    # ------------------------------------------------------------ waterfall
    def _finish_waterfall(self, model: str, r, t_done: float,
                          lat: float) -> None:
        """Close a completed request's latency waterfall.

        Components telescope over the request's attempts -- queue_wait
        (waiting for batchmates), batch_delay (dispatcher/server wait),
        service (busy work), stall_time_mux (time-mux window dead time),
        dead_fault (aborted in-flight attempts) -- then queue time spent
        inside redeploy windows is re-attributed to its cause (fault vs
        autoscale re-solve), and the whole thing is conserved bit-exactly
        against the measured latency.
        """
        a = self._acct.pop(id(r), None)
        if a is None:
            return
        service = a.get("work", 0.0)
        stall = (t_done - a.get("attempt_start", t_done)) - service
        comps = {
            "queue_wait": a["queue_wait"],
            "batch_delay": a["batch_delay"],
            "service": service,
            "stall_time_mux": stall,
            "dead_fault": a["dead_fault"],
            "dead_autoscale": 0.0,
        }
        for ev in self.redeploys:
            dur = ev.get("redeploy_s", 0.0)
            t0 = ev.get("t")
            if t0 is None or dur <= 0:
                continue
            key = ("dead_fault" if ev.get("cause") == "fault"
                   else "dead_autoscale")
            for wlo, whi in a["waits"]:
                ov = min(whi, t0 + dur) - max(wlo, t0)
                if ov > 0:
                    comps[key] += ov
                    take = min(ov, comps["queue_wait"])
                    comps["queue_wait"] -= take
                    comps["batch_delay"] -= ov - take
        wf = conserve_waterfall(comps, lat)
        wf["total"] = lat
        self.waterfalls[model].append(wf)

    # ------------------------------------------------------- fleet swapping
    def _current_hw(self) -> HardwareModel:
        """The package as the faults have left it."""
        hw = self.hw
        if self._dead:
            hw = hw.disable_chips(self._dead)
        for a, b in self._dead_seams:
            hw = hw.disable_seam(a, b)
        return hw

    @property
    def degraded(self) -> bool:
        return bool(self._dead or self._dead_seams)

    def _swap_fleet(self, t: float, new_mm: MultiModelSchedule,
                    hw_now: HardwareModel) -> float:
        """Replace the fleet with ``new_mm`` solved on ``hw_now``; charge
        redeploy dead time; returns the new fleet's origin.  Down servers
        come back up (the re-solve placed them on surviving chips);
        surviving in-flight batches drain on their old submeshes first."""
        check_stage_contiguity(new_mm, hw_now)
        redeploy = sum(
            self.reload_s.get(a.model, 0.0) for a in new_mm.assignments
        )
        old = self.servers
        origin = t + redeploy
        self.servers = build_servers(new_mm, hw_now, origin,
                                     self.switch_period_s,
                                     self.service_override)
        if set(self.servers) != set(old):
            raise ValueError(
                f"re-solve changed the model set: {sorted(old)} -> "
                f"{sorted(self.servers)} (re-solves may only move chips)"
            )
        for m, srv in self.servers.items():
            # let in-flight batches drain on the old fleet first (a down
            # server has none: its batch was spilled back to the queue)
            if not old[m].down:
                srv.free_at = max(srv.free_at, old[m].free_at)
        self.mm = new_mm
        self.placement = allocate_submeshes(new_mm, hw_now)
        for m in self.servers:
            self._close_downtime(m, origin)
        for m, srv in self.servers.items():
            # wake every queue when its new server starts accepting work --
            # without this, a model with no in-flight batch and no further
            # arrivals would strand its queued requests forever
            self._push(max(t, srv.free_at), _TIMER, m)
            self._try_dispatch(m, t)
        return origin

    # ------------------------------------------------------------ autoscale
    def _apply_autoscale(self, t: float) -> None:
        hw_now = self._current_hw() if self.degraded else self.hw
        out = self.autoscaler.maybe_resolve(
            t, hw=hw_now if self.degraded else None)
        if self.tracer is not None:
            self.tracer.counter("autoscale_drift", t,
                                round(self.autoscaler.last_drift, 6),
                                group="serving")
        if out is None:
            return
        new_mm, event = out
        if self.tracer is not None:
            self.tracer.instant(
                "autoscale:re-solve", t, group="serving", lane="fleet",
                drift=round(event.get("drift", 0.0), 6),
                cache_hit=event.get("cache_hit"))
        origin = self._swap_fleet(t, new_mm, hw_now)
        event = dict(event, redeploy_s=origin - t)
        self.redeploys.append(event)
        self._settle_recoveries(origin, resolved=True, info=event)

    # --------------------------------------------------------------- faults
    def _close_downtime(self, model: str, t: float) -> None:
        t0 = self._down_since.pop(model, None)
        if t0 is not None:
            self._downtime[model] += max(0.0, t - t0)
        srv = self.servers.get(model)
        if srv is not None:
            srv.down = False

    def _settle_recoveries(self, t: float, resolved: bool,
                           info: dict | None = None) -> None:
        """Close every pending recovery once no server is down."""
        if not self._pending_recoveries:
            return
        if any(s.down for s in self.servers.values()):
            return
        for p in self._pending_recoveries:
            rec = {
                **p,
                "t_recovered": t,
                "ttr_s": t - p["t_fail"],
                "resolved": resolved,
            }
            for k in ("cache_hit", "dse_s", "redeploy_s"):
                if info and k in info:
                    rec[k] = info[k]
            self.recoveries.append(rec)
            if self.tracer is not None:
                self.tracer.instant(
                    "recovered", t, group="serving", lane="faults",
                    target=p.get("target"), ttr_s=round(rec["ttr_s"], 9),
                    resolved=resolved)
        self._pending_recoveries.clear()

    def _seam_blocked(self, zones: dict) -> bool:
        """Does this placement straddle a failed seam?"""
        used = {f for f, coords in zones.items() if coords}
        return any(a in used and b in used for a, b in self._dead_seams)

    def _killed_by(self, model: str) -> bool:
        zones = self.placement[model]
        if any(c in self._dead
               for coords in zones.values() for c in coords):
            return True
        return self._seam_blocked(zones)

    def _spill(self, model: str, t: float) -> int:
        """Kill ``model``'s server: spill the in-flight batch back to the
        queue front (epoch-fencing its pending completion) and mark the
        server down.  Returns the spilled sample count."""
        srv = self.servers[model]
        spilled = 0
        batch = self._inflight[model]
        if batch is not None:
            self._epoch[model] += 1        # fences the stale _DONE
            for r in reversed(batch):
                self.queues[model].appendleft(r)
                # the aborted attempt's in-flight time is fault dead time;
                # the request re-enters the queue at the kill
                a = self._acct[id(r)]
                a["dead_fault"] += t - a["attempt_start"]
                a["entry"] = t
            spilled = sum(r.samples for r in batch)
            self.queued_samples[model] += spilled
            self._inflight[model] = None
            self._trace_queue(t, model)
            if self.tracer is not None:
                # the batch span is truncated at the kill: its server is
                # gone, and the re-dispatched retry opens a fresh span
                b0 = self._inflight_t0.pop(model, None)
                if b0 is not None:
                    self.tracer.complete(
                        "batch (spilled)", b0[0], t, group="serving",
                        lane=model, samples=b0[1], spilled=True)
        if self.tracer is not None:
            self.tracer.instant("kill", t, group="serving", lane=model,
                                spilled_samples=spilled)
        srv.down = True
        srv.free_at = max(srv.free_at, t)
        self._down_since.setdefault(model, t)
        return spilled

    def _revive_static(self, t: float) -> list[str]:
        """Static-degraded repair path: rebuild the original server of
        every down model whose pristine submesh is fully alive again."""
        revived = []
        fresh = None
        for m, srv in list(self.servers.items()):
            if not srv.down or self._killed_by(m):
                continue
            if fresh is None:
                fresh = build_servers(self._mm0, self.hw, 0.0,
                                      self.switch_period_s,
                                      self.service_override)
            nsrv = fresh[m]
            nsrv.free_at = t
            self.servers[m] = nsrv
            self._close_downtime(m, t)
            revived.append(m)
            self._push(t, _TIMER, m)
        return revived

    def _apply_fault(self, t: float, ev: FaultEvent) -> None:
        entry = ev.to_json()
        entry["applied_at"] = t
        if ev.kind == "fail":
            self._dead.update(ev.chips)
            if ev.seam:
                self._dead_seams.add(tuple(sorted(ev.seam)))
            killed, spilled = [], 0
            for m, srv in self.servers.items():
                if not srv.down and self._killed_by(m):
                    spilled += self._spill(m, t)
                    killed.append(m)
            entry.update(killed=killed, spilled_samples=spilled,
                         dead_chips=len(self._dead))
            if self.tracer is not None:
                self.tracer.instant(
                    "fault:fail", t, group="serving", lane="faults",
                    target=ev.target, killed=list(killed),
                    dead_chips=len(self._dead))
            if killed:
                self._pending_recoveries.append(
                    {"t_fail": t, "target": ev.target})
            if killed and self.fault_resolver is not None:
                entry["resolve"] = self._fault_redeploy(t)
        elif ev.kind == "repair":
            changed = (self._dead & set(ev.chips)) or (
                ev.seam and tuple(sorted(ev.seam)) in self._dead_seams)
            if not changed:
                return              # repair of something that never failed
            self._dead.difference_update(ev.chips)
            if ev.seam:
                self._dead_seams.discard(tuple(sorted(ev.seam)))
            if self.tracer is not None:
                self.tracer.instant(
                    "fault:repair", t, group="serving", lane="faults",
                    target=ev.target, dead_chips=len(self._dead))
            if self.fault_resolver is not None:
                # re-solve back up on the (partially) restored package --
                # a full repair re-solves the pristine fingerprint, a
                # SolutionCache hit
                entry["resolve"] = self._fault_redeploy(t)
            else:
                entry["revived"] = self._revive_static(t)
                self._settle_recoveries(t, resolved=False)
            entry.update(dead_chips=len(self._dead))
        self.fault_log.append(entry)

    def _fault_redeploy(self, t: float) -> dict:
        """Ask ``fault_resolver`` for a deployment on the current package;
        swap fleets on success.  An infeasible degraded package leaves the
        down servers down (their queues wait for a repair)."""
        hw_now = self._current_hw()
        new_mm, info = self.fault_resolver(hw_now)
        info = dict(info or {})
        if self.tracer is not None:
            # args stay sim-deterministic: no wall-clock dse_s here
            self.tracer.instant(
                "fault:re-solve", t, group="serving", lane="fleet",
                applied=new_mm is not None and bool(new_mm.assignments),
                cache_hit=info.get("cache_hit"))
        if new_mm is None or not new_mm.assignments:
            info["applied"] = False
            return info
        origin = self._swap_fleet(t, new_mm, hw_now)
        info.update(applied=True, redeploy_s=origin - t,
                    t_serving_again=origin)
        self.redeploys.append(dict(info, t=t, cause="fault"))
        self._settle_recoveries(origin, resolved=True, info=info)
        return info

    # ------------------------------------------------------------------ run
    def run(self, trace: list[Request], horizon_s: float | None = None
            ) -> ServingReport:
        if horizon_s is None:
            horizon_s = trace[-1].t_arrive if trace else 0.0
        for r in trace:
            if r.model not in self.servers:
                raise ValueError(
                    f"request for {r.model!r}: deployment serves "
                    f"{sorted(self.servers)}"
                )
            self._push(r.t_arrive, _ARRIVE, r)
        if self.autoscaler is not None and trace:
            step = self.autoscaler.policy.check_every_s
            t = step
            while t <= horizon_s + _EPS:
                self._push(t, _CHECK, None)
                t += step
        if self.faults is not None:
            events = (self.faults.schedule(horizon_s)
                      if isinstance(self.faults, FaultInjector)
                      else list(self.faults))
            for ev in events:
                self._push(ev.t, _FAULT, ev)
        pol = self.batching
        while self._heap:
            t, kind, _, payload = heapq.heappop(self._heap)
            self._makespan = max(self._makespan, t)
            if kind == _ARRIVE:
                r: Request = payload
                self.arrived[r.model][0] += 1
                self.arrived[r.model][1] += r.samples
                cap = pol.max_queue_samples
                if cap is not None and \
                        self.queued_samples[r.model] + r.samples > cap:
                    self._drop(r.model, "queue_full", 1, r.samples)
                    continue
                if self.autoscaler is not None:
                    self.autoscaler.observe(t, r.model, r.samples)
                self.queues[r.model].append(r)
                self.queued_samples[r.model] += r.samples
                self._acct[id(r)] = {"entry": t, "queue_wait": 0.0,
                                     "batch_delay": 0.0, "dead_fault": 0.0,
                                     "waits": []}
                self._trace_queue(t, r.model)
                self._try_dispatch(r.model, t)
            elif kind == _TIMER:
                if self._timer_at.get(payload, -INF) <= t + _EPS:
                    self._timer_at.pop(payload, None)
                self._try_dispatch(payload, t)
            elif kind == _DONE:
                model, batch, epoch = payload
                if epoch != self._epoch[model]:
                    continue        # batch died with its server (spilled)
                if self._inflight[model] is batch:
                    self._inflight[model] = None
                    if self.tracer is not None:
                        b0 = self._inflight_t0.pop(model, None)
                        if b0 is not None:
                            self.tracer.complete(
                                "batch", b0[0], t, group="serving",
                                lane=model, samples=b0[1])
                for r in batch:
                    lat = t - r.t_arrive
                    self.latencies[model].append(lat)
                    self.req_samples[model].append(r.samples)
                    self._completions.append((t, model, r.samples, lat))
                    self._finish_waterfall(model, r, t, lat)
                self._try_dispatch(model, t)
            elif kind == _CHECK:
                self._apply_autoscale(t)
            elif kind == _FAULT:
                self._apply_fault(t, payload)
        return self._report(horizon_s)

    # --------------------------------------------------------------- report
    def _gated_samples(self, lo: float, hi: float,
                       by_arrival: bool = False) -> int:
        """SLO-satisfying samples completed (or, ``by_arrival``, arrived)
        in ``[lo, hi)``."""
        total = 0
        for t_done, m, s, lat in self._completions:
            t = t_done - lat if by_arrival else t_done
            if lo <= t < hi:
                slo = self.slos.get(m)
                if slo is None or lat <= slo:
                    total += s
        return total

    def _fault_summary(self, makespan: float,
                       horizon_s: float) -> dict | None:
        if self.faults is None and not self.fault_log:
            return None
        span = max(makespan, _EPS)
        downtime = dict(self._downtime)
        for m, t0 in self._down_since.items():
            downtime[m] = downtime.get(m, 0.0) + max(0.0, makespan - t0)
        n_models = max(1, len(self.servers))
        availability = 1.0 - min(
            1.0, sum(downtime.values()) / (n_models * span))
        # failure windows: fault through recovery (or end of run)
        windows = [(r["t_fail"], min(r["t_recovered"], makespan))
                   for r in self.recoveries]
        windows += [(p["t_fail"], makespan)
                    for p in self._pending_recoveries]
        windows.sort()
        merged: list[tuple[float, float]] = []
        for lo, hi in windows:
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        w_span = sum(hi - lo for lo, hi in merged)
        in_w = sum(self._gated_samples(lo, hi) for lo, hi in merged)
        total_good = self._gated_samples(0.0, INF)
        out = {
            "events": len(self.fault_log),
            "log": self.fault_log,
            "recoveries": self.recoveries,
            "unrecovered": len(self._pending_recoveries),
            "availability": availability,
            "downtime_s": {m: round(d, 6) for m, d in downtime.items()},
            "mean_ttr_s": (
                sum(r["ttr_s"] for r in self.recoveries)
                / len(self.recoveries) if self.recoveries else None
            ),
            "failure_window_s": w_span,
            "goodput_in_failure": (in_w / w_span) if w_span > _EPS else None,
            "goodput_outside_failure": (
                (total_good - in_w) / (span - w_span)
                if span - w_span > _EPS else None
            ),
            "redeploy_dead_s": sum(
                e.get("redeploy_s", 0.0) for e in self.redeploys
                if e.get("cause") == "fault"
            ),
        }
        # pre-failure vs post-recovery goodput (the recovery-quality gauge:
        # a recovered fleet should serve within a few percent of the
        # pre-failure rate).  "Post-recovery" starts after the LAST fault
        # activity settles -- the last recovery window, repair event, or
        # fault-driven redeploy -- so a fleet that re-solved onto a
        # degraded package isn't judged at degraded capacity.  Both gauges
        # are by ARRIVAL time: requests arriving after recovery see the
        # recovered fleet's true service, while the failure-window backlog
        # draining late (and SLO-gated out) stays charged to the failure
        # windows, not to the recovered fleet.
        if merged:
            t_first = merged[0][0]
            t_settle = max(
                [merged[-1][1]]
                + [e["applied_at"] for e in self.fault_log
                   if e["kind"] == "repair"]
                + [e.get("t_serving_again",
                         e["t"] + e.get("redeploy_s", 0.0))
                   for e in self.redeploys if e.get("cause") == "fault"]
            )
            out["goodput_pre_fault"] = (
                self._gated_samples(0.0, t_first, by_arrival=True) / t_first
                if t_first > _EPS else None
            )
            # clamped to the arrival horizon: nothing arrives past it
            t_lo, t_hi = t_settle, min(span, horizon_s)
            out["goodput_post_recovery"] = (
                self._gated_samples(t_lo, t_hi, by_arrival=True)
                / (t_hi - t_lo)
                if t_hi - t_lo > _EPS and not self._pending_recoveries
                else None
            )
        else:
            out["goodput_pre_fault"] = None
            out["goodput_post_recovery"] = None
        return out

    def _emit_trace_tracks(self, makespan: float) -> None:
        """Bulk-emit the post-hoc trace tracks: per-model queue-depth
        counter series and redeploy spans on the fleet lane.  A redeploy
        superseded by a later swap is truncated at the swap (the old fleet
        never came up), keeping the lane's spans non-overlapping."""
        tr = self.tracer
        for m in sorted(self.queue_traces):
            for t, depth in self.queue_traces[m]:
                tr.counter(f"queue:{m}", t, depth, group="serving")
            series = tr.metrics.timeseries(f"queue_depth/{m}")
            series.extend(self.queue_traces[m])
        starts = sorted(
            (ev.get("t", 0.0), ev.get("redeploy_s", 0.0),
             ev.get("cause", "autoscale"))
            for ev in self.redeploys
        )
        for i, (t, dur, cause) in enumerate(starts):
            end = t + dur
            if i + 1 < len(starts):
                end = min(end, starts[i + 1][0])
            tr.complete("redeploy", t, max(t, end), group="serving",
                        lane="fleet", cause=cause,
                        redeploy_s=round(dur, 9))
        tr.metrics.counter("serving.batches").set(sum(self.batches.values()))
        tr.metrics.counter("serving.faults").set(len(self.fault_log))
        tr.metrics.counter("serving.recoveries").set(len(self.recoveries))
        tr.metrics.counter("serving.redeploys").set(len(self.redeploys))

    def _report(self, horizon_s: float) -> ServingReport:
        autoscale = None
        if self.autoscaler is not None:
            autoscale = {
                "events": self.redeploys,
                "checks": self.autoscaler.checks,
                "solve_cache": self.autoscaler.cache_stats(),
            }
        mode = self.mm.mode
        meta = {
            "batching": {
                "max_batch": self.batching.max_batch,
                "max_delay_s": self.batching.max_delay_s,
            },
        }
        if self.mm.mode == MM_TIME_MUX:
            meta["switch_period_s"] = (
                self.switch_period_s or self.mm.meta.get("switch_period_s", 1.0)
            )
        busy_chip_s = None
        if self.mm.mode == MM_MERGED:
            # every merged assignment is a slot share of ONE pipeline over
            # the same chips: the pipeline ticks whenever any model has a
            # batch in flight (idle models' slots go empty but the wave
            # still runs), so the package's busy time is the union of the
            # per-model in-flight intervals, not their sum
            pipeline_chips = max(s.chips for s in self.servers.values())
            intervals = sorted(
                (start, done)
                for log in self.batch_log.values()
                for (start, done, *_rest) in log
            )
            union = cur_lo = cur_hi = 0.0
            for lo, hi in intervals:
                if lo > cur_hi:
                    union += cur_hi - cur_lo
                    cur_lo, cur_hi = lo, hi
                else:
                    cur_hi = max(cur_hi, hi)
            union += cur_hi - cur_lo
            busy_chip_s = union * pipeline_chips
            meta["merged_graph"] = self.mm.meta.get("merged_graph")
        makespan = max(self._makespan, horizon_s)
        if self.tracer is not None:
            self._emit_trace_tracks(makespan)
        return summarize(
            mode=mode,
            package=self.hw.name,
            chips=self.hw.chips,
            seed=self.seed,
            horizon_s=horizon_s,
            makespan_s=makespan,
            arrived={m: tuple(v) for m, v in self.arrived.items()},
            dropped={
                m: {cause: tuple(v) for cause, v in causes.items()}
                for m, causes in self.dropped.items()
            },
            latencies=self.latencies,
            request_samples=self.req_samples,
            batches=self.batches,
            busy_s=self.busy_s,
            model_chips={m: s.chips for m, s in self.servers.items()},
            queue_traces=self.queue_traces,
            slos={m: self.slos.get(m) for m in self.servers},
            placement=self.placement,
            autoscale=autoscale,
            meta=meta,
            package_busy_chip_s=busy_chip_s,
            queued_end={
                m: (len(self.queues[m]), self.queued_samples[m])
                for m in self.servers
            },
            faults=self._fault_summary(makespan, horizon_s),
            waterfalls=self.waterfalls,
        )


def simulate(
    mm: MultiModelSchedule,
    hw: HardwareModel,
    trace: list[Request],
    batching: BatchingPolicy | None = None,
    horizon_s: float | None = None,
    **kw,
) -> ServingReport:
    """One-call wrapper: build a :class:`ServingExecutor` and run it."""
    return ServingExecutor(mm, hw, batching=batching, **kw).run(
        trace, horizon_s=horizon_s
    )


# ---------------------------------------------------------------------------
# Measured path: calibrate the service law from the real torch steps
# ---------------------------------------------------------------------------

def measure_service_models(
    deployment,
    seq_len: int = 16,
    batches: tuple[int, int] = (1, 4),
    iters: int = 3,
    device: str = "cuda",
    timings: dict | None = None,
) -> dict[str, ServiceModel]:
    """Time the real torch prefill steps from ``build_multimodel_steps`` on
    ``device`` (the card unless ``device="cpu"``) and fit
    ``service = overhead + b * beat`` per model.

    The two-point fit at batch sizes ``batches`` separates the fixed
    per-batch overhead from the per-sample slope; the returned models plug
    into ``ServingExecutor(service_override=...)`` so the simulation runs
    on measured instead of modeled service times.  The laws are keyed by
    ``cfg.name``; the executor looks one up by its assignment's model name,
    which ``Solution.serve`` maps them to (the lm-graph name).
    ``timings``, when given, receives each model's mean seconds per call at
    both batch sizes, keyed alike.

    One model is on the device at a time: each is built from a seeded
    generator, timed, and freed before the next.
    """
    import time

    import torch

    from ..device import resolve_device
    from ..models.model import init_params

    b_lo, b_hi = batches
    if not (0 < b_lo < b_hi):
        raise ValueError(f"need 0 < b_lo < b_hi, got {batches}")
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fleet = deployment.build_steps(with_decode=False, device=dev)
    out: dict[str, ServiceModel] = {}
    for cfg in deployment.cfgs:
        prefill = fleet[cfg.name]["prefill"]
        model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        timed = {}
        for b in (b_lo, b_hi):
            toks = torch.ones((b, seq_len), dtype=torch.int64, device=dev)
            prefill(model, toks)                                # warm-up
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                prefill(model, toks)
            sync()
            timed[b] = (time.perf_counter() - t0) / iters
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        beat = max(_EPS, (timed[b_hi] - timed[b_lo]) / (b_hi - b_lo))
        overhead = max(0.0, timed[b_lo] - beat * b_lo)
        out[cfg.name] = ServiceModel(beat=beat, stages=1, overhead_s=overhead)
        if timings is not None:
            timings[cfg.name] = timed
    return out
