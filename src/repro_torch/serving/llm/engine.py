"""Token-level serving executor: continuous batching over prefill/decode.

A copy of the JAX package's ``serving/llm/engine.py``, which is JAX-free.

Runs an :class:`~repro_torch.serving.llm.phases.LLMPlan` against a request trace
whose requests carry seeded prompt/output token lengths
(:class:`~repro_torch.serving.traffic.TokenLengths`).  Per model:

* a **prefill server** batches queued prompts (FIFO or EDF order) and runs
  one pipeline pass per batch -- the batch's first tokens are produced at
  batch completion (TTFT);
* a **decode server** holds a pool of active sequences and runs *steps*: a
  step over ``b`` active sequences emits one token each and takes
  ``(stages - 1 + b) * beat`` under the decode schedule's own service law,
  so a pool saturated at the DSE batch reproduces the solved decode
  throughput exactly.

**Continuous batching** admits prefilled sequences into the running pool at
step boundaries whenever KV capacity allows (counted by the
``llm.admitted_midbatch`` counter); **static batching** (``static=True``,
the whole-request baseline) admits only into an empty pool and reserves the
full batch width until every member finishes -- the classic drain waste
that continuous batching exists to remove.  Admission enforces the
searched KV bound in *bytes* (``sum of per-sequence state <= quota
capacity``), so the occupancy series can never exceed the bound the DSE
assumed.

Deployment modes follow the plan: **disaggregated** runs the two servers
concurrently with a per-request KV hand-off delay
(``kv_prompt_bytes / handoff_bw``) between prefill completion and decode
eligibility; **colocated** serializes both phases on one server --
arbitration between a ready prefill batch and pending decode steps is
prefill-first under ``queue_policy="fifo"`` and deadline-driven (TTFT
deadline vs next-token TPOT deadline) under ``"edf"``.  Batch-delay timers
are deduplicated per ``(model, phase)``, the whole-request executor's
one-timer-per-model rule extended to phases.

Wall-clock-free and deterministic under the trace seed, like the
whole-request executor.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field

from ...core.hw import HardwareModel
from ...multimodel.curves import service_law
from ...obs import current_tracer
from ..executor import BatchingPolicy
from ..metrics import conserve_waterfall
from ..traffic import Request
from .kv import kv_seq_bytes
from .metrics import LLM_WATERFALL_COMPONENTS, LLMReport, summarize_llm
from .phases import LLMPlan, PhaseAssignment

INF = float("inf")
_EPS = 1e-12

# event kinds (heap order at equal times: arrivals before timers before
# completions, completions before hand-off wakes)
_ARRIVE, _TIMER, _PDONE, _DDONE, _HAND = 0, 1, 2, 3, 4

__all__ = ["TokenExecutor", "simulate_tokens"]


@dataclass
class _Seq:
    """One sequence resident in (or bound for) a decode pool."""
    req: Request
    kv: float                  # resident state bytes at full context
    t_first: float             # first-token time (prefill completion)
    remaining: int             # decode tokens still to emit
    acct: dict = field(default_factory=dict)   # waterfall accumulators


@dataclass
class _MState:
    a: PhaseAssignment
    stages_p: int
    beat_p: float
    stages_d: int
    beat_d: float
    coloc: bool
    p_max: int                 # prefill batch cap
    d_max: int                 # decode pool cap (DSE batch ^ KV bound)
    queue: deque = field(default_factory=deque)
    waiting: deque = field(default_factory=deque)   # admission-eligible seqs
    pool: list = field(default_factory=list)
    pool_kv: float = 0.0
    busy_p: bool = False
    busy_d: bool = False
    static_slots: int = 0      # reserved batch width (static mode)
    inflight_hand: int = 0     # seqs between prefill and decode eligibility
    step_t0: float = 0.0       # start of the current decode busy run
    run_steps: int = 0         # steps in the current decode busy run
    t_last_step: float = 0.0
    prefill_batches: int = 0
    decode_steps: int = 0
    admitted_midbatch: int = 0
    busy_chip_s: float = 0.0
    kv_trace: list = field(default_factory=list)
    q_trace: list = field(default_factory=list)   # (t, queue depth)


class TokenExecutor:
    """Discrete-event token-level engine over a solved :class:`LLMPlan`."""

    def __init__(
        self,
        plan: LLMPlan,
        hw: HardwareModel,
        batching: BatchingPolicy | None = None,
        slos: dict[str, tuple[float | None, float | None]] | None = None,
        static: bool = False,
        seed: int = 0,
        tracer=None,
    ):
        self.plan = plan
        self.hw = hw
        self.batching = batching or BatchingPolicy()
        self.slos = slos or {}
        self.static = static
        self.seed = seed
        self.tracer = tracer if tracer else None
        self.states: dict[str, _MState] = {}
        for a in plan.assignments:
            sp, bp = service_law(a.prefill_schedule)
            if a.decode_schedule is not None:
                sd, bd = service_law(a.decode_schedule)
                m_d = a.decode_schedule.meta.get("m_samples", 1)
            else:
                sd, bd, m_d = 1, 0.0, 1
            self.states[a.model] = _MState(
                a=a, stages_p=sp, beat_p=bp, stages_d=sd, beat_d=bd,
                coloc=plan.mode == "colocated",
                p_max=max(1, self.batching.max_batch),
                d_max=max(1, min(m_d, a.max_seqs)),
            )
        self._heap: list = []
        self._seq = 0
        self._timer_at: dict[tuple[str, str], float] = {}
        self._arrived: dict[str, int] = {m: 0 for m in self.states}
        self._dropped: dict[str, dict[str, int]] = {m: {} for m in self.states}
        self._completions: dict[str, list] = {m: [] for m in self.states}
        self.waterfalls: dict[str, list[dict]] = {m: [] for m in self.states}
        self._makespan = 0.0

    # ----------------------------------------------------------- plumbing
    def _push(self, t: float, kind: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, kind, self._seq, payload))

    def _deadline(self, r: Request, ms: _MState) -> float:
        ttft_slo = self.slos.get(r.model, (None, None))[0]
        return r.t_arrive + (ttft_slo if ttft_slo is not None
                             else self.batching.max_delay_s)

    def _drop(self, r: Request, cause: str) -> None:
        by = self._dropped[r.model]
        by[cause] = by.get(cause, 0) + 1

    def _complete(self, r: Request, ttft: float, tpot: float | None,
                  t: float) -> None:
        self._completions[r.model].append(
            (ttft, tpot, r.prompt_tokens, r.output_tokens))
        self._makespan = max(self._makespan, t)

    def _finish_waterfall(self, r: Request, comps: dict, t_done: float) -> None:
        """Close a per-request waterfall, conserved against end-to-end latency."""
        total = t_done - r.t_arrive
        wf = conserve_waterfall(comps, total, order=LLM_WATERFALL_COMPONENTS)
        wf["total"] = total
        self.waterfalls[r.model].append(wf)

    def _note_queue(self, model: str, ms: _MState, t: float) -> None:
        depth = len(ms.queue)
        ms.q_trace.append((t, depth))
        if self.tracer is not None:
            self.tracer.counter(f"queue:{model}", t, depth, group="serving")

    def _note_kv(self, model: str, ms: _MState, t: float) -> None:
        ms.kv_trace.append((t, max(0.0, ms.pool_kv)))
        if self.tracer is not None:
            self.tracer.counter(f"kv_bytes/{model}", t,
                                max(0.0, ms.pool_kv), group="llm")

    # ------------------------------------------------------------ arrival
    def _arrive(self, r: Request, t: float) -> None:
        ms = self.states.get(r.model)
        if ms is None:
            raise KeyError(f"trace names unknown model {r.model!r}")
        self._arrived[r.model] += 1
        kv = kv_seq_bytes(ms.a.cfg, r.prompt_tokens + r.output_tokens)
        if (r.output_tokens > 1 and ms.a.kv_capacity_bytes
                and kv > ms.a.kv_capacity_bytes):
            self._drop(r, "kv_overflow")
            return
        cap = self.batching.max_queue_samples
        if cap is not None and len(ms.queue) >= cap:
            self._drop(r, "queue_full")
            return
        ms.queue.append(r)
        self._note_queue(r.model, ms, t)
        self._schedule(r.model, t)

    # --------------------------------------------------------- scheduling
    def _prefill_ready(self, ms: _MState, t: float) -> bool:
        if not ms.queue:
            return False
        if len(ms.queue) >= ms.p_max:
            return True
        oldest = min(r.t_arrive for r in ms.queue)
        return t >= oldest + self.batching.max_delay_s - _EPS

    def _set_timer(self, model: str, ms: _MState, t: float) -> None:
        if not ms.queue:
            return
        oldest = min(r.t_arrive for r in ms.queue)
        deadline = oldest + self.batching.max_delay_s
        key = (model, "prefill")
        if self._timer_at.get(key, INF) > deadline + _EPS:
            self._timer_at[key] = deadline
            self._push(deadline, _TIMER, key)

    def _decode_pending(self, ms: _MState) -> bool:
        if ms.pool:
            return True
        if not ms.waiting:
            return False
        if self.static:
            return not ms.pool          # admits only into an empty pool
        w = ms.waiting[0]
        return (len(ms.pool) < ms.d_max
                and ms.pool_kv + w.kv <= ms.a.kv_capacity_bytes + _EPS)

    def _schedule(self, model: str, t: float) -> None:
        ms = self.states[model]
        if ms.coloc:
            if ms.busy_p or ms.busy_d:
                return
            p_ready = self._prefill_ready(ms, t)
            d_ready = self._decode_pending(ms)
            if p_ready and d_ready and self.batching.queue_policy == "edf":
                # deadline arbitration: the queue head's TTFT deadline vs
                # the pool's next-token TPOT deadline
                p_dl = min(self._deadline(r, ms) for r in ms.queue)
                tpot_slo = self.slos.get(model, (None, None))[1]
                d_dl = (ms.t_last_step + tpot_slo
                        if (ms.pool and tpot_slo is not None) else INF)
                if d_dl < p_dl:
                    self._start_decode(model, ms, t)
                else:
                    self._start_prefill(model, ms, t)
            elif p_ready:
                self._start_prefill(model, ms, t)
            elif d_ready:
                self._start_decode(model, ms, t)
            else:
                self._set_timer(model, ms, t)
            return
        if not ms.busy_p:
            if self._prefill_ready(ms, t):
                self._start_prefill(model, ms, t)
            else:
                self._set_timer(model, ms, t)
        if not ms.busy_d and self._decode_pending(ms):
            self._start_decode(model, ms, t)

    # ------------------------------------------------------------ prefill
    def _start_prefill(self, model: str, ms: _MState, t: float) -> None:
        if self.batching.queue_policy == "edf":
            batch = sorted(ms.queue, key=lambda r: (self._deadline(r, ms),
                                                    r.seq))[:ms.p_max]
            picked = set(id(r) for r in batch)
            ms.queue = deque(r for r in ms.queue if id(r) not in picked)
        else:
            batch = [ms.queue.popleft() for _ in range(
                min(ms.p_max, len(ms.queue)))]
        self._note_queue(model, ms, t)
        eff = sum(max(1, r.prompt_tokens) for r in batch) / max(
            1, self.plan.seq_len)
        dur = (ms.stages_p - 1 + eff) * ms.beat_p
        ms.busy_p = True
        ms.busy_chip_s += dur * ms.a.prefill_chips
        self._push(t + dur, _PDONE, (model, batch, t))

    def _prefill_done(self, model: str, batch: list[Request], t0: float,
                      t: float) -> None:
        ms = self.states[model]
        ms.busy_p = False
        ms.prefill_batches += 1
        if self.tracer is not None:
            self.tracer.complete(f"prefill x{len(batch)}", t0, t,
                                 group="llm", lane=f"{model}/prefill",
                                 reqs=len(batch))
        for r in batch:
            ttft = t - r.t_arrive
            queue_wait = t0 - r.t_arrive
            prefill = t - t0
            if r.output_tokens <= 1:
                self._complete(r, ttft, None, t)
                self._finish_waterfall(
                    r, {"queue_wait": queue_wait, "prefill": prefill,
                        "kv_handoff": 0.0, "admission_wait": 0.0,
                        "decode": 0.0}, t)
                continue
            seq = _Seq(req=r,
                       kv=kv_seq_bytes(ms.a.cfg,
                                       r.prompt_tokens + r.output_tokens),
                       t_first=t, remaining=r.output_tokens - 1)
            seq.acct = {"queue_wait": queue_wait, "prefill": prefill,
                        "kv_handoff": 0.0, "ready": t}
            if ms.coloc or self.plan.handoff_bw <= 0:
                ms.waiting.append(seq)
            else:
                delay = kv_seq_bytes(ms.a.cfg, r.prompt_tokens) \
                    / self.plan.handoff_bw
                seq.acct["kv_handoff"] = delay
                seq.acct["ready"] = t + delay
                ms.inflight_hand += 1
                self._push(t + delay, _HAND, (model, seq))
        self._makespan = max(self._makespan, t)
        self._schedule(model, t)

    def _handoff(self, model: str, seq: _Seq, t: float) -> None:
        ms = self.states[model]
        ms.inflight_hand -= 1
        ms.waiting.append(seq)
        self._schedule(model, t)

    # ------------------------------------------------------------- decode
    def _admit(self, ms: _MState, t: float) -> None:
        was = len(ms.pool)
        admitted = 0
        if self.static:
            if ms.pool:
                return
            while ms.waiting and len(ms.pool) < ms.d_max and (
                    ms.pool_kv + ms.waiting[0].kv
                    <= ms.a.kv_capacity_bytes + _EPS):
                s = ms.waiting.popleft()
                s.acct["admit"] = t
                ms.pool.append(s)
                ms.pool_kv += s.kv
                admitted += 1
            ms.static_slots = len(ms.pool)
        else:
            while ms.waiting and len(ms.pool) < ms.d_max and (
                    ms.pool_kv + ms.waiting[0].kv
                    <= ms.a.kv_capacity_bytes + _EPS):
                s = ms.waiting.popleft()
                s.acct["admit"] = t
                ms.pool.append(s)
                ms.pool_kv += s.kv
                admitted += 1
            if was > 0 and admitted:
                ms.admitted_midbatch += admitted
                if self.tracer is not None:
                    self.tracer.instant("admit_midbatch", t=t,
                                        group="llm",
                                        lane=f"{ms.a.model}/decode",
                                        n=admitted)
        if admitted:
            self._note_kv(ms.a.model, ms, t)

    def _start_decode(self, model: str, ms: _MState, t: float) -> None:
        if not ms.pool:
            ms.step_t0 = t
            ms.run_steps = 0
        self._admit(ms, t)
        if not ms.pool:
            return
        b = ms.static_slots if self.static else len(ms.pool)
        dur = (ms.stages_d - 1 + b) * ms.beat_d
        ms.busy_d = True
        ms.busy_chip_s += dur * ms.a.decode_chips
        self._push(t + dur, _DDONE, model)

    def _decode_done(self, model: str, t: float) -> None:
        ms = self.states[model]
        ms.busy_d = False
        ms.decode_steps += 1
        ms.run_steps += 1
        ms.t_last_step = t
        finished = [s for s in ms.pool if s.remaining <= 1]
        ms.pool = [s for s in ms.pool if s.remaining > 1]
        for s in ms.pool:
            s.remaining -= 1
        for s in finished:
            ms.pool_kv -= s.kv
            r = s.req
            tpot = (t - s.t_first) / max(1, r.output_tokens - 1)
            self._complete(r, s.t_first - r.t_arrive, tpot, t)
            a = s.acct
            admit = a.get("admit", a.get("ready", t))
            self._finish_waterfall(
                r, {"queue_wait": a.get("queue_wait", 0.0),
                    "prefill": a.get("prefill", 0.0),
                    "kv_handoff": a.get("kv_handoff", 0.0),
                    "admission_wait": admit - a.get("ready", admit),
                    "decode": t - admit}, t)
        if finished:
            self._note_kv(model, ms, t)
        if not ms.pool:
            ms.static_slots = 0
            if self.tracer is not None and ms.run_steps:
                self.tracer.complete(f"decode x{ms.run_steps}", ms.step_t0,
                                     t, group="llm", lane=f"{model}/decode",
                                     steps=ms.run_steps)
        self._makespan = max(self._makespan, t)
        self._schedule(model, t)

    # ---------------------------------------------------------------- run
    def run(self, trace: list[Request],
            horizon_s: float | None = None) -> LLMReport:
        for r in trace:
            self._push(r.t_arrive, _ARRIVE, r)
        if horizon_s is None:
            horizon_s = max((r.t_arrive for r in trace), default=0.0)
        while self._heap:
            t, kind, _, payload = heapq.heappop(self._heap)
            if kind == _ARRIVE:
                self._arrive(payload, t)
            elif kind == _TIMER:
                if self._timer_at.pop(payload, None) is not None:
                    self._schedule(payload[0], t)
            elif kind == _PDONE:
                model, batch, t0 = payload
                self._prefill_done(model, batch, t0, t)
            elif kind == _DDONE:
                self._decode_done(payload, t)
            elif kind == _HAND:
                self._handoff(payload[0], payload[1], t)
        return self._report(horizon_s)

    def _report(self, horizon_s: float) -> LLMReport:
        queued_end = {}
        for m, ms in self.states.items():
            queued_end[m] = (len(ms.queue) + len(ms.waiting) + len(ms.pool)
                             + ms.inflight_hand)
        chips = {}
        for m, ms in self.states.items():
            a = ms.a
            chips[m] = (a.prefill_chips if ms.coloc
                        else a.prefill_chips + a.decode_chips)
        rep = summarize_llm(
            mode=self.plan.mode,
            batching="static" if self.static else "continuous",
            package=self.plan.package,
            chips=self.plan.chips,
            seed=self.seed,
            horizon_s=horizon_s,
            makespan_s=self._makespan,
            arrived=self._arrived,
            dropped=self._dropped,
            queued_end=queued_end,
            completions=self._completions,
            slos={m: self.slos.get(m, (None, None)) for m in self.states},
            model_chips=chips,
            prefill_batches={m: ms.prefill_batches
                             for m, ms in self.states.items()},
            decode_steps={m: ms.decode_steps
                          for m, ms in self.states.items()},
            admitted_midbatch={m: ms.admitted_midbatch
                               for m, ms in self.states.items()},
            kv_traces={m: ms.kv_trace for m, ms in self.states.items()},
            queue_traces={m: ms.q_trace for m, ms in self.states.items()},
            waterfalls=self.waterfalls,
            kv_capacity={m: ms.a.kv_capacity_bytes
                         for m, ms in self.states.items()},
            busy_chip_s={m: ms.busy_chip_s for m, ms in self.states.items()},
            meta={"mix_rate": self.plan.mix_rate,
                  "queue_policy": self.batching.queue_policy,
                  "plan_token_rate": self.plan.token_rate},
        )
        rep.tracer = self.tracer
        return rep


def simulate_tokens(
    plan: LLMPlan,
    hw: HardwareModel,
    trace: list[Request],
    batching: BatchingPolicy | None = None,
    slos: dict[str, tuple[float | None, float | None]] | None = None,
    static: bool = False,
    horizon_s: float | None = None,
    seed: int = 0,
    tracer=None,
) -> LLMReport:
    """One-call wrapper mirroring :func:`repro_torch.serving.executor.simulate`."""
    if tracer is None:
        tracer = current_tracer()
    ex = TokenExecutor(plan, hw, batching=batching, slos=slos, static=static,
                       seed=seed, tracer=tracer)
    return ex.run(trace, horizon_s=horizon_s)
