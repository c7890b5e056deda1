"""Span-based tracer with dual clocks and Chrome trace-event export.

A copy of the JAX package's ``obs/trace.py``, which is JAX-free.

Two usage modes share one event buffer:

* **Wall-clock spans** (the DSE path): ``with tracer.span("search", ...):``
  measures elapsed ``time.perf_counter`` seconds, relative to the tracer's
  epoch.  Spans nest; late arguments attach via ``span.set(best=...)``.
* **Simulated-time events** (the serving executor): the caller owns the
  clock and reports explicit times through :meth:`Tracer.complete`,
  :meth:`Tracer.instant`, and :meth:`Tracer.counter`.  Sim events never
  read the wall clock, so same-seed runs export bytewise-identical traces.

Events group into Chrome trace *processes* (``group``: e.g. ``dse`` vs
``serving``) and *threads* (``lane``: e.g. one lane per model server) so
Perfetto / ``chrome://tracing`` renders a Gantt: solver spans, per-server
batch lanes, queue-depth counter tracks, and fault/recovery instants on a
shared timeline.  :meth:`Tracer.write` emits Chrome JSON (``*.json``) or
one event per line (``*.jsonl``); :meth:`Tracer.summary` prints top spans
by self-time plus the metrics table.

Disabled path: :data:`NULL_TRACER` is a falsy no-op singleton.  Hot code
uses the ambient-tracer stack (:func:`current_tracer` / :func:`use_tracer`)
and pays roughly a dict-free method call per span when tracing is off —
``tests/test_obs.py`` micro-benches the bound.
"""
from __future__ import annotations

import functools
import json
import time

from .metrics import MetricsRegistry, NULL_METRICS

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "current_tracer",
    "traced",
    "use_tracer",
    "validate_chrome_trace",
]


# ---------------------------------------------------------------------------
# Disabled path
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span (context manager)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Falsy do-nothing tracer; every method is a cheap no-op."""
    enabled = False
    metrics = NULL_METRICS
    events: list = []

    def __bool__(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def span(self, name, group="dse", lane="solver", **args):
        return _NULL_SPAN

    def complete(self, name, t0, t1, group="sim", lane="", **args):
        pass

    def instant(self, name, t=None, group="dse", lane="solver", **args):
        pass

    def counter(self, name, t, value, group="sim"):
        pass

    def summary(self, top: int = 10) -> str:
        return "(tracing disabled)"


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# Ambient tracer stack
# ---------------------------------------------------------------------------

_STACK: list = [NULL_TRACER]


def current_tracer():
    """The innermost active tracer (the no-op singleton by default)."""
    return _STACK[-1]


class use_tracer:
    """Install ``tracer`` as the ambient tracer for a ``with`` block."""
    __slots__ = ("tracer",)

    def __init__(self, tracer):
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def __enter__(self):
        _STACK.append(self.tracer)
        return self.tracer

    def __exit__(self, exc_type, exc, tb):
        _STACK.pop()
        return False


def traced(name: str | None = None, group: str = "dse", lane: str = "solver"):
    """Decorator: run the function inside a span on the ambient tracer."""
    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with current_tracer().span(label, group=group, lane=lane):
                return fn(*a, **kw)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Live tracer
# ---------------------------------------------------------------------------

class _Span:
    """Wall-clock span; records on ``__exit__``."""
    __slots__ = ("tr", "name", "group", "lane", "args", "t0")

    def __init__(self, tr, name, group, lane, args):
        self.tr = tr
        self.name = name
        self.group = group
        self.lane = lane
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = self.tr.now()
        return self

    def set(self, **args):
        self.args.update(args)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tr._record("X", self.name, self.group, self.lane,
                        self.t0, self.tr.now(), self.args)
        return False


class Tracer:
    """Collects span/instant/counter events; owns a :class:`MetricsRegistry`."""
    enabled = True

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._epoch = self._clock()
        # event: (ph, name, group, lane, t0, t1_or_value, args)
        self.events: list[tuple] = []
        self.metrics = MetricsRegistry()

    def __bool__(self) -> bool:
        return True

    def now(self) -> float:
        """Seconds since this tracer's epoch (wall clock by default)."""
        return self._clock() - self._epoch

    # -- recording ----------------------------------------------------------

    def span(self, name: str, group: str = "dse", lane: str = "solver", **args):
        """Context-manager span on this tracer's own clock."""
        return _Span(self, name, group, lane, args)

    def complete(self, name: str, t0: float, t1: float,
                 group: str = "sim", lane: str = "", **args) -> None:
        """A finished span with caller-supplied times (simulated seconds)."""
        self._record("X", name, group, lane, t0, t1, args)

    def instant(self, name: str, t: float | None = None,
                group: str = "dse", lane: str = "solver", **args) -> None:
        """A point event; ``t=None`` stamps the tracer's own clock."""
        tt = self.now() if t is None else t
        self._record("i", name, group, lane, tt, tt, args)

    def counter(self, name: str, t: float, value, group: str = "sim") -> None:
        """One sample of a counter track (rendered as a filled series)."""
        self._record("C", name, group, "", t, t, {"value": value})

    def _record(self, ph, name, group, lane, t0, t1, args) -> None:
        self.events.append((ph, name, group, lane, t0, t1, args))

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (load in Perfetto / chrome://tracing).

        ``group`` -> pid, ``(group, lane)`` -> tid, both assigned in first-use
        order so same-event-stream exports are identical.
        """
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        meta: list[dict] = []
        body: list[dict] = []

        def pid_of(group: str) -> int:
            pid = pids.get(group)
            if pid is None:
                pid = pids[group] = len(pids) + 1
                meta.append({"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "ts": 0, "args": {"name": group}})
            return pid

        def tid_of(group: str, lane: str) -> int:
            key = (group, lane)
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids) + 1
                meta.append({"ph": "M", "name": "thread_name",
                             "pid": pid_of(group), "tid": tid, "ts": 0,
                             "args": {"name": lane or group}})
            return tid

        def us(t: float) -> float:
            v = round(t * 1e6, 3)
            return int(v) if v == int(v) else v

        for ph, name, group, lane, t0, t1, args in self.events:
            ev = {"ph": ph, "name": name, "pid": pid_of(group),
                  "tid": tid_of(group, lane), "ts": us(t0)}
            if ph == "X":
                ev["dur"] = us(max(0.0, t1 - t0))
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            body.append(ev)

        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the trace: ``*.jsonl`` -> one event per line, else Chrome JSON."""
        payload = self.to_chrome()
        with open(path, "w") as fh:
            if path.endswith(".jsonl"):
                for ev in payload["traceEvents"]:
                    fh.write(json.dumps(ev, sort_keys=True) + "\n")
            else:
                json.dump(payload, fh, sort_keys=True)
                fh.write("\n")
        return path

    # -- reporting ----------------------------------------------------------

    def _span_aggregate(self) -> dict:
        """(group, name) -> [count, total_s, self_s] with child time removed."""
        agg: dict[tuple[str, str], list] = {}
        lanes: dict[tuple[str, str], list] = {}
        for ev in self.events:
            if ev[0] == "X":
                lanes.setdefault((ev[2], ev[3]), []).append(ev)
        for evs in lanes.values():
            evs.sort(key=lambda e: (e[4], -(e[5])))
            stack: list = []
            for ev in evs:
                _, name, group, _, t0, t1, _ = ev
                while stack and t0 >= stack[-1][5] - 1e-12:
                    stack.pop()
                a = agg.setdefault((group, name), [0, 0.0, 0.0])
                dur = t1 - t0
                a[0] += 1
                a[1] += dur
                a[2] += dur
                if stack:
                    parent = agg[(stack[-1][2], stack[-1][1])]
                    parent[2] -= dur
                stack.append(ev)
        return agg

    def summary(self, top: int = 10) -> str:
        """Text report: top spans by self-time, then the metrics table."""
        agg = self._span_aggregate()
        n_spans = sum(a[0] for a in agg.values())
        lines = [f"trace: {n_spans} spans, {len(self.events)} events"]
        if agg:
            lines.append(f"{'self_s':>10} {'total_s':>10} {'count':>7}  span")
            ranked = sorted(agg.items(), key=lambda kv: -kv[1][2])[:top]
            for (group, name), (count, total, self_s) in ranked:
                lines.append(
                    f"{self_s:>10.4f} {total:>10.4f} {count:>7}  {group}/{name}"
                )
        snap = self.metrics.snapshot()
        for kind in ("counters", "gauges"):
            table = snap.get(kind)
            if table:
                lines.append(f"{kind}:")
                for k, v in table.items():
                    vv = f"{v:.6g}" if isinstance(v, float) else str(v)
                    lines.append(f"  {k:<32} {vv}")
        series = snap.get("series")
        if series:
            lines.append("series (time-weighted):")
            for k, st in series.items():
                lines.append(
                    f"  {k:<32} mean={st['mean']:.3f} p95={st['p95']:.3f} "
                    f"max={st['max']:.3f}"
                )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Chrome-trace validation (shared by scripts/check_trace.py and tests)
# ---------------------------------------------------------------------------

def validate_chrome_trace(payload, expect_fault_events: bool = False,
                          expect_groups=(),
                          expect_llm: bool = False) -> list[str]:
    """Schema-check a Chrome trace-event JSON object; returns problem strings.

    Checks: required keys per event phase, non-negative times, proper span
    nesting per (pid, tid) lane, monotone per-counter timestamps, requested
    process groups present, and (optionally) fault instant events.

    ``expect_llm`` additionally requires the token-level serving signature:
    ``prefill``/``decode`` spans on per-model ``<model>/<phase>`` lanes in
    the ``llm`` group, at least one ``admit_midbatch`` instant, and
    ``kv_bytes/<model>`` counter tracks.
    """
    problems: list[str] = []
    if not isinstance(payload, dict) or not isinstance(
            payload.get("traceEvents"), list):
        return ["payload is not an object with a traceEvents list"]
    events = payload["traceEvents"]
    if not events:
        problems.append("traceEvents is empty")

    groups: set[str] = set()
    lanes: dict[tuple, list] = {}
    counter_last: dict[tuple, float] = {}
    saw_fault = False
    pid_group: dict = {}            # pid -> process (group) name
    lane_name: dict = {}            # (pid, tid) -> thread (lane) name
    span_lanes: dict = {}           # span-name prefix evidence, per group
    counter_names: set[str] = set()
    saw_admit = False

    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        for key in ("ph", "name", "pid", "tid", "ts"):
            if key not in ev:
                problems.append(f"event {i} ({ph}/{name}): missing key {key!r}")
        ts = ev.get("ts", 0)
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ph}/{name}): bad ts {ts!r}")
            continue
        if ph == "M":
            if name == "process_name":
                groups.add(ev.get("args", {}).get("name", ""))
                pid_group[ev.get("pid")] = ev.get("args", {}).get("name", "")
            elif name == "thread_name":
                lane_name[(ev.get("pid"), ev.get("tid"))] = \
                    ev.get("args", {}).get("name", "")
        elif ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X/{name}): bad dur {dur!r}")
            else:
                key = (ev.get("pid"), ev.get("tid"))
                lanes.setdefault(key, []).append((ts, ts + dur, name))
                if isinstance(name, str):
                    span_lanes.setdefault(
                        pid_group.get(ev.get("pid"), ""), set()).add(
                        (name.split(" ")[0], lane_name.get(key, "")))
        elif ph == "i":
            if ev.get("s") not in ("t", "p", "g"):
                problems.append(f"event {i} (i/{name}): missing scope 's'")
            if isinstance(name, str) and name.startswith("fault"):
                saw_fault = True
            if name == "admit_midbatch":
                saw_admit = True
        elif ph == "C":
            if "value" not in ev.get("args", {}):
                problems.append(f"event {i} (C/{name}): missing args.value")
            key = (ev.get("pid"), name)
            if counter_last.get(key, -1.0) > ts:
                problems.append(
                    f"event {i} (C/{name}): non-monotone counter ts {ts}")
            counter_last[key] = ts
            if isinstance(name, str):
                counter_names.add(name)
        else:
            problems.append(f"event {i}: unknown phase {ph!r}")

    # spans must nest per lane: sort by (start, -end); each span must close
    # inside its enclosing span
    eps = 5e-3          # µs; export rounds to 1e-3
    for (pid, tid), spans in lanes.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1] - eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                problems.append(
                    f"lane pid={pid} tid={tid}: span {name!r} "
                    f"[{t0},{t1}] overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]},{stack[-1][1]}]")
            stack.append((t0, t1, name))

    for g in expect_groups:
        if g not in groups:
            problems.append(f"missing process group {g!r} "
                            f"(have {sorted(groups)})")
    if expect_fault_events and not saw_fault:
        problems.append("no fault instant events found")
    if expect_llm:
        llm_spans = span_lanes.get("llm", set())
        for phase in ("prefill", "decode"):
            if not any(n == phase and lane.endswith(f"/{phase}")
                       for n, lane in llm_spans):
                problems.append(
                    f"no {phase} spans on a '<model>/{phase}' lane in "
                    f"group 'llm'")
        if not saw_admit:
            problems.append("no admit_midbatch instant events found")
        if not any(n.startswith("kv_bytes/") for n in counter_names):
            problems.append("no kv_bytes/<model> counter tracks found")
    return problems
