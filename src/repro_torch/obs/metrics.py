"""Typed metrics registry: counters / gauges / histograms / time-weighted series.

A copy of the JAX package's ``obs/metrics.py``, which is JAX-free.

One interface subsumes the ad-hoc stat dicts the repo grew (the engines'
``stats`` counters, the serving executor's queue traces): a
:class:`MetricsRegistry` hands out named instruments, and
:meth:`MetricsRegistry.snapshot` renders them back into one plain dict for
reports and benches.

Disabled-path contract: :data:`NULL_METRICS` is a no-op singleton whose
instruments are shared do-nothing objects -- code may call
``registry.counter("x").inc()`` unconditionally and pay only an attribute
lookup plus an empty method call when metrics are off
(``tests/test_obs.py`` micro-benches the bound).

:class:`TimeSeries` is the time-weighted step series used for queue depths:
``record(t, v)`` means the series holds value ``v`` from ``t`` until the
next record (and 0 before its first record), so ``mean`` / ``percentile``
integrate over the whole run exactly like the serving report's
time-weighted queue mean.
"""
from __future__ import annotations

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
    "NullRegistry",
    "TimeSeries",
]


class Counter:
    """Monotone (or snapshot-``set``) integer counter."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        """Absolute snapshot (engine stats are cumulative at the source)."""
        self.value = v


class Gauge:
    """Last-value-wins scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exact-sample histogram with nearest-rank percentiles."""
    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def observe(self, v: float) -> None:
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return sum(self.values)

    def percentile(self, q: float) -> float:
        vals = sorted(self.values)
        if not vals:
            return 0.0
        k = max(1, int(-(-q * len(vals) // 100)))       # ceil without floats
        return vals[min(k, len(vals)) - 1]

    def snapshot(self) -> dict:
        vals = self.values
        return {
            "count": len(vals),
            "sum": sum(vals),
            "min": min(vals) if vals else 0.0,
            "max": max(vals) if vals else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class TimeSeries:
    """Right-continuous step series ``[(t, value), ...]`` with time-weighted
    statistics over ``[0, t_end]`` (value 0 before the first record)."""
    __slots__ = ("points",)

    def __init__(self):
        self.points: list[tuple[float, float]] = []

    def record(self, t: float, v) -> None:
        pts = self.points
        if pts and pts[-1][0] == t:
            pts[-1] = (t, v)
        else:
            pts.append((t, v))

    def extend(self, pairs) -> None:
        for t, v in pairs:
            self.record(t, v)

    @property
    def max(self):
        """Peak recorded value (matches a step trace's recorded peak)."""
        return max((v for _, v in self.points), default=0)

    def _segments(self, t_end: float) -> list[tuple[float, float]]:
        """``(value, duration)`` pieces covering ``[0, t_end]``."""
        pts = self.points
        if not pts:
            return [(0.0, max(0.0, t_end))]
        segs: list[tuple[float, float]] = []
        first_t = pts[0][0]
        if first_t > 0:
            segs.append((0.0, min(first_t, t_end)))
        for (t, v), (t_next, _) in zip(pts, pts[1:] + [(t_end, None)]):
            if t >= t_end:
                break
            segs.append((v, max(0.0, min(t_next, t_end) - t)))
        return segs

    def mean(self, t_end: float) -> float:
        area = sum(v * d for v, d in self._segments(t_end))
        return area / max(1e-12, t_end)

    def percentile(self, q: float, t_end: float):
        """Time-weighted percentile: the smallest value whose cumulative
        holding time reaches ``q``% of ``t_end``."""
        segs = [(v, d) for v, d in self._segments(t_end) if d > 0]
        total = sum(d for _, d in segs)
        if total <= 0:
            return 0.0
        segs.sort(key=lambda s: s[0])
        need = (q / 100.0) * total
        acc = 0.0
        for v, d in segs:
            acc += d
            if acc >= need - 1e-12:
                return v
        return segs[-1][0]

    def stats(self, t_end: float) -> dict:
        return {
            "mean": self.mean(t_end),
            "max": self.max,
            "p95": self.percentile(95, t_end),
            "points": len(self.points),
        }


class MetricsRegistry:
    """Named instruments, created on first use."""
    enabled = True

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series: dict[str, TimeSeries] = {}

    def __bool__(self) -> bool:
        return True

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def timeseries(self, name: str) -> TimeSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = TimeSeries()
        return s

    def update_counters(self, mapping: dict, prefix: str = "") -> None:
        """Snapshot a plain counter dict (e.g. an engine's ``stats``)."""
        for k, v in mapping.items():
            if isinstance(v, (int, float)):
                self.counter(prefix + k).set(v)

    def snapshot(self, t_end: float | None = None) -> dict:
        out: dict = {}
        if self.counters:
            out["counters"] = {k: c.value for k, c in sorted(self.counters.items())}
        if self.gauges:
            out["gauges"] = {k: g.value for k, g in sorted(self.gauges.items())}
        if self.histograms:
            out["histograms"] = {
                k: h.snapshot() for k, h in sorted(self.histograms.items())
            }
        if self.series:
            end = t_end if t_end is not None else max(
                (pts.points[-1][0] for pts in self.series.values() if pts.points),
                default=0.0,
            )
            out["series"] = {
                k: s.stats(end) for k, s in sorted(self.series.items())
            }
        return out


# ---------------------------------------------------------------------------
# Disabled path: shared no-op instruments
# ---------------------------------------------------------------------------

class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    values: list = []
    count = 0
    total = 0.0

    def observe(self, v) -> None:
        pass

    def percentile(self, q) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {}


class _NullSeries:
    __slots__ = ()
    points: list = []
    max = 0

    def record(self, t, v) -> None:
        pass

    def extend(self, pairs) -> None:
        pass

    def mean(self, t_end) -> float:
        return 0.0

    def percentile(self, q, t_end) -> float:
        return 0.0

    def stats(self, t_end) -> dict:
        return {}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_SERIES = _NullSeries()


class NullRegistry:
    """Do-nothing registry: every accessor returns a shared no-op object."""
    enabled = False
    counters: dict = {}
    gauges: dict = {}
    histograms: dict = {}
    series: dict = {}

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str) -> _NullHistogram:
        return _NULL_HISTOGRAM

    def timeseries(self, name: str) -> _NullSeries:
        return _NULL_SERIES

    def update_counters(self, mapping: dict, prefix: str = "") -> None:
        pass

    def snapshot(self, t_end=None) -> dict:
        return {}


NULL_METRICS = NullRegistry()
