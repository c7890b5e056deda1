"""Seeded fault injection for the serving executor (and the ft trainer).

A copy of the JAX package's ``serving/faults.py``, which is JAX-free.

A :class:`FaultInjector` turns a hardware package into a deterministic
stream of :class:`FaultEvent` failure/repair pairs over three target
kinds:

* ``chip:r,c`` -- one chip at mesh coordinate ``(r, c)``;
* ``zone:<flavor>`` -- a whole flavor zone (``zone:*`` on a homogeneous
  package is every chip);
* ``seam:a+b`` -- the interconnect seam between two adjacent flavor
  zones (chips survive; cross-seam deployments lose service until
  repair).

Random lifetimes are alternating exponential MTBF/MTTR draws, one
independent stream per component keyed exactly like the traffic
generators -- ``numpy.random.default_rng([seed, crc32(name)])``
(:func:`repro_torch.serving.traffic.model_rng`) -- so adding a chip stream
never perturbs another component's schedule, and the trainer and the
serving simulator replay identical chaos from one (seed, hardware) pair.
Scripted scenarios (``"zone:little@2:6;chip:0,1@3"``, parsed by
:func:`parse_faults`) ride the same event type.

The serving executor consumes ``FaultInjector.schedule(horizon)`` (or a
raw event list); the training path (:mod:`repro_torch.ft.runner`) consumes
:meth:`FaultInjector.step_hook`, which maps step indices onto the same
failure windows and raises :class:`InjectedFault` the first time a step
lands inside each window.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.hw import HardwareModel
from ..core.regions import flavor_zones
from ..multimodel.quota import package_flavors
from .traffic import model_rng

__all__ = [
    "FaultEvent",
    "FaultInjector",
    "InjectedFault",
    "parse_faults",
]


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.step_hook` inside a failure window."""


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One state change of the package: ``kind`` is ``"fail"`` or
    ``"repair"``; ``chips`` are the mesh coordinates affected (empty for a
    seam event); ``seam`` is the unordered flavor pair of a seam target."""
    t: float
    kind: str
    target: str
    chips: tuple[tuple[int, int], ...] = ()
    seam: tuple[str, str] | None = None

    def __post_init__(self):
        if self.kind not in ("fail", "repair"):
            raise ValueError(f"fault kind {self.kind!r}")

    def to_json(self) -> dict:
        return {
            "t": self.t, "kind": self.kind, "target": self.target,
            "chips": [list(c) for c in self.chips],
            "seam": list(self.seam) if self.seam else None,
        }


def resolve_target(
    target: str, hw: HardwareModel
) -> tuple[tuple[tuple[int, int], ...], tuple[str, str] | None]:
    """Map a target string onto ``(chip coords, seam pair)`` for ``hw``.

    Zones resolve against the *pristine* flavor zones (the package as
    built); chip coordinates must be occupied.
    """
    kind, _, rest = target.partition(":")
    if kind == "chip":
        try:
            r, c = rest.split(",")
            coord = (int(r), int(c))
        except ValueError:
            raise ValueError(f"chip target {target!r}: want chip:r,c") from None
        if coord not in hw.occupied_coords():
            raise ValueError(
                f"{target!r}: coordinate outside the occupied mesh "
                f"{hw.mesh_shape}"
            )
        return (coord,), None
    if kind == "zone":
        flavor = None if rest in ("", "*") else rest
        zones = flavor_zones(package_flavors(hw), hw.mesh_shape,
                             dead=hw.dead_chips)
        if flavor not in zones:
            raise ValueError(
                f"{target!r}: package flavors are "
                f"{sorted(str(f) for f in zones)}"
            )
        return tuple(zones[flavor]), None
    if kind == "seam":
        parts = rest.split("+")
        if len(parts) != 2:
            raise ValueError(f"seam target {target!r}: want seam:a+b")
        a, b = parts
        for n in (a, b):
            hw.chip_type(n)       # raises on unknown flavors
        return (), (a, b)
    raise ValueError(
        f"fault target {target!r}: want chip:r,c | zone:flavor | seam:a+b"
    )


def _parse_time(tok: str, horizon_s: float | None) -> float:
    if tok.endswith("%"):
        if horizon_s is None:
            raise ValueError(
                f"relative fault time {tok!r} needs a horizon"
            )
        return float(tok[:-1]) / 100.0 * horizon_s
    return float(tok)


def parse_faults(
    spec: str, hw: HardwareModel, horizon_s: float | None = None
) -> list[FaultEvent]:
    """Parse a scripted scenario DSL into sorted events.

    ``spec`` is ``;``-separated items ``target@t_fail[:t_repair]`` (chip
    targets contain a comma, hence the semicolon separator).  Times are
    seconds, or percentages of ``horizon_s`` (``zone:little@25%:75%``).  A
    missing ``t_repair`` means the component never comes back.
    """
    events: list[FaultEvent] = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        target, at, times = item.rpartition("@")
        if not at:
            raise ValueError(f"fault item {item!r}: want target@t0[:t1]")
        chips, seam = resolve_target(target, hw)
        toks = times.split(":")
        if len(toks) not in (1, 2):
            raise ValueError(f"fault item {item!r}: want target@t0[:t1]")
        t0 = _parse_time(toks[0], horizon_s)
        events.append(FaultEvent(t=t0, kind="fail", target=target,
                                 chips=chips, seam=seam))
        if len(toks) == 2:
            t1 = _parse_time(toks[1], horizon_s)
            if t1 <= t0:
                raise ValueError(
                    f"fault item {item!r}: repair {t1} <= failure {t0}"
                )
            events.append(FaultEvent(t=t1, kind="repair", target=target,
                                     chips=chips, seam=seam))
    events.sort(key=lambda e: (e.t, e.target, e.kind))
    return events


@dataclass
class FaultInjector:
    """Deterministic failure/repair schedule generator for one package.

    Random streams turn on per component class when its MTBF is set:
    every chip (``chip_mtbf_s``), every flavor zone (``zone_mtbf_s``) and
    every adjacent flavor seam (``seam_mtbf_s``) draws alternating
    Exponential(MTBF) up-times and Exponential(MTTR) down-times from its
    own ``model_rng(seed, component_name)`` stream.  ``scripted`` events
    (FaultEvents, ``(target, t0, t1)`` tuples, or DSL strings) merge into
    the same timeline.
    """
    hw: HardwareModel
    seed: int = 0
    chip_mtbf_s: float | None = None
    chip_mttr_s: float = 1.0
    zone_mtbf_s: float | None = None
    zone_mttr_s: float = 2.0
    seam_mtbf_s: float | None = None
    seam_mttr_s: float = 2.0
    scripted: tuple = ()
    horizon_hint_s: float | None = None   # resolves % times in scripted items
    _scripted_events: list[FaultEvent] = field(init=False, repr=False)

    def __post_init__(self):
        for label, v in (("chip_mtbf_s", self.chip_mtbf_s),
                         ("zone_mtbf_s", self.zone_mtbf_s),
                         ("seam_mtbf_s", self.seam_mtbf_s),
                         ("chip_mttr_s", self.chip_mttr_s),
                         ("zone_mttr_s", self.zone_mttr_s),
                         ("seam_mttr_s", self.seam_mttr_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{label} {v} <= 0")
        events: list[FaultEvent] = []
        for item in self.scripted:
            if isinstance(item, FaultEvent):
                events.append(item)
            elif isinstance(item, str):
                events.extend(parse_faults(item, self.hw,
                                           self.horizon_hint_s))
            else:
                target, t0, t1 = item
                events.extend(parse_faults(
                    f"{target}@{t0}" + (f":{t1}" if t1 is not None else ""),
                    self.hw, self.horizon_hint_s,
                ))
        self._scripted_events = events

    # ------------------------------------------------------------- streams
    def _random_components(self) -> list[tuple[str, float, float]]:
        """(component name, mtbf, mttr) of every enabled random stream."""
        out: list[tuple[str, float, float]] = []
        if self.chip_mtbf_s is not None:
            for r, c in self.hw.occupied_coords():
                out.append((f"chip:{r},{c}",
                            self.chip_mtbf_s, self.chip_mttr_s))
        counts = package_flavors(self.hw)
        if self.zone_mtbf_s is not None:
            for f, _ in counts:
                out.append((f"zone:{f if f is not None else '*'}",
                            self.zone_mtbf_s, self.zone_mttr_s))
        if self.seam_mtbf_s is not None:
            for (a, _), (b, _) in zip(counts, counts[1:]):
                if a is not None and b is not None:
                    out.append((f"seam:{a}+{b}",
                                self.seam_mtbf_s, self.seam_mttr_s))
        return out

    def schedule(self, horizon_s: float) -> list[FaultEvent]:
        """All events with ``t < horizon_s``, time-sorted, deterministic.

        A failure whose repair would land past the horizon stays down for
        the rest of the run (no repair event is emitted).
        """
        events = [e for e in self._scripted_events if e.t < horizon_s]
        for name, mtbf, mttr in self._random_components():
            rng = model_rng(self.seed, name)
            chips, seam = resolve_target(name, self.hw)
            t = 0.0
            while True:
                t += rng.exponential(mtbf)
                if t >= horizon_s:
                    break
                events.append(FaultEvent(t=t, kind="fail", target=name,
                                         chips=chips, seam=seam))
                t += rng.exponential(mttr)
                if t >= horizon_s:
                    break
                events.append(FaultEvent(t=t, kind="repair", target=name,
                                         chips=chips, seam=seam))
        events.sort(key=lambda e: (e.t, e.target, e.kind))
        return events

    # ---------------------------------------------------------- ft bridge
    def step_hook(self, step_time_s: float = 1.0, n_steps: int = 1000):
        """A ``failure_injector(step)`` callable for
        :class:`repro_torch.ft.ResilientTrainer`: maps ``step * step_time_s``
        onto this injector's failure windows and raises
        :class:`InjectedFault` the *first* time a step lands inside each
        window (transient-fault semantics: after checkpoint restore the
        replay of the same step passes, matching a node that was replaced).
        """
        events = self.schedule(n_steps * step_time_s)
        down_since: dict[str, float] = {}
        windows: list[tuple[float, float, str]] = []
        for e in events:
            if e.kind == "fail":
                down_since.setdefault(e.target, e.t)
            elif e.target in down_since:
                windows.append((down_since.pop(e.target), e.t, e.target))
        for target, t0 in down_since.items():
            windows.append((t0, n_steps * step_time_s, target))
        windows.sort()
        fired: set[int] = set()

        def hook(step: int) -> None:
            t = step * step_time_s
            for i, (t0, t1, target) in enumerate(windows):
                if i not in fired and t0 <= t < t1:
                    fired.add(i)
                    raise InjectedFault(
                        f"{target} down at t={t:g}s (step {step})"
                    )

        return hook
