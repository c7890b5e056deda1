"""Model specs for co-scheduling: a LayerGraph plus its traffic weight.

A copy of the JAX package's ``multimodel/spec.py``, which is JAX-free.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.graph import LayerGraph
from ..core.workloads import get_cnn


@dataclass(frozen=True)
class ModelSpec:
    """One tenant of a co-scheduled package.

    ``weight`` is the relative request rate of this model in the traffic
    mix (weights only matter relative to each other): the co-scheduler
    maximizes the sustainable rate of the weighted mix unit.

    ``slo_s`` (optional) is the model's serving latency objective: the DSE
    ignores it, but the serving executor reports per-model SLO attainment
    and counts only SLO-satisfying samples toward goodput.
    """
    graph: LayerGraph
    weight: float = 1.0
    slo_s: float | None = None

    @property
    def name(self) -> str:
        return self.graph.name

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"{self.graph.name}: weight must be > 0")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(f"{self.graph.name}: slo_s must be > 0")


def parse_mix(mix: str) -> list[ModelSpec]:
    """``"resnet50:2,alexnet:1"`` -> ModelSpecs (weight defaults to 1).

    A third ``:``-field is the model's serving SLO in milliseconds
    (``"resnet50:2:50"`` = weight 2, 50 ms latency objective).  Names
    resolve through the CNN workload registry; duplicate names get a
    ``#k`` suffix so per-model results stay distinguishable.
    """
    specs: list[ModelSpec] = []
    seen: dict[str, int] = {}
    for part in mix.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) > 3:
            raise ValueError(f"mix entry {part!r}: name[:weight[:slo_ms]]")
        name = fields[0]
        weight = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
        slo_s = (float(fields[2]) / 1e3
                 if len(fields) > 2 and fields[2] else None)
        graph = get_cnn(name)
        count = seen.get(name, 0)
        seen[name] = count + 1
        if count:
            graph = LayerGraph(f"{name}#{count + 1}", graph.layers)
        specs.append(ModelSpec(graph, weight, slo_s=slo_s))
    if not specs:
        raise ValueError(f"empty mix: {mix!r}")
    return specs
