"""Layer-graph IR consumed by the Scope scheduler.

A copy of the JAX package's ``core/graph.py``, which is JAX-free.

The paper treats an NN as a sequence of layers (Table I indexes
``Layer(i,j,k)`` by segment / cluster / position).  We linearize every
workload (CNN or LM) into a chain of :class:`LayerNode`.  Residual adds,
norms and other cheap glue are folded into the node they feed.

Each node carries the quantities the cost model (paper Eqs. 4-7, Table II)
needs:

* ``flops``          total forward FLOPs (2 x MACs) for one sample
* ``weight_bytes``   parameter bytes (at the deployment precision)
* ``in_bytes`` / ``out_bytes``  activation volumes for one sample
* ``halo_bytes``     WSP boundary-exchange volume for one sample: conv kernel
                     overlap for CNNs, KV/state handoff for attention/SSM
* ``wsp_parallel``   max useful split degree of the activation dim
                     (output pixels / tokens) -- WSP's parallelism
* ``isp_parallel``   max useful split degree of the weight-output dim
                     (output channels / heads / ffn width) -- ISP's parallelism
* ``parallel_metric``  scalar used by GenCMT's similarity merge
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Sequence


@dataclass(frozen=True)
class LayerNode:
    name: str
    kind: str                      # conv | fc | attention | ffn | moe_ffn | mamba | rwkv | embed
    flops: float
    weight_bytes: float
    in_bytes: float
    out_bytes: float
    halo_bytes: float = 0.0
    wsp_parallel: float = 1.0
    isp_parallel: float = 1.0
    parallel_metric: float = 0.0   # defaults to wsp_parallel in __post_init__
    # Optional extras used by extensions (kept out of the paper-faithful path).
    n_experts: int = 0             # >0 marks a MoE layer -> EP partition legal
    active_experts: int = 0
    meta: dict = field(default_factory=dict, hash=False, compare=False)

    def __post_init__(self):
        if self.parallel_metric == 0.0:
            object.__setattr__(self, "parallel_metric", float(self.wsp_parallel))

    def scaled(self, batch: int) -> "LayerNode":
        """Per-sample -> per-microbatch scaling (weights are batch invariant)."""
        return replace(
            self,
            flops=self.flops * batch,
            in_bytes=self.in_bytes * batch,
            out_bytes=self.out_bytes * batch,
            halo_bytes=self.halo_bytes * batch,
            wsp_parallel=self.wsp_parallel * batch,
        )


@dataclass(frozen=True)
class LayerGraph:
    """A linearized network: an ordered chain of layers."""
    name: str
    layers: tuple[LayerNode, ...]

    def __len__(self) -> int:
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerGraph(self.name, tuple(self.layers[idx]))
        return self.layers[idx]

    @property
    def total_flops(self) -> float:
        return sum(l.flops for l in self.layers)

    @property
    def total_weight_bytes(self) -> float:
        return sum(l.weight_bytes for l in self.layers)

    def slice(self, lo: int, hi: int) -> "LayerGraph":
        return LayerGraph(f"{self.name}[{lo}:{hi}]", tuple(self.layers[lo:hi]))


def chain(name: str, layers: Sequence[LayerNode]) -> LayerGraph:
    return LayerGraph(name, tuple(layers))


# ---------------------------------------------------------------------------
# Cluster / schedule containers (Table I of the paper).
# ---------------------------------------------------------------------------

PARTITION_WSP = "WSP"
PARTITION_ISP = "ISP"
PARTITION_EP = "EP"            # beyond-paper: expert parallelism for MoE FFNs


@dataclass(frozen=True)
class ClusterAssignment:
    """``Cluster(i, j)`` with its region and per-layer partitions."""
    layer_lo: int                  # inclusive, global layer index
    layer_hi: int                  # exclusive
    region_chips: int              # ||Region(i, j)||
    partitions: tuple[str, ...]    # P(i, j, k) per layer, len == hi - lo
    chip_type: str | None = None   # hetero package flavor (None = base type)

    @property
    def n_layers(self) -> int:
        return self.layer_hi - self.layer_lo


@dataclass(frozen=True)
class SegmentSchedule:
    """One ``Segment(i)``: pipelined clusters over disjoint regions."""
    clusters: tuple[ClusterAssignment, ...]
    latency: float = 0.0           # seconds for the evaluation batch
    cluster_times: tuple[float, ...] = ()

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)


@dataclass(frozen=True)
class ScopeSchedule:
    """Full system schedule: sequential segments (paper Eq. 1)."""
    workload: str
    chips: int
    segments: tuple[SegmentSchedule, ...]
    latency: float = 0.0
    meta: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def layer_partition(self) -> list[tuple[int, str, int]]:
        """Flat [(layer_idx, partition, region_chips)] over the whole net."""
        out = []
        for seg in self.segments:
            for cl in seg.clusters:
                for k, p in enumerate(cl.partitions):
                    out.append((cl.layer_lo + k, p, cl.region_chips))
        return out


# ---------------------------------------------------------------------------
# Multi-model co-scheduling containers (multimodel/ subsystem).
# ---------------------------------------------------------------------------

MM_PARTITIONED = "partitioned"     # per-model chip quotas, concurrent pipelines
MM_MERGED = "merged"               # one merged pipeline over concatenated graphs
MM_TIME_MUX = "time_mux"           # whole package time-multiplexed across models
MM_MODES = (MM_PARTITIONED, MM_MERGED, MM_TIME_MUX)


@dataclass(frozen=True)
class ModelAssignment:
    """One model's share of a co-scheduled package.

    ``samples_per_beat`` is this model's batch weighting inside a merged
    pipeline (1.0 elsewhere); ``time_share`` is its slice of a
    time-multiplexed package (1.0 elsewhere).  A quota drawn from a single
    flavor names it in ``chip_type``; a mixed-flavor quota (the model's
    pipeline spans flavors) itemizes per-flavor chips in ``chip_quota``
    with ``chips`` their total and ``chip_type`` None.
    """
    model: str                     # LayerGraph name
    weight: float                  # traffic weight (relative request rate)
    chips: int                     # chips dedicated (partitioned) or total (else)
    schedule: ScopeSchedule
    chip_type: str | None = None   # hetero flavor the quota is drawn from
    chip_quota: tuple[tuple[str | None, int], ...] = ()  # mixed-flavor quota
    samples_per_beat: float = 1.0
    time_share: float = 1.0

    @property
    def throughput(self) -> float:
        """Samples/s this assignment serves for its model."""
        lat = self.schedule.latency
        if lat <= 0 or lat == float("inf"):
            return 0.0
        m = self.schedule.meta.get("m_samples", 1)
        return self.time_share * m * self.samples_per_beat / lat


@dataclass(frozen=True)
class MultiModelSchedule:
    """A co-schedule of N models onto one (optionally heterogeneous) package.

    ``mix_rate`` is the sustainable rate of the *weighted mix unit*: the
    largest lambda such that every model i can serve ``lambda * weight_i``
    samples/s.  ``weighted_throughput = mix_rate * sum(weights)`` is the
    total samples/s at the traffic mix, the figure of merit reported by
    ``benchmarks/fig11_multimodel.py``.
    """
    package: str
    chips: int
    mode: str                      # one of MM_MODES
    assignments: tuple[ModelAssignment, ...]
    mix_rate: float = 0.0
    weighted_throughput: float = 0.0
    meta: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def n_models(self) -> int:
        return len(self.assignments)

    def assignment(self, model: str) -> ModelAssignment:
        for a in self.assignments:
            if a.model == model:
                return a
        raise KeyError(model)


def mix_rate(assignments) -> float:
    """lambda = min_i throughput_i / weight_i over a set of assignments."""
    return min(
        (a.throughput / a.weight if a.weight > 0 else float("inf"))
        for a in assignments
    )


def validate_multimodel(
    sched: MultiModelSchedule,
    graphs: dict[str, LayerGraph],
    type_capacity: dict[str | None, int],
) -> dict:
    """Invariants of a co-schedule.

    * every assignment's underlying ScopeSchedule is itself valid for its
      (merged-mode: shared) graph and chip budget -- including the seam
      accounting of :func:`validate_schedule`;
    * partitioned quotas are disjoint: per chip type, dedicated chips sum to
      at most the flavor's capacity (mixed-flavor quotas are itemized via
      ``chip_quota`` and accounted per flavor);
    * time-multiplexed shares sum to at most 1;
    * mix_rate / weighted_throughput are consistent with the assignments.

    Returns a report: ``{"seam_crossings": {model: total_crossings}}`` --
    how many cross-flavor seams each model's pipeline hands activations
    through (0 for every single-flavor assignment).
    """
    assert sched.mode in MM_MODES, sched.mode
    assert sched.assignments, "empty co-schedule"
    seam_by_model: dict[str, int] = {}
    for a in sched.assignments:
        assert a.weight > 0, f"{a.model}: non-positive traffic weight"
        assert a.chips >= 1
        if a.chip_quota:
            assert a.chip_type is None, (
                f"{a.model}: chip_type and chip_quota are mutually exclusive"
            )
            assert sum(c for _, c in a.chip_quota) == a.chips, (
                f"{a.model}: chip_quota {a.chip_quota} != chips {a.chips}"
            )
        # Keyed by the schedule's workload so merged-mode assignments (which
        # share one schedule over the concatenated graph) validate against
        # the merged graph, not the per-model one.
        graph = graphs[a.schedule.workload]
        caps = dict(a.chip_quota) if a.chip_quota else None
        report = validate_schedule(graph, a.schedule, a.chips, flavor_caps=caps)
        seam_by_model[a.model] = report["seam_crossings"]
    if sched.mode == MM_PARTITIONED:
        used: dict[str | None, int] = {}
        seen_schedules: set[tuple] = set()
        for a in sched.assignments:
            # Merged sub-groups: members share one ScopeSchedule *and* one
            # resource claim over one chip region, so each distinct
            # (schedule, claim)'s chips count once.
            key = (id(a.schedule), a.chip_type, a.chips,
                   tuple(a.chip_quota or ()))
            if key in seen_schedules:
                continue
            seen_schedules.add(key)
            if a.chip_quota:
                for ctype, c in a.chip_quota:
                    used[ctype] = used.get(ctype, 0) + c
            else:
                used[a.chip_type] = used.get(a.chip_type, 0) + a.chips
        for ctype, n in used.items():
            cap = type_capacity.get(ctype)
            assert cap is not None, f"unknown chip type {ctype!r}"
            assert n <= cap, f"type {ctype!r}: {n} chips used > {cap}"
    if sched.mode == MM_TIME_MUX:
        shares = sum(a.time_share for a in sched.assignments)
        assert shares <= 1.0 + 1e-9, f"time shares sum to {shares}"
    lam = mix_rate(sched.assignments)
    assert abs(lam - sched.mix_rate) <= 1e-9 * max(1.0, abs(lam)), (
        "mix_rate inconsistent", lam, sched.mix_rate,
    )
    total_w = sum(a.weight for a in sched.assignments)
    expect = lam * total_w
    assert abs(expect - sched.weighted_throughput) <= 1e-9 * max(1.0, expect)
    return {"seam_crossings": seam_by_model}


def validate_schedule(
    graph: LayerGraph,
    sched: ScopeSchedule,
    chips: int,
    flavor_caps: dict[str | None, int] | None = None,
) -> dict:
    """Invariants: contiguous cover of all layers; regions fit the package.

    ``flavor_caps`` (mixed-flavor schedules) additionally bounds each
    segment's per-flavor chip usage by that flavor's budget.

    Seam accounting (mixed-flavor pipelines): within a segment the clusters'
    chip flavors must form *contiguous runs* -- flavors occupy contiguous
    areas of the mesh, so a placement like big, little, big would tear the
    big region apart and cross the flavor seam twice where the link model
    (``HardwareModel.seam_link_bw``) charges it once.  Non-contiguous runs
    are rejected; the returned report counts the seam crossings:
    ``{"seam_crossings": total, "seam_crossings_per_segment": [...]}``.
    """
    cursor = 0
    seam_per_segment: list[int] = []
    for seg in sched.segments:
        used = 0
        by_type: dict[str | None, int] = {}
        flavor_runs: list[str | None] = []
        for cl in seg.clusters:
            assert cl.layer_lo == cursor, (cl.layer_lo, cursor)
            assert cl.layer_hi > cl.layer_lo
            assert len(cl.partitions) == cl.n_layers
            assert cl.region_chips >= 1
            used += cl.region_chips
            by_type[cl.chip_type] = by_type.get(cl.chip_type, 0) + cl.region_chips
            if not flavor_runs or flavor_runs[-1] != cl.chip_type:
                flavor_runs.append(cl.chip_type)
            cursor = cl.layer_hi
        assert used <= chips, f"segment uses {used} > {chips} chips"
        assert len(flavor_runs) == len(set(flavor_runs)), (
            f"non-contiguous flavor runs {flavor_runs}: a flavor's clusters "
            "must occupy one contiguous stretch of the pipeline"
        )
        seam_per_segment.append(max(0, len(flavor_runs) - 1))
        if flavor_caps is not None:
            for ctype, n in by_type.items():
                cap = flavor_caps.get(ctype)
                assert cap is not None, f"unknown chip type {ctype!r}"
                assert n <= cap, (
                    f"segment uses {n} chips of type {ctype!r} > {cap}"
                )
    assert cursor == len(graph), f"schedule covers {cursor}/{len(graph)} layers"
    return {
        "seam_crossings": sum(seam_per_segment),
        "seam_crossings_per_segment": seam_per_segment,
    }


def geomean(vals) -> float:
    vals = [max(v, 1e-30) for v in vals]
    return math.exp(sum(math.log(v) for v in vals) / len(vals))
