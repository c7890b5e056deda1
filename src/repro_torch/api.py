"""One front door for the Scope DSE: ``Problem -> solve() -> Solution``.

A copy of the JAX package's ``api.py``, which is JAX-free except for its two
device hooks: here ``Solution.serve(measure=True, device=...)`` times the
torch prefill steps that ``Deployment.build_steps(device=...)`` builds, on
the card unless ``device="cpu"`` is passed, and hands every server its
measured service law under the server's own (lm-graph) name.

Three PRs of growth left the entry points sprawled across
``core.search`` (``search`` / ``search_mixed`` / ``exhaustive_search`` /
``random_search``), ``core.baselines`` (the paper's three comparison
schedulers), ``multimodel`` (``co_schedule``, quota/curve searches, the two
static baselines) and the runtime bridge (``plan_for_cell`` /
``plan_for_multimodel``), each with its own kwarg dialect.  This module is
the single declarative facade the benchmarks, CLI, examples and CI all go
through -- the same shape the multi-tenant DSE literature (SCAR, Odema et
al.) exposes: one scheduler front end over many underlying strategies.

The model::

    from repro_torch import scope

    problem  = scope.problem("resnet50", "mcm64_hetero")
    solution = scope.solve(problem)          # auto-picks the strategy
    print(solution.latency, solution.strategy, solution.diagnostics["dse_s"])

* :class:`WorkloadSpec` -- one or N ``(LayerGraph, traffic_weight)`` models
  (CNN registry names, a ``"net:w,net:w"`` mix string, raw graphs, or LM
  configs via :meth:`WorkloadSpec.lm`).
* :class:`PackageSpec` -- a hardware preset name or a
  :class:`~repro_torch.core.hw.HardwareModel`, plus optional per-flavor chip caps
  and seam-model overrides.
* :class:`SearchOptions` -- strategy selection and every search knob
  (``mode``, ``paper_strict``, quota ``step``, mixed/refine/switch-cost,
  engine choice) in one place, with the legacy defaults.
* :func:`solve` -- dispatches through the strategy registry
  (``scope``, ``scope-mixed``, ``coschedule``, ``exhaustive``, ``random``,
  the paper baselines, ``equal-split``, ``time-mux``), auto-selecting by
  problem shape: 1 model x 1 flavor -> ``scope``; 1 model x N flavors ->
  ``scope-mixed``; N models -> ``coschedule``.  Every sub-search of one
  ``solve`` shares a single :class:`~repro_torch.core.fastcost.FastCostModel`
  memo.
* :class:`Solution` -- the unified result: the schedule(s), per-strategy
  diagnostics (``dse_s``, engine stats, candidates, seam crossings), and
  the :meth:`Solution.deploy` bridge into the runtime
  (``plan_for_cell`` / ``plan_for_multimodel`` -> :class:`Deployment` ->
  ``build_multimodel_steps``).

Every legacy entry point remains importable and bit-identical -- the
strategies here are thin delegating wrappers over them (see the mapping
table in README.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

from .core.baselines import (
    schedule_full_pipeline,
    schedule_segmented,
    schedule_sequential,
)
from .core.costmodel import INF, CostBreakdown, CostModel
from .core.fastcost import FastCostModel
from .core.graph import (
    MM_PARTITIONED,
    LayerGraph,
    ModelAssignment,
    MultiModelSchedule,
    ScopeSchedule,
    SegmentSchedule,
    mix_rate,
    validate_multimodel,
    validate_schedule,
)
from .core.hw import HardwareModel, get_hw, validate_region_types
from .core.regions import RegionMode
from .core.search import (
    build_clusters,
    exhaustive_search,
    random_search,
    search,
    search_mixed,
)
from .core.segments import candidate_segment_counts
from .core.workloads import get_cnn
from .multimodel.baselines import equal_split, time_multiplexed
from .multimodel.coschedule import co_schedule
from .multimodel.interleave import merged_graph
from .multimodel.quota import package_flavors
from .multimodel.spec import ModelSpec, parse_mix
from .obs import Tracer, current_tracer, use_tracer

__all__ = [
    "Deployment",
    "PackageSpec",
    "Problem",
    "SearchOptions",
    "Solution",
    "SolutionCache",
    "WorkloadSpec",
    "available_strategies",
    "problem",
    "problem_fingerprint",
    "register_strategy",
    "solve",
    "solve_many",
]


# ---------------------------------------------------------------------------
# Problem model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WorkloadSpec:
    """What to schedule: one or N ``(LayerGraph, traffic_weight)`` models.

    ``cfgs``/``seq_len`` are carried when the workload was exported from LM
    :class:`~repro_torch.models.config.ModelConfig` objects
    (:meth:`WorkloadSpec.lm`), so :meth:`Solution.deploy` can derive
    runtime ShardPlans without re-stating them.
    """
    models: tuple[ModelSpec, ...]
    cfgs: tuple = ()                 # optional ModelConfigs aligned to models
    seq_len: int | None = None
    phase: str = "prefill"           # LM graph phase: "prefill" | "decode"

    def __post_init__(self):
        if not self.models:
            raise ValueError("empty workload")
        names = [m.name for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in workload: {names}")

    @property
    def n_models(self) -> int:
        return len(self.models)

    @property
    def graph(self) -> LayerGraph:
        if self.n_models != 1:
            raise ValueError(
                f"{self.n_models}-model workload has no single graph"
            )
        return self.models[0].graph

    # -------------------------------------------------------- constructors
    @classmethod
    def cnn(cls, name: str, weight: float = 1.0) -> "WorkloadSpec":
        """One CNN from the workload registry (``"resnet50"``...)."""
        return cls(models=(ModelSpec(get_cnn(name), weight),))

    @classmethod
    def mix(cls, mix: str) -> "WorkloadSpec":
        """A traffic mix string: ``"resnet50:2,alexnet:1"``."""
        return cls(models=tuple(parse_mix(mix)))

    @classmethod
    def graphs(cls, entries) -> "WorkloadSpec":
        """Raw ``LayerGraph`` | ``(LayerGraph, weight)`` | ``ModelSpec``."""
        models = []
        for e in entries:
            if isinstance(e, ModelSpec):
                models.append(e)
            elif isinstance(e, LayerGraph):
                models.append(ModelSpec(e, 1.0))
            else:
                g, w = e
                models.append(ModelSpec(g, w))
        return cls(models=tuple(models))

    @classmethod
    def lm(cls, cfgs, seq_len: int, weights=None, *,
           phase: str = "prefill",
           decode: bool | None = None) -> "WorkloadSpec":
        """LM configs -> exported layer graphs (``lm_graph``), keeping the
        configs attached for :meth:`Solution.deploy`.

        ``phase`` selects which per-phase graph to export: ``"prefill"``
        (the default, full-sequence attention FLOPs) or ``"decode"``
        (one-token KV-append costs).  ``decode=True/False`` is an alias
        that overrides ``phase``; graph names embed the phase
        (``name@decode128``), so fingerprints distinguish the two.
        """
        from .core.workloads.lm import lm_graph

        if decode is not None:
            phase = "decode" if decode else "prefill"
        if phase not in ("prefill", "decode"):
            raise ValueError(f"phase must be prefill|decode, got {phase!r}")
        cfgs = tuple(cfgs)
        weights = list(weights) if weights else [1.0] * len(cfgs)
        if len(weights) != len(cfgs):
            raise ValueError(f"{len(weights)} weights for {len(cfgs)} configs")
        models = tuple(
            ModelSpec(lm_graph(cfg, seq_len, decode=(phase == "decode")), w)
            for cfg, w in zip(cfgs, weights)
        )
        return cls(models=models, cfgs=cfgs, seq_len=seq_len, phase=phase)

    @classmethod
    def of(cls, workload) -> "WorkloadSpec":
        """Coerce: WorkloadSpec | graph(s) | ModelSpec(s) | name/mix string."""
        if isinstance(workload, cls):
            return workload
        if isinstance(workload, str):
            return cls.mix(workload)
        if isinstance(workload, (LayerGraph, ModelSpec)):
            return cls.graphs([workload])
        return cls.graphs(workload)


@dataclass(frozen=True)
class PackageSpec:
    """Where to schedule: a preset name or an explicit HardwareModel.

    ``flavor_caps`` restricts how many chips of each flavor a (mixed)
    search may use -- ``((flavor, chips), ...)`` partial budgets, the same
    convention as ``search_mixed(flavor_budgets=...)``.  ``seam_bw_scale``
    / ``seam_bw_overrides`` override the package's cross-flavor seam model
    without rebuilding the HardwareModel by hand.
    """
    preset: str | None = None
    hw: HardwareModel | None = None
    flavor_caps: tuple[tuple[str | None, int], ...] | None = None
    seam_bw_scale: float | None = None
    seam_bw_overrides: tuple[tuple[str, str, float], ...] | None = None

    def __post_init__(self):
        if (self.preset is None) == (self.hw is None):
            raise ValueError("specify exactly one of preset / hw")

    def resolve(self) -> HardwareModel:
        hw = self.hw if self.hw is not None else get_hw(self.preset)
        if self.seam_bw_scale is not None:
            hw = replace(hw, seam_bw_scale=self.seam_bw_scale)
        if self.seam_bw_overrides is not None:
            hw = replace(hw, seam_bw_overrides=tuple(self.seam_bw_overrides))
        validate_region_types(hw)
        return hw

    @classmethod
    def of(cls, package) -> "PackageSpec":
        if isinstance(package, cls):
            return package
        if isinstance(package, str):
            return cls(preset=package)
        if isinstance(package, HardwareModel):
            return cls(hw=package)
        raise TypeError(f"cannot interpret package spec: {package!r}")


@dataclass(frozen=True)
class SearchOptions:
    """Every search knob, with the legacy entry points' defaults."""
    strategy: str = "auto"
    mode: RegionMode | str = RegionMode.FREE
    m_samples: int = 16
    paper_strict: bool = False
    ep_for_moe: bool = False
    segment_counts: tuple[int, ...] | None = None
    max_clusters: int | None = None
    chip_type: str | None = None     # pin a single-flavor search to one flavor
    # multi-model / quota search
    step: int = 1
    mixed: bool = True               # spanning quotas / per-cluster flavors
    mixed_step: int | None = None
    refine: bool = False             # coarse-to-fine curves (1D and 2D)
    cut_window: int = 2
    include_merged: bool = True
    include_time_mux: bool = True
    switch_cost: bool = False
    switch_period_s: float = 1.0
    # token-level LLM serving (strategy "llm-phase"): expected decode
    # tokens per request, and the phase-deployment mode to search --
    # "auto" (best of both) | "disaggregated" | "colocated"
    output_tokens: float = 64.0
    phase_mode: str = "auto"
    # validation searches
    samples: int = 10_000
    seed: int = 0
    # evaluation engine: "fast" (FastCostModel, batched populations) |
    # "reference" (paper-literal CostModel) | "jit" (the reference's jitted
    # population tier; not ported, raises NotImplementedError: ROADMAP A15)
    engine: str = "fast"
    distributed_weights: bool = True
    cost: Any = None                 # pre-built CostModel: shared memo across solves
    validate: bool = True
    # observability (repro_torch.obs): Tracer instance | output path | True;
    # excluded from problem_fingerprint -- tracing never changes the answer
    trace: Any = None
    # warm start: a previous Solution (or bare ScopeSchedule /
    # MultiModelSchedule) for the same model set.  Narrows the search to a
    # window around the incumbent -- segment counts for single-model
    # strategies, per-model quota windows + family gating for coschedule --
    # so drift / fault re-solves are interactive.  Excluded from
    # problem_fingerprint: a warm re-solve is a local refinement the
    # SolutionCache treats as equivalent to the cold answer (exhaustiveness
    # is deliberately traded for latency).
    warm_start: Any = None

    @property
    def region_mode(self) -> RegionMode:
        if isinstance(self.mode, RegionMode):
            return self.mode
        return RegionMode(self.mode)

    def make_cost(self, hw: HardwareModel) -> CostModel:
        if self.cost is not None:
            return self.cost
        if self.engine == "jit":
            return FastCostModel(hw, m_samples=self.m_samples,
                                 distributed_weights=self.distributed_weights,
                                 use_jit=True)
        cls = {"fast": FastCostModel, "reference": CostModel}[self.engine]
        return cls(hw, m_samples=self.m_samples,
                   distributed_weights=self.distributed_weights)


@dataclass(frozen=True)
class Problem:
    """A declarative DSE problem: workload x package x options."""
    workload: WorkloadSpec
    package: PackageSpec
    options: SearchOptions = SearchOptions()

    def with_options(self, **overrides) -> "Problem":
        """Same problem, some SearchOptions fields overridden (e.g.
        ``prob.with_options(strategy="time-mux")``)."""
        return replace(self, options=replace(self.options, **overrides))


def problem(workload, package, options: SearchOptions | None = None,
            **opts) -> Problem:
    """Build a :class:`Problem` from loose pieces.

    ``workload``: WorkloadSpec | name/mix string | LayerGraph(s) | ModelSpec(s).
    ``package``: PackageSpec | preset name | HardwareModel.
    ``**opts``: SearchOptions field overrides (exclusive with ``options``).
    """
    if options is not None and opts:
        raise ValueError("pass options= or keyword overrides, not both")
    return Problem(
        workload=WorkloadSpec.of(workload),
        package=PackageSpec.of(package),
        options=options if options is not None else SearchOptions(**opts),
    )


# ---------------------------------------------------------------------------
# Solution / Deployment
# ---------------------------------------------------------------------------

@dataclass
class Solution:
    """Unified result of :func:`solve`.

    Exactly one of ``schedule`` (single-model strategies) / ``multi``
    (multi-model strategies) is set, except for sampling strategies
    (``random``) which only fill ``diagnostics``.  ``diagnostics`` always
    carries ``dse_s`` and ``engine_stats``; strategy-specific keys include
    ``mode_rates`` (coschedule), ``per_flavor``
    (scope on a heterogeneous package), ``population`` (random) and
    ``seam_crossings`` (filled by validation).
    """
    problem: Problem
    strategy: str
    hw: HardwareModel
    schedule: ScopeSchedule | None = None
    multi: MultiModelSchedule | None = None
    llm: Any = None                  # LLMPlan (strategy "llm-phase")
    diagnostics: dict = field(default_factory=dict)

    # ----------------------------------------------------------- accessors
    @property
    def feasible(self) -> bool:
        if self.llm is not None:
            return self.llm.mix_rate > 0
        if self.schedule is not None:
            return self.schedule.latency < INF
        if self.multi is not None:
            return self.multi.weighted_throughput > 0
        return False

    @property
    def latency(self) -> float:
        """End-to-end batch latency (single-model solutions)."""
        if self.schedule is None:
            raise ValueError(f"strategy {self.strategy!r} has no single schedule")
        return self.schedule.latency

    @property
    def throughput(self) -> float:
        """Samples/s (single-model: m / latency; multi-model: weighted)."""
        if self.llm is not None:
            return self.llm.token_rate
        if self.schedule is not None:
            lat = self.schedule.latency
            m = self.diagnostics.get("m_samples",
                                     self.problem.options.m_samples)
            return 0.0 if (lat <= 0 or lat == INF) else m / lat
        if self.multi is not None:
            return self.multi.weighted_throughput
        return 0.0

    @property
    def weighted_throughput(self) -> float:
        if self.multi is not None:
            return self.multi.weighted_throughput
        return self.throughput

    @property
    def n_segments(self) -> int | None:
        return len(self.schedule.segments) if self.schedule else None

    # ---------------------------------------------------------- validation
    def validate(self) -> dict:
        """Run the schedule validators; returns (and stashes) the seam
        report (``{"seam_crossings": ...}``, see ``validate_schedule``)."""
        flavors = dict(package_flavors(self.hw))
        report: dict = {}
        if self.multi is not None:
            graphs = {m.name: m.graph for m in self.problem.workload.models}
            if self.multi.mode == "merged":
                mg, _ = merged_graph(list(self.problem.workload.models))
                graphs[mg.name] = mg
            # Merged sub-groups (partitioned mode, meta "merge_groups")
            # share one schedule over a group-merged graph: rebuild each
            # group's graph so its assignments validate against it.
            by_name = {m.name: m for m in self.problem.workload.models}
            for group in self.multi.meta.get("merge_groups", ()):
                mg, _ = merged_graph([by_name[n] for n in group])
                graphs[mg.name] = mg
            report = validate_multimodel(self.multi, graphs, flavors)
        elif (self.schedule is not None and self.schedule.latency < INF
              and self.schedule.segments):
            # (the sequential baseline is segment-free: nothing to validate)
            caps = flavors if self.hw.region_types else None
            report = validate_schedule(
                self.problem.workload.graph, self.schedule,
                self.schedule.chips, flavor_caps=caps,
            )
        if "seam_crossings" in report:
            self.diagnostics["seam_crossings"] = report["seam_crossings"]
        return report

    # ------------------------------------------------------------- runtime
    def verify_reference(self, rtol: float = 1e-9) -> float:
        """Re-evaluate the winning schedule(s) on a fresh reference
        :class:`CostModel` and assert engine parity; returns the reference
        latency (single-model) or 0.0 (nothing to check)."""
        opts = self.problem.options
        ref = CostModel(self.hw, m_samples=opts.m_samples,
                        distributed_weights=opts.distributed_weights)
        total = 0.0
        scheds = []
        if self.schedule is not None and self.schedule.latency < INF:
            scheds.append((self.problem.workload.graph, self.schedule))
        if self.multi is not None:
            graphs = {m.name: m.graph for m in self.problem.workload.models}
            if self.multi.mode == "merged":
                mg, _ = merged_graph(list(self.problem.workload.models))
                graphs[mg.name] = mg
            for a in self.multi.assignments:
                scheds.append((graphs[a.schedule.workload], a.schedule))
        for graph, sched in scheds:
            lat = sum(
                ref.segment_time(graph, seg.clusters)[0]
                for seg in sched.segments
            )
            assert abs(lat - sched.latency) <= rtol * max(lat, 1e-30), (
                "engine parity violated", sched.workload, lat, sched.latency,
            )
            total += lat
        return total

    # ---------------------------------------------------------- attribution
    def explain(self) -> dict:
        """Cost attribution for the solved deployment (Scope Lens).

        Decomposes every stage/quota the solver priced -- single-model
        segments, multimodel assignments (merged groups included), LLM
        prefill/decode phase quotas -- into the additive
        :data:`~repro_torch.core.costmodel.BREAKDOWN_COMPONENTS` (compute, NoP
        comm, seam crossing, DRAM weight load, input staging) with a
        bottleneck label per stage (compute- / link- / seam- / dram- /
        staging- / kv-bound).  The components of each stage sum
        *bit-identically* to the scalar the solver optimized
        (``schedule.latency`` per stage), on whichever engine the search
        used -- the conservation invariant the property tests assert.
        """
        opts = self.problem.options
        cost = replace(opts, cost=None).make_cost(self.hw)
        out: dict = {"strategy": self.strategy, "package": self.hw.name,
                     "chips": self.hw.chips, "stages": []}

        def stage_entry(label, graph, sched, *, chips, stage, model,
                        kv=None):
            seg_bds = []
            for seg in sched.segments:
                bd, per_cl = cost.segment_breakdown(graph, seg.clusters)
                seg_bds.append((bd, per_cl))
            total = sched.latency
            merged = CostBreakdown.merge([bd for bd, _ in seg_bds], total)
            bound = merged.bound
            if kv is not None and kv.get("kv_bound"):
                bound = "kv"
            entry = {
                "label": label, "model": model, "stage": stage,
                "chips": chips, "latency": total, "bound": bound,
                "breakdown": merged.to_json(),
                "conserved": merged.conserved,
                "segments": [
                    dict(bd.to_json(), clusters=[c.to_json() for c in cls_])
                    for bd, cls_ in seg_bds
                ],
            }
            if kv:
                entry["kv"] = kv
            out["stages"].append(entry)

        if self.llm is not None:
            from .core.workloads.lm import lm_graph

            plan = self.llm
            out["mode"] = plan.mode
            out["mix_rate"] = plan.mix_rate
            m = int(self.diagnostics.get("m_samples", opts.m_samples))
            for a in plan.assignments:
                gp = lm_graph(a.cfg, plan.seq_len)
                stage_entry(f"{a.model}/prefill", gp, a.prefill_schedule,
                            chips=a.prefill_chips, stage="prefill",
                            model=a.model)
                if a.decode_schedule is not None:
                    gd = lm_graph(a.cfg, plan.seq_len, decode=True)
                    kv = {
                        "kv_seq_bytes": a.kv_seq_bytes,
                        "kv_capacity_bytes": a.kv_capacity_bytes,
                        "max_seqs": a.max_seqs,
                        # the decode envelope flattened at the memory bound
                        # when the quota holds fewer sequences than the
                        # batch the compute bound would fill
                        "kv_bound": 0 <= a.max_seqs < m,
                    }
                    stage_entry(f"{a.model}/decode", gd, a.decode_schedule,
                                chips=a.decode_chips, stage="decode",
                                model=a.model, kv=kv)
        elif self.multi is not None:
            graphs = {mo.name: mo.graph for mo in self.problem.workload.models}
            if self.multi.mode == "merged":
                mg, _ = merged_graph(list(self.problem.workload.models))
                graphs[mg.name] = mg
            by_name = {mo.name: mo for mo in self.problem.workload.models}
            for group in self.multi.meta.get("merge_groups", ()):
                mg, _ = merged_graph([by_name[n] for n in group])
                graphs[mg.name] = mg
            out["mode"] = self.multi.mode
            for a in self.multi.assignments:
                quota = (dict(a.chip_quota) if a.chip_quota
                         else {a.chip_type: a.chips})
                stage_entry(a.model, graphs[a.schedule.workload], a.schedule,
                            chips=a.chips, stage="quota", model=a.model)
                out["stages"][-1]["quota"] = {str(k): v
                                              for k, v in quota.items()}
        elif self.schedule is not None and self.schedule.latency < INF:
            stage_entry(self.schedule.workload, self.problem.workload.graph,
                        self.schedule, chips=self.schedule.chips,
                        stage="schedule", model=self.schedule.workload)

        out["ranking"] = sorted(
            ({"label": s["label"], "bound": s["bound"],
              "latency": s["latency"]} for s in out["stages"]),
            key=lambda r: -r["latency"],
        )
        return out

    def deploy(
        self,
        cfgs=None,
        *,
        seq_len: int | None = None,
        global_batch: int = 8,
        mesh_axes: tuple[str, ...] = ("data", "model"),
        kind: str | None = None,
        step: int = 1,
        switch_cost: bool = False,
    ) -> "Deployment":
        """Bridge into the runtime: derive per-model ShardPlans.

        One config -> ``plan_for_cell``; N configs ->
        ``plan_for_multimodel`` (reusing this solution's co-schedule when
        its model names match, so solve-then-deploy never searches twice).
        ``cfgs``/``seq_len`` default to the ones the workload was built
        from (:meth:`WorkloadSpec.lm`).  ``kind`` defaults by workload
        phase: a decode-phase workload plans decode ShardPlans, anything
        else keeps the legacy ``"train"``.
        """
        from .runtime.planner import plan_for_cell, plan_for_multimodel

        if kind is None:
            kind = ("decode" if self.problem.workload.phase == "decode"
                    else "train")

        cfgs = tuple(cfgs) if cfgs is not None else self.problem.workload.cfgs
        if not cfgs:
            raise ValueError(
                "deploy needs ModelConfigs: pass cfgs= or build the workload "
                "with WorkloadSpec.lm(...)"
            )
        seq_len = seq_len or self.problem.workload.seq_len
        if seq_len is None:
            raise ValueError("deploy needs seq_len= (or WorkloadSpec.lm)")
        if len(cfgs) == 1:
            plan = plan_for_cell(
                cfgs[0], seq_len, global_batch, mesh_axes,
                model_axis=self.hw.chips, kind=kind,
            )
            return Deployment(cfgs=cfgs, plans={cfgs[0].name: plan},
                              multi=None, mesh_axes=mesh_axes)
        wl = self.problem.workload
        mm = self.multi
        # Only reuse the solved co-schedule when it was built from these
        # exact configs at this seq_len (lm-graph names embed both).  A
        # merged-mode schedule spans the *concatenated* graph and has no
        # per-model GSPMD execution path: let the planner re-search without
        # the merged family instead of deriving bogus per-model plans.
        if mm is not None and (
            mm.mode == "merged"
            or seq_len != wl.seq_len
            or len(wl.cfgs) != len(cfgs)
            or any(a.name != b.name for a, b in zip(wl.cfgs, cfgs))
        ):
            mm = None        # solution doesn't cover these configs: re-plan
        mm, plans = plan_for_multimodel(
            list(cfgs), seq_len, global_batch, mesh_axes,
            model_axis=self.hw.chips,
            weights=[m.weight for m in self.problem.workload.models],
            step=step, hw=self.hw, switch_cost=switch_cost, mm=mm,
        )
        return Deployment(cfgs=cfgs, plans=plans, multi=mm,
                          mesh_axes=mesh_axes)

    # -------------------------------------------------------------- serving
    def as_multimodel(self) -> MultiModelSchedule:
        """This solution as a co-schedule: ``multi`` when set, otherwise the
        single-model schedule wrapped as a one-assignment partitioned
        deployment (the serving executor's input shape)."""
        if self.multi is not None:
            return self.multi
        if self.schedule is None or not self.feasible:
            raise ValueError(f"[{self.strategy}] nothing deployable to serve")
        sched = self.schedule
        sched.meta.setdefault(
            "m_samples",
            self.diagnostics.get("m_samples", self.problem.options.m_samples),
        )
        # Concurrent per-flavor footprint: the max over segments (segments
        # run sequentially; clusters within one run concurrently).
        by_flavor: dict[str | None, int] = {}
        for seg in sched.segments:
            seg_use: dict[str | None, int] = {}
            for cl in seg.clusters:
                seg_use[cl.chip_type] = (
                    seg_use.get(cl.chip_type, 0) + cl.region_chips
                )
            for f, c in seg_use.items():
                by_flavor[f] = max(by_flavor.get(f, 0), c)
        order = [f for f, _ in package_flavors(self.hw)]
        quota = tuple(
            (f, by_flavor[f]) for f in order if by_flavor.get(f)
        )
        spec = self.problem.workload.models[0]
        a = ModelAssignment(
            model=sched.workload,
            weight=spec.weight,
            chips=sum(by_flavor.values()),
            schedule=sched,
            chip_type=quota[0][0] if len(quota) == 1 else None,
            chip_quota=quota if len(quota) > 1 else (),
        )
        lam = mix_rate((a,))
        return MultiModelSchedule(
            package=self.hw.name, chips=self.hw.chips, mode=MM_PARTITIONED,
            assignments=(a,), mix_rate=lam,
            weighted_throughput=lam * a.weight,
            meta={"wrapped_single_model": True},
        )

    def offered_traffic(
        self, rate_scale: float = 0.8, n_requests: int = 1000
    ) -> tuple[dict[str, float], float]:
        """The default offered load: per-model Poisson rates at
        ``rate_scale`` times the solved capacity (``mix_rate * weight``),
        with the horizon sized so ~``n_requests`` arrive.  Returns
        ``(traffic, horizon_s)`` -- the single source the CLI and the
        serving bench use to replay identical traces across deployments."""
        if self.llm is not None:
            traffic = {a.model: a.rate * rate_scale
                       for a in self.llm.assignments}
            total = sum(traffic.values())
            if total <= 0:
                raise ValueError(f"[{self.strategy}] zero solved capacity")
            return traffic, n_requests / total
        mm = self.as_multimodel()
        lam = mm.mix_rate * rate_scale
        traffic = {a.model: lam * a.weight for a in mm.assignments}
        total = sum(traffic.values())
        if total <= 0:
            raise ValueError(f"[{self.strategy}] zero solved capacity")
        return traffic, n_requests / total

    def serve(
        self,
        traffic=None,
        *,
        trace=None,
        n_requests: int = 1000,
        horizon_s: float | None = None,
        seed: int = 0,
        rate_scale: float = 0.8,
        max_batch: int | None = None,
        max_delay_s: float = 2e-3,
        max_queue: int | None = None,
        slos: dict[str, float] | None = None,
        autoscale=None,
        cache: "SolutionCache | None" = None,
        faults=None,
        fault_recovery: bool = True,
        measure: bool = False,
        device: str = "cuda",
        seq_len: int = 16,
        tracer=None,
        # token-level serving (strategy "llm-phase" solutions only)
        plan=None,
        static_batching: bool = False,
        queue_policy: str = "fifo",
        lengths=None,
        ttft_slo=None,
        tpot_slo=None,
    ):
        """Run this solution under synthetic traffic
        (:class:`repro_torch.serving.ServingExecutor`); returns a
        :class:`~repro_torch.serving.ServingReport`.

        ``traffic`` maps model -> arrival process (or requests/s); default
        is per-model Poisson at ``rate_scale`` times the solved capacity
        (``mix_rate * weight``), sized so ~``n_requests`` arrive.  Pass a
        pre-built ``trace`` to serve the exact same arrivals across
        deployments (the benchmark's like-for-like comparison).
        ``max_batch`` defaults to the DSE batch, which makes a saturated
        simulated server reproduce the DSE throughput figure exactly.

        ``autoscale`` (an :class:`~repro_torch.serving.AutoscalePolicy`, or
        ``True`` for defaults) turns on the online re-solve hook: observed
        mix drift re-plans through a shared :class:`SolutionCache`
        (``cache``), charging each redeploy as weight-reload dead time.
        ``measure=True`` calibrates service times from the real torch
        prefill steps (``deploy()`` + ``build_multimodel_steps`` on
        ``device``, the card unless ``device="cpu"``); every server then runs
        on its measured law: ``report.meta`` holds each server's law
        (``"service"``), where it came from (``"service_source"``:
        ``"measured"`` or ``"modeled"``) and the timed seconds per call at
        both batch sizes (``"measured_s"``).

        ``faults`` injects chip/zone/seam failures: a
        :class:`~repro_torch.serving.FaultInjector`, a list of
        :class:`~repro_torch.serving.FaultEvent`, or a scenario string for
        :func:`~repro_torch.serving.parse_faults` (``"zone:little@2:6"``).  With
        ``fault_recovery=True`` (the default) every failure and repair
        triggers a re-solve on the degraded package through the shared
        ``cache`` -- the dead-chip set is part of the problem fingerprint,
        so a repeat of the same failure is a whole-solution cache hit --
        and the executor swaps fleets charging redeploy dead time.
        ``fault_recovery=False`` runs the static-degraded baseline: down
        models just queue until their chips are repaired.

        ``tracer`` records the run on the Scope Observatory timeline
        (``trace=`` being taken by request traces): a
        :class:`~repro_torch.obs.Tracer`, ``True`` (fresh tracer, returned as
        ``report.tracer``), or a path string (Chrome trace-event JSON,
        Perfetto-loadable, written there).  Server lanes become trace
        threads with per-batch spans, queue depths become counter series,
        and fault / kill / re-solve / recovery events land as instants on
        the same timeline; mid-run re-solves (autoscale or fault recovery)
        add their solver spans too.
        """
        if self.llm is not None or plan is not None:
            return self._serve_llm(
                traffic, trace=trace, n_requests=n_requests,
                horizon_s=horizon_s, seed=seed, rate_scale=rate_scale,
                max_batch=max_batch, max_delay_s=max_delay_s,
                max_queue=max_queue, queue_policy=queue_policy,
                plan=plan, static_batching=static_batching, lengths=lengths,
                ttft_slo=ttft_slo, tpot_slo=tpot_slo, tracer=tracer,
            )
        from .serving import (
            AutoscalePolicy,
            Autoscaler,
            BatchingPolicy,
            ServingExecutor,
            measure_service_models,
            parse_faults,
            request_trace,
        )

        mm = self.as_multimodel()
        hw = self.hw
        weights = {a.model: a.weight for a in mm.assignments}

        obs_tracer, obs_path = None, None
        if tracer is not None and tracer is not False:
            if isinstance(tracer, Tracer):
                obs_tracer = tracer
            elif isinstance(tracer, str):
                obs_tracer, obs_path = Tracer(), tracer
            elif tracer is True:
                obs_tracer = Tracer()
            else:
                raise TypeError(
                    f"tracer= takes a Tracer, True, or a path; got {tracer!r}")
        if traffic is not None and trace is not None:
            raise ValueError("pass traffic= or trace=, not both")
        if trace is None:
            if traffic is None:
                traffic, default_horizon = self.offered_traffic(
                    rate_scale, n_requests)
                if horizon_s is None:
                    horizon_s = default_horizon
            if horizon_s is None:
                total_rate = sum(
                    (spec if isinstance(spec, (int, float))
                     else getattr(spec, "mean_rate", 0.0))
                    for spec in traffic.values()
                )
                if total_rate <= 0:
                    raise ValueError(
                        "cannot derive a horizon from rate-free traffic: "
                        "pass horizon_s="
                    )
                horizon_s = n_requests / total_rate
            trace = request_trace(traffic, horizon_s, seed=seed)
        elif horizon_s is None:
            horizon_s = trace[-1].t_arrive if trace else 0.0

        if max_batch is None:
            max_batch = max(
                1, int(self.diagnostics.get("m_samples",
                                            self.problem.options.m_samples))
            )
        batching = BatchingPolicy(max_batch=max_batch,
                                  max_delay_s=max_delay_s,
                                  max_queue_samples=max_queue)
        if slos is None:
            slos = {
                m.name: m.slo_s for m in self.problem.workload.models
                if getattr(m, "slo_s", None)
            }
        reload_s = {
            m.name: m.graph.total_weight_bytes / hw.dram_bw_total
            for m in self.problem.workload.models
        }

        fault_resolver = None
        if faults is not None:
            if isinstance(faults, str):
                faults = parse_faults(faults, hw, horizon_s)
            if fault_recovery:
                cache = cache or SolutionCache()
                # The degraded re-solve rebuilds this problem on the
                # surviving package.  flavor_caps are dropped (they were
                # budgeted against the pristine flavors) and any
                # caller-supplied engine is stripped so the solve takes the
                # cached path -- the degraded HardwareModel (dead_chips
                # included) is the fingerprint that separates intact from
                # degraded solutions.
                # (trace is stripped too: a path-valued trace option would
                # make every degraded re-solve overwrite the trace file;
                # re-solve spans reach the serve tracer via the ambient
                # tracer stack instead)
                # The running deployment warm-starts the degraded re-solve:
                # it narrows the search around the incumbent allocation, so
                # recovery planning is interactive rather than a cold DSE.
                fr_opts = replace(self.problem.options, cost=None,
                                  trace=None, warm_start=mm)
                if mm.mode != "time_mux":
                    # keep the recovery fleet in the deployment's latency
                    # class: a time-mux winner-by-rate would trade
                    # slice-period queueing waves against SLOs the
                    # continuously-serving deployment was sized for
                    fr_opts = replace(fr_opts, include_time_mux=False)
                fr_base = replace(self.problem, options=fr_opts)

                def fault_resolver(hw_now):
                    prob2 = replace(fr_base, package=PackageSpec(hw=hw_now))
                    sol2 = cache.solve(prob2)
                    mm2 = None
                    if sol2.feasible:
                        mm2 = (sol2.multi if sol2.multi is not None
                               else sol2.as_multimodel())
                    return mm2, {
                        "hw": hw_now.name,
                        "chips": hw_now.chips,
                        "dead_chips": len(hw_now.dead_chips),
                        "feasible": sol2.feasible,
                        "dse_s": sol2.diagnostics.get("dse_s"),
                        "cache_hit": cache.last_hit,
                        "solve_cache": dict(cache.stats),
                    }

        autoscaler = None
        if autoscale:
            if self.multi is None or len(mm.assignments) < 2:
                raise ValueError("autoscale needs a multi-model deployment")
            policy = (autoscale if isinstance(autoscale, AutoscalePolicy)
                      else AutoscalePolicy())
            cache = cache or SolutionCache()
            base = self.problem

            def resolve_fn(new_weights: dict[str, float], hw=None):
                models = tuple(
                    replace(m, weight=new_weights[m.name])
                    for m in base.workload.models
                )
                prob = replace(base,
                               workload=replace(base.workload, models=models))
                if hw is not None:
                    # mid-failure drift re-solve: plan on the surviving
                    # package (degraded fingerprints stay cache-isolated,
                    # and the fleet keeps its latency class, see the
                    # fault_resolver above)
                    opts = replace(prob.options, cost=None, trace=None,
                                   warm_start=mm)
                    if mm.mode != "time_mux":
                        opts = replace(opts, include_time_mux=False)
                    prob = replace(prob, package=PackageSpec(hw=hw),
                                   options=opts)
                else:
                    # the incumbent deployment warm-starts the drift
                    # re-solve (quota windows around its allocation)
                    prob = replace(prob, options=replace(
                        prob.options, trace=None, warm_start=mm))
                sol = cache.solve(prob)
                info = {
                    "dse_s": sol.diagnostics.get("dse_s"),
                    "cache_hit": cache.last_hit,
                    "engine_stats": sol.diagnostics.get("engine_stats", {}),
                    "solve_cache": dict(cache.stats),
                }
                return (sol.multi, info)

            autoscaler = Autoscaler(policy, resolve_fn, weights)

        service_override, measured_s = None, {}
        if measure:
            dep = self.deploy()
            by_cfg: dict = {}
            laws = measure_service_models(dep, seq_len=seq_len, device=device,
                                          timings=by_cfg)
            # the executor looks a server's law up by its assignment name,
            # the lm-graph name (cfg.name@prefill<seq_len>), not cfg.name
            wl = self.problem.workload
            names = {cfg.name: m.name for cfg, m in zip(wl.cfgs, wl.models)}
            service_override = {names[c]: law for c, law in laws.items()}
            measured_s = {names[c]: s for c, s in by_cfg.items()}

        ex = ServingExecutor(
            mm, hw, batching=batching, slos=slos, autoscaler=autoscaler,
            service_override=service_override, reload_s=reload_s, seed=seed,
            faults=faults, fault_resolver=fault_resolver, tracer=obs_tracer,
        )
        if obs_tracer is not None:
            # mid-run re-solves (autoscale drift, fault recovery) go through
            # solve(), which picks up the ambient tracer: their solver spans
            # land on the same timeline as the executor's sim events
            with use_tracer(obs_tracer):
                report = ex.run(trace, horizon_s=horizon_s)
        else:
            report = ex.run(trace, horizon_s=horizon_s)
        report.meta.update(
            strategy=self.strategy,
            solved_mix_rate=mm.mix_rate,
            solved_weighted_throughput=mm.weighted_throughput,
        )
        if service_override is not None:
            report.meta["service"] = {m: s.service
                                      for m, s in ex.servers.items()}
            report.meta["service_source"] = {
                m: ("measured" if s.service is service_override.get(m)
                    else "modeled")
                for m, s in ex.servers.items()
            }
            report.meta["measured_s"] = measured_s
        if obs_tracer is not None:
            report.tracer = obs_tracer
            if obs_path:
                obs_tracer.write(obs_path)
                report.meta["trace_path"] = obs_path
        return report

    def _serve_llm(
        self,
        traffic=None,
        *,
        trace=None,
        n_requests: int = 1000,
        horizon_s: float | None = None,
        seed: int = 0,
        rate_scale: float = 0.8,
        max_batch: int | None = None,
        max_delay_s: float = 2e-3,
        max_queue: int | None = None,
        queue_policy: str = "fifo",
        plan=None,
        static_batching: bool = False,
        lengths=None,
        ttft_slo=None,
        tpot_slo=None,
        tracer=None,
    ):
        """Token-level serving path of :meth:`serve` (``llm-phase``
        solutions): replay a token trace through the
        :class:`~repro_torch.serving.llm.TokenExecutor`.

        ``plan`` overrides the solved :class:`~repro_torch.serving.llm.LLMPlan`
        (e.g. to replay the losing deployment mode from
        ``diagnostics["plans"]`` on the identical trace);
        ``static_batching=True`` runs the whole-request baseline;
        ``lengths`` is a :class:`~repro_torch.serving.TokenLengths` (or per-model
        dict) for the prompt/output draws -- default matches the plan's
        searched ``seq_len`` / ``output_tokens``; ``ttft_slo`` / ``tpot_slo``
        are seconds (float for all models, or per-model dicts).  Returns an
        :class:`~repro_torch.serving.LLMReport`.
        """
        from .serving import BatchingPolicy, TokenLengths, request_trace
        from .serving.llm import TokenExecutor

        plan = plan if plan is not None else self.llm
        if plan is None:
            raise ValueError(
                f"[{self.strategy}] no LLMPlan to serve: solve with "
                "strategy='llm-phase' or pass plan="
            )
        hw = self.hw

        obs_tracer, obs_path = None, None
        if tracer is not None and tracer is not False:
            if isinstance(tracer, Tracer):
                obs_tracer = tracer
            elif isinstance(tracer, str):
                obs_tracer, obs_path = Tracer(), tracer
            elif tracer is True:
                obs_tracer = Tracer()
            else:
                raise TypeError(
                    f"tracer= takes a Tracer, True, or a path; got {tracer!r}")

        if traffic is not None and trace is not None:
            raise ValueError("pass traffic= or trace=, not both")
        if trace is None:
            if traffic is None:
                traffic, default_horizon = self.offered_traffic(
                    rate_scale, n_requests)
                if horizon_s is None:
                    horizon_s = default_horizon
            if horizon_s is None:
                total_rate = sum(
                    (spec if isinstance(spec, (int, float))
                     else getattr(spec, "mean_rate", 0.0))
                    for spec in traffic.values()
                )
                if total_rate <= 0:
                    raise ValueError(
                        "cannot derive a horizon from rate-free traffic: "
                        "pass horizon_s="
                    )
                horizon_s = n_requests / total_rate
            if lengths is None:
                lengths = TokenLengths(
                    prompt_mean=float(plan.seq_len),
                    output_mean=float(plan.output_tokens),
                )
            trace = request_trace(traffic, horizon_s, seed=seed,
                                  lengths=lengths)
        elif horizon_s is None:
            horizon_s = trace[-1].t_arrive if trace else 0.0

        if max_batch is None:
            max_batch = max(1, int(plan.meta.get(
                "m_samples", self.problem.options.m_samples)))
        batching = BatchingPolicy(max_batch=max_batch,
                                  max_delay_s=max_delay_s,
                                  max_queue_samples=max_queue,
                                  queue_policy=queue_policy)

        def _slo_for(spec, model):
            if isinstance(spec, dict):
                return spec.get(model)
            return spec

        slos = {
            a.model: (_slo_for(ttft_slo, a.model), _slo_for(tpot_slo, a.model))
            for a in plan.assignments
        }
        ex = TokenExecutor(plan, hw, batching=batching, slos=slos,
                           static=static_batching, seed=seed,
                           tracer=obs_tracer)
        if obs_tracer is not None:
            with use_tracer(obs_tracer):
                report = ex.run(trace, horizon_s=horizon_s)
        else:
            report = ex.run(trace, horizon_s=horizon_s)
        report.meta.update(
            strategy=self.strategy,
            solved_mix_rate=plan.mix_rate,
            solved_token_rate=plan.token_rate,
        )
        if obs_tracer is not None:
            report.tracer = obs_tracer
            if obs_path:
                obs_tracer.write(obs_path)
                report.meta["trace_path"] = obs_path
        return report

    # ------------------------------------------------------------- display
    def describe(self) -> list[str]:
        """Human-readable summary lines (CLI / examples)."""
        lines = []
        if self.llm is not None:
            from .serving.llm import describe_llm

            lines += describe_llm(self.llm)
        elif self.multi is not None:
            from .multimodel.coschedule import describe as _describe_mm

            lines += _describe_mm(self.multi)
        elif self.schedule is not None and self.feasible:
            s = self.schedule
            lines.append(
                f"{s.workload} on {self.hw.name}: latency {s.latency:.6g}s, "
                f"{self.throughput:.1f} samples/s, "
                f"{len(s.segments)} segment(s) [{self.strategy}]"
            )
            for i, seg in enumerate(s.segments):
                for cl in seg.clusters:
                    flavor = f" type={cl.chip_type}" if cl.chip_type else ""
                    kinds = "/".join(sorted(set(cl.partitions)))
                    lines.append(
                        f"  seg{i} layers[{cl.layer_lo}:{cl.layer_hi}] "
                        f"region={cl.region_chips}{flavor} P={kinds}"
                    )
        else:
            lines.append(f"[{self.strategy}] infeasible on {self.hw.name}")
        if "dse_s" in self.diagnostics:
            lines.append(f"  searched in {self.diagnostics['dse_s']:.2f}s; "
                         f"engine {self.diagnostics.get('engine_stats', {})}")
        return lines

    def to_json(self) -> dict:
        """JSON-serializable summary (the CLI's ``--json`` payload)."""
        out = {
            "strategy": self.strategy,
            "hw": self.hw.name,
            "chips": self.hw.chips,
            "feasible": self.feasible,
            "dse_s": self.diagnostics.get("dse_s"),
            "engine_stats": self.diagnostics.get("engine_stats", {}),
        }
        for key in ("seam_crossings", "mode_rates"):
            if key in self.diagnostics:
                out[key] = self.diagnostics[key]
        if self.schedule is not None:
            out.update(
                latency_s=self.schedule.latency,
                throughput=self.throughput,
                n_segments=self.n_segments,
                clusters_per_segment=[
                    s.n_clusters for s in self.schedule.segments
                ],
            )
        if self.multi is not None:
            out.update(
                mode=self.multi.mode,
                mix_rate=self.multi.mix_rate,
                weighted_throughput=self.multi.weighted_throughput,
                assignments=[
                    {
                        "model": a.model, "weight": a.weight,
                        "chips": a.chips, "chip_type": a.chip_type,
                        "chip_quota": [[t, c] for t, c in a.chip_quota],
                        "throughput": a.throughput,
                        "time_share": a.time_share,
                        "samples_per_beat": a.samples_per_beat,
                    }
                    for a in self.multi.assignments
                ],
            )
        if self.llm is not None:
            p = self.llm
            out.update(
                mode=p.mode,
                mix_rate=p.mix_rate,
                token_rate=p.token_rate,
                seq_len=p.seq_len,
                output_tokens=p.output_tokens,
                handoff_bw=p.handoff_bw,
                assignments=[
                    {
                        "model": a.model, "weight": a.weight,
                        "prefill_chips": a.prefill_chips,
                        "decode_chips": a.decode_chips,
                        "rate": a.rate,
                        "max_seqs": a.max_seqs,
                        "kv_seq_bytes": a.kv_seq_bytes,
                        "kv_capacity_bytes": a.kv_capacity_bytes,
                    }
                    for a in p.assignments
                ],
            )
        if "population" in self.diagnostics:
            pop = self.diagnostics["population"]
            out["samples"] = len(pop)
            out["best_sampled_s"] = min(pop) if pop else None
        return out


@dataclass
class Deployment:
    """Runtime-facing view of a solution: per-model ShardPlans.

    ``build_steps`` builds the torch serving steps on one device, or for
    the calling rank of ``mesh``
    (:func:`repro_torch.runtime.serve.build_multimodel_steps`).
    """
    cfgs: tuple
    plans: dict
    multi: MultiModelSchedule | None
    mesh_axes: tuple[str, ...]

    def plan(self, name: str):
        return self.plans[name]

    def build_steps(self, batch: int | None = None,
                    max_len: int | None = None, with_decode: bool = True,
                    device: str = "cuda", mesh=None):
        from .runtime.serve import build_multimodel_steps

        return build_multimodel_steps(
            list(self.cfgs), self.plans,
            batch=batch, max_len=max_len, with_decode=with_decode,
            device=device, mesh=mesh,
        )


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

_STRATEGIES: dict[str, Callable[[Problem, HardwareModel, CostModel], Solution]] = {}


def register_strategy(name: str):
    """Register ``fn(problem, hw, cost) -> Solution`` under ``name``."""
    def deco(fn):
        _STRATEGIES[name] = fn
        return fn
    return deco


def available_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def _lookup(name: str) -> tuple[str, Callable]:
    for cand in (name, name.replace("_", "-"), name.replace("-", "_")):
        if cand in _STRATEGIES:
            return cand, _STRATEGIES[cand]
    raise KeyError(
        f"unknown strategy {name!r}; available: {available_strategies()}"
    )


def _auto_strategy(prob: Problem, hw: HardwareModel) -> str:
    """1 model x 1 flavor -> scope; 1 model x N flavors -> scope-mixed;
    N models -> coschedule."""
    if prob.workload.n_models > 1:
        return "coschedule"
    if len(hw.region_types) > 1 and prob.options.mixed:
        return "scope-mixed"
    return "scope"


def _single_graph(prob: Problem, strategy: str) -> LayerGraph:
    if prob.workload.n_models != 1:
        raise ValueError(
            f"strategy {strategy!r} schedules a single model; this workload "
            f"has {prob.workload.n_models} (use strategy='coschedule')"
        )
    return prob.workload.graph


def _flavor_budgets(prob: Problem, hw: HardwareModel):
    if prob.package.flavor_caps is not None:
        return [list(t) for t in prob.package.flavor_caps]
    return None


def _warm_parts(o: SearchOptions):
    """Split ``options.warm_start`` into its (single-model, multi-model)
    incumbents: accepts a :class:`Solution` or a bare schedule of either
    kind; anything else warms nothing."""
    warm = o.warm_start
    if warm is None:
        return None, None
    if isinstance(warm, ScopeSchedule):
        return warm, None
    if isinstance(warm, MultiModelSchedule):
        return None, warm
    sched = getattr(warm, "schedule", None)
    multi = getattr(warm, "multi", None)
    return (sched if isinstance(sched, ScopeSchedule) else None,
            multi if isinstance(multi, MultiModelSchedule) else None)


def _warm_segment_counts(o: SearchOptions, g: LayerGraph,
                         hw: HardwareModel, chips: int):
    """Warm single-model sweep: restrict the segment-count sweep to within
    one of the incumbent schedule's count (the drifted problem's optimum is
    overwhelmingly at or adjacent to the incumbent's segmentation).  Returns
    None -- no restriction -- when there is no applicable warm start or the
    caller pinned ``segment_counts`` explicitly."""
    sched, _ = _warm_parts(o)
    if sched is None or o.segment_counts is not None:
        return None
    window = [
        s for s in candidate_segment_counts(g, hw, chips)
        if abs(s - sched.n_segments) <= 1
    ]
    return window or None


@register_strategy("scope")
def _solve_scope(prob: Problem, hw: HardwareModel, cost: CostModel) -> Solution:
    """Paper Algorithm 1 (``core.search.search``).  On a heterogeneous
    package: the best *single-flavor* schedule across flavors (pin one with
    ``options.chip_type``)."""
    g = _single_graph(prob, "scope")
    o = prob.options
    kw = dict(mode=o.region_mode, ep_for_moe=o.ep_for_moe,
              segment_counts=list(o.segment_counts) if o.segment_counts else None,
              max_clusters=o.max_clusters, paper_strict=o.paper_strict)
    diagnostics: dict = {}
    if not hw.region_types or o.chip_type is not None:
        chips = hw.chips if o.chip_type is None else hw.chip_type(o.chip_type).chips
        warm = _warm_segment_counts(o, g, hw, chips)
        if warm is not None:
            kw["segment_counts"] = warm
        sched = search(g, cost, chips, chip_type=o.chip_type, **kw)
    else:
        sched, per_flavor = None, {}
        budgets = _flavor_budgets(prob, hw) or package_flavors(hw)
        for ctype, cap in budgets:
            warm = _warm_segment_counts(o, g, hw, cap)
            if warm is not None:
                kw["segment_counts"] = warm
            s = search(g, cost, cap, chip_type=ctype, **kw)
            per_flavor[ctype] = s.latency if s is not None else INF
            if s is not None and (sched is None or s.latency < sched.latency):
                sched = s
        diagnostics["per_flavor"] = per_flavor
    return Solution(problem=prob, strategy="scope", hw=hw, schedule=sched,
                    diagnostics=diagnostics)


@register_strategy("scope-mixed")
def _solve_scope_mixed(prob: Problem, hw: HardwareModel,
                       cost: CostModel) -> Solution:
    """Mixed-flavor DSE (``core.search.search_mixed``): per-cluster chip
    flavors under per-flavor budgets; never worse than the best single
    flavor."""
    g = _single_graph(prob, "scope-mixed")
    o = prob.options
    counts = list(o.segment_counts) if o.segment_counts else None
    if counts is None:
        counts = _warm_segment_counts(o, g, hw, hw.chips)
    sched = search_mixed(
        g, cost, flavor_budgets=_flavor_budgets(prob, hw),
        mode=o.region_mode, ep_for_moe=o.ep_for_moe,
        segment_counts=counts,
        max_clusters=o.max_clusters, paper_strict=o.paper_strict,
        cut_window=o.cut_window,
    )
    return Solution(problem=prob, strategy="scope-mixed", hw=hw,
                    schedule=sched)


@register_strategy("coschedule")
def _solve_coschedule(prob: Problem, hw: HardwareModel,
                      cost: CostModel) -> Solution:
    """Multi-model co-scheduling (``multimodel.co_schedule``): best of
    partitioned / spanning / merged / time-mux for N >= 1 models."""
    o = prob.options
    _, warm_mm = _warm_parts(o)
    mm = co_schedule(
        list(prob.workload.models), hw, m_samples=o.m_samples, step=o.step,
        include_merged=o.include_merged, include_time_mux=o.include_time_mux,
        include_mixed=o.mixed, paper_strict=o.paper_strict, cost=cost,
        validate=False,                 # solve() validates and keeps the report
        curve_refine=o.refine, mixed_step=o.mixed_step,
        switch_cost=o.switch_cost, switch_period_s=o.switch_period_s,
        warm_start=warm_mm,
    )
    diagnostics: dict = {}
    if mm is not None:
        for key in ("mode_rates",):
            if key in mm.meta:
                diagnostics[key] = mm.meta[key]
    return Solution(problem=prob, strategy="coschedule", hw=hw, multi=mm,
                    diagnostics=diagnostics)


@register_strategy("sequential")
def _solve_sequential(prob, hw, cost) -> Solution:
    g = _single_graph(prob, "sequential")
    sched = schedule_sequential(g, cost, hw.chips)
    return Solution(problem=prob, strategy="sequential", hw=hw, schedule=sched)


@register_strategy("full_pipeline")
def _solve_full_pipeline(prob, hw, cost) -> Solution:
    g = _single_graph(prob, "full_pipeline")
    sched = schedule_full_pipeline(g, cost, hw.chips)
    return Solution(problem=prob, strategy="full_pipeline", hw=hw,
                    schedule=sched)


@register_strategy("segmented")
def _solve_segmented(prob, hw, cost) -> Solution:
    g = _single_graph(prob, "segmented")
    o = prob.options
    sched = schedule_segmented(
        g, cost, hw.chips,
        segment_counts=list(o.segment_counts) if o.segment_counts else None,
    )
    return Solution(problem=prob, strategy="segmented", hw=hw, schedule=sched)


@register_strategy("equal-split")
def _solve_equal_split(prob, hw, cost) -> Solution:
    mm = equal_split(list(prob.workload.models), cost)
    return Solution(problem=prob, strategy="equal-split", hw=hw, multi=mm)


@register_strategy("time-mux")
def _solve_time_mux(prob, hw, cost) -> Solution:
    o = prob.options
    mm = time_multiplexed(
        list(prob.workload.models), cost,
        switch_cost=o.switch_cost, switch_period_s=o.switch_period_s,
    )
    return Solution(problem=prob, strategy="time-mux", hw=hw, multi=mm)


@register_strategy("exhaustive")
def _solve_exhaustive(prob, hw, cost) -> Solution:
    """Brute force over one segment (``core.search.exhaustive_search``);
    tiny cases only -- the Fig. 8 optimality oracle."""
    g = _single_graph(prob, "exhaustive")
    lat, clustering, regions, partitions = next(
        exhaustive_search(cost, g, hw.chips)
    )
    sched = None
    if clustering is not None and lat < INF:
        clusters = build_clusters(0, clustering, partitions, list(regions))
        _, times = cost.segment_time(g, clusters)
        sched = ScopeSchedule(
            workload=g.name, chips=hw.chips,
            segments=(SegmentSchedule(clusters, lat, tuple(times)),),
            latency=lat, meta={"method": "exhaustive"},
        )
    return Solution(problem=prob, strategy="exhaustive", hw=hw,
                    schedule=sched)


@register_strategy("random")
def _solve_random(prob, hw, cost) -> Solution:
    """Uniform random sampling of the space (``core.search.random_search``);
    the population lands in ``diagnostics["population"]`` (Fig. 8
    histograms)."""
    g = _single_graph(prob, "random")
    o = prob.options
    pop = random_search(cost, g, hw.chips, samples=o.samples, seed=o.seed)
    return Solution(
        problem=prob, strategy="random", hw=hw,
        diagnostics={"population": pop,
                     "best_sampled_s": min(pop) if pop else INF},
    )


@register_strategy("llm-phase")
def _solve_llm_phase(prob: Problem, hw: HardwareModel,
                     cost: CostModel) -> Solution:
    """Token-level phase DSE (``serving.llm.solve_phases``): disaggregated
    vs colocated prefill/decode deployments over KV-bounded throughput
    curves.  Needs an LM workload (:meth:`WorkloadSpec.lm`): the decode
    graphs and KV footprints come from the attached ModelConfigs."""
    from .serving.llm import solve_phases

    wl = prob.workload
    if not wl.cfgs or wl.seq_len is None:
        raise ValueError(
            "strategy 'llm-phase' needs ModelConfigs: build the workload "
            "with WorkloadSpec.lm(...)"
        )
    o = prob.options
    plan, diag = solve_phases(
        list(wl.cfgs), [m.weight for m in wl.models], hw, cost,
        seq_len=wl.seq_len, output_tokens=o.output_tokens,
        mode=o.phase_mode, step=o.step, paper_strict=o.paper_strict,
        m_samples=o.m_samples,
    )
    return Solution(problem=prob, strategy="llm-phase", hw=hw, llm=plan,
                    diagnostics=diag)


# ---------------------------------------------------------------------------
# solve(): the front door
# ---------------------------------------------------------------------------

def solve(prob: Problem | None = None, *, workload=None, package=None,
          options: SearchOptions | None = None, **opts) -> Solution:
    """Solve a declarative Scope DSE problem.

    Either pass a :class:`Problem`, or the pieces::

        solve(problem("resnet50:2,alexnet:1", "mcm64", step=1))
        solve(workload="resnet50", package="mcm64_hetero", mode="uniform")

    Dispatches through the strategy registry (``options.strategy``;
    ``"auto"`` selects by problem shape), builds one shared evaluation
    engine for every sub-search, validates the result (seam accounting
    included) and stamps ``dse_s`` / ``engine_stats`` diagnostics.
    """
    if prob is None:
        if workload is None or package is None:
            raise ValueError("solve() needs a Problem or workload= + package=")
        prob = problem(workload, package, options=options, **opts)
    elif workload is not None or package is not None or options is not None or opts:
        raise ValueError("pass a Problem or loose pieces, not both")

    hw = prob.package.resolve()
    o = prob.options
    if o.cost is not None and o.cost.hw != hw:
        raise ValueError(
            f"options.cost was built for {o.cost.hw.name}, but this problem "
            f"resolves to {hw.name}: sharing the engine would evaluate "
            "against the wrong hardware"
        )
    cost = o.make_cost(hw)
    name = o.strategy
    if name in ("auto", "", None):
        name = _auto_strategy(prob, hw)
    name, fn = _lookup(name)

    tr, trace_path = _resolve_trace(o.trace)
    t0 = time.time()
    with use_tracer(tr):
        with tr.span(f"solve:{name}", strategy=name, hw=hw.name,
                     models=len(prob.workload.models)) as sp:
            sol = fn(prob, hw, cost)
            if sol.feasible and sol.schedule is not None:
                sp.set(latency=sol.schedule.latency)
    sol.strategy = name
    sol.diagnostics.setdefault("dse_s", time.time() - t0)
    sol.diagnostics.setdefault("m_samples", cost.m)
    sol.diagnostics.setdefault("engine_stats", dict(cost.stats))
    if tr:
        tr.metrics.counter("solve.calls").inc()
        tr.metrics.update_counters(sol.diagnostics["engine_stats"],
                                   prefix="engine.")
        if o.trace is not None:
            sol.diagnostics["trace"] = tr
        if trace_path:
            tr.write(trace_path)
    if o.validate and sol.feasible:
        sol.validate()
    return sol


def _resolve_trace(spec):
    """Map ``SearchOptions.trace`` to (tracer, output path).

    ``None``/falsy -> the ambient tracer (no-op unless a caller installed
    one via ``use_tracer``); a :class:`~repro_torch.obs.Tracer` -> itself; a path
    string -> fresh tracer written there after the solve; ``True`` -> fresh
    tracer attached to ``diagnostics["trace"]``.
    """
    if isinstance(spec, Tracer):
        return spec, None
    if isinstance(spec, str):
        return Tracer(), spec
    if spec:
        return Tracer(), None
    return current_tracer(), None


# ---------------------------------------------------------------------------
# solve_many / SolutionCache: repeated solves sharing one engine memo
# ---------------------------------------------------------------------------

def _hw_fingerprint(hw: HardwareModel) -> HardwareModel:
    # HardwareModel is a frozen dataclass of scalars and tuples: the value
    # itself is the key, so no perf field can be forgotten from a summary.
    return hw


def problem_fingerprint(prob: Problem, hw: HardwareModel | None = None) -> tuple:
    """Hashable identity of a Problem's *solution*: workload graphs (by
    name/size/volume), traffic weights, the resolved hardware (the full
    frozen HardwareModel), flavor caps, and every result-affecting
    SearchOptions field.  Two problems with equal fingerprints solve to
    the same Solution, so :class:`SolutionCache` may return the cached
    one.  ``trace`` never changes the answer and ``warm_start`` only
    narrows the search around an incumbent (a warm re-solve is treated as
    equivalent to the cold answer), so both are deliberately excluded --
    repeated re-solves of the same drifted mix stay whole-solution hits
    regardless of which incumbent seeded them."""
    if hw is None:
        hw = prob.package.resolve()
    wl = prob.workload
    models = tuple(
        (m.name, round(m.weight, 9), len(m.graph),
         round(m.graph.total_flops, 3),
         round(m.graph.total_weight_bytes, 3),
         getattr(m, "slo_s", None))
        for m in wl.models
    )
    o = prob.options
    opts = (
        o.strategy, o.region_mode.value, o.m_samples, o.paper_strict,
        o.ep_for_moe,
        tuple(o.segment_counts) if o.segment_counts else None,
        o.max_clusters, o.chip_type,
        o.step, o.mixed, o.mixed_step, o.refine, o.cut_window,
        o.include_merged, o.include_time_mux, o.switch_cost,
        o.switch_period_s, o.output_tokens, o.phase_mode,
        o.samples, o.seed, o.engine,
        o.distributed_weights,
    )
    caps = (tuple(tuple(c) for c in prob.package.flavor_caps)
            if prob.package.flavor_caps is not None else None)
    return (models, wl.seq_len, _hw_fingerprint(hw), caps, opts)


class SolutionCache:
    """Memoized :func:`solve`: one shared evaluation engine per (hardware,
    engine-options) pair across *all* solves, plus a whole-``Solution``
    cache keyed by :func:`problem_fingerprint`.

    This is the serving autoscaler's solver (repeated re-solves of similar
    mixes are near-free: the engine memo carries cluster costs across
    mixes, and a mix seen before is a solution hit) and the backing store
    of :func:`solve_many`.  ``stats`` records the hit rates.
    """

    def __init__(self):
        self._engines: dict[tuple, CostModel] = {}
        self._solutions: dict[tuple, Solution] = {}
        self.hits = 0
        self.misses = 0
        self.last_hit = False

    def engine_for(self, prob: Problem, hw: HardwareModel) -> CostModel:
        o = prob.options
        if o.cost is not None:
            return o.cost
        key = (_hw_fingerprint(hw), o.engine, o.m_samples,
               o.distributed_weights)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = o.make_cost(hw)
        return eng

    def solve(self, prob: Problem) -> Solution:
        if prob.options.cost is not None:
            # A caller-supplied engine is outside the declarative problem
            # identity the fingerprint captures: solve directly, uncached
            # (neither reusing nor poisoning default-engine entries).
            self.misses += 1
            self.last_hit = False
            return solve(prob)
        hw = prob.package.resolve()
        key = problem_fingerprint(prob, hw)
        sol = self._solutions.get(key)
        tr = current_tracer()
        if sol is not None:
            self.hits += 1
            self.last_hit = True
            tr.metrics.counter("solve_cache.hits").inc()
            tr.instant("solve-cache:hit", strategy=sol.strategy)
            return sol
        self.misses += 1
        self.last_hit = False
        tr.metrics.counter("solve_cache.misses").inc()
        cost = self.engine_for(prob, hw)
        tr.metrics.counter("solve_cache.engines").set(len(self._engines))
        sol = solve(replace(prob, options=replace(prob.options, cost=cost)))
        # Keep the caller's cost-free Problem as the solution's identity:
        # downstream re-solves derived from sol.problem (the autoscaler's
        # resolve_fn) must take the cached path, not the cost bypass above.
        sol.problem = prob
        sol.diagnostics["solve_cache"] = dict(self.stats)
        self._solutions[key] = sol
        return sol

    @property
    def stats(self) -> dict:
        return {
            "solution_hits": self.hits,
            "solution_misses": self.misses,
            "solutions": len(self._solutions),
            "engines": len(self._engines),
        }


def solve_many(
    problems, cache: SolutionCache | None = None
) -> list[Solution]:
    """Solve a batch of problems through one :class:`SolutionCache`: every
    sub-search of every problem shares one ``FastCostModel`` memo per
    hardware, and duplicate problems are whole-solution hits.  Each
    returned Solution's ``diagnostics["solve_cache"]`` snapshots the hit
    rates at its solve time."""
    cache = cache or SolutionCache()
    return [cache.solve(p) for p in problems]
