"""DSE -> runtime bridge: pick the Scope plan for an (arch x shape x mesh)
(port of ``repro/runtime/planner.py``).

For the non-pipelined production meshes the ``model`` axis is one Scope
*region*; the searched knob is the paper's WSP->ISP transition point, which
maps onto the scanned layer stack as ``transition_repeat`` (two scan zones).
The search evaluates the paper's cost model (Eq. 1-7, Table II volumes) with
TPU v5e constants over the arch's exported layer graph, as the reference
hard-codes them, so both packages pick the same plan for the same cell.
``plan_for_multimodel`` co-schedules several configs on that package (default
``tpu_v5e(model_axis, (1, model_axis))``, as the reference).
"""
from __future__ import annotations

import time

from ..core.costmodel import INF
from ..core.fastcost import FastCostModel
from ..core.graph import PARTITION_ISP, PARTITION_WSP
from ..core.hw import tpu_v5e
from ..core.workloads.lm import lm_graph
from ..models.config import ModelConfig
from .sharding import ShardPlan


def plan_for_cell(
    cfg: ModelConfig,
    seq_len: int,
    global_batch: int,
    mesh_axes: tuple[str, ...],
    model_axis: int = 16,
    kind: str = "train",
    use_dse: bool = True,
) -> ShardPlan:
    if kind == "decode":
        # single-token steps have no sequence to split: pure ISP
        return ShardPlan(mesh_axes=mesh_axes, p1="ISP", p2="ISP",
                         transition_repeat=None,
                         meta={"kind": kind, "dse": False})
    if not use_dse:
        return ShardPlan(mesh_axes=mesh_axes, p1="ISP", p2="ISP",
                         transition_repeat=None, meta={"kind": kind, "dse": False})

    graph = lm_graph(cfg, seq_len, decode=False)
    L = len(graph)
    hw = tpu_v5e(model_axis, (1, model_axis))
    cost = FastCostModel(hw, m_samples=max(2, global_batch), distributed_weights=True)
    clustering = ((0, L),)          # the model axis is one region
    best = (INF, L)                 # default: all ISP
    t0 = time.time()
    sweeper = cost.segment_sweeper(graph, 0, clustering)
    for idx in range(L + 1):
        partitions = tuple(
            [PARTITION_WSP] * idx + [PARTITION_ISP] * (L - idx)
        )
        eval_fn = sweeper(partitions, transition=(idx, False))
        lat, _ = eval_fn([model_axis])
        if lat < best[0]:
            best = (lat, idx)
    dse_s = time.time() - t0
    t_layers = best[1]
    meta = {"kind": kind, "dse": True, "t_layers": t_layers,
            "latency": best[0], "dse_s": dse_s,
            "dse_engine": cost.stats}
    return _plan_from_transition(cfg, mesh_axes, t_layers, L, meta)


def _plan_from_transition(
    cfg: ModelConfig,
    mesh_axes: tuple[str, ...],
    t_layers: int,
    L: int,
    meta: dict,
    stage_chip_types: tuple = (),
) -> ShardPlan:
    """Map a WSP->ISP layer transition index onto the scanned layer stack.

    Graph layout: [embed] + per-block nodes + [lm_head]; the transition maps
    onto the repeat axis of the stack as ``transition_repeat`` (two zones).
    ``stage_chip_types`` carries the schedule's per-stage chip flavors into
    the plan (mixed-flavor packages).
    """
    per_block = (L - 2) / max(1, cfg.n_layers)
    layers_per_repeat = per_block * len(cfg.expanded_pattern)
    t_rep = round(max(0.0, (t_layers - 1)) / max(1e-9, layers_per_repeat))
    t_rep = min(max(t_rep, 0), cfg.pattern_repeats)
    if t_rep == 0:
        return ShardPlan(mesh_axes=mesh_axes, p1="ISP", p2="ISP",
                         transition_repeat=None,
                         stage_chip_types=stage_chip_types, meta=meta)
    if t_rep == cfg.pattern_repeats:
        return ShardPlan(mesh_axes=mesh_axes, p1="WSP", p2="WSP",
                         transition_repeat=None,
                         stage_chip_types=stage_chip_types, meta=meta)
    return ShardPlan(
        mesh_axes=mesh_axes, p1="WSP", p2="ISP", transition_repeat=t_rep,
        stage_chip_types=stage_chip_types, meta=meta,
    )


def schedule_stages(schedule) -> tuple[tuple[int, int, str | None, int], ...]:
    """Flatten a ScopeSchedule into per-stage ``(layer_lo, layer_hi,
    chip_type, region_chips)`` tuples -- the runtime's view of which chip
    flavor serves which layer range."""
    return tuple(
        (cl.layer_lo, cl.layer_hi, cl.chip_type, cl.region_chips)
        for seg in schedule.segments
        for cl in seg.clusters
    )


def check_stage_placement(
    stage_chip_types: tuple[tuple[int, int, str | None, int], ...],
    hw,
) -> list[list[tuple[int, int]]]:
    """Tie a plan's per-stage chip flavors to mesh coordinates.

    Places each stage's region inside its flavor's physical zone of the
    package mesh (flavor-aware :func:`~repro_torch.core.regions.zigzag_placement`)
    and returns the per-stage coordinate lists.  Raises ``ValueError`` when
    the plan's flavor runs straddle the seam non-contiguously (a flavor
    appearing in two separate runs would tear its zone apart) or overflow a
    flavor's chips -- the placement-level completion of the
    ``validate_schedule`` seam accounting.
    """
    from ..core.regions import zigzag_placement
    from ..multimodel.quota import package_flavors

    if not stage_chip_types:
        return []
    return zigzag_placement(
        [chips for _, _, _, chips in stage_chip_types],
        hw.mesh_shape,
        region_flavors=[ctype for _, _, ctype, _ in stage_chip_types],
        flavor_counts=package_flavors(hw),
        dead=getattr(hw, "dead_chips", ()),
    )


def plan_for_multimodel(
    cfgs: list[ModelConfig],
    seq_len: int,
    global_batch: int,
    mesh_axes: tuple[str, ...],
    model_axis: int = 16,
    weights: list[float] | None = None,
    step: int = 1,
    hw=None,
    switch_cost: bool = False,
    mm=None,
):
    """Co-schedule several LM configs onto one model axis.

    Runs the multimodel quota search (``repro_torch.multimodel.co_schedule``) over
    the configs' exported layer graphs on a ``model_axis``-chip package, then
    derives each model's ShardPlan from its Scope schedule: the plan's
    WSP->ISP transition is the schedule's first transition point,
    ``meta["quota_chips"]`` is the model-axis share the co-schedule assigned
    (the serving path runs each model on that sub-axis, or time-multiplexes
    when the co-schedule says so), and ``plan.stage_chip_types`` records
    which chip flavor serves each pipeline stage -- on a heterogeneous
    package (pass ``hw``) one model's stages may span flavors, and
    ``meta["chip_quota"]`` itemizes the per-flavor chips.

    ``mm`` skips the search and derives the plans from an already-solved
    :class:`~repro_torch.core.graph.MultiModelSchedule` (the facade's
    ``Solution.deploy`` passes its own result through, so solve-then-deploy
    never searches twice); it must cover every config by name.

    Returns ``(MultiModelSchedule, {cfg.name: ShardPlan})``.
    """
    from ..multimodel import ModelSpec, co_schedule

    names = [cfg.name for cfg in cfgs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate config names in co-schedule: {names}")
    weights = weights or [1.0] * len(cfgs)
    if len(weights) != len(cfgs):
        raise ValueError(
            f"{len(weights)} weights for {len(cfgs)} configs"
        )
    graphs = [lm_graph(cfg, seq_len, decode=False) for cfg in cfgs]
    # LayerGraph names default to the arch name; keep them aligned to cfgs.
    specs = [ModelSpec(g, w) for g, w in zip(graphs, weights)]
    if hw is None:
        hw = tpu_v5e(model_axis, (1, model_axis))
    elif hw.chips != model_axis:
        raise ValueError(f"hw has {hw.chips} chips != model_axis {model_axis}")
    if mm is None:
        cost = FastCostModel(hw, m_samples=max(2, global_batch),
                             distributed_weights=True)
        # Merged interleaving has no GSPMD execution path (one jitted fn
        # serves one config), so the runtime bridge searches partitioned +
        # time-mux.
        mm = co_schedule(specs, hw, m_samples=max(2, global_batch), step=step,
                         include_merged=False, cost=cost,
                         switch_cost=switch_cost)
    if mm is None:
        return None, {}
    if hw.region_types:
        # Placement-level seam check: every assignment's stage flavors must
        # map onto contiguous zone coordinates (per segment).
        from ..core.regions import check_assignments_placement
        from ..multimodel.quota import package_flavors

        check_assignments_placement(mm.assignments, hw.mesh_shape,
                                    package_flavors(hw),
                                    dead=hw.dead_chips)
    plans: dict[str, ShardPlan] = {}
    for cfg, graph, spec in zip(cfgs, graphs, specs):
        a = mm.assignment(spec.name)
        flat = a.schedule.layer_partition()
        L = len(graph)
        t_layers = next(
            (i for i, (_, p, _) in enumerate(flat) if p != PARTITION_WSP), L
        )
        meta = {
            "kind": "serve", "dse": True, "t_layers": t_layers,
            "latency": a.schedule.latency,
            "quota_chips": a.chips,
            "co_mode": mm.mode,
            "time_share": a.time_share,
        }
        if a.chip_type:
            meta["chip_type"] = a.chip_type
        if a.chip_quota:
            meta["chip_quota"] = [[t, c] for t, c in a.chip_quota]
        plans[cfg.name] = _plan_from_transition(
            cfg, mesh_axes, t_layers, L, meta,
            stage_chip_types=schedule_stages(a.schedule),
        )
    return mm, plans
