"""DSE -> runtime bridge: pick the Scope plan for an (arch x shape x mesh)
(port of ``repro/runtime/planner.py``).

For the non-pipelined production meshes the ``model`` axis is one Scope
*region*; the searched knob is the paper's WSP->ISP transition point, which
maps onto the scanned layer stack as ``transition_repeat`` (two scan zones).
The search evaluates the paper's cost model (Eq. 1-7, Table II volumes) with
TPU v5e constants over the arch's exported layer graph, as the reference
hard-codes them, so both packages pick the same plan for the same cell.

``plan_for_multimodel`` needs the multimodel quota search, which is not
copied yet (ROADMAP A5).
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
