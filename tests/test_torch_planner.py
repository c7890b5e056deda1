"""The port's DSE branch of ``plan_for_cell`` and the cost model behind it,
on the CPU against the JAX package.

The layer graphs must agree node for node, and the plans exactly: the same
WSP->ISP transition, the same ``transition_repeat`` and a bit-equal
predicted latency (``inf`` where the weights do not fit), for every arch at
``model_axis`` 1 and 16.  Both price the sweep with the same TPU v5e
constants, as the reference hard-codes them.
"""
import dataclasses
import math

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.workloads.lm import lm_graph as jax_lm_graph
from repro.runtime.planner import plan_for_cell as jax_plan_for_cell
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core import CostModel, FastCostModel, tpu_v5e
from repro_torch.core.graph import PARTITION_ISP, PARTITION_WSP
from repro_torch.core.workloads.lm import lm_graph
from repro_torch.runtime.planner import plan_for_cell

MESH = ("data", "model")


def _node_fields(node):
    return tuple((f.name, getattr(node, f.name)) for f in dataclasses.fields(node))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_graph_matches_reference_node_for_node(arch, decode, smoke):
    """Names, kinds, FLOPs, bytes, halos and the WSP/ISP parallel extents of
    every node, at S = 2048."""
    cfg, jcfg = ((get_smoke_config(arch), jax_smoke_config(arch)) if smoke
                 else (get_config(arch), jax_get_config(arch)))
    g, jg = lm_graph(cfg, 2048, decode=decode), jax_lm_graph(jcfg, 2048, decode=decode)
    assert g.name == jg.name and len(g) == len(jg)
    for node, jnode in zip(g.layers, jg.layers):
        assert _node_fields(node) == _node_fields(jnode)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("model_axis", [1, 16])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_plan_for_cell_dse_matches_reference(arch, model_axis, kind):
    """The same plan as the JAX planner, with a bit-equal predicted latency
    (``inf`` and WSP/WSP where nothing fits one chip, as for jamba and
    gemma2-9b at model_axis 1)."""
    plan = plan_for_cell(get_config(arch), 2048, 8, MESH, model_axis, kind=kind)
    ref = jax_plan_for_cell(jax_get_config(arch), 2048, 8, MESH, model_axis, kind=kind)
    assert (plan.p1, plan.p2, plan.transition_repeat) == (ref.p1, ref.p2, ref.transition_repeat)
    assert plan.mesh_axes == ref.mesh_axes == MESH
    for key in ("kind", "dse", "t_layers"):
        assert plan.meta[key] == ref.meta[key]
    lat, ref_lat = plan.meta["latency"], ref.meta["latency"]
    assert lat == ref_lat or (math.isinf(lat) and math.isinf(ref_lat))
    assert math.isfinite(plan.meta["dse_s"]) and plan.meta["dse_s"] >= 0


@pytest.mark.parametrize("arch,model_axis", [("jamba-v0.1-52b", 1), ("gemma2-9b", 1)])
def test_plan_for_cell_infeasible_on_one_chip(arch, model_axis):
    """Weights that do not fit one v5e chip: every transition is infinite,
    and the plan keeps the default (all layers before the transition)."""
    plan = plan_for_cell(get_config(arch), 2048, 8, MESH, model_axis, kind="prefill")
    assert math.isinf(plan.meta["latency"]) and (plan.p1, plan.p2) == ("WSP", "WSP")


def test_plan_for_cell_smoke_config_matches_reference():
    plan = plan_for_cell(get_smoke_config("granite-3-8b"), 32, 2, MESH, 1, kind="prefill")
    ref = jax_plan_for_cell(jax_smoke_config("granite-3-8b"), 32, 2, MESH, 1, kind="prefill")
    assert (plan.p1, plan.p2, plan.transition_repeat, plan.meta["t_layers"],
            plan.meta["latency"]) == (ref.p1, ref.p2, ref.transition_repeat,
                                      ref.meta["t_layers"], ref.meta["latency"])


@pytest.mark.parametrize("arch,model_axis", [("granite-3-8b", 16), ("granite-20b", 16),
                                             ("rwkv6-3b", 4), ("jamba-v0.1-52b", 1)])
def test_fastcost_sweep_matches_costmodel(arch, model_axis):
    """The port's FastCostModel sweep against its own reference CostModel on
    a few WSP^k ISP^(L-k) partitions, within the engines' 1e-9 contract."""
    graph = lm_graph(get_config(arch), 2048)
    L = len(graph)
    hw = tpu_v5e(model_axis, (1, model_axis))
    fast = FastCostModel(hw, m_samples=8, distributed_weights=True)
    slow = CostModel(hw, m_samples=8, distributed_weights=True)
    fast_sweep = fast.segment_sweeper(graph, 0, ((0, L),))
    slow_sweep = slow.segment_sweeper(graph, 0, ((0, L),))
    for idx in (0, 1, L // 3, L // 2, L - 1, L):
        parts = tuple([PARTITION_WSP] * idx + [PARTITION_ISP] * (L - idx))
        got, _ = fast_sweep(parts, transition=(idx, False))([model_axis])
        want, _ = slow_sweep(parts, transition=(idx, False))([model_axis])
        assert got == pytest.approx(want, rel=1e-9) or (math.isinf(got) and math.isinf(want))


def test_fastcost_jit_tier_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        FastCostModel(tpu_v5e(16, (1, 16)), use_jit=True)
