"""The port's copy of the multimodel co-scheduler and of
``plan_for_multimodel``, on the CPU against the JAX package.

``co_schedule`` and each of its modes on ``"resnet50:2,resnet18:1"`` must
give the same ``MultiModelSchedule`` (assignments, quotas, schedules, mix
rate, ``==`` throughputs); ``plan_for_multimodel`` the same ``ShardPlan``s,
``quota_chips`` and ``stage_chip_types`` on the smoke LM pair and on the
hetero 8-chip package of ``tests/test_api.py``'s ``lm_setup``.
"""
from dataclasses import replace

import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fastcost import FastCostModel as JaxFastCostModel
from repro.core.hw import ChipType as JaxChipType
from repro.core.hw import get_hw as jax_get_hw
from repro.core.hw import tpu_v5e as jax_tpu_v5e
from repro.multimodel import baselines as jax_mm_baselines
from repro.multimodel import co_schedule as jax_co_schedule
from repro.multimodel import curves as jax_curves
from repro.multimodel import interleave as jax_interleave
from repro.multimodel import parse_mix as jax_parse_mix
from repro.multimodel import quota as jax_quota
from repro.runtime.planner import check_stage_placement as jax_check_stage_placement
from repro.runtime.planner import plan_for_multimodel as jax_plan_for_multimodel
from repro_torch.configs import get_smoke_config
from repro_torch.core.fastcost import FastCostModel
from repro_torch.core.hw import ChipType, get_hw, tpu_v5e
from repro_torch.multimodel import baselines as mm_baselines
from repro_torch.multimodel import co_schedule
from repro_torch.multimodel import curves
from repro_torch.multimodel import interleave
from repro_torch.multimodel import parse_mix
from repro_torch.multimodel import quota
from repro_torch.runtime.planner import check_stage_placement, plan_for_multimodel
from torch_parity import canon

MIX = "resnet50:2,resnet18:1"
MESH = ("data", "model")


def _pair(hw_name, m_samples=16):
    return (FastCostModel(get_hw(hw_name), m_samples=m_samples),
            JaxFastCostModel(jax_get_hw(hw_name), m_samples=m_samples))


def _plans(plans):
    """Every field of every plan, meta included (no wall-clock field)."""
    return canon({name: p for name, p in plans.items()})


@pytest.mark.parametrize("hw_name", ["mcm16", "mcm16_hetero"])
def test_co_schedule_matches_reference(hw_name):
    """The whole co-scheduler (best of partitioned, merged, time-mux and, on
    the hetero package, spanning quotas)."""
    cost, jcost = _pair(hw_name)
    kw = dict(step=4, mixed_step=16) if hw_name.endswith("hetero") else {}
    got = co_schedule(parse_mix(MIX), cost.hw, cost=cost, **kw)
    want = jax_co_schedule(jax_parse_mix(MIX), jcost.hw, cost=jcost, **kw)
    assert got.mode == want.mode
    assert got.weighted_throughput == want.weighted_throughput
    assert canon(got) == canon(want)


def test_each_mode_matches_reference():
    """Partitioned quotas, the merged pipeline, time-mux (with and without
    its switch cost) and the equal split, each on its own,
    over curves built once by each package."""
    cost, jcost = _pair("mcm16")
    specs, jspecs = parse_mix(MIX), jax_parse_mix(MIX)
    cv = curves.build_curves(specs, cost, quota.package_flavors(cost.hw))
    jcv = jax_curves.build_curves(jspecs, jcost, jax_quota.package_flavors(jcost.hw))
    assert canon(cv) == canon(jcv)
    modes = [
        (lambda: quota.search_partitioned(specs, cost, curves=cv),
         lambda: jax_quota.search_partitioned(jspecs, jcost, curves=jcv), "partitioned"),
        (lambda: interleave.search_merged(specs, cost),
         lambda: jax_interleave.search_merged(jspecs, jcost), "merged"),
        (lambda: mm_baselines.time_multiplexed(specs, cost, curves=cv),
         lambda: jax_mm_baselines.time_multiplexed(jspecs, jcost, curves=jcv), "time_mux"),
        (lambda: mm_baselines.time_multiplexed(specs, cost, curves=cv, switch_cost=True),
         lambda: jax_mm_baselines.time_multiplexed(jspecs, jcost, curves=jcv,
                                                   switch_cost=True), "time_mux"),
        (lambda: mm_baselines.equal_split(specs, cost),
         lambda: jax_mm_baselines.equal_split(jspecs, jcost), None),
    ]
    for port_fn, ref_fn, mode in modes:
        got, want = port_fn(), ref_fn()
        assert want is not None
        if mode is not None:
            assert got.mode == want.mode == mode
        assert got.weighted_throughput == want.weighted_throughput
        assert canon(got) == canon(want)


def test_merged_groups_match_reference():
    """Merged groups need a third model (a group between all-merged and
    all-partitioned)."""
    mix = MIX + ",alexnet:1"
    cost, jcost = _pair("mcm16")
    got = interleave.search_merged_groups(parse_mix(mix), cost)
    want = jax_interleave.search_merged_groups(jax_parse_mix(mix), jcost)
    assert want is not None and want.meta["merge_groups"]
    assert canon(got) == canon(want)


def test_merged_graph_matches_reference():
    g, offsets = interleave.merged_graph(parse_mix(MIX))
    jg, joffsets = jax_interleave.merged_graph(jax_parse_mix(MIX))
    assert offsets == joffsets
    assert canon(g) == canon(jg)


def _lm_pair(names):
    return ([get_smoke_config(n) for n in names], [jax_smoke_config(n) for n in names])


def test_plan_for_multimodel_smoke_pair_matches_reference():
    """granite-3-8b + gemma2-9b (smoke) on an 8-chip v5e package, searched
    by each package (partitioned + time-mux), then derived from a given
    schedule."""
    cfgs, jcfgs = _lm_pair(["granite-3-8b", "gemma2-9b"])
    mm, plans = plan_for_multimodel(cfgs, 64, 8, MESH, model_axis=8, weights=[1.0, 2.0])
    jmm, jplans = jax_plan_for_multimodel(jcfgs, 64, 8, MESH, model_axis=8, weights=[1.0, 2.0])
    assert canon(mm) == canon(jmm)
    assert _plans(plans) == _plans(jplans)
    assert [p.meta["quota_chips"] for p in plans.values()] == [
        p.meta["quota_chips"] for p in jplans.values()]
    mm2, plans2 = plan_for_multimodel(cfgs, 64, 8, MESH, model_axis=8, weights=[1.0, 2.0],
                                      mm=mm)
    assert mm2 is mm and _plans(plans2) == _plans(plans)


@pytest.fixture(scope="module")
def lm_setup():
    """tests/test_api.py's ``lm_setup``, built by each package."""
    def hetero(tpu, chip_type):
        return replace(tpu(8, (1, 8)), name="tpu_v5e_8_hetero", region_types=(
            chip_type("big", 4),
            chip_type("little", 4, flops_scale=0.5, nop_bw_scale=0.75)))

    cfgs, jcfgs = _lm_pair(["granite-3-8b", "granite-20b"])
    return cfgs, jcfgs, hetero(tpu_v5e, ChipType), hetero(jax_tpu_v5e, JaxChipType)


def test_plan_for_multimodel_hetero_matches_reference(lm_setup):
    cfgs, jcfgs, hw, jhw = lm_setup
    mm, plans = plan_for_multimodel(cfgs, 64, 8, MESH, model_axis=8, weights=[2.0, 1.0], hw=hw)
    jmm, jplans = jax_plan_for_multimodel(jcfgs, 64, 8, MESH, model_axis=8,
                                          weights=[2.0, 1.0], hw=jhw)
    assert canon(mm) == canon(jmm)
    assert _plans(plans) == _plans(jplans)
    for name, plan in plans.items():
        jplan = jplans[name]
        assert plan.meta["quota_chips"] == jplan.meta["quota_chips"]
        assert plan.stage_chip_types == jplan.stage_chip_types
        assert canon(check_stage_placement(plan.stage_chip_types, hw)) == canon(
            jax_check_stage_placement(jplan.stage_chip_types, jhw))
