"""The port's facade (``repro_torch.scope``), on the CPU against the JAX
package's (``repro.scope``).

One solve per registered strategy must give the same ``to_json()`` (the
CLI's payload), diagnostics, ``validate()`` and ``explain()``, with every
wall-clock field left out; ``deploy`` must reuse a solved co-schedule and
re-plan a merged one exactly as the reference does; ``SolutionCache`` and
``solve_many`` must count the same hits.  The full-size problem that
``chip_smoke.py`` phase 14 drives on the card is solved and deployed here by
both packages, and its plans are pinned to the ones that phase checks.
"""
import importlib.util
import pathlib
from dataclasses import replace

import pytest

from repro import scope as jax_scope
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.graph import chain as jax_chain
from repro.core.hw import ChipType as JaxChipType
from repro.core.hw import mcm_table_iii as jax_mcm
from repro.core.hw import tpu_v5e as jax_tpu_v5e
from repro.core.workloads import get_cnn as jax_get_cnn
from repro_torch import scope
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.graph import chain
from repro_torch.core.hw import ChipType, mcm_table_iii, tpu_v5e
from repro_torch.core.workloads import get_cnn
from torch_parity import canon

REPO = pathlib.Path(__file__).resolve().parents[1]


class Side:
    """One package's names, so one function builds the same problem in both."""

    def __init__(self, port):
        self.scope = scope if port else jax_scope
        self.smoke = get_smoke_config if port else jax_smoke_config
        self.config = get_config if port else jax_get_config
        self.chain, self.cnn = (chain, get_cnn) if port else (jax_chain, jax_get_cnn)
        self.mcm = mcm_table_iii if port else jax_mcm
        self.tpu, self.chip_type = (tpu_v5e, ChipType) if port else (jax_tpu_v5e, JaxChipType)


PORT, REF = Side(True), Side(False)


def _problem(side, strategy):
    s = side.scope
    if strategy == "llm-phase":
        cfgs = [side.smoke("granite-3-8b"), side.smoke("gemma2-9b")]
        return s.problem(s.WorkloadSpec.lm(cfgs, 64, [1, 2]), "mcm16", strategy=strategy)
    if strategy in ("coschedule", "equal-split", "time-mux"):
        return s.problem("resnet50:2,resnet18:1", "mcm16", strategy=strategy)
    if strategy == "scope-mixed":
        return s.problem("resnet18", "mcm16_hetero", strategy=strategy)
    if strategy in ("exhaustive", "random"):
        g = side.chain("alexnet[:4]", side.cnn("alexnet").layers[:4])
        return s.problem(s.WorkloadSpec.graphs([g]), side.mcm(16).with_chips(6),
                         strategy=strategy, samples=200, seed=3)
    return s.problem("alexnet", "mcm16", strategy=strategy)


def test_available_strategies_match_reference():
    assert scope.available_strategies() == jax_scope.available_strategies()


@pytest.mark.parametrize("strategy", jax_scope.available_strategies())
def test_solve_per_strategy_matches_reference(strategy):
    got = scope.solve(_problem(PORT, strategy))
    want = jax_scope.solve(_problem(REF, strategy))
    assert got.strategy == want.strategy == strategy
    # "random" returns its sampled population, not a schedule
    assert got.feasible == want.feasible == (strategy != "random")
    if strategy == "random":
        assert got.diagnostics["population"] == want.diagnostics["population"] != []
    assert canon(got.to_json()) == canon(want.to_json())
    assert canon(got.diagnostics) == canon(want.diagnostics)
    assert canon(got.validate()) == canon(want.validate())
    assert canon(got.explain()) == canon(want.explain())
    if want.schedule is not None:
        assert got.latency == want.latency


def test_jit_engine_is_not_ported():
    with pytest.raises(NotImplementedError, match="A15"):
        scope.solve(scope.problem("alexnet", "mcm16", engine="jit"))


# ------------------------------------------------------------ deployment

def _lm_setup(side):
    """tests/test_api.py's ``lm_setup``: two smoke configs on an 8-chip
    big/little v5e package."""
    cfgs = (side.smoke("granite-3-8b"), side.smoke("granite-20b"))
    hw = replace(side.tpu(8, (1, 8)), name="tpu_v5e_8_hetero", region_types=(
        side.chip_type("big", 4),
        side.chip_type("little", 4, flops_scale=0.5, nop_bw_scale=0.75)))
    return cfgs, hw


def _deploy_roundtrip(side):
    cfgs, hw = _lm_setup(side)
    s = side.scope
    wl = s.WorkloadSpec.lm(cfgs, seq_len=64, weights=[2.0, 1.0])
    sol = s.solve(s.problem(wl, hw, m_samples=8, include_merged=False))
    dep = sol.deploy(global_batch=8, mesh_axes=("data", "model"))
    return sol, dep


def test_deploy_reuses_the_solved_co_schedule_as_reference():
    sol, dep = _deploy_roundtrip(PORT)
    jsol, jdep = _deploy_roundtrip(REF)
    assert sol.strategy == "coschedule" and sol.feasible
    assert dep.multi is sol.multi and jdep.multi is jsol.multi     # no second search
    assert canon(dep.plans) == canon(jdep.plans)
    assert dep.mesh_axes == jdep.mesh_axes and [c.name for c in dep.cfgs] == [
        c.name for c in jdep.cfgs]


def test_deploy_replans_a_merged_schedule_as_reference():
    """A merged co-schedule has no per-model execution path: deploy
    re-searches without the merged family, in both packages alike."""
    out = []
    for side in (PORT, REF):
        sol, _ = _deploy_roundtrip(side)
        sol.multi = replace(sol.multi, mode="merged")
        dep = sol.deploy(global_batch=8)
        assert dep.multi is not sol.multi and dep.multi.mode != "merged"
        out.append((canon(dep.multi), canon(dep.plans)))
    assert out[0] == out[1]


def test_single_cfg_deploy_uses_plan_for_cell_as_reference():
    out = []
    for side in (PORT, REF):
        s = side.scope
        cfgs, _ = _lm_setup(side)
        sol = s.solve(s.problem(s.WorkloadSpec.lm(cfgs[:1], seq_len=64),
                                side.tpu(8, (1, 8)), m_samples=8))
        dep = sol.deploy(global_batch=8)
        plan = dep.plans[cfgs[0].name]
        assert plan.meta["kind"] == "train" and plan.meta["dse"] is True
        out.append(canon(dep.plans))
    assert out[0] == out[1]


def test_deploy_without_cfgs_raises():
    sol = scope.solve(workload="alexnet", package="mcm16")
    with pytest.raises(ValueError, match="ModelConfigs"):
        sol.deploy(global_batch=8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _facade_run(side):
    s = side.scope
    cfgs = [side.config(name) for name in ("granite-3-8b", "gemma2-9b")]
    sol = s.solve(s.problem(s.WorkloadSpec.lm(cfgs, seq_len=2048, weights=[1.0, 2.0]),
                            side.tpu(16, (1, 16))))
    return sol, sol.deploy(global_batch=4)


def test_full_size_facade_problem_matches_reference_and_chip_smoke():
    """granite-3-8b + gemma2-9b at full size, S=2048, weights 1:2 on
    ``tpu_v5e(16, (1, 16))``: the solve of ``chip_smoke.py`` phase 14.  It
    is the merged co-schedule, and deploy re-plans it partitioned; both
    packages agree, and the plans are the ones phase 14 requires on the
    card."""
    sol, dep = _facade_run(PORT)
    jsol, jdep = _facade_run(REF)
    assert canon(sol.to_json()) == canon(jsol.to_json())
    assert canon(dep.multi) == canon(jdep.multi)
    assert canon(dep.plans) == canon(jdep.plans)
    want = _chip_smoke().FACADE_EXPECTED
    assert (sol.strategy, sol.multi.mode) == (want["strategy"], want["mode"])
    got = {name: (p.p1, p.p2, p.transition_repeat, p.meta["quota_chips"], p.meta["co_mode"])
           for name, p in dep.plans.items()}
    assert got == {name: tuple(plan) for name, plan in want["plans"].items()}


# ------------------------------------------------------------ cache

def test_solution_cache_and_solve_many_count_as_reference():
    out = []
    for side in (PORT, REF):
        s = side.scope
        probs = [s.problem("alexnet:1,resnet18:1", "mcm16", m_samples=16),
                 s.problem("alexnet:1,resnet18:1", "mcm16", m_samples=16),
                 s.problem("alexnet:2,resnet18:1", "mcm16", m_samples=16)]
        cache = s.SolutionCache()
        sols = s.solve_many(probs, cache=cache)
        assert sols[0] is sols[1] and sols[2] is not sols[0]
        again = cache.solve(probs[2])
        assert again is sols[2] and cache.last_hit
        out.append((dict(cache.stats), [canon(x.to_json()) for x in sols],
                    s.problem_fingerprint(probs[0]) == s.problem_fingerprint(probs[1])))
    assert out[0] == out[1]
    assert out[0][0] == {"solution_hits": 2, "solution_misses": 2,
                         "solutions": 2, "engines": 1}
