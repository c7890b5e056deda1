"""The port's copy of the Scope search (paper Algorithm 1) and the paper's
baselines, on the CPU against the JAX package.

``search`` (homogeneous packages), ``search_mixed`` (the big/little one) and
every ``core/baselines.py`` scheduler must return the same ``ScopeSchedule``
on alexnet, resnet18, resnet50 and resnet152: the same segments, clusters,
partitions, region chips and chip types, with ``==`` latencies (the copy is
the same arithmetic in the same order, so equality is exact).
"""
import importlib

import pytest

from repro.core import baselines as jax_baselines
from repro.core.fastcost import FastCostModel as JaxFastCostModel
from repro.core.graph import chain as jax_chain
from repro.core.hw import get_hw as jax_get_hw
from repro.core.regions import RegionMode as JaxRegionMode
from repro.core.workloads import get_cnn as jax_get_cnn
from repro_torch.core import baselines
from repro_torch.core.fastcost import FastCostModel
from repro_torch.core.graph import chain
from repro_torch.core.hw import get_hw
from repro_torch.core.regions import RegionMode
from repro_torch.core.workloads import get_cnn
from torch_parity import canon

# the packages' ``core/__init__`` shadow the ``search`` module with the function
jax_search = importlib.import_module("repro.core.search")
search = importlib.import_module("repro_torch.core.search")

NETS = ["alexnet", "resnet18", "resnet50", "resnet152"]
PACKAGES = ["mcm16", "mcm64", "mcm64_hetero"]
# resnet152 on the hetero package is most of a minute for both packages, so
# it runs in its own file (test_torch_search_mixed.py) on its own worker
CASES = [(net, hw) for net in NETS for hw in PACKAGES
         if (net, hw) != ("resnet152", "mcm64_hetero")]


def _pair(hw_name, m_samples=16):
    return (FastCostModel(get_hw(hw_name), m_samples=m_samples),
            JaxFastCostModel(jax_get_hw(hw_name), m_samples=m_samples))


def check_algorithm1_and_baselines(net, hw_name):
    """Algorithm 1 (``search_mixed`` on the hetero package, which crosses
    the flavor seam; ``search`` elsewhere), then the four baselines on the
    same warm engines."""
    cost, jcost = _pair(hw_name)
    g, jg = get_cnn(net), jax_get_cnn(net)
    if cost.hw.region_types:
        got, want = search.search_mixed(g, cost), jax_search.search_mixed(jg, jcost)
    else:
        got = search.search(g, cost, cost.hw.chips)
        want = jax_search.search(jg, jcost, jcost.hw.chips)
    assert want is not None
    assert got.latency == want.latency
    assert canon(got) == canon(want)
    for method in baselines.ALL_METHODS:
        got = baselines.ALL_METHODS[method](g, cost, cost.hw.chips)
        want = jax_baselines.ALL_METHODS[method](jg, jcost, jcost.hw.chips)
        assert canon(got) == canon(want), method


@pytest.mark.parametrize("net,hw_name", CASES)
def test_algorithm1_and_baselines_match_reference(net, hw_name):
    check_algorithm1_and_baselines(net, hw_name)


@pytest.mark.parametrize("mode", ["free", "uniform"])
@pytest.mark.parametrize("net", ["resnet18", "resnet50"])
def test_region_modes_and_paper_strict_match_reference(net, mode):
    cost, jcost = _pair("mcm16")
    for strict in (False, True):
        got = search.search(get_cnn(net), cost, 16, mode=RegionMode(mode), paper_strict=strict)
        want = jax_search.search(jax_get_cnn(net), jcost, 16, mode=JaxRegionMode(mode),
                                 paper_strict=strict)
        assert canon(got) == canon(want)


def test_search_segment_and_chip_type_match_reference():
    """One segment alone, and the whole search restricted to one flavor of
    the hetero package (the multimodel quota search's call)."""
    cost, jcost = _pair("mcm64_hetero")
    g, jg = get_cnn("resnet50"), jax_get_cnn("resnet50")
    got = search.search_segment(cost, g, 0, 12, 16)
    want = jax_search.search_segment(jcost, jg, 0, 12, 16)
    assert canon(got) == canon(want)
    for ctype, chips in ((t.name, t.chips) for t in cost.hw.region_types):
        got = search.search(g, cost, chips, chip_type=ctype)
        want = jax_search.search(jg, jcost, chips, chip_type=ctype)
        assert canon(got) == canon(want), ctype


def test_exhaustive_random_and_compositions_match_reference():
    """The validation searches on a 4-layer prefix (seeded sampling: equal
    populations, not close ones) and the composition enumerator."""
    from repro.core.hw import mcm_table_iii as jax_mcm
    from repro_torch.core.hw import mcm_table_iii

    g = chain("alexnet[:4]", get_cnn("alexnet").layers[:4])
    jg = jax_chain("alexnet[:4]", jax_get_cnn("alexnet").layers[:4])
    cost = FastCostModel(mcm_table_iii(16).with_chips(6), m_samples=16)
    jcost = JaxFastCostModel(jax_mcm(16).with_chips(6), m_samples=16)
    assert canon(list(search.exhaustive_search(cost, g, 6, yield_all=True))) == canon(
        list(jax_search.exhaustive_search(jcost, jg, 6, yield_all=True)))
    assert search.random_search(cost, g, 6, samples=200, seed=3) == \
        jax_search.random_search(jcost, jg, 6, samples=200, seed=3)
    for total, parts in ((6, 2), (9, 3), (12, 4)):
        assert list(search.compositions(total, parts)) == list(
            jax_search.compositions(total, parts))
