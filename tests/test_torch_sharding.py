"""The port's placement rules (``repro_torch.runtime.sharding``) against the
reference's ``repro.runtime.sharding``: for every registered config on the
reference's meshes (2, 4), (16, 16) and (2, 16, 16), the parameter,
optimizer (AdamW and Adafactor), cache and batch PartitionSpecs, the
sanitized and ZeRO placements over the configs' own shapes, and the zones'
activation layouts, entry for entry.

The reference's placement functions read only ``mesh.shape``, so a
stand-in with that dict serves for both packages; the shapes are the
reference's abstract trees (``jax.eval_shape``) and the port's meta model.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from repro.configs import get_config as jget_config
from repro.models import init_kv_cache as jinit_kv_cache
from repro.models import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import sharding as jsh

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import init_kv_cache, init_params
from repro_torch.optim import make_optimizer
from repro_torch.runtime import sharding as tsh

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# the default plan, and one with every switch the other way
PLANS = {"default": {}, "switched": dict(ep=False, zero=False, shard_kv_cache_time=False,
                                         use_dp=False)}
CACHE_B, CACHE_T = 32, 4096


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _plans(mesh_name, plan_name):
    axes = MESHES[mesh_name][1]
    kw = PLANS[plan_name]
    return (jsh.ShardPlan(axes, p1="WSP", p2="ISP", transition_repeat=1, **kw),
            tsh.ShardPlan(axes, p1="WSP", p2="ISP", transition_repeat=1, **kw))


def canon(tree):
    """A nested plain form of a spec tree of either package: a spec as
    ("P", entries), a NamedTuple by its class name and fields."""
    if isinstance(tree, (JP, tsh.PartitionSpec)):
        return ("P", tuple(tree))
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(canon(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(canon(v) for v in tree)
    return tree


@functools.cache
def _ref_shapes(arch):
    cfg = jget_config(arch)
    params = jax.eval_shape(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    opts = {name: jax.eval_shape(jmake_optimizer(name)[0], params)
            for name in ("adamw", "adafactor")}
    caches = jax.eval_shape(lambda: jinit_kv_cache(cfg, CACHE_B, CACHE_T, jnp.bfloat16))
    return params, opts, caches


@functools.cache
def _port_shapes(arch):
    cfg = get_config(arch)
    params = init_params(cfg, None, "meta").param_tree()
    opts = {name: make_optimizer(name)[0](params) for name in ("adamw", "adafactor")}
    caches = init_kv_cache(cfg, CACHE_B, CACHE_T, torch.bfloat16, "meta")
    return params, opts, caches


CELLS = [(a, m, p) for a in sorted(ARCHS) for m in MESHES for p in PLANS]
IDS = [f"{a}-{m}-{p}" for a, m, p in CELLS]


@pytest.mark.parametrize("arch,mesh,plan", CELLS, ids=IDS)
def test_param_specs_match(arch, mesh, plan):
    jplan, tplan = _plans(mesh, plan)
    ref = jsh.param_pspecs(jget_config(arch), jplan, _mesh(mesh))
    got = tsh.param_pspecs(get_config(arch), tplan, _mesh(mesh))
    assert canon(got) == canon(ref)
    ref_s = jsh.sanitize_pspecs(ref, _ref_shapes(arch)[0], _mesh(mesh))
    got_s = tsh.sanitize_pspecs(got, _port_shapes(arch)[0], _mesh(mesh))
    assert canon(got_s) == canon(ref_s)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,mesh,plan", CELLS, ids=IDS)
def test_opt_specs_match(arch, mesh, plan, optimizer):
    """The optimizer placements, then sanitized and ZeRO-placed over the
    state's own shapes, as the reference's train step does."""
    jplan, tplan = _plans(mesh, plan)
    jm, tm = _mesh(mesh), _mesh(mesh)
    jp = jsh.sanitize_pspecs(jsh.param_pspecs(jget_config(arch), jplan, jm),
                             _ref_shapes(arch)[0], jm)
    tp = tsh.sanitize_pspecs(tsh.param_pspecs(get_config(arch), tplan, tm),
                             _port_shapes(arch)[0], tm)
    ref = jsh.opt_pspecs(jget_config(arch), jplan, jm, jp, optimizer)
    got = tsh.opt_pspecs(get_config(arch), tplan, tm, tp, optimizer)
    assert canon(got) == canon(ref)
    ref_shapes, got_shapes = _ref_shapes(arch)[1][optimizer], _port_shapes(arch)[1][optimizer]
    ref = jsh.sanitize_pspecs(ref, ref_shapes, jm)
    got = tsh.sanitize_pspecs(got, got_shapes, tm)
    assert canon(got) == canon(ref)
    assert canon(tsh.zero_shard(got, got_shapes, tm)) == canon(
        jsh.zero_shard(ref, ref_shapes, jm))


@pytest.mark.parametrize("arch,mesh,plan", CELLS, ids=IDS)
def test_cache_and_batch_specs_match(arch, mesh, plan):
    jplan, tplan = _plans(mesh, plan)
    jc, tc = jget_config(arch), get_config(arch)
    ref, got = jsh.cache_pspecs(jc, jplan), tsh.cache_pspecs(tc, tplan)
    assert canon(got) == canon(ref)
    assert canon(tsh.sanitize_pspecs(got, _port_shapes(arch)[2], _mesh(mesh))) == canon(
        jsh.sanitize_pspecs(ref, _ref_shapes(arch)[2], _mesh(mesh)))
    for labels in (True, False):
        assert canon(tsh.batch_pspecs(tc, tplan, labels)) == canon(
            jsh.batch_pspecs(jc, jplan, labels))


@pytest.mark.parametrize("mesh,plan", [(m, p) for m in MESHES for p in PLANS])
def test_activation_layouts_match_make_constrain(monkeypatch, mesh, plan):
    """``activation_pspec`` against the spec the reference's constrain
    callback hands ``with_sharding_constraint``, for each zone, tag and
    shape the model passes it."""
    jplan, tplan = _plans(mesh, plan)
    monkeypatch.setattr(jsh, "NamedSharding", lambda _mesh, spec: spec)
    monkeypatch.setattr(jsh.jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    cases = [("embed", (8, 64, 32)), ("blk0:attn", (8, 64, 32)), ("blk1:ffn", (8, 1, 32)),
             ("transition", (8, 64, 32)), ("logits", (8, 64, 256)),
             ("moe:groups", (16, 32, 32)), ("moe:buffers", (4, 64, 32)), ("embed", (8, 32))]
    for zone in (1, 2):
        constrain = jsh.make_constrain(None, jplan, zone)
        for tag, shape in cases:
            ref = constrain(jax.ShapeDtypeStruct(shape, jnp.float32), tag)
            assert tuple(tsh.activation_pspec(tplan, zone, tag, shape)) == tuple(ref), (
                zone, tag, shape)


def test_partition_spec_normalises_as_jax():
    for entries in [((), None), (("data",), "model"), (("pod", "data"), None, "model"),
                    (None,), ()]:
        assert tuple(tsh.PartitionSpec(*entries)) == tuple(JP(*entries))


def test_plan_dataclass_matches():
    names = [f.name for f in dataclasses.fields(tsh.ShardPlan)]
    assert names == [f.name for f in dataclasses.fields(jsh.ShardPlan)]
    for axes in (("data", "model"), ("pod", "data", "model")):
        for use_dp in (True, False):
            assert tsh.ShardPlan(axes, use_dp=use_dp).dp == jsh.ShardPlan(axes,
                                                                          use_dp=use_dp).dp
