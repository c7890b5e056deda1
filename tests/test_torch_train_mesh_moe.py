"""MoE's AdamW train step on a (data, model) mesh of ranks.

The reference's ``build_train_step`` raises for every MoE config (ROADMAP
C-ref-5), so the mesh step is held to its step body composed without a
mesh (``tests/test_torch_train.py``'s ``_ref_step_unsharded``, run here on
one device) and to the port's one-rank step.  The smoke
granite-moe-1b-a400m and jamba-v0.1-52b (MoE on its mamba layers) take 2
AdamW steps on (2, 2) and (1, 4) under ISP, WSP and a mixed plan (WSP then
ISP from repeat 1), granite-moe also on (2, 2) without expert parallelism
and on the data-only (2, 1), at ``tests/test_torch_train_mesh.py``'s
B=4 x S=13, batches and hyperparameters.

Held, at ``tests/test_torch_train_mesh{,_recurrent}.py``'s bounds: losses
and grad norms (2e-6 relative), moments (1e-4 of each leaf's largest),
parameters after each step (0.05 lr, gathered whole); against the
reference, and for jamba (whose second step starts from the reference's
state after the first, on the mesh and on one rank, as the recurrent test
re-syncs it) against the one-rank step too, the parameters are held so
where the moment bound fixes AdamW's first-step sign, the rest within
2.1 lr (the recurrent test's rule: an element whose gradient is within
rounding of zero moves by up to +-lr as rounding decides); each expert bank's moments on the parameter's own
piece (its experts over ``model``, its second-to-last dim over ``data``);
the MoE layers' collectives of a step (forward, remat's recompute, the
transposes) against a count from the shapes; and a checkpoint written on
(2, 2) restored on (1, 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.optim import make_optimizer as jax_make_optimizer

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.runtime.sharding import ShardPlan
from test_torch_multirank_moe import _groups
from test_torch_train import _ref_step_unsharded
from test_torch_train_mesh import (AXES, HYPER, LOSS_RTOL, LR, PARAM_TOL, PLANS, STATE_TOL, STEPS,
                                   B, S, _batches, _one_rank_steps)
from torch_parity import restore_on_rank, train_on_rank

MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
PLANS = {**PLANS, "no_ep": dict(ep=False)}
ARCHS = ("granite-moe-1b-a400m", "jamba-v0.1-52b")
# name -> (arch, mesh, plan)
CASES = {f"{a}/{m}/{p}": (a, m, p) for a in ARCHS for m in ("2x2", "1x4")
         for p in ("isp", "wsp", "mixed")}
CASES["granite-moe-1b-a400m/2x2/no_ep"] = ("granite-moe-1b-a400m", "2x2", "no_ep")
CASES["granite-moe-1b-a400m/2x1/isp"] = ("granite-moe-1b-a400m", "2x1", "isp")
# jamba's second step starts from the reference's state after the first, the
# one-rank step's too (tests/test_torch_train_mesh_recurrent.py re-syncs
# jamba so: its first AdamW update is sensitive to rounding, ROADMAP C)
RESYNC = tuple(n for n in CASES if n.startswith("jamba"))
SAVED = "granite-moe-1b-a400m/2x2/isp"


def _reference(arch):
    """The reference's step body without a mesh: per step the loss, grad
    norm and the parameters and moments (leaves in order, numpy)."""
    cfg = jax_smoke_config(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    opt = jax_make_optimizer(cfg.optimizer)[0](params)
    step = _ref_step_unsharded(cfg, False)
    out = {"losses": [], "grad_norms": [], "params": [], "m": [], "v": []}
    for b in _batches(cfg.vocab):
        params, opt, met = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        for what, tree_ in (("params", params), ("m", opt.m), ("v", opt.v)):
            out[what].append([np.asarray(x, np.float32) for x in jax.tree.leaves(tree_)])
    return out


def _one_rank(arch, payload, resync):
    """The port's one-rank steps of ``arch`` from the reference's weights
    (``_one_rank_steps``), or with ``resync`` ((params, m, v) whole leaves
    in order) loaded before the second step."""
    import torch

    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train import build_train_step

    if resync is None:
        return _one_rank_steps((arch, None, "isp", {}), payload)
    cfg = get_smoke_config(arch)
    params, batches = payload
    model = params_from_jax(cfg, params, "cpu").train_params()
    opt = adamw_init(model.param_tree())
    step = build_train_step(cfg, ShardPlan(AXES), device="cpu", **HYPER)

    def whole(t):
        return (torch.stack(t.layers) if isinstance(t, tree.Stacked) else t).detach().numpy().copy()

    out = {"losses": [], "grad_norms": [], "params": [], "m": [], "v": []}
    for s, b in enumerate(batches):
        if s == 1:
            with torch.no_grad():
                for tree_, arrays in zip((model.param_tree(), opt.m, opt.v), resync):
                    for leaf, a in zip(tree.leaves(tree_), arrays, strict=True):
                        for t, x in zip(tree.leaf_layers(leaf), torch.tensor(a).reshape(
                                -1, *tree.leaf_layers(leaf)[0].shape)):
                            t.copy_(x)
        model, opt, met = step(model, opt, b)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        for what, tree_ in (("params", model.param_tree()), ("m", opt.m), ("v", opt.v)):
            out[what].append([whole(t) for t in tree.leaves(tree_)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({arch: the reference's steps}, {arch: the port's one-rank steps},
    {case: every rank's results}, the state a (1, 4) mesh restored from the
    (2, 2) checkpoint, per rank)."""
    payload, ref, one = {}, {}, {}
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        payload[arch] = (jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0))),
                         _batches(cfg.vocab))
        ref[arch] = _reference(arch)
        state = tuple(ref[arch][w][0] for w in ("params", "m", "v"))
        one[arch] = _one_rank(arch, payload[arch], state if arch == "jamba-v0.1-52b" else None)
    resync = {n: {1: tuple(ref[CASES[n][0]][w][0] for w in ("params", "m", "v"))}
              for n in RESYNC}
    saved = str(tmp_path_factory.mktemp("moe_ckpt"))
    ranks = {}
    for mesh_name, shape in MESHES.items():
        mine = [(n, a, PLANS[p], {}) for n, (a, m, p) in CASES.items() if m == mesh_name]
        per_rank = run_ranks(train_on_rank, shape, AXES, {a: payload[a] for _, a, _, _ in mine},
                             mine, STEPS, HYPER, resync, {SAVED: saved}, device="cpu",
                             verbose=False)
        for name, *_ in mine:
            ranks[name] = [r[name] for r in per_rank]
    restored = run_ranks(restore_on_rank, MESHES["1x4"], AXES, CASES[SAVED][0],
                         PLANS["isp"], saved, STEPS, device="cpu", verbose=False)
    return ref, one, ranks, restored


def _held(res, want, sign_fixed):
    """``res``' steps against ``want``'s (the reference's or the one-rank
    port's) at the bounds; ``sign_fixed``: the parameters held to 0.05 lr
    where the moment bound fixes AdamW's first-step sign, elsewhere to
    2.1 lr (an element whose gradient is within rounding of zero moves by
    up to +-lr as rounding decides, and keeps that offset: an element is
    held at 0.05 lr while its moment has been above the bound at every
    step so far)."""
    fixed = [True] * len(want["params"][0])      # per leaf: fixed at every step so far
    for s in range(STEPS):
        for what in ("losses", "grad_norms"):
            assert res[what][s] == pytest.approx(want[what][s], rel=LOSS_RTOL), (what, s)
        for i, w in enumerate(want["params"][s]):
            m = want["m"][s][i]
            for what in ("m", "v"):
                ww = want[what][s][i]
                err = np.abs(res[what][s][i] - ww).max()
                assert err <= STATE_TOL * (np.abs(ww).max() or 1.0), (what, s, i, err)
            err = np.abs(res["params"][s][i] - w)
            if sign_fixed:
                fixed[i] = fixed[i] & (np.abs(m) > STATE_TOL * (np.abs(m).max() or 1.0))
                assert err[fixed[i]].max(initial=0.0) <= PARAM_TOL * LR, (s, i)
                assert err.max() <= 2.1 * LR, (s, i)
            else:
                assert err.max() <= PARAM_TOL * LR, (s, i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_the_reference_step_body(runs, name):
    ref, _, ranks, _ = runs
    for res in ranks[name]:
        _held(res, ref[CASES[name][0]], True)
        assert res["step"] == STEPS


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_the_one_rank_step(runs, name):
    _, one, ranks, _ = runs
    for res in ranks[name]:
        _held(res, one[CASES[name][0]], name in RESYNC)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_moments_sit_on_the_parameter_piece(runs, name):
    """Each expert bank's moment piece is the rank's parameter piece: its
    experts over ``model`` and its block of the second-to-last dim over
    ``data`` under ``ep`` (no ZeRO entry added), its ``d_ff`` over ``model``
    and the repeat axis over ``data`` (ZeRO) without."""
    _, _, ranks, _ = runs
    arch, mesh_name, plan = CASES[name]
    cfg = get_smoke_config(arch)
    D, m = MESHES[mesh_name]
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff or cfg.d_ff
    R = cfg.pattern_repeats
    if plan == "no_ep":
        z = R // D if R % D == 0 else R
        want = {(z, E, d, f // m), (z, E, f // m, d)}
    else:
        want = {(R, E // m, d // D, f), (R, E // m, f // D, d)}
    banks = {(R, E, d, f), (R, E, f, d)}
    whole = [tuple(p.shape) for p in ranks[name][0]["params"][0]]
    for res in ranks[name]:
        pieces = [p for w, p in zip(whole, res["piece_shapes"], strict=True) if w in banks]
        assert pieces and set(pieces) == want, pieces


# ------------------------------------------------------------ collectives

def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_moe_step_calls(cfg, plan, shape, batch, seq, dt):
    """{(kind, axis, tag): [calls, bytes]} of one rank's train step, its MoE
    layers' collectives only, counted from the shapes: each forward
    collective twice (the forward and remat's recompute) and its transpose
    once.  The transposes: the token block's all-gather over ``model`` (or,
    where blocks cross the data slices, the all-reduce over ``model`` and
    the reduce-scatter over ``data``), the all-to-alls back, the expert
    banks' gathers reduce-scattered, and the outputs' gathers
    reduce-scattered where the gradient arriving is a part on each rank
    (a WSP zone; over ``data``)."""
    D, m = shape
    dp = D if plan.use_dp else 1
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff or cfg.d_ff
    G, Tg, Cg = _groups(cfg, batch * seq)
    n = dp * m
    c = -(-G // n)
    local = dp == 1 or G % n == 0
    Tl = batch // dp * seq
    banks = ("w1", "w2", "w3") if cfg.ffn_gated else ("w1", "w2")
    calls = {}

    def add(kind, axis, tag, nbytes, count=1):
        calls[(kind, axis, tag)] = [count, count * nbytes]

    for layer in range(cfg.n_layers):
        if not cfg.is_moe_block(layer):
            continue
        t = f"blk{layer}"
        wsp = m > 1 and _partition(cfg, plan, layer) == "WSP"
        if wsp:
            add("all-gather", "model", f"{t}:moe_in", batch // dp * -(-seq // m) * m * d * dt, 2)
        if local and m > 1:
            add("all-gather", "model", f"{t}:moe_tokens:grad", m * c * Tg * d * dt)
        if not local:
            add("all-gather", "data", f"{t}:moe_tokens", dp * Tl * d * dt, 2)
            add("reduce-scatter", "data", f"{t}:moe_tokens:grad", Tl * d * dt)
            if m > 1:
                add("all-reduce", "model", f"{t}:moe_tokens:grad", Tl * d * dt)
        if plan.ep:
            if m > 1:
                for w in ("dispatch", "combine"):
                    add("all-to-all", "model", f"{t}:{w}", c * E * Cg * d * dt, 2)
                    add("all-to-all", "model", f"{t}:{w}:grad", c * E * Cg * d * dt)
            for w in banks:
                rows = f if w == "w2" else d
                if D > 1 and rows % D == 0:
                    add("all-gather", "data", f"{t}:{w}", E // m * d * f * dt, 2)
                    add("reduce-scatter", "data", f"{t}:{w}:grad", E // m * d * f // D * dt)
        elif m > 1:
            for w in banks:
                add("all-gather", "model", f"{t}:{w}", E * d * f * dt, 2)
                add("reduce-scatter", "model", f"{t}:{w}:grad", E * d * f // m * dt)
        if m > 1:
            add("all-gather", "model", f"{t}:moe_out", m * c * Tg * d * dt, 2)
            if wsp:
                add("reduce-scatter", "model", f"{t}:moe_out:grad", c * Tg * d * dt)
        if not local:
            add("all-gather", "data", f"{t}:moe_out", n * c * Tg * d * dt, 2)
            add("reduce-scatter", "data", f"{t}:moe_out:grad", m * c * Tg * d * dt)
    return calls


_MOE_TAGS = ("moe_in", "moe_tokens", "dispatch", "combine", "moe_out", "w1", "w2", "w3")


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_collectives_counted_from_shapes(runs, name):
    _, _, ranks, _ = runs
    arch, mesh_name, plan = CASES[name]
    cfg = get_smoke_config(arch)
    want = expected_moe_step_calls(cfg, ShardPlan(AXES, **PLANS[plan]), MESHES[mesh_name], B, S,
                                   4)
    for res in ranks[name]:
        got = {k: v for k, v in res["calls"].items()
               if k[2].startswith("blk") and cfg.is_moe_block(int(k[2][3:].split(":")[0]))
               and k[2].split(":")[1] in _MOE_TAGS}
        assert got == want


# ------------------------------------------------------------- checkpoints

def test_a_checkpoint_of_2x2_restores_on_1x4(runs):
    """The (2, 2) ISP case's state after its steps, checkpointed as whole
    leaves, restored into fresh (1, 4) shards: every rank's gathered
    parameters, moments and step count equal the saved ones."""
    _, _, ranks, restored = runs
    saved = ranks[SAVED][0]
    for params, m, v, step in restored:
        assert step == STEPS
        for got, want in ((params, saved["params"][-1]), (m, saved["m"][-1]),
                          (v, saved["v"][-1])):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
