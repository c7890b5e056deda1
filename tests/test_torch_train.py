"""Training on the port against the reference, on the CPU.

The same weights (the reference's ``init_params`` through
``params_from_jax``), the same optimizer state (through
``opt_state_from_jax``) and the same batches (the reference's
``SyntheticLM``) go through the reference's train step and the port's
``build_train_step``; loss, grad norm, parameters and optimizer state are
compared after 1 and after 5 steps.

Tolerances (fp32 smoke configs):
* loss and grad norm: 2e-6 relative (the two frameworks sum in another
  order; measured <= 2e-7);
* optimizer moments / statistics: 1e-4 of each leaf's largest entry
  (measured <= 8e-6);
* parameters, relative to ``lr``: 0.05 lr.  AdamW's first update is
  ``lr * g / (|g| + eps)``, so an element whose gradient is within rounding
  of zero moves by a fraction of lr that rounding decides (measured
  <= 0.022 lr); a wrong update is off by O(lr).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke_config as ref_smoke
from repro.data import SyntheticLM
from repro.launch.mesh import single_device_mesh
from repro.models import init_params as ref_init
from repro.models import loss_fn as ref_loss_fn
from repro.optim import adafactor_init as ref_adafactor_init
from repro.optim import adafactor_update as ref_adafactor_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_schedule as ref_schedule
from repro.optim import make_optimizer as ref_make_optimizer
from repro.runtime.compression import compress_decompress as ref_compress
from repro.runtime.planner import plan_for_cell as ref_plan
from repro.runtime.train import build_train_step as ref_build_train_step

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (opt_state_from_jax, opt_state_to_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.models import loss_fn
from repro_torch.optim import cosine_schedule
from repro_torch.runtime.compression import compress_decompress
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.train import build_train_step
from repro_torch.tree import Stacked

B, S, LR, WARMUP, TOTAL = 4, 32, 1e-3, 2, 10
LOSS_RTOL = 2e-6
STATE_TOL = 1e-4
PARAM_TOL = 0.05          # x lr
INT8_QUANTUM = 1 / 127    # compress: one int8 step of a leaf's amax


def _np(tree_):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree_)


def _configs(arch, **over):
    return replace(ref_smoke(arch), **over), replace(get_smoke_config(arch), **over)


def _ref_step_unsharded(jc, compress):
    """``build_train_step``'s step body (accum_steps 1) without the mesh: its
    shardings raise for every MoE config (ROADMAP C-ref-5)."""
    _, update = ref_make_optimizer(jc.optimizer)
    lr = ref_schedule(LR, WARMUP, TOTAL)
    grad_fn = jax.value_and_grad(lambda p, t, lab: ref_loss_fn(p, jc, t, lab))

    def step(params, opt, batch):
        loss, grads = grad_fn(params, batch["tokens"], batch["labels"])
        if compress:
            grads = jax.tree.map(ref_compress, grads)
        grads, gnorm = ref_clip(grads, 1.0)
        params, opt = update(params, grads, opt, lr)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return jax.jit(step)


def _setup(arch, compress=False, **over):
    jc, tc = _configs(arch, **over)
    jparams = ref_init(jc, jax.random.PRNGKey(0))
    jopt = ref_make_optimizer(jc.optimizer)[0](jparams)
    model = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu").train_params()
    topt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), "cpu")
    if jc.moe is None:
        plan = ref_plan(jc, S, B, ("data", "model"), 1, kind="train", use_dse=False)
        jstep, shardings = ref_build_train_step(jc, single_device_mesh(), plan, base_lr=LR,
                                                warmup=WARMUP, total_steps=TOTAL,
                                                compress=compress)
        # placed as the step's outputs are, so the second call does not recompile
        jparams = jax.device_put(jparams, shardings["params"])
        jopt = jax.device_put(jopt, shardings["opt"])
    else:
        jstep = _ref_step_unsharded(jc, compress)
    tplan = plan_for_cell(tc, S, B, ("data", "model"), 1, kind="train", use_dse=False)
    tstep = build_train_step(tc, tplan, base_lr=LR, warmup=WARMUP, total_steps=TOTAL,
                             compress=compress, device="cpu")
    return jc, jparams, jopt, jstep, model, topt, tstep


def _leaf_errors(a_tree, b_tree, scale=None):
    """{key: max|a - b| (/ scale, or / max|b| of the leaf)} over two pytrees."""
    out = {}
    for (key, a), b in zip(tree.flatten_with_path(_np(a_tree)), jax.tree.leaves(_np(b_tree)),
                           strict=True):
        d = float(np.abs(a - b).max()) if a.size else 0.0
        out[key] = d / (scale if scale is not None else (float(np.abs(b).max()) or 1.0))
    return out


def _batch(jc, data, step):
    """The data pipeline's batch for ``jc``: tokens and labels, and for a
    frontend stub its embeddings (audio: a frame a position, no tokens;
    vision: ``frontend_tokens`` patches ahead of the tokens)."""
    if jc.frontend == "none":
        return data.batch(step, B, S)
    patches = jc.frontend_tokens if jc.frontend == "vision_stub" else 0
    return data.frontend_batch(step, B, S, jc.d_model, patches)


def _run(arch, steps=5, compress=False, skip=(), resync=None, **over):
    """Run both steps ``steps`` times; yield (step, ref metrics, port metrics,
    params err / lr, m err, v err) after step 1 and the last step."""
    jc, jparams, jopt, jstep, model, topt, tstep = _setup(arch, compress, **over)
    data = SyntheticLM(jc.vocab, seed=0)
    out = []
    for s in range(steps):
        if resync is not None:
            resync(jparams, jopt, model, topt)
        b = _batch(jc, data, s)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        model, topt, tm = tstep(model, topt, b)
        if s + 1 in (1, steps):
            tos = opt_state_to_jax(topt)
            assert int(tos.step) == int(jopt.step) == s + 1
            errs = [_leaf_errors(params_to_jax(model), jparams, LR),
                    _leaf_errors(tos.m, jopt.m), _leaf_errors(tos.v, jopt.v)]
            errs = [{k: e for k, e in d.items() if not any(x in k for x in skip)} for d in errs]
            out.append((s + 1, jm, tm, *errs))
    return out


def _check(records, param_tol=PARAM_TOL, state_tol=STATE_TOL, norm_rtol=LOSS_RTOL):
    for step, jm, tm, dp, dm, dv in records:
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL), step
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=norm_rtol), step
        assert max(dp.values()) <= param_tol, (step, {k: e for k, e in dp.items() if e > param_tol})
        assert max(dm.values()) <= state_tol, (step, max(dm.items(), key=lambda kv: kv[1]))
        assert max(dv.values()) <= state_tol, (step, max(dv.items(), key=lambda kv: kv[1]))


@pytest.mark.parametrize("arch,over", [
    ("granite-3-8b", {}),                           # AdamW, GQA
    ("gemma2-9b", {}),                              # window and softcaps in the backward
    ("granite-3-8b", {"accum_steps": 2}),           # fp32 accumulation over microbatches
    ("granite-3-8b", {"optimizer": "adafactor"}),   # R = 2: stacked [2, d] norms factored
    ("paligemma-3b", {}),                           # patches ahead of the tokens, unlabeled
    ("musicgen-medium", {}),                        # frames, no tokens; ungated GELU MLP
    ("paligemma-3b", {"accum_steps": 2}),           # embeddings row-sliced with the labels
    ("musicgen-medium", {"tie_embeddings": True}),  # the table reaches the loss through the head
    ("rwkv6-3b", {}),                               # AdamW through the WKV-6 recurrence
    ("jamba-v0.1-52b", {"moe": None}),              # AdamW through the selective scan
], ids=["granite-adamw", "gemma2-adamw", "granite-accum2", "granite-adafactor-R2",
        "paligemma-adamw", "musicgen-adamw", "paligemma-accum2", "musicgen-tied", "rwkv6-adamw",
        "jamba-dense-adamw"])
def test_train_steps_match_reference(arch, over):
    _check(_run(arch, **over))


def _resync_router(jparams, jopt, model, topt):
    """Copy the reference's MoE router leaves and their Adafactor statistics
    into the port."""
    ptree, sm, sv = model.param_tree(), topt.m, topt.v
    with torch.no_grad():
        for pi, blk in enumerate(jparams["blocks"]):
            if "moe" not in blk:
                continue
            for r, t in enumerate(ptree["blocks"][pi]["moe"]["router"].layers):
                t.copy_(torch.from_numpy(np.array(blk["moe"]["router"][r])))
            sm["blocks"][pi]["moe"]["router"].copy_(
                torch.from_numpy(np.array(jopt.m["blocks"][pi]["moe"]["router"])))
            sv["blocks"][pi]["moe"]["router"].copy_(
                torch.from_numpy(np.array(jopt.v["blocks"][pi]["moe"]["router"])))


def test_llama4_adafactor_moe():
    """llama4-maverick smoke: Adafactor, MoE top-1 on every second layer.

    Under top-1 the renormalised gate is 1, so the router's gradient is zero
    up to rounding on both sides (|g| <= 1e-8 here) and Adafactor, which
    normalises each update, turns that noise into +-lr moves of the router
    that differ between the frameworks and then flip routes.  The router
    leaf is therefore re-synced from the reference before each step and
    left out of the comparison; every other leaf, the loss and the grad
    norm are held to the tolerances above after 1 and 5 steps.
    """
    jc, tc = _configs("llama4-maverick-400b-a17b")
    assert jc.optimizer == tc.optimizer == "adafactor" and jc.moe.top_k == 1
    _check(_run("llama4-maverick-400b-a17b", skip=("['router']",), resync=_resync_router))


def test_a_leaf_without_a_gradient_path_raises(monkeypatch):
    """A kernel call that drops its inputs' graph (as the ctypes forward
    did before it had a backward) leaves wq / wk / wv with no path to the
    loss: the step raises instead of training on with them frozen, and the
    parameters and optimizer state stay as they were."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    tc = get_smoke_config("granite-3-8b")
    model = params_from_jax(tc, jax.tree.map(np.asarray, ref_init(ref_smoke("granite-3-8b"),
                                                                  jax.random.PRNGKey(0))),
                            "cpu").train_params()
    opt = opt_state_from_jax(jax.tree.map(np.asarray, ref_make_optimizer(tc.optimizer)[0](
        params_to_jax(model))), "cpu")
    plan = plan_for_cell(tc, S, B, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(tc, plan, base_lr=LR, warmup=WARMUP, total_steps=TOTAL, device="cpu")
    before = [t.detach().clone() for t in model.flat_params()]
    monkeypatch.setattr(attention, "flash_attention", lambda q, k, v, **kw: attention_ref(
        q.detach(), k.detach(), v.detach(), **kw))
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        step(model, opt, SyntheticLM(tc.vocab, seed=0).batch(0, B, S))
    assert int(opt.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(model.flat_params(), before, strict=True))


def test_compressed_gradients_match_reference():
    """compress=True: int8 quantize -> dequantize of each whole leaf.  Rounding
    to the int8 grid is discontinuous, so a gradient within rounding of a
    half-step lands one int8 step away on the other side: moments are held
    to one step of the leaf's amax (plus the usual 1e-4), parameters to
    0.5 lr (measured 0.24 lr after 5 steps), the grad norm, which sums those
    steps, to 5e-5 (measured 1.1e-5)."""
    _check(_run("granite-3-8b", compress=True), param_tol=0.5,
           state_tol=INT8_QUANTUM + STATE_TOL, norm_rtol=5e-5)


def test_compress_decompress_whole_leaf_is_exact():
    """The port's compress_decompress on a stacked leaf's layers equals the
    reference's on the stacked array, bit for bit (one amax over all R
    layers); a per-layer scale would not."""
    rng = np.random.default_rng(0)
    stacked = (rng.standard_normal((3, 16, 8)) * np.array([1.0, 0.1, 0.01])[:, None, None])
    stacked = stacked.astype(np.float32)
    want = np.asarray(ref_compress(jnp.asarray(stacked)))
    got = compress_decompress([torch.from_numpy(x.copy()) for x in stacked])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    per_layer = np.stack([compress_decompress(torch.from_numpy(x.copy())).numpy() for x in stacked])
    assert not np.array_equal(per_layer, want)


def test_per_layer_adafactor_would_fail_the_stacked_case():
    """With R = 2 the reference's Adafactor factors a stacked [2, d] norm
    weight (column statistics over the two layers) and clips by the RMS of
    the whole stacked leaf.  The port, whose unit is the stacked leaf,
    matches it; run per layer on [d] weights (unfactored, clipped per layer)
    it computes another update, which the granite-adafactor-R2 case above
    would fail by far more than its tolerance."""
    from repro_torch.optim import adafactor_init, adafactor_update

    rng = np.random.default_rng(0)
    p = rng.standard_normal((2, 64)).astype(np.float32) * 0.02
    g = rng.standard_normal((2, 64)).astype(np.float32) * np.array([[1.0], [0.05]], np.float32)
    lr = ref_schedule(LR, WARMUP, TOTAL)
    stacked, _ = ref_adafactor_update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)},
                                      ref_adafactor_init({"w": jnp.asarray(p)}), lr)
    stacked = np.asarray(stacked["w"])
    per_layer = []
    for r in range(2):
        one = {"w": jnp.asarray(p[r])}
        new, _ = ref_adafactor_update(one, {"w": jnp.asarray(g[r])}, ref_adafactor_init(one), lr)
        per_layer.append(np.asarray(new["w"]))
    assert np.abs(np.stack(per_layer) - stacked).max() / LR > 10 * PARAM_TOL

    layers = [torch.from_numpy(x.copy()) for x in p]
    params = {"w": Stacked(layers)}
    state = adafactor_init(params)
    assert tuple(state.m["w"].shape) == (2,) and tuple(state.v["w"].shape) == (64,)
    adafactor_update(params, {"w": Stacked([torch.from_numpy(x.copy()) for x in g])}, state,
                     cosine_schedule(LR, WARMUP, TOTAL))
    got = np.stack([t.numpy() for t in layers])
    assert np.abs(got - stacked).max() / LR <= PARAM_TOL


def test_schedule_matches_reference():
    got = cosine_schedule(3e-4, 10, 100)
    want = ref_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        assert got(step) == np.float32(want(step)), step


def _loss_and_grads(tc, jparams, tokens, labels, femb=None):
    model = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu").train_params()
    ptree = model.param_tree()
    flat = model.flat_params()
    loss = loss_fn(model, None if tokens is None else torch.as_tensor(tokens).long(),
                   torch.as_tensor(labels).long(),
                   None if femb is None else torch.as_tensor(femb))
    # only the leaves the prefill does not use (the audio stub's untied
    # embedding table) have no path to the loss: a zero gradient, as the
    # reference's; any other leaf without one raises
    unused = {id(p) for p in model.unused_by_prefill()}
    used = iter(torch.autograd.grad(loss, [p for p in flat if id(p) not in unused]))
    it = iter([torch.zeros_like(p) if id(p) in unused else next(used) for p in flat])
    grads = tree.map(lambda leaf: np.stack([next(it).numpy() for _ in leaf.layers])
                     if isinstance(leaf, Stacked) else next(it).numpy(), ptree)
    return loss.item(), grads


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_reference(arch):
    """Every smoke config: the loss and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, to 1e-4 of the
    leaf's largest gradient (fp32; measured <= 1e-5), except a top-1 MoE
    router's, whose gradient is rounding noise around 0 (the renormalised
    gate is 1): held to 1e-7 absolute.  The frontend stubs take the data
    pipeline's ``frontend_batch`` (audio: frame embeddings and no tokens;
    vision: patch embeddings ahead of the tokens, the patches unlabeled)."""
    jc, tc = ref_smoke(arch), get_smoke_config(arch)
    jparams = ref_init(jc, jax.random.PRNGKey(0))
    data = SyntheticLM(jc.vocab, seed=1)
    patches = jc.frontend_tokens if jc.frontend == "vision_stub" else 0
    b = (data.batch(0, 2, 16) if jc.frontend == "none"
         else data.frontend_batch(0, 2, 16, jc.d_model, patches))
    tokens, femb = b.get("tokens"), b.get("frontend_embeds")
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(p, jc, None if tokens is None else jnp.asarray(tokens),
                              jnp.asarray(b["labels"]),
                              None if femb is None else jnp.asarray(femb))))(jparams)
    got_loss, got = _loss_and_grads(tc, jparams, tokens, b["labels"], femb)
    assert got_loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    for (key, g), w in zip(tree.flatten_with_path(got), jax.tree.leaves(_np(want)), strict=True):
        err = float(np.abs(g - w).max())
        if "['router']" in key and jc.moe.top_k == 1:
            assert err <= 1e-7, (key, err)
        else:
            assert err <= STATE_TOL * float(np.abs(w).max()), (key, err, float(np.abs(w).max()))
