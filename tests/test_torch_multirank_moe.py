"""MoE's serving steps on a mesh of ranks against the reference on one device.

The smoke granite-moe-1b-a400m (attention and MoE on every layer),
jamba-v0.1-52b (mamba and attention, MoE on every second layer: the mamba
ones) and llama4-maverick (dense and MoE layers, top-1 of 4 experts, one
kv head) run their prefill and a decode step on (2, 2), (1, 4) and the
data-only (2, 1) (data, model) meshes of gloo ranks under ISP, WSP, a mixed
plan (WSP then ISP from repeat 1) and ISP without expert parallelism
(``ep=False``), on the reference's weights (``convert.params_from_jax``),
at B=4 x S=13 (which neither model axis divides).  granite-moe also runs
with ``dispatch_groups`` overridden and a capacity factor of 1: 4 groups of
13 tokens (capacity drops choices), 13 groups (which do not split evenly
over 4 ranks) and 2 groups (fewer than the ranks; in decode, on (2, 2),
groups that do not lie in a rank's data slice).

Held: the gathered logits against the reference's single-device
``forward`` / ``decode_step`` within ``tests/test_torch_model.py``'s bound
(1e-4); every MoE layer's routing, assembled from the ranks' groups,
equal to the reference's (the smallest gap between the k-th and the next
router logit is printed); the drop cases dropping; the recorded collectives (the
dispatch and combine all-to-alls, the expert banks' gathers over ``data``,
the token and output gathers) against a count from the shapes, which the
meta route (the dry-run's) records for every rank's coordinates too; the
expert banks stored cut
over ``model`` (experts) and ``data`` (their second-to-last dim), the
router whole; and the dry-run's (2, 4) granite-moe and llama4 cells
counting the same from their shapes.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_kv_cache as jax_init_kv_cache
from repro.models import init_params as jax_init_params

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.model import init_params
from repro_torch.runtime.serve import build_decode_step, build_prefill_step
from repro_torch.runtime.sharding import ShardPlan, shard_model
from test_torch_multirank_recurrent import expected_decode_calls, expected_prefill_calls
from torch_parity import moe_cases_on_rank

TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_torch_model.py's
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
PLANS = {"isp": {}, "wsp": dict(p1="WSP", p2="WSP"),
         "mixed": dict(p1="WSP", p2="ISP", transition_repeat=1), "no_ep": dict(ep=False)}
# name -> (arch, MoE config overrides on both packages' smoke configs, plans)
CASES = {
    "granite-moe": ("granite-moe-1b-a400m", {}, ("isp", "wsp", "mixed", "no_ep")),
    "granite-moe/drop": ("granite-moe-1b-a400m", dict(dispatch_groups=4, capacity_factor=1.0),
                         ("isp", "wsp", "no_ep")),
    "granite-moe/g13": ("granite-moe-1b-a400m", dict(dispatch_groups=13, capacity_factor=1.0),
                        ("isp", "mixed")),
    "granite-moe/g2": ("granite-moe-1b-a400m", dict(dispatch_groups=2, capacity_factor=1.0),
                       ("isp", "wsp", "no_ep")),
    "jamba": ("jamba-v0.1-52b", {}, ("isp", "wsp", "mixed", "no_ep")),
    "llama4": ("llama4-maverick-400b-a17b", {}, ("isp", "wsp", "mixed", "no_ep")),
}
DROPPING = ("granite-moe/drop", "granite-moe/g13", "granite-moe/g2")
B, S = 4, 13                            # S % 2 and S % 4 are not 0
T = S + 1


def _cfg(name, jax_side=False):
    arch, over, _ = CASES[name]
    cfg = (jax_smoke_config if jax_side else get_smoke_config)(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


def _groups(cfg, tokens):
    """(G, Tg, Cg) of the reference's dispatch for ``tokens`` tokens."""
    G = min(cfg.moe.dispatch_groups, tokens)
    while tokens % G:
        G -= 1
    Tg = tokens // G
    return G, Tg, max(1, int(cfg.moe.capacity_factor * Tg * cfg.moe.top_k / cfg.moe.n_experts))


@contextlib.contextmanager
def _jax_routing(cfg):
    """The reference's routing as it runs: each MoE call's top k + 1 router
    logits (in the softmax gates' order) and experts over every token, in
    the order the calls run (the reference's ``moe_ffn`` wrapped where its
    model looks it up, the same operations on the same inputs ahead of
    it)."""
    import repro.models.model as jax_model

    inner, log = jax_model.moe_ffn, []
    k = min(cfg.moe.top_k + 1, cfg.moe.n_experts)

    def wrapped(params, x, c, constrain):
        xf = x.reshape(-1, x.shape[-1])
        logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), params["router"])
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        vals = jnp.take_along_axis(logits, idx, axis=-1)
        jax.debug.callback(lambda v, i: log.append((np.asarray(v), np.asarray(i))), vals, idx,
                           ordered=True)
        return inner(params, x, c, constrain)

    jax_model.moe_ffn = wrapped
    try:
        yield log
    finally:
        jax_model.moe_ffn = inner


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _reference(name):
    """(params, tokens, the caches after the prefill with k / v padded to T
    positions, decode tokens, prefill logits, decode logits, prefill
    routing, decode routing) of the reference; each routing a list over
    its MoE layers in order of (router logits, experts) [tokens, K + 1]."""
    cfg = _cfg(name, jax_side=True)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dtoks = rng.integers(0, cfg.vocab, (1, B, 1)).astype(np.int32)
    with _jax_routing(cfg) as routing:
        logits, caches = jax.jit(lambda p, t: jax_forward(p, cfg, t, collect_cache=True))(
            params, jnp.asarray(tokens))
        jax.effects_barrier()
    prefill_routing = list(routing)
    full = jax_init_kv_cache(cfg, B, T, jnp.float32)
    caches = tuple({n: full[i][n].at[:, :, :S].set(c[n]) if n in ("k", "v") else c[n]
                    for n in c} for i, c in enumerate(caches))
    start = _np_tree(caches)
    with _jax_routing(cfg) as routing:
        dec, _ = jax.jit(lambda p, tok, pos, c: jax_decode_step(p, cfg, tok, pos, c))(
            params, jnp.asarray(dtoks[0]), jnp.full((B,), S, jnp.int32), caches)
        jax.effects_barrier()
    return (_np_tree(params), tokens, start, dtoks, np.asarray(logits), np.asarray(dec),
            prefill_routing, list(routing))


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request):
    payload = {}
    for name, (arch, over, plans) in CASES.items():
        params, tokens, caches, dtoks, *_ = _reference(name)
        payload[name] = (arch, over, params, tokens, caches, dtoks, plans)
    shape = MESHES[request.param]
    return shape, run_ranks(moe_cases_on_rank, shape, AXES, payload, PLANS, T, device="cpu",
                            verbose=False)


RUNS = [(n, p) for n, (_, _, plans) in CASES.items() for p in plans]


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,plan", RUNS)
def test_prefill_logits_match_reference(mesh_run, name, plan):
    shape, ranks = mesh_run
    cfg = _cfg(name)
    for res in ranks:
        r = res[(name, plan)]
        assert r["local_shape"] == (B // shape[0], S, cfg.padded_vocab // shape[1])
        _close(r["logits"], _reference(name)[4])


@pytest.mark.parametrize("name,plan", RUNS)
def test_decode_logits_match_reference(mesh_run, name, plan):
    _, ranks = mesh_run
    for res in ranks:
        _close(res[(name, plan)]["decode"], _reference(name)[5])


# ---------------------------------------------------------------- routing

def _assemble(ranks, key, cfg, tokens):
    """Every MoE layer's choices [tokens, K] from the ranks' routing logs:
    each rank's records placed at their first token; each token routed by
    exactly one rank."""
    K = cfg.moe.top_k
    layers = [layer for layer in range(cfg.n_layers) if cfg.is_moe_block(layer)]
    out = {layer: np.full((tokens, K), -1) for layer in layers}
    seen = {layer: np.zeros(tokens, int) for layer in layers}
    for res in ranks:
        for tag, first, _, idx in res[key]:
            layer = int(tag.removeprefix("blk"))
            out[layer][first:first + len(idx)] = idx[:, :K]
            seen[layer][first:first + len(idx)] += 1
    for layer in layers:
        assert (seen[layer] == 1).all(), (layer, seen[layer])
    return [out[layer] for layer in layers]


@pytest.mark.parametrize("name,plan", RUNS)
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_routing_matches_reference_layer_by_layer(mesh_run, name, plan, step):
    _, ranks = mesh_run
    cfg = _cfg(name)
    K = cfg.moe.top_k
    ref = _reference(name)[6 if step == "prefill" else 7]
    key = "routing" if step == "prefill" else "decode_routing"
    got = _assemble([r[(name, plan)] for r in ranks], key, cfg, B * (S if step == "prefill" else 1))
    assert len(got) == len(ref)
    margin = min(float((v[:, K - 1] - v[:, K]).min()) for v, _ in ref)
    print(f"{name} {step}: the smallest gap between the k-th and the next router logit "
          f"{margin:.3g}")
    for layer, (sel, (_, idx)) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(sel, idx[:, :K], err_msg=f"MoE layer {layer}")


@pytest.mark.parametrize("name", DROPPING)
def test_capacity_drops_choices(name):
    """The drop cases' prefill drops choices (per group, an expert's choices
    beyond its capacity ``Cg``), by the reference's routing."""
    cfg = _cfg(name)
    G, Tg, Cg = _groups(cfg, B * S)
    dropped = 0
    for _, idx in _reference(name)[6]:
        sel = idx[:, :cfg.moe.top_k].reshape(G, -1)
        for g in sel:
            dropped += int(np.maximum(np.bincount(g, minlength=cfg.moe.n_experts) - Cg, 0).sum())
    assert dropped > 0


# ------------------------------------------------------------ collectives

def expected_moe_calls(cfg, plan, shape, batch, seq, dt, wsp):
    """{(kind, axis, tag suffix): [calls, bytes]} of one MoE layer's forward
    on a rank, counted from the shapes: in a WSP zone the zone's positions
    gathered; the data slices' tokens gathered over ``data`` where the
    rank's block of the groups (``ceil(G / n)`` of them) does not lie in its
    slice; with ``ep`` the dispatch and combine all-to-alls of every rank's
    blocks padded to one count, and the expert banks gathered over
    ``data`` where it divides their second-to-last dim; without, every
    expert bank gathered over ``model``; the group outputs gathered back."""
    D, m = shape
    dp = D if plan.use_dp else 1
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff or cfg.d_ff
    G, Tg, Cg = _groups(cfg, batch * seq)
    n = dp * m
    c = -(-G // n)
    local = dp == 1 or G % n == 0
    banks = ("w1", "w2", "w3") if cfg.ffn_gated else ("w1", "w2")
    calls = {}

    def add(kind, axis, tag, nbytes):
        calls[(kind, axis, tag)] = [1, nbytes]

    if wsp:
        add("all-gather", "model", "moe_in", batch // dp * -(-seq // m) * m * d * dt)
    if not local:
        add("all-gather", "data", "moe_tokens", batch * seq * d * dt)
    if plan.ep:
        if m > 1:
            add("all-to-all", "model", "dispatch", c * E * Cg * d * dt)
            add("all-to-all", "model", "combine", c * E * Cg * d * dt)
        for w in banks:
            if D > 1 and (f if w == "w2" else d) % D == 0:
                add("all-gather", "data", w, E // m * d * f * dt)
    elif m > 1:
        for w in banks:
            add("all-gather", "model", w, E * d * f * dt)
    if m > 1:
        add("all-gather", "model", "moe_out", m * c * Tg * d * dt)
    if not local:
        add("all-gather", "data", "moe_out", n * c * Tg * d * dt)
    return calls


def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_calls(cfg, plan, shape, batch, seq, dt, decode=False):
    """One rank's prefill (or decode step) of an MoE config, counted from
    the shapes: ``tests/test_torch_multirank_recurrent.py``'s count of the
    config with a dense FFN on a model axis, each MoE layer's FFN
    collectives replaced by :func:`expected_moe_calls`."""
    m = shape[1]
    calls = {}
    if m > 1:
        # the same layers and zones (the pattern MoE's period expands), a dense FFN
        dense = dataclasses.replace(cfg, moe=None, block_pattern=cfg.expanded_pattern)
        calls = (expected_decode_calls(dense, plan, shape, batch, dt) if decode
                 else expected_prefill_calls(dense, plan, shape, batch, seq, dt))
    for layer in range(cfg.n_layers):
        if not cfg.is_moe_block(layer):
            continue
        tag = f"blk{layer}"
        for key in [k for k in calls if k[2] in (f"{tag}:ffn", f"{tag}:w1", f"{tag}:w2",
                                                 f"{tag}:w3")]:
            del calls[key]
        wsp = not decode and m > 1 and _partition(cfg, plan, layer) == "WSP"
        for (kind, axis, t), v in expected_moe_calls(cfg, plan, shape, batch,
                                                     1 if decode else seq, dt, wsp).items():
            calls[(kind, axis, f"{tag}:{t}")] = v
    return calls


@pytest.mark.parametrize("name,plan", RUNS)
def test_collectives_counted_from_shapes(mesh_run, name, plan):
    shape, ranks = mesh_run
    splan = ShardPlan(AXES, **PLANS[plan])
    cfg = _cfg(name)
    want = expected_calls(cfg, splan, shape, B, S, 4)
    want_dec = expected_calls(cfg, splan, shape, B, S, 4, decode=True)
    for res in ranks:
        assert res[(name, plan)]["calls"] == want
        assert res[(name, plan)]["decode_calls"] == want_dec


def _meta_calls(cfg, plan, shape, coords):
    """The collectives of the prefill and a decode step of the rank at
    ``coords`` traced on meta (the dry-run's route)."""
    mesh = make_mesh(shape, AXES, meta=True, coords=coords)
    model = shard_model(init_params(cfg, None, "meta"), plan, mesh)
    tokens = torch.empty(B, S, dtype=torch.int64, device="meta")
    build_prefill_step(cfg, plan, "meta", mesh)(model, tokens)
    prefill = dict(mesh.comm.calls)
    mesh.comm.reset()
    caches = model.init_kv_cache(B, T, torch.float32)
    build_decode_step(cfg, plan, B, T, "meta", mesh)(
        model, torch.empty(B, 1, dtype=torch.int64, device="meta"),
        torch.empty(B, dtype=torch.int64, device="meta"), caches)
    return prefill, dict(mesh.comm.calls)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name,plan", [("granite-moe/g13", "mixed"), ("granite-moe/g2", "wsp"),
                                       ("jamba", "isp"), ("llama4", "no_ep")])
def test_meta_route_counts_as_the_ranks(mesh, name, plan):
    """Every rank's prefill and decode step traced on meta records the
    count from the shapes that the gloo ranks record (at d_head 64: the
    flash kernel's meta route has no instantiation at the smoke's 16)."""
    shape = MESHES[mesh]
    splan = ShardPlan(AXES, **PLANS[plan])
    cfg = dataclasses.replace(_cfg(name), d_head=64)
    want = (expected_calls(cfg, splan, shape, B, S, 4),
            expected_calls(cfg, splan, shape, B, S, 4, decode=True))
    for coords in np.ndindex(*shape):
        assert _meta_calls(cfg, splan, shape, coords) == want, coords


@pytest.mark.parametrize("name,plan", RUNS)
def test_expert_banks_stored_cut_over_model_and_data(mesh_run, name, plan):
    shape, ranks = mesh_run
    cfg = _cfg(name)
    D, m = shape
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff or cfg.d_ff
    if PLANS[plan].get("ep", True):
        want = {"w1": (E // m, d // D, f), "w3": (E // m, d // D, f), "w2": (E // m, f // D, d)}
    else:
        want = {"w1": (E, d, f // m), "w3": (E, d, f // m), "w2": (E, f // m, d)}
    want["router"] = (d, E)
    for res in ranks:
        assert res[(name, plan)]["expert_shapes"] == want


# ------------------------------------------------------------ the dry-run

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_dryrun_moe_mesh_cell_counts_the_collectives(arch, shape_name):
    """A (2, 4) rank of the cell traced on meta: its recorded collectives,
    the all-to-alls and the expert gathers among them, are the count from
    the shapes and feed the roofline's collective term."""
    res = dryrun.run_cell(arch, shape_name, mesh_shape=(2, 4))
    cfg = dataclasses.replace(get_config(arch), accum_steps=1)
    seq, batch, kind = dryrun.SHAPES[shape_name]
    plan = ShardPlan(AXES, p1=res["plan"]["p1"], p2=res["plan"]["p2"],
                     transition_repeat=res["plan"]["transition_repeat"])
    want = expected_calls(cfg, plan, (2, 4), batch, seq, 2, decode=kind == "decode")
    by_kind = {}
    for (k, _, _), (n, b) in want.items():
        by_kind.setdefault(k, [0, 0])
        by_kind[k][0] += n
        by_kind[k][1] += b
    coll = res["collectives"]
    assert coll["bytes_by_kind"] == {k: b for k, (_, b) in by_kind.items()}
    assert coll["count_by_kind"] == {k: n for k, (n, _) in by_kind.items()}
    assert coll["count_by_kind"]["all-to-all"] == 2 * sum(
        cfg.is_moe_block(layer) for layer in range(cfg.n_layers))
    assert res["roofline"]["collective_s"] == coll["total_bytes"] / 450e9
