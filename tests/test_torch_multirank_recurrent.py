"""The serving steps of the recurrent blocks and the frontend stubs on a
mesh of ranks against the reference on one device.

The smoke rwkv6-3b, jamba-v0.1-52b with a dense FFN on every layer
(``moe=None`` on both packages' configs: MoE on a mesh is ROADMAP A13c-3),
paligemma-3b (vision stub, MQA) and musicgen-medium (audio stub) run their
prefill and 4 decode steps on (2, 2) and (1, 4) (data, model) meshes of
gloo ranks under ISP, WSP and a mixed plan (WSP then ISP from repeat 1),
and the two with attention layers also with the decode cache whole over
time (``shard_kv_cache_time=False``), on the reference's weights
(``convert.params_from_jax``).  Held: the gathered logits against the
reference's single-device ``forward`` / ``decode_step`` within
``tests/test_torch_model.py``'s bound (1e-4) at an S that neither model
axis divides; the recorded collectives against a count from the shapes;
the rank's caches against the placement (its rwkv heads of ``S``, its
mamba channels, whole token shifts; its kv heads over the whole time);
the dry-run's (2, 4) rwkv6-3b cells counting the same; and a model axis
that would split inside an rwkv head raising, naming ROADMAP A13c-6.
"""
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
from repro_torch.models.model import init_kv_cache, init_params
from repro_torch.runtime.sharding import ShardPlan, rank_shard, shard_caches, shard_model
from torch_parity import serve_cases_on_rank

TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_torch_model.py's
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
PLANS = {"isp": {}, "wsp": dict(p1="WSP", p2="WSP"),
         "mixed": dict(p1="WSP", p2="ISP", transition_repeat=1),
         "whole_time": dict(shard_kv_cache_time=False)}
# name -> (arch, config overrides on both packages' smoke configs, plans)
CASES = {
    "rwkv6-3b": ("rwkv6-3b", {}, ("isp", "wsp", "mixed")),
    "jamba-dense": ("jamba-v0.1-52b", {"moe": None}, ("isp", "wsp", "mixed", "whole_time")),
    "paligemma-3b": ("paligemma-3b", {}, ("isp", "wsp", "mixed", "whole_time")),
    "musicgen-medium": ("musicgen-medium", {}, ("isp", "wsp", "mixed")),
}
B, S, STEPS = 4, 13, 4                  # S % 2 and S % 4 are not 0
T = S + STEPS


def _cfg(name, jax_side=False):
    arch, over, _ = CASES[name]
    return dataclasses.replace((jax_smoke_config if jax_side else get_smoke_config)(arch), **over)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _reference(name):
    """(params, tokens or None, frontend embeddings or None, the caches
    after the prefill with k / v padded to T positions, decode tokens,
    prefill logits, decode logits) of the reference."""
    cfg = _cfg(name, jax_side=True)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tokens = femb = None
    scale = cfg.d_model ** -0.5                # the token embeddings' scale
    if cfg.frontend == "audio_stub":
        femb = (scale * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    else:
        P = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
        tokens = rng.integers(0, cfg.vocab, (B, S - P)).astype(np.int32)
        if P:
            femb = (scale * rng.standard_normal((B, P, cfg.d_model))).astype(np.float32)
    dtoks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    logits, caches = jax.jit(lambda p, t, f: jax_forward(p, cfg, t, f, collect_cache=True))(
        params, None if tokens is None else jnp.asarray(tokens),
        None if femb is None else jnp.asarray(femb))
    full = jax_init_kv_cache(cfg, B, T, jnp.float32)
    caches = tuple({n: full[i][n].at[:, :, :S].set(c[n]) if n in ("k", "v") else c[n]
                    for n in c} for i, c in enumerate(caches))
    start = _np_tree(caches)
    step = jax.jit(lambda p, tok, pos, c: jax_decode_step(p, cfg, tok, pos, c))
    dec = []
    for t in range(STEPS):
        lg, caches = step(params, jnp.asarray(dtoks[t]), jnp.full((B,), S + t, jnp.int32),
                          caches)
        dec.append(np.asarray(lg))
    return _np_tree(params), tokens, femb, start, dtoks, np.asarray(logits), np.stack(dec)


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request):
    payload = {}
    for name, (arch, over, plans) in CASES.items():
        params, tokens, femb, caches, dtoks, _, _ = _reference(name)
        payload[name] = (arch, over, params, tokens, femb, caches, dtoks, plans)
    shape = MESHES[request.param]
    return shape, run_ranks(serve_cases_on_rank, shape, AXES, payload, PLANS, T, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


RUNS = [(n, p) for n, (_, _, plans) in CASES.items() for p in plans]


@pytest.mark.parametrize("name,plan", RUNS)
def test_prefill_logits_match_reference(mesh_run, name, plan):
    shape, ranks = mesh_run
    cfg = _cfg(name)
    for res in ranks:
        r = res[(name, plan)]
        assert r["local_shape"] == (B // shape[0], S, cfg.padded_vocab // shape[1])
        _close(r["logits"], _reference(name)[5])


@pytest.mark.parametrize("name,plan", RUNS)
def test_decode_logits_match_reference(mesh_run, name, plan):
    _, ranks = mesh_run
    for res in ranks:
        _close(res[(name, plan)]["decode"], _reference(name)[6])


# ------------------------------------------------------------ collectives

def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_prefill_calls(cfg, plan, shape, batch, seq, dt):
    """{(kind, axis, tag): [calls, bytes]} of one rank's prefill of any
    block kind, counted from the shapes.  Attention and the FFN as
    ``tests/test_torch_multirank.py`` counts them; an rwkv layer's time mix
    ends in an all-reduce (ISP) or a reduce-scatter over the sequence
    (WSP), its channel mix in a reduce-scatter over the features and an
    all-gather; a mamba layer adds up ``x_proj``'s output and ends in an
    all-reduce or a reduce-scatter; a recurrent mixer in a WSP zone first
    all-gathers the zone's positions (and runs on the ``seq`` real ones).
    Partial sums travel in fp32."""
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    m = shape[1]
    Bl = batch // shape[0] if plan.use_dp else batch
    Sl = -(-seq // m)
    Sp = Sl * m
    kvl = KV // m if m <= KV else 1
    R, N = max(1, d // 16), cfg.mamba_d_state
    calls = {}

    def add(kind, tag, nbytes):
        c = calls.setdefault((kind, "model", tag), [0, 0])
        c[0] += 1
        c[1] += nbytes

    cur = plan.p1
    if cfg.frontend != "audio_stub":                 # the audio stub looks up nothing
        P = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
        if cur == "ISP":
            add("all-reduce", "embed", Bl * (seq - P) * d * dt)
        else:
            add("reduce-scatter", "embed", Bl * Sl * d * dt)
    for layer, kind in enumerate(cfg.block_kinds()):
        part = _partition(cfg, plan, layer)
        if part != cur:
            add("all-gather", "transition", Bl * Sp * d * dt)
            cur = part
        tag = f"blk{layer}"
        wsp = part == "WSP"
        if kind in ("attn", "local"):
            if not wsp:
                add("all-reduce", f"{tag}:attn", Bl * seq * d * 4)
            else:
                add("all-gather", f"{tag}:wq", d * H * hd * dt)
                add("all-gather", f"{tag}:wk", m * d * kvl * hd * dt)
                add("all-gather", f"{tag}:wv", m * d * kvl * hd * dt)
                add("all-gather", f"{tag}:kv", 2 * Bl * Sp * KV * hd * dt)
                add("all-gather", f"{tag}:wo", H * hd * d * dt)
        elif kind == "rwkv":
            if wsp:
                add("all-gather", f"{tag}:tm_in", Bl * Sp * d * dt)
                add("reduce-scatter", f"{tag}:tm", Bl * Sl * d * 4)
                add("all-gather", f"{tag}:cm_in", Bl * Sp * d * dt)
            else:
                add("all-reduce", f"{tag}:tm", Bl * seq * d * 4)
            add("reduce-scatter", f"{tag}:cm_v", Bl * seq * d // m * 4)
            add("all-gather", f"{tag}:cm", Bl * seq * d * dt)
        else:                                        # mamba
            if wsp:
                add("all-gather", f"{tag}:mamba_in", Bl * Sp * d * dt)
                add("reduce-scatter", f"{tag}:mamba", Bl * Sl * d * 4)
            else:
                add("all-reduce", f"{tag}:mamba", Bl * seq * d * 4)
            add("all-reduce", f"{tag}:x_proj", Bl * seq * (R + 2 * N) * 4)
        if kind == "rwkv":
            continue
        if not wsp:
            add("all-reduce", f"{tag}:ffn", Bl * seq * d * 4)
        else:
            for w in ("w1", "w2", "w3")[:3 if cfg.ffn_gated else 2]:
                add("all-gather", f"{tag}:{w}", d * ff * dt)
    if cur == "WSP":
        add("all-gather", "logits", Bl * Sp * d * dt)
    return calls


def expected_decode_calls(cfg, plan, shape, batch, dt):
    """One rank's decode step (ISP), counted from the shapes: an attention
    layer's as ``tests/test_torch_multirank.py`` counts them, or over a
    cache whole over time the output's all-reduce alone; an rwkv layer's
    and a mamba layer's as in the prefill at one position."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = shape[1]
    Bl = batch // shape[0]
    hl, kvl = H // m, (KV // m if m <= KV else 1)
    R, N = max(1, d // 16), cfg.mamba_d_state
    calls = {("all-reduce", "model", "embed"): [1, Bl * d * dt]}
    for layer, kind in enumerate(cfg.block_kinds()):
        tag = f"blk{layer}"
        if kind in ("attn", "local"):
            if plan.shard_kv_cache_time:
                calls[("all-gather", "model", f"{tag}:qkv")] = [1, m * Bl * (hl + 2 * kvl) * hd * dt]
                calls[("all-reduce", "model", f"{tag}:max")] = [1, Bl * H * 4]
                calls[("all-reduce", "model", f"{tag}:sum")] = [1, Bl * H * (1 + hd) * 4]
            calls[("all-reduce", "model", f"{tag}:attn")] = [1, Bl * d * 4]
        elif kind == "rwkv":
            calls[("all-reduce", "model", f"{tag}:tm")] = [1, Bl * d * 4]
            calls[("reduce-scatter", "model", f"{tag}:cm_v")] = [1, Bl * d // m * 4]
            calls[("all-gather", "model", f"{tag}:cm")] = [1, Bl * d * dt]
            continue
        else:
            calls[("all-reduce", "model", f"{tag}:x_proj")] = [1, Bl * (R + 2 * N) * 4]
            calls[("all-reduce", "model", f"{tag}:mamba")] = [1, Bl * d * 4]
        calls[("all-reduce", "model", f"{tag}:ffn")] = [1, Bl * d * 4]
    return calls


@pytest.mark.parametrize("name,plan", RUNS)
def test_prefill_collectives_counted_from_shapes(mesh_run, name, plan):
    shape, ranks = mesh_run
    want = expected_prefill_calls(_cfg(name), ShardPlan(AXES, **PLANS[plan]), shape, B, S, 4)
    for res in ranks:
        assert res[(name, plan)]["calls"] == want


@pytest.mark.parametrize("name,plan", RUNS)
def test_decode_collectives_counted_from_shapes(mesh_run, name, plan):
    shape, ranks = mesh_run
    want = expected_decode_calls(_cfg(name), ShardPlan(AXES, **PLANS[plan]), shape, B, 4)
    for res in ranks:
        assert res[(name, plan)]["decode_calls"] == want


# ------------------------------------------------------------------ caches

def _piece_shapes(cfg, plan, shape, batch, max_len):
    """Each cache's piece on a rank, from the placement: the reference's
    ``cache_pspecs`` (a ``model`` entry divides the dim), except the k / v
    of a cache whole over time, whose rank holds its kv heads."""
    d, KV, hd, m = cfg.d_model, cfg.n_kv_heads, cfg.head_dim, shape[1]
    R, Bl = cfg.pattern_repeats, batch // shape[0]
    di, rhd = cfg.mamba_expand * d, cfg.rwkv_head_dim
    out = []
    for kind in cfg.expanded_pattern:
        if kind == "rwkv":
            out.append({"S": (R, Bl, d // rhd // m, rhd, rhd), "shift": (R, Bl, 1, d),
                        "shift_ffn": (R, Bl, 1, d)})
        elif kind == "mamba":
            out.append({"h": (R, Bl, di // m, cfg.mamba_d_state),
                        "conv": (R, Bl, cfg.mamba_d_conv - 1, di // m)})
        else:
            kv = ((R, Bl, -(-max_len // m), KV, hd) if plan.shard_kv_cache_time
                  else (R, Bl, max_len, KV // m if m <= KV else 1, hd))
            out.append({"k": kv, "v": kv})
    return out


@pytest.mark.parametrize("name,plan", RUNS)
def test_rank_caches_follow_the_placement(mesh_run, name, plan):
    shape, ranks = mesh_run
    want = _piece_shapes(_cfg(name), ShardPlan(AXES, **PLANS[plan]), shape, B, T)
    for res in ranks:
        assert res[(name, plan)]["cache_shapes"] == want
        assert res[(name, plan)]["init_shapes"] == want


@pytest.mark.parametrize("name,plan", [("rwkv6-3b", "isp"), ("jamba-dense", "isp"),
                                       ("jamba-dense", "whole_time")])
def test_shard_caches_cuts_the_state_pieces(name, plan):
    """Every model rank's pieces of whole caches (numbers, no processes:
    ranks of a meta mesh) put side by side again give the whole caches:
    ``S`` by heads, ``h`` and ``conv`` by channels, k / v by time; whole
    over time, each rank's k / v are the whole caches' kv heads it reads
    (the one kv head of the smoke jamba on every rank); the token shifts
    whole on every rank.  Every piece is a copy (decode writes it in place),
    also where it is the whole tensor (a data axis of 1)."""
    cfg = _cfg(name)
    splan = ShardPlan(AXES, **PLANS[plan])
    g = torch.Generator().manual_seed(5)
    whole = tuple({n: torch.randn(t.shape, generator=g) for n, t in slot.items()}
                  for slot in init_kv_cache(cfg, B, 16, torch.float32, "cpu"))
    m = 4
    shards = [rank_shard(cfg, splan, make_mesh((1, m), AXES, meta=True, coords=(0, r)))
              for r in range(m)]
    pieces = [shard_caches(whole, sh) for sh in shards]
    dims = {"S": 2, "h": 2, "conv": 3}
    if splan.shard_kv_cache_time:
        dims["k"] = dims["v"] = 2
    for i, slot in enumerate(whole):
        for n, t in slot.items():
            if n in dims:
                assert torch.equal(torch.cat([p[i][n] for p in pieces], dim=dims[n]), t), n
            elif n in ("k", "v"):
                for p, sh in zip(pieces, shards):
                    assert torch.equal(p[i][n], t[:, :, :, sh.kv_heads[0]:sh.kv_heads[1]]), n
            else:
                assert all(torch.equal(p[i][n], t) for p in pieces), n
            for p in pieces:
                assert p[i][n].untyped_storage().data_ptr() != t.untyped_storage().data_ptr()


# ------------------------------------------------------- an rwkv head split

@pytest.mark.parametrize("arch,m", [("rwkv6-3b", 16), ("rwkv6-3b-smoke", 8)])
def test_a_model_axis_inside_an_rwkv_head_raises_naming_a13c6(arch, m):
    cfg = get_smoke_config("rwkv6-3b") if arch.endswith("smoke") else get_config(arch)
    mesh = make_mesh((1, m), AXES, meta=True)
    with pytest.raises(NotImplementedError, match="A13c-6"):
        shard_model(init_params(cfg, None, "meta"), ShardPlan(AXES), mesh)


def test_dryrun_skips_an_rwkv_head_split(tmp_path, capsys):
    dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k", "--mesh", "1x16",
                 "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "skipped:" in out and "A13c-6" in out and "all cells passed" in out


# ------------------------------------------------------------ the dry-run

@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_dryrun_rwkv_mesh_cell_counts_the_collectives(shape_name):
    """A (2, 4) rank of rwkv6-3b traced on meta: its recorded collectives
    are the count from the shapes, and its WKV-6 launches one a layer in
    the prefill (the rank's heads), none in decode."""
    res = dryrun.run_cell("rwkv6-3b", shape_name, mesh_shape=(2, 4))
    cfg = dataclasses.replace(get_config("rwkv6-3b"), accum_steps=1)
    seq, batch, kind = dryrun.SHAPES[shape_name]
    plan = ShardPlan(AXES, p1=res["plan"]["p1"], p2=res["plan"]["p2"],
                     transition_repeat=res["plan"]["transition_repeat"])
    want = (expected_prefill_calls(cfg, plan, (2, 4), batch, seq, 2) if kind == "prefill"
            else expected_decode_calls(cfg, plan, (2, 4), batch, 2))
    by_kind = {}
    for (k, _, _), (n, b) in want.items():
        by_kind.setdefault(k, [0, 0])
        by_kind[k][0] += n
        by_kind[k][1] += b
    coll = res["collectives"]
    assert coll["bytes_by_kind"] == {k: b for k, (_, b) in by_kind.items()}
    assert coll["count_by_kind"] == {k: n for k, (n, _) in by_kind.items()}
    assert res["kernel_calls"].get("wkv6_kernel", 0) == (cfg.n_layers if kind == "prefill"
                                                          else 0)
