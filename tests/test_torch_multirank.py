"""The serving steps on a mesh of ranks against the reference on one device.

Each mesh's ranks are gloo processes on the CPU (``launch.mesh.run_ranks``).
On the (2, 2) and (1, 4) (data, model) meshes, the smoke granite-3-8b and
gemma2-9b run their prefill and 4 decode steps under ISP, WSP and a mixed
plan (WSP then ISP from repeat 1), on the reference's weights
(``convert.params_from_jax``); the gathered logits are held to the
reference's single-device ``forward`` / ``decode_step`` within
``tests/test_torch_model.py``'s bound (1e-4: the same math summed in
another order), at an S that neither model axis divides.  Each plan's
recorded collectives are held to Table II (ISP: all-reduces; WSP: weight
and K/V all-gathers, nothing on the residual; the transition: one
activation all-gather) and their bytes to a count from the shapes.  A
data-only (2, 1) mesh runs rwkv6-3b by batch split.  The plain
``attention_ref`` with ``q_offset`` is held to the reference's attention
sliced to those rows, its gradient to ``jax.grad`` of the reference's
attention restricted to them, and what lies outside the slices built so
far raises, naming its ROADMAP item: llama4-maverick's Adafactor step on a
mesh (A13c-3b), int8 gradient compression on a mesh (A13c-5), a multi-pod
mesh (A13c-4).  MoE on a mesh is ``tests/test_torch_multirank_moe.py``'s.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_kv_cache as jax_init_kv_cache
from repro.models import init_params as jax_init_params

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.cost import visible_pairs
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cost,
                                                        flash_attention_bwd_kernel,
                                                        flash_attention_cost)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import collective_stats
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.runtime.sharding import ShardPlan
from repro_torch.runtime.train import build_train_step
from torch_parity import serve_cases_on_rank, serve_rows_on_rank

TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_torch_model.py's
AXES = ("data", "model")
ARCHS = ["granite-3-8b", "gemma2-9b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
PLANS = {"isp": {}, "wsp": dict(p1="WSP", p2="WSP"),
         "mixed": dict(p1="WSP", p2="ISP", transition_repeat=1)}
B, S, STEPS = 4, 13, 4                  # S % 2 and S % 4 are not 0
T = S + STEPS


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _reference(arch):
    """(params, tokens, caches after the prefill padded to T positions,
    decode tokens, prefill logits, decode logits) of the reference."""
    cfg = jax_smoke_config(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dtoks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    logits, caches = jax.jit(lambda p, t: jax_forward(p, cfg, t, collect_cache=True))(
        params, jnp.asarray(tokens))
    # k / v padded to T positions; the rwkv states as they are
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
    return _np_tree(params), tokens, start, dtoks, np.asarray(logits), np.stack(dec)


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request):
    payload = {}
    for arch in ARCHS:
        params, tokens, caches, dtoks = _reference(arch)[:4]
        payload[arch] = (arch, {}, params, tokens, None, caches, dtoks, tuple(PLANS))
    shape = MESHES[request.param]
    return shape, run_ranks(serve_cases_on_rank, shape, AXES, payload, PLANS, T, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


CASES = [(a, p) for a in ARCHS for p in PLANS]


@pytest.mark.parametrize("arch,plan", CASES)
def test_prefill_logits_match_reference(mesh_run, arch, plan):
    shape, ranks = mesh_run
    cfg = get_smoke_config(arch)
    for res in ranks:
        r = res[(arch, plan)]
        assert r["local_shape"] == (B // shape[0], S, cfg.padded_vocab // shape[1])
        _close(r["logits"], _reference(arch)[4])


@pytest.mark.parametrize("arch,plan", CASES)
def test_decode_logits_match_reference(mesh_run, arch, plan):
    _, ranks = mesh_run
    for res in ranks:
        _close(res[(arch, plan)]["decode"], _reference(arch)[5])


def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_prefill_calls(cfg, plan, shape, batch, seq, dt):
    """{(kind, axis, tag): [calls, bytes]} of one rank's prefill, counted
    from the shapes: Table II's collectives of each zone at its layout."""
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    m = shape[1]
    Bl = batch // shape[0] if plan.use_dp else batch
    Sl = -(-seq // m)
    Sp = Sl * m
    kvl = KV // m if m <= KV else 1          # whole kv heads a rank holds
    calls = {}

    def add(kind, tag, nbytes):
        c = calls.setdefault((kind, "model", tag), [0, 0])
        c[0] += 1
        c[1] += nbytes

    cur = plan.p1
    if cur == "ISP":
        add("all-reduce", "embed", Bl * seq * d * dt)
    else:
        add("reduce-scatter", "embed", Bl * Sl * d * dt)
    for layer in range(cfg.n_layers):
        part = _partition(cfg, plan, layer)
        if part != cur:
            assert cur == "WSP"
            add("all-gather", "transition", Bl * Sp * d * dt)
            cur = part
        tag = f"blk{layer}"
        if part == "ISP":                                # row-parallel partials, fp32
            add("all-reduce", f"{tag}:attn", Bl * seq * d * 4)
            add("all-reduce", f"{tag}:ffn", Bl * seq * d * 4)
        else:                                            # weights at use, and the K/V halo
            add("all-gather", f"{tag}:wq", d * H * hd * dt)
            add("all-gather", f"{tag}:wk", m * d * kvl * hd * dt)
            add("all-gather", f"{tag}:wv", m * d * kvl * hd * dt)
            add("all-gather", f"{tag}:kv", 2 * Bl * Sp * KV * hd * dt)
            add("all-gather", f"{tag}:wo", H * hd * d * dt)
            for w in ("w1", "w2", "w3")[:3 if cfg.ffn_gated else 2]:
                add("all-gather", f"{tag}:{w}", d * ff * dt)
    if cur == "WSP":
        add("all-gather", "logits", Bl * Sp * d * dt)
    return calls


def expected_decode_calls(cfg, shape, batch, dt):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = shape[1]
    Bl = batch // shape[0]
    hl, kvl = H // m, (KV // m if m <= KV else 1)
    calls = {("all-reduce", "model", "embed"): [1, Bl * d * dt]}
    for layer in range(cfg.n_layers):
        tag = f"blk{layer}"
        calls[("all-gather", "model", f"{tag}:qkv")] = [1, m * Bl * (hl + 2 * kvl) * hd * dt]
        calls[("all-reduce", "model", f"{tag}:max")] = [1, Bl * H * 4]
        calls[("all-reduce", "model", f"{tag}:sum")] = [1, Bl * H * (1 + hd) * 4]
        calls[("all-reduce", "model", f"{tag}:attn")] = [1, Bl * d * 4]
        calls[("all-reduce", "model", f"{tag}:ffn")] = [1, Bl * d * 4]
    return calls


@pytest.mark.parametrize("arch,plan", CASES)
def test_collectives_follow_table_ii(mesh_run, arch, plan):
    shape, ranks = mesh_run
    cfg = get_smoke_config(arch)
    splan = ShardPlan(AXES, **PLANS[plan])
    want = expected_prefill_calls(cfg, splan, shape, B, S, 4)
    for res in ranks:
        assert res[(arch, plan)]["calls"] == want
    for layer in range(cfg.n_layers):               # each layer's collectives
        kinds = {k for k, _, t in want if t.startswith(f"blk{layer}:")}
        assert kinds == ({"all-reduce"} if _partition(cfg, splan, layer) == "ISP"
                         else {"all-gather"})        # WSP: nothing on the residual
    tags = [t for _, _, t in want]
    assert tags.count("transition") == (plan == "mixed")
    if plan == "isp":
        assert {k for k, _, _ in want} == {"all-reduce"}


@pytest.mark.parametrize("arch,plan", CASES)
def test_decode_collectives_counted_from_shapes(mesh_run, arch, plan):
    shape, ranks = mesh_run
    want = expected_decode_calls(get_smoke_config(arch), shape, B, 4)
    for res in ranks:
        assert res[(arch, plan)]["decode_calls"] == want


# ---------------------------------------------------------- data-only mesh

def test_rwkv_on_a_data_only_mesh_matches_reference():
    params, tokens, caches, dtoks, logits, dec = _reference("rwkv6-3b")
    for calls, got, got_dec in run_ranks(serve_rows_on_rank, (2, 1), AXES, "rwkv6-3b",
                                         params, tokens, caches, dtoks, T, device="cpu"):
        assert calls == {}          # each rank runs its rows; nothing crosses ranks
        _close(got, logits)
        _close(got_dec, dec)


# ------------------------------------------------------------ the offset

@pytest.mark.parametrize("offset,n,window,cap", [(8, 8, 0, 0.0), (13, 7, 0, 50.0),
                                                 (16, 16, 6, 0.0), (5, 11, 9, 30.0)])
def test_attention_ref_offset_matches_reference_rows(offset, n, window, cap):
    """Queries at positions offset .. offset+n-1 against keys 0 .. offset+n-1
    (a WSP rank's call) are the reference's rows of the whole causal
    attention."""
    rng = np.random.default_rng(offset)
    Bq, H, KV, hd, L = 2, 4, 2, 16, offset + n
    q = rng.standard_normal((Bq, H, L, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, KV, L, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, KV, L, hd)).astype(np.float32)
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                                        window, cap))[:, :, offset:]
    got = attention_ref(torch.from_numpy(q[:, :, offset:].copy()), torch.from_numpy(k),
                        torch.from_numpy(v), True, window, cap, q_offset=offset)
    _close(got.numpy(), want)
    assert flash_attention(torch.from_numpy(q[:, :, offset:].copy()), torch.from_numpy(k),
                           torch.from_numpy(v), True, window, cap, q_offset=offset).equal(got)


def test_offset_cost_counts_the_visible_pairs():
    def loop(Sq, Skv, window, off):
        return sum(max(min(q, Skv - 1) - (max(q - window + 1, 0) if window else 0) + 1, 0)
                   for q in range(off, off + Sq))
    for case in [(16, 32, 0, 16), (8, 40, 12, 32), (10, 10, 0, 0), (4, 64, 3, 60)]:
        assert visible_pairs(case[0], case[1], True, case[2], case[3]) == loop(*case)
    q = torch.empty(1, 2, 16, 64, device="meta")
    k = torch.empty(1, 2, 32, 64, device="meta")
    assert flash_attention_cost(q, k, k, q_offset=16).flops == 4 * 2 * 64 * visible_pairs(
        16, 32, True, 0, 16)


OFFSET_GRAD_CASES = [(8, 8, 0, 0.0), (13, 7, 0, 50.0), (16, 16, 6, 0.0), (5, 11, 9, 30.0),
                     (24, 8, 4, 0.0)]


@pytest.mark.parametrize("offset,n,window,cap", OFFSET_GRAD_CASES)
def test_offset_gradient_matches_reference_rows(offset, n, window, cap):
    """The gradient of a WSP rank's call (queries at positions offset ..
    offset+n-1 against keys 0 .. offset+n-1) through ``flash_attention``'s
    CPU route (``attention_ref`` under autograd) against ``jax.grad`` of the
    reference's whole causal attention with a cotangent on those rows only:
    dq of the rows, dk and dv of every key (0 for keys no row sees)."""
    rng = np.random.default_rng(100 + offset)
    Bq, H, KV, hd, L = 2, 4, 2, 16, offset + n
    q = rng.standard_normal((Bq, H, L, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, KV, L, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, KV, L, hd)).astype(np.float32)
    do = rng.standard_normal((Bq, H, n, hd)).astype(np.float32)
    cot = np.zeros((Bq, H, L, hd), np.float32)
    cot[:, :, offset:] = do

    def f(q_, k_, v_):
        return jnp.sum(jax_attention_ref(q_, k_, v_, True, window, cap) * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q[:, :, offset:].copy(), k, v)]
    out = flash_attention(*leaves, True, window, cap, q_offset=offset)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _close(got[0].numpy(), np.asarray(want[0])[:, :, offset:])
    _close(got[1].numpy(), np.asarray(want[1]))
    _close(got[2].numpy(), np.asarray(want[2]))
    if window:
        unseen = slice(0, max(offset - window + 1, 0))
        assert not got[1][:, :, unseen].any() and not got[2][:, :, unseen].any()


@pytest.mark.parametrize("offset,n,window,cap", OFFSET_GRAD_CASES)
def test_offset_backward_meta_route_counts_the_visible_pairs(offset, n, window, cap):
    """The backward kernel's meta route (the dry-run) counts five products
    over the pairs the offset leaves visible, and allocates its outputs."""
    q = torch.empty(1, 4, n, 64, device="meta")
    k = torch.empty(1, 2, offset + n, 64, device="meta")
    assert flash_attention_bwd_cost(q, k, k, True, window, offset).flops == \
        10 * 4 * 64 * visible_pairs(n, offset + n, True, window, offset)
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.kernel import SavedForward, lse_rows
    saved = SavedForward(torch.empty_like(q), torch.empty(1, 4, lse_rows(n), device="meta"),
                         None)
    with cost.tally() as calls:
        dq, dk, dv = flash_attention_bwd_kernel(q, k, k, torch.empty_like(q), saved,
                                                window=window, softcap=cap, q_offset=offset)
    assert calls == [("flash_attention_bwd_kernel",
                      flash_attention_bwd_cost(q, k, k, True, window, offset))]
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def _adafactor_mesh_step():
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    build_train_step(cfg, ShardPlan(AXES), device="meta", mesh=make_mesh((1, 2), AXES, meta=True))


def _compressed_mesh_step():
    cfg = get_smoke_config("granite-3-8b")
    build_train_step(cfg, ShardPlan(AXES), compress=True, device="meta",
                     mesh=make_mesh((2, 1), AXES, meta=True))


def _multi_pod_dryrun():
    dryrun.main(["--arch", "granite-3-8b", "--shape", "prefill_32k", "--multi-pod"])


@pytest.mark.parametrize("run,item", [(_adafactor_mesh_step, "A13c-3b"),
                                      (_compressed_mesh_step, "A13c-5"),
                                      (_multi_pod_dryrun, "A13c-4")],
                         ids=["adafactor-mesh-step", "compress-on-a-mesh", "multi-pod"])
def test_outside_this_slice_raises_naming_a13c(run, item):
    with pytest.raises(NotImplementedError, match=item):
        run()


# ------------------------------------------------------------ the dry-run

@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_dryrun_mesh_cell_counts_the_collectives(shape_name):
    """A (2, 4) rank of granite-3-8b traced on meta: its recorded collectives
    are the count from the shapes, and feed the roofline's term."""
    res = dryrun.run_cell("granite-3-8b", shape_name, mesh_shape=(2, 4))
    cfg = dataclasses.replace(dryrun.get_config("granite-3-8b"), accum_steps=1)
    seq, batch, kind = dryrun.SHAPES[shape_name]
    plan = ShardPlan(AXES, p1=res["plan"]["p1"], p2=res["plan"]["p2"],
                     transition_repeat=res["plan"]["transition_repeat"])
    want = (expected_prefill_calls(cfg, plan, (2, 4), batch, seq, 2) if kind == "prefill"
            else expected_decode_calls(cfg, (2, 4), batch, 2))
    by_kind = {}
    for (k, _, _), (n, b) in want.items():
        by_kind.setdefault(k, [0, 0])
        by_kind[k][0] += n
        by_kind[k][1] += b
    coll = res["collectives"]
    assert coll["bytes_by_kind"] == {k: b for k, (_, b) in by_kind.items()}
    assert coll["count_by_kind"] == {k: n for k, (n, _) in by_kind.items()}
    assert res["roofline"]["collective_s"] == coll["total_bytes"] / 450e9
    assert res["kernel_calls"].get("flash_attention_kernel", 0) == (
        cfg.n_layers if kind == "prefill" else 0)


def test_collective_stats_reads_the_recorder():
    mesh = make_mesh((1, 4), AXES, meta=True)
    x = torch.empty(2, 8, dtype=torch.bfloat16, device="meta")
    mesh.comm.all_gather(x, dim=1, tag="a")
    mesh.comm.all_reduce(x, tag="b")
    mesh.comm.reduce_scatter(x, dim=1, tag="c")
    mesh.comm.all_reduce(x, axis="data", tag="size-one axis")
    stats = collective_stats(mesh.comm)
    assert stats.bytes_by_kind == {"all-gather": 2 * 32 * 2, "all-reduce": 2 * 8 * 2,
                                   "reduce-scatter": 2 * 2 * 2}
    assert stats.count_by_kind == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
