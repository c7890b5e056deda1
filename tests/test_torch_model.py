"""repro_torch attention and model against the JAX reference on the CPU.

Same weights in both (the JAX init converted by ``repro_torch.convert``),
float32 smoke configs.  Tolerance 1e-4: the same math summed in another
order (the port's prefill attention is the flash kernel's plain version, the
reference's the einsum path; the port's rwkv prefill scan is the wkv6
kernel's plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jatt
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_kv_cache as jax_init_kv_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import attention as tatt
from repro_torch.models import decode_step, forward, init_kv_cache, init_params, loss_fn

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-3-8b", "gemma2-9b"]          # attention models
MODEL_ARCHS = ARCHS + ["rwkv6-3b", "jamba-v0.1-52b", "granite-moe-1b-a400m"]


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def pair(request):
    """(arch, JAX cfg, JAX params, port cfg, port model) on the same weights."""
    jcfg = jax_smoke_config(request.param)
    tcfg = get_smoke_config(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return request.param, jcfg, jparams, tcfg, params_from_jax(tcfg, _np_tree(jparams), "cpu")


def _close_caches(t_caches, j_caches):
    """Every leaf of every pattern slot: k/v, or the rwkv S/shift/shift_ffn."""
    assert len(t_caches) == len(j_caches)
    for tc, jc in zip(t_caches, j_caches):
        assert set(tc) == set(jc)
        for n in jc:
            _close(tc[n], jc[n])


def _tokens(cfg, B=2, S=12, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("explicit_positions", [False, True])
def test_attention_prefill_matches(arch, explicit_positions):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    window = jcfg.window
    jp = jatt.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    B, S = 2, 20
    x = np.random.default_rng(0).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    start = 5 if explicit_positions else 0
    pos = np.broadcast_to(np.arange(start, start + S), (B, S))
    j_out, (jk, jv) = jatt.attention_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), window)
    t_out, (tk, tv) = tatt.attention_prefill(
        tp, torch.from_numpy(x), tcfg,
        torch.from_numpy(pos.copy()) if explicit_positions else None, window)
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_matches(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = jatt.init_attn(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    B, T = 2, 24
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, T, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal((B, T, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    pos = np.array([5, 17])
    j_out, (jk, jv) = jatt.attention_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(ck),
                                            jnp.asarray(cv), jnp.asarray(pos), jcfg.window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t_out, (tk2, tv2) = tatt.attention_decode(tp, torch.from_numpy(x), tcfg, tk, tv,
                                              torch.from_numpy(pos), tcfg.window)
    assert tk2 is tk and tv2 is tv          # updated in place
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)


def test_forward_logits_and_caches_match(pair):
    _, jcfg, jparams, tcfg, model = pair
    toks = _tokens(jcfg)
    j_logits, j_caches = jax_forward(jparams, jcfg, jnp.asarray(toks), collect_cache=True)
    t_logits, t_caches = forward(model, torch.from_numpy(toks), collect_cache=True)
    assert t_logits.shape == (2, 12, tcfg.padded_vocab) and t_logits.dtype == torch.float32
    _close(t_logits, j_logits)
    _close_caches(t_caches, j_caches)


def test_forward_explicit_positions_match(pair):
    _, jcfg, jparams, _, model = pair
    toks = _tokens(jcfg, seed=4)
    pos = np.broadcast_to(np.arange(3, 15), toks.shape).copy()
    j_logits, _ = jax_forward(jparams, jcfg, jnp.asarray(toks), positions=jnp.asarray(pos))
    t_logits, _ = forward(model, torch.from_numpy(toks), positions=torch.from_numpy(pos))
    _close(t_logits, j_logits)


def test_decode_steps_match(pair):
    _, jcfg, jparams, tcfg, model = pair
    B, T = 2, 16
    toks = _tokens(jcfg, B=B, S=10, seed=5)
    j_caches = jax_init_kv_cache(jcfg, B, T, jnp.float32)
    t_caches = init_kv_cache(tcfg, B, T, torch.float32, "cpu")
    j_step = jax.jit(jax_decode_step, static_argnums=1)
    for t in range(toks.shape[1]):
        pos = np.full((B,), t)
        j_logits, j_caches = j_step(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos), j_caches)
        t_logits, t_caches = decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos), t_caches)
        _close(t_logits, j_logits)
    _close_caches(t_caches, j_caches)


def test_loss_matches(pair):
    _, jcfg, jparams, _, model = pair
    toks = _tokens(jcfg, seed=6)
    labels = _tokens(jcfg, S=8, seed=7)
    j_loss = jax_loss_fn(jparams, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    _close(loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labels)), j_loss)


def test_init_params_shapes_and_scales():
    cfg = get_smoke_config("gemma2-9b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.lm_head is None                       # tied head
    assert len(model.blocks) == cfg.n_layers
    assert [b.window for b in model.blocks] == [cfg.window, 0] * (cfg.n_layers // 2)
    assert model.embed.shape == (cfg.padded_vocab, cfg.d_model)
    wq = model.blocks[0].attn["wq"]
    assert wq.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch, entry", [("paligemma-3b", "A4"), ("musicgen-medium", "A4")])
def test_unported_families_raise(arch, entry):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {entry}"):
        init_params(get_smoke_config(arch), torch.Generator(), "cpu")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_then_decode_consistency(arch):
    """Token-by-token decode reproduces the prefill logits and, for rwkv, the
    collected state (tests/test_arch_smoke.py's check, on the port)."""
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    B, S = 2, 6
    toks = torch.from_numpy(_tokens(cfg, B=B, S=S, seed=7))
    full_logits, pre_caches = forward(model, toks, collect_cache=True)
    caches = init_kv_cache(cfg, B, 8, torch.float32, "cpu")
    outs = []
    for t in range(S):
        lg, caches = decode_step(model, toks[:, t:t + 1], torch.full((B,), t), caches)
        outs.append(lg[:, 0])
    tol = dict(rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(torch.stack(outs, dim=1), full_logits, **tol)
    for slot, pre in zip(caches, pre_caches):
        for n in set(pre) & {"S", "shift", "shift_ffn", "h", "conv"}:   # recurrent state
            torch.testing.assert_close(slot[n], pre[n], **tol)


def _leaves(tree, prefix=""):
    for n, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{n}.")
        else:
            yield f"{prefix}{n}", v


def _block_leaves(blk):
    """name -> tensor of one port block, in the reference's nested naming."""
    out = {n: getattr(blk, n) for n in ("ln1", "ln2")}
    for group in ("attn", "ffn", "moe", "mamba", "rwkv"):
        sub = getattr(blk, group, None)
        if sub is not None:
            out.update({f"{group}.{n}": t for n, t in sub.items()})
    return out


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-1b-a400m"])
def test_params_from_jax_carries_every_moe_and_mamba_leaf(arch):
    """Layer r * P + pi gets leaf [r] of slot pi, [R, E, d, ff] -> [E, d, ff]."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(2)))
    model = params_from_jax(tcfg, jparams, "cpu")
    P = len(jcfg.expanded_pattern)
    seen = set()
    for layer, blk in enumerate(model.blocks):
        r, pi = divmod(layer, P)
        want = dict(_leaves(jparams["blocks"][pi]))
        got = _block_leaves(blk)
        assert set(got) == set(want), layer
        for n, a in want.items():
            np.testing.assert_array_equal(got[n].numpy(), a[r])
        seen |= {n.split(".")[0] for n in got}
    assert {"moe", "mamba"} & seen == ({"moe", "mamba"} if "jamba" in arch else {"moe"})


def test_init_params_mamba_and_moe_leaves():
    """The reference's leaf shapes and dtypes (bf16 params), init_mamba's and
    init_moe's scales: dt_bias in the param dtype, A_log, D and the router
    in fp32."""
    arch = "jamba-v0.1-52b"
    jcfg = dataclasses.replace(jax_smoke_config(arch), param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    model = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(lambda k: jax_init_params(jcfg, k), jax.random.PRNGKey(0))
    P = len(jcfg.expanded_pattern)
    for layer, blk in enumerate(model.blocks):
        want = dict(_leaves(jshapes["blocks"][layer % P]))
        got = _block_leaves(blk)
        assert set(got) == set(want), layer
        for n, s in want.items():
            assert tuple(got[n].shape) == s.shape[1:], n
            assert str(got[n].dtype).removeprefix("torch.") == s.dtype.name, n
    d, di, N = tcfg.d_model, tcfg.mamba_expand * tcfg.d_model, tcfg.mamba_d_state
    m = model.blocks[0].mamba
    assert (m["dt_bias"] == -4.59375).all()            # -4.6 rounded to bf16
    torch.testing.assert_close(m["A_log"], torch.log(torch.arange(1.0, N + 1)).repeat(di, 1))
    assert (m["D"] == 1).all() and (m["conv_b"] == 0).all()
    assert abs(m["in_proj"].float().std().item() - d ** -0.5) < 0.01
    assert abs(m["conv_w"].float().std().item() - 0.2) < 0.03
    moe = model.blocks[1].moe
    assert model.blocks[0].moe is None and model.blocks[0].ffn is not None
    assert abs(moe["router"].std().item() - d ** -0.5) < 0.02
    assert abs(moe["w2"].float().std().item() - tcfg.d_ff ** -0.5) < 0.01
