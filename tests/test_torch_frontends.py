"""The frontend stubs and explicit prefill positions on the port, against
the JAX reference on the CPU.

Same weights in both (the reference's init through ``params_from_jax``),
float32 smoke configs.  Port against reference at 1e-4 (the model parity
tests' bound: the same math summed in another order); prefill against
token-by-token decode within one package at 2e-3 (the port's
prefill-then-decode consistency bound).
"""
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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import attention as tatt
from repro_torch.models import decode_step, forward, init_kv_cache
from repro_torch.models import model as tmodel

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
B = 2


def _pair(arch, seed=0):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_decode(jcfg, jparams, caches, toks, start):
    j_step = jax.jit(jax_decode_step, static_argnums=1)
    out = []
    for t in range(toks.shape[1]):
        lg, caches = j_step(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), start + t, jnp.int32), caches)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, axis=1)


def _torch_decode(model, caches, toks, start):
    out = []
    for t in range(toks.shape[1]):
        lg, caches = decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), start + t), caches)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1).numpy()


def _jax_caches_from(jcfg, pre, T):
    """The prefill's collected k / v in the first positions of T-position caches."""
    full = jax_init_kv_cache(jcfg, B, T, jnp.float32)
    P = pre[0]["k"].shape[2]
    return tuple({n: c[n].at[:, :, :P].set(p[n]) for n in c} for c, p in zip(full, pre))


def _torch_caches_from(tcfg, pre, T):
    full = init_kv_cache(tcfg, B, T, torch.float32, "cpu")
    for c, p in zip(full, pre):
        for n in c:
            c[n][:, :, :p[n].shape[2]] = p[n]
    return full


def test_vision_prefix_then_decode_matches_whole_prefill():
    """paligemma: a prefill of the patches and the first text tokens (caches
    collected), then decode of the remaining text tokens, gives the whole
    prefill's logits at those positions; each step against the reference's
    same procedure on the same weights."""
    jcfg, jparams, tcfg, model = _pair("paligemma-3b")
    P, T_text, split = jcfg.frontend_tokens, 10, 4
    rng = np.random.default_rng(1)
    patches = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, T_text))

    j_whole, _ = jax_forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(patches))
    t_whole, _ = forward(model, torch.from_numpy(toks), torch.from_numpy(patches))
    assert t_whole.shape == (B, P + T_text, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(t_whole), np.asarray(j_whole), **TOL)

    T = P + T_text
    j_pre_logits, j_pre = jax_forward(jparams, jcfg, jnp.asarray(toks[:, :split]),
                                      jnp.asarray(patches), collect_cache=True)
    t_pre_logits, t_pre = forward(model, torch.from_numpy(toks[:, :split]),
                                  torch.from_numpy(patches), collect_cache=True)
    np.testing.assert_allclose(_np(t_pre_logits), np.asarray(j_pre_logits), **TOL)
    j_dec = _jax_decode(jcfg, jparams, _jax_caches_from(jcfg, j_pre, T), toks[:, split:],
                        P + split)
    t_dec = _torch_decode(model, _torch_caches_from(tcfg, t_pre, T), toks[:, split:], P + split)
    np.testing.assert_allclose(t_dec, j_dec, **TOL)
    # the decoded logits are the whole prefill's at the positions of those
    # tokens; the prefix prefill's are its first positions
    np.testing.assert_allclose(t_dec, _np(t_whole)[:, P + split:], **DECODE_TOL)
    np.testing.assert_allclose(_np(t_pre_logits), _np(t_whole)[:, :P + split], **DECODE_TOL)


def test_audio_frames_of_embedded_tokens_match_decode():
    """musicgen: a prefill on ``embed[tokens]`` as its frames gives the
    logits of token-by-token decode (which embeds the tokens); both against
    the reference on the same weights."""
    jcfg, jparams, tcfg, model = _pair("musicgen-medium")
    S = 10
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S))
    frames = np.asarray(jparams["embed"])[toks]

    j_logits, _ = jax_forward(jparams, jcfg, None, jnp.asarray(frames))
    t_logits, _ = forward(model, None, torch.from_numpy(frames))
    assert t_logits.shape == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)

    j_dec = _jax_decode(jcfg, jparams, jax_init_kv_cache(jcfg, B, S, jnp.float32), toks, 0)
    t_dec = _torch_decode(model, init_kv_cache(tcfg, B, S, torch.float32, "cpu"), toks, 0)
    np.testing.assert_allclose(t_dec, j_dec, **TOL)
    np.testing.assert_allclose(t_dec, _np(t_logits), **DECODE_TOL)


def _offset_positions(S, offsets=(5, 9)):
    return np.stack([o + np.arange(S) for o in offsets])


class _CountingRef:
    """Stands in for the flash call's plain version and counts its calls."""

    def __init__(self):
        self.calls = 0
        self.ref = tatt.attention_ref

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.ref(*args, **kwargs)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b"])
def test_offset_positions_take_the_kernel_route(arch, monkeypatch):
    """Rows at positions ``p0_b + 0..S-1`` (a different p0 in each row) go
    through the flash call (here its plain version, which masks from 0) with
    RoPE on the given positions, and match the reference's position-mask
    path: one attention layer, and gemma2's window (8 of S=20) and softcaps."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = jatt.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    S = 20
    x = np.random.default_rng(0).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = _offset_positions(S)
    ref = _CountingRef()
    monkeypatch.setattr(tatt, "attention_ref", ref)
    j_out, (jk, jv) = jatt.attention_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                             jcfg.window)
    t_out, (tk, tv) = tatt.attention_prefill(tp, torch.from_numpy(x), tcfg,
                                             torch.from_numpy(pos), tcfg.window, plain=True)
    assert ref.calls == 1
    for t, j in ((t_out, j_out), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b"])
def test_model_with_offset_positions_takes_the_kernel_route(arch, monkeypatch):
    """The whole model at per-row offset positions through the kernel
    route's plain version (every attention layer) against the reference's
    forward with the same positions; the positions are tested once for all
    layers (on the card, one host sync a forward)."""
    jcfg, jparams, tcfg, model = _pair(arch)
    S = 12
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S))
    pos = _offset_positions(S, (3, 40))
    ref = _CountingRef()
    monkeypatch.setattr(tatt, "attention_ref", ref)
    tests, runs_from_offsets = [], tatt.runs_from_offsets
    monkeypatch.setattr(tmodel, "runs_from_offsets",
                        lambda p: tests.append(p) or runs_from_offsets(p))
    monkeypatch.setattr(tatt, "runs_from_offsets", None)     # no layer tests again
    j_logits, _ = jax_forward(jparams, jcfg, jnp.asarray(toks), positions=jnp.asarray(pos))
    t_logits, _ = model(torch.from_numpy(toks), positions=torch.from_numpy(pos),
                        plain_attention=True)
    assert ref.calls == tcfg.n_layers and len(tests) == 1
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)


def test_other_positions_keep_the_masked_path_on_the_cpu(monkeypatch):
    """Positions with a gap are not ``p0 + 0..S-1``: the CPU runs the masked
    path (no flash call), which matches the reference."""
    jcfg, tcfg = jax_smoke_config("gemma2-9b"), get_smoke_config("gemma2-9b")
    jp = jatt.init_attn(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    S = 16
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = _offset_positions(S)
    pos[1, 8:] += 3                                   # a gap in the second row
    ref = _CountingRef()
    monkeypatch.setattr(tatt, "attention_ref", ref)
    j_out, _ = jatt.attention_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), jcfg.window)
    t_out, _ = tatt.attention_prefill(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                      tcfg.window, plain=True)
    assert ref.calls == 0
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("gap_row", [0, 1])
def test_other_positions_raise_off_the_cpu(gap_row):
    """Off the CPU (a ``meta`` tensor here) positions that are not
    ``p0 + 0..S-1`` in every row raise, naming the kernel variant that would
    take them, before anything is computed."""
    cfg = get_smoke_config("granite-3-8b")
    d, hd = cfg.d_model, cfg.head_dim
    params = {n: torch.empty(shape, device="meta") for n, shape in (
        ("wq", (d, cfg.n_heads * hd)), ("wk", (d, cfg.n_kv_heads * hd)),
        ("wv", (d, cfg.n_kv_heads * hd)), ("wo", (cfg.n_heads * hd, d)))}
    x = torch.empty(B, 8, d, device="meta")
    pos = torch.from_numpy(_offset_positions(8))
    pos[gap_row, 4] = 100
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        tatt.attention_prefill(params, x, cfg, pos)


def test_runs_from_offsets():
    pos = torch.from_numpy(_offset_positions(6, (0, 7)))
    assert tatt.runs_from_offsets(pos)
    assert tatt.runs_from_offsets(pos.int())
    assert not tatt.runs_from_offsets(pos.flip(1))
    pos[1, 3] += 1
    assert not tatt.runs_from_offsets(pos)
