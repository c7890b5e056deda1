"""The port's RWKV-6 modules against the JAX reference on the CPU.

Same weights in both (the reference's ``init_rwkv`` converted to torch), the
rwkv6-3b smoke config in float32.  Tolerance 1e-4: the same math, with the
prefill scan in the reference's sequential order on one side and the port's
wkv6 plain version on the other.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.models import init_kv_cache, init_params
from repro_torch.models import rwkv as trwkv

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "rwkv6-3b"


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jrwkv.init_rwkv(jax.random.PRNGKey(1), jcfg, jax.numpy.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    return jcfg, jp, tcfg, tp


def _x(cfg, B=2, S=9, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _state(cfg, B=2, seed=1):
    rng = np.random.default_rng(seed)
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return {"S": rng.standard_normal((B, H, hd, hd)).astype(np.float32),
            "shift": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32),
            "shift_ffn": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("S, with_state", [(9, False), (1, True), (5, True)])
def test_time_mix_matches(weights, S, with_state):
    jcfg, jp, tcfg, tp = weights
    x = _x(jcfg, S=S)
    st = _state(jcfg) if with_state else None
    j_out, j_st = jrwkv.rwkv_time_mix(jp, jax.numpy.asarray(x), jcfg,
                                      jax.tree.map(jax.numpy.asarray, st) if st else None)
    t_out, t_st = trwkv.rwkv_time_mix(
        tp, torch.from_numpy(x), tcfg,
        {n: torch.from_numpy(a) for n, a in st.items()} if st else None)
    _close(t_out, j_out)
    assert set(t_st) == set(j_st) == {"S", "shift"}
    for n in j_st:
        _close(t_st[n], j_st[n])


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches(weights, with_state):
    jcfg, jp, _, tp = weights
    x = _x(jcfg, seed=2)
    st = _state(jcfg, seed=3) if with_state else None
    j_out, j_st = jrwkv.rwkv_channel_mix(jp, jax.numpy.asarray(x),
                                         jax.tree.map(jax.numpy.asarray, st) if st else None)
    t_out, t_st = trwkv.rwkv_channel_mix(
        tp, torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in st.items()} if st else None)
    _close(t_out, j_out)
    _close(t_st["shift_ffn"], j_st["shift_ffn"])


@pytest.mark.parametrize("scan", ["plain", "kernel_chunk_form"])
def test_time_mix_strong_decays_matches(weights, monkeypatch, scan):
    """w0 raised from -2 to 2.5, so log w = -exp(w0 + lora) is about -12 a
    token (w ~ 6e-6) and a 32-token chunk sums far below fp32's exp range:
    the prefill through the port's plain scan, and through the CUDA kernel's
    in-chunk arithmetic replayed on the CPU (``wkv6_chunked_ref``, its
    strong-decay form), against the reference's token-by-token scan."""
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref

    jcfg, jp, tcfg, tp = weights
    jp = dict(jp, w0=jax.numpy.full_like(jp["w0"], 2.5))
    tp = dict(tp, w0=torch.full_like(tp["w0"], 2.5))
    if scan == "kernel_chunk_form":
        monkeypatch.setattr(trwkv, "wkv6", wkv6_chunked_ref)
    x = _x(jcfg, S=70, seed=4)
    j_out, j_st = jrwkv.rwkv_time_mix(jp, jax.numpy.asarray(x), jcfg)
    t_out, t_st = trwkv.rwkv_time_mix(tp, torch.from_numpy(x), tcfg)
    assert torch.isfinite(t_out).all()
    _close(t_out, j_out)
    _close(t_st["S"], j_st["S"])


def test_init_params_rwkv_leaves_and_scales():
    cfg = get_smoke_config(ARCH)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d, hd, ff = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
    p = model.blocks[0].rwkv
    jp = jrwkv.init_rwkv(jax.random.PRNGKey(0), jax_smoke_config(ARCH), jax.numpy.float32)
    assert {n: tuple(t.shape) for n, t in p.items()} == \
        {n: tuple(a.shape) for n, a in jp.items()}
    for n in ("w0", "u", "ln_x"):
        assert p[n].dtype == torch.float32
    assert (p["w0"] == -2.0).all() and (p["ln_x"] == 0).all()
    assert 0.0 <= p["mu"].min() and p["mu"].max() <= 1.0
    assert abs(p["u"].std().item() - 0.1) < 0.03
    assert abs(p["wr"].std().item() - d ** -0.5) < 0.02
    assert abs(p["cm_v"].std().item() - ff ** -0.5) < 0.02
    assert p["u"].shape == (d // hd, hd)
    assert not any(t.requires_grad for t in model.parameters())


def test_init_kv_cache_rwkv_state_layout():
    cfg = get_smoke_config(ARCH)
    (slot,) = init_kv_cache(cfg, 3, 11, torch.bfloat16, "cpu")
    R, H, hd = cfg.pattern_repeats, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert slot["S"].shape == (R, 3, H, hd, hd) and slot["S"].dtype == torch.float32
    for n in ("shift", "shift_ffn"):
        assert slot[n].shape == (R, 3, 1, cfg.d_model) and slot[n].dtype == torch.bfloat16


def test_params_from_jax_carries_every_rwkv_leaf():
    """Nested ``rwkv`` leaves, bf16 and fp32 alike, reach each layer intact."""
    import dataclasses

    from repro.models import init_params as jax_init_params
    from repro_torch.convert import params_from_jax

    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    model = params_from_jax(tcfg, jparams, "cpu")
    (stacked,) = jparams["blocks"]
    for layer, blk in enumerate(model.blocks):
        assert set(blk.rwkv) == set(stacked["rwkv"])
        for n, a in stacked["rwkv"].items():
            t = blk.rwkv[n]
            assert str(t.dtype).removeprefix("torch.") == a.dtype.name, n
            np.testing.assert_array_equal(t.float().numpy(), a[layer].astype(np.float32))
