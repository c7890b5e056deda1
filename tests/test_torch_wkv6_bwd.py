"""The WKV-6 backward on the CPU: the port's plain backward
(``wkv6_bwd_ref``), the backward kernel's split in plain PyTorch
(``wkv6_bwd_segmented_ref``) and the chunked fp32 form tried in its place
(``wkv6_bwd_chunked_ref``, ``scripts/wkv6_bwd_chunked.cu``) against
``jax.vjp`` of the reference's oracle (``repro.kernels.rwkv6.ref.wkv6_ref``),
and the autograd function that routes the card's gradient through the
kernels.

Bounds: fp32, ``allclose(rtol=2e-4, atol=2e-4)``, the forward's bound; du
is a sum over B*S of values ~1e2, so it needs the relative part.  float64:
1e-10 against torch autograd of the port's own plain forward (the
reference's oracle computes in fp32 whatever it is given; the two agree to
~1e-13).  The CUDA kernel itself is held against ``wkv6_bwd_ref`` on the card
by tests/test_torch_cuda.py and chip_smoke.py phase 18.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.kernel import SEGMENT, wkv6_bwd_kernel
from repro_torch.kernels.rwkv6.ref import (matmul_3xtf32, wkv6_bwd_chunked_ref, wkv6_bwd_ref,
                                           wkv6_bwd_segmented_ref, wkv6_ref, wkv6_segmented_ref)

TOL = dict(rtol=2e-4, atol=2e-4)
TOL64 = dict(rtol=1e-10, atol=1e-10)
NAMES = ("dr", "dk", "dv", "dlogw", "du")
# (B, H, S, hd): tests/test_kernels.py WKV_CASES without their chunk, then a
# ragged S (no multiple of any chunk or segment) and a head dim of 32 over
# several segments
SHAPES = [(2, 2, 64, 16), (1, 4, 128, 64), (2, 1, 96, 32), (1, 2, 256, 64),
          (2, 3, 100, 64), (1, 2, 300, 32)]


STRONG_LOGW = -2.0   # the forward's strong-decay threshold (csrc/wkv6.cu)
DECAYS = ("reference", "strong", "weakest_fp32", "half_strong")


def _logw(rng, shape, decays):
    """log w on one of scripts/wkv6_bwd_conditioning.py's four ranges: the
    reference's (w uniform in (0.7, 0.999)); strong (log-uniform over [1e-3,
    0.999], channels 3, 19, ... at -50); log w uniform in [STRONG_LOGW,
    log 0.999] (the weakest the forward calls strong); and in every token
    half the channels, at random, log-uniform in [1e-3, e^STRONG_LOGW), the
    other half as the last."""
    if decays == "strong":
        logw = rng.uniform(np.log(1e-3), np.log(0.999), shape)
        logw[..., 3::16] = -50.0
        return logw
    if decays == "reference":
        return np.log(rng.uniform(0.7, 0.999, shape))
    logw = rng.uniform(STRONG_LOGW, np.log(0.999), shape)
    if decays == "half_strong":
        low = rng.uniform(np.log(1e-3), STRONG_LOGW, shape)
        half = rng.random(shape).argsort(-1) < shape[-1] // 2
        logw = np.where(half, low, logw)
    return logw


def _inputs(B, H, S, hd, seed=0, strong=False, ds_last=False):
    """The reference's test distribution (tests/test_torch_wkv6.py): r, k, v
    normal, decay uniform in (0.7, 0.999) as log w, u * 0.3; ``strong``
    (True, or one of ``DECAYS``): log w on that range of :func:`_logw`.
    Then dout normal and, with ``ds_last``, a normal cotangent of S_last."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    decays = "strong" if strong is True else strong or "reference"
    logw = _logw(rng, (B, H, S, hd), decays)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    dout = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    ds = rng.standard_normal((B, H, hd, hd)).astype(np.float32) if ds_last else None
    return (r, k, v, logw.astype(np.float32), u), dout, ds


def _jax_grads(arrs, dout, ds):
    """jax.vjp of the reference's oracle at (dout, ds or zero)."""
    j = [jnp.asarray(a) for a in arrs]
    out, vjp = jax.vjp(jax_wkv6_ref, *j)
    ct_s = jnp.zeros_like(out[1]) if ds is None else jnp.asarray(ds)
    return [np.asarray(g) for g in vjp((jnp.asarray(dout), ct_s))]


def _torch(arrs, dout, ds, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    return t, torch.from_numpy(dout).to(dtype), None if ds is None else torch.from_numpy(ds).to(dtype)


def _assert_grads_close(got, want, tol):
    for name, g, w in zip(NAMES, got, want, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("ds_last", [False, True], ids=["no_dS_last", "dS_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wkv6_bwd_ref_matches_jax_vjp(shape, strong, ds_last):
    """The port's plain backward, token by token, against jax.vjp of the
    reference's oracle: the reference's test shapes, a ragged S, strong
    decays (log w down to -50) and a non-zero cotangent of S_last."""
    arrs, dout, ds = _inputs(*shape, seed=1, strong=strong, ds_last=ds_last)
    want = _jax_grads(arrs, dout, ds)
    t, tdo, tds = _torch(arrs, dout, ds)
    got = wkv6_bwd_ref(*t, tdo, tds)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("segment", [8, 32, 64, SEGMENT])
@pytest.mark.parametrize("case", [
    ((1, 4, 128, 64), False, False), ((2, 3, 100, 64), False, True),
    ((1, 2, 300, 32), True, True), ((2, 1, 96, 32), True, False),
    ((1, 2, 257, 16), False, True),
], ids=["wkv_case1", "ragged_dS_last", "ragged_strong_dS_last", "wkv_case2_strong",
        "segment_plus_one"])
def test_wkv6_bwd_segmented_ref_matches_jax_vjp(case, segment):
    """The kernel's split (segment-local G, its carry, float64 sweeps from
    the fp32 segment states, dlogw restarted at each segment's end from
    sum_j G_end * S_end) against jax.vjp of the reference's oracle, at one
    to 38 segments, whole or ragged, on both decay ranges, with and without
    a cotangent of S_last."""
    shape, strong, ds_last = case
    arrs, dout, ds = _inputs(*shape, seed=2, strong=strong, ds_last=ds_last)
    want = _jax_grads(arrs, dout, ds)
    t, tdo, tds = _torch(arrs, dout, ds)
    got = wkv6_bwd_segmented_ref(*t, tdo, tds, segment)
    _assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("ds_last", [False, True], ids=["no_dS_last", "dS_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
def test_wkv6_bwd_float64_matches_autograd(strong, ds_last):
    """In float64 the plain backwards agree with autograd of the port's
    plain forward to 1e-10: the formulas are exact, including dlogw's
    running sums (segment 32: 3 segments, a ragged one) and its pair form
    (chunks of 8 in blocks of 16: 5 blocks, a ragged one)."""
    arrs, dout, ds = _inputs(2, 3, 70, 16, seed=3, strong=strong, ds_last=ds_last)
    t, tdo, tds = _torch(arrs, dout, ds, torch.float64)
    leaves = [x.clone().requires_grad_(True) for x in t]
    out, s_last = wkv6_ref(*leaves)
    loss = (out * tdo).sum() + (0 if tds is None else (s_last * tds).sum())
    want = torch.autograd.grad(loss, leaves)
    for got in (wkv6_bwd_ref(*t, tdo, tds), wkv6_bwd_segmented_ref(*t, tdo, tds, 32),
                wkv6_bwd_chunked_ref(*t, tdo, tds, chunk=8, block=16, segment=32)):
        assert all(g.dtype == torch.float64 for g in got)
        _assert_grads_close([g.detach() for g in got], [w.detach() for w in want], TOL64)


@pytest.mark.parametrize("ds_last", [False, True], ids=["no_dS_last", "dS_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
@pytest.mark.parametrize("S", [1, 40])
def test_wkv6_bwd_segmented_ref_short_sequence(S, strong, ds_last):
    """The kernel's split at the kernel's segment length on a sequence
    shorter than one 64-token block (one ragged segment) against jax.vjp of
    the reference's oracle, as chip_smoke.py phase 18(a)'s S=40 case holds
    the kernel on the card."""
    arrs, dout, ds = _inputs(2, 3, S, 64, seed=6, strong=strong, ds_last=ds_last)
    want = _jax_grads(arrs, dout, ds)
    t, tdo, tds = _torch(arrs, dout, ds)
    got = wkv6_bwd_segmented_ref(*t, tdo, tds, SEGMENT)
    _assert_grads_close(got, want, TOL)


# (chunk, block, segment): the chunked kernel's (16, 128, SEGMENT), then shorter and
# longer chunks, and blocks and segments short enough that the sequences
# span many of each
CHUNKINGS = [(16, 128, SEGMENT), (4, 8, 16), (8, 32, 64), (32, 64, 128)]


@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda c: "c{}_b{}_s{}".format(*c))
@pytest.mark.parametrize("case", [
    ((1, 4, 128, 64), False, False), ((2, 3, 100, 64), False, True),
    ((1, 2, 300, 32), True, True), ((2, 1, 96, 32), True, False),
    ((1, 2, 257, 16), False, True),
], ids=["wkv_case1", "ragged_dS_last", "ragged_strong_dS_last", "wkv_case2_strong",
        "segment_plus_one"])
def test_wkv6_bwd_chunked_ref_matches_jax_vjp(case, chunking):
    """The kernel's split and chunk arithmetic in fp32 (block-local G, its
    carry, S forward from the segments' input states, the pair form inside
    each chunk) against jax.vjp of the reference's oracle, at one to 38
    blocks, whole or ragged, on both decay ranges, with and without a
    cotangent of S_last."""
    shape, strong, ds_last = case
    arrs, dout, ds = _inputs(*shape, seed=2, strong=strong, ds_last=ds_last)
    want = _jax_grads(arrs, dout, ds)
    t, tdo, tds = _torch(arrs, dout, ds)
    chunk, block, segment = chunking
    got = wkv6_bwd_chunked_ref(*t, tdo, tds, chunk=chunk, block=block, segment=segment)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("ds_last", [False, True], ids=["no_dS_last", "dS_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
@pytest.mark.parametrize("S", [1, 40])
def test_wkv6_bwd_chunked_ref_short_sequence(S, strong, ds_last):
    """The chunked form's split and chunks (16 tokens, blocks of 128) on a
    sequence shorter than one block (one ragged block, S=1: one token of a
    chunk) against jax.vjp of the reference's oracle, as chip_smoke.py phase
    18(a)'s S=40 case holds the kernels on the card."""
    arrs, dout, ds = _inputs(2, 3, S, 64, seed=6, strong=strong, ds_last=ds_last)
    want = _jax_grads(arrs, dout, ds)
    t, tdo, tds = _torch(arrs, dout, ds)
    got = wkv6_bwd_chunked_ref(*t, tdo, tds)
    _assert_grads_close(got, want, TOL)


@functools.cache
def _long_case(decays):
    """S=2048, H=2, hd=64 on one decay range: the fp32 inputs and the float64
    plain backward."""
    arrs, dout, _ = _inputs(1, 2, 2048, 64, seed=8, strong=decays)
    t, tdo, _ = _torch(arrs, dout, None)
    want64 = wkv6_bwd_ref(*(x.double() for x in t), tdo.double())
    return t, tdo, want64


def _row_rel_err(got, want, floor=1e-3):
    """chip_smoke.py's per-row error: max over rows of the row's largest
    error over its rms, rows under ``floor`` of the tensor's rms left out."""
    err = (got.double() - want).abs().amax(-1)
    rms = want.pow(2).mean(-1).sqrt()
    keep = rms >= floor * want.pow(2).mean().sqrt()
    return (err[keep] / rms[keep]).max().item()


SCHEMES = {
    # the port's kernel: float64 sweeps, dlogw restarted at each segment's end
    "segmented_float64": lambda t, tdo: wkv6_bwd_segmented_ref(*t, tdo, None, SEGMENT),
    # the chunked fp32 form (scripts/wkv6_bwd_chunked.cu), its products in fp32
    "chunked_fp32": lambda t, tdo: wkv6_bwd_chunked_ref(*t, tdo),
    # ... and with each product's operands split in TF32 as its tensor cores take them
    "chunked_3xtf32": lambda t, tdo: wkv6_bwd_chunked_ref(*t, tdo, mm=matmul_3xtf32),
}


@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_wkv6_bwd_dlogw_at_training_length(scheme, decays):
    """At rwkv6-3b's training length (S=2048, hd=64, H=2) in fp32, the
    kernel's scheme and the chunked fp32 form tried in its place (with its
    products in fp32, and split in TF32 as its tensor cores take them) keep
    dlogw within allclose(2e-4, 2e-4) of the float64 plain backward and
    within chip_smoke.py's per-row bound (1e-3 of a row's rms), on all four
    of scripts/wkv6_bwd_conditioning.py's decay ranges (the fp32 running
    sums tried before missed the per-row bound on strong decays)."""
    t, tdo, want64 = _long_case(decays)
    got = SCHEMES[scheme](t, tdo)[3]
    np.testing.assert_allclose(got.double().numpy(), want64[3].numpy(), **TOL)
    assert _row_rel_err(got, want64[3]) <= 1e-3


def test_autograd_function_routes_both_passes(monkeypatch):
    """``_WKV6`` on CPU tensors with the two kernels replaced by their plain
    versions: the forward keeps the segment states and the inputs, the
    backward gets them back with dout and a None cotangent for an unused
    S_last (or S_last's when it is used), and the gradients equal autograd
    of the plain forward.  The card runs the same function with the CUDA
    kernels."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(r, k, v, logw, u, with_states=False):
        calls["fwd"] += 1
        out, s_last = wkv6_segmented_ref(r, k, v, logw, u, SEGMENT)
        assert with_states
        return out, s_last, torch.zeros(0)

    def bwd(r, k, v, logw, u, seg_state, dout, ds_last=None):
        calls["bwd"] += 1
        assert seg_state.numel() == 0
        calls["ds_last"] = ds_last
        return wkv6_bwd_segmented_ref(r, k, v, logw, u, dout, ds_last, SEGMENT)

    monkeypatch.setattr(ops, "wkv6_kernel", fwd)
    monkeypatch.setattr(ops, "wkv6_bwd_kernel", bwd)
    arrs, dout, ds = _inputs(1, 2, 40, 16, seed=4, ds_last=True)
    t, tdo, tds = _torch(arrs, dout, ds)
    for use_s_last in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in t]
        out, s_last = ops._WKV6.apply(*leaves, True)
        loss = (out * tdo).sum() + ((s_last * tds).sum() if use_s_last else 0)
        got = torch.autograd.grad(loss, leaves)
        assert (calls["ds_last"] is None) != use_s_last
        ref_leaves = [x.clone().requires_grad_(True) for x in t]
        ro, rs = wkv6_ref(*ref_leaves)
        want = torch.autograd.grad((ro * tdo).sum() + ((rs * tds).sum() if use_s_last else 0),
                                   ref_leaves)
        _assert_grads_close(got, want, TOL)
    assert calls["fwd"] == calls["bwd"] == 2


def test_wkv6_bwd_kernel_raises_on_cpu_tensors():
    arrs, dout, _ = _inputs(1, 2, 8, 16, seed=6)
    t, tdo, _ = _torch(arrs, dout, None)
    before = wkv6_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd_kernel(*t, torch.zeros(1, 2, 0, 16, 16), tdo)
    with pytest.raises(ValueError, match="head dim"):
        wkv6_bwd_kernel(*(torch.zeros(1, 2, 8, 24) for _ in range(4)), torch.zeros(2, 24),
                        torch.zeros(1, 2, 0, 24, 24), torch.zeros(1, 2, 8, 24))
    assert wkv6_bwd_kernel.launches == before


def test_model_gradients_through_the_autograd_function(monkeypatch):
    """rwkv6-3b's smoke config under remat, on the CPU, with every WKV-6
    call routed through ``_WKV6`` (its kernels replaced by the kernels'
    splits in plain PyTorch, ``wkv6_segmented_ref`` / ``wkv6_bwd_segmented_ref``
    at 16-token segments): the loss and every per-layer gradient equal the
    CPU route's (autograd of the plain version) within 2e-4 of each leaf's
    largest gradient, the S_last cotangent of every call is None, and each
    call's backward runs once (remat recomputes the forward, the backward
    runs on the recomputed one)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import rwkv as trwkv

    cfg = get_smoke_config("rwkv6-3b")
    assert cfg.remat
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").train_params()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=g)
    flat = model.flat_params()
    loss_p = loss_fn(model, toks[:, :-1], toks[:, 1:])
    want = torch.autograd.grad(loss_p, flat)

    seen = []

    def fwd(r, k, v, logw, u, with_states=False):
        return (*wkv6_segmented_ref(r, k, v, logw, u, 16), torch.zeros(0))

    def bwd(r, k, v, logw, u, seg_state, dout, ds_last=None):
        seen.append(ds_last)
        return wkv6_bwd_segmented_ref(r, k, v, logw, u, dout, ds_last, 16)

    def routed(r, k, v, logw, u):
        keep = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u))
        return ops._WKV6.apply(r, k, v, logw, u, keep)

    monkeypatch.setattr(ops, "wkv6_kernel", fwd)
    monkeypatch.setattr(ops, "wkv6_bwd_kernel", bwd)
    monkeypatch.setattr(trwkv, "wkv6", routed)
    loss_k = loss_fn(model, toks[:, :-1], toks[:, 1:])
    got = torch.autograd.grad(loss_k, flat)
    assert len(seen) == cfg.n_layers and all(d is None for d in seen)
    assert loss_k.item() == pytest.approx(loss_p.item(), rel=1e-6)
    for a, w in zip(got, want, strict=True):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max() <= 2e-4 * max(w.abs().max().item(), 1e-30)
