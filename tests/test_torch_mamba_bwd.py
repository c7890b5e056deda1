"""The selective scan's backward on the CPU: the port's plain backward
(``mamba_scan_bwd_ref``) and the backward kernel's order of operations in
plain PyTorch (``mamba_scan_bwd_chunked_ref``) against ``jax.vjp`` of the
reference's oracle (``repro.kernels.mamba.ref.mamba_scan_ref``), and the
autograd function that routes the card's gradient through the kernels.

Bounds: fp32, ``allclose(rtol=2e-4, atol=2e-4)``, the forward's bound (dA
and dD are sums over B*S terms of size ~1-10^2, so they need the relative
part).  float64: 1e-10 against torch autograd of the port's own plain
forward (the reference's oracle computes in fp32 whatever it is given).
The CUDA kernels themselves are held against ``mamba_scan_bwd_ref`` on the
card by tests/test_torch_cuda.py and chip_smoke.py phase 19.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro_torch.kernels.mamba import ops
from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel, n_state_slots
from repro_torch.kernels.mamba.ref import (BLOCK, CHUNK, SUB, mamba_scan_bwd_chunked_ref,
                                           mamba_scan_bwd_ref, mamba_scan_lanes_ref,
                                           mamba_scan_ref)

TOL = dict(rtol=2e-4, atol=2e-4)
TOL64 = dict(rtol=1e-10, atol=1e-10)
NAMES = ("ddt", "dx", "dA", "dB", "dC", "dD")
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
# (B, S, di, N): tests/test_kernels.py MAMBA_CASES without their tiling, then
# a ragged S over two chunks and an S below one chunk
SHAPES = [(2, 64, 128, 8), (1, 128, 256, 16), (1, 96, 64, 4), (2, 100, 64, 16), (2, 40, 32, 8)]


def _inputs(B, S, di, N, seed=0, strong=False, dh_last=False):
    """The reference's test draw (dt = softplus(normal), x, B, C normal,
    A = -exp(0.5 normal), D = 1); ``strong``: dt log-uniform in [1e-2, 8]
    and A = -(1 .. N) on every channel, so exp(dt A) underflows to 0 in fp32
    on some state-tokens.  Then dy normal and, with ``dh_last``, a normal
    cotangent of h_last."""
    rng = np.random.default_rng(seed)
    if strong:
        dt = np.exp(rng.uniform(np.log(1e-2), np.log(8.0), (B, S, di)))
        A = -np.tile(np.arange(1, N + 1, dtype=np.float64), (di, 1))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, di))))
        A = -np.exp(rng.standard_normal((di, N)) * 0.5)
    x = rng.standard_normal((B, S, di))
    Bc, Cc = (rng.standard_normal((B, S, N)) for _ in range(2))
    arrs = [a.astype(np.float32) for a in (dt, x, A, Bc, Cc, np.ones(di))]
    dy = rng.standard_normal((B, S, di)).astype(np.float32)
    dh = rng.standard_normal((B, di, N)).astype(np.float32) if dh_last else None
    return arrs, dy, dh


def _jax_grads(arrs, dy, dh):
    """jax.vjp of the reference's oracle at (dy, dh or zero)."""
    out, vjp = jax.vjp(jax_mamba_scan_ref, *(jnp.asarray(a) for a in arrs))
    ct_h = jnp.zeros_like(out[1]) if dh is None else jnp.asarray(dh)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), ct_h))]


def _torch(arrs, dy, dh, dtype=torch.float32):
    return ([torch.from_numpy(a).to(dtype) for a in arrs], torch.from_numpy(dy).to(dtype),
            None if dh is None else torch.from_numpy(dh).to(dtype))


def _states(t):
    """The chunk states the forward kernel keeps, from its order in plain PyTorch."""
    return mamba_scan_lanes_ref(*t, with_states=True)[2]


def _assert_grads_close(got, want, tol):
    for name, g, w in zip(NAMES, got, want, strict=True):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("dh_last", [False, True], ids=["no_dh_last", "dh_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["test_draw", "strong_decays"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mamba_scan_bwd_ref_matches_jax_vjp(shape, strong, dh_last):
    """The port's plain backward, token by token, against jax.vjp of the
    reference's oracle: the reference's test shapes, a ragged S, an S below
    one chunk, strong decays and a cotangent of h_last."""
    arrs, dy, dh = _inputs(*shape, seed=1, strong=strong, dh_last=dh_last)
    want = _jax_grads(arrs, dy, dh)
    t, tdy, tdh = _torch(arrs, dy, dh)
    got = mamba_scan_bwd_ref(*t, tdy, tdh)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("case", [
    ((1, 128, 256, 16), False, False), ((2, 64, 128, 8), False, True),
    ((2, 200, 200, 16), True, True), ((1, 96, 64, 4), True, False),
    ((2, 65, 130, 4), False, True), ((2, 40, 32, 16), True, True),
    ((1, 257, 136, 8), True, True),
], ids=["mamba_case1", "mamba_case0_dh_last", "ragged_strong_dh_last", "mamba_case2_strong",
        "chunk_plus_one", "short_strong_dh_last", "ragged_n8"])
def test_mamba_scan_bwd_chunked_ref_matches_jax_vjp(case):
    """The kernel's order (chunk states from the forward, each chunk run
    forward from its state, sub-chunks recomputed and swept back, dB / dC
    summed per 128-channel block, then the blocks) against jax.vjp of the
    reference's oracle: one to five chunks, whole or ragged, d_inner no
    multiple of the block, N = 4, 8 and 16, both decay ranges, with and
    without a cotangent of h_last."""
    shape, strong, dh_last = case
    arrs, dy, dh = _inputs(*shape, seed=2, strong=strong, dh_last=dh_last)
    want = _jax_grads(arrs, dy, dh)
    t, tdy, tdh = _torch(arrs, dy, dh)
    got = mamba_scan_bwd_chunked_ref(*t, _states(t), tdy, tdh)
    _assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("dh_last", [False, True], ids=["no_dh_last", "dh_last"])
@pytest.mark.parametrize("strong", [False, True], ids=["test_draw", "strong_decays"])
def test_mamba_scan_bwd_float64_matches_autograd(strong, dh_last):
    """In float64 both plain backwards agree with autograd of the port's
    plain forward to 1e-10: the formulas are exact (three chunks, a ragged
    one; chunk states taken from the float64 forward)."""
    arrs, dy, dh = _inputs(2, 150, 136, 8, seed=3, strong=strong, dh_last=dh_last)
    t, tdy, tdh = _torch(arrs, dy, dh, torch.float64)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y, h_last = mamba_scan_ref(*leaves)
    loss = (y * tdy).sum() + (0 if tdh is None else (h_last * tdh).sum())
    want = torch.autograd.grad(loss, leaves)
    states = torch.stack([mamba_scan_ref(*(a[:, :CHUNK * k] if a.dim() == 3 else a for a in t))[1]
                          for k in range(1, n_state_slots(150) + 1)], dim=2)
    for got in (mamba_scan_bwd_ref(*t, tdy, tdh),
                mamba_scan_bwd_chunked_ref(*t, states, tdy, tdh)):
        assert all(g.dtype == torch.float64 for g in got)
        _assert_grads_close(got, want, TOL64)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
def test_lanes_ref_states_are_the_forward_state_at_each_chunk_start(S):
    """``mamba_scan_lanes_ref(with_states=True)``: (y, h_last) as without
    states, and slot k - 1 the state after the first 64 k tokens (the same
    recurrence run on that prefix), ``[B, di, ceil(S/64) - 1, N]``."""
    arrs, _, _ = _inputs(2, S, 24, 8, seed=4)
    t, _, _ = _torch(arrs, np.zeros(1), None)
    y, h, states = mamba_scan_lanes_ref(*t, with_states=True)
    y0, h0 = mamba_scan_lanes_ref(*t)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert tuple(states.shape) == (2, 24, n_state_slots(S), 8)
    for k in range(1, n_state_slots(S) + 1):
        prefix = [a[:, :CHUNK * k] if a.dim() == 3 else a for a in t]
        assert torch.equal(states[:, :, k - 1], mamba_scan_lanes_ref(*prefix)[1])


def test_autograd_function_routes_both_passes(monkeypatch):
    """``_MambaScan`` on CPU tensors with the two kernels replaced by their
    plain versions in the kernels' order: the forward keeps the chunk states
    and the inputs, the backward gets them back with dy and a None cotangent
    for an unused h_last (or h_last's when it is used), and the gradients
    equal autograd of the plain forward.  The card runs the same function
    with the CUDA kernels."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(dt, x, A, Bc, Cc, D, with_states=False):
        calls["fwd"] += 1
        assert with_states
        return mamba_scan_lanes_ref(dt, x, A, Bc, Cc, D, with_states=True)

    def bwd(dt, x, A, Bc, Cc, D, states, dy, dh_last=None):
        calls["bwd"] += 1
        calls["dh_last"] = dh_last
        return mamba_scan_bwd_chunked_ref(dt, x, A, Bc, Cc, D, states, dy, dh_last)

    monkeypatch.setattr(ops, "mamba_scan_kernel", fwd)
    monkeypatch.setattr(ops, "mamba_scan_bwd_kernel", bwd)
    arrs, dy, dh = _inputs(2, 100, 40, 8, seed=5, dh_last=True)
    t, tdy, tdh = _torch(arrs, dy, dh)
    for use_h_last in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in t]
        y, h_last = ops._MambaScan.apply(*leaves, True)
        loss = (y * tdy).sum() + ((h_last * tdh).sum() if use_h_last else 0)
        got = torch.autograd.grad(loss, leaves)
        assert (calls["dh_last"] is None) != use_h_last
        ref_leaves = [a.clone().requires_grad_(True) for a in t]
        ry, rh = mamba_scan_ref(*ref_leaves)
        want = torch.autograd.grad((ry * tdy).sum() + ((rh * tdh).sum() if use_h_last else 0),
                                   ref_leaves)
        _assert_grads_close(got, want, TOL)
    assert calls["fwd"] == calls["bwd"] == 2


def test_mamba_scan_bwd_kernel_raises_on_cpu_tensors():
    arrs, dy, _ = _inputs(1, 8, 16, 4, seed=6)
    t, tdy, _ = _torch(arrs, dy, None)
    before = mamba_scan_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd_kernel(*t, torch.zeros(1, 16, 0, 4), tdy)
    bad, _, _ = _inputs(1, 8, 16, 6, seed=6)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan_bwd_kernel(*(torch.from_numpy(a) for a in bad), torch.zeros(1, 16, 0, 6), tdy)
    assert mamba_scan_bwd_kernel.launches == before


def test_plain_constants_match_the_kernel_sources():
    """The plain versions' chunk, sub-chunk and block are the kernels'
    (``kT`` of both sources, ``kSub`` and ``kCB`` of the backward's): the
    wrapper sizes the chunk states and the partial sums by them."""
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())[1])

    assert const("mamba_scan.cu", "kT") == const("mamba_scan_bwd.cu", "kT") == CHUNK
    assert const("mamba_scan_bwd.cu", "kSub") == SUB
    assert const("mamba_scan_bwd.cu", "kCB") == BLOCK


def test_model_gradients_through_the_autograd_function(monkeypatch):
    """jamba's smoke config under remat, on the CPU, with every scan routed
    through ``_MambaScan`` (its kernels replaced by their plain versions in
    the kernels' order): the loss and every per-layer gradient equal the CPU
    route's (autograd of the plain version) within 2e-4 of each leaf's
    largest gradient, the h_last cotangent of every call is None, and each
    call's backward runs once (remat recomputes the forward, the backward
    runs on the recomputed one)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import ssm as tssm

    cfg = get_smoke_config("jamba-v0.1-52b")
    assert cfg.remat
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").train_params()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 71), generator=g)
    flat = model.flat_params()
    unused = {id(p) for p in model.unused_by_prefill()}
    flat = [p for p in flat if id(p) not in unused]
    loss_p = loss_fn(model, toks[:, :-1], toks[:, 1:])
    want = torch.autograd.grad(loss_p, flat)

    seen = {"fwd": 0, "bwd": []}

    def fwd(dt, x, A, Bc, Cc, D, with_states=False):
        seen["fwd"] += 1
        return mamba_scan_lanes_ref(dt, x, A, Bc, Cc, D, with_states=True)

    def bwd(dt, x, A, Bc, Cc, D, states, dy, dh_last=None):
        seen["bwd"].append(dh_last)
        return mamba_scan_bwd_chunked_ref(dt, x, A, Bc, Cc, D, states, dy, dh_last)

    def routed(dt, x, A, Bc, Cc, D):
        keep = torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, A, Bc, Cc, D))
        return ops._MambaScan.apply(dt, x, A, Bc, Cc, D, keep)

    monkeypatch.setattr(ops, "mamba_scan_kernel", fwd)
    monkeypatch.setattr(ops, "mamba_scan_bwd_kernel", bwd)
    monkeypatch.setattr(tssm, "mamba_scan", routed)
    loss_k = loss_fn(model, toks[:, :-1], toks[:, 1:])
    got = torch.autograd.grad(loss_k, flat)
    n_mamba = cfg.block_kinds().count("mamba")
    assert seen["fwd"] == 2 * n_mamba
    assert len(seen["bwd"]) == n_mamba and all(d is None for d in seen["bwd"])
    assert loss_k.item() == pytest.approx(loss_p.item(), rel=1e-6)
    for a, w in zip(got, want, strict=True):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max() <= 2e-4 * max(w.abs().max().item(), 1e-30)
