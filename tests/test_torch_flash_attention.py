"""The port's flash_attention entry on the CPU (its plain version) against
the reference's oracle and its Pallas kernel in interpret mode, the
backward's plain version (``attention_bwd_ref``, the oracle the backward
kernel is held against on the card) against ``jax.grad`` of the
reference's oracle, and the bf16 backward kernels' rounding, emulated
(``attention_bwd_emulated``), against the same.

Bounds are the reference's own (tests/test_kernels.py): 2e-3 in fp32,
2e-2 in bf16.  The kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.kernel import (SavedForward, flash_attention_bwd_kernel,
                                                        flash_attention_kernel, lse_rows)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (RESIDUAL_GROUP, attention_bwd_emulated,
                                                     attention_bwd_ref)

FA_CASES = [
    # (B, H, KV, S, hd, causal, window, softcap, dtype) -- tests/test_kernels.py
    (2, 4, 2, 256, 64, True, 0, 0.0, "float32"),
    (1, 4, 1, 256, 128, True, 0, 50.0, "float32"),
    (2, 2, 2, 384, 64, True, 128, 0.0, "float32"),
    (1, 8, 4, 512, 64, False, 0, 0.0, "float32"),
    (1, 2, 2, 256, 64, True, 0, 0.0, "bfloat16"),
    (1, 16, 2, 128, 128, True, 64, 30.0, "float32"),
]
RAGGED_CASE = (1, 4, 2, 1000, 64, True, 300, 20.0, "float32")


def _inputs(case, seed=0):
    B, H, KV, S, hd, *_rest, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _check(j_out, t_out, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FA_CASES + [RAGGED_CASE])
def test_flash_attention_cpu_matches_jax_oracle(case):
    _, _, _, _, _, causal, window, cap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(case)
    t_out = flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert t_out.dtype == tq.dtype and t_out.shape == tq.shape
    _check(jax_attention_ref(jq, jk, jv, causal, window, cap), t_out, dtype)


@pytest.mark.parametrize("case", [FA_CASES[2], FA_CASES[4]])
def test_flash_attention_cpu_matches_pallas_interpret(case):
    _, _, _, _, _, causal, window, cap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, seed=1)
    j_out = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=cap,
                                interpret=True)
    _check(j_out, flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap), dtype)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "device", "gqa"])
def test_kernel_wrapper_rejects_what_it_cannot_take(bad):
    """The wrapper validates before it builds or launches anything."""
    shapes = {"head_dim": ((1, 2, 8, 96), (1, 2, 8, 96)),
              "gqa": ((1, 3, 8, 64), (1, 2, 8, 64))}.get(bad, ((1, 2, 8, 64), (1, 2, 8, 64)))
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k)


# (B, H, KV, S, hd, causal, window, softcap, dtype): GQA, windows, softcaps,
# non-causal, MQA, a ragged S, in both dtypes.
BWD_CASES = [
    (2, 4, 2, 96, 64, True, 0, 0.0, "float32"),
    (1, 4, 1, 80, 32, True, 16, 50.0, "float32"),
    (1, 6, 3, 70, 64, False, 0, 30.0, "float32"),
    (1, 8, 1, 64, 16, True, 8, 0.0, "float32"),
    (1, 4, 2, 96, 64, True, 24, 50.0, "bfloat16"),
    (2, 2, 1, 64, 32, False, 0, 0.0, "bfloat16"),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_matches_jax_grad(case):
    """dq, dk, dv of the plain backward against jax.vjp of the reference's
    oracle, to the reference's flash bounds (2e-3 fp32, 2e-2 bf16), each in
    its input's dtype; dk and dv sum over the H / KV heads of a group."""
    _, _, _, _, _, causal, window, cap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(case)
    rng = np.random.default_rng(5)
    do = rng.standard_normal(tuple(tq.shape)).astype(np.float32)
    jdo = jnp.asarray(do, jq.dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, causal, window, cap), jq, jk, jv)
    want = vjp(jdo)
    got = attention_bwd_ref(tq, tk, tv, torch.from_numpy(do).to(tq.dtype), causal, window, cap)
    for g, w, t in zip(got, want, (tq, tk, tv), strict=True):
        assert g.dtype == t.dtype and g.shape == t.shape
        _check(w, g, dtype)


class _CapNoChain(torch.autograd.Function):
    """cap * tanh(s / cap) whose backward leaves out 1 - tanh^2."""

    @staticmethod
    def forward(ctx, s, cap):
        return cap * torch.tanh(s / cap)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _bwd_fp64(q, k, v, do, window, cap, chain=True):
    """dq, dk, dv of causal attention in fp64 (``attention_ref`` computes in
    fp32), optionally without the softcap's chain factor."""
    leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    q_, k_, v_ = leaves
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhsd,bhtd->bhst", q_, k_.repeat_interleave(g, 1)) / q.shape[-1] ** 0.5
    s = cap * torch.tanh(s / cap) if chain else _CapNoChain.apply(s, cap)
    pos = torch.arange(q.shape[2])
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - (window or 10**9))
    p = torch.softmax(torch.where(mask, s, -1e300), dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, v_.repeat_interleave(g, 1))
    return torch.autograd.grad(out, leaves, do.double())


def _row_rel(got, want, floor=1e-3):
    """max|got - want| / rms(want) per row, over rows whose rms reaches
    ``floor`` of the tensor's (chip_smoke.py's ``row_rel_err``)."""
    d = (got.double() - want).abs().amax(-1)
    rms = want.pow(2).mean(-1).sqrt()
    keep = rms >= floor * want.pow(2).mean().sqrt()
    return (d[keep] / rms[keep]).max().item()


@pytest.mark.parametrize("window", [0, 300])
def test_softcap_backward_check_sees_the_chain_factor(window):
    """chip_smoke.py phase 15(a)'s softcap inputs (q scaled by cap / 3, so
    the cap's tanh saturates) at S=1024, hd 256, cap 50, on the CPU.  The
    fp32 plain backward is within the card's fp32 per-row bound (1e-2 of
    the row's rms, rows above 1e-3 of the tensor's rms) of an fp64 one:
    measured dq 1.31e-3 (dP - D cancels in rows that one key holds), dk
    <= 2.5e-4, dv <= 9e-5.  A backward without the chain factor 1 - tanh^2
    misses it in dq and dk by several times the rms (measured 8.3-11.1)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1024, n, 256, generator=g).transpose(1, 2) for n in (4, 2, 2))
    q = q * (50.0 / 3)
    do = torch.randn(1, 4, 1024, 256, generator=g)
    want = _bwd_fp64(q, k, v, do, window, 50.0)
    plain = attention_bwd_ref(q, k, v, do, True, window, 50.0)
    errs = [_row_rel(a, w) for a, w in zip(plain, want, strict=True)]
    assert max(errs) <= 5e-3, errs
    no_chain = _bwd_fp64(q, k, v, do, window, 50.0, chain=False)
    missed = [_row_rel(a, w) for a, w in zip(no_chain[:2], want[:2], strict=True)]
    assert min(missed) >= 1.0, missed


def test_flash_attention_cpu_backward_is_autograd_of_the_plain_version():
    """On the CPU the entry is the plain version, so autograd through it is
    attention_bwd_ref."""
    (_, _, _), (tq, tk, tv) = _inputs(BWD_CASES[1])
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=True, window=16, softcap=50.0)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, leaves, do)
    want = attention_bwd_ref(tq, tk, tv, do, True, 16, 50.0)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim", "do_shape", "device", "lse"])
def test_bwd_kernel_wrapper_rejects_what_it_cannot_take(bad):
    """The backward wrapper validates before it builds or launches anything:
    here on CPU tensors, and a log-sum-exp of the wrong shape."""
    hd = 96 if bad == "head_dim" else 64
    q = torch.zeros(1, 2, 8, hd)
    do = torch.zeros(1, 2, 9, hd) if bad == "do_shape" else torch.zeros_like(q)
    lse = torch.zeros(1, 2, 8 if bad == "lse" else lse_rows(8))
    with pytest.raises(ValueError):
        flash_attention_bwd_kernel(q, q, q, do, SavedForward(q, lse, None))


# chip_smoke.py phase 15(a)'s cases cut to S=512 (gemma2's window to 256):
# (name, B, H, KV, S, hd, causal, window, softcap)
EMU_CASES = [
    ("granite_train", 1, 32, 8, 512, 128, True, 0, 0.0),
    ("gemma2_local", 1, 16, 8, 512, 256, True, 256, 50.0),
    ("gemma2_global", 1, 16, 8, 512, 256, True, 0, 50.0),
    ("granite20b_mqa", 1, 48, 1, 512, 128, True, 0, 0.0),
]


def _emu_case(case):
    """bf16 inputs as phase 15(a) draws them (under a softcap q scaled by
    cap / 3, so the cap's tanh saturates), and the oracle: jax.vjp of the
    reference's attention in fp32 on the same bf16 values.  (jax.vjp at bf16
    inputs sums a group's dk, dv in bf16, its repeat's transpose, and that
    alone misses 2e-2 at gemma2's and the MQA shapes; attention_bwd_ref on
    the card upcasts before it sums.)"""
    _, B, H, KV, S, hd, causal, window, cap = case
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, n, S, hd)).astype(np.float32) for n in (H, KV, KV))
    if cap > 0:
        q *= cap / 3
    do = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    jx = [jnp.asarray(t.float().numpy()) for t in tt]
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal, window, cap), *jx[:3])
    want = [torch.from_numpy(np.array(w)) for w in vjp(jx[3])]
    return tt, want


def _card_bounds_missed(got, want):
    """phase 15(a)'s bf16 checks: 2e-2 elementwise (relative and absolute),
    and each row within 0.1 of its rms over rows whose rms reaches 1e-3 of
    the tensor's; the names of the ones missed."""
    missed = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        if not torch.allclose(g.float(), w, rtol=2e-2, atol=2e-2):
            missed.append(f"{name} elementwise")
        if _row_rel(g, w.double()) > 0.1:
            missed.append(f"{name} per row")
    return missed


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_attention_bwd_emulated_matches_jax_grad(case):
    """The bf16 kernels' rounding points (D from o + o_res, P from the
    forward's log-sum-exp, P and dS rounded to bf16 for their products, the
    residual products by the kernels' rule) stay inside the card's bounds."""
    _, B, H, KV, S, hd, causal, window, cap = case
    tt, want = _emu_case(case)
    got = attention_bwd_emulated(*tt, causal, window, cap)
    for g, t in zip(got, tt[:3], strict=True):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
    assert not _card_bounds_missed(got, want)


@pytest.mark.parametrize("case, without, misses", [
    (EMU_CASES[3], ("residual",), "dv elementwise"),
    (EMU_CASES[1], ("residual",), "dk elementwise"),
    (EMU_CASES[0], ("o_residual", "p_residual"), "dq per row"),
    (EMU_CASES[2], ("o_residual", "p_residual"), "dq per row"),
    (EMU_CASES[2], ("p_residual",), "dq per row"),
], ids=["mqa-no-residual-products", "softcap-no-residual-products", "granite-d-from-bf16-o",
        "gemma2-d-from-bf16-o", "gemma2-p-rounded-once"])
def test_attention_bwd_emulated_needs_each_precision_step(case, without, misses):
    """Each of the design's precision steps is needed: without the residual
    products granite-20b's 48 heads on one kv head miss the bound in dv,
    and a softcap's scaled logits in dk; D from the bf16 output alone, or
    from o + o_res of a forward whose P v rounds P once, misses the per-row
    bound in dq, where one key holds a row."""
    _, B, H, KV, S, hd, causal, window, cap = case
    tt, want = _emu_case(case)
    got = attention_bwd_emulated(*tt, causal, window, cap, **dict.fromkeys(without, False))
    assert misses in _card_bounds_missed(got, want)


def test_residual_group_is_the_kernels():
    """The emulation's group threshold is the CUDA source's."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "flash_attention_bwd.cu").read_text()
    assert re.search(r"constexpr int kResidualGroup = (\d+);", src).group(1) == str(RESIDUAL_GROUP)


@pytest.mark.parametrize("spec", ["flash_bwd_ablations.json", "flash_bwd_mutations.json"])
def test_flash_bwd_variant_edits_match_the_kernel_source(spec):
    """Every edit of the flash backward's ablation and mutation specs (the
    variants ``scripts/kernel_variants.py`` builds on the card) matches its
    CUDA source exactly once, so they stay those of the kernels as they
    are."""
    import json
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    items = json.loads((repo / "scripts" / spec).read_text())
    for item in items:
        text = (repo / "src" / "repro_torch" / "csrc" / item["source"]).read_text()
        for old, new in item.get("edits", []):
            assert text.count(old) == 1, (item["name"], old[:60])
            assert old != new
