"""The port's MoE FFN on the CPU against the JAX reference.

Same weights (the reference's ``init_moe`` converted), same inputs, fp32.
The sort-based capacity dispatch must agree token for token, drops
included; the outputs at 1e-5 (the same products summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import MoEConfig as JaxMoEConfig
from repro_torch.convert import to_torch
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, MoEConfig

TOL = dict(rtol=1e-5, atol=1e-5)
_jit_moe = jax.jit(jmoe.moe_ffn, static_argnums=2)
_jit_fallback = jax.jit(jmoe.moe_ffn_dense_fallback, static_argnums=2)


def _cfgs(E=4, K=2, cf=8.0, groups=4, gated=True, d=32, ff=16):
    """tests/test_moe.py's ``mk_cfg``, once in each package."""
    def mk(Model, MoE):
        return Model(name="t", n_layers=2, d_model=d, n_heads=2, n_kv_heads=2, d_ff=ff,
                     vocab=64, ffn_gated=gated, param_dtype="float32",
                     moe=MoE(n_experts=E, top_k=K, capacity_factor=cf, dispatch_groups=groups))
    return mk(JaxModelConfig, JaxMoEConfig), mk(ModelConfig, MoEConfig)


def _run(jcfg, tcfg, B, S, seed=0):
    """(port moe_ffn, JAX moe_ffn, port fallback, JAX fallback) as numpy."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    return (tmoe.moe_ffn(tp, tx, tcfg).numpy(), np.asarray(_jit_moe(jp, jx, jcfg)),
            tmoe.moe_ffn_dense_fallback(tp, tx, tcfg).numpy(),
            np.asarray(_jit_fallback(jp, jx, jcfg)))


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("E,K,gated", [(4, 1, True), (4, 2, True), (8, 2, False)])
def test_moe_ffn_matches_reference(E, K, gated, groups):
    jcfg, tcfg = _cfgs(E=E, K=K, gated=gated, cf=float(E), groups=groups)
    out, jout, fb, jfb = _run(jcfg, tcfg, 2, 8)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(fb, jfb, **TOL)
    np.testing.assert_allclose(out, fb, rtol=2e-4, atol=2e-4)   # ample capacity: no drops


@pytest.mark.parametrize("B,S,groups,G", [(1, 13, 8, 1), (3, 5, 4, 3), (2, 9, 8, 6)])
def test_moe_ffn_group_count_shrinks_to_divide_tokens(B, S, groups, G):
    """G = min(dispatch_groups, T), lowered until it divides T."""
    jcfg, tcfg = _cfgs(groups=groups, cf=1.25)
    assert tmoe.dispatch_shape(tcfg, B * S)[0] == G
    out, jout, _, _ = _run(jcfg, tcfg, B, S, seed=2)
    np.testing.assert_allclose(out, jout, **TOL)


def test_moe_ffn_drops_match_reference_token_for_token():
    """cf 1.0 at 16 tokens per group: experts overflow and choices drop.  The
    same choices drop in both: the same rows lose their contribution (zero
    rows where every choice dropped) and everything else agrees at 1e-5."""
    jcfg, tcfg = _cfgs(cf=1.0)
    out, jout, fb, _ = _run(jcfg, tcfg, 2, 16)
    assert tmoe.dispatch_shape(tcfg, 32)[1:] == (8, 4)
    dropped = ~np.isclose(out, fb, rtol=1e-4, atol=1e-4).all(-1)
    assert dropped.any() and not dropped.all()          # the case does drop
    np.testing.assert_array_equal(~out.any(-1), ~jout.any(-1))
    np.testing.assert_array_equal(dropped, ~np.isclose(jout, fb, rtol=1e-4, atol=1e-4).all(-1))
    np.testing.assert_allclose(out, jout, **TOL)


def _max_rel(a, b):
    """max |a - b| over max |b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# The first-layer products of bf16 operands in fp32 differ from their exact
# value (float64) only by fp32 summation, ~1e-7 of their scale; rounding them
# to bf16 first, as a bf16 matmul does, moves them by up to 2^-9 ~ 2e-3.
HIDDEN_FP32_TOL = 1e-5


@pytest.mark.parametrize("gated", [True, False])
def test_expert_hidden_keeps_first_layer_products_fp32_in_bf16(gated):
    """In bf16 the experts' first-layer products stay fp32, as the
    reference's ``einsum(..., preferred_element_type=f32)`` keeps them: the
    hidden activations are held against the float64 product of the same
    bf16 operands and against JAX's; a bf16 product cast to fp32 after the
    fact misses the same bound."""
    rng = np.random.default_rng(9)
    E, M, d, f = 4, 24, 64, 48
    xe, w1, w3 = (rng.standard_normal(s).astype(np.float32)
                  for s in ((E, M, d), (E, d, f), (E, d, f)))
    tx, t1, t3 = (torch.from_numpy(a).bfloat16() for a in (xe, w1, w3))
    jx, j1, j3 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (xe, w1, w3))

    got = tmoe._expert_hidden({"w1": t1, "w3": t3}, tx, gated)
    assert got.dtype == torch.float32

    x64, w1_64, w3_64 = (t.double() for t in (tx, t1, t3))
    h = x64 @ w1_64
    exact = (torch.nn.functional.silu(h) * (x64 @ w3_64) if gated
             else torch.nn.functional.gelu(h, approximate="tanh"))
    einsum = lambda a, b: jnp.einsum("emd,edf->emf", a, b, preferred_element_type=jnp.float32)
    jh = einsum(jx, j1)
    jref = jax.nn.silu(jh) * einsum(jx, j3) if gated else jax.nn.gelu(jh)
    assert _max_rel(got, exact) < HIDDEN_FP32_TOL
    assert _max_rel(got, np.asarray(jref)) < HIDDEN_FP32_TOL

    # the old code: bf16 products rounded, then cast to fp32
    h16 = torch.matmul(tx, t1).float()
    old = (torch.nn.functional.silu(h16) * torch.matmul(tx, t3).float() if gated
           else torch.nn.functional.gelu(h16, approximate="tanh"))
    assert _max_rel(old, exact) > 10 * HIDDEN_FP32_TOL


def test_expert_ffn_bf16_feeds_fp32_hidden_to_the_second_product():
    """``_expert_ffn`` is the fp32 hidden activations cast once to the
    operands' dtype, then the second product."""
    rng = np.random.default_rng(10)
    xe, w1, w2, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                      for s in ((2, 8, 32), (2, 32, 16), (2, 16, 32), (2, 32, 16)))
    params = {"w1": w1, "w2": w2, "w3": w3}
    out = tmoe._expert_ffn(params, xe, True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.matmul(tmoe._expert_hidden(params, xe, True).bfloat16(), w2))


@pytest.mark.parametrize("gated", [True, False])
def test_moe_dense_fallback_bf16_matches_reference(gated):
    """bf16 weights and input: the oracle keeps the per-expert outputs fp32
    and casts only the combined sum, as the reference does.  Tolerance: the
    two differ only where fp32 summation order flips a bf16 rounding, so at
    most 1 % of the outputs differ, each by at most one bf16 ulp of itself
    (2^-7 relative); a bf16 rounding of the per-expert outputs before the
    combine moves about a third of them, by up to 7e-3 of the output scale."""
    jcfg, tcfg = _cfgs(E=8, K=2, gated=gated, d=64, ff=48)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}
    assert tp["w1"].dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    x = np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jout = _jit_fallback(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    out = tmoe.moe_ffn_dense_fallback(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert out.dtype == torch.bfloat16
    got, want = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert (diff <= 2.0 ** -7 * np.abs(want)).all(), (diff / np.abs(want).clip(1e-30)).max()
