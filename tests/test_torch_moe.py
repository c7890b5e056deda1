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
