"""repro_torch.models.layers against repro.models.layers (fp32, CPU).

Inputs come from a numpy seed and go to both functions; tolerance 1e-5
(same fp32 arithmetic, possibly in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)
RNG_SEED = 0


def _both(*shapes):
    rng = np.random.default_rng(RNG_SEED)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(j, t):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rmsnorm():
    (jx, jw), (tx, tw) = _both((2, 5, 32), (32,))
    _close(jl.rmsnorm(jx, jw, 1e-6), tl.rmsnorm(tx, tw, 1e-6))


@pytest.mark.parametrize("cap", [0.0, 5.0, 50.0])
def test_softcap(cap):
    (jx,), (tx,) = _both((4, 64))
    _close(jl.softcap(jx * 20, cap), tl.softcap(tx * 20, cap))


@pytest.mark.parametrize("start", [0, 7, 4093])
def test_rope(start):
    (jx,), (tx,) = _both((2, 6, 3, 16))
    pos = np.arange(start, start + 6)[None, :].repeat(2, 0)
    jc, js = jl.rope_freqs(jnp.asarray(pos), 16, 10_000.0)
    tc, ts = tl.rope_freqs(torch.from_numpy(pos), 16, 10_000.0)
    _close(jc, tc)
    _close(js, ts)
    _close(jl.apply_rope(jx, jc, js), tl.apply_rope(tx, tc, ts))


def test_dense_and_embed():
    (jx, jw, jt), (tx, tw, tt) = _both((3, 4, 32), (32, 48), (50, 32))
    _close(jl.dense(jx, jw), tl.dense(tx, tw))
    toks = np.array([[0, 3, 49], [7, 7, 1]])
    _close(jl.embed(jnp.asarray(toks), jt), tl.embed(torch.from_numpy(toks), tt))


@pytest.mark.parametrize("gated", [True, False])
def test_ffn(gated):
    (jx, j1, j2, j3), (tx, t1, t2, t3) = _both((2, 5, 32), (32, 64), (64, 32), (32, 64))
    jp = {"w1": j1, "w2": j2, "w3": j3}
    tp = {"w1": t1, "w2": t2, "w3": t3}
    _close(jl.ffn(jp, jx, gated), tl.ffn(tp, tx, gated))
