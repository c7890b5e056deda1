"""The port's flash_attention entry on the CPU (its plain version) against
the reference's oracle and its Pallas kernel in interpret mode.

Bounds are the reference's own (tests/test_kernels.py): 2e-3 in fp32,
2e-2 in bf16.  The kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

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
