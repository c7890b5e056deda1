"""The port's selective scan and Mamba block on the CPU against the JAX
reference.

``mamba_scan`` (its plain version on the CPU) against the reference's oracle
and its Pallas kernel in interpret mode, at the reference's bound 2e-4
(tests/test_kernels.py); the block's functions against the JAX ones at 1e-4
(the same math summed in another order).  The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.mamba.ops import mamba_scan as jax_mamba_scan
from repro.kernels.mamba.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.kernels.mamba import ops
from repro_torch.kernels.mamba.kernel import mamba_scan_kernel
from repro_torch.kernels.mamba.ops import mamba_scan
from repro_torch.models import ssm as tssm

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
# (B, S, di, N, block_d, chunk): tests/test_kernels.py MAMBA_CASES; block_d
# and chunk are the reference kernel's tiling only
MAMBA_CASES = [(2, 64, 128, 8, 64, 32), (1, 128, 256, 16, 128, 64), (1, 96, 64, 4, 64, 32)]
ARCH = "jamba-v0.1-52b"


def _scan_inputs(B, S, di, N, seed=0):
    """The reference's test distribution: dt = softplus(normal), x, B, C
    normal, A = -exp(0.5 normal), D = 1."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N)) * 0.5).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    return dt, x, A, Bc, Cc, np.ones((di,), np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_scan_matches_reference_oracle_and_interpret_kernel(case):
    B, S, di, N, bd, chunk = case
    arrs = _scan_inputs(B, S, di, N)
    y, h = mamba_scan(*(torch.from_numpy(a) for a in arrs))
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    assert y.dtype == h.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    for yr, hr in (jax_mamba_scan_ref(*j),
                   jax_mamba_scan(*j, block_d=bd, chunk=chunk, interpret=True)):
        _close(y, yr, SCAN_TOL)
        _close(h, hr, SCAN_TOL)


def test_mamba_scan_ragged_length_matches_oracle():
    """S = 100 is no multiple of the reference kernel's chunk (which asserts
    one); the port takes it as it is."""
    arrs = _scan_inputs(2, 100, 64, 16, seed=1)
    y, h = mamba_scan(*(torch.from_numpy(a) for a in arrs))
    yr, hr = jax_mamba_scan_ref(*(jnp.asarray(a) for a in arrs))
    _close(y, yr, SCAN_TOL)
    _close(h, hr, SCAN_TOL)


def test_mamba_scan_float64_stays_float64():
    arrs = [torch.from_numpy(a).double() for a in _scan_inputs(1, 20, 16, 4, seed=2)]
    y, h = mamba_scan(*arrs)
    assert y.dtype == h.dtype == torch.float64
    y32, h32 = mamba_scan(*(a.float() for a in arrs))
    torch.testing.assert_close(y32, y.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h32, h.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    B, S, di, dc = 2, 9, 16, 4
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    w = rng.standard_normal((dc, di)).astype(np.float32)
    b = rng.standard_normal((di,)).astype(np.float32)
    st = rng.standard_normal((B, dc - 1, di)).astype(np.float32) if with_state else None
    j_out, j_st = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    t_out, t_st = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b),
                                    None if st is None else torch.from_numpy(st))
    _close(t_out, j_out)
    _close(t_st, j_st)           # the last d_conv - 1 rows of the padded input


def _block_pair(seed=4):
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, {n: to_torch(np.asarray(a), "cpu") for n, a in jp.items()}


def test_mamba_prefill_matches_reference_and_sequential_oracle():
    """S = 130: the reference's chunk shrinks from 128 to 65 to divide S."""
    jcfg, tcfg, jp, tp = _block_pair()
    x = np.random.default_rng(5).standard_normal((2, 130, jcfg.d_model)).astype(np.float32)
    j_out, j_st = jssm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    t_out, t_st = tssm.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    _close(t_out, j_out)
    _close(t_out, jssm.mamba_ref_sequential(jp, jnp.asarray(x), jcfg))
    assert set(t_st) == set(j_st) == {"h", "conv"}
    for n in j_st:
        _close(t_st[n], j_st[n])


def test_mamba_decode_from_nonzero_state_matches_reference():
    jcfg, tcfg, jp, tp = _block_pair(seed=6)
    di, N = jcfg.mamba_expand * jcfg.d_model, jcfg.mamba_d_state
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    st = {"h": rng.standard_normal((2, di, N)).astype(np.float32),
          "conv": rng.standard_normal((2, jcfg.mamba_d_conv - 1, di)).astype(np.float32)}
    j_out, j_st = jssm.mamba_decode(jp, jnp.asarray(x), jcfg,
                                    {n: jnp.asarray(a) for n, a in st.items()})
    t_out, t_st = tssm.mamba_decode(tp, torch.from_numpy(x), tcfg,
                                    {n: torch.from_numpy(a) for n, a in st.items()})
    _close(t_out, j_out)
    for n in ("h", "conv"):
        _close(t_st[n], j_st[n])


def test_mamba_scan_on_cpu_never_reaches_the_kernel(monkeypatch):
    def boom(*args):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(ops, "mamba_scan_kernel", boom)
    y, _ = mamba_scan(*(torch.from_numpy(a) for a in _scan_inputs(1, 8, 16, 4)))
    assert y.shape == (1, 8, 16)


def test_mamba_scan_kernel_raises_on_what_it_does_not_take():
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 8, 16, 4)]
    before = mamba_scan_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_kernel(*args)
    dt, x, A, Bc, Cc, D = _scan_inputs(1, 8, 16, 6)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan_kernel(*(torch.from_numpy(a) for a in (dt, x, A, Bc, Cc, D)))
    with pytest.raises(ValueError, match="float32"):
        mamba_scan_kernel(args[0].double(), *args[1:])
    assert mamba_scan_kernel.launches == before
