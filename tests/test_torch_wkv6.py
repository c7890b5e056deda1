"""The port's wkv6 entry on the CPU (its plain version) against the
reference's oracle and its Pallas kernel in interpret mode, and the port's
``wkv_scan`` against the reference's.

Bound: the reference's own, 2e-4 (tests/test_kernels.py).  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import wkv_scan as jax_wkv_scan
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref, wkv6_segmented_ref
from repro_torch.models.rwkv import wkv_scan

TOL = dict(rtol=2e-4, atol=2e-4)
# (B, H, S, hd, chunk) -- tests/test_kernels.py WKV_CASES; chunk is the
# reference kernel's tiling only
WKV_CASES = [(2, 2, 64, 16, 16), (1, 4, 128, 64, 32), (2, 1, 96, 32, 32), (1, 2, 256, 64, 64)]


def _inputs(B, H, S, hd, seed=0, strong=False):
    """r, k, v normal; decay uniform in (0.7, 0.999) as log w; u * 0.3.
    ``strong``: decay log-uniform in [1e-3, 0.999] instead, channels 3, 19,
    ... pinned at log w = -50 (a 32-token sum far below fp32's exp range)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    if strong:
        logw = rng.uniform(np.log(1e-3), np.log(0.999), (B, H, S, hd))
        logw[..., 3::16] = -50.0
    else:
        logw = np.log(rng.uniform(0.7, 0.999, (B, H, S, hd)))
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u


def _port(arrs):
    return wkv6(*(torch.from_numpy(a) for a in arrs))


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_matches_reference_oracle_and_interpret_kernel(case):
    B, H, S, hd, chunk = case
    arrs = _inputs(B, H, S, hd)
    out, s_last = _port(arrs)
    assert out.shape == (B, H, S, hd) and s_last.shape == (B, H, hd, hd)
    assert out.dtype == s_last.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    for ro, rs in (jax_wkv6_ref(*j), jax_wkv6(*j, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ro), **TOL)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(rs), **TOL)


def test_wkv6_ragged_length_matches_oracle():
    """S = 100 is no multiple of any chunk; the port takes it as it is."""
    arrs = _inputs(2, 3, 100, 64, seed=1)
    out, s_last = _port(arrs)
    ro, rs = jax_wkv6_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("segment", [32, 64, 256])
@pytest.mark.parametrize("shape", [c[:4] for c in WKV_CASES] + [(2, 3, 100, 64), (1, 2, 300, 16)])
def test_wkv6_segmented_split_matches_reference_oracle(shape, segment):
    """The CUDA kernel's split of the sequence (segment states, their carry,
    the outputs from the carried state), written in plain PyTorch, against the
    reference's oracle: at the reference's test shapes, and at S = 100 and 300
    (no multiple of any segment), with one to ten segments."""
    arrs = _inputs(*shape, seed=3)
    out, s_last = wkv6_segmented_ref(*(torch.from_numpy(a) for a in arrs), segment)
    ro, rs = jax_wkv6_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(rs), **TOL)


CHUNK_SHAPES = [c[:4] for c in WKV_CASES] + [(2, 3, 100, 64), (1, 2, 40, 16), (2, 1, 7, 32)]


@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_wkv6_chunk_form_matches_reference_oracle(shape, strong):
    """The CUDA kernel's arithmetic inside a chunk (the factored form, the
    strong-decay guard, the re-based 4-token blocks and the pairwise
    diagonal), in plain PyTorch, against the reference's oracle: finite and
    within 2e-4 on the reference's decays and on strong ones (w down to
    1e-3, some log w = -50); the port's CPU entry too."""
    arrs = _inputs(*shape, seed=4, strong=strong)
    ro, rs = jax_wkv6_ref(*(jnp.asarray(a) for a in arrs))
    for out, s_last in (wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrs)), _port(arrs)):
        assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(ro), **TOL)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(rs), **TOL)


def test_wkv6_factored_chunk_form_overflows_under_strong_decays():
    """Without the guard (every chunk factored as ``r exp(Cx)`` against
    ``k exp(-C)``) strong decays overflow ``exp`` and give non-finite
    outputs: the fault the guard repairs.  On the reference's decays the
    guard never fires and both forms agree bit for bit."""
    args = [torch.from_numpy(a) for a in _inputs(2, 3, 100, 64, seed=4, strong=True)]
    out, _ = wkv6_chunked_ref(*args, strong_logw=-np.inf)
    assert not torch.isfinite(out).all()
    args = [torch.from_numpy(a) for a in _inputs(2, 3, 100, 64, seed=4)]
    assert torch.equal(wkv6_chunked_ref(*args)[0], wkv6_chunked_ref(*args, strong_logw=-np.inf)[0])


def test_wkv_scan_from_nonzero_state_matches_reference():
    B, S, H, hd = 2, 7, 3, 16
    rng = np.random.default_rng(2)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.7, 0.999, (B, S, H, hd)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    arrs = (r, k, v, w, u, S0)
    out, s_last = wkv_scan(*(torch.from_numpy(a) for a in arrs))
    jo, js = jax_wkv_scan(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(js), **TOL)


def test_wkv6_on_cpu_never_reaches_the_kernel(monkeypatch):
    def boom(*args):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(ops, "wkv6_kernel", boom)
    out, _ = _port(_inputs(1, 1, 8, 16))
    assert out.shape == (1, 1, 8, 16)


def test_wkv6_kernel_raises_on_cpu_tensors():
    r, k, v, logw, u = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 16))
    before = wkv6_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel(r, k, v, logw, u)
    with pytest.raises(ValueError, match="head dim"):
        wkv6_kernel(*(torch.zeros(1, 2, 8, 24) for _ in range(4)), torch.zeros(2, 24))
    with pytest.raises(ValueError, match="float32"):
        wkv6_kernel(r.double(), k, v, logw, u)
    assert wkv6_kernel.launches == before
