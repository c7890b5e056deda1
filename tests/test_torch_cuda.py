"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a); every test here is
marked ``cuda`` and skips without one.  This file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba.kernel import mamba_scan_kernel
from repro_torch.kernels.mamba.ref import mamba_scan_ref
from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
from repro_torch.kernels.rwkv6.ref import wkv6_ref

pytestmark = pytest.mark.cuda

# (B, H, KV, Sq, hd, causal, window, softcap, dtype): tests/test_kernels.py
# FA_CASES, the same cases in bf16, and ragged / hd-256 / Sq != Skv shapes.
FA_GPU_CASES = [
    (2, 4, 2, 256, 64, True, 0, 0.0, torch.float32),
    (1, 4, 1, 256, 128, True, 0, 50.0, torch.float32),
    (2, 2, 2, 384, 64, True, 128, 0.0, torch.float32),
    (1, 8, 4, 512, 64, False, 0, 0.0, torch.float32),
    (1, 2, 2, 256, 64, True, 0, 0.0, torch.bfloat16),
    (1, 16, 2, 128, 128, True, 64, 30.0, torch.float32),
    (2, 4, 2, 256, 64, True, 0, 0.0, torch.bfloat16),
    (1, 4, 1, 256, 128, True, 0, 50.0, torch.bfloat16),
    (2, 2, 2, 384, 64, True, 128, 0.0, torch.bfloat16),
    (1, 8, 4, 512, 64, False, 0, 0.0, torch.bfloat16),
    (1, 16, 2, 128, 128, True, 64, 30.0, torch.bfloat16),
    (1, 8, 2, 1000, 128, True, 0, 0.0, torch.bfloat16),
    (1, 8, 2, 1000, 128, True, 300, 0.0, torch.float32),
    (1, 4, 2, 777, 256, True, 256, 50.0, torch.bfloat16),
    (1, 4, 2, 333, 256, False, 0, 50.0, torch.float32),
    (1, 4, 2, 1024, 256, True, 0, 50.0, torch.bfloat16),
    (4, 16, 8, 2048, 64, True, 0, 0.0, torch.bfloat16),     # granite-moe prefill
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", FA_GPU_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, case):
    B, H, KV, S, hd, causal, window, cap, dtype = case
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(B, H, S, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, KV, S, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, KV, S, hd, generator=g, device=cuda_device).to(dtype)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap)
    ref = attention_ref(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3   # the reference's bounds
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # Rows that see many keys have outputs ~1/sqrt(keys), far under ``tol``:
    # hold each row's worst error to a tenth of the row's rms as well, which a
    # dropped or doubled key tile exceeds.
    row_err = (out.float() - ref.float()).abs().amax(-1)
    row_rms = ref.float().pow(2).mean(-1).sqrt()
    assert (row_err <= 0.1 * row_rms).all(), (row_err / row_rms).max().item()


def test_flash_attention_kernel_takes_model_layout(cuda_device):
    """A transposed [B,S,H,hd] view goes in without a copy and the output
    keeps that layout."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, H, KV, hd = 2, 200, 8, 2, 128
    q = torch.randn(B, S, H, hd, generator=g, device=cuda_device).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_attention_kernel(qt, kt, vt, causal=True)
    assert out.stride() == qt.stride()
    ref = attention_ref(qt, kt, vt, True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_kernel_counts_launches(cuda_device):
    q = torch.randn(1, 2, 64, 64, device=cuda_device)
    before = flash_attention_kernel.launches
    flash_attention_kernel(q, q, q)
    assert flash_attention_kernel.launches == before + 1


# (B, H, S, hd): tests/test_kernels.py WKV_CASES, then ragged lengths (no
# multiple of the 32-token chunk), one chunk or less, and a longer sequence.
WKV_GPU_CASES = [
    (2, 2, 64, 16), (1, 4, 128, 64), (2, 1, 96, 32), (1, 2, 256, 64),
    (2, 40, 100, 64), (1, 3, 7, 16), (2, 2, 33, 32), (1, 1, 1, 64), (2, 4, 1000, 64),
]
# Per-row bound on max|kernel - plain| / rms(plain row): fp32 rounding in
# another summation order leaves up to ~4e-4 of a row's size in rows whose
# sums cancel (the fp32 plain version is as far from a float64 run), ~1e-6
# elsewhere; a dropped or doubled chunk, or a wrong decay, moves a row by O(1).
WKV_ROW_REL_TOL = 1e-3


def _wkv_inputs(device, B, H, S, hd, seed=0):
    """r, k, v normal; decay uniform in (0.7, 0.999) as log w; u * 0.3 (the
    reference's test distribution)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=device) for _ in range(3))
    w = 0.7 + 0.299 * torch.rand(B, H, S, hd, generator=g, device=device)
    u = 0.3 * torch.randn(H, hd, generator=g, device=device)
    return r, k, v, torch.log(w), u


def _assert_wkv_close(got, want):
    for o, ref in zip(got, want):
        torch.testing.assert_close(o, ref, rtol=2e-4, atol=2e-4)   # the reference's bound
        row_err = (o - ref).abs().amax(-1)
        row_rms = ref.pow(2).mean(-1).sqrt()
        assert (row_err <= WKV_ROW_REL_TOL * row_rms).all(), (row_err / row_rms).max().item()


@pytest.mark.parametrize("case", WKV_GPU_CASES)
def test_wkv6_kernel_matches_plain(cuda_device, case):
    args = _wkv_inputs(cuda_device, *case)
    got = wkv6_kernel(*args)
    want = wkv6_ref(*args)
    torch.cuda.synchronize()
    _assert_wkv_close(got, want)


def test_wkv6_kernel_takes_model_layout(cuda_device):
    """Transposed [B,S,H,hd] views go in without a copy; out keeps that layout."""
    B, S, H, hd = 2, 70, 6, 64
    r, k, v, logw, u = _wkv_inputs(cuda_device, B, H, S, hd, seed=1)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, logw)]
    assert not views[0].is_contiguous()
    out, s_last = wkv6_kernel(*views, u)
    assert out.stride() == views[0].stride()
    assert out.transpose(1, 2).is_contiguous()
    _assert_wkv_close((out, s_last), wkv6_ref(r, k, v, logw, u))


def test_wkv6_kernel_counts_launches(cuda_device):
    args = _wkv_inputs(cuda_device, 1, 2, 40, 32)
    before = wkv6_kernel.launches
    wkv6_kernel(*args)
    assert wkv6_kernel.launches == before + 1


# (B, S, di, N): tests/test_kernels.py MAMBA_CASES, then ragged lengths (no
# multiple of the 32-token chunk), one token, d_inner no multiple of the
# 128-channel block, and a longer sequence.
MAMBA_GPU_CASES = [
    (2, 64, 128, 8), (1, 128, 256, 16), (1, 96, 64, 4),
    (2, 100, 256, 16), (1, 7, 128, 8), (1, 1, 128, 4), (2, 50, 200, 16), (3, 33, 320, 4),
    (2, 1000, 512, 16),
]
# Per-row bound on max|kernel - plain| / rms(plain row) over a token's
# channels: the two differ only in fp32 rounding (expf, fused multiply-adds,
# the order of the N-term sum); a dropped, repeated or misplaced token moves
# a row by O(1).
MAMBA_ROW_REL_TOL = 1e-3


def _mamba_inputs(device, B, S, di, N, dtype=torch.float32, seed=0):
    """The reference's test distribution: dt = softplus(normal), x, B, C
    normal, A = -exp(0.5 normal), D = 1.  x, B and C in ``dtype``; B and C
    are column slices of one [B, S, R + 2N] tensor, as the model passes them
    (R = 256, jamba's dt rank)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device=device))
    x = torch.randn(B, S, di, generator=g, device=device).to(dtype)
    A = -torch.exp(0.5 * torch.randn(di, N, generator=g, device=device))
    dbc = torch.randn(B, S, 256 + 2 * N, generator=g, device=device).to(dtype)
    _, Bc, Cc = dbc.split([256, N, N], dim=-1)
    return dt, x, A, Bc, Cc, torch.ones(di, device=device)


def _assert_mamba_close(got, want):
    for o, ref in zip(got, want):
        torch.testing.assert_close(o, ref, rtol=2e-4, atol=2e-4)   # the reference's bound
        row_err = (o - ref).abs().amax(-1)
        row_rms = ref.pow(2).mean(-1).sqrt()
        assert (row_err <= MAMBA_ROW_REL_TOL * row_rms).all(), (row_err / row_rms).max().item()


@pytest.mark.parametrize("case", MAMBA_GPU_CASES)
def test_mamba_scan_kernel_matches_plain(cuda_device, case):
    args = _mamba_inputs(cuda_device, *case)
    got = mamba_scan_kernel(*args)
    want = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    _assert_mamba_close(got, want)


@pytest.mark.parametrize("case", [(2, 100, 256, 16), (1, 70, 200, 4)])
def test_mamba_scan_kernel_takes_model_layout(cuda_device, case):
    """bf16 x with B and C as strided bf16 views (row stride R + 2N), as the
    model passes them: no copy, the same result as the plain version on the
    same bf16 values."""
    args = _mamba_inputs(cuda_device, *case, dtype=torch.bfloat16, seed=1)
    Bc = args[3]
    assert not Bc.is_contiguous() and Bc.stride(1) == 256 + 2 * case[3]
    got = mamba_scan_kernel(*args)
    want = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    _assert_mamba_close(got, want)


def test_mamba_scan_kernel_counts_launches(cuda_device):
    args = _mamba_inputs(cuda_device, 1, 40, 128, 16)
    before = mamba_scan_kernel.launches
    mamba_scan_kernel(*args)
    assert mamba_scan_kernel.launches == before + 1
