"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a); every test here is
marked ``cuda`` and skips without one.  This file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                        flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel, mamba_scan_kernel
from repro_torch.kernels.mamba.ops import mamba_scan
from repro_torch.kernels.mamba.ref import mamba_scan_bwd_ref, mamba_scan_ref
from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel, tma_path
from repro_torch.kernels.qmatmul.ops import qmatmul
from repro_torch.kernels.qmatmul.ref import qmatmul_ref, quantize_cols, quantize_rows
from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_kernel
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.models import moe as tmoe

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
    (4, 16, 8, 2048, 256, True, 4096, 50.0, torch.bfloat16),  # gemma2-9b local, facade
    # the head layouts of the configs first run on the card: granite-20b
    # (MQA, a group of 48), starcoder2-15b (48 / 4), llama4 (40 / 8, a group
    # of 5), paligemma (MQA at hd 256), musicgen (MHA at hd 64)
    (1, 48, 1, 640, 128, True, 0, 0.0, torch.bfloat16),
    (1, 48, 1, 300, 128, True, 0, 0.0, torch.float32),
    (1, 48, 4, 640, 128, True, 0, 0.0, torch.bfloat16),
    (1, 48, 4, 300, 128, True, 0, 0.0, torch.float32),
    (1, 40, 8, 640, 128, True, 0, 0.0, torch.bfloat16),
    (1, 40, 8, 300, 128, True, 0, 0.0, torch.float32),
    (2, 8, 1, 640, 256, True, 0, 0.0, torch.bfloat16),
    (2, 8, 1, 300, 256, True, 0, 0.0, torch.float32),
    (1, 24, 24, 640, 64, True, 0, 0.0, torch.bfloat16),
    (1, 24, 24, 300, 64, True, 0, 0.0, torch.float32),
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


# (B, H, KV, Sq, Skv, hd, causal, window, softcap): the edges of the bf16
# wgmma kernel -- one token; Sq / Skv no multiple of its 128-row query tile or
# of its key tile (64 keys at hd 256, 128 otherwise), a single partial tile,
# Sq != Skv both ways; GQA ratios 1, 2 and 4; windows narrower than one key
# tile; softcap; non-causal.  Each runs in the reference layout and as the
# transposed view of the model's [B,S,H,hd] tensors (TMA over the strided
# view, zero fill past each head's rows).
FA_BF16_EDGE_CASES = [
    (1, 2, 2, 1, 1, 64, True, 0, 0.0),
    (1, 4, 4, 50, 50, 128, True, 0, 0.0),
    (2, 4, 2, 200, 333, 128, False, 0, 0.0),
    (1, 4, 2, 300, 200, 128, True, 0, 0.0),
    (1, 8, 2, 129, 129, 64, True, 0, 0.0),
    (1, 4, 1, 300, 300, 256, True, 0, 50.0),
    (1, 4, 2, 517, 517, 128, True, 40, 0.0),
    (1, 4, 2, 257, 100, 64, False, 0, 30.0),
    (2, 2, 2, 190, 190, 256, True, 33, 0.0),
    (1, 4, 4, 1000, 1000, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", FA_BF16_EDGE_CASES)
def test_flash_attention_bf16_kernel_edges(cuda_device, case, layout):
    B, H, KV, Sq, Skv, hd, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def make(n, S):
        if layout == "bhsd":
            return torch.randn(B, n, S, hd, generator=g, device=cuda_device).bfloat16()
        return torch.randn(B, S, n, hd, generator=g, device=cuda_device).bfloat16().transpose(1, 2)

    q, k, v = make(H, Sq), make(KV, Skv), make(KV, Skv)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap)
    ref = attention_ref(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    row_err = (out.float() - ref.float()).abs().amax(-1)
    row_rms = ref.float().pow(2).mean(-1).sqrt()
    assert (row_err <= 0.1 * row_rms).all(), (row_err / row_rms).max().item()


# (B, H, KV, Sq, Skv, q_offset, hd, window, softcap): a WSP rank's call --
# its queries at positions q_offset.. against the keys up to its last -- in
# the middle and at the end of a sequence, with a window that reaches into
# the other ranks' keys, a softcap, ragged tiles and an offset that is no
# multiple of a tile; each in fp32 and bf16.
FA_OFFSET_CASES = [
    (2, 8, 2, 256, 512, 256, 128, 0, 0.0),
    (1, 4, 2, 200, 777, 577, 64, 0, 30.0),
    (1, 4, 2, 300, 1200, 900, 256, 512, 50.0),
    (2, 4, 4, 129, 300, 171, 128, 100, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_OFFSET_CASES)
def test_flash_attention_kernel_query_offset(cuda_device, case, dtype):
    B, H, KV, Sq, Skv, off, hd, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(B, H, Sq, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, KV, Skv, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, KV, Skv, hd, generator=g, device=cuda_device).to(dtype)
    out = flash_attention_kernel(q, k, v, causal=True, window=window, softcap=cap, q_offset=off)
    ref = attention_ref(q, k, v, True, window, cap, q_offset=off)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
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
# multiple of the 32-token chunk), one chunk or less, and a longer sequence;
# then the kernel's 256-token segments: S = 31 and 33 around the chunk, and
# several segments at hd 16 / 32 / 64, whole, with a one-token tail, or with
# a ragged tail.
WKV_GPU_CASES = [
    (2, 2, 64, 16), (1, 4, 128, 64), (2, 1, 96, 32), (1, 2, 256, 64),
    (2, 40, 100, 64), (1, 3, 7, 16), (2, 2, 33, 32), (1, 1, 1, 64), (2, 4, 1000, 64),
    (2, 2, 31, 32), (2, 2, 33, 16), (1, 2, 300, 64), (2, 3, 700, 32), (1, 2, 1000, 16),
    (2, 2, 513, 64), (1, 3, 768, 32), (2, 2, 257, 16),
]
# Per-row bound on max|kernel - plain| / rms(plain row): fp32 rounding in
# another summation order leaves up to ~4e-4 of a row's size in rows whose
# sums cancel (the fp32 plain version is as far from a float64 run), ~1e-6
# elsewhere; a dropped or doubled chunk, or a wrong decay, moves a row by O(1).
WKV_ROW_REL_TOL = 1e-3


def _wkv_inputs(device, B, H, S, hd, seed=0, strong=False):
    """r, k, v normal; decay uniform in (0.7, 0.999) as log w; u * 0.3 (the
    reference's test distribution).  ``strong``: decay log-uniform in
    [1e-3, 0.999] instead, channels 3, 19, ... pinned at log w = -50, whose
    32-token sums overflow exp in fp32.  ``"half_strong"``: in every token
    half the channels, at random, log-uniform in [1e-3, e^-2), the other half
    log w uniform in [-2, log 0.999] (the forward's strong-decay threshold)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=device) for _ in range(3))
    draw = torch.rand(B, H, S, hd, generator=g, device=device)
    if strong == "half_strong":
        logw = -2.0 + (math.log(0.999) + 2.0) * draw
        low = math.log(1e-3) + (-2.0 - math.log(1e-3)) * torch.rand(
            B, H, S, hd, generator=g, device=device)
        half = torch.rand(B, H, S, hd, generator=g, device=device).argsort(-1) < hd // 2
        logw = torch.where(half, low, logw)
    elif strong:
        lo, hi = math.log(1e-3), math.log(0.999)
        logw = lo + (hi - lo) * draw
        logw[..., 3::16] = -50.0
    else:
        logw = torch.log(0.7 + 0.299 * draw)
    u = 0.3 * torch.randn(H, hd, generator=g, device=device)
    return r, k, v, logw, u


def _assert_wkv_close(got, want):
    for o, ref in zip(got, want):
        torch.testing.assert_close(o, ref, rtol=2e-4, atol=2e-4)   # the reference's bound
        row_err = (o - ref).abs().amax(-1)
        row_rms = ref.pow(2).mean(-1).sqrt()
        assert (row_err <= WKV_ROW_REL_TOL * row_rms).all(), (row_err / row_rms).max().item()


@pytest.mark.parametrize("strong", [False, True], ids=["reference", "strong_decays"])
@pytest.mark.parametrize("case", WKV_GPU_CASES)
def test_wkv6_kernel_matches_plain(cuda_device, case, strong):
    args = _wkv_inputs(cuda_device, *case, strong=strong)
    got = wkv6_kernel(*args)
    want = wkv6_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
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


# (B, H, S, hd, dS_last): the backward at the reference's test shapes, ragged
# lengths (no multiple of the 16-token chunk, the 128-token block or the
# 256-token segment), one token, several segments at each head dim, with and
# without a cotangent of S_last, and rwkv6-3b's head count over two segments.
WKV_BWD_GPU_CASES = [
    (2, 2, 64, 16, False), (1, 4, 128, 64, True), (2, 1, 96, 32, False), (1, 2, 256, 64, True),
    (2, 3, 100, 64, True), (1, 3, 1, 64, True), (1, 2, 7, 32, False), (2, 2, 257, 16, True),
    (1, 2, 700, 32, True), (2, 2, 513, 64, False), (1, 3, 1000, 64, True),
    (2, 40, 300, 64, False),
]


def _wkv_bwd_case(device, B, H, S, hd, with_ds, strong, seed=0):
    r, k, v, logw, u = _wkv_inputs(device, B, H, S, hd, seed=seed, strong=strong)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dout = torch.randn(B, H, S, hd, generator=g, device=device)
    ds = torch.randn(B, H, hd, hd, generator=g, device=device) if with_ds else None
    return (r, k, v, logw, u), dout, ds


def _assert_wkv_bwd_close(got, want):
    """Every gradient within the forward's bound (2e-4, relative and
    absolute: du is a sum over B*S) and per row within WKV_ROW_REL_TOL of
    the row's rms, over the non-zero rows whose rms reaches 1e-3 of the
    tensor's (dlogw at the last token is 0 without a cotangent of S_last,
    and everywhere at S = 1: the absolute bound holds those)."""
    for name, a, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want, strict=True):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4, msg=name)
        row_err = (a - w).abs().amax(-1)
        row_rms = w.pow(2).mean(-1).sqrt()
        keep = (row_rms > 0) & (row_rms >= 1e-3 * w.pow(2).mean().sqrt())
        assert (row_err[keep] <= WKV_ROW_REL_TOL * row_rms[keep]).all(), \
            (name, (row_err[keep] / row_rms[keep]).max().item())


@pytest.mark.parametrize("strong", [False, True, "half_strong"],
                         ids=["reference", "strong_decays", "half_strong"])
@pytest.mark.parametrize("case", WKV_BWD_GPU_CASES)
def test_wkv6_bwd_kernel_matches_plain(cuda_device, case, strong):
    """The backward kernel on what the forward keeps, against the plain
    backward: three decay ranges, ragged lengths, dS_last, two calls
    bit-identical (no atomics; fixed summation order)."""
    *shape, with_ds = case
    args, dout, ds = _wkv_bwd_case(cuda_device, *shape, with_ds, strong)
    _, _, seg_state = wkv6_kernel(*args, with_states=True)
    got = wkv6_bwd_kernel(*args, seg_state, dout, ds)
    again = wkv6_bwd_kernel(*args, seg_state, dout, ds)
    want = wkv6_bwd_ref(*args, dout, ds)
    torch.cuda.synchronize()
    _assert_wkv_bwd_close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


def test_wkv6_autograd_goes_through_both_kernels(cuda_device):
    """``wkv6`` on transposed [B,S,H,hd] leaves as the model passes them:
    one forward and one backward launch, gradients in the leaves' layout,
    matching the plain backward; a loss on S_last alone reaches the kernel
    as a cotangent of S_last with a zero dout."""
    B, S, H, hd = 2, 300, 4, 64
    (r, k, v, logw, u), dout, ds = _wkv_bwd_case(cuda_device, B, H, S, hd, True, False, seed=3)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (r, k, v, logw)]
    uu = u.clone().requires_grad_(True)
    f0, b0 = wkv6_kernel.launches, wkv6_bwd_kernel.launches
    out, s_last = wkv6(*(t.transpose(1, 2) for t in leaves), uu)
    loss = (out * dout).sum() + (s_last * ds).sum()
    grads = torch.autograd.grad(loss, [*leaves, uu])
    assert (wkv6_kernel.launches, wkv6_bwd_kernel.launches) == (f0 + 1, b0 + 1)
    assert all(g.stride() == t.stride() for g, t in zip(grads, leaves))
    want = wkv6_bwd_ref(r, k, v, logw, u, dout, ds)
    _assert_wkv_bwd_close([g.transpose(1, 2) for g in grads[:4]] + [grads[4]], want)
    out, s_last = wkv6(*(t.transpose(1, 2) for t in leaves), uu)
    grads = torch.autograd.grad((s_last * ds).sum(), [*leaves, uu])
    want = wkv6_bwd_ref(r, k, v, logw, u, torch.zeros_like(dout), ds)
    _assert_wkv_bwd_close([g.transpose(1, 2) for g in grads[:4]] + [grads[4]], want)


# (B, S, di, N): tests/test_kernels.py MAMBA_CASES, then ragged lengths (no
# multiple of the 32-token chunk), one token, d_inner no multiple of the
# 128-channel block, and a longer sequence; then the edges of the kernel's
# split: one token at N = 16, S just past one chunk and past the three-chunk
# ring, d_inner not a multiple of 4 (plain loads in place of cp.async),
# several chunks with a ragged tail.
MAMBA_GPU_CASES = [
    (2, 64, 128, 8), (1, 128, 256, 16), (1, 96, 64, 4),
    (2, 100, 256, 16), (1, 7, 128, 8), (1, 1, 128, 4), (2, 50, 200, 16), (3, 33, 320, 4),
    (2, 1000, 512, 16),
    (2, 1, 256, 16), (2, 33, 256, 16), (1, 97, 384, 8), (1, 65, 130, 16), (2, 300, 1000, 16),
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


@pytest.mark.parametrize("case", [(2, 100, 256, 16), (1, 70, 200, 4), (1, 45, 130, 16)])
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


# (B, S, di, N, x dtype, a cotangent of h_last): tests/test_kernels.py
# MAMBA_CASES, then ragged lengths over several 64-token chunks, S below one
# chunk, one token, d_inner no multiple of the 128-channel block, bf16 x in
# the model layout at N = 4, 8 and 16 (N = 4's 8-byte rows of B / C take
# plain loads), and rows of dt, x and dy that are not 16-byte aligned (di =
# 130), which take plain loads in place of cp.async.
MAMBA_BWD_GPU_CASES = [
    (2, 64, 128, 8, torch.float32, False), (1, 128, 256, 16, torch.float32, False),
    (1, 96, 64, 4, torch.float32, False), (2, 100, 256, 16, torch.float32, True),
    (2, 40, 200, 16, torch.bfloat16, True), (1, 1, 128, 8, torch.float32, True),
    (2, 300, 1000, 16, torch.bfloat16, False), (1, 700, 136, 4, torch.bfloat16, True),
    (2, 129, 384, 8, torch.bfloat16, True), (2, 200, 130, 16, torch.bfloat16, True),
]


def _assert_mamba_bwd_close(got, want):
    """Every gradient within the forward's bound (2e-4, relative and
    absolute: dA and dD are sums over B*S) and per row within
    MAMBA_ROW_REL_TOL of the row's rms, over the rows whose rms reaches 1e-3
    of the tensor's."""
    for name, a, w in zip(("ddt", "dx", "dA", "dB", "dC", "dD"), got, want, strict=True):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4, msg=name)
        row_err = (a - w).abs().amax(-1)
        row_rms = w.pow(2).mean(-1).sqrt()
        keep = (row_rms > 0) & (row_rms >= 1e-3 * w.pow(2).mean().sqrt())
        assert (row_err[keep] <= MAMBA_ROW_REL_TOL * row_rms[keep]).all(), \
            (name, (row_err[keep] / row_rms[keep]).max().item())


@pytest.mark.parametrize("case", MAMBA_BWD_GPU_CASES)
def test_mamba_scan_bwd_kernel_matches_plain(cuda_device, case):
    """The backward kernel on the chunk states the forward keeps, against
    the plain backward: its fp32 gradients at the forward's bounds, those in
    x's dtype the fp32 ones rounded, two calls bit-identical (no atomics;
    fixed summation order)."""
    *shape, dtype, with_dh = case
    B, S, di, N = shape
    args = _mamba_inputs(cuda_device, *shape, dtype=dtype, seed=2)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dy = torch.randn(B, S, di, generator=g, device=cuda_device)
    dh = torch.randn(B, di, N, generator=g, device=cuda_device) if with_dh else None
    _, _, states = mamba_scan_kernel(*args, with_states=True)
    got32 = mamba_scan_bwd_kernel(*args, states, dy, dh, grad_dtype=torch.float32)
    got = mamba_scan_bwd_kernel(*args, states, dy, dh)
    again = mamba_scan_bwd_kernel(*args, states, dy, dh)
    want = mamba_scan_bwd_ref(*args, dy, dh)
    torch.cuda.synchronize()
    _assert_mamba_bwd_close(got32, want)
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, got32, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


def test_mamba_scan_autograd_goes_through_both_kernels(cuda_device):
    """``mamba_scan`` on leaves laid out as the model passes them (bf16 x,
    B and C column slices of one tensor): one forward and one backward
    launch, gradients in the leaves' dtypes matching the plain backward; a
    loss on h_last alone reaches the kernel as its cotangent with a zero
    dy."""
    B, S, di, N = 2, 200, 256, 16
    dt, x, A, Bc, Cc, D = _mamba_inputs(cuda_device, B, S, di, N, dtype=torch.bfloat16, seed=4)
    dbc = Bc._base.detach().clone().requires_grad_(True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (dt, x, A, D)]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dy = torch.randn(B, S, di, generator=g, device=cuda_device)
    dh = torch.randn(B, di, N, generator=g, device=cuda_device)

    def run():
        _, b, c = dbc.split([256, N, N], dim=-1)
        return mamba_scan(leaves[0], leaves[1], leaves[2], b, c, leaves[3])

    f0, b0 = mamba_scan_kernel.launches, mamba_scan_bwd_kernel.launches
    y, h_last = run()
    grads = torch.autograd.grad((y * dy).sum() + (h_last * dh).sum(), [*leaves, dbc])
    assert (mamba_scan_kernel.launches, mamba_scan_bwd_kernel.launches) == (f0 + 1, b0 + 1)
    assert [t.dtype for t in grads] == [torch.float32, torch.bfloat16, torch.float32,
                                        torch.float32, torch.bfloat16]
    args = (dt, x, A, Bc, Cc, D)
    for loss_dy, loss_dh in ((dy, dh), (torch.zeros_like(dy), dh)):
        if loss_dy is not dy:
            y, h_last = run()
            grads = torch.autograd.grad((h_last * dh).sum(), [*leaves, dbc])
        ddt, dx, dA, dB, dC, dD = mamba_scan_bwd_kernel(*args, mamba_scan_kernel(
            *args, with_states=True)[2], loss_dy, loss_dh)
        for a, w in ((grads[0], ddt), (grads[1], dx), (grads[2], dA), (grads[3], dD),
                     (grads[4][..., 256:256 + N], dB), (grads[4][..., 256 + N:], dC)):
            assert torch.equal(a, w)
        assert (grads[4][..., :256] == 0).all()


# (M, N, K, out dtype): tests/test_kernels.py's shapes, benchmarks/
# kernel_bench.py's 256 x 512 x 256 (2 output tiles: fewer than SMs), ragged
# M / N / K on the byte-staged mma.sync path (K % 16 nonzero), ragged tiles
# of the wgmma / TMA path (M no multiple of 128, N of 256, K of 128; one row
# in bf16; fewer tiles than SMs), bf16 output, and the granite-3-8b FFN
# up-projection of a B=4 x S=2048 prefill.
QMM_GPU_CASES = [
    (128, 128, 128, torch.float32), (256, 128, 384, torch.float32),
    (128, 256, 256, torch.float32), (256, 256, 512, torch.float32),
    (1, 40, 100, torch.float32), (100, 40, 96, torch.float32),
    (8193, 12801, 4100, torch.float32), (300, 200, 160, torch.bfloat16),
    (1, 40, 100, torch.bfloat16), (8192, 12800, 4096, torch.float32),
    (8193, 12808, 4112, torch.float32), (1, 4096, 4096, torch.bfloat16),
    (200, 300, 272, torch.float32),
]


def _qmm_inputs(device, M, N, K, seed=0):
    """int8 operands uniform in [-127, 127], scales uniform in (0.5, 1.5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (M, K), generator=g, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    xs = 0.5 + torch.rand(M, generator=g, device=device)
    ws = 0.5 + torch.rand(N, generator=g, device=device)
    return x, w, xs, ws


@pytest.mark.parametrize("case", QMM_GPU_CASES)
def test_qmatmul_kernel_matches_plain(cuda_device, case):
    """Bit-equal: the int32 sum is exact in both, and both dequantize as
    (float(acc) * x_scale) * w_scale, each step rounded to nearest."""
    M, N, K, out_dtype = case
    args = _qmm_inputs(cuda_device, M, N, K)
    got = qmatmul_kernel(*args, out_dtype=out_dtype)
    want = qmatmul_ref(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def test_qmatmul_quantized_close_to_bf16_product(cuda_device):
    """The granite FFN up-projection shape: quantize a bf16 activation per row
    and a weight per column; the op's int8 product is within the reference's
    0.02 of the bf16 product."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(8192, 4096, generator=g, device=cuda_device).bfloat16()
    w = (0.02 * torch.randn(4096, 12800, generator=g, device=cuda_device)).bfloat16()
    xq, xs = quantize_rows(x)
    wq, ws = quantize_cols(w)
    before = qmatmul_kernel.launches
    out = qmatmul(xq, wq, xs, ws)
    assert qmatmul_kernel.launches == before + 1
    ref = (x @ w).float()
    assert ((out - ref).norm() / ref.norm()).item() < 0.02


def test_qmatmul_op_launches_the_kernel(cuda_device):
    args = _qmm_inputs(cuda_device, 64, 32, 96)
    before = qmatmul_kernel.launches
    got = qmatmul(*args)
    assert qmatmul_kernel.launches == before + 1
    assert torch.equal(got, qmatmul(*args, impl="ref"))
    assert qmatmul_kernel.launches == before + 1


def _unaligned_copy(x):
    """A contiguous copy of x whose data starts one byte past a 16-byte bound."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    base = (16 - buf.data_ptr() % 16) % 16 + 1
    out = buf[base:base + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_qmatmul_both_paths_agree_and_count_one_launch(cuda_device, out_dtype):
    """One shape both kernels take, sent down each path by x's alignment (the
    predicate's input): each call adds one to the count, and the wgmma / TMA
    kernel, the byte-staged mma.sync kernel and the plain version agree bit
    for bit."""
    M, N, K = 1000, 777, 1040
    x, w, xs, ws = _qmm_inputs(cuda_device, M, N, K, seed=3)
    x_odd = _unaligned_copy(x)
    assert tma_path(K, x.data_ptr()) and not tma_path(K, x_odd.data_ptr())
    outs = []
    for xx in (x, x_odd):
        before = qmatmul_kernel.launches
        outs.append(qmatmul_kernel(xx, w, xs, ws, out_dtype=out_dtype))
        torch.cuda.synchronize()
        assert qmatmul_kernel.launches == before + 1
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], qmatmul_ref(x, w, xs, ws, out_dtype=out_dtype))


def test_moe_first_layer_products_fp32_on_the_card(cuda_device):
    """The bf16 expert products come back fp32 from the tensor cores
    (``bmm`` with ``out_dtype``): within fp32 summation of the fp32 product
    of the same bf16 operands, where a bf16 product is 2^-9 off."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    xe = torch.randn(4, 256, 1024, generator=g, device=cuda_device).bfloat16()
    w = torch.randn(4, 1024, 512, generator=g, device=cuda_device).bfloat16()
    got = tmoe._products_fp32(xe, w)
    want = torch.bmm(xe.double(), w.double())
    assert got.dtype == torch.float32
    scale = want.abs().max()
    assert ((got.double() - want).abs().max() / scale).item() < 1e-5
    assert ((torch.bmm(xe, w).double() - want).abs().max() / scale).item() > 1e-4


def test_facade_measured_serving_runs_every_server_on_the_card(cuda_device):
    """``Solution.serve(measure=True)`` on the card with the smoke pair (at
    head dim 64, which the flash kernel is built for; the smoke configs' 16
    is not): both prefills timed through the flash kernel at both batch
    sizes, and every server of the simulated run on its measured service
    law."""
    import dataclasses

    from repro_torch import scope
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hw import tpu_v5e

    cfgs = [dataclasses.replace(get_smoke_config(name), d_head=64)
            for name in ("granite-3-8b", "gemma2-9b")]
    sol = scope.solve(scope.problem(scope.WorkloadSpec.lm(cfgs, 64, [1, 2]),
                                    tpu_v5e(8, (1, 8))))
    flash_attention_kernel.launches = 0
    rep = sol.serve(n_requests=300, seed=0, measure=True, seq_len=64, device="cuda")
    # one warm-up and three timed prefills at each of two batch sizes
    assert flash_attention_kernel.launches == 8 * sum(c.n_layers for c in cfgs)
    names = {a.model for a in sol.multi.assignments}
    assert rep.meta["service_source"] == {name: "measured" for name in names}
    assert set(rep.meta["measured_s"]) == names
    assert rep.conserved
    base = sol.serve(n_requests=300, seed=0)
    assert (base.goodput, base.latency_p95_s) != (rep.goodput, rep.latency_p95_s)


# (B, H, KV, S, hd, causal, window, softcap, dtype): the backward at
# chip_smoke.py phase 15's shapes (granite-3-8b's prefill, gemma2-9b's local
# and global layers at an S its window bites, granite-20b's MQA 48 / 1), in
# both dtypes, then small edges (ragged S, non-causal, hd 64).
FA_BWD_CASES = [
    (4, 32, 8, 2048, 128, True, 0, 0.0, torch.bfloat16),
    (4, 32, 8, 2048, 128, True, 0, 0.0, torch.float32),
    (1, 16, 8, 8192, 256, True, 4096, 50.0, torch.bfloat16),
    (1, 16, 8, 8192, 256, True, 0, 50.0, torch.float32),
    (1, 48, 1, 2048, 128, True, 0, 0.0, torch.bfloat16),
    (1, 48, 1, 2048, 128, True, 0, 0.0, torch.float32),
    (2, 4, 2, 333, 64, True, 100, 30.0, torch.bfloat16),
    (1, 6, 3, 257, 256, False, 0, 0.0, torch.float32),
    (1, 4, 1, 1000, 128, False, 300, 50.0, torch.bfloat16),
]


def _bwd_inputs(dev, B, H, KV, S, hd, dtype, seed=3, cap=0.0):
    """q, k, v as the model passes them (transposed [B,S,n,hd] views), dO
    contiguous.  Under a softcap q is scaled by cap / 3, so that the cap's
    tanh saturates and its chain factor 1 - tanh^2 matters (with unit q it
    stays within 4e-4 of 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev) for n in (H, KV, KV))
    if cap > 0:
        q = q * (cap / 3)
    do = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    return (*(t.to(dtype).transpose(1, 2) for t in (q, k, v)), do)


# per-row bound over the rows whose rms reaches 1e-3 of the tensor's (a
# causal q row 0 sees one key, so its dq is 0 up to rounding); fp32: where
# one key holds nearly all of a row's softmax, dP - D cancels and the fp32
# plain version itself is ~2e-3 off an fp64 one; as chip_smoke.py phase 15
FA_BWD_ROW_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.1}


@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, case):
    """dq, dk, dv, on what a training forward keeps, against
    attention_bwd_ref, to the reference's flash bounds; each row's worst
    error held to FA_BWD_ROW_TOL of the row's rms as well."""
    B, H, KV, S, hd, causal, window, cap, dtype = case
    q, k, v, do = _bwd_inputs(cuda_device, B, H, KV, S, hd, dtype, cap=cap)
    saved = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap,
                                   with_lse=True)
    got = flash_attention_bwd_kernel(q, k, v, do, saved, causal=causal, window=window,
                                     softcap=cap)
    want = attention_bwd_ref(q, k, v, do, causal, window, cap)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for g_, w, t in zip(got, want, (q, k, v), strict=True):
        assert g_.dtype == t.dtype and g_.shape == t.shape and g_.stride() == t.stride()
        torch.testing.assert_close(g_.float(), w.float(), rtol=tol, atol=tol)
        row_err = (g_.float() - w.float()).abs().amax(-1)
        row_rms = w.float().pow(2).mean(-1).sqrt()
        rows = row_rms >= 1e-3 * w.float().pow(2).mean().sqrt()
        assert (row_err[rows] <= FA_BWD_ROW_TOL[dtype] * row_rms[rows]).all(), \
            (row_err[rows] / row_rms[rows]).max().item()
    del got, want


@pytest.mark.parametrize("hd, dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                       (256, torch.bfloat16), (128, torch.float32)])
def test_flash_attention_training_forward_keeps_lse_and_residual(cuda_device, hd, dtype):
    """``with_lse=True``: each row's base-2 log-sum-exp against the plain
    logits', and in bf16 o + o_res against the fp32 attention of the same
    inputs (to ~16 bits: the forward's P v adds P's residual product), o_res
    within half a unit in the last place of o; the serving call's output
    within the reference's bound."""
    B, H, KV, S, window, cap = 1, 4, 2, 333, 100, 30.0
    q, k, v, _ = _bwd_inputs(cuda_device, B, H, KV, S, hd, dtype, cap=cap)
    saved = flash_attention_kernel(q, k, v, window=window, softcap=cap, with_lse=True)
    torch.cuda.synchronize()
    assert saved.lse.shape == (B, H, 384)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float().repeat_interleave(H // KV, 1))
    s = cap * torch.tanh(s / math.sqrt(hd) / cap)
    pos = torch.arange(S, device=cuda_device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), -1) / math.log(2.0)
    torch.testing.assert_close(saved.lse[..., :S], lse, rtol=0, atol=1e-4)
    want = attention_ref(q.float(), k.float(), v.float(), True, window, cap)
    if dtype == torch.bfloat16:
        full = saved.o.float() + saved.o_res.float()
        torch.testing.assert_close(full, want, rtol=0, atol=1e-4)
        assert (saved.o_res.float().abs() <= saved.o.float().abs() * 2.0 ** -8).all()
    else:
        assert saved.o_res is None
        torch.testing.assert_close(saved.o, want, rtol=0, atol=1e-4)
    serving = flash_attention_kernel(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(serving.float(), want, rtol=2e-2, atol=2e-2)


def test_flash_attention_bwd_is_deterministic_and_counts_calls(cuda_device):
    q, k, v, do = _bwd_inputs(cuda_device, 2, 8, 2, 300, 128, torch.bfloat16)
    saved = flash_attention_kernel(q, k, v, with_lse=True)
    before = flash_attention_bwd_kernel.launches
    first = flash_attention_bwd_kernel(q, k, v, do, saved)
    second = flash_attention_bwd_kernel(q, k, v, do, saved)
    assert flash_attention_bwd_kernel.launches == before + 2
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


def test_flash_attention_autograd_goes_through_both_kernels(cuda_device):
    """ops.flash_attention on CUDA tensors that need a gradient: one forward
    and one backward launch, the gradients those of the kernels, and a dO of
    any strides (here an expanded one, from a sum)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v, _ = _bwd_inputs(cuda_device, 1, 8, 2, 256, 64, torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_attention_kernel.launches, flash_attention_bwd_kernel.launches
    out = flash_attention(*leaves, causal=True, window=64, softcap=30.0)
    got = torch.autograd.grad(out.float().sum(), leaves)
    assert flash_attention_kernel.launches == f0 + 1
    assert flash_attention_bwd_kernel.launches == b0 + 1
    want = attention_bwd_ref(q, k, v, torch.ones_like(q), True, 64, 30.0)
    for g_, w in zip(got, want, strict=True):
        torch.testing.assert_close(g_.float(), w.float(), rtol=2e-2, atol=2e-2)


def test_model_gradients_through_the_kernels_match_plain_attention(cuda_device):
    """granite-3-8b's smoke config at head dim 64, bf16: the loss and every
    leaf's gradient through the kernels against the same model with
    attention through the plain version (``plain_attention=True``): each
    leaf's relative norm difference within the bf16 bound, 2e-2; every
    attention projection gets a non-zero gradient."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), d_head=64,
                              param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device).train_params()
    flat = model.flat_params()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=g).to(cuda_device)
    labels = torch.randint(0, cfg.vocab, (2, 128), generator=g).to(cuda_device)
    b0 = flash_attention_bwd_kernel.launches
    loss_k = loss_fn(model, tokens, labels)
    grads_k = torch.autograd.grad(loss_k, flat)
    assert flash_attention_bwd_kernel.launches == b0 + cfg.n_layers
    loss_p = loss_fn(model, tokens, labels, plain_attention=True)
    grads_p = torch.autograd.grad(loss_p, flat)
    assert abs(loss_k.item() - loss_p.item()) <= 2e-2 * abs(loss_p.item())
    for gk, gp in zip(grads_k, grads_p, strict=True):
        assert ((gk.float() - gp.float()).norm() / gp.float().norm()).item() <= 2e-2
    nonzero = {id(p): gk.abs().max().item() > 0 for p, gk in zip(flat, grads_k)}
    assert all(nonzero[id(blk.attn[n])] for blk in model.blocks for n in ("wq", "wk", "wv"))


def test_jamba_model_trains_on_the_card(cuda_device):
    """jamba's smoke config at head dim 64 (the flash kernels' narrowest),
    bf16: two train steps through the selective-scan forward and backward
    kernels (remat runs the forward twice a layer) and the flash kernels,
    the loss and grad norm finite; then one more gradient, every per-layer
    gradient finite and non-zero (a bf16 weight need not move: dt_bias =
    -4.6 moves by less than half its ulp at lr 1e-3)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import check_gradients
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.train import build_train_step

    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"), d_head=64,
                              param_dtype="bfloat16")
    n_mamba = cfg.block_kinds().count("mamba")
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device).train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg, 300, 2, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(cfg, plan, base_lr=1e-3, warmup=1, device=cuda_device)
    g = torch.Generator().manual_seed(2)
    toks = [torch.randint(0, cfg.vocab, (2, 301), generator=g) for _ in range(3)]
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    f0, b0 = mamba_scan_kernel.launches, mamba_scan_bwd_kernel.launches
    for batch in batches[:2]:
        model, opt, m = step(model, opt, batch)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert mamba_scan_bwd_kernel.launches - b0 == 2 * n_mamba
    assert mamba_scan_kernel.launches - f0 == 2 * 2 * n_mamba
    assert check_gradients(model, batches[2], cuda_device) == len(model.flat_params())
    assert mamba_scan_bwd_kernel.launches - b0 == 3 * n_mamba


def test_rwkv_model_trains_on_the_card(cuda_device):
    """rwkv6-3b's smoke config at head dim 64 (the kernels' widest), bf16:
    two train steps through the WKV-6 forward and backward kernels (remat
    runs the forward twice a layer), every rwkv weight moved, the loss and
    grad norm finite."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.train import build_train_step

    cfg = dataclasses.replace(get_smoke_config("rwkv6-3b"), rwkv_head_dim=64,
                              param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device).train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg, 300, 2, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(cfg, plan, base_lr=1e-3, warmup=1, device=cuda_device)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if ".rwkv." in n}
    g = torch.Generator().manual_seed(2)
    f0, b0 = wkv6_kernel.launches, wkv6_bwd_kernel.launches
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab, (2, 301), generator=g)
        model, opt, m = step(model, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert wkv6_bwd_kernel.launches - b0 == 2 * cfg.n_layers
    assert wkv6_kernel.launches - f0 == 2 * 2 * cfg.n_layers
    after = dict(model.named_parameters())
    assert before and all(not torch.equal(before[n], after[n]) for n in before)


def test_moe_model_trains_on_the_card(cuda_device):
    """granite-moe-1b-a400m's smoke config at head dim 64, bf16: two train
    steps on the card through the MoE dispatch's backward (the expert
    products' fp32-output ``bmm`` has its own backward), every expert and
    router weight moved, the loss finite."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.train import build_train_step

    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"), d_head=64,
                              param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device).train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg, 32, 4, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(cfg, plan, base_lr=1e-3, warmup=1, device=cuda_device)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if ".moe." in n}
    g = torch.Generator().manual_seed(2)
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab, (4, 33), generator=g)
        model, opt, m = step(model, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    after = dict(model.named_parameters())
    assert before and all(not torch.equal(before[n], after[n]) for n in before)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b"])
def test_offset_positions_go_through_the_kernel(cuda_device, arch):
    """Explicit prefill positions ``p0_b + 0..S-1`` (a different p0 in each
    row) take the flash kernel, one launch, with RoPE on the given
    positions, and match the masked plain path (the CPU's route for explicit
    positions) on the same fp32 inputs within the kernel's fp32 bound, 2e-3;
    gemma2's window of 8 and its softcaps included.  Positions with a gap
    raise on the card (ROADMAP A19)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention

    cfg = dataclasses.replace(get_smoke_config(arch), d_head=64)
    d, hd = cfg.d_model, cfg.head_dim
    g = torch.Generator().manual_seed(3)
    params = {n: torch.randn(shape, generator=g) * shape[0] ** -0.5 for n, shape in (
        ("wq", (d, cfg.n_heads * hd)), ("wk", (d, cfg.n_kv_heads * hd)),
        ("wv", (d, cfg.n_kv_heads * hd)), ("wo", (cfg.n_heads * hd, d)))}
    S = 200
    x = torch.randn(2, S, d, generator=g)
    pos = torch.stack([5 + torch.arange(S), 300 + torch.arange(S)])
    want, (wk, _) = attention.attention_prefill(params, x, cfg, pos, cfg.window)
    gpu = {n: t.to(cuda_device) for n, t in params.items()}
    f0 = flash_attention_kernel.launches
    got, (gk, _) = attention.attention_prefill(gpu, x.to(cuda_device), cfg,
                                               pos.to(cuda_device), cfg.window)
    assert flash_attention_kernel.launches == f0 + 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(gk.cpu(), wk, rtol=2e-3, atol=2e-3)
    pos[1, 100:] += 1
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        attention.attention_prefill(gpu, x.to(cuda_device), cfg, pos.to(cuda_device),
                                    cfg.window)
