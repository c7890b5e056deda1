"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a); every test here is
marked ``cuda`` and skips without one.  This file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba.kernel import mamba_scan_kernel
from repro_torch.kernels.mamba.ref import mamba_scan_ref
from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel, tma_path
from repro_torch.kernels.qmatmul.ops import qmatmul
from repro_torch.kernels.qmatmul.ref import qmatmul_ref, quantize_cols, quantize_rows
from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
from repro_torch.kernels.rwkv6.ref import wkv6_ref
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
    32-token sums overflow exp in fp32."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=device) for _ in range(3))
    draw = torch.rand(B, H, S, hd, generator=g, device=device)
    if strong:
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
