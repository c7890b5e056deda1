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
