"""The port's int8 matrix product and quantizers on the CPU against the JAX
reference.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs its Pallas kernel in interpret mode and its oracle
``qmatmul_ref``; the port runs ``qmatmul`` (its plain version on the CPU).
The int32 sum is exact and the dequantization rounds in the same order, so
every comparison is array-equal, and the quantizers are bit-exact for fp32
and bf16 inputs.  The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.qmatmul.kernel import qmatmul_kernel as jax_qmatmul_kernel
from repro.kernels.qmatmul.ops import qmatmul as jax_qmatmul
from repro.kernels.qmatmul.ref import qmatmul_ref as jax_qmatmul_ref
from repro.kernels.qmatmul.ref import quantize_cols as jax_quantize_cols
from repro.kernels.qmatmul.ref import quantize_rows as jax_quantize_rows
from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel, tma_path
from repro_torch.kernels.qmatmul.ops import qmatmul
from repro_torch.kernels.qmatmul.ref import qmatmul_ref, quantize_cols, quantize_rows

# (M, N, K): tests/test_kernels.py test_qmatmul_exact_int_arithmetic
QMM_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 256, 256)]


def _int8_inputs(M, N, K, seed=0, lo=-127, hi=128):
    """int8 x [M,K], w [K,N] uniform in [lo, hi); scales uniform in (0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, (M, K), dtype=np.int8)
    w = rng.integers(lo, hi, (K, N), dtype=np.int8)
    xs = (0.5 + rng.random(M)).astype(np.float32)
    ws = (0.5 + rng.random(N)).astype(np.float32)
    return x, w, xs, ws


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _jax_np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _torch_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("mnk", QMM_SHAPES)
def test_qmatmul_exact_int_arithmetic(mnk):
    """Random int8 operands and random scales: the port's op, JAX's
    interpret-mode kernel and JAX's oracle are array-equal."""
    M, N, K = mnk
    (jx, jw, jxs, jws), (tx, tw, txs, tws) = _both(_int8_inputs(M, N, K))
    out = qmatmul(tx, tw, txs, tws).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_qmatmul(jx, jw, jxs, jws, interpret=True)))
    np.testing.assert_array_equal(out, np.asarray(jax_qmatmul_ref(jx, jw, jxs, jws)))
    np.testing.assert_array_equal(qmatmul(tx, tw, txs, tws, impl="ref").numpy(), out)


def _float_input(shape, dtype, seed):
    """Normal values at mixed scales, with an all-zero row and a row under
    the 1e-8 floor; as fp32 numpy plus the JAX and torch arrays in dtype."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, (shape[0], 1)))
    a[1] = 0.0
    a[2] *= 1e-12
    a = a.astype(np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.bfloat16()
    return a, j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["rows", "cols"])
def test_quantizers_bit_exact(dtype, which):
    """quantize_rows / quantize_cols give JAX's int8 values and fp32 scales
    bit for bit (the zero row and the row under the floor included)."""
    shape = (48, 80) if which == "rows" else (80, 48)
    _, j, t = _float_input(shape if which == "rows" else shape[::-1], dtype, seed=3)
    if which == "cols":
        j, t = j.T, t.t()
    jq, js = (jax_quantize_rows if which == "rows" else jax_quantize_cols)(j)
    tq, ts = (quantize_rows if which == "rows" else quantize_cols)(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.is_contiguous() and tuple(tq.shape) == tuple(jq.shape)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_qmatmul_quantized_close_to_fp():
    """tests/test_kernels.py's end-to-end case: quantize fp32 operands, the
    int8 product is within 0.02 of the fp32 product, and the port's result
    is JAX's, array-equal."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((128, 256)).astype(np.float32)
    w = (0.1 * rng.standard_normal((256, 128))).astype(np.float32)
    jxq, jxs = jax_quantize_rows(jnp.asarray(x))
    jwq, jws = jax_quantize_cols(jnp.asarray(w))
    txq, txs = quantize_rows(torch.from_numpy(x))
    twq, tws = quantize_cols(torch.from_numpy(w))
    out = qmatmul(txq, twq, txs, tws).numpy()
    ref = x @ w
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 0.02
    np.testing.assert_array_equal(out, np.asarray(jax_qmatmul(jxq, jwq, jxs, jws,
                                                              interpret=True)))


@given(m=st.sampled_from([128, 256]), k_steps=st.integers(min_value=1, max_value=3))
@settings(max_examples=4, deadline=None)
def test_qmatmul_k_accumulation_property(m, k_steps):
    """tests/test_kernels.py's property: accumulating over K blocks equals
    the oracle, in both packages."""
    K = 128 * k_steps
    (jx, jw, jxs, jws), (tx, tw, txs, tws) = _both(_int8_inputs(m, 128, K, seed=k_steps,
                                                                lo=-5, hi=6))
    out = qmatmul(tx, tw, txs, tws, block_k=128).numpy()
    np.testing.assert_array_equal(out, qmatmul_ref(tx, tw, txs, tws).numpy())
    np.testing.assert_array_equal(
        out, np.asarray(jax_qmatmul(jx, jw, jxs, jws, block_k=128, interpret=True)))


@pytest.mark.parametrize("mnk,blocks", [
    ((100, 40, 96), (128, 128, 128)),        # every dim below its block
    ((256, 48, 96), (128, 16, 32)),          # multiples of smaller blocks
    ((1, 8, 32), (128, 128, 128)),
])
def test_qmatmul_shapes_the_reference_takes(mnk, blocks):
    """Shapes the reference takes through min(block, dim): array-equal to
    its interpret-mode kernel."""
    M, N, K = mnk
    bm, bn, bk = blocks
    (jx, jw, jxs, jws), (tx, tw, txs, tws) = _both(_int8_inputs(M, N, K, seed=5))
    out = qmatmul(tx, tw, txs, tws, block_m=bm, block_n=bn, block_k=bk).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_qmatmul(
        jx, jw, jxs, jws, block_m=bm, block_n=bn, block_k=bk, interpret=True)))


@pytest.mark.parametrize("mnk", [(200, 128, 128), (128, 200, 128), (128, 128, 200)])
def test_qmatmul_refuses_what_the_reference_refuses(mnk):
    """M, N or K = 200 is not a multiple of min(128, 200): the reference
    asserts, the port's op raises."""
    M, N, K = mnk
    (jx, jw, jxs, jws), (tx, tw, txs, tws) = _both(_int8_inputs(M, N, K, seed=6))
    with pytest.raises(AssertionError):
        jax_qmatmul(jx, jw, jxs, jws, interpret=True)
    with pytest.raises(ValueError, match="multiple of"):
        qmatmul(tx, tw, txs, tws)


def test_qmatmul_bf16_output():
    """out_dtype bf16: the plain version against JAX's interpret-mode kernel
    with out_dtype=bfloat16, array-equal (one rounding of the same fp32)."""
    (jx, jw, jxs, jws), (tx, tw, txs, tws) = _both(_int8_inputs(128, 256, 256, seed=7))
    out = qmatmul_ref(tx, tw, txs, tws, out_dtype=torch.bfloat16)
    jout = jax_qmatmul_kernel(jx, jw, jxs, jws, out_dtype=jnp.bfloat16, interpret=True)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_torch_np(out), _jax_np(jout))


def test_qmatmul_cpu_tensors_take_the_plain_version():
    """On the CPU the op computes the plain version and launches nothing."""
    before = qmatmul_kernel.launches
    _, (tx, tw, txs, tws) = _both(_int8_inputs(64, 32, 96, seed=8))
    np.testing.assert_array_equal(qmatmul(tx, tw, txs, tws).numpy(),
                                  qmatmul_ref(tx, tw, txs, tws).numpy())
    assert qmatmul_kernel.launches == before


def _wrapper_cases():
    x = torch.zeros(64, 96, dtype=torch.int8)
    w = torch.zeros(96, 32, dtype=torch.int8)
    xs, ws = torch.ones(64), torch.ones(32)
    cases = [
        ("dtype", (x.float(), w, xs, ws), {}, "int8"),
        ("dtype", (x, w.to(torch.uint8), xs, ws), {}, "int8"),
        ("dtype", (x, w, xs.double(), ws), {}, "float32"),
        ("dtype", (x, w, xs, ws.bfloat16()), {}, "float32"),
        ("out_dtype", (x, w, xs, ws), {"out_dtype": torch.float16}, "out_dtype"),
        ("shape", (x, w[:64], xs, ws), {}, "expected x"),
        ("shape", (x[0], w, xs, ws), {}, "expected x"),
        ("shape", (x, w, xs[:63], ws), {}, "x_scale"),
        ("shape", (x, w, xs, torch.ones(33)), {}, "w_scale"),
        ("shape", (x[:, :0], w[:0], xs, ws), {}, "empty"),
        ("contiguous", (x, torch.zeros(32, 96, dtype=torch.int8).t(), xs, ws), {}, "contiguous"),
        ("contiguous", (x, w, torch.ones(128)[::2], ws), {}, "contiguous"),
        ("device", (x, w, xs, ws), {}, "CUDA device"),
        ("blocks", (x, w, xs, ws), {"block_k": 0}, "block_k"),
    ]
    return [pytest.param(args, kwargs, match, id=f"{what}{i}")
            for i, (what, args, kwargs, match) in enumerate(cases)]


@pytest.mark.parametrize("args,kwargs,match", _wrapper_cases())
def test_qmatmul_kernel_wrapper_raises(args, kwargs, match):
    """The wrapper refuses, before any launch, every input the kernel does
    not take: wrong dtypes, shapes, non-contiguous operands, tensors not on
    one CUDA device."""
    before = qmatmul_kernel.launches
    with pytest.raises(ValueError, match=match):
        qmatmul_kernel(*args, **kwargs)
    assert qmatmul_kernel.launches == before


def test_qmatmul_op_raises_on_unknown_impl():
    _, (tx, tw, txs, tws) = _both(_int8_inputs(16, 16, 16))
    with pytest.raises(ValueError, match="impl"):
        qmatmul(tx, tw, txs, tws, impl="pallas")


@pytest.mark.parametrize("K,offset,expected", [
    (4096, 0, True),      # main path: granite-3-8b FFN up-projection, 8192 x 12800 x 4096
    (4112, 0, True),      # ragged tiles: 8193 x 12808 x 4112
    (4096, 512, True),    # one row, bf16 out: 1 x 4096 x 4096, x at another 16-byte bound
    (512, 0, True),       # fewer tiles than SMs: 256 x 256 x 512
    (272, 16, True),      # 200 x 300 x 272
    (100, 0, False),      # ragged_small: 1 x 40 x 100
    (4100, 0, False),     # ragged_large: 8193 x 12801 x 4100
    (4104, 0, False),     # K a multiple of 8, not of 16
    (4096, 1, False),     # x one byte past a 16-byte bound
    (4096, 8, False),
])
def test_qmatmul_path_predicate(K, offset, expected):
    """The wgmma / TMA kernel takes a call exactly when TMA can describe x
    and the transposed w (K % 16 == 0, x 16-byte aligned); the byte-staged
    mma.sync kernel takes the rest.  Only K and x's address decide."""
    assert tma_path(K, 0x7f0000000000 + offset) is expected


def test_qmatmul_ablation_edits_match_the_kernel_source():
    """Every edit of ``scripts/qmatmul_ablations.json`` (the variants that
    ``scripts/kernel_variants.py`` builds and times on the card) matches
    ``csrc/qmatmul.cu`` exactly once, so the ablations stay those of the
    kernel as it is."""
    import json
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = json.loads((repo / "scripts" / "qmatmul_ablations.json").read_text())
    assert {item["source"] for item in spec} == {"qmatmul.cu"}
    text = (repo / "src" / "repro_torch" / "csrc" / "qmatmul.cu").read_text()
    for item in spec:
        for old, new in item.get("edits", []):
            assert text.count(old) == 1, (item["name"], old[:60])
            assert old != new
