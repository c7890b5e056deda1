"""The dry-run on the meta device (``repro_torch.launch.dryrun``) and the
kernel wrappers' meta route, here on the CPU: no card needed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_config as jget_config
from repro.models import init_kv_cache as jinit_kv_cache
from repro.models import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer

from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import cost as kcost
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.mamba import kernel as mk
from repro_torch.kernels.mamba.ref import mamba_scan_bwd_ref, mamba_scan_ref
from repro_torch.kernels.qmatmul import kernel as qk
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.kernels.rwkv6 import kernel as wk
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import HwConstants, roofline_terms
from repro_torch.models import attention as tatt
from repro_torch.models.model import init_params
from repro_torch.runtime.planner import plan_for_cell

META = torch.device("meta")


@pytest.fixture
def no_card(monkeypatch):
    """Fail on anything a launch would touch: building or loading a kernel
    library, the CUDA stream or device."""
    def refuse(*a, **k):
        raise AssertionError("a meta call reached the card's route")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.cuda, "device", refuse)
    for fn in (fa.flash_attention_kernel, fa.flash_attention_bwd_kernel, wk.wkv6_kernel,
               wk.wkv6_bwd_kernel, mk.mamba_scan_kernel, mk.mamba_scan_bwd_kernel,
               qk.qmatmul_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    yield
    assert _build.load_library.cache_info().currsize == 0


def _meta(*ts):
    return [t.to(META) for t in ts]


def _same_layout(got, want):
    got, want = list(tree.leaves(got)), list(tree.leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        if w is None:
            assert g is None
            continue
        assert g.device == META and g.shape == w.shape and g.dtype == w.dtype


def _rand(*shape, dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_meta_route(no_card, dtype):
    """Forward (serving and training) and backward on meta: what the plain
    version returns, in shape and dtype; the tally has each call's cost."""
    B, H, KV, S, hd = 1, 4, 2, 40, 64
    q, k, v, do = (_rand(B, n, S, hd, dtype=dtype, seed=i)
                   for i, n in enumerate((H, KV, KV, H)))
    with kcost.tally() as calls:
        o = fa.flash_attention_kernel(*_meta(q, k, v), window=16)
        saved = fa.flash_attention_kernel(*_meta(q, k, v), window=16, with_lse=True)
        grads = fa.flash_attention_bwd_kernel(*_meta(q, k, v, do), saved, window=16)
    _same_layout(o, attention_ref(q, k, v, True, 16, 0.0))
    assert saved.lse.shape == (B, H, fa.lse_rows(S)) and saved.lse.dtype == torch.float32
    assert (saved.o_res is None) == (dtype == torch.float32)
    _same_layout(grads, attention_bwd_ref(q, k, v, do, True, 16, 0.0))
    assert [n for n, _ in calls] == ["flash_attention_kernel"] * 2 + ["flash_attention_bwd_kernel"]
    assert calls[0][1] == fa.flash_attention_cost(q, k, v, True, 16)
    assert fa.flash_attention_kernel.launches == fa.flash_attention_bwd_kernel.launches == 0


def test_flash_meta_route_allocates_the_split_scratch(no_card):
    """MQA with few key tiles splits each group: the meta call allocates
    the kernel's fp32 partial sums, sized by the copy of the C rule, beside
    dq, dk, dv and the fp32 statistics."""
    B, H, KV, S, hd = 1, 48, 1, 256, 128
    q, do = (torch.empty(B, H, S, hd, dtype=torch.bfloat16, device=META) for _ in range(2))
    k, v = (torch.empty(B, KV, S, hd, dtype=torch.bfloat16, device=META) for _ in range(2))
    split = fa.kv_split(torch.bfloat16, hd, B, H, KV, S)
    assert split == 48             # 2 key tiles: ceil(132 / 2) chunks, capped at 48 heads
    saved = fa.flash_attention_kernel(q, k, v, with_lse=True)
    with dryrun.StorageTracker() as t:
        fa.flash_attention_bwd_kernel(q, k, v, do, saved)
    sizes = (2 * q.numel(), 2 * k.numel(), 2 * v.numel(),      # dq, dk, dv
             2 * B * H * fa.lse_rows(S) * 4,                   # the statistics
             2 * split * B * KV * S * hd * 4)                  # the partial sums
    assert t.peak == sum(t.rounded(n) for n in sizes)


def test_kv_split_rule():
    """The copy of ``kv_split``: one chunk unless bf16 at hd 64 / 128 leaves
    SMs idle, then enough chunks to cover them, at most the group's heads."""
    assert fa.kv_split(torch.float32, 128, 1, 48, 1, 256) == 1
    assert fa.kv_split(torch.bfloat16, 256, 1, 48, 1, 256) == 1
    assert fa.kv_split(torch.bfloat16, 128, 4, 32, 8, 2048) == 1      # 512 tiles
    assert fa.kv_split(torch.bfloat16, 128, 1, 48, 1, 2048) == 9      # 16 tiles: ceil(132 / 16)
    assert fa.kv_split(torch.bfloat16, 64, 1, 4, 1, 128) == 4         # capped by H / KV


def test_wkv6_meta_route(no_card):
    B, H, S, hd = 1, 2, 300, 16
    r, k, v, logw = (_rand(B, H, S, hd, seed=i) for i in range(4))
    logw = -torch.exp(logw)
    u, dout = _rand(H, hd, seed=5), _rand(B, H, S, hd, seed=6)
    with kcost.tally() as calls:
        out = wk.wkv6_kernel(*_meta(r, k, v, logw, u))
        fwd = wk.wkv6_kernel(*_meta(r, k, v, logw, u), with_states=True)
        grads = wk.wkv6_bwd_kernel(*_meta(r, k, v, logw, u), fwd[2], dout.to(META))
    _same_layout(out, wkv6_ref(r, k, v, logw, u))
    assert fwd[2].shape == (B, H, 1, hd, hd)
    _same_layout(grads, wkv6_bwd_ref(r, k, v, logw, u, dout))
    assert [n for n, _ in calls] == ["wkv6_kernel"] * 2 + ["wkv6_bwd_kernel"]
    assert wk.wkv6_kernel.launches == wk.wkv6_bwd_kernel.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mamba_meta_route(no_card, dtype):
    B, S, di, N = 1, 70, 130, 16
    dt = torch.nn.functional.softplus(_rand(B, S, di, seed=0))
    x = _rand(B, S, di, dtype=dtype, seed=1)
    A = -torch.exp(_rand(di, N, seed=2))
    Bc, Cc = _rand(B, S, N, dtype=dtype, seed=3), _rand(B, S, N, dtype=dtype, seed=4)
    D, dy = _rand(di, seed=5), _rand(B, S, di, seed=6)
    args = (dt, x, A, Bc, Cc, D)
    with kcost.tally() as calls:
        out = mk.mamba_scan_kernel(*_meta(*args))
        fwd = mk.mamba_scan_kernel(*_meta(*args), with_states=True)
        grads = mk.mamba_scan_bwd_kernel(*_meta(*args), fwd[2], dy.to(META))
    _same_layout(out, mamba_scan_ref(*args))
    assert fwd[2].shape == (B, di, mk.n_state_slots(S), N)
    want = mamba_scan_bwd_ref(*args, dy)
    assert [g.shape for g in grads] == [w.shape for w in want]
    assert [g.dtype for g in grads] == [torch.float32, dtype, torch.float32, dtype, dtype,
                                        torch.float32]
    assert [n for n, _ in calls] == ["mamba_scan_kernel"] * 2 + ["mamba_scan_bwd_kernel"]
    assert mk.mamba_scan_kernel.launches == mk.mamba_scan_bwd_kernel.launches == 0


@pytest.mark.parametrize("K", [256, 100], ids=["tma-path", "byte-path"])
def test_qmatmul_meta_route(no_card, K):
    M, N = 64, 96
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=g)
    xs, ws = torch.rand(M, generator=g), torch.rand(N, generator=g)
    args = _meta(x, w, xs, ws)
    with dryrun.StorageTracker() as t, kcost.tally() as calls:
        out = qk.qmatmul_kernel(*args)
    _same_layout(out, qmatmul_ref(x, w, xs, ws))
    wt = N * K if K % 16 == 0 else 0          # the transposed w of the wgmma path
    assert t.peak == t.rounded(4 * M * N) + t.rounded(wt)
    assert calls == [("qmatmul_kernel", qk.qmatmul_cost(x, w))]
    assert qk.qmatmul_kernel.launches == 0


def test_cuda_tensors_still_take_the_kernel_only():
    """A CPU tensor the kernel wrapper is handed directly is refused (the
    plain version is only ever the ops' CPU route), as before."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_kernel(q, q, q)


def test_meta_positions_raise():
    with pytest.raises(NotImplementedError, match="meta device"):
        tatt.runs_from_offsets(torch.empty(2, 8, dtype=torch.int64, device=META))


def test_visible_pairs_closed_form():
    def loop(Sq, Skv, causal, window):
        total = 0
        for q in range(Sq):
            hi = min(q, Skv - 1) if causal else Skv - 1
            lo = max(q - window + 1, 0) if window > 0 else 0
            total += max(hi - lo + 1, 0)
        return total
    for case in [(64, 64, True, 0), (64, 64, True, 16), (50, 80, True, 7), (64, 64, False, 0),
                 (64, 48, False, 20), (1, 1, True, 0)]:
        assert kcost.visible_pairs(*case) == loop(*case), case


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_init_has_the_real_leaves(arch):
    """Names, shapes and dtypes of the meta model's leaves equal the real
    init's at smoke size; a meta init takes no generator and any other one."""
    cfg = get_smoke_config(arch)
    real = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = init_params(cfg, None, "meta")
    got = [(n, p.shape, p.dtype, p.device.type) for n, p in meta.named_parameters()]
    assert got == [(n, p.shape, p.dtype, "meta") for n, p in real.named_parameters()]
    with pytest.raises(ValueError, match="generator"):
        init_params(cfg, None, "cpu")
    with pytest.raises(ValueError, match="generator"):
        init_params(cfg, torch.Generator(), "meta")


def test_storage_tracker_counts_storages_not_views():
    with dryrun.StorageTracker() as t:
        a = torch.empty(1000, dtype=torch.uint8, device=META)    # 512-byte blocks: 1024
        b = a.view(10, 100)                                       # a view: nothing new
        c = torch.empty(0, device=META)                           # empty: 0
        assert t.live == 1024
        del a, b
        assert t.live == 0
        d = (torch.empty(3, device=META) + 1).sum()               # two 512-byte blocks
    assert t.peak == 1024 and t.live == 512 and c.numel() == 0 and d.shape == ()


def _hand_prefill_flops(cfg, B, S) -> int:
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_token = 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d + 3 * 2 * d * ff
    attn = 4 * B * H * hd * kcost.visible_pairs(S, S, True, cfg.window)
    return cfg.n_layers * (per_token * B * S + attn) + 2 * d * cfg.padded_vocab * B * S


def test_prefill_flops_within_1pc_of_a_count_by_hand():
    """granite-3-8b at full size, B=4 x S=2048: every product's 2 x d_in x
    d_out x rows plus the flash kernel's count."""
    cfg = get_config("granite-3-8b")
    B, S = 4, 2048
    plan = plan_for_cell(cfg, S, B, dryrun.MESH_AXES, 1, kind="prefill", use_dse=False)
    res = dryrun.trace_step(cfg, S, B, "prefill", plan)
    want = _hand_prefill_flops(cfg, B, S)
    assert abs(res["cost_analysis"]["flops"] / want - 1) < 0.01
    assert res["kernel_calls"] == {"flash_attention_kernel": cfg.n_layers}


def test_training_cell_kernel_calls():
    """granite-3-8b at full width cut to 16 layers, B=4 x S=2048, AdamW:
    remat runs each layer's forward twice, the backward once."""
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=16)
    plan = plan_for_cell(cfg, 2048, 4, dryrun.MESH_AXES, 1, kind="train", use_dse=False)
    res = dryrun.trace_step(cfg, 2048, 4, "train", plan)
    assert res["kernel_calls"] == {"flash_attention_kernel": 32, "flash_attention_bwd_kernel": 16}
    mem = res["memory_analysis"]
    params = list(init_params(cfg, None, "meta").parameters())
    weights = sum(p.numel() * p.element_size() for p in params)     # bf16, norms fp32
    moments = 8 * sum(p.numel() for p in params)                     # AdamW's m, v in fp32
    batch = 2 * 4 * 2048 * 4                                         # int32 tokens, labels
    assert mem["argument_size_bytes"] == weights + moments + 4 + batch   # + the step count
    assert mem["peak_bytes"] > mem["argument_size_bytes"]
    assert mem["fits"] == (mem["peak_bytes"] * (1 + mem["reserved_margin"])
                           <= mem["card_usable_memory"]) is True


def test_roofline_takes_each_kernel_at_its_own_units_peak():
    """rwkv6-3b at full width cut to 2 layers, B=4 x S=2048, training: the
    WKV-6 kernels run in fp32, so the compute term holds their operations
    at the fp32 peak and the aten products at the bf16 one."""
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=2)
    plan = plan_for_cell(cfg, 2048, 4, dryrun.MESH_AXES, 1, kind="train", use_dse=False)
    res = dryrun.trace_step(cfg, 2048, 4, "train", plan)
    hw, kernels = HwConstants(), res["kernels"]
    assert sorted(kernels) == ["wkv6_bwd_kernel", "wkv6_kernel"]
    for k in kernels.values():
        assert k["compute_s"] == pytest.approx(k["flops"] / hw.fp32_flops, rel=1e-12)
    want = (res["cost_analysis"]["aten_flops"] / hw.peak_flops
            + sum(k["flops"] for k in kernels.values()) / hw.fp32_flops)
    assert res["roofline"]["compute_s"] == pytest.approx(want, rel=1e-12)
    assert res["roofline"]["compute_s"] > res["cost_analysis"]["flops"] / hw.peak_flops


def test_roofline_terms_equal_the_reference():
    from repro.launch import hlo_analysis as ref
    hw = HwConstants(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    for args in [(1e15, 1e12, 0.0, 1), (1e12, 1e13, 5e9, 16), (1e9, 1e6, 1e12, 256)]:
        assert roofline_terms(*args, hw) == ref.roofline_terms(*args, ref.HwConstants())


def test_multi_pod_raises_naming_a13():
    with pytest.raises(NotImplementedError, match="A13"):
        dryrun.main(["--all", "--multi-pod"])
    with pytest.raises(NotImplementedError, match="A13"):
        dryrun.run_cell("granite-3-8b", "train_4k", multi_pod=True)


ARG_CELLS = [("granite-3-8b", "train_4k"), ("llama4-maverick-400b-a17b", "prefill_32k"),
             ("jamba-v0.1-52b", "long_500k"), ("rwkv6-3b", "decode_32k")]
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4}


def _ref_trees(arch, shape) -> dict:
    """The reference's abstract trees of a cell, as (path, shape, dtype) per
    leaf: ``jax.eval_shape`` of its ``init_params``, its optimizer's init and
    ``init_kv_cache``, and the int32 tokens / labels (one token and its
    position for decode) that its ``input_specs`` gives; ``repro.launch.dryrun``
    itself is not imported (it sets ``XLA_FLAGS`` to 512 host devices)."""
    cfg = jget_config(arch)
    S, B, kind = SHAPES[shape]
    params = jax.eval_shape(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)     # noqa: E731
    if kind == "decode":
        inputs = {"token": i32(B, 1), "position": i32(B),
                  "caches": jax.eval_shape(lambda: jinit_kv_cache(cfg, B, S, jnp.bfloat16))}
    else:
        inputs = {"tokens": i32(B, S)}
        if kind == "train":
            inputs["labels"] = i32(B, S)
    trees = {"params": params, "inputs": inputs}
    if kind == "train":
        trees["opt"] = jax.eval_shape(jmake_optimizer(cfg.optimizer)[0], params)
    return {name: [["/".join(str(k) for k in path), list(leaf.shape), str(leaf.dtype)]
                   for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]]
            for name, t in trees.items()}


def _leaves(t):
    return [[path, list(leaf.shape), str(leaf.dtype).removeprefix("torch.")]
            for path, leaf in tree.flatten_with_path(t)]


@pytest.mark.parametrize("arch,shape", ARG_CELLS, ids=[f"{a}-{s}" for a, s in ARG_CELLS])
def test_argument_bytes_equal_the_reference_trees(arch, shape):
    """At full size the dry-run's parameters, optimizer state and inputs or
    caches are the reference's abstract trees leaf for leaf (path, shape,
    dtype), and the bytes it reports for them are theirs.  No leaf differs,
    so none is exempt."""
    S, B, kind = SHAPES[shape]
    model, opt, inputs = dryrun.cell_arguments(get_config(arch), S, B, kind)
    want = _ref_trees(arch, shape)
    got = {"params": _leaves(model.param_tree()), "inputs": _leaves(inputs)}
    if opt is not None:
        got["opt"] = _leaves(opt)
    assert got == want
    ref_bytes = sum(int(np.prod(s)) * ITEMSIZE[dt] for leaves in want.values()
                    for _, s, dt in leaves)
    assert kcost.nbytes(*dryrun.argument_tensors(model, opt, inputs)) == ref_bytes
