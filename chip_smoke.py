#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one card, nvcc

Builds the CUDA kernels from the checkout's sources, holds each against its
plain PyTorch version on the card, then drives the serving path:

1. environment: versions, ``nvidia-smi`` name and power limit, kernel build;
2. flash-attention kernel vs its plain version at every shape the later
   phases give it (reference bounds: 2e-3 fp32, 2e-2 bf16, plus a per-row
   bound relative to the row's size) with kernel / plain / library (SDPA) /
   bound times;
3. granite-3-8b at full width and depth, bf16, seeded init: prefill step at
   B=4 x S=2048 (exactly one kernel launch per layer), then the launcher's
   flow (batch 4, prompt 64, 32 greedy tokens), and one decode step counted
   (operations dispatched) and traced (device busy time);
4. prefill vs token-by-token decode logits, granite-3-8b full width cut to 4
   layers, fp32 with TF32 off: the kernel against the model's independent
   decode attention;
5. gemma2-9b full width cut to 2 layers (one local, one global): prefill at
   S=8192 so the 4096 window bites, then 8 decode steps;
6. WKV-6 kernel vs its plain version at every shape the later phases give it
   (the reference's bound 2e-4, plus a per-row bound relative to the row's
   size), with kernel / plain / bound times; no single PyTorch call computes
   WKV-6, so it has no library time;
7. rwkv6-3b at full width and depth, bf16, seeded init: prefill step at
   B=4 x S=2048 (exactly one kernel launch per layer), prefill with the state
   collected then 8 decode steps from it, the launcher's flow (batch 4,
   prompt 64, 32 greedy tokens), and one decode step counted and traced;
8. prefill vs token-by-token decode, rwkv6-3b full width cut to 4 layers,
   fp32 with TF32 off: logits and the final S / shift / shift_ffn state, the
   kernel against the model's plain one-step scan;
9. selective-scan (mamba) kernel vs its plain version at every shape the
   later phases give it (the reference's bound 2e-4, plus a per-row bound
   relative to the row's size), with kernel / plain / bound times; no single
   PyTorch call computes the selective scan, so it has no library time;
10. jamba-v0.1-52b at full width cut to 16 layers (two periods of 7 mamba +
    1 attention layer, MoE on every second layer), bf16, seeded init:
    prefill step at B=4 x S=2048 (exactly 14 selective-scan and 2 flash
    launches; a second call's logits bit-identical to the first's), prefill
    with the state collected then 8 decode steps from it,
    the launcher's flow (batch 4, prompt 64, 32 greedy tokens), and one
    decode step counted and traced;
11. prefill vs token-by-token decode, jamba full width cut to 8 layers, fp32
    with TF32 off, B=2 x S=100 (no MoE drops at this size): logits and the
    final k / v / h / conv state, the kernel against the model's plain
    one-step update;
12. granite-moe-1b-a400m at full width and depth, bf16, seeded init: prefill
    step at B=4 x S=2048 (exactly one flash launch per layer; a second
    call's logits bit-identical to the first's), the launcher's
    flow and one decode step traced, then ``python -m
    repro_torch.launch.serve --arch granite-moe-1b-a400m`` as a process.

Any failed check raises and the script exits non-zero without a result.  The
last line is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the line before that a JSON object listing
every ported kernel with its launches on its own main path (flash attention:
the phase-3 granite-3-8b prefill; WKV-6: the phase-7 rwkv6-3b prefill;
selective scan: the phase-10 jamba prefill) and its times.  Imports nothing
of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
FP32_PEAK_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3

# (name, B, H, KV, S, hd, causal, window, softcap, dtype)
FA_CASES = [
    ("fa_case0", 2, 4, 2, 256, 64, True, 0, 0.0, "float32"),
    ("fa_case1", 1, 4, 1, 256, 128, True, 0, 50.0, "float32"),
    ("fa_case2", 2, 2, 2, 384, 64, True, 128, 0.0, "float32"),
    ("fa_case3", 1, 8, 4, 512, 64, False, 0, 0.0, "float32"),
    ("fa_case4", 1, 2, 2, 256, 64, True, 0, 0.0, "bfloat16"),
    ("fa_case5", 1, 16, 2, 128, 128, True, 64, 30.0, "float32"),
    ("ragged_s1000", 1, 8, 2, 1000, 128, True, 0, 0.0, "bfloat16"),
    ("granite_prefill", 4, 32, 8, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("phase4_fp32", 2, 32, 8, 100, 128, True, 0, 0.0, "float32"),
    ("gemma2_local", 1, 16, 8, 8192, 256, True, 4096, 50.0, "bfloat16"),
    ("gemma2_global", 1, 16, 8, 8192, 256, True, 0, 50.0, "bfloat16"),
    ("granite_moe_prefill", 4, 16, 8, 2048, 64, True, 0, 0.0, "bfloat16"),
]
# Per-row bound on max|kernel - plain| / rms(plain row).  The absolute 2e-2
# is about half a typical output in rows that see thousands of keys (their
# outputs are ~1/sqrt(keys)); rounding alone leaves ~1e-2 here, while a
# dropped or doubled 32-key tile in such a row leaves ~0.3.
ROW_REL_TOL = 0.1
MAIN_PATH_CASE = "granite_prefill"

# (name, B, H, S, hd): tests/test_kernels.py WKV_CASES, the rwkv6-3b prefill
# shape (phase 7) and the ragged phase-8 shape.
WKV_CASES = [
    ("wkv_case0", 2, 2, 64, 16),
    ("wkv_case1", 1, 4, 128, 64),
    ("wkv_case2", 2, 1, 96, 32),
    ("wkv_case3", 1, 2, 256, 64),
    ("rwkv_prefill", 4, 40, 2048, 64),
    ("phase8_ragged", 2, 40, 100, 64),
]
WKV_TOL = 2e-4             # the reference's bound (tests/test_kernels.py)
# Per-row bound on max|kernel - plain| / rms(plain row): fp32 rounding in
# another summation order leaves up to ~4e-4 of a row's size in rows whose
# sums cancel (the fp32 plain version is as far from a float64 run), ~1e-6
# elsewhere; a dropped or doubled chunk, or a wrong decay, moves a row by O(1).
WKV_ROW_REL_TOL = 1e-3
WKV_CHUNK = 32             # the reference's chunk, for the operation count
WKV_MAIN_PATH_CASE = "rwkv_prefill"
# (name, B, S, di, N, dtype, model layout): tests/test_kernels.py MAMBA_CASES,
# the jamba prefill shape (phase 10) and the phase-11 shape.  In the model
# layout x is as given and B / C are column slices of one [B, S, R + 2N]
# tensor (R = 256, jamba's dt rank), as the model passes them.
MAMBA_CASES = [
    ("mamba_case0", 2, 64, 128, 8, "float32", False),
    ("mamba_case1", 1, 128, 256, 16, "float32", False),
    ("mamba_case2", 1, 96, 64, 4, "float32", False),
    ("jamba_prefill", 4, 2048, 8192, 16, "bfloat16", True),
    ("phase11_fp32", 2, 100, 8192, 16, "float32", True),
]
MAMBA_TOL = 2e-4           # the reference's bound (tests/test_kernels.py)
# Per-row bound on max|kernel - plain| / rms(plain row): the two differ only
# in fp32 rounding (expf, fused multiply-adds, the order of the N-term sum);
# a dropped, repeated or misplaced token moves a row by O(1).
MAMBA_ROW_REL_TOL = 1e-3
MAMBA_MAIN_PATH_CASE = "jamba_prefill"
KERNEL_SOURCES = ("flash_attention.cu", "wkv6.cu", "mamba_scan.cu")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the causal / window masks leave visible."""
    total = 0
    for q in range(Sq):
        hi = min(q, Skv - 1) if causal else Skv - 1
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def row_rel_err(out, ref) -> float:
    """max over rows of max|out - ref| / rms(ref) within the row, in fp32
    (fp64 where either is fp64)."""
    import torch

    dt = torch.promote_types(torch.promote_types(out.dtype, ref.dtype), torch.float32)
    d = (out.to(dt) - ref.to(dt)).abs().amax(dim=-1)
    rms = ref.to(dt).pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return (d / rms).max().item()


def wkv_inputs(dev, B, H, S, hd, seed=0):
    """The reference's test distribution: r, k, v normal, decay uniform in
    (0.7, 0.999) as log w, u * 0.3."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=dev) for _ in range(3))
    w = 0.7 + 0.299 * torch.rand(B, H, S, hd, generator=g, device=dev)
    u = 0.3 * torch.randn(H, hd, generator=g, device=dev)
    return r, k, v, torch.log(w), u


def mamba_inputs(dev, B, S, di, N, dtype, model_layout, seed=0):
    """The reference's test distribution: dt = softplus(normal), x, B, C
    normal, A = -exp(0.5 normal), D = 1; x, B and C in ``dtype``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device=dev))
    x = torch.randn(B, S, di, generator=g, device=dev).to(dtype)
    A = -torch.exp(0.5 * torch.randn(di, N, generator=g, device=dev))
    if model_layout:
        dbc = torch.randn(B, S, 256 + 2 * N, generator=g, device=dev).to(dtype)
        _, Bc, Cc = dbc.split([256, N, N], dim=-1)
    else:
        Bc, Cc = (torch.randn(B, S, N, generator=g, device=dev).to(dtype) for _ in range(2))
    return dt, x, A, Bc, Cc, torch.ones(di, device=dev)


def decode_step_profile(cfg, model, dev, sync) -> str:
    """One decode step of the launcher's flow (batch 4, position 64 of a
    96-position cache) counted and traced: the operations the eager step
    dispatches (views included), its wall time unprofiled (median of 9), and
    the device's busy time under the profiler (sum of kernel durations)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step

    plan = plan_for_cell(cfg, 96, 4, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=4, max_len=96, device=dev)
    caches = init_kv_cache(cfg, 4, 96, torch.bfloat16, dev)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), 64, dtype=torch.int64, device=dev)
    n_layers = cfg.n_layers

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    for _ in range(3):
        dstep(model, tok, pos, caches)
    sync()
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        dstep(model, tok, pos, caches)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    ops = OpCount()
    with ops:
        dstep(model, tok, pos, caches)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dstep(model, tok, pos, caches)
        sync()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (f"{len(kern)} device kernels busy "
            f"{sum(e.time_range.elapsed_us() for e in kern) / 1e3:.3f} ms"
            if kern else "device busy time not measured (the profiler saw no kernels)")
    return (f"{statistics.median(times):.3f} ms wall (median of 9, "
            f"{min(times):.3f}-{max(times):.3f}), {ops.n} operations dispatched "
            f"({ops.n / n_layers:.1f} per layer), {busy}")


def prefill_breakdown(prefill, model, tokens, kernel_tags: tuple[str, ...], sync,
                      top: int = 8) -> str:
    """One prefill step under the profiler: device time summed over each
    hand-written kernel (its symbol contains one of ``kernel_tags``), the
    dense products (cuBLAS / CUTLASS symbols) and everything else
    (elementwise passes, reductions, copies); then the ``top`` PyTorch
    operators by the device time of the kernels they launched themselves."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prefill(model, tokens)
        sync()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return "device time by kind not measured (the profiler saw no kernels)"
    groups = {tag: [0, 0.0] for tag in kernel_tags}
    groups.update({"dense products": [0, 0.0], "other": [0, 0.0]})
    for e in kern:
        name = e.name.lower()
        kind = next((tag for tag in kernel_tags if tag in name), None) or (
            "dense products" if any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma"))
            else "other")
        groups[kind][0] += 1
        groups[kind][1] += e.time_range.elapsed_us() / 1e3
    total = sum(ms for _, ms in groups.values())
    ops = sorted(((a.key, a.count, a.self_device_time_total / 1e3) for a in prof.key_averages()
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda r: -r[2])
    return (f"{len(kern)} device kernels busy {total:.3f} ms: " + ", ".join(
        f"{kind} {ms:.3f} ms ({n} kernels)" for kind, (n, ms) in groups.items())
        + "; top aten operators by device time: "
        + ", ".join(f"{key} {ms:.3f} ms ({n} calls)" for key, n, ms in ops[:top]))


def timed_prefills(prefill, model, tokens, sync) -> list[float]:
    """Wall times (ms) of three prefill steps, each ending in a synchronise."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(model, tokens)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def check_reproducible(prefill, model, tokens, first, name: str) -> None:
    """Fails unless one more prefill of ``tokens`` gives logits bit-identical
    to ``first``, an earlier call's logits at every 64th position."""
    again = prefill(model, tokens)[:, ::64]
    check(again.equal(first), f"two {name} prefills of the same tokens differ: "
          f"max |diff| {(again.float() - first.float()).abs().max().item()}")


def decode_from_prefill(cfg, model, prompt, steps: int, dev, sync):
    """Prefill ``prompt`` with the state collected, move that state into
    full-length caches (k / v into the first positions; recurrent states as
    they are), then ``steps`` greedy decode steps; checks every logit is
    finite and returns the tokens [B, steps]."""
    import torch
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step, greedy_generate

    B, P = prompt.shape
    with torch.inference_mode():
        logits, pre_caches = model(prompt.to(dev), collect_cache=True)
    check(bool(torch.isfinite(logits).all()), f"non-finite {cfg.name} prefill logits")
    last = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    plan = plan_for_cell(cfg, P + steps, B, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=B, max_len=P + steps, device=dev)
    caches = init_kv_cache(cfg, B, P + steps, torch.bfloat16, dev)
    with torch.inference_mode():
        for full, pre in zip(caches, pre_caches):
            check(set(full) == set(pre), f"state keys {set(full)} vs {set(pre)}")
            for n in full:
                if n in ("k", "v"):
                    full[n][:, :, :P] = pre[n]
                else:
                    full[n].copy_(pre[n])
    del pre_caches
    captured = []

    def logged_step(m, tok, pos, c):
        lg, c = dstep(m, tok, pos, c)
        captured.append(lg)
        return lg, c

    out, caches = greedy_generate(cfg, model, logged_step, caches, last, P, steps)
    sync()
    check(tuple(out.shape) == (B, steps), f"{cfg.name} generated {tuple(out.shape)}")
    check(all(bool(torch.isfinite(lg).all()) for lg in captured), "non-finite decode logits")
    check(all(bool(torch.isfinite(t).all()) for c in caches for t in c.values()),
          "non-finite decode state")
    return out


def decode_token_by_token(cfg, model, tokens, dev):
    """Feed ``tokens`` [B, S] one at a time through the decode step from zero
    fp32 caches of S positions; returns (logits [B, S, vocab], caches)."""
    import torch
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step

    B, S = tokens.shape
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=B, max_len=S, device=dev)
    caches = init_kv_cache(cfg, B, S, torch.float32, dev)
    logits = []
    for t in range(S):
        lg, caches = dstep(model, tokens[:, t:t + 1], torch.full((B,), t), caches)
        logits.append(lg)
    return torch.cat(logits, dim=1), caches


def launcher_flow(serve, cfg, model, card: str) -> None:
    """The launcher's flow: batch 4, prompt 64 ingested through the decode
    step, 32 greedy tokens; prints its times and peak memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, batch=4, prompt_len=64, tokens=32, cache_dtype=torch.bfloat16)
    out = res["tokens"]
    check(tuple(out.shape) == (4, 32), f"generated {tuple(out.shape)}")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab, "token out of range")
    print(f"  launcher flow (batch 4, prompt 64, 32 tokens): prompt ingest "
          f"{1e3 * res['prompt_s']:.3f} ms, decode {res['decode_tok_s']:.1f} tok/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {Path(__file__).name}: run from a checkout",
              file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba.kernel import mamba_scan_kernel
    from repro_torch.kernels.mamba.ref import mamba_scan_ref
    from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_prefill_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def cuda_ms(fn, iters: int) -> float:
        fn()                                    # warm-up (and first-use build)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ------------------------------------------------------------ phase 1
    smi = nvidia_smi_line()
    card = f"[{smi}]"
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:     # one nvcc per source
        took = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    print("kernel build: " + ", ".join(f"{src} {t:.3f} s" for src, t in took.items())
          + f" (wall {time.perf_counter() - t0:.3f} s, in parallel)")
    for src in KERNEL_SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                    print(f"  ptxas {src}:", line.strip())

    # ------------------------------------------------------------ phase 2
    print("phase 2: flash_attention kernel vs plain version on the card")
    results = {}
    for name, B, H, KV, S, hd, causal, window, cap, dt in FA_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
        out = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap)
        ref = attention_ref(q, k, v, causal, window, cap)
        sync()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
              f"{name}: kernel vs plain max abs err {err} (tol {tol})")
        check(rel <= ROW_REL_TOL,
              f"{name}: kernel vs plain per-row error {rel} / rms (tol {ROW_REL_TOL})")
        del out, ref
        big = B * H * S * S > 2 ** 28
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=causal, window=window,
                                                    softcap=cap), 10 if big else 50)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal, window, cap), 2 if big else 10)
        library_ms = None
        if cap == 0.0:      # SDPA has no softcap; windows go in as a boolean mask
            mask = None
            if window > 0:
                pos = torch.arange(S, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=H != KV), 10 if big else 50)
        flops = 4 * B * H * hd * visible_pairs(S, S, causal, window)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        t_ops = flops / (BF16_PEAK_FLOPS if dtype == torch.bfloat16 else FP32_PEAK_FLOPS)
        t_mem = nbytes / HBM_BYTES_PER_S
        results[name] = {
            "max_abs_err": err, "row_rel_err": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
        }
        print(f"  {name}: B={B} H={H} KV={KV} S={S} hd={hd} causal={causal} "
              f"window={window} softcap={cap} {dt}: tol {tol}, row tol {ROW_REL_TOL} {json.dumps(results[name])} "
              f"{card}")
        del q, k, v
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 3
    cfg = get_config("granite-3-8b")
    print(f"phase 3: {cfg.name} full width and depth ({cfg.n_layers} layers), bf16")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(cfg, plan, dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = wkv6_kernel.launches = mamba_scan_kernel.launches = 0
    logits = prefill(model, tokens)
    sync()
    launches = flash_attention_kernel.launches
    check(launches == cfg.n_layers,
          f"{launches} flash-attention launches in one prefill, expected {cfg.n_layers}")
    check(wkv6_kernel.launches == mamba_scan_kernel.launches == 0,
          "wkv6 / mamba_scan launched in a granite prefill")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    check(flash_attention_kernel.launches == 4 * cfg.n_layers, "launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3), "
          f"{launches} kernel launches per call, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('fa_fwd',), sync)} {card}")
    launcher_flow(serve, cfg, model, card)
    # One step of the same decode flow, counted and traced.
    prof = decode_step_profile(cfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 4
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32")
    print(f"phase 4: prefill vs decode, {cfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {cfg.n_layers}→{cfg4.n_layers}")
    model = init_params(cfg4, torch.Generator(device=dev).manual_seed(2), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg4.vocab, (B, S), generator=torch.Generator().manual_seed(3))
    plan = plan_for_cell(cfg4, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    flash_attention_kernel.launches = 0
    logits_p = build_prefill_step(cfg4, plan, dev)(model, tokens)
    check(flash_attention_kernel.launches == cfg4.n_layers, "fp32 prefill launches")
    logits_d, caches = decode_token_by_token(cfg4, model, tokens, dev)
    scale = logits_p.abs().max().item()
    err = (logits_p - logits_d).abs().max().item()
    # fp32 throughout: the two paths differ only in summation order (flash
    # tiles vs one softmax over the cache; cuBLAS at M=B*S vs M=B), which
    # leaves ~1e-6 relative; 1e-3 of the logit scale flags any wrong mask,
    # position or cache entry, which moves logits by O(1).
    tol = 1e-3 * scale
    check(err <= tol, f"prefill vs decode logits: max abs err {err} > {tol}")
    print(f"  B={B} S={S}: max |prefill - decode| {err:.3e} (tol 1e-3 x max|logit| "
          f"= {tol:.3e})")
    del model, caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 5
    gcfg = get_config("gemma2-9b")
    cfg5 = dataclasses.replace(gcfg, n_layers=2)
    print(f"phase 5: {gcfg.name} full width, bf16, layers {cfg5.block_kinds()}")
    print(f"  reduced: n_layers {gcfg.n_layers}→{cfg5.n_layers}")
    model = init_params(cfg5, torch.Generator(device=dev).manual_seed(4), dev)
    B, S, steps = 1, 8192, 8
    tokens = torch.randint(0, cfg5.vocab, (B, S), generator=torch.Generator().manual_seed(5))
    flash_attention_kernel.launches = 0
    out = decode_from_prefill(cfg5, model, tokens, steps, dev, sync)
    check(flash_attention_kernel.launches == cfg5.n_layers, "gemma2 prefill launches")
    print(f"  prefill S={S} ({flash_attention_kernel.launches} kernel launches), "
          f"{steps} decode steps: tokens {out[0].tolist()}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 6
    print("phase 6: wkv6 kernel vs plain version on the card (fp32)")
    wkv_results = {}
    for name, B, H, S, hd in WKV_CASES:
        args = wkv_inputs(dev, B, H, S, hd)
        out = wkv6_kernel(*args)
        ref = wkv6_ref(*args)
        sync()
        errs, rels = [], []
        for what, o, rf in (("out", out[0], ref[0]), ("S_last", out[1], ref[1])):
            err = (o - rf).abs().max().item()
            rel = row_rel_err(o, rf)
            check(torch.allclose(o, rf, rtol=WKV_TOL, atol=WKV_TOL),
                  f"{name}: kernel vs plain {what} max abs err {err} (tol {WKV_TOL})")
            check(rel <= WKV_ROW_REL_TOL,
                  f"{name}: kernel vs plain {what} per-row error {rel} / rms "
                  f"(tol {WKV_ROW_REL_TOL})")
            errs.append(err)
            rels.append(rel)
        rounding = ""
        if name == WKV_MAIN_PATH_CASE:
            # How far fp32 rounding alone moves the plain version: the same
            # recurrence in float64 as the yardstick for both (max abs error;
            # worst row error / row rms).
            ref64 = wkv6_ref(*(a.double() for a in args))
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {what} {(o.double() - r64).abs().max().item():.3e} / "
                f"{row_rel_err(o, r64):.3e}"
                for who, got in (("fp32 plain", ref), ("kernel", out))
                for what, o, r64 in (("out", got[0], ref64[0]), ("S_last", got[1], ref64[1])))
            del ref64
        del out, ref
        big = B * H * S > 2 ** 16
        ms = cuda_ms(lambda: wkv6_kernel(*args), 20 if big else 50)
        plain_ms = cuda_ms(lambda: wkv6_ref(*args), 2 if big else 5)
        T = min(WKV_CHUNK, S)
        flops = B * H * S * (4 * T * hd + 4 * hd * hd)          # chunk form at chunk T
        nbytes = 4 * (5 * B * H * S * hd + H * hd + B * H * hd * hd)
        t_ops, t_mem = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
        wkv_results[name] = {
            "max_abs_err": max(errs), "row_rel_err": max(rels), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
        }
        print(f"  {name}: B={B} H={H} S={S} hd={hd}: tol {WKV_TOL}, row tol "
              f"{WKV_ROW_REL_TOL} (out, S_last) {json.dumps(wkv_results[name])}{rounding} {card}")
        del args
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 7
    rcfg = get_config("rwkv6-3b")
    print(f"phase 7: {rcfg.name} full width and depth ({rcfg.n_layers} layers), bf16")
    t0 = time.perf_counter()
    model = init_params(rcfg, torch.Generator(device=dev).manual_seed(6), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(rcfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(rcfg, plan, dev)
    tokens = torch.randint(0, rcfg.vocab, (B, S), generator=torch.Generator().manual_seed(7))
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = wkv6_kernel.launches = mamba_scan_kernel.launches = 0
    logits = prefill(model, tokens)
    sync()
    wkv_launches = wkv6_kernel.launches
    check(wkv_launches == rcfg.n_layers,
          f"{wkv_launches} wkv6 launches in one prefill, expected {rcfg.n_layers}")
    check(flash_attention_kernel.launches == mamba_scan_kernel.launches == 0,
          "flash attention / mamba_scan launched in an rwkv prefill")
    check(tuple(logits.shape) == (B, S, rcfg.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite rwkv prefill logits")
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    check(wkv6_kernel.launches == 4 * rcfg.n_layers, "wkv6 launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {wkv_launches} kernel launches per call, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('wkv6_fwd',), sync)} "
          f"{card}")

    # the prefill's collected state, then 8 decode steps from it
    P, steps = 512, 8
    wkv6_kernel.launches = 0
    out = decode_from_prefill(rcfg, model, tokens[:, :P], steps, dev, sync)
    check(wkv6_kernel.launches == rcfg.n_layers, "rwkv collect-cache prefill launches")
    print(f"  prefill S={P} with the state collected, {steps} decode steps from it: "
          f"tokens {out[0].tolist()}")
    launcher_flow(serve, rcfg, model, card)
    prof = decode_step_profile(rcfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 8
    cfg8 = dataclasses.replace(rcfg, n_layers=4, param_dtype="float32")
    print(f"phase 8: prefill vs decode, {rcfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {rcfg.n_layers}→{cfg8.n_layers}")
    model = init_params(cfg8, torch.Generator(device=dev).manual_seed(8), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg8.vocab, (B, S), generator=torch.Generator().manual_seed(9))
    wkv6_kernel.launches = 0
    with torch.inference_mode():
        logits_p, pre_caches = model(tokens.to(dev), collect_cache=True)
    check(wkv6_kernel.launches == cfg8.n_layers, "fp32 rwkv prefill launches")
    logits_d, caches = decode_token_by_token(cfg8, model, tokens, dev)
    check(wkv6_kernel.launches == cfg8.n_layers, "decode launched the wkv6 kernel")
    # fp32 throughout: the two paths differ in summation order (the kernel's
    # chunk form vs the one-step recurrence; cuBLAS at M=B*S vs M=B), which
    # leaves ~1e-6 relative; 1e-3 of each tensor's scale flags a wrong decay,
    # state handoff or token shift, which moves results by O(1).
    report = []
    pairs = [("logits", logits_p, logits_d)] + [
        (n, pre_caches[0][n], caches[0][n]) for n in ("S", "shift", "shift_ffn")]
    for n, a, b in pairs:
        scale = a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= 1e-3 * scale, f"prefill vs decode {n}: max abs err {err} > "
                                   f"1e-3 x {scale}")
        report.append(f"{n} {err:.3e} (tol {1e-3 * scale:.3e})")
    worst_t = int((logits_p - logits_d).abs().amax(dim=(0, 2)).argmax())
    print(f"  B={B} S={S}: max |prefill - decode| " + ", ".join(report)
          + f" (tol 1e-3 x max|x|); worst logit at position {worst_t}")
    del model, caches, pre_caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 9
    print("phase 9: mamba_scan kernel vs plain version on the card")
    mamba_results = {}
    for name, B, S, di, N, dt_name, model_layout in MAMBA_CASES:
        dtype = getattr(torch, dt_name)
        args = mamba_inputs(dev, B, S, di, N, dtype, model_layout)
        out = mamba_scan_kernel(*args)
        ref = mamba_scan_ref(*args)
        sync()
        errs, rels = [], []
        for what, o, rf in (("y", out[0], ref[0]), ("h_last", out[1], ref[1])):
            err = (o - rf).abs().max().item()
            rel = row_rel_err(o, rf)
            check(torch.allclose(o, rf, rtol=MAMBA_TOL, atol=MAMBA_TOL),
                  f"{name}: kernel vs plain {what} max abs err {err} (tol {MAMBA_TOL})")
            check(rel <= MAMBA_ROW_REL_TOL,
                  f"{name}: kernel vs plain {what} per-row error {rel} / rms "
                  f"(tol {MAMBA_ROW_REL_TOL})")
            errs.append(err)
            rels.append(rel)
        rounding = ""
        if name == MAMBA_MAIN_PATH_CASE:
            # How far fp32 rounding alone moves the plain version: the same
            # recurrence in float64 as the yardstick for both.
            ref64 = mamba_scan_ref(*(a.double() for a in args))
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {what} {(o.double() - r64).abs().max().item():.3e} / "
                f"{row_rel_err(o, r64):.3e}"
                for who, got in (("fp32 plain", ref), ("kernel", out))
                for what, o, r64 in (("y", got[0], ref64[0]), ("h_last", got[1], ref64[1])))
            del ref64
        del out, ref
        big = B * S * di > 2 ** 22
        ms = cuda_ms(lambda: mamba_scan_kernel(*args), 20 if big else 50)
        plain_ms = cuda_ms(lambda: mamba_scan_ref(*args), 2 if big else 5)
        # per state update: dt*A, exp, a*h + bx, (dt x)*B, y += C h; per
        # (token, channel): dt*x, y + D x
        flops = B * S * di * (7 * N + 3)
        nbytes = (sum(t.element_size() * t.numel() for t in args)     # B, C: views' own elements
                  + 4 * (B * S * di + B * di * N))                    # y, h_last
        t_ops, t_mem = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
        mamba_results[name] = {
            "max_abs_err": max(errs), "row_rel_err": max(rels), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
        }
        print(f"  {name}: B={B} S={S} di={di} N={N} x {dt_name}"
              f"{', B/C strided views' if model_layout else ''}: tol {MAMBA_TOL}, row tol "
              f"{MAMBA_ROW_REL_TOL} (y, h_last) {json.dumps(mamba_results[name])}{rounding} "
              f"{card}")
        del args
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 10
    jcfg = get_config("jamba-v0.1-52b")
    cfg10 = dataclasses.replace(jcfg, n_layers=16)
    n_mamba = cfg10.block_kinds().count("mamba")
    n_attn = cfg10.n_layers - n_mamba
    print(f"phase 10: {jcfg.name} full width, bf16, {cfg10.n_layers} layers "
          f"({n_mamba} mamba, {n_attn} attention, MoE on every second layer)")
    print(f"  reduced: n_layers {jcfg.n_layers}→{cfg10.n_layers}")
    t0 = time.perf_counter()
    model = init_params(cfg10, torch.Generator(device=dev).manual_seed(10), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(cfg10, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(cfg10, plan, dev)
    tokens = torch.randint(0, cfg10.vocab, (B, S), generator=torch.Generator().manual_seed(11))
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = wkv6_kernel.launches = mamba_scan_kernel.launches = 0
    logits = prefill(model, tokens)
    sync()
    mamba_launches = mamba_scan_kernel.launches
    check(mamba_launches == n_mamba == 14,
          f"{mamba_launches} mamba_scan launches in one prefill, expected 14")
    check(flash_attention_kernel.launches == n_attn == 2,
          f"{flash_attention_kernel.launches} flash launches in one prefill, expected 2")
    check(wkv6_kernel.launches == 0, "wkv6 launched in a jamba prefill")
    check(tuple(logits.shape) == (B, S, cfg10.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite jamba prefill logits")
    first = logits[:, ::64].clone()
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    check(mamba_scan_kernel.launches == 4 * n_mamba, "mamba_scan launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {mamba_launches} mamba_scan and "
          f"{n_attn} flash launches per call, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    check_reproducible(prefill, model, tokens, first, "jamba")
    print("  prefill traced: "
          f"{prefill_breakdown(prefill, model, tokens, ('mamba_scan_fwd', 'fa_fwd'), sync)} "
          f"{card}")
    out = decode_from_prefill(cfg10, model, tokens[:, :512], 8, dev, sync)
    print(f"  prefill S=512 with the state collected, 8 decode steps from it: "
          f"tokens {out[0].tolist()}")
    launcher_flow(serve, cfg10, model, card)
    prof = decode_step_profile(cfg10, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 11
    cfg11 = dataclasses.replace(jcfg, n_layers=8, param_dtype="float32")
    print(f"phase 11: prefill vs decode, {jcfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {jcfg.n_layers}→{cfg11.n_layers}")
    model = init_params(cfg11, torch.Generator(device=dev).manual_seed(12), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg11.vocab, (B, S), generator=torch.Generator().manual_seed(13))
    mamba_scan_kernel.launches = flash_attention_kernel.launches = 0
    with torch.inference_mode():
        logits_p, pre_caches = model(tokens.to(dev), collect_cache=True)
    check(mamba_scan_kernel.launches == 7 and flash_attention_kernel.launches == 1,
          "fp32 jamba prefill launches")
    logits_d, caches = decode_token_by_token(cfg11, model, tokens, dev)
    check(mamba_scan_kernel.launches == 7, "decode launched the mamba_scan kernel")
    # fp32 throughout, and at B*S = 200 <= 512 tokens every dispatch group
    # holds one token, so neither path drops an MoE choice: the two differ in
    # summation order only (the kernel vs the plain one-step update; cuBLAS at
    # M=B*S vs M=B), ~1e-6 relative; 1e-3 of each tensor's scale flags a
    # wrong decay, state handoff, conv window or routing, which moves results
    # by O(1).
    report = []
    pairs = [("logits", logits_p, logits_d)]
    for pi, (pre, full) in enumerate(zip(pre_caches, caches)):
        pairs += [(f"{n}[{pi}]", pre[n], full[n]) for n in sorted(pre)]
    worst = {}
    for n, a, b in pairs:
        scale = a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= 1e-3 * scale, f"prefill vs decode {n}: max abs err {err} > "
                                   f"1e-3 x {scale}")
        kind = n.split("[")[0]
        if err / scale >= worst.get(kind, (0.0, 0.0, ""))[0]:
            worst[kind] = (err / scale, err, n)
    report = [f"{n} {err:.3e} ({rel:.3e} of max|x|)" for rel, err, n in worst.values()]
    worst_t = int((logits_p - logits_d).abs().amax(dim=(0, 2)).argmax())
    print(f"  B={B} S={S}: max |prefill - decode|, worst slot of each state: "
          + ", ".join(report) + f" (tol 1e-3 x max|x|); worst logit at position {worst_t}")
    del model, caches, pre_caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 12
    gcfg = get_config("granite-moe-1b-a400m")
    print(f"phase 12: {gcfg.name} full width and depth ({gcfg.n_layers} layers, "
          f"{gcfg.moe.n_experts} experts top-{gcfg.moe.top_k}), bf16")
    model = init_params(gcfg, torch.Generator(device=dev).manual_seed(14), dev)
    sync()
    print(f"  init {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(gcfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(gcfg, plan, dev)
    tokens = torch.randint(0, gcfg.vocab, (B, S), generator=torch.Generator().manual_seed(15))
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = wkv6_kernel.launches = mamba_scan_kernel.launches = 0
    logits = prefill(model, tokens)
    sync()
    check(flash_attention_kernel.launches == gcfg.n_layers == 24,
          f"{flash_attention_kernel.launches} flash launches in one prefill, expected 24")
    check(wkv6_kernel.launches == mamba_scan_kernel.launches == 0,
          "wkv6 / mamba_scan launched in a granite-moe prefill")
    check(bool(torch.isfinite(logits).all()), "non-finite granite-moe prefill logits")
    first = logits[:, ::64].clone()
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {gcfg.n_layers} flash launches per call, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    check_reproducible(prefill, model, tokens, first, "granite-moe")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('fa_fwd',), sync)} "
          f"{card}")
    launcher_flow(serve, gcfg, model, card)
    prof = decode_step_profile(gcfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", gcfg.name]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "generated (4, 32)" in proc.stdout,
          f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stdout}{proc.stderr}")
    print(f"  python {' '.join(cmd[1:])}: " + " | ".join(proc.stdout.strip().splitlines())
          + f" {card}")

    # ------------------------------------------------------------ result
    main_case = results[MAIN_PATH_CASE]
    wkv_case = wkv_results[WKV_MAIN_PATH_CASE]
    mamba_case = mamba_results[MAMBA_MAIN_PATH_CASE]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "launches": launches,
        **{k: main_case[k] for k in keys},
    }, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:82",
        "launches": wkv_launches,
        **{k: wkv_case[k] for k in keys},
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba/kernel.py:61",
        "launches": mamba_launches,
        **{k: mamba_case[k] for k in keys},
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
