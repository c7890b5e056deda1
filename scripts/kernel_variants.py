#!/usr/bin/env python3
"""Ablations of a CUDA kernel of the port, timed on one NVIDIA GPU.

    python3 scripts/kernel_variants.py scripts/scan_ablations.json
    python3 scripts/kernel_variants.py scripts/qmatmul_ablations.json
    python3 scripts/kernel_variants.py scripts/flash_bwd_ablations.json
    python3 scripts/kernel_variants.py scripts/flash_bwd_mutations.json
    python3 scripts/kernel_variants.py scripts/scan_bwd_ablations.json

Each entry of the spec is ``{"name", "source", "edits", "note"}``: ``source`` is a
file under ``src/repro_torch/csrc`` (``mamba_scan.cu``, ``wkv6.cu``,
``qmatmul.cu``, ``flash_attention_bwd.cu`` or ``mamba_scan_bwd.cu``) and ``edits`` a list of ``[old, new]`` text replacements,
each of which must match.  Every variant is built with the flags of
``kernels/_build.py`` (one ``nvcc`` each, in parallel) into a scratch
directory, called through the same C interface as the kernel, and timed
with CUDA events (mean of 20 calls, three times) at the shape of its main
path: the selective scan at jamba's prefill (B=4, S=2048, di=8192, N=16,
x bf16, B / C strided views), WKV-6 at rwkv6-3b's (B=4, H=40, S=2048,
hd=64) on the reference's decays and on strong ones, qmatmul at
granite-3-8b's FFN up-projection (M=8192, K=4096, N=12800, fp32 out) on
its wgmma / TMA path, with the [N,K] scratch holding w transposed before
the timing, the flash backward at granite-3-8b's training shape (B=4,
H=32, KV=8, S=2048, hd=128, bf16, causal; q, k, v transposed views as the
model passes them), on what a training forward of the built kernel keeps,
the selective-scan backward at jamba's training shape (B=4, S=2048,
di=8192, N=16, x bf16, B / C strided views, ``chip_smoke.mamba_inputs``) on
the reference's test draw and on strong decays, on the chunk states of the
forward kernel.  A flash-backward or scan-backward variant goes through the
wrapper in place of the kernel.
A variant that removes work gives wrong outputs on purpose;
the max abs difference from the plain version is printed beside each time
so that the two kinds stand apart.  A flash-backward entry with ``cases``
(``[[name, dtype], ...]``, names of ``chip_smoke.FA_BWD_CASES``) is not
timed: it runs at each case's shape and inputs and is held to
``chip_smoke.py`` phase 15(a)'s bounds, which must fail a variant that
computes something else.  One JSON line per variant (with its kernels'
registers and spills from ptxas), then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"


def build(item: dict, out: Path) -> tuple[str, bool, str]:
    from repro_torch.kernels import _build

    text = (CSRC / item["source"]).read_text()
    for old, new in item.get("edits", []):
        if old not in text:
            raise ValueError(f"{item['name']}: edit does not match {item['source']}: {old[:60]!r}")
        text = text.replace(old, new)
    src, lib = out / f"{item['name']}.cu", out / f"{item['name']}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    return str(lib), proc.returncode == 0, proc.stdout + proc.stderr


def events_ms(torch, fn, iters: int = 20, reps: int = 3) -> list[float]:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(1, str(REPO))
    from chip_smoke import (FA_BWD_CASES, fa_bwd_errors, fa_bwd_inputs, mamba_inputs,
                            nvidia_smi_line, ptxas_report, wkv_inputs)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.mamba import kernel as mk
    from repro_torch.kernels.mamba.ref import mamba_scan_bwd_ref
    from repro_torch.kernels.mamba.ref import mamba_scan_ref
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    from repro_torch.kernels.rwkv6.kernel import SEGMENT
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    spec = json.loads(Path(sys.argv[1]).read_text())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = f"[{nvidia_smi_line()}]"
    stream = torch.cuda.current_stream().cuda_stream
    qmm = None    # qmatmul's inputs, plain output and w transposed, made once
    fab = None    # the flash backward's inputs and plain gradients, made once
    fa_cases = {}  # (case, dtype) -> inputs and plain gradients, made once
    scan_bwd = {}  # decay range -> the scan backward's inputs, states and plain gradients
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda item: build(item, Path(tmp)), spec))
        for item, (lib, ok, log) in zip(spec, built):
            if not ok:
                print(json.dumps({"variant": item["name"], "build": "failed"}), log[-3000:])
                return 1
            res = {"variant": item["name"], "source": item["source"], "note": item.get("note"),
                   "ptxas": {name: f"{regs}; {spill}" for name, regs, spill in ptxas_report(log)}}
            if item["source"] == "mamba_scan.cu":
                fn = ctypes.CDLL(lib).repro_mamba_scan_fwd
                fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                               + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
                B, S, di, N = 4, 2048, 8192, 16
                args = mamba_inputs(dev, B, S, di, N, torch.bfloat16, True)
                dt, x, A, Bc, Cc, D = args
                y = torch.empty(B, S, di, device=dev)
                h = torch.empty(B, di, N, device=dev)
                st = (ctypes.c_longlong * 10)(*dt.stride()[:2], *x.stride()[:2], *Bc.stride(),
                                               *Cc.stride())
                ptrs = [t.data_ptr() for t in (dt, x, A, Bc, Cc, D, y, h)] + [None]  # no states

                def call():
                    if fn(N, 1, *ptrs, B, S, di, st, stream) != 0:
                        raise RuntimeError(f"{item['name']}: launch failed")

                res["ms"] = events_ms(torch, call)
                res["max_abs_diff"] = (y - mamba_scan_ref(*args)[0]).abs().max().item()
            elif item["source"] == "qmatmul.cu":
                fn = ctypes.CDLL(lib).repro_qmatmul_fwd
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                M, N, K = 8192, 12800, 4096
                if qmm is None:
                    g = torch.Generator(device=dev).manual_seed(0)
                    x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                                      dtype=torch.int8)
                    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                                      dtype=torch.int8)
                    xs = 0.5 + torch.rand(M, generator=g, device=dev)
                    ws = 0.5 + torch.rand(N, generator=g, device=dev)
                    qmm = (x, w, xs, ws, qmatmul_ref(x, w, xs, ws), w.t().contiguous())
                x, w, xs, ws, want, wt_ready = qmm
                out = torch.full((M, N), float("nan"), device=dev)   # unwritten stays NaN
                wt = wt_ready.clone()
                ptrs = [t.data_ptr() for t in (x, w, xs, ws, out, wt)]

                def call():
                    if fn(*ptrs, M, N, K, 0, 1, stream) != 0:
                        raise RuntimeError(f"{item['name']}: launch failed")

                res["ms"] = events_ms(torch, call)
                res["max_abs_diff"] = (out - want).abs().max().item()
                del out, wt
            elif item["source"] == "flash_attention_bwd.cu":
                # the variant goes through the wrapper in place of the kernel
                variant = ctypes.CDLL(lib).repro_flash_attention_bwd
                variant.argtypes, variant.restype = fa._bwd().argtypes, fa._bwd().restype
                as_is, fa._bwd = fa._bwd, lambda: variant
                try:
                    if "cases" in item:
                        shapes = {c[0]: c[1:] for c in FA_BWD_CASES}
                        for name, dt in item["cases"]:
                            B, H, KV, S, hd, causal, window, cap = shapes[name]
                            dtype = getattr(torch, dt)
                            if (name, dt) not in fa_cases:
                                q, k, v, do = fa_bwd_inputs(dev, B, H, KV, S, hd, cap, dtype)
                                saved = fa.flash_attention_kernel(
                                    q, k, v, causal=causal, window=window, softcap=cap,
                                    with_lse=True)
                                fa_cases[name, dt] = (q, k, v, do, saved, attention_bwd_ref(
                                    q, k, v, do, causal, window, cap))
                            q, k, v, do, saved, want = fa_cases[name, dt]
                            got = fa.flash_attention_bwd_kernel(q, k, v, do, saved, causal=causal,
                                                                window=window, softcap=cap)
                            readings, missed = fa_bwd_errors(got, want, dtype)
                            res[f"{name}_{dt}"] = {"passes": not missed, "missed": missed,
                                                   **readings}
                            del got
                    else:
                        B, H, KV, S, hd = 4, 32, 8, 2048, 128
                        if fab is None:
                            q, k, v, do = fa_bwd_inputs(dev, B, H, KV, S, hd, 0.0,
                                                        torch.bfloat16)
                            saved = fa.flash_attention_kernel(q, k, v, with_lse=True)
                            fab = (q, k, v, do, saved, attention_bwd_ref(q, k, v, do))
                        q, k, v, do, saved, want = fab
                        res["ms"] = events_ms(
                            torch, lambda: fa.flash_attention_bwd_kernel(q, k, v, do, saved))
                        got = fa.flash_attention_bwd_kernel(q, k, v, do, saved)
                        res["max_abs_diff"] = max((a.float() - b.float()).abs().max().item()
                                                  for a, b in zip(got, want))
                        del got
                finally:
                    fa._bwd = as_is
            elif item["source"] == "mamba_scan_bwd.cu":
                # the variant goes through the wrapper in place of the kernel
                variant = ctypes.CDLL(lib).repro_mamba_scan_bwd
                variant.argtypes, variant.restype = mk._bwd().argtypes, mk._bwd().restype
                as_is, mk._bwd = mk._bwd, lambda: variant
                try:
                    B, S, di, N = 4, 2048, 8192, 16
                    for which in ("reference", "strong"):
                        if which not in scan_bwd:
                            args = mamba_inputs(dev, B, S, di, N, torch.bfloat16, True,
                                                strong=which == "strong")
                            g = torch.Generator(device=dev).manual_seed(1)
                            dy = torch.randn(B, S, di, generator=g, device=dev)
                            states = mk.mamba_scan_kernel(*args, with_states=True)[2]
                            scan_bwd[which] = (args, states, dy, mamba_scan_bwd_ref(*args, dy))
                        args, states, dy, want = scan_bwd[which]
                        res[f"ms_{which}"] = events_ms(
                            torch, lambda: mk.mamba_scan_bwd_kernel(*args, states, dy))
                        got = mk.mamba_scan_bwd_kernel(*args, states, dy,
                                                       grad_dtype=torch.float32)
                        res[f"max_abs_diff_{which}"] = max(
                            (a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
                        del got
                finally:
                    mk._bwd = as_is
            else:
                fn = ctypes.CDLL(lib).repro_wkv6_fwd
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                               + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
                B, H, S, hd = 4, 40, 2048, 64
                slots = -(-S // SEGMENT) - 1
                for strong in (False, True):
                    r, k, v, w, u = args = wkv_inputs(dev, B, H, S, hd, strong=strong)
                    out = torch.empty_like(r)
                    s_last = torch.empty(B, H, hd, hd, device=dev)
                    seg_state = torch.empty(B, H, slots, hd, hd, device=dev)
                    seg_decay = torch.empty(B, H, slots, hd, device=dev)
                    st = (ctypes.c_longlong * 16)(*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                                   *w.stride()[:3], *out.stride()[:3], u.stride(0))
                    ptrs = [t.data_ptr() for t in (r, k, v, w, u, out, s_last, seg_state, seg_decay)]

                    def call():
                        if fn(hd, *ptrs, B, H, S, SEGMENT, st, stream) != 0:
                            raise RuntimeError(f"{item['name']}: launch failed")

                    which = "strong" if strong else "reference"
                    res[f"ms_{which}"] = events_ms(torch, call)
                    res[f"max_abs_diff_{which}"] = (out - wkv6_ref(*args)[0]).abs().max().item()
            print(json.dumps(res), card, flush=True)
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
