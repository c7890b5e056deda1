#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19 alone, on one card: build the scan's and the
flash kernels' sources (one ``nvcc`` each, in parallel), print the scan
kernels' ptxas report, then run ``mamba_training_phase`` (the selective-scan
backward against its plain version, its times, jamba's training at full
width).  A quick check of a change to the scan's backward (~1.5 min, build
included), where the whole smoke run takes ~10:

    python3 scripts/mamba_bwd_phase.py [--src DIR]

``--src`` takes the ``src`` directory of another checkout (a ``git archive``
of a parent commit): its ``mamba_scan_bwd.cu`` is built with the same flags
and, before the phase, both backward kernels run through the wrapper (same C
interface) at ``jamba_train`` and ``jamba_train_strong``, timed in turns
(other, this, this, other; median of 21 each), with the max abs difference
between their outputs, fp32 and in x's dtype (0 when their arithmetic order
is the same).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("mamba_scan.cu", "mamba_scan_bwd.cu", "flash_attention.cu", "flash_attention_bwd.cu")


def compare(other_src: Path, card: str) -> None:
    """The scan backward of ``other_src`` beside this checkout's, in one run."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba import kernel as mk

    source = other_src / "repro_torch" / "csrc" / "mamba_scan_bwd.cu"
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "mamba_scan_bwd_other.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-o",
                               str(lib), str(source)], capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"nvcc failed on {source}: {proc.stdout}{proc.stderr}")
        for name, regs, spill in cs.ptxas_report(proc.stdout + proc.stderr):
            print(f"  ptxas {source} {name}: {regs}; {spill}")
        other = ctypes.CDLL(str(lib)).repro_mamba_scan_bwd
    as_is = mk._bwd
    other.argtypes, other.restype = as_is().argtypes, as_is().restype
    kernels = {"other": other, "this": as_is()}
    dev = torch.device("cuda")
    cases = {c[0]: c[1:] for c in cs.MAMBA_BWD_CASES}
    try:
        for name in ("jamba_train", "jamba_train_strong"):
            B, S, di, N, dt_name, model_layout, strong, with_dh = cases[name]
            args = cs.mamba_inputs(dev, B, S, di, N, getattr(torch, dt_name), model_layout,
                                   strong=strong)
            g = torch.Generator(device=dev).manual_seed(1)
            dy = torch.randn(B, S, di, generator=g, device=dev)
            dh = torch.randn(B, di, N, generator=g, device=dev) if with_dh else None
            states = mk.mamba_scan_kernel(*args, with_states=True)[2]

            def run(which, grad_dtype=None):
                mk._bwd = lambda: kernels[which]
                return mk.mamba_scan_bwd_kernel(*args, states, dy, dh, grad_dtype=grad_dtype)

            diff = {}
            for grad_dtype in (torch.float32, None):
                a, b = run("other", grad_dtype), run("this", grad_dtype)
                diff["float32" if grad_dtype else dt_name] = max(
                    (x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
                del a, b
            ms = {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                ms[which].append(cs.cuda_ms_median(lambda: run(which), 21))
            res = {"ms_other": ms["other"], "ms_this": ms["this"], "max_abs_diff": diff}
            print(f"  {name}: {json.dumps(res)} (other: {other_src}) {card}", flush=True)
            del args, dy, dh, states
            torch.cuda.empty_cache()
    finally:
        mk._bwd = as_is


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    help="another checkout's src: its scan backward beside this one")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this run needs a GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                            flash_attention_kernel)
    from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel, mamba_scan_kernel
    from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_kernel

    card = f"[{cs.nvidia_smi_line()}]"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda} {card}")
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        took = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print("kernel build: " + ", ".join(f"{s} {t:.3f} s" for s, t in took.items()))
    for src in SOURCES[:2]:
        for name, regs, spill in cs.ptxas_report(
                _build.library_path(src).with_suffix(".log").read_text()):
            print(f"  ptxas {src} {name}: {regs}; {spill}")
    if args.src is not None:
        compare(args.src.resolve(), card)
    kernels = (flash_attention_kernel, flash_attention_bwd_kernel, wkv6_kernel, wkv6_bwd_kernel,
               mamba_scan_kernel, mamba_scan_bwd_kernel, qmatmul_kernel)

    def reset_launches() -> None:
        for k in kernels:
            k.launches = 0

    t0 = time.perf_counter()
    cs.mamba_training_phase(get_config, card, reset_launches, kernels, cs.cuda_ms,
                            cs.cuda_ms_median, torch.cuda.synchronize)
    print(f"phase 19 wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
