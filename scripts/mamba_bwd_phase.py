#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19 alone, on one card: build the scan's and the
flash kernels' sources (one ``nvcc`` each, in parallel), print the scan
kernels' ptxas report, then run ``mamba_training_phase`` (the selective-scan
backward against its plain version, its times, jamba's training at full
width).  A quick check of a change to the scan's backward (~1.5 min, build
included), where the whole smoke run takes ~10:

    python3 scripts/mamba_bwd_phase.py
"""
from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("mamba_scan.cu", "mamba_scan_bwd.cu", "flash_attention.cu", "flash_attention_bwd.cu")


def main() -> int:
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
