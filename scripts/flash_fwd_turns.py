#!/usr/bin/env python3
"""Time this checkout's flash forward beside another checkout's, in turns.

    python3 scripts/flash_fwd_turns.py --src _archive/<parent>/src

Builds ``csrc/flash_attention.cu`` of each ``src`` (each into its own
``repro_torch/_build``), prints each build's ptxas registers and spills of
the serving instantiations, then times the serving call (bf16, no
log-sum-exp, no query offset) at the main paths' shapes in four turns:
the other checkout, this one, this one, the other, each turn a process of
its own (``PYTHONPATH`` at that ``src``), the median of 3 x 50 launches a
shape.  Run it on one card; compare only within one run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (name, B, H, KV, S, hd, window, softcap): granite-3-8b, gemma2-9b's local
# and global layers, granite-moe-1b-a400m
CASES = [
    ("granite", 4, 32, 8, 2048, 128, 0, 0.0),
    ("gemma2_local", 1, 16, 8, 8192, 256, 4096, 50.0),
    ("gemma2_global", 1, 16, 8, 8192, 256, 0, 50.0),
    ("granite_moe", 4, 16, 8, 2048, 64, 0, 0.0),
]

TURN = r"""
import json, statistics, sys, torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
cases, report = json.loads(sys.argv[1]), sys.argv[2] == "1"
_build.build("flash_attention.cu")
if report:
    log = _build.library_path("flash_attention.cu").with_suffix(".log").read_text()
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas", line.split("info    :")[-1].strip())
dev = torch.device("cuda")
out = {}
for name, B, H, KV, S, hd, window, cap in cases:
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, KV, S, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).bfloat16()
    call = lambda: flash_attention_kernel(q, k, v, causal=True, window=window, softcap=cap)
    for _ in range(5):
        call()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 50)
    out[name] = statistics.median(times)
print("RESULT " + json.dumps(out))
"""


def turn(src: Path, report: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, json.dumps(CASES), str(int(report))],
                          env={**os.environ, "PYTHONPATH": str(src)},
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {src} failed:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stdout.splitlines():
        if not line.startswith("RESULT "):
            print(line)
    return json.loads(proc.stdout.split("RESULT ", 1)[1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the other checkout's src directory")
    args = ap.parse_args()
    other, this = Path(args.src).resolve(), REPO / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    runs = []
    for i, (label, src) in enumerate((("other", other), ("this", this), ("this", this),
                                      ("other", other))):
        print(f"turn {i + 1}: {label} ({src})")
        ms = turn(src, report=i < 2)
        runs.append((label, ms))
        print(f"  {json.dumps(ms)} [{smi}]")
    for name, *_ in CASES:
        o = [ms[name] for label, ms in runs if label == "other"]
        t = [ms[name] for label, ms in runs if label == "this"]
        print(f"{name}: other {o[0]:.4f} / {o[1]:.4f} ms, this {t[0]:.4f} / {t[1]:.4f} ms "
              f"[{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
