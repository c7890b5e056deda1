#!/usr/bin/env python3
"""Time this checkout's flash backward beside another checkout's, in turns,
and check that the two compute the same bits.

    python3 scripts/flash_bwd_turns.py --src _archive/<parent>/src

Builds ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` of
each ``src`` (each into its own ``repro_torch/_build``), prints each build's
ptxas registers and spills of the backward, then runs the backward with no
query offset (the one-rank training call) in four turns: the other
checkout, this one, this one, the other, each turn a process of its own
(``PYTHONPATH`` at that ``src``).  Every case's dq, dk and dv are hashed in
every turn and must be the same in all four; granite-3-8b's training shape
is timed (the median of 3 x 20 launches).  Run it on one card; compare times
only within one run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (name, B, H, KV, S, hd, window, softcap, dtype, timed): granite-3-8b's
# training shape, gemma2-9b's local layer (hd 256, mma.sync), granite-20b's
# MQA (the split dk / dv path), a softcap with a window at hd 128 (the
# residual products) and an fp32 case
CASES = [
    ("granite_train", 4, 32, 8, 2048, 128, 0, 0.0, "bfloat16", True),
    ("gemma2_local", 1, 16, 8, 8192, 256, 4096, 50.0, "bfloat16", False),
    ("granite20b_mqa", 1, 48, 1, 2048, 128, 0, 0.0, "bfloat16", False),
    ("softcap_hd128", 1, 16, 8, 2048, 128, 1024, 50.0, "bfloat16", False),
    ("fp32_hd64", 2, 8, 4, 1000, 64, 0, 0.0, "float32", False),
]

TURN = r"""
import hashlib, json, statistics, sys, torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                        flash_attention_kernel)
cases, report = json.loads(sys.argv[1]), sys.argv[2] == "1"
for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
    _build.build(src)
if report:
    log = _build.library_path("flash_attention_bwd.cu").with_suffix(".log").read_text()
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas", line.split("info    :")[-1].strip())
dev = torch.device("cuda")
out = {}
for name, B, H, KV, S, hd, window, cap, dt, timed in cases:
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev).to(dtype).transpose(1, 2)
               for n in (H, KV, KV))
    do = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    saved = flash_attention_kernel(q, k, v, causal=True, window=window, softcap=cap,
                                   with_lse=True)
    call = lambda: flash_attention_bwd_kernel(q, k, v, do, saved, causal=True, window=window,
                                              softcap=cap)
    got = call()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in got:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    res = {"sha256": h.hexdigest()}
    if timed:
        for _ in range(3):
            call()
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 20)
        res["ms"] = statistics.median(times)
    out[name] = res
    del q, k, v, do, saved, got
print("RESULT " + json.dumps(out))
"""


def turn(src: Path, report: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, json.dumps(CASES), str(int(report))],
                          env={**os.environ, "PYTHONPATH": str(src)},
                          capture_output=True, text=True, timeout=900)
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
        res = turn(src, report=i < 2)
        runs.append((label, res))
        print(f"  {json.dumps(res)} [{smi}]")
    same = True
    for name, *_, timed in CASES:
        hashes = {res[name]["sha256"] for _, res in runs}
        same &= len(hashes) == 1
        line = f"{name}: outputs {'bit-identical in every turn' if len(hashes) == 1 else 'DIFFER'}"
        if timed:
            o = [res[name]["ms"] for label, res in runs if label == "other"]
            t = [res[name]["ms"] for label, res in runs if label == "this"]
            ratio = (t[0] + t[1]) / (o[0] + o[1])
            line += (f"; other {o[0]:.4f} / {o[1]:.4f} ms, this {t[0]:.4f} / {t[1]:.4f} ms, "
                     f"this / other {ratio:.4f}")
        print(f"{line} [{smi}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
