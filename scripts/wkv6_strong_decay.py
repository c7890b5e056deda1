#!/usr/bin/env python3
"""The WKV-6 CUDA kernel under strong decays, against its plain version on
one NVIDIA GPU.

    python3 scripts/wkv6_strong_decay.py [--src DIR] [--reps N]

For the rwkv6-3b prefill shape (B=4, H=40, S=2048, hd=64) and a small ragged
shape (2, 3, 100, 64), each on the reference's input distribution (w uniform
in (0.7, 0.999)) and on strong decays (w log-uniform in [1e-3, 0.999], every
16th channel pinned at log w = -50): the kernel's non-finite outputs, its
max abs and per-row error against ``wkv6_ref`` (bound 2e-4 and 1e-3 of the
row's rms, as ``chip_smoke.py`` phase 6), the max abs distance of the kernel
and of the fp32 plain version from the plain version run in float64, and
the kernel's time (CUDA events, mean of ``--reps`` calls).  ``--src`` takes
the ``src`` directory of another checkout (a ``git archive`` of a parent
commit), so that two versions of the kernel are measured in one run on one
card.  One JSON line per case; exits non-zero
if any case is non-finite or out of bounds.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (name, B, H, S, hd)
CASES = [("rwkv_prefill", 4, 40, 2048, 64), ("small_ragged", 2, 3, 100, 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this check needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(REPO))
    from chip_smoke import WKV_ROW_REL_TOL, WKV_TOL, nvidia_smi_line, row_rel_err, wkv_inputs
    from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    dev = torch.device("cuda")
    card = f"[{nvidia_smi_line()}]"
    ok = True
    for name, B, H, S, hd in CASES:
        for strong in (False, True):
            inputs = wkv_inputs(dev, B, H, S, hd, strong=strong)
            got = wkv6_kernel(*inputs)
            want = wkv6_ref(*inputs)
            torch.cuda.synchronize()
            res = {"case": name, "shape": [B, H, S, hd],
                   "inputs": "strong decays" if strong else "reference"}
            for what, o, r in (("out", got[0], want[0]), ("S_last", got[1], want[1])):
                bad = int((~torch.isfinite(o)).sum())
                fin = torch.isfinite(o)
                err = (o[fin] - r[fin]).abs().max().item() if fin.any() else float("nan")
                res[what] = {"non_finite": bad, "of": o.numel(), "max_abs_err_finite": err,
                             "row_rel_err": row_rel_err(o, r)}
                ok &= (bad == 0 and bool(torch.allclose(o, r, rtol=WKV_TOL, atol=WKV_TOL))
                       and res[what]["row_rel_err"] <= WKV_ROW_REL_TOL)
            ref64 = wkv6_ref(*(t.double() for t in inputs))
            res["vs_fp64"] = {
                f"{who} {what}": (o.double() - r64).abs().max().item()
                for who, pair in (("kernel", got), ("fp32 plain", want))
                for what, o, r64 in (("out", pair[0], ref64[0]), ("S_last", pair[1], ref64[1]))}
            del ref64
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                wkv6_kernel(*inputs)
            end.record()
            end.synchronize()
            res["ms"] = start.elapsed_time(end) / args.reps
            print(json.dumps(res), card, flush=True)
    print(f"all finite and within {WKV_TOL} / row {WKV_ROW_REL_TOL}: {ok} (src {args.src})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
