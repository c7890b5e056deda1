#!/usr/bin/env python3
"""The bf16 flash backward's precision steps, emulated on the CPU.

    PYTHONPATH=src python3 scripts/flash_bwd_emulation.py [--scan-s 2048]

``attention_bwd_emulated`` (kernels/flash_attention/ref.py) models the bf16
kernels' rounding points; this holds it against the fp32 plain backward
(``attention_bwd_ref`` on the same bf16 values upcast) under the card's bf16
bounds (2e-2 elementwise, 0.1 of a row's rms over rows whose rms reaches
1e-3 of the tensor's), at chip_smoke.py phase 15(a)'s inputs cut to S=512:

* D's route: from the bf16 output alone; from o + o_res of a forward whose
  P v rounds P once; the kernels' (P's residual product too);
* dk / dv's residual products on and off, by the kernels' rule and at
  groups of 16, 32 and 48 query heads on one kv head (S = --scan-s).

One JSON line per reading: the largest per-row error and elementwise error
of dq, dk, dv, and the bounds missed.  No card, no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan-s", type=int, default=2048)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(1, str(REPO))
    import torch

    from chip_smoke import FA_BWD_CASES, FA_BWD_ROW_FLOOR, fa_bwd_inputs, row_rel_err
    from repro_torch.kernels.flash_attention.ref import attention_bwd_emulated, attention_bwd_ref

    def reading(label, case, got, want):
        res, missed = {"reading": label, "case": case}, []
        for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
            err = (g.float() - w).abs().max().item()
            rel = row_rel_err(g, w, floor=FA_BWD_ROW_FLOOR)
            res[f"{name}_max_abs_err"], res[f"{name}_row_rel_err"] = err, rel
            if not torch.allclose(g.float(), w, rtol=2e-2, atol=2e-2):
                missed.append(f"{name} elementwise")
            if rel > 0.1:
                missed.append(f"{name} per row")
        print(json.dumps({**res, "missed": missed}), flush=True)

    cpu = torch.device("cpu")
    cases = {c[0]: c[1:] for c in FA_BWD_CASES}
    routes = {"d_from_bf16_o": {"o_residual": False, "p_residual": False},
              "d_from_o_plus_o_res_p_rounded_once": {"p_residual": False},
              "kernels": {}, "kernels_without_residual_products": {"residual": False}}
    for name in ("granite_train", "gemma2_local", "gemma2_global", "granite20b_mqa"):
        B, H, KV, S, hd, causal, window, cap = cases[name]
        S, window, B = 512, min(window, 256), 1
        q, k, v, do = fa_bwd_inputs(cpu, B, H, KV, S, hd, cap, torch.bfloat16)
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, do)), causal, window, cap)
        for label, kw in routes.items():
            reading(label, f"{name} S=512", attention_bwd_emulated(q, k, v, do, causal, window, cap,
                                                                   **kw), want)
    for group in (16, 32, 48):
        q, k, v, do = fa_bwd_inputs(cpu, 1, group, 1, args.scan_s, 128, 0.0, torch.bfloat16)
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, do)), True, 0, 0.0)
        for residual in (False, True):
            reading(f"residual_products_{'on' if residual else 'off'}",
                    f"group {group}/1 S={args.scan_s} hd 128",
                    attention_bwd_emulated(q, k, v, do, residual=residual), want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
