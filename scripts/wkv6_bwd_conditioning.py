#!/usr/bin/env python3
"""How far WKV-6's dlogw lands from a float64 run, by the form and the
precision it is computed in: the readings behind ``csrc/wkv6_bwd.cu``'s
choice of float64 sweeps.  CPU only, plain PyTorch, ~1 min:

    PYTHONPATH=src python3 scripts/wkv6_bwd_conditioning.py [--heads 8] [--seq 2048]

Inputs: the reference's test distribution (r, k, v, dout normal, decay
uniform in (0.7, 0.999), u * 0.3), B=1, hd=64, no cotangent of S_last.
Each row prints the largest absolute error of dlogw against
``wkv6_bwd_ref`` in float64 and the largest excess of an element's error
over ``allclose(rtol=2e-4, atol=2e-4)``'s allowance (positive: it fails
the bound):

* the running-sum form (``sum_{t>tau} r drs - sum_{t>=tau} k dks``) with
  the states S, G and the products drs = S dout, dks = G v each in fp32 or
  fp64, the sums in fp64;
* ``wkv6_bwd_ref`` in fp32 (the per-token product ``w_t sum_j G_t S_{t-1}``,
  the plain version the kernel is held against);
* ``wkv6_bwd_segmented_ref`` in fp32 (the kernel's scheme: fp32 segment
  states, fp64 sweeps, the sums restarted at every 256-token segment end).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.rwkv6.kernel import SEGMENT  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_bwd_segmented_ref  # noqa: E402


def running_sum_dlogw(r, k, v, logw, dout, state_dt, prod_dt):
    """dlogw by the running sums, states in ``state_dt``, drs / dks in
    ``prod_dt``, the sums in fp64."""
    B, H, S, hd = r.shape
    w = torch.exp(logw).to(state_dt)
    ks, vs, rs, ds = (x.to(state_dt) for x in (k, v, r, dout))
    state = torch.zeros(B, H, hd, hd, dtype=state_dt)
    drs = torch.empty(B, H, S, hd, dtype=prod_dt)
    for t in range(S):
        drs[:, :, t] = torch.einsum("bhij,bhj->bhi", state.to(prod_dt), dout[:, :, t].to(prod_dt))
        state = w[:, :, t, :, None] * state + ks[:, :, t, :, None] * vs[:, :, t, None, :]
    G = torch.zeros(B, H, hd, hd, dtype=state_dt)
    dks = torch.empty_like(drs)
    for t in range(S - 1, -1, -1):
        dks[:, :, t] = torch.einsum("bhij,bhj->bhi", G.to(prod_dt), v[:, :, t].to(prod_dt))
        G = w[:, :, t, :, None] * G + rs[:, :, t, :, None] * ds[:, :, t, None, :]
    a = (r.to(prod_dt) * drs).double()
    b = (k.to(prod_dt) * dks).double()
    suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2])   # noqa: E731
    after = torch.nn.functional.pad(suffix(a)[:, :, 1:], (0, 0, 0, 1))
    return after - suffix(b)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    B, H, S, hd = 1, args.heads, args.seq, 64
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(B, H, S, hd, generator=g) for _ in range(3))
    logw = torch.log(0.7 + 0.299 * torch.rand(B, H, S, hd, generator=g))
    u = 0.3 * torch.randn(H, hd, generator=g)
    dout = torch.randn(B, H, S, hd, generator=g)
    want = wkv6_bwd_ref(*(x.double() for x in (r, k, v, logw, u, dout)))[3]

    def report(name, got):
        err = (got.double() - want).abs()
        excess = (err - 2e-4 - 2e-4 * want.abs()).max().item()
        print(f"  {name:<58} max |err| {err.max().item():.3e}, allclose(2e-4) excess "
              f"{excess:+.3e}")

    print(f"dlogw against float64, B={B} H={H} S={S} hd={hd} (max |dlogw| "
          f"{want.abs().max().item():.1f}):")
    f32, f64 = torch.float32, torch.float64
    for sd, pd in ((f32, f32), (f32, f64), (f64, f32), (f64, f64)):
        report(f"running sums, states {str(sd)[6:]}, products {str(pd)[6:]}",
               running_sum_dlogw(r, k, v, logw, dout, sd, pd))
    report("wkv6_bwd_ref, fp32 (per-token product)", wkv6_bwd_ref(r, k, v, logw, u, dout)[3])
    report(f"wkv6_bwd_segmented_ref, fp32 (the kernel's scheme, L={SEGMENT})",
           wkv6_bwd_segmented_ref(r, k, v, logw, u, dout, None, SEGMENT)[3])


if __name__ == "__main__":
    main()
