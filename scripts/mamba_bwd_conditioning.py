#!/usr/bin/env python3
"""How far the selective scan's gradient lands from a float64 run, by the
order and precision it is computed in: the readings behind
``csrc/mamba_scan_bwd.cu``'s arithmetic.  CPU only, plain PyTorch, ~40 s
and ~2 GB:

    PYTHONPATH=src python3 scripts/mamba_bwd_conditioning.py [--batch 4] [--channels 256] \
        [--sum-channels 2048] [--width 8192 --width-seq 512]

Inputs: B x S=2048 x di channels, N=16, no cotangent of h_last (as in
training); x, B, C and dy normal, D = 1, on three decay ranges:

* reference init: dt = softplus(-4.6 + 0.5 normal) (the models' dt_bias is
  softplus^-1(0.01)), A = -(1 .. 16) on every channel (A_log = log(1 .. N));
* test distribution: dt = softplus(normal), A = -exp(0.5 normal), the draw
  ``chip_smoke.py`` phases 9 and 19 and the tests use;
* strong decays: dt log-uniform in [1e-2, 8], A = -(1 .. 16), so that
  exp(dt A) underflows to 0 in fp32 where dt A < -103 (the kernel's
  flush-to-zero ex2 already below -87).

Each row prints, for every gradient against ``mamba_scan_bwd_ref`` in
float64: the largest absolute error, the largest excess of an element's
error over ``allclose(rtol=2e-4, atol=2e-4)``'s allowance (positive: it
fails the bound), and the per-row error (max over rows of the row's largest
error over the row's rms, rows under 1e-3 of the tensor's rms left out, as
``chip_smoke.py``'s ``row_rel_err``; its bound there is 1e-3; dD is one row
per channel, so it has none):

* ``mamba_scan_bwd_ref`` in fp32 (its dA and dD sums in float64), the
  plain version the kernel is held against on the card;
* ``mamba_scan_bwd_chunked_ref`` in fp32, the kernel's order (chunk states,
  sub-chunk recompute, block partials), with dA's and dD's sums over each
  8-token sub-chunk in fp32 added into per-row totals in fp32 and in float64
  (the kernel's), each also against the fp32 plain version (the comparison
  the card makes).

dA's error grows with the number of rows it is read over (the worst of
di * N sums), so a second study takes dA alone at ``--sum-channels``
channels: its per-token terms g_t dt_t a_t h_{t-1} in fp32, summed over
the B*S tokens in reverse by five schemes, against ``mamba_scan_bwd_ref``
in float64.  dB and dC sum over the channels, so a third takes them at
jamba's ``--width`` (B=1, ``--width-seq`` tokens): their per-token terms
in fp32 (the kernel's decay), summed over the channels by three schemes,
against float64, and the kernel's scheme against the plain version's
(terms from ``exp``, one float64 sum).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.mamba.ref import (LOG2E, mamba_scan_bwd_chunked_ref,  # noqa: E402
                                           mamba_scan_bwd_ref, mamba_scan_lanes_ref)

RANGES = ("reference init", "test distribution", "strong decays")
NAMES = ("ddt", "dx", "dA", "dB", "dC", "dD")


def inputs(B, S, di, N, decays):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, di, generator=g)
    Bc, Cc, dy = (torch.randn(B, S, *s, generator=g) for s in ((N,), (N,), (di,)))
    tiled = -torch.arange(1, N + 1, dtype=torch.float32).repeat(di, 1)
    if decays == "reference init":
        dt = torch.nn.functional.softplus(-4.6 + 0.5 * torch.randn(B, S, di, generator=g))
        A = tiled
    elif decays == "test distribution":
        dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g))
        A = -torch.exp(0.5 * torch.randn(di, N, generator=g))
    else:
        lo, hi = torch.log(torch.tensor(1e-2)), torch.log(torch.tensor(8.0))
        dt = torch.exp(lo + (hi - lo) * torch.rand(B, S, di, generator=g))
        A = tiled
    return (dt, x, A, Bc, Cc, torch.ones(di)), dy


def errors(got, want):
    """(max |err|, allclose(2e-4) excess, per-row error) of got against want."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    excess = (err - 2e-4 - 2e-4 * want.abs()).max().item()
    if want.dim() < 2:
        return err.max().item(), excess, float("nan")
    rms = want.pow(2).mean(-1).sqrt()
    keep = rms >= 1e-3 * want.pow(2).mean().sqrt()
    row = (err.amax(-1)[keep] / rms[keep]).max().item()
    return err.max().item(), excess, row


def fmt(e):
    return f"{e[0]:.3e} / {e[1]:+.3e} / {e[2]:.3e}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--sum-channels", type=int, default=2048)
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--width-seq", type=int, default=512)
    args = ap.parse_args()
    B, S, di, N = args.batch, args.seq, args.channels, 16
    t0 = time.perf_counter()
    for decays in RANGES:
        x, dy = inputs(B, S, di, N, decays)
        a = torch.exp(x[0][..., None] * x[2])
        want64 = mamba_scan_bwd_ref(*(t.double() for t in x), dy.double())
        plain = mamba_scan_bwd_ref(*x, dy)
        _, _, states = mamba_scan_lanes_ref(*x, with_states=True)
        print(f"{decays}, B={B} S={S} di={di} N={N}: dt in [{x[0].min().item():.3g}, "
              f"{x[0].max().item():.3g}], exp(dt A) = 0 in fp32 on {(a == 0).float().mean().item():.2%}"
              " of state-tokens; max |grad| " + ", ".join(
                  f"{n} {w.abs().max().item():.3g}" for n, w in zip(NAMES, want64)))
        print("  max |err| / allclose(2e-4) excess / per-row error, against float64:")
        rows = [("mamba_scan_bwd_ref, fp32 (the plain version)", plain, None)]
        for acc in (torch.float32, torch.float64):
            got = mamba_scan_bwd_chunked_ref(*x, states, dy, acc_dtype=acc)
            rows.append((f"kernel order, fp32, dA / dD sub-chunk sums into {str(acc)[6:]}",
                         got, plain))
        for name, got, vs_plain in rows:
            print(f"    {name}:")
            for n, g_, w in zip(NAMES, got, want64):
                line = f"      {n:<4} vs fp64 {fmt(errors(g_, w))}"
                if vs_plain is not None:
                    line += f"; vs fp32 plain {fmt(errors(g_, vs_plain[NAMES.index(n)]))}"
                print(line)
    for decays in RANGES:
        dA_sums(B, S, args.sum_channels, N, decays)
    for decays in RANGES[1:]:
        channel_sums(args.width_seq, args.width, N, decays)
    print(f"({time.perf_counter() - t0:.1f} s)")


def channel_sums(S, di, N, decays) -> None:
    """dB's and dC's per-token terms g_t dt_t x_t and dy_t h_t in fp32,
    summed over the di channels by each scheme, against float64."""
    x, dy = inputs(1, S, di, N, decays)
    dt, xx, A, Bc, Cc, _ = x
    A2 = A * torch.tensor(LOG2E)
    per_warp = 32 // (N // 4)

    def run(kernel_decay):
        hs, h = [], torch.zeros(1, di, N)
        for t in range(S):
            hs.append(h)
            a = (torch.exp2(dt[:, t, :, None] * A2) if kernel_decay
                 else torch.exp(dt[:, t, :, None] * A))
            h = a * h + (dt[:, t] * xx[:, t])[:, :, None] * Bc[:, t, None, :]
        hs.append(h)
        g = torch.zeros(1, di, N)
        out = {k: torch.empty(2, 1, S, N, dtype=torch.float64)
               for k in ("fp32", "kernel", "float64")}
        for t in range(S - 1, -1, -1):
            g = g + dy[:, t, :, None] * Cc[:, t, None, :]
            a = (torch.exp2(dt[:, t, :, None] * A2) if kernel_decay
                 else torch.exp(dt[:, t, :, None] * A))
            for q, terms in enumerate((g * (dt[:, t] * xx[:, t])[:, :, None],
                                       dy[:, t, :, None] * hs[t + 1])):
                warps = terms.reshape(di // 128, 128 // per_warp, per_warp, N).sum(2)
                acc32 = torch.zeros(N)
                for blk in warps:
                    part = torch.zeros(N)
                    for w in blk:
                        part += w
                    acc32 += part
                out["fp32"][q, 0, t] = acc32.double()
                out["kernel"][q, 0, t] = warps.double().sum((0, 1))
                out["float64"][q, 0, t] = terms.double().sum(1)
            g = a * g
        return out

    got, plain = run(True), run(False)["float64"]
    truth = mamba_scan_bwd_ref(*(v.double() for v in x), dy.double())
    print(f"dB, dC over the channels, {decays}, B=1 S={S} di={di} N={N} (max |dB| "
          f"{truth[3].abs().max().item():.4g}): max |err| / allclose(2e-4) excess")
    for name, key in (("fp32 warps, blocks and their sum", "fp32"),
                      ("fp32 warps, then float64 (the kernel)", "kernel"),
                      ("one float64 sum", "float64")):
        eb, ec = errors(got[key][0], truth[3]), errors(got[key][1], truth[4])
        print(f"    {name:<40} vs float64: dB {fmt(eb)[:22]}, dC {fmt(ec)[:22]}")
    eb, ec = errors(got["kernel"][0], plain[0]), errors(got["kernel"][1], plain[1])
    print(f"    {'the kernel vs the plain version':<40}            dB {fmt(eb)[:22]}, "
          f"dC {fmt(ec)[:22]}")


def dA_sums(B, S, di, N, decays) -> None:
    """dA's per-token terms in fp32 (the kernel's decay and recurrence),
    summed over the B*S tokens in reverse by each scheme, against float64."""
    x, dy = inputs(B, S, di, N, decays)
    dt, xx, A, Bc, Cc, _ = x
    A2 = A * torch.tensor(LOG2E)
    hs, h = [], torch.zeros(B, di, N)
    for t in range(S):
        hs.append(h)
        h = (torch.exp2(dt[:, t, :, None] * A2) * h
             + (dt[:, t] * xx[:, t])[:, :, None] * Bc[:, t, None, :])
    g = torch.zeros(B, di, N)
    terms = torch.empty(S, B, di, N)
    for t in range(S - 1, -1, -1):
        g = g + dy[:, t, :, None] * Cc[:, t, None, :]
        a = torch.exp2(dt[:, t, :, None] * A2)
        terms[t] = g * (a * hs[t]) * dt[:, t, :, None]
        g = a * g
    del hs
    truth = mamba_scan_bwd_ref(*(v.double() for v in x), dy.double())[2]
    rev = terms.flip(0)

    def seq(tt, dtype):
        acc = torch.zeros(tt.shape[1:], dtype=dtype)
        for v in tt:
            acc += v.to(dtype)
        return acc.sum(0)

    def blocks(n):
        return rev.reshape(S // n, n, B, di, N).sum(1)

    print(f"dA alone, {decays}, B={B} S={S} di={di} N={N} (max |dA| "
          f"{truth.abs().max().item():.4g}): max |err| / allclose(2e-4) excess against float64")
    for name, got in (("fp32, sequential", seq(rev, torch.float32)),
                      ("fp32 sums of 8 tokens, into fp32", seq(blocks(8), torch.float32)),
                      ("fp32 sums of 64 tokens, into fp32", seq(blocks(64), torch.float32)),
                      ("fp32 sums of 8 tokens, into float64 (the kernel)",
                       seq(blocks(8), torch.float64)),
                      ("float64", seq(rev, torch.float64))):
        e = errors(got, truth)
        print(f"    {name:<50} {e[0]:.3e} / {e[1]:+.3e}")


if __name__ == "__main__":
    main()
