#!/usr/bin/env python3
"""How far WKV-6's dlogw lands from a float64 run, by the form and the
precision it is computed in: the readings behind ``csrc/wkv6_bwd.cu``'s
float64 sweeps, and behind the two fp32 designs tried in their place and
not kept: the running sums (``scripts/wkv6_bwd_fp32.cu``) and the chunked
pair form (``scripts/wkv6_bwd_chunked.cu``, ``wkv6_bwd_chunked_ref``).  CPU
only, plain PyTorch, ~40 s (~4 min at ``--heads 40``):

    PYTHONPATH=src python3 scripts/wkv6_bwd_conditioning.py [--heads 8] [--seq 2048]

Inputs: B=1, hd=64, no cotangent of S_last; r, k, v, dout normal, u * 0.3,
on four decay ranges: the two ``chip_smoke.py`` phase 18 draws, the
reference's (uniform in (0.7, 0.999)) and strong ones (log-uniform in
[1e-3, 0.999], every 16th channel at log w = -50), log w uniform in
[STRONG_LOGW, log 0.999] (no decay the forward calls strong), and in every
token half the channels, at random, log-uniform in [1e-3,
exp(STRONG_LOGW)), the other half as the last range.  Each row prints, for
dlogw against ``wkv6_bwd_ref`` in float64 (and, for the kernels' schemes,
also against ``wkv6_bwd_ref`` in fp32, the comparison the card makes): the
largest absolute error, the largest excess of an element's error over
``allclose(rtol=2e-4, atol=2e-4)``'s allowance (positive: it fails the
bound), and the per-row error (max over rows of the row's largest error over
the row's rms, rows under 1e-3 of the tensor's rms left out, as
``chip_smoke.py``'s ``row_rel_err``; its bound there is 1e-3):

* the running-sum form over the whole sequence (``sum_{t>tau} r drs -
  sum_{t>=tau} k dks``) with the states S, G and the products drs = S dout,
  dks = G v each in fp32 or fp64, the sums in fp64 (the first two ranges);
* ``wkv6_bwd_ref`` in fp32 (the per-token product ``w_t sum_j G_t S_{t-1}``,
  the plain version the kernel is held against);
* the pair form, ``wkv6_bwd_chunked_ref`` in fp32 at chunks of 16 (the
  chunked kernel's), 32 and 64 tokens, with every gradient against the fp32
  plain version at 16; then at 16 with every product over j, i or the
  chunk's tokens split into TF32 terms as that kernel's tensor cores take
  them (``matmul_3xtf32``);
* ``wkv6_bwd_segmented_ref``, the kernel's scheme: float64 sweeps from the
  fp32 segment states, dlogw restarted at each segment's end;
* the fp32 running-sum design (:func:`fp32_sweeps_dlogw`): fp32 states,
  products and ``P_e = sum_j G_e * S_e``, fp64 running sums restarted every
  R tokens, R = 16 .. 256.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.rwkv6.kernel import SEGMENT  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (matmul_3xtf32, wkv6_bwd_chunked_ref,  # noqa: E402
                                           wkv6_bwd_ref, wkv6_bwd_segmented_ref)

RESTARTS = (16, 32, 64, 128, 256)
CHUNKS = (16, 32, 64)   # the pair form's chunk; the kernel's is 16
HEAD_GROUP = 2          # heads a call of the chunked form takes at once (its memory)
RANGES = ("reference", "strong", "weakest fp32", "half strong")
NAMES = ("dr", "dk", "dv", "dlogw", "du")
STRONG_LOGW = -2.0   # the forward's strong-decay threshold (csrc/wkv6.cu, wkv6_chunked_ref)


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


def fp32_sweeps_dlogw(r, k, v, logw, dout, segment, restart):
    """dlogw of the fp32 design, no cotangent of S_last: the kernel's split
    into segments (fp32 segment states, local G and its carry), then S
    forward and G in reverse in fp32, ``dlogw_tau = P_e + sum_{tau<t<=e}
    a_t - sum_{tau<=t<=e} b_t`` inside each block of ``restart`` tokens,
    ``P_e = sum_j G_e * S_e`` in fp32 at the block's end, the two running
    sums in fp64.  ``restart`` divides ``segment``."""
    B, H, S, hd = r.shape
    f32, f64 = torch.float32, torch.float64
    n = -(-S // segment)
    pad = n * segment - S

    def split(x):
        return torch.nn.functional.pad(x.to(f32), (0, 0, 0, pad)).reshape(B, H, n, segment, hd)

    r, k, v, logw, dout = (split(x) for x in (r, k, v, logw, dout))
    w = torch.exp(logw)
    zeros = torch.zeros(B, H, n, hd, hd, dtype=f32)
    end, local, gdecay = zeros, zeros, torch.ones(B, H, n, hd, dtype=f32)
    for t in range(segment):
        end = w[:, :, :, t, :, None] * end + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
    for t in range(segment - 1, -1, -1):
        local = w[:, :, :, t, :, None] * local + r[:, :, :, t, :, None] * dout[:, :, :, t, None, :]
        gdecay = gdecay * w[:, :, :, t]
    fdecay = torch.exp(logw.sum(dim=3))
    s_in, g_end = torch.empty_like(zeros), torch.empty_like(zeros)
    state, grad = zeros[:, :, 0], zeros[:, :, 0]
    for s in range(n):
        s_in[:, :, s] = state
        state = fdecay[:, :, s, :, None] * state + end[:, :, s]
    for s in range(n - 1, -1, -1):
        g_end[:, :, s] = grad
        grad = gdecay[:, :, s, :, None] * grad + local[:, :, s]
    state, drs = s_in, torch.empty_like(r)
    s_pt = torch.empty(B, H, n, segment // restart, hd, hd, dtype=f32)
    for t in range(segment):
        drs[:, :, :, t] = torch.einsum("bhsij,bhsj->bhsi", state, dout[:, :, :, t])
        state = w[:, :, :, t, :, None] * state + k[:, :, :, t, :, None] * v[:, :, :, t, None, :]
        if (t + 1) % restart == 0:
            s_pt[:, :, :, t // restart] = state
    a = r * drs
    G, dlogw = g_end, torch.empty_like(r)
    for t in range(segment - 1, -1, -1):
        if (t + 1) % restart == 0:
            p_e = (G * s_pt[:, :, :, t // restart]).sum(-1).to(f64)
            acc_a = acc_b = torch.zeros(B, H, n, hd, dtype=f64)
        dks = torch.einsum("bhsij,bhsj->bhsi", G, v[:, :, :, t])
        acc_b = acc_b + (k[:, :, :, t] * dks).to(f64)
        dlogw[:, :, :, t] = (p_e + (acc_a - acc_b)).to(f32)
        acc_a = acc_a + a[:, :, :, t].to(f64)
        G = w[:, :, :, t, :, None] * G + r[:, :, :, t, :, None] * dout[:, :, :, t, None, :]
    return dlogw.reshape(B, H, n * segment, hd)[:, :, :S]


def chunked(r, k, v, logw, u, dout, chunk, mm=torch.matmul):
    """``wkv6_bwd_chunked_ref`` in fp32, HEAD_GROUP heads at a time."""
    parts = [wkv6_bwd_chunked_ref(r[:, h:h + HEAD_GROUP], k[:, h:h + HEAD_GROUP],
                                  v[:, h:h + HEAD_GROUP], logw[:, h:h + HEAD_GROUP],
                                  u[h:h + HEAD_GROUP], dout[:, h:h + HEAD_GROUP], chunk=chunk,
                                  block=max(chunk, SEGMENT // 2), segment=SEGMENT, mm=mm)
             for h in range(0, r.shape[1], HEAD_GROUP)]
    return [torch.cat([p[n] for p in parts], dim=1 if n < 4 else 0) for n in range(5)]


def inputs(B, H, S, hd, decays):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(B, H, S, hd, generator=g) for _ in range(3))
    draw = torch.rand(B, H, S, hd, generator=g)
    if decays == "strong":
        lo, hi = math.log(1e-3), math.log(0.999)
        logw = lo + (hi - lo) * draw
        logw[..., 3::16] = -50.0
    elif decays in ("weakest fp32", "half strong"):
        logw = STRONG_LOGW + (math.log(0.999) - STRONG_LOGW) * draw
        if decays == "half strong":
            lo = math.log(1e-3)
            low = lo + (STRONG_LOGW - lo) * torch.rand(B, H, S, hd, generator=g)
            half = torch.rand(B, H, S, hd, generator=g).argsort(-1) < hd // 2
            logw = torch.where(half, low, logw)
    else:
        logw = torch.log(0.7 + 0.299 * draw)
    u = 0.3 * torch.randn(H, hd, generator=g)
    dout = torch.randn(B, H, S, hd, generator=g)
    return (r, k, v, logw, u), dout


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
    return f"max |err| {e[0]:.3e}, excess {e[1]:+.3e}, per row {e[2]:.3e}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    B, H, S, hd = 1, args.heads, args.seq, 64
    f32, f64 = torch.float32, torch.float64
    for decays in RANGES:
        x, dout = inputs(B, H, S, hd, decays)
        want64 = wkv6_bwd_ref(*(a.double() for a in x), dout.double())
        plain = wkv6_bwd_ref(*x, dout)
        print(f"{decays} decays, dlogw, B={B} H={H} S={S} hd={hd} "
              f"(max |dlogw| {want64[3].abs().max().item():.1f}):")
        if decays in ("reference", "strong"):
            for sd, pd in ((f32, f32), (f32, f64), (f64, f32), (f64, f64)):
                name = f"running sums, no restart, states {str(sd)[6:]}, products {str(pd)[6:]}"
                print(f"  {name:<62} vs fp64: "
                      + fmt(errors(running_sum_dlogw(*x[:4], dout, sd, pd), want64[3])))
        print(f"  {'wkv6_bwd_ref, fp32 (per-token product)':<62} vs fp64: "
              + fmt(errors(plain[3], want64[3])))
        for c in CHUNKS:
            got = chunked(*x, dout, c)
            print(f"  {f'pair form, fp32, chunk {c}':<62} vs fp64: {fmt(errors(got[3], want64[3]))}; "
                  f"vs fp32 plain: {fmt(errors(got[3], plain[3]))}")
            if c == CHUNKS[0]:
                print("    every gradient vs fp32 plain: " + "; ".join(
                    f"{n} {fmt(errors(g, w))}" for n, g, w in zip(NAMES, got, plain)))
                print("    every gradient vs fp64: " + "; ".join(
                    f"{n} {fmt(errors(g, w))}" for n, g, w in zip(NAMES, got, want64)))
        got = chunked(*x, dout, CHUNKS[0], matmul_3xtf32)
        print(f"  {f'pair form, chunk {CHUNKS[0]}, products 3xTF32':<62} vs fp64: "
              f"{fmt(errors(got[3], want64[3]))}; vs fp32 plain: {fmt(errors(got[3], plain[3]))}")
        print("    every gradient vs fp32 plain: " + "; ".join(
            f"{n} {fmt(errors(g, w))}" for n, g, w in zip(NAMES, got, plain)))
        print("    every gradient vs fp64: " + "; ".join(
            f"{n} {fmt(errors(g, w))}" for n, g, w in zip(NAMES, got, want64)))
        got = wkv6_bwd_segmented_ref(*x, dout, None, SEGMENT)
        print(f"  {'segmented as the kernel (float64 sweeps), R=' + str(SEGMENT):<62} "
              f"vs fp64: {fmt(errors(got[3], want64[3]))}; "
              f"vs fp32 plain: {fmt(errors(got[3], plain[3]))}")
        for R in RESTARTS:
            got = fp32_sweeps_dlogw(*x[:4], dout, SEGMENT, R)
            print(f"  {f'fp32 design, R={R}':<62} vs fp64: {fmt(errors(got, want64[3]))}; "
                  f"vs fp32 plain: {fmt(errors(got, plain[3]))}")


if __name__ == "__main__":
    main()
