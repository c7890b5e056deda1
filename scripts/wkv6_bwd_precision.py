#!/usr/bin/env python3
"""The WKV-6 backward kernel (``csrc/wkv6_bwd.cu``, float64 sweeps) beside
the two fp32 designs tried in its place and not kept, each against the
plain version on one NVIDIA GPU:

    python3 scripts/wkv6_bwd_precision.py     # from the repo root; one card, nvcc

* ``scripts/wkv6_bwd_chunked.cu``: the chunked pair form in fp32, its
  products on the tensor cores in three TF32 terms; it takes the port's C
  interface with its own scratch, and :func:`chunked_record_bwd` calls it
  (``chip_smoke.py`` phase 18(b) times it beside the port's kernel the same
  way);
* ``scripts/wkv6_bwd_fp32.cu``: the fp32 running sums.  It takes the port's
  C interface plus two arguments: ``restart`` (its fp32 sweeps restart
  dlogw's sums every ``restart`` = ``RESTART`` tokens) and ``strong_logw`` (a
  (b, h, segment) where some token has more than half its channels' log
  decay below it sweeps in float64, any other in fp32).  It runs at three
  settings: ``-inf`` (every segment fp32), ``STRONG_LOGW`` (the hybrid) and
  ``inf`` (every segment float64).

At each of ``chip_smoke.py``'s ``WKV_BWD_CASES`` every kernel is held
against ``wkv6_bwd_ref`` in fp32 with phase 18(a)'s bounds (every element
within ``allclose(2e-4, 2e-4)``, every row above 1e-3 of the tensor's rms
within 1e-3 of its rms; ``missed`` lists what fails), two calls must give
the same bits, and at rwkv6-3b's training shape (every decay range) dlogw
is also read against the float64 plain version and each is timed (median of
21 calls queued back to back) with each of its passes (``torch.profiler``,
the mean of 5 calls' launches).  Prints each kernel's ptxas report
(registers, spills), then one JSON line per case, then the card's name and
power limit.  Exits 0 when every launch ran, whatever the bounds say (the
readings are the result).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NAMES = ("dr", "dk", "dv", "dlogw", "du")
RESTART = 64         # the fp32 sweeps restart dlogw's sums every RESTART tokens (divides SEGMENT)
STRONG_LOGW = -2.0   # the hybrid's threshold, the forward's strong-decay one
CHUNKED_BLOCK = 128  # tokens per block of the chunked kernel (its kBlock)


def chunked_record_bwd(fn, r, k, v, logw, u, seg_state, dout, ds_last):
    """The chunked fp32 kernel (``scripts/wkv6_bwd_chunked.cu``, entry point
    ``fn``) on [B,H,S,hd] fp32 inputs with the forward's ``seg_state``, with
    its own scratch (G at the end of every 128-token block and the blocks'
    decays, du's block parts, fp32) and outputs in the inputs' strides: (dr,
    dk, dv, dlogw, du)."""
    import torch

    from repro_torch.kernels.rwkv6.kernel import SEGMENT

    B, H, S, hd = r.shape
    n_blk = -(-S // CHUNKED_BLOCK)
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = [torch.empty_like(t) for t in (r, k, v, logw)]
    du = torch.empty(H, hd, **f32)
    scratch = (torch.empty(B, H, n_blk - 1, hd, hd, **f32), torch.empty(B, H, n_blk - 1, hd, **f32),
               torch.empty(B, H, n_blk, hd, **f32))
    strides = (ctypes.c_longlong * 28)(
        *(s for t in (r, k, v, logw, dout, *grads) for s in t.stride()[:3]), u.stride(0))
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(hd, *(ptr(t) for t in (r, k, v, logw, u, dout, ds_last, seg_state, *grads, du,
                                    *scratch)), B, H, S, SEGMENT, strides, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd_chunked launch failed (cudaError {err})")
    return (*grads, du)


def load_record(source: str, n_ptr: int, extra=()):
    """A record under ``scripts/`` built with the port's flags (``_build``,
    into ``_build/``): its ``repro_wkv6_bwd`` with ``n_ptr`` pointers and
    ``extra`` arguments before the strides, and its ptxas report."""
    from repro_torch.kernels import _build

    lib = _build.load_library(source, REPO / "scripts")
    fn = lib.repro_wkv6_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + list(extra)
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    log = _build.library_path(source, REPO / "scripts").with_suffix(".log").read_text()
    return fn, log


def load_chunked_record():
    return load_record("wkv6_bwd_chunked.cu", 16)


def attempt_bwd(fn, r, k, v, logw, u, seg_state, dout, ds_last, strong_logw):
    """The fp32 running-sum design's backward on dense [B,H,S,hd] fp32
    inputs, with its scratch and outputs: (dr, dk, dv, dlogw, du)."""
    import torch

    from repro_torch.kernels.rwkv6.kernel import SEGMENT

    B, H, S, hd = r.shape
    n_seg = max(1, -(-S // SEGMENT))
    f32 = dict(dtype=torch.float32, device=r.device)
    f64 = dict(dtype=torch.float64, device=r.device)
    grads = [torch.empty_like(t) for t in (r, k, v, logw)]
    du = torch.empty(H, hd, **f32)
    scratch = (torch.empty(B, H, n_seg - 1, hd, hd, **f32),             # gstate
               torch.empty(B, H, n_seg - 1, hd, **f32),                 # gdecay
               torch.empty(B, H, n_seg, SEGMENT // RESTART, hd, hd, **f32),   # S at restarts
               torch.empty(B, H, S, hd, **f64),                         # a_t
               torch.empty(B, H, n_seg, hd, **f64),                     # du's segment sums
               torch.empty(B, H, n_seg, dtype=torch.uint8, device=r.device))  # strong
    strides = (ctypes.c_longlong * 28)(
        *(s for t in (r, k, v, logw, dout, *grads) for s in t.stride()[:3]), u.stride(0))
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(hd, *(ptr(t) for t in (r, k, v, logw, u, dout, ds_last, seg_state, *grads, du,
                                    *scratch)),
             B, H, S, SEGMENT, RESTART, strong_logw, strides, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd_fp32 launch failed (cudaError {err})")
    return (*grads, du)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(1, str(REPO))
    from chip_smoke import (FA_BWD_ROW_FLOOR, WKV_BWD_CASES, WKV_ROW_REL_TOL, WKV_TOL,
                            nvidia_smi_line, ptxas_report, row_rel_err, wkv_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

    dev = torch.device("cuda")
    card = f"[{nvidia_smi_line()}]"
    _build.build("wkv6_bwd.cu")
    record, record_log = load_chunked_record()
    attempt, log = load_record("wkv6_bwd_fp32.cu", 19, (ctypes.c_int, ctypes.c_float))
    for src, text in (("wkv6_bwd.cu", _build.library_path("wkv6_bwd.cu").with_suffix(".log")
                       .read_text()), ("wkv6_bwd_chunked.cu", record_log),
                      ("wkv6_bwd_fp32.cu", log)):
        for name, regs, spill in ptxas_report(text):
            print(f"ptxas {src} {name}: {regs}; {spill or 'no spill report'}")
    settings = {
        "port": lambda *a: wkv6_bwd_kernel(*a),
        "chunked": lambda *a: chunked_record_bwd(record, *a),
        "all_fp32": lambda *a: attempt_bwd(attempt, *a, float("-inf")),
        "hybrid": lambda *a: attempt_bwd(attempt, *a, STRONG_LOGW),
        "all_fp64": lambda *a: attempt_bwd(attempt, *a, float("inf")),
    }

    def median_ms(f, n=21):
        """Median over n calls queued back to back, each between its own two
        events (as chip_smoke.py's cuda_ms_median)."""
        f()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n)]
        for start, end in events:
            start.record()
            f()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(start.elapsed_time(end) for start, end in events)

    def per_pass(f, n=5):
        f()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                f()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "wkv6_bwd_" in e.name:
                kind = e.name.split("wkv6_bwd_")[1].split("(")[0]
                split.setdefault(kind, []).append(e.time_range.elapsed_us() / 1e3)
        return {kind: [len(ms), statistics.mean(ms)] for kind, ms in split.items()}

    for name, B, H, S, hd, strong, with_ds in WKV_BWD_CASES:
        x = wkv_inputs(dev, B, H, S, hd, strong=strong)
        g = torch.Generator(device=dev).manual_seed(1)
        dout = torch.randn(B, H, S, hd, generator=g, device=dev)
        ds = torch.randn(B, H, hd, hd, generator=g, device=dev) if with_ds else None
        _, _, seg_state = wkv6_kernel(*x, with_states=True)
        main = name.startswith("rwkv_train")
        want = wkv6_bwd_ref(*x, dout, ds)
        want64 = wkv6_bwd_ref(*(a.double() for a in x), dout.double())[3] if main else None
        res = {"case": name, "B": B, "H": H, "S": S, "hd": hd, "strong": strong,
               "ds_last": with_ds}
        for setting, run in settings.items():
            def call():
                return run(*x, seg_state, dout, ds)

            got, again = call(), call()
            torch.cuda.synchronize()
            r = {"bit_identical": all(torch.equal(a, b) for a, b in zip(got, again))}
            missed = []
            for gname, a, w in zip(NAMES, got, want):
                r[f"{gname}_max_abs_err"] = (a - w).abs().max().item()
                r[f"{gname}_row_rel_err"] = row_rel_err(a, w, floor=FA_BWD_ROW_FLOOR)
                if not torch.allclose(a, w, rtol=WKV_TOL, atol=WKV_TOL):
                    missed.append(f"{gname} allclose")
                if not r[f"{gname}_row_rel_err"] <= WKV_ROW_REL_TOL:
                    missed.append(f"{gname} per row")
            r["missed"] = missed
            if main:
                r["dlogw_vs_fp64"] = (got[3].double() - want64).abs().max().item()
                r["dlogw_row_rel_vs_fp64"] = row_rel_err(got[3], want64, floor=FA_BWD_ROW_FLOOR)
                del got, again
                r["ms"] = median_ms(call)
                r["passes_ms"] = per_pass(call)
            res[setting] = r
        print(json.dumps(res), card, flush=True)
        del x, dout, ds, seg_state, want, want64
        torch.cuda.empty_cache()
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
