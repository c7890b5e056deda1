#!/usr/bin/env python3
"""Where the chunked fp32 WKV-6 backward (``scripts/wkv6_bwd_chunked.cu``,
tried in place of the port's kernel and not kept) spends its time, on one
NVIDIA GPU:

    python3 scripts/wkv6_bwd_chunked_profile.py     # from the repo root; one card, nvcc

1. Builds a copy of the kernel with ``clock64()`` ticks around each phase of
   its chunk pass (``wkv6_bwd_chunks<64>``), runs it at rwkv6-3b's training
   shape (B=4, H=40, S=2048, hd=64, the reference's decays, 3 calls through
   ``wkv6_bwd_precision.chunked_record_bwd``) and prints, for the first 512
   blocks of the last call, the mean cycles a block spends in each phase by
   warp, first-half and second-half blocks apart (a second-half block walks
   the first half's chunks forward too).  Phase names: ``f_*`` the forward
   walk's steps (``land`` waits for the chunk and the block, ``prep`` the
   decays, ``update`` the state's product), ``b_*`` the backward walk's
   (``a_*`` phase A by role: the decays, S0 dout^T, Gc v^T, v dout^T or
   sum_j S0 Gc, the wait for the decays, the G update, (k suf) Gc; ``b_*``
   phase B: a channel's loads, its pair loops, F; ``*_rest`` the rest of a
   phase, ``b_land`` the wait at a chunk's start).  Then the same for two
   variants (``VARIANTS``): phase A with only S0 dout^T's warps working, and
   S0 dout^T and Gc v^T through one call site.
2. Counts the instructions of the unmodified kernel's ``wkv6_bwd_chunks<64>``
   by opcode (``cuobjdump -sass``).
3. A microbenchmark: the dependent latency of FFMA and of a shared-memory
   load, and ``mma.sync.m16n8k8`` TF32 cycles per product for one warp with
   1, 4 and 8 independent accumulators at 1 to 16 warps an SM.

Then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "scripts" / "wkv6_bwd_chunked.cu"
NB = 512          # blocks whose ticks are kept
NAMES = ("f_land", "f_prep", "f_sync", "f_update", "b_land", "b_phaseA_rest", "b_syncB",
         "b_phaseB_rest", None, "b_top", "a_prep", "a_x1", "a_x2", "a_vd|psig", "a_barwait",
         "a_gupd", "a_x3", "b_loads", "b_pairs", "b_F")
# (anchor, with ticks): T[k] gathers the cycles since the last tick
EDITS = [('  const FragAddr<HD> fa(lane);\n  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;\n', '  const FragAddr<HD> fa(lane);\n  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;\n  unsigned long long T[20] = {}; unsigned long long tc = clock64();\n  auto tick = [&](int k) { const unsigned long long n = clock64(); T[k] += n - tc; tc = n; };\n'),
    ('    land(f);\n    fill(f);\n', '    tick(9);\n    land(f);\n    fill(f);\n    tick(0);\n'),
    ('      s_dc[tid] = pre[kC - 1] * w[kC - 1];\n    }\n    __syncthreads();\n    state_update<HD, 8>(sacc, s_kt, V, s_dc, warp, lane, fa);\n  }', '      s_dc[tid] = pre[kC - 1] * w[kC - 1];\n    }\n    tick(1);\n    __syncthreads();\n    tick(2);\n    state_update<HD, 8>(sacc, s_kt, V, s_dc, warp, lane, fa);\n    tick(3);\n  }'),
    ('    land(step);\n    if (step > n_fwd) flush(t0 + kC);             // the chunk after this one, before the copies\n    fill(step);\n', '    tick(9);\n    land(step);\n    if (step > n_fwd) flush(t0 + kC);\n    fill(step);\n    tick(4);\n'),
    ('    }\n    __syncthreads();\n\n    // Phase B', '    }\n    tick(5);\n    __syncthreads();\n    tick(6);\n\n    // Phase B'),
    ('      state_store<HD, 4, true>(s_g, gacc, warp - 4, lane);    // G for the chunk before\n    }\n  }', '      state_store<HD, 4, true>(s_g, gacc, warp - 4, lane);    // G for the chunk before\n    }\n    tick(7);\n  }'),
    ('  if (tid < HD) p.du_part[(bh * p.n_blk + blk) * HD + tid] = du_acc;\n}', '  if (tid < HD) p.du_part[(bh * p.n_blk + blk) * HD + tid] = du_acc;\n  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n  if (HD == 64 && lin < 512 && lane == 0) for (int k2 = 0; k2 < 20; ++k2) g_prof[(lin * 8 + warp) * 20 + k2] = T[k2];\n}'),
    ('constexpr float kLog2e = 1.4426950408889634f;\n', 'constexpr float kLog2e = 1.4426950408889634f;\n__device__ unsigned long long g_prof[512 * 8 * 20];\n'),
    ('      bar_arrive(1, 192);\n', '      bar_arrive(1, 192);\n      tick(10);\n'),
    ('      tiles_store<HD, NT2>(s_x1, acc, warp * NT2, NTC, lane);\n', '      tiles_store<HD, NT2>(s_x1, acc, warp * NT2, NTC, lane);\n      tick(11);\n'),
    ('      tiles_store<HD, NT2>(s_x2, acc, (warp - 2) * NT2, NTC, lane);\n', '      tiles_store<HD, NT2>(s_x2, acc, (warp - 2) * NT2, NTC, lane);\n      tick(12);\n'),
    ('        if (half == 0) s_vd[t * kC + t] = acc2;\n', '        if (half == 0) s_vd[t * kC + t] = acc2;\n        tick(13);\n'),
    ('          if (half == 0) s_ruk[t] = acc2;\n        }\n', '          if (half == 0) s_ruk[t] = acc2;\n        }\n        tick(13);\n'),
    ("      bar_sync(1, 192);                          // the chunk's decays are in\n", '      bar_sync(1, 192);\n      tick(14);\n'),
    ('      state_update<HD, 4>(gacc, s_rt, DO, s_dc, warp - 4, lane, fa);   // G, the chunk before\n', '      state_update<HD, 4>(gacc, s_rt, DO, s_dc, warp - 4, lane, fa);\n      tick(15);\n'),
    ('      prod_am<HD, NT4, false>(xacc, s_kt, s_g, HD, (warp - 4) * NT4, NTC, lane, fa);  // (k suf) Gc\n', '      prod_am<HD, NT4, false>(xacc, s_kt, s_g, HD, (warp - 4) * NT4, NTC, lane, fa);\n      tick(16);\n'),
    ('        const float u = s_u[i];\n', '        const float u = s_u[i];\n        tick(17);\n'),
    ('          float x1[kC], vdd[kC];\n', '          tick(18);\n          float x1[kC], vdd[kC];\n'),
    ('          float x1[kC], x2[kC];\n', '          tick(18);\n          float x1[kC], x2[kC];\n'),
    ('      bar_sync(2, 128);\n', '      bar_sync(2, 128);\n      tick(19);\n')]
# Variants of the ticked source, each timed the same way: phase A with its
# other roles' work removed (only S0 dout^T's warps work; wrong outputs), and
# S0 dout^T and Gc v^T through one call site (4 warps on one instruction
# stream; the same outputs).
VARIANTS = {
    "S0 dout^T alone in phase A": [
        ("      prod_xmt<HD, NT2>(acc, V, s_g, (warp - 2) * NT2, NTC, fa);      // Gc v_t\n", ""),
        ("      if (warp == 2) {   // vd[s][s'] = v_s . dout_s'\n", "      if (false) {\n"),
        ("      } else {\n        for (int i = lane; i < HD; i += 32) {   // sum_j S0 Gc, row i\n",
         "      } else if (false) {\n        for (int i = lane; i < HD; i += 32) {\n"),
        ("      state_update<HD, 4>(gacc, s_rt, DO, s_dc, warp - 4, lane, fa);\n", ""),
        ("      prod_am<HD, NT4, false>(xacc, s_kt, s_g, HD, (warp - 4) * NT4, NTC, lane, fa);\n",
         ""),
    ],
    "S0 dout^T and Gc v^T at one call site": [
        ("""      bar_arrive(1, 192);
      tick(10);
      float acc[NT2][4] = {};
      prod_xmt<HD, NT2>(acc, DO, s0, warp * NT2, NTC, fa);
      tiles_store<HD, NT2>(s_x1, acc, warp * NT2, NTC, lane);
      tick(11);
    } else if (warp < 4) {
      float acc[NT2][4] = {};
      prod_xmt<HD, NT2>(acc, V, s_g, (warp - 2) * NT2, NTC, fa);      // Gc v_t
      tiles_store<HD, NT2>(s_x2, acc, (warp - 2) * NT2, NTC, lane);
      tick(12);
""", """      bar_arrive(1, 192);
      tick(10);
    }
    if (warp < 4) {
      const bool first = warp < 2;
      float acc[NT2][4] = {};
      prod_xmt<HD, NT2>(acc, first ? DO : V, first ? s0 : s_g, (warp & 1) * NT2, NTC, fa);
      tiles_store<HD, NT2>(first ? s_x1 : s_x2, acc, (warp & 1) * NT2, NTC, lane);
      if (first) tick(11); else tick(12);
    }
    if (warp >= 2 && warp < 4) {
"""),
        ("    } else {\n      bar_sync(1, 192);\n", "    } else if (warp >= 4) {\n      bar_sync(1, 192);\n"),
    ],
}
SHOWN = ("a_prep", "a_x1", "a_x2", "a_vd|psig", "a_barwait", "a_gupd", "a_x3", "b_land")
MICRO = r"""#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// NI independent accumulators, N iterations: cycles per MMA for this warp
template <int NI>
__global__ void mma_bench(float* out, long long* cyc, int n) {
  uint32_t a[4] = {0x3f800000u + threadIdx.x, 0x3f800000u, 0x3f800000u, 0x3f800000u}, b[2] = {0x3f800000u, 0x3f000000u};
  float d[NI][4] = {};
  long long t0 = clock64();
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(d[j], a, b);
  long long t1 = clock64();
  float s = 0; for (int j = 0; j < NI; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) cyc[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}
__global__ void ffma_chain(float* out, long long* cyc, int n) {
  float x = threadIdx.x, y = 1.0001f;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) { x = fmaf(x, y, 0.5f); x = fmaf(x, y, 0.5f); x = fmaf(x, y, 0.5f); x = fmaf(x, y, 0.5f); }
  long long t1 = clock64();
  out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void lds_chain(float* out, long long* cyc, int n) {
  __shared__ int buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) buf[i] = (i + 1) & 1023;
  __syncthreads();
  int p = threadIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) { p = buf[p]; p = buf[p]; p = buf[p]; p = buf[p]; }
  long long t1 = clock64();
  out[threadIdx.x] = p; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
int main() {
  float* out; long long* cyc; cudaMalloc(&out, 1 << 20); cudaMalloc(&cyc, 1 << 16);
  long long h[64]; const int n = 4096;
  ffma_chain<<<1, 32>>>(out, cyc, n); cudaMemcpy(h, cyc, 8, cudaMemcpyDeviceToHost);
  printf("FFMA dependent latency: %.2f cycles\n", h[0] / (4.0 * n));
  lds_chain<<<1, 32>>>(out, cyc, n); cudaMemcpy(h, cyc, 8, cudaMemcpyDeviceToHost);
  printf("LDS dependent latency: %.2f cycles\n", h[0] / (4.0 * n));
  for (int warps : {1, 4, 8, 16}) {
    mma_bench<1><<<1, 32 * warps>>>(out, cyc, n); cudaMemcpy(h, cyc, 8 * warps, cudaMemcpyDeviceToHost);
    printf("MMA tf32 m16n8k8, 1 chain/warp, %2d warps/SM: %.2f cycles per MMA per warp\n", warps, h[0] / (1.0 * n));
    mma_bench<4><<<1, 32 * warps>>>(out, cyc, n); cudaMemcpy(h, cyc, 8 * warps, cudaMemcpyDeviceToHost);
    printf("MMA tf32 m16n8k8, 4 chains/warp, %2d warps/SM: %.2f cycles per MMA per warp\n", warps, h[0] / (4.0 * n));
    mma_bench<8><<<1, 32 * warps>>>(out, cyc, n); cudaMemcpy(h, cyc, 8 * warps, cudaMemcpyDeviceToHost);
    printf("MMA tf32 m16n8k8, 8 chains/warp, %2d warps/SM: %.2f cycles per MMA per warp\n", warps, h[0] / (8.0 * n));
  }
  printf("err %s\n", cudaGetErrorString(cudaDeviceSynchronize()));
  return 0;
}
"""


def instrumented(out: Path, variant: str | None = None) -> Path:
    from repro_torch.kernels import _build

    src = SOURCE.read_text()
    for old, new in EDITS + VARIANTS.get(variant, []):
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once in {SOURCE.name}: {old[:60]!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int get_prof(void* dst) '
            '{ return cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof)); }\n')
    stem = "prof" if variant is None else f"prof{list(VARIANTS).index(variant)}"
    (out / f"{stem}.cu").write_text(src)
    lib = out / f"{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{stem}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(1, str(REPO))
    sys.path.insert(2, str(REPO / "scripts"))
    from chip_smoke import nvidia_smi_line, wkv_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6.kernel import wkv6_kernel
    from wkv6_bwd_precision import chunked_record_bwd, load_record

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    args = wkv_inputs(dev, 4, 40, 2048, 64)
    dout = torch.randn(4, 40, 2048, 64, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    seg_state = wkv6_kernel(*args, with_states=True)[2]
    argtypes = load_record("wkv6_bwd_chunked.cu", 16)[0].argtypes

    def profile(variant):
        lib = ctypes.CDLL(str(instrumented(Path(tmp.name), variant)))
        fn = lib.repro_wkv6_bwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for _ in range(3):
            chunked_record_bwd(fn, *args, seg_state, dout, None)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (NB * 8 * len(NAMES)))()
        if lib.get_prof(buf) != 0:
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        return np.array(buf, dtype=np.float64).reshape(NB, 8, len(NAMES))

    ticks = profile(None)
    for half, label in ((0, "first"), (1, "second")):
        sel = ticks[half::2]            # blocks alternate halves of a segment
        print(f"{label}-half blocks: mean cycles a block, warps 0-7")
        for k, name in enumerate(NAMES):
            if name is not None:
                print(f"  {name:14s}" + "".join(f"{x:9.0f}" for x in sel[:, :, k].mean(0)))
        print(f"  {'total':14s}" + "".join(f"{x:9.0f}" for x in sel.sum(2).mean(0)))
    for variant in VARIANTS:
        sel = profile(variant)[0::2]
        print(f"variant: {variant}; first-half blocks, mean cycles a block, warps 0-7")
        for name in SHOWN:
            print(f"  {name:14s}" + "".join(f"{x:9.0f}" for x in sel[:, :, NAMES.index(name)].mean(0)))
        print(f"  {'total':14s}" + "".join(f"{x:9.0f}" for x in sel.sum(2).mean(0)))

    path = _build.library_path("wkv6_bwd_chunked.cu", REPO / "scripts")
    _build.build("wkv6_bwd_chunked.cu", REPO / "scripts")
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    ops, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "wkv6_bwd_chunksILi64" in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*)", line)
            if m and m.group(1).split():
                toks = m.group(1).split()
                ops[(toks[1] if toks[0].startswith("@") else toks[0]).split(".")[0]] += 1
    print(f"wkv6_bwd_chunks<64>: {sum(ops.values())} instructions; by opcode: "
          + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)))

    (Path(tmp.name) / "micro.cu").write_text(MICRO)
    exe = Path(tmp.name) / "micro"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(exe), str(Path(tmp.name) / "micro.cu")], check=True)
    print(subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout, end="")
    print(nvidia_smi_line())
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
