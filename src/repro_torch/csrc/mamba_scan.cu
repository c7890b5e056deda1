// Selective scan (Mamba-1 SSM core) forward for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel `mamba_scan_kernel`
// (src/repro/kernels/mamba/kernel.py:61, body `_mamba_kernel` :25).  Per
// batch row b and channel c, with an fp32 state h [N] starting from zero:
//     h_t = exp(dt_t * A_c) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = C_t . h_t + D_c * x_t
// returning y [B,S,di] and h_last [B,di,N], both fp32.  The decay and the
// input term are formed here, so the [B,S,di,N] tensors of the jnp model
// never exist.
//
// What bounds it on this card: at the jamba prefill shape (B=4, S=2048,
// di=8192, N=16, x in bf16) the call reads dt (fp32) and x once and writes y
// (fp32), ~0.67 GB, 0.20 ms at 3.35 TB/s, and does ~1.07e9 state updates of
// one expf and ~6 fp32 operations each, ~0.11 ms at 67 TFLOP/s.  So it is
// bytes-bound in principle; in practice the recurrence is serial in t, and
// B*di = 32768 threads are ~8 warps per SM, so the kernel is latency-bound.
// The design keeps it simple and exact:
//   * one thread per (b, channel): h[N] and the row of A live in registers,
//     so the state never leaves the thread;
//   * blocks of 128 channels; a loop over chunks of 32 tokens inside the
//     block takes the place of the TPU's sequential grid axis.  Each chunk's
//     dt and x are staged in shared memory (32 independent loads in flight
//     per thread, each a coalesced 512-byte row per block), B and C ([32, N])
//     once per block and read as broadcasts;
//   * any S: the last chunk is short (the TPU kernel asserts S % chunk == 0);
//     channels past di (di not a multiple of 128) compute nothing and store
//     nothing;
//   * x, B and C come in bf16 or fp32 as the model holds them, B and C as
//     strided views of the x_proj output (row stride R + 2N), so nothing is
//     copied or cast before the call;
//   * accurate expf and fp32 FMAs: the parity bound is 2e-4.
// Splitting N across lanes (more warps in flight) and prefetching the next
// chunk are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block, one thread each
constexpr int kT = 32;          // tokens per staged chunk

struct Params {
  const float* dt;
  const void* x;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  float* y;
  float* h_last;
  int B, S, di;
  long long dt_sb, dt_ss;      // strides in elements; the channel dim is unit-stride
  long long x_sb, x_ss;
  long long b_sb, b_ss, b_sn;
  long long c_sb, c_ss, c_sn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) mamba_scan_fwd(const Params p) {
  // dt and x: each thread reads back only its own column, so these two need
  // no barrier; B and C are shared by the whole block.  Register arrays in
  // place of s_dt / s_x would need the token loop fully unrolled (32 x N
  // expf bodies); that version measured 2x slower on the H100.
  __shared__ float s_dt[kT][kThreads];
  __shared__ float s_x[kT][kThreads];
  __shared__ float s_b[kT][N];
  __shared__ float s_c[kT][N];

  const int tid = threadIdx.x, bi = blockIdx.y;
  const int ch = blockIdx.x * kThreads + tid;
  const bool active = ch < p.di;
  const float* dt = p.dt + bi * p.dt_sb + ch;
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + ch;
  const T* bc = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cc = static_cast<const T*>(p.c) + bi * p.c_sb;
  float* y = p.y + (long long)bi * p.S * p.di + ch;

  float a_row[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_row[n] = active ? p.A[(long long)ch * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float d_skip = active ? p.D[ch] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += kT) {
    const int len = min(kT, p.S - t0);
#pragma unroll 8
    for (int tt = 0; tt < kT; ++tt) {
      float dv = 0.f, xv = 0.f;
      if (active && tt < len) {
        const long long pos = t0 + tt;
        dv = dt[pos * p.dt_ss];
        xv = to_float(x[pos * p.x_ss]);
      }
      s_dt[tt][tid] = dv;
      s_x[tt][tid] = xv;
    }
    for (int e = tid; e < kT * N; e += kThreads) {
      const int tt = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (tt < len) {
        const long long pos = t0 + tt;
        bv = to_float(bc[pos * p.b_ss + n * p.b_sn]);
        cv = to_float(cc[pos * p.c_ss + n * p.c_sn]);
      }
      s_b[tt][n] = bv;
      s_c[tt][n] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < len; ++tt) {
      const float dtv = s_dt[tt][tid], xv = s_x[tt][tid];
      const float dtx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(expf(dtv * a_row[n]), h[n], dtx * s_b[tt][n]);
        acc = fmaf(h[n], s_c[tt][n], acc);
      }
      if (active) y[(long long)(t0 + tt) * p.di] = fmaf(d_skip, xv, acc);
    }
    __syncthreads();          // every read of this chunk's B and C is done
  }

  if (active) {
    float* h_out = p.h_last + ((long long)bi * p.di + ch) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[n] = h[n];
  }
}

template <int N, typename T>
int launch(const Params& p, cudaStream_t stream) {
  dim3 grid((p.di + kThreads - 1) / kThreads, p.B);
  mamba_scan_fwd<N, T><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(int x_dtype, const Params& p, cudaStream_t stream) {
  switch (x_dtype) {
    case 0: return launch<N, float>(p, stream);
    case 1: return launch<N, __nv_bfloat16>(p, stream);
  }
  return -1;
}

}  // namespace

// dt: [B,S,di] fp32; x: [B,S,di] fp32 (x_dtype 0) or bf16 (1), both with a
// unit-stride channel dim; A: contiguous [di,N] fp32; Bc, Cc: [B,S,N] in x's
// dtype, any strides; D: [di] fp32; y: contiguous [B,S,di] fp32; h_last:
// contiguous [B,di,N] fp32.  strides: (b, s) of dt and x, then (b, s, n) of
// Bc and Cc.  Returns 0 or the CUDA error of the launch; -1 for a state size
// or dtype without an instantiation.
extern "C" int repro_mamba_scan_fwd(int d_state, int x_dtype, const void* dt, const void* x,
                                    const void* A, const void* Bc, const void* Cc,
                                    const void* D, void* y, void* h_last, int B, int S,
                                    int di, const long long* strides, void* stream) {
  Params p{static_cast<const float*>(dt), x, static_cast<const float*>(A), Bc, Cc,
           static_cast<const float*>(D), static_cast<float*>(y),
           static_cast<float*>(h_last), B, S, di,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4: return launch_n<4>(x_dtype, p, st);
    case 8: return launch_n<8>(x_dtype, p, st);
    case 16: return launch_n<16>(x_dtype, p, st);
  }
  return -1;
}
