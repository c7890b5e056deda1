// WKV-6 (RWKV-6 "Finch" time mix) forward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `wkv6_kernel`
// (src/repro/kernels/rwkv6/kernel.py:82, body `_wkv_kernel` :36).  Per head,
// with an fp32 state S [hd, hd] starting from zero:
//     out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//     S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// returning out [B,H,S,hd] and S_last [B,H,hd,hd], both fp32.
//
// The chunk form of the reference, chunks of T = 32 tokens:
//     clw   = inclusive cumsum of logw over the chunk, per channel
//     rt    = r * exp(clw - logw),  kt = k * exp(-clw)
//     out   = (tril_strict(rt kt^T) + diag(sum_i r u k)) v + rt S
//     S     = diag(exp(clw_T)) S + (k * exp(clw_T - clw))^T v
// The exponents are re-based in every chunk, so exp() stays bounded by one
// chunk's decay; that bound grows exponentially with T, which is why T stays
// at the reference's 32 (PERF.md).
//
// What bounds it on this card: at the rwkv6-3b prefill shape (B=4, H=40,
// S=2048, hd=64) the call reads r, k, v, logw and writes out, 5 x 84 MB, and
// does ~24.6 kFLOP per token-head in the chunk form (8.05 GFLOP): 0.125 ms of
// bytes against 0.120 ms of fp32 CUDA-core operations, so both matter.  The
// parity bound (2e-4) rules out TF32 tensor cores, so all arithmetic is fp32
// FMAs.  The design:
//   * one 128-thread block per (b, h, slice of NC value columns); the
//     recurrence never mixes value columns, so the slices are exact and give
//     B*H*hd/NC blocks (320 at the prefill shape, for 132 SMs);
//   * a loop over the chunks inside the block takes the place of the TPU's
//     sequential grid axis; the state slice lives in registers (each thread
//     owns a fixed part) with a shared-memory mirror for the rt S product;
//   * r, k, logw are stored channel-major in shared memory, so a warp scans
//     one channel's 32 log decays with shuffles (lane = token) and every
//     product below reads rows of consecutive tokens;
//   * a ragged last chunk is loaded as k = v = logw = r = 0, which leaves
//     the state untouched, and rows past S are never written;
//   * the model's [B,S,H,hd] tensors come in as strided [B,H,S,hd] views.
// Making it fast (prefetching the next chunk, tensor cores where the bound
// allows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // tokens per chunk: one per lane of a warp
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;         // row padding (floats): keeps float4 alignment

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  float* out;
  float* s_last;
  int B, H, S;
  long long r_sb, r_sh, r_ss;   // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long o_sb, o_sh, o_ss;
  long long u_sh;
};

template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  static_assert(N % 2 == 0, "row fragments are float2 or float4 aligned");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + m);
      dst[m] = x.x; dst[m + 1] = x.y; dst[m + 2] = x.z; dst[m + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; m += 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + m);
      dst[m] = x.x; dst[m + 1] = x.y;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) wkv6_fwd(const Params p) {
  constexpr int NC = HD < 32 ? HD : 32;       // value columns per block
  constexpr int OUT_COLS = NC / 4;            // out: 4 threads per token row
  constexpr int TPR = kThreads / HD;          // state: threads per channel row
  constexpr int S_COLS = NC / TPR;            // state columns per thread
  constexpr int LD = kT + kPad;               // channel-major row length
  constexpr int LDV = NC + kPad;
  static_assert(kThreads % HD == 0 && NC % TPR == 0 && HD % kWarps == 0, "tiling");

  __shared__ __align__(16) float rt[HD][LD];  // r, then r * exp(clw - logw)
  __shared__ __align__(16) float kt[HD][LD];  // k, then k * exp(-clw)
  __shared__ __align__(16) float kd[HD][LD];  // logw, then k * exp(clw_T - clw)
  __shared__ __align__(16) float vs[kT][LDV]; // this block's value columns
  __shared__ __align__(16) float a[kT][LD];   // tril_strict(rt kt^T) + u-bonus diagonal
  __shared__ __align__(16) float sm[HD][LDV]; // mirror of the state slice
  __shared__ float dpart[kWarps][kT];         // u-bonus partial sums, one per warp
  __shared__ float etot[HD];                  // exp(clw_T) per channel

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j_base = blockIdx.x * NC, h = blockIdx.y, b = blockIdx.z;
  const float* r = p.r + b * p.r_sb + h * p.r_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh + j_base;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh;
  float* out = p.out + b * p.o_sb + h * p.o_sh + j_base;

  float u_reg[HD / kWarps];                   // u of the channels this warp scans
#pragma unroll
  for (int m = 0; m < HD / kWarps; ++m) u_reg[m] = p.u[h * p.u_sh + warp + kWarps * m];

  // State: thread owns row si, columns sj .. sj + S_COLS of the slice.
  const int si = tid / TPR, sj = (tid % TPR) * S_COLS;
  float s_reg[S_COLS];
#pragma unroll
  for (int m = 0; m < S_COLS; ++m) s_reg[m] = 0.f;
  for (int e = tid; e < HD * NC; e += kThreads) sm[e / NC][e % NC] = 0.f;

  // Token row of the a-tile and of the output fragment this thread computes.
  const int t = tid >> 2;
  const int s0 = (tid & 3) * 8;
  const int oj = (tid & 3) * OUT_COLS;

  const int n_chunks = (p.S + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kT;
    // ---- load the chunk: r, k, logw channel-major; v row-major; zeros past S.
    // A warp reads 16 tokens x 2 float4 (one 32-byte sector per row), so its
    // channel-major stores land on 32 distinct banks.
    for (int e = tid; e < kT * HD / 4; e += kThreads) {
      const int q = e >> 4;
      const int tt = (e & 15) + 16 * (q / (HD / 4)), i = (q % (HD / 4)) * 4, pos = t0 + tt;
      float4 rv = make_float4(0.f, 0.f, 0.f, 0.f), kv = rv, wv = rv;
      if (pos < p.S) {
        rv = *reinterpret_cast<const float4*>(r + pos * p.r_ss + i);
        kv = *reinterpret_cast<const float4*>(k + pos * p.k_ss + i);
        wv = *reinterpret_cast<const float4*>(lw + pos * p.w_ss + i);
      }
      rt[i][tt] = rv.x; rt[i + 1][tt] = rv.y; rt[i + 2][tt] = rv.z; rt[i + 3][tt] = rv.w;
      kt[i][tt] = kv.x; kt[i + 1][tt] = kv.y; kt[i + 2][tt] = kv.z; kt[i + 3][tt] = kv.w;
      kd[i][tt] = wv.x; kd[i + 1][tt] = wv.y; kd[i + 2][tt] = wv.z; kd[i + 3][tt] = wv.w;
    }
    for (int e = tid; e < kT * NC / 4; e += kThreads) {
      const int tt = e / (NC / 4), j = (e % (NC / 4)) * 4, pos = t0 + tt;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos < p.S) x = *reinterpret_cast<const float4*>(v + pos * p.v_ss + j);
      *reinterpret_cast<float4*>(&vs[tt][j]) = x;
    }
    __syncthreads();

    // ---- per-channel cumulative decay (warp scan, lane = token) and factors
    float diag = 0.f;
#pragma unroll
    for (int m = 0; m < HD / kWarps; ++m) {
      const int i = warp + kWarps * m;
      const float w = kd[i][lane];
      float x = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      const float total = __shfl_sync(0xffffffffu, x, 31);
      const float ri = rt[i][lane], ki = kt[i][lane];
      diag += ri * u_reg[m] * ki;
      rt[i][lane] = ri * expf(x - w);
      kt[i][lane] = ki * expf(-x);
      kd[i][lane] = ki * expf(total - x);
      if (lane == 0) etot[i] = expf(total);
    }
    dpart[warp][lane] = diag;
    __syncthreads();

    // ---- a[t][s] = rt_t . kt_s for s < t; the u-bonus on the diagonal
    {
      float acc[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m] = 0.f;
      if (s0 < t) {
#pragma unroll 8
        for (int i = 0; i < HD; ++i) {
          const float ri = rt[i][t];
          float kk[8];
          load_row(kk, &kt[i][s0]);
#pragma unroll
          for (int m = 0; m < 8; ++m) acc[m] = fmaf(ri, kk[m], acc[m]);
        }
      }
      float d = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) d += dpart[w][t];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int s = s0 + m;
        a[t][s] = s < t ? acc[m] : (s == t ? d : 0.f);
      }
    }
    __syncthreads();

    // ---- out = a v + rt S (old state); new state into registers
    {
      float acc[OUT_COLS];
#pragma unroll
      for (int m = 0; m < OUT_COLS; ++m) acc[m] = 0.f;
#pragma unroll 8
      for (int s = 0; s < kT; ++s) {
        const float as = a[t][s];
        float vv[OUT_COLS];
        load_row(vv, &vs[s][oj]);
#pragma unroll
        for (int m = 0; m < OUT_COLS; ++m) acc[m] = fmaf(as, vv[m], acc[m]);
      }
#pragma unroll 8
      for (int i = 0; i < HD; ++i) {
        const float ri = rt[i][t];
        float ss[OUT_COLS];
        load_row(ss, &sm[i][oj]);
#pragma unroll
        for (int m = 0; m < OUT_COLS; ++m) acc[m] = fmaf(ri, ss[m], acc[m]);
      }
      if (t0 + t < p.S) {
        float* o = out + (t0 + t) * p.o_ss + oj;
#pragma unroll
        for (int m = 0; m < OUT_COLS; m += 2)
          *reinterpret_cast<float2*>(o + m) = make_float2(acc[m], acc[m + 1]);
      }

      float upd[S_COLS];
#pragma unroll
      for (int m = 0; m < S_COLS; ++m) upd[m] = 0.f;
#pragma unroll 8
      for (int tt = 0; tt < kT; ++tt) {
        const float kk = kd[si][tt];
        float vv[S_COLS];
        load_row(vv, &vs[tt][sj]);
#pragma unroll
        for (int m = 0; m < S_COLS; ++m) upd[m] = fmaf(kk, vv[m], upd[m]);
      }
      const float e = etot[si];
#pragma unroll
      for (int m = 0; m < S_COLS; ++m) s_reg[m] = fmaf(e, s_reg[m], upd[m]);
    }
    __syncthreads();          // every read of sm and of the chunk's tiles is done
#pragma unroll
    for (int m = 0; m < S_COLS; ++m) sm[si][sj + m] = s_reg[m];
  }

  float* s_out = p.s_last + ((long long)b * p.H + h) * HD * HD + si * HD + j_base + sj;
#pragma unroll
  for (int m = 0; m < S_COLS; ++m) s_out[m] = s_reg[m];
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int NC = HD < 32 ? HD : 32;
  dim3 grid(HD / NC, p.H, p.B);
  wkv6_fwd<HD><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw: [B,H,S,hd] fp32 with unit-stride head dim; u: [H,hd] fp32;
// out: [B,H,S,hd] fp32 (strided); s_last: contiguous [B,H,hd,hd] fp32.
// strides: (b, h, s) of r, k, v, logw, out, then u's head stride.  Returns 0
// or the CUDA error of the launch; -1 for a head dim without an instantiation.
extern "C" int repro_wkv6_fwd(int head_dim, const void* r, const void* k, const void* v,
                              const void* logw, const void* u, void* out, void* s_last,
                              int B, int H, int S, const long long* strides, void* stream) {
  Params p{static_cast<const float*>(r), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<float*>(out),
           static_cast<float*>(s_last), B, H, S,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           strides[12], strides[13], strides[14], strides[15]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
  }
  return -1;
}
