// Selective scan (Mamba-1 SSM core) backward for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// The gradient of mamba_scan.cu's forward, whose TPU kernel
// (src/repro/kernels/mamba/kernel.py:61) has no backward: the reference
// differentiates its jnp scan.  Per batch row b and channel c, with
// a_t = exp(dt_t A_c) and g_t the gradient of h_t (g past the last token is
// the cotangent of h_last, zero when it has none):
//     g_t   = a_{t+1} g_{t+1} + dy_t C_t
//     dC_t  = sum_c dy_t h_t                 dB_t = sum_c g_t dt_t x_t
//     ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//     dx_t  = D dy_t + dt_t sum_n g_t B_t
//     dA    = sum_{b,t} g_t dt_t a_t h_{t-1}  dD  = sum_{b,t} dy_t x_t
// Nothing divides by a_t (it underflows to 0 on strong decays): h is
// recomputed forward from the state the forward kept at the start of every
// kT-token chunk (mamba_scan.cu with states), never rebuilt backwards.
//
// What bounds it on this card, at jamba's training shape (B=4, S=2048,
// di=8192, N=16, x in bf16):
//   * bytes: dt, dy (fp32) and x read once, the chunk states (65 MB), ddt
//     (fp32) and dx written once: ~1.14 GB, 0.34 ms at 3.35 TB/s;
//   * operations: ~18 fp32 operations a state-token (the update of g, a h,
//     the five products and sums that feed ddt, dx, dA, dB, dC) and 8 a
//     channel-token: 0.30 ms at 67 TFLOP/s;
//   * exponentials: the special-function unit's 16 a clock per SM gives
//     0.26 ms for each pass over the B*S*di*N state-tokens; this design makes
//     two (the chunk's forward and each sub-chunk's recompute), >= 0.51 ms.
// The design, simple first:
//   * the forward's split: blocks of kCB = 128 channels of one batch row, a
//     lane owns 4 states of one channel (N/4 lanes a channel), so the sums
//     over n take N/4 lanes and dB / dC sum over the block's channels;
//   * chunks of kT = 64 tokens, last to first, each staged in shared memory
//     (dt, x, dy as fp32 rows of the block's channels; B and C per state
//     group).  A chunk runs forward once from its state, keeping h at the
//     start of each kSub-token sub-chunk in shared memory; each sub-chunk,
//     last to first, recomputes its tokens' a_t and h_{t-1} into registers
//     and sweeps back through them with g.  h_t is formed with the forward's
//     own fused multiply-add, so it is the forward's value;
//   * sums over channels without atomics: dB and dC per token by a
//     reduce-scatter of shuffles inside the warp (8 values over the warp's
//     channels), then over the block's warps in a fixed order, in float64,
//     into per-block partials [B,S,n_blocks,N]; dA and dD summed per lane over
//     its row's tokens, into per-row partials [B,di,N], [B,di]; a last pass
//     (mamba_scan_bwd_sum) adds the partials in block / row order.  Two
//     calls give the same bits;
//   * fp32, but for the long sums (scripts/mamba_bwd_conditioning.py:
//     against a float64 run the kernel's order stays 1.2e-4 inside
//     allclose(2e-4) and 30x inside the per-row bound on all three decay
//     ranges).  In fp32, dA summed over B*S = 8,192 tokens and dB / dC over
//     di = 8,192 channels miss the bound at jamba's width, so each lane sums
//     a sub-chunk's kSub tokens of dA and dD in fp32 and adds that into a
//     float64 total, kept in shared memory (the sweep is at its 128
//     registers), and dB / dC leave the warp in fp32 and are summed on in
//     float64: a few conversions and float64 adds a state per kSub tokens;
//   * ddt written in fp32, dx, dB and dC in an output type of their own
//     (the inputs' dtype for training; fp32 for the checks), converted only
//     at the store, so their fp32 values do not depend on it;
//   * any S (the padded tail of the last chunk has dt = dy = 0: a = 1 passes
//     g and h through unchanged and adds nothing) and any di (channels past
//     di compute on zeros and store nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCB = 128;        // channels per block
constexpr int kT = 64;          // tokens per chunk (the forward's states)
constexpr int kSub = 8;         // tokens per sub-chunk of the recompute
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* dt;
  const void* x;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  const float* states;         // [B,di,n_chunks-1,N]
  const float* dy;
  const float* dh_last;        // [B,di,N], or null: a zero cotangent
  float* ddt;                  // [B,S,di]
  void* dx;                    // [B,S,di] in the output type
  void* dB;                    // [B,S,N] in the output type
  void* dC;
  float* dA;                   // [di,N]
  float* dD;                   // [di]
  double* pB;                  // [B,S,n_blocks,N] partial sums of a block's channels
  double* pC;
  double* pA;                  // [B,di,N] partial sums of a row's tokens
  double* pD;                  // [B,di]
  int B, S, di;
  long long dt_sb, dt_ss;      // strides in elements; the channel dim is unit-stride
  long long x_sb, x_ss;
  long long b_sb, b_ss, b_sn;
  long long c_sb, c_ss, c_sn;
  long long dy_sb, dy_ss;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename O> __device__ __forceinline__ O from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The sum of v over the lanes of one state group (lanes g, g + L, ..., the
// warp's channels), as a reduce-scatter: lane ends with the sum of value
// 4 (lane & L) + 2 (lane & 2L) + (lane & 4L), each bit as 0 / 1, and lanes
// from 8L up hold copies.
template <int L>
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool h1 = lane & L, h2 = lane & (2 * L), h4 = lane & (4 * L);
  float w[4], u[2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (h1 ? v[4 + q] : v[q]) + __shfl_xor_sync(0xffffffffu, h1 ? v[q] : v[4 + q], L);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    u[q] = (h2 ? w[2 + q] : w[q]) + __shfl_xor_sync(0xffffffffu, h2 ? w[q] : w[2 + q], 2 * L);
  float s = (h4 ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, h4 ? u[0] : u[1], 4 * L);
#pragma unroll
  for (int m = 8 * L; m < 32; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The sum of v over the L lanes of one channel, in every one of them.
template <int L>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int m = 1; m < L; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <int N>
struct Smem {
  static constexpr int L = N / 4, NT = kCB * L, NW = NT / 32;
  static constexpr size_t DT = 0;                                          // float [kT][kCB]
  static constexpr size_t X = DT + sizeof(float) * kT * kCB;               // float [kT][kCB]
  static constexpr size_t DY = X + sizeof(float) * kT * kCB;               // float [kT][kCB]
  static constexpr size_t BC = DY + sizeof(float) * kT * kCB;              // float [kT][L][8]
  static constexpr size_t HS = BC + sizeof(float) * kT * 2 * N;            // float4 [kT/kSub][NT]
  static constexpr size_t PART = HS + 16 * (kT / kSub) * NT;               // float [2][NW][kSub][2N]
  static constexpr size_t ACC = PART + sizeof(float) * 2 * NW * kSub * 2 * N;  // double [5][NT]
  static constexpr size_t BYTES = ACC + sizeof(double) * 5 * NT;
};

// One block: kCB channels of one batch row, all S tokens, last chunk first.
// Thread tid owns channel tid / L of the block and its states 4g .. 4g+3,
// g = tid % L.  dt, x, dy of a chunk stage in shared memory as fp32; once a
// token is done, its rows of dt and x hold ddt and dx until the chunk is
// written out.  F32_OUT: dx is written in fp32, else in T.
template <int N, typename T, bool F32_OUT>
__global__ void __launch_bounds__(kCB * N / 4, 1)
mamba_scan_bwd_chunk(const Params p) {
  using O = std::conditional_t<F32_OUT, float, T>;
  using Sm = Smem<N>;
  constexpr int L = Sm::L, NT = Sm::NT, NW = Sm::NW;
  constexpr int NSUB = kT / kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  float(*s_dt)[kCB] = reinterpret_cast<float(*)[kCB]>(smem + Sm::DT);
  float(*s_x)[kCB] = reinterpret_cast<float(*)[kCB]>(smem + Sm::X);
  float(*s_dy)[kCB] = reinterpret_cast<float(*)[kCB]>(smem + Sm::DY);
  float(*s_bc)[L][8] = reinterpret_cast<float(*)[L][8]>(smem + Sm::BC);
  float4(*s_hs)[NT] = reinterpret_cast<float4(*)[NT]>(smem + Sm::HS);
  float(*s_part)[NW][kSub][2 * N] = reinterpret_cast<float(*)[NW][kSub][2 * N]>(smem + Sm::PART);
  double(*s_acc)[NT] = reinterpret_cast<double(*)[NT]>(smem + Sm::ACC);   // this lane's dA, dD

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = tid % L, cl = tid / L;
  const int bi = blockIdx.y, ch0 = blockIdx.x * kCB, ch = ch0 + cl;
  const int S = p.S, di = p.di, n_blocks = gridDim.x;
  const int n_chunks = (S + kT - 1) / kT;
  const bool act = ch < di;
  const float* dt = p.dt + bi * p.dt_sb;
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb;
  const T* bc = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cc = static_cast<const T*>(p.c) + bi * p.c_sb;
  const float* dy = p.dy + bi * p.dy_sb;
  // this lane's value of reduce_scatter8: dB (< 4) or dC, state 4g + (idx & 3)
  const int idx = 4 * ((lane & L) != 0) + 2 * ((lane & (2 * L)) != 0) + ((lane & (4 * L)) != 0);
  const int part_q = (idx < 4 ? 0 : N) + 4 * g + (idx & 3);
  const bool part_writer = lane < 8 * L;

  float a2[4], av_[4], gr[4];
  const float d_skip = act ? p.D[ch] : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    av_[j] = act ? p.A[static_cast<long long>(ch) * N + 4 * g + j] : 0.f;
    a2[j] = av_[j] * kLog2e;
    gr[j] = act && p.dh_last ? p.dh_last[(static_cast<long long>(bi) * di + ch) * N + 4 * g + j]
                             : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) s_acc[j][tid] = 0.0;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kT;
    __syncthreads();                    // the previous chunk is written out
    for (int e = tid; e < kT * kCB; e += NT) {
      const int tt = e / kCB, c1 = e % kCB;
      const bool ok = t0 + tt < S && ch0 + c1 < di;
      s_dt[tt][c1] = ok ? dt[(t0 + tt) * p.dt_ss + ch0 + c1] : 0.f;
      s_x[tt][c1] = ok ? to_float(x[(t0 + tt) * p.x_ss + ch0 + c1]) : 0.f;
      s_dy[tt][c1] = ok ? dy[(t0 + tt) * p.dy_ss + ch0 + c1] : 0.f;
    }
    for (int e = tid; e < kT * N; e += NT) {
      const int tt = e / N, n = e % N;
      const bool ok = t0 + tt < S;
      s_bc[tt][n / 4][n % 4] = ok ? to_float(bc[(t0 + tt) * p.b_ss + n * p.b_sn]) : 0.f;
      s_bc[tt][n / 4][4 + n % 4] = ok ? to_float(cc[(t0 + tt) * p.c_ss + n * p.c_sn]) : 0.f;
    }
    __syncthreads();

    // forward over the chunk from its state, keeping each sub-chunk's start
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (k > 0 && act) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          p.states + ((static_cast<long long>(bi) * di + ch) * (n_chunks - 1) + k - 1) * N + 4 * g);
      h[0] = s4.x; h[1] = s4.y; h[2] = s4.z; h[3] = s4.w;
    }
    for (int j = 0; j < NSUB; ++j) {
      s_hs[j][tid] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int tt = j * kSub + i;
        const float dtv = s_dt[tt][cl], dx = dtv * s_x[tt][cl];
        const float4 bb = *reinterpret_cast<const float4*>(&s_bc[tt][g][0]);
        h[0] = fmaf(ex2(dtv * a2[0]), h[0], dx * bb.x);
        h[1] = fmaf(ex2(dtv * a2[1]), h[1], dx * bb.y);
        h[2] = fmaf(ex2(dtv * a2[2]), h[2], dx * bb.z);
        h[3] = fmaf(ex2(dtv * a2[3]), h[3], dx * bb.w);
      }
    }

    // the sub-chunks, last first
    for (int j = NSUB - 1; j >= 0; --j) {
      float hp[kSub][4], ad[kSub][4];   // h_{t-1} and a_t of the sub-chunk's tokens
      float dA[4] = {0.f, 0.f, 0.f, 0.f}, dD = 0.f;   // the sub-chunk's sums
      {
        const float4 s4 = s_hs[j][tid];
        float hh[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int tt = j * kSub + i;
          const float dtv = s_dt[tt][cl], dx = dtv * s_x[tt][cl];
          const float4 bb = *reinterpret_cast<const float4*>(&s_bc[tt][g][0]);
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            hp[i][n] = hh[n];
            ad[i][n] = ex2(dtv * a2[n]);
            hh[n] = fmaf(ad[i][n], hh[n], dx * bv[n]);
          }
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int tt = j * kSub + i;
        const float dtv = s_dt[tt][cl], xv = s_x[tt][cl], dyv = s_dy[tt][cl];
        const float dx = dtv * xv;
        const float4 bb = *reinterpret_cast<const float4*>(&s_bc[tt][g][0]);
        const float4 cv = *reinterpret_cast<const float4*>(&s_bc[tt][g][4]);
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cvv[4] = {cv.x, cv.y, cv.z, cv.w};
        float v[8], sA = 0.f, gB = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          gr[n] = fmaf(dyv, cvv[n], gr[n]);                  // g_t
          const float ah = ad[i][n] * hp[i][n];              // a_t h_{t-1}
          const float ht = fmaf(ad[i][n], hp[i][n], dx * bv[n]);   // the forward's h_t
          const float term = gr[n] * ah;
          dA[n] = fmaf(term, dtv, dA[n]);
          sA = fmaf(av_[n], term, sA);
          gB = fmaf(gr[n], bv[n], gB);
          v[n] = gr[n] * dx;                                 // dB's part
          v[4 + n] = dyv * ht;                               // dC's part
          gr[n] *= ad[i][n];                                 // a_t g_t, for token t - 1
        }
        sA = channel_sum<L>(sA);
        gB = channel_sum<L>(gB);
        dD = fmaf(dyv, xv, dD);
        const float part = reduce_scatter8<L>(v, lane);
        if (part_writer) s_part[j & 1][warp][i][part_q] = part;
        __syncwarp();                   // every lane of the channel has read token tt
        if (g == 0) {
          s_dt[tt][cl] = fmaf(xv, gB, sA);                   // ddt
          s_x[tt][cl] = fmaf(dtv, gB, d_skip * dyv);         // dx
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) s_acc[n][tid] += static_cast<double>(dA[n]);
      s_acc[4][tid] += static_cast<double>(dD);
      __syncthreads();                  // s_part[j & 1] is complete
      // the block's partial dB / dC of the sub-chunk's tokens, warps in order
      // (buffer j & 1 is written again two sub-chunks on, past a barrier)
      for (int e = tid; e < kSub * 2 * N; e += NT) {
        const int i = e / (2 * N), q = e % (2 * N), pos = t0 + j * kSub + i;
        double acc = s_part[j & 1][0][i][q];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc += static_cast<double>(s_part[j & 1][w][i][q]);
        if (pos < S)
          (q < N ? p.pB : p.pC)[((static_cast<long long>(bi) * S + pos) * n_blocks + blockIdx.x) * N
                                + q % N] = acc;
      }
    }

    __syncthreads();                    // every token's ddt and dx is in place
    O* dxo = static_cast<O*>(p.dx);
    for (int e = tid; e < kT * kCB; e += NT) {
      const int tt = e / kCB, c1 = e % kCB;
      if (t0 + tt < S && ch0 + c1 < di) {
        const long long o = (static_cast<long long>(bi) * S + t0 + tt) * di + ch0 + c1;
        p.ddt[o] = s_dt[tt][c1];
        dxo[o] = from_float<O>(s_x[tt][c1]);
      }
    }
  }

  if (act) {
    double* pa = p.pA + (static_cast<long long>(bi) * di + ch) * N + 4 * g;
#pragma unroll
    for (int n = 0; n < 4; ++n) pa[n] = s_acc[n][tid];
    if (g == 0) p.pD[static_cast<long long>(bi) * di + ch] = s_acc[4][tid];
  }
}

// The partial sums, each in a fixed order and in float64, rounded once: dB,
// dC over the blocks (into the output type), dA, dD over the batch rows.
template <typename O>
__global__ void mamba_scan_bwd_sum(const Params p, int N, int n_blocks) {
  const long long nbc = static_cast<long long>(p.B) * p.S * N;
  const long long total = 2 * nbc + static_cast<long long>(p.di) * N + p.di;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (e < 2 * nbc) {
      const bool is_c = e >= nbc;
      const long long o = is_c ? e - nbc : e, bs = o / N, n = o % N;
      const double* src = (is_c ? p.pC : p.pB) + bs * n_blocks * N + n;
      double acc = src[0];
      for (int k = 1; k < n_blocks; ++k) acc += src[static_cast<long long>(k) * N];
      static_cast<O*>(is_c ? p.dC : p.dB)[o] = from_float<O>(static_cast<float>(acc));
    } else if (e < 2 * nbc + static_cast<long long>(p.di) * N) {
      const long long o = e - 2 * nbc, stride = static_cast<long long>(p.di) * N;
      double acc = p.pA[o];
      for (int b = 1; b < p.B; ++b) acc += p.pA[b * stride + o];
      p.dA[o] = static_cast<float>(acc);
    } else {
      const long long o = e - 2 * nbc - static_cast<long long>(p.di) * N;
      double acc = p.pD[o];
      for (int b = 1; b < p.B; ++b) acc += p.pD[static_cast<long long>(b) * p.di + o];
      p.dD[o] = static_cast<float>(acc);
    }
  }
}

template <int N, typename T, bool F32_OUT>
int launch(const Params& p, cudaStream_t stream) {
  using O = std::conditional_t<F32_OUT, float, T>;
  constexpr size_t smem = Smem<N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_bwd_chunk<N, T, F32_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_blocks = (p.di + kCB - 1) / kCB;
  mamba_scan_bwd_chunk<N, T, F32_OUT><<<dim3(n_blocks, p.B), kCB * N / 4, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * p.B * p.S * N + static_cast<long long>(p.di) * (N + 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  mamba_scan_bwd_sum<O><<<static_cast<int>(blocks < 4096 ? blocks : 4096), threads, 0, stream>>>(
      p, N, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(int x_dtype, int out_dtype, const Params& p, cudaStream_t stream) {
  if (x_dtype == 0 && out_dtype == 0) return launch<N, float, true>(p, stream);
  if (x_dtype == 1 && out_dtype == 0) return launch<N, __nv_bfloat16, true>(p, stream);
  if (x_dtype == 1 && out_dtype == 1) return launch<N, __nv_bfloat16, false>(p, stream);
  return -1;
}

}  // namespace

// dt: [B,S,di] fp32; x: [B,S,di] fp32 (x_dtype 0) or bf16 (1), both with a
// unit-stride channel dim; A: contiguous [di,N] fp32; Bc, Cc: [B,S,N] in x's
// dtype, any strides; D: [di] fp32; states: contiguous [B,di,ceil(S/64)-1,N]
// fp32 (the forward's); dy: [B,S,di] fp32 with a unit-stride channel dim;
// dh_last: contiguous [B,di,N] fp32 or null.  Outputs, contiguous: ddt
// [B,S,di] fp32; dx [B,S,di], dB, dC [B,S,N] in the output type (out_dtype 0
// fp32, 1 bf16: x's dtype or fp32); dA [di,N], dD [di] fp32.  Scratch,
// contiguous float64: pB, pC [B,S,ceil(di/128),N], pA [B,di,N], pD [B,di].
// strides: (b, s) of dt and x, (b, s, n) of Bc and Cc, (b, s) of dy.  Returns
// 0 or the CUDA error of a launch; -1 for a state size or dtype without an
// instantiation.
extern "C" int repro_mamba_scan_bwd(int d_state, int x_dtype, int out_dtype, const void* dt,
                                    const void* x, const void* A, const void* Bc,
                                    const void* Cc, const void* D, const void* states,
                                    const void* dy, const void* dh_last, void* ddt, void* dx,
                                    void* dB, void* dC, void* dA, void* dD, void* pB, void* pC,
                                    void* pA, void* pD, int B, int S, int di,
                                    const long long* strides, void* stream) {
  Params p{static_cast<const float*>(dt), x, static_cast<const float*>(A), Bc, Cc,
           static_cast<const float*>(D), static_cast<const float*>(states),
           static_cast<const float*>(dy), static_cast<const float*>(dh_last),
           static_cast<float*>(ddt), dx, dB, dC, static_cast<float*>(dA),
           static_cast<float*>(dD), static_cast<double*>(pB), static_cast<double*>(pC),
           static_cast<double*>(pA), static_cast<double*>(pD), B, S, di,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4: return launch_n<4>(x_dtype, out_dtype, p, st);
    case 8: return launch_n<8>(x_dtype, out_dtype, p, st);
    case 16: return launch_n<16>(x_dtype, out_dtype, p, st);
  }
  return -1;
}

// Dynamic shared memory of the chunk kernel at state size d_state.
extern "C" long long repro_mamba_scan_bwd_smem_bytes(int d_state) {
  switch (d_state) {
    case 4: return Smem<4>::BYTES;
    case 8: return Smem<8>::BYTES;
    case 16: return Smem<16>::BYTES;
  }
  return -1;
}
