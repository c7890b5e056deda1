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
// never exist.  For training, an instantiation also writes h at the start of
// every kT-token chunk but the first ([B,di,n_chunks-1,N] fp32), from which
// the backward (mamba_scan_bwd.cu) recomputes each chunk; the serving
// instantiation is the same code without those stores.
//
// What bounds it on this card, at the jamba prefill shape (B=4, S=2048,
// di=8192, N=16, x in bf16):
//   * bytes: dt (fp32) and x read once, y (fp32) written once, ~0.67 GB,
//     0.20 ms at 3.35 TB/s;
//   * exponentials: B*S*di*N = 1.07e9 of them, and the special-function unit
//     does 16 a clock per SM: >= 0.26 ms at 132 SMs x 1.98 GHz, the higher
//     floor; the ~4 fp32 operations of each state update come to ~0.13 ms.
// The design answers both, and the latency that held the first port (one
// thread per channel, ~8 warps per SM, 16-step dependent sums per token):
//   * N split across lanes: a lane owns states 4g .. 4g+3, N/4 lanes a
//     channel; and two adjacent channels a lane, two independent
//     recurrences that share each B and C load.  Jamba's shape runs 65,536
//     threads, two 256-thread blocks (16 warps) per SM.  One channel a lane
//     (twice the warps) measured slower on the H100: the per-token loads,
//     shuffles and stores cost more issue than the extra warps hid.  The
//     recurrence over t stays sequential in each lane, in the reference's
//     order;
//   * y over the N/4 lanes by a reduce-scatter of shuffles over N/4 tokens:
//     each lane ends with one token's y, 3 shuffles per 4 tokens at N = 16
//     (an all-reduce would take 8), and y is stored as rows of channels
//     (full 32-byte sectors);
//   * one exponential per state update, on the special-function unit with A
//     pre-scaled by log2(e) (ex2.approx: ~2 ulp, far inside the 2e-4
//     bound).  The unit is not what binds here: a build with an FMA in place
//     of ex2 ran barely faster;
//   * blocks of 128 channels: each chunk of 64 tokens of B and C (fp32 in
//     shared memory, 8 KB) serves all 128 channels, and dt and x come in
//     as 512- and 256-byte rows;
//   * dt and x stream through a ring of two chunks by cp.async (16-byte
//     pieces, zero-filled past S and di), the next chunk in flight while
//     one computes; B and C, strided views of the x_proj output, are loaded
//     a chunk ahead into registers and converted to fp32 on their way to
//     shared memory.  Inputs whose rows are not 16-byte aligned take plain
//     loads instead (the same arithmetic).  A build that streams these loads
//     and the stores of y with no arithmetic takes about 60 % of the kernel's
//     time: the rest is issue and latency in the update loop;
//   * any S (the last chunk runs past S on zero dt, which leaves h as it
//     is) and any di (channels past di compute nothing and store nothing).
// The time axis is not split: at jamba's shape the split of N and of the
// channels fills the card, and a parallel scan over t would add combine
// work on the same pipes without removing one exponential.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCB = 128;        // channels per block
constexpr int kT = 64;          // tokens per chunk
constexpr int kStages = 2;      // chunks of dt and x in the cp.async ring
constexpr int kCPL = 2;         // channels a lane
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* dt;
  const void* x;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  float* y;
  float* h_last;
  float* states;               // [B,di,n_chunks-1,N], or null: no chunk states
  int B, S, di;
  long long dt_sb, dt_ss;      // strides in elements; the channel dim is unit-stride
  long long x_sb, x_ss;
  long long b_sb, b_ss, b_sn;
  long long c_sb, c_ss, c_sn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then any mapped address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(n)); }

// p[j] is this lane's part of y at token j of a group of L tokens, over its 4
// states; the L lanes of a channel (g = lane's state group) exchange halves
// so that lane g ends with the whole y of token g:
// y = (p_0 + p_2) + (p_1 + p_3) at L = 4, the same order in every lane.
template <int L>
__device__ __forceinline__ float reduce_scatter(const float (&p)[L], int g) {
  if constexpr (L == 1) {
    return p[0];
  } else if constexpr (L == 2) {
    const bool hi = g & 1;
    return (hi ? p[1] : p[0]) + __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[1], 1);
  } else {
    static_assert(L == 4, "1, 2 or 4 lanes of 4 states: N is 4, 8 or 16");
    const bool hi2 = g & 2, hi1 = g & 1;
    const float q0 = (hi2 ? p[2] : p[0]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[0] : p[2], 2);
    const float q1 = (hi2 ? p[3] : p[1]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[1] : p[3], 2);
    return (hi1 ? q1 : q0) + __shfl_xor_sync(0xffffffffu, hi1 ? q0 : q1, 1);
  }
}

template <int N, typename T>
struct Smem {
  static constexpr size_t DT = 0;                                          // float [kStages][kT][kCB]
  static constexpr size_t X = DT + sizeof(float) * kStages * kT * kCB;     // T [kStages][kT][kCB]
  static constexpr size_t BC = X + sizeof(T) * kStages * kT * kCB;         // float [2][kT][N/4][8]
  static constexpr size_t BYTES = BC + sizeof(float) * 2 * kT * 2 * N;
};

// C adjacent channels of one token row (16 bytes at most, aligned to its size).
template <int C>
__device__ __forceinline__ void load_ch(float (&d)[C], const float* p) {
  if constexpr (C == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void load_ch(float (&d)[C], const __nv_bfloat16* p) {
  if constexpr (C == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    d[0] = lo.x; d[1] = lo.y; d[2] = hi.x; d[3] = hi.y;
  } else if constexpr (C == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __bfloat162float(*p);
  }
}
template <int C>
__device__ __forceinline__ void store_ch(float* p, const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// One block: kCB channels of one batch row, all S tokens.  Thread tid owns
// kCPL adjacent channels, from kCPL * (tid / L) of the block, and states
// 4g .. 4g+3 of each, g = tid % L: kCPL independent recurrences that share
// each token's B and C.  VEC: dt and x rows are 16-byte aligned and di fills
// whole 16-byte pieces, so they stream by cp.async; otherwise by plain loads.
// STATES: h at the start of chunk k >= 1 goes to slot k - 1 of p.states.
template <int N, typename T, bool VEC, bool STATES>
__global__ void __launch_bounds__(kCB / kCPL * N / 4, 2)
mamba_scan_fwd(const Params p) {
  constexpr int L = N / 4;                  // lanes a channel
  constexpr int C = kCPL;
  constexpr int NT = kCB / C * L;           // threads
  constexpr int EPP = 16 / sizeof(T);       // x elements a 16-byte piece
  constexpr int BC_PER = kT * N / NT;       // B (and C) elements a thread stages per chunk
  using Sm = Smem<N, T>;
  static_assert((kT * kCB / 4) % NT == 0 && (kT * kCB / EPP) % NT == 0 &&
                (kT * kCB) % NT == 0 && (kT * N) % NT == 0, "whole pieces a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  float(*s_dt)[kT][kCB] = reinterpret_cast<float(*)[kT][kCB]>(smem + Sm::DT);
  T(*s_x)[kT][kCB] = reinterpret_cast<T(*)[kT][kCB]>(smem + Sm::X);
  float(*s_bc)[kT][L][8] = reinterpret_cast<float(*)[kT][L][8]>(smem + Sm::BC);

  const int tid = threadIdx.x, g = tid % L, cl = C * (tid / L);
  const int bi = blockIdx.y, ch0 = blockIdx.x * kCB, ch = ch0 + cl;
  const int S = p.S, di = p.di;
  const int n_chunks = (S + kT - 1) / kT;
  const float* dt = p.dt + bi * p.dt_sb;
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb;
  const T* bc = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cc = static_cast<const T*>(p.c) + bi * p.c_sb;

  float a2[C][4], h[C][4], d_skip[C];       // A * log2(e), the state, D
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool act = ch + c < di;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a2[c][j] = act ? p.A[static_cast<long long>(ch + c) * N + 4 * g + j] * kLog2e : 0.f;
      h[c][j] = 0.f;
    }
    d_skip[c] = act ? p.D[ch + c] : 0.f;
  }

  // dt and x of chunk k into ring slot k % kStages, one commit group (empty
  // past the last chunk, so that the wait below counts groups uniformly)
  auto issue = [&](int k) {
    if (k < n_chunks) {
      const int st = k % kStages, t0 = k * kT;
      if constexpr (VEC) {
#pragma unroll
        for (int q = 0; q < kT * kCB / 4 / NT; ++q) {
          const int e = tid + q * NT, tt = e / (kCB / 4), c4 = 4 * (e % (kCB / 4));
          const bool ok = t0 + tt < S && ch0 + c4 < di;
          cp_async16(&s_dt[st][tt][c4], ok ? dt + (t0 + tt) * p.dt_ss + ch0 + c4 : dt, ok);
        }
#pragma unroll
        for (int q = 0; q < kT * kCB / EPP / NT; ++q) {
          const int e = tid + q * NT, tt = e / (kCB / EPP), c8 = EPP * (e % (kCB / EPP));
          const bool ok = t0 + tt < S && ch0 + c8 < di;
          cp_async16(&s_x[st][tt][c8], ok ? x + (t0 + tt) * p.x_ss + ch0 + c8 : x, ok);
        }
      } else {
        for (int q = 0; q < kT * kCB / NT; ++q) {
          const int e = tid + q * NT, tt = e / kCB, c1 = e % kCB;
          const bool ok = t0 + tt < S && ch0 + c1 < di;
          s_dt[st][tt][c1] = ok ? dt[(t0 + tt) * p.dt_ss + ch0 + c1] : 0.f;
          s_x[st][tt][c1] = ok ? x[(t0 + tt) * p.x_ss + ch0 + c1] : T(0.f);
        }
      }
    }
    cp_async_commit();
  };
  // B and C of chunk k, BC_PER elements of each a thread, into registers,
  // then as fp32 into buffer k & 1, laid out [token][state group][B0..3 C0..3]
  float pb[BC_PER], pcv[BC_PER];
  auto fetch_bc = [&](int k) {
#pragma unroll
    for (int q = 0; q < BC_PER; ++q) {
      const int e = tid + q * NT, pos = k * kT + e / N, n = e % N;
      const bool ok = k < n_chunks && pos < S;
      pb[q] = ok ? to_float(bc[pos * p.b_ss + n * p.b_sn]) : 0.f;
      pcv[q] = ok ? to_float(cc[pos * p.c_ss + n * p.c_sn]) : 0.f;
    }
  };
  auto stash_bc = [&](int k) {
#pragma unroll
    for (int q = 0; q < BC_PER; ++q) {
      const int e = tid + q * NT, tt = e / N, n = e % N;
      s_bc[k & 1][tt][n / 4][n % 4] = pb[q];
      s_bc[k & 1][tt][n / 4][4 + n % 4] = pcv[q];
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  fetch_bc(0);
  stash_bc(0);
  fetch_bc(1);

  // y of token t0 + tt + g (row yt, one group of L tokens on at a time): one
  // vector store where the thread's channels are all in range and the row
  // offsets keep it aligned (di % C == 0)
  float* yt = p.y + (static_cast<long long>(bi) * S + g) * di + ch;
  const long long y_step = static_cast<long long>(L) * di;
  const bool vec_store = ch + C <= di && di % C == 0;

  for (int k = 0; k < n_chunks; ++k) {
    if constexpr (STATES) {
      if (k > 0) {
        float* st = p.states + ((static_cast<long long>(bi) * di + ch) * (n_chunks - 1) + k - 1) * N
                    + 4 * g;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (ch + c < di)
            *reinterpret_cast<float4*>(st + static_cast<long long>(c) * (n_chunks - 1) * N) =
                make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
      }
    }
    cp_async_wait<kStages - 2>();       // this thread's pieces of chunk k landed
    __syncthreads();                    // everyone's landed; chunk k - 1 is done with
    issue(k + kStages - 1);             // into the slot chunk k - 1 used
    const int st = k % kStages, t0 = k * kT;
    const float(*bck)[L][8] = s_bc[k & 1];

#pragma unroll 2
    for (int tt = 0; tt < kT; tt += L) {
      float part[C][L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float dtv[C], xv[C], dx[C];
        load_ch(dtv, &s_dt[st][tt + j][cl]);
        load_ch(xv, &s_x[st][tt + j][cl]);
        const float4 bb = *reinterpret_cast<const float4*>(&bck[tt + j][g][0]);
        const float4 cv = *reinterpret_cast<const float4*>(&bck[tt + j][g][4]);
#pragma unroll
        for (int c = 0; c < C; ++c) dx[c] = dtv[c] * xv[c];
#pragma unroll
        for (int c = 0; c < C; ++c) h[c][0] = fmaf(ex2(dtv[c] * a2[c][0]), h[c][0], dx[c] * bb.x);
#pragma unroll
        for (int c = 0; c < C; ++c) h[c][1] = fmaf(ex2(dtv[c] * a2[c][1]), h[c][1], dx[c] * bb.y);
#pragma unroll
        for (int c = 0; c < C; ++c) h[c][2] = fmaf(ex2(dtv[c] * a2[c][2]), h[c][2], dx[c] * bb.z);
#pragma unroll
        for (int c = 0; c < C; ++c) h[c][3] = fmaf(ex2(dtv[c] * a2[c][3]), h[c][3], dx[c] * bb.w);
#pragma unroll
        for (int c = 0; c < C; ++c)
          part[c][j] = fmaf(cv.w, h[c][3], fmaf(cv.z, h[c][2], fmaf(cv.y, h[c][1], cv.x * h[c][0])));
      }
      float xg[C], yv[C];                 // x and y of this lane's token, tt + g
      load_ch(xg, &s_x[st][tt + g][cl]);
#pragma unroll
      for (int c = 0; c < C; ++c) yv[c] = fmaf(d_skip[c], xg[c], reduce_scatter<L>(part[c], g));
      if (t0 + tt + g < S) {
        if (vec_store) {
          store_ch(yt, yv);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (ch + c < di) yt[c] = yv[c];
        }
      }
      yt += y_step;
    }

    stash_bc(k + 1);                    // buffer (k + 1) & 1 was last read in chunk k - 1
    fetch_bc(k + 2);
  }
  cp_async_wait<0>();

  float* h_out = p.h_last + (static_cast<long long>(bi) * di + ch) * N + 4 * g;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (ch + c < di)
      *reinterpret_cast<float4*>(h_out + c * N) = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
}

template <int N, typename T, bool VEC, bool STATES>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<N, T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_fwd<N, T, VEC, STATES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.di + kCB - 1) / kCB, p.B);
  mamba_scan_fwd<N, T, VEC, STATES><<<grid, kCB / kCPL * N / 4, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename T, bool VEC>
int launch_s(const Params& p, cudaStream_t stream) {
  return p.states ? launch<N, T, VEC, true>(p, stream) : launch<N, T, VEC, false>(p, stream);
}

template <int N, typename T>
int launch_t(const Params& p, cudaStream_t stream) {
  // cp.async takes 16-byte pieces: rows 16-byte aligned, di whole pieces
  constexpr long long epp = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(p.dt) % 16 == 0 && p.dt_sb % 4 == 0 &&
                   p.dt_ss % 4 == 0 && p.di % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 && p.x_sb % epp == 0 &&
                   p.x_ss % epp == 0 && p.di % epp == 0;
  return vec ? launch_s<N, T, true>(p, stream) : launch_s<N, T, false>(p, stream);
}

template <int N>
int launch_n(int x_dtype, const Params& p, cudaStream_t stream) {
  switch (x_dtype) {
    case 0: return launch_t<N, float>(p, stream);
    case 1: return launch_t<N, __nv_bfloat16>(p, stream);
  }
  return -1;
}

}  // namespace

// dt: [B,S,di] fp32; x: [B,S,di] fp32 (x_dtype 0) or bf16 (1), both with a
// unit-stride channel dim; A: contiguous [di,N] fp32; Bc, Cc: [B,S,N] in x's
// dtype, any strides; D: [di] fp32; y: contiguous [B,S,di] fp32; h_last:
// contiguous [B,di,N] fp32; states: contiguous [B,di,ceil(S/64)-1,N] fp32, or
// null for none.  strides: (b, s) of dt and x, then (b, s, n) of Bc and Cc.
// Returns 0 or the CUDA error of the launch; -1 for a state size or dtype
// without an instantiation.
extern "C" int repro_mamba_scan_fwd(int d_state, int x_dtype, const void* dt, const void* x,
                                    const void* A, const void* Bc, const void* Cc,
                                    const void* D, void* y, void* h_last, void* states, int B,
                                    int S, int di, const long long* strides, void* stream) {
  Params p{static_cast<const float*>(dt), x, static_cast<const float*>(A), Bc, Cc,
           static_cast<const float*>(D), static_cast<float*>(y),
           static_cast<float*>(h_last), static_cast<float*>(states), B, S, di,
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
