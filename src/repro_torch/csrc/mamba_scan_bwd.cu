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
//     15/8 (the chunk's forward over all but its last sub-chunk, and each
//     sub-chunk's recompute), >= 0.48 ms;
//   * issue, which binds: a sub-chunk's loop holds ~1,190 instructions for
//     its 8 tokens (scripts/sass_loops.py); a token's dB / dC reduce-scatter
//     takes 14 selects, 7 shuffles and 7 adds of them, its channel sums 4
//     shuffles and 4 adds.  One block of 16 warps an SM: the sweep holds 128
//     registers a thread, the whole register file, so latency is hidden by
//     the 8 independent tokens of a sub-chunk, not by more warps.  On one
//     H100 (scripts/scan_bwd_ablations.json) a call took 1.97 ms, 1.62
//     without the reduce-scatter's and channel sums' shuffles and selects,
//     1.89 without staging, 1.95 without the wait for slot 0.
// The design:
//   * the forward's split: blocks of kCB = 128 channels of one batch row, a
//     lane owns 4 states of one channel (N/4 lanes a channel), so the sums
//     over n take N/4 lanes and dB / dC sum over the block's channels;
//   * chunks of kT = 64 tokens, last to first.  A chunk runs forward once
//     from its state, keeping h at the start of each kSub-token sub-chunk in
//     shared memory; each sub-chunk, last to first, recomputes its tokens'
//     a_t and h_t into registers and sweeps back through them with g.  The
//     last sub-chunk's recompute is the chunk's forward over it.  h_t is
//     formed with the forward's own fused multiply-add, so it is the
//     forward's value;
//   * staging overlapped with the sweep: dt, dy, x, B and C live in a ring
//     of kT / kSub slots of kSub tokens in shared memory, x and B / C in
//     their own dtype (bf16 B / C converted to fp32 once a chunk).  Once a
//     sub-chunk is swept its slot is dead and is refilled at once with the
//     same sub-chunk of the chunk before: one thread issues a TMA box (kSub
//     tokens x 128 channels, or x N states) per input on the slot's
//     mbarrier, zero-filled past S and di, so the sweeping threads spend no
//     instructions or registers on addresses, and only the refill of slot
//     0, which the next chunk's forward reads first, is exposed.  An input
//     TMA cannot take (an address or row stride off 16 bytes, B / C with a
//     state stride or rows under 16 bytes) takes plain loads out of line;
//   * ddt and dx leave through an output tile of kSub x kCB of their own
//     (dx in the output type), double-buffered and stored after each
//     sub-chunk by TMA (clipped at S and di; plain stores out of line where
//     TMA cannot take the rows), so nothing is written in place and a
//     token's shared loads need no fence;
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
// An earlier design staged each chunk through registers between two
// barriers, one load at a time (each behind its own branch): 1.44 of its
// 3.46 ms a call on one H100.  Staged by cp.async from every thread, its
// address arithmetic and the registers it held made the sweep spill: 2.70 ms.

#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kCB = 128;        // channels per block
constexpr int kT = 64;          // tokens per chunk (the forward's states)
constexpr int kSub = 8;         // tokens per sub-chunk of the recompute: a slot of the ring
constexpr float kLog2e = 1.4426950408889634f;

// Params::tma: which inputs and outputs move by TMA (their rows 16-byte
// aligned); the others take plain loads and stores
constexpr unsigned kTmaDt = 1, kTmaDy = 2, kTmaX = 4, kTmaBC = 8, kTmaDdt = 16, kTmaDx = 32;
constexpr unsigned kTmaAll = 63;

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
  unsigned tma;                // kTma* bits
};

// TMA tensor maps, 3-D (channels or states, S, B), boxes of kSub tokens
struct Maps {
  CUtensorMap dt, dy, x, b, c, ddt, dx;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename O> __device__ __forceinline__ O from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// One box of shared memory out to a 3-D tensor map (what lies past its
// edges is not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() {   // this thread's stores have read their source
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Orders this thread's shared-memory accesses before later TMA accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Shared memory of the chunk kernel (every array 128-byte aligned, as TMA
// wants).  The ring: dt, dy, x rows [kT][kCB] and B, C rows [kT][N] in the
// inputs' dtypes, kT / kSub slots of kSub tokens, one mbarrier a slot; bf16
// B / C are converted to fp32 (BF, CF) once a chunk.  HS: h at the start of
// each sub-chunk but the last, whose start is kept in OUT's buffer 0 when
// that holds it (free until the sweep of sub-chunk kT / kSub - 2), else in
// HS too.  OUT: ddt (fp32) and dx (O) of a sub-chunk, two buffers.
template <int N, typename T, typename O>
struct Smem {
  static constexpr int L = N / 4, NT = kCB * L, NW = NT / 32, NSUB = kT / kSub;
  static constexpr bool CONVERT = !std::is_same_v<T, float>;
  static constexpr size_t OUT_BUF = (sizeof(float) + sizeof(O)) * kSub * kCB;
  static constexpr bool LAST_IN_OUT = 16 * NT <= OUT_BUF;
  static constexpr size_t DT = 0;                                          // float [kT][kCB]
  static constexpr size_t DY = DT + sizeof(float) * kT * kCB;              // float [kT][kCB]
  static constexpr size_t X = DY + sizeof(float) * kT * kCB;               // T [kT][kCB]
  static constexpr size_t BR = X + sizeof(T) * kT * kCB;                   // T [kT][N]
  static constexpr size_t CR = BR + sizeof(T) * kT * N;                    // T [kT][N]
  static constexpr size_t BF = CR + sizeof(T) * kT * N;                    // float [kT][N]
  static constexpr size_t CF = BF + (CONVERT ? sizeof(float) * kT * N : 0);
  static constexpr size_t HS = CF + (CONVERT ? sizeof(float) * kT * N : 0);  // float4 [.][NT]
  static constexpr size_t PART = HS + 16 * (NSUB - (LAST_IN_OUT ? 1 : 0)) * NT;  // float [2][NW][kSub][2N]
  static constexpr size_t OUT = PART + sizeof(float) * 2 * NW * kSub * 2 * N;
  static constexpr size_t ACC = OUT + 2 * OUT_BUF;                         // double [4][NT]
  static constexpr size_t ACC_D = ACC + sizeof(double) * 4 * NT;           // double [kCB]
  static constexpr size_t BAR = ACC_D + sizeof(double) * kCB;              // uint64 [NSUB]
  static constexpr size_t BYTES = BAR + 8 * NSUB;
  static constexpr unsigned SLOT_BYTES = (2 * sizeof(float) + sizeof(T)) * kSub * kCB +
                                         2 * sizeof(T) * kSub * N;
  static_assert(BR % 128 == 0 && HS % 128 == 0 && OUT % 128 == 0 && OUT_BUF % 128 == 0,
                "TMA boxes start on 128-byte boundaries");
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// Slot j of the ring <- tokens t .. t + kSub - 1 of the inputs that TMA does
// not move (their p.tma bit clear), by plain loads, zero past S and di; out
// of line, off the main path.
template <int N, typename T, typename O>
__device__ __noinline__ void stage_plain(const Params& p, unsigned char* smem, int t, int j) {
  using Sm = Smem<N, T, O>;
  const int tid = threadIdx.x, bi = blockIdx.y, ch0 = blockIdx.x * kCB;
  float(*s_dt)[kCB] = reinterpret_cast<float(*)[kCB]>(smem + Sm::DT) + j * kSub;
  float(*s_dy)[kCB] = reinterpret_cast<float(*)[kCB]>(smem + Sm::DY) + j * kSub;
  T(*s_x)[kCB] = reinterpret_cast<T(*)[kCB]>(smem + Sm::X) + j * kSub;
  T(*s_b)[N] = reinterpret_cast<T(*)[N]>(smem + Sm::BR) + j * kSub;
  T(*s_c)[N] = reinterpret_cast<T(*)[N]>(smem + Sm::CR) + j * kSub;
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb;
  for (int e = tid; e < kSub * kCB; e += Sm::NT) {
    const int i = e / kCB, c = e % kCB;
    const long long r = t + i;
    const bool ok = t + i < p.S && ch0 + c < p.di;
    if (!(p.tma & kTmaDt)) s_dt[i][c] = ok ? p.dt[bi * p.dt_sb + r * p.dt_ss + ch0 + c] : 0.f;
    if (!(p.tma & kTmaDy)) s_dy[i][c] = ok ? p.dy[bi * p.dy_sb + r * p.dy_ss + ch0 + c] : 0.f;
    if (!(p.tma & kTmaX)) s_x[i][c] = ok ? x[r * p.x_ss + ch0 + c] : from_float<T>(0.f);
  }
  if (!(p.tma & kTmaBC)) {
    const T* b = static_cast<const T*>(p.b) + bi * p.b_sb;
    const T* c = static_cast<const T*>(p.c) + bi * p.c_sb;
    for (int e = tid; e < kSub * N; e += Sm::NT) {
      const int i = e / N, n = e % N;
      const long long r = t + i;
      const bool ok = t + i < p.S;
      s_b[i][n] = ok ? b[r * p.b_ss + n * p.b_sn] : from_float<T>(0.f);
      s_c[i][n] = ok ? c[r * p.c_ss + n * p.c_sn] : from_float<T>(0.f);
    }
  }
}

// ddt and dx of tokens t .. t + kSub - 1 from the output tile, for the
// outputs that TMA does not move, by plain stores; out of line.
template <typename O>
__device__ __noinline__ void store_plain(const Params& p, const float* o_ddt, const O* o_dx, int t,
                                         int nt) {
  const int bi = blockIdx.y, ch0 = blockIdx.x * kCB;
  for (int e = threadIdx.x; e < kSub * kCB; e += nt) {
    const int i = e / kCB, c = e % kCB;
    if (t + i < p.S && ch0 + c < p.di) {
      const long long o = (static_cast<long long>(bi) * p.S + t + i) * p.di + ch0 + c;
      if (!(p.tma & kTmaDdt)) p.ddt[o] = o_ddt[e];
      if (!(p.tma & kTmaDx)) static_cast<O*>(p.dx)[o] = o_dx[e];
    }
  }
}

// One block: kCB channels of one batch row, all S tokens, last chunk first.
// Thread tid owns channel tid / L of the block and its states 4g .. 4g+3,
// g = tid % L.  One thread issues the TMA copies.  F32_OUT: dx is written in
// fp32, else in T.
template <int N, typename T, bool F32_OUT>
__global__ void __launch_bounds__(kCB * N / 4, 1)
mamba_scan_bwd_chunk(const __grid_constant__ Maps maps, const Params p) {
  using O = std::conditional_t<F32_OUT, float, T>;
  using Sm = Smem<N, T, O>;
  constexpr int L = Sm::L, NT = Sm::NT, NW = Sm::NW, NSUB = Sm::NSUB;
  extern __shared__ __align__(128) unsigned char smem[];
  const float(*s_dt)[kCB] = reinterpret_cast<const float(*)[kCB]>(smem + Sm::DT);
  const float(*s_dy)[kCB] = reinterpret_cast<const float(*)[kCB]>(smem + Sm::DY);
  const T(*s_x)[kCB] = reinterpret_cast<const T(*)[kCB]>(smem + Sm::X);
  const float(*s_b)[N] = reinterpret_cast<const float(*)[N]>(smem + (Sm::CONVERT ? Sm::BF : Sm::BR));
  const float(*s_c)[N] = reinterpret_cast<const float(*)[N]>(smem + (Sm::CONVERT ? Sm::CF : Sm::CR));
  float4(*s_hs)[NT] = reinterpret_cast<float4(*)[NT]>(smem + Sm::HS);
  float4* s_hlast = Sm::LAST_IN_OUT ? reinterpret_cast<float4*>(smem + Sm::OUT) : s_hs[NSUB - 1];
  float(*s_part)[NW][kSub][2 * N] = reinterpret_cast<float(*)[NW][kSub][2 * N]>(smem + Sm::PART);
  double(*s_acc)[NT] = reinterpret_cast<double(*)[NT]>(smem + Sm::ACC);   // this lane's dA
  double* s_acc_d = reinterpret_cast<double*>(smem + Sm::ACC_D);          // its channel's dD
  const uint32_t bar0 = smem_u32(smem + Sm::BAR);                        // slot j's: bar0 + 8 j

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = tid % L, cl = tid / L;
  const int bi = blockIdx.y, ch0 = blockIdx.x * kCB, ch = ch0 + cl;
  const int S = p.S, di = p.di, n_blocks = gridDim.x;
  const int n_chunks = (S + kT - 1) / kT;
  const bool act = ch < di;
  // this lane's value of reduce_scatter8: dB (< 4) or dC, state 4g + (idx & 3)
  const int idx = 4 * ((lane & L) != 0) + 2 * ((lane & (2 * L)) != 0) + ((lane & (4 * L)) != 0);
  const int part_q = (idx < 4 ? 0 : N) + 4 * g + (idx & 3);
  const bool part_writer = lane < 8 * L;
  // the thread that issues the TMA copies: in the last warp, which has no
  // share of the sums over warps (kSub * 2N of them, fewer than NT - 32)
  const bool issuer = tid == NT - 32;
  static_assert(kSub * 2 * N <= NT - 32, "the issuer's warp sums nothing");

  // slot j <- tokens t .. t + kSub - 1; every thread has read the slot and
  // fenced its reads (fence_proxy_async, then a barrier) before a refill
  auto refill = [&](int t, int j) {
    if (issuer) {
      const unsigned bytes = Sm::SLOT_BYTES -
          (p.tma & kTmaDt ? 0u : 4u * kSub * kCB) - (p.tma & kTmaDy ? 0u : 4u * kSub * kCB) -
          (p.tma & kTmaX ? 0u : unsigned(sizeof(T)) * kSub * kCB) -
          (p.tma & kTmaBC ? 0u : 2u * unsigned(sizeof(T)) * kSub * N);
      const uint32_t bar = bar0 + 8 * j, row = j * kSub;
      mbar_expect_tx(bar, bytes);
      if (p.tma & kTmaDt) tma_load_3d(smem_u32(smem + Sm::DT + 4 * row * kCB), &maps.dt, bar, ch0, t, bi);
      if (p.tma & kTmaDy) tma_load_3d(smem_u32(smem + Sm::DY + 4 * row * kCB), &maps.dy, bar, ch0, t, bi);
      if (p.tma & kTmaX)
        tma_load_3d(smem_u32(smem + Sm::X + sizeof(T) * row * kCB), &maps.x, bar, ch0, t, bi);
      if (p.tma & kTmaBC) {
        tma_load_3d(smem_u32(smem + Sm::BR + sizeof(T) * row * N), &maps.b, bar, 0, t, bi);
        tma_load_3d(smem_u32(smem + Sm::CR + sizeof(T) * row * N), &maps.c, bar, 0, t, bi);
      }
    }
    if (p.tma != kTmaAll) stage_plain<N, T, O>(p, smem, t, j);
  };

  if (issuer) {
    for (int j = 0; j < NSUB; ++j) mbar_init(bar0 + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = 0; j < NSUB; ++j) refill((n_chunks - 1) * kT + j * kSub, j);

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
  for (int j = 0; j < 4; ++j) s_acc[j][tid] = 0.0;
  if (g == 0) s_acc_d[cl] = 0.0;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kT;
    for (int j = 0; j < NSUB; ++j) mbar_wait(bar0 + 8 * j, (n_chunks - 1 - k) & 1);
    if (issuer) bulk_wait_read();       // the last sub-chunk's tile is out (OUT's buffer 0)
    __syncthreads();                    // chunk k is staged
    if constexpr (Sm::CONVERT) {
      const T* br = reinterpret_cast<const T*>(smem + Sm::BR);
      float* bf = reinterpret_cast<float*>(smem + Sm::BF);
      for (int e = tid; e < 2 * kT * N; e += NT) bf[e] = to_float(br[e]);   // B, C rows
      __syncthreads();
    }

    // forward over the chunk from its state, keeping each sub-chunk's start
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (k > 0 && act) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          p.states + ((static_cast<long long>(bi) * di + ch) * (n_chunks - 1) + k - 1) * N + 4 * g);
      h[0] = s4.x; h[1] = s4.y; h[2] = s4.z; h[3] = s4.w;
    }
    for (int j = 0; j < NSUB - 1; ++j) {
      s_hs[j][tid] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int tt = j * kSub + i;
        const float dtv = s_dt[tt][cl], dx = dtv * to_float(s_x[tt][cl]);
        const float4 bb = *reinterpret_cast<const float4*>(&s_b[tt][4 * g]);
        h[0] = fmaf(ex2(dtv * a2[0]), h[0], dx * bb.x);
        h[1] = fmaf(ex2(dtv * a2[1]), h[1], dx * bb.y);
        h[2] = fmaf(ex2(dtv * a2[2]), h[2], dx * bb.z);
        h[3] = fmaf(ex2(dtv * a2[3]), h[3], dx * bb.w);
      }
    }
    s_hlast[tid] = make_float4(h[0], h[1], h[2], h[3]);

    // the sub-chunks, last first
    for (int j = NSUB - 1; j >= 0; --j) {
      const float4* start = j == NSUB - 1 ? &s_hlast[tid] : &s_hs[j][tid];
      float hn[kSub][4], ad[kSub][4];   // h_t and a_t of the sub-chunk's tokens
      float dA[4] = {0.f, 0.f, 0.f, 0.f}, dD = 0.f;   // the sub-chunk's sums
      {
        const float4 s4 = *start;
        float hh[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int tt = j * kSub + i;
          const float dtv = s_dt[tt][cl], dx = dtv * to_float(s_x[tt][cl]);
          const float4 bb = *reinterpret_cast<const float4*>(&s_b[tt][4 * g]);
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            ad[i][n] = ex2(dtv * a2[n]);
            hh[n] = fmaf(ad[i][n], hh[n], dx * bv[n]);
            hn[i][n] = hh[n];
          }
        }
      }
      unsigned char* out = smem + Sm::OUT + (j & 1) * Sm::OUT_BUF;
      float* o_ddt = reinterpret_cast<float*>(out);
      O* o_dx = reinterpret_cast<O*>(out + sizeof(float) * kSub * kCB);
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int tt = j * kSub + i;
        const float dtv = s_dt[tt][cl], xv = to_float(s_x[tt][cl]), dyv = s_dy[tt][cl];
        const float dx = dtv * xv;
        const float4 bb = *reinterpret_cast<const float4*>(&s_b[tt][4 * g]);
        const float4 cv = *reinterpret_cast<const float4*>(&s_c[tt][4 * g]);
        float hp[4];                    // h_{t-1}
        if (i > 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n) hp[n] = hn[i - 1][n];
        } else {
          const float4 s4 = *start;
          hp[0] = s4.x; hp[1] = s4.y; hp[2] = s4.z; hp[3] = s4.w;
        }
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cvv[4] = {cv.x, cv.y, cv.z, cv.w};
        float v[8], sA = 0.f, gB = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          gr[n] = fmaf(dyv, cvv[n], gr[n]);                  // g_t
          const float term = gr[n] * (ad[i][n] * hp[n]);     // g_t a_t h_{t-1}
          dA[n] = fmaf(term, dtv, dA[n]);
          sA = fmaf(av_[n], term, sA);
          gB = fmaf(gr[n], bv[n], gB);
          v[n] = gr[n] * dx;                                 // dB's part
          v[4 + n] = dyv * hn[i][n];                         // dC's part
          gr[n] *= ad[i][n];                                 // a_t g_t, for token t - 1
        }
        sA = channel_sum<L>(sA);
        gB = channel_sum<L>(gB);
        dD = fmaf(dyv, xv, dD);
        const float part = reduce_scatter8<L>(v, lane);
        if (part_writer) s_part[j & 1][warp][i][part_q] = part;
        if (g == 0) {
          o_ddt[i * kCB + cl] = fmaf(xv, gB, sA);                          // ddt
          o_dx[i * kCB + cl] = from_float<O>(fmaf(dtv, gB, d_skip * dyv));  // dx
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) s_acc[n][tid] += static_cast<double>(dA[n]);
      if (g == 0) s_acc_d[cl] += static_cast<double>(dD);
      if (issuer) bulk_wait_read();     // the last tile is out: the next sweep writes its buffer
      fence_proxy_async();              // this thread's reads of slot j and its tile writes
      __syncthreads();                  // slot j, s_part[j & 1] and the tile are complete
      const int t = t0 + j * kSub;
      if (issuer) {
        if (p.tma & kTmaDdt) tma_store_3d(&maps.ddt, smem_u32(o_ddt), ch0, t, bi);
        if (p.tma & kTmaDx) tma_store_3d(&maps.dx, smem_u32(o_dx), ch0, t, bi);
        bulk_commit();
      }
      if ((p.tma & (kTmaDdt | kTmaDx)) != (kTmaDdt | kTmaDx)) store_plain<O>(p, o_ddt, o_dx, t, NT);
      if (k > 0) refill(t - kT, j);     // slot j is read no more in this chunk
      // the block's partial dB / dC of the sub-chunk's tokens, warps in order
      // (buffer j & 1 is written again two sub-chunks on, past a barrier)
#pragma unroll
      for (int r = 0; r < (kSub * 2 * N + NT - 1) / NT; ++r) {
        const int e = tid + r * NT;
        if (e >= kSub * 2 * N) break;
        const int i = e / (2 * N), q = e % (2 * N), pos = t + i;
        double acc = s_part[j & 1][0][i][q];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc += static_cast<double>(s_part[j & 1][w][i][q]);
        if (pos < S)
          (q < N ? p.pB : p.pC)[((static_cast<long long>(bi) * S + pos) * n_blocks + blockIdx.x) * N
                                + q % N] = acc;
      }
    }
  }

  if (act) {
    double* pa = p.pA + (static_cast<long long>(bi) * di + ch) * N + 4 * g;
#pragma unroll
    for (int n = 0; n < 4; ++n) pa[n] = s_acc[n][tid];
    if (g == 0) p.pD[static_cast<long long>(bi) * di + ch] = s_acc_d[cl];
  }
  if (issuer) bulk_wait();              // the last tiles are written
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

// A 3-D tensor map over (inner, S, B) of `elem`-byte elements with strides
// ss, sb (elements; the inner dim unit-stride), boxes of `box` x kSub x 1,
// zero fill past every edge; false where TMA cannot take the view (an
// address or a row stride off 16 bytes).
bool encode3(CUtensorMap* map, int elem, const void* ptr, int inner, int S, int B, long long ss,
             long long sb, int box) {
  EncodeTiled fn = encode_tiled();
  if (B == 1) sb = ss * S;              // not read
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (ss * elem) % 16 != 0 ||
      (sb * elem) % 16 != 0 || ss < inner || sb < ss * S)
    return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss * elem),
                                 static_cast<cuuint64_t>(sb * elem)};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box), kSub, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(ptr), dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, typename T, bool F32_OUT>
int launch(Params p, cudaStream_t stream) {
  using O = std::conditional_t<F32_OUT, float, T>;
  constexpr size_t smem = Smem<N, T, O>::BYTES;
  constexpr int e = sizeof(T), eo = sizeof(O);
  const int S = p.S, B = p.B, di = p.di;
  Maps m;
  p.tma = (encode3(&m.dt, 4, p.dt, di, S, B, p.dt_ss, p.dt_sb, kCB) ? kTmaDt : 0u) |
          (encode3(&m.dy, 4, p.dy, di, S, B, p.dy_ss, p.dy_sb, kCB) ? kTmaDy : 0u) |
          (encode3(&m.x, e, p.x, di, S, B, p.x_ss, p.x_sb, kCB) ? kTmaX : 0u) |
          (p.b_sn == 1 && p.c_sn == 1 && encode3(&m.b, e, p.b, N, S, B, p.b_ss, p.b_sb, N) &&
                   encode3(&m.c, e, p.c, N, S, B, p.c_ss, p.c_sb, N)
               ? kTmaBC : 0u) |
          (encode3(&m.ddt, 4, p.ddt, di, S, B, di, static_cast<long long>(S) * di, kCB) ? kTmaDdt
                                                                                        : 0u) |
          (encode3(&m.dx, eo, p.dx, di, S, B, di, static_cast<long long>(S) * di, kCB) ? kTmaDx
                                                                                       : 0u);
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_bwd_chunk<N, T, F32_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_blocks = (di + kCB - 1) / kCB;
  mamba_scan_bwd_chunk<N, T, F32_OUT><<<dim3(n_blocks, B), kCB * N / 4, smem, stream>>>(m, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * B * S * N + static_cast<long long>(di) * (N + 1);
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
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11], 0u};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4: return launch_n<4>(x_dtype, out_dtype, p, st);
    case 8: return launch_n<8>(x_dtype, out_dtype, p, st);
    case 16: return launch_n<16>(x_dtype, out_dtype, p, st);
  }
  return -1;
}

// Dynamic shared memory of the chunk kernel at state size d_state, x's dtype
// and the output type (0 fp32, 1 bf16).
extern "C" long long repro_mamba_scan_bwd_smem_bytes(int d_state, int x_dtype, int out_dtype) {
  using bf16 = __nv_bfloat16;
  const int key = d_state * 4 + 2 * (x_dtype != 0) + (out_dtype != 0);
  switch (key) {
    case 16: return Smem<4, float, float>::BYTES;
    case 18: return Smem<4, bf16, float>::BYTES;
    case 19: return Smem<4, bf16, bf16>::BYTES;
    case 32: return Smem<8, float, float>::BYTES;
    case 34: return Smem<8, bf16, float>::BYTES;
    case 35: return Smem<8, bf16, bf16>::BYTES;
    case 64: return Smem<16, float, float>::BYTES;
    case 66: return Smem<16, bf16, float>::BYTES;
    case 67: return Smem<16, bf16, bf16>::BYTES;
  }
  return -1;
}
