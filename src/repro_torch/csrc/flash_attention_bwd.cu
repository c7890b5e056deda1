// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The gradient of the forward in flash_attention.cu, which replaces the
// Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:96).  The reference has no
// backward kernel: it differentiates its jnp attention.  Semantics are the
// forward's: GQA head h -> h / (H / KV), logits y = softcap(s * scale) with
// s = q.k, causal mask kpos <= qpos, sliding window kpos > qpos - window,
// fp32 softmax P.  Query row i sits at position i + q_offset and key row j
// at position j, as in the forward: a rank of a sequence-sharded (WSP)
// zone passes its first position.  The masks, the work lists' key and
// query ranges and the tile skips take the query's position; a key that no
// query sees (past the last query's position under the causal mask, or
// before the first one's window) gets dk = dv = 0.  With D = rowsum(dO * O) = sum_k P (dO . v) and the
// softcap's chain factor f = 1 - (y / cap)^2 (1 without a softcap):
//   dS = P * (dP - D) * f,  dq = scale * dS k,  dk = scale * dS^T q,
//   dv = P^T dO,
// dk and dv summed over the H / KV query heads of their group.  No atomics:
// the same bits on every run.
//
// What bounds it on this card: five products of 2 * (visible pairs) * hd
// FLOPs each per head (q k^T, dO v^T, P^T dO, dS^T q, dS k) against
// |q|+|k|+|v|+|dO| read and |dq|+|dk|+|dv| written: hundreds of FLOPs a
// byte at the training shapes, so operations (989 TFLOP/s bf16), which only
// wgmma reaches.
//
// What the forward hands over.  Its training instantiation writes each
// row's base-2 log-sum-exp, so P = exp2(y log2 e - lse) needs no pass of its
// own, and in bf16 o's residual o_fp32 - bf16(o_fp32); its P V then also
// takes the product of P's bf16 residual, so o + o_res is sum_k P v to ~16
// bits, and D = rowsum(dO (o + o_res)) is one bytes-bound pass
// (fa_bwd_delta).  This route keeps D within the bounds; D from the bf16
// output alone, or from an o whose P was rounded once to bf16, does not:
// where one key holds a row, dS = P (dP - D) is a small difference and a
// 2^-9 error in D (of the row's output, or of its second key's share) is as
// large as it (`attention_bwd_emulated` in kernels/flash_attention/ref.py
// models both).
//
// bf16 at hd 64 and 128: two kernels in the forward's shape (a persistent
// grid, one block an SM: a producer warpgroup whose one thread issues TMA
// loads through an mbarrier ring, two consumer warpgroups on wgmma with the
// registers of setmaxnreg), 7 products where the first version ran 11:
//   * fa_bwd_dq_bf16, one work tile per (128 query rows, head, batch) in the
//     forward's order (causal tiles heaviest first, snake-dealt): Q and dO
//     resident, K and V tiles streamed; S = Q K^T and dP = dO V^T are SS-form
//     wgmma (both operands K-major in shared memory), dQ += dS K is RS-form:
//     dS packed to bf16 from the accumulator registers is the A fragment and
//     K is read MN-major through the transpose bit;
//   * fa_bwd_dkdv_bf16, one work tile per (128 keys, chunk of the group's
//     heads, kv head, batch), key tiles in ascending order (causal: heaviest
//     first): K and V resident, the heads' Q and dO tiles of 64 rows streamed
//     with their log-sum-exp and D (bulk copies); S^T = K Q^T and dP^T = V
//     dO^T are SS-form, dV += P^T dO and dK += dS^T Q RS-form with P^T and
//     dS^T from registers, so P and dS never touch shared memory.  A group
//     is split into chunks only where (key tile, kv head, batch) alone leave
//     SMs idle (granite-20b's MQA: 16 for 132); the chunks' fp32 partial sums
//     are then added in order (fa_bwd_dkdv_sum);
//   * each kernel forms P from S while dP is still on the tensor cores (two
//     commit groups, a wait for the first), and the dk/dv kernel issues dV +=
//     P^T dO before it forms dS; the element-wise work runs in loops with no
//     branch inside (the softcap and the mask decided once a tile: a
//     per-element branch made it as slow as the products);
//   * dk and dv sum a P or dS rounded to bf16 over every query of every head
//     of a group.  Above kResidualGroup heads a kv head (granite-20b's 48 on
//     one miss the bf16 bound by that rounding alone) and under a softcap
//     (whose scaled logits make dk large against the bound's absolute part)
//     they add the products of P's and dS's bf16 residuals: one more RS
//     wgmma each (RESID, which forms P and dS once both products landed).
//     Granite's groups of 4 run without them.
//   Fully masked tiles are never loaded, a warpgroup skips a tile none of
//   whose pairs it sees, and the mask is applied only on tiles some pair of
//   the warpgroup does not see.
// fp32, and bf16 at hd 256: the first version's fa_bwd_dq / fa_bwd_dkdv
// (`mma.sync.m16n8k16` with fp32 accumulation on operands taken from padded
// shared-memory tiles by `ldmatrix` in bf16, P and dS split into a bf16 part
// and residual for dk / dv; CUDA cores in fp32, since the tensor cores would
// round to TF32).  dk and dv of 128 keys at hd 256 (two 64 x 256 fp32
// accumulators a warpgroup, 256 registers a thread) do not fit a consumer's
// registers.  bf16 there takes the forward's log-sum-exp and D from
// fa_bwd_delta; fp32 takes its own (fa_bwd_prep, below, says why).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>    // INFINITY
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Query heads a kv head above which the bf16 dk and dv add the residual
// products (kernels/flash_attention/ref.py RESIDUAL_GROUP holds the same).
constexpr int kResidualGroup = 16;

enum { kQ, kK, kV, kDO, kO, kORes, kDQ, kDK, kDV, kTensors };

struct Params {
  void* t[kTensors];     // q, k, v, dO, o, o_res (bf16; null in fp32), dq, dk, dv
  float* lse;            // [B, H, lse_ld]: the forward's base-2 log-sum-exp; +inf past Sq
  float* delta;          // [B, H, lse_ld]: D of each row; 0 past Sq
  float* row_lse;        // the log-sum-exp P is taken from: lse, or in fp32 fa_bwd_prep's
  long long lse_ld;      // a multiple of 128, >= Sq
  int kv_split;          // bf16 dk/dv: chunks of a group's heads on blocks of their own
  float* part;           // kv_split > 1: [2][kv_split][B][KV][Skv][hd] fp32 dk, dv partial sums
  int B, H, KV, Sq, Skv;
  long long st[kTensors][3];   // (batch, head, seq) strides in elements; hd is unit-stride
  int causal, window;
  int q_offset;          // position of query row 0 (keys start at 0)
  float softcap, scale;
};

// Whether query row `qi` (at position qi + q_offset) sees key `kpos`.
__device__ __forceinline__ bool visible(const Params& p, int qi, int kpos) {
  const int qpos = qi + p.q_offset;
  return qi < p.Sq && kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// Keys [k_begin, k_end) that query rows [q_first, q_last] see.
__device__ __forceinline__ void key_range(const Params& p, int q_first, int q_last, int& k_begin,
                                          int& k_end) {
  k_begin = p.window > 0 ? max(0, q_first + p.q_offset - p.window + 1) : 0;
  k_end = p.causal ? min(p.Skv, q_last + p.q_offset + 1) : p.Skv;
}

// Query rows [q_begin, q_end) that see a key of [k_first, k_last]: position
// >= k (causal), < k + window; empty where no query sees one.
__device__ __forceinline__ void query_range(const Params& p, int k_first, int k_last, int& q_begin,
                                            int& q_end) {
  q_begin = p.causal ? max(0, k_first - p.q_offset) : 0;
  q_end = p.window > 0 ? min(p.Sq, k_last + p.window - p.q_offset) : p.Sq;
}

__device__ __forceinline__ float logit(const Params& p, float s) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

// The softcap's chain factor d/dx cap tanh(x / cap) = 1 - u^2, from
// u = tanh(x / cap); every kernel here takes it from this function.
__device__ __forceinline__ float softcap_chain(float u) {
  return 1.f - u * u;
}

template <typename T>
__device__ __forceinline__ T* tensor(const Params& p, int which, int b, int h) {
  return static_cast<T*>(p.t[which]) + b * p.st[which][0] + h * p.st[which][1];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x less its bf16 rounding: the part a bf16 store of x drops
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

// ------------------------------------------------------------ D, lse padding

// D = rowsum(dO (o + o_res)) of each query row of bf16 inputs: HD / 8 lanes
// a row, 16-byte loads.  Rows past Sq (up to lse_ld) get D = 0 and a
// log-sum-exp of +inf, so that the P of a zero-filled row of a tile is
// exp2(-inf) = 0.
template <int HD>
__global__ void __launch_bounds__(kThreads) fa_bwd_delta(Params p) {
  constexpr int LANES = HD / 8;   // lanes of a row
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  const bool in = row < static_cast<long long>(p.B) * p.H * p.lse_ld;
  const int q = static_cast<int>(row % p.lse_ld);
  const int h = static_cast<int>((row / p.lse_ld) % p.H);
  const int b = static_cast<int>(row / (p.lse_ld * p.H));
  float acc = 0.f;
  if (in && q < p.Sq) {
    const int c = 8 * lane;
    const uint4 ov = *reinterpret_cast<const uint4*>(tensor<const __nv_bfloat16>(p, kO, b, h) +
                                                     q * p.st[kO][2] + c);
    const uint4 rv = *reinterpret_cast<const uint4*>(tensor<const __nv_bfloat16>(p, kORes, b, h) +
                                                     q * p.st[kORes][2] + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(tensor<const __nv_bfloat16>(p, kDO, b, h) +
                                                     q * p.st[kDO][2] + c);
    const uint32_t* o2 = &ov.x;
    const uint32_t* r2 = &rv.x;
    const uint32_t* d2 = &dv.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o2 + i));
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r2 + i));
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d2 + i));
      acc = fmaf(d.x, o.x + r.x, fmaf(d.y, o.y + r.y, acc));
    }
  }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    p.delta[row] = acc;
    if (q >= p.Sq) p.lse[row] = INFINITY;
  }
}

// ------------------------------------------- bf16 at hd 64 / 128: wgmma, TMA

constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1, producer 2

template <int HD>
struct WgTiles {
  static constexpr int BOXES = HD / 64;           // 128-byte column boxes per row
  // setmaxnreg: 2 x 128 x CONSUMER + 128 x PRODUCER <= 64K registers
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
  // dq: 128 query rows (64 a consumer warpgroup) resident with their dO;
  // key tiles of BK streamed.  S and dP (BK/2 fp32 each) and dQ (HD/2) of a
  // consumer thread live together.
  static constexpr int BK = HD == 64 ? 128 : 64;
  static constexpr int DQ_STAGES = HD == 64 ? 5 : 4;
  static constexpr uint32_t DQ_ROWS_BYTES = 128 * HD * 2;   // Q or dO of a work tile
  static constexpr uint32_t DQ_KV_BYTES = BK * HD * 2;      // one K or V tile
  static constexpr uint32_t DQ_BAR = 2 * DQ_ROWS_BYTES + 2 * DQ_STAGES * DQ_KV_BYTES;
  // + 1024: the buffer is realigned to 1024 bytes; then the mbarriers full_q,
  // full_k / full_v / empty per stage, empty_q
  static constexpr size_t DQ_SMEM = 1024 + DQ_BAR + 8 * (2 + 3 * DQ_STAGES);
  // dk/dv: 128 keys (64 a consumer warpgroup) resident with their V; query
  // tiles of BM streamed with their log-sum-exp and D.  S^T and dP^T (BM/2
  // each), dK and dV (HD/2 each) of a consumer thread live together.
  static constexpr int BM = 64;
  static constexpr int KV_STAGES = HD == 64 ? 6 : 4;
  static constexpr uint32_t KV_ROWS_BYTES = 128 * HD * 2;   // K or V of a work tile
  static constexpr uint32_t KV_Q_BYTES = BM * HD * 2;       // one Q or dO tile
  static constexpr uint32_t KV_STAT_BYTES = BM * 4;         // its lse or D
  static constexpr uint32_t KV_STAT = 2 * KV_ROWS_BYTES + 2 * KV_STAGES * KV_Q_BYTES;
  static constexpr uint32_t KV_BAR = KV_STAT + 2 * KV_STAGES * KV_STAT_BYTES;
  // then the mbarriers full_kv, full_q / full_do / empty per stage, empty_kv
  static constexpr size_t KV_SMEM = 1024 + KV_BAR + 8 * (2 + 3 * KV_STAGES);
};

// This block's work of round n: round n hands work n*G .. n*G + G-1 to the G
// blocks, in reverse order every second round (a snake), which evens out a
// list sorted heaviest first.
__device__ __forceinline__ int work_index(int n) {
  const int G = gridDim.x;
  return n * G + ((n & 1) ? G - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x));
}

// P and dS of one (query, key) pair from the raw s = q.k and dP = dO.v, P
// as the bf16 forward computes it (exp2 of y log2 e - lse).
__device__ __forceinline__ float grad_pair(const Params& p, float s, float dp, float lse,
                                           float delta, bool vis, float& P) {
  float f = 1.f;
  if (p.softcap > 0.f) {
    const float u = tanhf(s * (p.scale / p.softcap));
    const float y2 = p.softcap * kLog2e * u;
    f = softcap_chain(u);
    P = vis ? ex2(y2 - lse) : 0.f;
  } else {
    P = vis ? ex2(fmaf(s, p.scale * kLog2e, -lse)) : 0.f;   // the forward's rounding
  }
  return P * (dp - delta) * f;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Params p) {
  using T = WgTiles<HD>;
  constexpr int BQ = 128, BK = T::BK, STAGES = T::DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 8 rows x 128 bytes: tiles start 1024-aligned.
  // Q, dO: BOXES column boxes of [BQ][64]; each K / V stage BOXES of [BK][64].
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + T::DQ_ROWS_BYTES;
  const uint32_t sKV = base + 2 * T::DQ_ROWS_BYTES;   // K stages, then V stages
  const uint32_t bars = base + T::DQ_BAR;
  const uint32_t full_q = bars, empty_q = bars + 8u * (1 + 3 * STAGES);
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  // The forward's work list: (q tile, batch, head), head fastest, causal q
  // tiles in descending order.
  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  const int n_work = q_tiles * p.B * p.H;
  struct Work {
    int h, b, q0, k_first, n_tiles;
  };
  auto work = [&](int w) {
    Work x;
    x.h = w % p.H;
    x.b = (w / p.H) % p.B;
    const int z = w / (p.H * p.B);
    x.q0 = (p.causal ? q_tiles - 1 - z : z) * BQ;
    int k_begin, k_end;
    key_range(p, x.q0, min(x.q0 + BQ, p.Sq) - 1, k_begin, k_end);
    x.k_first = (k_begin / BK) * BK;
    x.n_tiles = k_end > x.k_first ? (k_end - x.k_first + BK - 1) / BK : 0;
    return x;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2 * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role is read through a shuffle so the compiler knows it is uniform
  // in the warp: wgmma under a branch it cannot prove uniform is serialized.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0;   // K/V tiles loaded so far: the ring's position
#pragma unroll 1
      for (int n = 0, w = work_index(0); w < n_work; w = work_index(++n)) {
        const Work x = work(w);
        const int kvh = x.h / (p.H / p.KV);
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);   // the last tile's Q, dO are done with
        mbar_expect_tx(full_q, 2 * T::DQ_ROWS_BYTES);
#pragma unroll 1
        for (int c = 0; c < T::BOXES; ++c) {
          tma_load_4d(sQ + c * BQ * 128, &tq, full_q, c * 64, x.q0, x.h, x.b);
          tma_load_4d(sDO + c * BQ * 128, &tdo, full_q, c * 64, x.q0, x.h, x.b);
        }
#pragma unroll 1
        for (int i = 0; i < x.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
          const int k0 = x.k_first + i * BK;
          const uint32_t sK = sKV + s * T::DQ_KV_BYTES, sV = sKV + (STAGES + s) * T::DQ_KV_BYTES;
          mbar_expect_tx(full_k(s), T::DQ_KV_BYTES);
#pragma unroll 1
          for (int c = 0; c < T::BOXES; ++c)
            tma_load_4d(sK + c * BK * 128, &tk, full_k(s), c * 64, k0, kvh, x.b);
          mbar_expect_tx(full_v(s), T::DQ_KV_BYTES);
#pragma unroll 1
          for (int c = 0; c < T::BOXES; ++c)
            tma_load_4d(sV + c * BK * 128, &tv, full_v(s), c * 64, k0, kvh, x.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t sQw = sQ + wg * 64 * 128, sDOw = sDO + wg * 64 * 128;   // this warpgroup's rows
    const float sl2 = p.scale * kLog2e;   // y log2 e = s sl2, or cap_out tanh(s cap_in)
    const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
    const float cap_out = p.softcap * kLog2e;

    float dq[HD / 2];
    float sc[BK / 2];          // S of the tile, then dS
    float dp[BK / 2];          // dP of the tile
    uint32_t ds[BK / 16][4];   // dS, bf16: the A fragments of dS K

    int it = 0;   // K/V tiles consumed so far: the ring's position
#pragma unroll 1
    for (int n = 0, w = work_index(0); w < n_work; w = work_index(++n)) {
      const Work x = work(w);
      const int wq_lo = x.q0 + wg * 64;
      const int qr0 = wq_lo + warp * 16 + g, qr1 = qr0 + 8;   // this thread's rows
      const long long rows = (static_cast<long long>(x.b) * p.H + x.h) * p.lse_ld;
      const float lse0 = p.lse[rows + qr0], lse1 = p.lse[rows + qr1];   // lse_ld % 128 == 0
      const float d0 = p.delta[rows + qr0], d1 = p.delta[rows + qr1];
      auto slot = [&](int i) { return (it + i) % STAGES; };
      auto k_tile = [&](int i) { return sKV + slot(i) * T::DQ_KV_BYTES; };
      // S = Q K^T and dP = dO V^T of key tile i into sc and dp, issued (not
      // waited for)
      auto issue_ss = [&](int i) {
        const uint32_t ph = ((it + i) / STAGES) & 1;
        const uint32_t sK = k_tile(i), sV = sKV + (STAGES + slot(i)) * T::DQ_KV_BYTES;
        mbar_wait(full_k(slot(i)), ph);
        wgmma_fence();   // sc, dp were last written by plain code
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * BQ * 128 + (kk % 4) * 32;   // 16 columns = 32 bytes
          Wgmma<BK>::ss(sc, sw128_desc(sQw + off, 16, 1024),
                        sw128_desc(sK + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();   // S, then dP: two groups, so S can be waited for alone
        mbar_wait(full_v(slot(i)), ph);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          Wgmma<BK>::ss(dp, sw128_desc(sDOw + off, 16, 1024),
                        sw128_desc(sV + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
      mbar_wait(full_q, n & 1);
      // Step i: S_i and dP_i, dS_i (while the other warpgroup's products
      // run), dQ += dS_i K_i.
#pragma unroll 1
      for (int i = 0; i < x.n_tiles; ++i) {
        const int k0 = x.k_first + i * BK;
        issue_ss(i);
        // P f while dP is still on the tensor cores (f, the softcap's chain
        // factor, is 1 without a cap), then dS = P f (dP - D).  Element e:
        // row g (e & 2: g + 8), column 8 (e / 4) + 2t + (e & 1).
        wgmma_wait<1>();
        fence_operands(sc);
        if (p.softcap > 0.f) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const float u = tanhf(sc[e] * cap_in);
            sc[e] = ex2(cap_out * u - ((e & 2) ? lse1 : lse0)) * softcap_chain(u);
          }
        } else {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) sc[e] = ex2(fmaf(sc[e], sl2, -((e & 2) ? lse1 : lse0)));
        }
        // A tile every row of the warpgroup sees in full needs no mask.
        const int wpos = wq_lo + p.q_offset;   // the warpgroup's first query position
        const bool full = k0 + BK <= p.Skv && wq_lo + 63 < p.Sq &&
                          (!p.causal || k0 + BK - 1 <= wpos) &&
                          (p.window <= 0 || k0 > wpos + 63 - p.window);
        if (!full) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e)
            if (!visible(p, (e & 2) ? qr1 : qr0, k0 + (e / 4) * 8 + 2 * t + (e & 1))) sc[e] = 0.f;
        }
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= dp[e] - ((e & 2) ? d1 : d0);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        wgmma_fence();   // dq and the packed dS are wgmma's input
        // dQ += dS K: two 8-key column tiles of dS form one 16-key A fragment;
        // K rows kk*16.. of every column box, MN-major.
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<HD>::rs(dq, ds[kk], sw128_desc(k_tile(i) + kk * 16 * 128, BK * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dq);
        fence_operands(ds);
        mbar_arrive(empty(slot(i)));   // this thread is done with the slot's K and V
      }
      mbar_arrive(empty_q);     // this thread is done with the work tile's Q and dO
      it += x.n_tiles;

      __nv_bfloat16* dqg = tensor<__nv_bfloat16>(p, kDQ, x.b, x.h);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (qr0 < p.Sq)
          *reinterpret_cast<uint32_t*>(dqg + qr0 * p.st[kDQ][2] + col) =
              pack_bf16(dq[4 * j + 0] * p.scale, dq[4 * j + 1] * p.scale);
        if (qr1 < p.Sq)
          *reinterpret_cast<uint32_t*>(dqg + qr1 * p.st[kDQ][2] + col) =
              pack_bf16(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
      }
    }
  }
}

template <int HD, bool RESID>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = WgTiles<HD>;
  constexpr int BN = 128, BM = T::BM, STAGES = T::KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // K, V: BOXES column boxes of [BN][64]; each Q / dO stage BOXES of [BM][64];
  // then each stage's lse and D rows (fp32), then the mbarriers.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // generic address of base
  const uint32_t sK = base, sV = base + T::KV_ROWS_BYTES;
  auto sQ = [&](int s) { return base + 2 * T::KV_ROWS_BYTES + s * T::KV_Q_BYTES; };
  auto sDO = [&](int s) { return base + 2 * T::KV_ROWS_BYTES + (STAGES + s) * T::KV_Q_BYTES; };
  auto sL = [&](int s) { return T::KV_STAT + s * T::KV_STAT_BYTES; };              // from base
  auto sD = [&](int s) { return T::KV_STAT + (STAGES + s) * T::KV_STAT_BYTES; };
  const uint32_t bars = base + T::KV_BAR;
  const uint32_t full_kv = bars, empty_kv = bars + 8u * (1 + 3 * STAGES);
  auto full_q = [&](int s) { return bars + 8u * (1 + s); };
  auto full_do = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  // Work list: (key tile, chunk of the group's heads, batch, kv head), kv
  // head fastest, key tiles in ascending order (under the causal mask the
  // first sees the most queries).  A group splits into kv_split chunks only
  // where (key tile, batch, kv head) alone leave SMs idle (granite-20b's
  // MQA: 16 for 132); each chunk then writes fp32 partial sums, which
  // fa_bwd_dkdv_sum adds in order.
  const int group = p.H / p.KV;
  const int k_tiles = (p.Skv + BN - 1) / BN;
  const int n_work = k_tiles * p.kv_split * p.B * p.KV;
  struct Work {
    int kvh, b, c, h0, nh, k0, q_first, n_q;
  };
  auto work = [&](int w) {
    Work x;
    x.kvh = w % p.KV;
    x.b = (w / p.KV) % p.B;
    x.c = (w / (p.KV * p.B)) % p.kv_split;
    x.h0 = x.c * group / p.kv_split;
    x.nh = (x.c + 1) * group / p.kv_split - x.h0;
    x.k0 = (w / (p.KV * p.B * p.kv_split)) * BN;
    int q_begin, q_end;
    query_range(p, x.k0, min(x.k0 + BN, p.Skv) - 1, q_begin, q_end);
    x.q_first = (q_begin / BM) * BM;
    x.n_q = q_end > x.q_first ? (q_end - x.q_first + BM - 1) / BM : 0;
    return x;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 2 * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_q(s), 1);
      mbar_init(full_do(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0;   // Q/dO tiles loaded so far: the ring's position
#pragma unroll 1
      for (int n = 0, w = work_index(0); w < n_work; w = work_index(++n)) {
        const Work x = work(w);
        if (n > 0) mbar_wait(empty_kv, (n - 1) & 1);   // the last tile's K, V are done with
        mbar_expect_tx(full_kv, 2 * T::KV_ROWS_BYTES);
#pragma unroll 1
        for (int c = 0; c < T::BOXES; ++c) {
          tma_load_4d(sK + c * BN * 128, &tk, full_kv, c * 64, x.k0, x.kvh, x.b);
          tma_load_4d(sV + c * BN * 128, &tv, full_kv, c * 64, x.k0, x.kvh, x.b);
        }
#pragma unroll 1
        for (int hh = 0; hh < x.nh; ++hh) {
          const int h = x.kvh * group + x.h0 + hh;
          const long long rows = (static_cast<long long>(x.b) * p.H + h) * p.lse_ld;
#pragma unroll 1
          for (int i = 0; i < x.n_q; ++i, ++it) {
            const int s = it % STAGES, q0 = x.q_first + i * BM;
            if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
            mbar_expect_tx(full_q(s), T::KV_Q_BYTES + T::KV_STAT_BYTES);
#pragma unroll 1
            for (int c = 0; c < T::BOXES; ++c)
              tma_load_4d(sQ(s) + c * BM * 128, &tq, full_q(s), c * 64, q0, h, x.b);
            bulk_load(base + sL(s), p.lse + rows + q0, T::KV_STAT_BYTES, full_q(s));
            mbar_expect_tx(full_do(s), T::KV_Q_BYTES + T::KV_STAT_BYTES);
#pragma unroll 1
            for (int c = 0; c < T::BOXES; ++c)
              tma_load_4d(sDO(s) + c * BM * 128, &tdo, full_do(s), c * 64, q0, h, x.b);
            bulk_load(base + sD(s), p.delta + rows + q0, T::KV_STAT_BYTES, full_do(s));
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;   // this warpgroup's keys
    const float sl2 = p.scale * kLog2e;   // y log2 e = s sl2, or cap_out tanh(s cap_in)
    const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
    const float cap_out = p.softcap * kLog2e;

    float dk[HD / 2], dv[HD / 2];
    float sc[BM / 2];               // S^T of the tile, then P^T
    float dp[BM / 2];               // dP^T of the tile, then dS^T
    uint32_t pp[BM / 16][4], dsp[BM / 16][4];   // P^T, dS^T in bf16 (or their residuals): A fragments

    int it = 0;   // Q/dO tiles consumed so far
#pragma unroll 1
    for (int n = 0, w = work_index(0); w < n_work; w = work_index(++n)) {
      const Work x = work(w);
      const int kw = x.k0 + wg * 64;                       // this warpgroup's first key
      const int kr0 = kw + warp * 16 + g, kr1 = kr0 + 8;   // this thread's keys
      // Query tile j of the work tile: head h0 + j / n_q of the group, rows
      // q_first + (j % n_q) BM; ring slot and phase.
      const int total = x.nh * x.n_q;
      auto q_row = [&](int j) { return x.q_first + (j % x.n_q) * BM; };
      auto slot = [&](int j) { return (it + j) % STAGES; };
      auto phase = [&](int j) { return static_cast<uint32_t>(((it + j) / STAGES) & 1); };
      // No pair of tile j is visible to this warpgroup's keys: skip it.
      auto none = [&](int j) {
        const int q0 = q_row(j) + p.q_offset;   // the tile's first query position
        return kw >= p.Skv || (p.causal && q0 + BM - 1 < kw) ||
               (p.window > 0 && q0 - (kw + 63) >= p.window);
      };
      // S^T = K Q^T and dP^T = V dO^T of tile j into sc and dp, issued (not
      // waited for)
      auto issue_ss = [&](int j) {
        const int s = slot(j);
        mbar_wait(full_q(s), phase(j));
        wgmma_fence();   // sc, dp were last written by plain code
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the box
          Wgmma<BM>::ss(sc, sw128_desc(sKw + (kk / 4) * BN * 128 + off, 16, 1024),
                        sw128_desc(sQ(s) + (kk / 4) * BM * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();   // S^T, then dP^T: two groups, so S^T can be waited for alone
        mbar_wait(full_do(s), phase(j));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          Wgmma<BM>::ss(dp, sw128_desc(sVw + (kk / 4) * BN * 128 + off, 16, 1024),
                        sw128_desc(sDO(s) + (kk / 4) * BM * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      // dV += P^T dO (or dK += dS^T Q) from the packed fragments a: dO (Q) rows
      // kk*16.. of every column box, MN-major.
      auto issue_rs = [&](float (&acc)[HD / 2], const uint32_t (&a)[BM / 16][4], uint32_t sB) {
        wgmma_fence();   // acc and the fragments are wgmma's input
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          Wgmma<HD>::rs(acc, a[kk], sw128_desc(sB + kk * 16 * 128, BM * 128, 1024));
        wgmma_commit();
      };
      auto settle = [&]() {   // every product issued has landed
        wgmma_wait<0>();
        fence_operands(sc);
        fence_operands(dp);
        fence_operands(dk);
        fence_operands(dv);
        fence_operands(pp);
        fence_operands(dsp);
      };
      auto pack = [&](uint32_t (&a)[BM / 16][4], const float (&x)[BM / 2]) {
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(full_kv, n & 1);
      // Step j: S^T_j and dP^T_j; P^T_j while dP^T_j is still on the tensor
      // cores, dV += P^T_j dO while dS^T_j is formed, then dK += dS^T_j Q.
      // RESID (the residual products, and every softcap) forms P and dS
      // once both products have landed, and issues dV and dK together, then
      // the products of their bf16 residuals.  Element e of a tile: key g
      // (e & 2: g + 8), query 8 (e / 4) + 2t + (e & 1).
#pragma unroll 1
      for (int j = 0; j < total; ++j) {
        const int s = slot(j), q0 = q_row(j);
        if (none(j)) {
          mbar_wait(full_q(s), phase(j));
          mbar_wait(full_do(s), phase(j));
          mbar_arrive(empty(s));
          continue;
        }
        const int qpos = q0 + p.q_offset;
        const bool full = kw + 63 < p.Skv && q0 + BM - 1 < p.Sq &&
                          (!p.causal || qpos >= kw + 63) &&
                          (p.window <= 0 || qpos + BM - 1 - kw < p.window);
        const float* lse = reinterpret_cast<const float*>(gbase + sL(s));
        const float* delta = reinterpret_cast<const float*>(gbase + sD(s));
        auto col = [&](int e) { return 8 * (e / 4) + 2 * t + (e & 1); };
        auto mask = [&](float (&x)[BM / 2]) {
          if (!full) {
#pragma unroll
            for (int e = 0; e < BM / 2; ++e)
              if (!visible(p, q0 + col(e), (e & 2) ? kr1 : kr0)) x[e] = 0.f;
          }
        };
        issue_ss(j);
        if constexpr (!RESID) {   // no softcap here: f = 1
          wgmma_wait<1>();
          fence_operands(sc);
#pragma unroll
          for (int e = 0; e < BM / 2; ++e) sc[e] = ex2(fmaf(sc[e], sl2, -lse[col(e)]));
          mask(sc);
          pack(pp, sc);
          issue_rs(dv, pp, sDO(s));
          wgmma_wait<1>();   // dP^T has landed; dV may still run
          fence_operands(dp);
#pragma unroll
          for (int e = 0; e < BM / 2; ++e) dp[e] = sc[e] * (dp[e] - delta[col(e)]);
          pack(dsp, dp);
          issue_rs(dk, dsp, sQ(s));
          settle();
        } else {
          settle();
          if (p.softcap > 0.f) {
#pragma unroll
            for (int e = 0; e < BM / 2; ++e) {
              const float u = tanhf(sc[e] * cap_in);
              sc[e] = ex2(cap_out * u - lse[col(e)]);
              dp[e] = sc[e] * softcap_chain(u) * (dp[e] - delta[col(e)]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < BM / 2; ++e) {
              sc[e] = ex2(fmaf(sc[e], sl2, -lse[col(e)]));
              dp[e] = sc[e] * (dp[e] - delta[col(e)]);
            }
          }
          mask(sc);
          mask(dp);
          pack(pp, sc);
          pack(dsp, dp);
          issue_rs(dv, pp, sDO(s));
          issue_rs(dk, dsp, sQ(s));
          settle();   // then the products of what the bf16 rounding dropped
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = 8 * kk + 2 * i;
              pp[kk][i] = pack_bf16(bf16_residual(sc[e]), bf16_residual(sc[e + 1]));
              dsp[kk][i] = pack_bf16(bf16_residual(dp[e]), bf16_residual(dp[e + 1]));
            }
          issue_rs(dv, pp, sDO(s));
          issue_rs(dk, dsp, sQ(s));
          settle();
        }
        mbar_arrive(empty(s));   // this thread is done with the slot
      }
      it += total;
      mbar_arrive(empty_kv);       // and with the work tile's K and V

      if (p.kv_split > 1) {   // this chunk's partial sums, fp32
        const long long chunk = static_cast<long long>(p.B) * p.KV * p.Skv * HD;
        float* pk = p.part + x.c * chunk + ((static_cast<long long>(x.b) * p.KV + x.kvh) * p.Skv) * HD;
        float* pv = pk + p.kv_split * chunk;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (kr0 < p.Skv) {
            store2(pk + kr0 * HD + col, dk[4 * j + 0], dk[4 * j + 1]);
            store2(pv + kr0 * HD + col, dv[4 * j + 0], dv[4 * j + 1]);
          }
          if (kr1 < p.Skv) {
            store2(pk + kr1 * HD + col, dk[4 * j + 2], dk[4 * j + 3]);
            store2(pv + kr1 * HD + col, dv[4 * j + 2], dv[4 * j + 3]);
          }
        }
      } else {
        __nv_bfloat16* dkg = tensor<__nv_bfloat16>(p, kDK, x.b, x.kvh);
        __nv_bfloat16* dvg = tensor<__nv_bfloat16>(p, kDV, x.b, x.kvh);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (kr0 < p.Skv) {
            store2(dkg + kr0 * p.st[kDK][2] + col, dk[4 * j + 0] * p.scale, dk[4 * j + 1] * p.scale);
            store2(dvg + kr0 * p.st[kDV][2] + col, dv[4 * j + 0], dv[4 * j + 1]);
          }
          if (kr1 < p.Skv) {
            store2(dkg + kr1 * p.st[kDK][2] + col, dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
            store2(dvg + kr1 * p.st[kDV][2] + col, dv[4 * j + 2], dv[4 * j + 3]);
          }
        }
      }
    }
  }
}

// dk, dv of a group split into kv_split chunks: the chunks' partial sums in
// chunk order (the same bits on every run), dk times the scale, to bf16.
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_sum(Params p, int hd) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;   // a pair
  const long long chunk = static_cast<long long>(p.B) * p.KV * p.Skv * hd;
  if (2 * i >= chunk) return;
  const int col = static_cast<int>((2 * i) % hd);
  const long long rest = 2 * i / hd;   // (b * KV + kvh) * Skv + row
  const int row = static_cast<int>(rest % p.Skv);
  const int kvh = static_cast<int>((rest / p.Skv) % p.KV);
  const int b = static_cast<int>(rest / (static_cast<long long>(p.Skv) * p.KV));
  float2 k2 = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
  for (int c = 0; c < p.kv_split; ++c) {
    const float2 a = load2(p.part + c * chunk + 2 * i);
    const float2 v = load2(p.part + (p.kv_split + c) * chunk + 2 * i);
    k2.x += a.x;
    k2.y += a.y;
    v2.x += v.x;
    v2.y += v.y;
  }
  store2(tensor<__nv_bfloat16>(p, kDK, b, kvh) + row * p.st[kDK][2] + col, k2.x * p.scale,
         k2.y * p.scale);
  store2(tensor<__nv_bfloat16>(p, kDV, b, kvh) + row * p.st[kDV][2] + col, v2.x, v2.y);
}

// ------------------------------- fp32, and bf16 at hd 256: mma.sync / CUDA cores

// Rows a block owns (BM) and rows of each tile it loops over (BN), as 16-row
// strips x WN column parts over the eight warps.  fp32 at hd 256 halves both
// to fit shared memory.
template <typename T, int HD>
struct Tiles {
  static constexpr int BM = (sizeof(T) == 4 && HD == 256) ? 32 : 64;
  static constexpr int BN = BM;
  static constexpr int WM = BM / 16;
  static constexpr int WN = kWarps / WM;
  static constexpr int PAD = 16 / sizeof(T);     // 16 bytes: rows stay 16-byte aligned, banks shift
  static constexpr int LD = HD + PAD;            // q / k / v / dO tiles
  static constexpr int LDP = BN + PAD;           // P and dS tiles
  static constexpr int NA = BN / WN / 8;         // n8 tiles of a warp's slice of S
  static constexpr int NB = HD / WN / 8;         // n8 tiles of a warp's slice of a gradient
  static constexpr bool SPLIT = sizeof(T) == 2;  // P, dS as bf16 part + bf16 residual for dk, dv
  static constexpr size_t SMEM = (2 * BM + 2 * BN) * LD * sizeof(T) +
                                 (SPLIT ? 4 : 2) * BM * LDP * sizeof(T) + 2 * BN * sizeof(float);
  static constexpr size_t SMEM_PREP = (2 * BM + 2 * BN) * LD * sizeof(T) + 2 * WN * BM * sizeof(float);
  static_assert(NA >= 1 && NB >= 1 && (sizeof(T) == 4 || (NA % 2 == 0 && NB % 2 == 0)),
                "tile split");
};

// Rows [row0, row0 + ROWS) of a [n, HD] strided tile into shared memory
// (row stride LD), 16 bytes a thread; rows past n read as zero.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long ss, int row0, int n) {
  constexpr int VEC = 16 / sizeof(T), CH = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = __ldg(reinterpret_cast<const uint4*>(g + (row0 + r) * ss + c));
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// ------------------------------------------------------- warp-level products
//
// acc[NT][4] += A (16 x K) * B (K x 8 NT), accumulator in the mma.m16n8
// layout: lane (g, t) = (lane / 4, lane % 4) holds rows g, g + 8 and columns
// 2t, 2t + 1 of each n8 tile.  A(m, k) = sA[m * lda + k].  B_NK: B(k, n) =
// sB[n * ldb + k] (a row-major tile used transposed, as k^T in q k^T);
// otherwise B(k, n) = sB[k * ldb + n].

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: ldmatrix fragments, lane l addresses row l % 8 of 8x8 matrix l / 8.
// A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
// B: matrices (k 0-7 | n 0-7), (k 8-15 | n 0-7), (k 0-7 | n 8-15),
// (k 8-15 | n 8-15): b0, b1 of n tile j, then of n tile j + 1.
template <int NT, int K, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* sA, int lda,
                                         const __nv_bfloat16* sB, int ldb) {
  const int lane = threadIdx.x & 31, l8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, sA + ((mi & 1) * 8 + l8) * lda + kk + (mi >> 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      if (B_NK)
        ldsm_x4(b, sB + (j * 8 + (mi >> 1) * 8 + l8) * ldb + kk + (mi & 1) * 8);
      else
        ldsm_x4_trans(b, sB + (kk + (mi & 1) * 8 + l8) * ldb + j * 8 + (mi >> 1) * 8);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// fp32: the same accumulator layout on CUDA cores.
template <int NT, int K, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* sA, int lda,
                                         const float* sB, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = sA[g * lda + k], a1 = sA[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + 2 * t;
      const float b0 = B_NK ? sB[n * ldb + k] : sB[k * ldb + n];
      const float b1 = B_NK ? sB[(n + 1) * ldb + k] : sB[k * ldb + n + 1];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// P and dS of one (query, key) pair from s = q.k and dp = dO.v, P computed
// as the forward of the same dtype computed it (bf16: as grad_pair, from the
// forward's log-sum-exp) or, in fp32, as fa_bwd_prep did when it formed D:
// where one key holds a row, dS = P (dP - D) is a small difference, which an
// element-wise mismatch of a few units in the last place of P moves by a
// percent.
template <typename T>
__device__ __forceinline__ void grad_logit(const Params& p, bool vis, float s, float dp,
                                           float lse, float delta, float& P, float& dS) {
  if constexpr (sizeof(T) == 2) {
    dS = grad_pair(p, s, dp, lse, delta, vis, P);
  } else {
    const float y = logit(p, s);
    const float f = p.softcap > 0.f ? softcap_chain(y / p.softcap) : 1.f;
    P = vis ? exp2f(y * kLog2e - lse) : 0.f;
    dS = P * (dp - delta) * f;
  }
}

// Store a warp's 16 x 8 NT accumulator slice, times `mul`, at rows [row0,
// row0 + 16) (those below n_rows) of a row-major tile with row stride ld.
template <int NT, typename T>
__device__ __forceinline__ void store_acc(T* dst, long long ld, int row0, int n_rows,
                                          const float (&acc)[NT][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(dst + row * ld + j * 8 + 2 * t, acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// ------------------------------------------------------------------ kernels

// fp32: each row's own log-sum-exp and D, in one pass over the key tiles it
// sees, shifted by the forward's log-sum-exp (so every term exp2(y log2 e -
// lse) is at most ~1 and no running max is needed): l = sum of the terms,
// a = sum of the terms times dP; the row's lse + log2 l and D = a / l.  A
// log-sum-exp rounded to fp32 near the row's largest logit scales a row's P
// by up to ~3e-6, harmless in dS = P (dP - D) alone, but not in a D formed
// from the same P (where one key holds a row that bias alone moved dq by
// 3.5e-2 of the row's rms at gemma2's softcap, over the 1e-2 bound); D = a /
// l does not carry it, and D from the fp32 output differs from the sum of P
// dP in its own rounding (1.8e-2).
template <int HD>
__global__ void __launch_bounds__(kThreads) fa_bwd_prep(Params p) {
  using C = Tiles<float, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sO = sQ + C::BM * C::LD;     // dO
  float* sK = sO + C::BM * C::LD;
  float* sV = sK + C::BN * C::LD;
  float* sL = sV + C::BN * C::LD;     // [WN][BM] partial sums of the terms
  float* sA = sL + C::WN * C::BM;     // [WN][BM] and of the terms times dP

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16, part = warp / C::WM, c0 = part * (C::BN / C::WN);
  const int q_lo = blockIdx.x * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.lse_ld;

  load_rows<float, HD, C::BM, C::LD>(sQ, tensor<const float>(p, kQ, b, h), p.st[kQ][2], q_lo, p.Sq);
  load_rows<float, HD, C::BM, C::LD>(sO, tensor<const float>(p, kDO, b, h), p.st[kDO][2], q_lo,
                                     p.Sq);
  float shift[2], l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_lo + r0 + g + 8 * half;
    shift[half] = row < p.Sq ? p.lse[row_base + row] : INFINITY;
  }
  const float* kg = tensor<const float>(p, kK, b, kvh);
  const float* vg = tensor<const float>(p, kV, b, kvh);
  int k_begin, k_end;
  key_range(p, q_lo, min(q_lo + C::BM, p.Sq) - 1, k_begin, k_end);
  for (int k0 = (k_begin / C::BN) * C::BN; k0 < k_end; k0 += C::BN) {
    __syncthreads();
    load_rows<float, HD, C::BN, C::LD>(sK, kg, p.st[kK][2], k0, p.Skv);
    load_rows<float, HD, C::BN, C::LD>(sV, vg, p.st[kV][2], k0, p.Skv);
    __syncthreads();
    float s[C::NA][4], dp[C::NA][4];
    zero(s);
    zero(dp);
    warp_mma<C::NA, HD, true>(s, sQ + r0 * C::LD, C::LD, sK + c0 * C::LD, C::LD);
    warp_mma<C::NA, HD, true>(dp, sO + r0 * C::LD, C::LD, sV + c0 * C::LD, C::LD);
#pragma unroll
    for (int j = 0; j < C::NA; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float term, dS;
          grad_logit<float>(p, visible(p, q_lo + r0 + g + 8 * half, k0 + c0 + j * 8 + 2 * t + e),
                            s[j][2 * half + e], dp[j][2 * half + e], shift[half], 0.f, term, dS);
          l[half] += term;
          a[half] = fmaf(term, dp[j][2 * half + e], a[half]);
        }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad that shares a row
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], off);
      a[half] += __shfl_xor_sync(0xffffffffu, a[half], off);
    }
    if (t == 0) {
      sL[part * C::BM + r0 + g + 8 * half] = l[half];
      sA[part * C::BM + r0 + g + 8 * half] = a[half];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < C::BM; r += kThreads) {
    if (q_lo + r >= p.Sq) continue;
    float sum = 0.f, dsum = 0.f;
    for (int w = 0; w < C::WN; ++w) {
      sum += sL[w * C::BM + r];
      dsum += sA[w * C::BM + r];
    }
    p.row_lse[row_base + q_lo + r] = sum > 0.f ? p.lse[row_base + q_lo + r] + log2f(sum) : INFINITY;
    p.delta[row_base + q_lo + r] = sum > 0.f ? dsum / sum : 0.f;
  }
}

// dq of one query tile: loop over the key tiles it sees.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq(Params p) {
  using C = Tiles<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + C::BM * C::LD;     // dO
  T* sK = sO + C::BM * C::LD;
  T* sV = sK + C::BN * C::LD;
  T* sS = sV + C::BN * C::LD;     // dS [BM][LDP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16, part = warp / C::WM;
  const int c0 = part * (C::BN / C::WN), h0 = part * (HD / C::WN);
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q_lo = qt * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.lse_ld;

  load_rows<T, HD, C::BM, C::LD>(sQ, tensor<const T>(p, kQ, b, h), p.st[kQ][2], q_lo, p.Sq);
  load_rows<T, HD, C::BM, C::LD>(sO, tensor<const T>(p, kDO, b, h), p.st[kDO][2], q_lo, p.Sq);
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_lo + r0 + g + 8 * half;
    lse[half] = row < p.Sq ? p.row_lse[row_base + row] : INFINITY;
    delta[half] = row < p.Sq ? p.delta[row_base + row] : 0.f;
  }
  const T* kg = tensor<const T>(p, kK, b, kvh);
  const T* vg = tensor<const T>(p, kV, b, kvh);

  float dq[C::NB][4];
  zero(dq);
  int k_begin, k_end;
  key_range(p, q_lo, min(q_lo + C::BM, p.Sq) - 1, k_begin, k_end);
  for (int k0 = (k_begin / C::BN) * C::BN; k0 < k_end; k0 += C::BN) {
    __syncthreads();
    load_rows<T, HD, C::BN, C::LD>(sK, kg, p.st[kK][2], k0, p.Skv);
    load_rows<T, HD, C::BN, C::LD>(sV, vg, p.st[kV][2], k0, p.Skv);
    __syncthreads();
    float s[C::NA][4], dp[C::NA][4];
    zero(s);
    zero(dp);
    warp_mma<C::NA, HD, true>(s, sQ + r0 * C::LD, C::LD, sK + c0 * C::LD, C::LD);
    warp_mma<C::NA, HD, true>(dp, sO + r0 * C::LD, C::LD, sV + c0 * C::LD, C::LD);
#pragma unroll
    for (int j = 0; j < C::NA; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, c = c0 + j * 8 + 2 * t;
        float P, dS[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          grad_logit<T>(p, visible(p, q_lo + r, k0 + c + e), s[j][2 * half + e],
                     dp[j][2 * half + e], lse[half], delta[half], P, dS[e]);
        store2(sS + r * C::LDP + c, dS[0], dS[1]);
      }
    __syncthreads();
    warp_mma<C::NB, C::BN, false>(dq, sS + r0 * C::LDP, C::LDP, sK + h0, C::LD);
  }
  T* dqg = tensor<T>(p, kDQ, b, h) + h0;
  store_acc(dqg + q_lo * p.st[kDQ][2], p.st[kDQ][2], r0, p.Sq - q_lo, dq, p.scale);
}

// dk and dv of one key tile: loop over the group's query heads and the query
// tiles that see the tile.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv(Params p) {
  using C = Tiles<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + C::BM * C::LD;
  T* sQ = sV + C::BM * C::LD;
  T* sO = sQ + C::BN * C::LD;     // dO
  T* sP = sO + C::BN * C::LD;     // P^T [BM][LDP]
  T* sS = sP + C::BM * C::LDP;    // dS^T [BM][LDP]
  T* sPr = sS + C::BM * C::LDP;   // SPLIT: their bf16 residuals
  T* sSr = sPr + C::BM * C::LDP;
  float* sLse = reinterpret_cast<float*>(sS + (C::SPLIT ? 3 : 1) * C::BM * C::LDP);
  float* sDelta = sLse + C::BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16, part = warp / C::WM;
  const int c0 = part * (C::BN / C::WN), h0 = part * (HD / C::WN);
  const int k_lo = blockIdx.x * C::BM, kvh = blockIdx.y, b = blockIdx.z;   // heaviest first
  const int group = p.H / p.KV;

  load_rows<T, HD, C::BM, C::LD>(sK, tensor<const T>(p, kK, b, kvh), p.st[kK][2], k_lo, p.Skv);
  load_rows<T, HD, C::BM, C::LD>(sV, tensor<const T>(p, kV, b, kvh), p.st[kV][2], k_lo, p.Skv);
  float dk[C::NB][4], dv[C::NB][4];
  zero(dk);
  zero(dv);
  int q_begin, q_end;
  query_range(p, k_lo, min(k_lo + C::BM, p.Skv) - 1, q_begin, q_end);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qg = tensor<const T>(p, kQ, b, h);
    const T* dog = tensor<const T>(p, kDO, b, h);
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.lse_ld;
    for (int q0 = (q_begin / C::BN) * C::BN; q0 < q_end; q0 += C::BN) {
      __syncthreads();
      load_rows<T, HD, C::BN, C::LD>(sQ, qg, p.st[kQ][2], q0, p.Sq);
      load_rows<T, HD, C::BN, C::LD>(sO, dog, p.st[kDO][2], q0, p.Sq);
      for (int i = threadIdx.x; i < C::BN; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        sLse[i] = in ? p.row_lse[row_base + q0 + i] : INFINITY;
        sDelta[i] = in ? p.delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[C::NA][4], dp[C::NA][4];   // S^T = k q^T, dP^T = v dO^T
      zero(s);
      zero(dp);
      warp_mma<C::NA, HD, true>(s, sK + r0 * C::LD, C::LD, sQ + c0 * C::LD, C::LD);
      warp_mma<C::NA, HD, true>(dp, sV + r0 * C::LD, C::LD, sO + c0 * C::LD, C::LD);
#pragma unroll
      for (int j = 0; j < C::NA; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half, c = c0 + j * 8 + 2 * t;
          float P[2], dS[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            grad_logit<T>(p, visible(p, q0 + c + e, k_lo + r), s[j][2 * half + e],
                       dp[j][2 * half + e], sLse[c + e], sDelta[c + e], P[e], dS[e]);
          store2(sP + r * C::LDP + c, P[0], P[1]);
          store2(sS + r * C::LDP + c, dS[0], dS[1]);
          if constexpr (C::SPLIT) {
            store2(sPr + r * C::LDP + c, bf16_residual(P[0]), bf16_residual(P[1]));
            store2(sSr + r * C::LDP + c, bf16_residual(dS[0]), bf16_residual(dS[1]));
          }
        }
      __syncthreads();
      warp_mma<C::NB, C::BN, false>(dv, sP + r0 * C::LDP, C::LDP, sO + h0, C::LD);
      warp_mma<C::NB, C::BN, false>(dk, sS + r0 * C::LDP, C::LDP, sQ + h0, C::LD);
      if constexpr (C::SPLIT) {
        warp_mma<C::NB, C::BN, false>(dv, sPr + r0 * C::LDP, C::LDP, sO + h0, C::LD);
        warp_mma<C::NB, C::BN, false>(dk, sSr + r0 * C::LDP, C::LDP, sQ + h0, C::LD);
      }
    }
  }
  T* dkg = tensor<T>(p, kDK, b, kvh) + h0;
  T* dvg = tensor<T>(p, kDV, b, kvh) + h0;
  store_acc(dkg + k_lo * p.st[kDK][2], p.st[kDK][2], r0, p.Skv - k_lo, dk, p.scale);
  store_acc(dvg + k_lo * p.st[kDV][2], p.st[kDV][2], r0, p.Skv - k_lo, dv, 1.f);
}

// ------------------------------------------------------------------ launches

template <int HD>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  const long long threads = static_cast<long long>(p.B) * p.H * p.lse_ld * (HD / 8);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > (1ll << 31) - 1) return cudaErrorInvalidConfiguration;
  fa_bwd_delta<HD><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// fp32, and bf16 at hd 256
template <typename T, int HD>
int launch_mma(const Params& p, cudaStream_t stream) {
  using C = Tiles<T, HD>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fa_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess)
    return err;
  const dim3 q_grid((p.Sq + C::BM - 1) / C::BM, p.H, p.B);
  const dim3 k_grid((p.Skv + C::BM - 1) / C::BM, p.KV, p.B);
  if constexpr (sizeof(T) == 4) {   // D = sum_k P dP
    if ((err = cudaFuncSetAttribute(fa_bwd_prep<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(C::SMEM_PREP))) != cudaSuccess)
      return err;
    fa_bwd_prep<HD><<<q_grid, kThreads, C::SMEM_PREP, stream>>>(p);
    err = cudaGetLastError();
  } else {                          // D = rowsum(dO (o + o_res))
    err = launch_delta<HD>(p, stream);
  }
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, HD><<<q_grid, kThreads, C::SMEM, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dkdv<T, HD><<<k_grid, kThreads, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Tensor map of tensor `which` (S rows over `heads` heads) with boxes of [rows][64].
template <int HD>
bool map_of(CUtensorMap* map, const Params& p, int which, int S, int heads, int rows) {
  return encode_map(map, p.t[which], HD, S, heads, p.B, p.st[which][2], p.st[which][1],
                    p.st[which][0], rows);
}

template <int HD, bool RESID>
cudaError_t launch_dkdv(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
                        const CUtensorMap& tv, const Params& p, unsigned grid,
                        cudaStream_t stream) {
  constexpr size_t smem = WgTiles<HD>::KV_SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_bf16<HD, RESID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_bf16<HD, RESID><<<grid, kWgThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

// bf16 at hd 64 and 128
template <int HD>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using T = WgTiles<HD>;
  constexpr int BN = 128;   // keys of a dk/dv work tile
  CUtensorMap q_rows, do_rows, k_tile, v_tile;   // dq: 128-row Q / dO, BK-row K / V boxes
  CUtensorMap q_tile, do_tile, k_rows, v_rows;   // dk/dv: BM-row Q / dO, 128-row K / V boxes
  if (!map_of<HD>(&q_rows, p, kQ, p.Sq, p.H, 128) || !map_of<HD>(&do_rows, p, kDO, p.Sq, p.H, 128) ||
      !map_of<HD>(&k_tile, p, kK, p.Skv, p.KV, T::BK) ||
      !map_of<HD>(&v_tile, p, kV, p.Skv, p.KV, T::BK) ||
      !map_of<HD>(&q_tile, p, kQ, p.Sq, p.H, T::BM) ||
      !map_of<HD>(&do_tile, p, kDO, p.Sq, p.H, T::BM) ||
      !map_of<HD>(&k_rows, p, kK, p.Skv, p.KV, BN) || !map_of<HD>(&v_rows, p, kV, p.Skv, p.KV, BN))
    return kEncodeFailed;
  cudaError_t err;
  int device, sms;
  if ((err = cudaFuncSetAttribute(fa_bwd_dq_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(T::DQ_SMEM))) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long dq_work = static_cast<long long>((p.Sq + 127) / 128) * p.B * p.H;
  const long long kv_work = static_cast<long long>((p.Skv + BN - 1) / BN) * p.B * p.KV;
  if (dq_work > (1ll << 31) - 1 || kv_work > (1ll << 31) - 1) return cudaErrorInvalidConfiguration;
  if ((err = launch_delta<HD>(p, stream)) != cudaSuccess) return err;
  // persistent: one block an SM (its shared memory allows no second), each
  // walking its kernel's work list
  fa_bwd_dq_bf16<HD><<<static_cast<unsigned>(dq_work < sms ? dq_work : sms), kWgThreads,
                       T::DQ_SMEM, stream>>>(q_rows, do_rows, k_tile, v_tile, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long kv_tiles = kv_work * p.kv_split;
  const unsigned kv_grid = static_cast<unsigned>(kv_tiles < sms ? kv_tiles : sms);
  // the residual products above kResidualGroup heads a kv head, or under a softcap
  err = p.softcap > 0.f || p.H / p.KV > kResidualGroup
            ? launch_dkdv<HD, true>(q_tile, do_tile, k_rows, v_rows, p, kv_grid, stream)
            : launch_dkdv<HD, false>(q_tile, do_tile, k_rows, v_rows, p, kv_grid, stream);
  if (err != cudaSuccess || p.kv_split == 1) return err;
  const long long pairs = static_cast<long long>(p.B) * p.KV * p.Skv * HD / 2;
  fa_bwd_dkdv_sum<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(p, HD);
  return cudaGetLastError();
}

// Chunks a group's heads split into in the bf16 dk/dv kernel: as many as
// fill the SMs that (key tile, batch, kv head) alone leave idle, at most the
// group; 1 outside the wgmma kernels.
int kv_split(int dtype, int head_dim, int B, int H, int KV, int Skv) {
  if (dtype != 1 || (head_dim != 64 && head_dim != 128)) return 1;
  int device, sms;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 1;
  const long long tiles = static_cast<long long>((Skv + 127) / 128) * B * KV;
  if (tiles >= sms) return 1;
  const long long want = (sms + tiles - 1) / tiles;
  return static_cast<int>(want < H / KV ? want : H / KV);
}

}  // namespace

// Chunks of a group's heads the dk/dv kernel splits into at these sizes on
// the current device (see kv_split); above 1 the call needs `part`, fp32
// scratch of 2 * chunks * B * KV * Skv * head_dim.
extern "C" int repro_flash_attention_bwd_split(int dtype, int head_dim, int B, int H, int KV,
                                               int Skv) {
  return kv_split(dtype, head_dim, B, H, KV, Skv);
}

// dtype: 0 = float32, 1 = bfloat16.  tensors: q, k, v, dO, o, o_res (the
// forward's output and, in bf16, its residual; null in fp32), dq, dk, dv;
// strides: 27 element strides, (batch, head, seq) of each in that order.
// lse: the forward's [B, H, lse_ld] base-2 log-sum-exp (lse_ld a multiple of
// 128, >= Sq; in bf16 its rows past Sq are written here); stats: fp32
// scratch of twice its size (D, then fp32's own log-sum-exp); part: the
// scratch repro_flash_attention_bwd_split asks for, or null.  q_offset: the
// position of query row 0, as in the forward.  Returns a cudaError_t value, -1 for a dtype / head-dim pair with no
// instantiation, or -2 when a TMA tensor map cannot be encoded.
extern "C" int repro_flash_attention_bwd(int dtype, int head_dim, void* const* tensors,
                                         float* lse, float* stats, long long lse_ld,
                                         float* part, int B, int H, int KV, int Sq, int Skv,
                                         const long long* strides, int causal, int window,
                                         int q_offset, float softcap, float scale,
                                         void* stream) {
  Params p{};
  for (int i = 0; i < kTensors; ++i) {
    p.t[i] = tensors[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.lse = lse;
  p.delta = stats;
  p.row_lse = dtype == 0 ? stats + static_cast<long long>(B) * H * lse_ld : lse;
  p.lse_ld = lse_ld;
  p.kv_split = kv_split(dtype, head_dim, B, H, KV, Skv);
  p.part = part;
  if (p.kv_split > 1 && part == nullptr) return cudaErrorInvalidValue;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch_wgmma<64>(p, st);
      case 128: return launch_wgmma<128>(p, st);
      case 256: return launch_mma<__nv_bfloat16, 256>(p, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch_mma<float, 64>(p, st);
      case 128: return launch_mma<float, 128>(p, st);
      case 256: return launch_mma<float, 256>(p, st);
    }
  }
  return -1;
}

// Dynamic shared memory of the bf16 wgmma kernels at a head dim (bytes; the
// dq kernel, or with dkdv != 0 the dk/dv kernel), or -1.
extern "C" long long repro_flash_attention_bwd_smem_bytes(int head_dim, int dkdv) {
  switch (head_dim) {
    case 64: return static_cast<long long>(dkdv ? WgTiles<64>::KV_SMEM : WgTiles<64>::DQ_SMEM);
    case 128: return static_cast<long long>(dkdv ? WgTiles<128>::KV_SMEM : WgTiles<128>::DQ_SMEM);
  }
  return -1;
}
