// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The gradient of the forward in flash_attention.cu, which replaces the
// Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:96).  The reference has no
// backward kernel: it differentiates its jnp attention.  Semantics are the
// forward's: GQA head h -> h / (H / KV), logits y = softcap(s * scale) with
// s = q.k, causal mask kpos <= qpos, sliding window kpos > qpos - window,
// fp32 softmax P.  With D = rowsum(dO * O) = sum_k P (dO . v) and the
// softcap's chain factor f = 1 - (y / cap)^2 (1 without a softcap):
//   dS = P * (dO v^T - D) * f,  dq = scale * dS k,  dk = scale * dS^T q,
//   dv = P^T dO,
// dk and dv summed over the H / KV query heads of their group.
//
// Three launches, no atomics, so the result is the same bits on every run:
//   * fa_bwd_prep, one block per (q tile, head, batch): each query row's
//     log-sum-exp and D, recomputed from q k^T and dO v^T in one online pass
//     (the forward emits neither), both to fp32 scratch.  D comes from the
//     fp32 P and dO . v, as in the reference, not from the bf16-rounded
//     output: where a row's attention sits on one key its dq is a small
//     difference, which the rounded O leaves outside the per-row bound;
//   * fa_bwd_dq, one block per (q tile, head, batch), looping over the key
//     tiles the tile sees;
//   * fa_bwd_dkdv, one block per (key tile, kv head, batch), looping over
//     the group's query heads and the query tiles that see the key tile.
// Tiles every row of which is masked are never loaded.
//
// What bounds it on this card: five products of 2 * (visible pairs) * hd
// FLOPs each per head (q k^T, dO v^T, P^T dO, dS^T q, dS k) against
// |q|+|k|+|v|+|dO| read and |dq|+|dk|+|dv| written: hundreds of FLOPs a
// byte at the serving and training shapes, so operations (989 TFLOP/s bf16).
// This first version recomputes q k^T three times and dO v^T three times,
// and in bf16 splits P and dS into a bf16 part and a bf16 residual for the
// dv and dk products (eleven products for the five): dk and dv sum the
// rounding of P and dS over every query of every head of a group, and with
// one bf16 rounding that sum left granite-20b's MQA (48 heads on one kv
// head) outside the bf16 bound.  It runs bf16 on `mma.sync.m16n8k16` with
// fp32 accumulation, its operands taken from padded shared-memory tiles by
// `ldmatrix` (`.trans` where the product needs a tile's transpose); fp32
// inputs run the same tiling on CUDA cores, since the tensor cores would
// round them to TF32.  A block's eight warps split its 64 rows into four
// 16-row strips and the columns into two halves; P and dS go through shared
// memory once per tile, so the row strip's partial products for both column
// halves meet there; bf16 up to hd 128 runs two blocks an SM.  wgmma, TMA
// and a fused single pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>    // INFINITY
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;   // the forward's masked logit
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

enum { kQ, kK, kV, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* in[4];     // q, k, v, dO
  void* out[3];          // dq, dk, dv
  float* lse;            // [B, H, Sq]: log2 of sum_k exp2(y log2 e), +inf for a row that sees no key
  float* delta;          // [B, H, Sq]: D = rowsum(dO * O)
  int B, H, KV, Sq, Skv;
  long long st[kTensors][3];   // (batch, head, seq) strides in elements; hd is unit-stride
  int causal, window;
  float softcap, scale;
};

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
  // bf16 up to hd 128 fits two blocks an SM in shared memory: capping the
  // registers at 128 a thread lets them share it (one block's loads and
  // softmax run under the other's products; scripts/flash_bwd_ablations.json)
  static constexpr int MIN_BLOCKS = (sizeof(T) == 2 && HD <= 128) ? 2 : 1;
  static constexpr size_t SMEM = (2 * BM + 2 * BN) * LD * sizeof(T) +
                                 (SPLIT ? 4 : 2) * BM * LDP * sizeof(T) + 2 * BN * sizeof(float);
  static constexpr size_t SMEM_PREP = (2 * BM + 2 * BN) * LD * sizeof(T) +
                                      3 * WN * BM * sizeof(float);
  static_assert(NA >= 1 && NB >= 1 && (sizeof(T) == 4 || (NA % 2 == 0 && NB % 2 == 0)),
                "tile split");
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

__device__ __forceinline__ float logit(const Params& p, float s) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x less its bf16 rounding: the part a bf16 store of x drops
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ const T* in_ptr(const Params& p, int which, int b, int h) {
  return static_cast<const T*>(p.in[which]) + b * p.st[which][0] + h * p.st[which][1];
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// P and dS of one (query, key) pair from s = q.k and dp = dO.v.
__device__ __forceinline__ void grad_logit(const Params& p, bool vis, float s, float dp,
                                           float lse, float delta, float& P, float& dS) {
  const float y = logit(p, s);
  float f = 1.f;
  if (p.softcap > 0.f) {
    const float u = y / p.softcap;
    f = 1.f - u * u;
  }
  P = vis ? exp2f(y * kLog2e - lse) : 0.f;
  dS = P * (dp - delta) * f;
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

// The log-sum-exp and D of each query row of the tile, in one online pass
// over the key tiles it sees: per row a running max m, sum l of exp2(y - m)
// and sum a of exp2(y - m) dP, rescaled together; D = a / l.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Tiles<T, HD>::MIN_BLOCKS) fa_bwd_prep(Params p) {
  using C = Tiles<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + C::BM * C::LD;     // dO
  T* sK = sO + C::BM * C::LD;
  T* sV = sK + C::BN * C::LD;
  float* sM = reinterpret_cast<float*>(sV + C::BN * C::LD);   // [WN][BM] partial max
  float* sL = sM + C::WN * C::BM;                             // [WN][BM] partial sum
  float* sA = sL + C::WN * C::BM;                             // [WN][BM] partial sum * dP

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16, part = warp / C::WM, c0 = part * (C::BN / C::WN);
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;   // heaviest first
  const int q_lo = qt * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, HD, C::BM, C::LD>(sQ, in_ptr<T>(p, kQ, b, h), p.st[kQ][2], q_lo, p.Sq);
  load_rows<T, HD, C::BM, C::LD>(sO, in_ptr<T>(p, kDO, b, h), p.st[kDO][2], q_lo, p.Sq);
  const T* kg = in_ptr<T>(p, kK, b, kvh);
  const T* vg = in_ptr<T>(p, kV, b, kvh);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};   // base 2
  const int q_last = min(q_lo + C::BM, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
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
    for (int half = 0; half < 2; ++half) {
      const int qpos = q_lo + r0 + g + 8 * half;
      float y[C::NA][2], mx = m[half];
#pragma unroll
      for (int j = 0; j < C::NA; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + c0 + j * 8 + 2 * t + e;
          y[j][e] = visible(p, qpos, kpos) ? logit(p, s[j][2 * half + e]) * kLog2e : kNegInf;
          mx = fmaxf(mx, y[j][e]);
        }
      const float rescale = exp2f(m[half] - mx);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < C::NA; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = y[j][e] > kNegInf ? exp2f(y[j][e] - mx) : 0.f;
          sum += pe;
          dsum = fmaf(pe, dp[j][2 * half + e], dsum);
        }
      l[half] = l[half] * rescale + sum;
      a[half] = a[half] * rescale + dsum;
      m[half] = mx;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad that shares a row
      const float mo = __shfl_xor_sync(0xffffffffu, m[half], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[half], off);
      const float ao = __shfl_xor_sync(0xffffffffu, a[half], off);
      const float mx = fmaxf(m[half], mo);
      const float f0 = exp2f(m[half] - mx), f1 = exp2f(mo - mx);
      l[half] = l[half] * f0 + lo * f1;
      a[half] = a[half] * f0 + ao * f1;
      m[half] = mx;
    }
    if (t == 0) {
      const int r = part * C::BM + r0 + g + 8 * half;
      sM[r] = m[half];
      sL[r] = l[half];
      sA[r] = a[half];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < C::BM; r += kThreads) {
    if (q_lo + r >= p.Sq) continue;
    float mx = kNegInf;
    for (int w = 0; w < C::WN; ++w) mx = fmaxf(mx, sM[w * C::BM + r]);
    float sum = 0.f, dsum = 0.f;
    for (int w = 0; w < C::WN; ++w) {
      const float f = exp2f(sM[w * C::BM + r] - mx);
      sum += sL[w * C::BM + r] * f;
      dsum += sA[w * C::BM + r] * f;
    }
    p.lse[row_base + q_lo + r] = sum > 0.f ? mx + log2f(sum) : INFINITY;
    p.delta[row_base + q_lo + r] = sum > 0.f ? dsum / sum : 0.f;
  }
}

// dq of one query tile: loop over the key tiles it sees.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Tiles<T, HD>::MIN_BLOCKS) fa_bwd_dq(Params p) {
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
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, HD, C::BM, C::LD>(sQ, in_ptr<T>(p, kQ, b, h), p.st[kQ][2], q_lo, p.Sq);
  load_rows<T, HD, C::BM, C::LD>(sO, in_ptr<T>(p, kDO, b, h), p.st[kDO][2], q_lo, p.Sq);
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_lo + r0 + g + 8 * half;
    lse[half] = row < p.Sq ? p.lse[row_base + row] : INFINITY;
    delta[half] = row < p.Sq ? p.delta[row_base + row] : 0.f;
  }
  const T* kg = in_ptr<T>(p, kK, b, kvh);
  const T* vg = in_ptr<T>(p, kV, b, kvh);

  float dq[C::NB][4];
  zero(dq);
  const int q_last = min(q_lo + C::BM, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
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
          grad_logit(p, visible(p, q_lo + r, k0 + c + e), s[j][2 * half + e],
                     dp[j][2 * half + e], lse[half], delta[half], P, dS[e]);
        store2(sS + r * C::LDP + c, dS[0], dS[1]);
      }
    __syncthreads();
    warp_mma<C::NB, C::BN, false>(dq, sS + r0 * C::LDP, C::LDP, sK + h0, C::LD);
  }
  T* dqg = static_cast<T*>(p.out[0]) + b * p.st[kDQ][0] + h * p.st[kDQ][1] + h0;
  store_acc(dqg + q_lo * p.st[kDQ][2], p.st[kDQ][2], r0, p.Sq - q_lo, dq, p.scale);
}

// dk and dv of one key tile: loop over the group's query heads and the query
// tiles that see the tile.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Tiles<T, HD>::MIN_BLOCKS) fa_bwd_dkdv(Params p) {
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

  load_rows<T, HD, C::BM, C::LD>(sK, in_ptr<T>(p, kK, b, kvh), p.st[kK][2], k_lo, p.Skv);
  load_rows<T, HD, C::BM, C::LD>(sV, in_ptr<T>(p, kV, b, kvh), p.st[kV][2], k_lo, p.Skv);
  float dk[C::NB][4], dv[C::NB][4];
  zero(dk);
  zero(dv);
  // queries that see a key of [k_lo, k_last]: q >= k (causal), q < k + window
  const int k_last = min(k_lo + C::BM, p.Skv) - 1;
  const int q_begin = p.causal ? k_lo : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qg = in_ptr<T>(p, kQ, b, h);
    const T* dog = in_ptr<T>(p, kDO, b, h);
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int q0 = (q_begin / C::BN) * C::BN; q0 < q_end; q0 += C::BN) {
      __syncthreads();
      load_rows<T, HD, C::BN, C::LD>(sQ, qg, p.st[kQ][2], q0, p.Sq);
      load_rows<T, HD, C::BN, C::LD>(sO, dog, p.st[kDO][2], q0, p.Sq);
      for (int i = threadIdx.x; i < C::BN; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        sLse[i] = in ? p.lse[row_base + q0 + i] : INFINITY;
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
            grad_logit(p, visible(p, q0 + c + e, k_lo + r), s[j][2 * half + e],
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
  T* dkg = static_cast<T*>(p.out[1]) + b * p.st[kDK][0] + kvh * p.st[kDK][1] + h0;
  T* dvg = static_cast<T*>(p.out[2]) + b * p.st[kDV][0] + kvh * p.st[kDV][1] + h0;
  store_acc(dkg + k_lo * p.st[kDK][2], p.st[kDK][2], r0, p.Skv - k_lo, dk, p.scale);
  store_acc(dvg + k_lo * p.st[kDV][2], p.st[kDV][2], r0, p.Skv - k_lo, dv, 1.f);
}

// ------------------------------------------------------------------ launches

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  using C = Tiles<T, HD>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fa_bwd_prep<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM_PREP))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess)
    return err;
  const dim3 q_grid((p.Sq + C::BM - 1) / C::BM, p.H, p.B);
  const dim3 k_grid((p.Skv + C::BM - 1) / C::BM, p.KV, p.B);
  fa_bwd_prep<T, HD><<<q_grid, kThreads, C::SMEM_PREP, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq<T, HD><<<q_grid, kThreads, C::SMEM, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dkdv<T, HD><<<k_grid, kThreads, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tensors: q, k, v, dO, dq, dk, dv;
// strides: 21 element strides, (batch, head, seq) of each in that order;
// lse, delta: fp32 scratch of B * H * Sq each.  Returns a cudaError_t value,
// or -1 for a dtype / head-dim pair with no instantiation.
extern "C" int repro_flash_attention_bwd(int dtype, int head_dim, const void* const* tensors,
                                         float* lse, float* delta, int B, int H, int KV, int Sq,
                                         int Skv, const long long* strides, int causal,
                                         int window, float softcap, float scale, void* stream) {
  Params p{};
  for (int i = 0; i < 4; ++i) p.in[i] = tensors[i];
  for (int i = 0; i < 3; ++i) p.out[i] = const_cast<void*>(tensors[4 + i]);
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.lse = lse;
  p.delta = delta;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch<__nv_bfloat16, 64>(p, st);
      case 128: return launch<__nv_bfloat16, 128>(p, st);
      case 256: return launch<__nv_bfloat16, 256>(p, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch<float, 64>(p, st);
      case 128: return launch<float, 128>(p, st);
      case 256: return launch<float, 256>(p, st);
    }
  }
  return -1;
}
