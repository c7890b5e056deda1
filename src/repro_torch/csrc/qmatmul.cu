// int8 x int8 matrix product with row / column dequantization for NVIDIA
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `qmatmul_kernel`
// (src/repro/kernels/qmatmul/kernel.py:43, body `_qmm_kernel` :21).  With
// x [M,K] int8 (K contiguous), w [K,N] int8 (N contiguous), x_scale [M] and
// w_scale [N] fp32:
//     acc[m,n] = sum_k x[m,k] * w[k,n]                 (exact, int32)
//     out[m,n] = (float(acc) * x_scale[m]) * w_scale[n]
// with every product and conversion rounded to nearest as torch rounds
// `acc.float() * xs[:, None] * ws[None, :]`, so the output is bit-equal to
// the plain version; out is fp32, or bf16 rounded once from that fp32.
//
// What bounds it on this card: at the granite-3-8b FFN up-projection of a
// B=4 x S=2048 prefill (M=8192, K=4096, N=12800) the call does 2*M*N*K =
// 8.6e11 integer operations, 0.434 ms at 1,979 TOP/s, and moves 86 MB in and
// 419 MB of fp32 out, 0.151 ms at 3.35 TB/s: it is bound by operations, and
// only the warpgroup MMA (`wgmma`) reaches the int8 tensor-core rate.  So a
// call is two launches:
//   * `transpose_w`: w [K,N] -> an [N,K] scratch the wrapper allocates.
//     8-bit `wgmma` takes B K-major from shared memory (the transpose bit
//     exists only for 16-bit types) and TMA cannot transpose bytes, so the
//     transpose is a pass of its own (52 MB read and written) and stays off
//     the shared-memory port the products use;
//   * `qmatmul_tma`: a persistent grid, one block per SM walking the
//     128 x 256 output tiles in groups of 8 tile rows (the x and w slices
//     the resident blocks share stay in the 50 MB L2).  A producer
//     warpgroup (setmaxnreg.dec) has one thread issue TMA loads of 128-byte
//     K slices of x and of the transposed w (128-byte swizzle, zero fill past
//     every edge) into a ring of 3 stages of 48 KB, each on a `full` and an
//     `empty` mbarrier; two consumer warpgroups (setmaxnreg.inc, 232
//     registers) each own 64 rows of the tile and issue
//     `wgmma.m64n256k32.s32.s8.s8` on them, 128 int32 accumulators a thread,
//     keeping one K slice's products in flight while the next is issued.
//     The int32 sum runs over all of K before the dequantizing epilogue;
//     the producer runs on into the next tile's loads meanwhile.  Ragged M,
//     N and K come in as TMA's zeros, which add nothing to the sum, so any
//     M, N, K >= 1 with K % 16 == 0 is taken;
//   * the epilogue costs the tensor cores their time, since both consumer
//     warpgroups run it at once, and its cost is in the SM, not in the
//     419 MB written (stores that stay in L2 cost as much).  So each
//     warpgroup writes its dequantized 64 rows into a 32 KB buffer of its
//     own, in 64-row boxes with the 128-byte swizzle (no bank conflicts),
//     and one thread hands the boxes to TMA stores, which clip at M and N;
//     the warpgroup goes back to the products while TMA drains the buffer.
//     The two buffers take the fourth stage's shared memory.  Output rows
//     not on 16-byte bounds (N % 4, or N % 8 in bf16, nonzero) are stored
//     straight from registers instead.
// TMA needs each row of x and of the transposed w (K bytes) and x's base on
// 16-byte bounds.  Other shapes (K % 16 != 0, or x not 16-byte aligned)
// take `qmatmul_bytes`, the first kernel of the port on `mma.sync`
// (m16n8k32, 128 x 128 tiles, K steps of 64, both operands staged byte by
// byte with zero fill).  The wrapper picks the path by shape and alignment.
// Keep every exit (a trap) out of the consumer path: ptxas then ignores
// setmaxnreg and serializes the wgmmas.

#include <cuda.h>            // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K;
};

constexpr int kGroupM = 8;   // tile rows per raster group (both kernels)

// Grouped raster: kGroupM tile rows walk the tile columns together.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int bm, int bn,
                                            int& m0, int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % group_m) * bm;
  n0 = (in_group / group_m) * bn;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store_pair(float* out, float v0, float v1) {
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(out) = v;
}
__device__ __forceinline__ void store_one(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// Columns gn, gn + 1 of one output row (gn < N); pairs: N is even, so both
// are in range and the pair is 8-byte (fp32) or 4-byte (bf16) aligned.
template <typename OutT>
__device__ __forceinline__ void store_cols(OutT* orow, int gn, int N, bool pairs, float v0,
                                           float v1) {
  if (pairs) {
    store_pair(orow + gn, v0, v1);
  } else {
    store_one(orow + gn, v0);
    if (gn + 1 < N) store_one(orow + gn + 1, v1);
  }
}

// ------------------------------------- mma.sync: shapes TMA cannot describe

constexpr int kBM = 128, kBN = 128, kBK = 64;   // block tile; K step in bytes
constexpr int kThreads = 256;                   // 8 warps: 2 along M x 4 along N
constexpr int kRow = kBK + 16;                  // smem row stride in bytes (padded)
constexpr int kTile = kBM * kRow;               // bytes of one operand stage (kBM == kBN)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 32, row) . b (32 x 8, col), s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of the 16-byte chunk `chunk` (k / 16) of row n in a B stage:
// the chunk index is XORed with bits 3-4 of n, so the transposing stores and
// the `ldmatrix` reads are free of bank conflicts.
__device__ __forceinline__ int b_offset(int n, int chunk) {
  return n * kRow + 16 * (chunk ^ ((n >> 3) & 3));
}

// 4 x 4 byte block transpose: r[k] holds n = 0..3 of row k; col[n] gets
// k = 0..3 of column n.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Both operands are staged byte by byte through registers with zero fill, so
// any M, N, K and any alignment is taken; two shared-memory stages.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2) qmatmul_bytes(const Params p) {
  __shared__ __align__(16) int8_t s_a[2][kTile];   // [m][k], rows padded
  __shared__ __align__(16) int8_t s_b[2][kTile];   // [n][k], rows padded, swizzled

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, K = p.K;
  int m0, n0;
  tile_origin(blockIdx.x, (M + kBM - 1) / kBM, (N + kBN - 1) / kBN, kBM, kBN, m0, n0);

  // x staging: 128 rows x 4 chunks of 16 bytes, two chunks a thread.
  // w staging: 16 k-groups x 32 n-groups of 4 x 4 bytes, two blocks a thread;
  // a warp's blocks share one 16-byte k chunk (kgl = lane & 3 picks the word)
  // and cover 8 consecutive n-groups.
  const int kgl = lane & 3, ngl = lane >> 2;
  uint32_t b_reg[2][4];                 // w blocks staged through registers
  uint4 a_reg[2];                       // x chunks staged through registers

  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 16;
      const int gm = m0 + row, gk = k0 + col;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = gk + q * 4 + b;
          const uint32_t byte =
              (gm < M && kk < K) ? static_cast<uint8_t>(p.x[(long long)gm * K + kk]) : 0u;
          word |= byte << (8 * b);
        }
        v[q] = word;
      }
      a_reg[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_a = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 16;
      *reinterpret_cast<uint4*>(&s_a[stage][row * kRow + col]) = a_reg[i];
    }
  };
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = warp * 2 + i, chunk = idx & 3;
      const int kg = chunk * 4 + kgl, ng = (idx >> 2) * 8 + ngl;
      const int gn = n0 + ng * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gk = k0 + kg * 4 + r;
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (gk < K && gn + b < N)
              ? static_cast<uint8_t>(p.w[(long long)gk * N + gn + b]) : 0u;
          word |= byte << (8 * b);
        }
        b_reg[i][r] = word;
      }
    }
  };
  auto store_b = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = warp * 2 + i, chunk = idx & 3;
      const int ng = (idx >> 2) * 8 + ngl;
      uint32_t col[4];
      transpose4x4(b_reg[i], col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = ng * 4 + j;
        *reinterpret_cast<uint32_t*>(&s_b[stage][b_offset(n, chunk) + kgl * 4]) = col[j];
      }
    }
  };

  const int warp_m = (warp >> 2) * 64, warp_n = (warp & 3) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int k_tiles = (K + kBK - 1) / kBK;
  load_a(0);
  store_a(0);
  load_b(0);
  store_b(0);
  __syncthreads();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      load_a((kt + 1) * kBK);
      load_b((kt + 1) * kBK);
    }
    const int8_t* sa = s_a[cur];
    const int8_t* sb = s_b[cur];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {        // two k32 steps per 64-byte slice
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // lanes 0-15: rows 0-15 at k 0-15; lanes 16-31: rows 0-15 at k 16-31
        const int row = warp_m + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], sa + row * kRow + (ks * 2 + (lane >> 4)) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
        const int n = warp_n + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b[nj], sb + b_offset(n, ks * 2 + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (more) {
      store_a(cur ^ 1);
      store_b(cur ^ 1);
    }
    __syncthreads();
  }

  // Epilogue: accumulator e of tile (mi, ni) sits at row g (+8 for e >= 2),
  // column 2t + (e & 1), with g = lane / 4 and t = lane % 4.
  OutT* out = static_cast<OutT*>(p.out);
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + warp_m + mi * 16 + g + half * 8;
      if (gm >= M) continue;
      const float xs = p.xs[gm];
      OutT* orow = out + (long long)gm * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gn = n0 + warp_n + ni * 8 + 2 * t;
        const int* c = &acc[mi][ni][half * 2];
        if (gn < N)
          store_cols(orow, gn, N, pairs, dequant(c[0], xs, p.ws[gn]),
                     gn + 1 < N ? dequant(c[1], xs, p.ws[gn + 1]) : 0.f);
      }
    }
  }
}

// ------------------------------------------------- w [K,N] -> wt [N,K] bytes

constexpr int kTrK = 256, kTrN = 128;   // transpose tile: 256 k x 128 n bytes (32 KB)
constexpr int kTrThreads = 256;

// Word (k, c) of the transpose tile (c = n / 4): the column is XORed with
// 4 * (k / 32 % 8), so both the 16-byte row stores and the word reads of
// the transposing threads are free of bank conflicts.
__device__ __forceinline__ int tr_word(int k, int c) {
  return k * (kTrN / 4) + (c ^ (((k >> 5) & 7) << 2));
}

// wt[n][k] = w[k][n]; K % 16 == 0 (the TMA path's condition), so each
// 16-byte half of a thread's 32 k of one n is in range or out as a whole.
// kVec: N % 16 == 0 and w 16-byte aligned, so the tile comes in as whole
// 16-byte row chunks; otherwise byte by byte.  Out: lane (kq, nq) of warp w
// transposes the 32 k x 4 n block at k = 32 kq, n = 4 (4 w + nq) in 4 x 4
// byte blocks and writes 32 contiguous bytes of each of its 4 rows of wt, so
// one store of a warp covers 4 rows x 256 bytes.
template <bool kVec>
__global__ void __launch_bounds__(kTrThreads) transpose_w(const int8_t* __restrict__ w,
                                                          int8_t* __restrict__ wt, int K,
                                                          int N) {
  __shared__ __align__(16) uint32_t s[kTrK * kTrN / 4];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTrN, k0 = blockIdx.y * kTrK;
#pragma unroll
  for (int i = 0; i < kTrK * kTrN / 16 / kTrThreads; ++i) {
    const int c = tid + i * kTrThreads, row = c / (kTrN / 16), col = (c % (kTrN / 16)) * 16;
    const int gk = k0 + row, gn = n0 + col;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gk < K) {
      const int8_t* src = w + (long long)gk * N + gn;
      if (kVec && gn + 16 <= N) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (gn + b < N) word[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                                         << (8 * (b % 4));
        v = make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    *reinterpret_cast<uint4*>(&s[tr_word(row, col / 4)]) = v;
  }
  __syncthreads();
  const int lane = tid % 32, kq = lane & 7;
  const int ng = (tid / 32) * 4 + (lane >> 3);   // 4-column group of the tile
  const int kb = kq * 32;                       // this thread's 32 k (of the tile)
  uint32_t cols[4][8];                          // cols[j][q]: k = kb + 4q .. +3 of n = 4 ng + j
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t r[4] = {s[tr_word(kb + 4 * q, ng)], s[tr_word(kb + 4 * q + 1, ng)],
                           s[tr_word(kb + 4 * q + 2, ng)], s[tr_word(kb + 4 * q + 3, ng)]};
    uint32_t c[4];
    transpose4x4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) cols[j][q] = c[j];
  }
  const int gk = k0 + kb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + 4 * ng + j;
    if (gn >= N) continue;
    uint4* dst = reinterpret_cast<uint4*>(wt + (long long)gn * K + gk);
    if (gk < K) dst[0] = make_uint4(cols[j][0], cols[j][1], cols[j][2], cols[j][3]);
    if (gk + 16 < K) dst[1] = make_uint4(cols[j][4], cols[j][5], cols[j][6], cols[j][7]);
  }
}

// ------------------------------------------------ wgmma, TMA, mbarrier ring

constexpr int kTileM = 128;   // two consumer warpgroups x 64 rows
constexpr int kTileN = 256;   // wgmma N; 128 int32 accumulators a consumer thread
constexpr int kTileK = 128;   // bytes: one 128-byte swizzle row per tile row
constexpr int kStages = 3;
constexpr int kGemmThreads = 384;              // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerRegs = 232, kProducerRegs = 40;   // 2 x 128 x 232 + 128 x 40 <= 64K
constexpr uint32_t kABytes = kTileM * kTileK, kBBytes = kTileN * kTileK;
constexpr uint32_t kStageBytes = kABytes + kBBytes;
// The output goes out through a 32 KB buffer per consumer warpgroup, in
// boxes of 64 rows x 128 bytes (128-byte swizzle) that TMA stores.
constexpr uint32_t kOutBytes = 32768;
// + 1024: the dynamic buffer is realigned to 1024 bytes (the swizzle atom is
// 8 rows x 128 bytes); then the output buffers, then a full and an empty
// mbarrier per stage.
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kOutBytes + 8 * 2 * kStages;

// Columns of one output box (128 bytes) and of one pass through the buffer.
template <typename OutT> constexpr int kBoxCols = 128 / sizeof(OutT);
template <typename OutT>
constexpr int kPassCols = kOutBytes / (64 * sizeof(OutT)) < kTileN
                              ? kOutBytes / (64 * sizeof(OutT)) : kTileN;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  (No
// trap on a long wait: an exit inside the consumer path stops ptxas from
// giving it the registers of setmaxnreg.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory out to a 2-D tensor map (rows and columns past
// the map's edges are not written), as part of this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {   // this thread's stores have read their source
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {        // ... and are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes of shared memory made visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier of the 128 threads of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Two output values into shared memory: fp32 pair, or bf16 pair rounded once.
template <typename OutT>
__device__ __forceinline__ void st_shared_out(uint32_t addr, float v0, float v1) {
  if constexpr (sizeof(OutT) == 4) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v0), "f"(v1) : "memory");
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v))
                 : "memory");
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).  Byte
// offsets: `lbo` unused for K-major, `sbo` between groups of 8 rows (1024).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most N groups still in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma (issued before, completed at the wait).
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// N = kTileN: 256, or 128 in the 128 x 128 tile ablation (scripts/qmatmul_ablations.json).
template <int N> struct Wgmma;

template <> struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 32] . B[32 x 128], s8 x s8 -> s32, A and B K-major in
  // shared memory; scale_d 0 overwrites D.
  static __device__ __forceinline__ void ss(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  // D[64 x 256] (+)= A[64 x 32] . B[32 x 256], s8 x s8 -> s32, A and B K-major in
  // shared memory; scale_d 0 overwrites D.
  static __device__ __forceinline__ void ss(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// kTmaStore: the output goes out through shared memory by TMA (its rows,
// N elements, on 16-byte bounds); otherwise straight from registers.
template <typename OutT, bool kTmaStore>
__global__ void __launch_bounds__(kGemmThreads, 1)
    qmatmul_tma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap to, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_buf = base + kStages * kStageBytes;       // one per consumer warpgroup
  const uint32_t bars = out_buf + 2 * kOutBytes;
  auto stage_a = [&](int s) { return base + s * kStageBytes; };              // [128 m][128 k]
  auto stage_b = [&](int s) { return base + s * kStageBytes + kABytes; };    // [256 n][128 k]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tiles_m = (p.M + kTileM - 1) / kTileM, tiles_n = (p.N + kTileN - 1) / kTileN;
  const int n_tiles = tiles_m * tiles_n;   // the host checked that it fits an int
  const int k_steps = (p.K + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;   // K slices loaded so far: the ring's position
#pragma unroll 1
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, kTileM, kTileN, m0, n0);
#pragma unroll 1
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          mbar_expect_tx(full(s), kStageBytes);
          tma_load_2d(stage_a(s), &tx, full(s), kt * kTileK, m0);
          tma_load_2d(stage_b(s), &tw, full(s), kt * kTileK, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const bool pairs = (p.N & 1) == 0;
    OutT* out = static_cast<OutT*>(p.out);
    int acc[kTileN / 2];
    int it = 0;   // K slices consumed so far: the ring's position
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, tiles_m, tiles_n, kTileM, kTileN, m0, n0);
#pragma unroll 1
      for (int kt = 0; kt < k_steps; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 32; ++kk) {   // k32 steps: 32 bytes into the row
          const uint64_t da = sw128_desc(stage_a(s) + wg * 64 * kTileK + kk * 32, 16, 1024);
          const uint64_t db = sw128_desc(stage_b(s) + kk * 32, 16, 1024);
          Wgmma<kTileN>::ss(acc, da, db, kt > 0 || kk > 0);
        }
        wgmma_commit();
        // The slice before this one is done with: hand its stage back while
        // this slice's products run.
        wgmma_wait<1>();
        fence_operands(acc);
        if (kt > 0) mbar_arrive(empty((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(empty((it - 1) % kStages));

      // Epilogue: accumulator 4j + e sits at row g (+8 for e >= 2) of this
      // warp's 16, column 8j + 2t + (e & 1).  The producer is already
      // loading the next tile.  The scales come in first, all at once: a
      // load between two output stores would wait out its own latency (the
      // compiler does not move a load above a store that may alias it).
      const int row0 = m0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const bool in0 = row0 < p.M, in1 = row1 < p.M;
      const float xs0 = in0 ? __ldg(p.xs + row0) : 0.f, xs1 = in1 ? __ldg(p.xs + row1) : 0.f;
      float wsv[kTileN / 4];   // w_scale at columns 8j + 2t and 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int gn = n0 + j * 8 + 2 * t;
        wsv[2 * j] = gn < p.N ? __ldg(p.ws + gn) : 0.f;
        wsv[2 * j + 1] = gn + 1 < p.N ? __ldg(p.ws + gn + 1) : 0.f;
      }
      if constexpr (kTmaStore) {
        // Through this warpgroup's buffer, kPassCols columns a pass: the
        // dequantized pairs go to their swizzled place in the 64-row boxes
        // (16-byte chunk c of row r at c ^ (r % 8): the stores of a warp are
        // free of bank conflicts), then one thread hands the boxes to TMA,
        // which clips rows past M and columns past N.  The warpgroup goes on
        // to the next tile while TMA drains the last pass.
        constexpr int kCols = kPassCols<OutT>, kBox = kBoxCols<OutT>;
        const uint32_t buf = out_buf + wg * kOutBytes;
#pragma unroll
        for (int pass = 0; pass < kTileN / kCols; ++pass) {
          if (tid == 0) bulk_wait_read();    // the buffer's last stores have read it
          warpgroup_sync(1 + wg);
#pragma unroll
          for (int jj = 0; jj < kCols / 8; ++jj) {
            const int j = pass * (kCols / 8) + jj, c = 8 * jj + 2 * t;
            const uint32_t byte = (c % kBox) * sizeof(OutT);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + g + 8 * h;
              const uint32_t addr = buf + (c / kBox) * (64 * 128) + r * 128 +
                                    ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
              st_shared_out<OutT>(addr, dequant(acc[4 * j + 2 * h], h ? xs1 : xs0, wsv[2 * j]),
                                  dequant(acc[4 * j + 2 * h + 1], h ? xs1 : xs0, wsv[2 * j + 1]));
            }
          }
          fence_proxy_async();
          warpgroup_sync(1 + wg);
          if (tid == 0) {
#pragma unroll
            for (int b = 0; b < kCols / kBox; ++b)
              tma_store_2d(&to, buf + b * (64 * 128), n0 + pass * kCols + b * kBox,
                           m0 + wg * 64);
            bulk_commit();
          }
        }
      } else {
        OutT* o0 = out + (long long)row0 * p.N;
        OutT* o1 = out + (long long)row1 * p.N;
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const int gn = n0 + j * 8 + 2 * t;
          if (gn < p.N) {
            if (in0)
              store_cols(o0, gn, p.N, pairs, dequant(acc[4 * j], xs0, wsv[2 * j]),
                         dequant(acc[4 * j + 1], xs0, wsv[2 * j + 1]));
            if (in1)
              store_cols(o1, gn, p.N, pairs, dequant(acc[4 * j + 2], xs1, wsv[2 * j]),
                         dequant(acc[4 * j + 3], xs1, wsv[2 * j + 1]));
          }
        }
      }
    }
    if (kTmaStore && tid == 0) bulk_wait();   // the last stores are done before the block ends
  }
}

// ------------------------------------------------------------------ launches

template <typename OutT>
int launch_bytes(const Params& p, cudaStream_t stream) {
  const long long tiles = (long long)((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qmatmul_bytes<OutT><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Tensor map over a row-major [rows][cols] matrix of `elem`-byte elements;
// boxes of [box_rows][128 bytes], 128-byte swizzle, zero fill past every edge.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int cols,
                int rows, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kEncodeFailed = -2;

template <typename OutT>
int launch_tma(const Params& p, int8_t* wt, cudaStream_t stream) {
  constexpr CUtensorMapDataType kOutType =
      sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // TMA stores the output where its rows lie on 16-byte bounds.
  const bool tma_store = (static_cast<long long>(p.N) * sizeof(OutT)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  CUtensorMap tx, tw, to = {};
  if (!encode_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.x, p.K, p.M, kTileM) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, p.K, p.N, kTileN) ||
      (tma_store && !encode_map(&to, kOutType, sizeof(OutT), p.out, p.N, p.M, 64)))
    return kEncodeFailed;
  auto kernel = tma_store ? qmatmul_tma<OutT, true> : qmatmul_tma<OutT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((p.M + kTileM - 1) / kTileM) * ((p.N + kTileN - 1) / kTileN);
  const long long tr_blocks = (p.N + kTrN - 1) / kTrN;
  if (tiles > 0x7fffffffLL || tr_blocks > 0x7fffffffLL || (p.K + kTrK - 1) / kTrK > 65535)
    return cudaErrorInvalidConfiguration;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;

  const dim3 tr_grid(static_cast<unsigned>(tr_blocks), (p.K + kTrK - 1) / kTrK);
  if (p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.w) % 16 == 0)
    transpose_w<true><<<tr_grid, kTrThreads, 0, stream>>>(p.w, wt, p.K, p.N);
  else
    transpose_w<false><<<tr_grid, kTrThreads, 0, stream>>>(p.w, wt, p.K, p.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // One block per SM (its shared memory allows no second), each walking the
  // output tiles.
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kGemmThreads, kSmem, stream>>>(tx, tw, to, p);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous [M,K] int8; w: contiguous [K,N] int8; x_scale [M], w_scale
// [N]: contiguous fp32; out: contiguous [M,N], fp32 (out_bf16 0) or bf16 (1).
// tma 1: the transpose and the wgmma / TMA kernel, which need K % 16 == 0
// and x 16-byte aligned; wt is an [N,K] int8 scratch, 16-byte aligned.
// tma 0: the byte-staged mma.sync kernel, any shape and alignment (wt
// unused).  Returns 0, the first CUDA error of the launches, -2 when a
// tensor map cannot be encoded (nothing launched then), or
// cudaErrorInvalidConfiguration for a grid too large to launch.
extern "C" int repro_qmatmul_fwd(const void* x, const void* w, const void* x_scale,
                                 const void* w_scale, void* out, void* wt, int M, int N, int K,
                                 int out_bf16, int tma, void* stream) {
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(x_scale), static_cast<const float*>(w_scale), out,
           M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* scratch = static_cast<int8_t*>(wt);
  if (tma) {
    return out_bf16 ? launch_tma<__nv_bfloat16>(p, scratch, st) : launch_tma<float>(p, scratch, st);
  }
  return out_bf16 ? launch_bytes<__nv_bfloat16>(p, st) : launch_bytes<float>(p, st);
}

// Dynamic shared memory of the wgmma / TMA kernel (bytes).
extern "C" long long repro_qmatmul_smem_bytes() { return static_cast<long long>(kSmem); }
