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
// 419 MB of fp32 out, 0.151 ms at 3.35 TB/s: it is bound by operations.  The
// design is the simple tensor-core kernel, right first:
//   * int8 `mma.sync.m16n8k32` (s8 x s8 -> s32) on 128 x 128 output tiles,
//     one block of 8 warps each, each warp a 64 x 32 quadrant (4 x 4 mma
//     tiles, 64 int32 accumulators a thread), K in steps of 64 bytes;
//   * two shared-memory stages: while one 64-deep slice feeds the tensor
//     cores, the next is in flight (x by `cp.async`, w through registers);
//   * the B operand has to be K-major for 8-bit `mma` (each register holds
//     four consecutive k of one n), while w is N-contiguous.  `ldmatrix.trans`
//     moves 16-bit elements, not bytes, so each thread loads a 4 k x 4 n byte
//     block as four 32-bit words, transposes it with `__byte_perm` and stores
//     four words into an [n][k] tile.  The tile rows are padded to 80 bytes
//     and their 16-byte chunks XOR-swizzled, so those stores and the
//     `ldmatrix` reads of both operands are free of bank conflicts;
//   * the int32 sum runs over all of K before the one dequantizing epilogue,
//     as on the TPU; ragged M, N and K are zero-filled in shared memory
//     (zeros add nothing to the sum), so any M, N, K >= 1 is taken.  When K
//     is not a multiple of 16 or N of 4 the rows are not aligned for vector
//     loads, and a second instantiation stages both operands byte by byte;
//   * blocks walk the output in groups of 8 tile rows, so the slices of x
//     and w that the resident blocks share stay in the 50 MB L2.
// `wgmma`, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;   // block tile; K step in bytes
constexpr int kThreads = 256;                   // 8 warps: 2 along M x 4 along N
constexpr int kRow = kBK + 16;                  // smem row stride in bytes (padded)
constexpr int kTile = kBM * kRow;               // bytes of one operand stage (kBM == kBN)
constexpr int kGroupM = 8;                      // tile rows per raster group

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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
// the chunk index is XORed with bits 3-4 of n (see the header).
__device__ __forceinline__ int b_offset(int n, int chunk) {
  return n * kRow + 16 * (chunk ^ ((n >> 3) & 3));
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

// kVec: K % 16 == 0 and N % 4 == 0 (with aligned bases), so every in-range
// 16-byte row chunk of x and 4-byte row word of w can be loaded whole.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) qmatmul_fwd(const Params p) {
  __shared__ __align__(16) int8_t s_a[2][kTile];   // [m][k], rows padded
  __shared__ __align__(16) int8_t s_b[2][kTile];   // [n][k], rows padded, swizzled

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, K = p.K;

  // Grouped raster: kGroupM tile rows walk the tile columns together.
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * kBN;

  // x staging: 128 rows x 4 chunks of 16 bytes, two chunks a thread.
  // w staging: 16 k-groups x 32 n-groups of 4 x 4 bytes, two blocks a thread;
  // a warp's blocks share one 16-byte k chunk (kgl = lane & 3 picks the word)
  // and cover 8 consecutive n-groups.
  const int kgl = lane & 3, ngl = lane >> 2;
  uint32_t b_reg[2][4];                 // w blocks staged through registers
  uint4 a_reg[2];                       // x chunks (byte-by-byte instantiation only)

  auto load_a = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 16;
      const int gm = m0 + row, gk = k0 + col;
      if constexpr (kVec) {
        const bool ok = gm < M && gk < K;
        const int8_t* src = ok ? p.x + (long long)gm * K + gk : p.x;
        cp_async16(&s_a[stage][row * kRow + col], src, ok ? 16 : 0);
      } else {
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
    }
  };
  auto store_a = [&](int stage) {          // byte-by-byte instantiation only
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
        if constexpr (kVec) {
          if (gk < K && gn < N)
            word = *reinterpret_cast<const uint32_t*>(p.w + (long long)gk * N + gn);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte = (gk < K && gn + b < N)
                ? static_cast<uint8_t>(p.w[(long long)gk * N + gn + b]) : 0u;
            word |= byte << (8 * b);
          }
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
      const uint32_t* r = b_reg[i];          // r[k] holds n = 0..3 of row k
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t col[4] = {                // col[j] holds k = 0..3 of n = j
          __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
          __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
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
  load_a(0, 0);
  if constexpr (kVec) cp_async_commit(); else store_a(0);
  load_b(0);
  store_b(0);
  if constexpr (kVec) cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      load_a(cur ^ 1, (kt + 1) * kBK);
      if constexpr (kVec) cp_async_commit();
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
      if constexpr (!kVec) store_a(cur ^ 1);
      store_b(cur ^ 1);
    }
    if constexpr (kVec) cp_async_wait_all();
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
        if (pairs && gn + 1 < N) {
          store_pair(orow + gn, dequant(c[0], xs, p.ws[gn]), dequant(c[1], xs, p.ws[gn + 1]));
        } else {
          if (gn < N) store_one(orow + gn, dequant(c[0], xs, p.ws[gn]));
          if (gn + 1 < N) store_one(orow + gn + 1, dequant(c[1], xs, p.ws[gn + 1]));
        }
      }
    }
  }
}

template <typename OutT, bool kVec>
int launch(const Params& p, cudaStream_t stream) {
  const long long tiles =
      (long long)((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return -1;
  qmatmul_fwd<OutT, kVec><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [M,K] int8; w: contiguous [K,N] int8; x_scale [M], w_scale
// [N]: contiguous fp32; out: contiguous [M,N], fp32 (out_bf16 0) or bf16 (1).
// vec: 1 when K % 16 == 0, N % 4 == 0, x is 16-byte and w 4-byte aligned
// (whole-chunk loads), else 0 (byte loads).  Returns 0 or the CUDA error of
// the launch; -1 for a grid too large to launch.
extern "C" int repro_qmatmul_fwd(const void* x, const void* w, const void* x_scale,
                                 const void* w_scale, void* out, int M, int N, int K,
                                 int out_bf16, int vec, void* stream) {
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(x_scale), static_cast<const float*>(w_scale), out,
           M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return vec ? launch<__nv_bfloat16, true>(p, st) : launch<__nv_bfloat16, false>(p, st);
  }
  return vec ? launch<float, true>(p, st) : launch<float, false>(p, st);
}
