// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:96, body `_fa_kernel` :29):
// softmax(softcap(q k^T / sqrt(hd)) masked) v with causal mask kpos <= qpos,
// sliding window kpos > qpos - window, GQA head h -> h / (H / KV), and an
// online softmax whose running max, sum and accumulator are fp32.
//
// What bounds it on this card: at the prefill shapes of the serving path
// (granite-3-8b B=4 S=2048 hd=128; gemma2-9b S=8192 hd=256) the work is
// ~4*B*H*hd*(visible q.k pairs) FLOPs against 2*(|q|+|k|+|v|+|o|) bytes,
// i.e. hundreds of FLOPs per byte: compute-bound (989 TFLOP/s bf16 tensor
// cores vs 3.35 TB/s HBM).  So the design keeps the S/P tiles out of device
// memory and puts both products on the tensor cores:
//   * one 128-thread block per (q tile, head, batch); each warp owns 16 rows;
//   * a loop inside the block over only the kv tiles the causal/window masks
//     leave visible (the range is computed, not tested tile by tile);
//   * K and V tiles double-buffered in shared memory with cp.async (the
//     next tile loads while this one is computed); q k^T and p v are bf16
//     mma.sync.m16n8k16 with fp32 accumulators; P never leaves registers
//     (the C fragment of q k^T is the A fragment of p v);
//   * the mask is evaluated only on tiles some row does not see in full;
//   * ragged Sq / Skv are masked, so no length needs to be a tile multiple.
// Measured, this mma.sync design stays far from that bound: it is latency-
// bound (too few warps in flight per SM), which is why the key tile is sized
// for occupancy below.  wgmma, TMA and warp specialisation are later work.
// fp32 inputs take a CUDA-core kernel with the same tiling of the work, since
// the tensor cores would round fp32 to TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;   // same masked logit as the TPU kernel
constexpr int kThreads = 128;
// Keys per tile of the bf16 kernel.  The kernel is latency-bound, so the tile
// is sized for occupancy: 32 keys keep hd 128 at ~125 registers and 52 KB of
// double-buffered shared memory, 4 blocks (16 warps) per SM; 64 keys need
// ~160 registers and 87 KB, 2 blocks per SM, and run slower (PERF.md).
constexpr int kBlockKBf16 = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Skv;
  long long q_sb, q_sh, q_ss;   // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// First key and one past the last key any row of [q_lo, q_last] can see.
__device__ __forceinline__ void key_range(const Params& p, int q_lo, int q_last,
                                          int& k_begin, int& k_end) {
  k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
}

__device__ __forceinline__ float logit(const Params& p, float s) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

// ------------------------------------------------------------- bf16: mma.sync

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of a [16 keys x 8 dims] block of row-major V, transposed on load.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row_ptr) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;   // 0: read nothing, zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) of a [S, HD] bf16 slab into shared
// memory (row stride LD), 16 bytes per thread per step; rows >= S are
// zero-filled.  Completes at a later cp_async_wait.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int row0, int S) {
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < S;
    cp_async_16(dst + r * LD + c, valid ? src + (row0 + r) * row_stride + c : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) fa_fwd_bf16(Params p) {
  constexpr int BQ = 64;          // 4 warps x 16 query rows
  constexpr int BK = kBlockKBf16;
  constexpr int LD = HD + 8;      // 16-byte row pad: conflict-free fragment loads
  constexpr int NT = BK / 8;      // 8-key column tiles of S per warp
  constexpr int DT = HD / 8;      // 8-dim column tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [BQ][LD] q tile, then K buffers 0 and 1, then V buffers 0 and 1, [BK][LD] each
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + 2 * BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_lo = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // This thread's two rows: r0 = 16*warp + g and r0 + 8 of the q tile.
  const int qr0 = q_lo + warp * 16 + g, qr1 = qr0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's columns
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  int k_begin, k_end;
  key_range(p, q_lo, min(q_lo + BQ, p.Sq) - 1, k_begin, k_end);
  const int k_first = (k_begin / BK) * BK;
  // Pipeline: the q tile and the first K/V tile form one copy group; every
  // iteration starts the next tile's copy before it computes on this one.
  load_tile_async<BQ, HD, LD>(sQ, qg, p.q_ss, q_lo, p.Sq);
  if (k_first < k_end) {
    load_tile_async<BK, HD, LD>(sK, kg, p.k_ss, k_first, p.Skv);
    load_tile_async<BK, HD, LD>(sV, vg, p.v_ss, k_first, p.Skv);
  }
  cp_async_commit();
  int buf = 0;
  for (int k0 = k_first; k0 < k_end; k0 += BK, buf ^= 1) {
    if (k0 + BK < k_end) {   // this buffer was last read before the trailing sync
      load_tile_async<BK, HD, LD>(sK + (buf ^ 1) * BK * LD, kg, p.k_ss, k0 + BK, p.Skv);
      load_tile_async<BK, HD, LD>(sV + (buf ^ 1) * BK * LD, vg, p.v_ss, k0 + BK, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();      // everything but the copy just started has landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * BK * LD;
    const __nv_bfloat16* tV = sV + buf * BK * LD;
    // A tile every row of the block sees in full needs no mask.
    const bool full = k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= q_lo) &&
                      (p.window <= 0 || k0 > q_lo + BQ - 1 - p.window);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (warp * 16 + g) * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = tK + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale, softcap, mask, then the online-softmax update of both rows.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qr0 : qr1;
        const float x = full || visible(p, qpos, kpos) ? logit(p, s[nt][e]) : kNegInf;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {   // the 4 lanes that share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // O += P V: P's C fragments (two 8-key tiles) form one 16-key A fragment.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, tV + (kk * 16 + (lane % 16)) * LD + dt * 8);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
    __syncthreads();         // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (qr0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qr0 * p.o_ss + col) = pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (qr1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qr1 * p.o_ss + col) = pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// ------------------------------------------------------------- fp32: CUDA cores

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows ty + 8*i of the q tile,
// key columns tx + 16*j of S and head-dim columns tx + 16*c of O.
template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads) fa_fwd_f32(Params p) {
  constexpr int BK = 64;
  constexpr int LD = HD + 1;       // odd stride: conflict-free column walks
  constexpr int LDP = BK + 1;
  constexpr int R = BQ / 8;        // rows per thread
  constexpr int C = HD / 16;       // O columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [BQ][LD]
  float* sK = sQ + BQ * LD;                         // [BK][LD]
  float* sV = sK + BK * LD;                         // [BK][HD]
  float* sP = sV + BK * HD;                         // [BQ][LDP]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q_lo = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * LD + d] = q_lo + r < p.Sq ? qg[(q_lo + r) * p.q_ss + d] : 0.f;
  }

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(p, q_lo, min(q_lo + BQ, p.Sq) - 1, k_begin, k_end);
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < p.Skv;
      sK[r * LD + d] = in ? kg[(k0 + r) * p.k_ss + d] : 0.f;
      sV[r * HD + d] = in ? vg[(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float qv = sQ[(ty + 8 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q_lo + ty + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(p, qpos, kpos) ? logit(p, s[i][j]) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)   // the 16 lanes that share a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - mn);
        sP[(ty + 8 * i) * LDP + tx + 16 * j] = pj;
        ps += pj;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // a row of sP is written and read by the same 16 lanes

    for (int kk = 0; kk < BK; ++kk) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sV[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pv = sP[(ty + 8 * i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_lo + ty + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) og[row * p.o_ss + tx + 16 * c] = acc[i][c] * inv;
  }
}

// ------------------------------------------------------------------ launches

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int block_q, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + block_q - 1) / block_q, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = (64 + 4 * kBlockKBf16) * (HD + 8) * sizeof(__nv_bfloat16);
  return launch(fa_fwd_bf16<HD>, p, 64, smem, stream);
}

template <int HD, int BQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = ((BQ + 64) * (HD + 1) + 64 * HD + BQ * 65) * sizeof(float);
  return launch(fa_fwd_f32<HD, BQ>, p, BQ, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v and o in that order.  Returns a cudaError_t value,
// or -1 for a dtype / head-dim pair with no instantiation.
extern "C" int repro_flash_attention_fwd(int dtype, int head_dim, const void* q,
                                         const void* k, const void* v, void* o,
                                         int B, int H, int KV, int Sq, int Skv,
                                         const long long* strides, int causal,
                                         int window, float softcap, float scale,
                                         void* stream) {
  Params p{q, k, v, o, B, H, KV, Sq, Skv,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch_bf16<64>(p, st);
      case 128: return launch_bf16<128>(p, st);
      case 256: return launch_bf16<256>(p, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch_f32<64, 64>(p, st);
      case 128: return launch_f32<128, 64>(p, st);
      case 256: return launch_f32<256, 32>(p, st);
    }
  }
  return -1;
}
