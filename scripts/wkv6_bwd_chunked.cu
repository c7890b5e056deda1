// WKV-6 (RWKV-6 "Finch" time mix) backward for NVIDIA Hopper (sm_90a), plain
// C interface: a redesign in fp32 tried in place of the port's kernel
// (src/repro_torch/csrc/wkv6_bwd.cu, whose S and G sweeps run in float64) and
// not kept.  It holds every bound of chip_smoke.py phase 18 on the card, but
// takes longer than the port's kernel at rwkv6-3b's training shape.
// scripts/wkv6_bwd_precision.py and chip_smoke.py phase 18(b) build it and
// time it beside the port's kernel, and scripts/wkv6_bwd_chunked_profile.py
// times its phases with clock64(); the port does not use it.
//
// Why it is slow: its chunk pass keeps the block's 8 chunk-start states in
// shared memory (128 KB of 223 KB at hd 64), so an SM holds one block of 8
// warps, 2 a scheduler, and every phase of a chunk waits on latency (shared
// loads, the products' 3-deep accumulator chains, the running products):
// the schedulers issue well under one instruction a cycle.  A faster form
// needs more warps an SM (16 warps at <= 128 registers, or the states out of
// shared memory so two blocks fit) before fewer instructions pay.
//
// The gradient of `wkv6.cu`'s forward.  The reference has no backward kernel
// (it differentiates the jnp scan under its Pallas kernel
// src/repro/kernels/rwkv6/kernel.py:82); this one replaces that autodiff on
// the card.  The forward, per (b, h), from S = 0:
//     out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t)
// Given dout and dS_last (zero when S_last gets no gradient, as in
// training), the state's gradient runs back from G = dS_last:
//     G_{t-1} = diag(w_t) G_t + r_t dout_t^T
// and dr_t = S_{t-1} dout_t + u k_t (v_t . dout_t), dk_t = G_t v_t + u r_t
// (v_t . dout_t), dv_t = G_t^T k_t + (sum r_t u k_t) dout_t, dlogw_t = w_t
// sum_j G_t * S_{t-1}, du = sum r k (v . dout) over b and t.
//
// The chunked form.  Inside a chunk of C = 16 tokens, with S0 the state
// before it, Gc the state's gradient after it, D(a..b) the product of w over
// tokens a..b (1 when empty), pre_t = D(0..t-1), suf_t = D(t+1..C-1) and
// vd[s,s'] = v_s . dout_s', every term of the per-token products expands
// into terms that carry the decay spanning them:
//     dr_t    = pre_t (S0 dout_t) + sum_{s<t} k_s E[s,t]          + u k_t vd[t,t]
//     dk_t    = suf_t (Gc v_t)    + sum_{s'>t} r_s' E[t,s']       + u r_t vd[t,t]
//     dv_t    = (k_t suf_t) Gc    + sum_{s'>t} F[t,s'] dout_s'    + (sum r_t u k_t) dout_t
//     dlogw_t = sum_{s<t<s'} k_s r_s' E[s,s'] + sum_{s<t} k_s suf_s (Gc v_s)
//               + sum_{s'>t} r_s' pre_s' (S0 dout_s') + D(0..C-1) sum_j S0 * Gc
// with E[s,s'] = D(s+1..s'-1) vd[s,s'] and F[t,s'] = sum_i k_t r_s' D(t+1..s'-1)
// (per channel i; the products S0 dout_t, Gc v_t are over j).  No term
// cancels against a larger one where w is small, so fp32 holds dlogw to a
// relative error where the port kernel's running sums hold it only to an
// absolute one and need float64 sweeps (scripts/wkv6_bwd_conditioning.py, on
// the CPU;
// kernels/rwkv6/ref.py wkv6_bwd_chunked_ref is this arithmetic in plain
// PyTorch).  Across chunks S <- D(0..C-1) S + (k suf)^T v and G <-
// D(0..C-1) G + (r pre)^T dout.  Every decay is a product of w <= 1, or
// (F) exp2 of a difference of the chunk's cumulative log2 w that is <= 0:
// strong decays cannot overflow it.
//
// What bounds it on this card: at rwkv6-3b's training shape (B=4, H=40,
// S=2048, hd=64) a call must read r, k, v, logw, dout (5 x 84 MB) and the
// forward's segment states (18 MB) and write dr, dk, dv, dlogw (4 x 84 MB),
// 0.78 GB or 0.23 ms at 3.35 TB/s; the least arithmetic is ~10 hd^2
// operations a token-head, 13.4 GFLOP, 0.20 ms on the fp32 CUDA cores.
// This form takes ~6 hd^2 multiply-adds a token-head in products over j, i
// or a chunk's tokens (S walked forward, S0 dout^T, Gc v^T, (k suf) Gc, the
// G update), plus ~30 hd one channel at a time.  The products run on the
// tensor cores (mma.sync m16n8k8 TF32) with each fp32 operand split in two
// TF32 terms, lo_a hi_b + hi_a lo_b + hi_a hi_b summed in fp32: TF32 alone
// keeps three digits, the split keeps each product within ~2^-19 (ref.py
// matmul_3xtf32 emulates it; the CPU study holds it to every bound).
//
// Design.  The sequence is cut into blocks of 128 tokens, half the forward's
// segment, each of 8 chunks, and four kernels run a call:
//   pass 1  one block per (b, h, block but the first), 256 threads: G from
//           zero at the block's end back to its start, chunk by chunk on the
//           tensor cores, and the block's decay, into scratch;
//   pass 2  one thread per (b, h, state entry): the carry, G_end[q-1] =
//           diag(decay[q]) G_end[q] + local[q] from G_end[last] = dS_last,
//           in place, fp32;
//   pass 3  one block per (b, h, block), 256 threads: S forward from the
//           block's segment's input state (the forward's seg_state; a
//           second-half block walks the first half too), its 8 chunk-start
//           states kept in shared memory (128 KB at hd 64); then its chunks
//           in reverse from G_end, each in two phases by warp pairs.  Phase
//           A: warps 0-1 the chunk's decays (w, cumulative log2 w, k suf,
//           r pre), then S0 dout^T; warps 2-3 Gc v^T, then v dout^T, and
//           sum_j S0 Gc and sum r u k; warps 4-7, once the decays are there,
//           the G update in their registers and (k suf) Gc.  Phase B: warps
//           0-1 dr and dk and warps 2-3 dlogw, one channel a thread with
//           running products of w along s'; warps 4-7 F pair by pair, then
//           dv = (k suf) Gc + [F; sum r u k] dout, and the new G into shared
//           memory.  Every [*, hd] tile in shared memory is XOR-swizzled by
//           16-byte pieces so that a fragment's loads and a channel's are
//           conflict-free;
//   pass 4  one thread per (h, channel): du, the blocks' fp32 parts summed
//           over b and the blocks in float64 (DADD), in a fixed order.
// Nothing is summed by atomics: two calls give the same bits.  Rows stream
// by cp.async (16-byte pieces, zero-filled past S: r = k = v = dout = logw
// = 0 leaves both states as they are) into a ring of ten [16][hd] tiles:
// a forward step takes 3 (k, v, log w), so two more chunks are in flight
// while one computes, a backward step 5.  Strided [B,H,S,hd] views (the
// model's [B,S,H,hd] tensors transposed) go in and out without a copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                // tokens per chunk
constexpr int kBlock = 128;           // tokens per block
constexpr int kCPB = kBlock / kC;     // chunks per block
constexpr int kNT = 256;              // threads of passes 1 and 3
constexpr int kRing = 10;             // [kC][hd] tiles in pass 3's ring
constexpr int kFs = kC + 4;           // row stride of F in shared memory (conflict-free frags)
constexpr float kLog2e = 1.4426950408889634f;

enum Tensor { kR = 0, kK = 1, kV = 2, kDO = 3, kW = 4, kTensors = 5 };

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* dout;
  const float* ds_last;    // [B,H,hd,hd] or null (zero)
  const float* seg_state;  // [B,H,n_seg-1,hd,hd]: the forward's state at the end of segment s, slot s
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;               // [H,hd]
  float* gstate;           // [B,H,n_blk-1,hd,hd]: local G of block q+1, then G_end[q], at slot q
  float* gdecay;           // [B,H,n_blk-1,hd]: prod of w over block q+1 at slot q
  float* du_part;          // [B,H,n_blk,hd]
  int B, H, S, seg_len, n_seg, n_blk;
  long long r_sb, r_sh, r_ss;   // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long o_sb, o_sh, o_ss;   // dout
  long long dr_sb, dr_sh, dr_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long dw_sb, dw_sh, dw_ss;
  long long u_sh;
};

// Element (row, col) of a row-major tile with rows of HD floats in shared
// memory: its 16-byte pieces XOR-swizzled by the row.  The XOR (a
// permutation of 0..7 over rows 8 m .. 8 m + 7, and of its even / odd
// values over rows 4 m .. 4 m + 3) makes three patterns conflict-free: 8
// rows at one 4-column piece (an mma fragment along a row), 4 rows at 8
// columns (a fragment down a column) and one row at 32 columns (a channel a
// lane).  A float4 at col (a multiple of 4) stays whole.
template <int HD>
__device__ __forceinline__ int swz(int row) {       // the XOR of a row's pieces
  return (((row & 3) << 1) | ((row >> 2) & 1)) & (HD / 4 - 1);
}
template <int HD>
__device__ __forceinline__ int sw(int row, int col) {
  return row * HD + (((col >> 2) ^ swz<HD>(row)) << 2) + (col & 3);
}

// sw() of a lane's mma fragment elements, with what depends on the lane
// alone worked out once (the XOR depends on row & 7 only):
// along(r0, c0, rh, ch) = sw(r0 + g + 8 rh, c0 + q + 4 ch),
// down(r0, c0, rh)      = sw(r0 + q + 4 rh, c0 + g),
// for r0 and c0 multiples of 8 (lane = 4 g + q).
template <int HD>
struct FragAddr {
  int g_off, g_x, q_off[2], q_x[2], gb;
  __device__ __forceinline__ explicit FragAddr(int lane) {
    const int g = lane >> 2, q = lane & 3;
    g_off = g * HD + q;
    g_x = swz<HD>(g);
    gb = g >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q_off[h] = (q + 4 * h) * HD + (g & 3);
      q_x[h] = swz<HD>(q + 4 * h);
    }
  }
  __device__ __forceinline__ int along(int r0, int c0, int rh, int ch) const {
    return (r0 + 8 * rh) * HD + g_off + ((((c0 >> 2) + ch) ^ g_x) << 2);
  }
  __device__ __forceinline__ int down(int r0, int c0, int rh) const {
    return r0 * HD + q_off[rh] + ((((c0 >> 2) + gb) ^ q_x[rh]) << 2);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
// 2^x in one special-function instruction (relative error ~2^-22; results
// below 2^-126 flush to 0, decays that nothing would register)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then any mapped address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most `pending` (0, 1 or 2) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}
// the `count` threads (a multiple of 32) of barrier `id`: wait for all, or
// arrive without waiting (its shared-memory writes published first)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// x = hi + lo + e, hi and lo TF32 values (x's, then the rest's, 13 low
// mantissa bits cleared; the rest is exact in fp32), |e| < 2^-20 |x|: three
// instructions (a rounding conversion takes eight)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b over one m16n8k8 TF32 tile: a (16 x 8, rows g and g + 8, columns
// q and q + 4 of lane 4 g + q), b (8 x 8, rows q and q + 4, column g), d
// (rows g and g + 8, columns 2 q and 2 q + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An fp32 fragment split in TF32 terms, and d += a b in three products: the
// small terms first, lo a lo b left out.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
  template <typename F>
  __device__ __forceinline__ void load(F at) {
#pragma unroll
    for (int x = 0; x < N; ++x) split_tf32(at(x), hi[x], lo[x]);
  }
};
// Over NTW tiles that share a (the first n of them): each term for every tile
// before the next term, so the tiles' products overlap in the tensor pipe.
template <int NTW>
__device__ __forceinline__ void mma3_tiles(float (&d)[NTW][4], const Frag<4>& a,
                                           const Frag<2> (&b)[NTW], int n) {
#pragma unroll
  for (int r = 0; r < NTW; ++r)
    if (r < n) mma_tf32(d[r], a.lo, b[r].hi);
#pragma unroll
  for (int r = 0; r < NTW; ++r)
    if (r < n) mma_tf32(d[r], a.hi, b[r].lo);
#pragma unroll
  for (int r = 0; r < NTW; ++r)
    if (r < n) mma_tf32(d[r], a.hi, b[r].hi);
}

// A fragment's element x of lane (g, q): its row and column.
__device__ __forceinline__ int a_row(int x, int g) { return g + 8 * (x & 1); }
__device__ __forceinline__ int a_col(int x, int q) { return q + 4 * (x >> 1); }

// The 16 x 8 tiles of an HD x HD state that NW warps share, TPW a warp:
// warp ws takes tiles ws TPW .. ws TPW + TPW - 1, tile n at rows 16 (n /
// (HD/8)), columns 8 (n % (HD/8)); a warp's tiles share their rows.
template <int HD, int NW>
struct StateTiles {
  static constexpr int NTC = HD / 8;
  static constexpr int T = (HD / 16) * NTC;
  static constexpr int TPW = (T + NW - 1) / NW;
  static_assert(TPW <= NTC && NTC % TPW == 0, "a warp's tiles share their rows");
};

// acc (warp ws's tiles) = diag(dc) acc + A^T B over one chunk: A and B
// [kC][HD] swizzled tiles (the state's rows are A's columns).
template <int HD, int NW>
__device__ __forceinline__ void state_update(float (&acc)[StateTiles<HD, NW>::TPW][4],
                                             const float* A, const float* Bm, const float* dc,
                                             int ws, int lane, const FragAddr<HD>& fa) {
  using ST = StateTiles<HD, NW>;
  const int g = lane >> 2, n_first = ws * ST::TPW;
  if (n_first >= ST::T) return;
  const int m0 = 16 * (n_first / ST::NTC);
  const float d0 = dc[m0 + g], d1 = dc[m0 + g + 8];
#pragma unroll
  for (int r = 0; r < ST::TPW; ++r) {
    acc[r][0] *= d0; acc[r][1] *= d0; acc[r][2] *= d1; acc[r][3] *= d1;
  }
#pragma unroll
  for (int ks = 0; ks < kC / 8; ++ks) {
    Frag<4> a;   // A^T's element (m, k) is A[k][m]
    a.load([&](int x) { return A[fa.down(8 * ks, m0 + 8 * (x & 1), x >> 1)]; });
    Frag<2> b[ST::TPW];
#pragma unroll
    for (int r = 0; r < ST::TPW; ++r) {
      const int n0 = 8 * ((n_first + r) % ST::NTC);
      b[r].load([&](int x) { return Bm[fa.down(8 * ks, n0, x)]; });
    }
    mma3_tiles<ST::TPW>(acc, a, b, ST::TPW);
  }
}

// A state's tiles from row-major global memory (zero for null), and to
// row-major memory (global, or a swizzled tile in shared memory).
template <int HD, int NW>
__device__ __forceinline__ void state_load_global(float (&acc)[StateTiles<HD, NW>::TPW][4],
                                                  const float* src, int ws, int lane) {
  using ST = StateTiles<HD, NW>;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < ST::TPW; ++r) {
    const int n = ws * ST::TPW + r;
    if (n >= ST::T || src == nullptr) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      continue;
    }
    const int m0 = 16 * (n / ST::NTC), c = 8 * (n % ST::NTC) + 2 * q;
    const float2 lo = *reinterpret_cast<const float2*>(src + (m0 + g) * HD + c);
    const float2 hi = *reinterpret_cast<const float2*>(src + (m0 + g + 8) * HD + c);
    acc[r][0] = lo.x; acc[r][1] = lo.y; acc[r][2] = hi.x; acc[r][3] = hi.y;
  }
}

template <int HD, int NW, bool SWIZZLED>
__device__ __forceinline__ void state_store(float* dst, const float (&acc)[StateTiles<HD, NW>::TPW][4],
                                            int ws, int lane) {
  using ST = StateTiles<HD, NW>;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < ST::TPW; ++r) {
    const int n = ws * ST::TPW + r;
    if (n >= ST::T) continue;
    const int m0 = 16 * (n / ST::NTC), c = 8 * (n % ST::NTC) + 2 * q;
    st2(dst + (SWIZZLED ? sw<HD>(m0 + g, c) : (m0 + g) * HD + c), acc[r][0], acc[r][1]);
    st2(dst + (SWIZZLED ? sw<HD>(m0 + g + 8, c) : (m0 + g + 8) * HD + c), acc[r][2], acc[r][3]);
  }
}

// acc[r] (columns n-tile nt0 + r) += sum_k X[t][k] M[col][k] over k < HD:
// X [kC][HD] and M [*][HD] swizzled (out[t][i] = (M X_t)[i]).
template <int HD, int NTW>
__device__ __forceinline__ void prod_xmt(float (&acc)[NTW][4], const float* X, const float* M,
                                         int nt0, int nt_end, const FragAddr<HD>& fa) {
  const int n = min(NTW, nt_end - nt0);
  if (n <= 0) return;
  float acc2[NTW][4] = {};                        // odd k-steps: twice the products in flight
#pragma unroll 1
  for (int ks = 0; ks < HD / 8; ks += 2) {
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      Frag<4> a;
      a.load([&](int x) { return X[fa.along(0, 8 * (ks + odd), x & 1, x >> 1)]; });
      Frag<2> b[NTW];
#pragma unroll
      for (int r = 0; r < NTW; ++r) {
        const int n0 = 8 * min(nt0 + r, nt_end - 1);
        b[r].load([&](int x) { return M[fa.along(n0, 8 * (ks + odd), 0, x)]; });
      }
      mma3_tiles<NTW>(odd ? acc2 : acc, a, b, n);
    }
  }
#pragma unroll
  for (int r = 0; r < NTW; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] += acc2[r][e];
}

// acc[r] (columns n-tile nt0 + r) += sum_k A[t][k] M[k][col] over k < K:
// M [K][HD] swizzled, A [kC][HD] swizzled (PLAIN: [kC][kFs] row-major).
template <int HD, int NTW, bool PLAIN>
__device__ __forceinline__ void prod_am(float (&acc)[NTW][4], const float* A, const float* M,
                                        int K, int nt0, int nt_end, int lane,
                                        const FragAddr<HD>& fa) {
  const int g = lane >> 2, q = lane & 3, n = min(NTW, nt_end - nt0);
  if (n <= 0) return;
#pragma unroll 1
  for (int ks = 0; ks < K / 8; ++ks) {
    Frag<4> a;
    a.load([&](int x) {
      return PLAIN ? A[(a_row(x, g)) * kFs + 8 * ks + a_col(x, q)]
                   : A[fa.along(0, 8 * ks, x & 1, x >> 1)];
    });
    Frag<2> b[NTW];
#pragma unroll
    for (int r = 0; r < NTW; ++r) {
      const int n0 = 8 * min(nt0 + r, nt_end - 1);
      b[r].load([&](int x) { return M[fa.down(8 * ks, n0, x)]; });
    }
    mma3_tiles<NTW>(acc, a, b, n);
  }
}

// A [kC][HD] product's tiles into a swizzled [kC][HD] tile of shared memory.
template <int HD, int NTW>
__device__ __forceinline__ void tiles_store(float* out, const float (&acc)[NTW][4], int nt0,
                                            int nt_end, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < NTW; ++r) {
    if (nt0 + r >= nt_end) continue;
    const int c = 8 * (nt0 + r) + 2 * q;
    st2(out + sw<HD>(g, c), acc[r][0], acc[r][1]);
    st2(out + sw<HD>(g + 8, c), acc[r][2], acc[r][3]);
  }
}

// The chunk at token t0 into the tiles dst[x] of shared memory (swizzled
// [kC][HD]) for each Tensor x whose dst is not null, tokens at or past S
// zero-filled; one copy group.
template <int HD>
__device__ __forceinline__ void load_chunk(const Params& p, float* const (&dst)[kTensors], int b,
                                           int h, int t0) {
  constexpr int PIECES = kC * HD / 4;
  const float* base[kTensors] = {p.r + b * p.r_sb + h * p.r_sh, p.k + b * p.k_sb + h * p.k_sh,
                                 p.v + b * p.v_sb + h * p.v_sh, p.dout + b * p.o_sb + h * p.o_sh,
                                 p.lw + b * p.w_sb + h * p.w_sh};
  const long long ss[kTensors] = {p.r_ss, p.k_ss, p.v_ss, p.o_ss, p.w_ss};
  for (int e = threadIdx.x; e < PIECES; e += kNT) {
    const int t = e / (HD / 4), c4 = (e % (HD / 4)) * 4, pos = t0 + t;
    const bool ok = pos < p.S;
    const long long at = ok ? pos : 0;
#pragma unroll
    for (int x = 0; x < kTensors; ++x)
      if (dst[x] != nullptr) cp_async16(dst[x] + sw<HD>(t, c4), base[x] + at * ss[x] + c4, ok);
  }
  cp_async_commit();
}

// pre_t = D(0..t-1), suf_t = D(t+1..C-1): running products of w
__device__ __forceinline__ void prefix_suffix(const float (&w)[kC], float (&pre)[kC], float (&suf)[kC]) {
  pre[0] = 1.f;
#pragma unroll
  for (int t = 1; t < kC; ++t) pre[t] = pre[t - 1] * w[t - 1];
  suf[kC - 1] = 1.f;
#pragma unroll
  for (int t = kC - 2; t >= 0; --t) suf[t] = suf[t + 1] * w[t + 1];
}

// Channel i's w = exp(log w) over a landed chunk, written back in place;
// with l2 also the chunk's running sum of log2 w into it.
// (Every load comes before any store: the compiler cannot tell that they do
// not alias, and would otherwise take them one token at a time.)
template <int HD>
__device__ __forceinline__ void chunk_w(float* W, int i, float (&w)[kC], float* l2 = nullptr) {
  float lw2[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) lw2[t] = W[sw<HD>(t, i)] * kLog2e;
#pragma unroll
  for (int t = 0; t < kC; ++t) w[t] = ex2(lw2[t]);
#pragma unroll
  for (int t = 0; t < kC; ++t) W[sw<HD>(t, i)] = w[t];
  if (l2 != nullptr) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      acc += lw2[t];
      l2[sw<HD>(t, i)] = acc;
    }
  }
}

// out[t][i] = A[t][i] * f[t] for a column of [kC][HD] tiles, loads first.
template <int HD>
__device__ __forceinline__ void scale_column(float* out, const float* A, const float (&f)[kC], int i) {
  float a[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) a[t] = A[sw<HD>(t, i)];
#pragma unroll
  for (int t = 0; t < kC; ++t) out[sw<HD>(t, i)] = a[t] * f[t];
}

// Shared memory of pass 3 (floats): the chunk-start states, G, the ring, the
// chunk's k suf, r pre and cumulative log2 w, S0 dout^T and Gc v^T, vd and
// F, per-channel and per-token vectors, then the chunk's outputs.
template <int HD>
struct Smem3 {
  static constexpr int TILE = kC * HD;
  static constexpr int SLOTS = 0;
  static constexpr int G = SLOTS + kCPB * HD * HD;
  static constexpr int RING = G + HD * HD;
  static constexpr int KT = RING + kRing * TILE;
  static constexpr int RT = KT + TILE;
  static constexpr int L2 = RT + TILE;
  static constexpr int X1 = L2 + TILE;
  static constexpr int X2 = X1 + TILE;
  static constexpr int VD = X2 + TILE;
  static constexpr int F = VD + kC * kC;
  static constexpr int DC = F + kC * kFs;
  static constexpr int PSIG = DC + HD;
  static constexpr int U = PSIG + HD;
  static constexpr int RUK = U + HD;
  static constexpr int OUT = RUK + kC;          // dr, dk, dv, dlogw of a chunk, to write out
  static constexpr int FLOATS = OUT + 4 * TILE;
  static constexpr size_t bytes = sizeof(float) * FLOATS;
};

// Shared memory of pass 1 (floats): two ring stages (r, dout, log w), r pre,
// the chunk's decay.
template <int HD>
struct Smem1 {
  static constexpr int TILE = kC * HD;
  static constexpr int RING = 0;
  static constexpr int RT = RING + 6 * TILE;
  static constexpr int DC = RT + TILE;
  static constexpr size_t bytes = sizeof(float) * (DC + HD);
};

// Pass 1: block q + 1's G from zero at its end back to its start, and its
// decay, into slot q.
template <int HD>
__global__ void __launch_bounds__(kNT) wkv6_bwd_local(const Params p) {
  using L = Smem1<HD>;
  using ST = StateTiles<HD, 8>;
  constexpr int TILE = kC * HD;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + L::RING;
  float* s_rt = smem + L::RT;
  float* s_dc = smem + L::DC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const FragAddr<HD> fa(lane);
  const int blk = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int slots = p.n_blk - 1;
  const int t_begin = blk * kBlock;
  const int n_ch = (min(p.S, t_begin + kBlock) - t_begin + kC - 1) / kC;
  auto stage = [&](int c) {   // chunk c (the last first): r, dout, log w in stage c & 1
    float* s = ring + (c & 1) * 3 * TILE;
    float* const dst[kTensors] = {s, nullptr, nullptr, s + TILE, s + 2 * TILE};
    load_chunk<HD>(p, dst, b, h, t_begin + (n_ch - 1 - c) * kC);
  };
  float acc[ST::TPW][4] = {};
  float decay = 1.f;

  stage(0);
  for (int c = 0; c < n_ch; ++c) {
    const float* R = ring + (c & 1) * 3 * TILE;
    const float* DO = R + TILE;
    float* W = ring + (c & 1) * 3 * TILE + 2 * TILE;
    cp_async_wait(0);
    __syncthreads();       // chunk c landed; every read of the other stage is done
    if (c + 1 < n_ch) stage(c + 1);
    if (tid < HD) {
      float w[kC], pre[kC], suf[kC];
      chunk_w<HD>(W, tid, w);
      prefix_suffix(w, pre, suf);
      scale_column<HD>(s_rt, R, pre, tid);
      const float dc = pre[kC - 1] * w[kC - 1];
      s_dc[tid] = dc;
      decay *= dc;
    }
    __syncthreads();
    state_update<HD, 8>(acc, s_rt, DO, s_dc, warp, lane, fa);
  }
  state_store<HD, 8, false>(p.gstate + (bh * slots + blk - 1) * HD * HD, acc, warp, lane);
  if (tid < HD) p.gdecay[(bh * slots + blk - 1) * HD + tid] = decay;
}

// Pass 2: one thread per (b, h, state entry i, j); slot q of gstate turns
// from block q+1's local G into G at the end of block q.
template <int HD>
__global__ void wkv6_bwd_carry(const Params p) {
  const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long bh = e / (HD * HD);
  const int ij = static_cast<int>(e % (HD * HD)), i = ij / HD;
  const int slots = p.n_blk - 1;
  float cur = p.ds_last != nullptr ? p.ds_last[e] : 0.f;
  for (int s = slots; s >= 1; --s) {
    const long long slot = bh * slots + s - 1;
    float* g = p.gstate + slot * HD * HD + ij;
    cur = fmaf(p.gdecay[slot * HD + i], cur, *g);
    *g = cur;
  }
}

// Pass 3: one block per (b, h, block): S forward to the block's chunks, then
// the chunks in reverse, every gradient.
template <int HD>
__global__ void __launch_bounds__(kNT, 1) wkv6_bwd_chunks(const Params p) {
  using L = Smem3<HD>;
  using S8 = StateTiles<HD, 8>;     // S in the forward walk: all 8 warps
  using G4 = StateTiles<HD, 4>;     // G in the backward walk: warps 4-7
  constexpr int TILE = kC * HD;
  constexpr int NTC = HD / 8;                   // 8-column tiles across hd
  constexpr int NT2 = (NTC + 1) / 2;            // S0 dout^T / Gc v^T: a warp of a pair
  constexpr int NT4 = (NTC + 3) / 4;            // (k suf) Gc and dv: a warp of warps 4-7
  extern __shared__ __align__(16) float smem[];
  float* slots = smem + L::SLOTS;
  float* s_g = smem + L::G;
  float* ring = smem + L::RING;
  float* s_kt = smem + L::KT;
  float* s_rt = smem + L::RT;
  float* s_l2 = smem + L::L2;
  float* s_x1 = smem + L::X1;
  float* s_x2 = smem + L::X2;
  float* s_vd = smem + L::VD;
  float* s_f = smem + L::F;
  float* s_dc = smem + L::DC;
  float* s_psig = smem + L::PSIG;
  float* s_u = smem + L::U;
  float* s_ruk = smem + L::RUK;
  float* s_out = smem + L::OUT;                 // [dr, dk, dv, dlogw][kC][HD], swizzled

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const FragAddr<HD> fa(lane);
  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int per_seg = p.seg_len / kBlock;
  const int seg = blk / per_seg;
  const int own_off = (blk % per_seg) * kCPB;   // chunks of the segment before this block
  const int seg_t0 = seg * p.seg_len, blk_t0 = blk * kBlock;
  const int n_own = (min(p.S, blk_t0 + kBlock) - blk_t0 + kC - 1) / kC;
  const int n_fwd = own_off + n_own - 1;        // chunks S steps over
  const int n_steps = n_fwd + n_own;

  // The ring: step s's chunk takes tiles off(s) .. off(s) + 2 (forward: k,
  // v, log w) or + 4 (backward: r, k, v, dout, log w), mod kRing.
  auto n_tiles = [&](int s) { return s < n_fwd ? 3 : 5; };
  auto tile = [&](int s, int x) {
    const int off = 3 * min(s, n_fwd) + 5 * max(0, s - n_fwd);
    return ring + ((off + x) % kRing) * TILE;
  };
  int next = 0;                                 // the next step to issue
  auto fill = [&](int cur) {                    // issue while chunks cur .. next fit
    int used = 0;
    for (int s = cur; s < next; ++s) used += n_tiles(s);
    while (next < n_steps && used + n_tiles(next) <= kRing) {
      used += n_tiles(next);
      if (next < n_fwd) {
        float* const dst[kTensors] = {nullptr, tile(next, 0), tile(next, 1), nullptr, tile(next, 2)};
        load_chunk<HD>(p, dst, b, h, seg_t0 + next * kC);
      } else {
        float* const dst[kTensors] = {tile(next, 0), tile(next, 1), tile(next, 2), tile(next, 3),
                                      tile(next, 4)};
        load_chunk<HD>(p, dst, b, h, blk_t0 + (n_steps - 1 - next) * kC);
      }
      ++next;
    }
  };
  auto land = [&](int s) {                      // step s's chunk in place, every earlier one read
    cp_async_wait(next - s - 1);
    __syncthreads();
  };
  if (tid < HD) s_u[tid] = p.u[h * p.u_sh + tid];

  // S forward from the segment's input state, keeping each own chunk's start
  float sacc[S8::TPW][4];
  state_load_global<HD, 8>(sacc, seg > 0 ? p.seg_state + (bh * (p.n_seg - 1) + seg - 1) * HD * HD
                                         : nullptr, warp, lane);
  fill(0);
  for (int f = 0; f < n_fwd; ++f) {
    land(f);
    fill(f);
    const float* K = tile(f, 0);
    const float* V = tile(f, 1);
    float* W = tile(f, 2);
    if (f >= own_off) state_store<HD, 8, true>(slots + (f - own_off) * HD * HD, sacc, warp, lane);
    if (tid < HD) {
      float w[kC], pre[kC], suf[kC];
      chunk_w<HD>(W, tid, w);
      prefix_suffix(w, pre, suf);
      scale_column<HD>(s_kt, K, suf, tid);
      s_dc[tid] = pre[kC - 1] * w[kC - 1];
    }
    __syncthreads();
    state_update<HD, 8>(sacc, s_kt, V, s_dc, warp, lane, fa);
  }
  state_store<HD, 8, true>(slots + (n_own - 1) * HD * HD, sacc, warp, lane);

  // G at the block's end: warps 4-7 hold it, shared memory has a copy
  float gacc[G4::TPW][4];
  float xacc[NT4][4];                           // (k suf) Gc, then dv
  if (warp >= 4) {
    const float* g0 = blk < p.n_blk - 1 ? p.gstate + (bh * (p.n_blk - 1) + blk) * HD * HD
                      : p.ds_last != nullptr ? p.ds_last + bh * HD * HD : nullptr;
    state_load_global<HD, 4>(gacc, g0, warp - 4, lane);
    state_store<HD, 4, true>(s_g, gacc, warp - 4, lane);
  }

  // A chunk's outputs leave from shared memory in 16-byte pieces, spread over
  // every thread (one thread's column of scalar stores queued behind the
  // ring's copies)
  float* const out_base[4] = {p.dr + b * p.dr_sb + h * p.dr_sh, p.dk + b * p.dk_sb + h * p.dk_sh,
                              p.dv + b * p.dv_sb + h * p.dv_sh, p.dlw + b * p.dw_sb + h * p.dw_sh};
  const long long out_ss[4] = {p.dr_ss, p.dk_ss, p.dv_ss, p.dw_ss};
  auto flush = [&](int t_first) {
    for (int e = tid; e < 4 * TILE / 4; e += kNT) {
      const int x = e / (TILE / 4), t = (e % (TILE / 4)) / (HD / 4), c4 = 4 * (e % (HD / 4));
      if (t_first + t < p.S)
        __stcs(reinterpret_cast<float4*>(out_base[x] + (t_first + t) * out_ss[x] + c4),
               ld4(s_out + x * TILE + sw<HD>(t, c4)));
    }
  };

  float du_acc = 0.f;
  for (int step = n_fwd; step < n_steps; ++step) {
    const int j = n_steps - 1 - step;             // own chunk, last first
    const int t0 = blk_t0 + j * kC;
    const float* s0 = slots + j * HD * HD;
    land(step);
    if (step > n_fwd) flush(t0 + kC);             // the chunk after this one, before the copies
    fill(step);
    const float* R = tile(step, 0);
    const float* K = tile(step, 1);
    const float* V = tile(step, 2);
    const float* DO = tile(step, 3);
    float* W = tile(step, 4);

    // Phase A
    if (warp < 2) {
      // the chunk's decays, then S0 dout_t
      if (tid < HD) {
        float w[kC], pre[kC], suf[kC];
        chunk_w<HD>(W, tid, w, s_l2);
        prefix_suffix(w, pre, suf);
        scale_column<HD>(s_kt, K, suf, tid);
        scale_column<HD>(s_rt, R, pre, tid);
        s_dc[tid] = pre[kC - 1] * w[kC - 1];
      }
      bar_arrive(1, 192);
      float acc[NT2][4] = {};
      prod_xmt<HD, NT2>(acc, DO, s0, warp * NT2, NTC, fa);
      tiles_store<HD, NT2>(s_x1, acc, warp * NT2, NTC, lane);
    } else if (warp < 4) {
      float acc[NT2][4] = {};
      prod_xmt<HD, NT2>(acc, V, s_g, (warp - 2) * NT2, NTC, fa);      // Gc v_t
      tiles_store<HD, NT2>(s_x2, acc, (warp - 2) * NT2, NTC, lane);
      if (warp == 2) {   // vd[s][s'] = v_s . dout_s'
        float vacc[2][4] = {};
        prod_xmt<HD, 2>(vacc, V, DO, 0, 2, fa);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          st2(s_vd + g * kC + 8 * r + 2 * q, vacc[r][0], vacc[r][1]);
          st2(s_vd + (g + 8) * kC + 8 * r + 2 * q, vacc[r][2], vacc[r][3]);
        }
        // the diagonal, which du sums over every token, in fp32 on the CUDA
        // cores: half the channels a lane
        const int t = lane >> 1, half = lane & 1;
        float acc2 = 0.f;
#pragma unroll
        for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 4) {
          const float4 vv = ld4(V + sw<HD>(t, c)), oo = ld4(DO + sw<HD>(t, c));
          acc2 = fmaf(vv.x, oo.x, fmaf(vv.y, oo.y, fmaf(vv.z, oo.z, fmaf(vv.w, oo.w, acc2))));
        }
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, 1);
        __syncwarp();
        if (half == 0) s_vd[t * kC + t] = acc2;
      } else {
        for (int i = lane; i < HD; i += 32) {   // sum_j S0 Gc, row i
          float acc2 = 0.f;
#pragma unroll 4
          for (int jb = 0; jb < HD; jb += 4) {
            const float4 a = ld4(s0 + sw<HD>(i, jb)), gg = ld4(s_g + sw<HD>(i, jb));
            acc2 = fmaf(a.x, gg.x, fmaf(a.y, gg.y, fmaf(a.z, gg.z, fmaf(a.w, gg.w, acc2))));
          }
          s_psig[i] = acc2;
        }
        {   // sum_i r_t u k_t, half the channels a lane
          const int t = lane >> 1, half = lane & 1;
          float acc2 = 0.f;
#pragma unroll
          for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 4) {
            const float4 rr = ld4(R + sw<HD>(t, c)), kk = ld4(K + sw<HD>(t, c)), uu = ld4(s_u + c);
            acc2 = fmaf(rr.x * uu.x, kk.x, fmaf(rr.y * uu.y, kk.y,
                   fmaf(rr.z * uu.z, kk.z, fmaf(rr.w * uu.w, kk.w, acc2))));
          }
          acc2 += __shfl_xor_sync(0xffffffffu, acc2, 1);
          if (half == 0) s_ruk[t] = acc2;
        }
      }
    } else {
      bar_sync(1, 192);                          // the chunk's decays are in
      state_update<HD, 4>(gacc, s_rt, DO, s_dc, warp - 4, lane, fa);   // G, the chunk before
#pragma unroll
      for (int r = 0; r < NT4; ++r) xacc[r][0] = xacc[r][1] = xacc[r][2] = xacc[r][3] = 0.f;
      prod_am<HD, NT4, false>(xacc, s_kt, s_g, HD, (warp - 4) * NT4, NTC, lane, fa);  // (k suf) Gc
    }
    __syncthreads();

    // Phase B
    if (warp < 4) {
      const int i = tid & 63;
      if (i < HD) {
        float w[kC], pre[kC], suf[kC], kk[kC], rr[kC];
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          const int x = sw<HD>(t, i);
          w[t] = W[x]; kk[t] = K[x]; rr[t] = R[x];
        }
        prefix_suffix(w, pre, suf);
        const float u = s_u[i];
        if (warp < 2) {
          // dr, dk: E[s,s'] = D(s+1..s'-1) vd[s,s'], D a running product along
          // s', the pairs taken by their distance s' - s so that the 16
          // running products advance together
          float drs[kC] = {}, dks[kC] = {}, dd[kC];
#pragma unroll
          for (int s = 0; s < kC; ++s) dd[s] = 1.f;
#pragma unroll
          for (int gap = 1; gap < kC; ++gap) {
#pragma unroll
            for (int s = 0; s + gap < kC; ++s) {
              const int s1 = s + gap;
              const float ev = dd[s] * s_vd[s * kC + s1];
              drs[s1] = fmaf(kk[s], ev, drs[s1]);
              dks[s] = fmaf(rr[s1], ev, dks[s]);
              dd[s] *= w[s1];
            }
          }
          float x1[kC], vdd[kC];
#pragma unroll
          for (int t = 0; t < kC; ++t) {
            x1[t] = s_x1[sw<HD>(t, i)];
            vdd[t] = s_vd[t * kC + t];
          }
          float x2[kC];
#pragma unroll
          for (int t = 0; t < kC; ++t) x2[t] = s_x2[sw<HD>(t, i)];
#pragma unroll
          for (int t = 0; t < kC; ++t) {
            du_acc = fmaf(rr[t] * kk[t], vdd[t], du_acc);
            s_out[sw<HD>(t, i)] = fmaf(pre[t], x1[t], drs[t]) + u * kk[t] * vdd[t];
            s_out[TILE + sw<HD>(t, i)] = fmaf(suf[t], x2[t], dks[t]) + u * rr[t] * vdd[t];
          }
        } else {
          // dlogw: the pairs s < t < s', a row s at a time: its pairs summed
          // over s' > t for each t > s; then the terms through Gc (s < t) and
          // S0 (s' > t), and D(0..C-1) sum_j S0 Gc
          float dl[kC] = {};
#pragma unroll
          for (int s = 0; s < kC - 2; ++s) {
            float pr[kC];
            float d = w[s + 1];                   // D(s+1..s'-1) at s' = s + 2
#pragma unroll
            for (int s1 = s + 2; s1 < kC; ++s1) {
              pr[s1] = rr[s1] * (kk[s] * s_vd[s * kC + s1]) * d;
              d *= w[s1];
            }
            float acc = 0.f;
#pragma unroll
            for (int t = kC - 2; t > s; --t) {
              acc += pr[t + 1];
              dl[t] += acc;
            }
          }
          float x1[kC], x2[kC];
#pragma unroll
          for (int t = 0; t < kC; ++t) {
            x1[t] = s_x1[sw<HD>(t, i)];
            x2[t] = s_x2[sw<HD>(t, i)];
          }
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < kC; ++t) {
            dl[t] += acc;
            acc = fmaf(kk[t] * suf[t], x2[t], acc);
          }
          acc = 0.f;
#pragma unroll
          for (int t = kC - 1; t >= 0; --t) {
            dl[t] += acc;
            acc = fmaf(rr[t] * pre[t], x1[t], acc);
          }
          const float tail = s_dc[i] * s_psig[i];
#pragma unroll
          for (int t = 0; t < kC; ++t) s_out[3 * TILE + sw<HD>(t, i)] = dl[t] + tail;
        }
      }
    } else {
      const int e = tid - 128;
      // F[t][s'] = sum_i k_t r_s' exp2(L2_{s'-1} - L2_t) above the diagonal,
      // sum_i r_t u k_t on it, 0 below
      if (e < kC * (kC - 1) / 2) {
        int t = 0, s1 = e;                      // the e-th pair t < s', row by row
        while (s1 >= kC - 1 - t) s1 -= kC - 1 - t++;
        s1 += t + 1;
        float acc[4] = {};
        const float* kt_row = K + t * HD;
        const float* rs_row = R + s1 * HD;
        const float* lt_row = s_l2 + t * HD;
        const float* ls_row = s_l2 + (s1 - 1) * HD;
        const int xt = swz<HD>(t), xs = swz<HD>(s1), xl = swz<HD>(s1 - 1);
#pragma unroll 4
        for (int c = 0; c < HD / 4; ++c) {
          const float4 kk = ld4(kt_row + ((c ^ xt) << 2)), rr = ld4(rs_row + ((c ^ xs) << 2));
          const float4 lt = ld4(lt_row + ((c ^ xt) << 2)), ls = ld4(ls_row + ((c ^ xl) << 2));
          acc[0] = fmaf(kk.x * rr.x, ex2(ls.x - lt.x), acc[0]);
          acc[1] = fmaf(kk.y * rr.y, ex2(ls.y - lt.y), acc[1]);
          acc[2] = fmaf(kk.z * rr.z, ex2(ls.z - lt.z), acc[2]);
          acc[3] = fmaf(kk.w * rr.w, ex2(ls.w - lt.w), acc[3]);
        }
        s_f[t * kFs + s1] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      for (int n = e; n < kC * kC; n += 128) {
        const int t = n / kC, s1 = n % kC;
        if (s1 <= t) s_f[t * kFs + s1] = s1 == t ? s_ruk[t] : 0.f;
      }
      bar_sync(2, 128);
      // dv_t = (k suf) Gc + sum_{s'} F[t][s'] dout_s'
      const int nt0 = (warp - 4) * NT4;
      prod_am<HD, NT4, true>(xacc, s_f, DO, kC, nt0, NTC, lane, fa);
      tiles_store<HD, NT4>(s_out + 2 * TILE, xacc, nt0, NTC, lane);
      state_store<HD, 4, true>(s_g, gacc, warp - 4, lane);    // G for the chunk before
    }
  }
  __syncthreads();
  flush(blk_t0);                                  // the block's first chunk
  if (tid < HD) p.du_part[(bh * p.n_blk + blk) * HD + tid] = du_acc;
}

// Pass 4: one thread per (h, channel): du, the blocks' parts summed over b
// and the blocks in float64.
template <int HD>
__global__ void wkv6_bwd_du(const Params p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.H * HD) return;
  const int h = e / HD, i = e % HD;
  double sum = 0.0;
  for (int b = 0; b < p.B; ++b)
    for (int q = 0; q < p.n_blk; ++q)
      sum += static_cast<double>(p.du_part[((static_cast<long long>(b) * p.H + h) * p.n_blk + q) * HD + i]);
  p.du[e] = static_cast<float>(sum);
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (p.n_blk > 1) {
    wkv6_bwd_local<HD><<<dim3(p.n_blk - 1, p.H, p.B), kNT, Smem1<HD>::bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
    wkv6_bwd_carry<HD><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = cudaFuncSetAttribute(wkv6_bwd_chunks<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(Smem3<HD>::bytes))) != cudaSuccess)
    return err;
  wkv6_bwd_chunks<HD><<<dim3(p.n_blk, p.H, p.B), kNT, Smem3<HD>::bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_du<HD><<<(p.H * HD + 255) / 256, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw, dout: [B,H,S,hd] fp32 with unit-stride head dim; u: [H,hd];
// ds_last: contiguous [B,H,hd,hd] or null (a zero cotangent); seg_state: the
// forward's contiguous [B,H,n_seg-1,hd,hd] states at the ends of segments
// 0 .. n_seg-2, n_seg = ceil(S / seg_len).  Writes dr, dk, dv, dlogw
// ([B,H,S,hd], strided) and du (contiguous [H,hd]).  Scratch, contiguous
// fp32, n_blk = ceil(S / 128): gstate [B,H,n_blk-1,hd,hd], gdecay
// [B,H,n_blk-1,hd], du_part [B,H,n_blk,hd].  strides: (b, h, s) of r, k, v,
// logw, dout, dr, dk, dv, dlogw, then u's head stride.  S >= 1; seg_len a
// positive multiple of 128 (the forward's segment).  Returns 0 or the CUDA
// error of the first launch that fails; -1 for a head dim without an
// instantiation or a bad length.
extern "C" int repro_wkv6_bwd(int head_dim, const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* dout,
                              const void* ds_last, const void* seg_state, void* dr, void* dk,
                              void* dv, void* dlogw, void* du, void* gstate, void* gdecay,
                              void* du_part, int B, int H, int S, int seg_len,
                              const long long* strides, void* stream) {
  if (seg_len <= 0 || seg_len % kBlock != 0 || S <= 0) return -1;
  const int n_seg = (S + seg_len - 1) / seg_len;
  const int n_blk = (S + kBlock - 1) / kBlock;
  const long long* s = strides;
  Params p{static_cast<const float*>(r), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(dout),
           static_cast<const float*>(ds_last), static_cast<const float*>(seg_state),
           static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
           static_cast<float*>(dlogw), static_cast<float*>(du), static_cast<float*>(gstate),
           static_cast<float*>(gdecay), static_cast<float*>(du_part), B, H, S, seg_len, n_seg,
           n_blk,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
           s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
           s[24], s[25], s[26], s[27]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
  }
  return -1;
}
