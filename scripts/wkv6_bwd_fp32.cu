// WKV-6 (RWKV-6 "Finch" time mix) backward for NVIDIA Hopper (sm_90a), plain
// C interface: a design tried in place of the port's kernel
// (src/repro_torch/csrc/wkv6_bwd.cu, whose sweeps run in float64) and not
// kept.  Its fp32 sweep misses the per-row bound on strong decays, and its
// hybrid (float64 where a segment's decays are strong) is slower than the
// port's kernel there.  scripts/wkv6_bwd_precision.py builds it and times it
// beside the port's kernel; the port does not use it.
//
// The gradient of `wkv6.cu`'s forward.  The reference has no backward kernel
// (it differentiates the jnp scan under its Pallas kernel
// src/repro/kernels/rwkv6/kernel.py:82); this one replaces that autodiff on
// the card.  The forward, per (b, h), from S_0 = 0:
//     out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t)
// Given dout and dS_last (zero when S_last gets no gradient, as in
// training), G_S = dS_last, and for t = S .. 1 (G_t the state's gradient):
//     drs_t = S_{t-1} dout_t            dr_t = drs_t + u * k_t (v_t . dout_t)
//     dks_t = G_t v_t                   dk_t = dks_t + u * r_t (v_t . dout_t)
//     dv_t  = G_t^T k_t + (sum_i r_t u k_t) dout_t
//     du   += r_t * k_t (v_t . dout_t)               (summed over b and t)
//     G_{t-1} = diag(w_t) G_t + r_t dout_t^T
// and dlogw never needs the per-token product sum_j G_t * S_{t-1}: with
// a_t = r_t * drs_t, b_t = k_t * dks_t and P_t = sum_j G_t * S_t (per
// channel), P_{t-1} = P_t + a_t - b_t, so for any e >= tau
//     dlogw_tau = P_e + sum_{tau < t <= e} a_t - sum_{tau <= t <= e} b_t:
// two reverse running sums from an anchor P_e.
//
// What bounds it on this card: at rwkv6-3b's training shape (B=4, H=40,
// S=2048, hd=64) a call reads r, k, v, logw, dout (5 x 84 MB) and the
// forward's segment states (18 MB) and writes dr, dk, dv, dlogw (4 x 84 MB),
// 0.78 GB or 0.23 ms at 3.35 TB/s; the recurrences are ~10 hd^2 operations
// a token-head, 13.4 GFLOP, 0.20 ms on the fp32 CUDA cores (twice that in
// fp64).  The step-by-step form, not the chunked matrix form: every factor
// it multiplies is a w <= 1, so strong decays cannot overflow it.  What
// bounds it in practice is the sweeps' serial recurrence (one token after
// another, ~200-270 instructions a thread a token, 8 x 8 tiles) and the
// precision dlogw needs.
//
// Precision.  The running sums' error is absolute: eps times the terms a_t,
// b_t (~10^2 at this shape), where the per-token product's (the plain
// version's) is relative to w_t.  Where strong decays make a whole row of
// dlogw small (~3e-3 of the tensor's rms), fp32 states alone put it 2-3e-3
// of the row's rms off, over the 1e-3 per-row bound, at any restart length;
// while every token keeps at least half its channels at w >= e^-2, an fp32
// sweep restarted every 64 tokens stays within 2.1e-4 of the row's rms
// (scripts/wkv6_bwd_conditioning.py, CPU).  So each (b, h, segment) takes
// one of two sweeps, chosen by its decays:
//   * no token with more than half its channels' logw below strong_logw
//     (-2): fp32 states and products (8 x 8 fp32 tiles, <= 128 registers at
//     hd 64, 8 blocks an SM); only the two running sums and du's segment
//     sums are float64, fed by fp32 products (DADD, no DFMA / DMUL); the
//     sums restart every `restart` tokens from P_e = sum_j G_e * S_e in fp32;
//   * otherwise: float64 states, products and sums (~250 registers, 4
//     blocks an SM), the sums restarted at the segment's end only.
// The anchor S_e is the forward's state at a segment's end but the last,
// else pass 3's own, kept in fp32 at every restart point.  On an H100 80GB
// (scripts/wkv6_bwd_precision.py) a call at the training shape takes 0.94
// ms where every segment sweeps in fp32 (the reference's decays, rwkv6-3b
// at its seeded init) and 1.38 ms where every one sweeps in float64.
//
// Design.  Every entry of S and of G evolves on its own (row i scaled by
// w_t[i], plus a rank-one term); the coupling is in the sums over rows or
// columns.  So a block holds one head's whole state in registers, hd threads
// with an R x C tile each (8 x 8 at hd 64), sums inside the tile, and
// finishes each sum across the tile's lanes by a reduce-scatter of shuffles
// that leaves every lane one row (or a few columns).  A tile's rows and
// columns are interleaved in fours (4 i .. 4 i + 3, then + 4 x groups), so
// the float4 loads of a token's rows from shared memory are conflict-free.
// The sequence is split into the forward's segments (L = 256 tokens), whose
// input states the forward keeps, and the state's gradient is carried across
// them as the forward's pass 2 carries the state.  Seven launches a call:
//   pass 1  one block per (b, h, segment), in reverse, fp32: the most
//           channels of one token below strong_logw, hence the segment's
//           sweeps' precision, and (all segments but the first) G from zero
//           at the segment's end to its start and the segment's decay prod
//           w, into scratch; the first segments' blocks, which read only
//           log w, come last;
//   pass 2  one thread per (b, h, state entry): the carry,
//           G_end[s-1] = diag(decay[s]) G_end[s] + local[s] from
//           G_end[last] = dS_last, in place;
//   pass 3  one block per (b, h, segment), launched once for each
//           precision (a block of the other one returns at once): S forward
//           from the segment's input state (the forward's seg_state): drs,
//           then dr, a_t into scratch, and the state at each restart point;
//   pass 4  as pass 3, G in reverse from G_end: dks and dv, dk, dv and
//           dlogw, and the segment's part of du;
//   pass 5  one thread per (h, channel): du, the parts summed over b and
//           the segments in a fixed order.
// Nothing is summed by atomics: every sum runs in a fixed order, so two
// calls give the same bits.  Rows stream through shared memory in chunks of
// 8 tokens by cp.async (16-byte pieces, zero-filled past S: r = k = v =
// dout = logw = 0 leaves both states as they are), the next chunk in flight
// while one computes; each thread turns its own pieces of logw into w once.
// Strided [B,H,S,hd] views (the model's [B,S,H,hd] tensors transposed) go in
// and out without a copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 8;           // tokens per chunk
constexpr int kStages = 2;      // chunks in the cp.async ring

enum Mode { kLocal = 0, kState = 1, kGrad = 2 };

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
  float* gstate;           // [B,H,n_seg-1,hd,hd]: local G of segment s+1, then G_end[s], at slot s
  float* gdecay;           // [B,H,n_seg-1,hd]: prod of w over segment s+1 at slot s
  float* spt;              // [B,H,n_seg,n_res,hd,hd]: S at the end of restart block j of segment s
  void* abuf;              // [B,H,S,hd] of 8 bytes: a_t, in its first hd floats or doubles
  double* du_part;         // [B,H,n_seg,hd]
  unsigned char* strong;   // [B,H,n_seg]: 1 where the segment's sweeps run in float64
  float strong_logw;       // a segment with a logw below it is strong
  int B, H, S, seg_len, n_seg, restart, n_res;
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

// hd threads a head, each an R x C tile of the state; R == NC and C == NR,
// so a reduce-scatter over the NC lanes of a row group leaves each lane one
// row, and over the row groups of a warp C / RGW columns.
template <int HD>
struct Tile {
  static constexpr int NT = HD;
  static constexpr int R = HD == 64 ? 8 : 4;
  static constexpr int C = HD / R;
  static constexpr int NC = HD / C;              // column groups
  static constexpr int NR = HD / R;              // row groups
  static constexpr int NW = (NT + 31) / 32;
  static constexpr int LOG_NC = NC == 8 ? 3 : 2;
  static constexpr int RGW = (NT < 32 ? NT : 32) / NC;   // row groups in a warp
  static constexpr int CL = C / RGW;             // columns a lane keeps of a column sum
  static constexpr int TPT = NT / kT;            // threads a token in the dv pass (8 channels each)
  static constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  static_assert(R == NC && C == NR && CL >= 1 && R % 4 == 0 && C % 4 == 0, "tiling");
  static_assert(HD / TPT == 8, "the dv pass takes 8 channels a thread");
};

// Shared memory (floats): staged rows [kStages][kT][HD] of w, dout, r, then
// (passes 3, 4) k, v, then (pass 4) a (Acc), the per-warp column sums of dv
// and u; pass 1 ends with the warps' least logw.
template <int HD, typename Acc>
struct Smem {
  static constexpr int ROWS = kStages * kT * HD;
  static constexpr int W = 0, DO = ROWS, R = 2 * ROWS, K = 3 * ROWS, V = 4 * ROWS, A = 5 * ROWS;
  static constexpr int DVP = A + ROWS * static_cast<int>(sizeof(Acc) / sizeof(float));   // [NW][kT][HD]
  static constexpr int U = DVP + Tile<HD>::NW * kT * HD;
  static constexpr size_t bytes(int mode) {
    return sizeof(float) * (mode == kLocal ? 3 * ROWS : mode == kState ? 5 * ROWS : U + HD);
  }
};

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then any mapped address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// x[0 .. N) in each lane; the G lanes that differ in bits LO .. LO+log2(G)
// exchange halves (the highest bit first) until lane g, g = (lane >> LO) &
// (G-1), holds in x[0 .. N/G) the sums over the G lanes of x[g N/G + m].
template <int N, int G, int LO, typename V>
__device__ __forceinline__ void reduce_scatter(V* x, int lane, unsigned mask) {
  if constexpr (G > 1) {
    constexpr int h = N / 2, o = G / 2;
    const bool upper = (lane >> LO) & o;
#pragma unroll
    for (int m = 0; m < h; ++m) {
      const V send = upper ? x[m] : x[m + h];
      const V keep = upper ? x[m + h] : x[m];
      x[m] = keep + __shfl_xor_sync(mask, send, o << LO);
    }
    reduce_scatter<h, o, LO>(x, lane, mask);
  }
}

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

template <int G, int LO, typename V>
__device__ __forceinline__ V allreduce(V x, unsigned mask) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(mask, x, o << LO);
  return x;
}

// N floats in fours: f(4 q) .. f(4 q) + 3 for q < N / 4 (16-byte aligned),
// as V (float or double).
template <int N, typename V, typename F>
__device__ __forceinline__ void load4(V* dst, const float* base, F f) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(base + f(4 * q));
    dst[4 * q] = x.x; dst[4 * q + 1] = x.y; dst[4 * q + 2] = x.z; dst[4 * q + 3] = x.w;
  }
}

// Passes 1 (kLocal, fp32), 3 (kState) and 4 (kGrad), the latter two in Acc
// (float or double): the recurrence of one head over one segment, X = S
// (pass 3, forward) or G (passes 1 and 4, reverse).
template <int HD, int MODE, typename Acc>
__global__ void __launch_bounds__(HD, sizeof(Acc) == 4 ? 8 : 1) wkv6_bwd_sweep(const Params p) {
  using T = Tile<HD>;
  using L = Smem<HD, Acc>;
  constexpr int R = T::R, C = T::C, NC = T::NC, NR = T::NR;
  constexpr bool REV = MODE != kState;
  constexpr bool F64 = sizeof(Acc) == 8;
  constexpr int ASTRIDE = HD * 8 / sizeof(Acc);   // a_t's row in abuf, in Acc
  extern __shared__ __align__(16) float smem[];
  float(*s_w)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::W);
  float(*s_do)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::DO);
  float(*s_r)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::R);
  float(*s_k)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::K);
  float(*s_v)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::V);
  Acc(*s_a)[kT][HD] = reinterpret_cast<Acc(*)[kT][HD]>(smem + L::A);
  float(*dvp)[kT][HD] = reinterpret_cast<float(*)[kT][HD]>(smem + L::DVP);
  float* s_u = smem + L::U;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if constexpr (MODE == kLocal) {
    // the first segments' blocks, which read only log w, after all the
    // others, so that they fill the last wave instead of lengthening it
    const long long id = blockIdx.x + gridDim.x * (blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z);
    const long long rest = static_cast<long long>(p.n_seg - 1) * p.H * p.B;
    const long long bh_id = id < rest ? id / (p.n_seg - 1) : id - rest;
    seg = id < rest ? 1 + static_cast<int>(id % (p.n_seg - 1)) : 0;
    h = static_cast<int>(bh_id % p.H);
    b = static_cast<int>(bh_id / p.H);
  }
  const long long bh = static_cast<long long>(b) * p.H + h;
  if (MODE != kLocal && p.strong[bh * p.n_seg + seg] != F64) return;   // the other sweep's
  const int slots = p.n_seg - 1;
  const int t_begin = seg * p.seg_len;
  const int t_end = min(p.S, t_begin + p.seg_len);
  const int n_chunks = (t_end - t_begin + kT - 1) / kT;
  const int restart = F64 ? p.seg_len : p.restart;
  const int cg = tid % NC, rg = tid / NC;
  // the tile: index x of R (rows) or C (columns) in fours, interleaved
  auto row = [&](int x) { return 4 * rg + 4 * NR * (x >> 2) + (x & 3); };
  auto col = [&](int x) { return 4 * cg + 4 * NC * (x >> 2) + (x & 3); };
  const int own = row(cg);                 // the row a lane holds after a row reduce-scatter
  const int rg_lo = rg % T::RGW;           // the lane's row group in its warp

  const float* r = p.r + b * p.r_sb + h * p.r_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh;
  const float* dout = p.dout + b * p.o_sb + h * p.o_sh;
  Acc* abuf = reinterpret_cast<Acc*>(p.abuf) + bh * p.S * ASTRIDE;
  float* spt = p.spt + (bh * p.n_seg + seg) * p.n_res * HD * HD;

  // the state's starting value, tile by tile
  Acc X[R][C];
#pragma unroll
  for (int y = 0; y < R; ++y)
#pragma unroll
    for (int x = 0; x < C; ++x) X[y][x] = 0;
  const float* x0 = nullptr;
  if (MODE == kState && seg > 0) x0 = p.seg_state + (bh * slots + seg - 1) * HD * HD;
  if (MODE == kGrad) x0 = seg < slots ? p.gstate + (bh * slots + seg) * HD * HD
                         : p.ds_last ? p.ds_last + bh * HD * HD : nullptr;
  if (x0 != nullptr) {
#pragma unroll
    for (int y = 0; y < R; ++y) load4<C>(X[y], x0 + row(y) * HD, col);
  }
  const Acc u_own = MODE == kLocal ? 0.f : p.u[h * p.u_sh + own];
  if (MODE == kGrad) s_u[tid] = p.u[h * p.u_sh + tid];

  // a restart block of the segment ends after chunk c when c is the last
  // chunk or (c + 1) kT is a multiple of the restart
  auto block_end = [&](int c) { return c == n_chunks - 1 || ((c + 1) * kT) % restart == 0; };

  // chunk c of this sweep into stage st: kT rows of each tensor, 2 pieces of
  // 16 bytes a thread a tensor (4 of a in float64)
  auto stage = [&](int c, int st) {
    const int t0 = t_begin + (REV ? n_chunks - 1 - c : c) * kT;
#pragma unroll
    for (int m = 0; m < kT / 4; ++m) {
      const int e = tid + m * HD;
      const int tt = e / (HD / 4), c4 = (e % (HD / 4)) * 4, pos = t0 + tt;
      const bool ok = pos < t_end;
      const long long q = ok ? pos : 0;
      cp_async16(&s_w[st][tt][c4], lw + q * p.w_ss + c4, ok);
      cp_async16(&s_do[st][tt][c4], dout + q * p.o_ss + c4, ok);
      cp_async16(&s_r[st][tt][c4], r + q * p.r_ss + c4, ok);
      if (MODE != kLocal) {
        cp_async16(&s_k[st][tt][c4], k + q * p.k_ss + c4, ok);
        cp_async16(&s_v[st][tt][c4], v + q * p.v_ss + c4, ok);
      }
    }
    if (MODE == kGrad) {
      constexpr int PER = 16 / sizeof(Acc);                          // a_t values in 16 bytes
      constexpr int PIECES = kT * static_cast<int>(sizeof(Acc)) / 16;   // a thread's pieces
#pragma unroll
      for (int m = 0; m < PIECES; ++m) {
        const int e = tid + m * HD;
        const int tt = e / (HD / PER), cp = (e % (HD / PER)) * PER, pos = t0 + tt;
        const bool ok = pos < t_end;
        cp_async16(&s_a[st][tt][cp], abuf + static_cast<long long>(ok ? pos : 0) * ASTRIDE + cp, ok);
      }
    }
    cp_async_commit();
  };
  // this thread's pieces of log w, once landed, into w; pass 1 also counts
  // each token's channels below strong_logw (a token's HD / 4 pieces lie in
  // HD / 4 neighbouring lanes; a byte a token, summed in one pass of
  // shuffles) and keeps the most it saw
  int most_strong = 0;
  auto to_w = [&](int st) {
    int n = 0;
#pragma unroll
    for (int m = 0; m < kT / 4; ++m) {
      const int e = tid + m * HD;
      float* x = &s_w[st][e / (HD / 4)][(e % (HD / 4)) * 4];
      if constexpr (MODE == kLocal)
        n += ((x[0] < p.strong_logw) + (x[1] < p.strong_logw) + (x[2] < p.strong_logw) +
              (x[3] < p.strong_logw)) << (8 * m);
      x[0] = expf(x[0]); x[1] = expf(x[1]); x[2] = expf(x[2]); x[3] = expf(x[3]);
    }
    if constexpr (MODE == kLocal) {
#pragma unroll
      for (int o = HD / 8; o > 0; o >>= 1) n += __shfl_xor_sync(T::MASK, n, o);
#pragma unroll
      for (int m = 0; m < kT / 4; ++m) most_strong = max(most_strong, (n >> (8 * m)) & 0xff);
    }
  };

  double acc_a = 0.0, acc_b = 0.0;  // pass 4: sums of a (t > tau) and b (t >= tau) in the block
  double acc_p = 0.0;               // pass 4: P at the block's end
  double acc_du = 0.0;              // pass 4: this segment's part of du
  float decay = 1.f;                // pass 1: prod of w over the segment

  // pass 4, where the restart block ending after chunk c begins (in
  // reverse): P_e = sum_j G_e * S_e, row by row (S_e the forward's state at
  // a segment's end but the last, else pass 3's)
  auto anchor = [&](int c) {
    const float* se = seg < slots && c == n_chunks - 1
                          ? p.seg_state + (bh * slots + seg) * HD * HD
                          : spt + static_cast<long long>(c * kT / restart) * HD * HD;
    Acc part[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      Acc s4[C];
      load4<C>(s4, se + row(a) * HD, col);
      part[a] = 0;
#pragma unroll
      for (int x = 0; x < C; ++x) part[a] = mad(X[a][x], s4[x], part[a]);
    }
    reduce_scatter<R, NC, 0>(part, lane, T::MASK);
    acc_p = part[0];
  };
  // pass 3: the state at a restart point, in fp32
  auto keep_state = [&](int c) {
    float* dst = spt + static_cast<long long>(c * kT / restart) * HD * HD;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        *reinterpret_cast<float4*>(dst + row(a) * HD + col(4 * q)) = make_float4(
            static_cast<float>(X[a][4 * q]), static_cast<float>(X[a][4 * q + 1]),
            static_cast<float>(X[a][4 * q + 2]), static_cast<float>(X[a][4 * q + 3]));
  };
  // the float64 sweeps restart only at the segment's end: their one anchor
  // before the loop, their one kept state (the last segment's) after it
  if (MODE == kGrad && F64 && n_chunks > 0) anchor(n_chunks - 1);

  // pass 1 on the first segment wants only the precision: log w read
  // straight from memory, the loads independent of each other
  const bool flag_only = MODE == kLocal && seg == 0;
  if (flag_only) {
    constexpr int P = HD / 4;                       // a token's 16-byte pieces
    const int pieces = (t_end - t_begin) * P;
#pragma unroll 8
    for (int e0 = 0; e0 < pieces; e0 += HD) {      // the same trips in every lane
      const int e = e0 + tid;
      int n = 0;
      if (e < pieces) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(
            lw + static_cast<long long>(t_begin + e / P) * p.w_ss + (e % P) * 4));
        n = (x.x < p.strong_logw) + (x.y < p.strong_logw) + (x.z < p.strong_logw) +
            (x.w < p.strong_logw);
      }
#pragma unroll
      for (int o = HD / 8; o > 0; o >>= 1) n += __shfl_xor_sync(T::MASK, n, o);
      most_strong = max(most_strong, n);
    }
  }

  if (!flag_only && n_chunks > 0) stage(0, 0);
  for (int c = 0; c < (flag_only ? 0 : n_chunks); ++c) {
    const int st = c & 1;
    const int t0 = t_begin + (REV ? n_chunks - 1 - c : c) * kT;
    cp_async_wait_all();
    to_w(st);
    __syncthreads();      // chunk c in place; every read of the other stage is done
    if (c + 1 < n_chunks) stage(c + 1, st ^ 1);

    if constexpr (MODE == kGrad && !F64) {
      const int ci = n_chunks - 1 - c;
      if (block_end(ci)) {
        anchor(ci);
        acc_a = acc_b = 0.0;
      }
    }

#pragma unroll 1
    for (int i = 0; i < kT; ++i) {
      const int tt = REV ? kT - 1 - i : i, pos = t0 + tt;
      if constexpr (MODE == kLocal) {
        if (seg > 0) {
          float ww[R], pr[R], y[C];
          load4<R>(ww, s_w[st][tt], row);
          load4<R>(pr, s_r[st][tt], row);
          load4<C>(y, s_do[st][tt], col);
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int x = 0; x < C; ++x) X[a][x] = fmaf(ww[a], X[a][x], pr[a] * y[x]);
          decay *= s_w[st][tt][own];
        }
      } else {
        Acc y[C], q[C];                     // dout and v of the tile's columns
        load4<C>(y, s_do[st][tt], col);
        load4<C>(q, s_v[st][tt], col);
        Acc vd = 0;
#pragma unroll
        for (int x = 0; x < C; ++x) vd = mad(q[x], y[x], vd);
        vd = allreduce<NC, 0>(vd, T::MASK);                  // v_t . dout_t
        if constexpr (MODE == kState) {
          // drs = S_{t-1} dout_t, then S_t = w S_{t-1} + k v^T
          Acc part[R];
#pragma unroll
          for (int a = 0; a < R; ++a) {
            part[a] = 0;
#pragma unroll
            for (int x = 0; x < C; ++x) part[a] = mad(X[a][x], y[x], part[a]);
          }
          reduce_scatter<R, NC, 0>(part, lane, T::MASK);
          Acc ww[R], kk[R];
          load4<R>(ww, s_w[st][tt], row);
          load4<R>(kk, s_k[st][tt], row);
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int x = 0; x < C; ++x) X[a][x] = mad(kk[a], q[x], ww[a] * X[a][x]);
          if (pos < t_end) {
            const Acc drs = part[0];
            p.dr[b * p.dr_sb + h * p.dr_sh + pos * p.dr_ss + own] =
                static_cast<float>(mad(u_own * s_k[st][tt][own], vd, drs));
            abuf[static_cast<long long>(pos) * ASTRIDE + own] = s_r[st][tt][own] * drs;   // a_t
          }
        } else {
          // dks = G_t v_t, dv = G_t^T k_t, then G_{t-1} = w G_t + r dout^T
          Acc ks[R], vs[C];
          {
            Acc kk[R];
            load4<R>(kk, s_k[st][tt], row);
#pragma unroll
            for (int a = 0; a < R; ++a) {
              ks[a] = 0;
#pragma unroll
              for (int x = 0; x < C; ++x) ks[a] = mad(X[a][x], q[x], ks[a]);
            }
#pragma unroll
            for (int x = 0; x < C; ++x) {
              vs[x] = 0;
#pragma unroll
              for (int a = 0; a < R; ++a) vs[x] = mad(X[a][x], kk[a], vs[x]);
            }
          }
          reduce_scatter<R, NC, 0>(ks, lane, T::MASK);
          reduce_scatter<C, T::RGW, T::LOG_NC>(vs, lane, T::MASK);
#pragma unroll
          for (int m = 0; m < T::CL; ++m)
            dvp[warp][tt][col(rg_lo * T::CL + m)] = static_cast<float>(vs[m]);
          {
            Acc ww[R], pr[R];
            load4<R>(ww, s_w[st][tt], row);
            load4<R>(pr, s_r[st][tt], row);
#pragma unroll
            for (int a = 0; a < R; ++a)
#pragma unroll
              for (int x = 0; x < C; ++x) X[a][x] = mad(pr[a], y[x], ww[a] * X[a][x]);
          }
          if (pos < t_end) {
            // products in Acc into the float64 sums
            const Acc kr = s_k[st][tt][own], rr = s_r[st][tt][own];
            if constexpr (F64) acc_b = mad(kr, ks[0], acc_b);
            else acc_b += static_cast<double>(kr * ks[0]);
            p.dk[b * p.dk_sb + h * p.dk_sh + pos * p.dk_ss + own] =
                static_cast<float>(mad(u_own * rr, vd, ks[0]));
            p.dlw[b * p.dw_sb + h * p.dw_sh + pos * p.dw_ss + own] =
                static_cast<float>(acc_p + (acc_a - acc_b));
            acc_a += static_cast<double>(s_a[st][tt][own]);
            if constexpr (F64) acc_du = mad(rr * kr, vd, acc_du);
            else acc_du += static_cast<double>(rr * kr * vd);
          }
        }
      }
    }

    if (MODE == kGrad) {
      // dv of the chunk's tokens: the warps' column sums plus (sum_i r u k)
      // dout, 8 channels a thread
      __syncthreads();
      const int tt = tid / T::TPT, c0 = (tid % T::TPT) * 8, pos = t0 + tt;
      float ruk = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) ruk = fmaf(s_r[st][tt][c0 + x] * s_u[c0 + x], s_k[st][tt][c0 + x], ruk);
      ruk = allreduce<T::TPT, 0>(ruk, T::MASK);
      if (pos < t_end) {
        float o[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < T::NW; ++w) sum += dvp[w][tt][c0 + x];
          o[x] = fmaf(ruk, s_do[st][tt][c0 + x], sum);
        }
        float* dst = p.dv + b * p.dv_sb + h * p.dv_sh + pos * p.dv_ss + c0;
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    // at a segment's end but the last, pass 4 takes the forward's state
    if (MODE == kState && !F64 && block_end(c) && !(seg < slots && c == n_chunks - 1))
      keep_state(c);
  }
  if (MODE == kState && F64 && seg == slots && n_chunks > 0) keep_state(n_chunks - 1);

  if constexpr (MODE == kLocal) {
    // the segment is strong where a token has more than half its channels
    // below strong_logw: its sweeps run in float64
    __shared__ int warp_most[T::NW];
#pragma unroll
    for (int o = (T::NT < 32 ? T::NT : 32) / 2; o > 0; o >>= 1)
      most_strong = max(most_strong, __shfl_xor_sync(T::MASK, most_strong, o));
    if (lane == 0) warp_most[warp] = most_strong;
    __syncthreads();
    if (tid == 0) {
      int m = warp_most[0];
      for (int w = 1; w < T::NW; ++w) m = max(m, warp_most[w]);
      p.strong[bh * p.n_seg + seg] = 2 * m > HD;
    }
    if (seg > 0) {
      float* dst = p.gstate + (bh * slots + seg - 1) * HD * HD;
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          *reinterpret_cast<float4*>(dst + row(a) * HD + col(4 * q)) = make_float4(
              static_cast<float>(X[a][4 * q]), static_cast<float>(X[a][4 * q + 1]),
              static_cast<float>(X[a][4 * q + 2]), static_cast<float>(X[a][4 * q + 3]));
      p.gdecay[(bh * slots + seg - 1) * HD + own] = decay;
    }
  } else if constexpr (MODE == kGrad) {
    p.du_part[(bh * p.n_seg + seg) * HD + own] = acc_du;
  }
}

// Pass 2: one thread per (b, h, state entry i, j); slot s - 1 of gstate
// turns from segment s's local G into G at the end of segment s - 1.
template <int HD>
__global__ void wkv6_bwd_carry(const Params p) {
  const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long bh = e / (HD * HD);
  const int ij = static_cast<int>(e % (HD * HD)), i = ij / HD;
  const int slots = p.n_seg - 1;
  float cur = p.ds_last != nullptr ? p.ds_last[e] : 0.f;
  for (int s = slots; s >= 1; --s) {
    const long long slot = bh * slots + s - 1;
    float* g = p.gstate + slot * HD * HD + ij;
    cur = fmaf(p.gdecay[slot * HD + i], cur, *g);
    *g = cur;
  }
}

// Pass 5: one thread per (h, channel): du, summed over b and the segments.
template <int HD>
__global__ void wkv6_bwd_du(const Params p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.H * HD) return;
  const int h = e / HD, i = e % HD;
  double sum = 0.0;
  for (int b = 0; b < p.B; ++b)
    for (int s = 0; s < p.n_seg; ++s)
      sum += p.du_part[((static_cast<long long>(b) * p.H + h) * p.n_seg + s) * HD + i];
  p.du[e] = static_cast<float>(sum);
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  const dim3 grid(p.n_seg, p.H, p.B);
  wkv6_bwd_sweep<HD, kLocal, float><<<grid, HD, Smem<HD, float>::bytes(kLocal), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n_seg > 1) {
    const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
    wkv6_bwd_carry<HD><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  wkv6_bwd_sweep<HD, kState, float><<<grid, HD, Smem<HD, float>::bytes(kState), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_sweep<HD, kState, double><<<grid, HD, Smem<HD, double>::bytes(kState), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_sweep<HD, kGrad, float><<<grid, HD, Smem<HD, float>::bytes(kGrad), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_sweep<HD, kGrad, double><<<grid, HD, Smem<HD, double>::bytes(kGrad), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_du<HD><<<(p.H * HD + 255) / 256, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw, dout: [B,H,S,hd] fp32 with unit-stride head dim; u: [H,hd];
// ds_last: contiguous [B,H,hd,hd] or null (a zero cotangent); seg_state: the
// forward's contiguous [B,H,n_seg-1,hd,hd] states at the ends of segments
// 0 .. n_seg-2, n_seg = ceil(S / seg_len).  Writes dr, dk, dv, dlogw
// ([B,H,S,hd], strided) and du (contiguous [H,hd]).  Scratch, contiguous:
// gstate [B,H,n_seg-1,hd,hd], gdecay [B,H,n_seg-1,hd] and spt
// [B,H,n_seg,seg_len/restart,hd,hd] fp32, abuf [B,H,S,hd] and du_part
// [B,H,n_seg,hd] fp64, strong [B,H,n_seg] bytes.  strides: (b, h, s) of r,
// k, v, logw, dout, dr, dk, dv, dlogw, then u's head stride.  S >= 1;
// seg_len a positive multiple of 8 (the forward's segment), restart a
// positive multiple of 8 that divides it; a segment with a logw below
// strong_logw sweeps in float64.  Returns 0 or the CUDA error of the first
// launch that fails; -1 for a head dim without an instantiation or a bad
// length.
extern "C" int repro_wkv6_bwd(int head_dim, const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* dout,
                              const void* ds_last, const void* seg_state, void* dr, void* dk,
                              void* dv, void* dlogw, void* du, void* gstate, void* gdecay,
                              void* spt, void* abuf, void* du_part, void* strong, int B, int H,
                              int S, int seg_len, int restart, float strong_logw,
                              const long long* strides, void* stream) {
  if (seg_len <= 0 || seg_len % kT != 0 || S <= 0 || restart <= 0 || restart % kT != 0 ||
      seg_len % restart != 0)
    return -1;
  const int n_seg = (S + seg_len - 1) / seg_len;
  const long long* s = strides;
  Params p{static_cast<const float*>(r), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(dout),
           static_cast<const float*>(ds_last), static_cast<const float*>(seg_state),
           static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
           static_cast<float*>(dlogw), static_cast<float*>(du), static_cast<float*>(gstate),
           static_cast<float*>(gdecay), static_cast<float*>(spt), abuf,
           static_cast<double*>(du_part), static_cast<unsigned char*>(strong), strong_logw,
           B, H, S, seg_len, n_seg, restart, seg_len / restart,
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

// Dynamic shared memory of a sweep at a head dim (bytes), or -1: mode 0
// (pass 1), 1 (pass 3), 2 (pass 4); f64 whether it is the float64 one.
extern "C" long long repro_wkv6_bwd_smem_bytes(int head_dim, int mode, int f64) {
  if (mode < 0 || mode > 2) return -1;
  switch (head_dim) {
    case 16: return static_cast<long long>(f64 ? Smem<16, double>::bytes(mode) : Smem<16, float>::bytes(mode));
    case 32: return static_cast<long long>(f64 ? Smem<32, double>::bytes(mode) : Smem<32, float>::bytes(mode));
    case 64: return static_cast<long long>(f64 ? Smem<64, double>::bytes(mode) : Smem<64, float>::bytes(mode));
  }
  return -1;
}
