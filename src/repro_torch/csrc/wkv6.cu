// WKV-6 (RWKV-6 "Finch" time mix) forward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `wkv6_kernel`
// (src/repro/kernels/rwkv6/kernel.py:82, body `_wkv_kernel` :36).  Per head,
// with an fp32 state S [hd, hd] starting from zero:
//     out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//     S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// returning out [B,H,S,hd] and S_last [B,H,hd,hd], both fp32.
//
// The chunk form of the reference, chunks of T = 32 tokens:
//     clw   = inclusive cumsum of logw over the chunk, per channel
//     rt    = r * exp(clw - logw),  kt = k * exp(-clw)
//     out   = (tril_strict(rt kt^T) + diag(sum_i r u k)) v + rt S
//     S     = diag(exp(clw_T)) S + (k * exp(clw_T - clw))^T v
// The exponents are re-based in every chunk, so exp() stays bounded by one
// chunk's decay; that bound grows exponentially with T, which is why T stays
// at the reference's 32 (PERF.md).  Even so kt = k * exp(-clw) overflows
// fp32 once a chunk's decay sums below ~-88 (w < ~0.06 a token), and
// rt kt^T turns to 0 * inf = NaN.  So a chunk whose block holds a log decay
// below kStrongLogw (-2; the guard rides on a barrier the loop has anyway)
// computes the a tile in the strong-decay form instead (strong_a_tile):
// each pair's decay split at the first token of the later 4-token block,
// pairs inside a block one by one, every factor <= 1 (the secondary
// chunking of the GLA / RWKV-6 kernels of flash-linear-attention), the
// exponents from sums inside the blocks; and kd's decays summed from the
// chunk's end (strong_scan).  Every other factor (rt, exp(clw_T)) is <= 1
// in either form.  Exact for every finite logw <= 0, and within a few times
// the fp32 plain version's distance from a float64 run.  Both functions
// are __noinline__ so that their registers stay out of the common path.
//
// What bounds it on this card: at the rwkv6-3b prefill shape (B=4, H=40,
// S=2048, hd=64) the call reads r, k, v, logw and writes out, 5 x 84 MB, and
// does ~24.6 kFLOP per token-head in the chunk form (8.05 GFLOP): 0.125 ms of
// bytes against 0.120 ms of fp32 CUDA-core operations, so both matter.  The
// parity bound (2e-4) rules out TF32 tensor cores, so all arithmetic is fp32
// FMAs.  A recurrence over the whole sequence in one block per head leaves
// the card nearly empty (B*H blocks), so the sequence is split into segments
// of L tokens (a multiple of the chunk) and the state is carried between
// them, which the recurrence allows because it is linear in S:
//   pass 1  one block per (b, h, segment but the last): the chunk loop for
//           the state only, from zero: the segment's end state and its total
//           decay exp(sum logw) per channel, into scratch;
//   pass 2  one thread per (b, h, state entry): the carry over segments,
//           S_in[s+1] = diag(decay[s]) S_in[s] + end[s], in place;
//   pass 3  one block per (b, h, segment): the chunk loop from S_in, writing
//           out; the last segment's block writes S_last.
// Passes 1 and 3 give B*H*S/L blocks (1,280 at the prefill shape with L =
// 256), and segments of several chunks keep the scratch traffic at one state
// per segment (21 MB at that shape, against ~1 GB for a state per chunk).
// Inside a block:
//   * one block covers all hd value columns (4*hd threads), so the per-
//     channel decay scan and the rt kt^T tile are computed once per chunk;
//   * the next chunk's r, k, v, logw are loaded into registers while this
//     chunk computes, and stored channel-major into shared memory after it:
//     a warp scans one channel's 32 log decays with shuffles (lane = token)
//     and the products read rows of consecutive tokens or channels,
//     conflict-free (cp.async would copy the rows as they lie, token-major);
//   * the products are register-blocked outer products (4 x 4 or 4 x 8 a
//     thread, both operands one float4 a step): shared-memory bandwidth, not
//     the FMAs, bounds them, and a 128-bit load costs four passes of the
//     shared-memory pipe whatever it broadcasts;
//   * in pass 3 half the threads compute out while the other half update
//     the state, which they hold in registers with a shared-memory mirror
//     for the next chunk's rt S;
//   * a ragged last chunk is loaded as k = v = logw = r = 0, which leaves
//     the state untouched, and rows past S are never written;
//   * the model's [B,S,H,hd] tensors come in as strided [B,H,S,hd] views.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // tokens per chunk: one per lane of a warp
constexpr int kPad = 4;         // row padding (floats): keeps float4 alignment
// A chunk whose log decays all lie at or above this keeps every cumulative
// sum above 32 * -2 = -64, so exp(-clw) <= 6e27 and exp(clw) stays normal:
// the factored a tile is exact to rounding.  Below it, the strong-decay form.
constexpr float kStrongLogw = -2.f;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  float* out;
  float* s_last;
  float* seg_state;   // [B,H,n_seg-1,hd,hd]: end states, then (pass 2) S_in of the next segment
  float* seg_decay;   // [B,H,n_seg-1,hd]: exp(sum of logw) over each segment
  int B, H, S, seg_len, n_seg;
  long long r_sb, r_sh, r_ss;   // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long o_sb, o_sh, o_ss;
  long long u_sh;
};

// N consecutive floats (N = 1, 2, 4 or 8; 4-float rows 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + m);
      dst[m] = x.x; dst[m + 1] = x.y; dst[m + 2] = x.z; dst[m + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    static_assert(N == 1, "row fragments are 1, 2 or a multiple of 4 floats");
    dst[0] = *src;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4)
      *reinterpret_cast<float4*>(dst + m) = make_float4(src[m], src[m + 1], src[m + 2], src[m + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    static_assert(N == 1, "row fragments are 1, 2 or a multiple of 4 floats");
    *dst = src[0];
  }
}

template <int HD>
struct Smem {
  static constexpr int LD = kT + kPad;        // channel-major / token-major rows of 32
  static constexpr int LDV = HD + kPad;       // token-major / state rows of hd
  static constexpr int NW = 4 * HD / 32;      // warps
  static constexpr int RT = 0;                               // [HD][LD] rt (pass 3)
  static constexpr int KT = RT + HD * LD;                    // [HD][LD] k (pass 1), kt (pass 3)
  static constexpr int LW = KT + HD * LD;                    // [HD][LD] logw
  static constexpr int VS = LW + HD * LD;                    // [kT][LDV] v
  static constexpr int KD = VS + kT * LDV;                   // [kT][LDV] kd, token-major
  static constexpr int AT = KD + kT * LDV;                   // [kT][LD] the a tile, transposed
  static constexpr int SM = AT + kT * LD;                    // [HD][LDV] state mirror
  static constexpr int DPART = SM + HD * LDV;                // [NW][kT] u-bonus partials
  static constexpr int ETOT = DPART + NW * kT;               // [HD] exp(clw_T)
  static constexpr int RR = ETOT + HD;                       // [HD][LD] r (pass 3)
  static constexpr int KR = RR + HD * LD;                    // [HD][LD] k (pass 3)
  static constexpr int EX = KR + HD * LD;                    // [HD][LD] strong decays: exclusive sums
  static constexpr size_t BYTES_STATE = RR * sizeof(float);  // pass 1
  static constexpr size_t BYTES = (EX + HD * LD) * sizeof(float);
};

constexpr int kLD = kT + kPad;     // rows of 32 tokens (Smem::LD)

// Column s = bs .. bs+3, rows t = bt .. bt+3 of the a tile from a 4 x 4
// block of r . k sums: the sum where s < t, the u-bonus (summed over the NW
// warps' partials) where s == t, 0 above the diagonal.
template <int NW>
__device__ __forceinline__ void store_a_block(float (*at)[kLD], float (*dpart)[kT],
                                              const float (&acc)[4][4], int bt, int bs) {
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int s = bs + y;
    float col[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = bt + x;
      float d = 0.f;
      if (s == t) {
#pragma unroll
        for (int w = 0; w < NW; ++w) d += dpart[w][t];
      }
      col[x] = s < t ? acc[x][y] : d;
    }
    store_row(&at[s][bt], col);
  }
}

// The decays of a chunk with strong decays, by the whole block, from logw
// (lwc) and k as loaded (kin), each warp over its channels, lane = token:
//   * kd again, its decay exp(sum of logw over t+1 .. 31) summed from the
//     chunk's end (a scan down the lanes) rather than as clw_T - clw, a
//     difference of two large sums that loses the small terms after them;
//   * pass 3: the cumulative log decay inside each 4-token block (lane & 3
//     is the place in the block), inclusive into lwc and exclusive into
//     exc, the second shifted from the first so that equal sums are
//     bit-equal, for strong_a_tile.
template <int HD, bool OUT>
__device__ __noinline__ void strong_scan(float (*lwc)[kLD], float (*exc)[kLD], float (*kin)[kLD],
                                         float (*kd)[HD + kPad], int tid) {
  constexpr int NW = 4 * HD / 32, CPW = HD / NW;
  const int lane = tid & 31, warp = tid >> 5, pos = lane & 3;
  float w[CPW], suf[CPW];
#pragma unroll
  for (int m = 0; m < CPW; ++m) suf[m] = w[m] = lwc[warp + NW * m][lane];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const float y = __shfl_down_sync(0xffffffffu, suf[m], off);
      if (lane + off < 32) suf[m] += y;
    }
  }
#pragma unroll
  for (int m = 0; m < CPW; ++m) {
    const int i = warp + NW * m;
    const float after = __shfl_down_sync(0xffffffffu, suf[m], 1);
    kd[lane][i] = kin[i][lane] * expf(lane == 31 ? 0.f : after);
    if (OUT) {
      float inc = w[m];
      float up = __shfl_up_sync(0xffffffffu, inc, 1);
      if (pos >= 1) inc += up;
      up = __shfl_up_sync(0xffffffffu, inc, 2);
      if (pos >= 2) inc += up;
      const float prev = __shfl_up_sync(0xffffffffu, inc, 1);
      lwc[i][lane] = inc;
      exc[i][lane] = pos == 0 ? 0.f : prev;
    }
  }
}

// The a tile of a chunk with strong decays, by the whole block: P = NT / 64
// threads a 4 x 4 block, each over HD / P channels, summed with shuffles.
// A pair s < t carries exp(D), D = sum of logw over s+1 .. t-1.  With c and
// cx the inclusive and exclusive cumulative log decay inside each 4-token
// block (lwc, exc) and T_b = c at the block's last token, D is taken as
//   cx_t + ((T_bs - c_s) + sum of T_b over the blocks between)
//       with exp(cx_t) on r_t and the rest on k_s,   for s < bt <= t,
//   cx_t - c_s, pair by pair,                         for s, t in one block.
// Every exponent is <= 0 (underflow to 0 is right, nothing overflows) and a
// sum of terms of one sign or of a block's own sums, so it keeps fp32's
// relative precision: differences of sums over the whole chunk would lose
// it wherever large decays come before small ones.  r and k come as they
// are (rraw, kraw).
template <int HD>
__device__ __noinline__ void strong_a_tile(float (*rraw)[kLD], float (*exc)[kLD], float (*kraw)[kLD],
                                           float (*lwc)[kLD], float (*dpart)[kT], float (*at)[kLD],
                                           int tid) {
  constexpr int NT = 4 * HD, P = NT / 64;
  const int blk = tid / P, q = tid % P;
  const int bt = 4 * (blk % 8), bs = 4 * (blk / 8);
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  if (bs < bt) {
#pragma unroll 1
    for (int i = q; i < HD; i += P) {
      float r4[4], e4[4], k4[4], c4[4];
      load_row(r4, &rraw[i][bt]);
      load_row(e4, &exc[i][bt]);
      load_row(k4, &kraw[i][bs]);
      load_row(c4, &lwc[i][bs]);
      float between = 0.f;                    // the totals of the blocks between
#pragma unroll
      for (int b = 1; b < kT / 4 - 1; ++b)
        if (bs + 4 * b < bt) between += lwc[i][bs + 4 * b + 3];
#pragma unroll
      for (int x = 0; x < 4; ++x) r4[x] *= expf(e4[x]);
#pragma unroll
      for (int y = 0; y < 4; ++y) k4[y] *= expf((c4[3] - c4[y]) + between);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(r4[x], k4[y], acc[x][y]);
    }
  } else if (bs == bt) {
#pragma unroll 1
    for (int i = q; i < HD; i += P) {
      float r4[4], e4[4], k4[4], c4[4];
      load_row(r4, &rraw[i][bt]);
      load_row(e4, &exc[i][bt]);
      load_row(k4, &kraw[i][bs]);
      load_row(c4, &lwc[i][bs]);
#pragma unroll
      for (int x = 1; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < x; ++y)
          acc[x][y] = fmaf(r4[x] * k4[y], expf(e4[x] - c4[y]), acc[x][y]);
    }
  }
#pragma unroll
  for (int off = 1; off < P; off <<= 1)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] += __shfl_xor_sync(0xffffffffu, acc[x][y], off);
  if (q == 0) store_a_block<NT / 32>(at, dpart, acc, bt, bs);
}

// Passes 1 (OUT = false: state only, from zero, for segments but the last)
// and 3 (OUT = true: out from S_in; the last segment writes S_last).
//
// Every product is an outer-product loop over a 4 x N register block whose
// two operand rows are contiguous in shared memory (one float4 each per
// step): a = tril(rt kt^T) over channels, out = a v over tokens plus rt S
// over channels, S' = e S + kd^T v over tokens.  In pass 3 the first half of
// the block computes out while the second half updates the state.
template <int HD, bool OUT>
__global__ void __launch_bounds__(4 * HD, 2) wkv6_segment(const Params p) {
  using L = Smem<HD>;
  constexpr int NT = 4 * HD;                  // threads
  constexpr int NW = L::NW;
  constexpr int LD = L::LD, LDV = L::LDV;
  constexpr int CPW = HD / NW;                // channels each warp scans (8)
  // state update: CT threads, each rows 4*ib .. +4 and columns CJ*jb .. +CJ
  constexpr int CT = OUT ? NT / 2 : NT;
  constexpr int CJ = HD * HD / (CT * 4);
  constexpr int IB = HD / 4;
  static_assert(CPW == 8 && 8 * NT == kT * HD && CJ >= 1 && CJ <= 8, "tiling");

  extern __shared__ __align__(16) float smem[];
  float(*rt)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::RT);
  float(*kt)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::KT);
  float(*lwc)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::LW);
  float(*vs)[LDV] = reinterpret_cast<float(*)[LDV]>(smem + L::VS);
  float(*kd)[LDV] = reinterpret_cast<float(*)[LDV]>(smem + L::KD);
  float(*at)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::AT);
  float(*sm)[LDV] = reinterpret_cast<float(*)[LDV]>(smem + L::SM);
  float(*rraw)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::RR);
  float(*kraw)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::KR);
  float(*kin)[LD] = OUT ? kraw : kt;          // k as loaded
  float(*exc)[LD] = reinterpret_cast<float(*)[LD]>(smem + L::EX);
  float(*dpart)[kT] = reinterpret_cast<float(*)[kT]>(smem + L::DPART);
  float* etot = smem + L::ETOT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int t_begin = seg * p.seg_len;
  const int t_end = min(p.S, t_begin + p.seg_len);
  const int n_chunks = (t_end - t_begin + kT - 1) / kT;
  const bool last_seg = seg == p.n_seg - 1;
  const float* r = p.r + b * p.r_sb + h * p.r_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh;
  float* out = p.out + b * p.o_sb + h * p.o_sh;

  float u_reg[CPW];                           // u of the channels this warp scans
  float logd[CPW];                            // pass 1: sum of logw over the segment
#pragma unroll
  for (int m = 0; m < CPW; ++m) {
    u_reg[m] = OUT ? p.u[h * p.u_sh + warp + NW * m] : 0.f;
    logd[m] = 0.f;
  }

  // State owners: thread c of the update group holds rows si .. si+3,
  // columns sj .. sj+CJ.  Pass 3 starts from the carried state of the
  // segments before (pass 2), pass 1 from zero.
  const int c_upd = OUT ? tid - NT / 2 : tid;
  const bool updater = c_upd >= 0;
  const int si = 4 * (max(c_upd, 0) % IB), sj = CJ * (max(c_upd, 0) / IB);
  float s_reg[4][CJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int m = 0; m < CJ; ++m) s_reg[ii][m] = 0.f;
  if (OUT && updater) {
    if (seg > 0) {
      const float* src = p.seg_state + ((bh * (p.n_seg - 1) + seg - 1) * HD + si) * HD + sj;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) load_row(s_reg[ii], src + ii * HD);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) store_row(&sm[si + ii][sj], s_reg[ii]);
  }

  // Loads: two float4 of each tensor a thread.  r, k, logw go channel-major:
  // a warp reads 16 tokens x 2 float4, so its transposed stores land on 32
  // distinct banks; v stays token-major.
  float4 pr[2], pk[2], pw[2], pv[2];
  auto fetch = [&](int c) {
    const int t0 = t_begin + c * kT;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = tid + m * NT;
      const int q = e >> 4;
      const int tt = (e & 15) + 16 * (q / (HD / 4)), i = (q % (HD / 4)) * 4, pos = t0 + tt;
      const int vt = e / (HD / 4), vj = (e % (HD / 4)) * 4, vpos = t0 + vt;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      pr[m] = OUT && pos < t_end ? *reinterpret_cast<const float4*>(r + pos * p.r_ss + i) : z;
      pk[m] = pos < t_end ? *reinterpret_cast<const float4*>(k + pos * p.k_ss + i) : z;
      pw[m] = pos < t_end ? *reinterpret_cast<const float4*>(lw + pos * p.w_ss + i) : z;
      pv[m] = vpos < t_end ? *reinterpret_cast<const float4*>(v + vpos * p.v_ss + vj) : z;
    }
  };
  auto stash = [&]() {                        // returns the least log w it stored
    float lw_min = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = tid + m * NT;
      const int q = e >> 4;
      const int tt = (e & 15) + 16 * (q / (HD / 4)), i = (q % (HD / 4)) * 4;
      const int vt = e / (HD / 4), vj = (e % (HD / 4)) * 4;
      if (OUT) {
        rraw[i][tt] = pr[m].x; rraw[i + 1][tt] = pr[m].y; rraw[i + 2][tt] = pr[m].z; rraw[i + 3][tt] = pr[m].w;
      }
      kin[i][tt] = pk[m].x; kin[i + 1][tt] = pk[m].y; kin[i + 2][tt] = pk[m].z; kin[i + 3][tt] = pk[m].w;
      lwc[i][tt] = pw[m].x; lwc[i + 1][tt] = pw[m].y; lwc[i + 2][tt] = pw[m].z; lwc[i + 3][tt] = pw[m].w;
      *reinterpret_cast<float4*>(&vs[vt][vj]) = pv[m];
      lw_min = fminf(lw_min, fminf(fminf(pw[m].x, pw[m].y), fminf(pw[m].z, pw[m].w)));
    }
    return lw_min;
  };

  if (n_chunks > 0) fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = t_begin + c * kT;
    const float lw_min = stash();
    // strong: some log decay of this chunk, in any channel of the block, lies
    // below kStrongLogw (block-uniform, from the barrier itself)
    const bool strong = __syncthreads_or(lw_min < kStrongLogw);
    if (c + 1 < n_chunks) fetch(c + 1);       // in flight while this chunk computes

    // ---- per-channel cumulative decay (warp scan, lane = token) and factors;
    // the warp's 8 channels go through each step together, 8 independent
    // shuffle chains in flight
    float x[CPW], w[CPW], ki[CPW], ri[CPW];
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const int i = warp + NW * m;
      w[m] = x[m] = lwc[i][lane];
      ki[m] = kin[i][lane];
      ri[m] = OUT ? rraw[i][lane] : 0.f;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int m = 0; m < CPW; ++m) {
        const float y = __shfl_up_sync(0xffffffffu, x[m], off);
        if (lane >= off) x[m] += y;
      }
    }
    float diag = 0.f;
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const int i = warp + NW * m;
      const float total = __shfl_sync(0xffffffffu, x[m], 31);
      if (OUT) {
        diag += ri[m] * u_reg[m] * ki[m];
        rt[i][lane] = ri[m] * expf(x[m] - w[m]);
        kt[i][lane] = ki[m] * expf(-x[m]);
      } else {
        logd[m] += total;
      }
      kd[lane][i] = ki[m] * expf(total - x[m]);
      if (lane == 0) etot[i] = expf(total);
    }
    if (strong) strong_scan<HD, OUT>(lwc, exc, kin, kd, tid);
    if (OUT) dpart[warp][lane] = diag;
    __syncthreads();

    if (OUT) {
      // ---- at[s][t] = rt_t . kt_s for s < t, the u-bonus for s == t, else
      // 0: 4 x 4 blocks of the lower triangle, one per thread of the first
      // 64; strong decays take their own form (strong_a_tile)
      if (strong) {
        strong_a_tile<HD>(rraw, exc, kraw, lwc, dpart, at, tid);
      } else if (tid < 64) {
        const int bt = 4 * (tid % 8), bs = 4 * (tid / 8);
        float acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
        if (bs <= bt) {
#pragma unroll 4
          for (int i = 0; i < HD; ++i) {
            float rr[4], kk[4];
            load_row(rr, &rt[i][bt]);
            load_row(kk, &kt[i][bs]);
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(rr[x], kk[y], acc[x][y]);
          }
        }
        store_a_block<NW>(at, dpart, acc, bt, bs);
      }
      __syncthreads();
    }

    if (OUT && !updater) {
      // ---- out = a v + rt S (the state before this chunk): 4 tokens x 4
      // columns a thread
      const int c_out = tid;
      const int ot = 4 * (c_out % 8), oj = 4 * (c_out / 8);
      float o[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) o[x][y] = 0.f;
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        float aa[4], vv[4];
        load_row(aa, &at[s][ot]);
        load_row(vv, &vs[s][oj]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) o[x][y] = fmaf(aa[x], vv[y], o[x][y]);
      }
#pragma unroll 4
      for (int i = 0; i < HD; ++i) {
        float rr[4], ss[4];
        load_row(rr, &rt[i][ot]);
        load_row(ss, &sm[i][oj]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) o[x][y] = fmaf(rr[x], ss[y], o[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (t0 + ot + x < t_end) store_row(out + (t0 + ot + x) * p.o_ss + oj, o[x]);
    } else if (!OUT || c + 1 < n_chunks || last_seg) {
      // ---- the state after this chunk, into registers (pass 3 needs it only
      // for the next chunk, or as S_last in the last segment)
      float upd[4][CJ];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < CJ; ++y) upd[x][y] = 0.f;
#pragma unroll 4
      for (int tt = 0; tt < kT; ++tt) {
        float kk[4], vv[CJ];
        load_row(kk, &kd[tt][si]);
        load_row(vv, &vs[tt][sj]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < CJ; ++y) upd[x][y] = fmaf(kk[x], vv[y], upd[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float e = etot[si + x];
#pragma unroll
        for (int y = 0; y < CJ; ++y) s_reg[x][y] = fmaf(e, s_reg[x][y], upd[x][y]);
      }
    }
    __syncthreads();          // every read of sm and of the chunk's tiles is done
    if (OUT && updater) {
#pragma unroll
      for (int x = 0; x < 4; ++x) store_row(&sm[si + x][sj], s_reg[x]);
    }
  }

  if (!updater) return;
  float* dst;
  if (OUT) {
    if (!last_seg) return;
    dst = p.s_last + (bh * HD + si) * HD + sj;
  } else {
    dst = p.seg_state + ((bh * (p.n_seg - 1) + seg) * HD + si) * HD + sj;
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < CPW; ++m)
        p.seg_decay[(bh * (p.n_seg - 1) + seg) * HD + warp + NW * m] = expf(logd[m]);
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) store_row(dst + x * HD, s_reg[x]);
}

// Pass 2: one thread per (b, h, state entry i, j); in place, slot s of
// seg_state turns from segment s's end state (from zero) into the state
// after segment s, which is where segment s + 1 starts.
template <int HD>
__global__ void wkv6_carry(const Params p) {
  const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long bh = e / (HD * HD);
  const int ij = static_cast<int>(e % (HD * HD)), i = ij / HD;
  const int slots = p.n_seg - 1;
  float cur = 0.f;
  for (int s = 0; s < slots; ++s) {
    const long long slot = bh * slots + s;
    float* st = p.seg_state + slot * HD * HD + ij;
    cur = fmaf(p.seg_decay[slot * HD + i], cur, *st);
    *st = cur;
  }
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::BYTES, smem_state = Smem<HD>::BYTES_STATE;
  cudaError_t err;
  if (p.n_seg > 1) {
    err = cudaFuncSetAttribute(wkv6_segment<HD, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_state));
    if (err != cudaSuccess) return err;
    wkv6_segment<HD, false><<<dim3(p.n_seg - 1, p.H, p.B), 4 * HD, smem_state, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long n = static_cast<long long>(p.B) * p.H * HD * HD;
    wkv6_carry<HD><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(wkv6_segment<HD, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_segment<HD, true><<<dim3(p.n_seg, p.H, p.B), 4 * HD, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw: [B,H,S,hd] fp32 with unit-stride head dim; u: [H,hd] fp32;
// out: [B,H,S,hd] fp32 (strided); s_last: contiguous [B,H,hd,hd] fp32.
// seg_len: tokens per segment, a positive multiple of 32; seg_state /
// seg_decay: contiguous fp32 scratch of [B,H,n_seg-1,hd,hd] / [B,H,n_seg-1,hd]
// with n_seg = max(1, ceil(S / seg_len)) (unused when n_seg is 1).
// strides: (b, h, s) of r, k, v, logw, out, then u's head stride.  Returns 0
// or the CUDA error of the first launch that fails; -1 for a head dim without
// an instantiation or a segment length that is no multiple of 32.
extern "C" int repro_wkv6_fwd(int head_dim, const void* r, const void* k, const void* v,
                              const void* logw, const void* u, void* out, void* s_last,
                              void* seg_state, void* seg_decay, int B, int H, int S,
                              int seg_len, const long long* strides, void* stream) {
  if (seg_len <= 0 || seg_len % kT != 0) return -1;
  const int n_seg = S > 0 ? (S + seg_len - 1) / seg_len : 1;
  Params p{static_cast<const float*>(r), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<float*>(out),
           static_cast<float*>(s_last), static_cast<float*>(seg_state),
           static_cast<float*>(seg_decay), B, H, S, seg_len, n_seg,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           strides[12], strides[13], strides[14], strides[15]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
  }
  return -1;
}

// Dynamic shared memory of a segment kernel (out_pass: pass 3, else pass 1)
// at a head dim (bytes), or -1.
extern "C" long long repro_wkv6_smem_bytes(int head_dim, int out_pass) {
  switch (head_dim) {
    case 16: return static_cast<long long>(out_pass ? Smem<16>::BYTES : Smem<16>::BYTES_STATE);
    case 32: return static_cast<long long>(out_pass ? Smem<32>::BYTES : Smem<32>::BYTES_STATE);
    case 64: return static_cast<long long>(out_pass ? Smem<64>::BYTES : Smem<64>::BYTES_STATE);
  }
  return -1;
}
