// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:96, body `_fa_kernel` :29):
// softmax(softcap(q k^T / sqrt(hd)) masked) v with causal mask kpos <= qpos,
// sliding window kpos > qpos - window, GQA head h -> h / (H / KV), and an
// online softmax whose running max, sum and accumulator are fp32.
// Query row i sits at position i + q_offset and key row j at position j:
// a rank of a sequence-sharded (WSP) prefill passes its first position as
// q_offset, with the keys of every position up to its last.  The masks,
// the key range and the skipping of fully masked tiles all take the query's
// position; the rows are read and written at their own index.
//
// What bounds it on this card: at the prefill shapes of the serving path
// (granite-3-8b B=4 S=2048 hd=128; gemma2-9b S=8192 hd=256) the work is
// ~4*B*H*hd*(visible q.k pairs) FLOPs against 2*(|q|+|k|+|v|+|o|) bytes,
// i.e. hundreds of FLOPs per byte: bound by operations (989 TFLOP/s bf16
// tensor cores vs 3.35 TB/s HBM).  Only wgmma reaches that rate, so the bf16
// kernel is built around it, in the FA3 shape:
//   * a persistent grid, one block per SM, of three warpgroups: two
//     consumer warpgroups own 64 query rows each of a 128-row work tile and
//     take 240 registers (setmaxnreg.inc; 232 at hd 256), one producer
//     warpgroup gives its registers away (setmaxnreg.dec) and one of its
//     threads issues every load;
//   * the work list is (q tile, batch, head), heads of one KV head next to
//     each other (their K/V tiles come from L2) and causal q tiles heaviest
//     first, dealt to the blocks in a snake order that evens out the work;
//   * loads are TMA copies through tensor maps encoded on the host per call
//     over the 4-D strided view (hd, S, heads, batch), so the model's
//     [B,S,H,hd] tensors come in as they lie and a ragged S reads TMA's zero
//     fill, never the next head's rows; 128-byte swizzle, one 64-column box
//     per 128 bytes of head dim, tiles 1024-byte aligned;
//   * K and V tiles go through a ring of stages (as many as the 227 KB of
//     shared memory hold: 6 at hd 64, 3 at hd 128, 2 at hd 256), each tile
//     on its own mbarrier, so q.k^T of a tile starts while its V is still
//     landing; an `empty` mbarrier per stage hands it back to the producer,
//     and one for Q lets the next work tile's Q load while P V finishes;
//   * S = Q K^T is wgmma m64nBKk16 with Q and K K-major in shared memory;
//     O += P V takes P from registers (the fp32 accumulator of S, packed to
//     bf16, is the A fragment) and V MN-major through the transpose bit, so
//     neither P nor a transposed V is ever written;
//   * each warpgroup overlaps its softmax of tile i with P V of tile i - 1
//     (issue S_i, rescale O, issue P V, wait for S_i only), and the two
//     warpgroups take turns at the tensor cores (named barriers 1 and 2), so
//     one's softmax runs under the other's products;
//   * the online softmax runs on the accumulator layout (rows g, g+8 of a
//     warp's 16; columns 2t, 2t+1 + 8j) in base 2 with the scale folded into
//     the exponent's FMA; the mask is evaluated only on tiles some row of the
//     warpgroup does not see in full, and the key range is computed, so fully
//     masked tiles are never loaded.
// Key tile: 128 at hd 64/128; 64 at hd 256, where O alone is 128 fp32
// registers a thread.  The registers are the constraint: S (BK/2), P (BK/4)
// and O (hd/2) of a consumer thread are live at once.  ptxas gives the
// consumer path the setmaxnreg count only when no exit (a trap) sits inside
// it; otherwise it allocates the launch's 168 and serializes the wgmmas.
// fp32 inputs take a CUDA-core kernel with the tiling of the first version,
// since the tensor cores would round fp32 to TF32.
// A training call passes `lse`: both kernels then also write each row's
// base-2 log-sum-exp for the backward (flash_attention_bwd.cu), and bf16 runs
// its STATS instantiation, which writes o's bf16 residual as well and adds
// the product of P's bf16 residual to P V.  Serving passes none and runs the
// instantiation the serving path always ran.

#include <math.h>              // INFINITY
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;   // same masked logit as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;         // fp32 kernel; one warpgroup

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
  int q_offset;                 // position of query row 0 (keys start at 0)
  float softcap, scale;
  // What the backward takes from a training forward (null when serving):
  // each row's base-2 log-sum-exp, log2 sum_k exp2(y log2 e) (+inf for a
  // row that sees no key), at lse[(b * H + h) * lse_ld + row], and in bf16
  // o's residual, o_fp32 - bf16(o_fp32), with o's strides.
  float* lse;
  void* o_res;
  long long lse_ld;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// First key and one past the last key any query position of [q_lo, q_last]
// can see.
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

// ------------------------------------------------- bf16: wgmma, TMA, mbarrier

template <int HD>
struct Bf16Tiles {
  static constexpr int BQ = 128;                  // two consumer warpgroups x 64 rows
  // Keys per tile: S (BK/2 fp32), its bf16 P (BK/4) and O (HD/2 fp32) of a
  // consumer thread live together in its 240 (hd 256: 232) registers.
  static constexpr int BK = HD == 256 ? 64 : 128;
  // K/V stages: as many as the 227 KB of shared memory hold.
  static constexpr int STAGES = HD == 128 ? 3 : (HD == 64 ? 6 : 2);
  // setmaxnreg: 2 x 128 x CONSUMER + 128 x PRODUCER <= 64K registers
  static constexpr int CONSUMER_REGS = HD == 256 ? 232 : 240;
  static constexpr int PRODUCER_REGS = HD == 256 ? 40 : 24;
  static constexpr int BOXES = HD / 64;           // 128-byte column boxes per row
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;   // one K or one V tile
  static constexpr uint32_t BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + 1024: the dynamic buffer is realigned to 1024 bytes; then the
  // mbarriers: full_q, full_k / full_v / empty per stage, empty_q
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * (2 + 3 * STAGES);
};

constexpr int kBf16Threads = 384;   // consumer warpgroups 0 and 1, producer 2

// STATS: the training instantiation, which also writes p.lse and p.o_res.
// Its P V adds the product of P's bf16 residual, so that o + o_res is
// sum_k P v in fp32 to ~16 bits and the backward's D = rowsum(dO (o +
// o_res)) agrees with the P it recomputes (one bf16 rounding of P shifts D by
// 2^-9 of the second key's share, more than dS where one key holds a row).
// The serving instantiation (STATS false) is the kernel as it was.
template <int HD, bool STATS>
__global__ void __launch_bounds__(kBf16Threads, 1)
    fa_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Bf16Tiles<HD>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES;
  constexpr int NT = BK / 8;      // 8-key column tiles of S per thread
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 8 rows x 128 bytes: tiles start 1024-aligned.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // Q: BOXES column boxes of [BQ rows][64]; each K / V stage: BOXES boxes of [BK][64]
  const uint32_t sQ = base;
  const uint32_t sKV = base + T::Q_BYTES;            // K stages, then V stages
  const uint32_t bars = base + T::BAR_OFFSET;
  const uint32_t full_q = bars, empty_q = bars + 8u * (1 + 3 * STAGES);
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  // Persistent: the work list is (q tile, batch, head) with the head
  // fastest, so heads of one KV head are neighbours, and causal q tiles in
  // descending order, so the longest key ranges go first.  Round n hands
  // work n*G .. n*G + G-1 to the G blocks, in reverse order every second
  // round (a snake), which evens out the descending work per block.  The K/V
  // ring runs on across a block's work tiles.
  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  const int n_work = q_tiles * p.B * p.H;
  struct Work {
    int h, b, q0, kvh, k_first, n_tiles;
  };
  auto work_index = [&](int n) {   // this block's work of round n
    const int G = gridDim.x;
    return n * G + ((n & 1) ? G - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x));
  };
  auto work = [&](int w) {
    Work x;
    x.h = w % p.H;
    x.b = (w / p.H) % p.B;
    const int z = w / (p.H * p.B);
    x.q0 = (p.causal ? q_tiles - 1 - z : z) * BQ;
    x.kvh = x.h / (p.H / p.KV);
    int k_begin, k_end;
    key_range(p, x.q0 + p.q_offset, min(x.q0 + BQ, p.Sq) - 1 + p.q_offset, k_begin, k_end);
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
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);   // the last tile's Q is done with
        mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll 1
        for (int c = 0; c < T::BOXES; ++c)
          tma_load_4d(sQ + c * BQ * 128, &tq, full_q, c * 64, x.q0, x.h, x.b);
#pragma unroll 1
        for (int i = 0; i < x.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
          const int k0 = x.k_first + i * BK;
          const uint32_t sK = sKV + s * T::KV_BYTES, sV = sKV + (STAGES + s) * T::KV_BYTES;
          mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll 1
          for (int c = 0; c < T::BOXES; ++c)
            tma_load_4d(sK + c * BK * 128, &tk, full_k(s), c * 64, k0, x.kvh, x.b);
          mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll 1
          for (int c = 0; c < T::BOXES; ++c)
            tma_load_4d(sV + c * BK * 128, &tv, full_v(s), c * 64, k0, x.kvh, x.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    int wq_lo, qr0, qr1;     // this warpgroup's first row and this thread's rows
    const int qo = p.q_offset;   // row r's query position is r + qo
    const float sl2 = p.scale * kLog2e;
    const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
    const float cap_out = p.softcap * kLog2e;
    const uint32_t sQw = sQ + wg * 64 * 128;         // this warpgroup's rows of each box

    float o[HD / 2];
    float m0, m1, l0, l1;    // running max (log2 units) and this thread's sums
    float sc[BK / 2];        // S of the newest tile, then its probabilities
    uint32_t pp[BK / 16][4]; // P of the tile before, bf16: the A fragments of P V
    uint32_t pr[STATS ? BK / 16 : 1][4];   // STATS: P - bf16(P), bf16

    // S = Q K^T of stage s, issued (not waited for).
    auto issue_qk = [&](int s) {
      const uint32_t sK = sKV + s * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the box
        const uint64_t da = sw128_desc(sQw + (kk / 4) * BQ * 128 + off, 16, 1024);
        const uint64_t db = sw128_desc(sK + (kk / 4) * BK * 128 + off, 16, 1024);
        Wgmma<BK>::ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of stage s: two 8-key column tiles of S form one 16-key A
    // fragment; V rows kk*16.. of every column box, MN-major.
    auto issue_pv = [&](int s) {
      const uint32_t sV = sKV + (STAGES + s) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::rs(o, pp[kk], sw128_desc(sV + kk * 16 * 128, BK * 128, 1024));
      if constexpr (STATS) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<HD>::rs(o, pr[kk], sw128_desc(sV + kk * 16 * 128, BK * 128, 1024));
      }
      wgmma_commit();
    };
    // Online softmax of tile k0 in sc (raw q.k^T): running max m0 / m1 in
    // log2 units, per-thread sums l0 / l1; sc becomes the probabilities.
    // Returns the factors that rescale O.
    auto softmax = [&](int k0, float& al0, float& al1) {
      if (p.softcap > 0.f) {   // softcap first (log2 units), else scale in the exponent
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = cap_out * tanhf(sc[e] * cap_in);
      }
      const float to_log2 = p.softcap > 0.f ? 1.f : sl2;
      // A tile every row of the warpgroup sees in full needs no mask.
      const bool full = k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= wq_lo + qo) &&
                        (p.window <= 0 || k0 > wq_lo + qo + 63 - p.window);
      if (!full) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int kpos = k0 + (e / 4) * 8 + 2 * t + (e & 1);
          if (!visible(p, ((e & 2) ? qr1 : qr0) + qo, kpos)) sc[e] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt + 0], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {   // the 4 lanes that share a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // Masked logits are -inf.  A row that has seen no visible key yet has
      // the running max -inf, and subtracts 0 instead, so its probabilities
      // and rescale factor are 0, never inf - inf.
      const float mn0 = fmaxf(m0, mx0 * to_log2), mn1 = fmaxf(m1, mx1 * to_log2);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
      al0 = ex2(m0 - b0);
      al1 = ex2(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[4 * nt + 0] = ex2(fmaf(sc[4 * nt + 0], to_log2, -b0));
        sc[4 * nt + 1] = ex2(fmaf(sc[4 * nt + 1], to_log2, -b0));
        sc[4 * nt + 2] = ex2(fmaf(sc[4 * nt + 2], to_log2, -b1));
        sc[4 * nt + 3] = ex2(fmaf(sc[4 * nt + 3], to_log2, -b1));
        ps0 += sc[4 * nt + 0] + sc[4 * nt + 1];
        ps1 += sc[4 * nt + 2] + sc[4 * nt + 3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
    };
    auto rescale_o = [&](float al0, float al1) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (STATS)
            pack_split(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], pp[kk][i], pr[kk][i]);
          else
            pp[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        }
      }
    };

    if (wg == 0) named_arrive(1);   // the first turn is warpgroup 0's
    int it = 0;   // K/V tiles consumed so far: the ring's position
#pragma unroll 1
    for (int n = 0, w = work_index(0); w < n_work; w = work_index(++n)) {
      const Work x = work(w);
      const int k_first = x.k_first, n_tiles = x.n_tiles;
      wq_lo = x.q0 + wg * 64;
      qr0 = wq_lo + warp * 16 + g;
      qr1 = qr0 + 8;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      mbar_wait(full_q, n & 1);
      if (n_tiles > 0) {
        // Tile 0: S, softmax, P.  Then step i overlaps work with the tensor
        // cores as FA3's intra-warpgroup pipelining does: issue S_i; rescale
        // O (for tile i - 1) while it runs; issue P_{i-1} V_{i-1}; wait for
        // S_i only, and run the softmax of tile i while P V runs.
        float al0, al1;
        mbar_wait(full_k(it % STAGES), (it / STAGES) & 1);
        named_sync(1 + wg);
        wgmma_fence();
        issue_qk(it % STAGES);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_operands(sc);
        softmax(k_first, al0, al1);
        pack_p();
#pragma unroll 1
        for (int i = 1; i < n_tiles; ++i) {
          const int r = it + i, s = r % STAGES, sp = (r - 1) % STAGES;
          mbar_wait(full_k(s), (r / STAGES) & 1);
          named_sync(1 + wg);  // this warpgroup's turn at the tensor cores
          wgmma_fence();       // sc was last written by plain code
          issue_qk(s);
          rescale_o(al0, al1);
          fence_operands(o);
          mbar_wait(full_v(sp), ((r - 1) / STAGES) & 1);
          wgmma_fence();       // the rescaled o and the packed P are wgmma's input
          issue_pv(sp);
          named_arrive(2 - wg);   // the other warpgroup's turn
          wgmma_wait<1>();     // S_i has landed; P_{i-1} V_{i-1} may still run
          fence_operands(sc);
          softmax(k_first + i * BK, al0, al1);
          wgmma_wait<0>();
          fence_operands(o);
          fence_operands(pp);
          if constexpr (STATS) fence_operands(pr);
          mbar_arrive(empty(sp));   // this thread is done with slot sp's K and V
          pack_p();
        }
        mbar_arrive(empty_q);       // every q.k^T of this work tile is done
        const int r = it + n_tiles - 1, sp = r % STAGES;
        rescale_o(al0, al1);
        fence_operands(o);
        mbar_wait(full_v(sp), (r / STAGES) & 1);
        named_sync(1 + wg);
        wgmma_fence();
        issue_pv(sp);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_operands(o);
        fence_operands(pp);
        if constexpr (STATS) fence_operands(pr);
        mbar_arrive(empty(sp));
        it += n_tiles;
      } else {
        mbar_arrive(empty_q);
      }

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + x.b * p.o_sb + x.h * p.o_sh;
      if constexpr (STATS) {
        __nv_bfloat16* rg = static_cast<__nv_bfloat16*>(p.o_res) + x.b * p.o_sb + x.h * p.o_sh;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * t;
          uint32_t hi, lo;
          if (qr0 < p.Sq) {
            pack_split(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0, hi, lo);
            *reinterpret_cast<uint32_t*>(og + qr0 * p.o_ss + col) = hi;
            *reinterpret_cast<uint32_t*>(rg + qr0 * p.o_ss + col) = lo;
          }
          if (qr1 < p.Sq) {
            pack_split(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1, hi, lo);
            *reinterpret_cast<uint32_t*>(og + qr1 * p.o_ss + col) = hi;
            *reinterpret_cast<uint32_t*>(rg + qr1 * p.o_ss + col) = lo;
          }
        }
        // m: the row's running max in log2 units; l: its sum of exp2(y log2 e - m)
        float* lg = p.lse + (static_cast<long long>(x.b) * p.H + x.h) * p.lse_ld;
        if (t == 0 && qr0 < p.Sq) lg[qr0] = l0 > 0.f ? m0 + log2f(l0) : INFINITY;
        if (t == 0 && qr1 < p.Sq) lg[qr1] = l1 > 0.f ? m1 + log2f(l1) : INFINITY;
      } else {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (qr0 < p.Sq)
            *reinterpret_cast<uint32_t*>(og + qr0 * p.o_ss + col) =
                pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
          if (qr1 < p.Sq)
            *reinterpret_cast<uint32_t*>(og + qr1 * p.o_ss + col) =
                pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
    }
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
  key_range(p, q_lo + p.q_offset, min(q_lo + BQ, p.Sq) - 1 + p.q_offset, k_begin, k_end);
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
      const int qpos = q_lo + ty + 8 * i + p.q_offset;
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
    if (p.lse != nullptr && tx == 0)   // m and l in natural-log units here
      p.lse[(static_cast<long long>(b) * p.H + h) * p.lse_ld + row] =
          l[i] > 0.f ? (m[i] + logf(l[i])) * kLog2e : INFINITY;
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

template <int HD, bool STATS>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tiles<HD>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, p.q, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, T::BQ) ||
      !encode_map(&tk, p.k, HD, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, T::BK) ||
      !encode_map(&tv, p.v, HD, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, T::BK))
    return kEncodeFailed;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_bf16<HD, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const long long n_work = static_cast<long long>((p.Sq + T::BQ - 1) / T::BQ) * p.B * p.H;
  if (n_work > (1ll << 31) - 1) return cudaErrorInvalidConfiguration;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  // One block per SM (its shared memory allows no second), each walking the
  // work list.
  const dim3 grid(static_cast<unsigned>(n_work < sms ? n_work : sms));
  fa_fwd_bf16<HD, STATS><<<grid, kBf16Threads, T::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD, int BQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = ((BQ + 64) * (HD + 1) + 64 * HD + BQ * 65) * sizeof(float);
  return launch(fa_fwd_f32<HD, BQ>, p, BQ, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v and o in that order.  q_offset: the position of
// query row 0 (>= 0; keys count from 0).  lse: null (serving), or fp32
// [B, H, lse_ld] for each row's base-2 log-sum-exp (training); then in bf16
// o_res (o's strides) takes o's residual.  Returns a cudaError_t value, -1
// for a dtype / head-dim pair with no instantiation, or -2 when a TMA tensor
// map cannot be encoded (no driver entry point, or a stride or address the
// TMA unit does not take).
extern "C" int repro_flash_attention_fwd(int dtype, int head_dim, const void* q,
                                         const void* k, const void* v, void* o,
                                         float* lse, void* o_res, long long lse_ld,
                                         int B, int H, int KV, int Sq, int Skv,
                                         const long long* strides, int causal,
                                         int window, int q_offset, float softcap,
                                         float scale, void* stream) {
  Params p{q, k, v, o, B, H, KV, Sq, Skv,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           causal, window, q_offset, softcap, scale, lse, o_res, lse_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && lse != nullptr) {
    switch (head_dim) {
      case 64: return launch_bf16<64, true>(p, st);
      case 128: return launch_bf16<128, true>(p, st);
      case 256: return launch_bf16<256, true>(p, st);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch_bf16<64, false>(p, st);
      case 128: return launch_bf16<128, false>(p, st);
      case 256: return launch_bf16<256, false>(p, st);
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

// Dynamic shared memory of the bf16 kernel at a head dim (bytes), or -1.
extern "C" long long repro_flash_attention_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 64: return static_cast<long long>(Bf16Tiles<64>::SMEM);
    case 128: return static_cast<long long>(Bf16Tiles<128>::SMEM);
    case 256: return static_cast<long long>(Bf16Tiles<256>::SMEM);
  }
  return -1;
}
