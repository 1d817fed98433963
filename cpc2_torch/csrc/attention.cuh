// Causal relative-position attention of the prediction heads, forward and
// backward, for Hopper (sm_90a). Per attention unit n (one block of S steps
// of one head of one batch row):
//
//   logit[r, c] = (q[r] . k[c] + sum_d q[r, d] * Krelpos[d, S-1-(r-c)]) / sqrt(dk)
//   p = softmax over c <= r (causal),  p~ = dropout(p),  out = p~ . v
//
// Replaces the TPU kernel cpc2_tpu/ops/attention_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_relpos_attention`). The TPU kernel takes a (dk, S, S)
// table W2[d, r, c] = Krelpos[d, S-1-(r-c)] gathered outside the kernel and
// carries dW2 across its sequential grid. Here the relative term is a
// product plus a skew: for a tile of 16 rows, QP = Q_t . Krelpos is a
// (16, S) product and rel[r, c] = QP[r, S-1-r+c]; in the backward the score
// gradients dS, written skewed as dQP[r, S-1-r+c] = dS[r, c], give
// dq += dQP . Krelpos^T and the unit's dKrelpos = Q^T . dQP.
//
// What bounds it: at the recipe (N = 64 units, S = 116, dk = 32) the work is
// about 165 MFLOP forward and 440 MFLOP backward, microseconds even at the
// 3xTF32 rate, and the compulsory traffic about 4 MB. Latency and idle SMs
// set its time, so the design spreads every unit over several CTAs and puts
// every product on the tensor cores:
//
// - Rows. A unit's row tiles of 16 (the last one ragged) go in causal-
//   balanced pairs, tile i with tile T-1-i, so every pair has T+1 column
//   tiles of work; CTA rank rho of a unit's R CTAs owns pair slots rho,
//   rho + R, ..., a warp per tile (`own_tile`). At the recipe: 8 tiles, 4
//   pairs, R = 2, 128 CTAs of 4 warps in each kernel.
// - Staging, by asynchronous copies on two mbarriers: Krelpos (dk, S) by
//   one bulk copy on the first, transposed once in shared memory into
//   krel_t (S rows of ldr floats) while the second waits for the unit's K
//   and V and the CTA's Q (and G) tiles, TMA boxes of a 3-D map (dk, S, N)
//   whose box is ld = dkp + 4 floats wide: TMA writes them at the padded
//   row stride, fills the padding and rows past S with zeros, and no thread
//   touches them on the way. Fragment loads are free of
//   bank conflicts: the row-major tiles at ld = 4 mod 8 serve both fragment
//   patterns the products read them in ([g][t], and [2t][g] with the k
//   order permuted, below); krel_t is read as [g][t] (QP) and as [t][g]
//   (dq's relative part), which no padding serves, so its columns are
//   XOR-swizzled by row (`swz`) instead.
// - Products: mma.sync.m16n8k8 in TF32 with the 3xTF32 split (common.cuh:
//   small*big + big*small + big*big, fp32 accumulators; about 1.2e-6 of a
//   product, against 2^-24 for fp32 FMAs). Single-pass TF32 or bf16 is
//   never used. `wgmma` is not taken: a unit's products are 116 x 116 x 32,
//   too small for 64-row warpgroup tiles to pay, and latency, not the
//   tensor-core rate, bounds them. Column tiles wholly above the diagonal
//   are skipped a group of column tiles at a time (`group_of`, below).
// - Softmax in registers: a row's values of the C fragments sit in one quad,
//   so its max and sum take two shuffles; a row (<= 16 max_tiles columns)
//   fits, so there is no online rescaling. Dropout hashes the fragment's
//   coordinates.
// - p~ . v from registers. The k index of a product is summed, so V's rows
//   within each 8-block are taken in the order k = t <-> c = 2t, k = t + 4
//   <-> c = 2t + 1, and the C fragment of p~ serves as the A fragment with
//   no round trip through shared memory. dq's dS . k does the same.
// - Backward, one cluster of R CTAs a unit (R = 2 at the recipe), each CTA
//   with the forward's rows. Row side: recompute p, dP = G_t . V^T masked by
//   the same hash, D_r = sum_c dp p, dS = p (dp - D) scale in registers;
//   store p~ and dS (and dS skewed as dQP) to the CTA's own planes; dq_t =
//   dS_t . K + dQP_t . krel_t. Column side: each CTA forms its rows'
//   partials of dk = dS^T Q, dv = p~^T G and the unit's dKrelpos = dQP^T Q
//   by m-tiles of 16 (row tiles that hold no nonzero skipped), and rank
//   rho finishes m-tiles [rho T / R, (rho + 1) T / R): the others store
//   their partials into its shared memory (distributed shared memory, over
//   k, v and krel_t, dead by then), and it adds them in rank order. The
//   per-unit dKrelpos partials (N, S, dk) are summed over units in order by
//   `relpos_grad_sum`. No atomics: bit for bit the same from call to call.
// - Wide units. Where a unit's rows do not fit a block whole (dk above 248,
//   a TMA box's 256 floats less the padding, or above what shared memory
//   holds; the gate's limits allow such dk only at S <= 58, 4 row tiles),
//   the plan gives chunks of dc columns of dk and the wide kernels take one
//   CTA a unit. They stage a chunk at a time on one mbarrier: the forward
//   adds up QP, q.k (and the backward dP) over the chunks in registers, then
//   takes the softmax (and the score gradients) as above, and stages the
//   chunks again for p~.v (dq, dk, dv and dKrelpos), a chunk of the outputs
//   at a time.
//
// The plan (`cpc2_torch/ops/attention.py:attention_plan`) holds every stride,
// region, grid and cluster size; the entry points refuse a plan that differs
// from the layout below (`plan_ok`). dk is a multiple of 4 here (16-byte
// rows; the wrapper pads it) and is padded to 8 in shared memory.
//
// Dropout keeps (n, r, c) when dropout_bits(seed, n*S + r, c) >= threshold
// (common.cuh), the mask that cpc2_torch/ops/ffn.py:dropout_bits computes.
//
// bf16-in/bf16-out variant (`cpc2_attention_{fwd,bwd}_bf16io`, the heads'
// bf16 activations under `--precision bf16`): every kernel above is also
// instantiated for bf16 q, k, v and g (the template's `In`). What held its
// first version back was its staging: every thread loaded the rows by
// plain 8-byte loads before any product, with nothing in flight beside
// them, and each product paid three TF32 products where its operands' small
// planes were zero. Now q, k, v and g come by TMA boxes of a bf16 3-D map
// (dk_in, S, N), dk_in padded to 8 (16-byte strides), on the mbarrier the
// fp32 boxes use, while the Krelpos transpose runs; the block then widens
// them to the fp32 rows at ld (zeros past dk and S, as the fp32 boxes leave
// them; `widen`). The boxes land in a staging region of their own where the
// block still fits with it (the recipe: one pass of whole rows a warp,
// about 0.5 us), else at the end of the rows they fill, widened in place
// in a few passes (every shape the gate lets through fits so). A bf16 value
// is its own TF32 rounding, so `mma3` leaves out the terms of a zero small
// plane: q.k, G.V^T and the forward's p~.v take one TF32 product (exact), a
// product with one bf16 operand two, the fp32 ones (Krelpos, dS, the
// backward's p~) three; the sums are those of three bit for bit. The
// forward rounds p~ to bf16 only as p~ . v's operand and stores o as bf16;
// the backward recomputes p~ in fp32 (the rounding is straight-through, as
// in the TPU kernel) and stores dq, dk and dv as bf16, the units' dKrelpos
// partials and their sum in fp32. Latency bounds these kernels as it bounds
// the fp32 ones.
#pragma once

#include "hopper_gemm.cuh"

namespace {

using cpc2::bf16;
using cpc2::bulk_copy;
using cpc2::mbar_expect_tx;
using cpc2::mbar_init;
using cpc2::mbar_wait;
using cpc2::mma_tf32;
using cpc2::smem_u32;
using cpc2::split_tf32;
using cpc2::tma_load_3d;

constexpr int kTile = 16;
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxBox = 256;
constexpr int kHeaderBytes = 128;
constexpr int kSmemLimit = 232448;
constexpr int kChunk = 4;  // n8 tiles of an output chunk: 32 columns of dk
// Column tiles of a group: the products' loops over column tiles run a
// group at a time, unrolled with no branch inside, so that the scheduler
// interleaves the group's independent products and loads (with a branch
// per tile each product waited for the last: 10x slower). Tiles past the
// causal end of a group are computed and masked, their rows clamped. 2 for
// the widest instantiation (kN = 24 column tiles), whose backward spills
// with 4.
template <int kN>
__host__ __device__ constexpr int group_of() {
  return kN > 16 ? 2 : 4;
}
// The widest instantiation also takes its output chunks 16 columns wide and
// keeps each product's three terms in one accumulator (no hi/lo split),
// which with its 96 floats of probabilities would not fit 255 registers.
template <int kN>
__host__ __device__ constexpr int chunk_of() {
  return kN > 16 ? 2 : kChunk;
}
template <int kN>
__host__ __device__ constexpr bool split_of() {
  return kN <= 16;
}
constexpr float kLog2e = 1.4426950408889634f;

// The host's plan, field for field as AttentionPlan lists them.
struct AttnPlan {
  int n, s, dk, dk_in, dkp, dc, chunks, tiles, pairs, max_tiles, ld, ldr, lds;
  int fwd_ctas, fwd_warps, f_k, f_v, f_krel, f_q, f_x, f_raw, f_floats,
      fwd_smem;
  int bwd_ctas, bwd_warps, mtiles, b_k, b_v, b_krel, b_q, b_g, b_pd, b_ds,
      b_dqp, b_raw, b_floats, exchange, bwd_smem;
  int io, f_st, b_st;
};
constexpr int kPlanInts = sizeof(AttnPlan) / sizeof(int);

int up(int x, int m) { return (x + m - 1) / m * m; }
int region(int floats) { return up(floats, 32); }  // 128-byte aligned

// The layout that the kernels below use, from (n, s, dk), the CTAs a unit
// and the chunk of dk, for fp32 or (io) bf16 operands; ok is false where no
// instantiation, TMA box or block takes it. A chunk narrower than dkp (the
// wide kernels) takes one CTA a unit and the narrowest instantiation. bf16
// rows are dk_in = dk padded to 8 (TMA's 16-byte strides). Their boxes land
// in a staging region of their own (f_st, b_st: K, V, then every warp
// slot's Q, then G), after Krelpos's raw copy, where the block still fits
// with it; else (f_st, b_st 0) at the end of the fp32 rows they are widened
// into, in place (`widen`), which takes no shared memory.
bool layout(int n, int s, int dk, int rf, int rb, int dc, int io,
            AttnPlan* p) {
  if (n < 0 || s < 1 || dk < 1 || dk % (io ? 8 : 4) != 0 || io < 0 ||
      io > 1)
    return false;
  AttnPlan& q = *p;
  q.n = n;
  q.s = s;
  q.io = io;
  q.dk_in = dk;
  q.dkp = up(dk, 8);
  q.dc = dc;
  q.tiles = (s + kTile - 1) / kTile;
  q.pairs = (q.tiles + 1) / 2;
  q.max_tiles = q.tiles <= 4 ? 4 : q.tiles <= 8 ? 8 : q.tiles <= 12 ? 12 : 0;
  const bool wide = dc < q.dkp;
  const int sp = kTile * q.tiles;
  q.ld = dc + 4;
  q.ldr = up(dc, 32);
  q.lds = sp + 4;
  if (q.max_tiles == 0 || dc < 8 || dc % 8 != 0 || dc > q.dkp ||
      q.ld > kMaxBox || rf < 1 || rb < 1 || rf > q.pairs || rb > q.pairs ||
      rb > kMaxCluster || (wide && (rf != 1 || rb != 1 || q.max_tiles != 4)))
    return false;
  q.chunks = (q.dkp + dc - 1) / dc;
  q.fwd_ctas = rf;
  q.fwd_warps = 2 * ((q.pairs + rf - 1) / rf);
  q.f_k = 0;
  q.f_v = q.f_k + region(sp * q.ld);
  q.f_krel = q.f_v + region(sp * q.ld);
  q.f_q = q.f_krel + region(sp * q.ldr);
  q.f_x = q.f_q + region(kTile * q.fwd_warps * q.ld);
  const int x = q.fwd_warps * kTile * q.lds;
  q.f_raw = wide ? q.f_x + region(x) : q.f_x;
  q.f_floats = wide ? q.f_raw + region(dc * s)
                    : q.f_x + region(x > dk * s ? x : dk * s);
  q.f_st = 0;
  if (io) {  // staged where the block still fits
    const int st = q.f_raw + region((wide ? dc : dk) * s);
    const int end = st + region(dc * (2 * sp + kTile * q.fwd_warps) / 2);
    const int floats = wide ? end : q.f_x + (x > end - q.f_x ? x : end - q.f_x);
    if (kHeaderBytes + 4 * floats <= kSmemLimit) {
      q.f_st = st;
      q.f_floats = floats;
    }
  }
  q.fwd_smem = kHeaderBytes + 4 * q.f_floats;
  q.bwd_ctas = rb;
  q.bwd_warps = 2 * ((q.pairs + rb - 1) / rb);
  const int rows = kTile * q.bwd_warps;
  q.mtiles = (q.tiles + rb - 1) / rb;
  q.b_k = q.f_k;
  q.b_v = q.f_v;
  q.b_krel = q.f_krel;
  q.b_q = q.b_krel + region(sp * q.ldr);
  q.b_g = q.b_q + region(rows * q.ld);
  q.b_pd = q.b_g + region(rows * q.ld);
  q.b_ds = q.b_pd + region(rows * q.lds);
  q.b_dqp = q.b_ds + region(rows * q.lds);
  const int planes_end = q.b_dqp + region(rows * q.lds);
  const int stage_end = q.b_pd + region(dk * s);
  q.b_raw = wide ? planes_end : q.b_pd;
  q.b_floats = wide ? q.b_raw + region(dc * s)
                    : (planes_end > stage_end ? planes_end : stage_end);
  q.b_st = 0;
  if (io) {
    const int st = q.b_raw + region((wide ? dc : dk) * s);
    const int end =
        st + region(dc * (2 * sp + 2 * kTile * q.bwd_warps) / 2);
    const int floats = wide ? end : (planes_end > end ? planes_end : end);
    if (kHeaderBytes + 4 * floats <= kSmemLimit) {
      q.b_st = st;
      q.b_floats = floats;
    }
  }
  q.exchange = (rb - 1) * q.mtiles * 3 * (q.dkp / 8) * 128;
  q.bwd_smem = kHeaderBytes + 4 * q.b_floats;
  return true;
}

// Does the host's plan equal the layout, and does that layout fit?
bool plan_ok(const AttnPlan& got, bool backward) {
  AttnPlan want;
  if (!layout(got.n, got.s, got.dk_in, got.fwd_ctas, got.bwd_ctas, got.dc,
              got.io, &want))
    return false;
  want.dk = got.dk;
  if (got.dk < 1 || got.dk > got.dk_in ||
      up(got.dk, got.io ? 8 : 4) != got.dk_in || up(got.dk, 8) != got.dkp)
    return false;
  const int* a = reinterpret_cast<const int*>(&got);
  const int* b = reinterpret_cast<const int*>(&want);
  for (int i = 0; i < kPlanInts; ++i)
    if (a[i] != b[i]) return false;
  if (backward)
    return got.bwd_warps <= kMaxWarps && got.bwd_smem <= kSmemLimit &&
           got.exchange <= got.b_q - got.b_k;
  return got.fwd_warps <= kMaxWarps && got.fwd_smem <= kSmemLimit;
}

struct AttnArgs {
  AttnPlan p;
  const float* krel;      // (dk_in, S)
  const uint32_t* seed;   // one value in device memory
  void* out;              // forward: out; backward: dq (N, S, dk_in), In
  void* dk;               // backward: (N, S, dk_in), In
  void* dv;               // backward: (N, S, dk_in), In
  float* partial;         // backward: each unit's dKrelpos^T (N, S, dk_in)
  uint32_t threshold;     // drop when dropout_bits < threshold
  float keep_scale;       // 1 / (1 - rate)
  float scale;            // 1 / sqrt(dk)
};

// Local tile slot l of CTA `rank`: its row tile, or -1 where empty.
__device__ __forceinline__ int own_tile(int rank, int R, int T, int l) {
  const int pair = rank + (l >> 1) * R;
  if (pair >= (T + 1) / 2) return -1;
  if ((l & 1) == 0) return pair;
  const int other = T - 1 - pair;
  return other == pair ? -1 : other;
}

// krel_t's swizzle: row j's logical column d lies at d ^ swz(j). Over the
// eight rows of a fragment it takes eight values that differ in bits 2-4,
// so the [g][t] fragments (rows g, columns t) and the [t][g] ones (rows t
// and t + 4, eight columns) each hit 32 banks; ldr is a multiple of 32, so
// a swizzled column stays inside its row.
__device__ __forceinline__ int swz(int j) {
  return ((j & 3) << 3) | (j & 4);
}

// dropout_bits(seed, row, c) = mix32(row_bits(seed, row) + c): the row's
// part once a row, then one mix a column.
__device__ __forceinline__ uint32_t row_bits(uint32_t seed, int row) {
  return cpc2::mix32(seed ^ cpc2::mix32((uint32_t)row));
}
__device__ __forceinline__ bool kept(uint32_t rbits, uint32_t threshold,
                                     int c) {
  return threshold == 0u || cpc2::mix32(rbits + (uint32_t)c) >= threshold;
}

struct Split {
  uint32_t big[4], small[4];
};

// kBf: the values are bf16 (8 significant bits), whose TF32 rounding is
// themselves: big is the value, small is zero and left unset.
template <bool kBf = false>
__device__ __forceinline__ void split4(const float (&v)[4], Split& f) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kBf)
      f.big[e] = __float_as_uint(v[e]);
    else
      split_tf32(v[e], f.big[e], f.small[e]);
  }
}

// A . B in 3xTF32: the small terms into lo, big * big into hi (two chains,
// summed hi + lo at the end). kAB (kBB): A's (B's) values are bf16, so
// their small plane is zero and the term it enters is left out: the same
// sums bit for bit, one product fewer (with both, one product: exact).
template <bool kAB = false, bool kBB = false>
__device__ __forceinline__ void mma3(float* hi, float* lo, const Split& a,
                                     float b0, float b1) {
  uint32_t bb[2], bs[2];
  if constexpr (kBB) {
    bb[0] = __float_as_uint(b0);
    bb[1] = __float_as_uint(b1);
  } else {
    split_tf32(b0, bb[0], bs[0]);
    split_tf32(b1, bb[1], bs[1]);
  }
  if constexpr (!kAB) mma_tf32(lo, a.small, bb);
  if constexpr (!kBB) mma_tf32(lo, a.big, bs);
  mma_tf32(hi, a.big, bb);
}

// Accumulators of one output chunk (kC n8 tiles), hi and lo terms.
template <int kC>
struct ChunkT {
  float hi[kC][4], lo[kC][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nt = 0; nt < kC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[nt][e] = lo[nt][e] = 0.f;
  }
  // out[nt] = hi + lo
  __device__ __forceinline__ void sum(float (&o)[kC][4]) const {
#pragma unroll
    for (int nt = 0; nt < kC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = hi[nt][e] + lo[nt][e];
  }
};
using Chunk = ChunkT<kChunk>;

// The A fragment of rows (g, g + 8) of a row-major tile at stride ld,
// columns k0 + t and k0 + t + 4.
__device__ __forceinline__ void load_a(const float* x, int ld, int k0,
                                       float (&v)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  v[0] = x[g * ld + k0 + t];
  v[1] = x[(g + 8) * ld + k0 + t];
  v[2] = x[g * ld + k0 + t + 4];
  v[3] = x[(g + 8) * ld + k0 + t + 4];
}

// A C fragment as the A fragment of the next product, its columns taken as
// k in the order k = t <-> 2t, k = t + 4 <-> 2t + 1.
template <bool kBf = false>
__device__ __forceinline__ void c_as_a(const float (&c)[4], Split& f) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  split4<kBf>(v, f);
}

// One row tile's (16 x 8 n) fragments of a product over the dkp columns of
// the tile's rows x (at ld), against rows of y (at ldy, rows past ymax
// clamped) or, with kRel, of the swizzled krel_t: acc[u] = x . y[8 (u0 + u)
// .. +8]^T for u < nu, rounded up to a group (with kAdd, acc[u] +=).
// kXB, kYB: x's, y's values are bf16 (`mma3`).
template <int kN, bool kRel, bool kAdd = false, bool kXB = false,
          bool kYB = false>
__device__ __forceinline__ void rows_product(const float* x, int ld,
                                             const float* y, int ldy,
                                             int ymax, int dkp, int u0,
                                             int nu, float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= nu) break;
    float hi[kG][4] = {}, lo[kG][4] = {};
    const float* yr[kG];
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
      yr[uu] = y + min(8 * (u0 + g0 + uu) + g, ymax) * ldy;
    for (int k0 = 0; k0 < dkp; k0 += 8) {
      float v[4];
      load_a(x, ld, k0, v);
      Split a;
      split4<kXB>(v, a);
#pragma unroll
      for (int uu = 0; uu < kG; ++uu) {
        const float b0 = kRel ? yr[uu][(k0 + t) ^ swz(g)] : yr[uu][k0 + t];
        const float b1 =
            kRel ? yr[uu][(k0 + t + 4) ^ swz(g)] : yr[uu][k0 + t + 4];
        mma3<kXB, kYB>(hi[uu], split_of<kN>() ? lo[uu] : hi[uu], a, b0, b1);
      }
    }
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kAdd)
          acc[g0 + uu][e] += hi[uu][e] + lo[uu][e];
        else
          acc[g0 + uu][e] = hi[uu][e] + lo[uu][e];
      }
  }
}

// o += A_u . B_u over k steps u < nu (rounded up to a group), A_u the C
// fragment acc[u] taken as an A fragment, B_u rows 8 u + 2t and 8 u + 2t + 1
// of y (at ld, clamped at ymax), columns d0 + 8 nt + g. kAB, kYB: acc's,
// y's values are bf16 (`mma3`).
template <int kN, bool kAB = false, bool kYB = false>
__device__ __forceinline__ void c_product(const float (&acc)[kN][4], int nu,
                                          const float* y, int ld, int ymax,
                                          int d0,
                                          ChunkT<chunk_of<kN>()>& o) {
  constexpr int kG = group_of<kN>(), kC = chunk_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= nu) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu) {
      const int u = g0 + uu;
      Split fa;
      c_as_a<kAB>(acc[u], fa);
      const float* y0 = y + min(8 * u + 2 * t, ymax - 1) * ld + d0 + g;
#pragma unroll
      for (int nt = 0; nt < kC; ++nt)
        mma3<kAB, kYB>(o.hi[nt], split_of<kN>() ? o.lo[nt] : o.hi[nt], fa,
                       y0[8 * nt], y0[ld + 8 * nt]);
    }
  }
}

// o += dS . y as c_product, with dS read back from the warp's ds plane
// (rows at lds) instead of registers: the widest instantiation's dq, whose
// probabilities' 96 registers are free by then. kYB: y's values are bf16.
template <int kN, bool kYB = false>
__device__ __forceinline__ void plane_product(const float* x, int lds, int nu,
                                              const float* y, int ld,
                                              int ymax, int d0,
                                              ChunkT<chunk_of<kN>()>& o) {
  constexpr int kC = chunk_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int u = 0; u < nu; ++u) {
    const float2 r0 = *reinterpret_cast<const float2*>(x + g * lds + 8 * u +
                                                       2 * t);
    const float2 r1 = *reinterpret_cast<const float2*>(
        x + (g + 8) * lds + 8 * u + 2 * t);
    const float c[4] = {r0.x, r0.y, r1.x, r1.y};  // as the C fragment
    Split fa;
    c_as_a(c, fa);
    const float* y0 = y + min(8 * u + 2 * t, ymax - 1) * ld + d0 + g;
#pragma unroll
    for (int nt = 0; nt < kC; ++nt)
      mma3<false, kYB>(o.hi[nt], split_of<kN>() ? o.lo[nt] : o.hi[nt], fa,
                       y0[8 * nt], y0[ld + 8 * nt]);
  }
}

template <typename In>
__host__ __device__ constexpr bool is_bf16() {
  return sizeof(In) == 2;
}

// Where the boxes of a unit land: fp32 ones in the rows themselves (k and
// v: sp rows; q and g: a warp slot's 16 rows at + l kTile ld), bf16 ones
// (rows of dc values) at the end of the rows they are widened into.
template <typename In>
struct Boxes {
  float *k, *v, *q, *g;
  int sp, dc, ld, warps;
  bf16* st;  // the staging region, or nullptr: in place
  // the bf16 rows of region `rows` (n of them) whose staging slot begins
  // `slot` rows into the staging region
  __device__ __forceinline__ bf16* src(float* rows, int n, int slot) const {
    return st ? st + slot * dc
              : reinterpret_cast<bf16*>(rows + n * ld) - n * dc;
  }
  __device__ __forceinline__ void* at(float* rows, int n, int slot) const {
    return is_bf16<In>() ? (void*)src(rows, n, slot) : (void*)rows;
  }
  __device__ __forceinline__ void* dst_k() const { return at(k, sp, 0); }
  __device__ __forceinline__ void* dst_v() const { return at(v, sp, sp); }
  __device__ __forceinline__ void* dst_q(int l) const {
    return at(q + l * kTile * ld, kTile, 2 * sp + kTile * l);
  }
  __device__ __forceinline__ void* dst_g(int l) const {
    return at(g + l * kTile * ld, kTile, 2 * sp + kTile * (warps + l));
  }
  // a row's bytes in a box
  __device__ __forceinline__ uint32_t row_bytes() const {
    return is_bf16<In>() ? 2u * dc : 4u * ld;
  }
};

// The boxes of a unit in the forward's (kBwd false) or the backward's
// regions of the block's floats at `base`.
template <bool kBwd, typename In>
__device__ __forceinline__ Boxes<In> unit_boxes(const AttnPlan& p,
                                                float* base) {
  if constexpr (kBwd)
    return {base + p.b_k, base + p.b_v, base + p.b_q, base + p.b_g,
            kTile * p.tiles, p.dc, p.ld, p.bwd_warps,
            p.b_st ? reinterpret_cast<bf16*>(base + p.b_st) : nullptr};
  else
    return {base + p.f_k, base + p.f_v, base + p.f_q, nullptr,
            kTile * p.tiles, p.dc, p.ld, p.fwd_warps,
            p.f_st ? reinterpret_cast<bf16*>(base + p.f_st) : nullptr};
}

// The lanes' share of widening rows of dc values: a warp takes 32 / (dc /
// 8) rows at a time, lane (row, piece) = (lane / (dc / 8), lane % (dc /
// 8)), a piece 8 values (16 bytes in, 32 out); lanes past the warp's
// rows idle.
struct WidenLanes {
  int c8n, piece, first, step;
  __device__ __forceinline__ explicit WidenLanes(int dc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    c8n = dc / 8;
    const int rpw = 32 / c8n, sub = lane / c8n;
    piece = lane - sub * c8n;
    step = (blockDim.x >> 5) * rpw;
    first = sub < rpw ? warp * rpw + sub : 1 << 30;
  }
};

__device__ __forceinline__ void widen_piece(float* d, uint4 raw, bool last) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
  *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
  if (last)  // the row's padding: zeros, as a box of the fp32 map leaves it
    *reinterpret_cast<float4*>(d + 8) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows [a, b) of fp32 rows at ld widened from the bf16 rows of dc values
// at src.
__device__ __forceinline__ void widen_rows(float* dst, const bf16* src,
                                           int a, int b, int dc, int ld,
                                           const WidenLanes& wl) {
#pragma unroll 2
  for (int r = a + wl.first; r < b; r += wl.step)
    widen_piece(dst + r * ld + 8 * wl.piece,
                *reinterpret_cast<const uint4*>(src + r * dc + 8 * wl.piece),
                wl.piece == wl.c8n - 1);
}

// widen_rows over two regions of the same rows (K and V) in one loop.
__device__ __forceinline__ void widen_rows2(float* dst0, const bf16* src0,
                                            float* dst1, const bf16* src1,
                                            int a, int b, int dc, int ld,
                                            const WidenLanes& wl) {
#pragma unroll 2
  for (int r = a + wl.first; r < b; r += wl.step) {
    const uint4 v0 =
        *reinterpret_cast<const uint4*>(src0 + r * dc + 8 * wl.piece);
    const uint4 v1 =
        *reinterpret_cast<const uint4*>(src1 + r * dc + 8 * wl.piece);
    widen_piece(dst0 + r * ld + 8 * wl.piece, v0, wl.piece == wl.c8n - 1);
    widen_piece(dst1 + r * ld + 8 * wl.piece, v1, wl.piece == wl.c8n - 1);
  }
}

// The end of the next pass over a region of `rows` rows, `done` of them
// widened: the rows whose fp32 writes end before the bf16 rows still
// unread begin (bf16 row r lies at byte rows (4 ld - 2 dc) + 2 dc r of the
// region, so fp32 row r's write covers only bf16 rows at or before r):
// about half the rows left; `done` itself when one row is left, whose fp32
// row covers its own bf16 one.
__device__ __forceinline__ int widen_upto(int rows, int done, int dc,
                                          int ld) {
  return (rows * (4 * ld - 2 * dc) + 2 * dc * done) / (4 * ld);
}

// bf16: the landed boxes of `what` (1 K, 2 V, 4 Q, 8 G) widened to the
// fp32 rows by every thread of the block. Staged: one pass, a barrier.
// In place: K and V on one schedule of passes, every own warp slot's Q and
// G on another, a barrier after each round (about log2 of the rows: 7 at
// SP = 128, 5.3 us on an H100 against one staged pass's 0.5), then each
// region's last row by one warp, read into registers before it is
// written. The rows are ready after the final barrier.
template <typename In>
__device__ __forceinline__ void widen(const Boxes<In>& b, int what, int rank,
                                      int R, int tiles) {
  const int dc = b.dc, ld = b.ld;
  const WidenLanes wl(dc);
  const int sp = b.sp;
  const int last = b.st ? 0 : 1;  // in place: a last row apart
  int kv = what & 3 ? 0 : sp, sl = what & 12 ? 0 : kTile;
  while (kv < sp - last || sl < kTile - last) {
    if (kv < sp - last) {
      const int to = b.st ? sp : widen_upto(sp, kv, dc, ld);
      if ((what & 3) == 3)  // both: one loop, twice the loads in flight
        widen_rows2(b.k, b.src(b.k, sp, 0), b.v, b.src(b.v, sp, sp), kv, to,
                    dc, ld, wl);
      else if (what & 1)
        widen_rows(b.k, b.src(b.k, sp, 0), kv, to, dc, ld, wl);
      else if (what & 2)
        widen_rows(b.v, b.src(b.v, sp, sp), kv, to, dc, ld, wl);
      kv = to;
    }
    if (sl < kTile - last) {
      const int to = b.st ? kTile : widen_upto(kTile, sl, dc, ld);
      for (int l = 0; l < b.warps; ++l) {
        if (own_tile(rank, R, tiles, l) < 0) continue;
        float* q = b.q + l * kTile * ld;
        if (what & 4)
          widen_rows(q, b.src(q, kTile, 2 * sp + kTile * l), sl, to, dc, ld,
                     wl);
        if (what & 8) {
          float* g = b.g + l * kTile * ld;
          widen_rows(g, b.src(g, kTile, 2 * sp + kTile * (b.warps + l)), sl,
                     to, dc, ld, wl);
        }
      }
      sl = to;
    }
    __syncthreads();
  }
  if (b.st) return;
  // region i (0 K, 1 V, then Q and G of each warp slot) by warp i % warps
  const int lane = threadIdx.x & 31, warps_n = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < 2 + 2 * b.warps; i += warps_n) {
    float* dst = nullptr;
    int rows = kTile;
    if (i < 2) {
      dst = (what >> i) & 1 ? (i == 0 ? b.k : b.v) : nullptr;
      rows = b.sp;
    } else if (own_tile(rank, R, tiles, (i - 2) >> 1) >= 0 &&
               (what >> (2 + (i & 1))) & 1) {
      dst = (i & 1 ? b.g : b.q) + ((i - 2) >> 1) * kTile * ld;
    }
    if (dst == nullptr) continue;
    uint4 raw = {};
    const bool live = lane < wl.c8n;
    if (live)
      raw = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const bf16*>(dst + rows * ld) - dc + 8 * lane);
    __syncwarp();
    if (live)
      widen_piece(dst + (rows - 1) * ld + 8 * lane, raw, lane == wl.c8n - 1);
  }
  __syncthreads();
}

// Staging, shared by both kernels: K and V of the unit and the CTA's Q (and
// G) tiles by TMA boxes (fp32: straight into the rows; bf16: at the end of
// the rows they fill), Krelpos by one bulk copy into `stage`, on two
// mbarriers; Krelpos transposed into krel_t (zeros past S and dk) while the
// boxes are in flight, then the bf16 boxes widened in place.
template <bool kBwd, typename In>
__device__ __forceinline__ void stage_unit(
    const AttnPlan& p, const AttnArgs& a, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_q,
    const CUtensorMap* map_g, uint64_t* bar, float* base, float* krel_t,
    float* stage, int unit, int rank, int R) {
  const Boxes<In> b = unit_boxes<kBwd, In>(p, base);
  const int sp = kTile * p.tiles, warps = b.warps;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], 4u * p.dk_in * p.s);
    bulk_copy(stage, a.krel, 4u * p.dk_in * p.s, &bar[0]);
    int own = 0;
    for (int l = 0; l < warps; ++l) own += own_tile(rank, R, p.tiles, l) >= 0;
    const uint32_t row = b.row_bytes();
    mbar_expect_tx(&bar[1], 2 * row * sp + (kBwd ? 2 : 1) * row * kTile * own);
    tma_load_3d(b.dst_k(), map_k, &bar[1], 0, 0, unit);
    tma_load_3d(b.dst_v(), map_v, &bar[1], 0, 0, unit);
    for (int l = 0; l < warps; ++l) {
      const int tile = own_tile(rank, R, p.tiles, l);
      if (tile < 0) continue;
      tma_load_3d(b.dst_q(l), map_q, &bar[1], 0, kTile * tile, unit);
      if (kBwd)
        tma_load_3d(b.dst_g(l), map_g, &bar[1], 0, kTile * tile, unit);
    }
  }
  // Krelpos transposed while the boxes land: a warp takes 8 rows j of
  // krel_t, its lanes 8 j by 4 d at a time (the writes hit 32 banks, the
  // staged reads at most two a bank).
  mbar_wait(&bar[0], 0);
  const int lane = threadIdx.x & 31, warps_n = blockDim.x >> 5;
  for (int j0 = 8 * (threadIdx.x >> 5); j0 < sp; j0 += 8 * warps_n) {
    const int j = j0 + (lane & 7), jc = min(j, p.s - 1);
#pragma unroll 4
    for (int d = lane >> 3; d < p.ldr; d += 4) {
      // an unconditional load (clamped), so that the unrolled loads overlap
      const float v = stage[min(d, p.dk_in - 1) * p.s + jc];
      krel_t[j * p.ldr + (d ^ swz(j))] = (j < p.s && d < p.dk_in) ? v : 0.f;
    }
  }
  mbar_wait(&bar[1], 0);
  if constexpr (is_bf16<In>())
    widen<In>(b, kBwd ? 15 : 7, rank, R, p.tiles);
  else
    __syncthreads();
}

// The column tiles of a row tile's relative term: QP's columns [8 jlo, 8
// (jlo + njt)) hold every S-1-r+c of its causal (r, c).
__device__ __forceinline__ int rel_lo(int s, int tile) {
  const int r0 = kTile * tile;
  return (s - kTile - r0 > 0 ? s - kTile - r0 : 0) >> 3;
}

// QP's fragments acc[u] (u < njt) into the warp's 16 x lds scratch `qp`.
template <int kN>
__device__ __forceinline__ void store_qp(const AttnPlan& p, float* qp,
                                         int jlo, int njt,
                                         const float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= njt) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu) {
      const int u = g0 + uu, j = 8 * (jlo + u) + 2 * t;
      if (u < njt) {
        *reinterpret_cast<float2*>(qp + g * p.lds + j) =
            make_float2(acc[u][0], acc[u][1]);
        *reinterpret_cast<float2*>(qp + (g + 8) * p.lds + j) =
            make_float2(acc[u][2], acc[u][3]);
      }
    }
  }
  __syncwarp();
}

// The softmax of row tile `tile` in place: acc[u] holds q.k of column tiles
// u < ncol (and up to the end of the last group), `qp` the tile's QP; out
// come the probabilities. Rows past S get zeros.
template <int kN>
__device__ __forceinline__ void softmax_rows(const AttnPlan& p, float scale,
                                             const float* qp, int tile,
                                             int ncol, float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = kTile * tile, s = p.s;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu) {
      const int u = g0 + uu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = g + 8 * (e >> 1), r = r0 + rr;
        const int c = 8 * u + 2 * t + (e & 1);
        const bool in = c <= r && r < s;
        const float rel = qp[rr * p.lds + (in ? s - 1 - r + c : 0)];
        const float x = in ? (acc[u][e] + rel) * scale : -INFINITY;
        acc[u][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
    }
  }
  float sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    if (m[h] == -INFINITY) m[h] = 0.f;  // a row past S
    sum[h] = 0.f;
  }
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = acc[g0 + uu][e];
        x = exp2f((x - m[e >> 1]) * kLog2e);
        sum[e >> 1] += x;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] = sum[h] > 0.f ? 1.f / sum[h] : 0.f;
  }
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g0 + uu][e] *= sum[e >> 1];
  }
  __syncwarp();  // qp's reads done before the warp writes there again
}

// Row tile `tile`'s probabilities in acc[u] (column tiles u < ncol, and 0
// up to the end of the last group), from its q rows (at ld) against k and
// krel_t, with `qp`, the warp's 16 x lds scratch, for the relative term;
// kBf: q and k hold bf16 values.
template <int kN, bool kBf>
__device__ __forceinline__ void row_probs(const AttnPlan& p, float scale,
                                          const float* q, const float* sk,
                                          const float* krel_t, float* qp,
                                          int tile, int ncol,
                                          float (&acc)[kN][4]) {
  const int s = p.s, last = kTile * p.tiles - 1;
  const int jlo = rel_lo(s, tile), njt = (s + 7) / 8 - jlo;
  rows_product<kN, true, false, kBf>(q, p.ld, krel_t, p.ldr, last, p.dkp,
                                     jlo, njt, acc);
  store_qp<kN>(p, qp, jlo, njt, acc);
  rows_product<kN, false, false, kBf, kBf>(q, p.ld, sk, p.ld, last, p.dkp, 0,
                                           ncol, acc);
  softmax_rows<kN>(p, scale, qp, tile, ncol, acc);
}

// Dropout on the C fragments of the probabilities: kept ones scaled by
// 1 / (1 - rate), the others 0.
template <int kN>
__device__ __forceinline__ void drop(const AttnArgs& a, int ncol,
                                     const uint32_t (&rbits)[2],
                                     float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * (g0 + uu) + 2 * t + (e & 1);
        float& x = acc[g0 + uu][e];
        x = kept(rbits[e >> 1], a.threshold, c) ? x * a.keep_scale : 0.f;
      }
  }
}

// The row side's stores for column tile u of a row tile, from its
// probabilities pr and its dP before the mask (C fragments): p~ to the
// warp's plane pd, the masked dP to ds (held there until D is known), and
// the masked dP . p into dsum.
__device__ __forceinline__ void keep_dp(const AttnPlan& p, const AttnArgs& a,
                                        const uint32_t (&rbits)[2], int u,
                                        int ncol, const float (&dp)[4],
                                        const float (&pr)[4], float* pd,
                                        float* ds, float (&dsum)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int rr = g + 8 * (e >> 1);
    const int c = 8 * u + 2 * t + (e & 1);
    const bool keep = kept(rbits[e >> 1], a.threshold, c);
    const float v = keep ? dp[e] * a.keep_scale : 0.f;
    dsum[e >> 1] += v * pr[e];
    if (u < ncol) {
      pd[rr * p.lds + c] = keep ? pr[e] * a.keep_scale : 0.f;
      ds[rr * p.lds + c] = v;
    }
  }
}

// D_r = sum_c dp p over the quad, then dS = p (dp - D) scale, in registers
// (acc, 0 past ncol) and to ds (each thread rereads only what it wrote);
// dQP zeroed, then dS written skewed.
template <int kN>
__device__ __forceinline__ void score_grads(const AttnPlan& p, float scale,
                                            int r0, int ncol,
                                            float (&dsum)[2], float* ds,
                                            float* dqp,
                                            float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s = p.s;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
  }
  for (int i = lane; i < kTile * p.lds / 4; i += 32)
    reinterpret_cast<float4*>(dqp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu) {
      const int u = g0 + uu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = g + 8 * (e >> 1), r = r0 + rr;
        const int c = 8 * u + 2 * t + (e & 1);
        const bool here = u < ncol;
        const float dp = ds[rr * p.lds + (here ? c : 0)];
        const float v = here ? acc[u][e] * (dp - dsum[e >> 1]) * scale : 0.f;
        acc[u][e] = v;
        if (here) ds[rr * p.lds + c] = v;
        if (c <= r && r < s) dqp[rr * p.lds + s - 1 - r + c] = v;
      }
    }
  }
  __syncwarp();
}

// o += dQP_t . krel_t over QP's column tiles [jlo, jlo + njt), output
// columns d0.. of the chunk (dq's relative part).
template <int kN>
__device__ __forceinline__ void rel_dq(const AttnPlan& p, const float* dqp,
                                       const float* krel_t, int jlo, int njt,
                                       int d0, ChunkT<chunk_of<kN>()>& o) {
  constexpr int kG = group_of<kN>(), kC = chunk_of<kN>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int last = kTile * p.tiles - 1;
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= njt) break;
#pragma unroll
    for (int vv = 0; vv < kG; ++vv) {
      const int j0 = 8 * (jlo + g0 + vv);
      const bool here = g0 + vv < njt;
      float va[4];
      load_a(dqp, p.lds, here ? j0 : 0, va);
#pragma unroll
      for (int e = 0; e < 4; ++e) va[e] = here ? va[e] : 0.f;
      Split fa;
      split4(va, fa);
      const float* kr0 = krel_t + min(j0 + t, last - 4) * p.ldr;
      const float* kr1 = kr0 + 4 * p.ldr;
#pragma unroll
      for (int nt = 0; nt < kC; ++nt) {
        const int d = d0 + 8 * nt + g;
        mma3(o.hi[nt], split_of<kN>() ? o.lo[nt] : o.hi[nt], fa,
             kr0[d ^ swz(t)], kr1[d ^ swz(t + 4)]);
      }
    }
  }
}

// Stores rows (g, g + 8) of a (16 x 32) output chunk, columns d0.., rows
// below s and columns below dk_in, at out + row * dk_in (fp32, or rounded
// to bf16).
template <int kC, typename T>
__device__ __forceinline__ void store_chunk(T* out, int row0, int s,
                                            int dk_in, int d0, int nt_end,
                                            const float (&o)[kC][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kC; ++nt) {
    const int d = d0 + 8 * nt + 2 * t;
    if (nt >= nt_end || d >= dk_in) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r >= s) continue;
      if constexpr (is_bf16<T>())
        *reinterpret_cast<__nv_bfloat162*>(out + (long)r * dk_in + d) =
            __floats2bfloat162_rn(o[nt][2 * h], o[nt][2 * h + 1]);
      else
        *reinterpret_cast<float2*>(out + (long)r * dk_in + d) =
            make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
    }
  }
}

// The bf16 kernels' p~ as p~ . v's operand: each probability rounded to
// bf16 (the backward recomputes it unrounded).
template <int kN>
__device__ __forceinline__ void round_probs(int ncol, float (&acc)[kN][4]) {
  constexpr int kG = group_of<kN>();
#pragma unroll
  for (int g0 = 0; g0 < kN; g0 += kG) {
    if (g0 >= ncol) break;
#pragma unroll
    for (int uu = 0; uu < kG; ++uu)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[g0 + uu][e] = __bfloat162float(__float2bfloat16_rn(acc[g0 + uu][e]));
  }
}

template <int kMaxTiles, typename In>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_fwd_mma(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ AttnArgs a) {
  constexpr int kN = 2 * kMaxTiles;
  constexpr bool kBf = is_bf16<In>();
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnPlan& p = a.p;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* base = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* sk = base + p.f_k;
  float* sv = base + p.f_v;
  float* krel_t = base + p.f_krel;
  float* sq = base + p.f_q;
  float* sx = base + p.f_x;
  const int R = p.fwd_ctas, rank = blockIdx.x % R, unit = blockIdx.x / R;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  stage_unit<false, In>(p, a, &map_k, &map_v, &map_q, nullptr, bar, base,
                        krel_t, base + p.f_raw, unit, rank, R);

  const int tile = own_tile(rank, R, p.tiles, warp);
  if (tile < 0) return;  // no block-wide barrier follows
  const int s = p.s, r0 = kTile * tile;
  const int ncol = min(2 * (tile + 1), (s + 7) / 8);
  float acc[kN][4];
  row_probs<kN, kBf>(p, a.scale, sq + warp * kTile * p.ld, sk, krel_t,
                     sx + warp * kTile * p.lds, tile, ncol, acc);
  const uint32_t seed = *a.seed;
  const uint32_t rbits[2] = {row_bits(seed, unit * s + r0 + g),
                             row_bits(seed, unit * s + r0 + g + 8)};
  drop<kN>(a, ncol, rbits, acc);
  if constexpr (is_bf16<In>()) round_probs<kN>(ncol, acc);

  // out_t = p~ . V, a chunk of columns at a time, k over the column tiles.
  In* out = static_cast<In*>(a.out) + (long)unit * s * p.dk_in;
  constexpr int kC = chunk_of<kN>();
  for (int d0 = 0; d0 < p.dkp; d0 += 8 * kC) {
    ChunkT<kC> o;
    o.zero();
    c_product<kN, kBf, kBf>(acc, ncol, sv, p.ld, kTile * p.tiles - 1, d0, o);
    float out_c[kC][4];
    o.sum(out_c);
    store_chunk(out, r0, s, p.dk_in, d0, min(kC, (p.dkp - d0) / 8), out_c);
  }
}

// --- backward ----------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Four floats into the same shared-memory location of CTA `rank`.
__device__ __forceinline__ void store_remote(float* local, int rank,
                                             const float (&v)[4]) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// One output chunk of m-tile m of a column product over the CTA's rows: x
// 0 is dk = dS^T Q, 1 dv = p~^T G, 2 the unit's dKrelpos^T = dQP^T Q.
// Rows that hold no nonzero of the m-tile lie before `first`: for dk and
// dv rows below 16 m (causal), for dKrelpos rows below S - 16 - 16 m
// (dQP[r, j] = 0 for j < S-1-r). Row tiles wholly before it are skipped;
// a kept tile's 8-row blocks before it or past S enter as zeros. k runs
// over the rows in slot order, each block's rows in the order k = t <->
// 2t, k = t + 4 <-> 2t + 1. kYB: the rows (q or g) hold bf16 values.
template <bool kYB>
__device__ __forceinline__ void column_chunk(const AttnPlan& p, int rank,
                                             int warps, const float* plane,
                                             const float* rows, int x, int m,
                                             int d0, float (&out)[kChunk][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int c0 = kTile * m;
  const int first = x < 2 ? c0 : p.s - kTile - c0;
  Chunk o;
  o.zero();
  for (int l = 0; l < warps; ++l) {
    const int tile = own_tile(rank, p.bwd_ctas, p.tiles, l);
    if (tile < 0 || kTile * tile + 15 < first) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a block wholly before `first` or past S is zero: its A is zeroed
      const int b0 = kTile * tile + 8 * h;
      const bool live = b0 + 7 >= first && b0 < p.s;
      const int lr = kTile * l + 8 * h + 2 * t;
      const float* a0 = plane + lr * p.lds + c0 + g;
      const float v[4] = {live ? a0[0] : 0.f, live ? a0[8] : 0.f,
                          live ? a0[p.lds] : 0.f, live ? a0[p.lds + 8] : 0.f};
      Split fa;
      split4(v, fa);
      const float* y0 = rows + lr * p.ld + d0 + g;
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt)
        mma3<false, kYB>(o.hi[nt], o.lo[nt], fa, y0[8 * nt],
                         y0[p.ld + 8 * nt]);
    }
  }
  o.sum(out);
}

template <int kMaxTiles, typename In>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bwd_mma(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_g,
                  const __grid_constant__ AttnArgs a) {
  constexpr int kN = 2 * kMaxTiles;
  constexpr int kG = group_of<kN>();
  constexpr bool kBf = is_bf16<In>();
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnPlan& p = a.p;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* base = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* sk = base + p.b_k;
  float* sv = base + p.b_v;
  float* krel_t = base + p.b_krel;
  float* sq = base + p.b_q;
  float* sg = base + p.b_g;
  float* spd = base + p.b_pd;
  float* sds = base + p.b_ds;
  float* sdqp = base + p.b_dqp;
  float* exch = base + p.b_k;  // over k, v and krel_t once the rows are done
  const int R = p.bwd_ctas, W = p.bwd_warps;
  const int rank = (int)cluster_rank(), unit = blockIdx.x / R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = p.s, dk_in = p.dk_in;
  stage_unit<true, In>(p, a, &map_k, &map_v, &map_q, &map_g, bar, base,
                       krel_t, base + p.b_raw, unit, rank, R);

  // Row side: a warp per own tile.
  const int tile = own_tile(rank, R, p.tiles, warp);
  if (tile >= 0) {
    const int r0 = kTile * tile;
    const int ncol = min(2 * (tile + 1), (s + 7) / 8);
    const int jlo = rel_lo(s, tile), njt = (s + 7) / 8 - jlo;
    const float* q = sq + warp * kTile * p.ld;
    const float* gr = sg + warp * kTile * p.ld;
    float* pd = spd + warp * kTile * p.lds;
    float* ds = sds + warp * kTile * p.lds;
    float* dqp = sdqp + warp * kTile * p.lds;
    float acc[kN][4];
    row_probs<kN, kBf>(p, a.scale, q, sk, krel_t, dqp, tile, ncol, acc);
    const uint32_t seed = *a.seed;
    const uint32_t rbits[2] = {row_bits(seed, unit * s + r0 + g),
                               row_bits(seed, unit * s + r0 + g + 8)};
    const int last = kTile * p.tiles - 1;

    // dP = G_t . V^T a group of column tiles at a time, masked by the
    // hash; p~ and the masked dP (held in ds until D is known) to the
    // CTA's planes.
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int g0 = 0; g0 < kN; g0 += kG) {
      if (g0 >= ncol) break;
      float hi[kG][4] = {}, lo[kG][4] = {};
      const float* vr[kG];
#pragma unroll
      for (int uu = 0; uu < kG; ++uu)
        vr[uu] = sv + min(8 * (g0 + uu) + g, last) * p.ld;
      for (int k0 = 0; k0 < p.dkp; k0 += 8) {
        float v[4];
        load_a(gr, p.ld, k0, v);
        Split fa;
        split4<kBf>(v, fa);
#pragma unroll
        for (int uu = 0; uu < kG; ++uu)
          mma3<kBf, kBf>(hi[uu], split_of<kN>() ? lo[uu] : hi[uu], fa,
                         vr[uu][k0 + t], vr[uu][k0 + t + 4]);
      }
#pragma unroll
      for (int uu = 0; uu < kG; ++uu) {
        float dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[e] = hi[uu][e] + lo[uu][e];
        keep_dp(p, a, rbits, g0 + uu, ncol, dp, acc[g0 + uu], pd, ds, dsum);
      }
    }
    score_grads<kN>(p, a.scale, r0, ncol, dsum, ds, dqp, acc);

    // dq_t = dS_t . K + dQP_t . krel_t, a chunk of columns at a time.
    In* dq = static_cast<In*>(a.out) + (long)unit * s * dk_in;
    constexpr int kC = chunk_of<kN>();
    for (int d0 = 0; d0 < p.dkp; d0 += 8 * kC) {
      ChunkT<kC> o;
      o.zero();
      if constexpr (split_of<kN>())
        c_product<kN, false, kBf>(acc, ncol, sk, p.ld, last, d0, o);
      else
        plane_product<kN, kBf>(ds, p.lds, ncol, sk, p.ld, last, d0, o);
      rel_dq<kN>(p, dqp, krel_t, jlo, njt, d0, o);
      float out_c[kC][4];
      o.sum(out_c);
      store_chunk(dq, r0, s, dk_in, d0, min(kC, (p.dkp - d0) / 8), out_c);
    }
  }
  __syncthreads();

  // Column side. Phase 1: partials of the m-tiles that other ranks finish,
  // stored into their exchange; phase 2: this rank's m-tiles, its partial
  // added to the others' in rank order.
  const int T = p.tiles;
  const int lo = rank * T / R, hi = (rank + 1) * T / R;
  const int nchunk = (p.dkp + 8 * kChunk - 1) / (8 * kChunk);
  const int frag = (p.dkp / 8) * 128;  // floats of one m-tile's partial
  if (R > 1) {
    cluster_arrive();  // this CTA's k, v and krel_t are free
    cluster_wait();
    const int jobs = (T - (hi - lo)) * 3;
    for (int j = warp; j < jobs; j += W) {
      const int mi = j / 3, x = j % 3;
      const int m = mi < lo ? mi : mi + (hi - lo);
      int owner = 0;
      while ((owner + 1) * T / R <= m) ++owner;
      const int src = rank < owner ? rank : rank - 1;
      float* slot = exch + ((src * p.mtiles + m - owner * T / R) * 3 + x) *
                               frag;
      for (int ch = 0; ch < nchunk; ++ch) {
        const int d0 = 8 * kChunk * ch;
        const int nt_end = min(kChunk, (p.dkp - d0) / 8);
        float o[kChunk][4];
        column_chunk<kBf>(p, rank, W, x == 0 ? sds : x == 1 ? spd : sdqp,
                          x == 1 ? sg : sq, x, m, d0, o);
#pragma unroll
        for (int nt = 0; nt < kChunk; ++nt)
          if (nt < nt_end)
            store_remote(slot + (kChunk * ch + nt) * 128 + lane * 4, owner,
                         o[nt]);
      }
    }
    cluster_arrive();
  }
  bool waited = R == 1;
  for (int j = warp; j < (hi - lo) * 3; j += W) {
    const int m = lo + j / 3, x = j % 3;
    const long at = (long)unit * s * dk_in;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int d0 = 8 * kChunk * ch;
      const int nt_end = min(kChunk, (p.dkp - d0) / 8);
      float o[kChunk][4];
      column_chunk<kBf>(p, rank, W, x == 0 ? sds : x == 1 ? spd : sdqp,
                        x == 1 ? sg : sq, x, m, d0, o);
      if (!waited) {
        cluster_wait();  // every rank's phase-1 stores have landed
        waited = true;
      }
      float sum[kChunk][4] = {};
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt) {
        if (nt >= nt_end) continue;
        for (int r = 0; r < R; ++r) {
          float v[4];
          if (r == rank) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = o[nt][e];
          } else {
            const int src = r < rank ? r : r - 1;
            const float4 w = *reinterpret_cast<const float4*>(
                exch + ((src * p.mtiles + m - lo) * 3 + x) * frag +
                (kChunk * ch + nt) * 128 + lane * 4);
            v[0] = w.x;
            v[1] = w.y;
            v[2] = w.z;
            v[3] = w.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[nt][e] = r == 0 ? v[e] : sum[nt][e] + v[e];
        }
      }
      if (x == 2)
        store_chunk(a.partial + at, kTile * m, s, dk_in, d0, nt_end, sum);
      else
        store_chunk(static_cast<In*>(x == 0 ? a.dk : a.dv) + at, kTile * m, s,
                    dk_in, d0, nt_end, sum);
    }
  }
  if (!waited) cluster_wait();
}

// --- the wide kernels: dk in chunks ------------------------------------------

enum : int { kStageK = 1, kStageV = 2, kStageQ = 4, kStageG = 8, kStageRel = 16 };

// Chunk c of dk (columns [c dc, c dc + dc)) of the operands in `what`, one
// CTA a unit, on the mbarrier's next phase (`parity`): K and V of the unit
// and the CTA's Q (and G) tiles by TMA boxes at column c dc (bf16: at the
// end of the rows they fill, then widened in place), Krelpos's rows [c dc, c
// dc + dc) by one bulk copy into `raw`, then transposed into krel_t (zeros
// past S and past dk). Every thread's reads of the last chunk end before
// the copies start.
template <bool kBwd, typename In>
__device__ __forceinline__ void stage_chunk(
    const AttnPlan& p, const AttnArgs& a, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_q,
    const CUtensorMap* map_g, uint64_t* bar, uint32_t parity, float* base,
    float* krel_t, float* raw, int unit, int c, int what) {
  const Boxes<In> b = unit_boxes<kBwd, In>(p, base);
  const int sp = kTile * p.tiles, x0 = c * p.dc;
  const int rel_rows = min(p.dc, p.dk_in - x0);
  // bf16: the last chunk's widened rows, written by this proxy, are where
  // the next boxes land
  if (is_bf16<In>()) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    int own = 0;
    for (int l = 0; l < b.warps; ++l) own += own_tile(0, 1, p.tiles, l) >= 0;
    const uint32_t row = b.row_bytes();
    uint32_t bytes = 0;
    if (what & kStageK) bytes += row * sp;
    if (what & kStageV) bytes += row * sp;
    if (what & kStageQ) bytes += row * kTile * own;
    if (what & kStageG) bytes += row * kTile * own;
    if (what & kStageRel) bytes += 4u * rel_rows * p.s;
    mbar_expect_tx(bar, bytes);
    if (what & kStageRel)
      bulk_copy(raw, a.krel + (long)x0 * p.s, 4u * rel_rows * p.s, bar);
    if (what & kStageK) tma_load_3d(b.dst_k(), map_k, bar, x0, 0, unit);
    if (what & kStageV) tma_load_3d(b.dst_v(), map_v, bar, x0, 0, unit);
    for (int l = 0; l < b.warps; ++l) {
      const int tile = own_tile(0, 1, p.tiles, l);
      if (tile < 0) continue;
      if (what & kStageQ)
        tma_load_3d(b.dst_q(l), map_q, bar, x0, kTile * tile, unit);
      if (what & kStageG)
        tma_load_3d(b.dst_g(l), map_g, bar, x0, kTile * tile, unit);
    }
  }
  mbar_wait(bar, parity);
  if constexpr (is_bf16<In>())
    if (what & (kStageK | kStageV | kStageQ | kStageG))
      widen<In>(b, what & 15, 0, 1, p.tiles);
  if (what & kStageRel) {
    const int lane = threadIdx.x & 31, warps_n = blockDim.x >> 5;
    for (int j0 = 8 * (threadIdx.x >> 5); j0 < sp; j0 += 8 * warps_n) {
      const int j = j0 + (lane & 7), jc = min(j, p.s - 1);
      for (int d = lane >> 3; d < p.ldr; d += 4) {
        const float v = raw[min(d, rel_rows - 1) * p.s + jc];
        krel_t[j * p.ldr + (d ^ swz(j))] = (j < p.s && d < rel_rows) ? v : 0.f;
      }
    }
  }
  if (is_bf16<In>() || (what & kStageRel)) __syncthreads();
}

__device__ __forceinline__ void init_bar(uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

template <int kMaxTiles, typename In>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_fwd_wide(const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ AttnArgs a) {
  constexpr int kN = 2 * kMaxTiles, kC = chunk_of<kN>();
  constexpr bool kBf = is_bf16<In>();
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnPlan& p = a.p;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* base = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* sk = base + p.f_k;
  float* sv = base + p.f_v;
  float* krel_t = base + p.f_krel;
  float* sq = base + p.f_q;
  float* raw = base + p.f_raw;
  const int unit = blockIdx.x, warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int s = p.s, last = kTile * p.tiles - 1;
  const int tile = own_tile(0, 1, p.tiles, warp);
  const int ncol = min(2 * (tile + 1), (s + 7) / 8);
  const int jlo = rel_lo(s, tile), njt = (s + 7) / 8 - jlo;
  const float* q = sq + warp * kTile * p.ld;
  float* qp = base + p.f_x + warp * kTile * p.lds;
  init_bar(bar);
  uint32_t phase = 0;

  // q.k and QP over the chunks of dk, in registers.
  float acc[kN][4] = {}, qpa[kN][4] = {};
  for (int c = 0; c < p.chunks; ++c) {
    stage_chunk<false, In>(p, a, &map_k, nullptr, &map_q, nullptr, bar,
                           phase++ & 1, base, krel_t, raw, unit, c,
                           kStageK | kStageQ | kStageRel);
    if (tile < 0) continue;
    const int cols = min(p.dc, p.dkp - c * p.dc);
    rows_product<kN, true, true, kBf>(q, p.ld, krel_t, p.ldr, last, cols, jlo,
                                      njt, qpa);
    rows_product<kN, false, true, kBf, kBf>(q, p.ld, sk, p.ld, last, cols, 0,
                                            ncol, acc);
  }
  if (tile >= 0) {
    store_qp<kN>(p, qp, jlo, njt, qpa);
    softmax_rows<kN>(p, a.scale, qp, tile, ncol, acc);
    const uint32_t seed = *a.seed;
    const int r0 = kTile * tile;
    const uint32_t rbits[2] = {row_bits(seed, unit * s + r0 + g),
                               row_bits(seed, unit * s + r0 + g + 8)};
    drop<kN>(a, ncol, rbits, acc);
    if constexpr (is_bf16<In>()) round_probs<kN>(ncol, acc);
  }

  // out_t = p~ . V, a chunk of dk at a time.
  In* out = static_cast<In*>(a.out) + (long)unit * s * p.dk_in;
  for (int c = 0; c < p.chunks; ++c) {
    stage_chunk<false, In>(p, a, nullptr, &map_v, nullptr, nullptr, bar,
                           phase++ & 1, base, nullptr, nullptr, unit, c,
                           kStageV);
    if (tile < 0) continue;
    const int x0 = c * p.dc, cols = min(p.dc, p.dkp - x0);
    for (int d0 = 0; d0 < cols; d0 += 8 * kC) {
      ChunkT<kC> o;
      o.zero();
      c_product<kN, kBf, kBf>(acc, ncol, sv, p.ld, last, d0, o);
      float out_c[kC][4];
      o.sum(out_c);
      store_chunk(out, kTile * tile, s, p.dk_in, x0 + d0,
                  min(kC, (cols - d0) / 8), out_c);
    }
  }
}

template <int kMaxTiles, typename In>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bwd_wide(const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ AttnArgs a) {
  constexpr int kN = 2 * kMaxTiles, kG = group_of<kN>(), kC = chunk_of<kN>();
  constexpr bool kBf = is_bf16<In>();
  static_assert(split_of<kN>(), "dq takes dS from registers");
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnPlan& p = a.p;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* base = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* sk = base + p.b_k;
  float* sv = base + p.b_v;
  float* krel_t = base + p.b_krel;
  float* sq = base + p.b_q;
  float* sg = base + p.b_g;
  float* spd = base + p.b_pd;
  float* sds = base + p.b_ds;
  float* sdqp = base + p.b_dqp;
  float* raw = base + p.b_raw;
  const int unit = blockIdx.x, W = p.bwd_warps, warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int s = p.s, dk_in = p.dk_in, last = kTile * p.tiles - 1;
  const int tile = own_tile(0, 1, p.tiles, warp);
  const int r0 = kTile * tile;
  const int ncol = min(2 * (tile + 1), (s + 7) / 8);
  const int jlo = rel_lo(s, tile), njt = (s + 7) / 8 - jlo;
  const float* q = sq + warp * kTile * p.ld;
  const float* gr = sg + warp * kTile * p.ld;
  float* pd = spd + warp * kTile * p.lds;
  float* ds = sds + warp * kTile * p.lds;
  float* dqp = sdqp + warp * kTile * p.lds;
  init_bar(bar);
  uint32_t phase = 0;

  // Row side: q.k, QP and dP = G_t . V^T over the chunks of dk.
  float acc[kN][4] = {}, qpa[kN][4] = {}, dpa[kN][4] = {};
  for (int c = 0; c < p.chunks; ++c) {
    stage_chunk<true, In>(p, a, &map_k, &map_v, &map_q, &map_g, bar,
                          phase++ & 1, base, krel_t, raw, unit, c,
                          kStageK | kStageV | kStageQ | kStageG | kStageRel);
    if (tile < 0) continue;
    const int cols = min(p.dc, p.dkp - c * p.dc);
    rows_product<kN, true, true, kBf>(q, p.ld, krel_t, p.ldr, last, cols, jlo,
                                      njt, qpa);
    rows_product<kN, false, true, kBf, kBf>(q, p.ld, sk, p.ld, last, cols, 0,
                                            ncol, acc);
    rows_product<kN, false, true, kBf, kBf>(gr, p.ld, sv, p.ld, last, cols, 0,
                                            ncol, dpa);
  }
  if (tile >= 0) {
    store_qp<kN>(p, dqp, jlo, njt, qpa);
    softmax_rows<kN>(p, a.scale, dqp, tile, ncol, acc);
    const uint32_t seed = *a.seed;
    const uint32_t rbits[2] = {row_bits(seed, unit * s + r0 + g),
                               row_bits(seed, unit * s + r0 + g + 8)};
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int g0 = 0; g0 < kN; g0 += kG) {
      if (g0 >= ncol) break;
#pragma unroll
      for (int uu = 0; uu < kG; ++uu)
        keep_dp(p, a, rbits, g0 + uu, ncol, dpa[g0 + uu], acc[g0 + uu], pd,
                ds, dsum);
    }
    score_grads<kN>(p, a.scale, r0, ncol, dsum, ds, dqp, acc);
  }

  // dq = dS . K + dQP . krel_t by rows, and dk = dS^T Q, dv = p~^T G and
  // the unit's dKrelpos^T = dQP^T Q by m-tiles, a chunk of dk at a time.
  In* dq = static_cast<In*>(a.out) + (long)unit * s * dk_in;
  for (int c = 0; c < p.chunks; ++c) {
    stage_chunk<true, In>(p, a, &map_k, nullptr, &map_q, &map_g, bar,
                          phase++ & 1, base, krel_t, raw, unit, c,
                          kStageK | kStageQ | kStageG | kStageRel);
    const int x0 = c * p.dc, cols = min(p.dc, p.dkp - x0);
    if (tile >= 0) {
      for (int d0 = 0; d0 < cols; d0 += 8 * kC) {
        ChunkT<kC> o;
        o.zero();
        c_product<kN, false, kBf>(acc, ncol, sk, p.ld, last, d0, o);
        rel_dq<kN>(p, dqp, krel_t, jlo, njt, d0, o);
        float out_c[kC][4];
        o.sum(out_c);
        store_chunk(dq, r0, s, dk_in, x0 + d0, min(kC, (cols - d0) / 8),
                    out_c);
      }
    }
    for (int j = warp; j < p.tiles * 3; j += W) {
      const int m = j / 3, x = j % 3;
      const long at = (long)unit * s * dk_in;
      for (int d0 = 0; d0 < cols; d0 += 8 * kChunk) {
        float o[kChunk][4];
        column_chunk<kBf>(p, 0, W, x == 0 ? sds : x == 1 ? spd : sdqp,
                          x == 1 ? sg : sq, x, m, d0, o);
        const int nt_end = min(kChunk, (cols - d0) / 8);
        if (x == 2)
          store_chunk(a.partial + at, kTile * m, s, dk_in, x0 + d0, nt_end, o);
        else
          store_chunk(static_cast<In*>(x == 0 ? a.dk : a.dv) + at, kTile * m,
                      s, dk_in, x0 + d0, nt_end, o);
      }
    }
  }
}

// dkrel[d, j] = sum over units of partial[n, j, d], units in order.
__global__ void relpos_grad_sum(const float* __restrict__ partial,
                                float* __restrict__ dkrel, int N, int S,
                                int dk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * dk) return;
  const int j = i / dk, d = i % dk;
  float acc = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) acc += partial[((long)n * S + j) * dk + d];
  dkrel[d * S + j] = acc;
}

// A (N, S, dk_in) tensor read in boxes of `rows` rows: fp32 ones ld floats
// wide, bf16 ones dc values wide (dk_in a multiple of 8: 16-byte strides);
// columns past dk_in and rows past S come as zeros.
template <typename In>
cudaError_t unit_map(CUtensorMap* map, const In* ptr, const AttnPlan& p,
                     int rows) {
  cpc2::EncodeTiledFn encode = cpc2::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t kSize = sizeof(In);
  const cuuint64_t dims[3] = {(cuuint64_t)p.dk_in, (cuuint64_t)p.s,
                              (cuuint64_t)p.n};
  const cuuint64_t strides[2] = {(cuuint64_t)p.dk_in * kSize,
                                 (cuuint64_t)p.dk_in * p.s * kSize};
  const cuuint32_t box[3] = {(cuuint32_t)(is_bf16<In>() ? p.dc : p.ld),
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, is_bf16<In>() ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<In*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The plan of the fp32 (io 0) or bf16 (io 1) kernels, if it holds.
bool read_plan(const int* ints, int n_ints, bool backward, int io,
               AttnPlan* p) {
  if (ints == nullptr || n_ints != kPlanInts) return false;
  *p = *reinterpret_cast<const AttnPlan*>(ints);
  return p->io == io && plan_ok(*p, backward);
}

typedef void (*FwdKernel)(CUtensorMap, CUtensorMap, CUtensorMap, AttnArgs);
typedef void (*BwdKernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          AttnArgs);

// The plan's kernels: the wide ones (one instantiation) where dk comes in
// chunks.
template <typename In>
FwdKernel fwd_kernel(const AttnPlan& p) {
  return p.chunks > 1         ? attention_fwd_wide<4, In>
         : p.max_tiles == 4   ? attention_fwd_mma<4, In>
         : p.max_tiles == 8   ? attention_fwd_mma<8, In>
                              : attention_fwd_mma<12, In>;
}
template <typename In>
BwdKernel bwd_kernel(const AttnPlan& p) {
  return p.chunks > 1         ? attention_bwd_wide<4, In>
         : p.max_tiles == 4   ? attention_bwd_mma<4, In>
         : p.max_tiles == 8   ? attention_bwd_mma<8, In>
                              : attention_bwd_mma<12, In>;
}

// The forward as the plan lays it out.
template <typename In>
int attention_fwd(const In* q, const In* k, const In* v, const float* krel,
                  const unsigned* seed, In* out, const int* plan, int n_plan,
                  unsigned threshold, float keep_scale, float scale,
                  cudaStream_t stream) {
  AttnArgs a{};
  if (!read_plan(plan, n_plan, false, is_bf16<In>(), &a.p))
    return (int)cudaErrorInvalidValue;
  const AttnPlan& p = a.p;
  if (p.n == 0) return 0;
  a.krel = krel;
  a.seed = seed;
  a.out = out;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.scale = scale;
  CUtensorMap mk{}, mv{}, mq{};
  cudaError_t err = unit_map(&mk, k, p, kTile * p.tiles);
  if (err == cudaSuccess) err = unit_map(&mv, v, p, kTile * p.tiles);
  if (err == cudaSuccess) err = unit_map(&mq, q, p, kTile);
  if (err != cudaSuccess) return (int)err;
  FwdKernel fn = fwd_kernel<In>(p);
  err = cpc2::set_smem((const void*)fn, p.fwd_smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<p.n * p.fwd_ctas, 32 * p.fwd_warps, p.fwd_smem, stream>>>(mk, mv, mq,
                                                                  a);
  return (int)cudaGetLastError();
}

// The backward as the plan lays it out (see attention_fwd for the maps).
template <typename In>
int attention_bwd(const In* q, const In* k, const In* v, const float* krel,
                  const unsigned* seed, const In* g, In* dq, In* dk_out,
                  In* dv, float* partial, float* dkrel, const int* plan,
                  int n_plan, unsigned threshold, float keep_scale,
                  float scale, cudaStream_t s) {
  AttnArgs a{};
  if (!read_plan(plan, n_plan, true, is_bf16<In>(), &a.p))
    return (int)cudaErrorInvalidValue;
  const AttnPlan& p = a.p;
  if (p.n == 0) return 0;
  a.krel = krel;
  a.seed = seed;
  a.out = dq;
  a.dk = dk_out;
  a.dv = dv;
  a.partial = partial;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.scale = scale;
  CUtensorMap mk{}, mv{}, mq{}, mg{};
  cudaError_t err = unit_map(&mk, k, p, kTile * p.tiles);
  if (err == cudaSuccess) err = unit_map(&mv, v, p, kTile * p.tiles);
  if (err == cudaSuccess) err = unit_map(&mq, q, p, kTile);
  if (err == cudaSuccess) err = unit_map(&mg, g, p, kTile);
  if (err != cudaSuccess) return (int)err;
  BwdKernel fn = bwd_kernel<In>(p);
  err = cpc2::set_smem((const void*)fn, p.bwd_smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr{};
  cfg.gridDim = dim3(p.n * p.bwd_ctas);
  cfg.blockDim = dim3(32 * p.bwd_warps);
  cfg.dynamicSmemBytes = p.bwd_smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.bwd_ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, mk, mv, mq, mg, a);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  relpos_grad_sum<<<(p.s * p.dk_in + 255) / 256, 256, 0, s>>>(
      partial, dkrel, p.n, p.s, p.dk_in);
  return (int)cudaGetLastError();
}

}  // namespace
