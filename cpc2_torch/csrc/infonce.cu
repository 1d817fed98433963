// InfoNCE negative scoring, forward and backward, for Hopper (sm_90a):
//   neg[b, k, w, n] = preds[b, k, w, :] . z[idx[b, w, n], :]
//   dpreds[b, k, w, :] = sum_n g[b, k, w, n] z[idx[b, w, n], :]
//   dz[p, :] = sum over (b, w, n) with idx[b, w, n] = p of
//              sum_k g[b, k, w, n] preds[b, k, w, :]
//
// Replaces the TPU kernels of cpc2_tpu/ops/infonce_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`). Those keep the whole (P, D) pool in VMEM and select the
// sampled rows with one-hot matmuls, so their cost grows with P. Here a unit
// of work is one (b, w): its N sampled pool rows are gathered, and nothing
// depends on P but the dz tiles.
//
// What bounds it. 2*B*K*W*N*D FLOPs (0.73 GFLOP forward at the recipe,
// B = 8, K = 12, W = 116, N = 128, D = 256, P = 1024) over about 19 MB of
// device memory traffic; but the gather is compulsory traffic from L2: each
// unit reads its own N rows, 121.6 MB a call (the 1 MB pool stays in L2).
// So the design keeps the gather off the threads and the math off the FMA
// pipes:
//
// - Forward and dpreds (`gathered_fwd`, `dpreds_role`): a persistent grid
//   of one CTA per SM walks the units. Producer warps stage each unit's
//   rows, a block of rb rows (and a chunk of D columns) at a time, with 1-D
//   bulk async copies (`cp.async.bulk ... mbarrier::complete_tx`), one per
//   gathered row, into a ring of shared-memory stages guarded by full and
//   empty mbarriers, so copies for the next block or unit are in flight
//   while eight consumer warps compute on the current one. On an H100 a
//   bulk copy takes the same time whatever its size, up to 1 KB at least
//   (PERF.md, §6), so the copies are as large as the rows allow (whole rows
//   of D floats where a stage holds them), and two producer warps issue
//   them; the producers load a chunk of 256 indices before issuing any
//   copy, since each copy's address depends on one.
// - The products run on the tensor cores, `mma.sync.m16n8k8` in TF32 with
//   the 3xTF32 split: each fp32 operand x = big + small, big = x rounded to
//   TF32, small = x - big read as TF32 (`split_tf32`), and acc += small*big
//   + big*small + big*big with fp32 accumulators. Each product then errs by
//   under 2.5 * 2^-21 of |a b| (small's truncation twice, the dropped
//   small*small once), about 1.2e-6, against 2^-24 for an fp32 FMA: at the
//   recipe the kernels agree with the fp32 plain version to about 1e-6 of
//   the largest value, inside the fp32 tolerance (atol 1e-5 + rtol 1e-4) of
//   `chip_smoke.py`. Single-pass TF32 or bf16 is never used. The forward puts
//   the gathered rows on the M side, scores^T = Zg (N x D) . P^T (D x K),
//   and dpreds is G (K x N) . Zg (N x D); no output needs a warp-shuffle
//   reduction, and each operand element is read from shared memory once a
//   warp. Row strides are padded so that fragment loads are free of bank
//   conflicts (4 mod 32 floats for row-indexed fragments, 8 mod 32 for the
//   column-indexed one). Even and odd k steps (and, in the forward, each of
//   the three terms) go to separate accumulators, summed at the end in a
//   fixed order, so that independent mma chains hide their latency.
// - dz (`dz_role`), deterministic and without atomics or a memset: a CTA
//   owns a tile of PT pool rows and a slice of D, keeps their sum in shared
//   memory, and walks a contiguous run of units in ascending order with the
//   same producer ring (idx chunk, g block, preds block of each unit). For
//   each sampled row that falls in its tile, in ascending n, it adds
//   sum_k g[k, n] * preds[k, slice] (each warp lists its sampled rows of a
//   unit first, then computes four at once and adds them in order); each
//   thread owns fixed (row, column) entries, so every sum has a fixed
//   order. Only the sampled entries are touched: the sparse 0.73 GFLOP, not
//   the TPU's dense 5.8. The units are split over several CTAs a tile to
//   fill the card; each writes a partial, and a second launch sums them in
//   ascending split order.
// - Grouped pools (`--neg_pool_group`): where each batch element samples
//   only its group's rows (G contiguous elements' G * P / B rows), the dz
//   tiles cover each group's rows apart, no tile straddling two groups, and
//   a tile's splits share only its group's G * W units. A dz CTA then walks
//   G * W / splits units, not B * W / splits: at B = 64 in groups of 8 that
//   is 464 units, not 3,712. The forward and dpreds gather any row anyway.
//   One group is the whole pool's plan.
//
// Any shape: K in groups of KP (16 or 32) prediction rows, N in chunks of
// 256 sampled rows, D in chunks (forward, dpreds) and slices (dz) that fit
// a stage; each is one more item of the walk, and at the recipe every unit
// is one group, one chunk and one slice. D must be a multiple of 4 and the
// backward's N too (16-byte copies of rows); the host pads the others.
//
// The backward is two launches: dpreds CTAs and dz CTAs side by side in one
// grid, then the partials' sum. The launch plan (row blocks, chunks, strides,
// stage sizes, stages, grids, tiles, shared memory) comes from the host
// (`cpc2_torch/ops/infonce.py:infonce_plan`); the entry points refuse a plan
// whose stages or shared memory do not hold what the kernels put there.
#include "hopper_gemm.cuh"

namespace {

using cpc2::bulk_copy;
using cpc2::mbar_arrive;
using cpc2::mbar_expect_tx;
using cpc2::mbar_init;
using cpc2::mbar_wait;
using cpc2::mma_tf32;
using cpc2::smem_u32;
using cpc2::split_tf32;

constexpr int kWarps = 8;          // consumer warps
constexpr int kProducerWarps = 2;  // faster than one, and four no faster
constexpr int kThreads = (kWarps + kProducerWarps) * 32;
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full and empty barriers
constexpr int kChunkN = 256;  // sampled rows a chunk, 8 a producer lane
// (m16 tile, n8 tile) pairs of a forward row block a consumer warp takes at
// most: rb / 16 * KP / 8 <= kPairSlots * kWarps.
constexpr int kPairSlots = 2;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The host's plan. Forward stage: rb gathered rows, then KP prediction rows,
// each `stride` floats, dc columns of D a stage. dpreds stage: rb gathered
// rows of a dc-wide chunk at `zs`, then KP rows of g's rb columns at `gs`.
// dz stage: the unit's chunk of at most nc indices, KR = min(K, KP) rows of
// g at stride nc, KR rows of the preds slice at stride dzc; after the ring,
// the (pt, dzc) accumulator and each consumer warp's list of nc sampled
// rows. dz tiles: group_tiles tiles of pt rows over each group's group_rows
// pool rows, row_tiles of them in all; a tile's splits share its group's
// group_units units.
struct FwdPlan {
  int rb, dc, stride, stage, stages;
};
struct DpPlan {
  int rb, dc, zs, gs, stage, stages, ctas;
};
struct DzPlan {
  int nc, dzc, stage, stages, pt, row_tiles, col_slices, splits;
  int group_rows, group_units, group_tiles;
};

// dz threads: each owns CPT contiguous columns (64 / KP, so that its
// prediction values fit in registers; one vector load or store) of the rows
// of one row group; TPR threads (a power of two, at least a warp) cover the
// slice's dzc columns, and the 256 consumer threads make 256 / TPR row
// groups.
template <int CPT> struct Vec;
template <> struct Vec<4> { typedef float4 T; };
template <> struct Vec<2> { typedef float2 T; };
__host__ __device__ inline int dz_tpr(int dzc, int cpt) {
  int tpr = 32;
  while (tpr * cpt < dzc) tpr *= 2;
  return tpr;
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  float* data;
  int stages;
  int stage_floats;
};

// Barriers at the front of shared memory, the ring after them; the ring is
// zeroed once, so padding that no copy writes reads as 0. A stage's full
// barrier completes when its copies' bytes have landed, its empty barrier
// when every consumer warp has released it.
__device__ Ring ring_setup(unsigned char* smem, int stages, int stage_floats) {
  Ring r;
  r.full = reinterpret_cast<uint64_t*>(smem);
  r.empty = r.full + kMaxStages;
  r.data = reinterpret_cast<float*>(smem + kBarrierBytes);
  r.stages = stages;
  r.stage_floats = stage_floats;
  for (long i = threadIdx.x; i < (long)stages * stage_floats; i += blockDim.x)
    r.data[i] = 0.f;
  // the zeros (generic proxy) before any bulk copy (async proxy) lands
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producers' side of item `it`: wait until the stage is free and return
// it; `arm` (producer warp 0, after any zero-filling of the stage) sets the
// bytes that the producers' copies will bring, whose completion completes
// the full barrier.
__device__ __forceinline__ float* producer_acquire(const Ring& r, int it) {
  const int s = it % r.stages;
  mbar_wait(&r.empty[s], ((it / r.stages) & 1) ^ 1);
  return r.data + (long)s * r.stage_floats;
}
__device__ __forceinline__ void producer_arm(const Ring& r, int it,
                                             uint32_t bytes) {
  __syncwarp();
  if (threadIdx.x == kWarps * 32)
    mbar_expect_tx(&r.full[it % r.stages], bytes);
}
__device__ __forceinline__ const float* consumer_acquire(const Ring& r,
                                                         int it) {
  const int s = it % r.stages;
  mbar_wait(&r.full[s], (it / r.stages) & 1);
  return r.data + (long)s * r.stage_floats;
}
__device__ __forceinline__ void consumer_release(const Ring& r, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[it % r.stages]);
}

// Zeros written by a producer warp into a stage before its copies: ordered
// before any later bulk copy into the same stage.
__device__ __forceinline__ void fence_zeros() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A chunk of at most kChunkN pool rows into registers, lane l holding rows
// l, l + 32, ..., all loads issued before any is used.
__device__ __forceinline__ void load_rows(int* rows_u, const int* idx_c,
                                          int nrows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kChunkN / 32; ++q)
    rows_u[q] = q * 32 + lane < nrows ? idx_c[q * 32 + lane] : 0;
}

// Bulk copies of a chunk's gathered rows [r0, r0 + nr), bytes `bytes` from
// column offset d0, to dst + (r - r0) * stride: row q * 32 + lane by the
// lane of producer warp q mod kProducerWarps.
__device__ __forceinline__ void copy_gathered(const int* rows_u, int r0,
                                              int nr, const float* z, int D,
                                              int d0, int bytes, float* dst,
                                              int stride, uint64_t* bar) {
  const int pw = threadIdx.x / 32 - kWarps, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kChunkN / 32; ++q) {
    const int r = q * 32 + lane;
    if (q % kProducerWarps == pw && r >= r0 && r < r0 + nr)
      bulk_copy(dst + (r - r0) * stride, z + (long)rows_u[q] * D + d0, bytes,
                bar);
  }
}

// The forward's operands of the k step at k0: A (gathered rows g, g + 8 at
// columns t, t + 4), B (prediction row g at columns t, t + 4); and its
// three products, each into its own accumulator of acc[3][4], so that no
// product of a step waits for another.
__device__ __forceinline__ void fwd_load(float* v, const float* a,
                                         const float* bq, int rs, int k0) {
  v[0] = a[k0];
  v[1] = a[8 * rs + k0];
  v[2] = a[k0 + 4];
  v[3] = a[8 * rs + k0 + 4];
  v[4] = bq[k0];
  v[5] = bq[k0 + 4];
}
__device__ __forceinline__ void fwd_mma(float (*acc)[4], const float* v) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], ab[e], as[e]);
  split_tf32(v[4], bb[0], bs[0]);
  split_tf32(v[5], bb[1], bs[1]);
  mma_tf32(acc[0], as, bb);
  mma_tf32(acc[1], ab, bs);
  mma_tf32(acc[2], ab, bb);
}

// ---------------------------------------------------------------------------
// Forward: out[b, k, w, n] for the units blockIdx.x, + gridDim.x, ...; a
// unit's items are (group of KP predictions, block of rb gathered rows,
// chunk of dc columns), the block's sums carried across its chunks. Each
// consumer warp takes (m16 tile, n8 tile) pairs of the block's scores^T.
// ---------------------------------------------------------------------------
template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
gathered_fwd(const float* __restrict__ preds, const float* __restrict__ z,
             const int* __restrict__ idx, float* __restrict__ out, int B,
             int K, int W, int N, int D, FwdPlan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rb = pl.rb, rs = pl.stride;
  const Ring ring = ring_setup(smem, pl.stages, pl.stage);
  const int units = B * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kWarps) {  // producers
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / W, w = u % W;
      for (int k0 = 0; k0 < K; k0 += KP) {
        const int kg = min(KP, K - k0);
        for (int c0 = 0; c0 < N; c0 += kChunkN) {
          const int c1 = min(N, c0 + kChunkN);
          int rows_u[kChunkN / 32];
          load_rows(rows_u, idx + (long)u * N + c0, c1 - c0);
          for (int r0 = c0; r0 < c1; r0 += rb) {
            const int nr = min(rb, c1 - r0);
            for (int d0 = 0; d0 < D; d0 += pl.dc, ++it) {
              const int cw = min(pl.dc, D - d0), cw8 = round_up(cw, 8);
              float* st = producer_acquire(ring, it);
              // a last chunk not a multiple of 8 wide: its padding columns
              // hold an earlier chunk's data
              if (cw8 != cw && warp == kWarps) {
                for (int i = lane; i < (rb + KP) * (cw8 - cw); i += 32)
                  st[i / (cw8 - cw) * rs + cw + i % (cw8 - cw)] = 0.f;
                fence_zeros();
              }
              uint64_t* bar = &ring.full[it % ring.stages];
              producer_arm(ring, it, (uint32_t)(nr + kg) * cw * 4);
              copy_gathered(rows_u, r0 - c0, nr, z, D, d0, cw * 4, st, rs,
                            bar);
              if (warp == kWarps + kProducerWarps - 1 && lane < kg)
                bulk_copy(st + (rb + lane) * rs,
                          preds + (((long)b * K + k0 + lane) * W + w) * D + d0,
                          cw * 4, bar);
            }
          }
        }
      }
    }
    return;
  }

  constexpr int KT = KP / 8;  // n8 tiles over the KP predictions
  const int g = lane >> 2, t = lane & 3;
  const int pairs = rb / 16 * KT;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b = u / W, w = u % W;
    for (int k0 = 0; k0 < K; k0 += KP) {
      const int kg = min(KP, K - k0);
      for (int r0 = 0; r0 < N; r0 += rb) {
        // blocks never straddle a chunk of kChunkN rows: rb divides it
        // acc[i][parity][term]: a warp's pairs i (at most kPairSlots), the
        // k step's parity, small*big, big*small, big*big
        float acc[kPairSlots][2][3][4] = {};
        for (int d0 = 0; d0 < D; d0 += pl.dc, ++it) {
          const int cw8 = round_up(min(pl.dc, D - d0), 8);
          const float* st = consumer_acquire(ring, it);
#pragma unroll
          for (int i = 0; i < kPairSlots; ++i) {
            const int pr = warp + i * kWarps;
            if (pr >= pairs) break;
            const int mt = pr / KT, j = pr % KT;
            const float* a = st + (mt * 16 + g) * rs + t;
            const float* bq = st + (rb + j * 8 + g) * rs + t;
            // the next k step's operands are loaded before this step's
            // products, with no branch in the loop; the last one or two
            // steps after it
            float cur[6], nxt[6];
            fwd_load(cur, a, bq, rs, 0);
            int k1 = 0;
            for (; k1 + 16 < cw8; k1 += 16) {
              fwd_load(nxt, a, bq, rs, k1 + 8);
              fwd_mma(acc[i][0], cur);
              fwd_load(cur, a, bq, rs, k1 + 16);
              fwd_mma(acc[i][1], nxt);
            }
            if (k1 + 8 < cw8) fwd_load(nxt, a, bq, rs, k1 + 8);
            fwd_mma(acc[i][0], cur);
            if (k1 + 8 < cw8) fwd_mma(acc[i][1], nxt);
          }
          consumer_release(ring, it);
        }
#pragma unroll
        for (int i = 0; i < kPairSlots; ++i) {
          const int pr = warp + i * kWarps;
          if (pr >= pairs) break;
          const int mt = pr / KT, j = pr % KT;
          const float(*a)[3][4] = acc[i];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = r0 + mt * 16 + g + (e >> 1) * 8;
            const int k = j * 8 + 2 * t + (e & 1);
            if (n < min(N, r0 + rb) && k < kg)
              out[(((long)b * K + k0 + k) * W + w) * N + n] =
                  ((a[0][0][e] + a[1][0][e]) + (a[0][1][e] + a[1][1][e])) +
                  (a[0][2][e] + a[1][2][e]);
          }
        }
      }
    }
  }
}

// dpreds' operands of the k step at k0: A from the g rows (ga: row g,
// column t) for every m16 tile, B from the gathered rows (zb: row t, column
// g) for the warp's n8 tiles nt = warp, warp + kWarps, ... below ntiles; and
// its products into the accumulators of parity PAR.
template <int MT>
struct DpOperands {
  float a[MT][4];
  float b[4][2];
};
template <int MT>
__device__ __forceinline__ void dp_load(DpOperands<MT>& v, const float* ga,
                                        int gs, const float* zb, int rs,
                                        int warp, int ntiles, int k0) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* ap = ga + m * 16 * gs + k0;
    v.a[m][0] = ap[0];
    v.a[m][1] = ap[8 * gs];
    v.a[m][2] = ap[4];
    v.a[m][3] = ap[8 * gs + 4];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nt = warp + i * kWarps;
    if (nt >= ntiles) break;
    v.b[i][0] = zb[k0 * rs + nt * 8];
    v.b[i][1] = zb[(k0 + 4) * rs + nt * 8];
  }
}
template <int MT, int PAR>
__device__ __forceinline__ void dp_mma(float (*acc)[4][2][4],
                                       const DpOperands<MT>& v, int warp,
                                       int ntiles) {
  uint32_t ab[MT][4], as[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v.a[m][e], ab[m][e], as[m][e]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (warp + i * kWarps >= ntiles) break;
    uint32_t bb[2], bs[2];
    split_tf32(v.b[i][0], bb[0], bs[0]);
    split_tf32(v.b[i][1], bb[1], bs[1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma_tf32(acc[m][i][PAR], as[m], bb);
      mma_tf32(acc[m][i][PAR], ab[m], bs);
      mma_tf32(acc[m][i][PAR], ab[m], bb);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dpreds CTAs: dpreds[b, group, w, chunk] = G (KP x N) . Zg (N x
// chunk); a unit's items are (group of KP predictions, dc-wide chunk, block
// of rb rows), the chunk's sum carried across its row blocks. Each consumer
// warp takes the n8 tiles warp, warp + 8, ...
// ---------------------------------------------------------------------------
template <int KP>
__device__ void dpreds_role(unsigned char* smem, int cta,
                            const float* __restrict__ g_in,
                            const float* __restrict__ z,
                            const int* __restrict__ idx,
                            float* __restrict__ dpreds, int B, int K, int W,
                            int N, int D, const DpPlan& pl) {
  const int rb = pl.rb, rs = pl.zs, gs = pl.gs;
  const Ring ring = ring_setup(smem, pl.stages, pl.stage);
  const int units = B * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kWarps) {  // producers
    int it = 0;
    for (int u = cta; u < units; u += pl.ctas) {
      const int b = u / W, w = u % W;
      for (int k0 = 0; k0 < K; k0 += KP) {
        const int kg = min(KP, K - k0);
        for (int d0 = 0; d0 < D; d0 += pl.dc) {
          const int cw = min(pl.dc, D - d0), cw8 = round_up(cw, 8);
          for (int c0 = 0; c0 < N; c0 += kChunkN) {
            const int c1 = min(N, c0 + kChunkN);
            int rows_u[kChunkN / 32];
            load_rows(rows_u, idx + (long)u * N + c0, c1 - c0);
            for (int r0 = c0; r0 < c1; r0 += rb, ++it) {
              float* st = producer_acquire(ring, it);
              const int nr = min(rb, c1 - r0), nr8 = round_up(nr, 8);
              float* gb = st + rb * rs;
              // a last block of rows not a multiple of 8: its padding rows
              // of Zg and columns of G hold an earlier block's data
              if (nr8 != nr && warp == kWarps) {
                for (int i = lane; i < (nr8 - nr) * cw8; i += 32)
                  st[(nr + i / cw8) * rs + i % cw8] = 0.f;
                for (int i = lane; i < (nr8 - nr) * KP; i += 32)
                  gb[(i / (nr8 - nr)) * gs + nr + i % (nr8 - nr)] = 0.f;
                fence_zeros();
              }
              uint64_t* bar = &ring.full[it % ring.stages];
              producer_arm(ring, it, (uint32_t)(nr * cw + kg * nr) * 4);
              copy_gathered(rows_u, r0 - c0, nr, z, D, d0, cw * 4, st, rs,
                            bar);
              if (warp == kWarps + kProducerWarps - 1 && lane < kg)
                bulk_copy(gb + lane * gs,
                          g_in + (((long)b * K + k0 + lane) * W + w) * N + r0,
                          nr * 4, bar);
            }
          }
        }
      }
    }
    return;
  }

  constexpr int MT = KP / 16;  // m16 tiles over the KP predictions
  const int g = lane >> 2, t = lane & 3;
  int it = 0;
  for (int u = cta; u < units; u += pl.ctas) {
    const int b = u / W, w = u % W;
    for (int k0 = 0; k0 < K; k0 += KP) {
      const int kg = min(KP, K - k0);
      for (int d0 = 0; d0 < D; d0 += pl.dc) {
        const int cw = min(pl.dc, D - d0), ntiles = (cw + 7) / 8;
        // acc[m][i][parity]
        float acc[MT][4][2][4] = {};
        for (int r0 = 0; r0 < N; r0 += rb, ++it) {
          const float* st = consumer_acquire(ring, it);
          const float* ga = st + rb * rs + g * gs + t;
          const float* zb = st + t * rs + g;
          const int nr8 = round_up(min(rb, N - r0), 8);
          // the next k step's operands are loaded before this step's
          // products, with no branch in the loop; the last one or two
          // steps after it
          DpOperands<MT> cur, nxt;
          dp_load(cur, ga, gs, zb, rs, warp, ntiles, 0);
          int k1 = 0;
          for (; k1 + 16 < nr8; k1 += 16) {
            dp_load(nxt, ga, gs, zb, rs, warp, ntiles, k1 + 8);
            dp_mma<MT, 0>(acc, cur, warp, ntiles);
            dp_load(cur, ga, gs, zb, rs, warp, ntiles, k1 + 16);
            dp_mma<MT, 1>(acc, nxt, warp, ntiles);
          }
          if (k1 + 8 < nr8) dp_load(nxt, ga, gs, zb, rs, warp, ntiles, k1 + 8);
          dp_mma<MT, 0>(acc, cur, warp, ntiles);
          if (k1 + 8 < nr8) dp_mma<MT, 1>(acc, nxt, warp, ntiles);
          consumer_release(ring, it);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nt = warp + i * kWarps;
            if (nt >= ntiles) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = m * 16 + g + (e >> 1) * 8;
              const int d = nt * 8 + 2 * t + (e & 1);
              if (k < kg && d < cw)
                dpreds[(((long)b * K + k0 + k) * W + w) * D + d0 + d] =
                    acc[m][i][0][e] + acc[m][i][1][e];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dz CTAs: row tile rt, the tile t = rt % group_tiles of pool group
// pg = rt / group_tiles, holds pool rows [pg * group_rows + t * pt, + pt)
// (not past its group's last row) and columns [cs * dzc, + dzc), over units
// [u0, u1) of its group's; items (group of KP predictions, chunk of kChunkN
// sampled rows, unit), the unit fastest, so that the prediction group's and
// chunk's bounds are invariant in the unit loop (with the unit outside, the
// dz CTAs were slower at the recipe). Writes the tile into rows
// [rt * pt, + pt) of this split's partial.
// ---------------------------------------------------------------------------
template <int KP>
__device__ void dz_role(unsigned char* smem, int tile, int split,
                        const float* __restrict__ g_in,
                        const float* __restrict__ preds,
                        const int* __restrict__ idx,
                        float* __restrict__ partial, int B, int K, int W,
                        int N, int D, int P, const DzPlan& pl) {
  constexpr int CPT = 64 / KP;
  constexpr int kBatch = 4;  // sampled rows computed at once
  const int nc = pl.nc, dzc = pl.dzc, pt = pl.pt, kr = min(K, KP);
  const Ring ring = ring_setup(smem, pl.stages, pl.stage);
  float* acc = ring.data + (long)pl.stages * pl.stage;  // (pt, dzc)
  const int rt = tile / pl.col_slices, pg = rt / pl.group_tiles;
  const int gu = pl.group_units, ub = pg * gu;
  const int u0 = ub + (int)((long)split * gu / pl.splits);
  const int u1 = ub + (int)((long)(split + 1) * gu / pl.splits);
  const int row0 = pg * pl.group_rows + rt % pl.group_tiles * pt;
  const int d0 = tile % pl.col_slices * dzc, cwz = min(dzc, D - d0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kWarps) {  // producers: one copy a row, by the lanes
    int it = 0;
    for (int k0 = 0; k0 < K; k0 += KP) {
      const int kg = min(KP, K - k0);
      for (int c0 = 0; c0 < N; c0 += kChunkN) {
        const int ncc = min(kChunkN, N - c0);
        for (int u = u0; u < u1; ++u, ++it) {
          const int b = u / W, w = u % W;
          float* st = producer_acquire(ring, it);
          uint64_t* bar = &ring.full[it % ring.stages];
          producer_arm(ring, it, (uint32_t)(ncc + kg * ncc + kg * cwz) * 4);
          for (int r = (warp - kWarps) * 32 + lane; r < 1 + 2 * kg;
               r += kProducerWarps * 32) {
            if (r == 0) {
              bulk_copy(st, idx + (long)u * N + c0, ncc * 4, bar);
            } else if (r <= kg) {
              const long row = ((long)b * K + k0 + r - 1) * W + w;
              bulk_copy(st + nc + (r - 1) * nc, g_in + row * N + c0, ncc * 4,
                        bar);
            } else {
              const long row = ((long)b * K + k0 + r - 1 - kg) * W + w;
              bulk_copy(st + nc + kr * nc + (r - 1 - kg) * dzc,
                        preds + row * D + d0, cwz * 4, bar);
            }
          }
        }
      }
    }
    return;
  }

  typedef typename Vec<CPT>::T VT;
  const int tpr = dz_tpr(dzc, CPT), rg = kWarps * 32 / tpr;
  const int group = threadIdx.x / tpr, col = threadIdx.x % tpr * CPT;
  const bool mine = col < cwz;
  int* list = reinterpret_cast<int*>(acc + (long)pt * dzc) + warp * nc;
  for (int r = group; r < pt; r += rg)
    if (mine) *reinterpret_cast<VT*>(acc + r * dzc + col) = VT{};
  const int valid = min(pt, (pg + 1) * pl.group_rows - row0);
  int it = 0;
  for (int k0 = 0; k0 < K; k0 += KP) {
    const int kg = min(KP, K - k0);
    for (int c0 = 0; c0 < N; c0 += kChunkN) {
      const int ncc = min(kChunkN, N - c0);
      for (int u = u0; u < u1; ++u, ++it) {
        const float* st = consumer_acquire(ring, it);
        const int* idx_s = reinterpret_cast<const int*>(st);
        const float* gs = st + nc;
        const float* ps = st + nc + kr * nc;
        // the warp's sampled rows in this tile, ascending n, as n | row << 8
        int count = 0, rows_n[kChunkN / 32];
#pragma unroll
        for (int q = 0; q < kChunkN / 32; ++q)
          rows_n[q] = q * 32 + lane < ncc ? idx_s[q * 32 + lane] - row0 : -1;
#pragma unroll
        for (int q = 0; q < kChunkN / 32; ++q) {
          if (q * 32 >= ncc) break;
          const int r = rows_n[q];
          const bool hit = r >= 0 && r < valid && (r & (rg - 1)) == group;
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (hit)
            list[count + __popc(mask & ((1u << lane) - 1))] =
                q * 32 + lane | r << 8;
          count += __popc(mask);
        }
        __syncwarp();
        float pr[KP][CPT];
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k >= kg) break;
          const VT p = mine ? *reinterpret_cast<const VT*>(ps + k * dzc + col)
                            : VT{};
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            pr[k][j] = reinterpret_cast<const float*>(&p)[j];
        }
        for (int h0 = 0; h0 < count; h0 += kBatch) {  // kBatch rows at once
          int jn[kBatch], rr[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int e = list[h0 + min(q, count - h0 - 1)];
            jn[q] = e & 255;
            rr[q] = e >> 8;
          }
          float v[kBatch][CPT] = {};
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            if (k >= kg) break;
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const float gk = gs[k * nc + jn[q]];
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                v[q][j] = fmaf(gk, pr[k][j], v[q][j]);
            }
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {  // added in order
            if (h0 + q >= count || !mine) break;
            VT* a = reinterpret_cast<VT*>(acc + rr[q] * dzc + col);
            VT sum = *a;
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              reinterpret_cast<float*>(&sum)[j] += v[q][j];
            *a = sum;
          }
        }
        __syncwarp();
        consumer_release(ring, it);
      }
    }
  }
  // each thread writes the entries it owns into this split's partial
  // (splits x row_tiles * pt x D)
  float* out =
      partial + ((long)split * pl.row_tiles * pt + (long)rt * pt) * D + d0;
  for (int r = group; r < pt; r += rg)
    if (mine)
      *reinterpret_cast<VT*>(out + (long)r * D + col) =
          *reinterpret_cast<const VT*>(acc + r * dzc + col);
}

// One grid: CTAs [0, dp.ctas) compute dpreds, the row_tiles x col_slices x
// splits after them dz (tile fastest).
template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
gathered_bwd(const float* __restrict__ g, const float* __restrict__ preds,
             const float* __restrict__ z, const int* __restrict__ idx,
             float* __restrict__ dpreds, float* __restrict__ partial, int B,
             int K, int W, int N, int D, int P, DpPlan dp, DzPlan dz) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((int)blockIdx.x < dp.ctas) {
    dpreds_role<KP>(smem, blockIdx.x, g, z, idx, dpreds, B, K, W, N, D, dp);
    return;
  }
  const int i = blockIdx.x - dp.ctas, tiles = dz.row_tiles * dz.col_slices;
  dz_role<KP>(smem, i % tiles, i / tiles, g, preds, idx, partial, B, K, W, N,
              D, P, dz);
}

// dz[i] = sum over splits s, ascending, of partial[s][i'], float4 at a time:
// pool row r of group r / group_rows is row r % group_rows of its group's
// tiles, which start at row r / group_rows * group_stride of a partial
// (group_stride = group_tiles * pt; i' = i with one group).
__global__ void dz_sum(const float4* __restrict__ partial,
                       float4* __restrict__ dz, long n4, long split4,
                       int splits, int d4, int group_rows, int group_stride) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const long r = i / d4;
    const long j = (r / group_rows * group_stride + r % group_rows) * d4 +
                   i % d4;
    float4 s = partial[j];
    for (int k = 1; k < splits; ++k) {
      const float4 v = partial[k * split4 + j];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dz[i] = s;
  }
}

// Plans the kernels can run: the shapes they take (D a multiple of 4; N too
// for the backward), row blocks, chunks and strides within their register
// arrays and fragment layouts, and stages and shared memory that hold what
// the kernels put there.
bool fwd_ok(int KP, int B, int K, int W, int N, int D, const FwdPlan& f,
            long smem) {
  return B > 0 && K > 0 && W > 0 && N > 0 && D > 0 && D % 4 == 0 &&
         f.rb > 0 && f.rb <= 128 && f.rb % 16 == 0 &&
         f.rb / 16 * (KP / 8) <= kPairSlots * kWarps && f.dc > 0 &&
         f.dc % 8 == 0 && f.stride >= f.dc && f.stride % 4 == 0 &&
         f.stage % 4 == 0 &&
         (long)f.stage >= (long)(f.rb + KP) * f.stride && f.stages >= 1 &&
         f.stages <= kMaxStages &&
         smem >= kBarrierBytes + 4L * f.stages * f.stage;
}

bool bwd_ok(int KP, int B, int K, int W, int N, int D, int P,
            const DpPlan& dp, const DzPlan& dz, long smem) {
  const int cpt = 64 / KP, kr = min(K, KP);
  return B > 0 && K > 0 && W > 0 && N > 0 && N % 4 == 0 && D > 0 &&
         D % 4 == 0 && P > 0 && dp.rb > 0 && dp.rb <= 128 &&
         dp.rb % 16 == 0 && dp.dc > 0 && dp.dc <= 256 && dp.dc % 8 == 0 &&
         dp.zs >= dp.dc && dp.zs % 4 == 0 && dp.gs >= dp.rb &&
         dp.gs % 4 == 0 && dp.stage % 4 == 0 &&
         (long)dp.stage >= (long)dp.rb * dp.zs + (long)KP * dp.gs &&
         dp.stages >= 1 && dp.stages <= kMaxStages && dp.ctas > 0 &&
         dz.nc == min(N, kChunkN) && dz.dzc > 0 && dz.dzc % 4 == 0 &&
         dz.dzc <= 256 * cpt && dz.stage % 4 == 0 &&
         (long)dz.stage >= (long)dz.nc * (1 + kr) + (long)kr * dz.dzc &&
         dz.stages >= 1 && dz.stages <= kMaxStages && dz.pt > 0 &&
         dz.group_rows > 0 && P % dz.group_rows == 0 && dz.group_units > 0 &&
         dz.group_units % W == 0 && B % (dz.group_units / W) == 0 &&
         B / (dz.group_units / W) == P / dz.group_rows &&
         dz.group_tiles > 0 && (long)dz.group_tiles * dz.pt >= dz.group_rows &&
         (dz.group_tiles - 1L) * dz.pt < dz.group_rows &&
         (long)dz.row_tiles == (long)dz.group_tiles * (P / dz.group_rows) &&
         (long)dz.col_slices * dz.dzc >= D &&
         (dz.col_slices - 1L) * dz.dzc < D && dz.splits > 0 &&
         smem >= kBarrierBytes + 4L * dp.stages * dp.stage &&
         smem >= kBarrierBytes + 4L * ((long)dz.stages * dz.stage +
                                       (long)dz.pt * dz.dzc + kWarps * dz.nc);
}

}  // namespace

extern "C" {

// preds (B,K,W,D), z (P,D), idx (B,W,N) int32 in [0, P) -> out (B,K,W,N);
// the plan's groups of kp predictions, row block, column chunk, stage
// stride and size, stages, CTAs and shared memory bytes.
int cpc2_infonce_fwd(const float* preds, const float* z, const int* idx,
                     float* out, int B, int K, int W, int N, int D, int kp,
                     int rb, int dc, int stride, int stage, int stages,
                     int grid, long smem, void* stream) {
  const FwdPlan f{rb, dc, stride, stage, stages};
  if ((kp != 16 && kp != 32) || grid <= 0 ||
      !fwd_ok(kp, B, K, W, N, D, f, smem))
    return (int)cudaErrorInvalidValue;
  const void* fn = kp == 16 ? (const void*)gathered_fwd<16>
                            : (const void*)gathered_fwd<32>;
  cudaError_t err = cpc2::set_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp == 16)
    gathered_fwd<16><<<grid, kThreads, smem, s>>>(preds, z, idx, out, B, K,
                                                  W, N, D, f);
  else
    gathered_fwd<32><<<grid, kThreads, smem, s>>>(preds, z, idx, out, B, K,
                                                  W, N, D, f);
  return (int)cudaGetLastError();
}

// g (B,K,W,N) -> dpreds (B,K,W,D), dz (P,D). `partial` holds splits x
// row_tiles * pt x D floats. One launch of dp_ctas dpreds CTAs beside
// row_tiles x col_slices x splits dz CTAs, then the partials' sum. With
// pool groups (group_rows < P), idx of group u / group_units's units lies
// in that group's group_rows rows.
int cpc2_infonce_bwd(const float* g, const float* preds, const float* z,
                     const int* idx, float* dpreds, float* dz, float* partial,
                     int B, int K, int W, int N, int D, int P, int kp,
                     int rb, int dc, int zs, int gs, int dp_stage,
                     int dp_stages, int dp_ctas, int nc, int dzc,
                     int dz_stage, int dz_stages, int pt, int row_tiles,
                     int col_slices, int splits, int group_rows,
                     int group_units, int group_tiles, long smem,
                     void* stream) {
  const DpPlan dp{rb, dc, zs, gs, dp_stage, dp_stages, dp_ctas};
  const DzPlan dzp{nc,        dzc,        dz_stage,   dz_stages,
                   pt,        row_tiles,  col_slices, splits,
                   group_rows, group_units, group_tiles};
  if ((kp != 16 && kp != 32) || !bwd_ok(kp, B, K, W, N, D, P, dp, dzp, smem))
    return (int)cudaErrorInvalidValue;
  const void* fn = kp == 16 ? (const void*)gathered_bwd<16>
                            : (const void*)gathered_bwd<32>;
  cudaError_t err = cpc2::set_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = dp_ctas + row_tiles * col_slices * splits;
  if (kp == 16)
    gathered_bwd<16><<<grid, kThreads, smem, s>>>(
        g, preds, z, idx, dpreds, partial, B, K, W, N, D, P, dp, dzp);
  else
    gathered_bwd<32><<<grid, kThreads, smem, s>>>(
        g, preds, z, idx, dpreds, partial, B, K, W, N, D, P, dp, dzp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n4 = (long)P * D / 4, split4 = (long)row_tiles * pt * D / 4;
  const long blocks = (n4 + 255) / 256;
  dz_sum<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dz),
      n4, split4, splits, D / 4, group_rows, group_tiles * pt);
  return (int)cudaGetLastError();
}

}  // extern "C"
