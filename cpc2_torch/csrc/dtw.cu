// Batched DTW with backtracked-path-length normalisation, forward only:
//   out[p] = cost[n1-1, n2-1] / max(len[n1-1, n2-1], 1)
//   cost[i, j] = d[i, j] + min(cost[i-1, j-1], cost[i, j-1], cost[i-1, j])
// over dist[p, :n1[p], :n2[p]], cell (0, 0) taking d alone and border cells
// their one predecessor. The path length follows the predecessor chosen by
// the backtracking tie-break diag <= left <= up.
//
// Replaces the TPU kernel cpc2_tpu/ops/dtw_pallas.py (`_dtw_kernel`,
// `dtw_normalized_pallas`). The TPU design copies `dist` into a skewed,
// diagonal-major layout so that each anti-diagonal of a block of pairs is
// one VMEM vector; nothing of that carries over.
//
// What bounds it: the n1 x n2 cells a pair needs are read once (at most
// P*S1*S2*4 bytes, 75.5 MB for one ABX flush of 18,432 pairs at 32x32)
// against about 20 operations per cell, so its bound is bytes. But every
// cell waits on its left neighbour, so what sets the time is how many
// lanes have a cell to compute at each step and whether their loads of d
// are in flight before they are needed. Two routes, chosen by the shape
// (`dtw_layout`, mirrored by cpc2_torch/ops/dtw.py:dtw_plan):
//
// * Lane route (`dtw_lanes<S2B, G>`, S2 <= 64: every ABX bucket up to 64
//   frames). G lanes a pair (1, 2, 4 or 8; each S2B / G >= 8 columns, G
//   the fewest that give every SM 8 warps: 2 at an ABX flush of 18,432
//   pairs, 8 at a few hundred), 32 / G pairs a warp, one warp a CTA. A pair
//   walks its rows in order; lane k keeps its S2B / G columns of the row
//   above in registers (costs and path lengths; S2B the bucket width 8,
//   16, 32 or 64) and computes row t - k at step t, taking its left and
//   diagonal neighbours at column kC - 1 from lane k - 1's last column by
//   one shuffle a step. So a lane is busy for every row of its own pair:
//   no lane waits on a 32-step wavefront, and a dummy pair of length 1
//   holds its lanes for one row. The warp's pairs' rows reach shared
//   memory by coalesced `cp.async` copies (16 bytes where S2 is a
//   multiple of 4 and `dist` 16-byte aligned, else 4), only the n1 rows
//   and the 16-byte groups below n2 of each pair, `ahead` rows (128 cells
//   a lane) before they are needed, into a ring of `ahead` + G row slots
//   padded to S2B + 4 floats, from which each lane reads its columns as
//   float4s. A lane computes no row past its own n1; its cells past n2
//   feed no cell it keeps.
// * Wave route (`dtw_wave`, 64 < S2 <= 2,048). One warp a pair. Lane l
//   owns row i = base + l of a strip of 32 rows and walks the strip's
//   columns with a lag of l steps, so that at each step the warp holds one
//   anti-diagonal of the strip: the up neighbour is lane l-1's newest cell
//   (`__shfl_up_sync`), the diagonal one the up neighbour of the step
//   before, the left one the lane's own newest cell. Lane 0 reads its up
//   neighbours from the previous strip's bottom row, which lane 31 wrote to
//   shared memory; two row buffers alternate between strips. The strip's
//   32 x 32 column chunks of d are staged by coalesced `cp.async` copies
//   into a ring of three: in each phase of 32 steps the wavefront reads
//   chunks s-1 and s while chunk s+1 is in flight, and each lane loads the
//   phase's 32 values of d (and lane 0 its 32 up neighbours) into
//   registers at its start (row stride 32 floats: lane l reading column
//   t - l is free of bank conflicts). The steps are branch-free: cells
//   outside the pair are computed all the same, and none inside reads one.
//
// Every cost is one fp32 add of d to an exact minimum, and the result one
// IEEE division, so any traversal order that applies the tie-break to the
// same accumulated costs gives the bits of the plain version in
// cpc2_torch/ops/dtw.py. No atomics, no state across CTAs.
#include "common.cuh"

namespace {

constexpr float kBig = 1e30f;  // `_BIG` of cpc2_torch/ops/dtw.py
constexpr int kMaxLen = 2048;  // largest S1 and S2 taken: 20 s of frames
constexpr int kLaneMax = 64;   // widest S2 of the lane route
constexpr int kChunk = 32;     // wave route: columns of a staged chunk
constexpr int kChunkSlots = 3; // wave route: chunks in the ring
constexpr unsigned kFull = 0xffffffffu;

enum Route : int { kLanes = 0, kWave = 1 };

// Rows the lane route stages ahead of the newest row it computes: enough
// steps of `c` cells a lane to cover a load from device memory.
__host__ __device__ constexpr int lane_ahead(int c) {
  return c >= 64 ? 2 : 128 / c;
}

// Padded row stride of the lane route's ring, floats.
__host__ __device__ constexpr int lane_ld(int s2b) { return s2b + 4; }

// The kernels' layout at (S1, S2) for P pairs on a card of `sms` SMs:
// route; lane route: bucket width S2B, lanes a pair G, pairs a CTA (one
// warp), rows staged ahead, ring slots (rows staged ahead + G), dynamic
// shared memory bytes of the ring; wave route: 0, 1, 1, columns a chunk,
// chunks in the ring, shared memory bytes (the ring, then two row buffers
// of S2 costs and S2 lengths).
struct Layout {
  int route, s2b, lanes, pairs, ahead, slots, smem;
};

bool dtw_layout(int S1, int S2, int P, int sms, Layout* l) {
  if (S1 < 1 || S2 < 1 || S1 > kMaxLen || S2 > kMaxLen || P < 0 || sms < 1)
    return false;
  if (S2 > kLaneMax) {
    *l = {kWave, 0, 1, 1, kChunk, kChunkSlots,
          (kChunkSlots * 32 * kChunk + 4 * S2) * 4};
    return true;
  }
  int s2b = 8;
  while (s2b < S2) s2b *= 2;
  // G lanes a pair, each S2B / G >= 8 columns: the fewest that give every
  // SM 8 warps (two a scheduler)
  int g = 1;
  while (g < s2b / 8 && (long)P * g < 32L * 8 * sms) g *= 2;
  const int ahead = lane_ahead(s2b / g), slots = ahead + g;
  *l = {kLanes, s2b, g, 32 / g, ahead, slots,
        slots * (32 / g) * lane_ld(s2b) * 4};
  return true;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   cpc2::smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One cell: cost d + min(diag, left, up) and the length of the path through
// the predecessor the tie-break diag <= left <= up picks. On the wave route
// `up` arrives last (a shuffle) and is taken last; on the lane route `left`
// (the cell just computed) does, and one minimum of left and up serves both
// the cost and the tie-break (diag <= left && diag <= up is diag <= that
// minimum). The same values either way.
template <bool kUpLast>
__device__ __forceinline__ void cell(float dv, float diag, int ldiag,
                                     float left, int lleft, float up, int lup,
                                     float& c, int& l) {
  bool take_diag;
  if (kUpLast) {
    take_diag = diag <= left && diag <= up;
    c = dv + fminf(fminf(diag, left), up);
  } else {
    const float m = fminf(left, up);
    take_diag = diag <= m;
    c = dv + fminf(diag, m);
  }
  l = (take_diag ? ldiag : left <= up ? lleft : lup) + 1;
}

// ---- lane route -----------------------------------------------------------

template <int S2B, int G>
__global__ void __launch_bounds__(32)
dtw_lanes(const float* __restrict__ dist, const int* __restrict__ n1s,
          const int* __restrict__ n2s, float* __restrict__ out, int P, int S1,
          int S2, bool vec) {
  constexpr int C = S2B / G;          // columns a lane
  constexpr int Q = 32 / G;           // pairs a warp
  constexpr int kLd = lane_ld(S2B), kAhead = lane_ahead(C);
  constexpr int kSlots = kAhead + G;  // rows t - G + 1 ... t + kAhead
  constexpr int kCpr = S2B / 4;       // 16-byte groups of a row
  extern __shared__ __align__(16) float ring[];  // [kSlots][Q pairs][kLd]
  const int lane = threadIdx.x, q = lane / G, k = lane % G;
  const long p0 = (long)blockIdx.x * Q, p = p0 + q;
  const int live = (int)min((long)Q, P - p0);  // pairs of this warp
  const int n1 = q < live ? min(max(n1s[p], 1), S1) : 0;
  const int n2 = q < live ? min(max(n2s[p], 1), S2) : 0;
  const int rows = __reduce_max_sync(kFull, n1);
  const float* src = dist + p0 * S1 * S2;

  // 16-byte `cp.async`: this lane copies one group of columns of C / 4
  // pairs, `kQstep` pairs apart, each below the row where its pair needs
  // the group no more.
  constexpr int kCopies = C / 4, kQstep = 32 / kCpr;
  const int col = (lane % kCpr) * 4, q0 = lane / kCpr;
  const float* const from = src + (long)q0 * S1 * S2 + col;
  const long from_step = (long)kQstep * S1 * S2;
  const uint32_t to = cpc2::smem_u32(ring) + (q0 * kLd + col) * 4;
  int lim[kCopies];
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int qq = q0 + m * kQstep;
    const int q1 = __shfl_sync(kFull, n1, qq * G);
    const int q2 = __shfl_sync(kFull, n2, qq * G);
    lim[m] = col < q2 ? q1 : 0;
  }
  // Row r (< rows) of the warp's pairs into its ring slot.
  auto stage = [&](int r) {
    if (vec) {
      const float* g = from + (long)r * S2;
      const uint32_t slot = to + r % kSlots * (Q * kLd * 4);
#pragma unroll
      for (int m = 0; m < kCopies; ++m, g += from_step)
        if (r < lim[m]) cp_async16(slot + m * kQstep * kLd * 4, g);
    } else {
      float* dst = ring + r % kSlots * Q * kLd;
#pragma unroll 4
      for (int m = 0; m < C; ++m) {
        const int c = lane + 32 * m, qq = c / S2B, j = c % S2B;
        if (qq < live && j < S2)
          cp_async4(dst + qq * kLd + j, src + ((long)qq * S1 + r) * S2 + j);
      }
    }
  };

  for (int r = 0; r < kAhead; ++r) {
    if (r < rows) stage(r);
    cp_async_commit();
  }
  float pc[C];  // this lane's columns of the row above: costs and lengths
  int pl[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    pc[j] = kBig;
    pl[j] = 0;
  }
  // From lane k - 1: its last column at the row it computed last step
  // (this step's left neighbour) and the step before (diagonal).
  float last_c = kBig, in_c = kBig;
  int last_l = 0, in_l = 0;
  const int steps = rows + G - 1;  // lane k computes row t - k at step t
  // two steps an iteration: pc and pl then alternate registers, not moves
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kAhead - 1>();
    __syncwarp();
    if (t + kAhead < rows) stage(t + kAhead);
    cp_async_commit();
    const float left_c = __shfl_up_sync(kFull, last_c, 1);
    const int left_l = __shfl_up_sync(kFull, last_l, 1);
    const int i = t - k;
    last_c = kBig;
    last_l = 0;
    if (i >= 0 && i < n1) {
      const float* row = ring + ((i % kSlots) * Q + q) * kLd + k * C;
      // cell (-1, -1) of cost 0 and length 0 starts the path at (0, 0);
      // column -1 and row -1 are kBig
      float diag = k > 0 ? in_c : i == 0 ? 0.f : kBig;
      int ldiag = k > 0 ? in_l : 0;
      float left = k > 0 ? left_c : kBig;
      int lleft = k > 0 ? left_l : 0;
#pragma unroll
      for (int g = 0; g < C; g += 4) {
        const float4 dv = *reinterpret_cast<const float4*>(row + g);
        const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float up = pc[g + u];
          const int lup = pl[g + u];
          cell<false>(d4[u], diag, ldiag, left, lleft, up, lup, left, lleft);
          diag = up;
          ldiag = lup;
          pc[g + u] = left;
          pl[g + u] = lleft;
        }
      }
      last_c = pc[C - 1];
      last_l = pl[C - 1];
    }
    in_c = left_c;
    in_l = left_l;
  }
  cp_async_wait<0>();
  float fc = 0.f;
  int fl = 0;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (k * C + j == n2 - 1) {
      fc = pc[j];
      fl = pl[j];
    }
  if (q < live && k == (n2 - 1) / C) out[p] = fc / fmaxf((float)fl, 1.f);
}

// ---- wave route -----------------------------------------------------------

__global__ void __launch_bounds__(32)
dtw_wave(const float* __restrict__ dist, const int* __restrict__ n1s,
         const int* __restrict__ n2s, float* __restrict__ out, int S1, int S2,
         bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* const chunks = smem;  // [kChunkSlots][32 rows][kChunk]
  float* const rows = smem + kChunkSlots * 32 * kChunk;  // 2 x (S2 c, S2 l)
  const int lane = threadIdx.x;
  const long p = blockIdx.x;
  const int n1 = min(max(n1s[p], 1), S1), n2 = min(max(n2s[p], 1), S2);
  const float* d = dist + p * S1 * S2;

  float final_c = 0.f;
  int final_l = 0;
  int strip = 0;
  for (int base = 0; base < n1; base += 32, ++strip) {
    const int i = base + lane;
    const bool row_ok = i < n1;
    const float* above_c = rows + ((strip + 1) & 1) * 2 * S2;  // row base-1
    const int* above_l = reinterpret_cast<const int*>(above_c + S2);
    float* below_c = rows + (strip & 1) * 2 * S2;  // this strip's last row
    int* below_l = reinterpret_cast<int*>(below_c + S2);
    // chunk s of the strip (columns 32s ... 32s + 31) into slot s % 3
    auto stage = [&](int s) {
      float* dst = chunks + (s % kChunkSlots) * 32 * kChunk;
      if (vec) {
        const int j = s * kChunk + (lane % 8) * 4;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = m * 4 + lane / 8;
          if (base + r < n1 && j < n2)
            cp_async16(cpc2::smem_u32(dst + r * kChunk + (lane % 8) * 4),
                       d + (long)(base + r) * S2 + j);
        }
      } else {
        const int j = s * kChunk + lane;
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          if (base + r < n1 && j < n2)
            cp_async4(dst + r * kChunk + lane, d + (long)(base + r) * S2 + j);
      }
    };

    float cur_c = kBig, up_prev_c = kBig;  // cells (i, j-1) and (i-1, j-1)
    int cur_l = 0, up_prev_l = 0;
    const int phases = (n2 + 62) / 32;  // n2 + 31 steps
    stage(0);
    cp_async_commit();
    for (int s = 0; s < phases; ++s) {
      cp_async_wait<0>();
      __syncwarp();
      if ((s + 1) * kChunk < n2) stage(s + 1);
      cp_async_commit();
      // this phase's d (column j = 32s + u - lane, in chunk s or s - 1)
      // and lane 0's up neighbours, loaded before the steps that need them
      float dv[32], ab_c[32];
      int ab_l[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int j = s * 32 + u - lane;
        const int slot = (u >= lane ? s : s + kChunkSlots - 1) % kChunkSlots;
        dv[u] = (row_ok && j >= 0 && j < n2)
                    ? chunks[(slot * 32 + lane) * kChunk + (j & 31)]
                    : 0.f;
        const bool have = lane == 0 && base > 0 && j < n2;
        ab_c[u] = have ? above_c[j] : kBig;
        ab_l[u] = have ? above_l[j] : 0;
      }
      // Branch-free steps: a cell outside the pair is computed all the
      // same, and no cell inside reads one (its column-0 and row-0
      // neighbours are the constants below, its others inside the pair).
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int j = s * 32 + u - lane;
        const float sh_c = __shfl_up_sync(kFull, cur_c, 1);  // cell (i-1, j)
        const int sh_l = __shfl_up_sync(kFull, cur_l, 1);
        const float up_c = lane == 0 ? ab_c[u] : sh_c;
        const int up_l = lane == 0 ? ab_l[u] : sh_l;
        // cell (-1, -1) of cost 0 and length 0 starts the path at (0, 0)
        const float c_diag = j == 0 ? (i == 0 ? 0.f : kBig) : up_prev_c;
        const int l_diag = j == 0 ? 0 : up_prev_l;
        const float c_left = j == 0 ? kBig : cur_c;
        float new_c;
        int new_l;
        cell<true>(dv[u], c_diag, l_diag, c_left, cur_l, up_c, up_l, new_c,
                   new_l);
        if (lane == 31 && row_ok && j >= 0 && j < n2) {
          below_c[j] = new_c;
          below_l[j] = new_l;
        }
        if (i == n1 - 1 && j == n2 - 1) {
          final_c = new_c;
          final_l = new_l;
        }
        up_prev_c = up_c;
        up_prev_l = up_l;
        cur_c = new_c;
        cur_l = new_l;
      }
    }
    cp_async_wait<0>();
    __syncwarp();
  }
  if (lane == (n1 - 1) % 32) out[p] = final_c / fmaxf((float)final_l, 1.f);
}

using LanesKernel = void (*)(const float*, const int*, const int*, float*,
                            int, int, int, bool);

// The lane route's kernel at bucket width S2B and G lanes a pair.
LanesKernel lanes_kernel(int s2b, int g) {
  switch (s2b * 16 + g) {
    case 8 * 16 + 1: return dtw_lanes<8, 1>;
    case 16 * 16 + 1: return dtw_lanes<16, 1>;
    case 16 * 16 + 2: return dtw_lanes<16, 2>;
    case 32 * 16 + 1: return dtw_lanes<32, 1>;
    case 32 * 16 + 2: return dtw_lanes<32, 2>;
    case 32 * 16 + 4: return dtw_lanes<32, 4>;
    case 64 * 16 + 1: return dtw_lanes<64, 1>;
    case 64 * 16 + 2: return dtw_lanes<64, 2>;
    case 64 * 16 + 4: return dtw_lanes<64, 4>;
    case 64 * 16 + 8: return dtw_lanes<64, 8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The kernels' layout at (S1, S2) for P pairs on a card of `sms` SMs into
// out[0..6]: route (0 lanes, 1 wave), S2B, lanes a pair, pairs a CTA, rows
// staged ahead or chunk columns, ring slots, shared memory bytes. Returns
// cudaErrorInvalidValue for S1 or S2 outside [1, 2048], P < 0 or sms < 1.
int cpc2_dtw_layout(int S1, int S2, int P, int sms, int* out) {
  Layout l;
  if (!dtw_layout(S1, S2, P, sms, &l)) return (int)cudaErrorInvalidValue;
  const int v[7] = {l.route, l.s2b, l.lanes, l.pairs, l.ahead, l.slots,
                    l.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// dist (P, S1, S2) fp32, n1/n2 (P,) int32 in [1, S1] / [1, S2] -> out (P,),
// with `sms` and the plan's seven ints (cpc2_dtw_layout). Returns
// cudaErrorInvalidValue for a shape the layout refuses or a plan that is
// not the layout; P == 0 launches nothing.
int cpc2_dtw(const float* dist, const int* n1, const int* n2, float* out,
             int P, int S1, int S2, int sms, int route, int s2b, int lanes,
             int pairs, int ahead, int slots, int smem, void* stream) {
  Layout l;
  if (!dtw_layout(S1, S2, P, sms, &l)) return (int)cudaErrorInvalidValue;
  if (route != l.route || s2b != l.s2b || lanes != l.lanes ||
      pairs != l.pairs || ahead != l.ahead || slots != l.slots ||
      smem != l.smem)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = S2 % 4 == 0 && reinterpret_cast<uintptr_t>(dist) % 16 == 0;
  // every layout's shared memory is below the 48 KB a launch may take
  // without opting in (45,056 bytes at S2 = 2,048)
  if (l.route == kWave)
    dtw_wave<<<P, 32, l.smem, st>>>(dist, n1, n2, out, S1, S2, vec);
  else
    lanes_kernel(l.s2b, l.lanes)<<<(P + l.pairs - 1) / l.pairs, 32, l.smem,
                                   st>>>(dist, n1, n2, out, P, S1, S2, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
