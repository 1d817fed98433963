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
// against about 20 operations per cell, so its bound is bytes. But the
// recurrence is a chain of dependent steps, so latency sets its time.
// Design: one warp per pair. Lane l owns row i = base + l of a strip of 32
// rows and walks the strip's columns with a lag of l steps, so that at each
// step the warp holds one anti-diagonal of the strip: the up neighbour is
// lane l-1's newest cell (`__shfl_up_sync`), the diagonal one is the up
// neighbour of the step before, the left one the lane's own newest cell.
// Lane 0 reads its up neighbours from the previous strip's bottom row,
// which lane 31 wrote to shared memory; two row buffers alternate between
// strips. A pair walks only its own n1 x n2 cells. Every cost is one fp32
// add of d to an exact minimum and the last step one IEEE division, so the
// result is bit-identical to the plain version in cpc2_torch/ops/dtw.py.
#include "common.cuh"

namespace {

constexpr float kBig = 1e30f;   // `_BIG` of cpc2_torch/ops/dtw.py
constexpr int kMaxLen = 2048;   // largest S1 and S2 taken: 20 s of frames
constexpr int kWarps = 4;       // pairs per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
dtw_kernel(const float* __restrict__ dist, const int* __restrict__ n1s,
           const int* __restrict__ n2s, float* __restrict__ out, int P,
           int S1, int S2) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long p = (long)blockIdx.x * kWarps + warp;
  if (p >= P) return;  // uniform across the warp
  // this warp's two row buffers, each S2 costs then S2 lengths
  float* const rows = smem + (long)warp * 4 * S2;
  const int n1 = min(max(n1s[p], 1), S1), n2 = min(max(n2s[p], 1), S2);
  const float* d = dist + p * S1 * S2;

  float final_c = 0.f;
  int final_l = 0;
  int strip = 0;
  for (int base = 0; base < n1; base += 32, ++strip) {
    const int i = base + lane;
    const bool row_ok = i < n1;
    const float* d_row = d + (long)i * S2;
    const float* above_c = rows + ((strip + 1) & 1) * 2 * S2;  // row base-1
    const int* above_l = reinterpret_cast<const int*>(above_c + S2);
    float* below_c = rows + (strip & 1) * 2 * S2;  // this strip's last row
    int* below_l = reinterpret_cast<int*>(below_c + S2);
    float cur_c = kBig, up_prev_c = kBig;  // cells (i, j-1) and (i-1, j-1)
    int cur_l = 0, up_prev_l = 0;
    for (int t = 0; t < n2 + 31; ++t) {
      const int j = t - lane;
      float up_c = __shfl_up_sync(kFull, cur_c, 1);  // cell (i-1, j)
      int up_l = __shfl_up_sync(kFull, cur_l, 1);
      if (lane == 0) {
        const bool have = base > 0 && j < n2;
        up_c = have ? above_c[j] : kBig;
        up_l = have ? above_l[j] : 0;
      }
      float new_c = kBig;
      int new_l = 0;
      if (row_ok && j >= 0 && j < n2) {
        const bool i0 = i == 0, j0 = j == 0;
        const float c_left = j0 ? kBig : cur_c;
        const float c_up = i0 ? kBig : up_c;
        const float c_diag = (i0 || j0) ? kBig : up_prev_c;
        const float dv = __ldg(d_row + j);
        if (i0 && j0) {
          new_c = dv + 0.f;
          new_l = 1;
        } else {
          new_c = dv + fminf(c_diag, fminf(c_left, c_up));
          int pred;
          if (c_diag <= c_left && c_diag <= c_up) pred = up_prev_l;
          else if (c_left <= c_up) pred = cur_l;
          else pred = up_l;
          new_l = pred + 1;
        }
        if (lane == 31) {
          below_c[j] = new_c;
          below_l[j] = new_l;
        }
        if (i == n1 - 1 && j == n2 - 1) {
          final_c = new_c;
          final_l = new_l;
        }
      }
      up_prev_c = up_c;
      up_prev_l = up_l;
      cur_c = new_c;
      cur_l = new_l;
    }
    __syncwarp();
  }
  if (lane == (n1 - 1) % 32) out[p] = final_c / fmaxf((float)final_l, 1.f);
}

}  // namespace

extern "C" {

// dist (P, S1, S2) fp32, n1/n2 (P,) int32 in [1, S1] / [1, S2] -> out (P,).
// Returns cudaErrorInvalidValue for S1 or S2 outside [1, 2048].
int cpc2_dtw(const float* dist, const int* n1, const int* n2, float* out,
             int P, int S1, int S2, void* stream) {
  if (S1 < 1 || S2 < 1 || S1 > kMaxLen || S2 > kMaxLen)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const size_t smem = (size_t)kWarps * 4 * S2 * sizeof(float);
  cudaError_t err = cpc2::set_smem((const void*)dtw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dtw_kernel<<<(P + kWarps - 1) / kWarps, kWarps * 32, smem,
               static_cast<cudaStream_t>(stream)>>>(dist, n1, n2, out, P, S1,
                                                    S2);
  return (int)cudaGetLastError();
}

}  // extern "C"
