// Host (CPU) DTW: batched dynamic-time-warping distances with backtracked
// path-length normalization, for the cpc2_torch package (a copy of the JAX
// package's `csrc/dtwhost.cc`).
//
// The card's DTW is `cpc2_torch/csrc/dtw.cu` (`cpc2_torch/ops/dtw.py`).
// This host kernel serves callers without a card and is held bit for bit
// against that kernel and against the plain DTW (`ops/dtw.py:dtw_normalized_plain`).
// Exposed to Python via ctypes (`cpc2_torch/ops/dtw_host.py`); built with
// g++ at first use into build/cpc2_torch_kernels/libdtwhost.so
// (`cpc2_torch/ops/_build.py:build_host`).
//
// Semantics follow the reference kernel `cpc/eval/ABX/dtw.pyx:40-77`:
// 3-neighbour DP over the (n1, n2) distance matrix, then a backtrack that
// prefers diagonal, then left, then up (ties included), counting path
// cells; the score is final_cost / path_length, with the same f32 operand
// order per cell as the other DTW implementations.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

inline float dtw_one(const float* dist, int s2_stride, int n1, int n2,
                     std::vector<float>& cost) {
  cost.resize(size_t(n1) * n2);
  // DP: cost[i,j] = dist[i,j] + min(cost[i-1,j], cost[i-1,j-1], cost[i,j-1])
  cost[0] = dist[0];
  for (int j = 1; j < n2; ++j) cost[j] = dist[j] + cost[j - 1];
  for (int i = 1; i < n1; ++i) {
    const float* drow = dist + size_t(i) * s2_stride;
    float* crow = cost.data() + size_t(i) * n2;
    const float* prow = crow - n2;
    crow[0] = drow[0] + prow[0];
    for (int j = 1; j < n2; ++j) {
      float up = prow[j], diag = prow[j - 1], left = crow[j - 1];
      float m = diag < left ? diag : left;
      if (up < m) m = up;
      crow[j] = drow[j] + m;
    }
  }
  // Backtrack with the reference's tie-break (diag <= left <= up).
  int i = n1 - 1, j = n2 - 1;
  long path = 1;
  while (i > 0 && j > 0) {
    float up = cost[size_t(i - 1) * n2 + j];
    float left = cost[size_t(i) * n2 + j - 1];
    float diag = cost[size_t(i - 1) * n2 + j - 1];
    if (diag <= left && diag <= up) {
      --i; --j;
    } else if (left <= up) {
      --j;
    } else {
      --i;
    }
    ++path;
  }
  path += i + j;  // only one direction remains along the border
  return cost[size_t(n1 - 1) * n2 + (n2 - 1)] / float(path);
}

}  // namespace

extern "C" {

// dist: (n, s1, s2) row-major padded distance matrices; n1/n2: true
// lengths per pair (>= 1); out: (n,) normalized DTW scores.
void dtw_host_batch(const float* dist, long long n, int s1, int s2,
                    const int* n1, const int* n2, float* out) {
  std::vector<float> scratch;
  for (long long b = 0; b < n; ++b) {
    const float* d = dist + size_t(b) * s1 * s2;
    out[b] = dtw_one(d, s2, n1[b], n2[b], scratch);
  }
}

}  // extern "C"
