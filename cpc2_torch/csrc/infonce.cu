// InfoNCE negative scoring, forward and backward, for Hopper:
//   neg[b, k, w, n] = preds[b, k, w, :] . z[idx[b, w, n], :]
//
// Replaces the TPU kernel cpc2_tpu/ops/infonce_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `negative_scores_pallas`). The TPU design keeps the whole
// (P, D) pool in VMEM and selects the sampled rows with one-hot matmuls, so
// its cost grows with P; that pool does not fit shared memory here, and the
// card gathers rows cheaply, so nothing of that design carries over.
//
// What bounds it: 2*B*K*W*N*D FLOPs (0.73 GFLOP at the recipe) against
// about 19 MB of compulsory traffic, so it is bound by operations; the
// gathered rows come from L2 (the 1 MB pool stays resident there). Design:
// one block per (b, w). The block stages its K prediction rows and N indices
// in shared memory, then each warp takes sampled rows n, reads row
// z[idx[n]] once (coalesced) and scores it against all K predictions. The
// backward uses the same blocking: dpreds reads each sampled row once for
// all K, and dz scatter-adds sum_k g[k, n] * preds[k, :] into pool row
// idx[n] with fp32 atomicAdd, so its summation order varies from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // prediction rows scored per pass over a z row

__global__ void __launch_bounds__(kThreads)
neg_scores_fwd(const float* __restrict__ preds, const float* __restrict__ z,
               const int* __restrict__ idx, float* __restrict__ out, int K,
               int W, int N, int D) {
  extern __shared__ float smem[];
  float* p_s = smem;                                  // (K, D)
  int* idx_s = reinterpret_cast<int*>(smem + K * D);  // (N)
  const int w = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    const int k = i / D, d = i % D;
    p_s[i] = preds[(((long)b * K + k) * W + w) * D + d];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    idx_s[i] = idx[((long)b * W + w) * N + i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int n = warp; n < N; n += n_warps) {
    const float* z_row = z + (long)idx_s[n] * D;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float zv = z_row[d];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < kc) acc[j] = fmaf(p_s[(k0 + j) * D + d], zv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j >= kc) break;
        const float v = cpc2::warp_sum(acc[j]);
        if (lane == 0)
          out[(((long)b * K + k0 + j) * W + w) * N + n] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
neg_scores_bwd(const float* __restrict__ g, const float* __restrict__ preds,
               const float* __restrict__ z, const int* __restrict__ idx,
               float* __restrict__ dpreds, float* __restrict__ dz, int K,
               int W, int N, int D) {
  extern __shared__ float smem[];
  float* g_s = smem;                                       // (K, N)
  float* p_s = smem + K * N;                               // (K, D)
  int* idx_s = reinterpret_cast<int*>(smem + K * N + K * D);  // (N)
  const int w = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) {
    const int k = i / N, n = i % N;
    g_s[i] = g[(((long)b * K + k) * W + w) * N + n];
  }
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    const int k = i / D, d = i % D;
    p_s[i] = preds[(((long)b * K + k) * W + w) * D + d];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    idx_s[i] = idx[((long)b * W + w) * N + i];
  __syncthreads();

  // dpreds[b, k, w, d] = sum_n g[k, n] * z[idx[n], d]; one thread per d.
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float zv = z[(long)idx_s[n] * D + d];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < kc) acc[j] = fmaf(g_s[(k0 + j) * N + n], zv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j >= kc) break;
        dpreds[(((long)b * K + k0 + j) * W + w) * D + d] = acc[j];
      }
    }
  }

  // dz[idx[n], d] += sum_k g[k, n] * preds[k, d]
  for (int n = 0; n < N; ++n) {
    float* dz_row = dz + (long)idx_s[n] * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float v = 0.f;
      for (int k = 0; k < K; ++k) v = fmaf(g_s[k * N + n], p_s[k * D + d], v);
      atomicAdd(dz_row + d, v);
    }
  }
}

}  // namespace

extern "C" {

// preds (B,K,W,D), z (P,D), idx (B,W,N) int32 in [0, P) -> out (B,K,W,N).
int cpc2_infonce_fwd(const float* preds, const float* z, const int* idx,
                     float* out, int B, int K, int W, int N, int D,
                     void* stream) {
  if (B == 0 || W == 0) return 0;
  const size_t smem = (size_t)K * D * sizeof(float) + (size_t)N * sizeof(int);
  cudaError_t err = cpc2::set_smem((const void*)neg_scores_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  neg_scores_fwd<<<dim3(W, B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(preds, z, idx, out, K,
                                                        W, N, D);
  return (int)cudaGetLastError();
}

// g (B,K,W,N) -> dpreds (B,K,W,D); dz (P,D) must be zeroed by the caller.
int cpc2_infonce_bwd(const float* g, const float* preds, const float* z,
                     const int* idx, float* dpreds, float* dz, int B, int K,
                     int W, int N, int D, void* stream) {
  if (B == 0 || W == 0) return 0;
  const size_t smem = (size_t)(K * N + K * D) * sizeof(float) +
                      (size_t)N * sizeof(int);
  cudaError_t err = cpc2::set_smem((const void*)neg_scores_bwd, smem);
  if (err != cudaSuccess) return (int)err;
  neg_scores_bwd<<<dim3(W, B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(g, preds, z, idx,
                                                        dpreds, dz, K, W, N, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
