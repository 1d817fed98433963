// Shared device code for the cpc2_torch kernels: a plain fp32 tiled GEMM
// with strided operands and fused epilogues, a column sum, a warp sum and
// the counter-based dropout hash.
//
// The GEMM is the simple shared-memory SGEMM (64x64 output tile, 16-deep
// k slices, a 4x4 register tile per thread, 256 threads). It runs on the
// fp32 FMA units, not the tensor cores: it is the right-first version
// that later work replaces with wgmma/TMA tiles.
//
// Everything here has internal linkage (an unnamed namespace), so each
// .cu file that includes this header gets its own copy and the objects
// link into one library without duplicate symbols.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cpc2 {
namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kGemmThreads = 256;

// Dropout hash: 32 random bits from (seed, row, col). The plain PyTorch
// version in cpc2_torch/ops/ffn.py (`dropout_bits`) computes the same
// function with int64 arithmetic, so kernel and plain draw identical masks.
__host__ __device__ inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ inline uint32_t dropout_bits(uint32_t seed, uint32_t row,
                                                 uint32_t col) {
  return mix32(mix32(seed ^ mix32(row)) + col);
}

enum Epilogue : int {
  kStore = 0,            // C = acc (+ bias[n])
  kBiasReluDropout = 1,  // C = keep(m,n) ? relu(acc + bias[n]) * scale : 0
  kDropoutReluGrad = 2,  // C = acc * (C_old > 0 ? scale : 0), in place
};

struct EpilogueArgs {
  int kind;
  const float* bias;      // length N, or nullptr
  const uint32_t* seed;   // one value in device memory (kBiasReluDropout)
  uint32_t threshold;     // drop when bits < threshold
  float scale;            // 1 / (1 - rate)
};

// C[m, n] = sum_k A(m, k) * B(k, n), A(m, k) = A[m*sam + k*sak],
// B(k, n) = B[k*sbk + n*sbn], C[m, n] = C[m*ldc + n].
// kAKFast: A's k index is the contiguous one (sak == 1), else its m index.
// kBKFast: B's k index is the contiguous one (sbk == 1), else its n index.
// The tile loads walk the contiguous index across neighbouring threads.
template <bool kAKFast, bool kBKFast>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(int M, int N, int K, const float* __restrict__ A, long sam,
            long sak, const float* __restrict__ B, long sbk, long sbn,
            float* C, long ldc, EpilogueArgs epi) {
  __shared__ float As[kTileK][kTileM + 4];
  __shared__ float Bs[kTileK][kTileN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileK; i += kGemmThreads) {
      int mm, kk;
      if (kAKFast) { kk = i % kTileK; mm = i / kTileK; }
      else         { mm = i % kTileM; kk = i / kTileM; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? A[m * sam + k * sak] : 0.f;
    }
    for (int i = tid; i < kTileN * kTileK; i += kGemmThreads) {
      int nn, kk;
      if (kBKFast) { kk = i % kTileK; nn = i / kTileK; }
      else         { nn = i % kTileN; kk = i / kTileN; }
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? B[k * sbk + n * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const uint32_t seed = (epi.kind == kBiasReluDropout) ? *epi.seed : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      float* c = C + m * ldc + n;
      if (epi.kind == kStore) {
        if (epi.bias) v += epi.bias[n];
      } else if (epi.kind == kBiasReluDropout) {
        v = fmaxf(v + epi.bias[n], 0.f);
        const bool keep =
            dropout_bits(seed, (uint32_t)m, (uint32_t)n) >= epi.threshold;
        v = keep ? v * epi.scale : 0.f;
      } else {  // kDropoutReluGrad: the hidden is > 0 exactly where it was
                // kept and its pre-activation was positive
        v = (*c > 0.f) ? v * epi.scale : 0.f;
      }
      *c = v;
    }
  }
}

inline cudaError_t gemm(int M, int N, int K, const float* A, long sam,
                        long sak, const float* B, long sbk, long sbn,
                        float* C, long ldc, EpilogueArgs epi,
                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const bool a_k = (sak == 1), b_k = (sbk == 1);
  if (a_k && b_k)
    gemm_kernel<true, true><<<grid, kGemmThreads, 0, stream>>>(
        M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, epi);
  else if (a_k)
    gemm_kernel<true, false><<<grid, kGemmThreads, 0, stream>>>(
        M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, epi);
  else if (b_k)
    gemm_kernel<false, true><<<grid, kGemmThreads, 0, stream>>>(
        M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, epi);
  else
    gemm_kernel<false, false><<<grid, kGemmThreads, 0, stream>>>(
        M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, epi);
  return cudaGetLastError();
}

// out[n] = sum_m X[m*ld + n], one thread per column.
__global__ void colsum_kernel(int M, int N, const float* __restrict__ X,
                              long ld, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int m = 0; m < M; ++m) acc += X[m * ld + n];
  out[n] = acc;
}

inline cudaError_t colsum(int M, int N, const float* X, long ld, float* out,
                          cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  colsum_kernel<<<(N + 255) / 256, 256, 0, stream>>>(M, N, X, ld, out);
  return cudaGetLastError();
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
}  // namespace cpc2
