// Shared device code for the cpc2_torch kernels: a plain fp32 tiled GEMM
// with strided operands and fused epilogues, a column sum and the
// counter-based dropout hash.
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
#include <mutex>

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

// --- mbarriers, bulk copies and 3xTF32 tensor-core products (sm_90) -------
// Shared by the kernels that stage operands with asynchronous copies and
// multiply them on the tensor cores at fp32 accuracy (infonce.cu,
// attention.cu, and the wgmma blocks of hopper_gemm.cuh).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of the given parity. A
// wait that has not completed after 2^35 cycles (over 15 s) traps, so that
// a fault in the pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 35)) __trap();
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = big + small: big is x rounded to TF32 (10 mantissa bits; half an
// ulp added, then the low 13 bits cleared), small = x - big exactly in fp32,
// |small| <= 2^-11 |x|, passed as it is: the tensor core reads only its top
// 19 bits, which truncates it to TF32 (an error below 2^-21 |x|). Three
// instructions a value; `cvt.rna.tf32.f32` is no single instruction on
// sm_90 and made the split, not the products, the forward's bound.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed,
// once per kernel, device and size: the attribute is a host call of its own
// on every launch else.
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  struct Set {
    const void* fn;
    int dev;
    size_t bytes;
  };
  constexpr int kSets = 64;
  static Set sets[kSets];
  static int n_sets = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < n_sets; ++i)
    if (sets[i].fn == fn && sets[i].dev == dev && sets[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && n_sets < kSets) sets[n_sets++] = {fn, dev, bytes};
  return err;
}

}  // namespace
}  // namespace cpc2
