// Causal relative-position attention of the prediction heads, forward and
// backward, for Hopper. Per attention unit n (one block of S steps of one
// head of one batch row):
//
//   logit[r, c] = (q[r] . k[c] + sum_d q[r, d] * Krelpos[d, S-1-(r-c)]) / sqrt(dk)
//   p = softmax over c <= r (causal),  p~ = dropout(p),  out = p~ . v
//
// Replaces the TPU kernel cpc2_tpu/ops/attention_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_relpos_attention`). The TPU kernel takes a (dk, S, S)
// table W2[d, r, c] = Krelpos[d, S-1-(r-c)] gathered outside the kernel and
// carries dW2 across its sequential grid. Here the kernel reads Krelpos
// itself, so q[r] . (k[c] + Krelpos[:, S-1-r+c]) is one dot, and since
// blocks run in no order, each unit writes its own dKrelpos partial
// (N, S, dk) and a second kernel sums the partials over units in a fixed
// order: the result is deterministic, with no atomics.
//
// What bounds it: at the recipe (N = 64 units, S = 116, dk = 32) the work is
// about 165 MFLOP forward and 440 MFLOP backward, a few microseconds at the
// fp32 peak, and the compulsory traffic is about 4 MB; with one block per
// unit (64 blocks on 132 SMs) and dependent steps inside each row, latency
// sets its time. Design: one block of 8 warps per unit, with the unit's q,
// k, v (g) and Krelpos (transposed) in shared memory at an odd row stride,
// so that lanes walking rows or features hit distinct banks. A warp takes
// one row at a time and its lanes hold the row's columns c = lane + 32 j in
// registers through the softmax. The forward stages each warp's row of
// probabilities in shared memory for the product with v. The backward
// recomputes the probabilities, keeps the unit's dropped probabilities and
// score gradients (2 x S x S fp32, 108 KB at the recipe) in shared memory,
// and gives dq by rows, then dk and dv by columns and the dKrelpos partial
// by diagonals.
//
// Dropout keeps (n, r, c) when dropout_bits(seed, n*S + r, c) >= threshold
// (common.cuh), the mask that cpc2_torch/ops/ffn.py:dropout_bits computes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 256 / 32;  // columns per lane: S <= 256

__device__ inline float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline float warp_allmax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// A (S, dk) row-major unit into shared memory at row stride ld.
__device__ void load_unit(float* dst, const float* __restrict__ src, int S,
                          int dk, int ld) {
  for (int i = threadIdx.x; i < S * dk; i += blockDim.x)
    dst[(i / dk) * ld + i % dk] = src[i];
}

// Krelpos (dk, S) into shared memory transposed: dst[j * ld + d].
__device__ void load_relpos(float* dst, const float* __restrict__ krel, int S,
                            int dk, int ld) {
  for (int i = threadIdx.x; i < S * dk; i += blockDim.x)
    dst[(i % S) * ld + i / S] = krel[i];
}

// Row r's probabilities: p[j] for column c = lane + 32 j, 0 where c > r.
__device__ void row_probs(const float* q_s, const float* k_s,
                          const float* kr_s, int S, int dk, int ld, int r,
                          float scale, float (&p)[kMaxCols]) {
  const int lane = threadIdx.x % 32;
  const float* qr = q_s + r * ld;
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = lane + 32 * j;
    float logit = -INFINITY;
    if (c <= r) {
      const float* kc = k_s + c * ld;
      const float* rel = kr_s + (S - 1 - r + c) * ld;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d) acc = fmaf(qr[d], kc[d] + rel[d], acc);
      logit = acc * scale;
    }
    p[j] = logit;
    m = fmaxf(m, logit);
  }
  m = warp_allmax(m);  // finite: column 0 is always in
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    p[j] = (lane + 32 * j <= r) ? expf(p[j] - m) : 0.f;
    sum += p[j];
  }
  sum = warp_allsum(sum);
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) p[j] = p[j] / sum;
}

__device__ inline bool kept(uint32_t seed, uint32_t threshold, int row,
                            int c) {
  return threshold == 0u ||
         cpc2::dropout_bits(seed, (uint32_t)row, (uint32_t)c) >= threshold;
}

__global__ void __launch_bounds__(kThreads)
attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ krel,
              const uint32_t* __restrict__ seed_ptr, float* __restrict__ out,
              int S, int dk, uint32_t threshold, float keep_scale) {
  extern __shared__ float smem[];
  const int ld = dk | 1;
  float* q_s = smem;
  float* k_s = q_s + S * ld;
  float* v_s = k_s + S * ld;
  float* kr_s = v_s + S * ld;
  float* p_s = kr_s + S * ld;  // one row of S per warp
  const int unit = blockIdx.x;
  const long base = (long)unit * S * dk;
  load_unit(q_s, q + base, S, dk, ld);
  load_unit(k_s, k + base, S, dk, ld);
  load_unit(v_s, v + base, S, dk, ld);
  load_relpos(kr_s, krel, S, dk, ld);
  __syncthreads();

  const uint32_t seed = *seed_ptr;
  const float scale = 1.f / sqrtf((float)dk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prow = p_s + warp * S;
  for (int r = warp; r < S; r += kWarps) {
    float p[kMaxCols];
    row_probs(q_s, k_s, kr_s, S, dk, ld, r, scale, p);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = lane + 32 * j;
      if (c < S)
        prow[c] = kept(seed, threshold, unit * S + r, c) ? p[j] * keep_scale
                                                         : 0.f;
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.f;
      for (int c = 0; c <= r; ++c) acc = fmaf(prow[c], v_s[c * ld + d], acc);
      out[base + (long)r * dk + d] = acc;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ krel,
              const uint32_t* __restrict__ seed_ptr,
              const float* __restrict__ g, float* __restrict__ dq,
              float* __restrict__ dk_out, float* __restrict__ dv,
              float* __restrict__ partial, int S, int dk, uint32_t threshold,
              float keep_scale) {
  extern __shared__ float smem[];
  const int ld = dk | 1;
  float* q_s = smem;
  float* k_s = q_s + S * ld;
  float* v_s = k_s + S * ld;
  float* g_s = v_s + S * ld;
  float* kr_s = g_s + S * ld;
  float* pd_s = kr_s + S * ld;  // (S, S) dropped probabilities
  float* ds_s = pd_s + S * S;   // (S, S) gradients of the scaled scores
  const int unit = blockIdx.x;
  const long base = (long)unit * S * dk;
  load_unit(q_s, q + base, S, dk, ld);
  load_unit(k_s, k + base, S, dk, ld);
  load_unit(v_s, v + base, S, dk, ld);
  load_unit(g_s, g + base, S, dk, ld);
  load_relpos(kr_s, krel, S, dk, ld);
  __syncthreads();

  const uint32_t seed = *seed_ptr;
  const float scale = 1.f / sqrtf((float)dk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Rows: recompute p, then dp = mask(g . v^T), ds = p (dp - sum dp p) scale
  // and dq[r] = sum_c ds[r, c] (k[c] + Krelpos[:, S-1-r+c]).
  for (int r = warp; r < S; r += kWarps) {
    float p[kMaxCols], dp[kMaxCols];
    row_probs(q_s, k_s, kr_s, S, dk, ld, r, scale, p);
    const float* gr = g_s + r * ld;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = lane + 32 * j;
      dp[j] = 0.f;
      if (c <= r) {
        const float* vc = v_s + c * ld;
        float acc = 0.f;
        for (int d = 0; d < dk; ++d) acc = fmaf(gr[d], vc[d], acc);
        const bool keep = kept(seed, threshold, unit * S + r, c);
        dp[j] = keep ? acc * keep_scale : 0.f;
        if (c < S) pd_s[r * S + c] = keep ? p[j] * keep_scale : 0.f;
      }
      dot += dp[j] * p[j];
    }
    dot = warp_allsum(dot);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = lane + 32 * j;
      if (c < S) {
        ds_s[r * S + c] = p[j] * (dp[j] - dot) * scale;
        if (c > r) pd_s[r * S + c] = 0.f;
      }
    }
    __syncwarp();
    const float* dsr = ds_s + r * S;
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.f;
      for (int c = 0; c <= r; ++c)
        acc = fmaf(dsr[c], k_s[c * ld + d] + kr_s[(S - 1 - r + c) * ld + d],
                   acc);
      dq[base + (long)r * dk + d] = acc;
    }
  }
  __syncthreads();

  // Columns: dv[c] = sum_r p~[r, c] g[r],  dk[c] = sum_r ds[r, c] q[r].
  for (int c = warp; c < S; c += kWarps) {
    for (int d = lane; d < dk; d += 32) {
      float av = 0.f, ak = 0.f;
      for (int r = c; r < S; ++r) {
        av = fmaf(pd_s[r * S + c], g_s[r * ld + d], av);
        ak = fmaf(ds_s[r * S + c], q_s[r * ld + d], ak);
      }
      dv[base + (long)c * dk + d] = av;
      dk_out[base + (long)c * dk + d] = ak;
    }
  }
  // Diagonals: this unit's dKrelpos[d, S-1-delta] = sum_r q[r, d] ds[r, r-delta].
  for (int delta = warp; delta < S; delta += kWarps) {
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.f;
      for (int r = delta; r < S; ++r)
        acc = fmaf(q_s[r * ld + d], ds_s[r * S + r - delta], acc);
      partial[((long)unit * S + S - 1 - delta) * dk + d] = acc;
    }
  }
}

// dkrel[d, j] = sum over units of partial[n, j, d], units in order.
__global__ void relpos_grad_sum(const float* __restrict__ partial,
                                float* __restrict__ dkrel, int N, int S,
                                int dk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * dk) return;
  const int j = t / dk, d = t % dk;
  float acc = 0.f;
  for (int n = 0; n < N; ++n) acc += partial[((long)n * S + j) * dk + d];
  dkrel[d * S + j] = acc;
}

size_t fwd_smem(int S, int dk) {
  return sizeof(float) * ((size_t)4 * S * (dk | 1) + (size_t)kWarps * S);
}

size_t bwd_smem(int S, int dk) {
  return sizeof(float) * ((size_t)5 * S * (dk | 1) + (size_t)2 * S * S);
}

}  // namespace

extern "C" {

// q, k, v (N,S,dk), krel (dk,S) -> out (N,S,dk). Requires S <= 256.
int cpc2_attention_fwd(const float* q, const float* k, const float* v,
                       const float* krel, const unsigned* seed, float* out,
                       int N, int S, int dk, unsigned threshold,
                       float keep_scale, void* stream) {
  if (N == 0) return 0;
  if (S > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(S, dk);
  cudaError_t err = cpc2::set_smem((const void*)attention_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, krel, seed, out, S, dk, threshold, keep_scale);
  return (int)cudaGetLastError();
}

// g (N,S,dk) -> dq, dk, dv (N,S,dk) and dkrel (dk,S); partial (N,S,dk) is
// scratch. Requires S <= 256 and bwd_smem(S, dk) within the block's limit.
int cpc2_attention_bwd(const float* q, const float* k, const float* v,
                       const float* krel, const unsigned* seed,
                       const float* g, float* dq, float* dk_out, float* dv,
                       float* partial, float* dkrel, int N, int S, int dk,
                       unsigned threshold, float keep_scale, void* stream) {
  if (N == 0) return 0;
  if (S > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(S, dk);
  cudaError_t err = cpc2::set_smem((const void*)attention_bwd, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd<<<N, kThreads, smem, s>>>(q, k, v, krel, seed, g, dq, dk_out,
                                          dv, partial, S, dk, threshold,
                                          keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  relpos_grad_sum<<<(S * dk + 255) / 256, 256, 0, s>>>(partial, dkrel, N, S,
                                                       dk);
  return (int)cudaGetLastError();
}

}  // extern "C"
