// The CPC waveform encoder, 5 x (strided conv -> ChannelNorm -> ReLU), forward
// and backward, for Hopper.
//
// Replaces the TPU kernel cpc2_tpu/ops/encoder_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_encoder`). Same numbers: conv operands in bf16 (x and
// every weight rounded to bf16, layers 1-4 stored as bf16), sums and norm
// statistics in fp32 (unbiased variance, eps 1e-5), layer 5 out in fp32; in
// the backward dy is fp32 for db and rounded to bf16 for dW and for the
// lower layer's gradient. The TPU kernel keeps one sample's whole stack in
// VMEM through a polyphase layout and recomputes the forward in its
// backward; a sample's layer-1 output alone (4,096 x 256 bf16, 2 MB) does not
// fit the 227 KB of shared memory a block has, so nothing of that layout
// carries over.
//
// What bounds it: the products, about 25 GFLOP forward and 50 GFLOP
// backward at the recipe (16 x 20,480 samples, C = 256), far above the
// card's FLOP-per-byte balance: it is bound by operations. Design, one
// launch per layer and step (activations channels-last, (rows, C)):
//  * forward: an implicit-GEMM conv whose block owns 32 output rows and all
//    C channels (a warp owns 4 whole rows, its lanes the channels lane +
//    32 j), so bias, ChannelNorm, affine and ReLU fuse into its epilogue
//    through warp sums. A row's patch of k x Cin inputs is contiguous in
//    the channels-last input, so A tiles are coalesced loads. Layers 1-4
//    are written as bf16 (48 MB at the recipe, inside the 50 MB L2); with
//    gradients on, the pre-norm conv outputs are also kept in fp32 (98 MB)
//    so that the backward does not recompute the forward;
//  * backward, per layer from 5 down: a norm kernel (warp per row) turns
//    dh into dy, writes dy as bf16 and per-block sums of dy, da.xh and da;
//    dW is A^T.dy over all rows, split over row ranges whose partials a
//    second pass sums in a fixed order; the lower layer's gradient is the
//    same implicit GEMM as the forward, run once per phase of the stride
//    (k = 2 s, so every input row gets exactly two taps: a 2C-deep product
//    over dy rows a-1 and a with that phase's weights); layer 1's input
//    gradient is two taps of dy . w1 per sample. No atomics: the results
//    do not depend on the order in which blocks run.
// The products run on the fp32 FMA units with bf16 operands; wgmma tiles
// are later work.
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLayers = 5;
// (kernel, stride, padding) of each layer: models/encoder.py CONV_STACK.
constexpr int kKernel[kLayers] = {10, 8, 4, 4, 4};
constexpr int kStride[kLayers] = {5, 4, 2, 2, 2};
constexpr int kPad[kLayers] = {3, 2, 1, 1, 1};
// Layer 1 as scalars, for device code.
constexpr int kTaps1 = 10, kStride1 = 5, kPad1 = 3;
constexpr float kEps = 1e-5f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBM = kWarps * kRowsPerWarp;  // rows of a conv block
constexpr int kBK = 32;                     // depth of a conv k slice
constexpr int kNormRows = 64;               // rows of a norm-backward block
constexpr int kWTile = 64;                  // dW output tile (kc x c)
constexpr int kWSlice = 16;                 // rows per dW k slice
constexpr int kWBlocks = 512;               // dW blocks aimed for per layer

__device__ inline float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ inline float load_f(const float* p) { return to_bf16(*p); }
__device__ inline float load_f(const bf16* p) { return __bfloat162float(*p); }

__device__ inline float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// An implicit-GEMM convolution over channels-last rows. Output row m = n *
// Tout + t reads the patch of input rows stride*t - pad + j, j < taps (zero
// outside [0, Tin)), i.e. the taps*Cin contiguous values from (n*Tin +
// stride*t - pad) * Cin, against w (taps*Cin, C) bf16, offset by blockIdx.z
// * w_phase for the backward's phases.
struct ConvArgs {
  const void* in;
  int Tin, Cin, taps, stride, pad, Tout;
  long M;
  const bf16* w;
  long w_phase;
  // forward epilogue: y = acc + bias, ChannelNorm, affine, ReLU
  const float* bias;
  const float* nw;
  const float* nb;
  float* y_save;  // pre-norm y (M, C) fp32, or nullptr
  void* out;      // (M, C): bf16 (kNormBf16) or fp32 (kNormF32)
  // backward epilogue (kScatter): out row n * out_T + out_stride * t +
  // blockIdx.z + out_offset, skipped outside [0, out_T); fp32
  int out_T, out_stride, out_offset;
};

enum Mode : int { kNormBf16 = 0, kNormF32 = 1, kScatter = 2 };

template <typename TIn, int kMode, int CPL>
__global__ void __launch_bounds__(kThreads) conv_gemm(ConvArgs a) {
  constexpr int C = 32 * CPL;
  __shared__ float As[kBK][kBM + 1];  // As[kk][row]
  __shared__ float Bs[kBK][C];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long m0 = (long)blockIdx.x * kBM;
  const TIn* in = static_cast<const TIn*>(a.in);
  const bf16* w = a.w + blockIdx.z * a.w_phase;
  const int KC = a.taps * a.Cin;
  const long in_len = (long)a.Tin * a.Cin;

  // The A rows this thread loads: warp + kWarps * e, at k offset lane.
  long row_base[kRowsPerWarp], row_off[kRowsPerWarp];
#pragma unroll
  for (int e = 0; e < kRowsPerWarp; ++e) {
    const long m = m0 + warp + kWarps * e;
    if (m < a.M) {
      const long n = m / a.Tout, t = m % a.Tout;
      row_base[e] = n * in_len;
      row_off[e] = (a.stride * t - a.pad) * (long)a.Cin;
    } else {
      row_base[e] = 0;
      row_off[e] = -(long)KC - kBK;  // never valid
    }
  }

  float acc[kRowsPerWarp][CPL] = {};
  for (int k0 = 0; k0 < KC; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < kRowsPerWarp; ++e) {
      const int kk = k0 + lane;
      const long off = row_off[e] + kk;
      As[lane][warp + kWarps * e] =
          (kk < KC && off >= 0 && off < in_len) ? load_f(in + row_base[e] + off)
                                                : 0.f;
    }
    for (int i = tid; i < kBK * C; i += kThreads) {
      const int kk = i / C, col = i % C;
      Bs[kk][col] =
          (k0 + kk < KC) ? __bfloat162float(w[(long)(k0 + kk) * C + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kRowsPerWarp], bv[CPL];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        av[i] = As[kk][warp * kRowsPerWarp + i];
#pragma unroll
      for (int j = 0; j < CPL; ++j) bv[j] = Bs[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long m = m0 + warp * kRowsPerWarp + i;
    if (m >= a.M) continue;  // uniform across the warp
    if (kMode == kScatter) {
      const long n = m / a.Tout, t = m % a.Tout;
      const long ot = a.out_stride * t + blockIdx.z + a.out_offset;
      if (ot < 0 || ot >= a.out_T) continue;
      float* out = static_cast<float*>(a.out) + (n * a.out_T + ot) * C;
#pragma unroll
      for (int j = 0; j < CPL; ++j) out[lane + 32 * j] = acc[i][j];
      continue;
    }
    float y[CPL], s = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      y[j] = acc[i][j] + a.bias[lane + 32 * j];
      s += y[j];
    }
    const float mean = warp_allsum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float d = y[j] - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_allsum(ss) / (C - 1) + kEps);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = lane + 32 * j;
      if (a.y_save) a.y_save[m * C + col] = y[j];
      const float h =
          fmaxf((y[j] - mean) * rstd * a.nw[col] + a.nb[col], 0.f);
      if (kMode == kNormBf16)
        static_cast<bf16*>(a.out)[m * C + col] = __float2bfloat16_rn(h);
      else
        static_cast<float*>(a.out)[m * C + col] = h;
    }
  }
}

template <typename TIn, int kMode>
cudaError_t conv(const ConvArgs& a, int C, int phases, cudaStream_t s) {
  const dim3 grid((unsigned)((a.M + kBM - 1) / kBM), 1, phases);
  switch (C) {
    case 32: conv_gemm<TIn, kMode, 1><<<grid, kThreads, 0, s>>>(a); break;
    case 64: conv_gemm<TIn, kMode, 2><<<grid, kThreads, 0, s>>>(a); break;
    case 128: conv_gemm<TIn, kMode, 4><<<grid, kThreads, 0, s>>>(a); break;
    case 256: conv_gemm<TIn, kMode, 8><<<grid, kThreads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ChannelNorm + affine + ReLU backward, warp per row. From the pre-norm y and
// the gradient dh at the layer's output: dy (bf16) and, per block, the sums
// over its rows of dy, da * xhat and da into part (blocks, 3, C).
template <int CPL>
__global__ void __launch_bounds__(kThreads)
norm_bwd(const float* __restrict__ y, const float* __restrict__ dh,
         const float* __restrict__ nw, const float* __restrict__ nb, long M,
         bf16* __restrict__ dy, float* __restrict__ part) {
  constexpr int C = 32 * CPL;
  __shared__ float red[kWarps][3][C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s_db[CPL] = {}, s_dnw[CPL] = {}, s_dnb[CPL] = {};
  const long r0 = (long)blockIdx.x * kNormRows + warp * (kNormRows / kWarps);
  for (int i = 0; i < kNormRows / kWarps; ++i) {
    const long m = r0 + i;
    if (m >= M) break;
    float yv[CPL], s = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      yv[j] = y[m * C + lane + 32 * j];
      s += yv[j];
    }
    const float mean = warp_allsum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float d = yv[j] - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_allsum(ss) / (C - 1) + kEps);
    float xh[CPL], dxh[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = lane + 32 * j;
      xh[j] = (yv[j] - mean) * rstd;
      const float act = xh[j] * nw[col] + nb[col];
      const float da = act > 0.f ? dh[m * C + col] : 0.f;
      s_dnw[j] += da * xh[j];
      s_dnb[j] += da;
      dxh[j] = da * nw[col];
      s1 += dxh[j];
      s2 += dxh[j] * xh[j];
    }
    const float mean_dxh = warp_allsum(s1) / C;
    const float proj = warp_allsum(s2) / (C - 1);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float g = rstd * (dxh[j] - mean_dxh - xh[j] * proj);
      s_db[j] += g;
      dy[m * C + lane + 32 * j] = __float2bfloat16_rn(g);
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    red[warp][0][lane + 32 * j] = s_db[j];
    red[warp][1][lane + 32 * j] = s_dnw[j];
    red[warp][2][lane + 32 * j] = s_dnb[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w][i / C][i % C];
    part[(long)blockIdx.x * 3 * C + i] = v;
  }
}

// dW partials: part[z, kc, c] = sum over rows m of split z of A(m, kc) *
// dy(m, c), with A the conv's patch matrix (as in conv_gemm) and dy bf16.
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
conv_wgrad(const TIn* __restrict__ in, int Tin, int Cin, int taps,
           int stride, int pad, int Tout, long M,
           const bf16* __restrict__ dy, int C, long rows_per_split,
           float* __restrict__ part) {
  __shared__ float As[kWSlice][kWTile + 4];
  __shared__ float Ds[kWSlice][kWTile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int KC = taps * Cin;
  const int c0 = blockIdx.x * kWTile, kc0 = blockIdx.y * kWTile;
  const long m_begin = blockIdx.z * rows_per_split;
  const long m_end =
      m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  const long in_len = (long)Tin * Cin;
  float acc[4][4] = {};
  for (long ms = m_begin; ms < m_end; ms += kWSlice) {
    for (int i = tid; i < kWSlice * kWTile; i += kThreads) {
      const int mm = i / kWTile, kk = i % kWTile;
      const long m = ms + mm;
      const int kc = kc0 + kk;
      float v = 0.f;
      if (m < m_end && kc < KC) {
        const long n = m / Tout, t = m % Tout;
        const long off = (stride * t - pad) * (long)Cin + kc;
        if (off >= 0 && off < in_len) v = load_f(in + n * in_len + off);
      }
      As[mm][kk] = v;
      Ds[mm][kk] = (m < m_end && c0 + kk < C)
                       ? __bfloat162float(dy[m * C + c0 + kk])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kWSlice; ++mm) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = Ds[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = kc0 + ty + 16 * i;
    if (kc >= KC) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < C) part[((long)blockIdx.z * KC + kc) * C + c] = acc[i][j];
    }
  }
}

// out[i] = sum over r < R of X[r * ncols + i], rows in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_rows(const float* __restrict__ X, long R, long ncols,
         float* __restrict__ out) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long i = (long)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (i < ncols)
    for (long r = warp; r < R; r += kWarps) v += X[r * ncols + i];
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && i < ncols) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][lane];
    out[i] = s;
  }
}

cudaError_t reduce_rows(const float* X, long R, long ncols, float* out,
                        cudaStream_t s) {
  sum_rows<<<(unsigned)((ncols + 31) / 32), kThreads, 0, s>>>(X, R, ncols,
                                                               out);
  return cudaGetLastError();
}

// Layer 1's taps: P[m, j] = sum_c dy[m, c] * w1[j, c], warp per row m.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
input_taps(const bf16* __restrict__ dy, const bf16* __restrict__ w1, long M,
           float* __restrict__ P) {
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x % 32;
  const long m = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  float d[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    d[j] = __bfloat162float(dy[m * C + lane + 32 * j]);
  for (int tap = 0; tap < kTaps1; ++tap) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      s = fmaf(d[j], __bfloat162float(w1[tap * C + lane + 32 * j]), s);
    s = warp_allsum(s);
    if (lane == 0) P[m * kTaps1 + tap] = s;
  }
}

// dx[n, u - pad] = P[n, a, ph] + P[n, a - 1, ph + stride], u = stride a + ph.
__global__ void input_overlap(const float* __restrict__ P, int N, int T,
                              int T1, float* __restrict__ dx) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)N * T) return;
  const long n = i / T;
  const int u = (int)(i % T) + kPad1;
  const int a = u / kStride1, ph = u % kStride1;
  float v = 0.f;
  if (a < T1) v += P[(n * T1 + a) * kTaps1 + ph];
  if (a >= 1 && a - 1 < T1) v += P[(n * T1 + a - 1) * kTaps1 + ph + kStride1];
  dx[i] = v;
}

// Frames after each layer, and element offsets of each layer's activations
// (N, T_l, C) and weights in their packed buffers.
struct Plan {
  int T[kLayers];
  long act_off[kLayers], w_off[kLayers], wt_off[kLayers];
  Plan(int N, int T0, int C) {
    long act = 0, wo = 0, wt = 0;
    int t = T0;
    for (int l = 0; l < kLayers; ++l) {
      t /= kStride[l];
      T[l] = t;
      act_off[l] = act;
      act += (long)N * t * C;
      const int cin = l == 0 ? 1 : C;
      w_off[l] = wo;
      wo += (long)kKernel[l] * cin * C;
      wt_off[l] = wt;
      if (l > 0) wt += (long)kStride[l] * 2 * C * cin;
    }
  }
};

template <int CPL>
cudaError_t launch_norm_bwd(const float* y, const float* dh, const float* nw,
                            const float* nb, long M, bf16* dy, float* part,
                            cudaStream_t s) {
  norm_bwd<CPL><<<(unsigned)((M + kNormRows - 1) / kNormRows), kThreads, 0,
                  s>>>(y, dh, nw, nb, M, dy, part);
  return cudaGetLastError();
}

cudaError_t norm_backward(int C, const float* y, const float* dh,
                          const float* nw, const float* nb, long M, bf16* dy,
                          float* part, cudaStream_t s) {
  switch (C) {
    case 32: return launch_norm_bwd<1>(y, dh, nw, nb, M, dy, part, s);
    case 64: return launch_norm_bwd<2>(y, dh, nw, nb, M, dy, part, s);
    case 128: return launch_norm_bwd<4>(y, dh, nw, nb, M, dy, part, s);
    case 256: return launch_norm_bwd<8>(y, dh, nw, nb, M, dy, part, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t taps_backward(int C, const bf16* dy, const bf16* w1, long M,
                          float* P, cudaStream_t s) {
  const unsigned grid = (unsigned)((M + kWarps - 1) / kWarps);
  switch (C) {
    case 32: input_taps<1><<<grid, kThreads, 0, s>>>(dy, w1, M, P); break;
    case 64: input_taps<2><<<grid, kThreads, 0, s>>>(dy, w1, M, P); break;
    case 128: input_taps<4><<<grid, kThreads, 0, s>>>(dy, w1, M, P); break;
    case 256: input_taps<8><<<grid, kThreads, 0, s>>>(dy, w1, M, P); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#define CPC2_TRY(expr)                       \
  do {                                       \
    const cudaError_t err_ = (expr);         \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

extern "C" {

// x (N,T) fp32, T a multiple of 160 -> out (N, T/160, C) fp32.
// wpack: every layer's weight as (k, Cin, C) bf16, layers in order; bias,
// nw, nb (5, C) fp32. acts: layers 1-4's outputs (N, T_l, C) bf16, in order.
// pre: the five pre-norm outputs (N, T_l, C) fp32, in order, or nullptr.
int cpc2_encoder_fwd(const float* x, const bf16* wpack, const float* bias,
                     const float* nw, const float* nb, bf16* acts, float* pre,
                     float* out, int N, int T, int C, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan(N, T, C);
  for (int l = 0; l < kLayers; ++l) {
    ConvArgs a{};
    a.in = l == 0 ? (const void*)x : (const void*)(acts + plan.act_off[l - 1]);
    a.Tin = l == 0 ? T : plan.T[l - 1];
    a.Cin = l == 0 ? 1 : C;
    a.taps = kKernel[l];
    a.stride = kStride[l];
    a.pad = kPad[l];
    a.Tout = plan.T[l];
    a.M = (long)N * plan.T[l];
    a.w = wpack + plan.w_off[l];
    a.bias = bias + l * C;
    a.nw = nw + l * C;
    a.nb = nb + l * C;
    a.y_save = pre ? pre + plan.act_off[l] : nullptr;
    if (l == 0) {
      a.out = acts;
      CPC2_TRY((conv<float, kNormBf16>(a, C, 1, s)));
    } else if (l < kLayers - 1) {
      a.out = acts + plan.act_off[l];
      CPC2_TRY((conv<bf16, kNormBf16>(a, C, 1, s)));
    } else {
      a.out = out;
      CPC2_TRY((conv<bf16, kNormF32>(a, C, 1, s)));
    }
  }
  return 0;
}

// Backward from gz (N, T/160, C) fp32. wpack, nw, nb, acts and pre as the
// forward gave them; wtpack: for layers 2-5, per phase ph < stride, the
// (2C, C) bf16 matrix [W[:, :, ph + stride]^T; W[:, :, ph]^T], in order.
// Out: dwpack (fp32, wpack's layout), dnorm (5, 3, C) = (db, dnw, dnb) per
// layer, dx (N, T). Scratch: dh (N*T_1*C fp32), dy (N*T_1*C bf16) and part
// (part_len fp32, at least N*T_1/64*3*C and 8*C*C).
int cpc2_encoder_bwd(const float* x, const float* gz, const bf16* wpack,
                     const bf16* wtpack, const float* nw, const float* nb,
                     const bf16* acts, const float* pre, float* dwpack,
                     float* dnorm, float* dx, float* dh, bf16* dy, float* part,
                     long part_len, int N, int T, int C, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan(N, T, C);
  for (int l = kLayers - 1; l >= 0; --l) {
    const long M = (long)N * plan.T[l];
    const int Tin = l == 0 ? T : plan.T[l - 1];
    const int Cin = l == 0 ? 1 : C;
    // dy and the per-layer sums of dy, da * xhat and da
    CPC2_TRY(norm_backward(C, pre + plan.act_off[l], l == kLayers - 1 ? gz : dh,
                           nw + l * C, nb + l * C, M, dy, part, s));
    const long blocks = (M + kNormRows - 1) / kNormRows;
    CPC2_TRY(reduce_rows(part, blocks, 3L * C, dnorm + 3L * l * C, s));
    // dW = A^T dy, split over row ranges, then the splits summed
    const int KC = kKernel[l] * Cin;
    const long tiles = (long)((C + kWTile - 1) / kWTile) *
                       ((KC + kWTile - 1) / kWTile);
    long splits = std::min(kWBlocks / tiles, (M + 255) / 256);
    splits = std::max(1L, std::min(splits, part_len / ((long)KC * C)));
    long rows = (M + splits - 1) / splits;
    rows = (rows + kWSlice - 1) / kWSlice * kWSlice;
    splits = (M + rows - 1) / rows;
    const dim3 wgrid((C + kWTile - 1) / kWTile, (KC + kWTile - 1) / kWTile,
                     (unsigned)splits);
    if (l == 0)
      conv_wgrad<float><<<wgrid, kThreads, 0, s>>>(
          x, Tin, Cin, kKernel[l], kStride[l], kPad[l], plan.T[l], M, dy, C,
          rows, part);
    else
      conv_wgrad<bf16><<<wgrid, kThreads, 0, s>>>(
          acts + plan.act_off[l - 1], Tin, Cin, kKernel[l], kStride[l],
          kPad[l], plan.T[l], M, dy, C, rows, part);
    CPC2_TRY(cudaGetLastError());
    CPC2_TRY(reduce_rows(part, splits, (long)KC * C, dwpack + plan.w_off[l],
                         s));
    if (l > 0) {
      // dh of the layer below: per phase ph, input rows s*a + ph - pad from
      // dy rows a-1 and a (a 2C-deep product), every row written once
      ConvArgs a{};
      a.in = dy;
      a.Tin = plan.T[l];
      a.Cin = C;
      a.taps = 2;
      a.stride = 1;
      a.pad = 1;
      a.Tout = plan.T[l] + 1;
      a.M = (long)N * (plan.T[l] + 1);
      a.w = wtpack + plan.wt_off[l];
      a.w_phase = 2L * C * Cin;
      a.out = dh;
      a.out_T = Tin;
      a.out_stride = kStride[l];
      a.out_offset = -kPad[l];
      CPC2_TRY((conv<bf16, kScatter>(a, C, kStride[l], s)));
    } else {
      // dx: the ten taps of every layer-1 row, then the two per sample
      CPC2_TRY(taps_backward(C, dy, wpack + plan.w_off[0], M, dh, s));
      const long n_x = (long)N * T;
      input_overlap<<<(unsigned)((n_x + 255) / 256), 256, 0, s>>>(
          dh, N, T, plan.T[0], dx);
      CPC2_TRY(cudaGetLastError());
    }
  }
  return 0;
}

}  // extern "C"
