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
// What bounds it: the products of layers 2-5 (Cin = C), 24.7 of the
// forward's 25.0 GFLOP and 49.4 of the backward's 50 at the recipe (16 x
// 20,480 samples, C = 256): bf16 tensor-core operations. Activations are
// channels-last, (N, T_l, C). Design:
//  * layers 2-5: each product is the bf16 `wgmma` block of hopper_gemm.cuh
//    (4-stage TMA ring, a producer warp, 128 x 128 x 64 tiles, fp32
//    accumulators) with a tile policy of per-tap boxes. A layer's input
//    (N, T_in, C), T_in = s T_out, is viewed as the 4-D tensor (C, s, T_out,
//    N): tap j of output rows t0.. of sample n is one box at (c0, (j - pad)
//    mod s, t0 + floor((j - pad) / s), n). TMA zero-fills what lies outside
//    the tensor, which is the conv's padding and each sample's edge, so
//    tiles never cross a sample and need no masks.
//    - forward: rows (n, t), k = (tap, channel): K-major A boxes of 128
//      rows, B the layer's (k, Cin, C) weight pack read N-major; the
//      epilogue stores y + bias in fp32 (the pre-norm output the backward
//      reads, or a scratch buffer), then `norm_fwd` (warp per row) writes
//      ChannelNorm + affine + ReLU;
//    - dW: rows (tap, channel), k = (n, t) in 64-row boxes: the same
//      per-tap boxes read M-major and dy's (C, T_out, N) boxes read N-major
//      (dy's zero fill past T_out cancels the input rows there), split
//      over k into fp32 partials that `sum_rows` adds in a fixed order;
//    - the lower layer's gradient, one grid slice per phase ph of the
//      stride: input row u = s a + ph - pad takes taps ph + s and ph of dy
//      rows a - 1 and a (k = 2 s), a 2C-deep product of dy boxes with that
//      phase's (2C, C) weights; the phases below pad start at a = 1, so
//      every row is written exactly once.
//    Below 64 channels a box's upper channels lie past the tensor and are
//    zero-filled: a tap is one k tile whose B rows are that tap's and the
//    next one's (times zeros; past the pack zero-filled too), so the packs
//    stay as they are at the cost of half the products at C = 32; the
//    block's 128-byte swizzle and descriptors stay as they are.
//  * layer 1 (Cin = 1, 10 taps, 0.34 GFLOP): SIMT kernels on the FMA units,
//    an implicit GEMM whose block owns 32 rows and all C channels with the
//    norm in its epilogue, dW in split partials, and the input gradient as
//    ten taps per row and two per sample.
//  * the backward's norm (`norm_bwd`, warp per row): dy as bf16 for the
//    products and per-block sums of dy, da.xhat and da for the bias and norm
//    gradients.
// No atomics: the results do not depend on the order in which blocks run.
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

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
constexpr int kBM = kWarps * kRowsPerWarp;  // rows of a layer-1 conv block
constexpr int kBK = 32;                     // depth of a layer-1 k slice
constexpr int kNormRows = 64;               // rows of a norm-backward block
constexpr int kWTile = 64;                  // layer-1 dW output tile (kc x c)
constexpr int kWSlice = 16;                 // rows per layer-1 dW k slice
constexpr int kWBlocks = 512;               // layer-1 dW blocks aimed for
constexpr int kBox = 64;                    // channels of a box: a k tile
constexpr int kWgradRows = 64;              // rows of t in a dW k tile

__device__ inline float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ inline void put(float* p, float v) { *p = v; }

// Layer 1's conv over the waveform: output row m = n * Tout + t reads the
// samples 5 t - 3 + j, j < 10 (zero outside [0, Tin)), rounded to bf16,
// against w (10, C) bf16; epilogue y = acc + bias (kept in y_save if set),
// ChannelNorm, affine, ReLU, out as bf16. A warp owns 4 whole rows, its
// lanes the channels lane + 32 j, so the norm is a warp sum.
struct ConvArgs {
  const float* in;
  int Tin, Tout;
  long M;
  const bf16* w;
  const float* bias;
  const float* nw;
  const float* nb;
  float* y_save;  // pre-norm y (M, C) fp32, or nullptr
  bf16* out;      // (M, C)
};

template <int CPL>
__global__ void __launch_bounds__(kThreads) conv_gemm(ConvArgs a) {
  constexpr int C = 32 * CPL;
  constexpr int KC = kTaps1;
  __shared__ float As[kBK][kBM + 1];  // As[kk][row]
  __shared__ float Bs[kBK][C];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long m0 = (long)blockIdx.x * kBM;

  // The A rows this thread loads: warp + kWarps * e, at k offset lane.
  long row_base[kRowsPerWarp], row_off[kRowsPerWarp];
#pragma unroll
  for (int e = 0; e < kRowsPerWarp; ++e) {
    const long m = m0 + warp + kWarps * e;
    if (m < a.M) {
      const long n = m / a.Tout, t = m % a.Tout;
      row_base[e] = n * a.Tin;
      row_off[e] = kStride1 * t - kPad1;
    } else {
      row_base[e] = 0;
      row_off[e] = -(long)KC - kBK;  // never valid
    }
  }

  float acc[kRowsPerWarp][CPL] = {};
#pragma unroll
  for (int e = 0; e < kRowsPerWarp; ++e) {
    const int kk = lane;
    const long off = row_off[e] + kk;
    As[lane][warp + kWarps * e] = (kk < KC && off >= 0 && off < a.Tin)
                                      ? to_bf16(a.in[row_base[e] + off])
                                      : 0.f;
  }
  for (int i = tid; i < kBK * C; i += kThreads) {
    const int kk = i / C, col = i % C;
    Bs[kk][col] = kk < KC ? __bfloat162float(a.w[(long)kk * C + col]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
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

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long m = m0 + warp * kRowsPerWarp + i;
    if (m >= a.M) continue;  // uniform across the warp
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
      a.out[m * C + col] = __float2bfloat16_rn(
          fmaxf((y[j] - mean) * rstd * a.nw[col] + a.nb[col], 0.f));
    }
  }
}

// ChannelNorm + affine + ReLU of layers 2-5, warp per row: out = relu((y -
// mean) rstd nw + nb) from the pre-norm y (M, C) fp32, as bf16 (layers 2-4)
// or fp32 (layer 5); the same sums, in the same order, as conv_gemm's.
template <int CPL, typename TOut>
__global__ void __launch_bounds__(kThreads)
norm_fwd(const float* __restrict__ y, const float* __restrict__ nw,
         const float* __restrict__ nb, long M, TOut* __restrict__ out) {
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x % 32;
  const long m = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  float v[CPL], s = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    v[j] = y[m * C + lane + 32 * j];
    s += v[j];
  }
  const float mean = warp_allsum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const float d = v[j] - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_allsum(ss) / (C - 1) + kEps);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = lane + 32 * j;
    put(out + m * C + col,
        fmaxf((v[j] - mean) * rstd * nw[col] + nb[col], 0.f));
  }
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

// Layer 1's dW partials: part[z, j, c] = sum over rows m of split z of
// x(n, 5 t - 3 + j) (bf16-rounded, zero outside) * dy(m, c), dy bf16.
__global__ void __launch_bounds__(kThreads)
conv_wgrad(const float* __restrict__ x, int Tin, int Tout, long M,
           const bf16* __restrict__ dy, int C, long rows_per_split,
           float* __restrict__ part) {
  __shared__ float As[kWSlice][kWTile + 4];
  __shared__ float Ds[kWSlice][kWTile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  constexpr int KC = kTaps1;
  const int c0 = blockIdx.x * kWTile, kc0 = blockIdx.y * kWTile;
  const long m_begin = blockIdx.z * rows_per_split;
  const long m_end =
      m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  float acc[4][4] = {};
  for (long ms = m_begin; ms < m_end; ms += kWSlice) {
    for (int i = tid; i < kWSlice * kWTile; i += kThreads) {
      const int mm = i / kWTile, kk = i % kWTile;
      const long m = ms + mm;
      const int kc = kc0 + kk;
      float v = 0.f;
      if (m < m_end && kc < KC) {
        const long n = m / Tout, t = m % Tout;
        const long off = kStride1 * t - kPad1 + kc;
        if (off >= 0 && off < Tin) v = to_bf16(x[n * Tin + off]);
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

// --- layers 2-5: the conv products on the wgmma block ------------------------

// A conv product's geometry. A's boxes read a conv of `taps` taps, stride
// and pad over a 4-D view (C, stride, T, N) of an activation tensor (3-D,
// (C, T, N), for stride 1): tap j lies at phase (j - pad) mod stride and row
// offset floor((j - pad) / stride).
struct ConvGeom {
  int taps, stride, pad;
  int cin;        // channels of a tap: B's rows per tap
  int tile_k;     // k tiles per tap: cin / 64, at least 1
  int rows;       // rows per sample of the product (its t < rows)
  int row_tiles;  // tiles of rows per sample: 128 rows (taps), 64 (dW's k)
  int col_tiles;  // 128-wide column tiles
  // the taps' products: row (n, t) stored at n out_T + out_stride (t +
  // shift) + z + out_offset when that lies in [0, out_T), where z is
  // blockIdx.z and shift is 1 for z < shift_below, else 0; B's rows of z
  // start at z b_z_rows
  int out_T, out_stride, out_offset, shift_below, b_z_rows;
};

__device__ __forceinline__ void tap_box(const ConvGeom& g, int j, int& ph,
                                        int& off) {
  const int q = j - g.pad;
  ph = ((q % g.stride) + g.stride) % g.stride;
  off = (q - ph) / g.stride;
}

// The forward conv and the lower layer's gradient (`kConvTaps`): blockIdx.x
// = (sample, row tile, column tile), the column fastest; A K-major, the
// tile's rows (n, t0 .. t0 + 127); k tile t is tap t / tile_k, channels
// c0 = 64 (t mod tile_k).
struct ConvTiles {
  static constexpr bool kAK = true;
  ConvGeom g;
  int n, t0, n0, kt0, kt1, shift, brow0;
  __device__ __forceinline__ ConvTiles(const cpc2::WgArgs&,
                                       const ConvGeom& geom)
      : g(geom) {
    const int tile = blockIdx.x / g.col_tiles;
    n0 = (blockIdx.x - tile * g.col_tiles) * cpc2::kWgBN;
    n = tile / g.row_tiles;
    t0 = (tile - n * g.row_tiles) * cpc2::kWgBM;
    kt0 = 0;
    kt1 = g.taps * g.tile_k;
    shift = static_cast<int>(blockIdx.z) < g.shift_below ? 1 : 0;
    brow0 = blockIdx.z * g.b_z_rows;
  }
  __device__ __forceinline__ void load(int t, uint8_t* a, uint8_t* b,
                                       const CUtensorMap* map_a,
                                       const CUtensorMap* map_b,
                                       uint64_t* bar) const {
    const int j = t / g.tile_k, c0 = (t - j * g.tile_k) * kBox;
    int ph, off;
    tap_box(g, j, ph, off);
    const int first = t0 + off + shift;  // may be -1: TMA takes it signed
    if (g.stride == 1)
      cpc2::tma_load_3d(a, map_a, bar, c0, first, n);
    else
      cpc2::tma_load_4d(a, map_a, bar, c0, ph, first, n);
    const int brow = brow0 + j * g.cin + c0;
    cpc2::tma_load(b, map_b, bar, n0, brow);
    cpc2::tma_load(b + cpc2::kWgOperandBytes / 2, map_b, bar, n0 + 64, brow);
  }
  __device__ __forceinline__ long row(int r) const {
    const int t = t0 + r;
    if (t >= g.rows) return -1;
    const int ot = g.out_stride * (t + shift) + static_cast<int>(blockIdx.z) +
                   g.out_offset;
    return ot >= 0 && ot < g.out_T ? (long)n * g.out_T + ot : -1;
  }
};

// dW (`kConvWgrad`): blockIdx.x = (row tile, column tile), the column
// fastest, blockIdx.z the split of k; A M-major, the tile's rows (tap,
// channel) at a stride of 64 tile_k channels a tap (channels from cin on
// are zero-filled and not stored); k tile t is sample t / row_tiles, rows
// t0 = 64 (t mod row_tiles) .. t0 + 63.
struct WgradTiles {
  static constexpr bool kAK = false;
  ConvGeom g;
  int m0, n0, kt0, kt1;
  __device__ __forceinline__ WgradTiles(const cpc2::WgArgs& args,
                                        const ConvGeom& geom)
      : g(geom) {
    const int tile = blockIdx.x / g.col_tiles;
    n0 = (blockIdx.x - tile * g.col_tiles) * cpc2::kWgBN;
    m0 = tile * cpc2::kWgBM;
    kt0 = blockIdx.z * args.k_tiles_per_split;
    kt1 = min(kt0 + args.k_tiles_per_split, args.K / cpc2::kWgBK);
  }
  __device__ __forceinline__ void load(int t, uint8_t* a, uint8_t* b,
                                       const CUtensorMap* map_a,
                                       const CUtensorMap* map_b,
                                       uint64_t* bar) const {
    const int n = t / g.row_tiles, t0 = (t - n * g.row_tiles) * kWgradRows;
    const int tap_rows = g.tile_k * kBox;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m0 + 64 * h, j = mm / tap_rows;
      int ph, off;
      tap_box(g, j, ph, off);
      cpc2::tma_load_4d(a + h * (cpc2::kWgOperandBytes / 2), map_a, bar,
                        mm - j * tap_rows, ph, t0 + off, n);
    }
    cpc2::tma_load_3d(b, map_b, bar, n0, t0, n);
    cpc2::tma_load_3d(b + cpc2::kWgOperandBytes / 2, map_b, bar, n0 + 64, t0,
                      n);
  }
  __device__ __forceinline__ long row(int r) const {
    const int tap_rows = g.tile_k * kBox;
    const int mm = m0 + r, j = mm / tap_rows, ci = mm - j * tap_rows;
    return j < g.taps && ci < g.cin ? (long)j * g.cin + ci : -1;
  }
};

enum ConvKind : int { kConvTaps = 0, kConvWgrad = 1 };

// Every product stores fp32 through the block's kWgStore epilogue: out +
// blockIdx.z * split_stride + row * ldo (+ bias), row from the policy.
template <int kKind>
__global__ void __launch_bounds__(cpc2::kWgThreads, 1)
conv_wgmma_gemm(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, cpc2::WgArgs args,
                ConvGeom geom) {
  using Tiles =
      std::conditional_t<kKind == kConvWgrad, WgradTiles, ConvTiles>;
  cpc2::wgmma_gemm_block<Tiles::kAK, false, cpc2::kWgStore>(
      &map_a, &map_b, args, Tiles(args, geom));
}

template <int kKind>
cudaError_t conv_product(const CUtensorMap& map_a, const CUtensorMap& map_b,
                         const cpc2::WgArgs& args, const ConvGeom& g,
                         dim3 grid, cudaStream_t s) {
  auto kernel = conv_wgmma_gemm<kKind>;
  const cudaError_t err =
      cpc2::set_smem((const void*)kernel, cpc2::kWgSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, cpc2::kWgThreads, cpc2::kWgSmemBytes, s>>>(map_a, map_b,
                                                             args, g);
  return cudaGetLastError();
}

// Activations (N, T_in, C) bf16, T_in = stride * T, as the tensor (C,
// stride, T, N), or (C, T, N) for stride 1, read in boxes of 64 channels x
// `rows` rows with the 128-byte swizzle; zeros out of range.
cudaError_t act_map(CUtensorMap* map, const bf16* p, int N, int T,
                    int stride, int C, int rows) {
  cpc2::EncodeTiledFn encode = cpc2::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  const cuuint64_t c = C, row = 2ull * C;  // a row of C channels, in bytes
  const cuuint64_t dims4[4] = {c, (cuuint64_t)stride, (cuuint64_t)T,
                               (cuuint64_t)N};
  const cuuint64_t strides4[3] = {row, stride * row, stride * row * T};
  const cuuint32_t box4[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint64_t dims3[3] = {c, (cuuint64_t)T, (cuuint64_t)N};
  const cuuint64_t strides3[2] = {row, row * T};
  const cuuint32_t box3[3] = {kBox, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const bool flat = stride == 1;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, flat ? 3 : 4,
      const_cast<bf16*>(p), flat ? dims3 : dims4, flat ? strides3 : strides4,
      flat ? box3 : box4, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A weight pack of `rows` rows of C bf16 ([k][n], read N-major), in boxes of
// 64 x 64; columns past C and rows past the pack are zeros.
cudaError_t pack_map(CUtensorMap* map, const bf16* p, long rows, int C) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  return cpc2::bf16_tensor_map(map, p, C, rows, kBox);
}

long cdiv(long a, long b) { return (a + b - 1) / b; }

// Frames after each layer, element offsets of each layer's activations (N,
// T_l, C) and weights in their packed buffers, the products' tiles and
// splits, and the backward's scratch floats: ops/encoder.py:encoder_plan
// computes the same.
struct Plan {
  int T[kLayers];
  long act_off[kLayers], w_off[kLayers], wt_off[kLayers];
  int tile_k, col_tiles;
  // dW of layers 2-5: k tiles per split and splits
  int wg_per[kLayers], wg_splits[kLayers];
  // layer 1's dW: rows per split and splits
  long w1_rows, w1_splits;
  long part_len;
  Plan(int N, int T0, int C, int sms) {
    long act = 0, wo = 0, wt = 0;
    int t = T0;
    tile_k = std::max(1, C / kBox);
    col_tiles = (int)cdiv(C, cpc2::kWgBN);
    const long M1 = (long)N * (T0 / kStride[0]);
    part_len = 0;
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
      wg_per[l] = wg_splits[l] = 0;
      if (l == 0 || N == 0) continue;
      const long k_tiles = (long)N * cdiv(t, kWgradRows);
      const long tiles =
          cdiv((long)kKernel[l] * tile_k * kBox, cpc2::kWgBM) * col_tiles;
      const long s = std::min(std::max(1L, sms / tiles), k_tiles);
      wg_per[l] = (int)cdiv(k_tiles, s);
      wg_splits[l] = (int)cdiv(k_tiles, wg_per[l]);
      part_len = std::max(part_len, (long)wg_splits[l] * kKernel[l] * C * C);
    }
    w1_rows = w1_splits = 0;
    if (N == 0) return;
    const long tiles1 = cdiv(C, kWTile) * cdiv(kTaps1, kWTile);
    w1_splits = std::max(1L, std::min(kWBlocks / tiles1, cdiv(M1, 256)));
    w1_rows = cdiv(cdiv(M1, w1_splits), kWSlice) * kWSlice;
    w1_splits = cdiv(M1, w1_rows);
    part_len = std::max(part_len, w1_splits * kTaps1 * C);
    part_len = std::max(part_len, cdiv(M1, kNormRows) * 3 * C);
  }
};

// The forward conv of layer l (1-4), or the lower layer's gradient (`dgrad`).
ConvGeom taps_geom(const Plan& p, int l, int C, bool dgrad) {
  ConvGeom g{};
  g.cin = C;
  g.tile_k = p.tile_k;
  g.rows = p.T[l];
  g.row_tiles = (int)cdiv(p.T[l], cpc2::kWgBM);
  g.col_tiles = p.col_tiles;
  if (dgrad) {  // dy rows a - 1 and a
    g.taps = 2;
    g.stride = 1;
    g.pad = 1;
    g.out_T = p.T[l - 1];
    g.out_stride = kStride[l];
    g.out_offset = -kPad[l];
    g.shift_below = kPad[l];
    g.b_z_rows = 2 * C;
  } else {
    g.taps = kKernel[l];
    g.stride = kStride[l];
    g.pad = kPad[l];
    g.out_T = p.T[l];
    g.out_stride = 1;
  }
  return g;
}

ConvGeom wgrad_geom(const Plan& p, int l, int C) {
  ConvGeom g{};
  g.taps = kKernel[l];
  g.stride = kStride[l];
  g.pad = kPad[l];
  g.cin = C;
  g.tile_k = p.tile_k;
  g.rows = p.T[l];
  g.row_tiles = (int)cdiv(p.T[l], kWgradRows);
  g.col_tiles = p.col_tiles;
  return g;
}

cpc2::WgArgs store_args(int M, int N, int K, float* out, long ldo) {
  cpc2::WgArgs a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.out = out;
  a.ldo = ldo;
  return a;
}

template <int CPL>
cudaError_t launch_layer1(const ConvArgs& a, cudaStream_t s) {
  conv_gemm<CPL><<<(unsigned)cdiv(a.M, kBM), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t launch_norm_fwd(const float* y, const float* nw, const float* nb,
                            long M, bf16* out_bf16, float* out_f32,
                            cudaStream_t s) {
  const unsigned grid = (unsigned)cdiv(M, kWarps);
  if (out_bf16)
    norm_fwd<CPL, bf16><<<grid, kThreads, 0, s>>>(y, nw, nb, M, out_bf16);
  else
    norm_fwd<CPL, float><<<grid, kThreads, 0, s>>>(y, nw, nb, M, out_f32);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t launch_norm_bwd(const float* y, const float* dh, const float* nw,
                            const float* nb, long M, bf16* dy, float* part,
                            cudaStream_t s) {
  norm_bwd<CPL><<<(unsigned)cdiv(M, kNormRows), kThreads, 0, s>>>(
      y, dh, nw, nb, M, dy, part);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t launch_taps(const bf16* dy, const bf16* w1, long M, float* P,
                        cudaStream_t s) {
  input_taps<CPL><<<(unsigned)cdiv(M, kWarps), kThreads, 0, s>>>(dy, w1, M,
                                                                 P);
  return cudaGetLastError();
}

// The kernels templated on CPL = C / 32, at C.
#define CPC2_BY_WIDTH(C, fn, ...)            \
  switch (C) {                               \
    case 32: return fn<1>(__VA_ARGS__);      \
    case 64: return fn<2>(__VA_ARGS__);      \
    case 128: return fn<4>(__VA_ARGS__);     \
    case 256: return fn<8>(__VA_ARGS__);     \
    default: return cudaErrorInvalidValue;   \
  }

cudaError_t layer1_forward(int C, const ConvArgs& a, cudaStream_t s) {
  CPC2_BY_WIDTH(C, launch_layer1, a, s)
}

cudaError_t norm_forward(int C, const float* y, const float* nw,
                         const float* nb, long M, bf16* out_bf16,
                         float* out_f32, cudaStream_t s) {
  CPC2_BY_WIDTH(C, launch_norm_fwd, y, nw, nb, M, out_bf16, out_f32, s)
}

cudaError_t norm_backward(int C, const float* y, const float* dh,
                          const float* nw, const float* nb, long M, bf16* dy,
                          float* part, cudaStream_t s) {
  CPC2_BY_WIDTH(C, launch_norm_bwd, y, dh, nw, nb, M, dy, part, s)
}

cudaError_t taps_backward(int C, const bf16* dy, const bf16* w1, long M,
                          float* P, cudaStream_t s) {
  CPC2_BY_WIDTH(C, launch_taps, dy, w1, M, P, s)
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
// pre: the five pre-norm outputs (N, T_l, C) fp32, in order, or nullptr;
// then scratch holds N * T_2 * C floats for layers 2-5's pre-norm outputs.
int cpc2_encoder_fwd(const float* x, const bf16* wpack, const float* bias,
                     const float* nw, const float* nb, bf16* acts, float* pre,
                     float* scratch, float* out, int N, int T, int C,
                     void* stream) {
  if (N == 0) return 0;
  if (C != 32 && C != 64 && C != 128 && C != 256)
    return (int)cudaErrorInvalidValue;
  if (pre == nullptr && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan(N, T, C, cpc2::sm_count());
  const ConvArgs a1{x, T, plan.T[0], (long)N * plan.T[0], wpack, bias, nw,
                    nb, pre, acts};
  CPC2_TRY(layer1_forward(C, a1, s));
  for (int l = 1; l < kLayers; ++l) {
    const long M = (long)N * plan.T[l];
    float* y = pre ? pre + plan.act_off[l] : scratch;
    CUtensorMap map_a, map_b;
    CPC2_TRY(act_map(&map_a, acts + plan.act_off[l - 1], N, plan.T[l],
                     kStride[l], C, cpc2::kWgBM));
    CPC2_TRY(pack_map(&map_b, wpack + plan.w_off[l], (long)kKernel[l] * C, C));
    const ConvGeom g = taps_geom(plan, l, C, false);
    cpc2::WgArgs args = store_args((int)M, C, kKernel[l] * C, y, C);
    args.bias = bias + l * C;
    CPC2_TRY(conv_product<kConvTaps>(
        map_a, map_b, args, g,
        dim3((unsigned)((long)N * g.row_tiles * g.col_tiles), 1, 1), s));
    const bool last = l == kLayers - 1;
    CPC2_TRY(norm_forward(C, y, nw + l * C, nb + l * C, M,
                          last ? nullptr : acts + plan.act_off[l],
                          last ? out : nullptr, s));
  }
  return 0;
}

// Backward from gz (N, T/160, C) fp32. wpack, nw, nb, acts and pre as the
// forward gave them; wtpack: for layers 2-5, per phase ph < stride, the
// (2C, C) bf16 matrix [W[:, :, ph + stride]^T; W[:, :, ph]^T], in order.
// Out: dwpack (fp32, wpack's layout), dnorm (5, 3, C) = (db, dnw, dnb) per
// layer, dx (N, T). Scratch: dh (N*T_1*C fp32), dy (N*T_1*C bf16) and part
// (part_len fp32, which must be the plan's: ops/encoder.py:encoder_plan).
int cpc2_encoder_bwd(const float* x, const float* gz, const bf16* wpack,
                     const bf16* wtpack, const float* nw, const float* nb,
                     const bf16* acts, const float* pre, float* dwpack,
                     float* dnorm, float* dx, float* dh, bf16* dy, float* part,
                     long part_len, int N, int T, int C, void* stream) {
  if (N == 0) return 0;
  if (C != 32 && C != 64 && C != 128 && C != 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan(N, T, C, cpc2::sm_count());
  if (part_len != plan.part_len) return (int)cudaErrorInvalidValue;
  for (int l = kLayers - 1; l >= 0; --l) {
    const long M = (long)N * plan.T[l];
    // dy and the per-layer sums of dy, da * xhat and da
    CPC2_TRY(norm_backward(C, pre + plan.act_off[l], l == kLayers - 1 ? gz : dh,
                           nw + l * C, nb + l * C, M, dy, part, s));
    CPC2_TRY(reduce_rows(part, cdiv(M, kNormRows), 3L * C, dnorm + 3L * l * C,
                         s));
    if (l == 0) {
      // dW, then dx: the ten taps of every layer-1 row, then the two per
      // sample
      const dim3 wgrid((unsigned)cdiv(C, kWTile),
                       (unsigned)cdiv(kTaps1, kWTile),
                       (unsigned)plan.w1_splits);
      conv_wgrad<<<wgrid, kThreads, 0, s>>>(x, T, plan.T[0], M, dy, C,
                                            plan.w1_rows, part);
      CPC2_TRY(cudaGetLastError());
      CPC2_TRY(reduce_rows(part, plan.w1_splits, (long)kTaps1 * C,
                           dwpack + plan.w_off[0], s));
      CPC2_TRY(taps_backward(C, dy, wpack + plan.w_off[0], M, dh, s));
      const long n_x = (long)N * T;
      input_overlap<<<(unsigned)cdiv(n_x, 256), 256, 0, s>>>(dh, N, T,
                                                             plan.T[0], dx);
      CPC2_TRY(cudaGetLastError());
      continue;
    }
    // dW = A^T dy in split partials, then the splits summed
    const long KC = (long)kKernel[l] * C;
    CUtensorMap map_in, map_dy, map_dy_rows, map_wt;
    CPC2_TRY(act_map(&map_in, acts + plan.act_off[l - 1], N, plan.T[l],
                     kStride[l], C, kWgradRows));
    CPC2_TRY(act_map(&map_dy, dy, N, plan.T[l], 1, C, kWgradRows));
    const ConvGeom gw = wgrad_geom(plan, l, C);
    cpc2::WgArgs wargs =
        store_args((int)(kKernel[l] * plan.tile_k * kBox), C,
                   N * gw.row_tiles * kWgradRows, part, C);
    wargs.k_tiles_per_split = plan.wg_per[l];
    wargs.split_stride = KC * C;
    const unsigned m_tiles =
        (unsigned)cdiv((long)kKernel[l] * plan.tile_k * kBox, cpc2::kWgBM);
    CPC2_TRY(conv_product<kConvWgrad>(
        map_in, map_dy, wargs, gw,
        dim3(m_tiles * gw.col_tiles, 1, (unsigned)plan.wg_splits[l]), s));
    CPC2_TRY(reduce_rows(part, plan.wg_splits[l], KC * C,
                         dwpack + plan.w_off[l], s));
    // dh of the layer below, one grid slice per phase of the stride
    CPC2_TRY(act_map(&map_dy_rows, dy, N, plan.T[l], 1, C, cpc2::kWgBM));
    CPC2_TRY(pack_map(&map_wt, wtpack + plan.wt_off[l],
                      (long)kStride[l] * 2 * C, C));
    const ConvGeom gd = taps_geom(plan, l, C, true);
    const cpc2::WgArgs dargs = store_args((int)M, C, 2 * C, dh, C);
    CPC2_TRY(conv_product<kConvTaps>(
        map_dy_rows, map_wt, dargs, gd,
        dim3((unsigned)((long)N * gd.row_tiles * gd.col_tiles), 1,
             (unsigned)kStride[l]),
        s));
  }
  return 0;
}

}  // extern "C"
