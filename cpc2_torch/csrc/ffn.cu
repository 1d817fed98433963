// Position-wise FFN of the transformer prediction heads,
// y = lin2(dropout(relu(lin1(x)))), forward and backward, for Hopper.
//
// Replaces the TPU kernel cpc2_tpu/ops/ffn_pallas.py (`_fwd_call`,
// `_bwd_call`, `fused_ffn`). Same contract: torch-layout weights W1 (Dff,
// Din) and W2 (Dout, Dff), a dropout mask drawn inside the kernel from a
// seed, and a backward that recomputes the hidden and its mask from that
// seed instead of saving them. The seed lives in device memory, so the
// caller draws it on the card and never waits for it.
//
// What bounds it: at the recipe (M = 928 rows, 256 -> 2048 -> 256) the two
// products are 1.9 GFLOP per head forward, far above the card's
// FLOP-per-byte balance, so it is bound by operations. Two routes, one per
// `--precision`:
//
// - bf16 (`cpc2_ffn_{fwd,bwd}_bf16`, the default `bf16mix`): single-pass
//   bf16 products with fp32 accumulation, as the JAX package's kernel takes
//   them on the TPU. One launch casts the fp32 operands to bf16; every
//   product is the TMA + wgmma GEMM of hopper_gemm.cuh with its epilogue
//   fused (bias + ReLU + dropout to a bf16 hidden; the dropout and ReLU
//   gradient in place on that hidden, with db1's column sums; fp32 stores);
//   the narrow products (y, dx) and the weight gradients split K over the
//   SMs, and one last launch sums every split's partials and the bias
//   sums' per-block partials in a fixed order. The bf16 hidden (M x Dff,
//   3.8 MB at the recipe) goes through device memory and stays in L2
//   between its two products. Its bf16-in/bf16-out variant
//   (`cpc2_ffn_{fwd,bwd}_bf16io`, `--precision bf16`, where the heads'
//   activations are bf16) reads x and the incoming gradient as they come,
//   so the cast launch takes the weights only (and db2's sums of the bf16
//   g), and y and dx are summed in fp32 by the last launch, bias and split
//   partials included, and rounded to bf16 once there, as the TPU kernel
//   rounds its fp32 output block once.
// - fp32 (`cpc2_ffn_{fwd,bwd}`, `--precision fp32`): the same products at
//   fp32 accuracy, in 3xTF32 on the tensor cores (`ffn_tf32x3_gemm` of
//   hopper_gemm.cuh): each operand as two TF32 planes, big and small, both
//   K-major, since the TF32 `wgmma` reads no other layout. One launch
//   (`ffn_split_tf32`) splits the operands into their planes, transposing
//   those a product reads M- or N-major (x^T, g^T, W1^T, W2^T), and takes
//   db2's per-tile column sums of g; the hidden product's epilogue writes
//   the hidden's planes in the layout the next product reads (forward:
//   (M, Dff) for y; backward: (Dff, M) for dW2, and the hidden's signs, 64
//   bits a thread), and the dh epilogue reads those bits back (the two
//   products share tiles and fragments) and writes dh's planes both ways,
//   (M, Dff) for dx and, in place of the hidden's, (Dff, M) for dW1, with
//   db1's column sums per 128-row tile. The hidden and dh products are never
//   split over K (the backward's hidden is bit for bit the forward's); the
//   others split as the host's plan says (`ops/ffn.py:ffn_fp32_plan`), and
//   one last launch sums every split's partials and the bias sums' partials
//   in a fixed order: no atomics, the backward the same bit for bit from
//   call to call. The planes' rows are padded to 4 floats for TMA, so any
//   M, Din, Dff and Dout are taken. A forward is 4 launches, a backward 7.
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using cpc2::bf16;

// --- bf16 route: operand casts and the fixed-order sums ---------------------

constexpr int kCastThreads = 256;
constexpr int kSumRows = 16;  // rows of g per block of db2's partial sums
constexpr int kMaxCast = 4, kMaxSum = 5;

struct CastSeg {
  const float* src;
  bf16* dst;
  long n;  // a multiple of 8
};

struct CastArgs {
  CastSeg seg[kMaxCast];
  int nseg;
  // with colsum_rows > 0: partial[b][c] = sum of colsum_src (or, where it
  // is set, of the bf16 colsum_src16) over rows [kSumRows b, kSumRows (b +
  // 1)), column c, for the (rows, cols) matrix
  const float* colsum_src;
  int colsum_rows, colsum_cols;
  float* partial;
  const bf16* colsum_src16;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Four bf16 values (8 bytes) as floats.
__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// blockIdx.y < nseg: a vectorised fp32 -> bf16 cast of segment y, 8 values a
// thread; blockIdx.y == nseg: db2's per-block column sums of g.
__global__ void __launch_bounds__(kCastThreads)
ffn_cast_bf16(CastArgs a) {
  const int y = blockIdx.y;
  if (y < a.nseg) {
    CastSeg s = a.seg[0];
#pragma unroll
    for (int i = 1; i < kMaxCast; ++i)  // constant indices: no stack copy
      if (i == y) s = a.seg[i];
    const long n8 = s.n / 8;
    for (long i = blockIdx.x * static_cast<long>(kCastThreads) + threadIdx.x;
         i < n8; i += static_cast<long>(gridDim.x) * kCastThreads) {
      const float4 lo = reinterpret_cast<const float4*>(s.src)[2 * i];
      const float4 hi = reinterpret_cast<const float4*>(s.src)[2 * i + 1];
      reinterpret_cast<uint4*>(s.dst)[i] =
          make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                     pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    }
    return;
  }
  const int blocks = (a.colsum_rows + kSumRows - 1) / kSumRows;
  const int c4n = a.colsum_cols / 4;
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int r0 = b * kSumRows;
    const int r1 = min(r0 + kSumRows, a.colsum_rows);
    for (int c4 = threadIdx.x; c4 < c4n; c4 += kCastThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = r0; r < r1; ++r) {
        const long at = static_cast<long>(r) * a.colsum_cols + 4 * c4;
        const float4 v =
            a.colsum_src16 ? load_bf16x4(a.colsum_src16 + at)
                           : *reinterpret_cast<const float4*>(a.colsum_src + at);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      reinterpret_cast<float4*>(
          a.partial + static_cast<long>(b) * a.colsum_cols)[c4] = acc;
    }
  }
}

cudaError_t cast_bf16(CastArgs a, cudaStream_t stream) {
  long most = 0;
  for (int i = 0; i < a.nseg; ++i) most = a.seg[i].n > most ? a.seg[i].n : most;
  long blocks = (most / 8 + kCastThreads - 1) / kCastThreads;
  const long sum_blocks = (a.colsum_rows + kSumRows - 1) / kSumRows;
  blocks = blocks > sum_blocks ? blocks : sum_blocks;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  dim3 grid(static_cast<unsigned>(blocks), a.nseg + (a.colsum_rows > 0));
  ffn_cast_bf16<<<grid, kCastThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

struct SumSeg {
  const float* part;  // count partials of n values, `stride` apart
  long stride, n;
  int count;
  const float* bias;  // nullptr, or `cols` values added per row
  int cols;
  float* out;
  bf16* out16;        // or, where set, the sums rounded to bf16 here
};

struct SumArgs {
  SumSeg seg[kMaxSum];
  int nseg;
};

// out = part[0] + part[1] + ... (+ bias), in that order; 4 values a thread
// where every row of values starts 16-byte aligned, else one.
__global__ void __launch_bounds__(kCastThreads)
ffn_sum_partials(SumArgs a) {
  SumSeg s = a.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSum; ++i)
    if (i == static_cast<int>(blockIdx.y)) s = a.seg[i];
  const bool vec =
      s.n % 4 == 0 && s.stride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(s.part) % 16 == 0) &&
      (s.out16 ? reinterpret_cast<uintptr_t>(s.out16) % 8 == 0
               : reinterpret_cast<uintptr_t>(s.out) % 16 == 0) &&
      (s.bias == nullptr ||
       (s.cols % 4 == 0 && reinterpret_cast<uintptr_t>(s.bias) % 16 == 0));
  const long step = static_cast<long>(gridDim.x) * kCastThreads;
  if (!vec) {
    for (long i = blockIdx.x * static_cast<long>(kCastThreads) + threadIdx.x;
         i < s.n; i += step) {
      float acc = s.part[i];
      for (int r = 1; r < s.count; ++r) acc += s.part[i + r * s.stride];
      if (s.bias) acc += s.bias[i % s.cols];
      if (s.out16)
        s.out16[i] = __float2bfloat16_rn(acc);
      else
        s.out[i] = acc;
    }
    return;
  }
  const long n4 = s.n / 4;
  for (long i = blockIdx.x * static_cast<long>(kCastThreads) + threadIdx.x;
       i < n4; i += step) {
    float4 acc = reinterpret_cast<const float4*>(s.part)[i];
    for (int r = 1; r < s.count; ++r) {
      const float4 v = reinterpret_cast<const float4*>(s.part + r * s.stride)[i];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    if (s.bias) {
      const float4 b = reinterpret_cast<const float4*>(s.bias)[i % (s.cols / 4)];
      acc.x += b.x; acc.y += b.y; acc.z += b.z; acc.w += b.w;
    }
    if (s.out16)
      reinterpret_cast<uint2*>(s.out16)[i] =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    else
      reinterpret_cast<float4*>(s.out)[i] = acc;
  }
}

cudaError_t sum_partials(SumArgs a, cudaStream_t stream) {
  if (a.nseg == 0) return cudaSuccess;
  long most = 0;
  for (int i = 0; i < a.nseg; ++i) most = a.seg[i].n > most ? a.seg[i].n : most;
  long blocks = (most / 4 + kCastThreads - 1) / kCastThreads;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  dim3 grid(static_cast<unsigned>(blocks), a.nseg);
  ffn_sum_partials<<<grid, kCastThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The workspace: bf16 copies of the operands and the hidden, then fp32
// partials. Every region starts on a 256-byte boundary.
struct Workspace {
  char* base;
  size_t used;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

cpc2::SplitK whole_k(int K) {
  return {(K + cpc2::kWgBK - 1) / cpc2::kWgBK, 1};
}

cpc2::WgArgs gemm_args(int M, int N, int K) {
  cpc2::WgArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

// A store product's output: the result itself when K is not split, else
// its partials, summed into `out` (with `bias`) by the last launch. With
// `out16` always its partials (one where K is not split), summed and
// rounded to bf16 into `out16` by the last launch.
template <typename Args>
void store_to(Args* g, cpc2::SplitK split, Workspace* ws, float* out,
              const float* bias, SumArgs* sums, bf16* out16 = nullptr) {
  g->ldo = g->N;
  if (split.splits == 1 && out16 == nullptr) {
    g->out = out;
    g->bias = bias;
    return;
  }
  const long n = static_cast<long>(g->M) * g->N;
  g->out = ws->take<float>(static_cast<size_t>(n) * split.splits);
  g->split_stride = n;
  g->bias = nullptr;
  sums->seg[sums->nseg++] = {g->out, n, n, split.splits, bias, g->N, out,
                             out16};
}

// The bf16 forward on workspace `ws` (sizes only when ws.base is null).
// With `io`, x and y are bf16 (the bf16-in/bf16-out variant), else fp32.
cudaError_t ffn_fwd_bf16(Workspace* ws, bool io, const void* x,
                         const float* w1, const float* b1, const float* w2,
                         const float* b2, const unsigned* seed, void* y,
                         int M, int Din, int Dff, int Dout,
                         unsigned threshold, float scale, cudaStream_t s) {
  bf16* xb = io ? static_cast<bf16*>(const_cast<void*>(x))
                : ws->take<bf16>(static_cast<size_t>(M) * Din);
  bf16* w1b = ws->take<bf16>(static_cast<size_t>(Dff) * Din);
  bf16* w2b = ws->take<bf16>(static_cast<size_t>(Dout) * Dff);
  bf16* hb = ws->take<bf16>(static_cast<size_t>(M) * Dff);
  SumArgs sums = {};
  const cpc2::SplitK split_y = cpc2::split_k(M, Dout, Dff);
  cpc2::WgArgs gy = gemm_args(M, Dout, Dff);
  store_to(&gy, split_y, ws, io ? nullptr : static_cast<float*>(y), b2,
           &sums, io ? static_cast<bf16*>(y) : nullptr);
  if (ws->base == nullptr) return cudaSuccess;

  CastArgs cast = {};
  if (!io)
    cast.seg[cast.nseg++] = {static_cast<const float*>(x), xb,
                             static_cast<long>(M) * Din};
  cast.seg[cast.nseg++] = {w1, w1b, static_cast<long>(Dff) * Din};
  cast.seg[cast.nseg++] = {w2, w2b, static_cast<long>(Dout) * Dff};
  cudaError_t err = cast_bf16(cast, s);
  if (err != cudaSuccess) return err;
  // hidden = bf16(dropout(relu(x W1^T + b1)))
  cpc2::WgArgs gh = gemm_args(M, Dff, Din);
  gh.bias = b1;
  gh.hidden = hb;
  gh.ldh = Dff;
  gh.seed = seed;
  gh.threshold = threshold;
  gh.scale = scale;
  err = cpc2::wgmma_gemm<true, true, cpc2::kWgHidden>(xb, w1b, gh,
                                                      whole_k(Din), s);
  if (err != cudaSuccess) return err;
  // y = hidden W2^T + b2
  err = cpc2::wgmma_gemm<true, true, cpc2::kWgStore>(hb, w2b, gy, split_y, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sums, s);
}

// The bf16 backward on workspace `ws` (sizes only when ws.base is null).
// With `io`, x, g and dx are bf16 (the bf16-in/bf16-out variant), else
// fp32; the weights' gradients are fp32 either way.
cudaError_t ffn_bwd_bf16(Workspace* ws, bool io, const void* x,
                         const float* w1, const float* b1, const float* w2,
                         const void* g, const unsigned* seed, void* dx,
                         float* dw1, float* db1, float* dw2, float* db2,
                         int M, int Din, int Dff, int Dout,
                         unsigned threshold, float scale, cudaStream_t s) {
  bf16* xb = io ? static_cast<bf16*>(const_cast<void*>(x))
                : ws->take<bf16>(static_cast<size_t>(M) * Din);
  bf16* w1b = ws->take<bf16>(static_cast<size_t>(Dff) * Din);
  bf16* w2b = ws->take<bf16>(static_cast<size_t>(Dout) * Dff);
  bf16* gb = io ? static_cast<bf16*>(const_cast<void*>(g))
                : ws->take<bf16>(static_cast<size_t>(M) * Dout);
  bf16* hb = ws->take<bf16>(static_cast<size_t>(M) * Dff);
  const int row_blocks = (M + kSumRows - 1) / kSumRows;
  float* db2_part = ws->take<float>(static_cast<size_t>(row_blocks) * Dout);
  const int m_tiles = (M + cpc2::kWgBM - 1) / cpc2::kWgBM;
  float* db1_part = ws->take<float>(static_cast<size_t>(m_tiles) * Dff);
  SumArgs sums = {};
  sums.seg[sums.nseg++] = {db2_part, Dout, Dout, row_blocks, nullptr, Dout,
                           db2};
  sums.seg[sums.nseg++] = {db1_part, Dff, Dff, m_tiles, nullptr, Dff, db1};
  const cpc2::SplitK split_dw2 = cpc2::split_k(Dout, Dff, M);
  const cpc2::SplitK split_dw1 = cpc2::split_k(Dff, Din, M);
  const cpc2::SplitK split_dx = cpc2::split_k(M, Din, Dff);
  cpc2::WgArgs gw2 = gemm_args(Dout, Dff, M);
  store_to(&gw2, split_dw2, ws, dw2, nullptr, &sums);
  cpc2::WgArgs gw1 = gemm_args(Dff, Din, M);
  store_to(&gw1, split_dw1, ws, dw1, nullptr, &sums);
  cpc2::WgArgs gx = gemm_args(M, Din, Dff);
  store_to(&gx, split_dx, ws, io ? nullptr : static_cast<float*>(dx),
           nullptr, &sums, io ? static_cast<bf16*>(dx) : nullptr);
  if (ws->base == nullptr) return cudaSuccess;

  CastArgs cast = {};
  if (!io)
    cast.seg[cast.nseg++] = {static_cast<const float*>(x), xb,
                             static_cast<long>(M) * Din};
  cast.seg[cast.nseg++] = {w1, w1b, static_cast<long>(Dff) * Din};
  cast.seg[cast.nseg++] = {w2, w2b, static_cast<long>(Dout) * Dff};
  if (io) {
    cast.colsum_src16 = gb;  // db2 = sum_m g, in fp32 from the bf16 g
  } else {
    cast.seg[cast.nseg++] = {static_cast<const float*>(g), gb,
                             static_cast<long>(M) * Dout};
    cast.colsum_src = static_cast<const float*>(g);  // db2 before rounding
  }
  cast.colsum_rows = M;
  cast.colsum_cols = Dout;
  cast.partial = db2_part;
  cudaError_t err = cast_bf16(cast, s);
  if (err != cudaSuccess) return err;
  // hidden = the forward's bf16 hidden, recomputed
  cpc2::WgArgs gh = gemm_args(M, Dff, Din);
  gh.bias = b1;
  gh.hidden = hb;
  gh.ldh = Dff;
  gh.seed = seed;
  gh.threshold = threshold;
  gh.scale = scale;
  err = cpc2::wgmma_gemm<true, true, cpc2::kWgHidden>(xb, w1b, gh,
                                                      whole_k(Din), s);
  if (err != cudaSuccess) return err;
  // dW2[o, f] = sum_m g[m, o] hidden[m, f]: A = g^T (M-major), B = hidden
  // (N-major)
  err = cpc2::wgmma_gemm<false, false, cpc2::kWgStore>(gb, hb, gw2, split_dw2,
                                                       s);
  if (err != cudaSuccess) return err;
  // dh = bf16((g W2) * mask * scale) in place of the hidden; db1's column
  // sums of the unrounded dh per 128-row tile. B = W2 read N-major.
  cpc2::WgArgs gd = gemm_args(M, Dff, Dout);
  gd.hidden = hb;
  gd.ldh = Dff;
  gd.scale = scale;
  gd.colsum = db1_part;
  err = cpc2::wgmma_gemm<true, false, cpc2::kWgHiddenGrad>(gb, w2b, gd,
                                                           whole_k(Dout), s);
  if (err != cudaSuccess) return err;
  // dW1[f, d] = sum_m dh[m, f] x[m, d]: A = dh^T (M-major), B = x (N-major)
  err = cpc2::wgmma_gemm<false, false, cpc2::kWgStore>(hb, xb, gw1, split_dw1,
                                                       s);
  if (err != cudaSuccess) return err;
  // dx = dh W1: B = W1 read N-major
  err = cpc2::wgmma_gemm<true, false, cpc2::kWgStore>(hb, w1b, gx, split_dx,
                                                      s);
  if (err != cudaSuccess) return err;
  return sum_partials(sums, s);
}

// --- fp32 route: the operands' TF32 planes, the 3xTF32 products ------------

constexpr int kSplitTile = 32;  // a block of the split pass: 32 x 32 values
constexpr int kMaxSplit = 8;

struct SplitSeg {
  const float* src;  // rows x cols, row-major
  int rows, cols;
  cpc2::Planes dst;  // src as (rows, ld) planes, or src^T as (cols, ld)
  int transpose;
  float* colsum;     // or nullptr: colsum[t][c] = the sum of src[., c] over
                     // rows [32 t, 32 t + 32), in order
  int first;         // the segment's first block
};

struct SplitArgs {
  SplitSeg seg[kMaxSplit];
  int nseg, blocks;
};

__device__ __forceinline__ void put_split(const cpc2::Planes& p, long r,
                                          long c, float v) {
  float big, small;
  cpc2::tf32_split(v, big, small);
  p.p[r * p.ld + c] = big;
  p.p[r * p.ld + c + p.plane] = small;
}

// Block b of segment s splits a 32 x 32 tile of s.src into its planes,
// through shared memory where it transposes, and takes the tile's column
// sums where s.colsum is set.
__global__ void __launch_bounds__(kCastThreads)
ffn_split_tf32(SplitArgs a) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];
  SplitSeg s = a.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSplit; ++i)  // constant indices: no stack copy
    if (i < a.nseg && static_cast<int>(blockIdx.x) >= a.seg[i].first)
      s = a.seg[i];
  const int t = blockIdx.x - s.first;
  const int tiles_c = (s.cols + kSplitTile - 1) / kSplitTile;
  const int r0 = t / tiles_c * kSplitTile, c0 = t % tiles_c * kSplitTile;
  const int tx = threadIdx.x % kSplitTile, ty = threadIdx.x / kSplitTile;
  constexpr int kRowsStep = kCastThreads / kSplitTile;
  for (int i = ty; i < kSplitTile; i += kRowsStep) {
    const int r = r0 + i, c = c0 + tx;
    const bool in = r < s.rows && c < s.cols;
    const float v = in ? s.src[static_cast<long>(r) * s.cols + c] : 0.f;
    tile[i][tx] = v;
    if (in && !s.transpose) put_split(s.dst, r, c, v);
  }
  if (!s.transpose && s.colsum == nullptr) return;
  __syncthreads();
  if (s.transpose) {
    for (int i = ty; i < kSplitTile; i += kRowsStep) {
      const int c = c0 + i, r = r0 + tx;
      if (c < s.cols && r < s.rows) put_split(s.dst, c, r, tile[tx][i]);
    }
  }
  if (s.colsum && ty == 0 && c0 + tx < s.cols) {
    float sum = 0.f;
    for (int i = 0; i < kSplitTile && r0 + i < s.rows; ++i) sum += tile[i][tx];
    s.colsum[static_cast<long>(t / tiles_c) * s.cols + c0 + tx] = sum;
  }
}

void add_split(SplitArgs* a, const float* src, int rows, int cols,
               cpc2::Planes dst, bool transpose, float* colsum = nullptr) {
  if (rows <= 0 || cols <= 0) return;
  const int tiles = ((rows + kSplitTile - 1) / kSplitTile) *
                    ((cols + kSplitTile - 1) / kSplitTile);
  a->seg[a->nseg++] = {src, rows, cols, dst, transpose, colsum, a->blocks};
  a->blocks += tiles;
}

cudaError_t split_planes(const SplitArgs& a, cudaStream_t stream) {
  if (a.blocks == 0) return cudaSuccess;
  ffn_split_tf32<<<a.blocks, kCastThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

long up4(int n) { return (n + 3) / 4 * 4; }

// Two planes of rows x ld floats.
cpc2::Planes take_planes(Workspace* ws, int rows, long ld) {
  const long plane = static_cast<long>(rows) * ld;
  return {ws->take<float>(static_cast<size_t>(2 * plane)), ld, plane};
}

// A product's split of its K into runs of `per` k tiles (at least one run).
cpc2::SplitK tf_split(int K, int per) {
  const int k_tiles = (K + cpc2::kTfBK - 1) / cpc2::kTfBK;
  return {per, k_tiles > 0 ? (k_tiles + per - 1) / per : 1};
}

cpc2::TfArgs tf_args(int M, int N, int K, int per) {
  cpc2::TfArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  g.k_tiles_per_split = per;
  return g;
}

// A product that is never split over K.
int whole(int K) {
  const int k_tiles = (K + cpc2::kTfBK - 1) / cpc2::kTfBK;
  return k_tiles > 0 ? k_tiles : 1;
}

// The fp32 forward on workspace `ws` (sizes only when ws.base is null); y's
// product split into runs of per_y k tiles.
cudaError_t ffn_fwd_fp32(Workspace* ws, const float* x, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const unsigned* seed, float* y, int M, int Din,
                         int Dff, int Dout, int per_y, unsigned threshold,
                         float scale, cudaStream_t s) {
  if (M <= 0 || Din < 0 || Dff < 0 || Dout < 0 || per_y <= 0)
    return cudaErrorInvalidValue;
  const long ld_din = up4(Din), ld_dff = up4(Dff);
  const cpc2::Planes xp = take_planes(ws, M, ld_din);
  const cpc2::Planes w1p = take_planes(ws, Dff, ld_din);
  const cpc2::Planes w2p = take_planes(ws, Dout, ld_dff);
  const cpc2::Planes hp = take_planes(ws, M, ld_dff);
  SumArgs sums = {};
  cpc2::TfArgs gy = tf_args(M, Dout, Dff, per_y);
  store_to(&gy, tf_split(Dff, per_y), ws, y, b2, &sums);
  if (ws->base == nullptr) return cudaSuccess;

  SplitArgs split = {};
  add_split(&split, x, M, Din, xp, false);
  add_split(&split, w1, Dff, Din, w1p, false);
  add_split(&split, w2, Dout, Dff, w2p, false);
  cudaError_t err = split_planes(split, s);
  if (err != cudaSuccess) return err;
  // hidden = dropout(relu(x W1^T + b1)), as (M, Dff) planes
  cpc2::TfArgs gh = tf_args(M, Dff, Din, whole(Din));
  gh.bias = b1;
  gh.rows = hp;
  gh.seed = seed;
  gh.threshold = threshold;
  gh.scale = scale;
  err = cpc2::tf32x3_gemm<cpc2::kTfHidden>(xp, w1p, gh, s);
  if (err != cudaSuccess) return err;
  // y = hidden W2^T + b2
  err = cpc2::tf32x3_gemm<cpc2::kTfStore>(hp, w2p, gy, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sums, s);
}

// The fp32 backward on workspace `ws` (sizes only when ws.base is null);
// dW2's, dW1's and dx's products split into runs of per_dw2, per_dw1 and
// per_dx k tiles.
cudaError_t ffn_bwd_fp32(Workspace* ws, const float* x, const float* w1,
                         const float* b1, const float* w2, const float* g,
                         const unsigned* seed, float* dx, float* dw1,
                         float* db1, float* dw2, float* db2, int M, int Din,
                         int Dff, int Dout, int per_dw2, int per_dw1,
                         int per_dx, unsigned threshold, float scale,
                         cudaStream_t s) {
  if (M <= 0 || Din < 0 || Dff < 0 || Dout < 0 || per_dw2 <= 0 ||
      per_dw1 <= 0 || per_dx <= 0)
    return cudaErrorInvalidValue;
  const long ld_m = up4(M), ld_din = up4(Din), ld_dff = up4(Dff),
             ld_dout = up4(Dout);
  const cpc2::Planes xp = take_planes(ws, M, ld_din);
  const cpc2::Planes xt = take_planes(ws, Din, ld_m);
  const cpc2::Planes w1p = take_planes(ws, Dff, ld_din);
  const cpc2::Planes w1t = take_planes(ws, Din, ld_dff);
  const cpc2::Planes w2t = take_planes(ws, Dff, ld_dout);
  const cpc2::Planes gp = take_planes(ws, M, ld_dout);
  const cpc2::Planes gt = take_planes(ws, Dout, ld_m);
  const cpc2::Planes ht = take_planes(ws, Dff, ld_m);  // then dh^T
  const cpc2::Planes dhp = take_planes(ws, M, ld_dff);
  const int row_tiles = (M + kSplitTile - 1) / kSplitTile;
  float* db2_part = ws->take<float>(static_cast<size_t>(row_tiles) * Dout);
  const int m_tiles = (M + cpc2::kWgBM - 1) / cpc2::kWgBM;
  float* db1_part = ws->take<float>(static_cast<size_t>(m_tiles) * Dff);
  const int n_tiles = (Dff + cpc2::kWgBN - 1) / cpc2::kWgBN;
  uint2* signs = ws->take<uint2>(static_cast<size_t>(m_tiles) * n_tiles *
                                 cpc2::kWgConsumers);
  SumArgs sums = {};
  sums.seg[sums.nseg++] = {db2_part, Dout, Dout, row_tiles, nullptr, Dout,
                           db2};
  sums.seg[sums.nseg++] = {db1_part, Dff, Dff, m_tiles, nullptr, Dff, db1};
  cpc2::TfArgs gw2 = tf_args(Dout, Dff, M, per_dw2);
  store_to(&gw2, tf_split(M, per_dw2), ws, dw2, nullptr, &sums);
  cpc2::TfArgs gw1 = tf_args(Dff, Din, M, per_dw1);
  store_to(&gw1, tf_split(M, per_dw1), ws, dw1, nullptr, &sums);
  cpc2::TfArgs gx = tf_args(M, Din, Dff, per_dx);
  store_to(&gx, tf_split(Dff, per_dx), ws, dx, nullptr, &sums);
  if (ws->base == nullptr) return cudaSuccess;

  SplitArgs split = {};
  add_split(&split, x, M, Din, xp, false);
  add_split(&split, x, M, Din, xt, true);
  add_split(&split, w1, Dff, Din, w1p, false);
  add_split(&split, w1, Dff, Din, w1t, true);
  add_split(&split, w2, Dout, Dff, w2t, true);
  add_split(&split, g, M, Dout, gp, false, db2_part);  // and db2's partials
  add_split(&split, g, M, Dout, gt, true);
  cudaError_t err = split_planes(split, s);
  if (err != cudaSuccess) return err;
  // the forward's hidden, recomputed, as (Dff, M) planes, and its signs
  cpc2::TfArgs gh = tf_args(M, Dff, Din, whole(Din));
  gh.bias = b1;
  gh.cols = ht;
  gh.signs = signs;
  gh.seed = seed;
  gh.threshold = threshold;
  gh.scale = scale;
  err = cpc2::tf32x3_gemm<cpc2::kTfHidden>(xp, w1p, gh, s);
  if (err != cudaSuccess) return err;
  // dW2[o, f] = sum_m g^T[o, m] hidden^T[f, m]
  err = cpc2::tf32x3_gemm<cpc2::kTfStore>(gt, ht, gw2, s);
  if (err != cudaSuccess) return err;
  // dh = (g W2) * mask * scale: g[m, o] W2^T[f, o]; to (M, Dff) planes and,
  // in place of the hidden's, (Dff, M) ones; db1's column sums per tile
  cpc2::TfArgs gd = tf_args(M, Dff, Dout, whole(Dout));
  gd.rows = dhp;
  gd.cols = ht;
  gd.signs = signs;
  gd.scale = scale;
  gd.colsum = db1_part;
  err = cpc2::tf32x3_gemm<cpc2::kTfHiddenGrad>(gp, w2t, gd, s);
  if (err != cudaSuccess) return err;
  // dW1[f, d] = sum_m dh^T[f, m] x^T[d, m]
  err = cpc2::tf32x3_gemm<cpc2::kTfStore>(ht, xt, gw1, s);
  if (err != cudaSuccess) return err;
  // dx[m, d] = sum_f dh[m, f] W1^T[d, f]
  err = cpc2::tf32x3_gemm<cpc2::kTfStore>(dhp, w1t, gx, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sums, s);
}

}  // namespace

extern "C" {

// --- fp32 route -------------------------------------------------------------
// Any M > 0, Din, Dff and Dout; the workspace is `bytes` long, exactly what
// the layout of ffn_{fwd,bwd}_fp32 takes at the given splits, or the call
// is refused (the host's plan, `ops/ffn.py:ffn_fp32_plan`, mirrors it).

// x (M,Din), w1 (Dff,Din), b1 (Dff), w2 (Dout,Dff), b2 (Dout) -> y (M,Dout).
// Dropout keeps (m, f) when dropout_bits(*seed, m, f) >= threshold and
// scales kept values by scale.
int cpc2_ffn_fwd(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* b2, const unsigned* seed,
                 void* workspace, float* y, long bytes, int M, int Din,
                 int Dff, int Dout, int per_y, unsigned threshold,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Workspace size{nullptr, 0};
  cudaError_t err = ffn_fwd_fp32(&size, x, w1, b1, w2, b2, seed, y, M, Din,
                                 Dff, Dout, per_y, threshold, scale, s);
  if (err != cudaSuccess) return (int)err;
  if (static_cast<long>(size.used) != bytes)
    return (int)cudaErrorInvalidValue;
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_fwd_fp32(&ws, x, w1, b1, w2, b2, seed, y, M, Din, Dff, Dout,
                           per_y, threshold, scale, s);
}

// Backward from g = dL/dy (M,Dout), recomputing the hidden and its mask.
int cpc2_ffn_bwd(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* g, const unsigned* seed,
                 void* workspace, float* dx, float* dw1, float* db1,
                 float* dw2, float* db2, long bytes, int M, int Din, int Dff,
                 int Dout, int per_dw2, int per_dw1, int per_dx,
                 unsigned threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Workspace size{nullptr, 0};
  cudaError_t err = ffn_bwd_fp32(&size, x, w1, b1, w2, g, seed, dx, dw1, db1,
                                 dw2, db2, M, Din, Dff, Dout, per_dw2,
                                 per_dw1, per_dx, threshold, scale, s);
  if (err != cudaSuccess) return (int)err;
  if (static_cast<long>(size.used) != bytes)
    return (int)cudaErrorInvalidValue;
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_bwd_fp32(&ws, x, w1, b1, w2, g, seed, dx, dw1, db1, dw2,
                           db2, M, Din, Dff, Dout, per_dw2, per_dw1, per_dx,
                           threshold, scale, s);
}

// --- bf16 route -------------------------------------------------------------
// Din, Dff and Dout must be multiples of 8 (TMA rows of 16-byte multiples),
// and every pointer 16-byte aligned; the wrapper checks both.

// Bytes of workspace the bf16 forward (backward != 0: backward) needs;
// io != 0: the bf16-in/bf16-out variant's.
long cpc2_ffn_bf16_workspace(int M, int Din, int Dff, int Dout, int backward,
                             int io) {
  Workspace ws{nullptr, 0};
  if (backward)
    ffn_bwd_bf16(&ws, io != 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                 Din, Dff, Dout, 0u, 1.f, nullptr);
  else
    ffn_fwd_bf16(&ws, io != 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, M, Din, Dff, Dout, 0u, 1.f, nullptr);
  return static_cast<long>(ws.used);
}

// As cpc2_ffn_fwd, in bf16 products; workspace of
// cpc2_ffn_bf16_workspace(..., 0, 0) bytes.
int cpc2_ffn_fwd_bf16(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* b2, const unsigned* seed,
                      void* workspace, float* y, int M, int Din, int Dff,
                      int Dout, unsigned threshold, float scale,
                      void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_fwd_bf16(&ws, false, x, w1, b1, w2, b2, seed, y, M, Din,
                           Dff, Dout, threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

// As cpc2_ffn_fwd_bf16 with x and y in bf16 (y rounded once from its fp32
// sum); workspace of cpc2_ffn_bf16_workspace(..., 0, 1) bytes.
int cpc2_ffn_fwd_bf16io(const bf16* x, const float* w1, const float* b1,
                        const float* w2, const float* b2,
                        const unsigned* seed, void* workspace, bf16* y,
                        int M, int Din, int Dff, int Dout,
                        unsigned threshold, float scale, void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_fwd_bf16(&ws, true, x, w1, b1, w2, b2, seed, y, M, Din,
                           Dff, Dout, threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

// As cpc2_ffn_bwd, in bf16 products; workspace of
// cpc2_ffn_bf16_workspace(..., 1, 0) bytes.
int cpc2_ffn_bwd_bf16(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* g, const unsigned* seed,
                      void* workspace, float* dx, float* dw1, float* db1,
                      float* dw2, float* db2, int M, int Din, int Dff,
                      int Dout, unsigned threshold, float scale,
                      void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_bwd_bf16(&ws, false, x, w1, b1, w2, g, seed, dx, dw1, db1,
                           dw2, db2, M, Din, Dff, Dout, threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

// As cpc2_ffn_bwd_bf16 with x, g and dx in bf16 (dx rounded once after
// its split partials are summed); the weights' gradients fp32. Workspace
// of cpc2_ffn_bf16_workspace(..., 1, 1) bytes.
int cpc2_ffn_bwd_bf16io(const bf16* x, const float* w1, const float* b1,
                        const float* w2, const bf16* g, const unsigned* seed,
                        void* workspace, bf16* dx, float* dw1, float* db1,
                        float* dw2, float* db2, int M, int Din, int Dff,
                        int Dout, unsigned threshold, float scale,
                        void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_bwd_bf16(&ws, true, x, w1, b1, w2, g, seed, dx, dw1, db1,
                           dw2, db2, M, Din, Dff, Dout, threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
