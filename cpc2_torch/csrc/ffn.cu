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
//   between its two products.
// - bf16-in/bf16-out (`cpc2_ffn_{fwd,bwd}_bf16io`, `--precision bf16`,
//   where the heads' activations are bf16): x and the incoming gradient are
//   read as they come, y and dx summed in fp32 and rounded to bf16 once, as
//   the TPU kernel rounds its fp32 output block once. Its first version ran
//   the bf16 route's chain (4 launches forward, 7 backward) and wrote every
//   split's fp32 partial to device memory (about 24 MB a backward) for the
//   sum launch, with db2's sums walking 16 rows of g a thread in series.
//   Its own blocks now (hopper_gemm.cuh, the bf16-io section;
//   `ops/ffn.py:ffn_bf16io_plan` mirrors `io_layout`): one launch casts the
//   weights once a forward (the backward reads that cast); `ffn_io_hidden`
//   takes the hidden and, in the backward, dh of
//   the same 128 x 128 tile in one CTA (the hidden's signs kept in
//   registers, db1's column sums per tile, db2's per 32 rows of g from dh's
//   A boxes); `ffn_io_split` takes y (forward), dW2 and dW1 together, and
//   dx, each tile's k tiles split over a thread-block cluster whose CTAs
//   add their partials in shared memory, in rank order, bias and bf16
//   rounding in the same pass, and finishes db1 and db2 from their
//   partials in order. No fp32 partial of a product in device memory, no
//   sum launch: 3 launches forward, 3 backward, the backward bit for bit
//   from call to call. Bound by operations at the recipe (1.9 GFLOP
//   forward), the products are 8 k tiles or fewer a CTA, so its time is
//   the launches' ramps and the clusters' one exchange each.
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
  // with colsum_rows > 0: partial[b][c] = sum of colsum_src over rows
  // [kSumRows b, kSumRows (b + 1)), column c, for the (rows, cols) matrix
  const float* colsum_src;
  int colsum_rows, colsum_cols;
  float* partial;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
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
        const float4 v = *reinterpret_cast<const float4*>(
            a.colsum_src + static_cast<long>(r) * a.colsum_cols + 4 * c4);
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
      (reinterpret_cast<uintptr_t>(s.out) % 16 == 0) &&
      (s.bias == nullptr ||
       (s.cols % 4 == 0 && reinterpret_cast<uintptr_t>(s.bias) % 16 == 0));
  const long step = static_cast<long>(gridDim.x) * kCastThreads;
  if (!vec) {
    for (long i = blockIdx.x * static_cast<long>(kCastThreads) + threadIdx.x;
         i < s.n; i += step) {
      float acc = s.part[i];
      for (int r = 1; r < s.count; ++r) acc += s.part[i + r * s.stride];
      if (s.bias) acc += s.bias[i % s.cols];
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
// its partials, summed into `out` (with `bias`) by the last launch.
template <typename Args>
void store_to(Args* g, cpc2::SplitK split, Workspace* ws, float* out,
              const float* bias, SumArgs* sums) {
  g->ldo = g->N;
  if (split.splits == 1) {
    g->out = out;
    g->bias = bias;
    return;
  }
  const long n = static_cast<long>(g->M) * g->N;
  g->out = ws->take<float>(static_cast<size_t>(n) * split.splits);
  g->split_stride = n;
  g->bias = nullptr;
  sums->seg[sums->nseg++] = {g->out, n, n, split.splits, bias, g->N, out};
}

// The bf16 forward on workspace `ws` (sizes only when ws.base is null).
cudaError_t ffn_fwd_bf16(Workspace* ws, const float* x, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const unsigned* seed, float* y, int M, int Din,
                         int Dff, int Dout, unsigned threshold, float scale,
                         cudaStream_t s) {
  bf16* xb = ws->take<bf16>(static_cast<size_t>(M) * Din);
  bf16* w1b = ws->take<bf16>(static_cast<size_t>(Dff) * Din);
  bf16* w2b = ws->take<bf16>(static_cast<size_t>(Dout) * Dff);
  bf16* hb = ws->take<bf16>(static_cast<size_t>(M) * Dff);
  SumArgs sums = {};
  const cpc2::SplitK split_y = cpc2::split_k(M, Dout, Dff);
  cpc2::WgArgs gy = gemm_args(M, Dout, Dff);
  store_to(&gy, split_y, ws, y, b2, &sums);
  if (ws->base == nullptr) return cudaSuccess;

  CastArgs cast = {};
  cast.seg[cast.nseg++] = {x, xb, static_cast<long>(M) * Din};
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
cudaError_t ffn_bwd_bf16(Workspace* ws, const float* x, const float* w1,
                         const float* b1, const float* w2, const float* g,
                         const unsigned* seed, float* dx, float* dw1,
                         float* db1, float* dw2, float* db2, int M, int Din,
                         int Dff, int Dout, unsigned threshold, float scale,
                         cudaStream_t s) {
  bf16* xb = ws->take<bf16>(static_cast<size_t>(M) * Din);
  bf16* w1b = ws->take<bf16>(static_cast<size_t>(Dff) * Din);
  bf16* w2b = ws->take<bf16>(static_cast<size_t>(Dout) * Dff);
  bf16* gb = ws->take<bf16>(static_cast<size_t>(M) * Dout);
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
  store_to(&gx, split_dx, ws, dx, nullptr, &sums);
  if (ws->base == nullptr) return cudaSuccess;

  CastArgs cast = {};
  cast.seg[cast.nseg++] = {x, xb, static_cast<long>(M) * Din};
  cast.seg[cast.nseg++] = {w1, w1b, static_cast<long>(Dff) * Din};
  cast.seg[cast.nseg++] = {w2, w2b, static_cast<long>(Dout) * Dff};
  cast.seg[cast.nseg++] = {g, gb, static_cast<long>(M) * Dout};
  cast.colsum_src = g;  // db2 before rounding
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

// --- bf16-io route: the hidden's tiles, the products split in clusters -----

// The host's plan (`ops/ffn.py:ffn_bf16io_plan`), field for field: the
// widths, the clusters of 2, 4 and 8 split CTAs the card holds at once
// (`cpc2_ffn_io_max_clusters`); each split launch's cluster (y; dW2 and dW1
// together; dx), the kernels' shared memory, and the workspace of a
// forward and of a backward.
struct IoPlan {
  long m, din, dff, dout, fit2, fit4, fit8;
  long y_cluster, dw_cluster, dx_cluster;
  long smem, fwd_bytes, bwd_bytes;
};
constexpr int kIoPlanLongs = sizeof(IoPlan) / sizeof(long);

int tiles_of(long n) { return static_cast<int>((n + cpc2::kWgBN - 1) / cpc2::kWgBN); }
int k_tiles_of(long k) { return static_cast<int>((k + cpc2::kWgBK - 1) / cpc2::kWgBK); }

// The largest cluster, of 2, 4 or 8 CTAs and at most k_tiles (every rank
// a run of k tiles), of which the card holds a launch's `tiles` at once
// (fits: 2, 4, 8); 1 where none.
long io_cluster(long tiles, long k_tiles, const long (&fits)[3]) {
  long c = 1;
  for (int i = 0; i < 3; ++i)
    if (2 * c <= k_tiles && tiles <= fits[i]) c *= 2;
    else break;
  return c;
}

// The workspace: the bf16 hidden; in the backward also dh and the bias
// gradients' partials (db1's per 128-row tile, db2's per 32 rows of g).
// Every region starts on a 256-byte boundary. (The bf16 weights are the
// caller's: the forward casts them, the backward reads that cast.)
struct IoSpace {
  bf16 *hb, *dhb;
  float *db1_part, *db2_part;
};

IoSpace io_space(Workspace* ws, long M, long Din, long Dff, long Dout,
                 bool backward) {
  IoSpace r = {};
  r.hb = ws->take<bf16>(static_cast<size_t>(M * Dff));
  if (backward) {
    const long m_tiles = tiles_of(M);
    r.dhb = ws->take<bf16>(static_cast<size_t>(M * Dff));
    r.db1_part = ws->take<float>(static_cast<size_t>(m_tiles * Dff));
    r.db2_part = ws->take<float>(
        static_cast<size_t>(cpc2::kWgBM / cpc2::kIoSumRows * m_tiles * Dout));
  }
  return r;
}

IoPlan io_layout(long m, long din, long dff, long dout, long fit2,
                 long fit4, long fit8) {
  IoPlan p = {m, din, dff, dout, fit2, fit4, fit8};
  const long fits[3] = {fit2, fit4, fit8};
  const long mt = tiles_of(m), it = tiles_of(din), ft = tiles_of(dff),
             ot = tiles_of(dout);
  p.y_cluster = io_cluster(mt * ot, k_tiles_of(dff), fits);
  p.dw_cluster = io_cluster(ot * ft + ft * it, k_tiles_of(m), fits);
  p.dx_cluster = io_cluster(mt * it, k_tiles_of(dff), fits);
  p.smem = cpc2::kIoHiddenSmem;  // the larger of the two blocks' (split:
                                 // kWgSmemBytes)
  Workspace fwd{nullptr, 0}, bwd{nullptr, 0};
  io_space(&fwd, m, din, dff, dout, false);
  io_space(&bwd, m, din, dff, dout, true);
  p.fwd_bytes = static_cast<long>(fwd.used);
  p.bwd_bytes = static_cast<long>(bwd.used);
  return p;
}

// Does the host's plan equal the layout, for widths the route takes?
bool io_plan_ok(const long* got, int n) {
  if (got == nullptr || n != kIoPlanLongs) return false;
  const IoPlan& g = *reinterpret_cast<const IoPlan*>(got);
  if (g.m <= 0 || g.din <= 0 || g.dff <= 0 || g.dout <= 0 || g.din % 8 ||
      g.dff % 8 || g.dout % 8 || g.fit2 < 0 || g.fit4 < 0 || g.fit8 < 0 ||
      g.m > (1l << 30))
    return false;
  const IoPlan want = io_layout(g.m, g.din, g.dff, g.dout, g.fit2, g.fit4,
                                g.fit8);
  const long* w = reinterpret_cast<const long*>(&want);
  for (int i = 0; i < kIoPlanLongs; ++i)
    if (got[i] != w[i]) return false;
  return true;
}

cpc2::IoProduct io_product(int M, int N, int K, int first, float* out,
                           bf16* out16, const float* bias) {
  cpc2::IoProduct p = {};
  p.M = M;
  p.N = N;
  p.K = K;
  p.n_tiles = tiles_of(N);
  p.first = first;
  p.tiles = tiles_of(M) * p.n_tiles;
  p.out = out;
  p.out16 = out16;
  p.bias = bias;
  return p;
}

// The bf16-io forward: the weights cast to bf16 into wb (W1, then W2),
// the hidden, y split in clusters and rounded once to bf16 (3 launches).
cudaError_t ffn_fwd_io(const IoPlan& p, void* workspace, const bf16* x,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const unsigned* seed, bf16* wb,
                       bf16* y, unsigned threshold, float scale,
                       cudaStream_t s) {
  const int M = p.m, Din = p.din, Dff = p.dff, Dout = p.dout;
  Workspace ws{static_cast<char*>(workspace), 0};
  const IoSpace w = io_space(&ws, M, Din, Dff, Dout, false);
  bf16* w1b = wb;
  bf16* w2b = wb + static_cast<long>(Dff) * Din;
  CastArgs cast = {};
  cast.seg[cast.nseg++] = {w1, w1b, static_cast<long>(Dff) * Din};
  cast.seg[cast.nseg++] = {w2, w2b, static_cast<long>(Dout) * Dff};
  cudaError_t err = cast_bf16(cast, s);
  if (err != cudaSuccess) return err;
  cpc2::IoHiddenArgs h = {M, Din, Dff, Dout, b1, seed, threshold, scale,
                          w.hb, nullptr, nullptr, nullptr};
  err = cpc2::io_hidden(x, w1b, nullptr, nullptr, h, s);
  if (err != cudaSuccess) return err;
  // y = hidden W2^T + b2
  cpc2::IoArgs a = {};
  a.products = 1;
  a.cluster = static_cast<int>(p.y_cluster);
  a.p[0] = io_product(M, Dout, Dff, 0, nullptr, y, b2);
  const bf16* A[1] = {w.hb};
  const bf16* B[1] = {w2b};
  return cpc2::io_split<true, true>(A, B, a, s);
}

// The bf16-io backward from the forward's bf16 weights wb: the hidden and
// dh with the bias partials; dW2 and dW1 split in clusters, db2 and db1
// summed; dx split in clusters and rounded once to bf16 (3 launches).
cudaError_t ffn_bwd_io(const IoPlan& p, void* workspace, const bf16* x,
                       const bf16* wb, const float* b1, const bf16* g,
                       const unsigned* seed, bf16* dx, float* dw1,
                       float* db1, float* dw2, float* db2,
                       unsigned threshold, float scale, cudaStream_t s) {
  const int M = p.m, Din = p.din, Dff = p.dff, Dout = p.dout;
  Workspace ws{static_cast<char*>(workspace), 0};
  const IoSpace w = io_space(&ws, M, Din, Dff, Dout, true);
  const bf16* w1b = wb;
  const bf16* w2b = wb + static_cast<long>(Dff) * Din;
  cpc2::IoHiddenArgs h = {M, Din, Dff, Dout, b1, seed, threshold, scale,
                          w.hb, w.dhb, w.db1_part, w.db2_part};
  cudaError_t err = cpc2::io_hidden(x, w1b, g, w2b, h, s);
  if (err != cudaSuccess) return err;
  // dW2[o, f] = sum_m g[m, o] hidden[m, f] (A = g^T M-major, B = hidden
  // N-major) and db2; dW1[f, d] = sum_m dh[m, f] x[m, d] and db1
  cpc2::IoArgs a = {};
  a.products = 2;
  a.cluster = static_cast<int>(p.dw_cluster);
  a.p[0] = io_product(Dout, Dff, M, 0, dw2, nullptr, nullptr);
  a.p[0].colsum_part = w.db2_part;
  a.p[0].colsum_count = cpc2::kWgBM / cpc2::kIoSumRows * tiles_of(M);
  a.p[0].colsum_out = db2;
  a.p[1] = io_product(Dff, Din, M, a.p[0].tiles, dw1, nullptr, nullptr);
  a.p[1].colsum_part = w.db1_part;
  a.p[1].colsum_count = tiles_of(M);
  a.p[1].colsum_out = db1;
  const bf16* A[2] = {g, w.dhb};
  const bf16* B[2] = {w.hb, x};
  err = cpc2::io_split<false, false>(A, B, a, s);
  if (err != cudaSuccess) return err;
  // dx = dh W1 (B = W1 read N-major)
  cpc2::IoArgs d = {};
  d.products = 1;
  d.cluster = static_cast<int>(p.dx_cluster);
  d.p[0] = io_product(M, Din, Dff, 0, nullptr, dx, nullptr);
  const bf16* A1[1] = {w.dhb};
  const bf16* B1[1] = {w1b};
  return cpc2::io_split<true, false>(A1, B1, d, s);
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

// Bytes of workspace the bf16 forward (backward != 0: backward) needs.
long cpc2_ffn_bf16_workspace(int M, int Din, int Dff, int Dout,
                             int backward) {
  Workspace ws{nullptr, 0};
  if (backward)
    ffn_bwd_bf16(&ws, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, M, Din, Dff,
                 Dout, 0u, 1.f, nullptr);
  else
    ffn_fwd_bf16(&ws, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, M, Din, Dff, Dout, 0u, 1.f, nullptr);
  return static_cast<long>(ws.used);
}

// As cpc2_ffn_fwd, in bf16 products; workspace of
// cpc2_ffn_bf16_workspace(..., 0) bytes.
int cpc2_ffn_fwd_bf16(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* b2, const unsigned* seed,
                      void* workspace, float* y, int M, int Din, int Dff,
                      int Dout, unsigned threshold, float scale,
                      void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_fwd_bf16(&ws, x, w1, b1, w2, b2, seed, y, M, Din, Dff, Dout,
                           threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

// As cpc2_ffn_bwd, in bf16 products; workspace of
// cpc2_ffn_bf16_workspace(..., 1) bytes.
int cpc2_ffn_bwd_bf16(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* g, const unsigned* seed,
                      void* workspace, float* dx, float* dw1, float* db1,
                      float* dw2, float* db2, int M, int Din, int Dff,
                      int Dout, unsigned threshold, float scale,
                      void* stream) {
  Workspace ws{static_cast<char*>(workspace), 0};
  return (int)ffn_bwd_bf16(&ws, x, w1, b1, w2, g, seed, dx, dw1, db1, dw2,
                           db2, M, Din, Dff, Dout, threshold, scale,
                           static_cast<cudaStream_t>(stream));
}

// --- bf16-io route -----------------------------------------------------------
// The plan (`plan`, n_plan longs) must equal io_layout's for its widths
// (M > 0; Din, Dff, Dout multiples of 8), and the workspace is its
// fwd_bytes or bwd_bytes long; else the call is refused. wb holds the
// weights in bf16, W1 (Dff x Din) then W2 (Dout x Dff): the forward writes
// it, its backward reads it.

// As cpc2_ffn_fwd_bf16 with x and y in bf16 (y rounded once from its fp32
// sum).
int cpc2_ffn_fwd_bf16io(const bf16* x, const float* w1, const float* b1,
                        const float* w2, const float* b2,
                        const unsigned* seed, void* workspace, bf16* wb,
                        bf16* y, const long* plan, int n_plan,
                        unsigned threshold, float scale, void* stream) {
  if (!io_plan_ok(plan, n_plan)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cpc2::current_context();
  if (err != cudaSuccess) return (int)err;
  return (int)ffn_fwd_io(*reinterpret_cast<const IoPlan*>(plan), workspace,
                         x, w1, b1, w2, b2, seed, wb, y, threshold, scale,
                         static_cast<cudaStream_t>(stream));
}

// As cpc2_ffn_bwd_bf16 with x, g and dx in bf16 (dx rounded once from its
// fp32 sum) and the forward's bf16 weights wb; the weights' gradients
// fp32.
int cpc2_ffn_bwd_bf16io(const bf16* x, const bf16* wb, const float* b1,
                        const bf16* g, const unsigned* seed, void* workspace,
                        bf16* dx, float* dw1, float* db1, float* dw2,
                        float* db2, const long* plan, int n_plan,
                        unsigned threshold, float scale, void* stream) {
  if (!io_plan_ok(plan, n_plan)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cpc2::current_context();
  if (err != cudaSuccess) return (int)err;
  return (int)ffn_bwd_io(*reinterpret_cast<const IoPlan*>(plan), workspace,
                         x, wb, b1, g, seed, dx, dw1, db1, dw2, db2,
                         threshold, scale,
                         static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of the bf16-io split block that the card holds
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int cpc2_ffn_io_max_clusters(int cluster) {
  auto kernel = cpc2::ffn_io_split<true, true>;
  cudaError_t err = cpc2::set_smem((const void*)kernel, cpc2::kWgSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(cluster * 16);
  cfg.blockDim = dim3(cpc2::kWgThreads);
  cfg.dynamicSmemBytes = cpc2::kWgSmemBytes;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
