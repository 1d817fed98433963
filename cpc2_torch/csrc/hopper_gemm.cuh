// GEMM building blocks for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages guarded by mbarriers, `wgmma.mma_async` products with
// fp32 accumulators in registers, and fused epilogues applied on the
// accumulator fragment. The FFN kernels of ffn.cu and the encoder's conv
// products (encoder.cu) are built from them. Two blocks share the ring, the
// tile and the split-K scheme below; the bf16-in/bf16-out FFN's own two
// blocks (`ffn_io_hidden`, `ffn_io_split`: clusters instead of split
// partials) close the file:
//
// `ffn_wgmma_gemm`, bf16 operands (the FFN's `bf16mix` route):
// C[m, n] = sum_k A(m, k) * B(n, k)
// - A is K-major (stored [M][K]) or M-major (stored [K][M]);
// - B is K-major (stored [N][K]) or N-major (stored [K][N]);
//   the majors go into the wgmma descriptors' transpose bits, so no
//   transposed copy of an operand is ever made.
// - Block tile 128 x 128 x 64: two consumer warpgroups of 64 rows each,
//   m64n128k16 products, and one producer warp whose lane 0 keeps TMA loads
//   in flight over kStages stages (128-byte swizzle, 16 KB per operand a
//   stage: one 128-row box for a K-major operand, two 64-wide boxes for an
//   MN-major one).
// - Ragged edges (M = 928 rows at the recipe; K = 928 for the weight
//   gradients): TMA fills out-of-range elements with zeros, and the
//   epilogues store only rows and columns in range.
// - Split-K: blockIdx.z takes a run of k tiles and writes its own fp32
//   partial; a second pass sums the partials in a fixed order
//   (deterministic, no atomics).
// - Where the tiles lie is a policy (`DenseTiles` for 2-D operands): the
//   encoder's products read per-tap 4-D boxes of an activation tensor.
//
// `ffn_tf32x3_gemm`, fp32 operands at fp32 accuracy (the FFN's `fp32`
// route), the same C from 3xTF32 products: each operand comes as two
// planes, big = x rounded to TF32 and small = x - big, and each k step adds
// small_A big_B + big_A small_B + big_A big_B (the dropped small_A small_B
// is below 2^-22 |A B|). The TF32 `wgmma` reads both operands from shared
// memory K-major only (the transpose bits are for 16-bit types), so both
// are stored K-major: the planes are made by a pass before the products,
// which also transposes, or by the epilogue of the product before.
// - Block tile 128 x 128 x 32 (128-byte rows, as the bf16 block's), three
//   stages of four 16 KB boxes (A big, A small, B big, B small), each box a
//   3-D TMA load of one plane; m64n128k8 products, three a k step.
// - The planes' row stride is a multiple of 4 floats (TMA's 16-byte
//   strides); the tensor maps give the true widths, so TMA never reads the
//   padding and any M, N and K are taken.
//
// Everything has internal linkage, as in common.cuh.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cpc2 {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64, kWgStages = 4;
constexpr int kWgConsumers = 256;                 // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;     // and one producer warp
constexpr int kWgOperandBytes = kWgBM * kWgBK * 2;  // 16 KB
constexpr int kWgStageBytes = 2 * kWgOperandBytes;
constexpr int kWgRedBytes = 8 * kWgBN * 4;        // column sums, 8 warps
constexpr int kWgSmemBytes =
    1024 + kWgStages * kWgStageBytes + kWgRedBytes + 2 * kWgStages * 8;

enum WgEpilogue : int {
  kWgStore = 0,       // out[z] = acc (+ bias[n]), fp32, at the policy's rows
  kWgHidden = 1,      // hidden = bf16(keep(m,n) ? relu(acc + bias[n]) * scale : 0)
  kWgHiddenGrad = 2,  // v = acc * (hidden > 0 ? scale : 0); hidden = bf16(v);
                      // colsum[m tile][n] = sum of v over the tile's rows
};

struct WgArgs {
  int M, N, K;
  int k_tiles_per_split;
  float* out;              // kWgStore: split z at out + z * split_stride
  long ldo, split_stride;
  const float* bias;       // kWgStore (or nullptr), kWgHidden
  bf16* hidden;            // kWgHidden, kWgHiddenGrad
  long ldh;
  const uint32_t* seed;    // kWgHidden: one value in device memory
  uint32_t threshold;      // drop when dropout_bits < threshold
  float scale;             // 1 / (1 - rate)
  float* colsum;           // kWgHiddenGrad: (ceil(M / 128), N)
};

// One 2-D TMA box, coordinates innermost first, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the stride between 64-wide MN atoms; unused for
// K-major) and stride byte offset (the stride between groups of 8 rows of
// 128 bytes), all in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) * B (16 x 128); kTransA / kTransB: 1 for MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// One 3-D TMA box, coordinates innermost first, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One 4-D TMA box, coordinates innermost first, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Where a block's tiles lie is a policy of the block (`Tiles`): its k tiles
// [kt0, kt1), the TMA boxes of k tile t (`load`: A's 16 KB at a, B's at b,
// in the layout the majors below say), the first column n0, and the output
// row of the tile's row r (`row`, -1 where nothing is stored). The dense
// products' policy: tile (blockIdx.y, blockIdx.x) of 128 x 128 at (m0, n0)
// of 2-D row-major operands; split z takes k tiles [z per, (z + 1) per).
// (The encoder's conv products bring their own policies, csrc/encoder.cu.)
template <bool kAK, bool kBK>
struct DenseTiles {
  int m0, n0, M, kt0, kt1;
  __device__ __forceinline__ explicit DenseTiles(const WgArgs& args)
      : m0(blockIdx.y * kWgBM), n0(blockIdx.x * kWgBN), M(args.M) {
    const int k_tiles = (args.K + kWgBK - 1) / kWgBK;
    kt0 = blockIdx.z * args.k_tiles_per_split;
    kt1 = min(kt0 + args.k_tiles_per_split, k_tiles);
  }
  __device__ __forceinline__ void load(int t, uint8_t* a, uint8_t* b,
                                       const CUtensorMap* map_a,
                                       const CUtensorMap* map_b,
                                       uint64_t* bar) const {
    const int k = t * kWgBK;
    if (kAK) {
      tma_load(a, map_a, bar, k, m0);
    } else {
      tma_load(a, map_a, bar, m0, k);
      tma_load(a + kWgOperandBytes / 2, map_a, bar, m0 + 64, k);
    }
    if (kBK) {
      tma_load(b, map_b, bar, k, n0);
    } else {
      tma_load(b, map_b, bar, n0, k);
      tma_load(b + kWgOperandBytes / 2, map_b, bar, n0 + 64, k);
    }
  }
  __device__ __forceinline__ long row(int r) const {
    return m0 + r < M ? m0 + r : -1;
  }
};

// The block: kAK: A is K-major (else M-major); kBK: B is K-major (else
// N-major); a 128-row box of a K-major operand, two 64-wide boxes of an
// MN-major one, as `tiles` loads them.
template <bool kAK, bool kBK, int kEpi, class Tiles>
__device__ __forceinline__ void wgmma_gemm_block(const CUtensorMap* map_a,
                                                 const CUtensorMap* map_b,
                                                 const WgArgs& args,
                                                 const Tiles& tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kWgStages * kWgStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * kWgBN);
  uint64_t* empty = full + kWgStages;
  const int kt0 = tiles.kt0, kt1 = tiles.kt1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {
    // producer: lane 0 of the last warp keeps the ring full
    if (threadIdx.x == kWgConsumers) {
      for (int t = kt0, it = 0; t < kt1; ++t, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWgStageBytes);
        uint8_t* a = smem + s * kWgStageBytes;
        tiles.load(t, a, a + kWgOperandBytes, map_a, map_b, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = kt0, it = 0; t < kt1; ++t, ++it) {
    const int s = it % kWgStages;
    mbar_wait(&full[s], (it / kWgStages) & 1);
    const uint8_t* a = smem + s * kWgStageBytes + wg * (kWgOperandBytes / 2);
    const uint8_t* b = smem + s * kWgStageBytes + kWgOperandBytes;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // K-major: the next 16 k are 32 bytes on within each 128-byte row;
      // MN-major: 16 rows of 128 bytes further
      const uint64_t da = kAK ? wg_desc(a + 32 * kk, 16, 1024)
                              : wg_desc(a + 2048 * kk, kWgOperandBytes / 2,
                                        1024);
      const uint64_t db = kBK ? wg_desc(b + 32 * kk, 16, 1024)
                              : wg_desc(b + 2048 * kk, kWgOperandBytes / 2,
                                        1024);
      wgmma_m64n128k16<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
    }
    wg_commit();
    wg_wait<1>();  // the previous tile's products are done with its stage
    fence_acc(acc);
    if (it > 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
  }
  wg_wait<0>();
  fence_acc(acc);

  // accumulator fragment: acc[4j + 2h + e] is row r0 + 8h, column
  // c0 + 8j + e of the tile
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * warp + lane / 4;  // warp w of 8: rows 16w..
  const int colb = tiles.n0 + 2 * (lane % 4);
  const int N = args.N;

  if constexpr (kEpi == kWgStore) {
    float* out = args.out + blockIdx.z * args.split_stride;
    const long rows[2] = {tiles.row(r0), tiles.row(r0 + 8)};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = colb + 8 * j;
      if (col >= N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (args.bias) { b0 = args.bias[col]; b1 = args.bias[col + 1]; }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= 0)
          *reinterpret_cast<float2*>(out + rows[h] * args.ldo + col) =
              make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
      }
    }
  } else if constexpr (kEpi == kWgHidden) {
    const int row0 = tiles.m0 + r0, M = args.M;
    const uint32_t seed = args.threshold ? *args.seed : 0u;
    uint32_t rbits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rbits[h] = mix32(seed ^ mix32(static_cast<uint32_t>(row0 + 8 * h)));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = colb + 8 * j;
      if (col >= N) continue;
      const float b0 = args.bias[col], b1 = args.bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
        float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
        if (args.threshold) {
          const bool k0 = mix32(rbits[h] + col) >= args.threshold;
          const bool k1 = mix32(rbits[h] + col + 1) >= args.threshold;
          v0 = k0 ? v0 * args.scale : 0.f;
          v1 = k1 ? v1 * args.scale : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(args.hidden + row * args.ldh +
                                           col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {  // kWgHiddenGrad: the stored hidden is > 0 exactly where it was
            // kept and its pre-activation was positive
    const int row0 = tiles.m0 + r0, M = args.M;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = colb + 8 * j;
      float s0 = 0.f, s1 = 0.f;
      if (col < N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
              args.hidden + row * args.ldh + col);
          const float2 hv = __bfloat1622float2(*p);
          const float v0 = acc[4 * j + 2 * h] * (hv.x > 0.f ? args.scale : 0.f);
          const float v1 =
              acc[4 * j + 2 * h + 1] * (hv.y > 0.f ? args.scale : 0.f);
          *p = __floats2bfloat162_rn(v0, v1);
          s0 += v0;
          s1 += v1;
        }
      }
      // sum the warp's 16 rows: lanes with the same lane % 4 share columns
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[warp * kWgBN + 8 * j + 2 * lane] = s0;
        red[warp * kWgBN + 8 * j + 2 * lane + 1] = s1;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
    if (threadIdx.x < kWgBN && tiles.n0 + threadIdx.x < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * kWgBN + threadIdx.x];
      args.colsum[blockIdx.y * static_cast<long>(N) + tiles.n0 +
                  threadIdx.x] = s;
    }
  }
}

template <bool kAK, bool kBK, int kEpi>
__global__ void __launch_bounds__(kWgThreads, 1)
ffn_wgmma_gemm(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, WgArgs args) {
  wgmma_gemm_block<kAK, kBK, kEpi>(&map_a, &map_b, args,
                                   DenseTiles<kAK, kBK>(args));
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A dense row-major bf16 matrix of `outer` rows of `inner` elements, read
// in boxes of 64 x box_outer with the 128-byte swizzle; zeros out of range.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const bf16* ptr,
                                   long inner, long outer, int box_outer) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled works in the calling thread's current context,
// which a thread that has launched nothing yet may not have (autograd's
// worker, running a backward whose first call encodes maps:
// CUDA_ERROR_INVALID_CONTEXT). cudaSetDevice binds the device's primary
// context to the thread (the device of the context current, if any: a
// rank's); it neither synchronises nor breaks a stream capture.
inline cudaError_t current_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// k tiles per split and the number of splits for an M x N x K product:
// enough splits to give every SM a block, each split at least one k tile.
struct SplitK {
  int per, splits;
};

inline SplitK split_k(int M, int N, int K) {
  const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + kWgBN - 1) / kWgBN);
  const int k_tiles = (K + kWgBK - 1) / kWgBK;
  int s = sm_count() / tiles;
  s = s < 1 ? 1 : (s > k_tiles ? k_tiles : s);
  const int per = (k_tiles + s - 1) / s;
  return {per, (k_tiles + per - 1) / per};
}

// C (M x N) from A and B (see the kernel), split as `split` says; every
// operand dense and row-major in its stated major.
template <bool kAK, bool kBK, int kEpi>
cudaError_t wgmma_gemm(const bf16* A, const bf16* B, WgArgs args,
                       SplitK split, cudaStream_t stream) {
  const int M = args.M, N = args.N, K = args.K;
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  CUtensorMap map_a, map_b;
  cudaError_t err = kAK ? bf16_tensor_map(&map_a, A, K, M, kWgBM)
                        : bf16_tensor_map(&map_a, A, M, K, kWgBK);
  if (err != cudaSuccess) return err;
  err = kBK ? bf16_tensor_map(&map_b, B, K, N, kWgBN)
            : bf16_tensor_map(&map_b, B, N, K, kWgBK);
  if (err != cudaSuccess) return err;
  auto kernel = ffn_wgmma_gemm<kAK, kBK, kEpi>;
  err = set_smem((const void*)kernel, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  args.k_tiles_per_split = split.per;
  dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM, split.splits);
  kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(map_a, map_b, args);
  return cudaGetLastError();
}

// --- 3xTF32 block ------------------------------------------------------------

constexpr int kTfBK = 32, kTfStages = 3;
constexpr int kTfBoxBytes = kWgBM * kTfBK * 4;  // 16 KB: one plane's box
constexpr int kTfStageBytes = 4 * kTfBoxBytes;  // A, B: big, small
constexpr int kTfSmemBytes =
    1024 + kTfStages * kTfStageBytes + kWgRedBytes + 2 * kTfStages * 8;

enum TfEpilogue : int {
  kTfStore = 0,       // out[z] = acc (+ bias[n]), fp32
  kTfHidden = 1,      // v = keep(m,n) ? relu(acc + bias[n]) * scale : 0, to
                      // the planes of `rows` and/or `cols`, and v > 0 to
                      // `signs` if set
  kTfHiddenGrad = 2,  // v = acc * (hidden > 0 ? scale : 0), the hidden's
                      // signs read from `signs`, v written to both planes;
                      // colsum[m tile][n] = sum of v over the tile's rows
};

// An fp32 matrix as its two TF32 planes: big at p, small at p + plane; row r
// at p + r * ld.
struct Planes {
  float* p;
  long ld, plane;
};

struct TfArgs {
  int M, N, K;
  int k_tiles_per_split;
  float* out;           // kTfStore: split z at out + z * split_stride
  long ldo, split_stride;
  const float* bias;    // kTfStore (or nullptr), kTfHidden
  Planes rows;          // kTfHidden, kTfHiddenGrad: v as (M x N) planes
  Planes cols;          // kTfHidden, kTfHiddenGrad: v as (N x M) planes
  const uint32_t* seed; // kTfHidden: one value in device memory
  uint32_t threshold;   // drop when dropout_bits < threshold
  float scale;          // 1 / (1 - rate)
  float* colsum;        // kTfHiddenGrad: (ceil(M / 128), N)
  uint2* signs;         // the hidden's signs, a consumer thread's 64 values
                        // at [tile][thread]: bit 2j + e of .x (h = 0) and
                        // .y (h = 1) for acc[4j + 2h + e]. The hidden and
                        // dh products share tiles and fragments, so each
                        // thread reads back its own bits.
};

// x = big + small: big is x rounded to TF32 (half an ulp added, the low 13
// bits cleared), small = x - big, exact in fp32; the tensor core reads only
// small's top 19 bits. big + small gives x back exactly.
__device__ __forceinline__ void tf32_split(float x, float& big, float& small) {
  big = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  small = x - big;
}

// d += A (64 x 8) * B (8 x 128) in TF32, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// v (and v1, column n + 1 if in range) into the planes of `rows` at (m, n)
// and of `cols` at (n, m), as big and small.
__device__ __forceinline__ void put_planes(const Planes& rows,
                                           const Planes& cols, int m, int n,
                                           float v0, float v1, bool has1) {
  float b0, s0, b1, s1;
  tf32_split(v0, b0, s0);
  tf32_split(v1, b1, s1);
  if (rows.p) {
    // n is even and ld a multiple of 4: n + 1 < ld, inside the padding
    // when it is past the last column
    float* p = rows.p + m * rows.ld + n;
    *reinterpret_cast<float2*>(p) = make_float2(b0, b1);
    *reinterpret_cast<float2*>(p + rows.plane) = make_float2(s0, s1);
  }
  if (cols.p) {
    float* p = cols.p + n * cols.ld + m;
    p[0] = b0;
    p[cols.plane] = s0;
    if (has1) {
      p[cols.ld] = b1;
      p[cols.ld + cols.plane] = s1;
    }
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kWgThreads, 1)
ffn_tf32x3_gemm(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, TfArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(tiles + kTfStages * kTfStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * kWgBN);
  uint64_t* empty = full + kTfStages;

  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int k_tiles = (args.K + kTfBK - 1) / kTfBK;
  const int kt0 = blockIdx.z * args.k_tiles_per_split;
  const int kt1 = min(kt0 + args.k_tiles_per_split, k_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {
    // producer: lane 0 of the last warp keeps the ring full; plane 0 of a
    // map is big, plane 1 small
    if (threadIdx.x == kWgConsumers) {
      for (int t = kt0, it = 0; t < kt1; ++t, ++it) {
        const int s = it % kTfStages;
        mbar_wait(&empty[s], ((it / kTfStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kTfStageBytes);
        uint8_t* box = tiles + s * kTfStageBytes;
        const int k = t * kTfBK;
        tma_load_3d(box, &map_a, &full[s], k, m0, 0);
        tma_load_3d(box + kTfBoxBytes, &map_a, &full[s], k, m0, 1);
        tma_load_3d(box + 2 * kTfBoxBytes, &map_b, &full[s], k, n0, 0);
        tma_load_3d(box + 3 * kTfBoxBytes, &map_b, &full[s], k, n0, 1);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = kt0, it = 0; t < kt1; ++t, ++it) {
    const int s = it % kTfStages;
    mbar_wait(&full[s], (it / kTfStages) & 1);
    const uint8_t* a_big = tiles + s * kTfStageBytes + wg * (kTfBoxBytes / 2);
    const uint8_t* a_small = a_big + kTfBoxBytes;
    const uint8_t* b_big = tiles + s * kTfStageBytes + 2 * kTfBoxBytes;
    const uint8_t* b_small = b_big + kTfBoxBytes;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTfBK / 8; ++kk) {
      // the next 8 k are 32 bytes on within each 128-byte row; the small
      // terms first, so that the big one is added last
      wgmma_m64n128k8_tf32(acc, wg_desc(a_small + 32 * kk, 16, 1024),
                           wg_desc(b_big + 32 * kk, 16, 1024));
      wgmma_m64n128k8_tf32(acc, wg_desc(a_big + 32 * kk, 16, 1024),
                           wg_desc(b_small + 32 * kk, 16, 1024));
      wgmma_m64n128k8_tf32(acc, wg_desc(a_big + 32 * kk, 16, 1024),
                           wg_desc(b_big + 32 * kk, 16, 1024));
    }
    wg_commit();
    wg_wait<1>();  // the previous tile's products are done with its stage
    fence_acc(acc);
    if (it > 0) mbar_arrive(&empty[(it - 1) % kTfStages]);
  }
  wg_wait<0>();
  fence_acc(acc);

  // accumulator fragment: acc[4j + 2h + e] is row r0 + 8h, column
  // c0 + 8j + e of the tile
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = m0 + 16 * warp + lane / 4;  // warp w of 8: rows 16w..
  const int colb = n0 + 2 * (lane % 4);
  const int M = args.M, N = args.N;

  if (kEpi == kTfStore) {
    float* out = args.out + blockIdx.z * args.split_stride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = colb + 8 * j + e;
        if (col >= N) continue;
        const float b = args.bias ? args.bias[col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < M) out[row * args.ldo + col] = acc[4 * j + 2 * h + e] + b;
        }
      }
    }
  } else if (kEpi == kTfHidden) {
    const uint32_t seed = args.threshold ? *args.seed : 0u;
    uint32_t rbits[2], pos[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rbits[h] = mix32(seed ^ mix32(static_cast<uint32_t>(row0 + 8 * h)));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = colb + 8 * j;
      if (col >= N) continue;
      const bool has1 = col + 1 < N;
      const float b0 = args.bias[col], b1 = has1 ? args.bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
        float v1 = has1 ? fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f) : 0.f;
        if (args.threshold) {
          const bool k0 = mix32(rbits[h] + col) >= args.threshold;
          const bool k1 = mix32(rbits[h] + col + 1) >= args.threshold;
          v0 = k0 ? v0 * args.scale : 0.f;
          v1 = k1 ? v1 * args.scale : 0.f;
        }
        put_planes(args.rows, args.cols, row, col, v0, v1, has1);
        pos[h] |= (v0 > 0.f ? 1u : 0u) << (2 * j);
        pos[h] |= (v1 > 0.f ? 1u : 0u) << (2 * j + 1);
      }
    }
    if (args.signs)
      args.signs[(blockIdx.y * gridDim.x + blockIdx.x) * kWgConsumers +
                 threadIdx.x] = make_uint2(pos[0], pos[1]);
  } else {  // kTfHiddenGrad: the hidden is > 0 exactly where it was kept and
            // its pre-activation was positive
    const uint2 signs = args.signs[(blockIdx.y * gridDim.x + blockIdx.x) *
                                       kWgConsumers + threadIdx.x];
    const uint32_t pos[2] = {signs.x, signs.y};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = colb + 8 * j;
      float s0 = 0.f, s1 = 0.f;
      if (col < N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          const float v0 = acc[4 * j + 2 * h] *
                           ((pos[h] >> (2 * j)) & 1u ? args.scale : 0.f);
          const float v1 = acc[4 * j + 2 * h + 1] *
                           ((pos[h] >> (2 * j + 1)) & 1u ? args.scale : 0.f);
          put_planes(args.rows, args.cols, row, col, v0, v1, col + 1 < N);
          s0 += v0;
          s1 += v1;
        }
      }
      // sum the warp's 16 rows: lanes with the same lane % 4 share columns
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[warp * kWgBN + 8 * j + 2 * lane] = s0;
        red[warp * kWgBN + 8 * j + 2 * lane + 1] = s1;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
    if (threadIdx.x < kWgBN && n0 + threadIdx.x < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * kWgBN + threadIdx.x];
      args.colsum[blockIdx.y * static_cast<long>(N) + n0 + threadIdx.x] = s;
    }
  }
}

// The two planes of a K-major operand (rows x k, row stride ld, a multiple
// of 4) as one 3-D tensor map (k, rows, plane), read in boxes of 32 x 128 x
// 1 with the 128-byte swizzle; zeros out of range.
inline cudaError_t planes_tensor_map(CUtensorMap* map, const Planes& p,
                                     long k, long rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.ld) * 4,
                                 static_cast<cuuint64_t>(p.plane) * 4};
  const cuuint32_t box[3] = {kTfBK, kWgBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.p, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C (M x N) = A (M x K) B (N x K)^T from K-major planes, K split into runs
// of args.k_tiles_per_split k tiles (blockIdx.z); K = 0 gives C = 0.
template <int kEpi>
cudaError_t tf32x3_gemm(const Planes& A, const Planes& B, TfArgs args,
                        cudaStream_t stream) {
  const int M = args.M, N = args.N, K = args.K;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (args.k_tiles_per_split <= 0 || A.ld % 4 || B.ld % 4)
    return cudaErrorInvalidValue;
  CUtensorMap map_a = {}, map_b = {};
  if (K > 0) {
    cudaError_t err = planes_tensor_map(&map_a, A, K, M);
    if (err != cudaSuccess) return err;
    err = planes_tensor_map(&map_b, B, K, N);
    if (err != cudaSuccess) return err;
  }
  auto kernel = ffn_tf32x3_gemm<kEpi>;
  {
    const cudaError_t err = set_smem((const void*)kernel, kTfSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const int k_tiles = (K + kTfBK - 1) / kTfBK;
  const int per = args.k_tiles_per_split;
  const int splits = k_tiles > 0 ? (k_tiles + per - 1) / per : 1;
  dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM, splits);
  kernel<<<grid, kWgThreads, kTfSmemBytes, stream>>>(map_a, map_b, args);
  return cudaGetLastError();
}

// --- bf16-io blocks ----------------------------------------------------------
//
// The FFN's bf16-in/bf16-out route (`--precision bf16`, csrc/ffn.cu) on the
// bf16 block's tile, ring and products, with two blocks of its own:
//
// `ffn_io_hidden`, one 128 x 128 (m, f) tile of the hidden a CTA: the
// hidden's product (x W1^T, K = Din) with its bias, ReLU and dropout, stored
// as bf16 with the tile's signs kept in registers (staged through shared
// memory, so that a warp stores whole rows of 256 bytes: the fragments'
// scattered 4-byte stores took 7.6 of the first version's 10.3 us on an
// H100); in the backward the same
// CTA then takes dh's product (g W2, K = Dout) on the same tile from the same
// ring, scales it by those signs, stores dh as bf16 and db1's column sums of
// the unrounded dh per tile. The CTAs of f tile 0 also sum g's columns per
// 32 rows from the A boxes that dh's product reads (db2's partials).
//
// `ffn_io_split`, the products whose K is long (y; dW2, dW1; dx), each
// output tile's k tiles split over the R CTAs of one thread-block cluster:
// every CTA keeps its fp32 partial in its own shared memory (over its ring,
// dead by then), and after one cluster barrier each CTA sums one slice of
// the tile's rows over the R partials in rank order through distributed
// shared memory (every rank's loads of a place issued before its sums),
// adds the bias, and stores fp32 or rounds once to bf16. (Stores of every
// partial into its summing rank's memory, a second barrier and local sums
// took 0.5-1 us more a launch on an H100.) No partial goes to device
// memory; the sums' order is fixed (no atomics). One
// launch holds up to kIoMaxProducts products of the same operand majors and
// cluster size; the CTAs of n tile 0 of a product may also finish a bias
// gradient from its per-tile partials, in order (`colsum_*`).

constexpr int kIoMaxProducts = 2;
constexpr int kIoMaxCluster = 8;
constexpr int kIoLd = kWgBN + 8;  // a partial's row in shared memory, floats
constexpr int kIoSumRows = 32;    // rows of g a db2 partial sums
static_assert(kWgBM * kIoLd * 4 <= kWgStages * kWgStageBytes,
              "a partial fits the ring");
// The hidden block's staged bf16 tile after its ring: 128 rows of 128
// values, 272 bytes apart (the fragment's writes and the 16-byte reads
// each hit 32 banks).
constexpr int kIoTileLd = 2 * kWgBN + 16;
constexpr int kIoHiddenSmem = kWgSmemBytes + kWgBM * kIoTileLd;

// One product of an `ffn_io_split` launch: C (M x N) = A B^T over K, its
// tiles (n_tiles a row of tiles) clusters [first, first + tiles) of the
// launch.
struct IoProduct {
  int M, N, K;
  int n_tiles, first, tiles;
  float* out;                // fp32 C (row stride N), or
  bf16* out16;               // C rounded once to bf16 (row stride N)
  const float* bias;         // or nullptr: N values added to C's rows
  const float* colsum_part;  // or nullptr: (colsum_count, M) partials
  int colsum_count;
  float* colsum_out;         // M values: the partials' sums, in order
};

struct IoArgs {
  IoProduct p[kIoMaxProducts];
  int products, cluster;
};

struct IoMaps {
  CUtensorMap a[kIoMaxProducts], b[kIoMaxProducts];
};

struct IoHiddenArgs {
  int M, Din, Dff, Dout;
  const float* bias;       // b1
  const uint32_t* seed;    // one value in device memory
  uint32_t threshold;      // drop when dropout_bits < threshold
  float scale;             // 1 / (1 - rate)
  bf16* hidden;            // (M, Dff)
  bf16* dh;                // (M, Dff), or nullptr: the forward
  float* db1_part;         // (m tiles, Dff)
  float* db2_part;         // (m tiles x 4, Dout): g's sums per kIoSumRows
};

// Rank r's k tiles of a product of k_tiles split over R ranks: the runs
// [r k / R, (r + 1) k / R), none empty while R <= k.
__host__ __device__ __forceinline__ int io_k_begin(int r, int k_tiles,
                                                   int R) {
  return static_cast<int>(static_cast<long>(r) * k_tiles / R);
}

// The producer's loads of k tiles [kt0, kt1) of one product at (m0, n0),
// ring slots counted on by `it`.
template <bool kAK, bool kBK>
__device__ __forceinline__ void io_produce(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty,
                                           const CUtensorMap* ma,
                                           const CUtensorMap* mb, int m0,
                                           int n0, int kt0, int kt1,
                                           int& it) {
  for (int t = kt0; t < kt1; ++t, ++it) {
    const int s = it % kWgStages;
    mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], kWgStageBytes);
    uint8_t* a = smem + s * kWgStageBytes;
    uint8_t* b = a + kWgOperandBytes;
    const int k = t * kWgBK;
    if (kAK) {
      tma_load(a, ma, &full[s], k, m0);
    } else {
      tma_load(a, ma, &full[s], m0, k);
      tma_load(a + kWgOperandBytes / 2, ma, &full[s], m0 + 64, k);
    }
    if (kBK) {
      tma_load(b, mb, &full[s], k, n0);
    } else {
      tma_load(b, mb, &full[s], n0, k);
      tma_load(b + kWgOperandBytes / 2, mb, &full[s], n0 + 64, k);
    }
  }
}

// The consumers' products over nk k tiles from the ring into acc; every
// stage is released once read, the last one included. With `g_sums`, each
// k tile's A box (128 rows of 64 bf16 columns, K-major, 128-byte swizzle)
// also gives each column's sums over its kIoSumRows-row blocks, in row
// order, to g_sums[block * g_ld + the k tile's column].
template <bool kAK, bool kBK>
__device__ __forceinline__ void io_consume(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int nk, int& it,
                                           float (&acc)[64],
                                           float* g_sums = nullptr,
                                           long g_ld = 0, int g_cols = 0) {
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    const int s = it % kWgStages;
    mbar_wait(&full[s], (it / kWgStages) & 1);
    const uint8_t* a = smem + s * kWgStageBytes + wg * (kWgOperandBytes / 2);
    const uint8_t* b = smem + s * kWgStageBytes + kWgOperandBytes;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t da = kAK ? wg_desc(a + 32 * kk, 16, 1024)
                              : wg_desc(a + 2048 * kk, kWgOperandBytes / 2,
                                        1024);
      const uint64_t db = kBK ? wg_desc(b + 32 * kk, 16, 1024)
                              : wg_desc(b + 2048 * kk, kWgOperandBytes / 2,
                                        1024);
      wgmma_m64n128k16<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
    }
    wg_commit();
    if (g_sums != nullptr) {
      // while the products run: column c, block q of the box's rows
      static_assert(kWgConsumers / 64 * kIoSumRows == kWgBM, "4 blocks");
      const uint8_t* box = smem + s * kWgStageBytes;
      const int c = threadIdx.x % 64, q = threadIdx.x / 64;
      float sum = 0.f;
#pragma unroll 8
      for (int r = kIoSumRows * q; r < kIoSumRows * (q + 1); ++r)
        sum += __bfloat162float(*reinterpret_cast<const bf16*>(
            box + r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))));
      const int col = i * kWgBK + c;
      if (col < g_cols) g_sums[q * g_ld + col] = sum;
    }
    wg_wait<1>();  // the previous tile's products are done with its stage
    fence_acc(acc);
    if (i > 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
  }
  wg_wait<0>();
  fence_acc(acc);
  if (nk > 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
}

__device__ __forceinline__ uint32_t io_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A bf16 128 x 128 output tile, as the consumers' accumulator fragments
// hold it (packed[2 j + h]: rows 16 warp + lane / 4 + 8 h, columns 2 (lane
// % 4) + 8 j and + 1), to out (row stride ld) at (m0, n0), rows below M and
// columns below N, through `tile` in shared memory: each warpgroup writes
// its 64 rows there, then reads them back 16 bytes a thread, so that a
// warp's stores are two whole rows of 256 bytes.
__device__ __forceinline__ void io_store_tile(uint8_t* tile,
                                              const uint32_t (&packed)[32],
                                              bf16* out, long ld, int m0,
                                              int n0, int M, int N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = threadIdx.x / 128;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  // the warpgroup's last reads of this tile are done
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (r0 + 8 * h) * kIoTileLd +
                                   2 * (c0 + 8 * j)) = packed[2 * j + h];
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int chunk = t + 128 * i;
    const int row = 64 * wg + chunk / 16, col = 8 * (chunk % 16);
    if (m0 + row < M && n0 + col < N)
      *reinterpret_cast<uint4*>(out + (long)(m0 + row) * ld + n0 + col) =
          *reinterpret_cast<const uint4*>(tile + row * kIoTileLd + 2 * col);
  }
}

__device__ __forceinline__ void io_ring_init(uint64_t* full,
                                             uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Launch 2 of the backward (and the forward's hidden): grid (f tiles, m
// tiles), one CTA a tile.
__global__ void __launch_bounds__(kWgThreads, 1)
ffn_io_hidden(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w1,
              const __grid_constant__ CUtensorMap map_g,
              const __grid_constant__ CUtensorMap map_w2,
              const __grid_constant__ IoHiddenArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kWgStages * kWgStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * kWgBN);
  uint64_t* empty = full + kWgStages;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int ka = (args.Din + kWgBK - 1) / kWgBK;
  const int kb = args.dh ? (args.Dout + kWgBK - 1) / kWgBK : 0;
  io_ring_init(full, empty);
  int it = 0;
  if (threadIdx.x >= kWgConsumers) {
    if (threadIdx.x == kWgConsumers) {
      io_produce<true, true>(smem, full, empty, &map_x, &map_w1, m0, n0, 0,
                             ka, it);
      io_produce<true, false>(smem, full, empty, &map_g, &map_w2, m0, n0, 0,
                              kb, it);
    }
    return;
  }
  float acc[64];
  io_consume<true, true>(smem, full, empty, ka, it, acc);

  // hidden = bf16(keep ? relu(acc + b1) * scale : 0); its signs kept:
  // bit 2j + e of pos[h] for acc[4j + 2h + e]
  uint8_t* tile = reinterpret_cast<uint8_t*>(empty + kWgStages);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = m0 + 16 * warp + lane / 4;
  const int colb = n0 + 2 * (lane % 4);
  const int M = args.M, N = args.Dff;
  const uint32_t seed = args.threshold ? *args.seed : 0u;
  uint32_t rbits[2], pos[2] = {0u, 0u}, packed[32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rbits[h] = mix32(seed ^ mix32(static_cast<uint32_t>(row0 + 8 * h)));
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = colb + 8 * j;
    const float b0 = col < N ? args.bias[col] : 0.f;
    const float b1 = col < N ? args.bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
      float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
      if (args.threshold) {
        const bool k0 = mix32(rbits[h] + col) >= args.threshold;
        const bool k1 = mix32(rbits[h] + col + 1) >= args.threshold;
        v0 = k0 ? v0 * args.scale : 0.f;
        v1 = k1 ? v1 * args.scale : 0.f;
      }
      packed[2 * j + h] = io_pack(v0, v1);
      pos[h] |= (v0 > 0.f ? 1u : 0u) << (2 * j);
      pos[h] |= (v1 > 0.f ? 1u : 0u) << (2 * j + 1);
    }
  }
  io_store_tile(tile, packed, args.hidden, N, m0, n0, M, N);
  if (args.dh == nullptr) return;

  // dh = (g W2) * (hidden > 0 ? scale : 0); db2's partials from g's boxes
  // in the CTAs of f tile 0
  float* g_sums = blockIdx.x == 0 ? args.db2_part + (long)blockIdx.y *
                                                        kWgBM / kIoSumRows *
                                                        args.Dout
                                  : nullptr;
  io_consume<true, false>(smem, full, empty, kb, it, acc, g_sums, args.Dout,
                          args.Dout);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // rows past M: the hidden's sign bits there are those of a product
      // of zero rows, but g's rows there are zero too, so acc is 0
      const float v0 = acc[4 * j + 2 * h] *
                       ((pos[h] >> (2 * j)) & 1u ? args.scale : 0.f);
      const float v1 = acc[4 * j + 2 * h + 1] *
                       ((pos[h] >> (2 * j + 1)) & 1u ? args.scale : 0.f);
      packed[2 * j + h] = io_pack(v0, v1);
      s0 += v0;
      s1 += v1;
    }
    // the warp's 16 rows: lanes with the same lane % 4 share columns
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane < 4) {
      red[warp * kWgBN + 8 * j + 2 * lane] = s0;
      red[warp * kWgBN + 8 * j + 2 * lane + 1] = s1;
    }
  }
  io_store_tile(tile, packed, args.dh, N, m0, n0, M, N);
  asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
  if (threadIdx.x < kWgBN && n0 + threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * kWgBN + threadIdx.x];
    args.db1_part[blockIdx.y * static_cast<long>(N) + n0 + threadIdx.x] = s;
  }
}

__device__ __forceinline__ void io_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Four floats at `local`'s place in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ float4 io_load_remote(const float* local,
                                                 int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(smem_u32(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// Four sums to C at `at`: fp32, or rounded once to bf16.
__device__ __forceinline__ void io_store4(const IoProduct& P, long at,
                                          float4 v) {
  if (P.out16)
    *reinterpret_cast<uint2*>(P.out16 + at) =
        make_uint2(io_pack(v.x, v.y), io_pack(v.z, v.w));
  else
    *reinterpret_cast<float4*>(P.out + at) = v;
}

// Rank `rank`'s slice of a tile's rows (kWgBM / kR of them), summed over
// the kR ranks' partials (`part`, at the same place in each CTA's shared
// memory) in rank order, the bias added, stored. Each thread loads 16
// places' floats (16 / kR places, every rank's) before it sums them: a
// round trip to the cluster's memory for many loads.
template <int kR>
__device__ __forceinline__ void io_reduce(const IoProduct& P,
                                          const float* part, int rank,
                                          int m0, int n0) {
  constexpr int kRows = kWgBM / kR, kPlaces = 16 / kR;
  constexpr int kN = kRows * (kWgBN / 4);
  for (int i0 = threadIdx.x; i0 < kN; i0 += kPlaces * kWgThreads) {
    float4 v[kPlaces][kR];
#pragma unroll
    for (int u = 0; u < kPlaces; ++u) {
      const int i = i0 + u * kWgThreads;
      const int r = rank * kRows + i / (kWgBN / 4), c = 4 * (i % (kWgBN / 4));
#pragma unroll
      for (int q = 0; q < kR; ++q)
        if (i < kN) v[u][q] = io_load_remote(part + r * kIoLd + c, q);
    }
#pragma unroll
    for (int u = 0; u < kPlaces; ++u) {
      const int i = i0 + u * kWgThreads;
      const int r = rank * kRows + i / (kWgBN / 4), c = 4 * (i % (kWgBN / 4));
      const int row = m0 + r, col = n0 + c;
      if (i >= kN || row >= P.M || col >= P.N) continue;
      float4 s = v[u][0];
#pragma unroll
      for (int q = 1; q < kR; ++q) {
        s.x += v[u][q].x;
        s.y += v[u][q].y;
        s.z += v[u][q].z;
        s.w += v[u][q].w;
      }
      if (P.bias) {
        const float4 b = *reinterpret_cast<const float4*>(P.bias + col);
        s.x += b.x;
        s.y += b.y;
        s.z += b.z;
        s.w += b.w;
      }
      io_store4(P, (long)row * P.N + col, s);
    }
  }
}

// The split products: grid (clusters of the launch) x R, cluster (R, 1, 1).
template <bool kAK, bool kBK>
__global__ void __launch_bounds__(kWgThreads, 1)
ffn_io_split(const __grid_constant__ IoMaps maps,
             const __grid_constant__ IoArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kWgStages * kWgStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * kWgBN);
  uint64_t* empty = full + kWgStages;
  const int R = args.cluster;
  const int cid = blockIdx.x / R, rank = blockIdx.x % R;
  const int pi = args.products > 1 && cid >= args.p[1].first ? 1 : 0;
  const IoProduct& P = args.p[pi];
  const int tile = cid - P.first;
  const int m0 = tile / P.n_tiles * kWgBM, n0 = tile % P.n_tiles * kWgBN;
  const int k_tiles = (P.K + kWgBK - 1) / kWgBK;
  const int kt0 = io_k_begin(rank, k_tiles, R);
  const int kt1 = io_k_begin(rank + 1, k_tiles, R);
  io_ring_init(full, empty);
  int it = 0;
  float acc[64];
  if (threadIdx.x >= kWgConsumers) {
    if (threadIdx.x == kWgConsumers)
      io_produce<kAK, kBK>(smem, full, empty, &maps.a[pi], &maps.b[pi], m0,
                           n0, kt0, kt1, it);
  } else {
    io_consume<kAK, kBK>(smem, full, empty, kt1 - kt0, it, acc);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int M = P.M, N = P.N;
  if (R == 1) {
    if (threadIdx.x < kWgConsumers) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + c0 + 8 * j;
        if (col >= N) continue;
        const float b0 = P.bias ? P.bias[col] : 0.f;
        const float b1 = P.bias ? P.bias[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + r0 + 8 * h;
          if (row >= M) continue;
          const float v0 = acc[4 * j + 2 * h] + b0;
          const float v1 = acc[4 * j + 2 * h + 1] + b1;
          const long at = (long)row * N + col;
          if (P.out16)
            *reinterpret_cast<__nv_bfloat162*>(P.out16 + at) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(P.out + at) = make_float2(v0, v1);
        }
      }
    }
  } else {
    // every CTA's partial to its own shared memory, over the ring once
    // both warpgroups' products are done with it
    float* part = reinterpret_cast<float*>(smem);
    if (threadIdx.x < kWgConsumers) {
      asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(part + (r0 + 8 * h) * kIoLd + c0 +
                                     8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    io_cluster_sync();
    switch (R) {
      case 2: io_reduce<2>(P, part, rank, m0, n0); break;
      case 4: io_reduce<4>(P, part, rank, m0, n0); break;
      default: io_reduce<8>(P, part, rank, m0, n0); break;
    }
    io_cluster_sync();  // no CTA leaves while another reads its partial
  }
  // a bias gradient's per-tile partials summed in order, by rank 0 of the
  // product's n tile 0
  if (P.colsum_out && n0 == 0 && rank == 0 && threadIdx.x < kWgBM &&
      m0 + threadIdx.x < M) {
    const int r = m0 + threadIdx.x;
    float s = 0.f;
    for (int i0 = 0; i0 < P.colsum_count; i0 += 8) {
      float v[8];  // eight partials' loads in flight, then their sums
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = i0 + u < P.colsum_count
                   ? P.colsum_part[(long)(i0 + u) * M + r] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < P.colsum_count) s += v[u];
    }
    P.colsum_out[r] = s;
  }
}

inline cudaError_t io_maps(CUtensorMap* ma, CUtensorMap* mb, bool ak, bool bk,
                           const bf16* A, const bf16* B, int M, int N,
                           int K) {
  cudaError_t err = ak ? bf16_tensor_map(ma, A, K, M, kWgBM)
                       : bf16_tensor_map(ma, A, M, K, kWgBK);
  if (err != cudaSuccess) return err;
  return bk ? bf16_tensor_map(mb, B, K, N, kWgBN)
            : bf16_tensor_map(mb, B, N, K, kWgBK);
}

// One ffn_io_split launch of args.products products (A[i], B[i] in the
// stated majors), args.cluster CTAs a tile.
template <bool kAK, bool kBK>
cudaError_t io_split(const bf16* const* A, const bf16* const* B,
                     IoArgs args, cudaStream_t stream) {
  IoMaps maps = {};
  int clusters = 0;
  for (int i = 0; i < args.products; ++i) {
    const IoProduct& p = args.p[i];
    if (p.first != clusters) return cudaErrorInvalidValue;
    clusters += p.tiles;
    const cudaError_t err = io_maps(&maps.a[i], &maps.b[i], kAK, kBK, A[i],
                                    B[i], p.M, p.N, p.K);
    if (err != cudaSuccess) return err;
  }
  if (clusters == 0) return cudaSuccess;
  auto kernel = ffn_io_split<kAK, kBK>;
  cudaError_t err = set_smem((const void*)kernel, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(clusters * args.cluster);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmemBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = args.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The hidden (and with args.dh, dh and the bias partials) of M rows.
inline cudaError_t io_hidden(const bf16* x, const bf16* w1, const bf16* g,
                             const bf16* w2, const IoHiddenArgs& args,
                             cudaStream_t stream) {
  if (args.M <= 0 || args.Dff <= 0) return cudaSuccess;
  CUtensorMap mx = {}, mw1 = {}, mg = {}, mw2 = {};
  cudaError_t err = io_maps(&mx, &mw1, true, true, x, w1, args.M, args.Dff,
                            args.Din);
  if (err != cudaSuccess) return err;
  if (args.dh) {
    err = io_maps(&mg, &mw2, true, false, g, w2, args.M, args.Dff,
                  args.Dout);
    if (err != cudaSuccess) return err;
  }
  err = set_smem((const void*)ffn_io_hidden, kIoHiddenSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Dff + kWgBN - 1) / kWgBN, (args.M + kWgBM - 1) / kWgBM);
  ffn_io_hidden<<<grid, kWgThreads, kIoHiddenSmem, stream>>>(mx, mw1, mg,
                                                              mw2, args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cpc2
