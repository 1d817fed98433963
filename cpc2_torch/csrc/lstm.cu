// LSTM hidden-to-hidden recurrence, forward and backward, for Hopper.
//
// Replaces the TPU kernel cpc2_tpu/ops/lstm_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_lstm`). Same contract: the input projection
// gi = x @ W_ih^T + b_ih is computed outside, gate order is i, f, g, o, and
// the forward saves the cell states and post-activation gates for the
// backward.
//
// What bounds it: the recurrence is serial in time, and each step is a tiny
// (B, H) x (H, 4H) product that depends on the step before, so a step is
// bound by its latency chain, not by bytes or FLOPs. The TPU kernel keeps the
// 1 MB W_hh resident in VMEM and walks the sequence inside one call. Here the
// same holds across a thread-block cluster or across the whole card: two
// routes, chosen by the caller from (B, H) and the card's SMs
// (cpc2_torch/ops/lstm.py:lstm_plan).
//
// - Resident (`cpc2_lstm_fwd`, `cpc2_lstm_bwd`): one launch per call.
//   Clusters of C CTAs (16 as a non-portable size, or 8); each cluster owns
//   BC batch rows (the ragged last tile is masked) and CTA j owns hidden
//   units [jH/C, (j+1)H/C): its 4H/C gate rows of W_hh stay in shared memory
//   for all T steps (64 KB at H = 256, C = 16). Forward step t: each thread
//   forms a 4-row x BC register tile of h_{t-1} . W^T over a slice of k, W
//   read as float4 and reused across the BC rows; the slices are summed in a
//   fixed order, the cell runs with c in registers (a CTA owns its units' c),
//   and each CTA stores its slice of h_t into the next h buffer of every CTA
//   of the cluster (`st.async` into distributed shared memory). Each h buffer
//   has an mbarrier that counts the bytes arriving in it, so a CTA waits only
//   for the h it reads; with h double-buffered that one wait a step also
//   keeps a writer from overtaking a reader. Backward step t: CTA j holds
//   dgi_{t+1} of its own rows and forms the partial P_j = dgi_{t+1}[:, R_j]
//   . W[R_j, :] over all H columns; slice k of P_j goes to slot j of CTA k
//   (a reduce-scatter, double-buffered slots behind mbarriers as above), and
//   each CTA sums its C slots in rank order 0..C-1: the backward is
//   deterministic, bit for bit. db_hh is summed inside the walk in a fixed
//   order (over clusters by one column sum when there are several), and the
//   walk writes [h0, ys[:, :-1]] for dW_hh = dgi^T . [h0, ys[:, :-1]], one
//   product after it (common.cuh's fp32 GEMM).
//   On an H100 a step costs about 1.5 us at BC = 1 whatever the tile's
//   FLOPs: the chain of shared-memory reads of W (64 KB, 512 clocks at 128
//   bytes a clock), the partial sums, the cell's transcendentals and the
//   remote stores' round trip (PERF.md, "Findings").
// - Grid (`cpc2_lstm_fwd_grid`, `cpc2_lstm_bwd_grid`): where a CTA's
//   slice of W_hh and its buffers exceed a cluster's shared memory (H =
//   512 and wider, or H not a multiple of 4), one cooperative launch per
//   call over the whole card, each CTA's slice resident, one grid barrier a
//   step (the section "grid route" below).
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// --- resident route ----------------------------------------------------------

constexpr int kMaxThreads = 256;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block

// Bytes before the float arrays of a CTA's shared memory: two mbarriers.
constexpr size_t kBarrierBytes = 16;

// Whole-cluster barrier, once at the start (every CTA has started and set up
// its mbarriers before any remote write) and once at the end (no CTA leaves
// while a remote write is in flight).
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster.
__device__ inline uint32_t remote(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ inline void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The CTA's one arrival of a phase, expecting `bytes` of remote stores.
__device__ inline void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes)
               : "memory");
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Store one float into another CTA's shared memory; its 4 bytes count
// towards that CTA's mbarrier `bar` (both remote addresses).
__device__ inline void st_remote(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}

// Threads, the split of the reduction over threads, and the shared memory of
// one CTA; ok is false where the route does not take (H, C, BC). The plan in
// cpc2_torch/ops/lstm.py computes the same numbers.
struct Layout {
  int threads, split;
  size_t smem;
  bool ok;
};

// Forward: thread (rg, ks) owns gate rows 4rg..4rg+3 and the k slice ks of
// H/KS columns; KS is the largest power of two with U*KS <= 256 threads and
// H/KS a multiple of 4. Shared memory: the mbarriers of the two h buffers,
// W^T slice (H, R), h (2, BC, H), the slices' partial sums (KS, BC, R).
Layout fwd_layout(int H, int C, int BC) {
  Layout l{0, 0, 0, false};
  if (H <= 0 || H % C || H % 4 || H / C > kMaxThreads) return l;
  const int U = H / C, R = 4 * U;
  int ks = 1;
  while (U * ks * 2 <= kMaxThreads && H % (8 * ks) == 0) ks *= 2;
  l.threads = U * ks;
  l.split = ks;
  l.smem = kBarrierBytes + sizeof(float) * ((size_t)H * R + 2ul * BC * H +
                                            (size_t)ks * BC * R);
  l.ok = ks >= BC && l.smem <= kSmemLimit;
  return l;
}

// Backward: thread (cg, rs) owns columns 4cg..4cg+3 and the row slice rs of
// R/RS rows. Shared memory: the mbarriers of the two slot buffers, W slice
// (R, H), the slices' partial sums (RS, BC, H), dgi of the CTA's rows (BC,
// R), the reduce-scatter slots (2, C, BC, U).
Layout bwd_layout(int H, int C, int BC) {
  Layout l{0, 0, 0, false};
  if (H <= 0 || H % C || H % 4 || H / 4 > kMaxThreads) return l;
  const int U = H / C, R = 4 * U, CG = H / 4;
  int rs = 1;
  while (CG * rs * 2 <= kMaxThreads && R % (8 * rs) == 0) rs *= 2;
  l.threads = CG * rs;
  l.split = rs;
  l.smem = kBarrierBytes +
           sizeof(float) * ((size_t)R * H + (size_t)rs * BC * H +
                            (size_t)BC * R + 2ul * C * BC * U);
  l.ok = l.threads >= U * BC && l.smem <= kSmemLimit;
  return l;
}

template <int C, int BC>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_resident(const float* __restrict__ gi, const float* __restrict__ h0,
                  const float* __restrict__ c0,
                  const float* __restrict__ w_hh,
                  const float* __restrict__ b_hh, float* __restrict__ ys,
                  float* __restrict__ cs, float* __restrict__ ga,
                  float* __restrict__ h_last, float* __restrict__ c_last,
                  int B, int T, int H, int KS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int U = H / C, R = 4 * U, G = 4 * H;
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / C) * BC;
  const int nb = min(BC, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  // bars[q] counts the bytes of h that arrive in hbuf[q]
  const uint32_t bars = smem_u32(smem_raw);
  float* wt = reinterpret_cast<float*>(smem_raw + kBarrierBytes);  // (H, R)
  float* hbuf = wt + (size_t)H * R;    // (2, BC, H)
  float* red = hbuf + 2 * BC * H;      // (KS, BC, R)

  // The W_hh rows of this CTA's units, gate-major (r = gate U + unit),
  // stored transposed. A lane group reads 4 float4 of each of 8 rows.
  const int H4 = H / 4, nq = (H4 + 3) / 4;
  for (int i = tid; i < nq * R * 4; i += nt) {
    const int k4 = (i / (4 * R)) * 4 + (i & 3), r = (i >> 2) % R;
    if (k4 >= H4) continue;
    const long grow = (long)(r / U) * H + u0 + r % U;
    const float4 v = reinterpret_cast<const float4*>(w_hh + grow * H)[k4];
    wt[(4 * k4 + 0) * R + r] = v.x;
    wt[(4 * k4 + 1) * R + r] = v.y;
    wt[(4 * k4 + 2) * R + r] = v.z;
    wt[(4 * k4 + 3) * R + r] = v.w;
  }
  for (int i = tid; i < 2 * BC * H; i += nt) {
    const int b = (i / H) % BC;
    hbuf[i] = (i < BC * H && b < nb) ? h0[(long)(b0 + b) * H + i % H] : 0.f;
  }
  // The cell's item: unit u0 + u of batch row b0 + b.
  const int u = tid % U, b = tid / U;
  const bool own = tid < U * BC && b < nb;
  const long row = b0 + b;
  float c = 0.f, bias[4] = {}, gin[4] = {};
  if (own) {
    c = c0[row * H + u0 + u];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bias[g] = b_hh[g * H + u0 + u];
      gin[g] = gi[row * T * G + g * H + u0 + u];
    }
  }
  // each CTA's valid rows of h_t, from all C CTAs
  const uint32_t h_bytes = (uint32_t)(nb * H * sizeof(float));
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bars, h_bytes);
    mbar_expect(bars + 8, h_bytes);
  }
  cluster_sync();

  const int rg = tid % U, ks = tid / U, kc = H / KS;
  for (int t = 0; t < T; ++t) {
    const int q = t & 1;
    const float* hcur = hbuf + q * BC * H;
    if (t > 0) {
      // h_{t-1} written at step t-1; phase (t-1)/2 of bars[q]
      mbar_wait(bars + 8 * q, ((t - 1) >> 1) & 1);
      if (tid == 0) mbar_expect(bars + 8 * q, h_bytes);  // for step t + 2
    }
    float acc[4][BC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int bb = 0; bb < BC; ++bb) acc[i][bb] = 0.f;
    const int k_lo = ks * kc;
#pragma unroll 2
    for (int k = k_lo; k < k_lo + kc; k += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(wt + (k + 0) * R + 4 * rg);
      const float4 w1 = *reinterpret_cast<const float4*>(wt + (k + 1) * R + 4 * rg);
      const float4 w2 = *reinterpret_cast<const float4*>(wt + (k + 2) * R + 4 * rg);
      const float4 w3 = *reinterpret_cast<const float4*>(wt + (k + 3) * R + 4 * rg);
#pragma unroll
      for (int bb = 0; bb < BC; ++bb) {
        const float4 hv = *reinterpret_cast<const float4*>(hcur + bb * H + k);
        acc[0][bb] = fmaf(w0.x, hv.x, fmaf(w1.x, hv.y, fmaf(w2.x, hv.z, fmaf(w3.x, hv.w, acc[0][bb]))));
        acc[1][bb] = fmaf(w0.y, hv.x, fmaf(w1.y, hv.y, fmaf(w2.y, hv.z, fmaf(w3.y, hv.w, acc[1][bb]))));
        acc[2][bb] = fmaf(w0.z, hv.x, fmaf(w1.z, hv.y, fmaf(w2.z, hv.z, fmaf(w3.z, hv.w, acc[2][bb]))));
        acc[3][bb] = fmaf(w0.w, hv.x, fmaf(w1.w, hv.y, fmaf(w2.w, hv.z, fmaf(w3.w, hv.w, acc[3][bb]))));
      }
    }
#pragma unroll
    for (int bb = 0; bb < BC; ++bb)
      *reinterpret_cast<float4*>(red + (ks * BC + bb) * R + 4 * rg) =
          make_float4(acc[0][bb], acc[1][bb], acc[2][bb], acc[3][bb]);
    __syncthreads();

    float gate[4] = {}, h = 0.f;
    if (own) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.f;
        for (int j = 0; j < KS; ++j) s += red[(j * BC + b) * R + g * U + u];
        gate[g] = gin[g] + s + bias[g];
      }
      gate[0] = sigmoid(gate[0]);
      gate[1] = sigmoid(gate[1]);
      gate[2] = tanhf(gate[2]);
      gate[3] = sigmoid(gate[3]);
      c = gate[1] * c + gate[0] * gate[2];
      h = gate[3] * tanhf(c);
      if (t + 1 < T) {
        const uint32_t dst =
            smem_u32(hbuf + (q ^ 1) * BC * H + b * H + u0 + u);
        const uint32_t bar = bars + 8 * (q ^ 1);
#pragma unroll
        for (int r = 0; r < C; ++r)
          st_remote(remote(dst, r), h, remote(bar, r));
      }
    }
    if (own) {
      const long bt = row * T + t;
      ys[bt * H + u0 + u] = h;
      cs[bt * H + u0 + u] = c;
#pragma unroll
      for (int g = 0; g < 4; ++g) ga[bt * G + g * H + u0 + u] = gate[g];
      if (t + 1 < T) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gin[g] = gi[(bt + 1) * G + g * H + u0 + u];
      } else {
        h_last[row * H + u0 + u] = h;
        c_last[row * H + u0 + u] = c;
      }
    }
    __syncthreads();  // all partial sums read before the next step's
  }
  cluster_sync();
}

template <int C, int BC>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_resident(const float* __restrict__ w_hh,
                  const float* __restrict__ dys,
                  const float* __restrict__ dh_last,
                  const float* __restrict__ dc_last,
                  const float* __restrict__ cs, const float* __restrict__ ga,
                  const float* __restrict__ c0, const float* __restrict__ h0,
                  const float* __restrict__ ys, float* __restrict__ hs_prev,
                  float* __restrict__ dgi, float* __restrict__ dh0,
                  float* __restrict__ dc0, float* __restrict__ db_part, int B,
                  int T, int H, int RS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int U = H / C, R = 4 * U, G = 4 * H, CG = H / 4;
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / C) * BC;
  const int nb = min(BC, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  // bars[q] counts the bytes that arrive in the slots recv[q]
  const uint32_t bars = smem_u32(smem_raw);
  float* ws = reinterpret_cast<float*>(smem_raw + kBarrierBytes);  // (R, H)
  float* red = ws + (size_t)R * H;        // (RS, BC, H)
  float* dg = red + (size_t)RS * BC * H;  // (BC, R): dgi_{t+1} of own rows
  float* recv = dg + BC * R;              // (2, C, BC, U)

  const int H4 = H / 4;
  for (int i = tid; i < R * H4; i += nt) {
    const int r = i / H4;
    const long grow = (long)(r / U) * H + u0 + r % U;
    reinterpret_cast<float4*>(ws)[i] =
        reinterpret_cast<const float4*>(w_hh + grow * H)[i % H4];
  }
  for (int i = tid; i < BC * R; i += nt) dg[i] = 0.f;

  const int u = tid % U, b = tid / U;
  const bool own = tid < U * BC && b < nb;
  const long row = b0 + b;
  float dc = own ? dc_last[row * H + u0 + u] : 0.f;
  float db[4] = {};
  // the inputs of step t, loaded one step ahead; h_{t-1} goes to hs_prev,
  // the right operand of the dW_hh product after the walk
  float x_dy = 0.f, x_c = 0.f, x_cp = 0.f, x_hp = 0.f, x_g[4] = {};
  auto load_step = [&](int t) {
    const long bt = row * T + t;
    x_dy = dys[bt * H + u0 + u];
    x_c = cs[bt * H + u0 + u];
    x_cp = t > 0 ? cs[(bt - 1) * H + u0 + u] : c0[row * H + u0 + u];
    x_hp = t > 0 ? ys[(bt - 1) * H + u0 + u] : h0[row * H + u0 + u];
#pragma unroll
    for (int g = 0; g < 4; ++g) x_g[g] = ga[bt * G + g * H + u0 + u];
  };
  if (own) load_step(T - 1);
  // every CTA's partial of the CTA's units, all BC rows
  const uint32_t slot_bytes = (uint32_t)(BC * H * sizeof(float));
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bars, slot_bytes);
    mbar_expect(bars + 8, slot_bytes);
  }
  cluster_sync();

  const int cgi = tid % CG, rs = tid / CG, rc = R / RS;
  for (int t = T - 1; t >= -1; --t) {
    const int q = t & 1;
    float* slots = recv + q * C * BC * U;
    if (t < T - 1) {
      // P_j[b, k] = sum over own rows r of dgi_{t+1}[b, r] W[r, k]
      float acc[4][BC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int bb = 0; bb < BC; ++bb) acc[i][bb] = 0.f;
      const int r_lo = rs * rc;
#pragma unroll 2
      for (int r = r_lo; r < r_lo + rc; r += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(ws + (r + 0) * H + 4 * cgi);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + (r + 1) * H + 4 * cgi);
        const float4 w2 = *reinterpret_cast<const float4*>(ws + (r + 2) * H + 4 * cgi);
        const float4 w3 = *reinterpret_cast<const float4*>(ws + (r + 3) * H + 4 * cgi);
#pragma unroll
        for (int bb = 0; bb < BC; ++bb) {
          const float4 d = *reinterpret_cast<const float4*>(dg + bb * R + r);
          acc[0][bb] = fmaf(d.x, w0.x, fmaf(d.y, w1.x, fmaf(d.z, w2.x, fmaf(d.w, w3.x, acc[0][bb]))));
          acc[1][bb] = fmaf(d.x, w0.y, fmaf(d.y, w1.y, fmaf(d.z, w2.y, fmaf(d.w, w3.y, acc[1][bb]))));
          acc[2][bb] = fmaf(d.x, w0.z, fmaf(d.y, w1.z, fmaf(d.z, w2.z, fmaf(d.w, w3.z, acc[2][bb]))));
          acc[3][bb] = fmaf(d.x, w0.w, fmaf(d.y, w1.w, fmaf(d.z, w2.w, fmaf(d.w, w3.w, acc[3][bb]))));
        }
      }
#pragma unroll
      for (int bb = 0; bb < BC; ++bb)
        *reinterpret_cast<float4*>(red + (rs * BC + bb) * H + 4 * cgi) =
            make_float4(acc[0][bb], acc[1][bb], acc[2][bb], acc[3][bb]);
      __syncthreads();
      // slice k of P_j to slot j of the CTA that owns unit k
      for (int i = tid; i < BC * H; i += nt) {
        const int bb = i / H, k = i % H;
        float s = 0.f;
        for (int j = 0; j < RS; ++j) s += red[(j * BC + bb) * H + k];
        st_remote(remote(smem_u32(slots + (rank * BC + bb) * U + k % U),
                         k / U),
                  s, remote(bars + 8 * q, k / U));
      }
      // phase (T-2-t)/2 of bars[q]
      mbar_wait(bars + 8 * q, ((T - 2 - t) >> 1) & 1);
      if (tid == 0) mbar_expect(bars + 8 * q, slot_bytes);  // for step t-2
    }
    if (own) {
      float dh_rec = 0.f;
      if (t == T - 1) {
        dh_rec = dh_last[row * H + u0 + u];
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) dh_rec += slots[(j * BC + b) * U + u];
      }
      if (t < 0) {
        dh0[row * H + u0 + u] = dh_rec;
        dc0[row * H + u0 + u] = dc;
      } else {
        const float i = x_g[0], f = x_g[1], g = x_g[2], o = x_g[3];
        const float tanh_c = tanhf(x_c);
        const float dh = x_dy + dh_rec;
        const float do_pre = dh * tanh_c * o * (1.f - o);
        const float dcv = dc + dh * o * (1.f - tanh_c * tanh_c);
        const float d[4] = {dcv * g * i * (1.f - i),
                            dcv * x_cp * f * (1.f - f),
                            dcv * i * (1.f - g * g), do_pre};
        const long bt = row * T + t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dg[b * R + q * U + u] = d[q];
          dgi[bt * G + q * H + u0 + u] = d[q];
          db[q] += d[q];
        }
        hs_prev[bt * H + u0 + u] = x_hp;
        dc = dcv * f;
        if (t > 0) load_step(t - 1);
      }
    }
    __syncthreads();
  }

  // db_hh of own rows: each thread's sum over t, then over b in order
  float* dbs = red;  // (BC, R)
  if (own)
#pragma unroll
    for (int q = 0; q < 4; ++q) dbs[b * R + q * U + u] = db[q];
  __syncthreads();
  for (int r = tid; r < R; r += nt) {
    float s = 0.f;
    for (int bb = 0; bb < nb; ++bb) s += dbs[bb * R + r];
    db_part[(long)(blockIdx.x / C) * G + (r / U) * H + u0 + r % U] = s;
  }
  cluster_sync();
}

using FwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           float*, float*, int, int, int, int);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*, float*,
                           float*, float*, float*, float*, int, int, int, int);

template <int C>
FwdKernel fwd_kernel_bc(int BC) {
  switch (BC) {
    case 1: return lstm_fwd_resident<C, 1>;
    case 2: return lstm_fwd_resident<C, 2>;
    case 4: return lstm_fwd_resident<C, 4>;
    case 8: return lstm_fwd_resident<C, 8>;
  }
  return nullptr;
}

template <int C>
BwdKernel bwd_kernel_bc(int BC) {
  switch (BC) {
    case 1: return lstm_bwd_resident<C, 1>;
    case 2: return lstm_bwd_resident<C, 2>;
    case 4: return lstm_bwd_resident<C, 4>;
    case 8: return lstm_bwd_resident<C, 8>;
  }
  return nullptr;
}

const void* resident_kernel(int C, int BC, bool backward) {
  if (C == 8)
    return backward ? (const void*)bwd_kernel_bc<8>(BC)
                    : (const void*)fwd_kernel_bc<8>(BC);
  if (C == 16)
    return backward ? (const void*)bwd_kernel_bc<16>(BC)
                    : (const void*)fwd_kernel_bc<16>(BC);
  return nullptr;
}

// The launch configuration of a cluster launch, with the kernel's shared
// memory and cluster-size attributes set. The first time a (kernel, shared
// memory) pair is seen, it also checks that the card can place at least one
// such cluster (cudaOccupancyMaxActiveClusters): a cluster that cannot be
// placed is an error, never a hang.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

cudaError_t cluster_config(const void* fn, int C, int n_clusters,
                           const Layout& l, cudaStream_t s,
                           ClusterLaunch* out, int* max_clusters) {
  cudaError_t err = cpc2::set_smem(fn, l.smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  out->cfg = cudaLaunchConfig_t{};
  out->cfg.gridDim = dim3(C * n_clusters);
  out->cfg.blockDim = dim3(l.threads);
  out->cfg.dynamicSmemBytes = l.smem;
  out->cfg.stream = s;
  out->attr.id = cudaLaunchAttributeClusterDimension;
  out->attr.val.clusterDim.x = C;
  out->attr.val.clusterDim.y = 1;
  out->attr.val.clusterDim.z = 1;
  out->cfg.attrs = &out->attr;
  out->cfg.numAttrs = 1;

  constexpr int kCache = 64;
  static const void* seen_fn[kCache];
  static size_t seen_smem[kCache];
  static int seen_count[kCache];
  static int n_seen = 0;
  for (int i = 0; i < n_seen; ++i) {
    if (seen_fn[i] == fn && seen_smem[i] == l.smem) {
      *max_clusters = seen_count[i];
      return cudaSuccess;
    }
  }
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &out->cfg);
  if (err != cudaSuccess) return err;
  if (n_seen < kCache) {
    seen_fn[n_seen] = fn;
    seen_smem[n_seen] = l.smem;
    seen_count[n_seen] = n;
    ++n_seen;
  }
  *max_clusters = n;
  return cudaSuccess;
}

// --- grid route: one cooperative launch a call --------------------------------
//
// The widths whose W_hh slice does not fit a cluster (H = 512 and wider, or
// H not a multiple of 4). G CTAs, all resident at once (a cooperative
// launch, which fails with a CUDA error where they cannot be), each owning
// U hidden units [gU, min((g+1)U, H)); U is the smallest with ceil(H/U) <=
// the card's SMs, so G = 128 and U = 4 at H = 512 on an H100. A CTA's slice
// of W_hh stays in shared memory for the whole call (forward: its 4U gate
// rows; backward: its U columns, rows of W_hh^T), or, where it does not fit
// beside the staged operand (from about H = 1,200), is read from L2 every
// step by the same kernel. Time is walked inside the launch: a step stages
// the operand every CTA wrote the step before (h_{t-1}, or dgi_{t+1}) from
// L2 into shared memory, forms the CTA's products, runs the cell for its
// units with c (dc) in registers, writes its outputs, and ends in one grid
// barrier (`cg::this_grid().sync()`). h_t and h_{t-1} (dgi_t and dgi_{t+1})
// live at different addresses, so one barrier a step is enough. Those
// operands are read through L2 only (`ld.global.cg`): never the
// non-coherent path, and never L1, which could hold a stale line of a row
// another CTA has written since.
//
// A product tile is 32 sums: forward, a unit's 4 gates x 8 batch rows;
// backward, 4 units x 8 rows. A warp takes a tile and a slice of k (the
// layout's splits fill the 8 warps); lane l adds up k = 4(l + 32i) .. +3 in
// fp32 FMAs, then the lanes' partials are reduced in a fixed butterfly that
// leaves sum l in lane l, and the cell adds the splits in order 0, 1, ...
// No atomics on values: the backward is the same bit for bit across calls.
// The batch is staged in chunks of `chunk` rows within a step where all of
// it does not fit beside the slice, and walked in blocks of `walk` rows
// (each thread carries c or dc of at most kCellItems (unit, row) items).
// dW_hh stays one product after the walk and db_hh a fixed-order column sum.
// What bounds a step is latency: an L2 round trip for the staged operand,
// the products, the cell and the barrier; the layout is mirrored by
// cpc2_torch/ops/lstm.py:grid_layout.

constexpr int kGridThreads = 256;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kCellItems = 4;
constexpr int kTileRows = 8;    // batch rows of a product tile
constexpr int kStageLoads = 16; // loads a thread has in flight when staging

struct GridLayout {
  int ctas, units, walk, chunk, splits, w_smem;
  size_t smem;
  bool ok;
};

// The layout at (B, H) on a card of `sms` SMs, forward or backward. The
// CTAs resident at once are min(1, the kernel's
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) x sms (`grid_setup` checks
// the occupancy): one CTA an SM at most, since a second CTA on an SM would
// stage the operand again and add an arrival to every barrier, for no FMA
// the first cannot run. Row length of the staged operand: forward H
// rounded up to 4 (zero padded), backward 4H. Shared memory: the W slice (forward (4U, k_row); backward
// (4 ceil(U/4), 4H), zero rows past the CTA's units) when it fits, the
// staged chunk (chunk, k_row), the splits' partial tiles (splits, tiles,
// 32). The largest chunk of the walk's rows that fits, with the slice in
// shared memory if any chunk fits beside it.
GridLayout grid_layout(int B, int H, int sms, bool backward) {
  GridLayout l{0, 0, 0, 0, 0, 0, 0, false};
  if (B < 1 || H < 1 || sms < 1) return l;
  const int U = (H + sms - 1) / sms;
  l.units = U;
  l.ctas = (H + U - 1) / U;
  l.walk = std::min(B, kGridThreads * kCellItems / U);
  if (l.walk < 1) return l;
  const long k_row = backward ? 4l * H : (H + 3) / 4 * 4l;
  const int groups = backward ? (U + 3) / 4 : U;
  const long w_floats = backward ? 4l * groups * k_row : 4l * U * k_row;
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    for (int chunk = l.walk; chunk >= 1; --chunk) {
      const int tiles = groups * ((chunk + kTileRows - 1) / kTileRows);
      const int splits = std::max(1, kGridWarps / tiles);
      const size_t smem = sizeof(float) *
          ((w_smem ? w_floats : 0) + chunk * k_row + 32l * splits * tiles);
      if (smem <= kSmemLimit) {
        l.chunk = chunk;
        l.splits = splits;
        l.w_smem = w_smem;
        l.smem = smem;
        l.ok = true;
        return l;
      }
    }
  }
  return l;
}

// Rows [0, n) of a chunk into `stage` (rows k_row floats apart): row r is
// src[r * stride + k] for k < len, zero beyond. Through L2 only: other CTAs
// of this launch wrote them. Each thread has kStageLoads loads in flight
// before it stores any, so a chunk costs about one L2 round trip.
__device__ __forceinline__ void stage_rows(float* stage, const float* src,
                                           long stride, int n, int len,
                                           int k_row) {
  const int tid = threadIdx.x;
  if ((len & 3) == 0 && len == k_row) {
    const int q = k_row / 4, total = n * q;
    for (int base = tid; base < total; base += kStageLoads * kGridThreads) {
      float4 v[kStageLoads];
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = base + j * kGridThreads;
        if (i < total)
          v[j] = __ldcg(reinterpret_cast<const float4*>(src + (i / q) * stride) +
                        i % q);
      }
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = base + j * kGridThreads;
        if (i < total) reinterpret_cast<float4*>(stage)[i] = v[j];
      }
    }
  } else {
    const int total = n * k_row;
    for (int base = tid; base < total; base += kStageLoads * kGridThreads) {
      float v[kStageLoads];
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = base + j * kGridThreads, k = i % k_row;
        v[j] = (i < total && k < len) ? __ldcg(src + (i / k_row) * stride + k)
                                      : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = base + j * kGridThreads;
        if (i < total) stage[i] = v[j];
      }
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// The warp's 32 sums, v[i] in lane l a partial over l's k: reduced over the
// lanes in a fixed butterfly that leaves sum l in lane l (in v[0]). Step
// kOff keeps the half of v[0, 2 kOff) that lane bit kOff selects and adds
// the partner lane's copy of it.
template <int kOff>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool hi = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = hi ? v[i] : v[i + kOff];
    const float keep = hi ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if constexpr (kOff > 1) butterfly<kOff / 2>(v, lane);
}

__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  butterfly<16>(v, lane);
  return v[0];
}

struct FwdGridArgs {
  const float* gi;
  const float* h0;
  const float* c0;
  const float* w_hh;
  const float* b_hh;
  float* ys;  // also read: h_{t-1}, written by every CTA
  float* cs;
  float* ga;
  float* h_last;
  float* c_last;
  int B, T, H, U, walk, chunk, splits;
};

// Forward. CTA g's W rows gate-major (r = gate U + unit), k padded to 4.
template <bool kWSmem>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_fwd_grid(const FwdGridArgs a) {
  extern __shared__ __align__(16) float smem_f[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, U = a.U, T = a.T, G4 = 4 * H;
  const int k_row = (H + 3) / 4 * 4, K4 = k_row / 4;
  const int u0 = blockIdx.x * U, un = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ws = smem_f;                                     // (4U, k_row)
  float* stage = smem_f + (kWSmem ? 4 * U * k_row : 0);   // (chunk, k_row)
  float* red = stage + (size_t)a.chunk * k_row;           // (splits, tiles, 32)
  if (kWSmem) {
    for (int i = tid; i < 4 * U * k_row; i += kGridThreads) {
      const int r = i / k_row, k = i % k_row, u = r % U;
      ws[i] = (u < un && k < H)
                  ? __ldg(a.w_hh + (long)((r / U) * H + u0 + u) * H + k)
                  : 0.f;
    }
  }
  for (int w0 = 0; w0 < a.B; w0 += a.walk) {
    const int nb = min(a.walk, a.B - w0);
    // the thread's items: unit u of walk row br, for i = tid + q * threads
    float c[kCellItems], bias[kCellItems][4], gin[kCellItems][4];
#pragma unroll
    for (int q = 0; q < kCellItems; ++q) {
      const int i = tid + q * kGridThreads, br = i / U, u = i % U;
      c[q] = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[q][g] = gin[q][g] = 0.f;
      if (br < nb && u < un) {
        c[q] = __ldg(a.c0 + (long)(w0 + br) * H + u0 + u);
#pragma unroll
        for (int g = 0; g < 4; ++g) bias[q][g] = __ldg(a.b_hh + g * H + u0 + u);
      }
    }
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int q = 0; q < kCellItems; ++q) {
        const int i = tid + q * kGridThreads, br = i / U, u = i % U;
        if (br < nb && u < un) {
          const float* g_in = a.gi + ((long)(w0 + br) * T + t) * G4 + u0 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) gin[q][g] = __ldg(g_in + g * H);
        }
      }
      for (int c_lo = 0; c_lo < nb; c_lo += a.chunk) {
        const int n = min(a.chunk, nb - c_lo);
        const long row0 = w0 + c_lo;
        if (t == 0)
          stage_rows(stage, a.h0 + row0 * H, H, n, H, k_row);
        else
          stage_rows(stage, a.ys + (row0 * T + t - 1) * H, (long)T * H, n, H,
                     k_row);
        __syncthreads();
        const int tiles = U * ((n + kTileRows - 1) / kTileRows);
        for (int item = warp; item < tiles * a.splits; item += kGridWarps) {
          const int s = item / tiles, tile = item % tiles;
          const int g8 = tile / U, u = tile % U;
          int off[kTileRows];
#pragma unroll
          for (int j = 0; j < kTileRows; ++j)
            off[j] = min(g8 * kTileRows + j, n - 1) * k_row;
          float v[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) v[i] = 0.f;
          const int hi = (s + 1) * K4 / a.splits;
          for (int k4 = s * K4 / a.splits + lane; k4 < hi; k4 += 32) {
            float4 w[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (kWSmem) {
                w[g] = reinterpret_cast<const float4*>(
                    ws + (g * U + u) * k_row)[k4];
              } else {
                const float* row = a.w_hh + (long)(g * H + u0 + u) * H;
                const int k = 4 * k4;
                const bool ok = u < un;
                w[g] = make_float4(
                    ok && k < H ? __ldg(row + k) : 0.f,
                    ok && k + 1 < H ? __ldg(row + k + 1) : 0.f,
                    ok && k + 2 < H ? __ldg(row + k + 2) : 0.f,
                    ok && k + 3 < H ? __ldg(row + k + 3) : 0.f);
              }
            }
#pragma unroll
            for (int j = 0; j < kTileRows; ++j) {
              const float4 x =
                  reinterpret_cast<const float4*>(stage + off[j])[k4];
#pragma unroll
              for (int g = 0; g < 4; ++g)
                v[g * kTileRows + j] = dot4(w[g], x, v[g * kTileRows + j]);
            }
          }
          red[item * 32 + lane] = reduce_scatter32(v, lane);
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kCellItems; ++q) {
          const int i = tid + q * kGridThreads, br = i / U, u = i % U;
          if (br < c_lo || br >= c_lo + n || u >= un) continue;
          const int r = br - c_lo;
          const float* p =
              red + ((r / kTileRows) * U + u) * 32 + r % kTileRows;
          float gate[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float sum = 0.f;
            for (int sp = 0; sp < a.splits; ++sp)
              sum += p[sp * tiles * 32 + g * kTileRows];
            gate[g] = gin[q][g] + sum + bias[q][g];
          }
          gate[0] = sigmoid(gate[0]);
          gate[1] = sigmoid(gate[1]);
          gate[2] = tanhf(gate[2]);
          gate[3] = sigmoid(gate[3]);
          c[q] = gate[1] * c[q] + gate[0] * gate[2];
          const float h = gate[3] * tanhf(c[q]);
          const long bt = (long)(w0 + br) * T + t;
          a.ys[bt * H + u0 + u] = h;
          a.cs[bt * H + u0 + u] = c[q];
#pragma unroll
          for (int g = 0; g < 4; ++g) a.ga[bt * G4 + g * H + u0 + u] = gate[g];
          if (t == T - 1) {
            a.h_last[(long)(w0 + br) * H + u0 + u] = h;
            a.c_last[(long)(w0 + br) * H + u0 + u] = c[q];
          }
        }
        __syncthreads();  // stage and partials free for the next chunk
      }
      if (t + 1 < T) grid.sync();  // every CTA's h_t written before step t+1
    }
  }
}

struct BwdGridArgs {
  const float* w_hh;
  const float* dys;
  const float* dh_last;
  const float* dc_last;
  const float* cs;
  const float* ga;
  const float* c0;
  const float* h0;
  const float* ys;
  float* hs_prev;
  float* dgi;  // also read: dgi_{t+1}, written by every CTA
  float* dh0;
  float* dc0;
  int B, T, H, U, walk, chunk, splits;
};

// Backward. CTA g's columns of W_hh as rows of W_hh^T (4 ceil(U/4), 4H),
// zero past its units. Step t (T-1 .. 0) forms dh_rec = dgi_{t+1} . W[:, u]
// for its units (dh_last at t = T-1) and runs the cell algebra of
// lstm_pallas.py:_bwd_kernel; step -1 writes dh0 = dgi_0 . W_hh and dc0.
template <bool kWSmem>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_bwd_grid(const BwdGridArgs a) {
  extern __shared__ __align__(16) float smem_b[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, U = a.U, T = a.T, G4 = 4 * H, K4 = H;
  const int groups = (U + 3) / 4, UP = 4 * groups;
  const int u0 = blockIdx.x * U, un = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ws = smem_b;                                  // (UP, 4H)
  float* stage = smem_b + (kWSmem ? UP * G4 : 0);      // (chunk, 4H)
  float* red = stage + (size_t)a.chunk * G4;           // (splits, tiles, 32)
  if (kWSmem) {
    for (int i = tid; i < UP * G4; i += kGridThreads) {
      const int r = i / UP, u = i % UP;
      ws[u * G4 + r] = u < un ? __ldg(a.w_hh + (long)r * H + u0 + u) : 0.f;
    }
  }
  for (int w0 = 0; w0 < a.B; w0 += a.walk) {
    const int nb = min(a.walk, a.B - w0);
    float dc[kCellItems];
#pragma unroll
    for (int q = 0; q < kCellItems; ++q) {
      const int i = tid + q * kGridThreads, br = i / U, u = i % U;
      dc[q] = (br < nb && u < un) ? __ldg(a.dc_last + (long)(w0 + br) * H +
                                          u0 + u)
                                  : 0.f;
    }
    for (int t = T - 1; t >= -1; --t) {
      // step t's inputs of the thread's items; h_{t-1} goes to hs_prev,
      // the right operand of the dW_hh product after the walk
      float x_dy[kCellItems], x_c[kCellItems], x_cp[kCellItems],
          x_hp[kCellItems], x_g[kCellItems][4];
#pragma unroll
      for (int q = 0; q < kCellItems; ++q) {
        const int i = tid + q * kGridThreads, br = i / U, u = i % U;
        x_dy[q] = x_c[q] = x_cp[q] = x_hp[q] = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) x_g[q][g] = 0.f;
        if (t < 0 || br >= nb || u >= un) continue;
        const long row = w0 + br, bt = row * T + t, col = u0 + u;
        x_dy[q] = __ldg(a.dys + bt * H + col);
        x_c[q] = __ldg(a.cs + bt * H + col);
        x_cp[q] = t > 0 ? __ldg(a.cs + (bt - 1) * H + col)
                        : __ldg(a.c0 + row * H + col);
        x_hp[q] = t > 0 ? __ldg(a.ys + (bt - 1) * H + col)
                        : __ldg(a.h0 + row * H + col);
#pragma unroll
        for (int g = 0; g < 4; ++g) x_g[q][g] = __ldg(a.ga + bt * G4 + g * H + col);
      }
      for (int c_lo = 0; c_lo < nb; c_lo += a.chunk) {
        const int n = min(a.chunk, nb - c_lo);
        const int tiles = groups * ((n + kTileRows - 1) / kTileRows);
        if (t < T - 1) {
          stage_rows(stage, a.dgi + ((long)(w0 + c_lo) * T + t + 1) * G4,
                     (long)T * G4, n, G4, G4);
          __syncthreads();
          for (int item = warp; item < tiles * a.splits; item += kGridWarps) {
            const int s = item / tiles, tile = item % tiles;
            const int g8 = tile / groups, ug = tile % groups;
            int off[kTileRows];
#pragma unroll
            for (int j = 0; j < kTileRows; ++j)
              off[j] = min(g8 * kTileRows + j, n - 1) * G4;
            float v[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) v[i] = 0.f;
            const int hi = (s + 1) * K4 / a.splits;
            for (int k4 = s * K4 / a.splits + lane; k4 < hi; k4 += 32) {
              float4 w[4];
#pragma unroll
              for (int uu = 0; uu < 4; ++uu) {
                const int u = 4 * ug + uu;
                if (kWSmem) {
                  w[uu] = reinterpret_cast<const float4*>(ws + u * G4)[k4];
                } else {
                  const float* col = a.w_hh + (long)(4 * k4) * H + u0 + u;
                  const bool ok = u < un;
                  w[uu] = make_float4(ok ? __ldg(col) : 0.f,
                                      ok ? __ldg(col + H) : 0.f,
                                      ok ? __ldg(col + 2 * H) : 0.f,
                                      ok ? __ldg(col + 3 * H) : 0.f);
                }
              }
#pragma unroll
              for (int j = 0; j < kTileRows; ++j) {
                const float4 d =
                    reinterpret_cast<const float4*>(stage + off[j])[k4];
#pragma unroll
                for (int uu = 0; uu < 4; ++uu)
                  v[uu * kTileRows + j] = dot4(d, w[uu], v[uu * kTileRows + j]);
              }
            }
            red[item * 32 + lane] = reduce_scatter32(v, lane);
          }
          __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < kCellItems; ++q) {
          const int i = tid + q * kGridThreads, br = i / U, u = i % U;
          if (br < c_lo || br >= c_lo + n || u >= un) continue;
          const int r = br - c_lo;
          const long row = w0 + br, col = u0 + u;
          float dh_rec = 0.f;
          if (t == T - 1) {
            dh_rec = __ldg(a.dh_last + row * H + col);
          } else {
            const float* p = red + ((r / kTileRows) * groups + u / 4) * 32 +
                             (u % 4) * kTileRows + r % kTileRows;
            for (int sp = 0; sp < a.splits; ++sp) dh_rec += p[sp * tiles * 32];
          }
          if (t < 0) {
            a.dh0[row * H + col] = dh_rec;
            a.dc0[row * H + col] = dc[q];
            continue;
          }
          const float ig = x_g[q][0], fg = x_g[q][1], gg = x_g[q][2],
                      og = x_g[q][3];
          const float tanh_c = tanhf(x_c[q]);
          const float dh = x_dy[q] + dh_rec;
          const float do_pre = dh * tanh_c * og * (1.f - og);
          const float dcv = dc[q] + dh * og * (1.f - tanh_c * tanh_c);
          const float d[4] = {dcv * gg * ig * (1.f - ig),
                              dcv * x_cp[q] * fg * (1.f - fg),
                              dcv * ig * (1.f - gg * gg), do_pre};
          const long bt = row * T + t;
#pragma unroll
          for (int g = 0; g < 4; ++g) a.dgi[bt * G4 + g * H + col] = d[g];
          a.hs_prev[bt * H + col] = x_hp[q];
          dc[q] = dcv * fg;
        }
        __syncthreads();  // stage and partials free for the next chunk
      }
      if (t >= 0) grid.sync();  // every CTA's dgi_t written before step t-1
    }
  }
}

// The grid kernel of a layout, forward or backward.
const void* grid_kernel(bool backward, bool w_smem) {
  if (backward)
    return w_smem ? (const void*)lstm_bwd_grid<true>
                  : (const void*)lstm_bwd_grid<false>;
  return w_smem ? (const void*)lstm_fwd_grid<true>
                : (const void*)lstm_fwd_grid<false>;
}

// The layout at (B, H) on the current device, checked against the caller's
// plan (ctas, units, walk, chunk, splits, w_smem, smem): a plan that differs
// from this file's own layout is refused. Opts the kernel into its shared
// memory.
cudaError_t grid_setup(int B, int H, bool backward, const int* plan,
                       GridLayout* out, const void** fn) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const GridLayout l = grid_layout(B, H, sms, backward);
  const int mine[7] = {l.ctas, l.units, l.walk, l.chunk, l.splits, l.w_smem,
                       (int)l.smem};
  if (!l.ok) return cudaErrorInvalidValue;
  for (int i = 0; i < 7; ++i)
    if (plan[i] != mine[i]) return cudaErrorInvalidValue;
  *fn = grid_kernel(backward, l.w_smem);
  *out = l;
  err = cpc2::set_smem(*fn, l.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *fn,
                                                      kGridThreads, l.smem);
  if (err != cudaSuccess) return err;
  return per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// dW_hh[r, k] = sum over (b, t) of dgi[b, t, r] * hs_prev[b, t, k]
cudaError_t dw_hh_product(const float* dgi, const float* hs_prev,
                          float* dw_hh, int B, int T, int H, cudaStream_t s) {
  const int G = 4 * H, M = B * T;
  cpc2::EpilogueArgs store{cpc2::kStore, nullptr, nullptr, 0u, 1.f};
  return cpc2::gemm(G, H, M, dgi, 1, G, hs_prev, H, 1, dw_hh, H, store, s);
}

}  // namespace

extern "C" {

// Shared memory in bytes of one CTA of the resident route at (H, C, BC),
// forward or backward, or -1 where that route does not take the shape.
long cpc2_lstm_smem(int H, int C, int BC, int backward) {
  const Layout l = backward ? bwd_layout(H, C, BC) : fwd_layout(H, C, BC);
  if (!l.ok || resident_kernel(C, BC, backward) == nullptr) return -1;
  return (long)l.smem;
}

// How many clusters of the resident kernel at (H, C, BC) the card can hold
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int cpc2_lstm_max_clusters(int H, int C, int BC, int backward) {
  const Layout l = backward ? bwd_layout(H, C, BC) : fwd_layout(H, C, BC);
  const void* fn = resident_kernel(C, BC, backward);
  if (!l.ok || fn == nullptr) return -(int)cudaErrorInvalidValue;
  ClusterLaunch launch;
  int n = 0;
  const cudaError_t err = cluster_config(fn, C, 1, l, nullptr, &launch, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Resident forward. gi (B,T,4H), h0/c0 (B,H), w_hh (4H,H), b_hh (4H) ->
// ys/cs (B,T,H), ga (B,T,4H), h_last/c_last (B,H). All fp32, contiguous,
// 16-byte aligned. C CTAs a cluster, BC batch rows a cluster.
int cpc2_lstm_fwd(const float* gi, const float* h0, const float* c0,
                  const float* w_hh, const float* b_hh, float* ys, float* cs,
                  float* ga, float* h_last, float* c_last, int B, int T,
                  int H, int C, int BC, void* stream) {
  const Layout l = fwd_layout(H, C, BC);
  const void* fn = resident_kernel(C, BC, false);
  if (!l.ok || fn == nullptr || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  ClusterLaunch launch;
  int n = 0;
  cudaError_t err = cluster_config(fn, C, (B + BC - 1) / BC, l,
                                   static_cast<cudaStream_t>(stream), &launch,
                                   &n);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&launch.cfg, (FwdKernel)fn, gi,
                           h0, c0, w_hh, b_hh, ys, cs, ga, h_last, c_last, B,
                           T, H, l.split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident backward. h0 and ys are the forward's; the walk writes hs_prev
// (B,T,H) = [h0, ys[:, :-1]], the right operand of the dW_hh product after
// it. db_part holds (ceil(B / BC), 4H) floats when B > BC (one row of db_hh
// partials per cluster, summed in cluster order) and may be null otherwise.
// Writes dgi (B,T,4H), dh0/dc0 (B,H), dw_hh (4H,H), db_hh (4H).
int cpc2_lstm_bwd(const float* w_hh, const float* dys, const float* dh_last,
                  const float* dc_last, const float* cs, const float* ga,
                  const float* c0, const float* h0, const float* ys,
                  float* hs_prev, float* dgi, float* dh0, float* dc0,
                  float* dw_hh, float* db_hh, float* db_part, int B, int T,
                  int H, int C, int BC, void* stream) {
  const Layout l = bwd_layout(H, C, BC);
  const void* fn = resident_kernel(C, BC, true);
  const int n_clusters = (B + BC - 1) / BC;
  if (!l.ok || fn == nullptr || B < 1 || T < 1 ||
      (n_clusters > 1 && db_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ClusterLaunch launch;
  int n = 0;
  cudaError_t err = cluster_config(fn, C, n_clusters, l, s, &launch, &n);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  float* part = n_clusters > 1 ? db_part : db_hh;
  err = cudaLaunchKernelEx(&launch.cfg, (BwdKernel)fn, w_hh, dys, dh_last,
                           dc_last, cs, ga, c0, h0, ys, hs_prev, dgi, dh0,
                           dc0, part, B, T, H, l.split);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_clusters > 1) {
    err = cpc2::colsum(n_clusters, 4 * H, db_part, 4 * H, db_hh, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)dw_hh_product(dgi, hs_prev, dw_hh, B, T, H, s);
}

// The grid route's layout at (B, H) for a card of `sms` SMs, forward or
// backward, into out[0..7]: ctas, units, walk, chunk, splits, w_smem, smem,
// and how many of that kernel's CTAs one SM of the current device holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns 0, -1 where the
// route does not take the shape, or minus a CUDA error code.
int cpc2_lstm_grid_layout(int B, int H, int sms, int backward, int* out) {
  const GridLayout l = grid_layout(B, H, sms, backward);
  if (!l.ok) return -1;
  const void* fn = grid_kernel(backward, l.w_smem);
  cudaError_t err = cpc2::set_smem(fn, l.smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kGridThreads, l.smem);
  if (err != cudaSuccess) return -(int)err;
  const int v[8] = {l.ctas, l.units, l.walk, l.chunk, l.splits, l.w_smem,
                    (int)l.smem, per_sm};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Grid forward: the arguments of cpc2_lstm_fwd, then the plan's seven ints
// (ctas, units, walk, chunk, splits, w_smem, smem) in place of C and BC.
// h0 16-byte aligned. One cooperative launch; a grid the card cannot hold
// at once fails with cudaErrorCooperativeLaunchTooLarge.
int cpc2_lstm_fwd_grid(const float* gi, const float* h0, const float* c0,
                       const float* w_hh, const float* b_hh, float* ys,
                       float* cs, float* ga, float* h_last, float* c_last,
                       int B, int T, int H, int ctas, int units, int walk,
                       int chunk, int splits, int w_smem, int smem,
                       void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const int plan[7] = {ctas, units, walk, chunk, splits, w_smem, smem};
  GridLayout l;
  const void* fn = nullptr;
  cudaError_t err = grid_setup(B, H, false, plan, &l, &fn);
  if (err != cudaSuccess) return (int)err;
  FwdGridArgs a{gi, h0, c0, w_hh, b_hh, ys, cs, ga, h_last, c_last,
                B, T, H, l.units, l.walk, l.chunk, l.splits};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(l.ctas), dim3(kGridThreads),
                                    args, l.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Grid backward: the arguments of cpc2_lstm_bwd without db_part, then the
// plan's seven ints. The walk writes hs_prev = [h0, ys[:, :-1]] for the
// dW_hh product after it; db_hh is the column sum of dgi over (b, t) in
// order.
int cpc2_lstm_bwd_grid(const float* w_hh, const float* dys,
                       const float* dh_last, const float* dc_last,
                       const float* cs, const float* ga, const float* c0,
                       const float* h0, const float* ys, float* hs_prev,
                       float* dgi, float* dh0, float* dc0, float* dw_hh,
                       float* db_hh, int B, int T, int H, int ctas, int units,
                       int walk, int chunk, int splits, int w_smem, int smem,
                       void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const int plan[7] = {ctas, units, walk, chunk, splits, w_smem, smem};
  GridLayout l;
  const void* fn = nullptr;
  cudaError_t err = grid_setup(B, H, true, plan, &l, &fn);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdGridArgs a{w_hh, dys, dh_last, dc_last, cs, ga, c0, h0, ys,
                hs_prev, dgi, dh0, dc0, B, T, H, l.units, l.walk, l.chunk,
                l.splits};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(l.ctas), dim3(kGridThreads),
                                    args, l.smem, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = dw_hh_product(dgi, hs_prev, dw_hh, B, T, H, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cpc2::colsum(B * T, 4 * H, dgi, 4 * H, db_hh, s);
}

}  // extern "C"
