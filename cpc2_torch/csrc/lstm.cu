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
// same holds across a thread-block cluster: two routes, chosen by the caller
// from (B, H) (cpc2_torch/ops/lstm.py:lstm_plan).
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
// - Steps (`cpc2_lstm_fwd_steps`, `cpc2_lstm_bwd_steps`): where a CTA's
//   slice of W_hh and its buffers exceed the 227 KB of shared memory (H =
//   512, say), one launch per time step whose blocks own kUnits hidden
//   units and read their W_hh rows from L2; the backward reads W_hh^T.
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

// --- steps route: one launch per time step -----------------------------------

constexpr int kUnits = 2;
constexpr int kThreads = 256;

// One forward step t. h_prev/c_prev rows are h_stride apart (h0 rows, or
// the rows of ys[:, t-1]).
__global__ void __launch_bounds__(kThreads)
lstm_fwd_step(const float* __restrict__ gi, const float* __restrict__ h_prev,
              const float* __restrict__ c_prev, long prev_stride,
              const float* __restrict__ w_hh, const float* __restrict__ b_hh,
              float* __restrict__ ys, float* __restrict__ cs,
              float* __restrict__ ga, float* __restrict__ h_last,
              float* __restrict__ c_last, int B, int T, int H, int t) {
  extern __shared__ float smem[];
  float* h_s = smem;              // (B, H)
  float* pre = smem + B * H;      // (4*kUnits, B)
  const int u0 = blockIdx.x * kUnits;
  for (int i = threadIdx.x; i < B * H; i += blockDim.x) {
    const int b = i / H, k = i % H;
    h_s[i] = h_prev[b * prev_stride + k];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int r = warp; r < 4 * kUnits; r += n_warps) {
    const int gate = r / kUnits, u = u0 + r % kUnits;
    if (u >= H) continue;
    const float* w_row = w_hh + (long)(gate * H + u) * H;
    for (int b = 0; b < B; ++b) {
      float acc = 0.f;
      for (int k = lane; k < H; k += 32) acc += w_row[k] * h_s[b * H + k];
      acc = cpc2::warp_sum(acc);
      if (lane == 0) pre[r * B + b] = acc;
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < kUnits * B; p += blockDim.x) {
    const int ul = p % kUnits, b = p / kUnits, u = u0 + ul;
    if (u >= H) continue;
    const long bt = (long)b * T + t;
    const float* g_in = gi + bt * 4 * H;
    const float xi = g_in[u] + pre[(0 * kUnits + ul) * B + b] + b_hh[u];
    const float xf = g_in[H + u] + pre[(1 * kUnits + ul) * B + b] + b_hh[H + u];
    const float xg =
        g_in[2 * H + u] + pre[(2 * kUnits + ul) * B + b] + b_hh[2 * H + u];
    const float xo =
        g_in[3 * H + u] + pre[(3 * kUnits + ul) * B + b] + b_hh[3 * H + u];
    const float i = sigmoid(xi), f = sigmoid(xf), g = tanhf(xg),
                o = sigmoid(xo);
    const float c = f * c_prev[b * prev_stride + u] + i * g;
    const float h = o * tanhf(c);
    ys[bt * H + u] = h;
    cs[bt * H + u] = c;
    float* ga_t = ga + bt * 4 * H;
    ga_t[u] = i;
    ga_t[H + u] = f;
    ga_t[2 * H + u] = g;
    ga_t[3 * H + u] = o;
    if (t == T - 1) {
      h_last[b * H + u] = h;
      c_last[b * H + u] = c;
    }
  }
}

// One backward step t (t = T-1 .. 0), the cell algebra of
// lstm_pallas.py:_bwd_kernel. The recurrent gradient into h_t is
// dgi[:, t+1] @ W_hh (dh_last at t = T-1). dc_carry holds dc_{t+1} * f_{t+1}
// between steps (dc_last at t = T-1) and ends as dc0. The extra step t = -1
// only writes dh0 = dgi[:, 0] @ W_hh.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step(const float* __restrict__ w_hh_t, const float* __restrict__ dys,
              const float* __restrict__ dh_last,
              const float* __restrict__ dc_last, const float* __restrict__ cs,
              const float* __restrict__ ga, const float* __restrict__ c0,
              float* __restrict__ dgi, float* __restrict__ dc_carry,
              float* __restrict__ dh0, int B, int T, int H, int t) {
  extern __shared__ float dh_rec[];  // (B, kUnits)
  const int u0 = blockIdx.x * kUnits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int G = 4 * H;
  for (int task = warp; task < B * kUnits; task += n_warps) {
    const int b = task / kUnits, u = u0 + task % kUnits;
    if (u >= H) continue;
    float acc;
    if (t == T - 1) {
      acc = dh_last[b * H + u];
    } else {
      const float* d_next = dgi + ((long)b * T + t + 1) * G;
      const float* w_col = w_hh_t + (long)u * G;
      acc = 0.f;
      for (int r = lane; r < G; r += 32) acc += d_next[r] * w_col[r];
      acc = cpc2::warp_sum(acc);
    }
    if (lane == 0) dh_rec[task] = acc;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < B * kUnits; p += blockDim.x) {
    const int b = p / kUnits, u = u0 + p % kUnits;
    if (u >= H) continue;
    if (t < 0) {
      dh0[b * H + u] = dh_rec[p];
      continue;
    }
    const long bt = (long)b * T + t;
    const float* ga_t = ga + bt * G;
    const float i = ga_t[u], f = ga_t[H + u], g = ga_t[2 * H + u],
                o = ga_t[3 * H + u];
    const float tanh_c = tanhf(cs[bt * H + u]);
    const float dh = dys[bt * H + u] + dh_rec[p];
    const float dc_next = (t == T - 1) ? dc_last[b * H + u] : dc_carry[b * H + u];
    const float c_prev = (t == 0) ? c0[b * H + u] : cs[(bt - 1) * H + u];
    const float do_pre = dh * tanh_c * o * (1.f - o);
    const float dc = dc_next + dh * o * (1.f - tanh_c * tanh_c);
    const float di_pre = dc * g * i * (1.f - i);
    const float df_pre = dc * c_prev * f * (1.f - f);
    const float dg_pre = dc * i * (1.f - g * g);
    float* dgi_t = dgi + bt * G;
    dgi_t[u] = di_pre;
    dgi_t[H + u] = df_pre;
    dgi_t[2 * H + u] = dg_pre;
    dgi_t[3 * H + u] = do_pre;
    dc_carry[b * H + u] = dc * f;
  }
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

// Steps forward: the arguments of cpc2_lstm_fwd without C and BC.
int cpc2_lstm_fwd_steps(const float* gi, const float* h0, const float* c0,
                        const float* w_hh, const float* b_hh, float* ys,
                        float* cs, float* ga, float* h_last, float* c_last,
                        int B, int T, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(B * H + 4 * kUnits * B) * sizeof(float);
  cudaError_t err = cpc2::set_smem((const void*)lstm_fwd_step, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kUnits - 1) / kUnits);
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : ys + (long)(t - 1) * H;
    const float* cp = t == 0 ? c0 : cs + (long)(t - 1) * H;
    const long stride = t == 0 ? H : (long)T * H;
    lstm_fwd_step<<<grid, kThreads, smem, s>>>(gi, hp, cp, stride, w_hh, b_hh,
                                               ys, cs, ga, h_last, c_last, B,
                                               T, H, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Steps backward. w_hh_t (H,4H) is W_hh^T; hs_prev as for cpc2_lstm_bwd.
int cpc2_lstm_bwd_steps(const float* w_hh_t, const float* dys,
                        const float* dh_last, const float* dc_last,
                        const float* cs, const float* ga, const float* c0,
                        const float* hs_prev, float* dgi, float* dh0,
                        float* dc0, float* dw_hh, float* db_hh, int B, int T,
                        int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * kUnits * sizeof(float);
  cudaError_t err = cpc2::set_smem((const void*)lstm_bwd_step, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kUnits - 1) / kUnits);
  for (int t = T - 1; t >= -1; --t) {
    lstm_bwd_step<<<grid, kThreads, smem, s>>>(w_hh_t, dys, dh_last, dc_last,
                                               cs, ga, c0, dgi, dc0, dh0, B,
                                               T, H, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = dw_hh_product(dgi, hs_prev, dw_hh, B, T, H, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cpc2::colsum(B * T, 4 * H, dgi, 4 * H, db_hh, s);
}

}  // extern "C"
