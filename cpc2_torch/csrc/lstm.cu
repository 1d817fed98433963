// LSTM hidden-to-hidden recurrence, forward and backward, for Hopper.
//
// Replaces the TPU kernel cpc2_tpu/ops/lstm_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_lstm`). Same contract: the input projection
// gi = x @ W_ih^T + b_ih is computed outside, gate order is i, f, g, o, and
// the forward saves the cell states and post-activation gates for the
// backward.
//
// What bounds it: the recurrence is serial in time, and each step is a tiny
// (B, H) x (H, 4H) product, so a step is bound by latency (launch, the
// reads of W_hh from L2, one barrier), not by bytes or FLOPs. The TPU
// kernel keeps the 1 MB W_hh resident in VMEM; it does not fit the 227 KB
// of shared memory of one SM. Design: one launch per timestep, all launched
// from one host call onto the caller's stream. Each block owns kUnits hidden
// units (their 4*kUnits gate rows) for all B rows, so W_hh is spread over
// H/kUnits blocks and read from L2 once per step; h_{t-1} is staged in
// shared memory. The backward walks t = T-1 .. 0 the same way, reading
// W_hh^T so that each block's recurrent gradient is a row-contiguous read.
// dW_hh and db_hh, sums over all B*T steps, are one GEMM and one column sum
// after the walk instead of a per-step accumulation.
#include "common.cuh"

namespace {

constexpr int kUnits = 2;
constexpr int kThreads = 256;

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

}  // namespace

extern "C" {

// gi (B,T,4H), h0/c0 (B,H), w_hh (4H,H), b_hh (4H) ->
// ys/cs (B,T,H), ga (B,T,4H), h_last/c_last (B,H). All fp32, contiguous.
int cpc2_lstm_fwd(const float* gi, const float* h0, const float* c0,
                  const float* w_hh, const float* b_hh, float* ys, float* cs,
                  float* ga, float* h_last, float* c_last, int B, int T,
                  int H, void* stream) {
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

// Backward. hs_prev (B,T,H) is [h0, ys[:, :-1]]; w_hh_t (H,4H) is W_hh^T.
// Writes dgi (B,T,4H), dh0/dc0 (B,H), dw_hh (4H,H), db_hh (4H).
int cpc2_lstm_bwd(const float* w_hh_t, const float* dys, const float* dh_last,
                  const float* dc_last, const float* cs, const float* ga,
                  const float* c0, const float* hs_prev, float* dgi,
                  float* dh0, float* dc0, float* dw_hh, float* db_hh, int B,
                  int T, int H, void* stream) {
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
  const int G = 4 * H, M = B * T;
  // dW_hh[r, k] = sum_m dgi[m, r] * hs_prev[m, k]
  cpc2::EpilogueArgs store{cpc2::kStore, nullptr, nullptr, 0u, 1.f};
  err = cpc2::gemm(G, H, M, dgi, 1, G, hs_prev, H, 1, dw_hh, H, store, s);
  if (err != cudaSuccess) return (int)err;
  err = cpc2::colsum(M, G, dgi, G, db_hh, s);
  return (int)err;
}

}  // extern "C"
