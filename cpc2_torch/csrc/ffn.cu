// Position-wise FFN of the transformer prediction heads,
// y = lin2(dropout(relu(lin1(x)))), forward and backward, for Hopper.
//
// Replaces the TPU kernel cpc2_tpu/ops/ffn_pallas.py (`_fwd_kernel`,
// `_bwd_kernel`, `fused_ffn`). Same contract: torch-layout weights W1 (Dff,
// Din) and W2 (Dout, Dff), a dropout mask drawn inside the kernel from a
// seed, and a backward that recomputes the hidden and its mask from that
// seed instead of saving them. The seed lives in device memory, so the
// caller draws it on the card and never waits for it.
//
// What bounds it: at the recipe (M = 928 rows, 256 -> 2048 -> 256) the two
// products are 1.9 GFLOP per head forward, far above the card's
// FLOP-per-byte balance, so it is bound by operations. This first version
// runs them as plain fp32 tiled GEMMs on the FMA units (common.cuh) with
// the bias, ReLU and dropout fused into the first product's epilogue and
// the bias into the second's; the 2048-wide hidden goes through device
// memory (M x Dff fp32, 7.6 MB at the recipe). Tensor-core tiles and
// keeping the hidden on chip are later work.
#include "common.cuh"

extern "C" {

// x (M,Din), w1 (Dff,Din), b1 (Dff), w2 (Dout,Dff), b2 (Dout) -> y (M,Dout).
// hidden (M,Dff) is scratch. Dropout keeps (m, f) when
// dropout_bits(*seed, m, f) >= threshold and scales kept values by scale.
int cpc2_ffn_fwd(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* b2, const unsigned* seed,
                 float* hidden, float* y, int M, int Din, int Dff, int Dout,
                 unsigned threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cpc2::EpilogueArgs hid{cpc2::kBiasReluDropout, b1, seed, threshold, scale};
  cudaError_t err =
      cpc2::gemm(M, Dff, Din, x, Din, 1, w1, 1, Din, hidden, Dff, hid, s);
  if (err != cudaSuccess) return (int)err;
  cpc2::EpilogueArgs out{cpc2::kStore, b2, nullptr, 0u, 1.f};
  err = cpc2::gemm(M, Dout, Dff, hidden, Dff, 1, w2, 1, Dff, y, Dout, out, s);
  return (int)err;
}

// Backward from g = dL/dy (M,Dout). hidden (M,Dff) is scratch: it first
// holds the recomputed dropped hidden, then dL/d(pre-activation) in place.
int cpc2_ffn_bwd(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* g, const unsigned* seed,
                 float* hidden, float* dx, float* dw1, float* db1, float* dw2,
                 float* db2, int M, int Din, int Dff, int Dout,
                 unsigned threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cpc2::EpilogueArgs hid{cpc2::kBiasReluDropout, b1, seed, threshold, scale};
  cpc2::EpilogueArgs store{cpc2::kStore, nullptr, nullptr, 0u, 1.f};
  cpc2::EpilogueArgs mask{cpc2::kDropoutReluGrad, nullptr, nullptr, 0u,
                          scale};
  cudaError_t err;
  // hidden = dropout(relu(x @ W1^T + b1)), the forward's hidden
  err = cpc2::gemm(M, Dff, Din, x, Din, 1, w1, 1, Din, hidden, Dff, hid, s);
  if (err != cudaSuccess) return (int)err;
  // dW2[o, f] = sum_m g[m, o] * hidden[m, f];  db2 = sum_m g[m, :]
  err = cpc2::gemm(Dout, Dff, M, g, 1, Dout, hidden, Dff, 1, dw2, Dff, store,
                   s);
  if (err != cudaSuccess) return (int)err;
  err = cpc2::colsum(M, Dout, g, Dout, db2, s);
  if (err != cudaSuccess) return (int)err;
  // dh[m, f] = (g @ W2)[m, f] * scale where hidden > 0, else 0 (in place)
  err = cpc2::gemm(M, Dff, Dout, g, Dout, 1, w2, Dff, 1, hidden, Dff, mask, s);
  if (err != cudaSuccess) return (int)err;
  // dW1[f, d] = sum_m dh[m, f] * x[m, d];  db1 = sum_m dh[m, :]
  err = cpc2::gemm(Dff, Din, M, hidden, 1, Dff, x, Din, 1, dw1, Din, store, s);
  if (err != cudaSuccess) return (int)err;
  err = cpc2::colsum(M, Dff, hidden, Dff, db1, s);
  if (err != cudaSuccess) return (int)err;
  // dx = dh @ W1
  err = cpc2::gemm(M, Din, Dff, hidden, Dff, 1, w1, Din, 1, dx, Din, store, s);
  return (int)err;
}

}  // extern "C"
