// Adam with its first moment stored in bf16 (`--adam_mu_dtype bf16`), one
// multi-tensor kernel for Hopper (sm_90a).
//
// The JAX package runs `optax.inject_hyperparams(optax.adam)(...,
// mu_dtype=bfloat16)` (cpc2_tpu/training.py:make_optimizer), which XLA
// computes; there is no TPU kernel. Its arithmetic, per element, with the
// injected b1, b2, eps and learning rate fp32 arrays:
//
//   mu32 = (1 - b1) * g + b1 * float(mu)       three fp32 roundings
//   nu   = (1 - b2) * (g * g) + b2 * nu
//   p   += ((mu32 / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)) * -lr
//   mu   = bf16(mu32)
//
// Every operation here is an explicitly rounded fp32 intrinsic, so the
// compiler contracts nothing into an FMA and the stored moments are the
// plain version's (`cpc2_torch/optim.py:adam_bf16_plain`) bit for bit. The
// step count t is each tensor's own fp32 count in device memory (torch's
// capturable Adam's `step`, incremented before the launch), so that a CUDA
// graph replays the update with the bias corrections computed on the card.
//
// What bounds it: 24 bytes an element moved (p, nu read and written, g
// read, mu read and written in bf16) and 15 operations: bytes, about 0.1 ms
// for the recipe's parameters. A launch takes up to kMaxTensors tensors,
// whose pointers travel in the kernel's parameters; a block takes kElems
// consecutive elements of one tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kElems = kThreads * kPerThread;
constexpr int kMaxTensors = 64;

struct AdamTensor {
  float* p;
  const float* g;
  __nv_bfloat16* mu;
  float* nu;
  const float* step;
  long n;
};

struct AdamArgs {
  AdamTensor t[kMaxTensors];
  int first_block[kMaxTensors + 1];  // tensor i's blocks: [first[i], first[i+1])
  int count;
  float lr, b1, b2, eps;
};

__global__ void __launch_bounds__(kThreads)
adam_bf16_moment(const __grid_constant__ AdamArgs a) {
  int i = 0;
  while (i + 1 < a.count && static_cast<int>(blockIdx.x) >= a.first_block[i + 1])
    ++i;
  const AdamTensor& t = a.t[i];
  const float step = *t.step;
  const float bc1 = __fsub_rn(1.f, powf(a.b1, step));
  const float bc2 = __fsub_rn(1.f, powf(a.b2, step));
  const float omb1 = __fsub_rn(1.f, a.b1), omb2 = __fsub_rn(1.f, a.b2);
  const float neg_lr = -a.lr;
  const long base =
      static_cast<long>(blockIdx.x - a.first_block[i]) * kElems + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long e = base + static_cast<long>(k) * kThreads;
    if (e >= t.n) break;
    const float g = t.g[e];
    const float m = __fadd_rn(__fmul_rn(omb1, g),
                              __fmul_rn(a.b1, __bfloat162float(t.mu[e])));
    const float v = __fadd_rn(__fmul_rn(omb2, __fmul_rn(g, g)),
                              __fmul_rn(a.b2, t.nu[e]));
    const float u = __fdiv_rn(__fdiv_rn(m, bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
    t.p[e] = __fadd_rn(t.p[e], __fmul_rn(u, neg_lr));
    t.mu[e] = __float2bfloat16_rn(m);
    t.nu[e] = v;
  }
}

}  // namespace

extern "C" {

// One Adam step of `count` tensors: params[i], grads[i], nu[i] fp32 and
// mu[i] bf16, each sizes[i] elements, steps[i] its fp32 count (already
// incremented for this step). Host arrays of device pointers; the tensors
// go kMaxTensors to a launch.
int cpc2_adam_bf16_moment(const long* params, const long* grads,
                          const long* mus, const long* nus, const long* steps,
                          const long* sizes, int count, float lr, float b1,
                          float b2, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int start = 0; start < count; start += kMaxTensors) {
    AdamArgs a{};
    a.lr = lr;
    a.b1 = b1;
    a.b2 = b2;
    a.eps = eps;
    int blocks = 0;
    for (int i = start; i < count && i < start + kMaxTensors; ++i) {
      if (sizes[i] <= 0) continue;
      a.t[a.count] = {reinterpret_cast<float*>(params[i]),
                      reinterpret_cast<const float*>(grads[i]),
                      reinterpret_cast<__nv_bfloat16*>(mus[i]),
                      reinterpret_cast<float*>(nus[i]),
                      reinterpret_cast<const float*>(steps[i]), sizes[i]};
      a.first_block[a.count++] = blocks;
      blocks += static_cast<int>((sizes[i] + kElems - 1) / kElems);
    }
    a.first_block[a.count] = blocks;
    if (blocks == 0) continue;
    adam_bf16_moment<<<blocks, kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
