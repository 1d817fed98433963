// Causal relative-position attention of the prediction heads, bf16 q, k,
// v, out and gradients (`--precision bf16`): the C entry points of the
// bf16 instantiations of the kernels in attention.cuh, which describes
// them (its "bf16-in/bf16-out variant" paragraph).
#include "attention.cuh"

extern "C" {

// As cpc2_attention_fwd with q, k, v and out in bf16 (p~ rounded to bf16
// as p~ . v's operand, out rounded once); krel stays fp32. dk_in a
// multiple of 8 (the plan's bf16 rows); every pointer 16-byte aligned.
int cpc2_attention_fwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                              const float* krel, const unsigned* seed,
                              bf16* out, const int* plan, int n_plan,
                              unsigned threshold, float keep_scale,
                              float scale, void* stream) {
  return attention_fwd(q, k, v, krel, seed, out, plan, n_plan, threshold,
                       keep_scale, scale, static_cast<cudaStream_t>(stream));
}

// As cpc2_attention_bwd with q, k, v, g, dq, dk and dv in bf16 (p~
// recomputed in fp32); partial and dkrel stay fp32.
int cpc2_attention_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                              const float* krel, const unsigned* seed,
                              const bf16* g, bf16* dq, bf16* dk_out,
                              bf16* dv, float* partial, float* dkrel,
                              const int* plan, int n_plan,
                              unsigned threshold, float keep_scale,
                              float scale, void* stream) {
  return attention_bwd(q, k, v, krel, seed, g, dq, dk_out, dv, partial, dkrel,
                       plan, n_plan, threshold, keep_scale, scale,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
