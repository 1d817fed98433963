// Causal relative-position attention of the prediction heads, fp32 q, k,
// v and gradients: the C entry points of the kernels in attention.cuh
// (which holds their design). attention_bf16io.cu holds the bf16-in/
// bf16-out entry points, a translation unit of its own so that the two
// sets of template instantiations compile in parallel.
#include "attention.cuh"

extern "C" {

// q, k, v (N, S, dk_in), krel (dk_in, S) -> out (N, S, dk_in), as the plan
// (`plan`, `n_plan` ints) lays the kernel out. Every pointer 16-byte aligned.
int cpc2_attention_fwd(const float* q, const float* k, const float* v,
                       const float* krel, const unsigned* seed, float* out,
                       const int* plan, int n_plan, unsigned threshold,
                       float keep_scale, float scale, void* stream) {
  return attention_fwd(q, k, v, krel, seed, out, plan, n_plan, threshold,
                       keep_scale, scale, static_cast<cudaStream_t>(stream));
}

// g (N, S, dk_in) -> dq, dk, dv (N, S, dk_in) and dkrel (dk_in, S); partial
// (N, S, dk_in) is scratch. One cluster of bwd_ctas CTAs a unit (one CTA a
// unit for the wide kernel), then the units' dKrelpos partials summed in
// order.
int cpc2_attention_bwd(const float* q, const float* k, const float* v,
                       const float* krel, const unsigned* seed,
                       const float* g, float* dq, float* dk_out, float* dv,
                       float* partial, float* dkrel, const int* plan,
                       int n_plan, unsigned threshold, float keep_scale,
                       float scale, void* stream) {
  return attention_bwd(q, k, v, krel, seed, g, dq, dk_out, dv, partial, dkrel,
                       plan, n_plan, threshold, keep_scale, scale,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
