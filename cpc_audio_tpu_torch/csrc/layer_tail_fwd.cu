// K3 forward (transformer-layer tail LN1 -> FFN -> residual -> LN2): the
// C entry points.  They size and launch one body for both dtypes, LN1 and
// two tensor-core GEMMs with fused epilogues (in float32 after the split
// of the weights into bf16 planes): the forward half of
// csrc/layer_tail_tc.cu, which names the Pallas kernel it replaces and
// says why it is built so.
#include "common.cuh"
#include "dropout.cuh"
#include "layer_tail_tc.cuh"

// Device memory the forward needs beside its arguments (y and the hidden,
// in float32 as bf16 planes, with the weights' planes); 0 for a bad dtype.
extern "C" size_t cpc_layer_tail_fwd_scratch(int K, int M, int D, int F,
                                             int dtype) {
  if (dtype != cpc::kBFloat16 && dtype != cpc::kFloat32) return 0;
  return cpc::tail_tc::scratch_bytes(K, M, D, F, dtype, true);
}

// x, w1, w2 and out in `dtype`; the LN parameters and biases float32;
// `scratch` cpc_layer_tail_fwd_scratch bytes.  D a multiple of 8; F a
// multiple of 64 (bf16) or 32 (float32).
extern "C" int cpc_layer_tail_fwd(const void* x, const void* ln1w,
                                  const void* ln1b, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* ln2w,
                                  const void* ln2b, void* out, void* scratch,
                                  int K, int M, int D, int F, float eps,
                                  const void* seed, unsigned int threshold,
                                  float keep_scale, int dtype, void* stream) {
  if (!cpc::tail_tc::shapes_ok(D, F, dtype))
    return (int)cudaErrorInvalidValue;
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return cpc::tail_tc::launch_fwd(
      x, f(ln1w), f(ln1b), w1, f(b1), w2, f(b2), f(ln2w), f(ln2b), out,
      scratch, K, M, D, F, eps, drop, dtype,
      static_cast<cudaStream_t>(stream));
}
