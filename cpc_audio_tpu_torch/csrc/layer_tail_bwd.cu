// K3 backward (transformer-layer tail LN1 -> FFN -> residual -> LN2): the
// C entry points.  They size and launch one body for both dtypes, six
// tensor-core GEMMs with fused epilogues, bf16 operands as they are and
// float32 ones split into bf16 planes: csrc/layer_tail_tc.cu, which names
// the Pallas kernel it replaces and says why it is built so.
#include "common.cuh"
#include "dropout.cuh"
#include "layer_tail_tc.cuh"

// Row tiles of the body's vector partials (the wrapper sizes vec_part with
// it), the shared memory of its largest block, and the device-memory
// scratch it needs; 0 for a bad dtype.
extern "C" int cpc_layer_tail_bwd_tiles(int M, int D, int dtype) {
  if (dtype != cpc::kBFloat16 && dtype != cpc::kFloat32) return 0;
  return cpc::tail_tc::row_tiles(M, D);
}

extern "C" size_t cpc_layer_tail_bwd_smem(int D, int F, int dtype) {
  if (dtype != cpc::kBFloat16 && dtype != cpc::kFloat32) return 0;
  return cpc::tail_tc::smem_bytes(D);
}

extern "C" size_t cpc_layer_tail_bwd_scratch(int K, int M, int D, int F,
                                             int dtype) {
  if (dtype != cpc::kBFloat16 && dtype != cpc::kFloat32) return 0;
  return cpc::tail_tc::scratch_bytes(K, M, D, F, dtype, false);
}

// x, w1, w2, dout and dx in `dtype`; the LN parameters and biases float32;
// outputs vec_out (5, K, D) = (dln1w, dln1b, db2, dln2w, dln2b), dw1 (K,
// D, F), db1 (K, F), dw2 (K, F, D) float32; vec_part is float32 scratch
// of K * tiles * 5 * D elements, and `scratch` cpc_layer_tail_bwd_scratch
// bytes.
extern "C" int cpc_layer_tail_bwd(
    const void* x, const void* ln1w, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2w,
    const void* ln2b, const void* dout, void* dx, void* vec_part,
    void* vec_out, void* dw1, void* db1, void* dw2, void* scratch, int K,
    int M, int D, int F, float eps, const void* seed, unsigned int threshold,
    float keep_scale, int dtype, void* stream) {
  if (!cpc::tail_tc::shapes_ok(D, F, dtype))
    return (int)cudaErrorInvalidValue;
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return cpc::tail_tc::launch_bwd(
      x, f(ln1w), f(ln1b), w1, f(b1), w2, f(b2), f(ln2w), f(ln2b), dout, dx,
      static_cast<float*>(vec_part), static_cast<float*>(vec_out),
      static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), scratch, K, M, D, F, eps, drop, dtype,
      static_cast<cudaStream_t>(stream));
}
