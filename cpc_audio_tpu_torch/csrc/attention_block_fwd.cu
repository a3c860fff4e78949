// K6: the prediction heads' whole attention block, forward.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_block_fwd_kernel`
// (called through `fused_attention_block`).  For head stack k, with c the
// (n_batch*S, D) context and D = nheads*dk:
//   q = round(c . Wq[k]),  k = round(c . Wk[k]),  v = round(c . Wv[k])
//   y = the nheads causal Shaw attentions (K2's), each rounded to E
//   x[k] = round(c + round(y . Wo[k]))
// with round() the rounding to the input dtype E after float32 sums (the
// Pallas kernel's `_dot_cast`).
//
// Design (csrc/attention_block_tc.cuh): three phases, each over all K
// head stacks at once, from this one C entry:
//   1. Proj, one GEMM launch on gemm_tc.cuh: [q | k | v] in E, written in
//      the natural (K, n_batch*S, D) rows K2's tensor-core body stages;
//   2. K2's tensor-core forward through its C entry
//      (`cpc_relpos_attention_fwd_tc`): y in E, the same dropout bits
//      (site SITE_ATTENTION, keyed on (k, b, h, i, j));
//   3. Out, one GEMM launch whose epilogue adds the residual: x.
// In float32, c and the weights are split into three bf16 planes first,
// and y before phase 3.  q, k, v and y are the caller's buffers: the
// backward reads them again (ops/attention_block.py keeps them).
//
// What bounds it on an H100: at the train shape (K 12, B 32, S 116, 8
// heads x dk 32, D 256) the four projections are 23 GFLOP, 0.023 ms at
// the bf16 peak, and the attention's 0.8 GFLOP a microsecond; q, k, v
// and y go to device memory and back once each (91 MB in bf16, 27 us at
// 3.35 TB/s), beside the inputs and x (24 MB).  In float32 the GEMMs do
// six split products of bf16 work a product.
#include "attention_block_tc.cuh"

namespace {

namespace k6 = cpc::k6;
using k6::bf16;

// The scratch: K2's first (at the allocation's own alignment), then in
// float32 the bf16 planes of c, the weights and y.
struct FwdScratch {
  bf16 *c = nullptr, *w = nullptr, *y = nullptr;
  void* k2;
  size_t bytes;
  FwdScratch(void* base, int K, int M, int D, size_t k2_bytes, bool f32) {
    cpc::Carve cv(base);
    k2 = cv.take<unsigned char>(k2_bytes);
    if (f32) {
      c = cv.take<bf16>((size_t)3 * M * D);
      w = cv.take<bf16>((size_t)4 * 3 * K * D * D);
      y = cv.take<bf16>((size_t)3 * K * M * D);
    }
    bytes = cv.bytes();
  }
};

template <class E>
int forward(const void* c, const void* const* w, const void* krel, void* x,
            void* qkv, void* y, void* scratch, int K, int n_batch, int S,
            int nheads, int dk, const void* seed, unsigned threshold,
            float keep_scale, int dtype, cudaStream_t s) {
  constexpr bool kF32 = k6::Prec<E>::kF32;
  const int M = n_batch * S, D = nheads * dk;
  const size_t kmd = (size_t)K * M * D;
  const size_t k2_bytes =
      cpc_relpos_attention_fwd_tc_scratch(K, n_batch, S, nheads, dk, dtype);
  const FwdScratch sc(scratch, K, M, D, k2_bytes, kF32);
  E* q = static_cast<E*>(qkv);
  k6::Args p{};
  p.K = K;
  p.M = M;
  p.D = D;
  p.kmd = kmd;
  p.c_in = c;
  cudaError_t err = cudaSuccess;
  if constexpr (kF32) {
    k6::SplitJobs jobs{};
    jobs.src[0] = static_cast<const float*>(c);
    jobs.dst[0] = sc.c;
    jobs.n[0] = (size_t)M * D;
    for (int i = 0; i < 4; ++i) {
      jobs.src[1 + i] = static_cast<const float*>(w[i]);
      jobs.dst[1 + i] = sc.w + (size_t)i * 3 * K * D * D;
      jobs.n[1 + i] = (size_t)K * D * D;
    }
    err = k6::split(jobs, 5, s);
    if (err != cudaSuccess) return (int)err;
    p.c = sc.c;
    for (int i = 0; i < 4; ++i) p.w[i] = jobs.dst[1 + i];
    p.c_plane = (size_t)M * D;
    p.w_plane = (size_t)K * D * D;
  } else {
    p.c = static_cast<const bf16*>(c);
    for (int i = 0; i < 4; ++i) p.w[i] = static_cast<const bf16*>(w[i]);
  }
  for (int i = 0; i < 3; ++i) p.out[i] = q + i * kmd;
  err = k6::run<k6::Proj<E>>(p, s);
  if (err != cudaSuccess) return (int)err;
  const int st = cpc_relpos_attention_fwd_tc(
      q, q + kmd, q + 2 * kmd, krel, y, sc.k2, K, n_batch, S, nheads, dk,
      seed, threshold, keep_scale, dtype, s);
  if (st != 0) return st;
  if constexpr (kF32) {
    k6::SplitJobs jobs{};
    jobs.src[0] = static_cast<const float*>(y);
    jobs.dst[0] = sc.y;
    jobs.n[0] = kmd;
    err = k6::split(jobs, 1, s);
    if (err != cudaSuccess) return (int)err;
    p.y = sc.y;
  } else {
    p.y = static_cast<const bf16*>(y);
  }
  p.out[0] = x;
  return (int)k6::run<k6::Out<E>>(p, s);
}

}  // namespace

// Bytes of scratch cpc_attention_block_fwd needs: K2's forward scratch
// and, in float32, the bf16 planes of c, the weights and y.
extern "C" size_t cpc_attention_block_fwd_scratch(int K, int n_batch, int S,
                                                  int nheads, int dk,
                                                  int dtype) {
  const size_t k2 =
      cpc_relpos_attention_fwd_tc_scratch(K, n_batch, S, nheads, dk, dtype);
  return FwdScratch(nullptr, K, n_batch * S, nheads * dk, k2,
                    dtype == cpc::kFloat32)
      .bytes;
}

// c (n_batch*S, D), wq, wk, wv, wo (K, D, D), krel (K, dk, S), x and y
// (K, n_batch*S, D), qkv (3, K, n_batch*S, D), all in `dtype`, 16-byte
// aligned; scratch of cpc_attention_block_fwd_scratch bytes, 256-byte
// aligned.  Writes x, and q, k, v and y for the backward.
extern "C" int cpc_attention_block_fwd(
    const void* c, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* krel, void* x, void* qkv, void* y,
    void* scratch, int K, int n_batch, int S, int nheads, int dk,
    const void* seed, unsigned int threshold, float keep_scale, int dtype,
    void* stream) {
  if (!k6::takes(K, n_batch, S, nheads, dk) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* w[4] = {wq, wk, wv, wo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cpc::kFloat32)
    return forward<float>(c, w, krel, x, qkv, y, scratch, K, n_batch, S,
                          nheads, dk, seed, threshold, keep_scale, dtype, s);
  if (dtype == cpc::kBFloat16)
    return forward<bf16>(c, w, krel, x, qkv, y, scratch, K, n_batch, S,
                         nheads, dk, seed, threshold, keep_scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}
