// K6: the prediction heads' whole attention block, backward.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_block_bwd_kernel`
// (called through `_fb_bwd`).  For head stack k, from the forward's q, k,
// v and y (the Pallas kernel recomputes them; here the forward keeps
// them, ops/attention_block.py) and the cotangent dout of x:
//   dy             = round(dout . Wo[k]^T)
//   dq, dk, dv     = K2's backward of the attention at dy (each rounded to
//                    E), and dkrel summed over the rows and heads
//   dWq, dWk, dWv  = c^T . dq, c^T . dk, c^T . dv       (float32)
//   dWo            = y^T . dout                         (float32)
//   dcp[k]         = round(dq . Wq^T + dk . Wk^T + dv . Wv^T)
// with round() the rounding to the input dtype E after float32 sums.  The
// input gradient dc = sum_k (dcp[k] + dout[k]) is summed by the wrapper,
// as the JAX package sums it outside its kernel.
//
// Design (csrc/attention_block_tc.cuh): from this one C entry, over all
// K head stacks at once,
//   1. Dy, one GEMM launch (Wo read n-major): dy in E;
//   2. K2's tensor-core backward through its C entry
//      (`cpc_relpos_attention_bwd_tc`: row, column and diagonal passes,
//      dkrel's windows summed in a fixed order) with the forward's
//      dropout bits;
//   3. DW, one GEMM launch of 4 K weight gradients, A read k-major, depth
//      M, float32 out;
//   4. Dcp, one GEMM launch that walks dq . Wq^T, dk . Wk^T and dv . Wv^T
//      into the same float32 sums and rounds once.
// In float32, c, the weights, dout and y are split into three bf16 planes
// first, and dq, dk, dv before phase 3.
//
// What bounds it on an H100: at the train shape (K 12, B 32, S 116, 8
// heads x dk 32, D 256) the GEMMs are 52 GFLOP (0.053 ms at the bf16
// peak) and K2's backward 2.1 GFLOP; the inputs, y, q, k, v and the
// outputs come to 0.15 GB in bf16 (0.045 ms at 3.35 TB/s), and dy, dq,
// dk, dv go to device memory and back once each.
#include "attention_block_tc.cuh"

namespace {

namespace k6 = cpc::k6;
using k6::bf16;

// The scratch: K2's first (at the allocation's own alignment), dy, dq,
// dk, dv in E, and in float32 the bf16 planes of c, the weights, dout, y,
// dq, dk and dv.
struct BwdScratch {
  void *k2, *dy, *g;
  bf16 *c = nullptr, *w = nullptr, *dout = nullptr, *y = nullptr,
       *gp = nullptr;
  size_t bytes;
  BwdScratch(void* base, int K, int M, int D, size_t k2_bytes, int elt) {
    cpc::Carve cv(base);
    const size_t kmd = (size_t)K * M * D;
    k2 = cv.take<unsigned char>(k2_bytes);
    dy = cv.take<unsigned char>(kmd * elt);
    g = cv.take<unsigned char>(3 * kmd * elt);
    if (elt == 4) {
      c = cv.take<bf16>((size_t)3 * M * D);
      w = cv.take<bf16>((size_t)4 * 3 * K * D * D);
      dout = cv.take<bf16>(3 * kmd);
      y = cv.take<bf16>(3 * kmd);
      gp = cv.take<bf16>(3 * 3 * kmd);
    }
    bytes = cv.bytes();
  }
};

template <class E>
int backward(const void* c, const void* const* w, const void* krel,
             const void* dout, const void* qkv, const void* y, void* dkrel,
             void* dw, void* dcp, void* scratch, int K, int n_batch, int S,
             int nheads, int dk, const void* seed, unsigned threshold,
             float keep_scale, int dtype, cudaStream_t s) {
  constexpr bool kF32 = k6::Prec<E>::kF32;
  const int M = n_batch * S, D = nheads * dk;
  const size_t kmd = (size_t)K * M * D;
  const size_t k2_bytes =
      cpc_relpos_attention_bwd_tc_scratch(K, n_batch, S, nheads, dk, dtype);
  const BwdScratch sc(scratch, K, M, D, k2_bytes, sizeof(E));
  const E* q = static_cast<const E*>(qkv);
  E* g = static_cast<E*>(sc.g);
  k6::Args p{};
  p.K = K;
  p.M = M;
  p.D = D;
  p.kmd = kmd;
  p.dw = static_cast<float*>(dw);
  cudaError_t err = cudaSuccess;
  if constexpr (kF32) {
    k6::SplitJobs jobs{};
    const void* src[7] = {c, w[0], w[1], w[2], w[3], dout, y};
    bf16* dst[7] = {sc.c, sc.w, sc.w + 3 * (size_t)K * D * D,
                    sc.w + 6 * (size_t)K * D * D,
                    sc.w + 9 * (size_t)K * D * D, sc.dout, sc.y};
    for (int i = 0; i < 7; ++i) {
      jobs.src[i] = static_cast<const float*>(src[i]);
      jobs.dst[i] = dst[i];
      jobs.n[i] = i == 0 ? (size_t)M * D : i < 5 ? (size_t)K * D * D : kmd;
    }
    err = k6::split(jobs, 7, s);
    if (err != cudaSuccess) return (int)err;
    p.c = sc.c;
    for (int i = 0; i < 4; ++i) p.w[i] = dst[1 + i];
    p.dout = sc.dout;
    p.y = sc.y;
    for (int i = 0; i < 3; ++i) p.g[i] = sc.gp + 3 * i * kmd;
    p.c_plane = (size_t)M * D;
    p.w_plane = (size_t)K * D * D;
  } else {
    p.c = static_cast<const bf16*>(c);
    for (int i = 0; i < 4; ++i) p.w[i] = static_cast<const bf16*>(w[i]);
    p.dout = static_cast<const bf16*>(dout);
    p.y = static_cast<const bf16*>(y);
    for (int i = 0; i < 3; ++i) p.g[i] = reinterpret_cast<bf16*>(g) + i * kmd;
  }
  p.out[0] = sc.dy;
  err = k6::run<k6::Dy<E>>(p, s);
  if (err != cudaSuccess) return (int)err;
  const int st = cpc_relpos_attention_bwd_tc(
      q, q + kmd, q + 2 * kmd, krel, sc.dy, g, g + kmd, g + 2 * kmd, dkrel,
      sc.k2, K, n_batch, S, nheads, dk, seed, threshold, keep_scale, dtype,
      s);
  if (st != 0) return st;
  if constexpr (kF32) {
    k6::SplitJobs jobs{};
    for (int i = 0; i < 3; ++i) {
      jobs.src[i] = reinterpret_cast<const float*>(g) + i * kmd;
      jobs.dst[i] = sc.gp + 3 * i * kmd;
      jobs.n[i] = kmd;
    }
    err = k6::split(jobs, 3, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = k6::run<k6::DW<E>>(p, s);
  if (err != cudaSuccess) return (int)err;
  p.out[0] = dcp;
  return (int)k6::run<k6::Dcp<E>>(p, s);
}

}  // namespace

// Bytes of scratch cpc_attention_block_bwd needs: dy, dq, dk, dv in
// `dtype`, K2's backward scratch and, in float32, the bf16 planes of c,
// the weights, dout, y, dq, dk and dv.
extern "C" size_t cpc_attention_block_bwd_scratch(int K, int n_batch, int S,
                                                  int nheads, int dk,
                                                  int dtype) {
  const size_t k2 =
      cpc_relpos_attention_bwd_tc_scratch(K, n_batch, S, nheads, dk, dtype);
  return BwdScratch(nullptr, K, n_batch * S, nheads * dk, k2,
                    dtype == cpc::kFloat32 ? 4 : 2)
      .bytes;
}

// c (n_batch*S, D), wq, wk, wv, wo (K, D, D), krel (K, dk, S), dout and y
// (K, n_batch*S, D), qkv (3, K, n_batch*S, D) and dcp (K, n_batch*S, D)
// in `dtype` (y and qkv the forward's), 16-byte aligned; dkrel (K, dk, S)
// and dw (4, K, D, D: dWq, dWk, dWv, dWo) float32; scratch of
// cpc_attention_block_bwd_scratch bytes, 256-byte aligned.
extern "C" int cpc_attention_block_bwd(
    const void* c, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* krel, const void* dout, const void* qkv,
    const void* y, void* dkrel, void* dw, void* dcp, void* scratch, int K,
    int n_batch, int S, int nheads, int dk, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  if (!k6::takes(K, n_batch, S, nheads, dk) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* w[4] = {wq, wk, wv, wo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == cpc::kFloat32)
    return backward<float>(c, w, krel, dout, qkv, y, dkrel, dw, dcp, scratch,
                           K, n_batch, S, nheads, dk, seed, threshold,
                           keep_scale, dtype, s);
  if (dtype == cpc::kBFloat16)
    return backward<bf16>(c, w, krel, dout, qkv, y, dkrel, dw, dcp, scratch,
                          K, n_batch, S, nheads, dk, seed, threshold,
                          keep_scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}
