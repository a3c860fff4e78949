// K7 backward: one fused encoder layer (strided conv -> bias ->
// ChannelNorm -> ReLU).
//
// Replaces cpc_audio_tpu/ops/pallas/conv_ln.py `_bwd_kernel` (called
// through `_fc_bwd`).  From the forward's yn and 1 / std (the Pallas
// kernel recomputes them; here the forward keeps them, ops/conv_ln.py)
// and dy, the cotangent of the output:
//   dyb = dy [yn nw + nb > 0],  g = dyb nw
//   dh  = round((g - mean(g) - yn C/(C-1) mean(g yn)) / sqrt(var + eps))
//   db = sum dh,  dnw = sum dyb yn,  dnb = sum dyb       (over B and T)
//   dW = sum_t A[t]^T dh[t]
//   dx: padded row u s + i (i < s) receives dh[u] . W[i C : (i+1) C]^T +
//       dh[u-1] . W[(s+i) C : (s+i+1) C]^T
// the ddof = 1 chain of the Pallas kernel.
//
// Design (csrc/conv_ln.cuh), four launches and two fixed-order sums, no
// float atomics, so the result does not depend on the launch order:
//   1. rows: dh (B out_t, C), or in float32 its two bf16 planes, and a
//      part of (db, dnw, dnb) a block, summed in order (cpc::sum_parts);
//   2. Dx, one GEMM launch: the padded input's block rows [dh[u] |
//      dh[u-1]] . [W_top ; W_bottom]^T, each written once, whole, where
//      it is a real row of x, so the TPU kernel's cross-tile carry and its
//      scatter-add epilogue have no counterpart;
//   3. DW, one GEMM launch: A^T . dh, A read k-major through the conv's
//      window, the frames split into contiguous ranges, each range's
//      float32 part summed in order (cpc::sum_parts).
// In float32, x and w are first split into two bf16 planes each, and Dx
// and DW take 3 split products.
//
// What bounds it on an H100: at the train shapes the two products are
// twice the forward's 49 GFLOP (0.1 ms at the bf16 peak); yn and dy read,
// dh, dx and the dW parts written come to ≈ 0.3 GB in bf16 (0.09 ms).
#include "conv_ln.cuh"

namespace {

namespace cl = cpc::conv_ln;
using cl::bf16;

// The scratch: dh (or its planes), the rows' and dW's parts, and in
// float32 the bf16 planes of x and w.
struct BwdScratch {
  bf16 *dh, *x = nullptr, *w = nullptr;
  float *vpart, *wpart = nullptr;
  size_t bytes;
  BwdScratch(void* base, const cl::Geom& g, int elt) {
    constexpr int NP = cl::Prec<float>::kPlanesBwd;
    const int planes = elt == 4 ? NP : 1;
    const size_t M = (size_t)g.B * g.out_t;
    cpc::Carve cv(base);
    dh = cv.take<bf16>(planes * M * g.C);
    vpart = cv.take<float>((size_t)n_vparts(g) * 3 * g.C);
    if (g.splits > 1) wpart = cv.take<float>((size_t)g.splits * 2 * g.s *
                                             g.C * g.C);
    if (elt == 4) {
      x = cv.take<bf16>((size_t)NP * g.B * g.T * g.C);
      w = cv.take<bf16>((size_t)NP * 2 * g.s * g.C * g.C);
    }
    bytes = cv.bytes();
  }
  static int n_vparts(const cl::Geom& g) {
    return (g.B * g.out_t + cl::kRowsBlock - 1) / cl::kRowsBlock;
  }
};

template <class E>
int backward(const void* x, const void* w, const float* nw, const float* nb,
             const void* dy, const float* yn, const float* inv, void* dx,
             float* vout, float* dw, void* scratch, const cl::Geom& g,
             cudaStream_t stream) {
  constexpr int NP = cl::Prec<E>::kPlanesBwd;
  const BwdScratch sc(scratch, g, sizeof(E));
  const int M = g.B * g.out_t, C = g.C;
  cl::Args p{};
  p.g = g;
  p.dh = sc.dh;
  p.dh_plane = (size_t)M * C;
  p.out = dx;
  p.dw = g.splits > 1 ? sc.wpart : dw;
  cudaError_t err;
  const size_t nx = (size_t)g.B * g.T * C, nw_ = (size_t)2 * g.s * C * C;
  if constexpr (cl::Prec<E>::kF32) {
    cl::SplitJobs jobs{{static_cast<const float*>(x),
                        static_cast<const float*>(w)},
                       {sc.x, sc.w},
                       {nx, nw_}};
    err = cl::split<NP>(jobs, 2, stream);
    if (err != cudaSuccess) return (int)err;
    p.x = sc.x;
    p.w = sc.w;
    p.x_plane = nx;
    p.w_plane = nw_;
  } else {
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
  }
  err = cl::run_rows<E, NP>(yn, inv, static_cast<const E*>(dy), nw, nb,
                            sc.dh, p.dh_plane, sc.vpart, M, C, stream);
  if (err != cudaSuccess) return (int)err;
  err = cpc::sum_parts(sc.vpart, vout, BwdScratch::n_vparts(g), 3 * C, 1,
                       stream);
  if (err != cudaSuccess) return (int)err;
  err = cl::run_dx<E>(p, stream);
  if (err != cudaSuccess) return (int)err;
  err = cl::run_dw<E>(p, stream);
  if (err != cudaSuccess || g.splits == 1) return (int)err;
  return (int)cpc::sum_parts(sc.wpart, dw, g.splits, 2 * g.s * C * C, 1,
                             stream);
}

}  // namespace

// Bytes of scratch cpc_conv_ln_bwd needs: dh in `dtype`'s planes (one
// bf16 plane in bf16, two in float32), the rows' parts of (db, dnw, dnb)
// and dW's float32 parts, and in float32 the bf16 planes of x and w.
extern "C" size_t cpc_conv_ln_bwd_scratch(int B, int T, int C, int stride,
                                          int pad, int dtype) {
  if (!cl::takes(B, T, C, stride, pad)) return 0;
  return BwdScratch(nullptr, cl::geom(B, T, C, stride, pad),
                    dtype == cpc::kFloat32 ? 4 : 2)
      .bytes;
}

// x (B, T, C), w (2 stride C, C), dy (B, out_t, C) and dx (B, T, C) in
// `dtype`, 16-byte aligned; float32: nw, nb (C,), yn (B, out_t, C) and
// inv (B, out_t) from cpc_conv_ln_fwd at the same inputs, vout (3, C) =
// (db, dnw, dnb), dw (2 stride C, C); scratch of cpc_conv_ln_bwd_scratch
// bytes, 256-byte aligned.  C % 64 == 0, C <= 256, out_t >= 1.
extern "C" int cpc_conv_ln_bwd(const void* x, const void* w, const void* nw,
                               const void* nb, const void* dy, const void* yn,
                               const void* inv, void* dx, void* vout,
                               void* dw, void* scratch, int B, int T, int C,
                               int stride, int pad, int dtype, void* stream) {
  if (!cl::takes(B, T, C, stride, pad) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cl::Geom g = cl::geom(B, T, C, stride, pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w1 = static_cast<const float*>(nw);
  const float* b1 = static_cast<const float*>(nb);
  const float* y = static_cast<const float*>(yn);
  const float* iv = static_cast<const float*>(inv);
  float* vo = static_cast<float*>(vout);
  float* wd = static_cast<float*>(dw);
  if (dtype == cpc::kFloat32)
    return backward<float>(x, w, w1, b1, dy, y, iv, dx, vo, wd, scratch, g,
                           s);
  if (dtype == cpc::kBFloat16)
    return backward<bf16>(x, w, w1, b1, dy, y, iv, dx, vo, wd, scratch, g,
                          s);
  return (int)cudaErrorInvalidValue;
}
