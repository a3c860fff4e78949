// K7: one fused encoder layer, forward: strided conv -> bias ->
// ChannelNorm -> ReLU.
//
// Replaces cpc_audio_tpu/ops/pallas/conv_ln.py `_fwd_kernel` (called
// through `fused_conv_ln_relu`).  For x (B, T, C), w (2 s C, C), kernel
// = 2 s, frame t:
//   h[t]   = A[t] . w + bias                 (float32 accumulation)
//   yn[t]  = (h[t] - mean) / sqrt(var + eps) (var over the C channels,
//                                             ddof = 1)
//   out[t] = round(relu(yn[t] nw + nb))
// with A[t] frame t's window of x (csrc/conv_ln.cuh).  yn (float32) and
// 1 / sqrt(var + eps) are kept for the backward, where the Pallas kernel
// recomputes the conv.
//
// Design (csrc/conv_ln.cuh): one launch of the Fwd GEMM on
// csrc/gemm_tc.cuh, x read in place through the conv's window (the
// padding a range check, so the input needs no padded copy and the TPU's
// halo blocks have no counterpart), a 128-frame row tile by every channel
// so that the norm, the affine and the ReLU run in the epilogue on the
// float32 sums before one store.  In float32, x and w are first split into
// three bf16 planes each and the conv takes 6 split products.
//
// What bounds it on an H100: at the train shapes (B = 32, C = 256, layers
// 1-4 of 1024/512/256/128 frames) the four calls are 34 + 8.6 + 4.3 + 2.1
// = 49 GFLOP (0.05 ms at the bf16 peak; 6 times that in float32's split
// products) on 67 + 34 + 17 + 8 MB of x read and 2 x (17 + 8 + 4 + 2) MB
// of out and yn written in bf16: the tensor cores, at B 32.
#include "conv_ln.cuh"

namespace {

namespace cl = cpc::conv_ln;
using cl::bf16;

// The scratch: in float32, the bf16 planes of x and w.
struct FwdScratch {
  bf16 *x = nullptr, *w = nullptr;
  size_t bytes;
  FwdScratch(void* base, const cl::Geom& g, int elt) {
    cpc::Carve cv(base);
    if (elt == 4) {
      constexpr int NP = cl::Prec<float>::kPlanesFwd;
      x = cv.take<bf16>((size_t)NP * g.B * g.T * g.C);
      w = cv.take<bf16>((size_t)NP * 2 * g.s * g.C * g.C);
    }
    bytes = cv.bytes();
  }
};

template <class E>
int forward(const void* x, const void* w, const float* bias, const float* nw,
            const float* nb, void* out, float* yn, float* inv,
            void* scratch, const cl::Geom& g, float eps,
            cudaStream_t stream) {
  cl::Args p{};
  p.g = g;
  p.bias = bias;
  p.nw = nw;
  p.nb = nb;
  p.out = out;
  p.yn = yn;
  p.inv = inv;
  p.eps = eps;
  const size_t nx = (size_t)g.B * g.T * g.C, nw_ = (size_t)2 * g.s * g.C * g.C;
  if constexpr (cl::Prec<E>::kF32) {
    constexpr int NP = cl::Prec<E>::kPlanesFwd;
    const FwdScratch sc(scratch, g, 4);
    cl::SplitJobs jobs{{static_cast<const float*>(x),
                        static_cast<const float*>(w)},
                       {sc.x, sc.w},
                       {nx, nw_}};
    const cudaError_t err = cl::split<NP>(jobs, 2, stream);
    if (err != cudaSuccess) return (int)err;
    p.x = sc.x;
    p.w = sc.w;
    p.x_plane = nx;
    p.w_plane = nw_;
  } else {
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
  }
  return (int)cl::run_fwd<E>(p, stream);
}

}  // namespace

// Bytes of scratch cpc_conv_ln_fwd needs: in float32, the bf16 planes of x
// and w; none in bf16.
extern "C" size_t cpc_conv_ln_fwd_scratch(int B, int T, int C, int stride,
                                          int pad, int dtype) {
  if (!cl::takes(B, T, C, stride, pad)) return 0;
  return FwdScratch(nullptr, cl::geom(B, T, C, stride, pad),
                    dtype == cpc::kFloat32 ? 4 : 2)
      .bytes;
}

// x (B, T, C), w (2 stride C, C) and out (B, out_t, C) in `dtype`,
// 16-byte aligned; bias, nw, nb (C,) float32; yn (B, out_t, C) and inv
// (B, out_t) float32, written for the backward; scratch of
// cpc_conv_ln_fwd_scratch bytes, 256-byte aligned.  C % 64 == 0, C <= 256,
// out_t >= 1.
extern "C" int cpc_conv_ln_fwd(const void* x, const void* w, const void* bias,
                               const void* nw, const void* nb, void* out,
                               void* yn, void* inv, void* scratch, int B,
                               int T, int C, int stride, int pad, float eps,
                               int dtype, void* stream) {
  if (!cl::takes(B, T, C, stride, pad)) return (int)cudaErrorInvalidValue;
  const cl::Geom g = cl::geom(B, T, C, stride, pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* w1 = static_cast<const float*>(nw);
  const float* b1 = static_cast<const float*>(nb);
  float* y = static_cast<float*>(yn);
  float* iv = static_cast<float*>(inv);
  if (dtype == cpc::kFloat32) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return forward<float>(x, w, b, w1, b1, out, y, iv, scratch, g, eps, s);
  }
  if (dtype == cpc::kBFloat16)
    return forward<bf16>(x, w, b, w1, b1, out, y, iv, scratch, g, eps, s);
  return (int)cudaErrorInvalidValue;
}
