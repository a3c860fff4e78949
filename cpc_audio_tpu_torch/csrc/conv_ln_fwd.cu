// K7: one fused encoder layer, forward: strided conv -> bias ->
// ChannelNorm -> ReLU.
//
// Replaces cpc_audio_tpu/ops/pallas/conv_ln.py `_fwd_kernel` (called
// through `fused_conv_ln_relu`).  For x (B, T, C), w (2 s C, C), kernel
// = 2 s, frame t:
//   h[t]   = A[t] . w + bias                 (float32 accumulation)
//   out[t] = round(relu((h[t] - mean) / sqrt(var + eps) * nw + nb))
// with the unbiased variance over the C channels (conv_ln.cuh).
//
// Design: one block of 16 warps per (64 frames, batch row).  The conv is
// one product over the 2 s C window, in 64-wide chunks: each chunk of
// x's rows and of w is staged in shared memory and multiplied on the
// tensor cores (bf16; FMA in float32, tile_mm.cuh) into a (64, C) float32
// tile, on which the norm and the ReLU run before a single store.  The
// padding is applied by index, so the input needs no padded copy and the
// TPU's halo blocks and carries have no counterpart: a frame's window is a
// strided view of x.
//
// What bounds it on an H100: at the train shapes (B = 32, C = 256, layers
// 1-4 of 1024/512/256/128 frames) the four calls are 34 + 8.6 + 4.3 + 2.1
// = 49 GFLOP (0.05 ms at the bf16 peak) on 67 + 34 + 17 + 8 MB read and
// 17 + 8 + 4 + 2 MB written (0.04 ms); this first version stages every
// chunk with a barrier between loads and products, so latency, not a
// roofline, sets its time.
#include "conv_ln.cuh"

namespace {

using cpc::bf16;
namespace cv = cpc::conv;

template <typename T>
__global__ void __launch_bounds__(cv::kThreads) conv_ln_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ nw,
    const float* __restrict__ nb, T* __restrict__ out, int T_len, int C,
    int stride, int pad, int out_t, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cv::Smem<T> L = cv::frame_smem<T>(smem, C);
  const int t0 = blockIdx.x * cv::TM;
  const int b = blockIdx.y;
  cv::conv_tile(L, x + (size_t)b * T_len * C, w, T_len, C, stride, pad, out_t,
                t0);
  const int rows = min(cv::TM, out_t - t0);
  cv::norm_stats(L, bias, rows, C, eps);
  T* ob = out + ((size_t)b * out_t + t0) * C;
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int r = idx / C;
    const int n = idx - r * C;
    const float yn = (L.cs[r * L.ldc + n] - L.stat[r]) * L.stat[cv::TM + r];
    ob[idx] = cpc::from_f32<T>(fmaxf(yn * nw[n] + nb[n], 0.0f));
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const float* nw,
           const float* nb, void* out, int B, int T_len, int C, int stride,
           int pad, float eps, cudaStream_t stream) {
  const int out_t = cv::out_frames(T_len, stride, pad);
  const size_t smem = cv::frame_smem<T>(nullptr, C).bytes;
  auto kernel = conv_ln_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((out_t + cv::TM - 1) / cv::TM, B);
  kernel<<<grid, cv::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, nw, nb,
      static_cast<T*>(out), T_len, C, stride, pad, out_t, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs; the wrapper refuses shapes above the
// card's 227 KB.
extern "C" size_t cpc_conv_ln_fwd_smem(int C, int dtype) {
  return dtype == cpc::kBFloat16 ? cv::frame_smem<bf16>(nullptr, C).bytes
                                 : cv::frame_smem<float>(nullptr, C).bytes;
}

// x (B, T, C) and w (2 stride C, C) in `dtype`, 16-byte aligned; bias, nw,
// nb (C,) float32; out (B, out_t, C) in `dtype`.  C % 64 == 0, C <= 256,
// out_t >= 1.
extern "C" int cpc_conv_ln_fwd(const void* x, const void* w, const void* bias,
                               const void* nw, const void* nb, void* out,
                               int B, int T, int C, int stride, int pad,
                               float eps, int dtype, void* stream) {
  if (C % cv::KC != 0 || C > cv::kMaxC || stride < 1 || pad < 0 ||
      cv::out_frames(T, stride, pad) < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* w1 = static_cast<const float*>(nw);
  const float* b1 = static_cast<const float*>(nb);
  if (dtype == cpc::kBFloat16)
    return launch<bf16>(x, w, b, w1, b1, out, B, T, C, stride, pad, eps, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(x, w, b, w1, b1, out, B, T, C, stride, pad, eps, s);
  return (int)cudaErrorInvalidValue;
}
