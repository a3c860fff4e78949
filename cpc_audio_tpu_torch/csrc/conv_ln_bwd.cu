// K7 backward: one fused encoder layer (strided conv -> bias ->
// ChannelNorm -> ReLU).
//
// Replaces cpc_audio_tpu/ops/pallas/conv_ln.py `_bwd_kernel` (called
// through `_fc_bwd`).  With the forward recomputed (conv_ln.cuh) and dy the
// cotangent of the output:
//   dyb = dy [pre > 0],  g = dyb nw
//   dh  = round((g - mean(g) - yn C/(C-1) mean(g yn)) / sqrt(var + eps))
//   db = sum dh,  dnw = sum dyb yn,  dnb = sum dyb       (over B and T)
//   dW = sum_t A[t]^T dh[t]
//   dx: padded row u s + i (i < s) receives dh[u] . W[i C : (i+1) C]^T +
//       dh[u-1] . W[(s+i) C : (s+i+1) C]^T
// the ddof = 1 chain of the Pallas kernel.
//
// Design: three passes and two fixed-order sums, no float atomics, so the
// result does not depend on the launch order:
//   1. rows: one block per (64 frames, batch row) recomputes h (the
//      forward's product), writes dh (B, out_t, C) in T and its tile's
//      part of (db, dnw, dnb);
//   2. dx: one block per (64 block rows u, offset i, batch row) gathers
//      [dh[u] | dh[u-1]] (64, 2C) . [W1_i ; W2_i]^T: each input row is
//      written once, whole, so the TPU kernel's cross-tile carry and its
//      scatter-add epilogue have no counterpart;
//   3. dw: one block per (64 rows of dW, split of the B out_t frames)
//      contracts A^T . dh over its frames into a float32 part;
// and the parts of dW and of the three vectors are summed in order.
//
// What bounds it on an H100: at the train shapes the three products are
// twice the forward's 49 GFLOP plus its recompute, ≈ 150 GFLOP (0.15 ms
// at the bf16 peak); dh and the dW parts add ≈ 80 MB of device memory
// traffic to the forward's.  The passes stage every chunk between
// barriers, as the forward does.
#include "conv_ln.cuh"

namespace {

using cpc::bf16;
namespace cv = cpc::conv;

// ---- 1. rows ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(cv::kThreads) conv_ln_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ nw,
    const float* __restrict__ nb, const T* __restrict__ dy,
    T* __restrict__ dh, float* __restrict__ vpart, int T_len, int C,
    int stride, int pad, int out_t, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cv::Smem<T> L = cv::frame_smem<T>(smem, C);
  const int t0 = blockIdx.x * cv::TM;
  const int b = blockIdx.y;
  cv::conv_tile(L, x + (size_t)b * T_len * C, w, T_len, C, stride, pad, out_t,
                t0);
  const int rows = min(cv::TM, out_t - t0);
  cv::norm_stats(L, bias, rows, C, eps);
  const T* dyb_g = dy + ((size_t)b * out_t + t0) * C;
  T* dhb = dh + ((size_t)b * out_t + t0) * C;

  // per row: m1 = mean(g), m2 = mean(g yn) C / (C - 1)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const float* h = L.cs + r * L.ldc;
    const float mean = L.stat[r];
    const float inv = L.stat[cv::TM + r];
    float s1 = 0.0f, s2 = 0.0f;
    for (int n = lane; n < C; n += 32) {
      const float yn = (h[n] - mean) * inv;
      const float g =
          yn * nw[n] + nb[n] > 0.0f ? cpc::to_f32(dyb_g[r * C + n]) * nw[n]
                                    : 0.0f;
      s1 += g;
      s2 += g * yn;
    }
    s1 = cpc::warp_sum(s1);
    s2 = cpc::warp_sum(s2);
    if (lane == 0) {
      L.stat[2 * cv::TM + r] = s1 / C;
      L.stat[3 * cv::TM + r] = s2 / C * (C / (C - 1.0f));
    }
  }
  __syncthreads();

  // per column: dh, and the tile's sums of dh, dyb yn and dyb
  for (int n = threadIdx.x; n < C; n += blockDim.x) {
    float db = 0.0f, dnw = 0.0f, dnb = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float inv = L.stat[cv::TM + r];
      const float yn = (L.cs[r * L.ldc + n] - L.stat[r]) * inv;
      const float dyb = yn * nw[n] + nb[n] > 0.0f
                            ? cpc::to_f32(dyb_g[r * C + n])
                            : 0.0f;
      const float g = dyb * nw[n];
      const float d = cpc::round_to<T>(
          (g - L.stat[2 * cv::TM + r] - yn * L.stat[3 * cv::TM + r]) * inv);
      dhb[(size_t)r * C + n] = cpc::from_f32<T>(d);
      db += d;
      dnw += dyb * yn;
      dnb += dyb;
    }
    float* p = vpart + ((size_t)b * gridDim.x + blockIdx.x) * 3 * C;
    p[n] = db;
    p[C + n] = dnw;
    p[2 * C + n] = dnb;
  }
}

// ---- 2. dx -----------------------------------------------------------------

template <typename T>
__host__ __device__ cv::Smem<T> dx_smem(void* base, int C) {
  // a: [dh[u] | dh[u-1]] chunk (TM, KC); b: the weights' rows (C, KC)
  return cv::Smem<T>(base, cv::KC, C, cv::KC, C);
}

template <typename T>
__global__ void __launch_bounds__(cv::kThreads) conv_ln_bwd_dx_kernel(
    const T* __restrict__ dh, const T* __restrict__ w, T* __restrict__ dx,
    int T_len, int C, int stride, int pad, int out_t, int n_u) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cv::Smem<T> L = dx_smem<T>(smem, C);
  const int u0 = blockIdx.x * cv::TM;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const T* dhb = dh + (size_t)b * out_t * C;
  constexpr int V = 16 / sizeof(T);
  cv::TileAcc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < 2 * C; k0 += cv::KC) {
    const int half = k0 / C;          // 0: dh[u] (tap i), 1: dh[u-1] (s + i)
    const int ch0 = k0 - half * C;
    __syncthreads();
    for (int idx = threadIdx.x; idx < cv::TM * (cv::KC / V);
         idx += blockDim.x) {
      const int r = idx / (cv::KC / V);
      const int j = (idx - r * (cv::KC / V)) * V;
      const int t = u0 + r - half;
      if (t >= 0 && t < out_t && u0 + r < n_u)
        cpc::copy16(L.a + r * L.lda + j, dhb + (size_t)t * C + ch0 + j);
      else
        cpc::zero16(L.a + r * L.lda + j);
    }
    cpc::stage(L.b, L.ldb, w + (size_t)(half * stride + i) * C * C + ch0, C,
               C, cv::KC, C);
    __syncthreads();
    acc.template mma<false, true>(L.a, L.lda, L.b, L.ldb, cv::TM, C,
                                  cv::KC);
  }
  acc.store(L.cs, L.ldc, cv::TM, C);
  __syncthreads();
  for (int idx = threadIdx.x; idx < cv::TM * C; idx += blockDim.x) {
    const int r = idx / C;
    const int n = idx - r * C;
    const int row = (u0 + r) * stride + i - pad;
    if (u0 + r < n_u && row >= 0 && row < T_len)
      dx[((size_t)b * T_len + row) * C + n] =
          cpc::from_f32<T>(L.cs[r * L.ldc + n]);
  }
}

// ---- 3. dw -----------------------------------------------------------------

template <typename T>
__host__ __device__ cv::Smem<T> dw_smem(void* base, int C) {
  // a: A^T chunk (KC frames, 64 window columns); b: dh chunk (KC, C)
  return cv::Smem<T>(base, cv::TM, cv::KC, C, C);
}

// part[split][j0 + r][n] = sum over the split's frames g of A[g][j0 + r]
// dh[g][n]; frames g = b out_t + t run over all batch rows.
template <typename T>
__global__ void __launch_bounds__(cv::kThreads) conv_ln_bwd_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ dh,
    float* __restrict__ wpart, int B, int T_len, int C, int stride, int pad,
    int out_t, int chunks_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cv::Smem<T> L = dw_smem<T>(smem, C);
  const int j0 = blockIdx.x * cv::TM;
  const int tap = j0 / C;
  const int ch0 = j0 - tap * C;
  const int G = B * out_t;
  const int g_begin = blockIdx.y * chunks_per_split * cv::KC;
  const int g_end = min(G, g_begin + chunks_per_split * cv::KC);
  constexpr int V = 16 / sizeof(T);
  cv::TileAcc<T> acc;
  acc.zero();
  for (int g0 = g_begin; g0 < g_end; g0 += cv::KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < cv::KC * (cv::TM / V);
         idx += blockDim.x) {
      const int r = idx / (cv::TM / V);              // frame g0 + r
      const int jj = (idx - r * (cv::TM / V)) * V;   // window column j0 + jj
      const int g = g0 + r;
      const int bb = g / out_t;
      const int row = (g - bb * out_t) * stride + tap - pad;
      if (g < g_end && row >= 0 && row < T_len)
        cpc::copy16(L.a + r * L.lda + jj,
                    x + ((size_t)bb * T_len + row) * C + ch0 + jj);
      else
        cpc::zero16(L.a + r * L.lda + jj);
    }
    cpc::stage(L.b, L.ldb, dh + (size_t)g0 * C, C, cv::KC, C, g_end - g0);
    __syncthreads();
    acc.template mma<true, false>(L.a, L.lda, L.b, L.ldb, cv::TM, C,
                                  cv::KC);
  }
  acc.store(L.cs, L.ldc, cv::TM, C);
  __syncthreads();
  float* out = wpart + ((size_t)blockIdx.y * 2 * stride * C + j0) * C;
  for (int idx = threadIdx.x; idx < cv::TM * C; idx += blockDim.x) {
    const int r = idx / C;
    out[idx] = L.cs[r * L.ldc + idx - r * C];
  }
}

template <typename T>
size_t smem_bytes(int C) {
  size_t s = cv::frame_smem<T>(nullptr, C).bytes;
  const size_t a = dx_smem<T>(nullptr, C).bytes;
  const size_t b = dw_smem<T>(nullptr, C).bytes;
  s = s > a ? s : a;
  return s > b ? s : b;
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const float* nw,
           const float* nb, const void* dy, void* dx, void* dh, float* vpart,
           float* vout, float* wpart, float* dw, int B, int T_len, int C,
           int stride, int pad, int n_split, float eps, cudaStream_t stream) {
  const int out_t = cv::out_frames(T_len, stride, pad);
  const T* x_ = static_cast<const T*>(x);
  const T* w_ = static_cast<const T*>(w);
  T* dh_ = static_cast<T*>(dh);

  const int n_t = (out_t + cv::TM - 1) / cv::TM;
  const size_t rows_smem = cv::frame_smem<T>(nullptr, C).bytes;
  auto rows = conv_ln_bwd_rows_kernel<T>;
  cudaError_t err = cpc::allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return (int)err;
  rows<<<dim3(n_t, B), cv::kThreads, rows_smem, stream>>>(
      x_, w_, bias, nw, nb, static_cast<const T*>(dy), dh_, vpart, T_len, C,
      stride, pad, out_t, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cpc::sum_parts(vpart, vout, B * n_t, 3 * C, 1, stream);
  if (err != cudaSuccess) return (int)err;

  const int n_u = (T_len - 1 + pad) / stride + 1;
  const size_t dx_bytes = dx_smem<T>(nullptr, C).bytes;
  auto dxk = conv_ln_bwd_dx_kernel<T>;
  err = cpc::allow_smem(dxk, dx_bytes);
  if (err != cudaSuccess) return (int)err;
  dxk<<<dim3((n_u + cv::TM - 1) / cv::TM, stride, B), cv::kThreads, dx_bytes,
        stream>>>(dh_, w_, static_cast<T*>(dx), T_len, C, stride, pad, out_t,
                  n_u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunks = (B * out_t + cv::KC - 1) / cv::KC;
  const int per_split = (chunks + n_split - 1) / n_split;
  const size_t dw_bytes = dw_smem<T>(nullptr, C).bytes;
  auto dwk = conv_ln_bwd_dw_kernel<T>;
  err = cpc::allow_smem(dwk, dw_bytes);
  if (err != cudaSuccess) return (int)err;
  dwk<<<dim3(2 * stride * C / cv::TM, n_split), cv::kThreads, dw_bytes,
        stream>>>(x_, dh_, wpart, B, T_len, C, stride, pad, out_t, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cpc::sum_parts(wpart, dw, n_split, 2 * stride * C * C, 1,
                              stream);
}

}  // namespace

// Shared memory the largest of the backward's blocks needs; the wrapper
// refuses shapes above the card's 227 KB.
extern "C" size_t cpc_conv_ln_bwd_smem(int C, int dtype) {
  return dtype == cpc::kBFloat16 ? smem_bytes<bf16>(C) : smem_bytes<float>(C);
}

// x (B, T, C), w (2 stride C, C), dy (B, out_t, C), dx (B, T, C) and the
// scratch dh (B, out_t, C) in `dtype`, 16-byte aligned; float32: bias, nw,
// nb (C,), vpart (B ceil(out_t / 64), 3, C) scratch, vout (3, C) = (db,
// dnw, dnb), wpart (n_split, 2 stride C, C) scratch, dw (2 stride C, C).
// C % 64 == 0, C <= 256.
extern "C" int cpc_conv_ln_bwd(const void* x, const void* w, const void* bias,
                               const void* nw, const void* nb, const void* dy,
                               void* dx, void* dh, void* vpart, void* vout,
                               void* wpart, void* dw, int B, int T, int C,
                               int stride, int pad, int n_split, float eps,
                               int dtype, void* stream) {
  if (C % cv::KC != 0 || C > cv::kMaxC || stride < 1 || pad < 0 ||
      n_split < 1 || cv::out_frames(T, stride, pad) < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* w1 = static_cast<const float*>(nw);
  const float* b1 = static_cast<const float*>(nb);
  float* vp = static_cast<float*>(vpart);
  float* vo = static_cast<float*>(vout);
  float* wp = static_cast<float*>(wpart);
  float* wd = static_cast<float*>(dw);
  if (dtype == cpc::kBFloat16)
    return launch<bf16>(x, w, b, w1, b1, dy, dx, dh, vp, vo, wp, wd, B, T, C,
                        stride, pad, n_split, eps, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(x, w, b, w1, b1, dy, dx, dh, vp, vo, wp, wd, B, T, C,
                         stride, pad, n_split, eps, s);
  return (int)cudaErrorInvalidValue;
}
