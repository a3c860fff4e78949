// K4 backward: reverse scan of the whole-window GRU.
//
// Replaces cpc_audio_tpu/ops/pallas/rnn.py `_gru_bwd_kernel` (called
// through `_gru_bwd`).  From the forward's saved gates r, z, n and gh_n
// (float32), with h_prev[t] = (t > 0 ? ys[t - 1] : h0), per batch row b and
// t = T-1 .. 0:
//   dh   = dys[t] + dh_carry
//   dz   = dh * (h_prev - n) * z (1 - z),   dn = dh * (1 - z) * (1 - n^2)
//   dghn = dn * r,                          dr = dn * gh_n * r (1 - r)
//   dx[b, t] = (dr, dz, dn);   dghn[b, t] = dghn
//   dh_carry = dh * z + (dr, dz, dghn) . W_hh
// and finally dh0 = dh_carry, all in float32.  The Pallas kernel also
// writes dgh = (dr, dz, dghn); two thirds of it repeat dx, so this kernel
// writes only its last third, and dW_hh = dgh^T h_prev and db_hh = sum dgh
// are formed outside it from dx and dghn (ops/gru.py), as rnn.py:383-385
// does.  h_prev is read from ys and h0 in place, so the wrapper builds no
// (B, T, H) copy of it.
//
// Design: K1's backward (csrc/lstm_bwd.cu).  One block per batch row keeps
// the carry in shared memory for the whole window.  The serial product is
// dh[j] = sum_r dgh[r] W_hh[r, j] over the 3H rows of W_hh in torch's
// (3H, H) layout, which needs no transpose: threads own pairs of adjacent
// columns (one 4- or 8-byte load per row, a warp reads a contiguous run of
// a row) and form groups that split the 3H rows; the partial sums meet in
// shared memory.
//
// What bounds it on an H100: like the forward, the T steps are serial and
// every step re-reads W_hh (384 KB in bf16 at H = 256) from L2; B = 32
// blocks use a quarter of the SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ ghn,
    const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ dys, const T* __restrict__ w_hh,
    const float* __restrict__ dhT, float* __restrict__ dx,
    float* __restrict__ dghn_out, float* __restrict__ dh0, int n_steps,
    int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  const int n_pairs = H / 2;
  const int n_groups = blockDim.x / n_pairs;
  float* dg = smem;                 // (3H,) dgh of this step
  float* dh = dg + G;               // (H,)  dh carry
  float* dhz = dh + H;              // (H,)  dh * z of this step
  float* part = dhz + H;            // (n_groups, H) partial column sums
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int pair = tid % n_pairs;
  const int group = tid / n_pairs;

  for (int j = tid; j < H; j += blockDim.x) dh[j] = dhT[(size_t)b * H + j];
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * n_steps + t;
    const float* gt = gates + bt * G;
    float* dxt = dx + bt * G;
    for (int j = tid; j < H; j += blockDim.x) {
      const float r = gt[j], z = gt[H + j], n = gt[2 * H + j];
      const float gn = ghn[bt * H + j];
      const float hp = t > 0 ? cpc::to_f32(ys[(bt - 1) * H + j])
                             : cpc::to_f32(h0[(size_t)b * H + j]);
      const float dhj = cpc::to_f32(dys[bt * H + j]) + dh[j];
      const float d_z = dhj * (hp - n) * z * (1.0f - z);
      const float d_n = dhj * (1.0f - z) * (1.0f - n * n);
      const float d_ghn = d_n * r;
      const float d_r = d_n * gn * r * (1.0f - r);
      dxt[j] = d_r;
      dxt[H + j] = d_z;
      dxt[2 * H + j] = d_n;
      dghn_out[bt * H + j] = d_ghn;
      dg[j] = d_r;
      dg[H + j] = d_z;
      dg[2 * H + j] = d_ghn;
      dhz[j] = dhj * z;
    }
    __syncthreads();
    if (group < n_groups) {
      float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      const T* wcol = w_hh + 2 * pair;
      int r = group;
#pragma unroll 4
      for (; r + n_groups < G; r += 2 * n_groups) {
        const float2 w = load2(wcol + (size_t)r * H);
        const float2 v = load2(wcol + (size_t)(r + n_groups) * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
        b0 += dg[r + n_groups] * v.x;
        b1 += dg[r + n_groups] * v.y;
      }
      if (r < G) {
        const float2 w = load2(wcol + (size_t)r * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
      }
      part[group * H + 2 * pair] = a0 + b0;
      part[group * H + 2 * pair + 1] = a1 + b1;
    }
    __syncthreads();
    for (int j = tid; j < H; j += blockDim.x) {
      float s = dhz[j];
      for (int g = 0; g < n_groups; ++g) s += part[g * H + j];
      dh[j] = s;
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += blockDim.x) dh0[(size_t)b * H + j] = dh[j];
}

template <typename T>
int launch(const float* gates, const float* ghn, const void* h0,
           const void* ys, const void* dys, const void* w_hh,
           const float* dhT, float* dx, float* dghn, float* dh0, int B,
           int n_steps, int H, cudaStream_t stream) {
  const int n_groups = kThreads / (H / 2);
  const size_t smem = (size_t)(5 + n_groups) * H * sizeof(float);
  auto kernel = gru_bwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(
      gates, ghn, static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(dys), static_cast<const T*>(w_hh), dhT, dx, dghn,
      dh0, n_steps, H);
  return (int)cudaGetLastError();
}

}  // namespace

// gates (B, T, 3H), ghn (B, T, H), dhT (B, H) and the outputs dx
// (B, T, 3H), dghn (B, T, H) and dh0 (B, H) are float32; h0 (B, H), ys
// and dys (B, T, H) and w_hh (3H, H) are in `dtype`.
extern "C" int cpc_gru_bwd(const void* gates, const void* ghn, const void* h0,
                           const void* ys, const void* dys, const void* w_hh,
                           const void* dhT, void* dx, void* dghn, void* dh0,
                           int B, int n_steps, int H, int dtype,
                           void* stream) {
  if (H <= 0 || H % 32 != 0 || H / 2 > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* n = static_cast<const float*>(ghn);
  const float* d = static_cast<const float*>(dhT);
  float* o_dx = static_cast<float*>(dx);
  float* o_dghn = static_cast<float*>(dghn);
  float* o_dh0 = static_cast<float*>(dh0);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(g, n, h0, ys, dys, w_hh, d, o_dx, o_dghn,
                                 o_dh0, B, n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(g, n, h0, ys, dys, w_hh, d, o_dx, o_dghn, o_dh0, B,
                         n_steps, H, s);
  return (int)cudaErrorInvalidValue;
}
