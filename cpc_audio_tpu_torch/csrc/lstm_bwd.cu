// K1 backward: reverse scan of the whole-window LSTM.
//
// Replaces cpc_audio_tpu/ops/pallas/rnn.py `_lstm_bwd_kernel` (called
// through `_lstm_bwd`).  From the forward's saved gate activations
// i, f, g, o and cell states (float32), per batch row b and t = T-1 .. 0:
//   c_t  = f * c_{t-1} + i * g,          dh = dys[t] + dh_carry
//   do   = dh * tanh(c_t) * o (1 - o),   dc = dc_carry + dh * o (1 - tanh^2 c_t)
//   di   = dc * g * i (1 - i),  df = dc * c_{t-1} * f (1 - f),  dg = dc * i (1 - g^2)
//   dgates[b, t] = (di, df, dg, do);  dh_carry = dgates . W_hh;  dc_carry = dc * f
// and finally dh0 = dh_carry, dc0 = dc_carry, all in float32.  dW_hh is
// one matmul outside the kernel (ops/lstm.py), as rnn.py:223-226 does.
//
// Design: as in the forward, one block per batch row keeps the carries in
// shared memory for the whole window.  The serial product is the
// transpose of the forward's: dh[j] = sum_r dgates[r] W_hh[r, j] over the
// 4H gate rows of W_hh in torch's (4H, H) layout.  Threads own pairs of
// adjacent columns (one 4- or 8-byte load per row, a warp reads a
// contiguous run of a row) and form G groups that split the 4H rows; the
// G partial sums meet in shared memory.
//
// What bounds it on an H100: like the forward, the T steps are serial
// and every step re-reads W_hh (512 KB in bf16 at H = 256) from L2, so a
// step costs one SM's L2 read bandwidth for 512 KB; B = 32 blocks use a
// quarter of the SMs.  Keeping W_hh on chip across a cluster (DSMEM) is
// the planned next step for both directions.
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
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const T* __restrict__ c0, const T* __restrict__ dys,
    const T* __restrict__ w_hh, const float* __restrict__ dhT,
    const float* __restrict__ dcT, float* __restrict__ dgates,
    float* __restrict__ dh0, float* __restrict__ dc0, int n_steps, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G4 = 4 * H;
  const int n_pairs = H / 2;
  const int n_groups = blockDim.x / n_pairs;
  float* dg = smem;                 // (4H,) dgates of this step
  float* dh = dg + G4;              // (H,)  dh carry
  float* dc = dh + H;               // (H,)  dc carry
  float* part = dc + H;             // (n_groups, H) partial column sums
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int pair = tid % n_pairs;
  const int group = tid / n_pairs;

  for (int j = tid; j < H; j += blockDim.x) {
    dh[j] = dhT[(size_t)b * H + j];
    dc[j] = dcT[(size_t)b * H + j];
  }
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * n_steps + t;
    const float* gt = gates + bt * G4;
    float* dgt = dgates + bt * G4;
    for (int j = tid; j < H; j += blockDim.x) {
      const float ig = gt[j], fg = gt[H + j], gg = gt[2 * H + j],
                  og = gt[3 * H + j];
      const float c_prev =
          t > 0 ? cs[(bt - 1) * H + j] : cpc::to_f32(c0[(size_t)b * H + j]);
      const float c = fg * c_prev + ig * gg;
      const float tc = tanhf(c);
      const float dhj = cpc::to_f32(dys[bt * H + j]) + dh[j];
      const float d_o = dhj * tc * og * (1.0f - og);
      const float dcj = dc[j] + dhj * og * (1.0f - tc * tc);
      const float d_i = dcj * gg * ig * (1.0f - ig);
      const float d_f = dcj * c_prev * fg * (1.0f - fg);
      const float d_g = dcj * ig * (1.0f - gg * gg);
      dg[j] = d_i;
      dg[H + j] = d_f;
      dg[2 * H + j] = d_g;
      dg[3 * H + j] = d_o;
      dgt[j] = d_i;
      dgt[H + j] = d_f;
      dgt[2 * H + j] = d_g;
      dgt[3 * H + j] = d_o;
      dc[j] = dcj * fg;
    }
    __syncthreads();
    if (group < n_groups) {
      float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      const T* wcol = w_hh + 2 * pair;
      int r = group;
#pragma unroll 4
      for (; r + n_groups < G4; r += 2 * n_groups) {
        const float2 w = load2(wcol + (size_t)r * H);
        const float2 v = load2(wcol + (size_t)(r + n_groups) * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
        b0 += dg[r + n_groups] * v.x;
        b1 += dg[r + n_groups] * v.y;
      }
      if (r < G4) {
        const float2 w = load2(wcol + (size_t)r * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
      }
      part[group * H + 2 * pair] = a0 + b0;
      part[group * H + 2 * pair + 1] = a1 + b1;
    }
    __syncthreads();
    for (int j = tid; j < H; j += blockDim.x) {
      float s = 0.0f;
      for (int g = 0; g < n_groups; ++g) s += part[g * H + j];
      dh[j] = s;
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += blockDim.x) {
    dh0[(size_t)b * H + j] = dh[j];
    dc0[(size_t)b * H + j] = dc[j];
  }
}

template <typename T>
int launch(const float* gates, const float* cs, const void* c0,
           const void* dys, const void* w_hh, const float* dhT,
           const float* dcT, float* dgates, float* dh0, float* dc0, int B,
           int n_steps, int H, cudaStream_t stream) {
  const int n_groups = kThreads / (H / 2);
  const size_t smem = (size_t)(6 + n_groups) * H * sizeof(float);
  auto kernel = lstm_bwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(
      gates, cs, static_cast<const T*>(c0), static_cast<const T*>(dys),
      static_cast<const T*>(w_hh), dhT, dcT, dgates, dh0, dc0, n_steps, H);
  return (int)cudaGetLastError();
}

}  // namespace

// gates (B, T, 4H), cs (B, T, H), dhT, dcT (B, H) and the outputs dgates
// (B, T, 4H), dh0, dc0 (B, H) are float32; c0 (B, H), dys (B, T, H) and
// w_hh (4H, H) are in `dtype`.
extern "C" int cpc_lstm_bwd(const void* gates, const void* cs, const void* c0,
                            const void* dys, const void* w_hh,
                            const void* dhT, const void* dcT, void* dgates,
                            void* dh0, void* dc0, int B, int n_steps, int H,
                            int dtype, void* stream) {
  if (H <= 0 || H % 8 != 0 || H / 2 > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* c = static_cast<const float*>(cs);
  const float* dh = static_cast<const float*>(dhT);
  const float* dc = static_cast<const float*>(dcT);
  float* dg = static_cast<float*>(dgates);
  float* h0 = static_cast<float*>(dh0);
  float* c0o = static_cast<float*>(dc0);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(g, c, c0, dys, w_hh, dh, dc, dg, h0, c0o, B,
                                 n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(g, c, c0, dys, w_hh, dh, dc, dg, h0, c0o, B,
                         n_steps, H, s);
  return (int)cudaErrorInvalidValue;
}
