// K1: whole-window LSTM forward recurrence.
//
// Replaces cpc_audio_tpu/ops/pallas/rnn.py `_lstm_fwd_kernel` (called
// through `lstm_scan_pallas`): ys[b, t] = h_t with torch gate order
// i, f, g, o and
//   g_t = x_proj[b, t] + h_{t-1} . W_hh^T      (x_proj already holds b_ih + b_hh)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),  h_t = sigmoid(o) * tanh(c_t)
// with the state and all gate math in float32.  For training it also
// saves the gate activations i, f, g, o (float32, (B, T, 4H)) and the cell
// states (float32, (B, T, H)), as `_lstm_fwd_kernel` does; both pointers
// may be null (the eval path), which leaves the launch unchanged.
//
// Design: batch rows are independent, so one block owns one batch row for
// the whole window and keeps h and c in shared memory across all T steps.
// Each warp takes tiles of 32 gate rows: every lane accumulates its slice
// of the hidden axis (4 elements per load) for all 32 rows at once (32
// independent loads in flight, W_hh read in torch's (4H, H) layout,
// coalesced, no transpose), then a warp reduce-scatter leaves row r0 + l's
// sum in lane l.  H % 8 == 0, so 4H is a whole number of 32-row tiles and
// no row index needs clamping (a clamped address per load cost a factor
// of five in a measured variant).
//
// What bounds it on an H100: the T steps are serial, and every step
// re-reads W_hh (4H x H; 512 KB in bf16 at H = 256, more than one SM's
// 227 KB of shared memory) from L2, so a step costs about one SM's L2
// read bandwidth for 512 KB.  B = 32 blocks occupy a quarter of the 132
// SMs.  The backward keeps W_hh on chip across a thread-block cluster
// (csrc/rnn_cluster.cuh, used by csrc/lstm_bwd.cu); the same split would
// serve this scan.
#include "common.cuh"

namespace {

// 1024 threads keep more loads in flight; the float32 body needs more
// than the 64 registers a thread may use at that size.
template <typename T>
constexpr int kThreads = sizeof(T) == 2 ? 1024 : 512;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One step of a warp reduce-scatter: each lane holds 2*OFF partial sums
// v[0..2*OFF); afterwards it holds OFF of them, summed with its partner
// lane ^ OFF (lanes with bit OFF set keep the upper half, in v[0..OFF)).
template <int OFF>
__device__ __forceinline__ void reduce_scatter_step(float* v, int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads<T>) lstm_fwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ w_hh,
    const T* __restrict__ h0, const T* __restrict__ c0, T* __restrict__ ys,
    T* __restrict__ hT, T* __restrict__ cT, float* __restrict__ gates,
    float* __restrict__ cs, int n_steps, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h = smem;       // (H,)  hidden state, f32
  float* c = h + H;      // (H,)  cell state, f32
  float* g = c + H;      // (4H,) gate pre-activations of this step
  const int G = 4 * H;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    h[j] = cpc::to_f32(h0[(size_t)b * H + j]);
    c[j] = cpc::to_f32(c0[(size_t)b * H + j]);
  }
  __syncthreads();

  const T* xb = x_proj + (size_t)b * n_steps * G;
  T* yb = ys + (size_t)b * n_steps * H;
  for (int t = 0; t < n_steps; ++t) {
    for (int r0 = warp * 32; r0 < G; r0 += n_warps * 32) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
      const T* w_tile = w_hh + (size_t)r0 * H;
      for (int j = 4 * lane; j < H; j += 128) {
        const float4 hh = *reinterpret_cast<const float4*>(h + j);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float4 w = load4(w_tile + (size_t)i * H + j);
          v[i] += w.x * hh.x + w.y * hh.y + w.z * hh.z + w.w * hh.w;
        }
      }
      reduce_scatter_step<16>(v, lane);
      reduce_scatter_step<8>(v, lane);
      reduce_scatter_step<4>(v, lane);
      reduce_scatter_step<2>(v, lane);
      reduce_scatter_step<1>(v, lane);
      g[r0 + lane] = v[0] + cpc::to_f32(xb[(size_t)t * G + r0 + lane]);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float ig = sigmoidf(g[j]);
      const float fg = sigmoidf(g[H + j]);
      const float gg = tanhf(g[2 * H + j]);
      const float og = sigmoidf(g[3 * H + j]);
      const float cn = fg * c[j] + ig * gg;
      const float hn = og * tanhf(cn);
      c[j] = cn;
      h[j] = hn;
      yb[(size_t)t * H + j] = cpc::from_f32<T>(hn);
      if (gates != nullptr) {
        float* gt = gates + ((size_t)b * n_steps + t) * G;
        gt[j] = ig;
        gt[H + j] = fg;
        gt[2 * H + j] = gg;
        gt[3 * H + j] = og;
      }
      if (cs != nullptr) cs[((size_t)b * n_steps + t) * H + j] = cn;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    hT[(size_t)b * H + j] = cpc::from_f32<T>(h[j]);
    cT[(size_t)b * H + j] = cpc::from_f32<T>(c[j]);
  }
}

template <typename T>
int launch(const void* x_proj, const void* w_hh, const void* h0,
           const void* c0, void* ys, void* hT, void* cT, float* gates,
           float* cs, int B, int n_steps, int H, cudaStream_t stream) {
  const size_t smem = 6 * (size_t)H * sizeof(float);
  auto kernel = lstm_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads<T>, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(w_hh),
      static_cast<const T*>(h0), static_cast<const T*>(c0),
      static_cast<T*>(ys), static_cast<T*>(hT), static_cast<T*>(cT), gates,
      cs, n_steps, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cpc_lstm_fwd(const void* x_proj, const void* w_hh,
                            const void* h0, const void* c0, void* ys,
                            void* hT, void* cT, void* gates, void* cs,
                            int B, int n_steps, int H, int dtype,
                            void* stream) {
  if (H <= 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gates);
  float* c = static_cast<float*>(cs);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(x_proj, w_hh, h0, c0, ys, hT, cT, g, c, B,
                                 n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(x_proj, w_hh, h0, c0, ys, hT, cT, g, c, B, n_steps,
                         H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
