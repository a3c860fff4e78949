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
// Two bodies, picked from the shape before launching (`cluster_body`):
//
// The cluster body (csrc/rnn_cluster.cuh), at H = 128 and 256 in both
// dtypes on C = 8 CTAs, and at H = 512 in bf16 on C = 16: one cluster per
// 16 batch rows keeps W_hh on chip for the whole window, split by hidden
// unit (CTA c owns units [c H/C, (c+1) H/C) and their 4 gate rows: 133 KB
// of bf16 W_hh at H = 512, 232 KB of the CTA's 227 KB in all), and each
// step's product dh = dgates . W_hh is a per-CTA partial product
// (mma.sync with a hi/lo split of dgates in bf16, FMA in float32)
// reduce-scattered over distributed shared memory, with one cluster
// barrier a step.  The elementwise part of a step needs only the CTA's own
// units.  In float32 at H = 512, W_hh (4 MB) exceeds even 16 CTAs' shared
// memory, so the rows body runs.
//
// The rows body, at every other H (up to 2048): as in the forward, one
// block per batch row keeps the carries in shared memory for the whole
// window.  The serial product is the transpose of the forward's: dh[j] =
// sum_r dgates[r] W_hh[r, j] over the 4H gate rows of W_hh in torch's
// (4H, H) layout.  Threads own pairs of adjacent columns (one 4- or 8-byte
// load per row, a warp reads a contiguous run of a row) and form G groups
// that split the 4H rows; the G partial sums meet in shared memory.  Every
// step re-reads W_hh (512 KB in bf16 at H = 256) from L2, so a step costs
// one SM's L2 read bandwidth for it; B = 32 blocks use a quarter of the
// SMs.
//
// What bounds it on an H100: the T = 128 dependent steps.  The bytes it
// must move (0.012 ms at B 32, T 128, H 256) ignore that chain; cuDNN's
// LSTM backward, which also forms dx and dW, is its yardstick.
#include "rnn_cluster.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- the cluster body ------------------------------------------------------

// A pair's residuals of one step: gates (4 float2), c_{t-1} (float2), dys
// (two T); each field an array over the CTA's pairs.
template <typename T>
constexpr int kSlot = 5 * (int)sizeof(float2) + 2 * (int)sizeof(T);

template <typename T, int J, int C>
using ClusterLayout = cpc::rnn::Layout<T, 4, J, kSlot<T>, C>;

template <typename T, int J, int C>
__global__ void __launch_bounds__(ClusterLayout<T, J, C>::kThreads, 1)
    lstm_bwd_cluster_kernel(const float* __restrict__ gates,
                            const float* __restrict__ cs,
                            const T* __restrict__ c0,
                            const T* __restrict__ dys,
                            const T* __restrict__ w_hh,
                            const float* __restrict__ dhT,
                            const float* __restrict__ dcT,
                            float* __restrict__ dgates,
                            float* __restrict__ dh0, float* __restrict__ dc0,
                            int B, int n_steps) {
  namespace rnn = cpc::rnn;
  using L = ClusterLayout<T, J, C>;
  using T2 = typename rnn::Two<T>::type;
  constexpr int H = L::H, G4 = 4 * H, P = L::P;
  extern __shared__ __align__(16) unsigned char cluster_smem_buf[];
  unsigned char* smem = cluster_smem_buf;
  const int c = rnn::cluster_rank();
  const int b0 = blockIdx.y * rnn::kRows;
  const int tid = threadIdx.x;
  float2* dcs = reinterpret_cast<float2*>(smem + L::state);   // (P,) dc
  auto slot_of = [&](int t) {
    return smem + L::ring + (t & 1) * L::slot_bytes;
  };
  // slot fields: gate g of pair p at [g * P + p], c_{t-1} at [4 P + p]
  auto gates_of = [&](int t) { return reinterpret_cast<float2*>(slot_of(t)); };
  auto dys_of = [&](int t) {
    return reinterpret_cast<T2*>(slot_of(t) + 5 * P * sizeof(float2));
  };
  auto prefetch = [&](int t) {
    float2* g = gates_of(t);
    T2* dy = dys_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) continue;
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rnn::cp_async<8>(g + q * P + p, gates + bt * G4 + q * H + j);
      if (t > 0) rnn::cp_async<8>(g + 4 * P + p, cs + (bt - 1) * H + j);
      rnn::copy_two<T>(dy + p, dys + bt * H + j);
    }
  };

  rnn::load_w<L>(reinterpret_cast<T*>(smem + L::w), w_hh, c);
  prefetch(n_steps - 1);
  cpc::mma::cp_async_commit();
  for (int p = tid; p < P; p += L::kThreads) {
    const rnn::Pair<J> pr(p);
    const int b = b0 + pr.row;
    dcs[p] = b < B ? *reinterpret_cast<const float2*>(
                         dcT + (size_t)b * H + c * J + pr.unit)
                   : make_float2(0.0f, 0.0f);
  }
  cpc::mma::cp_async_wait<0>();
  __syncthreads();
  rnn::cluster_sync();   // every CTA of the cluster runs before any push

  for (int t = n_steps - 1; t >= 0; --t) {
    if (t > 0) prefetch(t - 1);
    cpc::mma::cp_async_commit();
    cpc::mma::cp_async_wait<1>();   // this thread's copies of step t
    const float2* g = gates_of(t);
    const T2* dy = dys_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rnn::put_a<L>(smem, pr.row, q, pr.unit, 0.0f, 0.0f);
        continue;
      }
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
      const float2 carry =
          t == n_steps - 1
              ? *reinterpret_cast<const float2*>(dhT + (size_t)b * H + j)
              : rnn::gather<L>(smem, (t + 1) & 1, pr.row, pr.unit);
      const float2 ig2 = g[p], fg2 = g[P + p], gg2 = g[2 * P + p],
                   og2 = g[3 * P + p];
      const float2 cp2 = t > 0 ? g[4 * P + p]
                               : rnn::load_two(c0 + (size_t)b * H + j);
      const float2 dy2 = rnn::Two<T>::f32(dy[p]);
      float2 dc2 = dcs[p];
      float out[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ig = e ? ig2.y : ig2.x, fg = e ? fg2.y : fg2.x,
                    gg = e ? gg2.y : gg2.x, og = e ? og2.y : og2.x;
        const float c_prev = e ? cp2.y : cp2.x;
        const float cc = fg * c_prev + ig * gg;
        const float tc = tanhf(cc);
        const float dhj = (e ? dy2.y : dy2.x) + (e ? carry.y : carry.x);
        const float d_o = dhj * tc * og * (1.0f - og);
        const float dcj = (e ? dc2.y : dc2.x) + dhj * og * (1.0f - tc * tc);
        out[0][e] = dcj * gg * ig * (1.0f - ig);
        out[1][e] = dcj * c_prev * fg * (1.0f - fg);
        out[2][e] = dcj * ig * (1.0f - gg * gg);
        out[3][e] = d_o;
        (e ? dc2.y : dc2.x) = dcj * fg;
      }
      dcs[p] = dc2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float2*>(dgates + bt * G4 + q * H + j) =
            make_float2(out[q][0], out[q][1]);
        rnn::put_a<L>(smem, pr.row, q, pr.unit, out[q][0], out[q][1]);
      }
    }
    __syncthreads();
    rnn::product_push<L>(smem, c, t & 1);
    rnn::cluster_sync();
  }
  for (int p = tid; p < P; p += L::kThreads) {
    const rnn::Pair<J> pr(p);
    const int b = b0 + pr.row;
    if (b >= B) continue;
    const size_t o = (size_t)b * H + c * J + pr.unit;
    *reinterpret_cast<float2*>(dh0 + o) =
        rnn::gather<L>(smem, 0, pr.row, pr.unit);
    *reinterpret_cast<float2*>(dc0 + o) = dcs[p];
  }
}

// A CTA's shared memory in the cluster body at H: 8 CTAs at H = 128 and
// 256, 16 at H = 512; 0 at any other H.
template <typename T>
size_t cluster_smem(int H) {
  return H == 128   ? ClusterLayout<T, 16, 8>::bytes
         : H == 256 ? ClusterLayout<T, 32, 8>::bytes
         : H == 512 ? ClusterLayout<T, 32, 16>::bytes
                    : 0;
}

// The cluster body takes H = 128 and 256, and 512 in bf16: where its
// layout fits a CTA.
template <typename T>
bool cluster_body(int H) {
  const size_t smem = cluster_smem<T>(H);
  return smem > 0 && smem <= cpc::kSmemLimit;
}

template <typename T, int J, int C>
int launch_cluster(const float* gates, const float* cs, const void* c0,
                   const void* dys, const void* w_hh, const float* dhT,
                   const float* dcT, float* dgates, float* dh0, float* dc0,
                   int B, int n_steps, cudaStream_t stream) {
  return (int)cpc::rnn::launch<ClusterLayout<T, J, C>>(
      lstm_bwd_cluster_kernel<T, J, C>, B, stream, gates, cs,
      static_cast<const T*>(c0), static_cast<const T*>(dys),
      static_cast<const T*>(w_hh), dhT, dcT, dgates, dh0, dc0, B, n_steps);
}

// ---- the rows body ---------------------------------------------------------

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

template <typename T>
int launch_any(const float* gates, const float* cs, const void* c0,
               const void* dys, const void* w_hh, const float* dhT,
               const float* dcT, float* dgates, float* dh0, float* dc0, int B,
               int n_steps, int H, cudaStream_t stream) {
  if (!cluster_body<T>(H))
    return launch<T>(gates, cs, c0, dys, w_hh, dhT, dcT, dgates, dh0, dc0, B,
                     n_steps, H, stream);
  if (H == 128)
    return launch_cluster<T, 16, 8>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                    dgates, dh0, dc0, B, n_steps, stream);
  if (H == 256)
    return launch_cluster<T, 32, 8>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                    dgates, dh0, dc0, B, n_steps, stream);
  if constexpr (sizeof(T) < sizeof(float))   // H == 512: fits in bf16 only
    return launch_cluster<T, 32, 16>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                     dgates, dh0, dc0, B, n_steps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// 1 where cpc_lstm_bwd runs the cluster body at hidden width H in
// `dtype`, 0 where it runs the rows body.
extern "C" int cpc_lstm_bwd_body(int H, int dtype) {
  return dtype == cpc::kBFloat16 ? cluster_body<__nv_bfloat16>(H)
                                 : cluster_body<float>(H);
}

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
    return launch_any<__nv_bfloat16>(g, c, c0, dys, w_hh, dh, dc, dg, h0,
                                     c0o, B, n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch_any<float>(g, c, c0, dys, w_hh, dh, dc, dg, h0, c0o, B,
                             n_steps, H, s);
  return (int)cudaErrorInvalidValue;
}
