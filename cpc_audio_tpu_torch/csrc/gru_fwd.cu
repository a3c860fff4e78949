// K4: whole-window GRU forward recurrence.
//
// Replaces cpc_audio_tpu/ops/pallas/rnn.py `_gru_fwd_kernel` (called
// through `gru_scan_pallas`): ys[b, t] = h_t with torch gate order
// r, z, n and
//   gh_t = h_{t-1} . W_hh^T + b_hh                 (3H, float32)
//   r = sigmoid(x_r + gh_r),  z = sigmoid(x_z + gh_z)
//   n = tanh(x_n + r * gh_n),  h_t = (1 - z) * n + z * h_{t-1}
// where x_proj = x . W_ih^T + b_ih holds the input side only: b_hn sits
// inside r * (.), so b_hh is an input of the kernel and is not folded into
// x_proj as the LSTM's is.  State and gate math are float32.  For
// training it also saves r, z, n (float32, (B, T, 3H)) and gh_n (float32,
// (B, T, H)), as `_gru_fwd_kernel` does; both pointers may be null (the
// eval path).
//
// Four bodies, picked from the shape (`body`, mirrored by ops/gru.py
// `fwd_body`): at H 128 and 256 (the default --hiddenGar) K1's cluster
// body (csrc/rnn_cluster_fwd.cuh: a cluster of 8 CTAs at H 128, 16 at 256,
// serves 16 batch rows, CTA c keeps the 3 J gate rows of its J = 16 units
// on chip for the whole window, a step's product on mma.sync, h
// all-gathered through L2 by multicast; float32 W_hh as two bf16 planes,
// 3 split products, ops/gru.py `gru_scan_split`), past H 256 K1's grid body
// (csrc/rnn_grid.cuh: W_hh split by unit over all of the card's SMs, h
// all-gathered through L2 with a grid barrier a step), at the small widths
// whose W_hh fits one SM's registers the resident body (below; float32 H
// 32, 64, 96, bf16 also 160: the learning gate's GRU at H 64), else the
// rows body (bf16 192 and 224, float32 160-224).  `Cell`, the cell of the
// grid and cluster bodies, keeps gh_n = h . W_hn^T + b_hn apart from r's
// product, as below.
//
// The rows body: K1's (csrc/lstm_fwd.cu).  Batch rows are independent, so one
// block owns one batch row for the whole window and keeps h in shared
// memory across all T steps.  Each warp takes tiles of 32 rows of W_hh:
// every lane accumulates its slice of the hidden axis (4 elements per
// load) for all 32 rows at once, then a warp reduce-scatter leaves row
// r0 + l's sum in lane l.  H % 32 == 0, so 3H is a whole number of tiles.
//
// What bounds it on an H100: the T steps are serial.  The rows body
// re-reads W_hh (3H x H; 384 KB in bf16 at H = 256, more than one SM's
// 227 KB of shared memory) from L2 every step, so a step costs about one
// SM's L2 read bandwidth for it; B = 32 blocks occupy a quarter of the
// 132 SMs.  The cluster body reads W_hh once a window, so a step costs
// the partial product (2 x 16 x 3J x H multiply-adds a CTA, hi and lo),
// the cell and the multicast's round trip through L2.  The resident body
// reads W_hh once a window into registers, so a step costs its latency
// chain: the h loads from shared memory, K / 4 float4 steps of 12
// multiply-adds, log2 S shuffles, the cell and one __syncthreads.
#include "rnn_cluster_fwd.cuh"

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
__global__ void __launch_bounds__(kThreads<T>) gru_fwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ w_hh,
    const T* __restrict__ b_hh, const T* __restrict__ h0, T* __restrict__ ys,
    T* __restrict__ hT, float* __restrict__ gates, float* __restrict__ ghn,
    int n_steps, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h = smem;       // (H,)  hidden state, f32
  float* g = h + H;      // (3H,) h . W_hh^T + b_hh of this step
  const int G = 3 * H;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int j = threadIdx.x; j < H; j += blockDim.x)
    h[j] = cpc::to_f32(h0[(size_t)b * H + j]);
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
      g[r0 + lane] = v[0] + cpc::to_f32(b_hh[r0 + lane]);
    }
    __syncthreads();
    const T* xt = xb + (size_t)t * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = sigmoidf(cpc::to_f32(xt[j]) + g[j]);
      const float z = sigmoidf(cpc::to_f32(xt[H + j]) + g[H + j]);
      const float gn = g[2 * H + j];
      const float n = tanhf(cpc::to_f32(xt[2 * H + j]) + r * gn);
      const float hn = (1.0f - z) * n + z * h[j];
      h[j] = hn;
      yb[(size_t)t * H + j] = cpc::from_f32<T>(hn);
      if (gates != nullptr) {
        float* gt = gates + ((size_t)b * n_steps + t) * G;
        gt[j] = r;
        gt[H + j] = z;
        gt[2 * H + j] = n;
      }
      if (ghn != nullptr) ghn[((size_t)b * n_steps + t) * H + j] = gn;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x)
    hT[(size_t)b * H + j] = cpc::from_f32<T>(h[j]);
}

template <typename T>
int launch(const void* x_proj, const void* w_hh, const void* b_hh,
           const void* h0, void* ys, void* hT, float* gates, float* ghn,
           int B, int n_steps, int H, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)H * sizeof(float);
  auto kernel = gru_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads<T>, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(w_hh),
      static_cast<const T*>(b_hh), static_cast<const T*>(h0),
      static_cast<T*>(ys), static_cast<T*>(hT), gates, ghn, n_steps, H);
  return (int)cudaGetLastError();
}

// ---- the resident body ------------------------------------------------------

// The resident body at (H, dtype): S lanes a unit, H S threads, each
// holding K = H / S columns of the unit's three gate rows in registers
// (float32 H 32-96: 12-36 registers of weights; bf16 H 160: 60, at 640
// threads and at most 96 registers a thread).  f(Resident<T, H, S>{})
// with the body at H in `dtype`, false where it has none (bf16 H 192's
// 221 KB of W_hh would take 144 registers a thread at 384 threads: the
// rows body keeps it).
template <typename T_, int H_, int S_>
struct Resident {
  using T = T_;
  static constexpr int H = H_;
  static constexpr int S = S_;                // lanes a unit
  static constexpr int kThreads = H * S;
  static constexpr int kM = H / (4 * S);      // float4 of h a step, a lane
  static_assert(H % (4 * S) == 0 && 32 % S == 0 && kThreads <= 1024,
                "resident layout");
};

template <typename F>
bool with_resident(int H, int dtype, F f) {
  using bf = __nv_bfloat16;
  if (dtype == cpc::kFloat32) {
    switch (H) {
      case 32: f(Resident<float, 32, 8>{}); return true;
      case 64: f(Resident<float, 64, 8>{}); return true;
      case 96: f(Resident<float, 96, 8>{}); return true;
    }
  } else if (dtype == cpc::kBFloat16) {
    switch (H) {
      case 32: f(Resident<bf, 32, 8>{}); return true;
      case 64: f(Resident<bf, 64, 8>{}); return true;
      case 96: f(Resident<bf, 96, 8>{}); return true;
      case 160: f(Resident<bf, 160, 4>{}); return true;
    }
  }
  return false;
}

// One block a batch row.  Thread (unit j, lane s of its S) keeps, for
// each gate g, W_hh[g H + j, c] at the columns c = 4 (m S + s) + v (m <
// kM, v < 4) in registers for the whole window, as kM pairs of T2: the S
// lanes of a unit read neighbouring 16-byte pieces of h, so that a warp's
// float4 loads of h meet no bank twice.  A step: each lane forms its three
// partial dot products with h_{t-1} (read from shared memory), a butterfly
// over the unit's S lanes leaves the whole sums in all of them, and each
// lane runs the cell (the same bits in all); lane 0 writes h_t into the
// other half of the double-buffered h, the others the step's outputs.
// Step t reads buffer t & 1 and writes (t + 1) & 1, whose readers of step
// t - 1 all passed the step's one __syncthreads before it.  x_proj of
// step t + 1 is loaded while step t runs.
template <typename L>
__global__ void __launch_bounds__(L::kThreads) gru_fwd_resident(
    const typename L::T* __restrict__ x_proj,
    const typename L::T* __restrict__ w_hh,
    const typename L::T* __restrict__ b_hh,
    const typename L::T* __restrict__ h0, typename L::T* __restrict__ ys,
    typename L::T* __restrict__ hT, float* __restrict__ gates,
    float* __restrict__ ghn, int n_steps) {
  using T = typename L::T;
  using Two = cpc::rnn::Two<T>;
  using T2 = typename Two::type;
  constexpr int H = L::H, S = L::S, M = L::kM;
  __shared__ __align__(16) float hs[2][H];
  const int j = threadIdx.x / S, s = threadIdx.x % S;
  const int b = blockIdx.x;
  T2 w[3][2 * M];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        w[g][2 * m + q] = *reinterpret_cast<const T2*>(
            w_hh + (size_t)(g * H + j) * H + 4 * (m * S + s) + 2 * q);
  float bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bh[g] = cpc::to_f32(b_hh[g * H + j]);
  float h = cpc::to_f32(h0[(size_t)b * H + j]);
  if (s == 0) hs[0][j] = h;
  const T* xb = x_proj + (size_t)b * n_steps * 3 * H + j;
  float x[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) x[g] = cpc::to_f32(xb[g * H]);
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    float xn[3] = {0.0f, 0.0f, 0.0f};
    if (t + 1 < n_steps) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xn[g] = cpc::to_f32(xb[(size_t)(t + 1) * 3 * H + g * H]);
    }
    const float* hc = hs[t & 1];
    float acc[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (sizeof(T) == 2 && M > 4) {
      // bf16 H 160: keep the packed weights the step's operands, so that
      // their float32 values are not hoisted out of the loop (twice the
      // registers: 120 a thread, past the 96 it may use)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int i = 0; i < 2 * M; ++i)
          asm volatile("" : "+r"(*reinterpret_cast<uint32_t*>(&w[g][i])));
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 hv =
          *reinterpret_cast<const float4*>(hc + 4 * (m * S + s));
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 a = Two::f32(w[g][2 * m]);
        const float2 c = Two::f32(w[g][2 * m + 1]);
        acc[g] = fmaf(a.x, hv.x, acc[g]);
        acc[g] = fmaf(a.y, hv.y, acc[g]);
        acc[g] = fmaf(c.x, hv.z, acc[g]);
        acc[g] = fmaf(c.y, hv.w, acc[g]);
      }
    }
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    const float gn = acc[2] + bh[2];
    const float r = sigmoidf(x[0] + (acc[0] + bh[0]));
    const float z = sigmoidf(x[1] + (acc[1] + bh[1]));
    const float n = tanhf(x[2] + r * gn);
    h = (1.0f - z) * n + z * h;
    const size_t bt = (size_t)b * n_steps + t;
    if (s == 0) {
      hs[(t + 1) & 1][j] = h;
      ys[bt * H + j] = cpc::from_f32<T>(h);
    }
    if (gates != nullptr) {
      float* gt = gates + bt * 3 * H + j;
      if (s == 1 % S) gt[0] = r;
      if (s == 2 % S) gt[H] = z;
      if (s == 3 % S) gt[2 * H] = n;
    }
    if (ghn != nullptr && s == (S > 4 ? 4 : 0)) ghn[bt * H + j] = gn;
#pragma unroll
    for (int g = 0; g < 3; ++g) x[g] = xn[g];
    __syncthreads();
  }
  if (s == 0) hT[(size_t)b * H + j] = cpc::from_f32<T>(h);
}

template <typename L>
int launch_resident(const void* x_proj, const void* w_hh, const void* b_hh,
                    const void* h0, void* ys, void* hT, float* gates,
                    float* ghn, int B, int n_steps, cudaStream_t stream) {
  using T = typename L::T;
  gru_fwd_resident<L><<<B, L::kThreads, 0, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(w_hh),
      static_cast<const T*>(b_hh), static_cast<const T*>(h0),
      static_cast<T*>(ys), static_cast<T*>(hT), gates, ghn, n_steps);
  return (int)cudaGetLastError();
}

// ---- the cell of the grid and cluster bodies --------------------------------

namespace rnn = cpc::rnn;

// A thread's pair of units (k, k + 1) of batch row b: h and b_hh in
// registers.  `step` is the grid body's (csrc/rnn_grid.cuh); the cluster
// body runs its halves apart: `cell`, then `store` once h_t is on its way.
template <typename T_>
struct Cell {
  using T = T_;
  using T2 = typename rnn::Two<T>::type;
  static constexpr int G = 3;
  // distinct tensors (restrict: the x_proj loads go through the
  // read-only path and need not wait on the output stores)
  struct Params {
    const T* __restrict__ x_proj;
    const T* __restrict__ b_hh;
    const T* __restrict__ h0;
    T* __restrict__ ys;
    T* __restrict__ hT;
    float* __restrict__ gates;
    float* __restrict__ ghn;
  };
  struct State {
    float2 h;
    float2 b[3];
  };
  struct X {
    T2 x[3];
  };
  // the step's outputs of the pair: r, z, n and gh_n
  struct Out {
    float r[2], z[2], n[2], gn[2];
  };
  static Params offset(Params p, const cpc::grid::Shape& s, int b0) {
    const size_t r = (size_t)b0 * s.H, rt = r * s.T;
    p.x_proj += 3 * rt;
    p.h0 += r;
    p.ys += rt;
    p.hT += r;
    if (p.gates != nullptr) p.gates += 3 * rt;
    if (p.ghn != nullptr) p.ghn += rt;
    return p;
  }
  __device__ static State init(const Params& p, const cpc::grid::Shape& s,
                               int b, int k, bool valid) {
    State st;
    const float2 z = make_float2(0.0f, 0.0f);
    st.h = valid ? rnn::load_two(p.h0 + (size_t)b * s.H + k) : z;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      st.b[g] = valid ? rnn::load_two(p.b_hh + g * s.H + k) : z;
    return st;
  }
  __device__ static X load_x(const Params& p, const cpc::grid::Shape& s,
                             int b, int k, int t, bool valid) {
    X x;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      x.x[g] = valid ? *reinterpret_cast<const T2*>(
                           p.x_proj + ((size_t)b * s.T + t) * 3 * s.H +
                           g * s.H + k)
                     : rnn::Two<T>::zero();
    return x;
  }
  __device__ static float2 cell(State& st, const X& x,
                                const float (&pre)[3][2], Out& o) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float xv[3], gh[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 x2 = rnn::Two<T>::f32(x.x[g]);
        xv[g] = u ? x2.y : x2.x;
        gh[g] = pre[g][u] + (u ? st.b[g].y : st.b[g].x);
      }
      o.r[u] = sigmoidf(xv[0] + gh[0]);
      o.z[u] = sigmoidf(xv[1] + gh[1]);
      o.gn[u] = gh[2];
      o.n[u] = tanhf(xv[2] + o.r[u] * o.gn[u]);
      float& h = u ? st.h.y : st.h.x;
      h = (1.0f - o.z[u]) * o.n[u] + o.z[u] * h;
    }
    return st.h;
  }
  __device__ static void store(const Params& p, const cpc::grid::Shape& s,
                               const State& st, const Out& o, int b, int k,
                               int t) {
    const int H = s.H;
    const size_t bt = (size_t)b * s.T + t;
    if (p.gates != nullptr) {
      float* gt = p.gates + bt * 3 * H + k;
      *reinterpret_cast<float2*>(gt) = make_float2(o.r[0], o.r[1]);
      *reinterpret_cast<float2*>(gt + H) = make_float2(o.z[0], o.z[1]);
      *reinterpret_cast<float2*>(gt + 2 * H) = make_float2(o.n[0], o.n[1]);
    }
    if (p.ghn != nullptr)
      *reinterpret_cast<float2*>(p.ghn + bt * H + k) =
          make_float2(o.gn[0], o.gn[1]);
    rnn::store_two(p.ys + bt * H + k, st.h.x, st.h.y);
    if (t == s.T - 1)
      rnn::store_two(p.hT + (size_t)b * H + k, st.h.x, st.h.y);
  }
  __device__ static float2 step(const Params& p, const cpc::grid::Shape& s,
                                State& st, const X& x,
                                const float (&pre)[3][2], int b, int k,
                                int t) {
    Out o;
    const float2 h = cell(st, x, pre, o);
    store(p, s, st, o, b, k, t);
    return h;
  }
};

template <typename T>
typename Cell<T>::Params params(const void* x_proj, const void* b_hh,
                                const void* h0, void* ys, void* hT,
                                float* gates, float* ghn) {
  return {static_cast<const T*>(x_proj), static_cast<const T*>(b_hh),
          static_cast<const T*>(h0),     static_cast<T*>(ys),
          static_cast<T*>(hT),           gates,
          ghn};
}

// ---- the cluster body (csrc/rnn_cluster_fwd.cuh) ----------------------------

// the cluster body's layouts at H 128 and 256, K1's with three gate rows
// a unit (a warp's 24 rows of W_hh); f(L{}) with the layout at H in
// `dtype`, false where it has none
template <typename F>
bool with_layout(int H, int dtype, F f) {
  return rnn::with_resident_layout<3>(H, dtype, f);
}

size_t cluster_smem(int H, int dtype) {
  size_t smem = 0;
  with_layout(H, dtype, [&](auto l) { smem = decltype(l)::bytes; });
  return smem;
}

// The body at H in `dtype`: 1 the cluster body, 2 the grid body (every H
// past 256), 3 the resident body, 0 the rows body.
int body(int H, int dtype) {
  const size_t smem = cluster_smem(H, dtype);
  if (smem > 0 && smem <= cpc::kSmemLimit) return 1;
  if (H >= cpc::grid::kMinH) return 2;
  return with_resident(H, dtype, [](auto) {}) ? 3 : 0;
}

}  // namespace

// The body cpc_gru_fwd runs at hidden width H in `dtype`: 0 rows, 1
// cluster, 2 grid, 3 resident (ops/gru.py `fwd_body`).
extern "C" int cpc_gru_fwd_body(int H, int dtype) { return body(H, dtype); }

// The cluster body's shared memory a CTA at H in `dtype` (0: none;
// ops/gru.py `fwd_smem`).
extern "C" size_t cpc_gru_fwd_smem(int H, int dtype) {
  return cluster_smem(H, dtype);
}

// Bytes of global scratch cpc_gru_fwd needs at (B, H, dtype): the cluster
// body's exchange blocks, the grid body's exchange buffer (and in float32
// W_hh's bf16 planes, for both), 0 for the resident and rows bodies.
extern "C" size_t cpc_gru_fwd_scratch(int B, int H, int dtype) {
  switch (body(H, dtype)) {
    case 1: {
      size_t n = 0;
      with_layout(H, dtype,
                  [&](auto l) { n = decltype(l)::scratch(B); });
      return n;
    }
    case 2:
      return cpc::grid::scratch_bytes(false, B, H, 3,
                                      dtype == cpc::kFloat32 ? 2 : 1);
    default:
      return 0;
  }
}

// x_proj (B, T, 3H), w_hh (3H, H), b_hh (3H,), h0 (B, H), ys (B, T, H) and
// hT (B, H) in `dtype`; gates (B, T, 3H) and ghn (B, T, H) float32 or null;
// scratch: cpc_gru_fwd_scratch bytes (null where 0); barrier: the grid
// body's barrier word (csrc/rnn_grid.cuh; null for the other bodies).  A
// cluster the card refuses returns its error; no other body runs instead.
extern "C" int cpc_gru_fwd(const void* x_proj, const void* w_hh,
                           const void* b_hh, const void* h0, void* ys,
                           void* hT, void* gates, void* ghn, void* scratch,
                           void* barrier, int B, int n_steps, int H,
                           int dtype, void* stream) {
  if (H <= 0 || H % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gates);
  float* n = static_cast<float*>(ghn);
  switch (body(H, dtype)) {
    case 1: {
      cudaError_t err = cudaErrorInvalidValue;
      with_layout(H, dtype, [&](auto l) {
        using L = decltype(l);
        using T = typename L::T;
        err = rnn::launch_fwd<L, Cell<T>>(
            params<T>(x_proj, b_hh, h0, ys, hT, g, n), w_hh, scratch, B,
            n_steps, s);
      });
      return (int)err;
    }
    case 2: {
      unsigned* bar = static_cast<unsigned*>(barrier);
      if (bar == nullptr) return (int)cudaErrorInvalidValue;
      if (dtype == cpc::kBFloat16)
        return cpc::grid::run_fwd<Cell<__nv_bfloat16>>(
            params<__nv_bfloat16>(x_proj, b_hh, h0, ys, hT, g, n), w_hh,
            scratch, bar, B, n_steps, H, s);
      if (dtype == cpc::kFloat32)
        return cpc::grid::run_fwd<Cell<float>>(
            params<float>(x_proj, b_hh, h0, ys, hT, g, n), w_hh, scratch,
            bar, B, n_steps, H, s);
      return (int)cudaErrorInvalidValue;
    }
    case 3: {
      int err = (int)cudaErrorInvalidValue;
      with_resident(H, dtype, [&](auto l) {
        err = launch_resident<decltype(l)>(x_proj, w_hh, b_hh, h0, ys, hT, g,
                                           n, B, n_steps, s);
      });
      return err;
    }
  }
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(x_proj, w_hh, b_hh, h0, ys, hT, g, n, B,
                                 n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(x_proj, w_hh, b_hh, h0, ys, hT, g, n, B, n_steps, H,
                         s);
  return (int)cudaErrorInvalidValue;
}
