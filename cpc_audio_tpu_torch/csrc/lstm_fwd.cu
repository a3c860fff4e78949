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
// Three bodies, picked from the shape before launching (`body`, mirrored
// by ops/lstm.py `fwd_body`): the cluster body at H 128, 256, 512 and 768,
// the grid body at every other H past 256 (csrc/rnn_grid.cuh: W_hh split
// by unit over all of the card's SMs in one cooperative launch, h
// all-gathered through L2 with a grid barrier a step), the rows body at
// the other H <= 256 (200, 104, ...).  `Cell` is the cell of the grid and
// cluster bodies.
//
// The cluster body (csrc/rnn_cluster_fwd.cuh, one template with K4's):
// one cluster of C CTAs serves 16 batch rows, CTA c owns J = H / C units
// and their four gate rows of W_hh and keeps them on chip for the whole
// window; a step is the partial product h_{t-1} . W_slice^T on
// mma.sync.m16n8k16 (h as bf16 hi + lo), the cell on the owning warps, and
// an all-gather of h through L2 by one multicast bulk copy a CTA.  At H
// 128 C is 8 and at H 256 (the default --hiddenGar) 16 (J 16: 16 KB of
// bf16 slice a CTA; twice that in float32), the slice resident, the A
// tile in two parities (no cluster barrier).  (At H 256, 16 CTAs of 16
// units took 0.201 ms a call in bf16 at B 32 / T 128, 8 of 32 units
// 0.265: port_perf/k1_fwd_layouts.py, NVIDIA H100 80GB HBM3, 700 W.)  At
// H 512 (J 32) and 768 (J 48) C is 16 too,
// whose slice (139 and 295 KB in bf16) is resident at 512 in bf16; at
// 768, and at both in float32, a warp
// holds the fragments of its first k-steps in registers, the next in
// shared memory and streams the rest (72 KB a CTA a step at 768 in bf16)
// from L2 through a two-stage ring (`cpc::rnn::Split`), with one parity of
// the A tile and a cluster barrier split around the cell.  In float32
// W_hh is not exact in bf16: the body runs on its two bf16 planes, hi and
// lo (split once a call into the scratch, `cpc::rnn::split_planes`), with
// 3 split products a k-step (h's hi and lo by W_hi, h's hi by W_lo: about
// 2^-16 of |h||W_hh| a term dropped; ops/lstm.py `lstm_scan_split` writes
// that arithmetic).
//
// The rows body, at the H <= 256 with no cluster body: batch rows are
// independent, so one block owns one batch row for the whole window and keeps h
// and c in shared memory across all T steps. Each warp takes tiles of 32 gate
// rows: every lane accumulates its slice of the hidden axis (4 elements per
// load) for all 32 rows at once (32 independent loads in flight, W_hh read in
// torch's (4H, H) layout, coalesced, no transpose), then a warp reduce-scatter
// leaves row r0 + l's sum in lane l.  H % 8 == 0, so 4H is a whole number of
// 32-row tiles and no row index needs clamping (a clamped address per load cost
// a factor of five in a measured variant).
//
// What bounds it on an H100: the T steps are serial.  The rows body
// re-reads W_hh (4H x H; 320 KB in bf16 at H = 200) from L2 every step,
// once per batch row, so a step costs one SM's L2 read bandwidth for it.
// The cluster body reads W_hh once a window (but for the streamed
// remainder), so a step costs the partial product (2 x 16 x 4J x H
// multiply-adds a CTA, hi and lo), the cell on a third to a half of the
// warps, and the multicast's round trip through L2.
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

// ---- the cell of the grid and cluster bodies --------------------------------

namespace rnn = cpc::rnn;
using bf16 = __nv_bfloat16;

// A thread's pair of units (k, k + 1) of batch row b: c in registers.
// `step` is the grid body's (csrc/rnn_grid.cuh); the cluster body runs
// its halves apart: `cell`, then `store` once h_t is on its way.
template <typename T_>
struct Cell {
  using T = T_;
  using T2 = typename rnn::Two<T>::type;
  static constexpr int G = 4;
  // distinct tensors (restrict: the x_proj loads go through the
  // read-only path and need not wait on the output stores)
  struct Params {
    const T* __restrict__ x_proj;
    const T* __restrict__ h0;
    const T* __restrict__ c0;
    T* __restrict__ ys;
    T* __restrict__ hT;
    T* __restrict__ cT;
    float* __restrict__ gates;
    float* __restrict__ cs;
  };
  struct State {
    float2 c;
  };
  struct X {
    T2 x[4];
  };
  // the step's outputs of the pair: i, f, g, o and h
  struct Out {
    float act[4][2];
    float2 h;
  };
  static Params offset(Params p, const cpc::grid::Shape& s, int b0) {
    const size_t r = (size_t)b0 * s.H, rt = r * s.T;
    p.x_proj += 4 * rt;
    p.h0 += r;
    p.c0 += r;
    p.ys += rt;
    p.hT += r;
    p.cT += r;
    if (p.gates != nullptr) p.gates += 4 * rt;
    if (p.cs != nullptr) p.cs += rt;
    return p;
  }
  __device__ static State init(const Params& p, const cpc::grid::Shape& s,
                               int b, int k, bool valid) {
    return {valid ? rnn::load_two(p.c0 + (size_t)b * s.H + k)
                  : make_float2(0.0f, 0.0f)};
  }
  __device__ static X load_x(const Params& p, const cpc::grid::Shape& s,
                             int b, int k, int t, bool valid) {
    X x;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      x.x[g] = valid ? *reinterpret_cast<const T2*>(
                           p.x_proj + ((size_t)b * s.T + t) * 4 * s.H +
                           g * s.H + k)
                     : rnn::Two<T>::zero();
    return x;
  }
  __device__ static float2 cell(State& st, const X& x,
                                const float (&pre)[4][2], Out& o) {
    float hn[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 xv = rnn::Two<T>::f32(x.x[g]);
        v[g] = pre[g][u] + (u ? xv.y : xv.x);
      }
      o.act[0][u] = sigmoidf(v[0]);
      o.act[1][u] = sigmoidf(v[1]);
      o.act[2][u] = tanhf(v[2]);
      o.act[3][u] = sigmoidf(v[3]);
      float& cu = u ? st.c.y : st.c.x;
      cu = o.act[1][u] * cu + o.act[0][u] * o.act[2][u];
      hn[u] = o.act[3][u] * tanhf(cu);
    }
    o.h = make_float2(hn[0], hn[1]);
    return o.h;
  }
  __device__ static void store(const Params& p, const cpc::grid::Shape& s,
                               const State& st, const Out& o, int b, int k,
                               int t) {
    const int H = s.H;
    const size_t bt = (size_t)b * s.T + t;
    if (p.gates != nullptr)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<float2*>(p.gates + bt * 4 * H + g * H + k) =
            make_float2(o.act[g][0], o.act[g][1]);
    if (p.cs != nullptr)
      *reinterpret_cast<float2*>(p.cs + bt * H + k) = st.c;
    rnn::store_two(p.ys + bt * H + k, o.h.x, o.h.y);
    if (t == s.T - 1) {
      rnn::store_two(p.hT + (size_t)b * H + k, o.h.x, o.h.y);
      rnn::store_two(p.cT + (size_t)b * H + k, st.c.x, st.c.y);
    }
  }
  __device__ static float2 step(const Params& p, const cpc::grid::Shape& s,
                                State& st, const X& x,
                                const float (&pre)[4][2], int b, int k,
                                int t) {
    Out o;
    const float2 h = cell(st, x, pre, o);
    store(p, s, st, o, b, k, t);
    return h;
  }
};

template <typename T>
typename Cell<T>::Params params(const void* x_proj, const void* h0,
                                const void* c0, void* ys, void* hT, void* cT,
                                float* gates, float* cs) {
  return {static_cast<const T*>(x_proj), static_cast<const T*>(h0),
          static_cast<const T*>(c0),     static_cast<T*>(ys),
          static_cast<T*>(hT),           static_cast<T*>(cT),
          gates,                         cs};
}

// ---- the cluster body (csrc/rnn_cluster_fwd.cuh) ----------------------------

// FwdLayout<J, KS, RK, SK, D, NP, PL, C>, H = C J: at H 128 and 256
// rnn::with_resident_layout's; at H 512 and 768 on 16 CTAs, part of the
// slice streamed at 768 and in float32
using rnn::FwdLayout;
using Fwd512 = FwdLayout<32, 4, 0, 8, 1, 2>;
using Fwd768 = FwdLayout<48, 2, 8, 10, 2, 1>;
// float32: 16 and 48 k-steps a warp at 512 and 768, 6 and 30 of them
// streamed; at 512 one parity of the A tile, to make room for the ring
using Fwd512F = FwdLayout<32, 4, 3, 7, 2, 1, 2>;
using Fwd768F = FwdLayout<48, 2, 8, 10, 2, 1, 2>;

// K1's own body at H 768 in float32 (`Fwd768F`), the first float32
// kernel of this layout, kept beside the template: the same layout,
// arithmetic and bits as rnn_cluster_fwd.cuh's `fwd_cluster_kernel`,
// which at this one layout runs 7-8 % slower (2.125-2.134 against
// 1.975-1.980 ms at B 32 / T 128 on an H100, port_perf/k1_ab.py;
// PERF.md).  Its step loop has more instructions and spill ops than the
// template's (port_perf/k1_fwd_sass.py: 1522 against 1442, 146 against
// 112) and loads the next x_proj before the product; why it is faster
// is not found.
// w: W_hh's two bf16 planes ((4H, H) each, plane 1 4 H H elements past
// plane 0, `split_planes`' output).
template <typename L>
__global__ void __launch_bounds__(L::kThreads, 1) lstm_fwd_stream_kernel(
    const typename L::T* __restrict__ x_proj, const bf16* __restrict__ w,
    const typename L::T* __restrict__ h0,
    const typename L::T* __restrict__ c0, typename L::T* __restrict__ ys,
    typename L::T* __restrict__ hT, typename L::T* __restrict__ cT,
    float* __restrict__ gates, float* __restrict__ cs,
    bf16* __restrict__ scratch, int B, int n_steps) {
  using S = typename L::S;
  using Blk = typename L::Blk;
  using T2 = typename rnn::Two<typename L::T>::type;
  constexpr int J = L::J, H = L::H, G4 = 4 * H, NU = L::NU, KS = L::KS;
  constexpr int NKW = L::NKW, kC = L::kCluster;
  extern __shared__ __align__(16) unsigned char fwd_smem_buf[];
  unsigned char* smem = fwd_smem_buf;
  bf16* atile = reinterpret_cast<bf16*>(smem + L::a);   // [NP][CTA]
  bf16* res = reinterpret_cast<bf16*>(smem + L::res);
  float* part = reinterpret_cast<float*>(smem + L::part);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  const int c = rnn::cluster_rank();
  const int b0 = blockIdx.y * rnn::kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = warp % NU, p = warp / NU;
  const int gq = lane >> 2, tq = lane & 3;
  const int k_warp = p * NKW * 16;            // the warp's first k
  bf16* ring = reinterpret_cast<bf16*>(smem + L::ring) +
               (size_t)warp * S::ring_elems;
  // this CTA's block of parity q in global memory
  auto own_block = [&](int q) {
    return scratch +
           (((size_t)q * gridDim.y + blockIdx.y) * kC + c) * Blk::kElems;
  };
  // row r (0..7) of the warp's n-tile of gate g, in W_hh's plane pl
  auto w_row = [&](int g, int r, int pl) {
    return w + (size_t)pl * G4 * H +
           (size_t)(g * H + c * J + ug * 8 + r) * H;
  };

  if (tid == 0) {
    for (int q = 0; q < L::NP; ++q) rnn::mbar_init(full + q, 1);
    rnn::fence_mbar_init();
  }
  // the resident k-steps of every warp's 32 rows
  constexpr int RP = L::ldr / 8 - 1;          // 16-byte pieces a row
  for (int idx = tid; idx < L::kWarps * 32 * RP; idx += L::kThreads) {
    const int row = idx / RP, q = idx - row * RP;
    const int w_ = row >> 5, g = (row >> 3) & 3, r = row & 7;
    const int i = S::RK + q / 2;              // the piece's k-step
    const bf16* src = w + (size_t)(i / NKW) * G4 * H +
                      (size_t)(g * H + c * J + (w_ % NU) * 8 + r) * H +
                      (w_ / NU) * NKW * 16 + (i % NKW) * 16 + (q & 1) * 8;
    cpc::mma::cp_async16(res + row * L::ldr + q * 8, src, true);
  }
  cpc::mma::cp_async_commit();
  // the register k-steps' B fragments of the warp's four n-tiles
  uint32_t breg[S::RK > 0 ? S::RK : 1][4][2];
#pragma unroll
  for (int i = 0; i < S::RK; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const bf16* src =
          w_row(g, gq, i / NKW) + k_warp + (i % NKW) * 16 + 2 * tq;
      breg[i][g][0] = *reinterpret_cast<const uint32_t*>(src);
      breg[i][g][1] = *reinterpret_cast<const uint32_t*>(src + 8);
    }
  // parity 0 of the A tile <- h0 (rows past B zero)
  for (int idx = tid; idx < rnn::kRows * H / 2; idx += L::kThreads) {
    const int row = idx / (H / 2), col = 2 * (idx - row * (H / 2));
    const int b = b0 + row;
    const float2 v = b < B ? rnn::load_two(h0 + (size_t)b * H + col)
                           : make_float2(0.0f, 0.0f);
    uint32_t hi, lo;
    cpc::mma::split_pair(hi, lo, v.x, v.y);
    bf16* blk = atile + (col / J) * Blk::kElems + Blk::at(row, col % J);
    *reinterpret_cast<uint32_t*>(blk) = hi;
    *reinterpret_cast<uint32_t*>(blk + rnn::kRows * J) = lo;
  }
  rnn::fence_proxy_shared();   // before the copies that overwrite it
  // parts 0 and 1 own row gq + 8 p of the lane's cells, units u0, u0 + 1
  const bool owner = p < 2;
  const int u0 = ug * 8 + 2 * tq;
  const int j0 = c * J + u0;
  const int row = gq + 8 * (p & 1);
  const int brow = b0 + row;
  const bool valid = owner && brow < B;
  float2 cst = valid ? rnn::load_two(c0 + (size_t)brow * H + j0)
                     : make_float2(0.0f, 0.0f);
  T2 xnext[4];
  auto load_x = [&](int t) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xnext[g] = valid ? *reinterpret_cast<const T2*>(
                             x_proj + ((size_t)brow * n_steps + t) * G4 +
                             g * H + j0)
                       : rnn::Two<typename L::T>::zero();
  };
  load_x(0);
  cpc::mma::cp_async_wait<0>();
  __syncthreads();
  // streamed k-step q of the warp: its 32 rows by 16 k
  auto fill = [&](bf16* stage, int q) {
    const int i = S::NR + q;
    const int k = k_warp + (i % NKW) * 16;
    rnn::copy_rows<32, 2, L::lds>(stage, [&](int r) {
      return w_row(r >> 3, r & 7, i / NKW) + k;
    });
  };
  S::prime(ring, fill);
  rnn::cluster_sync();   // every CTA's mbarriers are set before any copy

  for (int t = 0; t < n_steps; ++t) {
    // A tile parity cur holds h_{t-1} (16 blocks copied at step t - 1),
    // h_t goes to parity nxt; the global blocks alternate
    const int cur = L::NP == 2 ? t & 1 : 0, nxt = L::NP == 2 ? cur ^ 1 : 0;
    const int sq = (t + 1) & 1;
    const bool more = t + 1 < n_steps;
    if (t > 0)
      rnn::mbar_wait(full + cur,
                     (L::NP == 2 ? (t - 1) >> 1 : t - 1) & 1);
    if (tid == 0 && more) rnn::mbar_expect(full + nxt, kC * Blk::kBytes);
    T2 x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = xnext[g];
    if (more) load_x(t + 1);

    // the partial product over the warp's part of k; the hi product and
    // the small ones (lo . W, and hi . W's lo plane) apart (two dependence
    // chains)
    const bf16* a_cur = atile + cur * kC * Blk::kElems;
    float acc_h[4][4], acc_l[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[g][e] = acc_l[g][e] = 0.0f;
    // k-step i of the warp (plane i / NKW; a constant once unrolled)
    auto kstep = [&](int i, const uint32_t (&b)[4][2]) {
      const bool lo_plane = i >= NKW;
      const int k = k_warp + (i % NKW) * 16;
      // rows lane & 15, chunk of k + 8 (lane >> 4), of the block holding k
      const int r = lane & 15;
      const bf16* hi = a_cur + (k / J) * Blk::kElems +
                       Blk::at(r, k % J + ((lane >> 4) << 3));
      uint32_t ah[4], al[4];
      cpc::mma::ldmatrix_x4(ah, hi);
      if (!lo_plane) cpc::mma::ldmatrix_x4(al, hi + rnn::kRows * J);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (lo_plane) {
          cpc::mma::mma_bf16(acc_l[g], ah, b[g][0], b[g][1]);
        } else {
          cpc::mma::mma_bf16(acc_h[g], ah, b[g][0], b[g][1]);
          cpc::mma::mma_bf16(acc_l[g], al, b[g][0], b[g][1]);
        }
      }
    };
    // B fragments of the four gates from a tile of the warp's 32 rows
    auto from_tile = [&](const bf16* tile, int ld, int k0,
                         uint32_t (&b)[4][2]) {
      uint32_t v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cpc::mma::load_b_nmajor(v, tile, ld, 16 * h, k0);
        b[2 * h][0] = v[0];
        b[2 * h][1] = v[1];
        b[2 * h + 1][0] = v[2];
        b[2 * h + 1][1] = v[3];
      }
    };
    S::product(
        ring,
        [&](int i) {
          if (i < S::RK) {
            kstep(i, breg[i < S::RK ? i : 0]);
          } else {
            uint32_t b[4][2];
            from_tile(res + warp * 32 * L::ldr, L::ldr, (i - S::RK) * 16, b);
            kstep(i, b);
          }
        },
        [&](int q, const bf16* stage) {
          uint32_t b[4][2];
          from_tile(stage, L::lds, 0, b);
          kstep(S::NR + q, b);
        },
        fill);
    // one parity: the copies of this step wait until every CTA is done
    // reading its A tile
    if (L::NP == 1) rnn::cluster_arrive();
    // the warp's sums, cell (row gq + 8 e, unit u0 + u) of gate g at
    // v[g][2 e + u]; each part leaves the rows it does not own:
    // part[unit group][PER][lane], part p < 2 at 8 p, p >= 2 at 16 (p - 1)
    float v[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[g][e] = acc_h[g][e] + acc_l[g][e];
    float* mine = part + (size_t)ug * L::PER * 32 + lane;
    if (owner) {                       // row gq + 8 (1 - p)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mine[(8 * p + 2 * g + u) * 32] = p ? v[g][u] : v[g][2 + u];
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(16 * (p - 1) + 4 * g + e) * 32] = v[g][e];
    }
    // the copy of step t - 2 has read this CTA's global block sq
    if (tid == 0) rnn::multicast_read_wait<1>();
    __syncthreads();
    float act[4][2], hn[2];            // i, f, g, o; units u0, u0 + 1
    if (owner) {
      const int e = p;                 // the owned row: gq + 8 e
      const float* theirs = part + (size_t)ug * L::PER * 32 + lane;
      float pre[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float own = p ? v[g][2 + u] : v[g][u];
          float s = 0.0f;
#pragma unroll
          for (int pp = 0; pp < KS; ++pp)
            s += pp == p   ? own
                 : pp < 2  ? theirs[(8 * pp + 2 * g + u) * 32]
                           : theirs[(16 * (pp - 1) + 4 * g + 2 * e + u) * 32];
          const float2 xv = rnn::Two<typename L::T>::f32(x[g]);
          pre[g][u] = s + (u ? xv.y : xv.x);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        act[0][u] = sigmoidf(pre[0][u]);
        act[1][u] = sigmoidf(pre[1][u]);
        act[2][u] = tanhf(pre[2][u]);
        act[3][u] = sigmoidf(pre[3][u]);
        float& cu = u ? cst.y : cst.x;
        const float cn = act[1][u] * cu + act[0][u] * act[2][u];
        hn[u] = valid ? act[3][u] * tanhf(cn) : 0.0f;
        cu = valid ? cn : 0.0f;
      }
      if (more) {
        uint32_t hi, lo;
        cpc::mma::split_pair(hi, lo, hn[0], hn[1]);
        bf16* blk = own_block(sq) + Blk::at(row, u0);
        *reinterpret_cast<uint32_t*>(blk) = hi;
        *reinterpret_cast<uint32_t*>(blk + rnn::kRows * J) = lo;
        rnn::fence_proxy_global();
      }
    }
    if (L::NP == 1) rnn::cluster_wait();
    __syncthreads();
    // h_t's block of this CTA into parity nxt of every CTA
    if (tid == 0 && more)
      rnn::multicast(atile + (nxt * kC + c) * Blk::kElems, own_block(sq),
                     Blk::kBytes, full + nxt, 0xffff);
    // the step's outputs, stored while the copies are in flight, off the
    // exchange's path
    if (valid) {
      const size_t bt = (size_t)brow * n_steps + t;
      if (gates != nullptr)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<float2*>(gates + bt * G4 + g * H + j0) =
              make_float2(act[g][0], act[g][1]);
      if (cs != nullptr) *reinterpret_cast<float2*>(cs + bt * H + j0) = cst;
      rnn::store_two(ys + bt * H + j0, hn[0], hn[1]);
      if (!more) {
        const size_t o = (size_t)brow * H + j0;
        rnn::store_two(hT + o, hn[0], hn[1]);
        rnn::store_two(cT + o, cst.x, cst.y);
      }
    }
  }
  if (tid == 0) rnn::multicast_read_wait<0>();
}


// f(L{}) with the cluster body's layout at H in `dtype`; false where it
// has none.
template <typename F>
bool with_layout(int H, int dtype, F f) {
  if (rnn::with_resident_layout<4>(H, dtype, f)) return true;
  if (dtype == cpc::kBFloat16) {
    switch (H) {
      case 512: f(Fwd512{}); return true;
      case 768: f(Fwd768{}); return true;
    }
  } else if (dtype == cpc::kFloat32) {
    switch (H) {
      case 512: f(Fwd512F{}); return true;
      case 768: f(Fwd768F{}); return true;
    }
  }
  return false;
}

// A CTA's shared memory in the cluster body at H in `dtype`, 0 where it
// has none.
size_t cluster_smem(int H, int dtype) {
  size_t smem = 0;
  with_layout(H, dtype, [&](auto l) { smem = decltype(l)::bytes; });
  return smem;
}

bool cluster_body(int H, int dtype) {
  const size_t smem = cluster_smem(H, dtype);
  return smem > 0 && smem <= cpc::kSmemLimit;
}

// lstm_fwd_stream_kernel on L::scratch(B) bytes: W_hh's planes first,
// then the CTAs' blocks, as rnn::launch_fwd lays them out.
template <typename L>
cudaError_t launch_stream(const void* x_proj, const void* w_hh,
                          const void* h0, const void* c0, void* ys, void* hT,
                          void* cT, float* gates, float* cs, void* scratch,
                          int B, int n_steps, cudaStream_t stream) {
  using T = typename L::T;
  static_assert(L::kPlanes == 2 && L::G == 4, "");
  bf16* planes = static_cast<bf16*>(scratch);
  const size_t n = (size_t)4 * L::H * L::H;
  const cudaError_t err = rnn::split_planes(static_cast<const float*>(w_hh),
                                            planes, n, stream);
  if (err != cudaSuccess) return err;
  return rnn::launch<L>(
      lstm_fwd_stream_kernel<L>, B, stream, static_cast<const T*>(x_proj),
      static_cast<const bf16*>(planes), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(ys), static_cast<T*>(hT),
      static_cast<T*>(cT), gates, cs, planes + 2 * n, B, n_steps);
}

int launch_cluster(const void* x_proj, const void* w_hh, const void* h0,
                   const void* c0, void* ys, void* hT, void* cT,
                   float* gates, float* cs, void* scratch, int B,
                   int n_steps, int H, int dtype, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  with_layout(H, dtype, [&](auto l) {
    using L = decltype(l);
    using T = typename L::T;
    if constexpr (std::is_same<L, Fwd768F>::value)
      err = launch_stream<L>(x_proj, w_hh, h0, c0, ys, hT, cT, gates, cs,
                             scratch, B, n_steps, stream);
    else
      err = rnn::launch_fwd<L, Cell<T>>(
          params<T>(x_proj, h0, c0, ys, hT, cT, gates, cs), w_hh, scratch, B,
          n_steps, stream);
  });
  return (int)err;
}

// ---- the grid body (csrc/rnn_grid.cuh) --------------------------------------

template <typename T>
int launch_grid(const void* x_proj, const void* w_hh, const void* h0,
                const void* c0, void* ys, void* hT, void* cT, float* gates,
                float* cs, void* scratch, unsigned* bar, int B, int n_steps,
                int H, cudaStream_t stream) {
  return cpc::grid::run_fwd<Cell<T>>(
      params<T>(x_proj, h0, c0, ys, hT, cT, gates, cs), w_hh, scratch, bar,
      B, n_steps, H, stream);
}

// The body at H in `dtype`: 1 the cluster body, 2 the grid body (every H
// past 256 with no cluster body), 0 the rows body.
int body(int H, int dtype) {
  return cluster_body(H, dtype) ? 1 : H >= cpc::grid::kMinH ? 2 : 0;
}

int planes_of(int dtype) { return dtype == cpc::kFloat32 ? 2 : 1; }

}  // namespace

// The body cpc_lstm_fwd runs at hidden width H in `dtype`: 0 rows, 1
// cluster, 2 grid (ops/lstm.py `fwd_body`).
extern "C" int cpc_lstm_fwd_body(int H, int dtype) { return body(H, dtype); }

// Shared memory of a CTA of a grid body (K1 and K4: G gates; the forward,
// or with `backward` the reverse scan) at H in `dtype` on this device's
// SMs (ops/lstm.py `grid_smem`).
extern "C" size_t cpc_rnn_grid_smem(int H, int G, int dtype, int backward) {
  return cpc::grid::smem_bytes(backward != 0, H, G, planes_of(dtype));
}

// The cluster body's shared memory a CTA at H in `dtype` (0: none).
extern "C" size_t cpc_lstm_fwd_smem(int H, int dtype) {
  return cluster_smem(H, dtype);
}

// Bytes of global scratch cpc_lstm_fwd needs at (B, H, dtype): the
// cluster body's exchange blocks, the grid body's exchange buffer (and in
// float32 W_hh's bf16 planes, for both), 0 for the rows body.
extern "C" size_t cpc_lstm_fwd_scratch(int B, int H, int dtype) {
  switch (body(H, dtype)) {
    case 1: {
      size_t n = 0;
      with_layout(H, dtype,
                  [&](auto l) { n = decltype(l)::scratch(B); });
      return n;
    }
    case 2:
      return cpc::grid::scratch_bytes(false, B, H, 4, planes_of(dtype));
    default:
      return 0;
  }
}

// scratch: cpc_lstm_fwd_scratch bytes (16-byte aligned; null where 0);
// barrier: the grid body's barrier word, zero before its first launch
// and left so (null for the other bodies).  A cluster the card refuses
// returns its error; no other body runs instead.
extern "C" int cpc_lstm_fwd(const void* x_proj, const void* w_hh,
                            const void* h0, const void* c0, void* ys,
                            void* hT, void* cT, void* gates, void* cs,
                            void* scratch, void* barrier, int B, int n_steps,
                            int H, int dtype, void* stream) {
  if (H <= 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gates);
  float* c = static_cast<float*>(cs);
  switch (body(H, dtype)) {
    case 1:
      return launch_cluster(x_proj, w_hh, h0, c0, ys, hT, cT, g, c, scratch,
                            B, n_steps, H, dtype, s);
    case 2: {
      unsigned* bar = static_cast<unsigned*>(barrier);
      if (bar == nullptr) return (int)cudaErrorInvalidValue;
      if (dtype == cpc::kBFloat16)
        return launch_grid<__nv_bfloat16>(x_proj, w_hh, h0, c0, ys, hT, cT,
                                          g, c, scratch, bar, B, n_steps, H,
                                          s);
      if (dtype == cpc::kFloat32)
        return launch_grid<float>(x_proj, w_hh, h0, c0, ys, hT, cT, g, c,
                                  scratch, bar, B, n_steps, H, s);
      return (int)cudaErrorInvalidValue;
    }
  }
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
