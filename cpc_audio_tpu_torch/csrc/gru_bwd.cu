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
// Three bodies, picked from the shape before launching (`body`), as K1's
// backward (csrc/lstm_bwd.cu): at H = 128 and 256 the cluster body
// (csrc/rnn_cluster.cuh; CTA c owns units [c H/8, (c+1) H/8), their 3 gate
// rows of W_hh and the carry dh * z of its units), past H 256 the grid
// body (csrc/rnn_grid.cuh, `GridCell`), at the other H the rows body:
// one block per batch row keeps the carry in shared memory for the
// whole window, and the serial product dh[j] = sum_r dgh[r] W_hh[r, j]
// over the 3H rows of W_hh in torch's (3H, H) layout needs no transpose:
// threads own pairs of adjacent columns (one 4- or 8-byte load per row, a
// warp reads a contiguous run of a row) and form groups that split the 3H
// rows; the partial sums meet in shared memory.  It re-reads W_hh (384 KB
// in bf16 at H = 256) from L2 every step, on B = 32 of the 132 SMs.
//
// What bounds it on an H100: the T = 128 dependent steps.  The bytes it
// must move (0.011 ms at B 32, T 128, H 256) ignore that chain; cuDNN's
// GRU backward, which also forms dx and dW, is its yardstick.
#include "rnn_grid.cuh"

namespace {

constexpr int kThreads = 1024;
// K1's bound (ops/lstm.py MAX_H), the widest H checked on the card.
constexpr int kMaxH = 8192;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- the cluster body ------------------------------------------------------

// A pair's residuals of one step: gates r, z, n and ghn (4 float2), h_prev
// and dys (two T each); each field an array over the CTA's pairs.
template <typename T>
constexpr int kSlot = 4 * (int)sizeof(float2) + 4 * (int)sizeof(T);

template <typename T, int J>
using ClusterLayout = cpc::rnn::Layout<T, 3, J, kSlot<T>>;

template <typename T, int J>
__global__ void __launch_bounds__(ClusterLayout<T, J>::kThreads, 1)
    gru_bwd_cluster_kernel(const float* __restrict__ gates,
                           const float* __restrict__ ghn,
                           const T* __restrict__ h0, const T* __restrict__ ys,
                           const T* __restrict__ dys,
                           const T* __restrict__ w_hh,
                           const float* __restrict__ dhT,
                           float* __restrict__ dx,
                           float* __restrict__ dghn_out,
                           float* __restrict__ dh0, int B, int n_steps) {
  namespace rnn = cpc::rnn;
  using L = ClusterLayout<T, J>;
  using T2 = typename rnn::Two<T>::type;
  constexpr int H = L::H, G = 3 * H, P = L::P;
  extern __shared__ __align__(16) unsigned char cluster_smem_buf[];
  unsigned char* smem = cluster_smem_buf;
  const int c = rnn::cluster_rank();
  const int b0 = blockIdx.y * rnn::kRows;
  const int tid = threadIdx.x;
  float2* dhz = reinterpret_cast<float2*>(smem + L::state);   // (P,) dh z
  auto slot_of = [&](int t) {
    return smem + L::ring + (t & 1) * L::slot_bytes;
  };
  // slot fields: gate q of pair p at [q * P + p], ghn at [3 P + p]; then
  // h_prev and dys
  auto gates_of = [&](int t) { return reinterpret_cast<float2*>(slot_of(t)); };
  auto hp_of = [&](int t) {
    return reinterpret_cast<T2*>(slot_of(t) + 4 * P * sizeof(float2));
  };
  auto prefetch = [&](int t) {
    float2* g = gates_of(t);
    T2* hp = hp_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) continue;
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        rnn::cp_async<8>(g + q * P + p, gates + bt * G + q * H + j);
      rnn::cp_async<8>(g + 3 * P + p, ghn + bt * H + j);
      rnn::copy_two<T>(hp + p, t > 0 ? ys + (bt - 1) * H + j
                                     : h0 + (size_t)b * H + j);
      rnn::copy_two<T>(hp + P + p, dys + bt * H + j);
    }
  };

  rnn::load_w<L>(reinterpret_cast<T*>(smem + L::w), w_hh, c);
  prefetch(n_steps - 1);
  cpc::mma::cp_async_commit();
  for (int p = tid; p < P; p += L::kThreads)
    dhz[p] = make_float2(0.0f, 0.0f);
  cpc::mma::cp_async_wait<0>();
  __syncthreads();
  rnn::cluster_sync();   // every CTA of the cluster runs before any push

  for (int t = n_steps - 1; t >= 0; --t) {
    if (t > 0) prefetch(t - 1);
    cpc::mma::cp_async_commit();
    cpc::mma::cp_async_wait<1>();   // this thread's copies of step t
    const float2* g = gates_of(t);
    const T2* hp = hp_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          rnn::put_a<L>(smem, pr.row, q, pr.unit, 0.0f, 0.0f);
        continue;
      }
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
      float2 carry;
      if (t == n_steps - 1) {
        carry = *reinterpret_cast<const float2*>(dhT + (size_t)b * H + j);
      } else {
        const float2 s = rnn::gather<L>(smem, (t + 1) & 1, pr.row, pr.unit);
        carry = make_float2(dhz[p].x + s.x, dhz[p].y + s.y);
      }
      const float2 r2 = g[p], z2 = g[P + p], n2 = g[2 * P + p],
                   gn2 = g[3 * P + p];
      const float2 hp2 = rnn::Two<T>::f32(hp[p]);
      const float2 dy2 = rnn::Two<T>::f32(hp[P + p]);
      float out[4][2];    // dr, dz, dn, dghn
      float2 dz2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r = e ? r2.y : r2.x, z = e ? z2.y : z2.x,
                    n = e ? n2.y : n2.x, gn = e ? gn2.y : gn2.x;
        const float dhj = (e ? dy2.y : dy2.x) + (e ? carry.y : carry.x);
        const float d_z = dhj * ((e ? hp2.y : hp2.x) - n) * z * (1.0f - z);
        const float d_n = dhj * (1.0f - z) * (1.0f - n * n);
        const float d_ghn = d_n * r;
        out[0][e] = d_n * gn * r * (1.0f - r);
        out[1][e] = d_z;
        out[2][e] = d_n;
        out[3][e] = d_ghn;
        (e ? dz2.y : dz2.x) = dhj * z;
      }
      dhz[p] = dz2;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<float2*>(dx + bt * G + q * H + j) =
            make_float2(out[q][0], out[q][1]);
      *reinterpret_cast<float2*>(dghn_out + bt * H + j) =
          make_float2(out[3][0], out[3][1]);
      // the rows of W_hh meet dgh = (dr, dz, dghn)
      rnn::put_a<L>(smem, pr.row, 0, pr.unit, out[0][0], out[0][1]);
      rnn::put_a<L>(smem, pr.row, 1, pr.unit, out[1][0], out[1][1]);
      rnn::put_a<L>(smem, pr.row, 2, pr.unit, out[3][0], out[3][1]);
    }
    __syncthreads();
    rnn::product_push<L>(smem, c, t & 1);
    rnn::cluster_sync();
  }
  for (int p = tid; p < P; p += L::kThreads) {
    const rnn::Pair<J> pr(p);
    const int b = b0 + pr.row;
    if (b >= B) continue;
    const float2 s = rnn::gather<L>(smem, 0, pr.row, pr.unit);
    *reinterpret_cast<float2*>(dh0 + (size_t)b * H + c * J + pr.unit) =
        make_float2(dhz[p].x + s.x, dhz[p].y + s.y);
  }
}

template <typename T>
size_t cluster_smem(int H) {
  return H == 128 ? ClusterLayout<T, 16>::bytes
                  : H == 256 ? ClusterLayout<T, 32>::bytes : 0;
}

// The cluster body takes H = 128 and 256, where its layout fits a CTA.
template <typename T>
bool cluster_body(int H) {
  const size_t smem = cluster_smem<T>(H);
  return smem > 0 && smem <= cpc::kSmemLimit;
}

template <typename T, int J>
int launch_cluster(const float* gates, const float* ghn, const void* h0,
                   const void* ys, const void* dys, const void* w_hh,
                   const float* dhT, float* dx, float* dghn, float* dh0,
                   int B, int n_steps, cudaStream_t stream) {
  return (int)cpc::rnn::launch<ClusterLayout<T, J>>(
      gru_bwd_cluster_kernel<T, J>, B, stream,
      gates, ghn, static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(dys), static_cast<const T*>(w_hh), dhT, dx, dghn,
      dh0, B, n_steps);
}

// ---- the rows body ---------------------------------------------------------

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
      const int pair = tid % n_pairs;
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

// ---- the grid body (csrc/rnn_grid.cuh) --------------------------------------

// A thread's pair of units (k, k + 1) of batch row b: dh z of the last
// step in registers.
template <typename T_>
struct GridCell {
  using T = T_;
  using T2 = typename cpc::rnn::Two<T>::type;
  static constexpr int G = 3;
  struct Params {
    const float* gates;
    const float* ghn;
    const T* h0;
    const T* ys;
    const T* dys;
    const float* dhT;
    float* dx;
    float* dghn;
    float* dh0;
  };
  struct State {
    float2 dhz;
  };
  struct Res {
    float2 g[4];     // r, z, n, gh_n
    T2 hp, dy;       // h_{t-1}, dys
  };
  static Params offset(Params p, const cpc::grid::Shape& s, int b0) {
    const size_t r = (size_t)b0 * s.H, rt = r * s.T;
    p.gates += 3 * rt;
    p.ghn += rt;
    p.h0 += r;
    p.ys += rt;
    p.dys += rt;
    p.dhT += r;
    p.dx += 3 * rt;
    p.dghn += rt;
    p.dh0 += r;
    return p;
  }
  __device__ static State init(const Params&, const cpc::grid::Shape&, int,
                               int, bool) {
    return {make_float2(0.0f, 0.0f)};
  }
  __device__ static Res load_res(const Params& p, const cpc::grid::Shape& s,
                                 int b, int k, int t, bool valid) {
    Res r;
    if (!valid) return r;
    const int H = s.H;
    const size_t bt = (size_t)b * s.T + t;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      r.g[q] = *reinterpret_cast<const float2*>(p.gates + bt * 3 * H +
                                                q * H + k);
    r.g[3] = *reinterpret_cast<const float2*>(p.ghn + bt * H + k);
    r.hp = *reinterpret_cast<const T2*>(
        t > 0 ? p.ys + (bt - 1) * H + k : p.h0 + (size_t)b * H + k);
    r.dy = *reinterpret_cast<const T2*>(p.dys + bt * H + k);
    return r;
  }
  __device__ static void step(const Params& p, const cpc::grid::Shape& s,
                              State& st, const Res& r, float2 gathered,
                              bool first, int b, int k, int t,
                              float (&dg)[3][2]) {
    const int H = s.H;
    const float2 carry =
        first ? gathered
              : make_float2(st.dhz.x + gathered.x, st.dhz.y + gathered.y);
    const float2 hp = cpc::rnn::Two<T>::f32(r.hp);
    const float2 dy = cpc::rnn::Two<T>::f32(r.dy);
    float out[3][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float rr = e ? r.g[0].y : r.g[0].x, z = e ? r.g[1].y : r.g[1].x,
                  n = e ? r.g[2].y : r.g[2].x, gn = e ? r.g[3].y : r.g[3].x;
      const float dhj = (e ? dy.y : dy.x) + (e ? carry.y : carry.x);
      const float d_z = dhj * ((e ? hp.y : hp.x) - n) * z * (1.0f - z);
      const float d_n = dhj * (1.0f - z) * (1.0f - n * n);
      const float d_ghn = d_n * rr;
      out[0][e] = d_n * gn * rr * (1.0f - rr);
      out[1][e] = d_z;
      out[2][e] = d_n;
      dg[0][e] = out[0][e];
      dg[1][e] = d_z;
      dg[2][e] = d_ghn;
      (e ? st.dhz.y : st.dhz.x) = dhj * z;
    }
    const size_t bt = (size_t)b * s.T + t;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<float2*>(p.dx + bt * 3 * H + q * H + k) =
          make_float2(out[q][0], out[q][1]);
    *reinterpret_cast<float2*>(p.dghn + bt * H + k) =
        make_float2(dg[2][0], dg[2][1]);
  }
  __device__ static void finish(const Params& p, const cpc::grid::Shape& s,
                                const State& st, float2 gathered, int b,
                                int k) {
    *reinterpret_cast<float2*>(p.dh0 + (size_t)b * s.H + k) =
        make_float2(st.dhz.x + gathered.x, st.dhz.y + gathered.y);
  }
};

// The body at H for T: 1 the cluster body, 2 the grid body (every H past
// 256), 0 the rows body.
template <typename T>
int body(int H) {
  return cluster_body<T>(H) ? 1 : H >= cpc::grid::kMinH ? 2 : 0;
}

template <typename T>
int launch_any(const float* gates, const float* ghn, const void* h0,
               const void* ys, const void* dys, const void* w_hh,
               const float* dhT, float* dx, float* dghn, float* dh0,
               void* scratch, unsigned* bar, int B, int n_steps, int H,
               cudaStream_t stream) {
  if (body<T>(H) == 2) {
    if (bar == nullptr) return (int)cudaErrorInvalidValue;
    typename GridCell<T>::Params p{
        gates, ghn, static_cast<const T*>(h0), static_cast<const T*>(ys),
        static_cast<const T*>(dys), dhT, dx, dghn, dh0};
    return cpc::grid::run_bwd<GridCell<T>>(p, w_hh, scratch, bar, B, n_steps,
                                           H, stream);
  }
  if (!cluster_body<T>(H))
    return launch<T>(gates, ghn, h0, ys, dys, w_hh, dhT, dx, dghn, dh0, B,
                     n_steps, H, stream);
  if (H == 128)
    return launch_cluster<T, 16>(gates, ghn, h0, ys, dys, w_hh, dhT, dx,
                                 dghn, dh0, B, n_steps, stream);
  return launch_cluster<T, 32>(gates, ghn, h0, ys, dys, w_hh, dhT, dx, dghn,
                               dh0, B, n_steps, stream);
}

}  // namespace

// The body cpc_gru_bwd runs at hidden width H in `dtype`: 0 rows, 1
// cluster, 2 grid (ops/gru.py `bwd_body`).
extern "C" int cpc_gru_bwd_body(int H, int dtype) {
  return dtype == cpc::kBFloat16 ? body<__nv_bfloat16>(H) : body<float>(H);
}

// Bytes of global scratch cpc_gru_bwd needs at (B, H, dtype): the grid
// body's receive blocks (and in float32 W_hh's bf16 planes), else 0.
extern "C" size_t cpc_gru_bwd_scratch(int B, int H, int dtype) {
  const bool f32 = dtype == cpc::kFloat32;
  return (f32 ? body<float>(H) : body<__nv_bfloat16>(H)) == 2
             ? cpc::grid::scratch_bytes(true, B, H, 3, f32 ? 2 : 1)
             : 0;
}

// gates (B, T, 3H), ghn (B, T, H), dhT (B, H) and the outputs dx
// (B, T, 3H), dghn (B, T, H) and dh0 (B, H) are float32; h0 (B, H), ys
// and dys (B, T, H) and w_hh (3H, H) are in `dtype`; scratch:
// cpc_gru_bwd_scratch bytes (null where 0); barrier: the grid body's
// barrier word (csrc/rnn_grid.cuh; null for the other bodies).
extern "C" int cpc_gru_bwd(const void* gates, const void* ghn, const void* h0,
                           const void* ys, const void* dys, const void* w_hh,
                           const void* dhT, void* dx, void* dghn, void* dh0,
                           void* scratch, void* barrier, int B, int n_steps,
                           int H, int dtype, void* stream) {
  if (H <= 0 || H % 32 != 0 || H > kMaxH)
    return (int)cudaErrorInvalidValue;
  unsigned* bar = static_cast<unsigned*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* n = static_cast<const float*>(ghn);
  const float* d = static_cast<const float*>(dhT);
  float* o_dx = static_cast<float*>(dx);
  float* o_dghn = static_cast<float*>(dghn);
  float* o_dh0 = static_cast<float*>(dh0);
  if (dtype == cpc::kBFloat16)
    return launch_any<__nv_bfloat16>(g, n, h0, ys, dys, w_hh, d, o_dx,
                                     o_dghn, o_dh0, scratch, bar, B, n_steps,
                                     H, s);
  if (dtype == cpc::kFloat32)
    return launch_any<float>(g, n, h0, ys, dys, w_hh, d, o_dx, o_dghn, o_dh0,
                             scratch, bar, B, n_steps, H, s);
  return (int)cudaErrorInvalidValue;
}
