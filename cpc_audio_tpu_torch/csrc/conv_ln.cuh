// K7, one fused encoder layer (strided conv -> bias -> ChannelNorm ->
// ReLU), on the port's tensor-core GEMM core (csrc/gemm_tc.cuh: mma.sync
// with a cp.async ring).  Shared by csrc/conv_ln_fwd.cu and
// csrc/conv_ln_bwd.cu.
//
// Layout: x (B, T, C) channels-last, the conv weight w (2 s C, C)
// tap-major (the JAX WIO kernel reshaped), kernel = 2 s.  With the zero
// padding applied by index, output frame t of batch row b reads the padded
// rows t s .. t s + 2 s - 1: one contiguous run of 2 s C elements of x,
// starting p C elements before x[b][t s].  So the conv is an implicit
// GEMM with no gather, its A operand x itself read through a window
// (gemm_tc.cuh `Window`): row stride s C, offset -p C, and the padding a
// range check on the flat offset, 0 <= e < T C.  Every frame of every
// batch row is one row of A (the batches stacked), so ragged frame counts
// waste no tile.
//
// The GEMMs, each one launch:
//   Fwd  h = A . w + bias, ChannelNorm (ddof = 1, eps on the variance),
//        out = round(relu(yn nw + nb)); a row tile holds every channel
//        (BN = 256 >= C), so the norm's statistics are row sums over the
//        block (gm::row_sums), and yn (float32) and 1 / std are kept for
//        the backward.                        (B out_t x C, depth 2 s C)
//   Dx   the padded input's block rows u (s rows each, n_u a batch row):
//        dxb[u] = dh[u] . W_top^T + dh[u - 1] . W_bottom^T, the two depth
//        segments walked into one set of sums; dh read through a window
//        (offset 0, then -C), the rows stored where they are real rows
//        of x.                                (B n_u x s C, depth 2 C)
//   DW   dW = A^T . dh, A read k-major through the same window, the
//        frames split into contiguous ranges, one float32 part each,
//        summed in a fixed order (cpc::sum_parts).
//                                             (2 s C x C, depth B out_t)
// and the backward's rows pass (`rows_kernel`, not a GEMM): from the
// forward's yn and 1 / std, dh = round((g - mean(g) - yn C/(C-1)
// mean(g yn)) / std) with g = dy [yn nw + nb > 0] nw, and per-block parts
// of db, dnw, dnb.  Every sum has one fixed order: bit-identical reruns.
//
// Float32 operands travel as bf16 planes (`split_kernel`, a pass of its
// own): the forward's conv as 6 split products (three planes of x and
// w), dx and dW as 3 (two planes of x, w and dh).  The counts were chosen
// on the CPU emulation, ops/conv_ln.py `conv_ln_split` /
// `conv_ln_bwd_split`: 3 in the forward leave ~2e-5 of max abs error
// against float64 (a tenth of chip_smoke's float32 tolerance), 6 ~2e-6;
// 3 in the backward leave ~4.5e-6 of each gradient's norm (a tolerance of
// 1e-3).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "scratch.cuh"

namespace cpc {
namespace conv_ln {

using bf16 = __nv_bfloat16;
namespace gm = cpc::gemm;

constexpr int kMaxC = 256;          // the forward's row tile: every channel
constexpr int kRowsBlock = 64;      // frames a block of the rows pass
constexpr int kTargetBlocks = 264;  // DW: about two blocks for each SM

// bf16 planes and split products of each GEMM by input dtype E.
template <class E>
struct Prec {
  static constexpr bool kF32 = std::is_same<E, float>::value;
  static constexpr int kFwd = kF32 ? 6 : 1;          // Fwd's products
  static constexpr int kBwd = kF32 ? 3 : 1;          // Dx's and DW's
  static constexpr int kPlanesFwd = kF32 ? 3 : 1;    // of x and w
  static constexpr int kPlanesBwd = kF32 ? 2 : 1;    // of x, w and dh
};

// The tiles, chosen by timing variants on an H100 (port_perf/k7_tiles.py,
// PERF.md): Fwd 8 warps of 64 x 32 over 64 frames by every channel (two
// blocks an SM, and 2-4x the blocks of a 128-frame tile at layers 2-4);
// Dx and DW 8 warps of 64 x 32 on 128 x 128 tiles with 64-deep slots.
using TileFwd = gm::Tile<64, 256, 1, 8>;
using TileDx = gm::Tile<128, 128, 2, 4, 3, 64>;
using TileDW = gm::Tile<128, 128, 2, 4, 3, 64>;
static_assert(TileFwd::BN >= kMaxC, "a row tile holds every channel");

// A layer's shape.
struct Geom {
  int B, T, C, s, p;
  int out_t;   // frames a batch row
  int n_u;     // block rows of the padded input that hold a real row
  int per;     // DW: frames a split (a multiple of the depth tile)
  int splits;  // DW: float32 parts of dW
};

inline Geom geom(int B, int T, int C, int s, int p) {
  Geom g{B, T, C, s, p, 0, 0, 0, 0};
  g.out_t = (T + 2 * p - 2 * s) / s + 1;
  g.n_u = (T - 1 + p) / s + 1;
  const int M = B * g.out_t;
  const int tiles = ((2 * s * C + TileDW::BM - 1) / TileDW::BM) *
                    ((C + TileDW::BN - 1) / TileDW::BN);
  const int want = (kTargetBlocks + tiles - 1) / tiles;
  int per = (M + want - 1) / want;
  per = (per + TileDW::BK - 1) / TileDW::BK * TileDW::BK;
  g.per = per;
  g.splits = (M + per - 1) / per;
  return g;
}

inline bool takes(int B, int T, int C, int s, int p) {
  return B > 0 && T > 0 && C % 64 == 0 && C > 0 && C <= kMaxC && s > 0 &&
         p >= 0 && T + 2 * p >= 2 * s;
}

// What the GEMMs read and write.  bf16 operands are the tensors
// themselves; float32 ones their planes (plane i `*_plane` elements past
// plane 0).
struct Args {
  Geom g;
  const bf16* x;          // (B, T, C)
  const bf16* w;          // (2 s C, C)
  const bf16* dh;         // (B out_t, C)
  size_t x_plane, w_plane, dh_plane;
  const float *bias, *nw, *nb;
  void* out;              // Fwd: out (B out_t, C); Dx: dx (B, T, C); in E
  float* yn;              // Fwd: (B out_t, C), for the backward
  float* inv;             // Fwd: (B out_t) 1 / std
  float* dw;              // DW: (splits, 2 s C, C) parts, or dW
  float eps;
};

using gm::store2;

// x read through the conv's window: frames stacked over the batch rows.
__device__ __forceinline__ gm::Window frames(const Geom& g, int row0) {
  gm::Window w;
  w.per = g.out_t;
  w.row0 = row0;
  w.off = -(long long)g.p * g.C;
  w.span = (long long)g.T * g.C;
  return w;
}

// ---- Fwd ---------------------------------------------------------------------

template <class E>
__global__ void __launch_bounds__(TileFwd::kThreads, TileFwd::kMinBlocks)
    fwd_kernel(const Args p) {
  using T = TileFwd;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom& g = p.g;
  const int C = g.C, M = g.B * g.out_t;
  const int m0 = blockIdx.x * T::BM;
  gm::Problem pr{{p.x, (size_t)g.T * C, g.s * C, p.x_plane},
                 {p.w, 0, C, p.w_plane},
                 M, C, 2 * g.s * C};
  pr.win = frames(g, 0);
  float acc[T::MI][T::NI][4];
  gm::mainloop<T, false, false, Prec<E>::kFwd, true>(acc, pr, 0, m0, 0,
                                                     smem);

  // h = acc + bias; the rows' mean, then their centred sum of squares
  const gm::Frag f = gm::frag<T>(m0, 0);
  float* red = reinterpret_cast<float*>(smem);
  float st[1][T::MI][2], mean[T::MI][2];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      st[0][mi][hf] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int c = f.col(ni);
        if (c < C) {
          float* a = &acc[mi][ni][2 * hf];
          a[0] += p.bias[c];
          a[1] += p.bias[c + 1];
          st[0][mi][hf] += a[0] + a[1];
        }
      }
    }
  gm::row_sums<T, 1>(st, f, red);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mean[mi][hf] = st[0][mi][hf] / C;
      st[0][mi][hf] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
        if (f.col(ni) < C) {
          const float d0 = acc[mi][ni][2 * hf] - mean[mi][hf];
          const float d1 = acc[mi][ni][2 * hf + 1] - mean[mi][hf];
          st[0][mi][hf] += d0 * d0 + d1 * d1;
        }
    }
  gm::row_sums<T, 1>(st, f, red);

  // yn = (h - mean) / sqrt(var + eps), var with ddof = 1
  E* out = static_cast<E*>(p.out);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
      if (row >= M) continue;
      const float inv = rsqrtf(st[0][mi][hf] / (C - 1) + p.eps);
      if (f.t == 0 && f.wn == 0) p.inv[row] = inv;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int c = f.col(ni);
        if (c >= C) continue;
        const float y0 = (acc[mi][ni][2 * hf] - mean[mi][hf]) * inv;
        const float y1 = (acc[mi][ni][2 * hf + 1] - mean[mi][hf]) * inv;
        const size_t at = (size_t)row * C + c;
        *reinterpret_cast<float2*>(p.yn + at) = make_float2(y0, y1);
        store2(out + at, fmaxf(__fmaf_rn(y0, p.nw[c], p.nb[c]), 0.0f),
               fmaxf(__fmaf_rn(y1, p.nw[c + 1], p.nb[c + 1]), 0.0f));
      }
    }
}

// ---- the backward's rows pass ------------------------------------------------

// One block of 8 warps per kRowsBlock frames, a warp per R frames at a
// time, a lane per channel c = lane + 32 j: every load of the R frames
// (yn, dy, 1 / std) is issued before any of them is used, so a frame
// costs the warp a fraction of one round trip to memory and not two in a
// row.  dh goes into its NP bf16 planes (NP = 1: dh in bf16 itself), and
// the block's part (3, C) of (db, dnw, dnb) is its warps' sums added in a
// fixed order.
template <class E, int NP>
__global__ void __launch_bounds__(256)
    rows_kernel(const float* __restrict__ yn, const float* __restrict__ inv,
                const E* __restrict__ dy, const float* __restrict__ nw,
                const float* __restrict__ nb, bf16* __restrict__ dh,
                size_t dh_plane, float* __restrict__ vpart, int M, int C) {
  constexpr int J = kMaxC / 32, W = 8, R = 2;
  __shared__ float red[W][3][kMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w_[J], b_[J], sdb[J], sdnw[J], sdnb[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    w_[j] = c < C ? nw[c] : 0.0f;
    b_[j] = c < C ? nb[c] : 0.0f;
    sdb[j] = sdnw[j] = sdnb[j] = 0.0f;
  }
  const int r0 = blockIdx.x * kRowsBlock;
  const int r1 = min(M, r0 + kRowsBlock);
  for (int rb = r0 + warp * R; rb < r1; rb += W * R) {
    float y[R][J], d[R][J], iv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = rb + q;
      iv[q] = r < r1 ? inv[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        const bool ok = r < r1 && c < C;
        y[q][j] = ok ? yn[(size_t)r * C + c] : 0.0f;
        d[q][j] = ok ? to_f32(dy[(size_t)r * C + c]) : 0.0f;
      }
    }
    float m1[R], m2[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!(__fmaf_rn(y[q][j], w_[j], b_[j]) > 0.0f)) d[q][j] = 0.0f;
        const float gj = d[q][j] * w_[j];
        s1 += gj;
        s2 += gj * y[q][j];
      }
      m1[q] = s1;
      m2[q] = s2;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m1[q] = warp_sum(m1[q]) / C;
      m2[q] = warp_sum(m2[q]) / C * (C / (C - 1.0f));
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = rb + q;
      if (r >= r1) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c >= C) continue;
        const float v = round_to<E>(
            (d[q][j] * w_[j] - m1[q] - y[q][j] * m2[q]) * iv[q]);
        float rest = v;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const bf16 h = __float2bfloat16(rest);
          dh[k * dh_plane + (size_t)r * C + c] = h;
          rest -= __bfloat162float(h);
        }
        sdb[j] += v;
        sdnw[j] += d[q][j] * y[q][j];
        sdnb[j] += d[q][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      red[warp][0][c] = sdb[j];
      red[warp][1][c] = sdnw[j];
      red[warp][2][c] = sdnb[j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += blockDim.x) {
    const int k = e / C, c = e - k * C;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += red[w][k][c];
    vpart[(size_t)blockIdx.x * 3 * C + e] = s;
  }
}

// ---- Dx ----------------------------------------------------------------------

template <class E>
__global__ void __launch_bounds__(TileDx::kThreads, TileDx::kMinBlocks)
    dx_kernel(const Args p) {
  using T = TileDx;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom& g = p.g;
  const int C = g.C, sC = g.s * C, rows = g.B * g.n_u;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[T::MI][T::NI][4];
  // segment 0: dh[u] . W_top^T; 1: dh[u - 1] . W_bottom^T
#pragma unroll 1
  for (int seg = 0; seg < 2; ++seg) {
    gm::Problem pr{{p.dh, (size_t)g.out_t * C, C, p.dh_plane},
                   {p.w + (size_t)seg * sC * C, 0, C, p.w_plane},
                   rows, sC, C};
    pr.win.per = g.n_u;
    pr.win.off = -(long long)seg * C;
    pr.win.span = (long long)g.out_t * C;
    gm::mainloop<T, false, true, Prec<E>::kBwd, true>(acc, pr, 0, m0, n0,
                                                      smem, seg == 0);
  }
  // padded row u s + col / C is x's row u s + col / C - p
  const gm::Frag f = gm::frag<T>(m0, n0);
  const long long TC = (long long)g.T * C;
  E* dx = static_cast<E*>(p.out);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
      if (row >= rows) continue;
      const int b = row / g.n_u, u = row - b * g.n_u;
      E* xb = dx + (size_t)b * TC;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = f.col(ni);
        const long long e = (long long)u * sC + col - (long long)g.p * C;
        if (col < sC && e >= 0 && e < TC)
          store2(xb + e, acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    }
}

// ---- DW ----------------------------------------------------------------------

// blockIdx.z: the split, frames [z per, (z + 1) per) of the stacked B out_t.
template <class E>
__global__ void __launch_bounds__(TileDW::kThreads, TileDW::kMinBlocks)
    dw_kernel(const Args p) {
  using T = TileDW;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom& g = p.g;
  const int C = g.C, sC = g.s * C, M = g.B * g.out_t;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int g0 = blockIdx.z * g.per;
  gm::Problem pr{{p.x, (size_t)g.T * C, sC, p.x_plane},
                 {p.dh + (size_t)g0 * C, 0, C, p.dh_plane},
                 2 * sC, C, min(g.per, M - g0)};
  pr.win = frames(g, g0);
  float acc[T::MI][T::NI][4];
  gm::mainloop<T, true, false, Prec<E>::kBwd, true>(acc, pr, 0, m0, n0,
                                                    smem);
  const gm::Frag f = gm::frag<T>(m0, n0);
  float* out = p.dw + (size_t)blockIdx.z * 2 * sC * C;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = f.col(ni);
        if (row < 2 * sC && col < C)
          *reinterpret_cast<float2*>(out + (size_t)row * C + col) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    }
}

// ---- launches ----------------------------------------------------------------

template <class T, class Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const Args& p, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class E>
cudaError_t run_fwd(const Args& p, cudaStream_t stream) {
  using T = TileFwd;
  const int M = p.g.B * p.g.out_t;
  return launch<T>(fwd_kernel<E>, dim3((M + T::BM - 1) / T::BM), p,
                   gm::ring_bytes<T, false, false>(), stream);
}

template <class E>
cudaError_t run_dx(const Args& p, cudaStream_t stream) {
  using T = TileDx;
  const int rows = p.g.B * p.g.n_u, sC = p.g.s * p.g.C;
  return launch<T>(dx_kernel<E>,
                   dim3((sC + T::BN - 1) / T::BN, (rows + T::BM - 1) / T::BM),
                   p, gm::ring_bytes<T, false, true>(), stream);
}

template <class E>
cudaError_t run_dw(const Args& p, cudaStream_t stream) {
  using T = TileDW;
  const int sC = p.g.s * p.g.C;
  return launch<T>(dw_kernel<E>,
                   dim3((p.g.C + T::BN - 1) / T::BN,
                        (2 * sC + T::BM - 1) / T::BM, p.g.splits),
                   p, gm::ring_bytes<T, true, false>(), stream);
}

template <class E, int NP>
cudaError_t run_rows(const float* yn, const float* inv, const E* dy,
                     const float* nw, const float* nb, bf16* dh,
                     size_t dh_plane, float* vpart, int M, int C,
                     cudaStream_t stream) {
  rows_kernel<E, NP><<<(M + kRowsBlock - 1) / kRowsBlock, 256, 0, stream>>>(
      yn, inv, dy, nw, nb, dh, dh_plane, vpart, M, C);
  return cudaGetLastError();
}

// Float32 tensors into NP bf16 planes each, n elements apart: plane i the
// rounding of what the planes before it left.  blockIdx.y: the tensor;
// n a multiple of 4.
struct SplitJobs {
  const float* src[2];
  bf16* dst[2];
  size_t n[2];
};

template <int NP>
__global__ void __launch_bounds__(256) split_kernel(const SplitJobs jobs) {
  const int j = blockIdx.y;
  const float* src = jobs.src[j];
  bf16* dst = jobs.dst[j];
  const size_t n = jobs.n[j];
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(src)[i];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      reinterpret_cast<uint2*>(dst + q * n)[i] = packed;
      v.x -= __low2float(lo);
      v.y -= __high2float(lo);
      v.z -= __low2float(hi);
      v.w -= __high2float(hi);
    }
  }
}

template <int NP>
cudaError_t split(const SplitJobs& jobs, int count, cudaStream_t stream) {
  size_t most = 0;
  for (int j = 0; j < count; ++j) most = jobs.n[j] > most ? jobs.n[j] : most;
  size_t blocks = (most / 4 + 255) / 256;
  blocks = blocks < 1 ? 1 : blocks > 4096 ? 4096 : blocks;
  split_kernel<NP><<<dim3((unsigned)blocks, count), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace conv_ln
}  // namespace cpc
