// K6, the prediction heads' whole attention block, composed from the
// port's two tensor-core bodies: its GEMMs on csrc/gemm_tc.cuh (mma.sync
// with a cp.async ring, fused epilogues) and its attention through K2's
// tensor-core body (csrc/relpos_attention_tc_{fwd,bwd}.cu, reached
// through K2's C entry points, so that K2's Python launch counts do not
// move).  Shared by csrc/attention_block_fwd.cu and
// csrc/attention_block_bwd.cu.
//
// The GEMMs, each one launch over every head stack k (and every weight):
//   Proj  [q | k | v][k] = round(c . [Wq | Wk | Wv][k])   (M x D, depth D)
//   Out   x[k] = round(c + round(y[k] . Wo[k]))          (M x D, depth D)
//   Dy    dy[k] = round(dout[k] . Wo[k]^T)                (M x D, depth D)
//   Dcp   dcp[k] = round(dq . Wq^T + dk . Wk^T + dv . Wv^T)[k]
//                                                  (M x D, depth 3 D)
//   DW    dWq|dWk|dWv[k] = c^T . dq|dk|dv[k],  dWo[k] = y[k]^T . dout[k]
//                                             (D x D, depth M, float32)
// round() is the rounding to the input dtype E (the identity in float32),
// where the Pallas kernels cast (`_dot_cast`).  Every output sums its
// depth in one fixed order (Dcp walks dq . Wq^T, dk . Wk^T, dv . Wv^T one
// after another into the same sums and rounds once): no split-K, no
// atomics, bit-identical reruns.
//
// Float32 operands travel as three bf16 planes each, split once a call
// (`split_kernel`), and each product sums split products of them
// (gemm_tc.cuh): 6 in Proj, Out, Dy and DW (float32's own 2^-24 of
// |a||b| a term), 3 in Dcp.  The counts were chosen on the CPU emulation,
// ops/attention_block.py `attention_block_split` /
// `attention_block_bwd_split`: with 3 in Proj and Out the forward's error
// is 0.8-0.9 of the card tests' float32 tolerance (2e-5 + 2e-5 |x|), with
// 6 under 0.1; with 3 in Dy and DW dWq's error is 1.3e-5 of its norm
// against float64, with 6 7.5e-6, the rest K2's backward (3 split
// products); Dcp at 3 puts dc at 5e-6.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "scratch.cuh"

// K2's tensor-core entry points (csrc/relpos_attention_tc_{fwd,bwd}.cu).
extern "C" size_t cpc_relpos_attention_fwd_tc_scratch(int K, int n_batch,
                                                      int S, int nheads,
                                                      int dk, int dtype);
extern "C" int cpc_relpos_attention_fwd_tc(
    const void* q, const void* k, const void* v, const void* krel, void* out,
    void* scratch, int K, int n_batch, int S, int nheads, int dk,
    const void* seed, unsigned int threshold, float keep_scale, int dtype,
    void* stream);
extern "C" size_t cpc_relpos_attention_bwd_tc_scratch(int K, int n_batch,
                                                      int S, int nheads,
                                                      int dk, int dtype);
extern "C" int cpc_relpos_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* krel,
    const void* dout, void* dq, void* dk, void* dv, void* dkrel,
    void* scratch, int K, int n_batch, int S, int nheads, int dkh,
    const void* seed, unsigned int threshold, float keep_scale, int dtype,
    void* stream);

namespace cpc {
namespace k6 {

using bf16 = __nv_bfloat16;
namespace gm = cpc::gemm;

// bf16 planes of a float32 operand, and split products a GEMM (Dcp: kDcp).
template <class E>
struct Prec {
  static constexpr bool kF32 = std::is_same<E, float>::value;
  static constexpr int kPlanes = kF32 ? 3 : 1;
  static constexpr int kProducts = kF32 ? 6 : 1;
  static constexpr int kDcp = kF32 ? 3 : 1;
};

// The (M x D)-output GEMMs: 8 warps of 64 x 32; the weight gradients, D x
// D over a depth of M: 4 warps on 128 x 64 tiles, so that 384 blocks at
// the train shape (K 12, D 256) spread over the SMs.
using TileMD = gm::Tile<128, 128, 2, 4, 3, 32>;
using TileDW = gm::Tile<128, 64, 2, 2, 3, 32>;

// What the GEMMs read and write.  bf16 operands are the tensors
// themselves; float32 ones their planes (plane i `*_plane` elements past
// plane 0).  Every (K, M, D) operand's planes lie K M D apart.
struct Args {
  const bf16* c;        // (M, D)
  const bf16* w[4];     // Wq, Wk, Wv, Wo, (K, D, D) each
  const bf16* y;        // (K, M, D)
  const bf16* dout;     // (K, M, D)
  const bf16* g[3];     // dq, dk, dv, (K, M, D) each
  size_t c_plane, w_plane, kmd;
  const void* c_in;     // c in E, the residual
  void* out[3];         // Proj: q, k, v; Out: x; Dy: dy; Dcp: dcp (E)
  float* dw;            // DW: (4, K, D, D)
  int K, M, D;
};

using gm::store2;

template <class E>
__device__ __forceinline__ float2 load2(const E* p) {
  if constexpr (std::is_same<E, float>::value)
    return *reinterpret_cast<const float2*>(p);
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// round(acc) of a warp's fragment into out (rows x cols, row-major, ld
// cols), rows and columns past the matrix skipped; `add`, when given, is
// added after that rounding and the sum rounded again (Out's residual).
template <class T, class E>
__device__ __forceinline__ void store_rounded(E* out, const E* add, int rows,
                                              int cols,
                                              float (&acc)[T::MI][T::NI][4],
                                              const gm::Frag& f) {
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = f.col(ni);
        if (row >= rows || col >= cols) continue;
        const size_t at = (size_t)row * cols + col;
        float a = round_to<E>(acc[mi][ni][2 * hf]);
        float b = round_to<E>(acc[mi][ni][2 * hf + 1]);
        if (add != nullptr) {
          const float2 r = load2(add + at);
          a += r.x;
          b += r.y;
        }
        store2(out + at, a, b);
      }
    }
}

// Proj: z = which * K + k, which 0..2 for q, k, v.
template <class E>
struct Proj {
  using T = TileMD;
  static constexpr bool kAK = false, kBN = false;
  static constexpr int kP = Prec<E>::kProducts, kSums = 1, kZ = 3;
  static constexpr int kRows = 0;   // rows: M
  __device__ static gm::Problem problem(const Args& p, int z, int) {
    const int which = z / p.K, kk = z - which * p.K;
    return {{p.c, 0, p.D, p.c_plane},
            {p.w[which] + (size_t)kk * p.D * p.D, 0, p.D, p.w_plane},
            p.M, p.D, p.D};
  }
  __device__ static void epilogue(const Args& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int z) {
    const int which = z / p.K, kk = z - which * p.K;
    E* out = static_cast<E*>(p.out[which]) + (size_t)kk * p.M * p.D;
    store_rounded<T, E>(out, nullptr, p.M, p.D, acc, f);
  }
};

// Out: x[k] = round(c + round(y[k] . Wo[k])).
template <class E>
struct Out {
  using T = TileMD;
  static constexpr bool kAK = false, kBN = false;
  static constexpr int kP = Prec<E>::kProducts, kSums = 1, kZ = 1;
  static constexpr int kRows = 0;
  __device__ static gm::Problem problem(const Args& p, int kk, int) {
    return {{p.y + (size_t)kk * p.M * p.D, 0, p.D, p.kmd},
            {p.w[3] + (size_t)kk * p.D * p.D, 0, p.D, p.w_plane},
            p.M, p.D, p.D};
  }
  __device__ static void epilogue(const Args& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk) {
    E* out = static_cast<E*>(p.out[0]) + (size_t)kk * p.M * p.D;
    store_rounded<T, E>(out, static_cast<const E*>(p.c_in), p.M, p.D, acc,
                        f);
  }
};

// Dy: dy[k] = round(dout[k] . Wo[k]^T), Wo read n-major.
template <class E>
struct Dy {
  using T = TileMD;
  static constexpr bool kAK = false, kBN = true;
  static constexpr int kP = Prec<E>::kProducts, kSums = 1, kZ = 1;
  static constexpr int kRows = 0;
  __device__ static gm::Problem problem(const Args& p, int kk, int) {
    return {{p.dout + (size_t)kk * p.M * p.D, 0, p.D, p.kmd},
            {p.w[3] + (size_t)kk * p.D * p.D, 0, p.D, p.w_plane},
            p.M, p.D, p.D};
  }
  __device__ static void epilogue(const Args& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk) {
    E* out = static_cast<E*>(p.out[0]) + (size_t)kk * p.M * p.D;
    store_rounded<T, E>(out, nullptr, p.M, p.D, acc, f);
  }
};

// Dcp: dcp[k] = round(sum over s of g_s[k] . W_s[k]^T), s = q, k, v.
template <class E>
struct Dcp {
  using T = TileMD;
  static constexpr bool kAK = false, kBN = true;
  static constexpr int kP = Prec<E>::kDcp, kSums = 3, kZ = 1;
  static constexpr int kRows = 0;
  __device__ static gm::Problem problem(const Args& p, int kk, int s) {
    return {{p.g[s] + (size_t)kk * p.M * p.D, 0, p.D, p.kmd},
            {p.w[s] + (size_t)kk * p.D * p.D, 0, p.D, p.w_plane},
            p.M, p.D, p.D};
  }
  __device__ static void epilogue(const Args& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk) {
    E* out = static_cast<E*>(p.out[0]) + (size_t)kk * p.M * p.D;
    store_rounded<T, E>(out, nullptr, p.M, p.D, acc, f);
  }
};

// DW: z = which * K + k; which 0..2: c^T . g_which[k]; 3: y[k]^T . dout[k]
// (A read k-major), float32 out.
template <class E>
struct DW {
  using T = TileDW;
  static constexpr bool kAK = true, kBN = false;
  static constexpr int kP = Prec<E>::kProducts, kSums = 1, kZ = 4;
  static constexpr int kRows = 1;   // rows: D
  __device__ static gm::Problem problem(const Args& p, int z, int) {
    const int which = z / p.K, kk = z - which * p.K;
    const size_t off = (size_t)kk * p.M * p.D;
    const gm::Operand a = which < 3 ? gm::Operand{p.c, 0, p.D, p.c_plane}
                                    : gm::Operand{p.y + off, 0, p.D, p.kmd};
    const bf16* b = which < 3 ? p.g[which] : p.dout;
    return {a, {b + off, 0, p.D, p.kmd}, p.D, p.D, p.M};
  }
  __device__ static void epilogue(const Args& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int z) {
    float* out = p.dw + (size_t)z * p.D * p.D;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int col = f.col(ni);
          if (row < p.D && col < p.D)
            *reinterpret_cast<float2*>(out + (size_t)row * p.D + col) =
                make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
        }
      }
  }
};

// One output tile of use U a block; blockIdx.z the head stack (and which).
template <class U>
__global__ void __launch_bounds__(U::T::kThreads, U::T::kMinBlocks)
    gemm_kernel(const Args p) {
  using T = typename U::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int z = blockIdx.z;
  float acc[T::MI][T::NI][4];
#pragma unroll 1
  for (int s = 0; s < U::kSums; ++s)
    gm::mainloop<T, U::kAK, U::kBN, U::kP>(acc, U::problem(p, z, s), 0, m0,
                                           n0, smem, s == 0);
  U::epilogue(p, acc, gm::frag<T>(m0, n0), z);
}

template <class U>
cudaError_t run(const Args& p, cudaStream_t stream) {
  using T = typename U::T;
  constexpr size_t smem = gm::ring_bytes<T, U::kAK, U::kBN>();
  auto kernel = gemm_kernel<U>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = U::kRows ? p.D : p.M;
  const dim3 grid((p.D + T::BN - 1) / T::BN, (rows + T::BM - 1) / T::BM,
                  U::kZ * p.K);
  kernel<<<grid, T::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Up to 8 float32 tensors of n elements (n even) into three bf16 planes
// each, n elements apart: plane i the rounding of what the planes before
// it left (the three hold the value exactly).  blockIdx.y: the tensor.
struct SplitJobs {
  const float* src[8];
  bf16* dst[8];
  size_t n[8];
};

static __global__ void __launch_bounds__(256)
    split_kernel(const SplitJobs jobs) {
  const int j = blockIdx.y;
  const float* src = jobs.src[j];
  bf16* dst = jobs.dst[j];
  const size_t n = jobs.n[j], pairs = n / 2;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    float2 v = *reinterpret_cast<const float2*>(src + 2 * i);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(dst + p * n + 2 * i) = h;
      v.x -= __low2float(h);
      v.y -= __high2float(h);
    }
  }
}

// Launches split_kernel over the jobs[0 .. count).
inline cudaError_t split(const SplitJobs& jobs, int count,
                         cudaStream_t stream) {
  size_t most = 0;
  for (int j = 0; j < count; ++j) most = jobs.n[j] > most ? jobs.n[j] : most;
  size_t blocks = (most / 2 + 255) / 256;
  blocks = blocks < 1 ? 1 : blocks > 2048 ? 2048 : blocks;
  split_kernel<<<dim3((unsigned)blocks, count), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// The shapes the body takes: K2's tensor-core body at every S <= 1024
// (dk <= 256), and the GEMMs' at any M; dk a multiple of 16 and D a
// multiple of 64 up to 256 are the heads' gate's (ops/attention_block.py
// `attention_block_supported`, the JAX package's).
inline bool takes(int K, int n_batch, int S, int nheads, int dk) {
  const int D = nheads * dk;
  return K > 0 && n_batch > 0 && nheads > 0 && dk > 0 && S > 0 &&
         S <= 1024 && dk % 16 == 0 && D % 64 == 0 && D <= 256;
}

}  // namespace k6
}  // namespace cpc
