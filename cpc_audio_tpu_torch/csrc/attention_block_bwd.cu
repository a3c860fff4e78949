// K6 backward: the prediction heads' whole attention block.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_block_bwd_kernel`
// (called through `_fb_bwd`).  With dx the cotangent of x[k] and the
// forward recomputed (q, k, v = round(c . W*[k])):
//   dy        = round(dx . Wo[k]^T)
//   dq, dk, dv, y, dkrel: the attention backward of relpos_attention.cuh
//   dWq[k] = c^T . dq,  dWk[k] = c^T . dk,  dWv[k] = c^T . dv,
//   dWo[k] = y^T . dx                       (float32, summed over rows)
//   dcp[k] = round(dq . Wq[k]^T + dk . Wk[k]^T + dv . Wv[k]^T)
// The caller forms dc = sum_k (dcp[k] + dx[k]), the JAX package's own
// epilogue outside its kernel.
//
// Design.  The Pallas kernel adds the dW blocks across a sequential grid
// axis; a GPU grid has none, and float atomics would make the result
// depend on the launch order.  So the backward is a rows pass and two
// products, each writing its outputs whole, as K3's backward does:
//   1. heads: one block per (head h, batch row b, k) projects [q | k | v]
//      and dy's dk columns of the head (tile_mm.cuh), runs the attention
//      backward of K2 (relpos_attention.cuh) and writes dq, dk, dv and y
//      (K, M, D) in T to scratch, and its dkrel part (dk, S);
//   2. the dkrel parts are summed over (b, h) in a fixed order;
//   3. dw: one block per (32 rows of dW, which of the four, k) contracts
//      over all M rows: c^T . dq|dk|dv and y^T . dx, written whole;
//   4. dcp: one block per (64 rows, k) contracts [dq | dk | dv] (64, 3D)
//      with [Wq; Wk; Wv]^T.
// q, k, v and dy stay on chip; dq, dk, dv and y make one round trip
// through device memory (4 x 23 MB in bf16 at the train shapes), as the
// Pallas kernel's VMEM could hold them and 227 KB cannot.
//
// What bounds it on an H100: ≈ 80 GFLOP at the train shapes (K = 12,
// M = 3712, D = 256), 0.08 ms at the bf16 peak, against ≈ 300 MB of device
// memory including the scratch (0.09 ms).  Pass 1 holds one block per SM
// (≈ 190 KB of shared memory) with its phases serialised.
#include <mma.h>

#include "attention_block.cuh"

namespace {

using cpc::bf16;
constexpr int kThreads = 512;
constexpr int KC = 64;        // contraction chunk
constexpr int kPad = 8;       // row padding of staged tiles (16 B in bf16)
constexpr int kRowsW = 32;    // dW rows a block
constexpr int kRowsC = 64;    // dcp rows a block

// ---- 1. heads --------------------------------------------------------------

template <typename T>
struct HeadsSmem {
  float *qs, *dos, *ks, *vs, *krT;   // attention operands, float32
  float *DS, *PD;                     // (S, S) tiles of the backward
  T *a, *bw;                          // projection chunks (union with DS, PD)
  float* cp;                          // projection result (SP, 3 dk)
  int SP, lda, ldb, ldbt, ldc;
  size_t bytes;
  __host__ __device__ HeadsSmem(void* base, int S, int dk)
      : SP((S + 15) / 16 * 16), lda(KC + kPad), ldb(3 * dk + kPad),
        ldbt(KC + kPad), ldc(3 * dk + 4) {
    cpc::Carve cv(base);
    qs = cv.take<float>((size_t)S * dk);
    dos = cv.take<float>((size_t)S * dk);
    ks = cv.take<float>((size_t)S * (dk + 1));
    vs = cv.take<float>((size_t)S * (dk + 1));
    krT = cv.take<float>((size_t)S * (dk + 1));
    const size_t mark = cv.off;
    DS = cv.take<float>((size_t)S * S);
    PD = cv.take<float>((size_t)S * S);
    cv.reset(mark);
    a = cv.take<T>((size_t)SP * lda);
    const size_t nb = (size_t)KC * ldb > (size_t)dk * ldbt ? (size_t)KC * ldb
                                                           : (size_t)dk * ldbt;
    bw = cv.take<T>(nb);
    cp = cv.take<float>((size_t)SP * ldc);
    bytes = cv.bytes();
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_block_bwd_heads_kernel(
    const T* __restrict__ c, const T* __restrict__ wq,
    const T* __restrict__ wk, const T* __restrict__ wv,
    const T* __restrict__ wo, const T* __restrict__ krel,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dkk,
    T* __restrict__ dv, T* __restrict__ y, float* __restrict__ part,
    int n_batch, int S, int nheads, int dk, float inv_sqrt,
    cpc::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadsSmem<T> L(smem, S, dk);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kk = blockIdx.z;
  const int tid = threadIdx.x;
  const int D = nheads * dk;
  const int n3 = 3 * dk;
  const int ldk = dk + 1;
  const size_t M = (size_t)n_batch * S;
  const T* cb = c + (size_t)b * S * D;
  const T* dxb = dout + ((size_t)kk * M + (size_t)b * S) * D;
  const size_t w_off = (size_t)kk * D * D;

  // ---- [q | k | v] of head h = c_b . W[:, h dk : (h+1) dk] ----
  cpc::ProjAcc<T> proj;
  proj.zero();
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();
    cpc::stage(L.a, L.lda, cb + k0, D, L.SP, KC, S);
    cpc::stage_qkv(L.bw, L.ldb, wq, wk, wv, w_off, D, dk, h, k0, KC);
    __syncthreads();
    proj.mma(L.a, L.lda, L.bw, L.ldb, L.SP, n3, KC);
  }
  proj.store(L.cp, L.ldc, L.SP, n3);
  __syncthreads();
  for (int idx = tid; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    const float* row = L.cp + i * L.ldc;
    L.qs[i * dk + d] = cpc::round_to<T>(row[d]);
    L.ks[i * ldk + d] = cpc::round_to<T>(row[dk + d]);
    L.vs[i * ldk + d] = cpc::round_to<T>(row[2 * dk + d]);
  }

  // ---- dy's columns of head h = dx_kb . (Wo[k][h dk : (h+1) dk, :])^T ----
  proj.zero();
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();
    cpc::stage(L.a, L.lda, dxb + k0, D, L.SP, KC, S);
    cpc::stage(L.bw, L.ldbt, wo + w_off + (size_t)h * dk * D + k0, D, dk, KC,
               dk);
    __syncthreads();
    proj.template mma<false, true>(L.a, L.lda, L.bw, L.ldbt, L.SP, dk,
                                   KC);
  }
  proj.store(L.cp, L.ldc, L.SP, dk);
  __syncthreads();
  for (int idx = tid; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    L.dos[i * dk + d] = cpc::round_to<T>(L.cp[i * L.ldc + d]);
  }
  const T* kr_g = krel + (size_t)kk * dk * S;
  for (int idx = tid; idx < dk * S; idx += blockDim.x) {
    const int d = idx / S;
    const int r = idx - d * S;
    L.krT[r * ldk + d] = cpc::to_f32(kr_g[idx]);
  }
  __syncthreads();

  cpc::relpos_bwd_body<T, true>(
      L.qs, L.dos, L.ks, L.vs, L.krT, L.DS, L.PD, S, dk, inv_sqrt, drop,
      cpc::attention_row_key(drop, kk, n_batch, b, nheads, h), dq, dkk, dv, y,
      ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk, D,
      part + ((size_t)(kk * n_batch + b) * nheads + h) * dk * S);
}

// A block's dW (kRowsW, D) or dcp (kRowsC, D) tile in registers, D <= 256:
// at most 64 tiles of 16 x 16, 4 a warp.
template <typename T>
using ProdAcc = cpc::BlockAcc<T, 4>;

// ---- 3. dw -----------------------------------------------------------------

template <typename T>
struct ProdSmem {
  T *a, *b;
  float* cs;
  int lda, ldb, ldc;
  size_t bytes;
  // a (ra, ca), b (rb, cb) staged tiles; cs (rc, D) float32
  __host__ __device__ ProdSmem(void* base, int ra, int ca, int rb, int cb,
                               int rc, int D)
      : lda(ca + kPad), ldb(cb + kPad), ldc(D + 4) {
    cpc::Carve cv(base);
    a = cv.take<T>((size_t)ra * lda);
    b = cv.take<T>((size_t)rb * ldb);
    cs = cv.take<float>((size_t)rc * ldc);
    bytes = cv.bytes();
  }
};

template <typename T>
__host__ __device__ ProdSmem<T> dw_smem(void* base, int D) {
  // a: (KC rows of M, kRowsW columns of D); b: (KC rows of M, D)
  return ProdSmem<T>(base, KC, kRowsW, KC, D, kRowsW, D);
}

template <typename T>
__host__ __device__ ProdSmem<T> dcp_smem(void* base, int D) {
  // a: (kRowsC rows, KC of 3D); b: (D, KC), the weights' rows
  return ProdSmem<T>(base, kRowsC, KC, D, KC, kRowsC, D);
}

// dw[which][k][d0 : d0 + kRowsW, :] = A^T . B over the M rows, with
// (A, B) = (c, dq[k]), (c, dk[k]), (c, dv[k]), (y[k], dx[k]).
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_block_dw_kernel(
    const T* __restrict__ c, const T* __restrict__ dq,
    const T* __restrict__ dkk, const T* __restrict__ dv,
    const T* __restrict__ y, const T* __restrict__ dout,
    float* __restrict__ dw, int K, int M, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ProdSmem<T> L = dw_smem<T>(smem, D);
  const int d0 = blockIdx.x * kRowsW;
  const int which = blockIdx.y;
  const int kk = blockIdx.z;
  const size_t koff = (size_t)kk * M * D;
  const T* A = which == 3 ? y + koff : c;
  const T* B = (which == 0 ? dq : which == 1 ? dkk : which == 2 ? dv : dout) +
               koff;
  ProdAcc<T> acc;
  acc.zero();
  for (int m0 = 0; m0 < M; m0 += KC) {
    __syncthreads();
    cpc::stage(L.a, L.lda, A + (size_t)m0 * D + d0, D, KC, kRowsW, M - m0);
    cpc::stage(L.b, L.ldb, B + (size_t)m0 * D, D, KC, D, M - m0);
    __syncthreads();
    acc.template mma<true, false>(L.a, L.lda, L.b, L.ldb, kRowsW, D,
                                  KC);
  }
  acc.store(L.cs, L.ldc, kRowsW, D);
  __syncthreads();
  float* out = dw + ((size_t)which * K + kk) * D * D + (size_t)d0 * D;
  for (int idx = threadIdx.x; idx < kRowsW * D; idx += blockDim.x) {
    const int r = idx / D;
    out[idx] = L.cs[r * L.ldc + idx - r * D];
  }
}

// ---- 4. dcp ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_block_dcp_kernel(
    const T* __restrict__ dq, const T* __restrict__ dkk,
    const T* __restrict__ dv, const T* __restrict__ wq,
    const T* __restrict__ wk, const T* __restrict__ wv, T* __restrict__ dcp,
    int M, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ProdSmem<T> L = dcp_smem<T>(smem, D);
  const int r0 = blockIdx.x * kRowsC;
  const int kk = blockIdx.y;
  const size_t koff = (size_t)kk * M * D;
  ProdAcc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < 3 * D; k0 += KC) {
    const int which = k0 / D;
    const int kin = k0 - which * D;
    const T* A = which == 0 ? dq : (which == 1 ? dkk : dv);
    const T* W = which == 0 ? wq : (which == 1 ? wk : wv);
    __syncthreads();
    cpc::stage(L.a, L.lda, A + koff + (size_t)r0 * D + kin, D, kRowsC, KC,
               M - r0);
    cpc::stage(L.b, L.ldb, W + (size_t)kk * D * D + kin, D, D, KC, D);
    __syncthreads();
    acc.template mma<false, true>(L.a, L.lda, L.b, L.ldb, kRowsC, D,
                                  KC);
  }
  acc.store(L.cs, L.ldc, kRowsC, D);
  __syncthreads();
  const int rows = min(kRowsC, M - r0);
  T* out = dcp + koff + (size_t)r0 * D;
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D;
    out[idx] = cpc::from_f32<T>(L.cs[r * L.ldc + idx - r * D]);
  }
}

template <typename T>
size_t smem_bytes(int S, int nheads, int dk) {
  const int D = nheads * dk;
  size_t s = HeadsSmem<T>(nullptr, S, dk).bytes;
  const size_t w = dw_smem<T>(nullptr, D).bytes;
  const size_t p = dcp_smem<T>(nullptr, D).bytes;
  s = s > w ? s : w;
  return s > p ? s : p;
}

template <typename T>
int launch(const void* c, const void* wq, const void* wk, const void* wv,
           const void* wo, const void* krel, const void* dout, void* dq,
           void* dkk, void* dv, void* y, float* part, float* dkrel, float* dw,
           void* dcp, int K, int n_batch, int S, int nheads, int dk,
           cpc::Dropout drop, cudaStream_t stream) {
  const int D = nheads * dk;
  const int M = n_batch * S;
  const T* c_ = static_cast<const T*>(c);
  const T *wq_ = static_cast<const T*>(wq), *wk_ = static_cast<const T*>(wk),
          *wv_ = static_cast<const T*>(wv);
  T *dq_ = static_cast<T*>(dq), *dk_ = static_cast<T*>(dkk),
    *dv_ = static_cast<T*>(dv), *y_ = static_cast<T*>(y);

  const size_t heads_smem = HeadsSmem<T>(nullptr, S, dk).bytes;
  auto heads = attention_block_bwd_heads_kernel<T>;
  cudaError_t err = cpc::allow_smem(heads, heads_smem);
  if (err != cudaSuccess) return (int)err;
  heads<<<dim3(nheads, n_batch, K), kThreads, heads_smem, stream>>>(
      c_, wq_, wk_, wv_, static_cast<const T*>(wo),
      static_cast<const T*>(krel), static_cast<const T*>(dout), dq_, dk_, dv_,
      y_, part, n_batch, S, nheads, dk, 1.0f / sqrtf(static_cast<float>(dk)),
      drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cpc::sum_parts(part, dkrel, n_batch * nheads, dk * S, K, stream);
  if (err != cudaSuccess) return (int)err;

  const size_t dw_bytes = dw_smem<T>(nullptr, D).bytes;
  auto dwk = attention_block_dw_kernel<T>;
  err = cpc::allow_smem(dwk, dw_bytes);
  if (err != cudaSuccess) return (int)err;
  dwk<<<dim3(D / kRowsW, 4, K), kThreads, dw_bytes, stream>>>(
      c_, dq_, dk_, dv_, y_, static_cast<const T*>(dout), dw, K, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t dcp_bytes = dcp_smem<T>(nullptr, D).bytes;
  auto dcpk = attention_block_dcp_kernel<T>;
  err = cpc::allow_smem(dcpk, dcp_bytes);
  if (err != cudaSuccess) return (int)err;
  dcpk<<<dim3((M + kRowsC - 1) / kRowsC, K), kThreads, dcp_bytes, stream>>>(
      dq_, dk_, dv_, wq_, wk_, wv_, static_cast<T*>(dcp), M, D);
  return (int)cudaGetLastError();
}

bool supported(int S, int nheads, int dk) {
  const int D = nheads * dk;
  return S > 0 && dk % 16 == 0 && D % KC == 0 && D <= 256;
}

}  // namespace

// Shared memory the largest of the backward's blocks needs; the wrapper
// refuses shapes above the card's 227 KB.
extern "C" size_t cpc_attention_block_bwd_smem(int S, int nheads, int dk,
                                               int dtype) {
  return dtype == cpc::kBFloat16 ? smem_bytes<bf16>(S, nheads, dk)
                                 : smem_bytes<float>(S, nheads, dk);
}

// c (n_batch*S, D); wq, wk, wv, wo (K, D, D); krel (K, dk, S); dout, dcp
// and the scratch dq, dk, dv, y (K, n_batch*S, D); all in `dtype`.
// float32: part (K, n_batch*nheads, dk, S) scratch, dkrel (K, dk, S), dw
// (4, K, D, D) = dWq, dWk, dWv, dWo.  dk % 16 == 0, D % 64 == 0, D <= 256,
// and the inputs 16-byte aligned.
extern "C" int cpc_attention_block_bwd(
    const void* c, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* krel, const void* dout, void* dq, void* dk,
    void* dv, void* y, void* part, void* dkrel, void* dw, void* dcp, int K,
    int n_batch, int S, int nheads, int dkh, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  if (!supported(S, nheads, dkh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  float* p = static_cast<float*>(part);
  float* dr = static_cast<float*>(dkrel);
  float* w = static_cast<float*>(dw);
  if (dtype == cpc::kBFloat16)
    return launch<bf16>(c, wq, wk, wv, wo, krel, dout, dq, dk, dv, y, p, dr,
                        w, dcp, K, n_batch, S, nheads, dkh, drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(c, wq, wk, wv, wo, krel, dout, dq, dk, dv, y, p, dr,
                         w, dcp, K, n_batch, S, nheads, dkh, drop, s);
  return (int)cudaErrorInvalidValue;
}
