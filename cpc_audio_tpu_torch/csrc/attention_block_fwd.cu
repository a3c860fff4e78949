// K6: the prediction heads' whole attention block, forward.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_block_fwd_kernel`
// (called through `fused_attention_block`).  For head stack k, with c the
// (n_batch*S, D) context and D = nheads*dk:
//   q = round(c . Wq[k]),  k = round(c . Wk[k]),  v = round(c . Wv[k])
//   y = the nheads causal Shaw attentions of relpos_attention.cuh, each
//       rounded to T
//   x[k] = round(c + round(y . Wo[k]))
// where round() is the rounding to T (the Pallas kernel's `_dot_cast`):
// products accumulate in float32.  q, k, v and y never reach device
// memory: that is the point of the block.
//
// Design: one block of 16 warps per (batch row b, k).  For each head h it
//   * projects [q | k | v] of the head, (S, 3 dk) = c_b . [Wq | Wk | Wv]
//     [:, h dk : (h+1) dk], streaming c_b and the weight columns through
//     shared memory in 64-wide chunks of D (tile_mm.cuh: tensor cores in
//     bf16, FMA in float32);
//   * runs the attention rows (relpos_attention.cuh) into an (S, dk) tile;
//   * adds that tile times the head's dk rows of Wo into the (S, D) output
//     accumulator, which lives in registers for the whole block (wmma
//     fragments in bf16, 64 floats a thread in float32), so y is never
//     stored anywhere.
// c is re-read from L2 per head (59 KB a head in bf16) instead of being
// kept: with it and y resident a float32 block would not fit in 227 KB.
// Rows are padded to a multiple of 16 for the tensor cores; the padding
// rows are zeros and are never written out.
//
// What bounds it on an H100: at the train shapes (K = 12, B = 32, S = 116,
// D = 256) the four projections are 23 GFLOP and the attention 5 GFLOP,
// 0.03 ms at the bf16 peak, against 22 MB of device memory (7 us).  This
// first version runs one block per SM (≈ 150 KB of shared memory) and
// serialises its phases, so the block's latency, not a roofline, sets its
// time.
#include <mma.h>

#include "attention_block.cuh"

namespace {

using cpc::bf16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 64;        // contraction chunk of the projections
constexpr int kPad = 8;       // row padding of staged tiles (16 B in bf16)
constexpr int kMaxTiles = 8;  // output accumulator tiles of 16 x 16 a warp

template <typename T>
struct FwdSmem {
  float *qs, *ks, *vs, *kr, *rows;  // attention operands, float32
  T *a, *bw;                         // projection chunks: c_b, weights
  float* cp;                         // projection result (SP, 3 dk)
  T *os, *wos;                       // head output (SP, dk), Wo rows (dk, D)
  float* scr;                        // epilogue: one 16 x 16 tile a warp
  int SP, lda, ldb, ldc, ldo, ldw;
  size_t bytes;
  __host__ __device__ FwdSmem(void* base, int S, int dk, int D)
      : SP((S + 15) / 16 * 16), lda(KC + kPad), ldb(3 * dk + kPad),
        ldc(3 * dk + 4), ldo(dk + kPad), ldw(D + kPad) {
    cpc::Carve cv(base);
    qs = cv.take<float>((size_t)S * dk);
    ks = cv.take<float>((size_t)S * (dk + 1));
    vs = cv.take<float>((size_t)S * dk);
    kr = cv.take<float>((size_t)dk * S);
    rows = cv.take<float>((size_t)kWarps * S);
    const size_t mark = cv.off;          // three phases share the rest
    a = cv.take<T>((size_t)SP * lda);
    bw = cv.take<T>((size_t)KC * ldb);
    cp = cv.take<float>((size_t)SP * ldc);
    cv.reset(mark);
    os = cv.take<T>((size_t)SP * ldo);
    wos = cv.take<T>((size_t)dk * ldw);
    cv.reset(mark);
    scr = cv.take<float>((size_t)kWarps * 256);
    bytes = cv.bytes();
  }
};

// The block's (SP, D) float32 accumulator of y . Wo, in registers.
template <typename T>
struct OutAcc;

template <>
struct OutAcc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[kMaxTiles];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i)
      nvcuda::wmma::fill_fragment(f[i], 0.0f);
  }

  // f += os (SP, dk) . wos (dk, D)
  __device__ void add(const bf16* os, int ldo, const bf16* wos, int ldw,
                      int SP, int D, int dk) {
    namespace wmma = nvcuda::wmma;
    const int warp = threadIdx.x >> 5;
    const int nt = D / 16;
    const int tiles = (SP / 16) * nt;
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int tile = warp + kWarps * i;
      if (tile < tiles) {
        const int m0 = (tile / nt) * 16;
        const int n0 = (tile - (tile / nt) * nt) * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        for (int k = 0; k < dk; k += 16) {
          wmma::load_matrix_sync(a, os + m0 * ldo + k, ldo);
          wmma::load_matrix_sync(b, wos + k * ldw + n0, ldw);
          wmma::mma_sync(f[i], a, b, f[i]);
        }
      }
    }
  }

  // emit(r, col, value) for every accumulator element of a row r < S
  template <typename Emit>
  __device__ void emit(float* scr, int SP, int D, int S, Emit out) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nt = D / 16;
    const int tiles = (SP / 16) * nt;
    float* s = scr + warp * 256;
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int tile = warp + kWarps * i;
      if (tile < tiles) {
        const int m0 = (tile / nt) * 16;
        const int n0 = (tile - (tile / nt) * nt) * 16;
        nvcuda::wmma::store_matrix_sync(s, f[i], 16,
                                        nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          if (m0 + e / 16 < S) out(m0 + e / 16, n0 + e % 16, s[e]);
        __syncwarp();
      }
    }
  }
};

template <>
struct OutAcc<float> {
  static constexpr int kN = kMaxTiles * 256 / 32;   // 64 elements a thread
  float f[kN];                 // element e = tid + kThreads * i of (SP, D)

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = 0.0f;
  }

  __device__ void add(const float* os, int ldo, const float* wos, int ldw,
                      int SP, int D, int dk) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e < SP * D) {
        const int r = e / D;
        const int col = e - r * D;
        float s = 0.0f;
        for (int k = 0; k < dk; ++k) s += os[r * ldo + k] * wos[k * ldw + col];
        f[i] += s;
      }
    }
  }

  template <typename Emit>
  __device__ void emit(float*, int SP, int D, int S, Emit out) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e < SP * D && e / D < S) out(e / D, e % D, f[i]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_block_fwd_kernel(
    const T* __restrict__ c, const T* __restrict__ wq,
    const T* __restrict__ wk, const T* __restrict__ wv,
    const T* __restrict__ wo, const T* __restrict__ krel, T* __restrict__ x,
    int n_batch, int S, int nheads, int dk, float inv_sqrt,
    cpc::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = nheads * dk;
  const FwdSmem<T> L(smem, S, dk, D);
  const int b = blockIdx.x;
  const int kk = blockIdx.y;
  const int tid = threadIdx.x;
  const int n3 = 3 * dk;
  const T* cb = c + (size_t)b * S * D;
  const size_t w_off = (size_t)kk * D * D;

  for (int idx = tid; idx < dk * S; idx += blockDim.x)
    L.kr[idx] = cpc::to_f32(krel[(size_t)kk * dk * S + idx]);

  OutAcc<T> acc;
  acc.zero();
  for (int h = 0; h < nheads; ++h) {
    // ---- [q | k | v] of head h = c_b . W[:, h dk : (h+1) dk] ----
    cpc::ProjAcc<T> proj;
    proj.zero();
    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();   // earlier readers of the staged tiles are done
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
      L.ks[i * (dk + 1) + d] = cpc::round_to<T>(row[dk + d]);
      L.vs[i * dk + d] = cpc::round_to<T>(row[2 * dk + d]);
    }
    __syncthreads();

    // ---- the head's attention, rounded to T, into os ----
    cpc::relpos_fwd_rows(
        L.qs, L.ks, L.vs, L.kr, L.rows, S, dk, inv_sqrt, drop,
        cpc::attention_row_key(drop, kk, n_batch, b, nheads, h),
        [&](int i, int d, float o) {
          L.os[i * L.ldo + d] = cpc::from_f32<T>(o);
        });
    for (int idx = tid; idx < (L.SP - S) * dk; idx += blockDim.x)
      L.os[(S + idx / dk) * L.ldo + idx % dk] = cpc::from_f32<T>(0.0f);
    cpc::stage(L.wos, L.ldw, wo + w_off + (size_t)h * dk * D, D, dk, D, dk);
    __syncthreads();

    // ---- out += os . Wo[k][h dk : (h+1) dk, :] ----
    acc.add(L.os, L.ldo, L.wos, L.ldw, L.SP, D, dk);
  }
  __syncthreads();
  T* xb = x + ((size_t)kk * n_batch * S + (size_t)b * S) * D;
  acc.emit(L.scr, L.SP, D, S, [&](int r, int col, float att) {
    const size_t off = (size_t)r * D + col;
    xb[off] = cpc::from_f32<T>(cpc::to_f32(cb[off]) + cpc::round_to<T>(att));
  });
}

template <typename T>
int launch(const void* c, const void* wq, const void* wk, const void* wv,
           const void* wo, const void* krel, void* x, int K, int n_batch,
           int S, int nheads, int dk, cpc::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = FwdSmem<T>(nullptr, S, dk, nheads * dk).bytes;
  auto kernel = attention_block_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_batch, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<const T*>(wo), static_cast<const T*>(krel),
      static_cast<T*>(x), n_batch, S, nheads, dk,
      1.0f / sqrtf(static_cast<float>(dk)), drop);
  return (int)cudaGetLastError();
}

bool supported(int S, int nheads, int dk) {
  const int D = nheads * dk;
  return S > 0 && dk % 16 == 0 && D % KC == 0 && D <= 256 &&
         (S + 15) / 16 * 16 * D <= kWarps * kMaxTiles * 256;
}

}  // namespace

// Shared memory one block needs; the wrapper refuses shapes above the
// card's 227 KB.
extern "C" size_t cpc_attention_block_fwd_smem(int S, int nheads, int dk,
                                               int dtype) {
  return dtype == cpc::kBFloat16
             ? FwdSmem<bf16>(nullptr, S, dk, nheads * dk).bytes
             : FwdSmem<float>(nullptr, S, dk, nheads * dk).bytes;
}

// c (n_batch*S, D); wq, wk, wv, wo (K, D, D); krel (K, dk, S); x (K,
// n_batch*S, D); all in `dtype`, 16-byte aligned.  dk % 16 == 0, D % 64 ==
// 0, D <= 256 and round_up(S, 16) * D <= 32768 (the register accumulator).
extern "C" int cpc_attention_block_fwd(const void* c, const void* wq,
                                       const void* wk, const void* wv,
                                       const void* wo, const void* krel,
                                       void* x, int K, int n_batch, int S,
                                       int nheads, int dk, const void* seed,
                                       unsigned int threshold,
                                       float keep_scale, int dtype,
                                       void* stream) {
  if (!supported(S, nheads, dk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16)
    return launch<bf16>(c, wq, wk, wv, wo, krel, x, K, n_batch, S, nheads,
                        dk, drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(c, wq, wk, wv, wo, krel, x, K, n_batch, S, nheads,
                         dk, drop, s);
  return (int)cudaErrorInvalidValue;
}
