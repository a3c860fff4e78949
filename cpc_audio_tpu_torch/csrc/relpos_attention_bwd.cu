// K2 backward: causal attention with Shaw relative positions.
//
// The rows body: it runs past dk 512 (--hiddenEncoder past 4096); at every
// dk up to 512 the tensor-core body of relpos_attention_tc_bwd.cu runs instead
// (ops/head_attention.py `fwd_body` / `bwd_body`).
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_bwd_kernel`
// (called through `_fr_bwd`).  Recompute-style: per (k, batch row b,
// head h) the probabilities p are recomputed from q, k and krel, and with
// the forward's dropout factors r (regenerated from dropout.cuh, keyed on
// (k, b, h, i, j)):
//   dv_j    = sum_i round(p_ij r_ij) do_i
//   dp_ij   = (do_i . v_j) r_ij,   ds_ij = round(p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk))
//   dq_i    = sum_j ds_ij (k_j + krel[:, j - i + S - 1])
//   dk_j    = sum_i ds_ij q_i
//   dkrel[:, j - i + S - 1] += ds_ij q_i      (summed over b and h)
// where round() is the rounding to the input dtype that the Pallas kernel
// applies before its products.  The rel-pos adjoint is an index, not the
// TPU's `_unskew` lane gather: ds_ij meets krel column j - i + S - 1.
//
// Design: one block per (k, b, h) stages q, k, v, do and krel^T (float32)
// and keeps the whole (S, S) ds and round(p r) tiles in shared memory as
// float32 (183 KB at S = 116, dk = 32), so each is formed once and then
// read in three orders: by query row (dq, written at once), by key column
// (dk, dv) and by diagonal (one dkrel column per diagonal j - i).  Where
// float32 tiles do not fit beside the operands, the bf16 body keeps them
// in bf16 (exact: both are rounded to T; 211 KB at dk = 64), with a row's
// float32 intermediates in two per-warp rows; past that (float32 at dk =
// 64, or S past ~200) the tiles go to a device-memory scratch of the
// block's own, read back through L1 and L2 (slower, the same values).
// Where even the float32 operands do not fit beside the rows (S 244, dk
// 64: 331 KB), a second kernel on operand views stages them in bf16
// (exact: they are bf16 already; 158 KB there), and past that (float32
// there, or S·dk larger) reads them in place from device memory; past S
// 3632, where even the rows (8 warps' two float32 rows of S, 64 S bytes)
// pass shared memory, the rows go to the scratch too, after the chunk's
// tiles (128 KB a block beside its 67 MB of bf16 tiles at S 4096).  Each
// of these is a compile-time body (`mode_of` picks one per shape family):
// chosen at run time, the compiler read shared tiles through generic
// loads and the default shape's backward ran 2.9-3.1 ms against 2.3.
// Blocks run
// in parallel, so the TPU's dkrel accumulator revisited along a
// sequential grid becomes per-block partials (K, B*h, dk, S) that a
// second kernel sums over b and h in a fixed order: the result does not
// depend on block scheduling.  The device-memory tiles take 2 S^2 values
// a (k, b, h): 8.2 MB in float32 at S 1012 (--sizeWindow 163840), 3.1 GB
// over 12 heads and 8 attention heads at B 4, 25 GB at B 32; so the
// wrapper hands over a scratch of at most 1 GiB (or of one row, where a
// row takes more) and the launches walk the (k, b) rows of heads in
// chunks that fit it, reusing it
// (ops/head_attention.py `TILE_BUDGET`): a launch's grid is (heads, a
// chunk of b, a chunk of k), one k at a time where a k's rows do not all
// fit, and one (k, b) row at a time where one row passes the budget (at
// S 4096 in float32 a row of 8 heads takes 1.07 GB: the scratch is that
// one row's).  (h, b, k) stay block indices: with a flat block index divided
// into them the default shape's backward took 2.90 ms against 2.33
// (bf16, H100 80GB HBM3, 700 W).
//
// What bounds it on an H100: the ds/p tiles limit a block to one per SM
// (8 warps; 137 KB in bf16), and at S = 116, dk = 32 the work per block is small
// (~2 MFLOP), so it is latency-bound on shared memory; the partials cost
// K*B*h*dk*S*4 bytes (45 MB at the train shapes) of writes and reads.
#include <type_traits>

#include "relpos_attention.cuh"

namespace {

constexpr int kThreads = 256;

// Where the operands and the (S, S) tiles live: float32 operands with
// float32 tiles in shared memory, their rows also the rows' scratch
// (kTiles); float32 operands with tiles in T in shared memory beside two
// per-warp float32 rows (kTilesT, bf16 only); float32 operands with tiles
// in T in a device-memory scratch beside the same rows (kScratch); the
// same with the operands staged in T (kScratchT, bf16 only); operands read
// in place, tiles in the scratch (kInPlace); and the rows in the scratch
// too, after every block's tiles (kInPlaceRows: S past 3632).
enum Mode { kTiles, kTilesT, kScratch, kScratchT, kInPlace, kInPlaceRows };

// One launch's blocks: heads x b in [b0, b0 + nb) x k in [k0, k0 + nk).
struct Chunk {
  int k0, b0, nk, nb;
};

__host__ __device__ size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename TS>
__host__ __device__ size_t operand_bytes(int S, int dk) {
  return round16(((size_t)S * dk * 2 + (size_t)S * (dk + 1) * 3) *
                 sizeof(TS));
}

size_t row_bytes(int S) {
  return (size_t)(kThreads / 32) * 2 * S * sizeof(float);
}

template <typename TT>
size_t tile_bytes(int S) {
  return (size_t)S * S * 2 * sizeof(TT);
}

template <typename T>
Mode mode_of(int S, int dk) {
  constexpr bool bf16 = sizeof(T) < sizeof(float);
  const size_t ops = operand_bytes<float>(S, dk);
  if (ops + tile_bytes<float>(S) <= cpc::kSmemLimit) return kTiles;
  if (bf16 && ops + row_bytes(S) + tile_bytes<T>(S) <= cpc::kSmemLimit)
    return kTilesT;
  if (ops + row_bytes(S) <= cpc::kSmemLimit) return kScratch;
  if (bf16 && operand_bytes<T>(S, dk) + row_bytes(S) <= cpc::kSmemLimit)
    return kScratchT;
  return row_bytes(S) <= cpc::kSmemLimit ? kInPlace : kInPlaceRows;
}

template <typename T>
size_t smem_bytes(int S, int dk) {
  switch (mode_of<T>(S, dk)) {
    case kTiles:
      return operand_bytes<float>(S, dk) + tile_bytes<float>(S);
    case kTilesT:
      return operand_bytes<float>(S, dk) + row_bytes(S) + tile_bytes<T>(S);
    case kScratch:
      return operand_bytes<float>(S, dk) + row_bytes(S);
    case kScratchT:
      return operand_bytes<T>(S, dk) + row_bytes(S);
    case kInPlace:
      return row_bytes(S);
    default:
      return 0;
  }
}

// TT: the tiles' element type; ROWS: the rows' scratch is two per-warp
// rows (else the tile rows themselves, TT = float); SCRATCH: the tiles
// are this call's device-memory scratch `tiles` (else shared memory; a
// compile-time choice, so that shared-memory tiles are read with
// shared-memory loads).
template <typename T, typename TT, bool ROWS, bool SCRATCH>
__global__ void __launch_bounds__(kThreads) relpos_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ krel, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk_out, T* __restrict__ dv,
    float* __restrict__ dkrel_part, TT* __restrict__ tiles, int k_base,
    int b_base, int n_batch, int S, int nheads, int dk, float inv_sqrt,
    cpc::Dropout drop) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* qs = smem;               // (S, dk)
  float* dos = qs + S * dk;       // (S, dk)
  float* ks = dos + S * dk;       // (S, dk + 1)
  float* vs = ks + S * ldk;       // (S, dk + 1)
  float* krT = vs + S * ldk;      // (S, dk + 1): krT[r][d] = krel[k][d][r]
  float* rows = krT + S * ldk;    // (n_warps, 2, S) a row's intermediates

  const int h = blockIdx.x;
  const int b = b_base + blockIdx.y;    // this launch's chunk of b
  const int kk = k_base + blockIdx.z;   // and of k
  // (S, S) ds and p * r, both rounded to T: in shared memory, or in this
  // block's part of the scratch (the chunk's)
  TT* DS = SCRATCH
      ? tiles + ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * nheads + h) *
                    2 * S * S
      : reinterpret_cast<TT*>(ROWS ? rows + (kThreads / 32) * 2 * S : rows);
  TT* PD = DS + S * S;
  const int D = nheads * dk;
  const size_t M = (size_t)n_batch * S;
  const size_t base = ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(
                          drop.seed_word(), cpc::kSiteAttention,
                          (uint32_t)((kk * n_batch + b) * nheads + h))
                    : 0u;

  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    const size_t off = base + (size_t)i * D + d;
    qs[i * dk + d] = cpc::to_f32(q[off]);
    dos[i * dk + d] = cpc::to_f32(dout[off]);
    ks[i * ldk + d] = cpc::to_f32(k[off]);
    vs[i * ldk + d] = cpc::to_f32(v[off]);
  }
  const T* kr_g = krel + (size_t)kk * dk * S;
  for (int idx = threadIdx.x; idx < dk * S; idx += blockDim.x) {
    const int d = idx / S;
    const int r = idx - d * S;
    krT[r * ldk + d] = cpc::to_f32(kr_g[idx]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, round(p r); then dq_i ----
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const float* doi = dos + i * dk;
    TT* dsr = DS + i * S;
    TT* pdr = PD + i * S;
    // scores, then dp, then ds; and p
    float* rs = ROWS ? rows + warp * 2 * S : reinterpret_cast<float*>(dsr);
    float* rp = ROWS ? rs + S : reinterpret_cast<float*>(pdr);
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      const float* kr = krT + (j - i + S - 1) * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * (kj[d] + kr[d]);
      s *= inv_sqrt;
      rs[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpc::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(rs[j] - mx);
      rs[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / cpc::warp_sum(sum);
    float pdp = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = rs[j] * inv_sum;
      const float* vj = vs + j * ldk;
      float dpd = 0.0f;
      for (int d = 0; d < dk; ++d) dpd += doi[d] * vj[d];
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                drop.threshold, drop.keep_scale)
          : 1.0f;
      const float dp = dpd * r;
      pdp += p * dp;
      rp[j] = p;
      rs[j] = dp;
    }
    const float c = cpc::warp_sum(pdp);
    for (int j = lane; j <= i; j += 32) {
      const float p = rp[j];
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                drop.threshold, drop.keep_scale)
          : 1.0f;
      const float ds = cpc::round_to<T>(p * (rs[j] - c) * inv_sqrt);
      rs[j] = ds;
      dsr[j] = cpc::from_f32<TT>(ds);
      pdr[j] = cpc::from_f32<TT>(cpc::round_to<T>(p * r));
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j)
        acc += rs[j] * (ks[j * ldk + d] + krT[(j - i + S - 1) * ldk + d]);
      dq[base + (size_t)i * D + d] = cpc::from_f32<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- by key column: dk_j, dv_j ----
  for (int j = warp; j < S; j += n_warps) {
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f, bsum = 0.0f;
      for (int i = j; i < S; ++i) {
        a += cpc::to_f32(DS[i * S + j]) * qs[i * dk + d];
        bsum += cpc::to_f32(PD[i * S + j]) * dos[i * dk + d];
      }
      dk_out[base + (size_t)j * D + d] = cpc::from_f32<T>(a);
      dv[base + (size_t)j * D + d] = cpc::from_f32<T>(bsum);
    }
  }

  // ---- by diagonal: this block's part of dkrel[:, r], r = j - i + S - 1 ----
  float* part = dkrel_part +
                ((size_t)(kk * n_batch + b) * nheads + h) * dk * S;
  for (int r = warp; r < S; r += n_warps) {
    const int delta = S - 1 - r;             // i - j
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f;
      for (int i = delta; i < S; ++i)
        a += cpc::to_f32(DS[i * S + i - delta]) * qs[i * dk + d];
      part[d * S + r] = a;
    }
  }
}

// The same backward where the float32 operands do not fit beside the rows
// (kScratchT, kInPlace, kInPlaceRows): the operands are views
// (relpos_attention.cuh), staged in TS = T, or (IN_PLACE) read from device
// memory; the tiles are in the device-memory scratch, a row's
// intermediates in two per-warp rows, in shared memory or (ROWS_DEV) in
// the scratch after the launch's tiles, the block's own 16 S floats.  The kernel above keeps its own body for the default shapes: the
// same code on views ran 2.66 ms there against its 2.31 (S 116, dk 32,
// bf16, chip_smoke.py on an H100).
template <typename T, typename TS, bool IN_PLACE, bool ROWS_DEV>
__global__ void __launch_bounds__(kThreads) relpos_attention_bwd_view_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ krel, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk_out, T* __restrict__ dv,
    float* __restrict__ dkrel_part, T* __restrict__ tiles, int k_base,
    int b_base, int n_batch, int S, int nheads, int dk, float inv_sqrt,
    cpc::Dropout drop) {
  extern __shared__ float smem[];
  using TT = T;
  const int ldk = dk + 1;
  const int h = blockIdx.x;
  const int b = b_base + blockIdx.y;    // this launch's chunk of b
  const int kk = k_base + blockIdx.z;   // and of k
  const int D = nheads * dk;
  const size_t M = (size_t)n_batch * S;
  const size_t base = ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk;
  const T* kr_g = krel + (size_t)kk * dk * S;
  // qs, dos (S, dk); ks, vs, krT (S, dk + 1) with krT[r][d] = krel[k][d][r]
  TS* qs = reinterpret_cast<TS*>(smem);
  TS* dos = qs + S * dk;
  TS* ks = dos + S * dk;
  TS* vs = ks + S * ldk;
  TS* krT = vs + S * ldk;
  // this block among the launch's (the chunk's)
  const size_t blk =
      (size_t)(blockIdx.z * gridDim.y + blockIdx.y) * nheads + h;
  // (n_warps, 2, S) a row's intermediates: in shared memory, or after the
  // launch's tiles in the scratch
  float* rows =
      ROWS_DEV ? reinterpret_cast<float*>(
                     tiles + (size_t)gridDim.x * gridDim.y * gridDim.z * 2 *
                                 S * S) +
                     blk * (kThreads / 32) * 2 * S
      : IN_PLACE ? smem
                 : smem + operand_bytes<TS>(S, dk) / sizeof(float);
  // (S, S) ds and p * r, both rounded to T: this block's part of the
  // scratch
  TT* DS = tiles + blk * 2 * S * S;
  TT* PD = DS + S * S;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(
                          drop.seed_word(), cpc::kSiteAttention,
                          (uint32_t)((kk * n_batch + b) * nheads + h))
                    : 0u;

  // the operands as views: Q(i, d), DO(i, d), Kv(j, d), V(j, d) and
  // KR(r, d) = krel[k][d][r]
  using E = std::conditional_t<IN_PLACE, T, TS>;
  cpc::View<E> Q, DO, Kv, V, KR;
  if constexpr (IN_PLACE) {
    Q = {q + base, D, 1};
    DO = {dout + base, D, 1};
    Kv = {k + base, D, 1};
    V = {v + base, D, 1};
    KR = {kr_g, 1, S};
  } else {
    for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
      const int i = idx / dk;
      const int d = idx - i * dk;
      const size_t off = base + (size_t)i * D + d;
      qs[i * dk + d] = cpc::from_f32<TS>(cpc::to_f32(q[off]));
      dos[i * dk + d] = cpc::from_f32<TS>(cpc::to_f32(dout[off]));
      ks[i * ldk + d] = cpc::from_f32<TS>(cpc::to_f32(k[off]));
      vs[i * ldk + d] = cpc::from_f32<TS>(cpc::to_f32(v[off]));
    }
    for (int idx = threadIdx.x; idx < dk * S; idx += blockDim.x) {
      const int d = idx / S;
      const int r = idx - d * S;
      krT[r * ldk + d] = cpc::from_f32<TS>(cpc::to_f32(kr_g[idx]));
    }
    Q = {qs, dk, 1};
    DO = {dos, dk, 1};
    Kv = {ks, ldk, 1};
    V = {vs, ldk, 1};
    KR = {krT, ldk, 1};
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, round(p r); then dq_i ----
  for (int i = warp; i < S; i += n_warps) {
    TT* dsr = DS + i * S;
    TT* pdr = PD + i * S;
    // scores, then dp, then ds; and p
    float* rs = rows + warp * 2 * S;
    float* rp = rs + S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const int r = j - i + S - 1;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += Q(i, d) * (Kv(j, d) + KR(r, d));
      s *= inv_sqrt;
      rs[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpc::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(rs[j] - mx);
      rs[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / cpc::warp_sum(sum);
    float pdp = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = rs[j] * inv_sum;
      float dpd = 0.0f;
      for (int d = 0; d < dk; ++d) dpd += DO(i, d) * V(j, d);
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                drop.threshold, drop.keep_scale)
          : 1.0f;
      const float dp = dpd * r;
      pdp += p * dp;
      rp[j] = p;
      rs[j] = dp;
    }
    const float c = cpc::warp_sum(pdp);
    for (int j = lane; j <= i; j += 32) {
      const float p = rp[j];
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                drop.threshold, drop.keep_scale)
          : 1.0f;
      const float ds = cpc::round_to<T>(p * (rs[j] - c) * inv_sqrt);
      rs[j] = ds;
      dsr[j] = cpc::from_f32<TT>(ds);
      pdr[j] = cpc::from_f32<TT>(cpc::round_to<T>(p * r));
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j)
        acc += rs[j] * (Kv(j, d) + KR(j - i + S - 1, d));
      dq[base + (size_t)i * D + d] = cpc::from_f32<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- by key column: dk_j, dv_j ----
  for (int j = warp; j < S; j += n_warps) {
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f, bsum = 0.0f;
      for (int i = j; i < S; ++i) {
        a += cpc::to_f32(DS[i * S + j]) * Q(i, d);
        bsum += cpc::to_f32(PD[i * S + j]) * DO(i, d);
      }
      dk_out[base + (size_t)j * D + d] = cpc::from_f32<T>(a);
      dv[base + (size_t)j * D + d] = cpc::from_f32<T>(bsum);
    }
  }

  // ---- by diagonal: this block's part of dkrel[:, r], r = j - i + S - 1 ----
  float* part = dkrel_part +
                ((size_t)(kk * n_batch + b) * nheads + h) * dk * S;
  for (int r = warp; r < S; r += n_warps) {
    const int delta = S - 1 - r;             // i - j
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f;
      for (int i = delta; i < S; ++i)
        a += cpc::to_f32(DS[i * S + i - delta]) * Q(i, d);
      part[d * S + r] = a;
    }
  }
}

// dkrel[k][e] = sum over the n_parts (b, h) partials, in a fixed order.
__global__ void dkrel_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ dkrel, int n_parts,
                                    int n_elem) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int kk = blockIdx.y;
  if (e >= n_elem) return;
  const float* p = part + (size_t)kk * n_parts * n_elem + e;
  float s = 0.0f;
  for (int n = 0; n < n_parts; ++n) s += p[(size_t)n * n_elem];
  dkrel[(size_t)kk * n_elem + e] = s;
}

template <typename T, typename TT, bool ROWS, bool SCRATCH>
cudaError_t launch_body(const void* q, const void* k, const void* v,
                        const void* krel, const void* dout, void* dq,
                        void* dk_out, void* dv, float* part, TT* tiles,
                        Chunk c, int n_batch, int S, int nheads, int dk,
                        size_t smem, cpc::Dropout drop, cudaStream_t stream) {
  auto kernel = relpos_attention_bwd_kernel<T, TT, ROWS, SCRATCH>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nheads, c.nb, c.nk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(krel),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk_out), static_cast<T*>(dv), part, tiles, c.k0, c.b0,
      n_batch, S, nheads, dk, 1.0f / sqrtf(static_cast<float>(dk)), drop);
  return cudaGetLastError();
}

template <typename T, typename TS, bool IN_PLACE, bool ROWS_DEV>
cudaError_t launch_view(const void* q, const void* k, const void* v,
                        const void* krel, const void* dout, void* dq,
                        void* dk_out, void* dv, float* part, void* tiles,
                        Chunk c, int n_batch, int S, int nheads, int dk,
                        size_t smem, cpc::Dropout drop, cudaStream_t stream) {
  auto kernel = relpos_attention_bwd_view_kernel<T, TS, IN_PLACE, ROWS_DEV>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nheads, c.nb, c.nk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(krel),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk_out), static_cast<T*>(dv), part,
      static_cast<T*>(tiles), c.k0, c.b0, n_batch, S, nheads, dk,
      1.0f / sqrtf(static_cast<float>(dk)), drop);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* krel,
           const void* dout, void* dq, void* dk_out, void* dv, float* part,
           float* dkrel, void* tiles, int K, int k_chunk, int b_chunk,
           int n_batch, int S, int nheads, int dk, cpc::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S, dk);
  if (S <= 0 || dk <= 0 || k_chunk <= 0 || b_chunk <= 0 ||
      (k_chunk > 1 && b_chunk < n_batch) || smem > cpc::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const Mode mode = mode_of<T>(S, dk);
  if (mode >= kScratch && tiles == nullptr) return (int)cudaErrorInvalidValue;
  T* scratch = static_cast<T*>(tiles);
  // k_chunk x b_chunk rows of heads a launch, one launch after another on
  // the stream, so that the scratch holds one chunk's tiles
  for (int k0 = 0; k0 < K; k0 += k_chunk)
    for (int b0 = 0; b0 < n_batch; b0 += b_chunk) {
      const Chunk c{k0, b0, min(k_chunk, K - k0), min(b_chunk, n_batch - b0)};
      cudaError_t err = cudaErrorInvalidValue;
      if (mode == kTiles)
        err = launch_body<T, float, false, false>(
            q, k, v, krel, dout, dq, dk_out, dv, part, nullptr, c, n_batch,
            S, nheads, dk, smem, drop, stream);
      else if (mode == kScratch)
        err = launch_body<T, T, true, true>(q, k, v, krel, dout, dq, dk_out,
                                            dv, part, scratch, c, n_batch, S,
                                            nheads, dk, smem, drop, stream);
      else if (mode == kInPlace)
        err = launch_view<T, T, true, false>(q, k, v, krel, dout, dq, dk_out,
                                             dv, part, tiles, c, n_batch, S,
                                             nheads, dk, smem, drop, stream);
      else if (mode == kInPlaceRows)
        err = launch_view<T, T, true, true>(q, k, v, krel, dout, dq, dk_out,
                                            dv, part, tiles, c, n_batch, S,
                                            nheads, dk, smem, drop, stream);
      else if constexpr (sizeof(T) < sizeof(float)) {   // bf16 only
        if (mode == kTilesT)
          err = launch_body<T, T, true, false>(
              q, k, v, krel, dout, dq, dk_out, dv, part, nullptr, c,
              n_batch, S, nheads, dk, smem, drop, stream);
        else
          err = launch_view<T, T, false, false>(q, k, v, krel, dout, dq,
                                                dk_out, dv, part, tiles, c,
                                                n_batch, S, nheads, dk, smem,
                                                drop, stream);
      }
      if (err != cudaSuccess) return (int)err;
    }
  const int n_elem = dk * S;
  const dim3 rgrid((n_elem + 255) / 256, K);
  dkrel_reduce_kernel<<<rgrid, 256, 0, stream>>>(part, dkrel,
                                                 n_batch * nheads, n_elem);
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of device scratch for the (S, S) tiles of n_blocks (k, b, h)
// blocks where they do not fit beside the operands (0 where they do), and
// past S 3632 their rows after them: the blocks of one launch, k_chunk *
// b_chunk * nheads.
template <typename T>
size_t scratch_bytes(int n_blocks, int S, int dk) {
  const Mode mode = mode_of<T>(S, dk);
  if (mode < kScratch) return 0;
  return (size_t)n_blocks *
         (tile_bytes<T>(S) + (mode == kInPlaceRows ? row_bytes(S) : 0));
}

extern "C" size_t cpc_relpos_attention_bwd_scratch(int n_blocks, int S,
                                                   int dk, int dtype) {
  return dtype == cpc::kBFloat16
             ? scratch_bytes<__nv_bfloat16>(n_blocks, S, dk)
             : scratch_bytes<float>(n_blocks, S, dk);
}

// q, k, v, dout and dq, dk, dv (K, n_batch*S, nheads*dk) and krel
// (K, dk, S) in `dtype`; dkrel (K, dk, S) float32; part is float32 scratch
// of K*n_batch*nheads*dk*S elements, tiles the scratch of
// cpc_relpos_attention_bwd_scratch(k_chunk * b_chunk * nheads, ...) bytes
// (null when that is 0), reused by each launch of k_chunk heads' b_chunk
// rows (b_chunk is n_batch where k_chunk > 1).
extern "C" int cpc_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* krel,
    const void* dout, void* dq, void* dk, void* dv, void* dkrel, void* part,
    void* tiles, int K, int k_chunk, int b_chunk, int n_batch, int S,
    int nheads, int dkh, const void* seed, unsigned int threshold,
    float keep_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  float* p = static_cast<float*>(part);
  float* dr = static_cast<float*>(dkrel);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, krel, dout, dq, dk, dv, p, dr,
                                 tiles, K, k_chunk, b_chunk, n_batch, S,
                                 nheads, dkh,
                                 drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(q, k, v, krel, dout, dq, dk, dv, p, dr, tiles, K,
                         k_chunk, b_chunk, n_batch, S, nheads, dkh, drop,
                         s);
  return (int)cudaErrorInvalidValue;
}
