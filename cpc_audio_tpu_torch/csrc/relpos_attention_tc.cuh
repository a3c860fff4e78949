// K2's tensor-core body: causal attention with Shaw relative positions on
// mma.sync, shared by relpos_attention_tc_fwd.cu and
// relpos_attention_tc_bwd.cu.  It is K5's body (causal_attention.cuh: the
// geometry `Geom`, cp.async staging, the products with every accumulator
// element's (row, column) known, the dropout bits in registers, float32
// on split bf16 planes) with what the rel-pos bias adds:
//
// The window product.  For query tile [i0, i0 + T) and key tile
// [j0, j0 + T), pair (i, j) reads krel column r = j - i + S - 1; over the
// tile pair these are the 2T - 1 columns from j0 - i0 + S - T, the window.
// Its columns depend on the tile diagonal qt - kt only.  QP = Q_tile .
// krel[:, window] runs on the tensor cores; pair (i, j) takes
// QP[i, j - i + T - 1].  Row group rw (query rows 16 rw .. 16 rw + 15)
// reads window columns [c_lo, c_lo + T + 16) only, c_lo = T - 16 - 16 rw:
// its band.  So each warp forms the band of its 16 rows (T + 16 columns,
// 1.25 times a score tile), stages it as float32 in shared memory, and
// every score element reads its bias from there: band column
// j - (i mod 16) + 15 of row i.  The backward's adjoint goes the other
// way: ds is staged into the same band layout (U, zero outside the
// causal band), over the rows of QP it no longer needs, and dq += U .
// krel[:, window]^T, dkrel[:, window] += Q^T . U.
//
// At DKP 512 (heads past dk 256; K5's 16-row tiles, the four warps on one
// row group, `kSplitK`) each warp forms its quarter of every reduction
// over dk: QP's band from the window rows [128 w, 128 w + 128), which are
// staged as four quarter blocks, (w, plane, 128 rows) (`stage_quarters`),
// and the scores from the same columns of q and k.  The partial bands
// are summed w 0 + 1 + 2 + 3 into the band's staging through shared
// memory (`sum_band`), the partial scores as K5's (`k5::load_sum`); dq's
// U . krel^T and dkrel's q^T . U stay split by output columns (a warp's
// quarter of dq reads its quarter block; dkrel's d tiles by warp).  No
// (S, S) tile anywhere at any width.
//
// Past dk 512 (heads of --hiddenEncoder 4104-32768, dk 513-4096) the
// cluster body: a thread-block cluster of ceil(dk / 512) CTAs serves one
// tile, CTA c on dk columns [512 c, 512 c + 512) at DKP 512's geometry,
// kernel by kernel the same code (template argument CL).  CTA c stages those
// columns of q, k, v, do and those rows of the krel window, and owns those
// columns of o, dq, dk, dv and those rows of dkrel.  Its warps form their
// quarters' partial window band, scores and dp as at DKP 512; the CTA sums
// its four warps' partials w 0 + 1 + 2 + 3 into its exchange block
// (`cta_band`, `cta_scores`), and after one cluster barrier every CTA
// sums the cluster's blocks CTA 0 + 1 + ... through distributed shared
// memory (`cluster_sum`), so that all of them hold the same bits for the
// max, the exp and the dropout factor.  The block is written again only
// after a second barrier, split into an arrive once the sums are read and
// a wait before the next tile's write, so the work between hides it.
// Warps whose 128 columns lie past dk (at dk 520 three of the second CTA's
// four) skip their products, and their partials are 0, and the slab's
// columns and window rows past dk are zero-filled without a read.
// Registers and shared memory a CTA are DKP 512's, plus 4 KB (backward:
// the exchange block) or 7 KB (forward: the block, and the scores'
// partials beside the band's, so that both pass through shared memory
// between one pair of __syncthreads).
//
// krel is read from a copy made once a call: (K, P, DKP, SK) bf16 planes,
// column x holding krel column x - off with off = (-S) mod 8 and SK = S +
// off, zero past dk and outside [0, S).  A window then starts at padded
// column SK - (qt - kt + 1) T, a multiple of 8, so it is staged with
// 16-byte copies and those wholly outside [0, SK) are zero-filled: the
// kernels never read krel out of range (such columns meet masked pairs
// only).
//
// q, k, v, do: in bf16 staged from their natural (K, B*S, D) rows (head
// h's columns at h dk) with 16-byte copies where dk is a multiple of 8;
// otherwise (dk 25, 132: rows 2- or 8-byte aligned), and in float32 as
// its split, copied once a call into (N, S, DKP) planes per head, n =
// (k * B + b) * nheads + h, aligned at any dk (element copies straight
// from the natural rows ran K2 at dk 25 slower than at dk 32 on an H100:
// 0.62 against 0.16 ms forward).  One block takes one head: the (k, b) row's heads sit
// side by side in a 512-byte row at D 256, so neighbouring blocks (heads
// h, h + 1 of one tile) read neighbouring pieces of the same rows and the
// sectors they share come from L2.
#pragma once

#include "causal_attention.cuh"

namespace cpc {

__device__ __forceinline__ uint32_t attention_row_key(const Dropout& drop,
                                                      int kk, int n_batch,
                                                      int b, int nheads,
                                                      int h) {
  return drop.active()
             ? dropout_row_key(drop.seed_word(), kSiteAttention,
                               (uint32_t)((kk * n_batch + b) * nheads + h))
             : 0u;
}

namespace k2 {

using bf16 = __nv_bfloat16;
using k5::col_of;
using k5::kThreads;
using k5::row_of;

// The shapes the tensor-core body takes: S up to 4096 (nothing in it is
// sized by S but its scratch, O(N S dk) and the diagonal pass's windows;
// the gate, ops/head_attention.py `MAX_S`, stops at the longest window
// checked on the card, the heads' S 4084 at --sizeWindow 655360) and
// dk up to 4096: every width K5 stages, and past 512 the cluster body on
// at most 8 CTAs, the portable cluster size (dk 4096 is --hiddenEncoder
// 32768, whose 12 heads' weights pass the card's 80 GB).
constexpr int kMaxS = 4096;
constexpr int kSlab = 512;                       // dk columns a CTA
constexpr int kMaxCluster = 8;
constexpr int kMaxDk = kMaxCluster * kSlab;

__host__ __device__ constexpr bool takes(int S, int dk) {
  return S > 0 && S <= kMaxS && dk > 0 && dk <= kMaxDk;
}

// CTAs a tile at head width dk: 1 up to dk 512, else one a 512 columns.
__host__ __device__ constexpr int cluster_ctas(int dk) {
  return dk <= kSlab ? 1 : (dk + kSlab - 1) / kSlab;
}

// dk rounded up to the staged width: K5's up to 512, past it whole slabs.
inline int padded_width(int dk) {
  return dk <= kSlab ? k5::padded_dk(dk) : cluster_ctas(dk) * kSlab;
}

// The width of the copies a call makes (krel's planes' rows, the operands'
// planes' columns): the staged width up to dk 512; past it dk rounded up
// to 8, since the cluster body reads no column (row) past dk there, and
// the second CTA of dk 520 copies 8 columns, not 512.
__host__ __device__ constexpr int plane_width(int dk) {
  return dk <= kSlab ? (dk <= 32    ? 32
                        : dk <= 64  ? 64
                        : dk <= 128 ? 128
                        : dk <= 256 ? 256
                                    : 512)
                     : (dk + 7) / 8 * 8;
}

// The kernel's krel plane rows: DKP, or in the cluster body plane_width.
template <bool CL, int DKP>
__device__ __forceinline__ int plane_rows(int dk) {
  if constexpr (CL)
    return plane_width(dk);
  else
    return DKP;
}

// Blocks of `smem` bytes an SM holds (228 KB, 1 KB of it kept a block),
// at most 3: the kernels' 130-170 registers a thread allow no more.
__host__ __device__ constexpr int blocks_an_sm(size_t smem) {
  return 233472 / (smem + 1024) < 3 ? (int)(233472 / (smem + 1024)) : 3;
}

// Buffers a kernel stages its tiles in, from its shared memory at one and
// at two: two (the next tile in flight) unless one lets more blocks share
// an SM, or two do not fit.  On an H100 more blocks beat the second
// buffer: the backward's row and diagonal passes in bf16 at S 1012, dk 32
// took 2.06 and 1.48 ms on one buffer at 3 blocks an SM, 2.61 and 1.81 on
// two at 2.
__host__ __device__ constexpr int pick_bufs(size_t one, size_t two) {
  return two > kSmemLimit || blocks_an_sm(one) > blocks_an_sm(two) ? 1 : 2;
}

// The window geometry of tiles of G::kTile rows.
template <typename G>
struct Win {
  static constexpr int kTile = G::kTile;
  static constexpr int kCols = 2 * kTile;      // a window's krel columns
  static constexpr int kLdw = kCols + 8;       // krel window row (bf16)
  static constexpr int kBand = kTile + 16;     // a row group's columns
  static constexpr int kBandNT = kBand / 8;    // its n8 tiles
  static constexpr int kLdq = kBand + 4;       // QP band row (float32)
  static constexpr int kLdu = kBand + 8;       // a U plane's row (bf16)
  // the forward's QP staging
  static constexpr size_t kQpBytes = (size_t)kTile * kLdq * sizeof(float);
  // The backward's band staging: row il holds QP's float32 row, and then
  // U's planes side by side over it (a row group's U overwrites its own
  // QP rows once its scores are read, so the two take one region); an odd
  // number of 16-byte units a row keeps ldmatrix's eight rows on distinct
  // banks.
  static constexpr int kRowUnits =
      ((kLdq * 4 > G::kPlanes * kLdu * 2 ? kLdq * 4 : G::kPlanes * kLdu * 2) +
       15) / 16;
  static constexpr int kRowBytes = (kRowUnits | 1) * 16;
  static constexpr int kRowF = kRowBytes / 4;   // float32 elements a row
  static constexpr int kRowH = kRowBytes / 2;   // bf16 elements a row
  static constexpr size_t kBandBytes = (size_t)kTile * kRowBytes;
  // krel window rows [0, kc) of all planes, bf16 elements (at kSplitK,
  // kc / 4 rows of each quarter block)
  __host__ __device__ static constexpr int kr_elems(int kc) {
    return G::kPlanes * kc * kLdw;
  }
  // at kSplitK: the warps' partial bands, or partial scores and dp
  // (k5::store_partial), in turns
  static constexpr size_t kRedBytes =
      G::kSplitK ? (size_t)k5::kPartialFloats<kBandNT> * sizeof(float) : 0;
  static_assert(!G::kSplitK || kBandNT >= 2 * G::kNT, "partials fit");
  // first window column of row group rw's band
  static __device__ __forceinline__ int c_lo(int rw) {
    return kTile - 16 - 16 * rw;
  }
};

// The operands q, k, v, do (p[0..3]) as the kernels stage them.
struct Heads {
  const bf16* p[4];
  int n_batch, S, nheads, dk;
  int lds;        // row stride, elements: D (natural) or DKP (planes)
  size_t plane;   // planes: elements plane to plane; natural: 0
  bool planes;

  // head n's row 0 in the natural (K, B*S, D) layout, D = lds there
  __device__ __forceinline__ size_t natural(int n, int D) const {
    return (size_t)(n / nheads) * S * D + (size_t)(n % nheads) * dk;
  }
  __device__ __forceinline__ size_t base(int n) const {
    return planes ? (size_t)n * S * lds : natural(n, lds);
  }
};

// Rows [r0, r0 + kTile) of head n's operand o into a staged tile (zero
// past S and past dk), 16 bytes a copy; with CL (the cluster body) its
// columns from col0, the CTA's, those past dk zero-filled without a read
// in the planes too.
template <typename G, int DKP, bool CL = false>
__device__ __forceinline__ void stage_head(bf16* dst, const Heads& H, int o,
                                           int n, int r0, int col0 = 0) {
  if constexpr (CL) {
    const int live = (H.dk - col0 + 7) / 8 * 8;
    k5::stage_rows<G, DKP>(dst, H.p[o] + H.base(n) + col0, H.plane, r0,
                           H.S, H.lds,
                           H.planes ? (live < DKP ? live : DKP)
                                    : H.dk - col0);
  } else {
    k5::stage_rows<G, DKP>(dst, H.p[o] + H.base(n), H.plane, r0, H.S, H.lds,
                           H.planes ? DKP : H.dk);
  }
}

// Rows [d0, d0 + KC) of head k's padded krel planes (K, P, DKP, sk), window
// columns from padded column x0, into dst (P planes of (KC, kLdw)).
template <typename G, int DKP, int KC>
__device__ __forceinline__ void stage_window(bf16* dst, const bf16* krp,
                                             int kk, int sk, int d0,
                                             int x0) {
  using W = Win<G>;
  constexpr int C = W::kCols / 8;
#pragma unroll
  for (int p = 0; p < G::kPlanes; ++p) {
    const bf16* src = krp + ((size_t)kk * G::kPlanes + p) * DKP * sk;
    for (int idx = threadIdx.x; idx < KC * C; idx += kThreads) {
      const int r = idx / C, c = (idx - r * C) * 8;
      const int x = x0 + c;
      const bool ok = x >= 0 && x < sk;
      mma::cp_async16(dst + (p * KC + r) * W::kLdw + c,
                      ok ? src + (size_t)(d0 + r) * sk + x : src, ok);
    }
  }
}

// At kSplitK: rows [128 w + c, 128 w + c + KQ) of the window, for each
// warp's quarter w, into dst as four blocks of KQ rows (block w at
// w * kr_elems(KQ), each as `stage_window` lays out its chunk); KQ = 128
// and c = 0 stage the whole window.  One loop over every row of every
// block and plane: eight loops' offsets held across the float32 column
// pass's loop spilled registers.  With CL (the cluster body) krp's planes
// hold dkr rows, the quarters are counted from row d0 (the CTA's), and
// rows from d_hi (dk) on are zero-filled without a read.
template <typename G, int DKP, int KQ, bool CL = false>
__device__ __forceinline__ void stage_quarters(bf16* dst, const bf16* krp,
                                               int kk, int sk, int c,
                                               int x0, int dkr = DKP,
                                               int d0 = 0, int d_hi = 0) {
  using W = Win<G>;
  constexpr int P = G::kPlanes;
  constexpr int C = W::kCols / 8;                  // 16-byte copies a row
  constexpr int kRows = k5::kWarps * P * KQ;       // (w, plane, row)
  const bf16* src = krp + (size_t)kk * P * dkr * sk;
  for (int idx = threadIdx.x; idx < kRows * C; idx += kThreads) {
    const int r = idx / C, x = x0 + (idx - r * C) * 8;
    const int wp = r / KQ, p = wp % P;
    const int d = d0 + wp / P * G::kDV + c + (r - wp * KQ);   // krel row
    const bool ok = x >= 0 && x < sk && (!CL || d < d_hi);
    mma::cp_async16(dst + r * W::kLdw + (x - x0),
                    ok ? src + ((size_t)p * dkr + d) * sk + x : src, ok);
  }
}

// qp (row group rw's 16 rows a0.. of staged tile A x its band of kBand
// window columns from c_lo) += A[:, d0 : d0 + KC] . Kr, the staged krel
// window rows (KC x window columns, k-major), as the split products of
// the planes (K5's order, by increasing i + j).
template <typename G, int KC>
__device__ __forceinline__ void window_product(
    float qp[Win<G>::kBandNT][4], const bf16* A, int a0, const bf16* Kr,
    int d0, int c_lo) {
  using W = Win<G>;
  constexpr int P = G::kPlanes;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    uint32_t a[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i)
      mma::load_a(a[i], A + i * G::kPlaneElems, G::kLd, a0, d0 + ks * 16);
#pragma unroll
    for (int np = 0; np < W::kBandNT / 2; ++np) {
      uint32_t b[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j)
        mma::load_b_kmajor(b[j], Kr + j * KC * W::kLdw, W::kLdw, ks * 16,
                           c_lo + np * 16);
#pragma unroll
      for (int d = 0; d < P; ++d)
#pragma unroll
        for (int i = 0; i <= d; ++i) {
          mma::mma_bf16(qp[2 * np], a[i], b[d - i][0], b[d - i][1]);
          mma::mma_bf16(qp[2 * np + 1], a[i], b[d - i][2], b[d - i][3]);
        }
    }
  }
}

template <typename G>
__device__ __forceinline__ void zero_band(float qp[Win<G>::kBandNT][4]) {
#pragma unroll
  for (int nt = 0; nt < Win<G>::kBandNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) qp[nt][e] = 0.0f;
}

// Row group rw's band of QP into the float32 staging of rows ldq apart.
template <typename G>
__device__ __forceinline__ void store_band(float* QPs,
                                           float qp[Win<G>::kBandNT][4],
                                           int rw, int ldq) {
#pragma unroll
  for (int nt = 0; nt < Win<G>::kBandNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      QPs[(rw * 16 + row_of(e)) * ldq + col_of(nt, e)] = qp[nt][e];
}

// At kSplitK: the band QPs (rows ldq apart) = the four warps' partial
// bands qp summed w 0 + 1 + 2 + 3 through red, all threads summing
// elements of it; starts with the partials' stores and ends with the band
// whole and red free (a __syncthreads after each).
template <typename G>
__device__ __forceinline__ void sum_band(float* QPs,
                                         const float qp[Win<G>::kBandNT][4],
                                         float* red, int ldq) {
  constexpr int NT = Win<G>::kBandNT;
  constexpr int kSlot = NT * 4 * 32;    // a warp's partial, floats
  k5::store_partial<NT>(red, qp);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kSlot; idx += kThreads) {
    const int lane = idx & 31, nt = idx >> 7, e = (idx >> 5) & 3;
    float x = red[idx];
#pragma unroll
    for (int w = 1; w < k5::kWarps; ++w) x += red[w * kSlot + idx];
    QPs[((lane >> 2) + ((e >> 1) << 3)) * ldq + nt * 8 + ((lane & 3) << 1) +
        (e & 1)] = x;
  }
  __syncthreads();
}

// The bias QP[i, j - i + T - 1] of tile pair (query row il, key jl).
__device__ __forceinline__ float band_at(const float* QPs, int il, int jl,
                                         int ldq) {
  return QPs[il * ldq + jl - (il & 15) + 15];
}

// s (the warp's scores, raw q . k^T of query rows 16 rw.. x the key tile)
// scaled with the bias added and -inf above the diagonal, from the staged
// band: the same code in every pass, so every pass sees the same bits.
template <typename G>
__device__ __forceinline__ void bias_scale_mask(float s[G::kNT][4],
                                                const float* QPs, int ldq,
                                                int rw, int q0, int k0,
                                                float inv_sqrt) {
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = rw * 16 + row_of(e), jl = col_of(nt, e);
      s[nt][e] = k0 + jl <= q0 + il
                     ? (s[nt][e] + band_at(QPs, il, jl, ldq)) * inv_sqrt
                     : -INFINITY;
    }
}

// ---- the cluster body's exchange ------------------------------------------

// The CTA's place in its cluster (the cluster body), or {0, 1}.
struct Cta {
  int rank, n;
};

template <bool CL>
__device__ __forceinline__ Cta this_cta() {
  if constexpr (CL) {
    uint32_t r, n;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
    return {(int)r, (int)n};
  } else {
    return {0, 1};
  }
}

// The two halves of a cluster barrier: after the wait, every thread of the
// cluster has passed its arrive, and its shared-memory writes before it,
// local and remote, are visible.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of `local`'s counterpart in CTA `rank`'s shared
// memory: plain loads through it, which the compiler orders after the
// cluster barrier (its asm clobbers memory) and keeps in flight together.
__device__ __forceinline__ const float* remote(const float* local, int rank) {
  uint64_t addr;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(addr)
      : "l"(reinterpret_cast<uint64_t>(local)), "r"(rank));
  return reinterpret_cast<const float*>(addr);
}

// Floats of one exchanged tile of NT n8 tiles (k5::store_partial's slots
// of one warp).
template <int NT>
constexpr int kSlotFloats = NT * 4 * 32;

// Floats of a CTA's exchange block: the band and the scores, in the
// backward also dp.
template <typename G, bool DP>
constexpr int kExchangeFloats =
    kSlotFloats<Win<G>::kBandNT> + (DP ? 2 : 1) * kSlotFloats<G::kNT>;

// x (one slot) = the four warps' partials in red (k5::store_partial)
// summed w 0 + 1 + 2 + 3, all threads summing elements of it.
template <int NT>
__device__ __forceinline__ void cta_sum(float* x, const float* red) {
  constexpr int kSlot = kSlotFloats<NT>;
  for (int idx = threadIdx.x; idx < kSlot; idx += kThreads) {
    float v = red[idx];
#pragma unroll
    for (int w = 1; w < k5::kWarps; ++w) v += red[w * kSlot + idx];
    x[idx] = v;
  }
}

// v[j] = the cluster's exchange blocks at x + at[j] summed CTA 0 + 1 +
// ... + n - 1, the J loads of a CTA in flight together.
template <int J>
__device__ __forceinline__ void cluster_sum(float (&v)[J], const float* x,
                                            const int (&at)[J], int n) {
  const float* x0 = remote(x, 0);
#pragma unroll
  for (int j = 0; j < J; ++j) v[j] = x0[at[j]];
  if (n == 2) {   // dk 513-1024: both CTAs' loads in flight at once
    const float* x1 = remote(x, 1);
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = x1[at[j]];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] += t[j];
    return;
  }
  for (int r = 1; r < n; ++r) {
    const float* xr = remote(x, r);
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = xr[at[j]];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] += t[j];
  }
}

// The cluster body's exchange of a tile, in parts.  `cta_band`: the
// warps' partial bands qp into the CTA's block X, through red; `armed`: an
// arrive is outstanding, whose wait comes before X is written (the
// cluster has read the last tile's blocks).  Ends with red free.
template <typename G>
__device__ __forceinline__ void cta_band(const float qp[Win<G>::kBandNT][4],
                                         float* red, float* X, bool& armed) {
  constexpr int NB = Win<G>::kBandNT;
  k5::store_partial<NB>(red, qp);
  __syncthreads();
  if (armed) cluster_wait();
  armed = false;
  cta_sum<NB>(X, red);
  __syncthreads();
}

// `cta_band_scores`: the band's and the scores' partials at once (the
// forward, whose red holds both), into X's band and scores.
template <typename G>
__device__ __forceinline__ void cta_band_scores(
    const float qp[Win<G>::kBandNT][4], const float s[G::kNT][4],
    float* red, float* X, bool& armed) {
  constexpr int NB = Win<G>::kBandNT, NS = G::kNT;
  k5::store_partial<NB>(red, qp);
  k5::store_partial<NS>(red + k5::kPartialFloats<NB>, s);
  __syncthreads();
  if (armed) cluster_wait();
  armed = false;
  cta_sum<NB>(X, red);
  cta_sum<NS>(X + kSlotFloats<NB>, red + k5::kPartialFloats<NB>);
}

// `cta_scores`: the warps' partial scores s (and dp, where DP) into X after
// the band, through red.
template <typename G, bool DP>
__device__ __forceinline__ void cta_scores(const float s[G::kNT][4],
                                           const float dp[G::kNT][4],
                                           float* red, float* X) {
  constexpr int NB = Win<G>::kBandNT, NS = G::kNT;
  constexpr int kB = kSlotFloats<NB>, kS = kSlotFloats<NS>;
  k5::store_partial<NS>(red, s);
  if constexpr (DP) k5::store_partial<NS>(red + k5::kPartialFloats<NS>, dp);
  __syncthreads();
  cta_sum<NS>(X + kB, red);
  if constexpr (DP) cta_sum<NS>(X + kB + kS, red + k5::kPartialFloats<NS>);
}

// `cluster_sums`, after the CTA's block is written: one cluster barrier,
// then the band QPs (rows ldq apart) and s (dp) the cluster's sums, in
// every CTA the same bits.  Ends with an arrive outstanding (`armed`) and
// the band readable by every warp.
template <typename G, bool DP>
__device__ __forceinline__ void cluster_sums(float* QPs, int ldq,
                                             float s[G::kNT][4],
                                             float dp[G::kNT][4], float* X,
                                             int n, bool& armed) {
  constexpr int NB = Win<G>::kBandNT, NS = G::kNT;
  constexpr int kB = kSlotFloats<NB>, kS = kSlotFloats<NS>;
  cluster_arrive();
  cluster_wait();   // every CTA's block whole
  constexpr int JB = kB / kThreads;   // band elements a thread
  static_assert(kB % kThreads == 0, "band elements");
  constexpr int JS = (DP ? 2 : 1) * NS * 4;   // s (and dp) of a lane
  int at[JB + JS];
  float v[JB + JS];
#pragma unroll
  for (int j = 0; j < JB; ++j) at[j] = threadIdx.x + j * kThreads;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < JS; ++j)   // s's (nt, e), then dp's
    at[JB + j] = kB + (j >= NS * 4 ? kS : 0) + (j % (NS * 4)) * 32 + lane;
  cluster_sum(v, X, at, n);
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    const int idx = at[j];
    const int ln = idx & 31, nt = idx >> 7, e = (idx >> 5) & 3;
    QPs[((ln >> 2) + ((e >> 1) << 3)) * ldq + nt * 8 + ((ln & 3) << 1) +
        (e & 1)] = v[j];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = v[JB + nt * 4 + e];
      if constexpr (DP) dp[nt][e] = v[JB + NS * 4 + nt * 4 + e];
    }
  cluster_arrive();
  armed = true;
  __syncthreads();
}

// The cluster body's columns of a CTA and of one of its warps (CL: CTA c
// takes [512 c, 512 c + 512), its warp w the 128 from 512 c + 128 w), or
// DKP's whole quarter of a warp.  (Spreading dk 520 evenly, 80 columns a
// warp, 320 and 200 a CTA, ran 1.2-1.4x slower than 512 and 8 on an
// H100: PERF.md section 6.)
struct Slab {
  int col0;   // the CTA's first column
  int gw;     // the warp's first column
  int live;   // the warp's columns before dk (<= 0: none)
};

template <bool CL, typename G>
__device__ __forceinline__ Slab slab(const Cta& cta, int dk, int warp) {
  if constexpr (CL) {
    const int col0 = cta.rank * 4 * G::kDV, gw = col0 + warp * G::kDV;
    return {col0, gw, dk - gw < G::kDV ? dk - gw : G::kDV};
  } else {
    return {0, 0, G::kDV};
  }
}

// s = 0 (a warp past dk forms no partial).
template <int NT>
__device__ __forceinline__ void zero_tile(float s[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
}

// Launch `kernel` on `grid` in clusters of nc CTAs along x (at most 8, the
// portable size).  A cluster the card cannot schedule makes the launch
// return its error; nothing else runs instead.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int nc, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Row group rw's ds as its band U over its QP rows (the backward's band
// staging): planes of ds (rounded to bf16 in bf16, as the JAX kernel casts
// it; hi and lo in float32) at band column j - (i mod 16) + 15, and zeros
// at the row's 16 other band columns, which the QP rows overwrote.
template <typename G>
__device__ __forceinline__ void store_u(bf16* Us, float ds[G::kNT][4],
                                        int rw) {
  using W = Win<G>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (rw * 16 + row_of(e)) * W::kRowH + col_of(nt, e) -
                     row_of(e) + 15;
      const bf16 hi = __float2bfloat16(ds[nt][e]);
      Us[at] = hi;
      if constexpr (G::kPlanes > 1)
        Us[W::kLdu + at] = __float2bfloat16(ds[nt][e] - __bfloat162float(hi));
    }
  // row r, its j-th column off the band: [0, 15 - r) then [T + 15 - r, T + 16)
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int q = lane + 32 * t, r = q >> 4, j = q & 15;
    const int at = (rw * 16 + r) * W::kRowH + (j < 15 - r ? j : W::kTile + j);
#pragma unroll
    for (int p = 0; p < G::kPlanes; ++p)
      Us[p * W::kLdu + at] = __float2bfloat16(0.0f);
  }
}

// acc (row group rw's 16 rows x the warp's kDV columns from c0) += U .
// Kr^T: the staged band U (16 rows from a0 x kBand) times the window rows
// of the staged krel (DKP rows, n-major), band column b at window column
// c_lo + b; split products as K5's (ds as two planes in float32, one bf16
// value in bf16).
template <typename G, int DKP>
__device__ __forceinline__ void unskew_product(float acc[G::kDV / 8][4],
                                               const bf16* Us, int a0,
                                               const bf16* Kr, int c0,
                                               int c_lo) {
  using W = Win<G>;
  constexpr int P = G::kPlanes;
#pragma unroll
  for (int kk = 0; kk < W::kBand / 16; ++kk) {
    uint32_t a[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i)
      mma::load_a(a[i], Us + i * W::kLdu, W::kRowH, a0, kk * 16);
#pragma unroll
    for (int dp = 0; dp < G::kDV / 16; ++dp) {
      uint32_t b[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j)
        mma::load_b_nmajor(b[j], Kr + j * DKP * W::kLdw, W::kLdw,
                           c0 + dp * 16, c_lo + kk * 16);
#pragma unroll
      for (int d = 0; d < P; ++d)
#pragma unroll
        for (int i = d; i >= 0; --i) {
          mma::mma_bf16(acc[2 * dp], a[i], b[d - i][0], b[d - i][1]);
          mma::mma_bf16(acc[2 * dp + 1], a[i], b[d - i][2], b[d - i][3]);
        }
    }
  }
}

// The window's dkrel accumulators of the diagonal pass: the (DKP x 2T)
// product Q^T . U over a tile's query rows, split over the 4 warps by d
// (16-row m tiles) and, at DKP 32, by halves of the window.
template <typename G, int DKP>
struct DkrelSplit {
  static constexpr int kMT = DKP / 16;                  // d tiles
  static constexpr int kNT = Win<G>::kCols / 8;         // window n8 tiles
  static constexpr int kColSplit = kMT < 4 ? 4 / kMT : 1;
  static constexpr int kWD = kMT * kColSplit / 4;       // d tiles a warp
  static constexpr int kWC = kNT / kColSplit;           // n8 tiles a warp
};

// acc += Q^T . U of one tile: A = Q^T (d x query rows, from the staged q
// rows, k-major), B = the band U of each row group (query rows x band, k
// major) at window columns c_lo(rw) + band; the warp's d tiles from md0,
// window n8 tiles from cw0.
template <typename G, int DKP>
__device__ __forceinline__ void dkrel_product(
    float acc[DkrelSplit<G, DKP>::kWD][DkrelSplit<G, DKP>::kWC][4],
    const bf16* Qs, const bf16* Us, int md0, int cw0) {
  using W = Win<G>;
  using D = DkrelSplit<G, DKP>;
  constexpr int P = G::kPlanes;
  if constexpr (D::kWD > 4) {
    // DKP 512, one row group: a d tile's A fragments loaded where they
    // are used, not all kWD at once (the same products in each
    // accumulator, in the same order)
    const int band0 = W::c_lo(0) / 8;
#pragma unroll
    for (int c = 0; c < D::kWC / 2; ++c) {
      const int bt = cw0 + 2 * c - band0;
      if (bt < 0 || bt >= W::kBandNT) continue;
      uint32_t b[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j)
        mma::load_b_kmajor(b[j], Us + j * W::kLdu, W::kRowH, 0, bt * 8);
#pragma unroll
      for (int m = 0; m < D::kWD; ++m) {
        uint32_t a[P][4];
#pragma unroll
        for (int i = 0; i < P; ++i)
          mma::load_a_kmajor(a[i], Qs + i * G::kPlaneElems, G::kLd,
                             (md0 + m) * 16, 0);
#pragma unroll
        for (int d = 0; d < P; ++d)
#pragma unroll
          for (int i = d; i >= 0; --i) {
            mma::mma_bf16(acc[m][2 * c], a[i], b[d - i][0], b[d - i][1]);
            mma::mma_bf16(acc[m][2 * c + 1], a[i], b[d - i][2],
                          b[d - i][3]);
          }
      }
    }
    return;
  }
#pragma unroll
  for (int rw = 0; rw < G::kRowWarps; ++rw) {
    const int band0 = W::c_lo(rw) / 8;   // window n8 tile of band tile 0
    uint32_t a[D::kWD][P][4];
#pragma unroll
    for (int m = 0; m < D::kWD; ++m)
#pragma unroll
      for (int i = 0; i < P; ++i)
        mma::load_a_kmajor(a[m][i], Qs + i * G::kPlaneElems, G::kLd,
                           (md0 + m) * 16, rw * 16);
#pragma unroll
    for (int c = 0; c < D::kWC / 2; ++c) {
      const int bt = cw0 + 2 * c - band0;   // band n8 tile
      if (bt < 0 || bt >= W::kBandNT) continue;
      uint32_t b[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j)
        mma::load_b_kmajor(b[j], Us + j * W::kLdu, W::kRowH, rw * 16,
                           bt * 8);
#pragma unroll
      for (int m = 0; m < D::kWD; ++m)
#pragma unroll
        for (int d = 0; d < P; ++d)
#pragma unroll
          for (int i = d; i >= 0; --i) {
            mma::mma_bf16(acc[m][2 * c], a[m][i], b[d - i][0], b[d - i][1]);
            mma::mma_bf16(acc[m][2 * c + 1], a[m][i], b[d - i][2],
                          b[d - i][3]);
          }
    }
  }
}

// Up to four operands of one call, (K, B*S, D) each.
template <typename T>
struct HeadOperands {
  const T* x[4];
};

// krel's padded copy: (K, P, DKP, sk) bf16 planes, column x holding krel
// column x - off (off = (-S) mod 8), zero past dk and outside [0, S).
template <typename T>
static __global__ void krel_planes(const T* __restrict__ krel,
                            bf16* __restrict__ dst, int K, int dk, int S,
                            int dkp, int sk, int n_planes) {
  const int off = sk - S;
  const size_t n = (size_t)K * dkp * sk;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int x = (int)(e % sk), d = (int)(e / sk % dkp);
    const int kk = (int)(e / ((size_t)sk * dkp));
    const int r = x - off;
    float v = d < dk && r >= 0 && r < S
                  ? to_f32(krel[((size_t)kk * dk + d) * S + r])
                  : 0.0f;
    for (int p = 0; p < n_planes; ++p) {
      const bf16 h = __float2bfloat16(v);
      dst[(((size_t)kk * n_planes + p) * dkp + d) * sk + x] = h;
      v -= __bfloat162float(h);
    }
  }
}

// The operands' planes by head: operand o (blockIdx.y) of `src` (natural
// (K, B*S, D) rows of T) to planes + o * n_planes * (N, S, dkp), each plane
// the bf16 rounding of what the planes before it left, zero past dk: the
// float32 operands' split, and the bf16 operands' aligned copy where dk is
// no multiple of 8.
template <typename T>
static __global__ void head_planes(HeadOperands<T> src,
                                   bf16* __restrict__ planes, int n_heads,
                                   int S, int nheads, int dk, int dkp,
                                   int n_planes) {
  const int cv = dkp / 8;                    // 8-column pieces a row
  const size_t total = (size_t)n_heads * S * cv;   // a thread a piece
  const size_t n = (size_t)n_heads * S * dkp;
  const T* x = src.x[blockIdx.y];
  bf16* out = planes + n_planes * n * blockIdx.y;
  const size_t D = (size_t)nheads * dk;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t row = idx / cv;                          // row: n S + s
    const int c = (int)(idx - row * cv) * 8;
    const int head = (int)(row / S), s = (int)(row - (size_t)head * S);
    const T* xr = x + ((size_t)(head / nheads) * S + s) * D +
                  (size_t)(head % nheads) * dk;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c + e < dk ? to_f32(xr[c + e]) : 0.0f;
    for (int p = 0; p < n_planes; ++p) {
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        wp[e] = *reinterpret_cast<const uint32_t*>(&h);
        v[2 * e] -= __low2float(h);
        v[2 * e + 1] -= __high2float(h);
      }
      *reinterpret_cast<uint4*>(out + p * n + (size_t)row * dkp + c) = w;
    }
  }
}

inline int grid_of(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 4096 ? (b ? b : 1) : 4096);
}

inline size_t round256(size_t bytes) { return (bytes + 255) / 256 * 256; }

// krel's padded planes and the operands' planes (float32: split; bf16
// where dk is no multiple of 8: copied to aligned rows): the scratch both
// directions share, in bytes.
struct Prep {
  int dkp, sk, planes;
  bool pack;
  size_t krel_bytes, ops_bytes;

  Prep(int K, int n_heads, int S, int dk, int dtype, int n_ops,
       int f32_planes) {
    dkp = plane_width(dk);
    sk = (S + 7) / 8 * 8;
    planes = dtype == kFloat32 ? f32_planes : 1;
    pack = dtype == kFloat32 || dk % 8 != 0;
    krel_bytes = round256((size_t)K * planes * dkp * sk * sizeof(bf16));
    ops_bytes = pack ? (size_t)n_ops * planes * n_heads * S * dkp *
                           sizeof(bf16)
                     : 0;
  }
  size_t bytes() const { return krel_bytes + ops_bytes; }
};

// Fills `scratch` with krel's padded planes and, where `pr.pack`, the n_ops
// operands' planes, and H with where the kernels stage them from; returns
// the padded krel planes.  bf16 operands that are not packed are read in
// place: their rows and head offsets are 16-byte aligned (dk % 8 == 0 and
// 16-byte aligned tensors, which the wrapper guarantees).
template <typename T>
cudaError_t prepare(const Prep& pr, const void* krel, const void* const* ops,
                    int n_ops, void* scratch, int K, int n_batch, int S,
                    int nheads, int dk, Heads& H, const bf16*& krp,
                    cudaStream_t stream) {
  bf16* kr = static_cast<bf16*>(scratch);
  const size_t nk = (size_t)K * pr.dkp * pr.sk;
  krel_planes<T><<<grid_of(nk), 256, 0, stream>>>(
      static_cast<const T*>(krel), kr, K, dk, S, pr.dkp, pr.sk, pr.planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  krp = kr;
  H.n_batch = n_batch;
  H.S = S;
  H.nheads = nheads;
  H.dk = dk;
  if (pr.pack) {
    const int n_heads = K * n_batch * nheads;
    bf16* planes = reinterpret_cast<bf16*>(static_cast<char*>(scratch) +
                                           pr.krel_bytes);
    HeadOperands<T> src{};
    for (int o = 0; o < n_ops; ++o) src.x[o] = static_cast<const T*>(ops[o]);
    const size_t n = (size_t)n_heads * S * pr.dkp;
    head_planes<T><<<dim3(grid_of(n / 8), n_ops), 256, 0, stream>>>(
        src, planes, n_heads, S, nheads, dk, pr.dkp, pr.planes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    for (int o = 0; o < n_ops; ++o) H.p[o] = planes + o * pr.planes * n;
    H.lds = pr.dkp;
    H.plane = n;
    H.planes = true;
  } else {
    for (int o = 0; o < n_ops; ++o) H.p[o] = static_cast<const bf16*>(ops[o]);
    H.lds = nheads * dk;
    H.plane = 0;
    H.planes = false;
  }
  return cudaSuccess;
}

}  // namespace k2
}  // namespace cpc
