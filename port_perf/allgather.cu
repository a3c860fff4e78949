// A 16-CTA all-gather of one BLK-byte block a CTA a step, three ways, for
// port_perf/allgather.py:
//   0 "stores": each thread copies 16-byte pieces of its CTA's block into
//     the 15 other CTAs with st.shared::cluster, then a cluster barrier
//     (how K1's backward pushes its partial products);
//   1 "bulk": 15 cp.async.bulk copies shared -> remote shared a step, each
//     counted by the receiver's mbarrier, two parities, no cluster barrier;
//   2 "multicast": the block goes to global memory and one cp.async.bulk
//     ... .multicast::cluster hands it to all 16 CTAs (how K1's forward
//     all-gathers h);
//   3 "barrier": the cluster barrier alone.
// Every step's block carries (rank, step) in its first two words; after
// the last step each CTA counts the blocks that do not, into bad[].
#include "../cpc_audio_tpu_torch/csrc/rnn_cluster.cuh"

namespace rnn = cpc::rnn;

namespace {

constexpr int kC = 16, kThreads = 512;

__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(cpc::mma::smem_addr(p)), "r"(rank));
  return addr;
}

template <int MODE, int BLK>
__global__ void __launch_bounds__(kThreads, 1)
    allgather_kernel(int steps, unsigned char* scratch, int* bad) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf = smem;                          // [2][kC][BLK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kC * BLK);
  const int c = rnn::cluster_rank(), tid = threadIdx.x;
  if (tid == 0) {
    rnn::mbar_init(full, 1);
    rnn::mbar_init(full + 1, 1);
    rnn::fence_mbar_init();
  }
  __syncthreads();
  rnn::cluster_sync();
  for (int t = 0; t < steps; ++t) {
    const int q = t & 1;
    unsigned char* own = buf + (q * kC + c) * BLK;
    unsigned char* glob =
        scratch + (((size_t)q * gridDim.y + blockIdx.y) * kC + c) * BLK;
    if (MODE == 2) {
      if (tid == 0) rnn::multicast_read_wait<1>();
      __syncthreads();
    }
    if (tid == 0) {
      int* head = reinterpret_cast<int*>(MODE == 2 ? glob : own);
      head[0] = c;
      head[1] = t;
    }
    if (MODE == 0) {
      __syncthreads();
      for (int idx = tid; idx < (kC - 1) * (BLK / 16); idx += kThreads) {
        const int d = idx / (BLK / 16), s = idx % (BLK / 16);
        const float4 v = *reinterpret_cast<const float4*>(own + s * 16);
        rnn::store_remote(reinterpret_cast<const float*>(own + s * 16),
                          d < c ? d : d + 1, v);
      }
      rnn::cluster_sync();
    } else if (MODE == 1 || MODE == 2) {
      if (tid == 0)
        rnn::mbar_expect(full + q, (MODE == 1 ? kC - 1 : kC) * BLK);
      if (MODE == 1)
        rnn::fence_proxy_shared();
      else
        rnn::fence_proxy_global();
      __syncthreads();
      if (MODE == 1 && tid < kC - 1) {
        const int d = tid < c ? tid : tid + 1;
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];\n" ::"r"(remote(own, d)),
            "r"(cpc::mma::smem_addr(own)), "r"(BLK),
            "r"(remote(full + q, d))
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      if (MODE == 2 && tid == 0)
        rnn::multicast(own, glob, BLK, full + q, 0xffff);
      rnn::mbar_wait(full + q, (t >> 1) & 1);
      // the next write of this parity's block (step t + 2) comes after
      // every CTA has its copy of step t + 1, so after this one is read
    } else {
      rnn::cluster_sync();
    }
  }
  if (MODE == 2 && tid == 0) rnn::multicast_read_wait<0>();
  rnn::cluster_sync();
  if (MODE != 3 && tid < kC && (tid != c || MODE == 2)) {
    const int* head =
        reinterpret_cast<const int*>(buf + (((steps - 1) & 1) * kC + tid) *
                                               BLK);
    if (head[0] != tid || head[1] != steps - 1) atomicAdd(bad, 1);
  }
}

template <int MODE, int BLK>
int run(int clusters, int steps, unsigned char* scratch, int* bad,
        cudaStream_t s) {
  const size_t smem = 2 * kC * BLK + 2 * sizeof(uint64_t);
  auto kernel = allgather_kernel<MODE, BLK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, steps, scratch, bad);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BLK>
int run_mode(int mode, int clusters, int steps, unsigned char* scratch,
             int* bad, cudaStream_t s) {
  switch (mode) {
    case 0: return run<0, BLK>(clusters, steps, scratch, bad, s);
    case 1: return run<1, BLK>(clusters, steps, scratch, bad, s);
    case 2: return run<2, BLK>(clusters, steps, scratch, bad, s);
    case 3: return run<3, BLK>(clusters, steps, scratch, bad, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// scratch: 2 * clusters * 16 * blk bytes; bad: one int, counted into.
extern "C" int allgather(int mode, int blk, int clusters, int steps,
                         void* scratch, void* bad, void* stream) {
  unsigned char* g = static_cast<unsigned char*>(scratch);
  int* b = static_cast<int*>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blk) {
    case 2048: return run_mode<2048>(mode, clusters, steps, g, b, s);
    case 3072: return run_mode<3072>(mode, clusters, steps, g, b, s);
    case 4096: return run_mode<4096>(mode, clusters, steps, g, b, s);
    case 6144: return run_mode<6144>(mode, clusters, steps, g, b, s);
  }
  return (int)cudaErrorInvalidValue;
}
