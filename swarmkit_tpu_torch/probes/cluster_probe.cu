// Probe of the Hopper primitives that the water-fill kernel (K3,
// csrc/waterfill.cu) is built from: what a cluster barrier, a shared-memory
// atomic, an st.async exchange between the blocks of a cluster and a warp
// reduction cost per step of a 69-step search.  A standalone program with
// no inputs; each line is the time of one step in microseconds (CUDA
// events over 2,000 steps in one launch).  Build and run on the card, from
// the root of the checkout (the binary goes to the git-ignored build
// directory of that checkout):
//
//   mkdir -p swarmkit_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o swarmkit_tpu_torch/_build/cluster_probe \
//       swarmkit_tpu_torch/probes/cluster_probe.cu
//   swarmkit_tpu_torch/_build/cluster_probe
//
// It decided K3's design: no release/acquire cluster.sync() in the loop
// (an st.async round and an mbarrier wait instead), 32-bit shared
// counters (64-bit shared atomics are compare-and-swap loops), and warp
// reductions only over whole warps (a partial-mask __reduce_add_sync runs
// once per distinct mask).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// ---- cluster barriers: cg's (arrive.release + wait.acquire) and relaxed
__global__ void cluster_sync(int iters) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cl.sync();
}

__global__ void cluster_sync_relaxed(int iters) {
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
}

// ---- every block pushes L u64 to every block with st.async; each waits
// for kCluster * L * 8 bytes on its mbarrier and sums the rows
__global__ void exchange(int iters, int L, unsigned long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ unsigned long long rows[];  // [2][C][L]
  __shared__ __align__(8) unsigned long long bars[2];
  const int C = (int)cl.num_blocks();
  const uint32_t rank = cl.block_rank();
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bars[p])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  unsigned long long check = 0;
  for (int t = 0; t < iters; ++t) {
    const int par = t & 1;
    const uint32_t bar = smem_addr(&bars[par]);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"((uint32_t)(C * L * 8)) : "memory");
    for (int j = threadIdx.x; j < C * L; j += blockDim.x) {
      const int c = j / L, s = j - c * L;
      const unsigned long long v = (unsigned long long)(t + 1) * (rank + 1) + s;
      const uint32_t dst = smem_addr(&rows[((size_t)par * C + rank) * L + s]);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], "
          "%1, [%2];" :: "r"(map_rank(dst, c)), "l"(v), "r"(map_rank(bar, c))
          : "memory");
    }
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.b32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar), "r"((uint32_t)((t >> 1) & 1)) : "memory");
    for (int s = threadIdx.x; s < L; s += blockDim.x)
      for (int b = 0; b < C; ++b) check += rows[((size_t)par * C + b) * L + s];
    __syncthreads();
  }
  if (check == 1) *out = check;  // keeps the sums
  cl.sync();
}

// ---- one block: 64-bit vs 32-bit shared atomics, one warp lane each
template <class T>
__global__ void smem_atomics(int iters, int naddr, T* out) {
  __shared__ T s[32];
  if (threadIdx.x < 32) s[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < iters; ++i) {
    if (lane < naddr) atomicAdd(&s[lane], (T)1);
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

// ---- one block, two elements a thread: summing per segment with
// __reduce_add_sync over each segment's lanes (mode 0), lane by lane with
// 32-bit shared atomics (1), or a whole-warp reduction where the warp holds
// one segment and lane by lane elsewhere (2).  pattern: 0 one segment,
// 1 lane % 20, 2 every element its own
__global__ void aggregate(int iters, int mode, int pattern, unsigned* out) {
  __shared__ unsigned acc[3][4096];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int j = tid; j < 3 * 4096; j += blockDim.x) (&acc[0][0])[j] = 0;
  int seg[2];
  unsigned peers[2];
  for (int q = 0; q < 2; ++q) {
    const int idx = q * 1024 + tid;
    seg[q] = pattern == 0 ? 0 : pattern == 1 ? lane % 20 : idx;
    peers[q] = __match_any_sync(kFull, seg[q]);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int q = 0; q < 2; ++q) {
      const unsigned v = (unsigned)(it * 7 + tid) & 0x3fffffu;
      const unsigned part[3] = {v & 0x7ffu, (v >> 11) & 0x7ffu, v >> 22};
      const bool whole = peers[q] == kFull;
      if (mode == 0 || (mode == 2 && whole)) {
        unsigned sum[3];
        for (int p = 0; p < 3; ++p)
          sum[p] = __reduce_add_sync(peers[q], part[p]);
        if (lane == __ffs(peers[q]) - 1)
          for (int p = 0; p < 3; ++p) atomicAdd(&acc[p][seg[q]], sum[p]);
      } else {
        for (int p = 0; p < 3; ++p) atomicAdd(&acc[p][seg[q]], part[p]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) *out = acc[0][0] + acc[1][1] + acc[2][2];
}

template <class F, class... A>
float step_us(F kern, int blocks, int threads, size_t smem, A... args) {
  const int iters = 2000;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, kern, 10, args...);  // warm
  cudaEventRecord(a);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, iters, args...);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  if (e != cudaSuccess || cudaGetLastError() != cudaSuccess) {
    printf("launch failed: %s\n", cudaGetErrorString(e));
    return -1;
  }
  return ms * 1e3f / iters;
}

int main() {
  unsigned long long* o64;
  unsigned* o32;
  cudaMalloc(&o64, 8);
  cudaMalloc(&o32, 4);
  for (int C : {8, 16})
    printf("cluster of %2d x 1024 threads: cluster.sync() %.3f us, relaxed "
           "arrive + wait %.3f us\n", C, step_us(cluster_sync, C, 1024, 0),
           step_us(cluster_sync_relaxed, C, 1024, 0));
  for (int C : {8, 16})
    for (int L : {1, 20, 256})
      printf("st.async exchange, cluster of %2d x 1024, %3d values a block: "
             "%.3f us\n", C, L,
             step_us(exchange, C, 1024, (size_t)2 * C * L * 8, L, o64));
  printf("shared atomics, 1024 threads, one lane a warp on 20 addresses: "
         "64-bit %.3f us, 32-bit %.3f us\n",
         step_us(smem_atomics<unsigned long long>, 1, 1024, 0, 20, o64),
         step_us(smem_atomics<unsigned>, 1, 1024, 0, 20, o32));
  const char* pattern[] = {"one segment", "lane % 20", "own segment"};
  for (int p = 0; p < 3; ++p)
    printf("per-segment sums, 2048 elements (%s): partial-mask reduce "
           "%.3f us, lane by lane %.3f us, whole-warp reduce else lane by "
           "lane %.3f us\n", pattern[p],
           step_us(aggregate, 1, 1024, 0, 0, p, o32),
           step_us(aggregate, 1, 1024, 0, 1, p, o32),
           step_us(aggregate, 1, 1024, 0, 2, p, o32));
  return 0;
}
