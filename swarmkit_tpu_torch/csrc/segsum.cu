// K2: per-branch sums for stage A of the hierarchical water-fill.
//
// Replaces the branch_arrays sums of swarmkit_tpu/ops/kernel.py:305-312
// (plan_group's stage A).  For every segment s it sums the valid nodes'
// clipped service counts (the branch load) and the nodes' capacities (the
// branch capacity), then clamps the load to LOAD_CLAMP and the capacity to
// the group size k, exactly as the reference does after its segment sums.
//
// The reference sums in float32; this kernel sums in int64, which is exact
// and the same in every order.  The two agree on every output: addends are
// non-negative, so a float32 total is exact below 2^24 and stays >= 2^24
// above it, and both clamps (LOAD_CLAMP = 2^24 - 1, k <= 2^22) sit below.
//
// Bound on the H100: bytes (13 bytes read per node, 16 written per
// segment).  Design: a grid-stride pass; while the segment count is small
// enough, each block first sums into int64 partials in shared memory and
// adds only its non-zero partials to the global int64 sums, so the global
// atomics scale with blocks x segments, not with nodes.  A second small
// kernel applies the clamps once every block has added its partials.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemSegments = 2048;  // 2 x 8 bytes x 2048 = 32 KB

__global__ void __launch_bounds__(kThreads) seg_sum_kernel(
    int n, int L, int use_smem, const int32_t* __restrict__ svc_tasks,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ seg,
    unsigned long long* __restrict__ acc) {  // [2, L]: load, capacity
  extern __shared__ unsigned long long part[];  // [2, L] when use_smem
  unsigned long long* dst = use_smem ? part : acc;
  if (use_smem) {
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x) part[s] = 0;
    __syncthreads();
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = seg[i];
    if ((unsigned)s >= (unsigned)L) continue;  // dropped, as segment_sum does
    const int load = valid[i] ? sk::clamp_int(svc_tasks[i], 0, sk::SVC_CLAMP)
                              : 0;
    const int c = cap[i];  // >= 0: feasibility output
    if (load > 0) atomicAdd(&dst[s], (unsigned long long)load);
    if (c > 0) atomicAdd(&dst[L + s], (unsigned long long)c);
  }
  if (use_smem) {
    __syncthreads();
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x)
      if (part[s] != 0) atomicAdd(&acc[s], part[s]);
  }
}

// The clamps, on the sum of `rows` [2, L] rows of acc taken in row order
// (one row unsharded, D on a node-axis split); raw_out, when given,
// receives the summed capacity.
__global__ void __launch_bounds__(kThreads) seg_clamp_kernel(
    int L, int rows, const unsigned long long* __restrict__ acc,
    const int32_t* __restrict__ k_ptr, int32_t* __restrict__ load,
    int32_t* __restrict__ bcap, long long* __restrict__ raw_out,
    int32_t* __restrict__ kk_out) {
  const long long kk = min(*k_ptr, sk::K_CLAMP);
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < L;
       s += gridDim.x * blockDim.x) {
    long long ld = 0, cp = 0;
    for (int d = 0; d < rows; ++d) {
      ld += (long long)acc[(size_t)d * 2 * L + s];
      cp += (long long)acc[(size_t)d * 2 * L + L + s];
    }
    load[s] = (int)min(ld, sk::LOAD_CLAMP);
    bcap[s] = (int)min(cp, kk);
    if (raw_out != nullptr) raw_out[s] = cp;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *kk_out = (int)kk;
}

int launch_clamp(int L, int rows, const void* acc, const void* k,
                 void* load, void* bcap, void* raw_out, void* kk_out,
                 cudaStream_t st) {
  int blocks = (L + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  seg_clamp_kernel<<<blocks, kThreads, 0, st>>>(
      L, rows, (const unsigned long long*)acc, (const int32_t*)k,
      (int32_t*)load, (int32_t*)bcap, (long long*)raw_out,
      (int32_t*)kk_out);
  return (int)cudaGetLastError();
}

}  // namespace

// acc must hold zeros on entry; raw branch capacities stay in acc[L:2L].
// With load == null only the (unclamped) sums are written: one shard's
// partials on a node-axis split.
extern "C" int sk_seg_sum(int n, int L, const void* svc_tasks,
                          const void* valid, const void* cap, const void* seg,
                          const void* k, void* acc, void* load, void* bcap,
                          void* kk_out, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    const int use_smem = L <= kMaxSmemSegments;
    const size_t smem = use_smem ? 2 * sizeof(unsigned long long) * L : 0;
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 1024) blocks = 1024;
    seg_sum_kernel<<<blocks, kThreads, smem, st>>>(
        n, L, use_smem, (const int32_t*)svc_tasks, (const uint8_t*)valid,
        (const int32_t*)cap, (const int32_t*)seg, (unsigned long long*)acc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (load == nullptr) return 0;
  return launch_clamp(L, 1, acc, k, load, bcap, nullptr, kk_out, st);
}

// The cross-shard fold of K2: `rows` = the [D, 2, L] partials of every
// shard, summed in shard order, then clamped; raw_cap receives the summed
// capacity (int64 [L]).
extern "C" int sk_seg_fold(int D, int L, const void* rows, const void* k,
                           void* load, void* bcap, void* raw_cap,
                           void* kk_out, void* stream) {
  if (L <= 0 || D <= 0) return 0;
  return launch_clamp(L, D, rows, k, load, bcap, raw_cap, kk_out,
                      (cudaStream_t)stream);
}
