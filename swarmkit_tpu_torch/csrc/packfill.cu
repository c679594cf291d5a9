// K5: the binpack fill of one group over all nodes (one segment).
//
// Replaces swarmkit_tpu/ops/kernel.py:428 seg_packfill, as the binpack
// branch of plan_strategy (:521-527) calls it: one segment (L = 1), the
// key computed here.  The key is score << 20 | i, where score is
// clip(res_cap, 0, BP_CLAMP), or BP_CLAMP + 1 + clip(failures, 0, 63) once
// a node has failed this service MAX_FAILURES times.  The kernel finds the
// least key threshold thr with sum(cap_i : key_i <= thr) >= k (a 34-step
// binary search over [-1, 2^30]), gives every node with key_i < thr its
// full capacity, and the one node AT the threshold (keys are unique) the
// remainder min(cap_i, k - sum(below)).  When the whole capacity is short
// of k, thr stays 2^30 and every node takes its capacity.
//
// Bound on the H100: latency, like K3.  The function moves 12 bytes per
// node in (res_cap, failures, cap) and 4 out, but its 36 passes depend on
// each other, each a sum over all nodes.  The design runs the whole search
// in ONE block: each thread sums its nodes into a register and the block
// reduces with warp shuffles (sk::block_sum), which also hands every thread
// the total, so the threshold bounds live in registers.  Sums are int64,
// exact; the reference's float32 sums decide every comparison the same way
// (see segsum.cu), and its remainder is exact whenever it is positive.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBpClamp = 959;  // scheduler/strategy.py BP_CLAMP

__device__ __forceinline__ int binpack_key(int i, int res_cap, int failures,
                                           int max_failures) {
  const int score = failures >= max_failures
                        ? kBpClamp + 1 + sk::clamp_int(failures, 0,
                                                       sk::FAILURE_CLAMP)
                        : sk::clamp_int(res_cap, 0, kBpClamp);
  return (score << sk::IDX_BITS) | i;
}

__global__ void __launch_bounds__(kThreads) packfill_kernel(
    int n, const int32_t* __restrict__ res_cap,
    const int32_t* __restrict__ failures, int max_failures,
    const int32_t* __restrict__ cap, const int32_t* __restrict__ k_ptr,
    int32_t* __restrict__ x) {
  __shared__ long long red[kWarps + 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long k = k_ptr[0];

  // ---- threshold search: the least thr with capacity >= k
  int lo = -1, hi = sk::SEARCH_HI;
  for (int it = 0; it < sk::TIE_ITERS; ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    long long mine = 0;
    for (int i = tid; i < n; i += nt) {
      const int c = cap[i];
      if (c != 0 && binpack_key(i, res_cap[i], failures[i], max_failures)
                        <= mid)
        mine += c;
    }
    if (sk::block_sum<kWarps>(mine, red) >= k) hi = mid;
    else lo = mid + 1;
  }

  // ---- full capacities below the threshold, and the remainder
  long long below = 0;
  for (int i = tid; i < n; i += nt) {
    const int c = cap[i];
    if (c != 0 && binpack_key(i, res_cap[i], failures[i], max_failures) < hi)
      below += c;
  }
  const long long r = k - sk::block_sum<kWarps>(below, red);
  const int rem = r > 0 ? (int)r : 0;   // r <= k <= K_CLAMP when positive

  // ---- placement
  for (int i = tid; i < n; i += nt) {
    const int c = cap[i];
    const int key = binpack_key(i, res_cap[i], failures[i], max_failures);
    int xi = 0;
    if (key < hi) xi = c;
    else if (key == hi && rem > 0) xi = min(c, rem);
    x[i] = xi;
  }
}

}  // namespace

extern "C" int sk_packfill(int n, const void* res_cap, const void* failures,
                           int max_failures, const void* cap, const void* k,
                           void* x, void* stream) {
  if (n <= 0) return 0;
  packfill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const int32_t*)res_cap, (const int32_t*)failures, max_failures,
      (const int32_t*)cap, (const int32_t*)k, (int32_t*)x);
  return (int)cudaGetLastError();
}
