// Shared integer envelope of the scheduling kernels.  The values mirror
// swarmkit_tpu_torch/ops/kernel.py (the plain PyTorch versions) and the
// reference's swarmkit_tpu/ops/kernel.py:61-73; the CPU tests hold the two
// Python versions bit-equal and chip_smoke.py holds these kernels bit-equal
// to the plain versions on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sk {

constexpr int K_CLAMP = 1 << 22;          // max group size
constexpr int SVC_CLAMP = (1 << 20) - 1;  // per-service count clamp
constexpr int F_BIG = 1 << 22;            // failure down-weight step
constexpr int FAILURE_CLAMP = 63;
constexpr long long LOAD_CLAMP = (1LL << 24) - 1;  // branch-load clamp
constexpr int TOTAL_CLAMP = (1 << 10) - 1;
constexpr int IDX_BITS = 20;
constexpr int LEVEL_ITERS = 34;           // binary search over [0, 2^30]
constexpr int TIE_ITERS = 34;             // binary search over tie keys
constexpr int SEARCH_HI = 1 << 30;

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Sum of v over a block of kWarps full warps; every thread gets the total.
// `red` is kWarps + 1 shared slots.  It synchronises the block, so every
// thread must call it.  The one-segment searches of K3 and K5 use it in
// place of shared-memory atomics that all hit one address.
template <int kWarps>
__device__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? red[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_down_sync(0xffffffffu, w, off);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const long long total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

}  // namespace sk
