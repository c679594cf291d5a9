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
// segment), but at the main path's sizes (16,384 nodes, 256 segments) the
// device time is a few microseconds and the call's cost is the host's.
// Design: ONE launch a call.  A grid-stride pass; while the segment count
// is small enough each block first sums into int64 partials in shared
// memory and adds only its non-zero partials to a global int64
// accumulator, so the global atomics scale with blocks x segments, not
// with nodes.  The last block to finish (an atomic ticket after a
// __threadfence) takes every sum out of the accumulator with atomicExch,
// leaving it zero, applies the clamps, writes the outputs and resets the
// ticket.  So the accumulator is zero whenever no call runs: the wrapper
// keeps one per stream and never clears it, and calls that follow each
// other on a stream without a sync find it ready.
//
// seg_fold (the node-axis split) is a separate small launch: it sums the
// shards' rows of partials, which this kernel writes in its partial mode.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmemSegments = 2048;  // 2 x 8 bytes x 2048 = 32 KB
constexpr int kMaxBlocks = 264;         // two per SM

__global__ void __launch_bounds__(kThreads) seg_sum_kernel(
    int n, int L, int use_smem, const int32_t* __restrict__ svc_tasks,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ seg, const int32_t* __restrict__ k_ptr,
    unsigned long long* __restrict__ acc,  // [2, L]: load, capacity; zero
    unsigned int* __restrict__ ticket,     // zero on entry and on exit
    int32_t* __restrict__ load, int32_t* __restrict__ bcap,
    long long* __restrict__ raw, int32_t* __restrict__ kk_out,
    long long* __restrict__ rows) {  // partial mode: [2, L] unclamped sums
  extern __shared__ unsigned long long part[];  // [2, L] when use_smem
  __shared__ bool last;
  unsigned long long* dst = use_smem ? part : acc;
  if (use_smem) {
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x) part[s] = 0;
    __syncthreads();
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = seg[i];
    if ((unsigned)s >= (unsigned)L) continue;  // dropped, as segment_sum does
    const int ld = valid[i] ? sk::clamp_int(svc_tasks[i], 0, sk::SVC_CLAMP)
                            : 0;
    const int c = cap[i];  // >= 0: feasibility output
    if (ld > 0) atomicAdd(&dst[s], (unsigned long long)ld);
    if (c > 0) atomicAdd(&dst[L + s], (unsigned long long)c);
  }
  if (use_smem) {
    __syncthreads();
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x)
      if (part[s] != 0) atomicAdd(&acc[s], part[s]);
  }

  // ---- the last block to finish folds and clamps
  __threadfence();  // this thread's adds are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long kk = rows == nullptr ? min(*k_ptr, sk::K_CLAMP) : 0;
  for (int s = threadIdx.x; s < L; s += blockDim.x) {
    const long long ld = (long long)atomicExch(&acc[s], 0ull);
    const long long cp = (long long)atomicExch(&acc[L + s], 0ull);
    if (rows != nullptr) {
      rows[s] = ld;
      rows[L + s] = cp;
      continue;
    }
    load[s] = (int)min(ld, sk::LOAD_CLAMP);
    bcap[s] = (int)min(cp, kk);
    raw[s] = cp;
  }
  if (threadIdx.x == 0) {
    if (rows == nullptr) *kk_out = (int)kk;
    *ticket = 0;
  }
}

// The clamps, on the sum of `rows` [2, L] rows of partials taken in row
// order (D on a node-axis split); raw_out receives the summed capacity.
__global__ void __launch_bounds__(256) seg_clamp_kernel(
    int L, int rows, const long long* __restrict__ acc,
    const int32_t* __restrict__ k_ptr, int32_t* __restrict__ load,
    int32_t* __restrict__ bcap, long long* __restrict__ raw_out,
    int32_t* __restrict__ kk_out) {
  const long long kk = min(*k_ptr, sk::K_CLAMP);
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < L;
       s += gridDim.x * blockDim.x) {
    long long ld = 0, cp = 0;
    for (int d = 0; d < rows; ++d) {
      ld += acc[(size_t)d * 2 * L + s];
      cp += acc[(size_t)d * 2 * L + L + s];
    }
    load[s] = (int)min(ld, sk::LOAD_CLAMP);
    bcap[s] = (int)min(cp, kk);
    raw_out[s] = cp;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *kk_out = (int)kk;
}

}  // namespace

// The launch table, in host memory: scratch and output addresses.
struct SegSumTable {
  void* acc;     // [2, L] int64, zero on entry; zero again when the launch
  void* ticket;  // ends (uint32, likewise)
  void* load;    // full mode: the clamped branch arrays
  void* bcap;
  void* raw;     // int64 [L]
  void* kk;
  void* rows;    // partial mode: [2, L] int64 unclamped sums, overwritten
};

// One call, one launch.  Full mode (rows == null): load, bcap, raw and kk
// receive the clamped branch arrays.  Partial mode (load == null): rows,
// one shard's row of a node-axis split's exchange, receives the unclamped
// sums.
extern "C" int sk_seg_sum(int n, int L, const void* svc_tasks,
                          const void* valid, const void* cap, const void* seg,
                          const void* k, const void* table, void* stream) {
  if (L <= 0) return 0;
  const SegSumTable t = *(const SegSumTable*)table;
  if ((t.rows == nullptr) == (t.load == nullptr) ||
      (t.rows == nullptr && k == nullptr))
    return (int)cudaErrorInvalidValue;
  const int use_smem = L <= kMaxSmemSegments;
  const size_t smem = use_smem ? 2 * sizeof(unsigned long long) * L : 0;
  int blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  seg_sum_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      n, L, use_smem, (const int32_t*)svc_tasks, (const uint8_t*)valid,
      (const int32_t*)cap, (const int32_t*)seg, (const int32_t*)k,
      (unsigned long long*)t.acc, (unsigned int*)t.ticket,
      (int32_t*)t.load, (int32_t*)t.bcap, (long long*)t.raw,
      (int32_t*)t.kk, (long long*)t.rows);
  return (int)cudaGetLastError();
}

// The cross-shard fold of K2: `rows` = the [D, 2, L] partials of every
// shard, summed in shard order, then clamped; raw_cap receives the summed
// capacity (int64 [L]).
extern "C" int sk_seg_fold(int D, int L, const void* rows, const void* k,
                           void* load, void* bcap, void* raw_cap,
                           void* kk_out, void* stream) {
  if (L <= 0 || D <= 0) return 0;
  int blocks = (L + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  seg_clamp_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      L, D, (const long long*)rows, (const int32_t*)k, (int32_t*)load,
      (int32_t*)bcap, (long long*)raw_cap, (int32_t*)kk_out);
  return (int)cudaGetLastError();
}
