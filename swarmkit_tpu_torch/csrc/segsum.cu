// K2: per-branch sums for stage A of the hierarchical water-fill.
//
// Replaces the branch_arrays sums of swarmkit_tpu/ops/kernel.py:305-312
// (plan_group's stage A) and, over a node-axis split, their psum
// (swarmkit_tpu/parallel/sharded.py:95 plan_group_sharded).  For every
// segment s it sums the valid nodes' clipped service counts (the branch
// load) and the nodes' capacities (the branch capacity), then clamps the
// load to LOAD_CLAMP and the capacity to the group size k, exactly as the
// reference does after its segment sums.
//
// The reference sums in float32; this kernel sums in int64, which is exact
// and the same in every order.  The two agree on every output: addends are
// non-negative, so a float32 total is exact below 2^24 and stays >= 2^24
// above it, and both clamps (LOAD_CLAMP = 2^24 - 1, k <= 2^22) sit below.
//
// Bound on the H100: bytes (13 bytes read per node, 24 written per
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
// Two entries share that kernel, a template over how many column sets its
// rows come from:
//  * sk_seg_sum, one set: the unsharded plan's level;
//  * sk_shard_seg_sum, a node-axis split's level: every shard of the card
//    through shard.cuh's table (svc, valid, cap, seg), row i of shard d
//    being row d * n + i of the pass.  Every shard of a split lies on one
//    card (parallel/sharded.py), so the level's sums over all shards are
//    one launch, and K3's stage-A fill then runs once a level on its
//    output, not once a shard.  The int64 sums equal the plain version's
//    sum of the shards' partials in shard order.

#include "shard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmemSegments = 2048;  // 2 x 8 bytes x 2048 = 32 KB
constexpr int kMaxBlocks = 264;         // two per SM

// what the pass reads of one column set
struct Cols {
  const int32_t* svc;
  const uint8_t* valid;
  const int32_t* cap;
  const int32_t* seg;
};

// the pass's rows: ``count`` column sets of ``n`` rows each
template <int kSets>
struct Rows {
  Cols c[kSets];
  int count;
  int n;
};

template <int kSets>
__global__ void __launch_bounds__(kThreads) seg_sum_kernel(
    const Rows<kSets> rows, int L, int use_smem,
    const int32_t* __restrict__ k_ptr,
    unsigned long long* __restrict__ acc,  // [2, L]: load, capacity; zero
    unsigned int* __restrict__ ticket,     // zero on entry and on exit
    int32_t* __restrict__ load, int32_t* __restrict__ bcap,
    long long* __restrict__ raw, int32_t* __restrict__ kk_out) {
  extern __shared__ unsigned long long part[];  // [2, L] when use_smem
  __shared__ Cols cols[kSets];
  __shared__ bool last;
  // thread d copies set d (the unrolled loop reads the parameter at
  // constant offsets: a dynamic index into it would copy it to local
  // memory)
#pragma unroll
  for (int d = 0; d < kSets; ++d)
    if (d == (int)threadIdx.x && d < rows.count) cols[d] = rows.c[d];
  if (use_smem)
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x) part[s] = 0;
  __syncthreads();
  unsigned long long* dst = use_smem ? part : acc;

  const int n = rows.n, count = rows.count;
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int d = g / n, i = g - d * n;
  while (d < count) {
    const Cols& c = cols[d];
    const int s = c.seg[i];
    if ((unsigned)s < (unsigned)L) {  // else dropped, as segment_sum does
      const int ld = c.valid[i] ? sk::clamp_int(c.svc[i], 0, sk::SVC_CLAMP)
                                : 0;
      const int cp = c.cap[i];  // >= 0: feasibility output
      if (ld > 0) atomicAdd(&dst[s], (unsigned long long)ld);
      if (cp > 0) atomicAdd(&dst[L + s], (unsigned long long)cp);
    }
    i += stride;
    while (i >= n) {  // on to the next set's rows
      i -= n;
      ++d;
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int s = threadIdx.x; s < 2 * L; s += blockDim.x)
      if (part[s] != 0) atomicAdd(&acc[s], part[s]);
  }

  // ---- the last block to finish takes the sums and clamps
  __threadfence();  // this thread's adds are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long kk = min(*k_ptr, sk::K_CLAMP);
  for (int s = threadIdx.x; s < L; s += blockDim.x) {
    const long long ld = (long long)atomicExch(&acc[s], 0ull);
    const long long cp = (long long)atomicExch(&acc[L + s], 0ull);
    load[s] = (int)min(ld, sk::LOAD_CLAMP);
    bcap[s] = (int)min(cp, kk);
    raw[s] = cp;
  }
  if (threadIdx.x == 0) {
    *kk_out = (int)kk;
    *ticket = 0;
  }
}

}  // namespace

// The launch table, in host memory: scratch and output addresses.
struct SegSumTable {
  void* acc;     // [2, L] int64, zero on entry; zero again when the launch
  void* ticket;  // ends (uint32, likewise)
  void* load;    // the clamped branch arrays
  void* bcap;
  void* raw;     // int64 [L]
  void* kk;
};

namespace {

template <int kSets>
int launch_seg_sum(const Rows<kSets>& rows, int L, const void* k,
                   const void* table, void* stream) {
  if (L <= 0 || rows.n <= 0) return 0;
  if (k == nullptr || table == nullptr) return (int)cudaErrorInvalidValue;
  const SegSumTable t = *(const SegSumTable*)table;
  const int use_smem = L <= kMaxSmemSegments;
  const size_t smem = use_smem ? 2 * sizeof(unsigned long long) * L : 0;
  const long long total = (long long)rows.count * rows.n;
  long long blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  seg_sum_kernel<kSets>
      <<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
          rows, L, use_smem, (const int32_t*)k, (unsigned long long*)t.acc,
          (unsigned int*)t.ticket, (int32_t*)t.load, (int32_t*)t.bcap,
          (long long*)t.raw, (int32_t*)t.kk);
  return (int)cudaGetLastError();
}

}  // namespace

// One call, one launch: load, bcap, raw and kk receive the clamped branch
// arrays of n rows.
extern "C" int sk_seg_sum(int n, int L, const void* svc_tasks,
                          const void* valid, const void* cap, const void* seg,
                          const void* k, const void* table, void* stream) {
  const Rows<1> rows{{Cols{(const int32_t*)svc_tasks, (const uint8_t*)valid,
                           (const int32_t*)cap, (const int32_t*)seg}},
                     1, n};
  return launch_seg_sum(rows, L, k, table, stream);
}

// One stage-A level of a node-axis split, one launch over the `count`
// shards of one card, each of n rows: `ptrs` holds sk::SS_COUNT device
// pointers per shard (svc, valid, cap and seg read; null elsewhere),
// `ints` (n, offset) per shard, both in host memory; k is shard 0's group
// size (the same on every shard).  The outputs are the level's one set of
// clamped branch arrays.
extern "C" int sk_shard_seg_sum(int count, int L, const void* ptrs,
                                const void* ints, const void* k,
                                const void* table, void* stream) {
  sk::ShardTable tab;
  if (!sk::make_table(count, (const void* const*)ptrs, (const int*)ints,
                      &tab))
    return (int)cudaErrorInvalidValue;
  Rows<sk::MAX_LAUNCH_SHARDS> rows;
  rows.count = count;
  rows.n = tab.s[0].n;
  for (int d = 0; d < count; ++d) {
    const sk::Shard& s = tab.s[d];
    if (s.n != rows.n || s.svc == nullptr || s.valid == nullptr ||
        s.cap == nullptr || s.seg == nullptr)
      return (int)cudaErrorInvalidValue;
    rows.c[d] = Cols{s.svc, s.valid, s.cap, s.seg};
  }
  return launch_seg_sum(rows, L, k, table, stream);
}
