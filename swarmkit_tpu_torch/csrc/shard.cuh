// The node-axis split's shard table (K10 shardfill.cu, K11 shardpack.cu):
// what one shard hands a launch, and K11's cross-shard fold.
//
// A mesh of D shards splits the node axis: shard d owns rows
// [d * n, (d + 1) * n) of every node column, in tensors of its own.  The
// reference runs each search step of a node-level fill under shard_map
// and psums the step's [L] partial sums over the node axis
// (swarmkit_tpu/parallel/sharded.py).  Every shard of a mesh lies on one
// card (parallel/sharded.py refuses a mesh over several), and one launch
// covers every shard of the card through this table.
//
// K10 reads only the shards' columns: its one cluster launch sums each
// step over all shards' rows itself.  K11 is a chain of step launches
// (grid.y = shards, one block each): step t reads the [D] int64 partials
// that step t - 1 left in the exchange buffer of parity (t - 1) & 1, sums
// the D rows in shard order (exact, the same on every shard, no atomics
// across shards), moves the shard's own search bounds (its `state`), and
// writes the shard's partial at the new midpoint into its row of parity
// t & 1.  Reads and writes of one launch touch different parities, and
// the stream orders the launches.
#pragma once

#include "common.cuh"

namespace sk {

// shards one launch may carry (the table travels by value as a kernel
// parameter: 16 x 112 bytes)
constexpr int MAX_LAUNCH_SHARDS = 16;

// pointer slots of one shard, in the order of the host's pointer table
enum ShardSlot {
  SS_E, SS_SVC, SS_FAILURES, SS_RES_CAP, SS_CAP, SS_TIE, SS_TOTAL, SS_SEG,
  SS_K, SS_X, SS_STATE, SS_XBUF, SS_COUNT
};

struct Shard {
  const int32_t* e;         // level, or null: the spread score of svc/failures
  const int32_t* svc;       // per-service task counts
  const int32_t* failures;  // recent failures
  const int32_t* res_cap;   // resource capacity (the binpack key)
  const int32_t* cap;       // per-node capacity from K1
  const int32_t* tie;       // tie key, or null: (clip(total) << 20) | idx
  const int32_t* total;     // total tasks (tie key), or null: idx alone
  const int32_t* seg;       // segment per row, or null: segment 0
  const int32_t* k;         // [L] units per segment (replicated)
  int32_t* x;               // [n] placement (written by the last step)
  int32_t* state;           // K11: the shard's own search bounds
  long long* xbuf;          // K11: [2, D, 1] exchange on this card
  int n;                    // rows of this shard
  int offset;               // global index of its first row
  int row;                  // its shard index (K11's exchange row)
};

struct ShardTable {
  Shard s[MAX_LAUNCH_SHARDS];
};

// This block's shard, staged in shared memory: the unrolled loop reads the
// table at constant offsets (a dynamic index into a kernel parameter would
// copy the whole table to local memory in every thread).
__device__ __forceinline__ void load_shard(const ShardTable& tab, Shard* me) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < MAX_LAUNCH_SHARDS; ++d)
      if (d == (int)blockIdx.y) *me = tab.s[d];
  }
  __syncthreads();
}

// Sum over the D shard rows of one exchange parity, segment l, in shard
// order.
__device__ __forceinline__ long long fold_rows(const long long* buf, int D,
                                               int L, int l) {
  long long t = 0;
  for (int d = 0; d < D; ++d) t += buf[(size_t)d * L + l];
  return t;
}

// Build the launch table from the host's per-shard pointer slots and
// (n, offset, row) triples.  Returns false for a count it cannot carry.
inline bool make_table(int count, const void* const* ptrs, const int* ints,
                       ShardTable* tab) {
  if (count <= 0 || count > MAX_LAUNCH_SHARDS) return false;
  for (int d = 0; d < count; ++d) {
    const void* const* p = ptrs + (size_t)d * SS_COUNT;
    Shard& s = tab->s[d];
    s.e = (const int32_t*)p[SS_E];
    s.svc = (const int32_t*)p[SS_SVC];
    s.failures = (const int32_t*)p[SS_FAILURES];
    s.res_cap = (const int32_t*)p[SS_RES_CAP];
    s.cap = (const int32_t*)p[SS_CAP];
    s.tie = (const int32_t*)p[SS_TIE];
    s.total = (const int32_t*)p[SS_TOTAL];
    s.seg = (const int32_t*)p[SS_SEG];
    s.k = (const int32_t*)p[SS_K];
    s.x = (int32_t*)p[SS_X];
    s.state = (int32_t*)p[SS_STATE];
    s.xbuf = (long long*)p[SS_XBUF];
    s.n = ints[3 * d];
    s.offset = ints[3 * d + 1];
    s.row = ints[3 * d + 2];
  }
  return true;
}

}  // namespace sk
