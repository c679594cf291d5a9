// The node-axis split's shard table (K10 shardfill.cu, K11 shardpack.cu,
// K2's stage-A sums segsum.cu): what one shard hands a launch.  K7
// (scatter.cu) keeps a table of its own, the five resident columns a
// shard, under the same MAX_LAUNCH_SHARDS.
//
// A mesh of D shards splits the node axis: shard d owns rows
// [d * n, (d + 1) * n) of every node column, in tensors of its own.  The
// reference runs each search step of a node-level fill under shard_map
// and psums the step's partial sums over the node axis
// (swarmkit_tpu/parallel/sharded.py).  Every shard of a mesh lies on one
// card (parallel/sharded.py refuses a mesh over several), and one launch
// covers every shard of the card through this table: K10's cluster and
// K11's block read the shards' columns and sum each step over all shards'
// rows themselves, and K2 sums a stage-A level's branch loads and
// capacities over all shards' rows, so no partial sum crosses a launch.
#pragma once

#include "common.cuh"

namespace sk {

// shards one launch may carry (the table travels by value as a kernel
// parameter: 16 x 96 bytes)
constexpr int MAX_LAUNCH_SHARDS = 16;

// pointer slots of one shard, in the order of the host's pointer table
enum ShardSlot {
  SS_E, SS_SVC, SS_FAILURES, SS_RES_CAP, SS_CAP, SS_TIE, SS_TOTAL, SS_SEG,
  SS_K, SS_X, SS_VALID, SS_COUNT
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
  int32_t* x;               // [n] placement
  const uint8_t* valid;     // padding mask (K2's branch loads)
  int n;                    // rows of this shard
  int offset;               // global index of its first row
};

struct ShardTable {
  Shard s[MAX_LAUNCH_SHARDS];
};

// Build the launch table from the host's per-shard pointer slots and
// (n, offset) pairs.  Returns false for a count it cannot carry.
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
    s.valid = (const uint8_t*)p[SS_VALID];
    s.n = ints[2 * d];
    s.offset = ints[2 * d + 1];
  }
  return true;
}

}  // namespace sk
