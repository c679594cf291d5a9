// K10: the node-level water-fill over a node-axis split, in ONE launch a
// fill: K3's cluster kernel (waterfill.cuh) fed from the shard table.
//
// Replaces the psum'd seg_waterfill (swarmkit_tpu/ops/kernel.py:127) that
// swarmkit_tpu/parallel/sharded.py:95 plan_group_sharded, :137
// plan_strategy_sharded and :194 plan_fused_sharded run under shard_map:
// stage B of a spread plan and the weighted/learned fill.  Per segment s
// it finds the least level lam with sum_i clip(lam - e_i, 0, cap_i) >= k_s
// over EVERY shard's rows, gives each row clip(lam - 1 - e_i, 0, cap_i),
// and grants the remainder r_s one unit each to the marginal rows with the
// r_s smallest tie keys.  Tie keys are global: (clip(total) << 20) |
// (i + offset), the reference's idx + axis_index * local_n.
//
// Every shard of a split lies on one card (parallel/sharded.py refuses a
// mesh over several), so the reference's psum of each step's [L] partials
// is a sum over rows that one launch can see.  The D shards' rows are the
// elements 0 .. D * n - 1 of one cluster launch, row i of shard d being
// element d * n + i; the element source reads that shard's tensors through
// the table of shard.cuh (staged in shared memory) and writes its
// placement into the shard's x.  The search, its exchange and owner routes
// and its registers are K3's: int64 sums, exact in any order, so the
// shards' rows summed together give what the reference's psum of per-shard
// partials decides.  No step chain, no exchange buffer in global memory
// between steps, and nothing kept across launches, so two fills may follow
// each other on a stream without a sync.
//
// Bound on the H100: latency, as K3: 69 dependent cluster-wide reductions
// (the bytes are 24 read and 4 written per row, plus k).  A cluster launch
// the runtime refuses returns its error; there is no step-chain path.

#include "shard.cuh"
#include "waterfill.cuh"

namespace {

// What an element load reads of one shard.
struct Cols {
  const int32_t* e;
  const int32_t* svc;
  const int32_t* failures;
  const int32_t* cap;
  const int32_t* tie;
  const int32_t* total;
  const int32_t* seg;
  int32_t* x;
  int offset;
};

struct ShardElems {
  sk::ShardTable tab;
  int count;         // shards in the table
  int n_local;       // rows of each shard
  int max_failures;

  struct Stage {
    Cols c[sk::MAX_LAUNCH_SHARDS];
  };

  // Thread d copies shard d's columns (the unrolled loop reads the table
  // at constant offsets: a dynamic index into a kernel parameter would
  // copy the whole table to local memory).
  __device__ __forceinline__ void stage(Stage* st) const {
#pragma unroll
    for (int d = 0; d < sk::MAX_LAUNCH_SHARDS; ++d) {
      if (d == (int)threadIdx.x && d < count) {
        const sk::Shard& s = tab.s[d];
        st->c[d] = Cols{s.e,     s.svc, s.failures, s.cap, s.tie,
                        s.total, s.seg, s.x,        s.offset};
      }
    }
  }

  __device__ __forceinline__ Elem load(const Stage& st, int i, int L) const {
    const int d = i / n_local;
    const int r = i - d * n_local;
    const Cols& c = st.c[d];
    Elem el{-1, 0, 0, 0};
    const int s = c.seg != nullptr ? c.seg[r] : 0;
    if ((unsigned)s < (unsigned)L) {
      el.s = s;
      el.lvl = c.e != nullptr
                   ? c.e[r]
                   : spread_level(c.svc[r], c.failures[r], max_failures);
      el.cap = c.cap[r];
      const int idx = r + c.offset;
      el.key = c.tie != nullptr ? c.tie[r]
               : c.total != nullptr
                   ? (sk::clamp_int(c.total[r], 0, sk::TOTAL_CLAMP)
                      << sk::IDX_BITS) | idx
                   : idx;
    }
    return el;
  }

  __device__ __forceinline__ void store(const Stage& st, int i, int v) const {
    const int d = i / n_local;
    st.c[d].x[i - d * n_local] = v;
  }
};

}  // namespace

// One fill over the `count` shards of one card, each of n rows.  `ptrs`
// holds sk::SS_COUNT device pointers per shard (null where unused),
// `ints` (n, offset) per shard, both in host memory; k is shard 0's (the
// same [L] on every shard).  `scratch`: sk_waterfill_scratch_bytes(L)
// bytes, or null where that is 0.
extern "C" int sk_shard_waterfill(int count, int L, const void* ptrs,
                                  const void* ints, int max_failures,
                                  void* scratch, void* stream) {
  ShardElems src;
  if (L <= 0 || !sk::make_table(count, (const void* const*)ptrs,
                                (const int*)ints, &src.tab))
    return (int)cudaErrorInvalidValue;
  const int n = src.tab.s[0].n;
  for (int d = 1; d < count; ++d)
    if (src.tab.s[d].n != n) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  src.count = count;
  src.n_local = n;
  src.max_failures = max_failures;
  return launch_waterfill(count * n, L, src, src.tab.s[0].k, nullptr,
                          nullptr, scratch, stream);
}
