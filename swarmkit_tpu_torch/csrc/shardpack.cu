// K11: the binpack fill over a node-axis split, in ONE launch a fill: K5's
// kernel (packfill.cuh) fed from the shard table.
//
// Replaces the psum'd seg_packfill (swarmkit_tpu/ops/kernel.py:428-460)
// that swarmkit_tpu/parallel/sharded.py:137 plan_strategy_sharded and :194
// plan_fused_sharded run under shard_map for a binpack group: one segment,
// key = score << 20 | (i + offset), K5's key on the global index.  Every
// shard of a split lies on one card (parallel/sharded.py refuses a mesh
// over several), so the reference's psum of each capacity sum is a sum
// over rows that one launch sees: the D shards' rows are the rows
// 0 .. D * n - 1 of one block, row r of shard d being row d * n + r.  Sums
// are int64, exact in any order, so they decide what the reference's psum
// of per-shard float32 partials decides below 2^24.  No step chain and no
// exchange buffer: nothing is kept across launches.

#include "packfill.cuh"
#include "shard.cuh"

namespace {

// What a row load reads of one shard.
struct ShardCols {
  const int32_t* res_cap;
  const int32_t* failures;
  const int32_t* cap;
  int32_t* x;
  int offset;
};

struct ShardRows {
  sk::ShardTable tab;
  int count;         // shards in the table
  int n_local;       // rows of each shard
  int log2_n;        // log2(n_local) when it is a power of two, else -1
  float inv_n;       // 1 / n_local
  int max_failures;
  bool ordered;      // shard d's first row has global index d * n_local

  struct Stage {
    ShardCols c[sk::MAX_LAUNCH_SHARDS];
  };

  // Thread d copies shard d's columns (the unrolled loop reads the table
  // at constant offsets: a dynamic index into a kernel parameter would
  // copy the whole table to local memory).
  __device__ __forceinline__ void stage(Stage* st) const {
#pragma unroll
    for (int d = 0; d < sk::MAX_LAUNCH_SHARDS; ++d) {
      if (d == (int)threadIdx.x && d < count) {
        const sk::Shard& s = tab.s[d];
        st->c[d] = ShardCols{s.res_cap, s.failures, s.cap, s.x, s.offset};
      }
    }
  }

  // i / n_local: a shift for a power of two (node buckets are), else the
  // float reciprocal corrected to the exact quotient (it is off by at most
  // one).
  __device__ __forceinline__ int shard(int i) const {
    if (log2_n >= 0) return i >> log2_n;
    int d = (int)((float)i * inv_n);
    if ((unsigned)d * (unsigned)n_local > (unsigned)i) --d;
    else if ((unsigned)(d + 1) * (unsigned)n_local <= (unsigned)i) ++d;
    return d;
  }

  __device__ __forceinline__ RowCols cols(const Stage& st, int i) const {
    const int d = shard(i);
    const int r = i - d * n_local;
    const ShardCols& c = st.c[d];
    return RowCols{c.res_cap + r, c.failures + r, c.cap + r};
  }
  __device__ __forceinline__ int gidx(const Stage& st, int i) const {
    const int d = shard(i);
    return i - d * n_local + st.c[d].offset;
  }
  __device__ __forceinline__ int32_t* out(const Stage& st, int i) const {
    const int d = shard(i);
    return st.c[d].x + (i - d * n_local);
  }
};

}  // namespace

// One fill over the `count` shards of one card, each of n rows.  `ptrs`
// holds sk::SS_COUNT device pointers per shard (null where unused), `ints`
// (n, offset) per shard, both in host memory; k is shard 0's (the same [1]
// on every shard).
extern "C" int sk_shard_packfill(int count, const void* ptrs,
                                 const void* ints, int max_failures,
                                 void* stream) {
  ShardRows src;
  if (!sk::make_table(count, (const void* const*)ptrs, (const int*)ints,
                      &src.tab))
    return (int)cudaErrorInvalidValue;
  const int n = src.tab.s[0].n;
  for (int d = 1; d < count; ++d)
    if (src.tab.s[d].n != n) return (int)cudaErrorInvalidValue;
  if ((long long)count * n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  src.count = count;
  src.n_local = n;
  src.log2_n = (n & (n - 1)) == 0 ? __builtin_ctz((unsigned)n) : -1;
  src.inv_n = 1.0f / (float)n;
  src.max_failures = max_failures;
  src.ordered = true;
  for (int d = 0; d < count; ++d)
    src.ordered = src.ordered && src.tab.s[d].offset == d * n;
  return launch_packfill(count * n, src, src.tab.s[0].k, stream);
}
