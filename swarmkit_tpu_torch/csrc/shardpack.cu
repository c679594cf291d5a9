// K11: the node-level pack fill (binpack) over a node-axis split, one
// search step per launch.
//
// Replaces the psum'd seg_packfill (swarmkit_tpu/ops/kernel.py:428-460)
// that swarmkit_tpu/parallel/sharded.py:137 plan_strategy_sharded and
// :194 plan_fused_sharded run under shard_map for a binpack group: one
// segment, key = score << 20 | (i + offset), with score clip(res_cap, 0,
// BP_CLAMP), or the failure band above it (K5's key with a global index).
// It finds the least threshold thr with sum(cap_i : key_i <= thr) >= k
// over EVERY shard's rows, gives each row with key_i < thr its capacity
// and the one row AT the threshold (keys are unique across shards) the
// remainder min(cap_i, k - sum(below)).
//
// Steps (STEPS = 36 launches per fill):
//   0 .. 33   fold step t - 1 into (lo, hi); capacity below the midpoint
//   34        fold step 33 (hi is thr); capacity strictly below thr
//   35        fold it: rem = max(k - below, 0); write x for the shard's rows
// State per shard, [3] int32: lo, hi, rem.  Partials cross shards through
// the [2, D, 1] exchange described in shard.cuh.
//
// Bound on the H100: latency, as K5: 36 dependent reductions, 12 bytes
// read per row from L2 per step.  One block per shard; the block reduces
// with warp shuffles.

#include "shard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBelow = sk::TIE_ITERS;   // 34
constexpr int kFinal = kBelow + 1;      // 35
constexpr int kBpClamp = 959;           // scheduler/strategy.py BP_CLAMP

__device__ __forceinline__ int binpack_key(const sk::Shard& sh, int i,
                                           int max_failures) {
  const int f = sh.failures[i];
  const int score = f >= max_failures
                        ? kBpClamp + 1 + sk::clamp_int(f, 0,
                                                       sk::FAILURE_CLAMP)
                        : sk::clamp_int(sh.res_cap[i], 0, kBpClamp);
  return (score << sk::IDX_BITS) | (i + sh.offset);
}

__global__ void __launch_bounds__(kThreads) shard_packfill_kernel(
    sk::ShardTable tab, int D, int step, int max_failures) {
  __shared__ long long red[kWarps + 1];
  __shared__ sk::Shard me;
  sk::load_shard(tab, &me);
  const int tid = threadIdx.x, nt = blockDim.x;
  int32_t* lo = me.state;
  int32_t* hi = lo + 1;
  int32_t* rem = lo + 2;

  // ---- fold the previous step's capacity sums of every shard
  if (tid == 0) {
    if (step == 0) {
      *lo = -1;
      *hi = sk::SEARCH_HI;
    } else {
      const long long* prev = me.xbuf + (size_t)((step + 1) & 1) * D;
      const long long tot = sk::fold_rows(prev, D, 1, 0);
      const long long k = me.k[0];
      if (step <= kBelow) {
        const int mid = *lo + ((*hi - *lo) >> 1);
        if (tot >= k) *hi = mid;
        else *lo = mid + 1;
      } else {
        const long long r = k - tot;
        *rem = r > 0 ? (int)r : 0;   // r <= k <= K_CLAMP when positive
      }
    }
  }
  __syncthreads();

  if (step == kFinal) {
    const int thr = *hi, r = *rem;
    for (int i = tid; i < me.n; i += nt) {
      const int c = me.cap[i];
      const int key = binpack_key(me, i, max_failures);
      int xi = 0;
      if (key < thr) xi = c;
      else if (key == thr && r > 0) xi = min(c, r);
      me.x[i] = xi;
    }
    return;
  }

  const int bound = step < kBelow ? *lo + ((*hi - *lo) >> 1) : *hi;
  const bool strict = step == kBelow;
  long long mine = 0;
  for (int i = tid; i < me.n; i += nt) {
    const int c = me.cap[i];
    if (c == 0) continue;
    const int key = binpack_key(me, i, max_failures);
    if (strict ? key < bound : key <= bound) mine += c;
  }
  const long long total = sk::block_sum<kWarps>(mine, red);
  if (tid == 0) me.xbuf[(size_t)(step & 1) * D + me.row] = total;
}

}  // namespace

// Launches steps [step0, step0 + nsteps) of the fill for the `count`
// shards of one card (pointer table and triples as sk_shard_waterfill's).
extern "C" int sk_shard_packfill(int count, int D, int step0, int nsteps,
                                 const void* ptrs, const void* ints,
                                 int max_failures, void* stream) {
  sk::ShardTable tab;
  if (D <= 0 || !sk::make_table(count, (const void* const*)ptrs,
                                (const int*)ints, &tab))
    return (int)cudaErrorInvalidValue;
  for (int t = step0; t < step0 + nsteps; ++t) {
    shard_packfill_kernel<<<dim3(1, count), kThreads, 0,
                            (cudaStream_t)stream>>>(tab, D, t, max_failures);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
