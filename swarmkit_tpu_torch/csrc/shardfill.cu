// K10: the node-level water-fill over a node-axis split, one search step
// per launch.
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
// Steps (STEPS = 70 launches per fill):
//   0 .. 33   fold step t - 1 into (lo, hi); partials at the level midpoint
//   34        fold step 33 (hi is lam); partials of the base fill at lam-1
//   35        fold the base sum: rem = max(k - base, 0); tie bounds; partials
//             of the marginal count at the first tie midpoint
//   36 .. 68  fold step t - 1 into (tlo, thi); marginal counts at the
//             new midpoint
//   69        fold step 68; write x for the shard's rows
// State per shard, [5, L] int32: lo, hi, tlo, thi, rem.  Every shard folds
// the same D rows in the same order, so every shard holds the same bounds.
//
// Bound on the H100: latency.  Each step is a dependent reduction over all
// shards' rows; the bytes are those of K3 (16 read, 4 written per row),
// read once per step from L2.  A simple first version: one block per
// shard, partial sums in registers (one segment: warp shuffles), in
// shared int64 atomics (up to kMaxSmemSegments segments: 128 KB), or in
// int64 atomics straight into the shard's row of the exchange (more
// segments).  A persistent cross-shard kernel or a CUDA graph per fill is
// later work.

#include "shard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemSegments = 16384;          // 8 bytes each: 128 KB
constexpr int kBase = sk::LEVEL_ITERS;           // 34: the base fill
constexpr int kTieBegin = kBase + 1;             // 35
constexpr int kFinal = kTieBegin + sk::TIE_ITERS;  // 69

__device__ __forceinline__ int fill(int lam, int e, int cap) {
  return min(max(lam - e, 0), cap);
}

__device__ __forceinline__ int level_of(const sk::Shard& sh, int i,
                                        int max_failures) {
  if (sh.e != nullptr) return sh.e[i];
  const int sv = sk::clamp_int(sh.svc[i], 0, sk::SVC_CLAMP);
  const int f = sh.failures[i];
  const int down = f >= max_failures ? sk::clamp_int(f, 0, sk::FAILURE_CLAMP)
                                     : 0;
  return sv + down * sk::F_BIG;
}

__device__ __forceinline__ int key_of(const sk::Shard& sh, int i) {
  if (sh.tie != nullptr) return sh.tie[i];
  const int idx = i + sh.offset;
  if (sh.total != nullptr)
    return (sk::clamp_int(sh.total[i], 0, sk::TOTAL_CLAMP) << sk::IDX_BITS) |
           idx;
  return idx;
}

__global__ void __launch_bounds__(kThreads) shard_waterfill_kernel(
    sk::ShardTable tab, int D, int L, int step, int max_failures) {
  extern __shared__ unsigned long long sum[];  // [L] up to kMaxSmemSegments
  __shared__ long long red[kWarps + 1];
  __shared__ sk::Shard me;
  sk::load_shard(tab, &me);
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool one = L == 1;
  int32_t* lo = me.state;
  int32_t* hi = lo + L;
  int32_t* tlo = hi + L;
  int32_t* thi = tlo + L;
  int32_t* rem = thi + L;

  // ---- fold the previous step's partials of every shard
  const long long* prev = me.xbuf + (size_t)((step + 1) & 1) * D * L;
  for (int s = tid; s < L; s += nt) {
    if (step == 0) {
      lo[s] = 0;
      hi[s] = sk::SEARCH_HI;
      continue;
    }
    const long long tot = sk::fold_rows(prev, D, L, s);
    const long long k = me.k[s];
    if (step <= kBase) {
      const int mid = lo[s] + ((hi[s] - lo[s]) >> 1);
      if (tot >= k) hi[s] = mid;
      else lo[s] = mid + 1;
    } else if (step == kTieBegin) {
      const long long r = k - tot;
      rem[s] = r > 0 ? (int)r : 0;
      tlo[s] = -1;
      thi[s] = sk::SEARCH_HI;
    } else {
      const int mid = tlo[s] + ((thi[s] - tlo[s]) >> 1);
      if (tot >= (long long)rem[s]) thi[s] = mid;
      else tlo[s] = mid + 1;
    }
  }
  __syncthreads();

  // ---- the last step writes the shard's placement
  if (step == kFinal) {
    for (int i = tid; i < me.n; i += nt) {
      const int s = me.seg != nullptr ? me.seg[i] : 0;
      int xi = 0;
      if ((unsigned)s < (unsigned)L) {
        const int lam1 = hi[s] - 1;
        const int e = level_of(me, i, max_failures);
        const int c = me.cap[i];
        const int base = fill(lam1, e, c);
        const bool marginal = e <= lam1 && base < c;
        const bool grant = marginal && key_of(me, i) <= thi[s] && rem[s] > 0;
        xi = base + (grant ? 1 : 0);
      }
      me.x[i] = xi;
    }
    return;
  }

  // ---- this shard's partials at the new midpoint: in shared memory, or
  // in the shard's own row of the exchange (that parity was last read by
  // the previous launch)
  long long* next = me.xbuf + (size_t)(step & 1) * D * L + (size_t)me.row * L;
  unsigned long long* acc =
      L <= kMaxSmemSegments ? sum : reinterpret_cast<unsigned long long*>(next);
  if (!one) {
    for (int s = tid; s < L; s += nt) acc[s] = 0;
    __syncthreads();
  }
  long long mine = 0;
  for (int i = tid; i < me.n; i += nt) {
    const int s = me.seg != nullptr ? me.seg[i] : 0;
    if ((unsigned)s >= (unsigned)L) continue;
    const int e = level_of(me, i, max_failures);
    const int c = me.cap[i];
    int v;
    if (step < kBase) {
      v = fill(lo[s] + ((hi[s] - lo[s]) >> 1), e, c);
    } else if (step == kBase) {
      v = fill(hi[s] - 1, e, c);
    } else {
      const int lam1 = hi[s] - 1;
      const bool marginal = e <= lam1 && fill(lam1, e, c) < c;
      const int mid = tlo[s] + ((thi[s] - tlo[s]) >> 1);
      v = marginal && key_of(me, i) <= mid ? 1 : 0;
    }
    if (v <= 0) continue;
    if (one) mine += v;
    else atomicAdd(&acc[s], (unsigned long long)v);
  }
  if (one) {
    const long long total = sk::block_sum<kWarps>(mine, red);
    if (tid == 0) next[0] = total;
    return;
  }
  if (acc != sum) return;
  __syncthreads();
  for (int s = tid; s < L; s += nt) next[s] = (long long)sum[s];
}

}  // namespace

// Launches steps [step0, step0 + nsteps) of the fill for the `count`
// shards of one card; D is the mesh's shard count.  `ptrs` holds
// sk::SS_COUNT device pointers per shard (null where unused), `ints`
// (n, offset, row) per shard, both in host memory.
extern "C" int sk_shard_waterfill(int count, int D, int L, int step0,
                                  int nsteps, const void* ptrs,
                                  const void* ints, int max_failures,
                                  void* stream) {
  sk::ShardTable tab;
  if (L <= 0 || D <= 0 ||
      !sk::make_table(count, (const void* const*)ptrs, (const int*)ints,
                      &tab))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      L <= kMaxSmemSegments ? (size_t)L * sizeof(unsigned long long) : 0;
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shard_waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int t = step0; t < step0 + nsteps; ++t) {
    shard_waterfill_kernel<<<dim3(1, count), kThreads, smem,
                             (cudaStream_t)stream>>>(tab, D, L, t,
                                                     max_failures);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
