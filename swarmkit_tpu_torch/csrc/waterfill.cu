// K3: capacity-bounded water-filling within each segment, both searches in
// one launch.
//
// Replaces swarmkit_tpu/ops/kernel.py:127 seg_waterfill, which the
// reference runs as two 34-step fori_loops of segment sums (about 70
// dependent reductions).  Per segment s it finds the least level lam with
// sum_i clip(lam - e_i, 0, cap_i) >= k_s, gives every element
// clip(lam - 1 - e_i, 0, cap_i), and grants the remainder
// r_s = k_s - sum(base) one unit each to the marginal elements with the r_s
// smallest tie keys (a second binary search over the keys).  plan_group
// uses it for the stage-A branch levels and for stage B over the nodes.
//
// Options folded into the launch:
//  * e == nullptr: e_i is the spread score from svc_tasks and failures
//    (clip(svc, 0, SVC_CLAMP) + downweight(failures) * F_BIG);
//  * tie == nullptr: the key is (clip(total, 0, TOTAL_CLAMP) << 20) | i when
//    total is given, else i;
//  * raw_cap != nullptr: the epilogue computes level_spill
//    (swarmkit_tpu/ops/kernel.py:332) on the result and sets *spill to 1
//    when some usable branch saturates while another does not.
//
// Bound on the H100: latency.  The 69 search steps depend on each other,
// and each needs a sum over all elements of a segment.  The bytes the
// function must move are small (16 bytes per element read, 4 written), so
// the design runs the whole search in ONE thread block: per-segment int64
// partial sums, search bounds and remainders live in shared memory
// (24 bytes per segment: 6 KB at L = 256), the block loops over the
// element axis each step, and __syncthreads separates the steps.  No
// launch, host round-trip or global-memory reduction sits between steps.
// With one segment (a weighted or learned group, and stage A's walk over
// the branches) each thread sums into a register and the block reduces
// with warp shuffles: shared-memory atomics on one address would
// serialise every element of every step.  A multi-block or cluster-wide
// version is later work.
//
// Arithmetic mirrors the reference's int32 forms: the midpoint
// lo + ((hi - lo) >> 1) (a floor division), lam - 1 at lam = 0, the tie
// search over (-1, 2^30].  Sums are int64 (exact); the reference's float32
// sums decide every comparison the same way (see segsum.cu).

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Elems {
  const int32_t* e;
  const int32_t* svc;
  const int32_t* failures;
  int max_failures;
  const int32_t* cap;
  const int32_t* tie;
  const int32_t* total;
  const int32_t* seg;

  __device__ __forceinline__ int level(int i) const {
    if (e != nullptr) return e[i];
    const int sv = sk::clamp_int(svc[i], 0, sk::SVC_CLAMP);
    const int f = failures[i];
    const int down = f >= max_failures ? sk::clamp_int(f, 0, sk::FAILURE_CLAMP)
                                       : 0;
    return sv + down * sk::F_BIG;
  }
  __device__ __forceinline__ int key(int i) const {
    if (tie != nullptr) return tie[i];
    if (total != nullptr)
      return (sk::clamp_int(total[i], 0, sk::TOTAL_CLAMP) << sk::IDX_BITS) | i;
    return i;
  }
};

__device__ __forceinline__ int fill(int lam, int e, int cap) {
  return min(max(lam - e, 0), cap);
}

__global__ void __launch_bounds__(kThreads) waterfill_kernel(
    int n, int L, Elems el, const int32_t* __restrict__ k_seg,
    int32_t* __restrict__ x, const long long* __restrict__ raw_cap,
    int32_t* __restrict__ spill) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sum = smem;                 // [L]
  int32_t* lo = reinterpret_cast<int32_t*>(sum + L);  // [L]
  int32_t* hi = lo + L;                           // [L]: lam after stage 1
  int32_t* thi = hi + L;                          // [L]
  int32_t* rem = thi + L;                         // [L]
  __shared__ long long red[kWarps + 1];           // one-segment reductions
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool one = L == 1;

  for (int s = tid; s < L; s += nt) {
    lo[s] = 0;
    hi[s] = sk::SEARCH_HI;
  }
  __syncthreads();

  // ---- level search: least lam per segment with fill(lam) >= k
  for (int it = 0; it < sk::LEVEL_ITERS; ++it) {
    if (!one) {
      for (int s = tid; s < L; s += nt) sum[s] = 0;
      __syncthreads();
    }
    long long mine = 0;
    for (int i = tid; i < n; i += nt) {
      const int s = el.seg[i];
      if ((unsigned)s >= (unsigned)L) continue;
      const int mid = lo[s] + ((hi[s] - lo[s]) >> 1);
      const int f = fill(mid, el.level(i), el.cap[i]);
      if (f <= 0) continue;
      if (one) mine += f;
      else atomicAdd(&sum[s], (unsigned long long)f);
    }
    if (one) {
      const long long total = sk::block_sum<kWarps>(mine, red);
      if (tid == 0) sum[0] = (unsigned long long)total;
    }
    __syncthreads();
    for (int s = tid; s < L; s += nt) {
      const int mid = lo[s] + ((hi[s] - lo[s]) >> 1);
      if ((long long)sum[s] >= (long long)k_seg[s]) hi[s] = mid;
      else lo[s] = mid + 1;
    }
    __syncthreads();
  }

  // ---- base fill at lam - 1 and the remainder per segment
  if (!one) {
    for (int s = tid; s < L; s += nt) sum[s] = 0;
    __syncthreads();
  }
  long long below = 0;
  for (int i = tid; i < n; i += nt) {
    const int s = el.seg[i];
    if ((unsigned)s >= (unsigned)L) continue;
    const int f = fill(hi[s] - 1, el.level(i), el.cap[i]);
    if (f <= 0) continue;
    if (one) below += f;
    else atomicAdd(&sum[s], (unsigned long long)f);
  }
  if (one) {
    const long long total = sk::block_sum<kWarps>(below, red);
    if (tid == 0) sum[0] = (unsigned long long)total;
  }
  __syncthreads();
  for (int s = tid; s < L; s += nt) {
    const long long r = (long long)k_seg[s] - (long long)sum[s];
    rem[s] = r > 0 ? (int)r : 0;
    lo[s] = -1;
    thi[s] = sk::SEARCH_HI;
  }
  __syncthreads();

  // ---- tie search: per segment, the r-th smallest key among marginals
  for (int it = 0; it < sk::TIE_ITERS; ++it) {
    if (!one) {
      for (int s = tid; s < L; s += nt) sum[s] = 0;
      __syncthreads();
    }
    long long mine = 0;
    for (int i = tid; i < n; i += nt) {
      const int s = el.seg[i];
      if ((unsigned)s >= (unsigned)L) continue;
      const int lam1 = hi[s] - 1;
      const int e = el.level(i);
      const int c = el.cap[i];
      const bool marginal = e <= lam1 && fill(lam1, e, c) < c;
      const int mid = lo[s] + ((thi[s] - lo[s]) >> 1);
      if (!marginal || el.key(i) > mid) continue;
      if (one) mine += 1;
      else atomicAdd(&sum[s], 1ull);
    }
    if (one) {
      const long long total = sk::block_sum<kWarps>(mine, red);
      if (tid == 0) sum[0] = (unsigned long long)total;
    }
    __syncthreads();
    for (int s = tid; s < L; s += nt) {
      const int mid = lo[s] + ((thi[s] - lo[s]) >> 1);
      if ((long long)sum[s] >= (long long)rem[s]) thi[s] = mid;
      else lo[s] = mid + 1;
    }
    __syncthreads();
  }

  // ---- placement, and the level_spill epilogue on it
  bool any_sat = false, any_open = false;
  for (int i = tid; i < n; i += nt) {
    const int s = el.seg[i];
    int xi = 0;
    if ((unsigned)s < (unsigned)L) {
      const int lam1 = hi[s] - 1;
      const int e = el.level(i);
      const int c = el.cap[i];
      const int base = fill(lam1, e, c);
      const bool marginal = e <= lam1 && base < c;
      const bool grant = marginal && el.key(i) <= thi[s] && rem[s] > 0;
      xi = base + (grant ? 1 : 0);
    }
    x[i] = xi;
    if (raw_cap != nullptr) {
      const long long rc = raw_cap[i];
      const bool usable = rc > 0;
      const bool sat = usable && (long long)xi >= rc;
      any_sat = any_sat || sat;
      any_open = any_open || (usable && !sat);
    }
  }
  if (raw_cap != nullptr) {
    const int a = __syncthreads_or(any_sat);
    const int b = __syncthreads_or(any_open);
    if (tid == 0 && a && b) *spill = 1;
  }
}

}  // namespace

// Shared memory the launch needs for L segments.
extern "C" long long sk_waterfill_smem_bytes(int L) {
  return (long long)L * (sizeof(unsigned long long) + 4 * sizeof(int32_t));
}

extern "C" int sk_waterfill(int n, int L, const void* e, const void* svc,
                            const void* failures, int max_failures,
                            const void* cap, const void* tie,
                            const void* total, const void* k_seg,
                            const void* seg, void* x, const void* raw_cap,
                            void* spill, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  const size_t smem = (size_t)sk_waterfill_smem_bytes(L);
  if (smem > 40 * 1024) {  // with the static reduction slots, near 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Elems el{(const int32_t*)e,   (const int32_t*)svc,
           (const int32_t*)failures, max_failures,
           (const int32_t*)cap, (const int32_t*)tie,
           (const int32_t*)total, (const int32_t*)seg};
  waterfill_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      n, L, el, (const int32_t*)k_seg, (int32_t*)x,
      (const long long*)raw_cap, (int32_t*)spill);
  return (int)cudaGetLastError();
}
