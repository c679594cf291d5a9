// K8: the gang all-or-nothing precheck, one gang or a stack of them.
//
// Replaces swarmkit_tpu/ops/kernel.py:786 gang_fit (its jitted entry
// gang_fit_jit, :799) and :804 gang_fit_fused_jit (gang_fit vmapped over a
// leading gang axis).  For each gang g it runs K1's per-node body
// (feasibility.cuh, shared with K1 and K1F) on gang g's slice of the stacked
// [G, ...] inputs, sums the per-node capacity, and decides
// total >= min(k, K_CLAMP).  Each gang is judged against the same base
// cluster state; G = 1 serves gang_fit.
//
// The grid is (node blocks, G), one node a thread.  Every warp stages its
// gang's scalars in shared memory (feasibility.cuh); a block sums its
// nodes' capacity in int64 in registers and warp shuffles (sk::block_sum)
// and folds its first-fail counts per warp (sk::fold_fails), then adds both
// into gang g's accumulators with integer atomics, which give the same sum
// in any order.
// The reference sums in float32; the verdict is the same: every addend is
// >= 0, float32 sums are exact below 2^24, and a total at or above 2^24 is
// far over K_CLAMP = 2^22 under any rounding.  The last block of a gang (a
// counter per gang, after a fence) writes the verdict, so one D2H of the
// output buffer returns every gang's fit and fail counts.
//
// Output buffer (bytes, zeroed by the caller): total i64[G] | fail i32[G, 8]
// | done u32[G] | fit i32[G].
//
// Bound on the H100: bytes -- each gang reads the node columns its filters
// need once (as K1, minus K1's capacity and mask writes); the arithmetic is
// a few integer compares per node.

#include "feasibility.cuh"

namespace {

// K8's launch shape (probes/feasibility_probe.cu times others)
constexpr int kK8Threads = 256;

template <int T>
__global__ void __launch_bounds__(T) gang_fit_kernel(
    int n, int cc, int np, sk::NodeColumns base,
    const uint8_t* __restrict__ res_ok, const int32_t* __restrict__ res_cap,
    const int32_t* __restrict__ svc_tasks,
    const int32_t* __restrict__ con_op, const int32_t* __restrict__ con_exp,
    const int32_t* __restrict__ plat, const int32_t* __restrict__ k_ptr,
    const int32_t* __restrict__ maxrep_ptr,
    const uint8_t* __restrict__ port_limited_ptr,
    long long* __restrict__ total, int32_t* __restrict__ fail,
    unsigned* __restrict__ done, int32_t* __restrict__ fit) {
  constexpr int kWarps = T / 32;
  extern __shared__ int sm[];
  __shared__ unsigned wsum[2 * kWarps];
  __shared__ long long red[kWarps + 1];

  const int g = blockIdx.y;
  const size_t gn = (size_t)g * n;
  sk::NodeColumns c;
  c.valid = base.valid + gn;
  c.ready = base.ready + gn;
  c.extra_mask = base.extra_mask + gn;
  c.con_hash = base.con_hash + (size_t)g * cc * 2 * n;
  c.os_hash = base.os_hash + 2 * gn;
  c.arch_hash = base.arch_hash + 2 * gn;
  c.port_conflict = base.port_conflict + gn;
  c.quota_ok = base.quota_ok == nullptr ? nullptr : base.quota_ok + gn;

  // K1's per-node body, one node a thread
  const int i = blockIdx.x * T + threadIdx.x;
  sk::NodeRegs regs;
  sk::load_early(c, i, n, regs);
  sk::PlainSource src{res_ok + gn, res_cap + gn, svc_tasks + gn};
  src.load_early(i, n);
  const int* grp = sk::stage_group(
      sm, cc, np, con_op + (size_t)g * cc, con_exp + (size_t)g * cc * 2,
      plat + (size_t)g * np * 4, k_ptr + g, maxrep_ptr + g,
      port_limited_ptr + g);
  unsigned fails;
  bool mask;
  int cap;
  sk::feasible_node(grp, c, regs, src, i, n, fails, mask, cap);

  // every lane of every warp reaches the fold and the block sum
  sk::fold_fails<kWarps>(fails, wsum, fail + 8 * g);
  const long long block_total = sk::block_sum<kWarps>(cap, red);
  if (threadIdx.x == 0) {
    if (block_total != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(&total[g]),
                static_cast<unsigned long long>(block_total));
    __threadfence();
    if (atomicAdd(&done[g], 1u) == gridDim.x - 1) {
      // every block of gang g has added its sum: decide
      const long long t = static_cast<long long>(atomicAdd(
          reinterpret_cast<unsigned long long*>(&total[g]), 0ull));
      fit[g] = t >= static_cast<long long>(min(k_ptr[g], sk::K_CLAMP))
                   ? 1 : 0;
    }
  }
}

template <int T>
int launch_gang_fit(
    int n, int g, int cc, int np, const void* valid, const void* ready,
    const void* res_ok, const void* res_cap, const void* svc_tasks,
    const void* extra_mask, const void* con_hash, const void* con_op,
    const void* con_exp, const void* plat, const void* os_hash,
    const void* arch_hash, const void* port_conflict, const void* quota_ok,
    const void* k, const void* maxrep, const void* port_limited, void* out,
    cudaStream_t stream) {
  if (n <= 0 || g <= 0) return 0;
  const size_t smem = sk::staged_bytes(T / 32, cc, np);
  if (smem > sk::kMaxGroupSmem) return (int)cudaErrorInvalidValue;
  const sk::NodeColumns cols{
      (const uint8_t*)valid, (const uint8_t*)ready,
      (const uint8_t*)extra_mask, (const int32_t*)con_hash,
      (const int32_t*)os_hash, (const int32_t*)arch_hash,
      (const uint8_t*)port_conflict, (const uint8_t*)quota_ok};
  uint8_t* base = (uint8_t*)out;
  long long* total = (long long*)base;
  int32_t* fail = (int32_t*)(base + 8 * (size_t)g);
  unsigned* done = (unsigned*)(base + 40 * (size_t)g);
  int32_t* fit = (int32_t*)(base + 44 * (size_t)g);
  const dim3 grid((n + T - 1) / T, g);
  gang_fit_kernel<T><<<grid, T, smem, stream>>>(
      n, cc, np, cols, (const uint8_t*)res_ok, (const int32_t*)res_cap,
      (const int32_t*)svc_tasks, (const int32_t*)con_op,
      (const int32_t*)con_exp, (const int32_t*)plat, (const int32_t*)k,
      (const int32_t*)maxrep, (const uint8_t*)port_limited, total, fail,
      done, fit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sk_gang_fit(
    int n, int g, int cc, int np, const void* valid, const void* ready,
    const void* res_ok, const void* res_cap, const void* svc_tasks,
    const void* extra_mask, const void* con_hash, const void* con_op,
    const void* con_exp, const void* plat, const void* os_hash,
    const void* arch_hash, const void* port_conflict, const void* quota_ok,
    const void* k, const void* maxrep, const void* port_limited, void* out,
    void* stream) {
  return launch_gang_fit<kK8Threads>(
      n, g, cc, np, valid, ready, res_ok, res_cap, svc_tasks, extra_mask,
      con_hash, con_op, con_exp, plat, os_hash, arch_hash, port_conflict,
      quota_ok, k, maxrep, port_limited, out, (cudaStream_t)stream);
}
