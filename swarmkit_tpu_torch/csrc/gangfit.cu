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
// The grid is (M, G): M blocks of T threads a gang, block b taking the
// node tiles b, b + M, ... of T nodes, one node a thread and tile (a loop
// past M * T nodes); every warp stages its own copy of the gang's scalars
// (feasibility.cuh).  gang_shape() picks T and M from the node count and
// the gangs, in one place; probes/feasibility_probe.cu times the
// candidates.  Each block reduces in its own shared memory: the
// first-fail counts a warp at a time (__reduce_add_sync over packed 8-bit
// counters, unpacked into int counters after each tile) and the int64
// capacity total by warp shuffles, then one block barrier.  With one block
// a gang, warp 0 writes gang g's total, fail counts and verdict.  With M
// blocks, warp 0 of each adds its nine values into gang g's five 64-bit
// words of a workspace with atomics that return the old word: the total in
// one, two fail counts a word in four, each word counting its adds in its
// top byte.  The add that completes a word (count M - 1 before it) holds
// the word's final value, writes its outputs and puts the word back to 0,
// so the workspace is zeroed once, when it is made: no fill a call, no
// fence, no counter and no re-read.  (One thread-block cluster a gang,
// its blocks handing their sums to block 0 through distributed shared
// memory, was slower past 512 nodes and held a gang to 16 SMs; PERF.md §6,
// PR 11.)
// The reference sums in float32; the verdict is the same: every addend is
// >= 0, float32 sums are exact below 2^24, and a total at or above 2^24 is
// far over K_CLAMP = 2^22 under any rounding.  Integer sums are the same
// in any order.
//
// Output buffer (bytes, written whole by the kernel): total i64[G] |
// fail i32[G, 8] | fit i32[G], 44 bytes a gang, so one D2H returns every
// gang's verdict.  Workspace (M > 1 only; sk_gang_fit_work_bytes): five
// u64 words a gang, zero between launches; launches that share one run
// one after another (one stream).
//
// Bound on the H100: bytes -- each gang reads the node columns its filters
// need once (as K1, minus K1's capacity and mask writes); the arithmetic is
// a few integer compares per node.  At the fleet's and the headline's
// shapes the floor is latency: two dependent round trips for the staged
// scalars and the columns they name, the block's reduction and one
// atomic's round trip.

#include "feasibility.cuh"

namespace {

// the most blocks a gang takes: a word counts its adds in one byte
constexpr int kMaxBlocks = 128;
// the blocks a launch aims at over all its gangs
constexpr int kGridBlocks = 512;
// threads a block while one node a thread fits the blocks, and past that
constexpr int kSmallThreads = 128;
constexpr int kLargeThreads = 256;

// the launch shape of G gangs of n nodes: T threads a block, M blocks a
// gang
struct GangShape {
  int threads, blocks;
};

// probes/feasibility_probe.cu timed the candidates, and probes/kernel_ab.py
// the grid budget on chip_smoke.py's gang rows (PERF.md §6): one node a
// thread in blocks of 128 where that many blocks fit kMaxBlocks a gang and
// kGridBlocks over the launch, else blocks of 256 up to that budget (two
// nodes a thread of 256 beat four of 128; at nb 16,384 and G = 8, 512
// blocks beat 256 and 1,024)
inline GangShape gang_shape(int n, int g) {
  int budget = g >= kGridBlocks ? 1 : kGridBlocks / (g < 1 ? 1 : g);
  if (budget > kMaxBlocks) budget = kMaxBlocks;
  const int small = (n + kSmallThreads - 1) / kSmallThreads;
  if (small <= budget) return GangShape{kSmallThreads, small < 1 ? 1 : small};
  const int large = (n + kLargeThreads - 1) / kLargeThreads;
  return GangShape{kLargeThreads, large < budget ? large : budget};
}

// what a launch reads: the stacked [G, ...] node columns of the filters
// and the gangs' scalars
struct GangArgs {
  sk::NodeColumns base;
  const uint8_t* res_ok;
  const int32_t* res_cap;
  const int32_t* svc_tasks;
  const int32_t* con_op;
  const int32_t* con_exp;
  const int32_t* plat;
  const int32_t* k;
  const int32_t* maxrep;
  const uint8_t* port_limited;
};

// The workspace of M > 1 blocks a gang: five 64-bit words a gang, zero
// between launches.  Word 0 holds the capacity total in its low 56 bits (a
// node's capacity is at most K_CLAMP = 2^22, so below 2^28 nodes it fits);
// word 1 + j fail counts 2j and 2j + 1 in two 28-bit fields; the top byte
// of each counts its adds.
constexpr int kWords = 5;
constexpr int kCountShift = 56;
constexpr unsigned long long kOneAdd = 1ull << kCountShift;
constexpr unsigned long long kTotalMask = kOneAdd - 1;
constexpr int kFailBits = 28;
constexpr unsigned long long kFailMask = (1ull << kFailBits) - 1;
constexpr int kMaxNodes = 1 << kFailBits;
static_assert(kMaxBlocks < 256, "a word counts its adds in one byte");

// the workspace's bytes for g gangs of m blocks (0 for m = 1)
inline size_t work_bytes(int g, int m) {
  return m <= 1 ? 0 : 8 * (size_t)kWords * g;
}

template <int T>
__global__ void __launch_bounds__(T) gang_fit_kernel(
    int n, int cc, int np, GangArgs a,
    unsigned long long* __restrict__ work, long long* __restrict__ total,
    int32_t* __restrict__ fail, int32_t* __restrict__ fit) {
  constexpr int kWarps = T / 32;
  constexpr int F = sk::N_FILTERS;
  extern __shared__ int sm[];
  __shared__ long long wtotal[kWarps];
  __shared__ int wfail[kWarps * F];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blocks = (int)gridDim.x;
  const int g = blockIdx.y;
  const size_t gn = (size_t)g * n;
  sk::NodeColumns c;
  c.valid = a.base.valid + gn;
  c.ready = a.base.ready + gn;
  c.extra_mask = a.base.extra_mask + gn;
  c.con_hash = a.base.con_hash + (size_t)g * cc * 2 * n;
  c.os_hash = a.base.os_hash + 2 * gn;
  c.arch_hash = a.base.arch_hash + 2 * gn;
  c.port_conflict = a.base.port_conflict + gn;
  c.quota_ok = a.base.quota_ok == nullptr ? nullptr : a.base.quota_ok + gn;
  sk::PlainSource src{a.res_ok + gn, a.res_cap + gn, a.svc_tasks + gn};

  // K1's per-node body, one node a thread and tile; the first tile's
  // early loads are issued before the gang's scalars are staged
  int i = blockIdx.x * T + tid;
  sk::NodeRegs regs;
  sk::load_early(c, i, n, regs);
  src.load_early(i, n);
  const int* grp = sk::stage_group(
      sm, cc, np, a.con_op + (size_t)g * cc, a.con_exp + (size_t)g * cc * 2,
      a.plat + (size_t)g * np * 4, a.k + g, a.maxrep + g,
      a.port_limited + g);
  long long sum = 0;
  int acc[F] = {};   // the warp's first-fail counts (every lane alike)
  for (;;) {
    unsigned fails;
    bool mask;
    int cap;
    sk::feasible_node(grp, c, regs, src, i, n, fails, mask, cap);
    sum += cap;
    sk::warp_fails(fails, acc);
    i += blocks * T;
    if (i - tid >= n) break;   // the same for the whole block
    sk::load_early(c, i, n, regs);
    src.load_early(i, n);
  }

  // ---- this block's nine values: warp sums, then one block barrier;
  // warp 0 then holds fail count j in lane j < F and the total in lane F
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(sk::kFull, sum, off);
  if (lane == 0) {
    wtotal[warp] = sum;
#pragma unroll
    for (int j = 0; j < F; ++j) wfail[warp * F + j] = acc[j];
  }
  __syncthreads();
  if (warp != 0) return;
  int v_fail = 0;
  long long v_total = 0;
  if (lane < F) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v_fail += wfail[w * F + lane];
  } else if (lane == F) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v_total += wtotal[w];
  }

  // ---- one block a gang: its values are gang g's
  if (blocks == 1) {
    if (lane < F) {
      fail[(size_t)g * F + lane] = v_fail;
    } else if (lane == F) {
      total[g] = v_total;
      fit[g] = v_total >= (long long)grp[sk::GW_K] ? 1 : 0;  // min(k, K_CLAMP)
    }
    return;
  }

  // ---- M blocks: each adds into gang g's five words; the add that
  // completes a word writes its outputs and puts the word back to 0
  unsigned long long* words = work + (size_t)g * kWords;
  // lane 2j packs fail counts 2j and 2j + 1 (lane 2j + 1's)
  const unsigned long long next =
      __shfl_down_sync(sk::kFull, (unsigned long long)v_fail, 1);
  const unsigned long long last = (unsigned long long)(blocks - 1);
  if (lane < F && (lane & 1) == 0) {
    const unsigned long long add =
        kOneAdd | (unsigned long long)v_fail | (next << kFailBits);
    const unsigned long long old = atomicAdd(&words[1 + lane / 2], add);
    if ((old >> kCountShift) == last) {
      const unsigned long long fin = old + add;
      fail[(size_t)g * F + lane] = (int32_t)(fin & kFailMask);
      fail[(size_t)g * F + lane + 1] =
          (int32_t)((fin >> kFailBits) & kFailMask);
      words[1 + lane / 2] = 0;
    }
  } else if (lane == F) {
    const unsigned long long add = kOneAdd | (unsigned long long)v_total;
    const unsigned long long old = atomicAdd(&words[0], add);
    if ((old >> kCountShift) == last) {
      const long long t = (long long)((old + add) & kTotalMask);
      total[g] = t;
      fit[g] = t >= (long long)grp[sk::GW_K] ? 1 : 0;  // min(k, K_CLAMP)
      words[0] = 0;
    }
  }
}

template <int T>
size_t gang_smem(int cc, int np) {
  return sk::staged_bytes(T / 32, cc, np);
}

// ONE launch: M blocks of T threads a gang; ``work`` holds
// work_bytes(g, m) bytes, zero when it was made (unused for one block).
// Returns the launch's error code (0 when accepted).
template <int T>
int launch_gang_fit(int n, int g, int m, int cc, int np, const GangArgs& a,
                    void* out, void* work, cudaStream_t stream) {
  if (n <= 0 || g <= 0) return 0;
  if (n >= kMaxNodes || m < 1 || m > kMaxBlocks ||
      (m > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gang_smem<T>(cc, np);
  if (smem > sk::kMaxGroupSmem) return (int)cudaErrorInvalidValue;
  uint8_t* base = (uint8_t*)out;
  long long* total = (long long*)base;
  int32_t* fail = (int32_t*)(base + 8 * (size_t)g);
  int32_t* fit = (int32_t*)(base + 40 * (size_t)g);
  gang_fit_kernel<T><<<dim3(m, g), T, smem, stream>>>(
      n, cc, np, a, (unsigned long long*)work, total, fail, fit);
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
    void* work, void* stream) {
  const GangArgs a{
      sk::NodeColumns{(const uint8_t*)valid, (const uint8_t*)ready,
                      (const uint8_t*)extra_mask, (const int32_t*)con_hash,
                      (const int32_t*)os_hash, (const int32_t*)arch_hash,
                      (const uint8_t*)port_conflict,
                      (const uint8_t*)quota_ok},
      (const uint8_t*)res_ok, (const int32_t*)res_cap,
      (const int32_t*)svc_tasks, (const int32_t*)con_op,
      (const int32_t*)con_exp, (const int32_t*)plat, (const int32_t*)k,
      (const int32_t*)maxrep, (const uint8_t*)port_limited};
  const GangShape s = gang_shape(n, g);
  const cudaStream_t st = (cudaStream_t)stream;
  return s.threads == kSmallThreads
             ? launch_gang_fit<kSmallThreads>(n, g, s.blocks, cc, np, a, out,
                                              work, st)
             : launch_gang_fit<kLargeThreads>(n, g, s.blocks, cc, np, a, out,
                                              work, st);
}

// The blocks a gang takes in a launch of g gangs of n nodes (the tests
// hold every count the launch can pick to the plain version).
extern "C" int sk_gang_fit_blocks(int n, int g) {
  return gang_shape(n, g).blocks;
}

// The workspace bytes a launch of g gangs of n nodes needs, zero when
// made (0: none).
extern "C" long long sk_gang_fit_work_bytes(int n, int g) {
  return (long long)work_bytes(g, gang_shape(n, g).blocks);
}
