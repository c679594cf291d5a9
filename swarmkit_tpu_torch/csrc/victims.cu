// K9: priority preemption's victim selection, the whole greedy in two
// launches.
//
// Replaces swarmkit_tpu/ops/preempt.py:84 select_victims_jit (with its
// per-node body _node_prefix, :51): a lax.scan over the picks whose every
// step recomputes, for every node, the cheapest victim prefix that frees
// enough cpu, memory and generic units, takes the argmin over nodes of the
// packed key cost << 27 | nvict << 20 | node, and carries the used-victim
// mask, the per-node freed surplus, the remaining budget and a stop flag.
//
// It computes what the scan computes without copying it step by step.  A
// pick changes the state of ONE node: the chosen node j's used mask, its
// surplus ex_*[j] and the budget.  Every other node's (feasible, m, cost,
// nvict), and so its key, is what it was before the pick.  So:
//
// * victim_prefix_kernel, one thread per node, computes each node's first
//   prefix and key once (slot s of node j at s * n + j: neighbouring
//   threads read neighbouring addresses), and zeroes the carried state;
// * victim_pick_kernel, ONE block of 1024 threads, loops over the picks:
//   a block argmin over the n keys (strided loads, warp shuffles, shared
//   memory), the reference's do / over / stopped rule on thread 0, then
//   node j's victims marked used, its int64 freed sums folded into ex_*[j],
//   the budget charged, and node j's prefix and key recomputed from its V
//   slots, which the first V threads stage in shared memory.
//
// Ties: a feasible key is unique (the node index is in its low bits); when
// no node is feasible every key is INT64_MAX and the argmin takes the
// first index, as jnp.argmin does.  A stopped run writes -1 / 0 for every
// later pick and never looks at the keys again.
//
// `m` counts slots, not victims: the first prefix length over ALL V slots,
// dead and used ones included, at which free + ex + freed >= demand holds
// for cpu, memory and generic alike (the reference's argmax over V + 1
// prefixes).  Sums are int64 (free pools and surpluses may be negative);
// the weights vprio + 1 are int32, clamped on the host so cost < 2^26.
//
// Scratch (bytes, made by the wrapper, written here before it is read):
// key i64[n] | ex_cpu i64[n] | ex_mem i64[n] | ex_gen i64[n] | used u64[n]
// | m i32[n].  V <= 64, so one node's used mask is one 64-bit word.
// Output: node i32[pb] | m i32[pb].
//
// Bound on the H100: bytes -- every input is read once by the prefix
// kernel (25 n + 29 V n bytes); the pick loop rereads the 8 n bytes of
// keys per pick from L2.  The pick loop is one block: its time is pb
// dependent block reductions, not bandwidth.  A tournament tree of the
// keys in shared memory, or a cluster of blocks, would shorten each pick.

#include "common.cuh"

namespace {

constexpr int kPrefixThreads = 256;
constexpr int kPickThreads = 1024;
constexpr int kPickWarps = kPickThreads / 32;
constexpr int kMaxV = 64;
constexpr int kIdxBits = 20;
constexpr int kNvBits = 7;
constexpr long long kMaxKey = 0x7fffffffffffffffLL;

struct Demand {
  long long cpu, mem, gen;
};

// One node's cheapest victim prefix.  Slot s sits at [s * stride] of each
// column (global memory in the prefix kernel, shared memory in the pick
// kernel).  Returns the packed key (kMaxKey when infeasible) and sets *m.
__device__ __forceinline__ long long node_prefix(
    int j, bool ok, long long have_c, long long have_m, long long have_g,
    unsigned long long used, int v, const uint8_t* vvalid,
    const int32_t* vprio, const long long* vcpu, const long long* vmem,
    const long long* vgen, size_t stride, Demand d, int* m_out) {
  *m_out = 0;
  if (!ok) return kMaxKey;
  int cost = 0, nvict = 0, m = -1;
  if (have_c >= d.cpu && have_m >= d.mem && have_g >= d.gen) {
    m = 0;
  } else {
    for (int s = 0; s < v; ++s) {
      const size_t o = (size_t)s * stride;
      if (vvalid[o] && !((used >> s) & 1ull)) {
        have_c += vcpu[o];
        have_m += vmem[o];
        have_g += vgen[o];
        cost += vprio[o] + 1;
        ++nvict;
      }
      if (have_c >= d.cpu && have_m >= d.mem && have_g >= d.gen) {
        m = s + 1;
        break;
      }
    }
  }
  if (m < 0) return kMaxKey;
  *m_out = m;
  return ((long long)cost << (kIdxBits + kNvBits)) |
         ((long long)nvict << kIdxBits) | (long long)j;
}

struct Inputs {
  const uint8_t* ok;
  const long long* free_cpu;
  const long long* free_mem;
  const long long* free_gen;
  const uint8_t* vvalid;
  const int32_t* vprio;
  const long long* vcpu;
  const long long* vmem;
  const long long* vgen;
};

struct Scratch {
  long long* key;
  long long* ex_cpu;
  long long* ex_mem;
  long long* ex_gen;
  unsigned long long* used;
  int32_t* m;
};

__global__ void __launch_bounds__(kPrefixThreads) victim_prefix_kernel(
    int n, int v, Inputs in, Demand d, Scratch sc) {
  const int j = blockIdx.x * kPrefixThreads + threadIdx.x;
  if (j >= n) return;
  int m;
  sc.key[j] = node_prefix(j, in.ok[j] != 0, in.free_cpu[j], in.free_mem[j],
                          in.free_gen[j], 0ull, v, in.vvalid + j,
                          in.vprio + j, in.vcpu + j, in.vmem + j,
                          in.vgen + j, (size_t)n, d, &m);
  sc.m[j] = m;
  sc.ex_cpu[j] = 0;
  sc.ex_mem[j] = 0;
  sc.ex_gen[j] = 0;
  sc.used[j] = 0ull;
}

// (key, index) pairs ordered by key, then index: the first index wins a tie
__device__ __forceinline__ void min_pair(long long& k, int& i, long long k2,
                                         int i2) {
  if (k2 < k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kPickThreads) victim_pick_kernel(
    int n, int v, int pb, int n_picks, int budget, Inputs in, Demand d,
    Scratch sc, int32_t* __restrict__ out_node, int32_t* __restrict__ out_m) {
  __shared__ long long red_key[kPickWarps];
  __shared__ int red_idx[kPickWarps];
  __shared__ int s_j, s_go;
  __shared__ uint8_t s_valid[kMaxV];
  __shared__ int32_t s_prio[kMaxV];
  __shared__ long long s_cpu[kMaxV], s_mem[kMaxV], s_gen[kMaxV];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int budget_rem = budget;  // thread 0's copy is the one that counts
  const int live_picks = min(pb, max(n_picks, 0));
  int p = 0;
  for (; p < live_picks; ++p) {
    // 1. argmin over the keys
    long long k = kMaxKey;
    int idx = n;
    for (int j = tid; j < n; j += kPickThreads) min_pair(k, idx, sc.key[j], j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      min_pair(k, idx, __shfl_down_sync(0xffffffffu, k, off),
               __shfl_down_sync(0xffffffffu, idx, off));
    if (lane == 0) {
      red_key[warp] = k;
      red_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      k = red_key[lane];
      idx = red_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        min_pair(k, idx, __shfl_down_sync(0xffffffffu, k, off),
                 __shfl_down_sync(0xffffffffu, idx, off));
      if (lane == 0) {
        // 2. the reference's rule: an infeasible pick or one over the
        // budget stops the run
        const bool any_f = k != kMaxKey;
        const int nv = (int)((k >> kIdxBits) & ((1 << kNvBits) - 1));
        s_j = idx;
        s_go = any_f && nv <= budget_rem;
        if (s_go) budget_rem -= nv;
      }
    }
    __syncthreads();
    if (!s_go) break;  // uniform: every thread reads the same flag
    const int j = s_j;
    // stage node j's victim slots in shared memory
    if (tid < v) {
      const size_t o = (size_t)tid * n + j;
      s_valid[tid] = in.vvalid[o];
      s_prio[tid] = in.vprio[o];
      s_cpu[tid] = in.vcpu[o];
      s_mem[tid] = in.vmem[o];
      s_gen[tid] = in.vgen[o];
    }
    __syncthreads();
    if (tid == 0) {
      // 3-4. mark the prefix's live victims used; fold freed - demand
      const int m_j = sc.m[j];
      unsigned long long used = sc.used[j];
      long long fc = 0, fm = 0, fg = 0;
      for (int s = 0; s < m_j; ++s) {
        if (s_valid[s] && !((used >> s) & 1ull)) {
          used |= 1ull << s;
          fc += s_cpu[s];
          fm += s_mem[s];
          fg += s_gen[s];
        }
      }
      const long long ec = sc.ex_cpu[j] + fc - d.cpu;
      const long long em = sc.ex_mem[j] + fm - d.mem;
      const long long eg = sc.ex_gen[j] + fg - d.gen;
      sc.used[j] = used;
      sc.ex_cpu[j] = ec;
      sc.ex_mem[j] = em;
      sc.ex_gen[j] = eg;
      // 6. node j's prefix and key under its new state
      int m_new;
      sc.key[j] = node_prefix(j, in.ok[j] != 0, in.free_cpu[j] + ec,
                              in.free_mem[j] + em, in.free_gen[j] + eg, used,
                              v, s_valid, s_prio, s_cpu, s_mem, s_gen, 1, d,
                              &m_new);
      sc.m[j] = m_new;
      // 7. the pick
      out_node[p] = j;
      out_m[p] = m_j;
    }
    __syncthreads();  // key[j] and the staged slots are read next pick
  }
  // inactive picks: past n_picks, or after a stop
  for (int q = p + tid; q < pb; q += kPickThreads) {
    out_node[q] = -1;
    out_m[q] = 0;
  }
}

}  // namespace

extern "C" int sk_select_victims(
    int n, int v, int pb, int n_picks, int budget, long long cpu_d,
    long long mem_d, long long gen_d, const void* ok, const void* free_cpu,
    const void* free_mem, const void* free_gen, const void* vvalid,
    const void* vprio, const void* vcpu, const void* vmem, const void* vgen,
    void* scratch, void* out, void* stream) {
  if (pb <= 0) return 0;
  if (v < 0 || v > kMaxV) return (int)cudaErrorInvalidValue;
  const Inputs in{(const uint8_t*)ok,       (const long long*)free_cpu,
                  (const long long*)free_mem, (const long long*)free_gen,
                  (const uint8_t*)vvalid,   (const int32_t*)vprio,
                  (const long long*)vcpu,   (const long long*)vmem,
                  (const long long*)vgen};
  uint8_t* base = (uint8_t*)scratch;
  const size_t n8 = 8 * (size_t)n;
  const Scratch sc{(long long*)base, (long long*)(base + n8),
                   (long long*)(base + 2 * n8), (long long*)(base + 3 * n8),
                   (unsigned long long*)(base + 4 * n8),
                   (int32_t*)(base + 5 * n8)};
  const Demand d{cpu_d, mem_d, gen_d};
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    victim_prefix_kernel<<<(n + kPrefixThreads - 1) / kPrefixThreads,
                           kPrefixThreads, 0, s>>>(n, v, in, d, sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int32_t* node = (int32_t*)out;
  victim_pick_kernel<<<1, kPickThreads, 0, s>>>(
      n, v, pb, n > 0 ? n_picks : 0, budget, in, d, sc, node, node + pb);
  return (int)cudaGetLastError();
}
