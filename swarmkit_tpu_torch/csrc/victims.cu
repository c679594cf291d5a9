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
//   threads read neighbouring addresses), zeroes the carried state, and
//   writes the first level of a 32-ary tournament tree of the keys (each
//   warp's minimum over its 32 nodes);
// * victim_pick_kernel, one block, builds the tree's upper levels, and
//   then ONE warp runs every pick with no block-wide barrier: it reads the
//   root (the minimum key), applies the reference's do / over / stopped
//   rule, updates node j over its V <= 64 slots warp-parallel (two slots a
//   lane), and re-minimises only j's path to the root.
//
// A pick, for the warp: node j's view (its slots, state, free pools and
// the 32 siblings of its path at every tree level) is already in
// registers; an int64 inclusive scan of the live slots' cpu, memory and
// generic units over the lanes that hold slots; the freed sums and the
// new surplus from that scan; the new first fitting prefix by ballot; its
// cost and victim count by one reduction and two ballots; and one warp
// minimum (two 32-bit redux.sync) per tree level.  The warp keeps the new
// root in a register.  The next pick is either j again or the node of
// the least key but j's, which the path siblings give at once (one warp
// minimum); that node's view is loaded, in one round of loads with no
// branch between them, while j's update runs, and its siblings that
// share a parent with j's path take the values j's update writes there.
// So a pick waits on no load: its time is the warp's chain of dependent
// collectives (shuffles, ballots and redux.sync), a few hundred cycles
// for each of the scan, the new prefix and key, and each tree level.
//
// Tree storage: level 0 holds the n keys, level l + 1 the minimum of each
// 32 entries of level l, up to one root (5 levels at 2^20 nodes).  The
// levels that fit kTreeSmem live in shared memory (every level up to
// 16,384 nodes), the rest in the global scratch (L2-resident: 8 MiB of
// keys at 2^20 nodes); the levels above the second always fit.
//
// Ties: the argmin of jnp.argmin takes the first index among equal keys.
// A feasible key is unique, because the node index is in its low bits, so
// the tree's minimum is that index's key and the tree may hold keys alone.
// When no node is feasible every key is INT64_MAX: the reference's argmin
// then names node 0, but the pick is inactive and the run stops, so the
// index is never written.  A stopped run writes -1 / 0 for every later
// pick and never looks at the keys again.
//
// `m` counts slots, not victims: the first prefix length over ALL V slots,
// dead and used ones included, at which free + ex + freed >= demand holds
// for cpu, memory and generic alike (the reference's argmax over V + 1
// prefixes).  Sums are int64 (free pools and surpluses may be negative);
// the weights vprio + 1 are int32, clamped on the host so cost < 2^26.
//
// Scratch (bytes, made by the wrapper, written here before it is read;
// sk_select_victims_scratch_bytes): key i64[n] | ex_cpu i64[n] | ex_mem
// i64[n] | ex_gen i64[n] | used u64[n] | level 1 i64[ceil(n / 32)] | m
// i32[n].  V <= 64, so one node's used mask is one 64-bit word.
// Output: node i32[pb] | m i32[pb].
//
// Bound on the H100: latency.  The bytes (every input read once by the
// prefix kernel, 25 n + 29 V n at most) take microseconds; the picks are
// pb dependent steps, each a chain of warp collectives.

#include "common.cuh"

namespace {

constexpr int kPrefixThreads = 256;
constexpr int kPickThreads = 256;    // the tree build; one warp picks
constexpr int kMaxV = 64;
constexpr int kIdxBits = 20;
constexpr int kNvBits = 7;
constexpr long long kIdxMask = (1 << kIdxBits) - 1;
constexpr int kFanBits = 5;          // 32-ary tree: one warp a node
constexpr int kMaxLevels = 5;        // 2^20 keys: 2^20, 2^15, 2^10, 2^5, 1
constexpr size_t kTreeSmem = 200 * 1024;
constexpr long long kMaxKey = 0x7fffffffffffffffLL;
constexpr unsigned kFull = 0xffffffffu;

struct Demand {
  long long cpu, mem, gen;
};

// One node's cheapest victim prefix.  Slot s sits at [s * stride] of each
// column.  Returns the packed key (kMaxKey when infeasible) and sets *m.
__device__ __forceinline__ long long node_prefix(
    int j, bool ok, long long have_c, long long have_m, long long have_g,
    int v, const uint8_t* vvalid, const int32_t* vprio, const long long* vcpu,
    const long long* vmem, const long long* vgen, size_t stride, Demand d,
    int* m_out) {
  *m_out = 0;
  if (!ok) return kMaxKey;
  int cost = 0, nvict = 0, m = -1;
  if (have_c >= d.cpu && have_m >= d.mem && have_g >= d.gen) {
    m = 0;
  } else {
    for (int s = 0; s < v; ++s) {
      const size_t o = (size_t)s * stride;
      if (vvalid[o]) {
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
  long long* level1;
  int32_t* m;
};

__host__ __device__ __forceinline__ int level1_size(int n) {
  return (n + 31) >> kFanBits;
}

// The minimum of v over the warp: keys are non-negative, so the unsigned
// (high, low) order is theirs.
__device__ __forceinline__ long long warp_min(long long v) {
  const unsigned long long u = (unsigned long long)v;
  const unsigned hi = (unsigned)(u >> 32), lo = (unsigned)u;
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? lo : kFull);
  return (long long)(((unsigned long long)mh << 32) | ml);
}

__global__ void __launch_bounds__(kPrefixThreads) victim_prefix_kernel(
    int n, int v, Inputs in, Demand d, Scratch sc) {
  const int j = blockIdx.x * kPrefixThreads + threadIdx.x;
  long long key = kMaxKey;
  if (j < n) {
    int m;
    key = node_prefix(j, in.ok[j] != 0, in.free_cpu[j], in.free_mem[j],
                      in.free_gen[j], v, in.vvalid + j, in.vprio + j,
                      in.vcpu + j, in.vmem + j, in.vgen + j, (size_t)n, d,
                      &m);
    sc.key[j] = key;
    sc.m[j] = m;
    sc.ex_cpu[j] = 0;
    sc.ex_mem[j] = 0;
    sc.ex_gen[j] = 0;
    sc.used[j] = 0ull;
  }
  // the tree's first level: each warp's 32 nodes (a warp's first node is
  // a multiple of 32)
  key = warp_min(key);
  if ((threadIdx.x & 31) == 0 && (j >> kFanBits) < level1_size(n))
    sc.level1[j >> kFanBits] = key;
}

// The tournament tree's levels: sizes, where each lives, and its reads.
struct Tree {
  int top;                       // the root's level
  int size[kMaxLevels];
  bool chip[kMaxLevels];         // in shared memory
  long long* at[kMaxLevels];

  // Entry c of level l (kMaxKey past its end), with no branch: a relaxed
  // gpu-scope load through the generic address (shared memory, or global
  // memory past L1, where this warp's own earlier stores are) of a
  // clamped index, so that a pick's loads all issue back to back.
  __device__ __forceinline__ long long child(int l, int c) const {
    long long v;
    asm volatile("ld.relaxed.gpu.b64 %0, [%1];"
                 : "=l"(v) : "l"(at[l] + min(c, size[l] - 1)));
    return c < size[l] ? v : kMaxKey;
  }
};

// Level sizes, the root's level and the first level kept on chip, as host
// and device both compute them (unrolled: every index is a constant);
// returns the shared-memory bytes of the levels on chip.  The levels
// above the second always fit (at most 8,456 bytes).
__host__ __device__ __forceinline__ size_t tree_layout(int n, int* size,
                                                       int* top,
                                                       int* first_chip) {
  *top = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    size[l] = l == 0 ? n : (size[l - 1] + 31) >> kFanBits;
    if (l > 0 && size[l - 1] > 1) *top = l;
  }
  size_t above = 0;
  bool open = true;
  *first_chip = kMaxLevels;
#pragma unroll
  for (int l = kMaxLevels - 1; l >= 0; --l) {
    const size_t b = above + (size_t)size[l] * 8;
    if (l > *top) {
      // above the root: no level
    } else if (open && b <= kTreeSmem) {
      above = b;
      *first_chip = l;
    } else {
      open = false;
    }
  }
  return above;
}

// Node j as a pick reads it, per lane: the 32 siblings of j's path at
// each tree level, its carried state, its free pools, and this lane's two
// victim slots (raw: the used mask is applied where they are read).
struct View {
  int j;
  long long sib[kMaxLevels];
  int m;
  unsigned long long used;
  long long ex_c, ex_m, ex_g, fr_c, fr_m, fr_g;
  bool ok0, ok1;
  int w0, w1;
  long long c0, c1, m0, m1, g0, g1;
};

// One round of loads with no branch between them (slot indices clamped
// into [0, v), the tree's reads through Tree::child), so they all issue
// back to back.
__device__ __forceinline__ View load_view(const Tree& t, const Inputs& in,
                                          const Scratch& sc, int j, int v,
                                          int n, int lane) {
  View w;
  w.j = j;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)
    w.sib[l] = l <= t.top
        ? t.child(l - 1, ((j >> (kFanBits * l)) << kFanBits) + lane)
        : kMaxKey;
  w.sib[0] = kMaxKey;
  w.m = __ldcg(sc.m + j);
  w.used = __ldcg(sc.used + j);
  w.ex_c = __ldcg(sc.ex_cpu + j);
  w.ex_m = __ldcg(sc.ex_mem + j);
  w.ex_g = __ldcg(sc.ex_gen + j);
  w.fr_c = in.free_cpu[j];
  w.fr_m = in.free_mem[j];
  w.fr_g = in.free_gen[j];
  w.ok0 = w.ok1 = false;
  w.w0 = w.w1 = 0;
  w.c0 = w.c1 = w.m0 = w.m1 = w.g0 = w.g1 = 0;
  if (v > 0) {  // the same on every lane
    const int s0 = 2 * lane, s1 = s0 + 1;
    const size_t o0 = (size_t)min(s0, v - 1) * n + j;
    const size_t o1 = (size_t)min(s1, v - 1) * n + j;
    w.ok0 = (in.vvalid[o0] != 0) & (s0 < v);
    w.ok1 = (in.vvalid[o1] != 0) & (s1 < v);
    w.w0 = in.vprio[o0] + 1;
    w.w1 = in.vprio[o1] + 1;
    w.c0 = in.vcpu[o0];
    w.c1 = in.vcpu[o1];
    w.m0 = in.vmem[o0];
    w.m1 = in.vmem[o1];
    w.g0 = in.vgen[o0];
    w.g1 = in.vgen[o1];
  }
  return w;
}

__global__ void __launch_bounds__(kPickThreads) victim_pick_kernel(
    int n, int v, int pb, int n_picks, int budget, Inputs in, Demand d,
    Scratch sc, int32_t* __restrict__ out_node, int32_t* __restrict__ out_m) {
  extern __shared__ long long tree_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kPickThreads / 32;
  const int live_picks = n > 0 ? min(pb, max(n_picks, 0)) : 0;
  int p = 0;
  if (live_picks > 0) {
    // ---- the tree: levels 0 and 1 come from the prefix kernel (copied
    // on chip where they fit), the rest are built here, warp per parent
    Tree t;
    int first_chip;
    tree_layout(n, t.size, &t.top, &first_chip);
    long long* next = tree_smem;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      t.chip[l] = l >= first_chip;
      t.at[l] = t.chip[l] ? next : (l == 0 ? sc.key : sc.level1);
      if (t.chip[l] && l <= t.top) next += t.size[l];
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const long long* src = l == 0 ? sc.key : sc.level1;
      if (l <= t.top && t.chip[l])
        for (int i = tid; i < t.size[l]; i += kPickThreads)
          t.at[l][i] = src[i];
    }
    __syncthreads();
#pragma unroll
    for (int l = 2; l < kMaxLevels; ++l) {
      // every index into t is a constant once unrolled: t stays in
      // registers (no `break`, which would keep the loop rolled)
      if (l <= t.top) {
        for (int q = warp; q < t.size[l]; q += nwarps) {
          const long long k =
              warp_min(t.child(l - 1, (q << kFanBits) + lane));
          if (lane == 0) t.at[l][q] = k;
        }
      }
      __syncthreads();
    }
    if (warp != 0) return;

    // ---- the picks, one warp
    long long root = kMaxKey;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      if (l == t.top) root = t.child(l, 0);
    int budget_rem = budget;
    const int s0 = 2 * lane, s1 = s0 + 1;  // this lane's two slots
    const int pairs = (v + 1) >> 1;        // lanes that hold a slot
    View cur;
    if (root != kMaxKey) cur = load_view(t, in, sc, (int)(root & kIdxMask),
                                         v, n, lane);
    for (; p < live_picks; ++p) {
      // the reference's rule: an infeasible pick or one over the budget
      // stops the run
      if (root == kMaxKey) break;
      const int j = cur.j;
      const int nv = (int)((root >> kIdxBits) & ((1 << kNvBits) - 1));
      if (nv > budget_rem) break;
      budget_rem -= nv;

      // ---- the least key but j's, from j's path siblings, and that
      // node's view, loaded while j's update runs: it is the next pick
      // unless j's new key is smaller
      long long r2 = kMaxKey;
#pragma unroll
      for (int l = 1; l < kMaxLevels; ++l)
        if (l <= t.top && lane != ((j >> (kFanBits * (l - 1))) & 31))
          r2 = min(r2, cur.sib[l]);
      r2 = warp_min(r2);
      View nxt;
      if (r2 != kMaxKey)
        nxt = load_view(t, in, sc, (int)(r2 & kIdxMask), v, n, lane);

      // ---- node j's live slots
      const bool live0 = cur.ok0 && !((cur.used >> s0) & 1ull);
      const bool live1 = cur.ok1 && !((cur.used >> s1) & 1ull);
      const long long c0 = live0 ? cur.c0 : 0, c1 = live1 ? cur.c1 : 0;
      const long long m0 = live0 ? cur.m0 : 0, m1 = live1 ? cur.m1 : 0;
      const long long g0 = live0 ? cur.g0 : 0, g1 = live1 ? cur.g1 : 0;
      const int m_j = cur.m;

      // ---- S_t, the live units of the slots before prefix t, at this
      // lane's prefixes t = s0 + 1 (a*) and t = s0 + 2 (b*); the scan
      // spans only the lanes that hold slots
      long long bc = c0 + c1, bm = m0 + m1, bg = g0 + g1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (off >= pairs) break;  // the same on every lane
        const long long xc = __shfl_up_sync(kFull, bc, off);
        const long long xm = __shfl_up_sync(kFull, bm, off);
        const long long xg = __shfl_up_sync(kFull, bg, off);
        if (lane >= off) {
          bc += xc;
          bm += xm;
          bg += xg;
        }
      }
      const long long ac = bc - c1, am = bm - m1, ag = bg - g1;

      // ---- the pick takes the live slots before m_j: freed = S_{m_j}
      long long fc = 0, fm = 0, fg = 0;
      if (m_j > 0) {
        const int src = (m_j - 1) >> 1;
        const bool second = ((m_j - 1) & 1) != 0;
        const long long sc_a = __shfl_sync(kFull, ac, src);
        const long long sc_b = __shfl_sync(kFull, bc, src);
        const long long sm_a = __shfl_sync(kFull, am, src);
        const long long sm_b = __shfl_sync(kFull, bm, src);
        const long long sg_a = __shfl_sync(kFull, ag, src);
        const long long sg_b = __shfl_sync(kFull, bg, src);
        fc = second ? sc_b : sc_a;
        fm = second ? sm_b : sm_a;
        fg = second ? sg_b : sg_a;
      }
      const bool sel0 = live0 && s0 < m_j, sel1 = live1 && s1 < m_j;
      const unsigned long long mine =
          ((unsigned long long)sel0 << s0) | ((unsigned long long)sel1 << s1);
      const unsigned long long used_new =
          cur.used |
          (unsigned long long)__reduce_or_sync(kFull, (unsigned)mine) |
          ((unsigned long long)__reduce_or_sync(kFull, (unsigned)(mine >> 32))
           << 32);
      const long long nc = cur.ex_c + fc - d.cpu;
      const long long nm = cur.ex_m + fm - d.mem;
      const long long ng = cur.ex_g + fg - d.gen;

      // ---- node j's new first fitting prefix: the slots it may take now
      // are the live ones from m_j on, so its units before prefix t are
      // S_t - S_{m_j} for t > m_j, and none before
      const long long hc = cur.fr_c + nc, hm = cur.fr_m + nm,
                      hg = cur.fr_g + ng;
      const bool fit0 = hc >= d.cpu && hm >= d.mem && hg >= d.gen;
      const int ta = s0 + 1, tb = s0 + 2;
      const bool fa = ta > m_j && hc + ac - fc >= d.cpu &&
                      hm + am - fm >= d.mem && hg + ag - fg >= d.gen;
      const bool fb = tb > m_j && hc + bc - fc >= d.cpu &&
                      hm + bm - fm >= d.mem && hg + bg - fg >= d.gen;
      const unsigned ba = __ballot_sync(kFull, fa && ta <= v);
      const unsigned bb = __ballot_sync(kFull, fb && tb <= v);
      int m_new = -1;
      if (fit0) {
        m_new = 0;
      } else if (ba | bb) {
        const int first_a = ba ? 2 * (__ffs(ba) - 1) + 1 : 1 << 20;
        const int first_b = bb ? 2 * (__ffs(bb) - 1) + 2 : 1 << 20;
        m_new = min(first_a, first_b);
      }
      long long key = kMaxKey;
      if (m_new >= 0) {
        const bool take0 = live0 && !sel0 && s0 < m_new;
        const bool take1 = live1 && !sel1 && s1 < m_new;
        const unsigned cost = __reduce_add_sync(
            kFull, (unsigned)((take0 ? cur.w0 : 0) + (take1 ? cur.w1 : 0)));
        const int nvict = __popc(__ballot_sync(kFull, take0)) +
                          __popc(__ballot_sync(kFull, take1));
        key = ((long long)cost << (kIdxBits + kNvBits)) |
              ((long long)nvict << kIdxBits) | (long long)j;
      }
      if (lane == 0) {
        sc.m[j] = m_new >= 0 ? m_new : 0;
        sc.used[j] = used_new;
        sc.ex_cpu[j] = nc;
        sc.ex_mem[j] = nm;
        sc.ex_gen[j] = ng;
        t.at[0][j] = key;
        out_node[p] = j;
        out_m[p] = m_j;
      }

      // ---- re-minimise j's path; the root stays in a register
      long long val = key, path[kMaxLevels];
      path[0] = key;
#pragma unroll
      for (int l = 1; l < kMaxLevels; ++l) {
        path[l] = kMaxKey;
        if (l <= t.top) {
          const int below = j >> (kFanBits * (l - 1));
          val = warp_min(lane == (below & 31) ? val : cur.sib[l]);
          path[l] = val;
          if (lane == 0) t.at[l][j >> (kFanBits * l)] = val;
        }
      }
      root = val;

      // ---- the next pick's view: node j again (its slots and path
      // siblings are what they were; its state is the one just written),
      // or the prefetched node, whose path siblings that share a parent
      // with j's path take the values just written there
      if (root == key) {
        cur.m = m_new >= 0 ? m_new : 0;
        cur.used = used_new;
        cur.ex_c = nc;
        cur.ex_m = nm;
        cur.ex_g = ng;
      } else if (root != kMaxKey) {
#pragma unroll
        for (int l = 1; l < kMaxLevels; ++l) {
          const int below = j >> (kFanBits * (l - 1));
          if (l <= t.top && (nxt.j >> (kFanBits * l)) ==
                                (j >> (kFanBits * l)) &&
              lane == (below & 31))
            nxt.sib[l] = path[l - 1];
        }
        cur = nxt;
      }
      __syncwarp();  // this pick's stores come before the next one's loads
    }
  } else if (warp != 0) {
    return;
  }
  // inactive picks: past n_picks, or after a stop
  for (int q = p + lane; q < pb; q += 32) {
    out_node[q] = -1;
    out_m[q] = 0;
  }
}

size_t scratch_bytes(int n) {
  return (size_t)44 * n + (size_t)8 * level1_size(n);
}

bool configured[64];

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(victim_pick_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTreeSmem);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64) configured[dev] = true;
  return cudaSuccess;
}

}  // namespace

// Bytes of scratch sk_select_victims needs for n nodes.
extern "C" long long sk_select_victims_scratch_bytes(int n) {
  return (long long)scratch_bytes(n);
}

extern "C" int sk_select_victims(
    int n, int v, int pb, int n_picks, int budget, long long cpu_d,
    long long mem_d, long long gen_d, const void* ok, const void* free_cpu,
    const void* free_mem, const void* free_gen, const void* vvalid,
    const void* vprio, const void* vcpu, const void* vmem, const void* vgen,
    void* scratch, void* out, void* stream) {
  if (pb <= 0) return 0;
  if (v < 0 || v > kMaxV || n < 0 || n > (1 << kIdxBits))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const Inputs in{(const uint8_t*)ok,       (const long long*)free_cpu,
                  (const long long*)free_mem, (const long long*)free_gen,
                  (const uint8_t*)vvalid,   (const int32_t*)vprio,
                  (const long long*)vcpu,   (const long long*)vmem,
                  (const long long*)vgen};
  uint8_t* base = (uint8_t*)scratch;
  const size_t n8 = 8 * (size_t)n;
  const size_t l1 = 8 * (size_t)level1_size(n);
  const Scratch sc{(long long*)base,
                   (long long*)(base + n8),
                   (long long*)(base + 2 * n8),
                   (long long*)(base + 3 * n8),
                   (unsigned long long*)(base + 4 * n8),
                   (long long*)(base + 5 * n8),
                   (int32_t*)(base + 5 * n8 + l1)};
  const Demand d{cpu_d, mem_d, gen_d};
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    victim_prefix_kernel<<<(n + kPrefixThreads - 1) / kPrefixThreads,
                           kPrefixThreads, 0, s>>>(n, v, in, d, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int sizes[kMaxLevels], top = 0, first_chip = 0;
  const size_t smem = n > 0 ? tree_layout(n, sizes, &top, &first_chip) : 0;
  int32_t* node = (int32_t*)out;
  victim_pick_kernel<<<1, kPickThreads, smem, s>>>(
      n, v, pb, n_picks, budget, in, d, sc, node, node + pb);
  return (int)cudaGetLastError();
}
