// The capacity-bounded water-fill of K3 (waterfill.cu) and K10
// (shardfill.cu): both searches in one launch of one thread-block cluster,
// over elements that a source type hands the kernel.
//
// Replaces swarmkit_tpu/ops/kernel.py:127 seg_waterfill, which the
// reference runs as two 34-step fori_loops of segment sums (about 70
// dependent reductions), alone (K3) or under shard_map with a psum of
// every partial sum over the node axis (K10).  Per segment s it finds the
// least level lam with sum_i clip(lam - e_i, 0, cap_i) >= k_s, gives every
// element clip(lam - 1 - e_i, 0, cap_i), and grants the remainder
// r_s = k_s - sum(base) one unit each to the marginal elements with the r_s
// smallest tie keys (a second binary search over the keys).
//
// A source type Src says where element i lives and where its placement
// goes: K3's reads flat columns, K10's maps i to (shard, row) through the
// shard table.  It provides
//  * Stage, what its loads read from shared memory (a shard table), and
//    stage(Stage*), which every thread calls once before the first load;
//  * load(stage, i, L): element i as an Elem (segment -1 outside [0, L));
//  * store(stage, i, x): element i's placement.
// With raw_cap != nullptr the epilogue computes level_spill
// (swarmkit_tpu/ops/kernel.py:332) on the result, ORed over the whole
// cluster, and sets *spill to 1 when some usable branch saturates while
// another does not.
//
// Bound on the H100: latency.  The 69 search steps (34 level steps, the
// base fill, 34 tie steps) depend on each other, and each needs a sum over
// all elements of every segment; the bytes the function must move are
// small (16 read and 4 written per element).  So the floor is 69 dependent
// cluster-wide reductions, not the bytes bound.  Design, for Hopper:
//  * ONE launch of one cluster of kCluster = 8 blocks (cudaLaunchKernelEx
//    with a cluster dimension).  A refused launch returns its error; there
//    is no single-block path.
//  * Each block takes a contiguous slice of the elements and keeps kSlots
//    of them per thread in registers (segment, level, capacity, tie key),
//    loaded once: at nb 16,384 every element.  Elements past that are
//    re-read from L2 each step.
//  * Block sums: a warp whose lanes all hold one segment sums its addends
//    with __reduce_add_sync in 11/11/9-bit parts (exact) and one lane adds
//    them; other warps add lane by lane.  Either way into 32-bit
//    shared-memory counters (64-bit shared atomics are compare-and-swap
//    loops on Hopper, about ten times slower).  Sums are exact; never a
//    float atomic.
//
// Two routes, chosen once per launch by every block alike:
//  * The exchange route (L <= kMapMax): the blocks first OR their bitmaps
//    of live segments (those with an element of positive capacity) and
//    split them into SHARED segments (elements in two blocks or more) and
//    LOCAL ones (one block), numbered densely.  Every block keeps the
//    search state of all shared segments (replicated) and of its own local
//    ones.  A step sums each block's addends per segment; a local segment
//    is done; each shared segment's block total is pushed to every block
//    with st.async into a receive buffer of that block, completing bytes
//    on its mbarrier, and every block sums the kCluster rows in rank order
//    and moves the same bounds.  No cluster barrier and no memory fence in
//    the loop: one round of distributed-shared-memory stores and an
//    mbarrier wait a step, or none where no segment is shared (a spread
//    over a per-node label).  Up to kSharedMax shared segments and
//    kStateMax segments a block.
//  * The owner route (more segments): segment s lives in block
//    s / share, share = ceil(L / kCluster), in shared memory up to
//    kCluster x kShareMax segments and in a global scratch that the
//    wrapper allocates above; elements read their segment's record
//    through distributed shared memory (or L2) and add int64 sums into the
//    owner's; cluster.sync(); the owners move their bounds and publish the
//    next record; cluster.sync().
//
// Arithmetic mirrors the reference's int32 forms: the midpoint
// lo + ((hi - lo) >> 1) (a floor division), lam - 1 at lam = 0, the tie
// search over (-1, 2^30].  Sums are int64 (exact); the reference's float32
// sums decide every comparison the same way (see segsum.cu).  Addends are
// clamped at 0 (capacities are K1's, never negative); an element of
// capacity c <= 0 is placed c, as the plain version places it.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kSlots = 2;          // elements a thread keeps in registers
constexpr int kSteps = sk::LEVEL_ITERS + 1 + sk::TIE_ITERS;  // 69
constexpr int kBaseStep = sk::LEVEL_ITERS;                   // 34
constexpr unsigned kFull = 0xffffffffu;
// the exchange route
constexpr int kMapMax = 16384;     // segments classified (bitmaps of L bits)
constexpr int kStateMax = 4096;    // shared + local segments of a block
constexpr int kSharedMax = 256;    // shared segments exchanged each step
constexpr int kStateBytes = 9 * 4; // lo hi rem k lvl tie, three sum parts
// the owner route
constexpr int kShareMax = 2048;    // segments one block owns on chip

// What every element of a segment reads in a step (the owner route).
struct alignas(16) Record {
  int lvl;    // level midpoint; lam - 1 from the base step on
  int tie;    // tie midpoint; the tie threshold after the last step
  int grant;  // remainder > 0 (set after the last step)
  int pad;
};

// Bytes of per-segment state on the owner route: the record, the int64
// sum, lo, hi, rem, k.
constexpr int kSegBytes = sizeof(Record) + 8 + 4 * 4;

// The spread score of a row: clip(svc, 0, SVC_CLAMP) + downweight(failures)
// * F_BIG, the level when a fill is given no explicit one.
__device__ __forceinline__ int spread_level(int svc, int failures,
                                            int max_failures) {
  const int sv = sk::clamp_int(svc, 0, sk::SVC_CLAMP);
  const int down = failures >= max_failures
                       ? sk::clamp_int(failures, 0, sk::FAILURE_CLAMP)
                       : 0;
  return sv + down * sk::F_BIG;
}

// One element as a step sees it: s = -1 (and cap = 0) for no element or a
// segment out of [0, L), placed 0.  The exchange route renumbers s.
struct Elem {
  int s, lvl, cap, key;
};

// Element i of the source, or none past `end`.
template <class Src>
__device__ __forceinline__ Elem load_elem(const Src& src,
                                          const typename Src::Stage& st,
                                          int i, int end, int L) {
  if (i < end) return src.load(st, i, L);
  return Elem{-1, 0, 0, 0};
}

__device__ __forceinline__ int fill(int lam, int e, int cap) {
  return min(max(lam - e, 0), cap);
}

// The addend of element x in step `step`, given its segment's level (the
// midpoint, or lam - 1 from the base step on) and tie midpoint.
__device__ __forceinline__ int addend(const Elem& x, int lvl, int tie,
                                      int step) {
  if (step <= kBaseStep) return max(fill(lvl, x.lvl, x.cap), 0);
  const bool marginal = x.lvl <= lvl && fill(lvl, x.lvl, x.cap) < x.cap;
  return marginal && x.key <= tie ? 1 : 0;
}

// x's placement, given its segment's final level (lam - 1), tie threshold
// and whether a remainder is left.
__device__ __forceinline__ int placement(const Elem& x, int lvl, int tie,
                                         bool grant) {
  const int base = fill(lvl, x.lvl, x.cap);
  const bool marginal = x.lvl <= lvl && base < x.cap;
  return base + (marginal && grant && x.key <= tie ? 1 : 0);
}

// One segment's search bounds after a step whose sum was `tot`; lvl and
// tie become what the next step's elements read.
__device__ __forceinline__ void advance(int& lo, int& hi, int& rem, int& lvl,
                                        int& tie, int k, long long tot,
                                        int step) {
  if (step < kBaseStep) {
    if (tot >= (long long)k) hi = lvl;
    else lo = lvl + 1;
    lvl = step + 1 < kBaseStep ? lo + ((hi - lo) >> 1) : hi - 1;
  } else if (step == kBaseStep) {
    const long long rm = (long long)k - tot;
    rem = rm > 0 ? (int)rm : 0;
    lo = -1;                      // the tie search's bounds
    hi = sk::SEARCH_HI;
    tie = lo + ((hi - lo) >> 1);
  } else {
    if (tot >= (long long)rem) hi = tie;
    else lo = tie + 1;
    tie = step + 1 < kSteps ? lo + ((hi - lo) >> 1) : hi;
  }
}

// Sum of v over a warp whose lanes all add to one segment, in three parts
// of 11, 11 and 9 bits, each summed by the warp's reduction unit: exact
// for any v in [0, 2^31), and each part fits 32-bit accumulators over 2^21
// elements.  (A warp whose lanes hold several segments adds lane by lane:
// __reduce_add_sync over a partial mask runs once per distinct mask, 8-13
// us a step for 20-32 segments a warp on an H100, where direct 32-bit
// shared atomics take 0.1-0.2 us; probes/cluster_probe.cu measures both.)
struct Parts {
  unsigned a, b, c;
};

__device__ __forceinline__ Parts warp_parts(int v) {
  const unsigned u = (unsigned)v;
  return Parts{__reduce_add_sync(kFull, u & 0x7ffu),
               __reduce_add_sync(kFull, (u >> 11) & 0x7ffu),
               __reduce_add_sync(kFull, u >> 22)};
}

// True when every lane of the warp holds segment s (the same value).
__device__ __forceinline__ bool warp_uniform(int s) {
  return __all_sync(kFull, s == __shfl_sync(kFull, s, 0));
}

__device__ __forceinline__ unsigned long long join(unsigned a, unsigned b,
                                                   unsigned c) {
  return (unsigned long long)a + ((unsigned long long)b << 11) +
         ((unsigned long long)c << 22);
}

// ---- distributed shared memory and mbarriers (PTX)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v into another block's shared memory and complete 8 bytes on that
// block's mbarrier.
__device__ __forceinline__ void push(uint32_t remote, unsigned long long v,
                                     uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, "
      "[%2];" :: "r"(remote), "l"(v), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.b32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Exclusive block-wide prefix sums of two ints per thread; `tot` receives
// both totals.  Every thread must call it.
__device__ int2 block_scan2(int2 v, int2* warp_tot, int2* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, off);
    const int y = __shfl_up_sync(kFull, inc.y, off);
    if (lane >= off) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < kWarps ? warp_tot[lane] : make_int2(0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, w.x, off);
      const int y = __shfl_up_sync(kFull, w.y, off);
      if (lane >= off) {
        w.x += x;
        w.y += y;
      }
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const int2 before = warp > 0 ? warp_tot[warp - 1] : make_int2(0, 0);
  *tot = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// The exchange route's maps: bit s of P (this block's live segments), S
// (shared) and Lo (this block's local ones), and the prefix counts of S
// and Lo per 32-bit word.
struct Maps {
  unsigned* P;
  unsigned* S;
  unsigned* Lo;
  int* SP;
  int* LP;
  int Ls;

  // A live segment's dense number: shared ones first, then this block's
  // local ones; -1 for a segment with no element of positive capacity here.
  __device__ __forceinline__ int id(int s) const {
    const int w = s >> 5;
    const unsigned bit = 1u << (s & 31), below = bit - 1;
    if (S[w] & bit) return SP[w] + __popc(S[w] & below);
    if (Lo[w] & bit) return Ls + LP[w] + __popc(Lo[w] & below);
    return -1;
  }
};

// The owner route's view of the per-segment state.  `rec` and `sum` are
// the bases of this block's own share (shared memory on chip, else its
// part of the global scratch); any owner's entries are reached through
// at() and record().
struct Segs {
  bool on_chip;
  int share;
  int rank;
  Record* rec;
  unsigned long long* sum;
  int* lo;
  int* hi;
  int* rem;
  const int* k;

  __device__ __forceinline__ int owner(int s) const { return s / share; }

  template <class T>
  __device__ __forceinline__ T* at(cg::cluster_group& cl, T* base,
                                   int s) const {
    const int o = owner(s);
    const int j = s - o * share;
    if (on_chip) return cl.map_shared_rank(base, (unsigned)o) + j;
    return base + (ptrdiff_t)(o - rank) * share + j;
  }

  // Segment s's record as its owner published it before the last
  // cluster barrier (a global one is read from L2, past this SM's L1).
  __device__ __forceinline__ Record record(cg::cluster_group& cl,
                                           int s) const {
    const Record* p = at(cl, rec, s);
    if (on_chip) return *p;
    const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
    return Record{v.x, v.y, v.z, v.w};
  }
};

// Shared-memory bytes of the exchange route's maps and state for L.
__host__ __device__ __forceinline__ size_t map_bytes(int L) {
  return (size_t)20 * ((L + 31) >> 5);
}
__host__ __device__ __forceinline__ int state_cap(int L) {
  return L < kStateMax ? L : kStateMax;
}
__host__ __device__ __forceinline__ int shared_cap(int L) {
  return L < kSharedMax ? L : kSharedMax;
}
__host__ __device__ __forceinline__ size_t exchange_bytes(int L) {
  if (L > kMapMax) return 0;
  const size_t maps = (map_bytes(L) + 15) & ~(size_t)15;
  return maps + (size_t)2 * kCluster * shared_cap(L) * 8 +
         (size_t)state_cap(L) * kStateBytes;
}
__host__ __device__ __forceinline__ size_t owner_bytes(int L) {
  const int share = (L + kCluster - 1) / kCluster;
  return share > kShareMax ? 0 : (size_t)share * kSegBytes;
}

template <class Src>
__global__ void __launch_bounds__(kThreads, 1) waterfill_kernel(
    int n, int L, Src src, const int32_t* __restrict__ k_seg,
    const long long* __restrict__ raw_cap, int32_t* __restrict__ spill,
    unsigned char* __restrict__ scratch) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Src::Stage stage;
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ unsigned flags;  // rank 0's: bit 0 saturated, bit 1 open
  __shared__ unsigned local_counts[kCluster];
  __shared__ int2 scan_tot[kWarps];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int rank = (int)cl.block_rank();

  if (tid == 0) {
    flags = 0;
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kCluster) local_counts[tid] = 0;
  src.stage(&stage);
  __syncthreads();  // the staged source is visible to every thread

  // ---- this block's elements: [begin, end); the first kSlots * nt in
  // registers
  const int per = (n + kCluster - 1) / kCluster;
  const int begin = min(n, rank * per);
  const int end = min(n, begin + per);
  const int rest = begin + kSlots * nt;  // re-read from L2 each step
  Elem reg[kSlots];
  bool uni[kSlots];  // the warp holds one segment in this slot
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
    reg[q] = load_elem(src, stage, begin + q * nt + tid, end, L);

  // ---- the live-segment bitmap of this block (the exchange route)
  const bool mapped = L <= kMapMax;
  const int W = (L + 31) >> 5;  // <= 512 words: one a thread
  Maps mp;
  mp.P = reinterpret_cast<unsigned*>(smem);
  mp.S = mp.P + W;
  mp.Lo = mp.S + W;
  mp.SP = reinterpret_cast<int*>(mp.Lo + W);
  mp.LP = mp.SP + W;
  mp.Ls = 0;
  if (mapped) {
    if (tid < W) mp.P[tid] = 0;
    __syncthreads();
    auto mark = [&](const Elem& e) {
      if (e.s >= 0 && e.cap > 0)
        atomicOr(&mp.P[e.s >> 5], 1u << (e.s & 31));
    };
#pragma unroll
    for (int q = 0; q < kSlots; ++q) mark(reg[q]);
#pragma unroll 1
    for (int i0 = rest; i0 < end; i0 += nt)
      mark(load_elem(src, stage, i0 + tid, end, L));
  }
  cl.sync();  // the bitmaps and the mbarriers are visible cluster-wide

  // ---- shared and local segments, their numbers, and the route
  bool exchange = false;
  int n_state = 0;
  if (mapped) {
    unsigned sw = 0, lw = 0, lc[kCluster];
#pragma unroll
    for (int b = 0; b < kCluster; ++b) lc[b] = 0;
    if (tid < W) {
      unsigned p[kCluster], seen = 0;
#pragma unroll
      for (int b = 0; b < kCluster; ++b) {
        p[b] = *cl.map_shared_rank(&mp.P[tid], (unsigned)b);
        sw |= seen & p[b];
        seen |= p[b];
      }
#pragma unroll
      for (int b = 0; b < kCluster; ++b) lc[b] = __popc(p[b] & ~sw);
      lw = mp.P[tid] & ~sw;
      mp.S[tid] = sw;
      mp.Lo[tid] = lw;
    }
#pragma unroll
    for (int b = 0; b < kCluster; ++b) {
      unsigned v = lc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(kFull, v, off);
      if (lane == 0 && v != 0) atomicAdd(&local_counts[b], v);
    }
    int2 tot;
    const int2 pre = block_scan2(make_int2(__popc(sw), __popc(lw)),
                                 scan_tot, &tot);
    if (tid < W) {
      mp.SP[tid] = pre.x;
      mp.LP[tid] = pre.y;
    }
    mp.Ls = tot.x;
    n_state = tot.x + tot.y;
    unsigned most = 0;
#pragma unroll
    for (int b = 0; b < kCluster; ++b) most = max(most, local_counts[b]);
    exchange = mp.Ls <= kSharedMax && mp.Ls + (int)most <= kStateMax;
    __syncthreads();  // the prefix counts are visible
  }

  bool any_sat = false, any_open = false;
  auto spill_of = [&](int xi, int i) {
    if (raw_cap == nullptr) return;
    const long long rc = raw_cap[i];
    const bool usable = rc > 0;
    const bool sat = usable && (long long)xi >= rc;
    any_sat = any_sat || sat;
    any_open = any_open || (usable && !sat);
  };

  if (exchange) {
    // ---- the exchange route: state of the shared segments (all blocks
    // alike) and of this block's local ones, in shared memory after the
    // maps; receive buffers R[parity][block][shared segment]
    const int Ls = mp.Ls, capS = shared_cap(L), capU = state_cap(L);
    unsigned long long* R = reinterpret_cast<unsigned long long*>(
        smem + ((map_bytes(L) + 15) & ~(size_t)15));
    int* lo = reinterpret_cast<int*>(R + 2 * kCluster * capS);
    int* hi = lo + capU;
    int* rem = hi + capU;
    int* kk = rem + capU;
    int* lvl = kk + capU;
    int* tie = lvl + capU;
    unsigned* a0 = reinterpret_cast<unsigned*>(tie + capU);
    unsigned* a1 = a0 + capU;
    unsigned* a2 = a1 + capU;
    if (tid < W) {
      for (unsigned w = mp.S[tid], r = 0; w != 0; w &= w - 1, ++r)
        kk[mp.SP[tid] + r] = k_seg[tid * 32 + __ffs(w) - 1];
      for (unsigned w = mp.Lo[tid], r = 0; w != 0; w &= w - 1, ++r)
        kk[Ls + mp.LP[tid] + r] = k_seg[tid * 32 + __ffs(w) - 1];
    }
    for (int u = tid; u < n_state; u += nt) {
      lo[u] = 0;
      hi[u] = sk::SEARCH_HI;
      rem[u] = 0;
      lvl[u] = sk::SEARCH_HI >> 1;
      tie[u] = 0;
      a0[u] = a1[u] = a2[u] = 0;
    }
    auto renumber = [&](Elem& e) { e.s = e.s >= 0 && e.cap > 0 ? mp.id(e.s)
                                                               : -1; };
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      renumber(reg[q]);
      uni[q] = warp_uniform(reg[q].s);
    }
    __syncthreads();

    auto contribute = [&](const Elem& e, bool uniform, int step) {
      const int v = e.s >= 0 ? addend(e, lvl[e.s], tie[e.s], step) : 0;
      if (uniform) {
        if (e.s < 0) return;
        const Parts t = warp_parts(v);
        if (lane != 0) return;
        if (t.a) atomicAdd(&a0[e.s], t.a);
        if (t.b) atomicAdd(&a1[e.s], t.b);
        if (t.c) atomicAdd(&a2[e.s], t.c);
      } else if (v > 0) {
        const unsigned u = (unsigned)v;
        if (u & 0x7ffu) atomicAdd(&a0[e.s], u & 0x7ffu);
        if ((u >> 11) & 0x7ffu) atomicAdd(&a1[e.s], (u >> 11) & 0x7ffu);
        if (u >> 22) atomicAdd(&a2[e.s], u >> 22);
      }
    };
    const uint32_t bar_base = smem_addr(&bars[0]);
    for (int step = 0; step < kSteps; ++step) {
      const int par = step & 1;
      const uint32_t bar = bar_base + 8 * par;
      if (Ls > 0 && tid == 0) bar_expect(bar, kCluster * Ls * 8);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) contribute(reg[q], uni[q], step);
#pragma unroll 1
      for (int i0 = rest; i0 < end; i0 += nt) {
        Elem e = load_elem(src, stage, i0 + tid, end, L);
        renumber(e);
        contribute(e, warp_uniform(e.s), step);
      }
      __syncthreads();
      unsigned long long* row = R + (size_t)par * kCluster * capS;
      if (Ls > 0) {
        for (int j = tid; j < Ls; j += nt) {
          const unsigned long long v = join(a0[j], a1[j], a2[j]);
          a0[j] = a1[j] = a2[j] = 0;
          const uint32_t slot = smem_addr(row + (size_t)rank * capS + j);
#pragma unroll
          for (int c = 0; c < kCluster; ++c)
            push(map_rank(slot, c), v, map_rank(bar, c));
        }
        bar_wait(bar, (uint32_t)((step >> 1) & 1));
      }
      for (int u = tid; u < n_state; u += nt) {
        long long tot = 0;
        if (u < Ls) {
#pragma unroll
          for (int b = 0; b < kCluster; ++b)
            tot += (long long)row[(size_t)b * capS + u];
        } else {
          tot = (long long)join(a0[u], a1[u], a2[u]);
          a0[u] = a1[u] = a2[u] = 0;
        }
        advance(lo[u], hi[u], rem[u], lvl[u], tie[u], kk[u], tot, step);
      }
      __syncthreads();
    }

    auto place = [&](const Elem& e, int i) {
      if (i >= end) return;
      const int xi = e.s >= 0
          ? placement(e, lvl[e.s], tie[e.s], rem[e.s] > 0) : e.cap;
      src.store(stage, i, xi);
      spill_of(xi, i);
    };
#pragma unroll
    for (int q = 0; q < kSlots; ++q) place(reg[q], begin + q * nt + tid);
#pragma unroll 1
    for (int i0 = rest; i0 < end; i0 += nt) {
      Elem e = load_elem(src, stage, i0 + tid, end, L);
      renumber(e);
      place(e, i0 + tid);
    }
  } else {
    // ---- the owner route
    if (mapped) cl.sync();  // other blocks may still read this one's bitmap
    const int share = (L + kCluster - 1) / kCluster;
    Segs sg;
    sg.on_chip = share <= kShareMax;
    sg.share = share;
    sg.rank = rank;
    if (sg.on_chip) {
      unsigned char* p = smem;
      sg.rec = reinterpret_cast<Record*>(p);
      p += sizeof(Record) * share;
      sg.sum = reinterpret_cast<unsigned long long*>(p);
      p += 8 * share;
      sg.lo = reinterpret_cast<int*>(p);
      sg.hi = sg.lo + share;
      sg.rem = sg.hi + share;
      int* kc = sg.rem + share;
      for (int j = tid; j < share && rank * share + j < L; j += nt)
        kc[j] = k_seg[rank * share + j];
      sg.k = kc;
    } else {  // scratch: records [L] | sums [L] | lo [L] | hi [L] | rem [L]
      const size_t off = (size_t)rank * share;
      sg.rec = reinterpret_cast<Record*>(scratch) + off;
      sg.sum = reinterpret_cast<unsigned long long*>(
                   scratch + sizeof(Record) * (size_t)L) + off;
      sg.lo = reinterpret_cast<int*>(
                  scratch + (sizeof(Record) + 8) * (size_t)L) + off;
      sg.hi = sg.lo + L;
      sg.rem = sg.hi + L;
      sg.k = k_seg + off;
    }
    const int owned = max(0, min(share, L - rank * share));
    for (int j = tid; j < owned; j += nt) {
      sg.lo[j] = 0;
      sg.hi[j] = sk::SEARCH_HI;
      sg.sum[j] = 0;
      sg.rec[j] = Record{sk::SEARCH_HI >> 1, 0, 0, 0};
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) uni[q] = warp_uniform(reg[q].s);
    cl.sync();

    auto contribute = [&](const Elem& e, bool uniform, int step) {
      int v = 0;
      if (e.s >= 0) {
        const Record r = sg.record(cl, e.s);
        v = addend(e, r.lvl, r.tie, step);
      }
      unsigned long long t = (unsigned long long)v;
      if (uniform) {
        if (e.s < 0) return;
        const Parts p = warp_parts(v);
        if (lane != 0) return;
        t = join(p.a, p.b, p.c);
      }
      if (e.s >= 0 && t != 0) atomicAdd(sg.at(cl, sg.sum, e.s), t);
    };
    for (int step = 0; step < kSteps; ++step) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) contribute(reg[q], uni[q], step);
#pragma unroll 1
      for (int i0 = rest; i0 < end; i0 += nt) {
        const Elem e = load_elem(src, stage, i0 + tid, end, L);
        contribute(e, warp_uniform(e.s), step);
      }
      cl.sync();
      // owners: move the bounds, publish the next record
      for (int j = tid; j < owned; j += nt) {
        const long long tot = (long long)atomicExch(&sg.sum[j], 0ull);
        Record r = sg.rec[j];
        advance(sg.lo[j], sg.hi[j], sg.rem[j], r.lvl, r.tie, sg.k[j], tot,
                step);
        if (step + 1 == kSteps) r.grant = sg.rem[j] > 0;
        sg.rec[j] = r;
      }
      cl.sync();
    }

    auto place = [&](const Elem& e, int i) {
      if (i >= end) return;
      int xi = 0;
      if (e.s >= 0) {
        const Record r = sg.record(cl, e.s);
        xi = placement(e, r.lvl, r.tie, r.grant != 0);
      }
      src.store(stage, i, xi);
      spill_of(xi, i);
    };
#pragma unroll
    for (int q = 0; q < kSlots; ++q) place(reg[q], begin + q * nt + tid);
#pragma unroll 1
    for (int i0 = rest; i0 < end; i0 += nt)
      place(load_elem(src, stage, i0 + tid, end, L), i0 + tid);
  }

  // ---- the level_spill epilogue, ORed over the cluster
  if (raw_cap != nullptr) {
    const int a = __syncthreads_or(any_sat);
    const int b = __syncthreads_or(any_open);
    if (tid == 0 && (a || b))
      atomicOr(cl.map_shared_rank(&flags, 0u), (a ? 1u : 0u) | (b ? 2u : 0u));
  }
  cl.sync();  // every remote access is done before any block exits
  if (raw_cap != nullptr && rank == 0 && tid == 0 && flags == 3u) *spill = 1;
}

// Raise the dynamic shared-memory limit of Src's kernel, once per device.
template <class Src>
cudaError_t configure() {
  static bool configured[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(waterfill_kernel<Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)exchange_bytes(kMapMax));
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64) configured[dev] = true;
  return cudaSuccess;
}

inline size_t smem_bytes(int L) {
  const size_t a = exchange_bytes(L), b = owner_bytes(L);
  return a > b ? a : b;
}

// Bytes of global scratch a fill of L segments needs: 0 while the owner
// route's per-segment state fits the cluster's shared memory.
inline long long scratch_bytes(int L) {
  const int share = (L + kCluster - 1) / kCluster;
  return share <= kShareMax ? 0 : (long long)L * kSegBytes;
}

// ONE launch of one cluster of kCluster blocks over the n elements of
// `src`.  Returns the launch's error code (0 when accepted).
template <class Src>
int launch_waterfill(int n, int L, const Src& src, const int32_t* k_seg,
                     const long long* raw_cap, int32_t* spill, void* scratch,
                     void* stream) {
  if (n <= 0 || L <= 0) return 0;
  if (scratch_bytes(L) > 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure<Src>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(L);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, waterfill_kernel<Src>, n, L, src, k_seg,
                           raw_cap, spill, (unsigned char*)scratch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
