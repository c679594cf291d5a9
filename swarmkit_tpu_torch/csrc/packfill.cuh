// The binpack fill of K5 (packfill.cu) and K11 (shardpack.cu): one group
// over one segment, in ONE launch of one block, over rows that a source
// type hands the kernel.
//
// Replaces swarmkit_tpu/ops/kernel.py:428 seg_packfill as the binpack
// branch of plan_strategy (:521-527) calls it, alone (K5) or under
// shard_map with every capacity sum psummed over the node axis (K11,
// swarmkit_tpu/parallel/sharded.py:137 and :194).  The key of a row is
// score << 20 | g, g its global index, score clip(res_cap, 0, BP_CLAMP) or
// BP_CLAMP + 1 + clip(failures, 0, 63) once the node has failed the
// service MAX_FAILURES times; keys lie in [0, 2^30).  The reference runs a
// 34-step bisection over [-1, 2^30]; what it computes is
//   thr = the least t with S(t) = sum(cap_i : key_i <= t) >= k
//         (-1 when k <= 0, 2^30 when the whole capacity is short of k),
//   x_i = cap_i where key_i < thr, min(cap_i, k - S(thr - 1)) where
//         key_i == thr and that remainder is positive, else 0.
// Past 2^20 rows the index runs into the score's bits and keys repeat
// (the reference's behaviour, kept): every row AT thr takes the remainder.
//
// A source type Src says where row i lives: K5's reads flat columns, K11's
// maps row d * n + r to row r of shard d through the shard table.  It
// provides Stage and stage(Stage*), which every thread calls once before
// the first row (a shard table staged in shared memory); cols(stage, i),
// row i's res_cap, failures and capacity; gidx(stage, i), its global
// index; out(stage, i), where its placement goes; max_failures; and
// ordered, true when row i's global index grows with i.
//
// Bound on the H100: latency.  The function moves 12 bytes a row in and 4
// out (0.08 us at nb 16,384); the work is a selection.  Design, for
// Hopper (probes/packfill_probe.cu times its phases and the options):
//  * A radix select, not the bisection.  Level 0 sums the rows' capacities
//    into 1,024 bins of the key's top 10 bits (the score band), and one
//    block scan over the bins (one a thread) finds the band where the
//    running capacity reaches k.  Within a band, keys grow with the global
//    index, so where the rows are all in registers and in global order (at
//    most kStage rows, indices below 2^20) one block scan of the threads'
//    band sums, in row order, and a walk of one thread's rows give thr
//    and S(thr - 1).  Otherwise two more levels of 10 bits resolve the
//    key, seeing only the rows of the chosen bins: exact, repeated keys
//    (indices past 2^20) included.
//  * Each row is read once.  Up to kStage rows are copied into shared
//    memory with cp.async, in a layout padded one word in 17; each thread
//    then keeps kSlots consecutive rows (key, capacity) in registers.
//    Rows past kStage are read again from L2 at each level and at the
//    placement.  One SM of an H100 pulls the 196 KB of nb 16,384 in ~5.8
//    us, by cp.async or by loads into registers alike: a third of the
//    kernel's time.
//  * Contention: config 7's binpack rows share a few res_cap values, so
//    many rows fall in one bin.  A thread sums its run of consecutive rows
//    that share a bin in a register and adds a run once; the last run of
//    each lane is summed over the warp when the lanes share its bin.
//    Grouping each row's lanes with __match_any_sync and a partial-mask
//    __reduce_add_sync instead takes about twice the time.
//  * Sums: a bin is two 32-bit shared counters read as one int64.  Up to
//    kSplitRows rows they hold the low 16 bits and the rest of each added
//    sum, which cannot overflow, so the adds return nothing; above, a
//    carry out of the low word goes into the high one (a 64-bit shared
//    atomic is a compare-and-swap loop on Hopper).  Capacities are K1's,
//    never negative; rows of capacity 0 add nothing.
//  * One block, no cluster: an 8-block cluster that spreads the rows over
//    8 SMs but merges its blocks' histograms through distributed shared
//    memory (three cluster barriers a level) took longer.
//  * The placements go back through shared memory and out coalesced.
//    Nothing is kept across launches, so two fills may follow each other
//    on a stream without a sync.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;          // rows a thread keeps in registers
constexpr int kStage = kSlots * kThreads;  // rows staged in shared memory
constexpr int kBits = 10;           // key bits a level resolves
constexpr int kBins = 1 << kBits;
constexpr int kLevels = 3;          // keys are below 2^30
constexpr int kIdxBits = (kLevels - 1) * kBits;  // sk::IDX_BITS
constexpr int kBpClamp = 959;       // scheduler/strategy.py BP_CLAMP
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBins == kThreads, "the scan gives every thread one bin");
static_assert(kIdxBits == sk::IDX_BITS, "a band is one score");

struct Row {
  int key, cap;
};

// Where a row's inputs live.
struct RowCols {
  const int32_t* res_cap;
  const int32_t* failures;
  const int32_t* cap;
};

__device__ __forceinline__ int binpack_key(int g, int res_cap, int failures,
                                           int max_failures) {
  const int score = failures >= max_failures
                        ? kBpClamp + 1 + sk::clamp_int(failures, 0,
                                                       sk::FAILURE_CLAMP)
                        : sk::clamp_int(res_cap, 0, kBpClamp);
  return (score << sk::IDX_BITS) | g;
}

// Row i read from global memory.
template <class Src>
__device__ __forceinline__ Row read_row(const Src& src,
                                        const typename Src::Stage& st,
                                        int i) {
  const RowCols c = src.cols(st, i);
  return Row{binpack_key(src.gidx(st, i), *c.res_cap, *c.failures,
                         src.max_failures),
             *c.cap};
}

// Position of staged row i: one pad word after every 16, so that the
// lanes of a warp, each reading its own run of 16 rows, hit 32 banks.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ void copy4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// The bins of one level: two 32-bit shared counters a bin, read as one
// int64 sum by the policy that filled them.
struct Bins {
  unsigned lo[kBins];
  unsigned hi[kBins];
};

// Up to kSplitRows rows: lo sums the low 16 bits of each added sum and hi
// the rest; each add puts at most 2^16 - 1 into lo and every add covers
// at least one row, so over 65,536 rows of int32 capacities neither
// counter passes 2^32: no carry, and the adds return nothing (RED).
struct SplitBins {
  __device__ static __forceinline__ void put(Bins& b, int bin,
                                             unsigned long long v) {
    atomicAdd(&b.lo[bin], (unsigned)(v & 0xffffu));
    if (v >> 16) atomicAdd(&b.hi[bin], (unsigned)(v >> 16));
  }
  __device__ static __forceinline__ long long value(const Bins& b, int bin) {
    return (long long)b.lo[bin] + ((long long)b.hi[bin] << 16);
  }
};
constexpr int kSplitRows = 1 << 16;

// Any row count: lo and hi are the low and high words of an int64 sum,
// the high one taking the carry out of the low one.
struct CarryBins {
  __device__ static __forceinline__ void put(Bins& b, int bin,
                                             unsigned long long v) {
    const unsigned lo = (unsigned)v;
    unsigned hi = (unsigned)(v >> 32);
    if (lo != 0) {
      const unsigned old = atomicAdd(&b.lo[bin], lo);
      hi += (unsigned)(old + lo < old);  // the carry out of the low word
    }
    if (hi != 0) atomicAdd(&b.hi[bin], hi);
  }
  __device__ static __forceinline__ long long value(const Bins& b, int bin) {
    return (long long)(((unsigned long long)b.hi[bin] << 32) | b.lo[bin]);
  }
};

// Each lane's pending run (its bin, or -1, and its sum) into the bins; a
// warp whose lanes with a run share one bin adds once.  Every lane of the
// warp must call it.
template <class Hist>
__device__ __forceinline__ void flush_warp(Bins& b, int bin,
                                           unsigned long long v) {
  if (!__any_sync(kFull, bin >= 0)) return;
  const int top = __reduce_max_sync(kFull, bin);
  if (__all_sync(kFull, bin < 0 || bin == top)) {
    if (bin < 0) v = 0;
    // 16-bit pieces: each sum over 32 lanes fits 32 bits (v < 2^36)
    const unsigned a = __reduce_add_sync(kFull, (unsigned)(v & 0xffffu));
    const unsigned c = __reduce_add_sync(kFull, (unsigned)(v >> 16));
    if ((threadIdx.x & 31) == 0)
      Hist::put(b, top, (unsigned long long)a +
                            ((unsigned long long)c << 16));
  } else if (bin >= 0) {
    Hist::put(b, bin, v);
  }
}

// The kernel's phase marks (0 start, 1 rows loaded, 2 + 2 l level l's bins
// summed, 3 + 2 l its bin picked, 8 placed): nothing, but in
// probes/packfill_probe.cu.
struct NoMarks {
  __device__ static __forceinline__ void mark(int) {}
};

// Exclusive and inclusive block prefix of v (one value a thread, in thread
// order) and the block's total.  Every thread must call it.
__device__ __forceinline__ void block_scan(long long v, long long* wsum,
                                           long long& excl, long long& incl,
                                           long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  incl = (warp > 0 ? wsum[warp - 1] : 0) + x;
  excl = incl - v;
  total = wsum[kWarps - 1];
}

template <class Src, class Hist, class Marks = NoMarks>
__global__ void __launch_bounds__(kThreads, 1) packfill_kernel(
    int n, Src src, const int32_t* __restrict__ k_ptr) {
  extern __shared__ __align__(16) int32_t staged[];  // [3][pad(m) + 1]
  __shared__ Bins bins;
  __shared__ long long wsum[kWarps];
  __shared__ int sel_bin;
  __shared__ long long sel_below;
  __shared__ typename Src::Stage stage;
  const int tid = threadIdx.x;
  const int m = min(n, kStage);   // rows staged in shared memory
  const int stride = pad(m) + 1;
  int32_t* s_res = staged;
  int32_t* s_fail = staged + stride;
  int32_t* s_cap = staged + 2 * stride;
  Marks::mark(0);
  bins.lo[tid] = 0;
  bins.hi[tid] = 0;
  src.stage(&stage);
  __syncthreads();  // the staged source and the cleared bins

  // ---- rows [0, m) into shared memory, coalesced, every load in flight
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int i = q * kThreads + tid;
    if (i >= m) break;
    const RowCols c = src.cols(stage, i);
    copy4(s_res + pad(i), c.res_cap);
    copy4(s_fail + pad(i), c.failures);
    copy4(s_cap + pad(i), c.cap);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const long long k = k_ptr[0];
  const int first = tid * kSlots;  // this thread's run of rows
  Row reg[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int i = first + q;
    reg[q] = Row{0, 0};
    if (i < m) {
      const int p = pad(i);
      reg[q] = Row{binpack_key(src.gidx(stage, i), s_res[p], s_fail[p],
                               src.max_failures),
                   s_cap[p]};
    }
  }
  Marks::mark(1);
  // every row in registers, in the order of its global index (< 2^20)
  const bool in_order = n <= kStage && src.ordered;

  // ---- the threshold: three levels of a capacity histogram and its scan,
  // or one level and a scan of the chosen band's rows in row order
  int thr = -1;          // k <= 0: nothing placed
  long long below = 0;   // S(thr - 1)
  if (k > 0) {
    int prefix = 0;
    bool short_of_k = false;
#pragma unroll 1
    for (int lvl = 0; lvl < kLevels; ++lvl) {
      const int shift = (kLevels - 1 - lvl) * kBits;
      auto bin_of = [&](const Row& r) {
        return r.cap > 0 && (r.key >> (shift + kBits)) == prefix
                   ? (r.key >> shift) & (kBins - 1) : -1;
      };
      int run = -1;                 // the pending run's bin
      unsigned long long sum = 0;   // and its capacity
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int b = bin_of(reg[q]);
        if (b != run) {
          if (run >= 0) Hist::put(bins, run, sum);
          run = b;
          sum = 0;
        }
        sum += (unsigned)max(reg[q].cap, 0);
      }
      flush_warp<Hist>(bins, run, sum);
#pragma unroll 1
      for (int i = kStage + tid; i < n; i += kThreads) {
        const Row r = read_row(src, stage, i);
        const int b = bin_of(r);
        if (b >= 0) Hist::put(bins, b, (unsigned)r.cap);
      }
      __syncthreads();
      Marks::mark(2 + 2 * lvl);
      const long long v = Hist::value(bins, tid);
      bins.lo[tid] = 0;  // for the next level (after two more barriers)
      bins.hi[tid] = 0;
      long long excl, incl, total;
      block_scan(v, wsum, excl, incl, total);
      const long long need = k - below;
      if (lvl == 0 && total < need) {  // the same in every thread
        short_of_k = true;
        break;
      }
      if (excl < need && need <= incl) {  // exactly one thread
        sel_bin = tid;
        sel_below = excl;
      }
      __syncthreads();
      Marks::mark(3 + 2 * lvl);
      prefix = (prefix << kBits) | sel_bin;
      below += sel_below;
      if (lvl == 0 && in_order) {
        // ---- the band's rows in row order, which is key order: one scan
        // of the threads' band sums, then the thread where it reaches k
        // walks its own run of rows
        const int band = prefix;
        long long mine = 0;
#pragma unroll
        for (int q = 0; q < kSlots; ++q)
          if (reg[q].cap > 0 && (reg[q].key >> kIdxBits) == band)
            mine += reg[q].cap;
        long long ex, in, tot;
        block_scan(mine, wsum, ex, in, tot);
        const long long need1 = k - below;
        if (ex < need1 && need1 <= in) {  // exactly one thread
          // its rows again from shared memory, not from the register array
          long long acc = ex;
#pragma unroll 1
          for (int i = first; i < first + kSlots; ++i) {
            const int p = pad(i);
            const int key = binpack_key(src.gidx(stage, i), s_res[p],
                                        s_fail[p], src.max_failures);
            const int c = s_cap[p];
            if (c <= 0 || (key >> kIdxBits) != band) continue;
            if (acc + c >= need1) {
              sel_bin = key;
              sel_below = acc;
              break;
            }
            acc += c;
          }
        }
        __syncthreads();
        Marks::mark(4);
        prefix = sel_bin;
        below += sel_below;
        break;
      }
    }
    thr = short_of_k ? sk::SEARCH_HI : prefix;
  }

  // ---- placement: through shared memory (s_res), then out coalesced
  const long long r = k - below;
  const int rem = r > 0 ? (int)r : 0;  // r <= k < 2^31 when thr < 2^30
  auto place = [&](const Row& row) {
    if (row.key < thr) return row.cap;
    if (row.key == thr && rem > 0) return min(row.cap, rem);
    return 0;
  };
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
    if (first + q < m) s_res[pad(first + q)] = place(reg[q]);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int i = q * kThreads + tid;
    if (i >= m) break;
    *src.out(stage, i) = s_res[pad(i)];
  }
#pragma unroll 1
  for (int i = kStage + tid; i < n; i += kThreads)
    *src.out(stage, i) = place(read_row(src, stage, i));
  Marks::mark(8);
}

// Shared memory of a launch over n rows: the staged columns.
__host__ __device__ __forceinline__ size_t staged_bytes(int n) {
  const int m = n < kStage ? n : kStage;
  return (size_t)3 * 4 * (pad(m) + 1);
}

// Raise the dynamic shared-memory limit of one instance, once per device.
template <class Src, class Hist, class Marks>
cudaError_t configure() {
  static bool configured[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(packfill_kernel<Src, Hist, Marks>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)staged_bytes(kStage));
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64) configured[dev] = true;
  return cudaSuccess;
}

// ONE launch of one block over the n rows of `src`; k is int32[1] on the
// device.  Returns the launch's error code (0 when accepted).
template <class Src, class Marks = NoMarks>
int launch_packfill(int n, const Src& src, const int32_t* k, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = staged_bytes(n);
  cudaError_t err;
  if (n <= kSplitRows) {
    err = configure<Src, SplitBins, Marks>();
    if (err == cudaSuccess)
      packfill_kernel<Src, SplitBins, Marks><<<1, kThreads, smem, s>>>(
          n, src, k);
  } else {
    err = configure<Src, CarryBins, Marks>();
    if (err == cudaSuccess)
      packfill_kernel<Src, CarryBins, Marks><<<1, kThreads, smem, s>>>(
          n, src, k);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
