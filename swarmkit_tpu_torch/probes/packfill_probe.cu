// Probe of the threshold select behind K5 and K11 (csrc/packfill.cuh) on
// Hopper: where its time goes, which way of summing the capacity
// histograms is faster, and whether an 8-block cluster beats one block.
// It compiles the kernels' own sources (packfill.cu, shardpack.cu) and
// runs, on 16,384 rows (config 7's node bucket) of random scores, of four
// scores (the lanes of a warp share a few bins) and of one score (every
// warp shares one bin):
//  * K5's kernel (flat columns) and K11's (four shards through the shard
//    table) with each histogram policy: SplitBins (16-bit halves, adds
//    that return nothing) and CarryBins (a carry into the high word); K11
//    also with its rows marked out of order, so that three radix levels
//    resolve the key instead of the band's scan in row order, and with its
//    shard found by the float reciprocal instead of a shift;
//  * the same kernels with their phase marks, cycles per phase (clock64 of
//    thread 0, summed over the launches);
//  * one cluster of 8 blocks, each over an eighth of the rows read from L2
//    into registers, merging its blocks' histograms through distributed
//    shared memory (three cluster barriers a level).
// Every variant must place exactly as K5's kernel does.  Times are one
// select in microseconds: CUDA events over 200 launches back to back, so
// each includes the gap between two launches.  Build and run on the card,
// from the root of the checkout (the binary goes to the git-ignored build
// directory of that checkout):
//
//   mkdir -p swarmkit_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -I swarmkit_tpu_torch/csrc \
//       -o swarmkit_tpu_torch/_build/packfill_probe \
//       swarmkit_tpu_torch/probes/packfill_probe.cu
//   swarmkit_tpu_torch/_build/packfill_probe

#include <cooperative_groups.h>

#include <cstdio>
#include <cstdlib>
#include <vector>

#include "packfill.cu"
#include "shardpack.cu"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kClusterSlots = 2;  // rows a thread holds: 16,384 / 8 / 1,024
constexpr int kMarks = 9;
constexpr int kMaxFailures = 5;   // scheduler/nodeinfo.py MAX_FAILURES

__device__ long long g_phase[kMarks];
__device__ long long g_prev;

struct ClockMarks {
  __device__ static void mark(int p) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    const long long t = clock64();
    if (p > 0) g_phase[p] += t - g_prev;
    g_prev = t;
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    select_cluster(int n, FlatRows src, const int* k_ptr) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ Bins bins;
  __shared__ long long wsum[kWarps];
  __shared__ int sel_bin;
  __shared__ long long sel_below;
  const int tid = threadIdx.x, rank = (int)cl.block_rank();
  const int per = (n + kCluster - 1) / kCluster;
  const int begin = rank * per, end = min(n, begin + per);
  FlatRows::Stage st{};
  bins.lo[tid] = 0;
  bins.hi[tid] = 0;
  Row reg[kClusterSlots];
#pragma unroll
  for (int q = 0; q < kClusterSlots; ++q) {
    const int i = begin + q * kThreads + tid;
    reg[q] = i < end ? read_row(src, st, i) : Row{0, 0};
  }
  const long long k = k_ptr[0];
  int thr = -1;
  long long below = 0;
  if (k > 0) {
    int prefix = 0;
    bool short_of_k = false;
#pragma unroll 1
    for (int lvl = 0; lvl < kLevels; ++lvl) {
      const int shift = (kLevels - 1 - lvl) * kBits;
      cl.sync();  // the bins are clear everywhere
#pragma unroll
      for (int q = 0; q < kClusterSlots; ++q) {
        const Row& r = reg[q];
        const bool in = r.cap > 0 && (r.key >> (shift + kBits)) == prefix;
        flush_warp<SplitBins>(bins, in ? (r.key >> shift) & (kBins - 1) : -1,
                              (unsigned)r.cap);
      }
      cl.sync();  // every block's bins are complete
      long long v = 0;
#pragma unroll
      for (int b = 0; b < kCluster; ++b)
        v += SplitBins::value(*cl.map_shared_rank(&bins, (unsigned)b), tid);
      cl.sync();  // every read is done: the bins may be cleared
      bins.lo[tid] = 0;
      bins.hi[tid] = 0;
      long long excl, incl, total;
      block_scan(v, wsum, excl, incl, total);
      const long long need = k - below;
      if (lvl == 0 && total < need) {
        short_of_k = true;
        break;
      }
      if (excl < need && need <= incl) {
        sel_bin = tid;
        sel_below = excl;
      }
      __syncthreads();
      prefix = (prefix << kBits) | sel_bin;
      below += sel_below;
    }
    thr = short_of_k ? sk::SEARCH_HI : prefix;
  }
  const long long r = k - below;
  const int rem = r > 0 ? (int)r : 0;
#pragma unroll
  for (int q = 0; q < kClusterSlots; ++q) {
    const int i = begin + q * kThreads + tid;
    if (i >= end) continue;
    const Row& row = reg[q];
    *src.out(st, i) = row.key < thr ? row.cap
                      : row.key == thr && rem > 0 ? min(row.cap, rem) : 0;
  }
  cl.sync();  // no block exits while another may read its bins
}

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    printf("%s failed: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
}

cudaEvent_t ev_a, ev_b;

// Microseconds a launch of `fn` over `reps` launches back to back.
template <class F>
float time_us(F fn, int reps = 200) {
  fn();
  check(cudaDeviceSynchronize(), "warm-up");
  cudaEventRecord(ev_a);
  for (int r = 0; r < reps; ++r) fn();
  cudaEventRecord(ev_b);
  cudaEventSynchronize(ev_b);
  check(cudaGetLastError(), "timed launches");
  float ms = 0;
  cudaEventElapsedTime(&ms, ev_a, ev_b);
  return 1e3f * ms / reps;
}

}  // namespace

int main() {
  const int n = 16384, shards = 4, ln = n / shards;
  int *res_cap, *failures, *cap, *k_dev, *x, *x_ref;
  check(cudaMalloc(&res_cap, n * 4), "malloc");
  check(cudaMalloc(&failures, n * 4), "malloc");
  check(cudaMalloc(&cap, n * 4), "malloc");
  check(cudaMalloc(&k_dev, 4), "malloc");
  check(cudaMalloc(&x, n * 4), "malloc");
  check(cudaMalloc(&x_ref, n * 4), "malloc");
  cudaEventCreate(&ev_a);
  cudaEventCreate(&ev_b);
  int sm_khz = 0;
  cudaDeviceGetAttribute(&sm_khz, cudaDevAttrClockRate, 0);
  const char* names[] = {"random", "four", "one"};
  for (int pattern = 0; pattern < 3; ++pattern) {
    std::vector<int> rc(n), fl(n, 0), cp(n), out(n), ref(n);
    long long total = 0;
    srand(7 + pattern);
    for (int i = 0; i < n; ++i) {
      rc[i] = pattern == 0 ? rand() % 960
              : pattern == 1 ? 100 * (1 + rand() % 4) : 480;
      if (pattern == 0 && rand() % 13 == 0) fl[i] = 5 + rand() % 60;
      cp[i] = rand() % 7;
      total += cp[i];
    }
    const int k = (int)(total / 2);
    cudaMemcpy(res_cap, rc.data(), n * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(failures, fl.data(), n * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(cap, cp.data(), n * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(k_dev, &k, 4, cudaMemcpyHostToDevice);
    const FlatRows flat{res_cap, failures, cap, x, kMaxFailures};
    const FlatRows flat_ref{res_cap, failures, cap, x_ref, kMaxFailures};
    ShardRows sh;
    sh.count = shards;
    sh.n_local = ln;
    sh.log2_n = 12;  // ln = 4,096
    sh.inv_n = 1.0f / ln;
    sh.ordered = true;
    sh.max_failures = kMaxFailures;
    for (int d = 0; d < shards; ++d) {
      sk::Shard& s = sh.tab.s[d];
      s = sk::Shard{};
      s.res_cap = res_cap + d * ln;
      s.failures = failures + d * ln;
      s.cap = cap + d * ln;
      s.k = k_dev;
      s.x = x + d * ln;
      s.n = ln;
      s.offset = d * ln;
    }
    check((cudaError_t)launch_packfill(n, flat_ref, k_dev, nullptr),
          "K5 launch");
    check(cudaDeviceSynchronize(), "reference select");
    cudaMemcpy(ref.data(), x_ref, n * 4, cudaMemcpyDeviceToHost);
    auto same = [&](const char* what) {
      cudaMemcpy(out.data(), x, n * 4, cudaMemcpyDeviceToHost);
      for (int i = 0; i < n; ++i)
        if (out[i] != ref[i]) {
          printf("%s, %s scores: row %d placed %d, K5 %d\n", what,
                 names[pattern], i, out[i], ref[i]);
          exit(1);
        }
      cudaMemset(x, 0xff, n * 4);
    };
    const size_t smem = staged_bytes(n);
    check(configure<FlatRows, CarryBins, NoMarks>(), "configure");
    check(configure<ShardRows, CarryBins, NoMarks>(), "configure");
    check(configure<FlatRows, SplitBins, ClockMarks>(), "configure");
    check(configure<ShardRows, SplitBins, ClockMarks>(), "configure");
    ShardRows sh3 = sh;  // the same rows, resolved by three radix levels
    sh3.ordered = false;
    ShardRows shf = sh;  // the same rows, the shard found by the reciprocal
    shf.log2_n = -1;
    float t[7];
    t[0] = time_us([&] { launch_packfill(n, flat, k_dev, nullptr); });
    same("K5 SplitBins");
    t[1] = time_us([&] {
      packfill_kernel<FlatRows, CarryBins><<<1, kThreads, smem>>>(
          n, flat, k_dev); });
    same("K5 CarryBins");
    t[2] = time_us([&] { launch_packfill(n, sh, k_dev, nullptr); });
    same("K11 SplitBins");
    t[3] = time_us([&] {
      packfill_kernel<ShardRows, CarryBins><<<1, kThreads, smem>>>(
          n, sh, k_dev); });
    same("K11 CarryBins");
    t[4] = time_us([&] {
      select_cluster<<<kCluster, kThreads>>>(n, flat, k_dev); });
    same("cluster SplitBins");
    t[5] = time_us([&] { launch_packfill(n, sh3, k_dev, nullptr); });
    same("K11 three levels");
    t[6] = time_us([&] { launch_packfill(n, shf, k_dev, nullptr); });
    same("K11 reciprocal");
    printf("%s scores, k %d: K5 SplitBins %.2f us, CarryBins %.2f; K11 "
           "(4 shards) SplitBins %.2f, CarryBins %.2f, three radix levels "
           "%.2f, shard by reciprocal %.2f; 8-block cluster (three levels) "
           "SplitBins %.2f\n", names[pattern], k, t[0], t[1], t[2], t[3],
           t[5], t[6], t[4]);
    for (int v = 0; v < 2; ++v) {
      long long zero[kMarks] = {0};
      cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
      const int reps = 200;
      for (int r = 0; r < reps; ++r) {
        if (v == 0)
          packfill_kernel<FlatRows, SplitBins, ClockMarks>
              <<<1, kThreads, smem>>>(n, flat, k_dev);
        else
          packfill_kernel<ShardRows, SplitBins, ClockMarks>
              <<<1, kThreads, smem>>>(n, sh, k_dev);
      }
      check(cudaDeviceSynchronize(), "marked launches");
      long long ph[kMarks];
      cudaMemcpyFromSymbol(ph, g_phase, sizeof(ph));
      const char* phase[] = {"", "load", "level 0 bins", "level 0 pick",
                             "level 1 bins or band scan", "level 1 pick",
                             "level 2 bins", "level 2 pick", "place"};
      printf("  %s phases, us (SM clock %d MHz):", v ? "K11" : "K5",
             sm_khz / 1000);
      for (int p = 1; p < kMarks; ++p)
        if (ph[p] != 0)
          printf(" %s %.2f", phase[p], 1e3 * ph[p] / reps / sm_khz);
      printf("\n");
    }
  }
  return 0;
}
