// Probe of the per-node filter kernels (csrc/feasibility.cuh) on Hopper:
// the block size K1 (feasibility.cu), K1F (fused.cu) and K8 (gangfit.cu)
// take.  It compiles the kernels' own sources and runs, at node bucket
// 16,384:
//  * K1 on the headline plan's shape (10,000 nodes, four constraint slots
//    of which two are active, four platform rows with the wildcard);
//  * K1F on a cfg7 chunk's weighted slot (16 service slots, 0.1 CPU and
//    64 MiB demands on 64-CPU nodes, a carried placement of 0-5 tasks on
//    10,000 nodes, the headroom columns written);
//  * K8 at G = 1 on the headline's inputs;
//  * an empty kernel, the floor of a launch;
// each over threads a block (T), one node a thread.  Every variant's
// outputs must equal the first variant's (the shipped shape).  Times are
// one launch in microseconds, from a CUDA graph of 2,000 launches replayed
// behind a warm-up (time_us), after a busy kernel that raises the SM
// clock; each time includes the gap between two kernels of the graph,
// which the empty kernel's time measures.  Every variant runs twice, in
// two passes over the list.  (The shapes the kernels no longer offer --
// two or four nodes a thread, one staged copy a block, K1F's int64
// division -- were timed by this probe before they were taken out; PERF.md
// keeps those times.)  Build and run on the card, from the root of the
// checkout (the binary goes to the git-ignored build directory of that
// checkout):
//
//   mkdir -p swarmkit_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -I swarmkit_tpu_torch/csrc \
//       -o swarmkit_tpu_torch/_build/feasibility_probe \
//       swarmkit_tpu_torch/probes/feasibility_probe.cu
//   swarmkit_tpu_torch/_build/feasibility_probe

#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <cstring>
#include <vector>

#include "feasibility.cu"
#include "fused.cu"
#include "gangfit.cu"

namespace {

constexpr int kN = 16384;
constexpr int kValid = 10000;
constexpr int kReps = 2000;

#define CK(...)                                                        \
  do {                                                                 \
    cudaError_t e_ = (__VA_ARGS__);                                    \
    if (e_ != cudaSuccess) {                                           \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,                \
              cudaGetErrorString(e_));                                 \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

unsigned long long g_seed = 12345;
unsigned rnd() {
  g_seed = g_seed * 6364136223846793005ULL + 1442695040888963407ULL;
  return (unsigned)(g_seed >> 33);
}

template <class T>
T* upload(const std::vector<T>& v) {
  T* d = nullptr;
  CK(cudaMalloc(&d, v.size() * sizeof(T) + 16));
  CK(cudaMemcpy(d, v.data(), v.size() * sizeof(T), cudaMemcpyHostToDevice));
  return d;
}

template <class T>
std::vector<T> download(const T* d, size_t n) {
  std::vector<T> v(n);
  CK(cudaMemcpy(v.data(), d, n * sizeof(T), cudaMemcpyDeviceToHost));
  return v;
}

__global__ void empty_kernel() {}

cudaEvent_t ev_a, ev_b;

cudaStream_t g_stream;

// one launch in microseconds: kReps launches captured in a CUDA graph,
// the graph replayed 5 times behind a warm-up replay, CUDA events around
// the replays; the host's launch cost drops out, the gap between two
// kernels of a graph stays (the empty kernel's time)
template <class F>
double time_us(F launch) {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  CK(cudaStreamBeginCapture(g_stream, cudaStreamCaptureModeGlobal));
  for (int r = 0; r < kReps; ++r) launch();
  CK(cudaStreamEndCapture(g_stream, &graph));
  CK(cudaGraphInstantiate(&exec, graph, 0));
  CK(cudaGraphLaunch(exec, g_stream));
  CK(cudaStreamSynchronize(g_stream));
  CK(cudaEventRecord(ev_a, g_stream));
  for (int r = 0; r < 5; ++r) CK(cudaGraphLaunch(exec, g_stream));
  CK(cudaEventRecord(ev_b, g_stream));
  CK(cudaEventSynchronize(ev_b));
  float ms = 0;
  CK(cudaEventElapsedTime(&ms, ev_a, ev_b));
  CK(cudaGraphExecDestroy(exec));
  CK(cudaGraphDestroy(graph));
  return 1e3 * ms / (5.0 * kReps);
}

// a busy kernel of ~0.2 s, so the SM clock has risen before any timing
__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// ---------------------------------------------------------------- K1

struct K1Case {
  K1Args a;
  int32_t* cap;
  uint8_t* mask;
  int32_t* fail;
};

K1Case k1_case() {
  const int n = kN, n_valid = kValid;
  const int cc = 4, np = 4;
  std::vector<uint8_t> valid(n), ready(n), res_ok(n), extra(n), port(n);
  std::vector<int32_t> res_cap(n), svc(n), con_hash(cc * 2 * n),
      os(2 * n), arch(2 * n);
  for (int i = 0; i < n; ++i) {
    valid[i] = i < n_valid;
    ready[i] = rnd() % 100 < 97;
    res_ok[i] = rnd() % 100 < 97;
    extra[i] = rnd() % 100 < 99;
    port[i] = rnd() % 100 < 5;
    res_cap[i] = rnd() % 640;
    svc[i] = rnd() % 8;
  }
  for (auto& h : con_hash) h = rnd() % 4;
  for (auto& h : os) h = rnd() % 2;
  for (auto& h : arch) h = rnd() % 2;
  std::vector<int32_t> op = {1, 2, 0, 2}, exp = {1, 1, 0, 0, 0, 0, 0, 0};
  std::vector<int32_t> plat(4 * np, -1);
  for (int j = 0; j < 4; ++j) plat[j] = 0;          // any platform
  plat[4] = 1, plat[5] = 1, plat[6] = 0, plat[7] = 0;
  std::vector<int32_t> k = {(1 << 22) - 1}, maxrep = {0};
  std::vector<uint8_t> limited = {0};
  K1Case c;
  c.cap = upload(std::vector<int32_t>(n));
  c.mask = upload(std::vector<uint8_t>(n));
  c.fail = upload(std::vector<int32_t>(8));
  c.a = K1Args{n, cc, np,
               sk::NodeColumns{upload(valid), upload(ready), upload(extra),
                               upload(con_hash), upload(os), upload(arch),
                               upload(port), nullptr},
               upload(res_ok), upload(res_cap), upload(svc), upload(op),
               upload(exp), upload(plat), upload(k), upload(maxrep),
               upload(limited), c.mask, c.cap, c.fail};
  return c;
}

template <int T>
void k1_variant(const K1Case& c, std::vector<int32_t>* want_cap,
                std::vector<int32_t>* want_fail) {
  CK(cudaMemsetAsync(c.fail, 0, 32, g_stream));
  CK((cudaError_t)launch_feasibility<T>(c.a, g_stream));
  CK(cudaDeviceSynchronize());
  auto cap = download(c.cap, c.a.n);
  auto fail = download(c.fail, 8);
  bool same = true;
  if (want_cap->empty()) {
    *want_cap = cap;
    *want_fail = fail;
  } else {
    same = cap == *want_cap && fail == *want_fail;
  }
  const double us =
      time_us([&] { launch_feasibility<T>(c.a, g_stream); });
  printf("K1  T=%3d                            %7.3f us  %s\n", T, us,
         same ? "== first" : "DIFFERS");
  if (!same) exit(2);
}

// --------------------------------------------------------------- K1F

struct K1FCase {
  K1FArgs a;
  std::vector<long long> cpu, mem;
  std::vector<int32_t> total, acc;
  int32_t* outs[5];   // cap, svc, hr_cpu, hr_mem, fail
};

K1FCase k1f_case() {
  const int n = kN, S = 16, G = 4, cc = 1, np = 1, g = 2;
  K1FCase c;
  std::vector<uint8_t> valid(n), ready(n), extra(G * n, 1);
  std::vector<int32_t> svc0(S * n), x(n, 0), hashes(G * cc * 2 * n, 0),
      zeros2(2 * n, 0);
  c.cpu.resize(n);
  c.mem.resize(n);
  c.total.resize(n);
  c.acc.assign(S * n, 0);
  const long long cpu_unit = 100000000LL, mem_unit = 64LL << 20;
  for (int i = 0; i < n; ++i) {
    valid[i] = i < kValid;
    ready[i] = rnd() % 100 < 98;
    c.cpu[i] = 64000000000LL - (long long)(rnd() % 600) * cpu_unit;
    c.mem[i] = (256LL << 30) - (long long)(rnd() % 600) * mem_unit;
    c.total[i] = rnd() % 600;
    if (i < kValid) x[i] = rnd() % 6;
  }
  for (int i = 0; i < 50; ++i) c.cpu[i] = cpu_unit;
  for (int i = 50; i < 60; ++i) c.cpu[i] = cpu_unit - 1;
  for (int i = 70; i < 80; ++i) c.cpu[i] = -7;
  for (auto& v : svc0) v = rnd() % 4;
  std::vector<int32_t> k = {50000, 50000, 50000, 50000};
  std::vector<int32_t> slot = {0, 1, 2, 0}, maxrep(G, 0);
  std::vector<long long> cpu_d(G, cpu_unit), mem_d(G, mem_unit);
  std::vector<int32_t> op(G * cc, 2), exp(G * cc * 2, 0),
      plat(G * np * 4, -1);
  for (auto& o : c.outs) o = upload(std::vector<int32_t>(n));
  c.a = K1FArgs{n, S, cc, np, g,
                sk::NodeColumns{upload(valid), upload(ready),
                                upload(extra) + (size_t)g * n,
                                upload(hashes) + (size_t)g * cc * 2 * n,
                                upload(zeros2), upload(zeros2), nullptr,
                                nullptr},
                upload(op) + g * cc, upload(exp) + g * cc * 2,
                upload(plat) + g * np * 4, upload(k) + g, upload(maxrep) + g,
                upload(cpu_d), upload(mem_d), upload(slot), upload(svc0),
                upload(c.acc), upload(c.total), upload(c.cpu), upload(c.mem),
                upload(x), c.outs[4], c.outs[0], c.outs[1], nullptr,
                c.outs[2], c.outs[3]};
  return c;
}

void k1f_reset(const K1FCase& c) {
  CK(cudaStreamSynchronize(g_stream));
  CK(cudaMemcpy(c.a.cpu, c.cpu.data(), kN * 8, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(c.a.mem, c.mem.data(), kN * 8, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(c.a.total, c.total.data(), kN * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(c.a.svc_acc, c.acc.data(), c.acc.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemset(c.outs[4], 0, 32));
  CK(cudaDeviceSynchronize());
}

std::vector<long long> k1f_digest(const K1FCase& c) {
  std::vector<long long> d;
  for (int j = 0; j < 4; ++j) {
    auto v = download(c.outs[j], kN);
    d.insert(d.end(), v.begin(), v.end());
  }
  auto f = download(c.outs[4], 8);
  d.insert(d.end(), f.begin(), f.end());
  auto cpu = download(c.a.cpu, kN), mem = download(c.a.mem, kN);
  d.insert(d.end(), cpu.begin(), cpu.end());
  d.insert(d.end(), mem.begin(), mem.end());
  auto tot = download(c.a.total, kN), acc = download(c.a.svc_acc, 16 * kN);
  d.insert(d.end(), tot.begin(), tot.end());
  d.insert(d.end(), acc.begin(), acc.end());
  return d;
}

template <int T>
void k1f_variant(const K1FCase& c, std::vector<long long>* want) {
  k1f_reset(c);
  CK((cudaError_t)launch_fused_feasibility<T>(c.a, g_stream));
  CK(cudaDeviceSynchronize());
  const auto got = k1f_digest(c);
  bool same = true;
  if (want->empty()) *want = got;
  else same = got == *want;
  const double us =
      time_us([&] { launch_fused_feasibility<T>(c.a, g_stream); });
  printf("K1F T=%3d                            %7.3f us  %s\n", T, us,
         same ? "== first" : "DIFFERS");
  if (!same) exit(2);
}

// ---------------------------------------------------------------- K8

template <int T>
void k8_variant(const K1Case& c, uint8_t* out, std::vector<uint8_t>* want) {
  auto run = [&] {
    CK(cudaMemsetAsync(out, 0, 48, g_stream));
    launch_gang_fit<T>(kN, 1, c.a.cc, c.a.np, c.a.cols.valid,
                       c.a.cols.ready, c.a.res_ok, c.a.res_cap, c.a.svc_tasks,
                       c.a.cols.extra_mask, c.a.cols.con_hash, c.a.con_op,
                       c.a.con_exp, c.a.plat, c.a.cols.os_hash,
                       c.a.cols.arch_hash, c.a.cols.port_conflict, nullptr,
                       c.a.k, c.a.maxrep, c.a.port_limited, out, g_stream);
  };
  run();
  CK(cudaDeviceSynchronize());
  auto got = download(out, 48);
  std::fill(got.begin() + 40, got.begin() + 44, 0);  // done: blocks seen
  bool same = true;
  if (want->empty()) *want = got;
  else same = got == *want;
  const double us = time_us(run);
  printf("K8  T=%3d (+ memset)                %7.3f us  %s\n", T, us,
         same ? "== first" : "DIFFERS");
  if (!same) exit(2);
}

}  // namespace

void pass(const char* label);

int main() {
  CK(cudaEventCreate(&ev_a));
  CK(cudaEventCreate(&ev_b));
  CK(cudaStreamCreateWithFlags(&g_stream, cudaStreamNonBlocking));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, %d SMs; node bucket %d, %d launches a timing\n", prop.name,
         prop.multiProcessorCount, kN, kReps);
  int clock_khz = 0;
  CK(cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0));
  spin_kernel<<<132, 32, 0, g_stream>>>(200LL * clock_khz);  // ~0.2 s
  CK(cudaStreamSynchronize(g_stream));
  pass("pass 1");
  pass("pass 2");
  return 0;
}

void pass(const char* label) {
  printf("---- %s\n", label);
  printf("empty kernel                         %7.3f us\n",
         time_us([] { empty_kernel<<<1, 32, 0, g_stream>>>(); }));
  printf("empty kernel, 128 blocks of 128      %7.3f us\n",
         time_us([] { empty_kernel<<<128, 128, 0, g_stream>>>(); }));

  const K1Case k1 = k1_case();
  std::vector<int32_t> cap, fail;
  k1_variant<128>(k1, &cap, &fail);   // shipped
  k1_variant<64>(k1, &cap, &fail);
  k1_variant<32>(k1, &cap, &fail);
  k1_variant<256>(k1, &cap, &fail);

  const K1FCase f = k1f_case();
  std::vector<long long> want;
  k1f_variant<128>(f, &want);   // shipped
  k1f_variant<64>(f, &want);
  k1f_variant<32>(f, &want);
  k1f_variant<256>(f, &want);

  uint8_t* out = upload(std::vector<uint8_t>(48));
  std::vector<uint8_t> want8;
  k8_variant<256>(k1, out, &want8);   // shipped
  k8_variant<128>(k1, out, &want8);
  k8_variant<64>(k1, out, &want8);
  printf("memset of 48 bytes alone             %7.3f us\n",
         time_us([&] { cudaMemsetAsync(out, 0, 48, g_stream); }));
}
