// Probe of the per-node filter kernels (csrc/feasibility.cuh) on Hopper:
// the block size K1 (feasibility.cu), K1F (fused.cu) and K8 (gangfit.cu)
// take, and how the scored K1F stages its learned scorer.  It compiles the
// kernels' own sources and runs, at node bucket 16,384:
//  * K1 on the headline plan's shape (10,000 nodes, four constraint slots
//    of which two are active, four platform rows with the wildcard), and
//    scored (learned, 8 hidden units) on it;
//  * K1F on a cfg7 chunk's slot (16 service slots, 0.1 CPU and 64 MiB
//    demands on 64-CPU nodes, a carried placement of 0-5 tasks on 10,000
//    nodes, res_cap written), and scored (K6's score as the epilogue,
//    weighted and learned with 8 and 64 hidden units, e written): the
//    shipped staging, each warp loading its copy of the weights and the
//    MLP one word a lane with the group's scalars, against a probe-only
//    kernel whose warps stage the MLP with one bulk asynchronous copy
//    (cp.async.bulk, the TMA engine, completing on a per-warp mbarrier)
//    issued before the group's staging and waited for only before the
//    score;
//  * K8 (M blocks a gang) at n = 512, 1,024 (the gang fleet's node
//    bucket), 4,096, 8,192 and 16,384 nodes for G = 1, 2 and 8: the
//    shipped shape (gangfit.cu gang_shape) and every other block size T
//    of 64 to 1,024 with M = 1, 2, 4, ... 128 blocks a gang that leave no
//    block without a node and a thread at most 8 nodes; past one block,
//    every workspace word must be back at 0 after the timed launches;
//  * an empty kernel, the floor of a launch;
// each over threads a block (T), one node a thread.  Every variant's
// outputs must equal the first variant's (the shipped shape).  Times are
// one launch in microseconds, from a CUDA graph of 2,000 launches replayed
// behind a warm-up (time_us), after a busy kernel that raises the SM
// clock; each time includes the gap between two kernels of the graph,
// which the empty kernel's time measures.  Every variant runs twice, in
// two passes over the list.  (The shapes the kernels no longer offer --
// two or four nodes a thread, one staged copy a block, K8's thread-block
// clusters, K1F's int64 division -- were timed by this probe before they
// were taken out; PERF.md keeps those times.)  Build and run on the
// card, from the root of the checkout (the binary goes to the git-ignored
// build directory of that checkout):
//
//   mkdir -p swarmkit_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -I swarmkit_tpu_torch/csrc \
//       -o swarmkit_tpu_torch/_build/feasibility_probe \
//       swarmkit_tpu_torch/probes/feasibility_probe.cu
//   swarmkit_tpu_torch/_build/feasibility_probe        # or: ... k8

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
  int32_t* e;
  const int32_t* failures;
  const int32_t* hr;   // hr_cpu, hr_mem, hr_gen
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
  std::vector<int32_t> total(n), failures(n), hr(3 * n);
  for (int i = 0; i < n; ++i) {
    total[i] = rnd() % 1500;
    failures[i] = (rnd() % 10 == 0) ? rnd() % 80 : 0;
  }
  for (auto& h : hr) h = rnd() % 1024;
  c.e = upload(std::vector<int32_t>(n));
  const int32_t* hr_d = upload(hr);
  c.a = K1Args{n, cc, np, upload(total),
               sk::NodeColumns{upload(valid), upload(ready), upload(extra),
                               upload(con_hash), upload(os), upload(arch),
                               upload(port), nullptr},
               upload(res_ok), upload(res_cap), upload(svc), upload(op),
               upload(exp), upload(plat), upload(k), upload(maxrep),
               upload(limited), c.mask, c.cap, c.fail, sk::ScoreArgs{}};
  c.failures = upload(failures);
  c.hr = hr_d;
  return c;
}

// the learned scorer of ``hidden`` units (within the artifact's clamps,
// pre-activations of both signs), one device array each, and the same
// packed [w1 | b1 | w2 | b2] padded to 16 bytes for the bulk copy
struct Mlp {
  int hidden;
  int32_t *w1, *b1, *w2, *b2, *packed, *weights;
  int packed_bytes;
};

Mlp make_mlp(int hidden) {
  std::vector<int32_t> w1(6 * hidden), b1(hidden), w2(hidden), b2(1);
  for (auto& v : w1) v = (int)(rnd() % 255) - 127;
  for (auto& v : b1) v = (int)(rnd() % 255) - 127;
  for (auto& v : w2) v = (int)(rnd() % 255) - 127;
  b2[0] = (int)(rnd() % 255) - 127;
  std::vector<int32_t> packed(w1);
  packed.insert(packed.end(), b1.begin(), b1.end());
  packed.insert(packed.end(), w2.begin(), w2.end());
  packed.push_back(b2[0]);
  while (packed.size() % 4) packed.push_back(0);
  Mlp m{hidden, upload(w1), upload(b1), upload(w2), upload(b2),
        upload(packed), upload(std::vector<int32_t>{2, 3, 1, 1}),
        (int)(packed.size() * 4)};
  return m;
}

sk::ScoreArgs score_args(int mode, const Mlp& m, const int32_t* failures,
                         const int32_t* hr, int n, int32_t* e) {
  return sk::ScoreArgs{mode,     m.hidden, 5,      m.weights, m.w1,
                       m.b1,     m.w2,     m.b2,   failures,  hr,
                       hr ? hr + n : nullptr, hr ? hr + 2 * n : nullptr, e};
}

template <int T, bool kScored>
void k1_variant(const K1Case& c, const char* label,
                std::vector<int32_t>* want) {
  CK(cudaMemsetAsync(c.fail, 0, 32, g_stream));
  CK((cudaError_t)launch_feasibility<T, kScored>(c.a, g_stream));
  CK(cudaDeviceSynchronize());
  auto got = download(c.cap, c.a.n);
  auto fail = download(c.fail, 8);
  got.insert(got.end(), fail.begin(), fail.end());
  if (kScored) {
    auto e = download(c.e, c.a.n);
    got.insert(got.end(), e.begin(), e.end());
  }
  bool same = true;
  if (want->empty()) *want = got;
  else same = got == *want;
  const double us =
      time_us([&] { launch_feasibility<T, kScored>(c.a, g_stream); });
  printf("K1  %-16s T=%3d               %7.3f us  %s\n", label, T, us,
         same ? "== first" : "DIFFERS");
  if (!same) exit(2);
}

// --------------------------------------------------------------- K1F

struct K1FCase {
  K1FArgs a;
  std::vector<long long> cpu, mem;
  std::vector<int32_t> total, acc;
  int32_t* outs[5];   // cap, svc, res_cap, e, fail
  const int32_t* failures;   // [G, n]
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
      plat(G * np * 4, -1), failures(G * n);
  for (auto& f : failures) f = (rnd() % 10 == 0) ? rnd() % 80 : 0;
  for (auto& o : c.outs) o = upload(std::vector<int32_t>(n));
  c.failures = upload(failures);
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
                upload(x), c.outs[4], c.outs[0], c.outs[1], c.outs[2],
                sk::ScoreArgs{}};
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
    if (j == 2 && c.a.res_cap_out == nullptr) continue;
    if (j == 3 && c.a.score.e == nullptr) continue;
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

// The probe-only scored K1F: the shipped kernel's body (fused.cu) with
// the learned scorer staged by one bulk asynchronous copy a warp (the TMA
// engine, cp.async.bulk into the warp's copy, completing on the warp's
// mbarrier) from the packed [w1 | b1 | w2 | b2], issued before the group's
// staging and waited for just before the score; the weights by lanes 0-3.
constexpr int kWordsPad = 4 + sk::score_words(sk::kStratLearned,
                                              sk::kMaxHidden) + 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int T>
__global__ void __launch_bounds__(T) fused_bulk_kernel(
    const K1FArgs a, const int32_t* __restrict__ packed, int packed_bytes) {
  constexpr int kWarps = T / 32;
  extern __shared__ int sm[];
  __shared__ unsigned wsum[2 * kWarps];
  __shared__ sk::SlotScalars scs[kWarps];
  __shared__ __align__(16) int words[kWarps][kWordsPad & ~3];
  __shared__ __align__(8) unsigned long long bars[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  sk::SlotScalars* sc = &scs[warp];
  int* ws = words[warp];
  const uint32_t bar = smem_u32(&bars[warp]);
  const bool learned = a.score.mode == sk::kStratLearned;
  if (learned && lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(packed_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(ws + 4)), "l"(packed), "r"(packed_bytes), "r"(bar)
        : "memory");
  }
  const int n = a.n;
  const int i = blockIdx.x * T + threadIdx.x;
  const bool has_prev = a.x_prev != nullptr;
  sk::NodeRegs regs;
  sk::load_early(a.cols, i, n, regs);
  sk::FusedSource src{a.cpu, a.mem, a.total, a.svc_acc, a.svc0, a.x_prev,
                      n, sc, learned};
  src.load_early(i, n);
  const int32_t f = sk::load_col(a.score.failures, i, n);
  const int w = lane < 4 && a.score.weights != nullptr ? a.score.weights[lane]
                                                       : 0;
  const int* grp = sk::stage_group(
      sm, a.cc, a.np, a.con_op, a.con_exp, a.plat, a.k, a.maxrep, nullptr,
      SlotExtra{a.cpu_d, a.mem_d, a.slot, a.g, a.S, has_prev, sc});
  if (lane < 4) ws[lane] = w;
  unsigned fails;
  bool mask;
  int cap;
  sk::feasible_node(grp, a.cols, regs, src, i, n, fails, mask, cap);
  if (learned) {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.b32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar) : "memory");
  }
  __syncwarp();
  if (i < n) {
    a.cap_out[i] = cap;
    a.svc_out[i] = src.svc;
    a.score.e[i] = sk::score_node(a.score, ws, src.svc, src.total, f,
                                  regs.ready != 0, src.hr_cpu(),
                                  src.hr_mem(), (int)sk::kHrClamp);
    if (has_prev && src.x != 0) {
      a.total[i] = src.total;
      a.cpu[i] = src.c;
      a.mem[i] = src.m;
      if (src.same_slot())
        a.svc_acc[(size_t)sc->slot * n + i] = src.acc;
      else if (src.other_slot())
        a.svc_acc[(size_t)sc->slot_prev * n + i] = src.acc_prev;
    }
  }
  sk::fold_fails<kWarps>(fails, wsum, a.fail_out);
}

template <int T>
int launch_bulk(const K1FArgs& a, const Mlp& m, cudaStream_t stream) {
  const size_t smem = sk::staged_bytes(T / 32, a.cc, a.np);
  fused_bulk_kernel<T><<<(a.n + T - 1) / T, T, smem, stream>>>(
      a, m.packed, m.packed_bytes);
  return (int)cudaGetLastError();
}

// variant: 0 = the shipped per-warp staging, 1 = the bulk copy (scored)
template <int T, bool kScored>
void k1f_variant(K1FCase c, const char* label, std::vector<long long>* want,
                 int mode = 0, const Mlp* m = nullptr, int variant = 0) {
  if (kScored) {
    c.a.res_cap_out = nullptr;
    c.a.score = score_args(mode, *m, c.failures + (size_t)c.a.g * kN,
                           nullptr, kN, c.outs[3]);
  }
  auto launch = [&] {
    return variant == 1 ? launch_bulk<T>(c.a, *m, g_stream)
                        : launch_fused_feasibility<T, kScored>(c.a,
                                                               g_stream);
  };
  k1f_reset(c);
  CK((cudaError_t)launch());
  CK(cudaDeviceSynchronize());
  const auto got = k1f_digest(c);
  bool same = true;
  if (want->empty()) *want = got;
  else same = got == *want;
  const double us = time_us(launch);
  printf("K1F %-24s T=%3d       %7.3f us  %s\n", label, T, us,
         same ? "== first" : "DIFFERS");
  if (!same) exit(2);
}

// ---------------------------------------------------------------- K8

// G gangs of n nodes (the headline's filters: four constraint slots of
// which two are active, four platform rows with the wildcard), each gang
// with its own columns and a k that some gangs' totals reach
struct K8Case {
  int n, g, cc, np;
  GangArgs a;
  uint8_t* out;
};

K8Case k8_case(int n, int g) {
  const int cc = 4, np = 4;
  const size_t gn = (size_t)g * n;
  std::vector<uint8_t> valid(gn), ready(gn), res_ok(gn), extra(gn),
      port(gn);
  std::vector<int32_t> res_cap(gn), svc(gn), con_hash(gn * cc * 2),
      os(2 * gn), arch(2 * gn);
  for (size_t i = 0; i < gn; ++i) {
    valid[i] = (int)(i % n) < n * 3 / 4;
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
  std::vector<int32_t> op, exp, plat, k, maxrep(g, 0);
  for (int j = 0; j < g; ++j) {
    for (int v : {1, 2, 0, 2}) op.push_back(v);
    for (int v : {1, 1, 0, 0, 0, 0, 0, 0}) exp.push_back(v);
    for (int v : {0, 0, 0, 0, 1, 1, 0, 0, -1, 0, 0, 0, -1, 0, 0, 0})
      plat.push_back(v);
    k.push_back((int)(rnd() % (unsigned)(n * 200)));
  }
  std::vector<uint8_t> limited(g, 0);
  K8Case c{n, g, cc, np,
           GangArgs{sk::NodeColumns{upload(valid), upload(ready),
                                    upload(extra), upload(con_hash),
                                    upload(os), upload(arch), upload(port),
                                    nullptr},
                    upload(res_ok), upload(res_cap), upload(svc), upload(op),
                    upload(exp), upload(plat), upload(k), upload(maxrep),
                    upload(limited)},
           upload(std::vector<uint8_t>(44 * (size_t)g))};
  return c;
}

template <int T>
void k8_variant(const K8Case& c, int m, std::vector<uint8_t>* want) {
  const size_t bytes = 44 * (size_t)c.g;
  CK(cudaMemset(c.out, 0xab, bytes));   // every byte must be written
  const size_t wbytes = work_bytes(c.g, m);
  uint8_t* work = nullptr;
  if (wbytes) {
    CK(cudaMalloc(&work, wbytes));
    CK(cudaMemset(work, 0, wbytes));
  }
  auto run = [&] {
    return launch_gang_fit<T>(c.n, c.g, m, c.cc, c.np, c.a, c.out, work,
                              g_stream);
  };
  CK((cudaError_t)run());
  CK(cudaDeviceSynchronize());
  auto got = download(c.out, bytes);
  bool same = true;
  if (want->empty()) *want = got;
  else same = got == *want;
  const double us = time_us([&] { run(); });
  // the add that completed each workspace word put it back to 0
  bool words_zero = true;
  if (work)
    for (unsigned long long v : download((const unsigned long long*)work,
                                         wbytes / 8))
      words_zero = words_zero && v == 0;
  printf("K8  n=%5d G=%d T=%4d M=%3d  %7.3f us  %s%s\n", c.n, c.g, T, m, us,
         same ? "== first" : "DIFFERS",
         words_zero ? "" : ", a workspace word left set");
  if (work) CK(cudaFree(work));
  if (!same || !words_zero) exit(2);
}

// the shipped shape of G gangs of n nodes first, then every other block
// size T and blocks a gang M (a power of two up to kMaxBlocks) that leave
// no block without a node and give a thread at most 8 nodes
void k8_shapes(int n, int g) {
  const K8Case c = k8_case(n, g);
  std::vector<uint8_t> want;
  const GangShape s = gang_shape(n, g);
  auto one = [&](int t, int m) {
    if (t == 64) k8_variant<64>(c, m, &want);
    else if (t == 128) k8_variant<128>(c, m, &want);
    else if (t == 256) k8_variant<256>(c, m, &want);
    else if (t == 512) k8_variant<512>(c, m, &want);
    else k8_variant<1024>(c, m, &want);
  };
  one(s.threads, s.blocks);
  for (int t : {64, 128, 256, 512, 1024})
    for (int m = 1; m <= kMaxBlocks; m *= 2) {
      if ((m - 1) * t >= n || m * t * 8 < n) continue;
      if (t == s.threads && m == s.blocks) continue;
      one(t, m);
    }
}

}  // namespace

void pass(const char* label, bool k8_only);
void other_kernels();

// ``feasibility_probe k8`` runs the K8 shapes alone
int main(int argc, char** argv) {
  const bool k8_only = argc > 1 && strcmp(argv[1], "k8") == 0;
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
  pass("pass 1", k8_only);
  pass("pass 2", k8_only);
  return 0;
}

void pass(const char* label, bool k8_only) {
  printf("---- %s\n", label);
  printf("empty kernel                         %7.3f us\n",
         time_us([] { empty_kernel<<<1, 32, 0, g_stream>>>(); }));
  printf("empty kernel, 128 blocks of 128      %7.3f us\n",
         time_us([] { empty_kernel<<<128, 128, 0, g_stream>>>(); }));
  if (!k8_only) other_kernels();

  // K8: M blocks a gang, at 512, the gang fleet's node bucket (1,024),
  // 4,096, 8,192 and the headline's 16,384, for G = 1, 2 and 8
  for (int n : {512, 1024, 4096, 8192, kN})
    for (int g : {1, 2, 8}) k8_shapes(n, g);
}

// K1 and K1F, plain and scored
void other_kernels() {
  K1Case k1 = k1_case();
  std::vector<int32_t> want1;
  k1_variant<128, false>(k1, "", &want1);   // shipped
  k1_variant<64, false>(k1, "", &want1);
  k1_variant<32, false>(k1, "", &want1);
  k1_variant<256, false>(k1, "", &want1);
  const Mlp h8 = make_mlp(8), h64 = make_mlp(64);
  k1.a.score = score_args(sk::kStratLearned, h8, k1.failures, k1.hr, kN,
                          k1.e);
  want1.clear();
  k1_variant<128, true>(k1, "scored learned8", &want1);   // shipped
  k1_variant<64, true>(k1, "scored learned8", &want1);

  const K1FCase f = k1f_case();
  std::vector<long long> want;
  k1f_variant<128, false>(f, "", &want);   // shipped
  k1f_variant<64, false>(f, "", &want);
  k1f_variant<32, false>(f, "", &want);
  k1f_variant<256, false>(f, "", &want);
  // the scored slot entry: each mode against its own first variant
  want.clear();
  k1f_variant<128, true>(f, "scored weighted", &want, sk::kStratWeighted,
                         &h8);
  k1f_variant<64, true>(f, "scored weighted", &want, sk::kStratWeighted,
                        &h8);
  for (const Mlp* m : {&h8, &h64}) {
    const char* lw = m->hidden == 8 ? "learned8 per-warp" : "learned64 "
                                                            "per-warp";
    const char* lb = m->hidden == 8 ? "learned8 bulk copy" : "learned64 "
                                                             "bulk copy";
    want.clear();
    k1f_variant<128, true>(f, lw, &want, sk::kStratLearned, m);  // shipped
    k1f_variant<128, true>(f, lb, &want, sk::kStratLearned, m, 1);
    k1f_variant<64, true>(f, lw, &want, sk::kStratLearned, m);
    k1f_variant<64, true>(f, lb, &want, sk::kStratLearned, m, 1);
  }
}
