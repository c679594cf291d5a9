// K1: the fused filter pipeline, per-node capacity and short-circuit
// failure counts.
//
// Replaces swarmkit_tpu/ops/kernel.py:190 feasibility_and_capacity (and its
// jitted entry feasibility_jit, :763).  It evaluates the eight filter masks
// in pipeline order (ready, resources, plugins, constraints, platforms,
// host ports, max replicas, tenant quota), the node's capacity for this
// group, and which filter rejected it first; the per-node body lives in
// feasibility.cuh, which K1F (fused.cu) and K8 (gangfit.cu) share.
//
// A scored launch (the per-group strategy route's weighted or learned
// group: swarmkit_tpu/ops/kernel.py:502 plan_strategy -> :484
// strategy_score) also writes each node's level e, K6's score as the
// epilogue of the same launch (feasibility.cuh score_node), from the
// group's svc, total, failures, ready and headroom columns and its weights
// or MLP, staged a copy a warp with the group's scalars.
//
// Bound on the H100: bytes.  Each node is read once and written once (4
// bytes of capacity, 1 of mask); the arithmetic is a few integer compares.
// A column that the group does not need is never read (feasibility.cuh),
// so a group with two constraints and the wildcard platform moves 29 bytes
// per node: 0.14 us at node bucket 16,384, far under the launch itself.
// What bounds it in practice is latency: the launch, the memory round
// trips and the block's tail.  The design keeps those few:
//  * the loads that do not depend on the group's scalars are issued
//    first; every warp then stages its own copy of the scalars in shared
//    memory with one load a lane, with no block barrier, and the rest are
//    issued, so a thread waits on two round trips, not the five of a chain
//    con_op -> con_hash -> plat -> hashes;
//  * the fail counts are folded per warp with __reduce_add_sync and added
//    with one global atomic per counter and block, with no shared atomics.
// The launch shape was measured (probes/feasibility_probe.cu, PERF.md): at
// node bucket 16,384 one node a thread beats two or four (vector loads of
// four nodes leave 128 warps on the card, each with four nodes' dependent
// compute), and per-warp staging beats a block barrier.  The grid is sized
// to the node count, 128 blocks at 16,384 nodes: one partial wave of the
// 132 SMs, which a grid-stride cap of one wave would not change.

#include "feasibility.cuh"

namespace {

// K1's launch shape, chosen by probes/feasibility_probe.cu (PERF.md): one
// node a thread, 128 threads a block
constexpr int kK1Threads = 128;

struct K1Args {
  int n, cc, np;
  const int32_t* total;    // scored, learned: the total task counts
  sk::NodeColumns cols;
  const uint8_t* res_ok;
  const int32_t* res_cap;
  const int32_t* svc_tasks;
  const int32_t* con_op;
  const int32_t* con_exp;
  const int32_t* plat;
  const int32_t* k;
  const int32_t* maxrep;
  const uint8_t* port_limited;
  uint8_t* mask_out;   // nullable
  int32_t* cap_out;
  int32_t* fail_out;
  sk::ScoreArgs score;  // the scored instantiation's
};

// kScored: the strategy route's instantiation, which also writes e
template <int T, bool kScored>
__global__ void __launch_bounds__(T) feasibility_kernel(const K1Args a) {
  constexpr int kWarps = T / 32;
  extern __shared__ int sm[];
  __shared__ unsigned wsum[2 * kWarps];
  const int n = a.n;
  const int i = blockIdx.x * T + threadIdx.x;
  const sk::ScoreArgs& s = a.score;
  const int tail = kScored ? sk::score_words(s.mode, s.hidden) : 0;

  sk::NodeRegs regs;
  sk::load_early(a.cols, i, n, regs);
  sk::PlainSource src{a.res_ok, a.res_cap, a.svc_tasks, kScored};
  src.load_early(i, n);
  // the score's columns: what its mode reads
  int32_t f = 0, total = 0, hc = 0, hm = 0, hg = 0;
  sk::ScoreStage st;
  if (kScored) {
    f = sk::load_col(s.failures, i, n);
    if (s.mode == sk::kStratWeighted || s.mode == sk::kStratLearned) {
      hc = sk::load_col(s.hr_cpu, i, n);
      hm = sk::load_col(s.hr_mem, i, n);
    }
    if (s.mode == sk::kStratWeighted) hg = sk::load_col(s.hr_gen, i, n);
    if (s.mode == sk::kStratLearned) total = sk::load_col(a.total, i, n);
    sk::score_load(s, st);
  }
  const int* grp = sk::stage_group(sm, a.cc, a.np, a.con_op, a.con_exp,
                                   a.plat, a.k, a.maxrep, a.port_limited,
                                   sk::NoExtra(), tail);
  const int* ws = grp + sk::group_words(a.cc, a.np);
  if (kScored) {
    sk::score_store(s, st, const_cast<int*>(ws));
    __syncwarp();
  }

  unsigned fails;
  bool mask;
  int cap;
  sk::feasible_node(grp, a.cols, regs, src, i, n, fails, mask, cap);
  if (i < n) {
    a.cap_out[i] = cap;
    if (a.mask_out != nullptr) a.mask_out[i] = mask ? 1 : 0;
    if (kScored)
      s.e[i] = sk::score_node(s, ws, src.svc, total, f, regs.ready != 0, hc,
                              hm, hg);
  }
  // every lane of every warp reaches the fold (no early return above)
  sk::fold_fails<kWarps>(fails, wsum, a.fail_out);
}

template <int T, bool kScored>
int launch_feasibility(const K1Args& a, cudaStream_t stream) {
  if (a.n <= 0) return 0;
  size_t extra = 0;
  if (kScored) {
    const sk::ScoreArgs& s = a.score;
    const bool hr = s.mode == sk::kStratWeighted ||
                    s.mode == sk::kStratLearned;
    if (s.e == nullptr || s.failures == nullptr ||
        (hr && (s.hr_cpu == nullptr || s.hr_mem == nullptr)) ||
        (s.mode == sk::kStratWeighted &&
         (s.weights == nullptr || s.hr_gen == nullptr)) ||
        (s.mode == sk::kStratLearned &&
         (a.total == nullptr || s.hidden <= 0 || s.hidden > sk::kMaxHidden ||
          s.w1 == nullptr || s.b1 == nullptr || s.w2 == nullptr ||
          s.b2 == nullptr)))
      return (int)cudaErrorInvalidValue;
    extra = (size_t)sk::score_words(s.mode, s.hidden);
  }
  const size_t smem = sk::staged_bytes(T / 32, a.cc, a.np, extra);
  if (smem > sk::kMaxGroupSmem) return (int)cudaErrorInvalidValue;
  feasibility_kernel<T, kScored><<<(a.n + T - 1) / T, T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sk_feasibility(
    int n, int cc, int np, const void* valid, const void* ready,
    const void* res_ok, const void* res_cap, const void* svc_tasks,
    const void* extra_mask, const void* con_hash, const void* con_op,
    const void* con_exp, const void* plat, const void* os_hash,
    const void* arch_hash, const void* port_conflict, const void* quota_ok,
    const void* k, const void* maxrep, const void* port_limited,
    void* mask_out, void* cap_out, void* fail_out, const void* total,
    const void* score, void* stream) {
  K1Args a{
      n, cc, np, (const int32_t*)total,
      sk::NodeColumns{(const uint8_t*)valid, (const uint8_t*)ready,
                      (const uint8_t*)extra_mask, (const int32_t*)con_hash,
                      (const int32_t*)os_hash, (const int32_t*)arch_hash,
                      (const uint8_t*)port_conflict,
                      (const uint8_t*)quota_ok},
      (const uint8_t*)res_ok, (const int32_t*)res_cap,
      (const int32_t*)svc_tasks, (const int32_t*)con_op,
      (const int32_t*)con_exp, (const int32_t*)plat, (const int32_t*)k,
      (const int32_t*)maxrep, (const uint8_t*)port_limited,
      (uint8_t*)mask_out, (int32_t*)cap_out, (int32_t*)fail_out,
      sk::ScoreArgs{}};
  if (score == nullptr)
    return launch_feasibility<kK1Threads, false>(a, (cudaStream_t)stream);
  // score: a host ScoreArgs (feasibility.cuh); total its learned feature
  a.score = *(const sk::ScoreArgs*)score;
  return launch_feasibility<kK1Threads, true>(a, (cudaStream_t)stream);
}

extern "C" const char* sk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
