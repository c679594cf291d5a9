// K1F and K4's carry update: the scan step of the fused many-service plan,
// around the per-group fills.
//
// Replaces the body of swarmkit_tpu/ops/kernel.py:640 plan_fused (its
// jitted entry plan_fused_jit, :728) other than the fills: the reference's
// lax.scan carries the cluster state from one group slot to the next; each
// step adds the previous group's placements into that carry (:715-719),
// derives the group's resource columns from it (:669-678, :692-694), runs
// the filter pipeline on them (plan_group / plan_strategy -> :190
// feasibility_and_capacity) and, for a weighted or learned group, scores
// the nodes (:702-712 -> :484 strategy_score).  The fill between two steps
// is K2 + 2 x K3 (spread), K5 (binpack) or K3 (weighted, learned), chosen
// on the host per slot.  Two entry points:
//
//  * K1F, sk_fused_feasibility, the slot entry of group slot g: for node i
//    (one thread a node, feasibility.cuh's FusedSource)
//      1. when the chunk has a slot g - 1, its placements x = out[g - 1]
//         go into node i's carry: total += x; cpu -= x * cpu_d[g - 1];
//         mem -= x * mem_d[g - 1]; svc_acc[slot(g - 1)] += x;
//      2. res_ok, res_cap and svc = svc0[slot] + svc_acc[slot] follow in
//         registers, after step 1, so a slot that repeats the previous
//         slot's service sees its own update;
//      3. K1's filters run on them (feasibility.cuh); the capacity and the
//         slot's fail counts (into out[g]'s fail slot) are written;
//      4. the columns this slot's fill reads are written: svc always,
//         res_cap for a binpack slot (K5's / K11's key), and for a
//         weighted or learned slot (the scored instantiation) the level e
//         its water-fill reads: K6's score as the epilogue of the same
//         launch (feasibility.cuh score_node), on the headroom
//           hr = d > 0 ? clip(avail // d, 0, HR_CLAMP) : HR_CLAMP
//         held in registers, hr_gen = HR_CLAMP (a group with a generic
//         demand never fuses), the group's failures (one more load a
//         node) and the slot's weights or MLP, staged a copy a warp with
//         the group's scalars; res_ok and the headroom are never written.
//  * the carry update, sk_fused_carry, after the last slot of a chunk:
//      total += x; cpu -= x * cpu_d; mem -= x * mem_d; svc_acc[slot] += x,
//    one thread a node, so the carry is complete when the chunk ends.
//
// Only thread i touches node i of the carry, so K1F reads and writes it
// with no hazard inside the launch.  Ordering across launches: slot
// g - 1's fill (K3, K5, K10 or K11) reads carry.total before K1F of slot
// g adds x into it; that holds because every launch of a chunk runs in
// stream order on one card.  A fill enqueued on another stream would
// break it.
//
// The divisions are floor divisions in int64, as the reference's under
// x64: C++'s / truncates, so the quotient is corrected when the remainder
// is non-zero and the dividend negative (d > 0 here).  Every product
// x * d is taken in long long.  A service slot is indexed as the
// reference's jnp indexing does (feasibility.cuh gather_slot and
// scatter_slot): the builder keeps slots in [0, S), and a bad one reads a
// clamped row and adds into none, as the reference's gather and scatter.
// The group's scalars (demands, slots, k, maxrep, constraints, platform
// rows, the score's weights) are read from device memory, staged in
// shared memory once a warp, so the host never reads the carry and a
// chunk runs without a host synchronisation.
//
// Bound on the H100: bytes.  K1F reads valid, ready, plugins (3 B a node),
// cpu and mem (16), svc0[slot] and svc_acc[slot] (8), the previous x (4)
// and the hashes of active constraints; it writes cap and svc (8), and
// res_cap (4) or, scored, e (4) after reading failures (4) and, learned,
// total (4, already read where the chunk has a previous slot); for each
// node the previous slot placed on it reads and writes total (8), writes
// cpu and mem (16) and reads and writes svc_acc at the previous slot's
// service (8; 4 where that is the row it reads anyway).  The arithmetic is
// two int64 floor divisions a node, taken from a reciprocal staged once a
// warp and corrected exactly (feasibility.cuh floor_div_rcp; the int64
// division is a long software sequence), and the score (the MLP: 7 x
// hidden int32 multiply-adds).  Like K1 it is latency-bound at node bucket
// 16,384 (feasibility.cu): one launch where K4's prologue, K1, K6 and K4's
// carry update took four.

#include "feasibility.cuh"

namespace {

// K1F's launch shape, chosen by probes/feasibility_probe.cu (PERF.md): as
// K1's
constexpr int kEntryThreads = 128;
constexpr int kCarryThreads = 256;

struct K1FArgs {
  int n, S, cc, np, g;
  sk::NodeColumns cols;                   // slot g's slices
  const int32_t* con_op;                  // slot g's
  const int32_t* con_exp;
  const int32_t* plat;
  const int32_t* k;
  const int32_t* maxrep;
  const long long* cpu_d;                 // [G]: slots g and g - 1
  const long long* mem_d;
  const int32_t* slot;
  const int32_t* svc0;                    // [S, n]
  int32_t* svc_acc;                       // [S, n], carry
  int32_t* total;                         // carry
  long long* cpu;
  long long* mem;
  const int32_t* x_prev;                  // nullable: first slot
  int32_t* fail_out;
  int32_t* cap_out;
  int32_t* svc_out;
  int32_t* res_cap_out;                   // nullable
  sk::ScoreArgs score;                    // the scored instantiation's
};

// the slot scalars, one a lane of the staging warp (held by value: the
// kernel's parameters are not addressed)
struct SlotExtra {
  const long long* cpu_d;
  const long long* mem_d;
  const int32_t* slot;
  int g, S;
  bool prev;
  sk::SlotScalars* sc;
  __device__ long long load(int lane) const {
    switch (lane) {
      case 4: return cpu_d[g];
      case 5: return mem_d[g];
      case 6: return prev ? cpu_d[g - 1] : 0;
      case 7: return prev ? mem_d[g - 1] : 0;
      case 8: return slot[g];
      case 9: return prev ? slot[g - 1] : 0;
      default: return 0;
    }
  }
  __device__ void store(int lane, long long v) const {
    switch (lane) {
      case 4:
        sc->cd = v;
        sc->rcp_c = v > 0 ? 1.0 / (double)v : 0.0;
        break;
      case 5:
        sc->md = v;
        sc->rcp_m = v > 0 ? 1.0 / (double)v : 0.0;
        break;
      case 6: sc->cd_prev = v; break;
      case 7: sc->md_prev = v; break;
      case 8: sc->slot = sk::gather_slot((int)v, S); break;
      case 9: sc->slot_prev = prev ? sk::scatter_slot((int)v, S) : -1; break;
      default: break;
    }
  }
};

// kScored: the weighted / learned slot's instantiation, which writes e
// (K6's score) where the other writes res_cap or nothing
template <int T, bool kScored>
__global__ void __launch_bounds__(T) fused_feasibility_kernel(
    const K1FArgs a) {
  constexpr int kWarps = T / 32;
  extern __shared__ int sm[];
  __shared__ unsigned wsum[2 * kWarps];
  __shared__ sk::SlotScalars scs[kWarps];   // one a warp, as the group
  sk::SlotScalars* sc = &scs[threadIdx.x >> 5];
  const int n = a.n;
  const int i = blockIdx.x * T + threadIdx.x;
  const bool has_prev = a.x_prev != nullptr;
  const int tail = kScored ? sk::score_words(a.score.mode, a.score.hidden)
                           : 0;

  // loads that need no staged scalar, then the staging
  sk::NodeRegs regs;
  sk::load_early(a.cols, i, n, regs);
  sk::FusedSource src{a.cpu, a.mem, a.total, a.svc_acc, a.svc0, a.x_prev,
                      n, sc, kScored && a.score.mode == sk::kStratLearned};
  src.load_early(i, n);
  int32_t f = 0;
  sk::ScoreStage st;
  if (kScored) {
    f = sk::load_col(a.score.failures, i, n);
    sk::score_load(a.score, st);
  }
  const int* grp = sk::stage_group(
      sm, a.cc, a.np, a.con_op, a.con_exp, a.plat, a.k, a.maxrep, nullptr,
      SlotExtra{a.cpu_d, a.mem_d, a.slot, a.g, a.S, has_prev, sc}, tail);
  const int* ws = grp + sk::group_words(a.cc, a.np);
  if (kScored) {
    sk::score_store(a.score, st, const_cast<int*>(ws));
    __syncwarp();
  }

  unsigned fails;
  bool mask;
  int cap;
  sk::feasible_node(grp, a.cols, regs, src, i, n, fails, mask, cap);

  if (i < n) {
    a.cap_out[i] = cap;
    a.svc_out[i] = src.svc;
    if (a.res_cap_out != nullptr) a.res_cap_out[i] = src.cap;
    if (kScored)
      a.score.e[i] = sk::score_node(a.score, ws, src.svc, src.total, f,
                                    regs.ready != 0, src.hr_cpu(),
                                    src.hr_mem(), (int)sk::kHrClamp);
    // the previous slot's placements into the carry, where any landed on
    // this node (the others keep the values just read)
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
  // every lane of every warp reaches the fold (no early return above)
  sk::fold_fails<kWarps>(fails, wsum, a.fail_out);
}

template <int T, bool kScored>
int launch_fused_feasibility(const K1FArgs& a, cudaStream_t stream) {
  if (a.n <= 0 || a.S <= 0) return 0;
  if (a.g < 0 || (a.g == 0 && a.x_prev != nullptr))
    return (int)cudaErrorInvalidValue;
  size_t extra = 0;
  if (kScored) {
    const sk::ScoreArgs& s = a.score;
    if (s.e == nullptr || s.failures == nullptr || a.res_cap_out != nullptr ||
        (s.mode == sk::kStratWeighted && s.weights == nullptr) ||
        (s.mode == sk::kStratLearned &&
         (s.hidden <= 0 || s.hidden > sk::kMaxHidden || s.w1 == nullptr ||
          s.b1 == nullptr || s.w2 == nullptr || s.b2 == nullptr)))
      return (int)cudaErrorInvalidValue;
    extra = (size_t)sk::score_words(s.mode, s.hidden);
  }
  const size_t smem = sk::staged_bytes(T / 32, a.cc, a.np, extra);
  if (smem > sk::kMaxGroupSmem) return (int)cudaErrorInvalidValue;
  fused_feasibility_kernel<T, kScored>
      <<<(a.n + T - 1) / T, T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kCarryThreads) fused_carry_kernel(
    int n, int S, const int32_t* __restrict__ x,
    const long long* __restrict__ cpu_d_ptr,
    const long long* __restrict__ mem_d_ptr,
    const int32_t* __restrict__ slot_ptr, int32_t* __restrict__ total,
    long long* __restrict__ cpu, long long* __restrict__ mem,
    int32_t* __restrict__ svc_acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int xi = x[i];
  if (xi == 0) return;
  const int slot = sk::scatter_slot(*slot_ptr, S);
  total[i] += xi;
  cpu[i] -= (long long)xi * *cpu_d_ptr;
  mem[i] -= (long long)xi * *mem_d_ptr;
  if (slot >= 0) svc_acc[(size_t)slot * n + i] += xi;
}

}  // namespace

// score: a host ScoreArgs (feasibility.cuh), or null for a slot that is
// not scored; the scored launch writes e in place of res_cap
extern "C" int sk_fused_feasibility(
    int n, int S, int cc, int np, int g, const void* valid,
    const void* ready, const void* os_hash, const void* arch_hash,
    const void* svc0, const void* k, const void* slot, const void* maxrep,
    const void* cpu_d, const void* mem_d, const void* con_hash,
    const void* con_op, const void* con_exp, const void* plat,
    const void* extra_mask, const void* quota_ok, void* total, void* cpu,
    void* mem, void* svc_acc, const void* x_prev, void* fail_out,
    void* cap_out, void* svc_out, void* res_cap_out, const void* score,
    void* stream) {
  if (g < 0) return (int)cudaErrorInvalidValue;
  const size_t gn = (size_t)g * n;
  // group slot g's slices of the stacked [G, ...] inputs
  K1FArgs a{
      n, S, cc, np, g,
      sk::NodeColumns{
          (const uint8_t*)valid, (const uint8_t*)ready,
          (const uint8_t*)extra_mask + gn,
          (const int32_t*)con_hash + (size_t)g * cc * 2 * n,
          (const int32_t*)os_hash, (const int32_t*)arch_hash, nullptr,
          quota_ok == nullptr ? nullptr : (const uint8_t*)quota_ok + gn},
      (const int32_t*)con_op + (size_t)g * cc,
      (const int32_t*)con_exp + (size_t)g * cc * 2,
      (const int32_t*)plat + (size_t)g * np * 4, (const int32_t*)k + g,
      (const int32_t*)maxrep + g, (const long long*)cpu_d,
      (const long long*)mem_d, (const int32_t*)slot, (const int32_t*)svc0,
      (int32_t*)svc_acc, (int32_t*)total, (long long*)cpu, (long long*)mem,
      (const int32_t*)x_prev, (int32_t*)fail_out, (int32_t*)cap_out,
      (int32_t*)svc_out, (int32_t*)res_cap_out, sk::ScoreArgs{}};
  if (score == nullptr)
    return launch_fused_feasibility<kEntryThreads, false>(
        a, (cudaStream_t)stream);
  a.score = *(const sk::ScoreArgs*)score;
  return launch_fused_feasibility<kEntryThreads, true>(a,
                                                       (cudaStream_t)stream);
}

extern "C" int sk_fused_carry(int n, int S, const void* x, const void* cpu_d,
                              const void* mem_d, const void* slot,
                              void* total, void* cpu, void* mem,
                              void* svc_acc, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const int blocks = (n + kCarryThreads - 1) / kCarryThreads;
  fused_carry_kernel<<<blocks, kCarryThreads, 0, (cudaStream_t)stream>>>(
      n, S, (const int32_t*)x, (const long long*)cpu_d,
      (const long long*)mem_d, (const int32_t*)slot, (int32_t*)total,
      (long long*)cpu, (long long*)mem, (int32_t*)svc_acc);
  return (int)cudaGetLastError();
}
