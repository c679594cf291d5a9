// The per-node body of the fused filter pipeline, shared by K1
// (feasibility.cu), K1F (fused.cu) and K8 (gangfit.cu) so the three cannot
// drift.  It is a template over a column source, the way waterfill.cuh
// serves K3/K10 and packfill.cuh serves K5/K11:
//
//  * PlainSource (K1, K8) reads res_ok, res_cap and the service's task
//    counts from columns;
//  * FusedSource (fused.cu, K1F) derives them in registers from the fused
//    plan's carried cluster state, with K4's exact int64 arithmetic.
//
// A scored instantiation of K1 or K1F ends with K6's score as an epilogue
// (score_node, below): the node's effective level e under the weighted,
// learned or spread strategy (score.cu's formulas, bit for bit), from the
// svc, total, ready and headroom the body already holds and one more load,
// the group's failures.  The slot's weights and, in learned mode, the MLP
// are staged with the group's scalars, a copy a warp.
//
// Reference: swarmkit_tpu/ops/kernel.py:190 feasibility_and_capacity.  For
// node i it evaluates the eight filter masks in pipeline order (ready,
// resources, plugins, constraints, platforms, host ports, max replicas,
// tenant quota), the node's capacity for the group, and which filter
// rejected it first.  A column that the group does not need is never read:
// the hashes of an unused constraint slot (op 2), the node platform hashes
// when no used platform row names an os or arch (or a used row is the full
// wildcard), the host-port column unless the group is port-limited, the
// service's task counts unless it has max-replicas (K1F always derives
// them: its fill reads them).
//
// The shape of a launch, one node a thread, designed for few memory round
// trips:
//  1. each thread issues the loads of every node column that does not
//     depend on the group's scalars (valid, ready, plugins, quota and the
//     source's first columns);
//  2. every warp stages its own copy of the group's scalars in shared
//     memory, one load a lane, issued together (stage_warp): k, maxrep,
//     port_limited, the active constraint slots compacted by a ballot, the
//     used platform rows compacted and the flags that say which node
//     hashes are needed.  No block barrier: the warps load the same
//     addresses, which hit the caches after the first warp's;
//  3. each thread issues the loads that depend on them (constraint hashes,
//     platform hashes, host ports, the source's service columns), then
//     computes with no further memory traffic;
//  4. the first-fail counts are packed four to a 32-bit word (8 bits
//     each), folded per warp with __reduce_add_sync, summed over the
//     block's warps in shared memory and added with ONE global integer
//     atomic per counter and block (any order gives the same sum); K8
//     keeps them in int counters a warp (warp_fails), sums them over the
//     block in shared memory and adds them into its workspace words.
// probes/feasibility_probe.cu times the block sizes; PERF.md keeps what it
// measured of the shapes not taken (two or four nodes a thread with vector
// loads, one staged copy a block behind a barrier, K1F's int64 division).
#pragma once

#include "common.cuh"

namespace sk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int N_FILTERS = 8;           // first-fail counters, pipeline order
constexpr long long kHrClamp = 1023;   // scheduler/strategy.py HR_CLAMP
// constraint slots whose hash loads are issued together
constexpr int kConChunk = 4;

// p[i], or 0 for a padding thread (i >= n)
template <class T>
__device__ __forceinline__ T load_col(const T* p, int i, int n) {
  return i < n ? p[i] : (T)0;
}

// ------------------------------------------------- the group's scalars

// shared-memory layout of a staged group (int words): a header, then the
// active constraint slots (slot, op, exp hi, exp lo) compacted, then the
// used platform rows (os hi, os lo, arch hi, arch lo) compacted
enum GroupWord {
  GW_K,          // min(k, K_CLAMP)
  GW_MAXREP,
  GW_PORT,       // port-limited
  GW_NCON,       // active constraint slots
  GW_PLAT_ALL,   // every node passes the platform filter
  GW_NEED_OS,    // some used row names an os: read os_hash
  GW_NEED_ARCH,  // some used row names an arch: read arch_hash
  GW_NROWS,      // used platform rows
  GW_ROWS,       // word offset of the platform rows
  GW_WORDS
};

// the most dynamic shared memory an entry accepts for its staged groups
// (under the 48 KB a block gets without opting in, beside the kernels'
// few static words)
constexpr size_t kMaxGroupSmem = 46 * 1024;

// words of one staged copy, and the dynamic shared memory of a launch of
// ``warps`` warps
__host__ __device__ constexpr size_t group_words(int cc, int np) {
  return (size_t)GW_WORDS + 4u * (size_t)cc + 4u * (size_t)np;
}
// ``extra``: words a kernel stages after each warp's group (the score's)
__host__ __device__ constexpr size_t staged_bytes(int warps, int cc, int np,
                                                  size_t extra = 0) {
  return 4u * (group_words(cc, np) + extra) * (size_t)warps;
}

// One warp stages a group's scalars into ``sm``: every lane's loads (a
// constraint slot, a platform row, a scalar, and ``extra``'s) issued
// before any of them is used, so the staging costs one round trip; then
// the active constraint slots and the used platform rows are compacted by
// ballots (slots and rows past the first 32 in further rounds).
// ``extra.load(lane)`` / ``extra.store(lane, value)`` stage a kernel's own
// scalars.  port_limited may be null (false).
template <class Extra>
__device__ __forceinline__ void stage_warp(
    int* sm, int cc, int np, const int32_t* __restrict__ con_op,
    const int32_t* __restrict__ con_exp, const int32_t* __restrict__ plat,
    const int32_t* __restrict__ k, const int32_t* __restrict__ maxrep,
    const uint8_t* __restrict__ port_limited, const Extra& extra) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* con = sm + GW_WORDS;
  int* rows = con + 4 * cc;

  // ---- loads
  int op = 2, e0 = 0, e1 = 0;
  if (lane < cc) {
    op = con_op[lane];
    e0 = con_exp[2 * lane];
    e1 = con_exp[2 * lane + 1];
  }
  int r0 = -1, r1 = 0, r2 = 0, r3 = 0;
  if (lane < np) {
    r0 = plat[4 * lane];
    r1 = plat[4 * lane + 1];
    r2 = plat[4 * lane + 2];
    r3 = plat[4 * lane + 3];
  }
  int scalar = 0;
  if (lane == 1) scalar = *k;
  else if (lane == 2) scalar = *maxrep;
  else if (lane == 3 && port_limited != nullptr) scalar = *port_limited;
  const long long ex = extra.load(lane);

  // ---- stores
  extra.store(lane, ex);
  if (lane == 1) sm[GW_K] = min(scalar, K_CLAMP);
  else if (lane == 2) sm[GW_MAXREP] = scalar;
  else if (lane == 3) sm[GW_PORT] = scalar != 0;

  int count = 0;
  for (int base = 0; base < cc; base += 32) {
    if (base > 0) {
      const int s = base + lane;
      op = 2;
      if (s < cc) {
        op = con_op[s];
        e0 = con_exp[2 * s];
        e1 = con_exp[2 * s + 1];
      }
    }
    const bool act = op == 0 || op == 1;  // op 2: unused, always passes
    const unsigned b = __ballot_sync(kFull, act);
    if (act) {
      int* e = con + 4 * (count + __popc(b & below));
      e[0] = base + lane;
      e[1] = op;
      e[2] = e0;
      e[3] = e1;
    }
    count += __popc(b);
  }
  if (lane == 0) sm[GW_NCON] = count;

  count = 0;
  bool any_used = false, wild = false, need_os = false, need_arch = false;
  for (int base = 0; base < np; base += 32) {
    if (base > 0) {
      const int p = base + lane;
      r0 = -1;
      if (p < np) {
        r0 = plat[4 * p];
        r1 = plat[4 * p + 1];
        r2 = plat[4 * p + 2];
        r3 = plat[4 * p + 3];
      }
    }
    const bool used = r0 != -1;  // -1 in column 0: unused row
    const bool os = used && (r0 != 0 || r1 != 0);
    const bool arch = used && (r2 != 0 || r3 != 0);
    const unsigned bu = __ballot_sync(kFull, used);
    if (used) {
      int* r = rows + 4 * (count + __popc(bu & below));
      r[0] = r0;
      r[1] = r1;
      r[2] = r2;
      r[3] = r3;
    }
    count += __popc(bu);
    any_used |= bu != 0;
    wild |= __ballot_sync(kFull, used && !os && !arch) != 0;
    need_os |= __ballot_sync(kFull, os) != 0;
    need_arch |= __ballot_sync(kFull, arch) != 0;
  }
  if (lane == 0) {
    // no used row, or a used row that is the full wildcard: every node
    // matches and no node hash is read
    sm[GW_PLAT_ALL] = !any_used || wild;
    sm[GW_NEED_OS] = need_os;
    sm[GW_NEED_ARCH] = need_arch;
    sm[GW_NROWS] = count;
    sm[GW_ROWS] = GW_WORDS + 4 * cc;
  }
}

struct NoExtra {
  __device__ long long load(int) const { return 0; }
  __device__ void store(int, long long) const {}
};

// Every warp stages its own copy of the group into ``sm`` (one copy of
// group_words(cc, np) + ``tail`` words a warp: the kernel's own staged
// words follow its group) and returns the copy this thread reads.  Every
// thread must call it.
template <class Extra = NoExtra>
__device__ __forceinline__ const int* stage_group(
    int* sm, int cc, int np, const int32_t* con_op, const int32_t* con_exp,
    const int32_t* plat, const int32_t* k, const int32_t* maxrep,
    const uint8_t* port_limited, const Extra& extra = Extra(),
    int tail = 0) {
  int* mine = sm + (threadIdx.x >> 5) * (group_words(cc, np) + tail);
  stage_warp(mine, cc, np, con_op, con_exp, plat, k, maxrep, port_limited,
             extra);
  __syncwarp();
  return mine;
}

// ------------------------------------------------------- column sources

// the node columns every group's filters read through the template (a
// group's own slice; quota_ok and port_conflict may be null)
struct NodeColumns {
  const uint8_t* __restrict__ valid;
  const uint8_t* __restrict__ ready;
  const uint8_t* __restrict__ extra_mask;
  const int32_t* __restrict__ con_hash;   // [cc, 2, n]
  const int32_t* __restrict__ os_hash;    // [2, n]
  const int32_t* __restrict__ arch_hash;  // [2, n]
  const uint8_t* __restrict__ port_conflict;
  const uint8_t* __restrict__ quota_ok;   // null: every node passes
};

// K1 and K8: res_ok, res_cap and the service's task counts from columns
struct PlainSource {
  const uint8_t* __restrict__ res_ok_col;
  const int32_t* __restrict__ res_cap_col;
  const int32_t* __restrict__ svc_col;
  bool svc_always;   // a scored K1 reads the task counts for its score
  uint8_t ok;
  int32_t cap, svc;

  __device__ __forceinline__ void load_early(int i, int n) {
    ok = load_col(res_ok_col, i, n);
    cap = load_col(res_cap_col, i, n);
    if (svc_always) svc = load_col(svc_col, i, n);
  }
  // after the group's scalars are staged: else the task counts only for a
  // group with max-replicas
  __device__ __forceinline__ void load_late(const int* sm, int i, int n) {
    if (!svc_always) svc = sm[GW_MAXREP] > 0 ? load_col(svc_col, i, n) : 0;
  }
  __device__ __forceinline__ void derive() {}
  __device__ __forceinline__ bool res_ok() const { return ok != 0; }
  __device__ __forceinline__ int res_cap() const { return cap; }
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0; C++'s / truncates toward zero
  long long q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A service slot as the reference's jnp indexing takes it: a negative slot
// counts from the end (slot + S); a read then clamps into [0, S)
// (gather_slot), a scatter drops a slot outside [0, S) (scatter_slot: -1).
// The builder keeps slots in range; this keeps a bad one bit-equal.
__host__ __device__ __forceinline__ int gather_slot(int slot, int S) {
  if (slot < 0) slot += S;
  return slot < 0 ? 0 : (slot >= S ? S - 1 : slot);
}
__host__ __device__ __forceinline__ int scatter_slot(int slot, int S) {
  if (slot < 0) slot += S;
  return slot >= 0 && slot < S ? slot : -1;
}

// floor(a / b) for b > 0 from rcp = 1.0 / b rounded to a double: for
// |a| <= 2^50 the estimate a * rcp is within a quarter of a / b (two
// roundings of 2^-53 each), so its floor is at most one off and one exact
// int64 remainder test corrects it; beyond, the int64 division.  A few
// instructions where the int64 division is a long software sequence.
__device__ __forceinline__ long long floor_div_rcp(long long a, long long b,
                                                   double rcp) {
  if (a >= -(1LL << 50) && a <= (1LL << 50)) {
    long long q = (long long)floor((double)a * rcp);
    const long long r = a - q * b;
    if (r < 0) q -= 1;
    else if (r >= b) q += 1;
    return q;
  }
  return floor_div(a, b);
}

// the fused plan's slot scalars, staged in shared memory by the kernel
struct SlotScalars {
  long long cd, md;            // this slot's int64 demands
  long long cd_prev, md_prev;  // the previous slot's (0 without one)
  double rcp_c, rcp_m;         // 1 / cd and 1 / md (0 where not > 0)
  int slot;                    // the service slot read (gather_slot)
  int slot_prev;               // the previous slot's scatter_slot, or -1
};

// K1F: the resource columns and the task counts derived from the carry
// (cpu, mem, svc_acc) after the previous slot's placements x_prev (null for
// the first slot of a chunk) are applied, in registers:
//   cpu -= x * cd_prev; mem -= x * md_prev; svc_acc[slot_prev] += x
//   (no svc_acc add where slot_prev is out of range, as the reference's
//   scatter drops it);
//   res_ok  = (cd == 0 | cpu >= cd) & (md == 0 | mem >= md);
//   res_cap = clip(min over demanded resources of avail // d, 0, K_CLAMP);
//   svc     = svc0[slot] + svc_acc[slot].
// Products in int64, floor divisions of negative dividends corrected.  The
// carry columns are read and written by the same thread, so they are not
// read through the read-only path.
struct FusedSource {
  long long* cpu_col;
  long long* mem_col;
  int32_t* total_col;
  int32_t* acc_col;             // svc_acc [S, n]
  const int32_t* svc0_col;      // svc0 [S, n]
  const int32_t* x_prev;        // previous slot's placement, or null
  int n_rows;                   // n: the stride of svc0 / svc_acc
  const SlotScalars* sc;        // in shared memory
  bool total_always;            // a learned score reads total (a feature)

  long long c, m, qc, qm;
  int32_t x, total, acc, acc_prev, s0, svc;
  bool ok;
  int cap;

  __device__ __forceinline__ bool has_prev() const {
    return x_prev != nullptr;
  }
  // the previous slot's scatter lands on the row this slot reads
  __device__ __forceinline__ bool same_slot() const {
    return sc->slot == sc->slot_prev;
  }
  __device__ __forceinline__ bool other_slot() const {
    return sc->slot_prev >= 0 && sc->slot_prev != sc->slot;
  }
  __device__ __forceinline__ void load_early(int i, int n) {
    c = load_col((const long long*)cpu_col, i, n);
    m = load_col((const long long*)mem_col, i, n);
    x = has_prev() ? load_col(x_prev, i, n) : 0;
    total = has_prev() || total_always
                ? load_col((const int32_t*)total_col, i, n) : 0;
  }
  __device__ __forceinline__ void load_late(const int*, int i, int n) {
    const size_t off = (size_t)sc->slot * n_rows;
    s0 = load_col(svc0_col + off, i, n);
    acc = load_col((const int32_t*)acc_col + off, i, n);
    if (has_prev() && other_slot())
      acc_prev = load_col(
          (const int32_t*)acc_col + (size_t)sc->slot_prev * n_rows, i, n);
  }
  __device__ __forceinline__ void derive() {
    const long long cd = sc->cd, md = sc->md;
    c -= (long long)x * sc->cd_prev;
    m -= (long long)x * sc->md_prev;
    if (has_prev()) {
      total += x;
      if (same_slot()) acc += x;
      else if (other_slot()) acc_prev += x;
    }
    svc = s0 + acc;
    bool good = true;
    long long cp = K_CLAMP;
    if (cd > 0) {
      good = good && c >= cd;
      qc = floor_div_rcp(c, cd, sc->rcp_c);
      cp = qc < cp ? qc : cp;
    }
    if (md > 0) {
      good = good && m >= md;
      qm = floor_div_rcp(m, md, sc->rcp_m);
      cp = qm < cp ? qm : cp;
    }
    ok = good;
    cap = (int)clamp_ll(cp, 0, K_CLAMP);
  }
  __device__ __forceinline__ bool res_ok() const { return ok; }
  __device__ __forceinline__ int res_cap() const { return cap; }
  // headroom in demand units (reference _fused_headroom), for the score
  __device__ __forceinline__ int hr_cpu() const {
    return sc->cd > 0 ? (int)clamp_ll(qc, 0, kHrClamp) : (int)kHrClamp;
  }
  __device__ __forceinline__ int hr_mem() const {
    return sc->md > 0 ? (int)clamp_ll(qm, 0, kHrClamp) : (int)kHrClamp;
  }
};

// ------------------------------------------------- the score epilogue (K6)
//
// Reference: swarmkit_tpu/ops/kernel.py:484 strategy_score and :464
// _learned_score, which the fused plan's scan step runs after the filters
// (:702-712); score.cu is its standalone port and argues the arithmetic:
// int32, arithmetic >> on a negative pre-activation, no float, so the
// result is bit-exact.  Products that can leave int32 in weighted mode
// wrap, as the reference's int32 arithmetic wraps (taken unsigned here,
// where the wrap is defined).

constexpr int kStratWeighted = 2;   // scheduler/strategy.py STRAT_WEIGHTED
constexpr int kStratLearned = 3;    // STRAT_LEARNED
constexpr int kFeatures = 6;        // MLP_FEATURES
constexpr int kMaxHidden = 64;      // the learned scorer's hidden units
constexpr int kFeatClamp = 1023;    // FEAT_CLAMP
constexpr int kMlpShift = 7;        // MLP_SHIFT
constexpr int kScoreClamp = (1 << 24) - 1;  // SCORE_CLAMP

// What a scored launch reads and writes beside the filters; the host
// passes it as a table (ops/kernel.py _ScoreTable has this layout).
struct ScoreArgs {
  int mode;           // kStratWeighted, kStratLearned, else spread
  int hidden;         // learned: hidden units, 1..kMaxHidden
  int max_failures;   // the down-weight's threshold (MAX_FAILURES)
  const int32_t* weights;   // [4] weighted terms (weighted; else unread)
  const int32_t* w1;        // [kFeatures, hidden] (learned)
  const int32_t* b1;        // [hidden]
  const int32_t* w2;        // [hidden]
  const int32_t* b2;        // []
  const int32_t* failures;  // [n] the group's recent failures
  const int32_t* hr_cpu;    // [n] K1's headroom columns; null in K1F,
  const int32_t* hr_mem;    // which derives them from the carry
  const int32_t* hr_gen;    // null: HR_CLAMP (K1F: no generic demand)
  int32_t* e;               // [n] the level, written
};

// words a warp stages for the score: the four weights, then in learned
// mode w1, b1, w2 and b2
__host__ __device__ constexpr int score_words(int mode, int hidden) {
  return 4 + (mode == kStratLearned ? (kFeatures + 2) * hidden + 1 : 0);
}
// the most a lane loads while its warp stages them
constexpr int kScoreRegs = (score_words(kStratLearned, kMaxHidden) + 31) / 32;

// a lane's share of its warp's staged score words, in registers
struct ScoreStage {
  int v[kScoreRegs];
};

__device__ __forceinline__ int score_word(const ScoreArgs& s, int j) {
  const int h = s.hidden;
  if (j < 4) return s.weights != nullptr ? s.weights[j] : 0;
  j -= 4;
  if (j < kFeatures * h) return s.w1[j];
  j -= kFeatures * h;
  if (j < h) return s.b1[j];
  j -= h;
  if (j < h) return s.w2[j];
  return *s.b2;
}

// every lane issues its loads of the score words (before the group's
// staging, so both are in flight together) ...
__device__ __forceinline__ void score_load(const ScoreArgs& s,
                                           ScoreStage& st) {
  const int lane = threadIdx.x & 31;
  const int nw = score_words(s.mode, s.hidden);
#pragma unroll
  for (int r = 0; r < kScoreRegs; ++r) {
    if (32 * r >= nw) break;           // uniform across the warp
    const int j = lane + 32 * r;
    st.v[r] = j < nw ? score_word(s, j) : 0;
  }
}

// ... and stores them into the warp's copy ``ws`` (the caller syncs the
// warp before any lane reads them)
__device__ __forceinline__ void score_store(const ScoreArgs& s,
                                            const ScoreStage& st, int* ws) {
  const int lane = threadIdx.x & 31;
  const int nw = score_words(s.mode, s.hidden);
#pragma unroll
  for (int r = 0; r < kScoreRegs; ++r) {
    if (32 * r >= nw) break;
    const int j = lane + 32 * r;
    if (j < nw) ws[j] = st.v[r];
  }
}

// K6's score of one node from its staged words ``ws``: weighted
// w0 * clip(svc) + w1 (HR - hr_cpu) + w2 (HR - hr_mem) + w3 (HR - hr_gen);
// learned, the fixed-point MLP over [svc, total, failures, hr_cpu,
// hr_mem, ready]; else the spread score clip(svc); each plus the
// failure down-weight.
__device__ __forceinline__ int score_node(const ScoreArgs& s, const int* ws,
                                          int svc, int total, int f,
                                          bool ready, int hc, int hm,
                                          int hg) {
  const int down = f >= s.max_failures ? clamp_int(f, 0, FAILURE_CLAMP)
                                       : 0;
  unsigned score;
  if (s.mode == kStratWeighted) {
    const unsigned hr = (unsigned)kHrClamp;
    score = (unsigned)ws[0] * (unsigned)clamp_int(svc, 0, SVC_CLAMP) +
            (unsigned)ws[1] * (hr - (unsigned)hc) +
            (unsigned)ws[2] * (hr - (unsigned)hm) +
            (unsigned)ws[3] * (hr - (unsigned)hg);
  } else if (s.mode == kStratLearned) {
    const int h_n = s.hidden;
    const int* w1 = ws + 4;
    const int* b1 = w1 + kFeatures * h_n;
    const int* w2 = b1 + h_n;
    const int feat[kFeatures] = {
        clamp_int(svc, 0, kFeatClamp),   clamp_int(total, 0, kFeatClamp),
        clamp_int(f, 0, kFeatClamp),     clamp_int(hc, 0, kFeatClamp),
        clamp_int(hm, 0, kFeatClamp),    ready ? kFeatClamp : 0,
    };
    int out = 0;
    for (int h = 0; h < h_n; ++h) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kFeatures; ++j) acc += feat[j] * w1[j * h_n + h];
      acc = clamp_int((acc + b1[h]) >> kMlpShift, 0, kFeatClamp);
      out += acc * w2[h];
    }
    score = (unsigned)clamp_int((out + w2[h_n]) >> kMlpShift, 0,
                                kScoreClamp);
  } else {
    score = (unsigned)clamp_int(svc, 0, SVC_CLAMP);
  }
  return (int)(score + (unsigned)down * (unsigned)F_BIG);
}

// ------------------------------------------------------------- the body

// the node columns a thread loads before the group is staged
struct NodeRegs {
  uint8_t valid, ready, extra, quota;
};

__device__ __forceinline__ void load_early(const NodeColumns& c, int i,
                                           int n, NodeRegs& r) {
  r.valid = load_col(c.valid, i, n);
  r.ready = load_col(c.ready, i, n);
  r.extra = load_col(c.extra_mask, i, n);
  r.quota = c.quota_ok != nullptr ? load_col(c.quota_ok, i, n) : 1;
}

// Node i (i >= n is padding) of the group staged in ``sm``, after
// load_early(c, ...) and src.load_early(...): issues the remaining loads,
// derives the source's columns, and returns the first-fail bit set (bit j:
// filter j is the first to reject the node; 0 for a node that passes or
// is padding), the mask and the capacity (0 unless the mask holds).
template <class Src>
__device__ __forceinline__ void feasible_node(
    const int* sm, const NodeColumns& c, const NodeRegs& r, Src& src, int i,
    int n, unsigned& fails, bool& mask, int& cap) {
  const int kc = sm[GW_K], maxrep = sm[GW_MAXREP];
  const bool port_limited = sm[GW_PORT] != 0;
  const bool plat_all = sm[GW_PLAT_ALL] != 0;
  const int n_con = sm[GW_NCON], n_rows = sm[GW_NROWS];
  const int* con = sm + GW_WORDS;

  // ---- every remaining load, before any compute
  const uint8_t port = port_limited ? load_col(c.port_conflict, i, n) : 0;
  const bool need_os = !plat_all && sm[GW_NEED_OS];
  const bool need_arch = !plat_all && sm[GW_NEED_ARCH];
  const int32_t os0 = need_os ? load_col(c.os_hash, i, n) : 0;
  const int32_t os1 = need_os ? load_col(c.os_hash + n, i, n) : 0;
  const int32_t ar0 = need_arch ? load_col(c.arch_hash, i, n) : 0;
  const int32_t ar1 = need_arch ? load_col(c.arch_hash + n, i, n) : 0;
  src.load_late(sm, i, n);

  // ---- constraints: kConChunk active slots' hashes loaded together
  bool con_ok = true;
  for (int e0 = 0; e0 < n_con; e0 += kConChunk) {
    int32_t h0[kConChunk], h1[kConChunk];
#pragma unroll
    for (int j = 0; j < kConChunk; ++j) {
      if (e0 + j < n_con) {
        const size_t s = (size_t)con[4 * (e0 + j)];
        h0[j] = load_col(c.con_hash + (2 * s) * n, i, n);
        h1[j] = load_col(c.con_hash + (2 * s + 1) * n, i, n);
      }
    }
#pragma unroll
    for (int j = 0; j < kConChunk; ++j) {
      if (e0 + j < n_con) {
        const int* e = con + 4 * (e0 + j);
        const bool eq = h0[j] == e[2] && h1[j] == e[3];
        con_ok = con_ok && (e[1] == 0 ? eq : !eq);
      }
    }
  }

  src.derive();

  // ---- the eight filters in pipeline order, and the capacity
  const int* rows = sm + sm[GW_ROWS];
  bool matched = plat_all;
  for (int p = 0; p < n_rows && !matched; ++p) {
    const int* w = rows + 4 * p;
    const bool os_ok = (w[0] == 0 && w[1] == 0) || (os0 == w[0] && os1 == w[1]);
    matched = os_ok && ((w[2] == 0 && w[3] == 0) ||
                        (ar0 == w[2] && ar1 == w[3]));
  }
  const int svc = maxrep > 0 ? src.svc : 0;
  const bool f[8] = {
      r.ready != 0,
      src.res_ok(),
      r.extra != 0,
      con_ok,
      matched,
      !(port_limited && port != 0),
      maxrep == 0 || svc < maxrep,
      r.quota != 0,
  };
  unsigned fl = 0;
  bool m = r.valid != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (m && !f[j]) fl |= 1u << j;
    m = m && f[j];
  }
  int cp = min(src.res_cap(), kc);
  if (maxrep > 0) cp = min(cp, max(maxrep - svc, 0));
  if (port_limited) cp = min(cp, 1);
  cap = m ? max(cp, 0) : 0;
  mask = m;
  fails = fl;
}

// ------------------------------------------------------ the fail counts

// a node's first fail as two packed words: filter j adds one to the 8-bit
// field j & 3 of lo (filters 0-3) or hi (4-7); a node that passes adds 0
__device__ __forceinline__ void pack_first_fail(unsigned fails, unsigned& lo,
                                                unsigned& hi) {
  lo = hi = 0;
  if (fails != 0) {
    const int j = __ffs(fails) - 1;
    const unsigned one = 1u << (8 * (j & 3));
    if (j < 4) lo = one;
    else hi = one;
  }
}

// Adds the first-fail counts of a warp's nodes (one a lane) into every
// lane's ``acc``: the packed words folded by __reduce_add_sync (at most 32
// a counter, so no field carries into the next), then unpacked into int
// counters, which hold any number of such folds.  Every lane of the warp
// must call it.
__device__ __forceinline__ void warp_fails(unsigned fails,
                                           int (&acc)[N_FILTERS]) {
  unsigned lo, hi;
  pack_first_fail(fails, lo, hi);
  lo = __reduce_add_sync(kFull, lo);
  hi = __reduce_add_sync(kFull, hi);
#pragma unroll
  for (int j = 0; j < N_FILTERS; ++j)
    acc[j] += (int)(((j < 4 ? lo : hi) >> (8 * (j & 3))) & 0xffu);
}

// Adds the block's first-fail counts into fail_out[8]: each thread's first
// fail packed into two words, 8 bits a counter (filters 0-3 in lo, 4-7 in
// hi; a warp sums at most 32 a counter, so the fold cannot carry between
// counters), a warp fold of the packed words (__reduce_add_sync), the
// warps' words in ``wsum`` (shared, 2 x kWarps), then one global integer
// atomic per non-zero counter.  Every thread of the block must call it (it
// synchronises the block).
template <int kWarps>
__device__ __forceinline__ void fold_fails(unsigned fails, unsigned* wsum,
                                           int32_t* fail_out) {
  unsigned lo, hi;
  pack_first_fail(fails, lo, hi);
  lo = __reduce_add_sync(kFull, lo);
  hi = __reduce_add_sync(kFull, hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wsum[2 * warp] = lo;
    wsum[2 * warp + 1] = hi;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int j = threadIdx.x;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += (wsum[2 * w + (j >> 2)] >> (8 * (j & 3))) & 0xff;
    if (sum != 0) atomicAdd(&fail_out[j], sum);
  }
}

}  // namespace sk
