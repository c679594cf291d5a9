// The per-node body of the fused filter pipeline, shared by K1
// (feasibility.cu) and K8 (gangfit.cu) so the two cannot drift.
//
// Reference: swarmkit_tpu/ops/kernel.py:190 feasibility_and_capacity.  For
// node i it evaluates the eight filter masks in pipeline order (ready,
// resources, plugins, constraints, platforms, host ports, max replicas,
// tenant quota), the node's capacity for the group, and which filter
// rejected it first.  A column that the group does not need is never read:
// the hashes of an unused constraint slot (op 2), the node platform hashes
// when no used platform row names an os or arch (or once a row matched),
// the host-port column unless the group is port-limited, the service's
// task counts unless it has max-replicas.
#pragma once

#include "common.cuh"

namespace sk {

struct FeasColumns {
  const uint8_t* __restrict__ valid;
  const uint8_t* __restrict__ ready;
  const uint8_t* __restrict__ res_ok;
  const int32_t* __restrict__ res_cap;
  const int32_t* __restrict__ svc_tasks;
  const uint8_t* __restrict__ extra_mask;
  const int32_t* __restrict__ con_hash;   // [cc, 2, n]
  const int32_t* __restrict__ con_op;     // [cc]
  const int32_t* __restrict__ con_exp;    // [cc, 2]
  const int32_t* __restrict__ plat;       // [np, 4]
  const int32_t* __restrict__ os_hash;    // [2, n]
  const int32_t* __restrict__ arch_hash;  // [2, n]
  const uint8_t* __restrict__ port_conflict;
  const uint8_t* __restrict__ quota_ok;   // nullable: all true
};

// Node i (< n) of one group: returns the first-fail bit set (bit j: filter
// j is the first to reject the node; 0 for a node that passes or is
// padding) and writes the mask and the capacity (0 unless the mask holds).
__device__ __forceinline__ unsigned feasible_node(
    const FeasColumns& c, int i, int n, int cc, int np, int k, int maxrep,
    bool port_limited, bool* mask, int* cap_out) {
  bool con_ok = true;
  for (int s = 0; s < cc; ++s) {
    const int op = c.con_op[s];
    if (op != 0 && op != 1) continue;  // unused slot: always passes
    const bool eq = c.con_hash[(2 * s) * n + i] == c.con_exp[2 * s] &&
                    c.con_hash[(2 * s + 1) * n + i] == c.con_exp[2 * s + 1];
    con_ok = con_ok && (op == 0 ? eq : !eq);
  }
  bool matched = false, any_used = false;
  for (int p = 0; p < np && !matched; ++p) {
    const int r0 = c.plat[4 * p], r1 = c.plat[4 * p + 1];
    const int r2 = c.plat[4 * p + 2], r3 = c.plat[4 * p + 3];
    if (r0 == -1) continue;  // unused row
    any_used = true;
    const bool os_ok = (r0 == 0 && r1 == 0) ||
                       (c.os_hash[i] == r0 && c.os_hash[n + i] == r1);
    matched = os_ok && ((r2 == 0 && r3 == 0) ||
                        (c.arch_hash[i] == r2 && c.arch_hash[n + i] == r3));
  }
  const int svc = maxrep > 0 ? c.svc_tasks[i] : 0;
  const bool f[8] = {
      c.ready[i] != 0,
      c.res_ok[i] != 0,
      c.extra_mask[i] != 0,
      con_ok,
      matched || !any_used,
      !(port_limited && c.port_conflict[i] != 0),
      maxrep == 0 || svc < maxrep,
      c.quota_ok == nullptr || c.quota_ok[i] != 0,
  };
  unsigned fails = 0;
  bool m = c.valid[i] != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (m && !f[j]) fails |= 1u << j;
    m = m && f[j];
  }
  int cap = min(c.res_cap[i], min(k, K_CLAMP));
  if (maxrep > 0) cap = min(cap, max(maxrep - svc, 0));
  if (port_limited) cap = min(cap, 1);
  *cap_out = m ? max(cap, 0) : 0;
  *mask = m;
  return fails;
}

// Adds each warp's first-fail bits into block_fail[8] (shared, zeroed) with
// ballots.  Every lane of every warp must reach it.
__device__ __forceinline__ void ballot_fails(unsigned fails, int* block_fail) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned ballot = __ballot_sync(0xffffffffu, (fails >> j) & 1u);
    if ((threadIdx.x & 31) == 0 && ballot != 0)
      atomicAdd(&block_fail[j], __popc(ballot));
  }
}

}  // namespace sk
