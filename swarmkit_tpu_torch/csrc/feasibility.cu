// K1: the fused filter pipeline, per-node capacity and short-circuit
// failure counts.
//
// Replaces swarmkit_tpu/ops/kernel.py:190 feasibility_and_capacity (and its
// jitted entry feasibility_jit, :763).  One thread per node evaluates the
// eight filter masks in pipeline order (ready, resources, plugins,
// constraints, platforms, host ports, max replicas, tenant quota), the
// node's capacity for this group, and which filter rejected it first; the
// per-node body lives in feasibility.cuh, which K8 (gangfit.cu) shares.
//
// Bound on the H100: bytes.  Each node is read once and written once (4
// bytes of capacity, 1 of mask); the arithmetic is a few integer compares.
// A column that the group does not need is never read: the hashes of an
// unused constraint slot (op 2), the node platform hashes when no used
// platform row names an os or arch (or once a row matched), the host-port
// column unless the group is port-limited, the service's task counts
// unless it has max-replicas.  So a group with two constraints and the
// wildcard platform moves 29 bytes per node.  The design keeps it a single
// pass: the Cc constraint and P platform loops run inside the thread, and
// the eight counters are reduced per warp with ballots, per block in
// shared memory, and across blocks with one integer atomicAdd per counter
// and block -- integer atomics give the same sum in any order.

#include "feasibility.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) feasibility_kernel(
    int n, int cc, int np, sk::FeasColumns cols,
    const int32_t* __restrict__ k_ptr, const int32_t* __restrict__ maxrep_ptr,
    const uint8_t* __restrict__ port_limited_ptr,
    uint8_t* __restrict__ mask_out,        // nullable
    int32_t* __restrict__ cap_out, int32_t* __restrict__ fail_out) {
  __shared__ int block_fail[8];
  if (threadIdx.x < 8) block_fail[threadIdx.x] = 0;
  __syncthreads();

  const int k = *k_ptr;
  const int maxrep = *maxrep_ptr;
  const bool port_limited = *port_limited_ptr != 0;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned fails = 0;  // bit j: filter j is the first to reject this node
  if (i < n) {
    bool m;
    int cap;
    fails = sk::feasible_node(cols, i, n, cc, np, k, maxrep, port_limited,
                              &m, &cap);
    cap_out[i] = cap;
    if (mask_out != nullptr) mask_out[i] = m ? 1 : 0;
  }

  // every lane of every warp reaches the ballots (no early return above)
  sk::ballot_fails(fails, block_fail);
  __syncthreads();
  if (threadIdx.x < 8 && block_fail[threadIdx.x] != 0)
    atomicAdd(&fail_out[threadIdx.x], block_fail[threadIdx.x]);
}

}  // namespace

extern "C" int sk_feasibility(
    int n, int cc, int np, const void* valid, const void* ready,
    const void* res_ok, const void* res_cap, const void* svc_tasks,
    const void* extra_mask, const void* con_hash, const void* con_op,
    const void* con_exp, const void* plat, const void* os_hash,
    const void* arch_hash, const void* port_conflict, const void* quota_ok,
    const void* k, const void* maxrep, const void* port_limited,
    void* mask_out, void* cap_out, void* fail_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const sk::FeasColumns cols{
      (const uint8_t*)valid, (const uint8_t*)ready, (const uint8_t*)res_ok,
      (const int32_t*)res_cap, (const int32_t*)svc_tasks,
      (const uint8_t*)extra_mask, (const int32_t*)con_hash,
      (const int32_t*)con_op, (const int32_t*)con_exp, (const int32_t*)plat,
      (const int32_t*)os_hash, (const int32_t*)arch_hash,
      (const uint8_t*)port_conflict, (const uint8_t*)quota_ok};
  feasibility_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, cc, np, cols, (const int32_t*)k, (const int32_t*)maxrep,
      (const uint8_t*)port_limited, (uint8_t*)mask_out, (int32_t*)cap_out,
      (int32_t*)fail_out);
  return (int)cudaGetLastError();
}

extern "C" const char* sk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
