// K4: the scan step of the fused many-service plan, around the per-group
// kernels.
//
// Replaces the body of swarmkit_tpu/ops/kernel.py:640 plan_fused (its
// jitted entry plan_fused_jit, :728) other than the plan itself: the
// reference's lax.scan carries the cluster state from one group slot to
// the next, and each step derives the group's resource columns from that
// carry (:669-678, :692-694) and adds the group's placements back into it
// (:715-719).  The plan between the two is K1 + K2 + K3 (spread), K1 + K5
// (binpack) or K1 + K6 + K3 (weighted, learned), chosen on the host per
// group slot.  Two entry points, one thread per node each:
//
//  * prologue for group slot g: from the carry's int64 cpu/mem and the
//    group's int64 demands,
//      res_ok  = valid & (d == 0 | avail >= d) for cpu and memory;
//      res_cap = clip(min over demanded resources of avail // d, 0,
//                     K_CLAMP);
//      svc     = svc0[slot] + svc_acc[slot];
//    and, for a weighted or learned group, the headroom columns
//      hr      = d > 0 ? clip(avail // d, 0, HR_CLAMP) : HR_CLAMP;
//  * carry update after the group's placements x:
//      total += x; cpu -= x * cpu_d; mem -= x * mem_d; svc_acc[slot] += x.
//
// The divisions are floor divisions in int64, as the reference's under
// x64: C++'s / truncates, so the quotient is corrected when the remainder
// is non-zero and the dividend negative (d > 0 here).  Every product
// x * d is taken in long long.  The group's scalars (demands, slot) are
// read from device memory, so the host never reads the carry and a chunk
// runs without a host synchronisation.
//
// Bound on the H100: bytes.  The prologue reads 17 bytes per node (valid,
// cpu, mem) plus 8 of service counts and writes 9 (13 more with the
// headroom columns); the carry update reads 4 bytes of x and updates
// 4 + 8 + 8 + 4 bytes where x is non-zero.  The arithmetic is a handful
// of integer operations per node.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kHrClamp = 1023;  // scheduler/strategy.py HR_CLAMP

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0
  long long q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long slot_offset(const int32_t* slot_ptr,
                                                int S, int n) {
  // the builder keeps slots in [0, S); the clamp only keeps a bad slot
  // inside the arrays
  return (long long)sk::clamp_int(*slot_ptr, 0, S - 1) * n;
}

__global__ void __launch_bounds__(kThreads) fused_prologue_kernel(
    int n, int S, const uint8_t* __restrict__ valid,
    const long long* __restrict__ cpu, const long long* __restrict__ mem,
    const long long* __restrict__ cpu_d_ptr,
    const long long* __restrict__ mem_d_ptr,
    const int32_t* __restrict__ slot_ptr,
    const int32_t* __restrict__ svc0,     // [S, n]
    const int32_t* __restrict__ svc_acc,  // [S, n]
    uint8_t* __restrict__ res_ok, int32_t* __restrict__ res_cap,
    int32_t* __restrict__ svc,
    int32_t* __restrict__ hr_cpu,         // nullable: no headroom
    int32_t* __restrict__ hr_mem) {       // nullable
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long cd = *cpu_d_ptr, md = *mem_d_ptr;
  const long long slot_off = slot_offset(slot_ptr, S, n);
  const long long c = cpu[i], m = mem[i];
  bool ok = valid[i] != 0;
  long long cap = sk::K_CLAMP;
  if (cd > 0) {
    ok = ok && c >= cd;
    cap = clamp_ll(floor_div(c, cd), LLONG_MIN, cap);
  }
  if (md > 0) {
    ok = ok && m >= md;
    cap = clamp_ll(floor_div(m, md), LLONG_MIN, cap);
  }
  res_ok[i] = ok ? 1 : 0;
  res_cap[i] = (int)clamp_ll(cap, 0, sk::K_CLAMP);
  svc[i] = svc0[slot_off + i] + svc_acc[slot_off + i];
  if (hr_cpu != nullptr) {
    hr_cpu[i] = cd > 0 ? (int)clamp_ll(floor_div(c, cd), 0, kHrClamp)
                       : (int)kHrClamp;
    hr_mem[i] = md > 0 ? (int)clamp_ll(floor_div(m, md), 0, kHrClamp)
                       : (int)kHrClamp;
  }
}

__global__ void __launch_bounds__(kThreads) fused_carry_kernel(
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
  const long long slot_off = slot_offset(slot_ptr, S, n);
  total[i] += xi;
  cpu[i] -= (long long)xi * *cpu_d_ptr;
  mem[i] -= (long long)xi * *mem_d_ptr;
  svc_acc[slot_off + i] += xi;
}

}  // namespace

extern "C" int sk_fused_prologue(
    int n, int S, const void* valid, const void* cpu, const void* mem,
    const void* cpu_d, const void* mem_d, const void* slot, const void* svc0,
    const void* svc_acc, void* res_ok, void* res_cap, void* svc,
    void* hr_cpu, void* hr_mem, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  if ((hr_cpu == nullptr) != (hr_mem == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_prologue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, S, (const uint8_t*)valid, (const long long*)cpu,
      (const long long*)mem, (const long long*)cpu_d,
      (const long long*)mem_d, (const int32_t*)slot, (const int32_t*)svc0,
      (const int32_t*)svc_acc, (uint8_t*)res_ok, (int32_t*)res_cap,
      (int32_t*)svc, (int32_t*)hr_cpu, (int32_t*)hr_mem);
  return (int)cudaGetLastError();
}

extern "C" int sk_fused_carry(int n, int S, const void* x, const void* cpu_d,
                              const void* mem_d, const void* slot,
                              void* total, void* cpu, void* mem,
                              void* svc_acc, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_carry_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, S, (const int32_t*)x, (const long long*)cpu_d,
      (const long long*)mem_d, (const int32_t*)slot, (int32_t*)total,
      (long long*)cpu, (long long*)mem, (int32_t*)svc_acc);
  return (int)cudaGetLastError();
}
