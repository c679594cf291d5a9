// K7: the dirty-row scatter into the streaming scheduler's resident node
// columns.
//
// Replaces swarmkit_tpu/ops/streaming.py:97 _scatter_rows_jit, a donated
// `.at[idx].set(..., mode="drop")` over the five resident columns (valid,
// ready, cpu, mem, total).  Here the columns are updated in place, which
// is this port's form of the reference's donation: the tensors keep their
// identity and no cluster-sized copy is made per delta.
//
// The host packs the update slots into ONE buffer (see ops/kernel.py
// scatter_layout): cpu i64[db] | mem i64[db] | idx i32[db] | total i32[db]
// | valid u8[db] | ready u8[db], db in {16, 256, 4096}, so a refresh is one
// H2D copy and one launch.  One thread per slot writes the five columns at
// row idx[j]; a pad slot carries idx = nb (out of range) and is dropped, as
// mode="drop" drops it.  Rows are unique (the dirty set is a dict's keys),
// so no two threads write one row.
//
// Bound on the H100: bytes -- 26 bytes read and 22 written per slot, a few
// kilobytes per refresh; the launch itself is the cost.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(
    int nb, int db, const uint8_t* __restrict__ staged,
    uint8_t* __restrict__ valid, uint8_t* __restrict__ ready,
    long long* __restrict__ cpu, long long* __restrict__ mem,
    int32_t* __restrict__ total) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= db) return;
  const long long* u_cpu = reinterpret_cast<const long long*>(staged);
  const long long* u_mem = u_cpu + db;
  const int32_t* idx = reinterpret_cast<const int32_t*>(u_mem + db);
  const int32_t* u_total = idx + db;
  const uint8_t* u_valid = reinterpret_cast<const uint8_t*>(u_total + db);
  const uint8_t* u_ready = u_valid + db;
  const int i = idx[j];
  if (i < 0 || i >= nb) return;  // pad slot: dropped
  valid[i] = u_valid[j];
  ready[i] = u_ready[j];
  cpu[i] = u_cpu[j];
  mem[i] = u_mem[j];
  total[i] = u_total[j];
}

}  // namespace

extern "C" int sk_scatter_rows(int nb, int db, const void* staged,
                               void* valid, void* ready, void* cpu,
                               void* mem, void* total, void* stream) {
  if (db <= 0) return 0;
  const int blocks = (db + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      nb, db, (const uint8_t*)staged, (uint8_t*)valid, (uint8_t*)ready,
      (long long*)cpu, (long long*)mem, (int32_t*)total);
  return (int)cudaGetLastError();
}
