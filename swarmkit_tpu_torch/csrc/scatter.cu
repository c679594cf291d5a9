// K7: the dirty-row scatter into the streaming scheduler's resident node
// columns, unsplit or split over the shards of a node-axis split.
//
// Replaces swarmkit_tpu/ops/streaming.py:97 _scatter_rows_jit, a donated
// `.at[idx].set(..., mode="drop")` over the five resident columns (valid,
// ready, cpu, mem, total), and swarmkit_tpu/parallel/sharded.py:272
// scatter_rows_sharded, the same update under shard_map with each shard
// keeping the rows it owns.  Here the columns are updated in place, which
// is this port's form of the reference's donation: the tensors keep their
// identity and no cluster-sized copy is made per delta.
//
// The host packs the update slots into ONE buffer (see ops/kernel.py
// scatter_views): cpu i64[db] | mem i64[db] | idx i32[db] | total i32[db]
// | valid u8[db] | ready u8[db], db in {16, 256, 4096}, with GLOBAL row
// indices, so a refresh is one H2D copy and one launch however many shards
// hold the columns.  The launch takes a table of D shards (D = 1 unsplit):
// each shard's five column pointers, every shard holding local_n rows
// (shard s owns global rows [s * local_n, (s + 1) * local_n)).  One thread
// per slot finds its shard s = idx / local_n and local row
// r = idx % local_n and writes the five columns of shard s at r.  A pad
// slot carries idx = nb = D * local_n; it and any index outside [0, nb)
// are dropped, as mode="drop" drops them, after a negative index is taken
// from the end (idx + nb), as jnp's indexing takes it.  Rows are unique
// (the dirty set is a dict's keys), so no two threads write one row.
//
// Bound on the H100: bytes -- 26 bytes read and 22 written per slot, a few
// kilobytes per refresh; the launch itself is the cost, and a split pays
// it once a refresh, not once a shard.

#include "shard.cuh"

namespace {

constexpr int kThreads = 256;

// one shard's resident columns
struct ScatterShard {
  uint8_t* valid;
  uint8_t* ready;
  long long* cpu;
  long long* mem;
  int32_t* total;
};

// the launch's shard table, a kernel parameter read in place
// (__grid_constant__: D x 40 bytes)
struct ScatterTable {
  ScatterShard s[sk::MAX_LAUNCH_SHARDS];
};

__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(
    int shards, int local_n, int db, const uint8_t* __restrict__ staged,
    const __grid_constant__ ScatterTable tab) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= db) return;
  const long long* u_cpu = reinterpret_cast<const long long*>(staged);
  const long long* u_mem = u_cpu + db;
  const int32_t* idx = reinterpret_cast<const int32_t*>(u_mem + db);
  const int32_t* u_total = idx + db;
  const uint8_t* u_valid = reinterpret_cast<const uint8_t*>(u_total + db);
  const uint8_t* u_ready = u_valid + db;
  const int nb = shards * local_n;   // < 2^31 (the entry checks)
  int i = idx[j];
  if (i < 0) i += nb;  // a negative index counts from the end, as in jnp
  if (i < 0 || i >= nb) return;  // pad slot or out of range: dropped
  const int s = shards == 1 ? 0 : i / local_n;
  const int r = i - s * local_n;
  const ScatterShard& d = tab.s[s];
  d.valid[r] = u_valid[j];
  d.ready[r] = u_ready[j];
  d.cpu[r] = u_cpu[j];
  d.mem[r] = u_mem[j];
  d.total[r] = u_total[j];
}

}  // namespace

// ``ptrs``: the host's table, five pointers a shard (valid, ready, cpu,
// mem, total), ``shards`` shards of ``local_n`` rows each.
extern "C" int sk_scatter_rows(int shards, int local_n, int db,
                               const void* staged, const void* const* ptrs,
                               void* stream) {
  if (db <= 0) return 0;
  if (shards <= 0 || shards > sk::MAX_LAUNCH_SHARDS || local_n <= 0 ||
      (long long)shards * local_n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ScatterTable tab = {};
  for (int s = 0; s < shards; ++s) {
    const void* const* p = ptrs + 5 * (size_t)s;
    tab.s[s] = ScatterShard{(uint8_t*)p[0], (uint8_t*)p[1], (long long*)p[2],
                            (long long*)p[3], (int32_t*)p[4]};
  }
  const int blocks = (db + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      shards, local_n, db, (const uint8_t*)staged, tab);
  return (int)cudaGetLastError();
}
