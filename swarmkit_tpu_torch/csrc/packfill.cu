// K5: the binpack fill of one group over all nodes (one segment), in one
// launch of one block (the kernel and its design are in packfill.cuh).
//
// Replaces swarmkit_tpu/ops/kernel.py:428 seg_packfill, as the binpack
// branch of plan_strategy (:521-527) calls it: one segment (L = 1), the
// key computed from res_cap and failures on the node index.  Its row
// source reads flat columns.

#include "packfill.cuh"

namespace {

struct FlatRows {
  const int32_t* res_cap;
  const int32_t* failures;
  const int32_t* cap;
  int32_t* x;
  int max_failures;
  static constexpr bool ordered = true;  // row i is node i

  struct Stage {};
  __device__ __forceinline__ void stage(Stage*) const {}

  __device__ __forceinline__ RowCols cols(const Stage&, int i) const {
    return RowCols{res_cap + i, failures + i, cap + i};
  }
  __device__ __forceinline__ int gidx(const Stage&, int i) const {
    return i;
  }
  __device__ __forceinline__ int32_t* out(const Stage&, int i) const {
    return x + i;
  }
};

}  // namespace

extern "C" int sk_packfill(int n, const void* res_cap, const void* failures,
                           int max_failures, const void* cap, const void* k,
                           void* x, void* stream) {
  const FlatRows src{(const int32_t*)res_cap, (const int32_t*)failures,
                     (const int32_t*)cap, (int32_t*)x, max_failures};
  return launch_packfill(n, src, (const int32_t*)k, stream);
}
