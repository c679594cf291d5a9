// K3: capacity-bounded water-filling within each segment, both searches in
// one launch of one thread-block cluster (the kernel and its design are in
// waterfill.cuh).
//
// Replaces swarmkit_tpu/ops/kernel.py:127 seg_waterfill.  plan_group uses
// it for the stage-A branch levels and for stage B over the nodes.  Its
// element source reads flat columns, with the options folded into the
// launch:
//  * e == nullptr: e_i is the spread score from svc_tasks and failures
//    (clip(svc, 0, SVC_CLAMP) + downweight(failures) * F_BIG);
//  * tie == nullptr: the key is (clip(total, 0, TOTAL_CLAMP) << 20) | i when
//    total is given, else i;
//  * raw_cap != nullptr: the level_spill epilogue (see waterfill.cuh).

#include "waterfill.cuh"

namespace {

struct Elems {
  const int32_t* e;
  const int32_t* svc;
  const int32_t* failures;
  int max_failures;
  const int32_t* cap;
  const int32_t* tie;
  const int32_t* total;
  const int32_t* seg;
  int32_t* x;

  struct Stage {};
  __device__ __forceinline__ void stage(Stage*) const {}

  __device__ __forceinline__ Elem load(const Stage&, int i, int L) const {
    Elem r{-1, 0, 0, 0};
    const int s = seg[i];
    if ((unsigned)s < (unsigned)L) {
      r.s = s;
      r.lvl = e != nullptr ? e[i]
                           : spread_level(svc[i], failures[i], max_failures);
      r.cap = cap[i];
      r.key = tie != nullptr ? tie[i]
              : total != nullptr
                  ? (sk::clamp_int(total[i], 0, sk::TOTAL_CLAMP)
                     << sk::IDX_BITS) | i
                  : i;
    }
    return r;
  }

  __device__ __forceinline__ void store(const Stage&, int i, int v) const {
    x[i] = v;
  }
};

}  // namespace

extern "C" long long sk_waterfill_scratch_bytes(int L) {
  return scratch_bytes(L);
}

extern "C" int sk_waterfill(int n, int L, const void* e, const void* svc,
                            const void* failures, int max_failures,
                            const void* cap, const void* tie,
                            const void* total, const void* k_seg,
                            const void* seg, void* x, const void* raw_cap,
                            void* spill, void* scratch, void* stream) {
  const Elems el{(const int32_t*)e,        (const int32_t*)svc,
                 (const int32_t*)failures, max_failures,
                 (const int32_t*)cap,      (const int32_t*)tie,
                 (const int32_t*)total,    (const int32_t*)seg,
                 (int32_t*)x};
  return launch_waterfill(n, L, el, (const int32_t*)k_seg,
                          (const long long*)raw_cap, (int32_t*)spill,
                          scratch, stream);
}
