// K6: the pluggable scoring stage -- each node's effective level (lower is
// preferred) under the spread, weighted or learned strategy.
//
// Replaces swarmkit_tpu/ops/kernel.py:484 strategy_score and :464
// _learned_score (the scoring half of plan_strategy_jit, :539; the
// placement half is K3 or K5).  One thread per node:
//
//  * weighted: w0 * clip(svc, 0, SVC_CLAMP) + w1 * (HR - hr_cpu)
//    + w2 * (HR - hr_mem) + w3 * (HR - hr_gen) + downweight * 2^22;
//  * learned: the fixed-point MLP of scheduler/strategy.py
//    learned_score_host -- features [svc, total, failures, hr_cpu, hr_mem,
//    ready] each clipped to [0, 1023]; h = clip((f . w1 + b1) >> 7, 0,
//    1023); out = clip((h . w2 + b2) >> 7, 0, 2^24 - 1); plus the
//    down-weight;
//  * any other mode: the spread score clip(svc) + downweight * 2^22.
//
// The arithmetic is int32 on the CUDA cores, exactly as the reference's:
// the weight clamps keep every accumulator far inside int32 (6 * 1023 *
// 127 + 127 for a hidden unit, 8 * 1023 * 127 + 127 for the output), and
// >> on a negative pre-activation is the arithmetic shift jnp.right_shift
// does (nvcc shifts signed ints arithmetically).  No tensor core and no
// float is involved, so the result is bit-exact.
//
// Bound on the H100: bytes.  A node reads 21 bytes in learned mode (svc,
// total, failures, hr_cpu, hr_mem as int32, ready as a byte) or 20 in
// weighted mode (svc, failures, hr_cpu, hr_mem, hr_gen) and writes 4; the MLP
// costs 2 * 6 * 8 + 2 * 8 multiply-adds per node, three orders of
// magnitude under the card's integer rate.  The weights (at most 6 x 64 +
// 3 x 64 + 1 int32) are staged in each block's shared memory once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFeatures = 6;           // scheduler/strategy.py MLP_FEATURES
constexpr int kMaxHidden = 64;
constexpr int kHrClamp = 1023;         // HR_CLAMP
constexpr int kFeatClamp = 1023;       // FEAT_CLAMP
constexpr int kMlpShift = 7;           // MLP_SHIFT
constexpr int kScoreClamp = (1 << 24) - 1;  // SCORE_CLAMP
constexpr int kWeighted = 2, kLearned = 3;  // STRAT_WEIGHTED, STRAT_LEARNED

__global__ void __launch_bounds__(kThreads) score_kernel(
    int n, int mode, int hidden, int max_failures,
    const int32_t* __restrict__ svc, const int32_t* __restrict__ total,
    const int32_t* __restrict__ failures, const uint8_t* __restrict__ ready,
    const int32_t* __restrict__ hr_cpu, const int32_t* __restrict__ hr_mem,
    const int32_t* __restrict__ hr_gen,
    const int32_t* __restrict__ weights,  // [4]
    const int32_t* __restrict__ w1,       // [kFeatures, hidden]
    const int32_t* __restrict__ b1,       // [hidden]
    const int32_t* __restrict__ w2,       // [hidden]
    const int32_t* __restrict__ b2,       // []
    int32_t* __restrict__ e) {
  __shared__ int32_t s_w1[kFeatures * kMaxHidden];
  __shared__ int32_t s_b1[kMaxHidden];
  __shared__ int32_t s_w2[kMaxHidden];
  if (mode == kLearned) {
    for (int j = threadIdx.x; j < kFeatures * hidden; j += blockDim.x)
      s_w1[j] = w1[j];
    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      s_b1[j] = b1[j];
      s_w2[j] = w2[j];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int f = failures[i];
  const int down = f >= max_failures ? sk::clamp_int(f, 0, sk::FAILURE_CLAMP)
                                     : 0;
  int score;
  if (mode == kWeighted) {
    score = weights[0] * sk::clamp_int(svc[i], 0, sk::SVC_CLAMP) +
            weights[1] * (kHrClamp - hr_cpu[i]) +
            weights[2] * (kHrClamp - hr_mem[i]) +
            weights[3] * (kHrClamp - hr_gen[i]);
  } else if (mode == kLearned) {
    const int feat[kFeatures] = {
        sk::clamp_int(svc[i], 0, kFeatClamp),
        sk::clamp_int(total[i], 0, kFeatClamp),
        sk::clamp_int(f, 0, kFeatClamp),
        sk::clamp_int(hr_cpu[i], 0, kFeatClamp),
        sk::clamp_int(hr_mem[i], 0, kFeatClamp),
        ready[i] != 0 ? kFeatClamp : 0,
    };
    int out = 0;
    for (int h = 0; h < hidden; ++h) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kFeatures; ++j) acc += feat[j] * s_w1[j * hidden + h];
      acc = sk::clamp_int((acc + s_b1[h]) >> kMlpShift, 0, kFeatClamp);
      out += acc * s_w2[h];
    }
    score = sk::clamp_int((out + *b2) >> kMlpShift, 0, kScoreClamp);
  } else {
    score = sk::clamp_int(svc[i], 0, sk::SVC_CLAMP);
  }
  e[i] = score + down * sk::F_BIG;
}

}  // namespace

extern "C" int sk_strategy_score(
    int n, int mode, int hidden, int max_failures, const void* svc,
    const void* total, const void* failures, const void* ready,
    const void* hr_cpu, const void* hr_mem, const void* hr_gen,
    const void* weights, const void* w1, const void* b1, const void* w2,
    const void* b2, void* e, void* stream) {
  if (n <= 0) return 0;
  if (mode == kLearned && (hidden <= 0 || hidden > kMaxHidden))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  score_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, mode, hidden, max_failures, (const int32_t*)svc,
      (const int32_t*)total, (const int32_t*)failures,
      (const uint8_t*)ready, (const int32_t*)hr_cpu, (const int32_t*)hr_mem,
      (const int32_t*)hr_gen, (const int32_t*)weights, (const int32_t*)w1,
      (const int32_t*)b1, (const int32_t*)w2, (const int32_t*)b2,
      (int32_t*)e);
  return (int)cudaGetLastError();
}
