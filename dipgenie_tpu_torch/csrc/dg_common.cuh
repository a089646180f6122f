// Constants and the 64-bit reduction key shared by the pair-DP kernels.
// The values mirror dipgenie_tpu/ops/diploid_pallas.py (NEG, REACH_T,
// PAD_SC, CHUNK) and dipgenie_tpu_torch/ops/plan.py (the key layout).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dg {

constexpr int CHUNK = 256;            // pairs per plan chunk
constexpr int NEG = -(1 << 19);       // unreachable state
constexpr int REACH_T = -(1 << 18);   // values above this are reachable
constexpr int PAD_SC = -(1 << 22);    // score of padded pair lanes

using Key = unsigned long long;

// (value - REACH_T + 1) << 32 | (0xFFFFFFFF - ordinal): a larger key is a
// larger value, then a smaller ordinal (the earliest pair in plan order).
// 0 means no valid candidate. Order-independent, so atomicMax is
// deterministic.
static __device__ __forceinline__ Key make_key(int value, int ordinal) {
  return ((Key)(unsigned)(value - REACH_T + 1) << 32) |
         (Key)(0xFFFFFFFFu - (unsigned)ordinal);
}

// Committed state of a key: NEG unless a candidate with a value above
// REACH_T reached the lane.
static __device__ __forceinline__ int key_value(Key k) {
  if (k == 0) return NEG;
  const int v = (int)(k >> 32) - 1 + REACH_T;
  return v > REACH_T ? v : NEG;
}

// Winner's pair ordinal (0 where no candidate reached the lane).
static __device__ __forceinline__ int key_ordinal(Key k) {
  return k == 0 ? 0 : (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFull));
}

}  // namespace dg

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* dg_error_string(int code);
