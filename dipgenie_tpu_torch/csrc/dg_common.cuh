// Constants, the 64-bit reduction key and the window-split candidate pass
// shared by the pair-DP kernels.
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

// One block per window-split chunk (row c0 + blockIdx.x of tbl), one
// thread per pair lane, looping over rows: max-reduces the key of every
// valid candidate V[r - wsum, gidx] + score into the global destination
// lane win[chunk] * 1024 + rel with ordinal base[chunk] + lane. Chunks of
// a transition are in pair order, so the key's ordinal rule is the TPU
// kernels' strict `>` across chunks. Shared by K3 (the run's chunks) and
// K4 (one tp rank's share of a transition's chunks).
static __global__ void __launch_bounds__(CHUNK)
window_candidates(const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ win,
                  const int32_t* __restrict__ base, int c0, int R1,
                  int lanes, const int32_t* __restrict__ V, Key* keys) {
  const int chunk = c0 + blockIdx.x;
  const int32_t* row0 = tbl + ((size_t)chunk * 2) * CHUNK;
  const int packed = row0[threadIdx.x];
  const int rel = ((packed >> 2) & 2047) - 1;  // -1 on padded lanes
  if (rel < 0) return;
  const int score = row0[CHUNK + threadIdx.x];
  const int gidx = packed >> 13;
  const int wsum = packed & 3;
  const int dst = win[chunk] * 1024 + rel;
  const int ordinal = base[chunk] + threadIdx.x;
  for (int r = wsum; r < R1; ++r) {
    const int c = V[(size_t)(r - wsum) * lanes + gidx];
    if (c < REACH_T) continue;
    atomicMax(&keys[(size_t)r * lanes + dst], make_key(c + score, ordinal));
  }
}

}  // namespace dg

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* dg_error_string(int code);
