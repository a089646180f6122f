// The cooperative skeleton shared by the sliced wide kernels, K2
// (csrc/wide_dense_run.cu) and K3 / K4 (csrc/wide_split.cuh): blocks of
// 1,024 threads, as many as the card holds at once, each taking contiguous
// slices of a transition's destination lanes; a slice's {packed, score}
// words staged in shared memory by cp.async while the block works on the
// slice before it; each destination's pairs one range of candidates in
// shared memory, reduced to its first maximum (strict >: the smallest
// index wins a tie) by a thread, or by a warp where the range is longer
// than LONG.
#pragma once

#include <climits>

#include "dg_common.cuh"

namespace coop {

using dg::CHUNK;

constexpr int THREADS = 1024;
constexpr int STAGE = 2560;  // words of a slice staged in shared memory
// candidate values a block holds at once, the most pairs (slots) of a
// slice (ops/plan.py K2_SLICE_PAIRS)
constexpr int CAND = 44032;
constexpr int MAX_W = 1024;  // lanes of a slice (ops/plan.py K2_SLICE_LANES)
constexpr int LONG = 32;     // a longer range is reduced by a warp
constexpr int NONE = INT_MIN;  // no valid candidate

// Word p of a transition whose chunks start at row c0 of a [chunks, 2,
// 256] table (the score is CHUNK words further).
__device__ __forceinline__ const int32_t* word(const int32_t* tbl, int c0,
                                                int p) {
  return tbl + ((size_t)(c0 + (p >> 8)) * 2) * CHUNK + (p & (CHUNK - 1));
}

// Issue cp.async copies of the words [lo, hi) into s (no wait); nothing
// where the slice holds more than STAGE.
__device__ __forceinline__ void stage(const int32_t* tbl, int c0, int lo,
                                      int hi, int2* s) {
  if (hi - lo > STAGE) return;
  for (int p = lo + (int)threadIdx.x; p < hi; p += THREADS) {
    const int32_t* w = word(tbl, c0, p);
    const unsigned d = (unsigned)__cvta_generic_to_shared(s + (p - lo));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(w)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d + 4),
                 "l"(w + CHUNK)
                 : "memory");
  }
}

// {first maximum, its index} of cv[e0, e1) by one thread, four values a
// step; {NONE, 0} where the range is empty or holds no valid candidate.
__device__ __forceinline__ int2 first_max(const int* cv, int e0, int e1) {
  int best = NONE, ord = 0;
#pragma unroll 1
  for (int e = e0; e < e1; e += 4) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cv[min(e + j, e1 - 1)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e + j < e1 && v[j] > best) {
        best = v[j];
        ord = e + j;
      }
    }
  }
  return make_int2(best, ord);
}

// The same by a warp (lane its lane): each lane the first maximum of its
// stride, the lanes' winners combined on (value, then the smaller index)
// by shuffles; every lane returns the winner, {NONE, *} where there is
// none.
__device__ __forceinline__ int2 warp_first_max(const int* cv, int e0, int e1,
                                               int lane) {
  int best = NONE, ord = INT_MAX;
#pragma unroll 1
  for (int e = e0 + lane; e < e1; e += 128) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cv[min(e + 32 * j, e1 - 1)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e + 32 * j < e1 && v[j] > best) {
        best = v[j];
        ord = e + 32 * j;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int vb = __shfl_xor_sync(0xffffffffu, best, o);
    const int vo = __shfl_xor_sync(0xffffffffu, ord, o);
    if (vb > best || (vb == best && vo < ord)) {
      best = vb;
      ord = vo;
    }
  }
  return make_int2(best, ord);
}

// The blocks of kernel fn (THREADS threads, smem bytes of dynamic shared
// memory) that the current device holds at once: its SMs times the blocks
// an SM holds (the occupancy API).
inline int held_blocks(const void* fn, int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, THREADS,
                                                         smem)) !=
      cudaSuccess)
    return (int)e;
  *blocks = sms * per;
  return 0;
}

// One cooperative launch of G blocks of fn;
// cudaErrorCooperativeLaunchTooLarge where the card cannot hold them at
// once (no fallback).
inline int launch(const void* fn, int G, int smem, void** args,
                  cudaStream_t stream) {
  int held = 0;
  cudaError_t e = (cudaError_t)held_blocks(fn, smem, &held);
  if (e != cudaSuccess) return (int)e;
  if (held < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(THREADS), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace coop
