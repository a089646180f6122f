// The skeleton the level-chain kernels K5b (chain_step16.cu) and K7
// (chain_edge.cu) share: a ring of table stages in shared memory, filled
// D levels ahead by a producer warp with 1-D bulk copies (cp.async.bulk)
// that complete on one mbarrier a stage, and one cluster barrier a level
// (barrier.cluster.arrive / wait; a launch without cluster dimensions is
// a cluster of one block, so the same barrier serves K7's single block).
//
// Level t uses stage t % D. The copies of level t complete phase t / D of
// the stage's barrier, so a consumer waits on parity (t / D) & 1. The
// producer takes part in every level's barrier: after the barrier of
// level t no consumer reads stage t % D again, and it issues level t +
// D's copies into it. The consumers arrive at the barrier of level t once
// they have written level t's state, then read level t + 1's tables into
// registers, then wait: the table reads run in the barrier's window.
// ops/chain_ring.py mirrors this schedule for the CPU tests.
#pragma once

#include "dg_common.cuh"

namespace dg {
namespace ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread sets up `n` barriers for `count` arrivals each; the block
// (and the cluster) then syncs before any thread uses them.
__device__ __forceinline__ void init(uint64_t* bars, int n, int count = 1) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(bars + i)),
                 "r"(count)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a stage's phase, with the bytes its copies bring.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A plain arrival on a barrier of this block (release, block scope).
__device__ __forceinline__ void arrive_local(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The level barrier over every thread of every block of the cluster:
// arrive releases this thread's writes (shared memory of this block and
// of its peers), wait acquires everyone's.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// An arrive that releases nothing: the caller orders its writes itself
// (a block-scope fence for its own shared memory, st.async for a peer's).
__device__ __forceinline__ void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address of `p` (this block's shared memory) in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// A word into a peer's shared memory (both addresses from peer_addr),
// counted as 4 bytes on the peer's barrier `bar`.
__device__ __forceinline__ void store_peer(uint32_t addr, int v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

}  // namespace ring
}  // namespace dg
