// K11: the dp sketch-count step's match and count of emitted minimizers.
//
// Replaces the body `local` of dipgenie_tpu/parallel/mesh.py
// `sharded_sketch_count_step` after its sketch (an XLA function): every
// emitted window (hash_hi, hash_lo) of a rank's reads is looked up in the
// replicated table sorted by (hi, lo) as unsigned pairs: the first slot
// whose hi is not below hash_hi (lower bound), then at most max_dup slots
// from there for an equal (hi, lo), the first hit winning; a hash whose
// equals start more than max_dup slots further is a miss, as in JAX.
// counts[slot] += 1 for each hit, and per_read[b] counts row b's hits.
// The ranks' counts then merge with one all_reduce(SUM) over dp.
//
// What bounds it on the H100: bytes (9 a window in; the table, which stays
// in L2, and the counts' atomics are small beside them). Design: one
// thread a window, a binary search in the table, the probes, one atomic
// add a hit into counts (hits spread over the table's slots) and one
// per block into per_read (a block's hits counted with
// __syncthreads_count).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sketch_count_kernel(const uint32_t* __restrict__ hash_hi,
                    const uint32_t* __restrict__ hash_lo,
                    const bool* __restrict__ emit, int NW, int tiles,
                    const uint32_t* __restrict__ table_hi,
                    const uint32_t* __restrict__ table_lo, int M, int max_dup,
                    int32_t* __restrict__ counts, int32_t* __restrict__ per_read) {
  const int b = blockIdx.x / tiles;
  const int j = (blockIdx.x % tiles) * THREADS + threadIdx.x;
  int slot = -1;
  if (j < NW) {
    const size_t o = (size_t)b * NW + j;
    if (emit[o]) {
      const uint32_t hh = hash_hi[o], hl = hash_lo[o];
      int lo = 0, hi = M;  // lower bound of hh in table_hi
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (table_hi[mid] < hh) lo = mid + 1;
        else hi = mid;
      }
      for (int d = 0; d < max_dup && lo + d < M; ++d) {
        if (table_hi[lo + d] == hh && table_lo[lo + d] == hl) {
          slot = lo + d;
          break;
        }
      }
      if (slot >= 0) atomicAdd(counts + slot, 1);
    }
  }
  const int hits = __syncthreads_count(slot >= 0);
  if (threadIdx.x == 0 && hits) atomicAdd(per_read + b, hits);
}

}  // namespace

// hash_hi / hash_lo / emit [B, NW] (K10's outputs), the table [M] sorted by
// (hi, lo); counts [M] and per_read [B] zeroed by the caller.
extern "C" int dg_sketch_count(const uint32_t* hash_hi, const uint32_t* hash_lo,
                               const bool* emit, int B, int NW,
                               const uint32_t* table_hi,
                               const uint32_t* table_lo, int M, int max_dup,
                               int32_t* counts, int32_t* per_read,
                               cudaStream_t stream) {
  const int tiles = (NW + THREADS - 1) / THREADS;
  if (B < 1 || NW < 1 || M < 1 || max_dup < 0 ||
      (long long)B * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  sketch_count_kernel<<<B * tiles, THREADS, 0, stream>>>(
      hash_hi, hash_lo, emit, NW, tiles, table_hi, table_lo, M, max_dup,
      counts, per_read);
  return (int)cudaGetLastError();
}
