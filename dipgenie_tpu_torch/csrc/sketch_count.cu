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
// What bounds it on the H100: its bytes are 1 a window, 8 an emitted one,
// the table, counts and per_read, but only ~10% of windows emit, so the
// hashes are read a 32-byte sector at a time, and a lookup is a chain of
// dependent trips to scattered L2 sectors. Design, in one call (counts and
// per_read zeroed, then two kernels):
//   * a bucket index over the sorted table: off[b] is the first slot whose
//     hi >> (32 - bits) is >= b, 2^bits ~ M (one thread a slot writes the
//     buckets between its predecessor's and its own);
//   * a block reads CHUNK windows' emit flags, 16 a thread in one load,
//     compacts its emitted windows into shared memory in window order (a
//     scan of the threads' counts), and every thread that looks up has an
//     emitted window;
//   * the lower bound of hh lies in [off[b], off[b + 1]] for b = hh >>
//     (32 - bits): JAX's lower bound, and every slot of hi hh lies in
//     bucket b too. The same pass copies the table as (hi, lo) pairs, so a
//     bucket of up to SCAN slots is read in one or two sectors and its
//     lower bound and probes come from registers; a longer bucket is
//     searched by bisection inside it. A lookup is ~3 dependent trips (the
//     hash, the index, the pairs) instead of ~22, and ~3 L2 sectors;
//   * a hit adds 1 to counts[slot]; per_read takes one atomic per row a
//     warp (__match_any_sync over the hits' rows), since a block's windows
//     span rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;  // emit flags a thread reads, one 16-byte load
constexpr int CHUNK = THREADS * PER_THREAD;  // windows a block
constexpr int SCAN = 8;  // bucket slots counted without a bisection

__global__ void bucket_index_kernel(const uint32_t* __restrict__ table_hi,
                                    const uint32_t* __restrict__ table_lo,
                                    int M, int shift, int nb,
                                    int32_t* __restrict__ off,
                                    uint2* __restrict__ pairs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;  // slot, or M: the end
  if (s > M) return;
  const int lo = s == 0 ? 0 : (int)(table_hi[s - 1] >> shift) + 1;
  const int hi = s == M ? nb : (int)(table_hi[s] >> shift);
  for (int b = lo; b <= hi; ++b) off[b] = s;
  if (s < M) pairs[s] = make_uint2(table_hi[s], table_lo[s]);
}

// x / d for x < 2^32, with m = (2^32 - 1) / d (from the host).
__device__ __forceinline__ unsigned div_by(unsigned x, unsigned d,
                                           unsigned m) {
  unsigned q = __umulhi(x, m);
  return x - q * d >= d ? q + 1 : q;
}

__global__ void __launch_bounds__(THREADS)
sketch_count_kernel(const uint32_t* __restrict__ hash_hi,
                    const uint32_t* __restrict__ hash_lo,
                    const bool* __restrict__ emit, int NW, unsigned mNW,
                    unsigned total,
                    const uint2* __restrict__ pairs, int max_dup,
                    const int32_t* __restrict__ off, int shift,
                    int32_t* __restrict__ counts, int32_t* __restrict__ per_read) {
  __shared__ int list[CHUNK];  // the block's emitted windows, g - g0
  __shared__ int wsum[THREADS / 32 + 1];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned g0 = blockIdx.x * (unsigned)CHUNK, gt = g0 + PER_THREAD * t;
  // this thread's 16 flags, bit 8 i + 7 of f[i / 4] set where window
  // gt + i emits
  uint32_t f[4] = {0, 0, 0, 0};
  if (gt + PER_THREAD <= total &&
      ((uintptr_t)(emit + gt) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(emit + gt);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    for (int i = 0; i < PER_THREAD; ++i)
      if (gt + i < total && emit[gt + i]) f[i >> 2] |= 1u << (8 * (i & 3));
  }
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // a byte's top bit where it is not zero
    f[q] = (((f[q] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | f[q]) & 0x80808080u;
    cnt += __popc(f[q]);
  }
  // the block's exclusive prefix of the counts
  int inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int x = 0; x < THREADS / 32; ++x) {
      const int c = wsum[x];
      wsum[x] = n;
      n += c;
    }
    wsum[THREADS / 32] = n;
  }
  __syncthreads();
  int at = wsum[warp] + inc - cnt;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (uint32_t m = f[q]; m; m &= m - 1)
      list[at++] = PER_THREAD * t + 4 * q + (__ffs(m) >> 3) - 1;
  __syncthreads();
  const int n = wsum[THREADS / 32];
  const unsigned b0 = div_by(g0, NW, mNW), j0 = g0 - b0 * NW;
  // every lane of a warp takes the same turns
  for (int base = t - lane; base < n; base += THREADS) {
    int slot = -1, row = 0;
    if (base + lane < n) {
      const int x = list[base + lane];
      const uint32_t hh = hash_hi[g0 + x], hl = hash_lo[g0 + x];
      row = (int)(b0 + div_by(j0 + x, NW, mNW));
      const unsigned b = hh >> shift;
      const int lo = off[b], end = off[b + 1];
      // every slot of hi hh is in bucket b: the lower bound and the probes
      // read only the bucket's pairs
      if (end - lo <= SCAN) {
        uint2 p[SCAN];
#pragma unroll
        for (int d = 0; d < SCAN; ++d)
          p[d] = lo + d < end ? pairs[lo + d] : make_uint2(~0u, 0);
        // the slots of hi hh are the lower bound and the ones after it:
        // the first max_dup of them are probed
        int seen = 0;
#pragma unroll
        for (int d = 0; d < SCAN; ++d)
          if (lo + d < end && p[d].x == hh && seen++ < max_dup &&
              p[d].y == hl && slot < 0)
            slot = lo + d;
      } else {
        int l = lo, h = end;
        while (l < h) {
          const int mid = (l + h) >> 1;
          if (pairs[mid].x < hh) l = mid + 1;
          else h = mid;
        }
        for (int d = 0; d < max_dup && l + d < end; ++d) {
          const uint2 q = pairs[l + d];
          if (q.x != hh) break;
          if (q.y == hl) {
            slot = l + d;
            break;
          }
        }
      }
      if (slot >= 0) atomicAdd(counts + slot, 1);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, slot >= 0);
    if (slot >= 0) {
      const unsigned peers = __match_any_sync(hits, row);
      if (lane == __ffs(peers) - 1) atomicAdd(per_read + row, __popc(peers));
    }
  }
}

}  // namespace

// hash_hi / hash_lo / emit [B, NW] (K10's outputs), the table [M] sorted by
// (hi, lo); scratch: off [2^bits + 1] int32 for the bucket index, 1 <=
// bits <= 30, and pairs [M] of 8 bytes (the table interleaved); counts [M]
// and per_read [B] are zeroed here; B * NW < 2^32 - CHUNK.
extern "C" int dg_sketch_count(const uint32_t* hash_hi, const uint32_t* hash_lo,
                               const bool* emit, int B, int NW,
                               const uint32_t* table_hi,
                               const uint32_t* table_lo, int M, int max_dup,
                               int bits, int32_t* off, uint2* pairs,
                               int32_t* counts, int32_t* per_read,
                               cudaStream_t stream) {
  const long long total = (long long)B * NW;
  if (B < 1 || NW < 1 || M < 1 || max_dup < 0 || bits < 1 || bits > 30 ||
      total > 0xffffffffLL - CHUNK)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + CHUNK - 1) / CHUNK);
  cudaMemsetAsync(counts, 0, sizeof(int32_t) * M, stream);
  cudaMemsetAsync(per_read, 0, sizeof(int32_t) * B, stream);
  bucket_index_kernel<<<M / 256 + 1, 256, 0, stream>>>(
      table_hi, table_lo, M, 32 - bits, 1 << bits, off, pairs);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sketch_count_kernel<<<blocks, THREADS, 0, stream>>>(
      hash_hi, hash_lo, emit, NW, 0xffffffffu / NW, (unsigned)total, pairs,
      max_dup, off, 32 - bits, counts, per_read);
  return (int)cudaGetLastError();
}
