// K5a: the empty-body level chain of the floor probe, as one scan over the
// whole card.
//
// Replaces scripts/tpu_floor_probe.py `build_pallas0`: a sequential TPU
// grid of T steps, each streaming a [8, 128] int32 block in, adding it to
// an accumulator kept in VMEM scratch and writing the accumulator's low 15
// bits out as an int16 block. The function is 1,024 independent inclusive
// prefix sums along T, mod 2^32, each element masked to its low 15 bits;
// wrapping addition is associative, so any chunking gives the same bits.
//
// What bounds it on the H100: bytes. A level reads 4 KB and writes 2 KB,
// so T = 40,000 levels are 246 MB, 73 us at 3.35 TB/s. The replaced kernel
// walked them in one block of 1,024 threads on one of the 132 SMs (0.049-
// 0.056 us a level: the floor of a level chain with an empty body, which
// PERF.md keeps as the record that K1's per-transition time is read
// against); this one is no longer such a floor.
//
// Design: a single-pass chained scan with decoupled look-back. A block of
// THREADS threads takes CHUNK consecutive levels, a thread 4 lanes (one
// 16-byte load a level, one 8-byte store of 4 int16), so a block covers a
// level row. A block's chunk is a ticket (an atomic on a counter the
// wrapper zeroes with the status words), not its blockIdx, so no chunk
// waits on one that was never scheduled. The block loads its CHUNK levels
// into registers, scans them there, publishes the chunk's sum (AGG) per
// thread, then looks back: over the chunks before it, LOOK at a time, it
// adds their AGG sums until it meets an inclusive prefix (INC), which it
// adds and stops (chunk 0 publishes INC at once). It publishes its own
// INC, adds the carry to its levels and writes their backpointers. Each
// thread looks back on its own 4 lanes only, so no thread waits on another
// of its block. A status word is set with a release store after its
// values; a window of them is read with relaxed loads, then a fence, then
// the values. acc is the last level's sum, written by the last chunk (0
// where T = 0: one chunk of no level). ops/chain_floor.py states CHUNK,
// THREADS and LOOK, and the CPU tests mirror the scan.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W, raw calls in
// turns, the zeroing of the status words included): 0.0207 ms at 4,000
// levels and 0.1187 ms at 40,000, against the replaced kernel's 0.219 /
// 2.138 and torch.cumsum's 1.196 / 14.62. Chunks of 16 levels took 0.0286
// / 0.1814 and of 32 0.0229 / 0.1373 (48 levels hold 192 registers of a
// thread's 232). One cooperative launch of 132 blocks, each summing its
// range into shared memory, a grid barrier, the carries, and a rescan,
// took 0.0209 / 0.2149: at 40,000 levels it reads the table twice.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8 * 128;
constexpr int THREADS = 256;  // a thread 4 lanes: a block a level row
constexpr int CHUNK = 48;     // levels a block
constexpr int LOOK = 8;       // chunks a look-back step reads
constexpr int AGG = 1, INC = 2;  // a chunk's published sums
static_assert(THREADS * 4 == LANES, "a block covers a level row");

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void publish(int* flag, int kind) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(kind)
               : "memory");
}

// Relaxed, so that a window's loads are in flight together; the fence
// after a window is read makes it an acquire.
__device__ __forceinline__ int status_of(const int* flag) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

// status: [0] the ticket counter, then [chunks, THREADS] status words, all
// zero at the launch; sums: [2, chunks, THREADS] uint4, the AGG sums then
// the INC prefixes.
__global__ void __launch_bounds__(THREADS)
chain_floor_kernel(const uint4* __restrict__ tbl, int T,
                   uint2* __restrict__ bp, uint4* __restrict__ acc_out,
                   int* __restrict__ status, uint4* __restrict__ sums) {
  __shared__ int s_chunk;
  const int i = threadIdx.x;
  if (i == 0) s_chunk = atomicAdd(status, 1);
  __syncthreads();
  const int c = s_chunk;
  const int chunks = max((T + CHUNK - 1) / CHUNK, 1);
  const int n = min(T - c * CHUNK, CHUNK);
  const uint4* in = tbl + (size_t)c * CHUNK * THREADS + i;
  int* flags = status + 1 + i;
  uint4* agg = sums + i;
  uint4* inc = sums + (size_t)chunks * THREADS + i;

  uint4 x[CHUNK];
#pragma unroll
  for (int k = 0; k < CHUNK; ++k)
    x[k] = k < n ? __ldcs(in + k * THREADS) : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 1; k < CHUNK; ++k) x[k] = add4(x[k - 1], x[k]);
  const uint4 own = x[CHUNK - 1];

  uint4 carry = make_uint4(0, 0, 0, 0);
  if (c == 0) {
    __stcg(inc, own);
    publish(flags, INC);
  } else {
    __stcg(agg + (size_t)c * THREADS, own);
    publish(flags + (size_t)c * THREADS, AGG);
    for (int j = c - 1;; j -= LOOK) {
      // the window j, j - 1, ..., j - LOOK + 1, read until every status
      // word down to the first INC is set
      int st[LOOK], upto;
      bool ready, found;
      do {
#pragma unroll
        for (int q = 0; q < LOOK; ++q)
          st[q] = j - q >= 0 ? status_of(flags + (size_t)(j - q) * THREADS)
                             : INC;
        ready = true;
        found = false;
        upto = LOOK;
#pragma unroll
        for (int q = LOOK - 1; q >= 0; --q) {
          if (st[q] == INC) upto = q + 1, ready = true, found = true;
          else if (st[q] == 0) ready = false;
        }
      } while (!ready);
      __threadfence();
#pragma unroll
      for (int q = 0; q < LOOK; ++q)
        if (q < upto)
          carry = add4(carry, __ldcg((st[q] == INC ? inc : agg) +
                                     (size_t)(j - q) * THREADS));
      if (found) break;
    }
    __stcg(inc + (size_t)c * THREADS, add4(carry, own));
    publish(flags + (size_t)c * THREADS, INC);
  }

  uint2* out = bp + (size_t)c * CHUNK * THREADS + i;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    if (k < n) {
      const uint4 y = add4(carry, x[k]);
      __stcs(out + k * THREADS,
             make_uint2((y.x & 0x7FFFu) | (y.y & 0x7FFFu) << 16,
                        (y.z & 0x7FFFu) | (y.w & 0x7FFFu) << 16));
    }
  }
  if (c == chunks - 1) acc_out[i] = add4(carry, own);
}

}  // namespace

// status: 1 + chunks * THREADS int32, zeroed by the caller on the launch's
// stream; sums: 2 * chunks * LANES int32; chunks = max(ceil(T / CHUNK), 1).
extern "C" int dg_chain_floor(const int32_t* tbl, int T, int16_t* bp,
                              int32_t* acc_out, int32_t* status,
                              int32_t* sums, cudaStream_t stream) {
  const int chunks = T > 0 ? (T + CHUNK - 1) / CHUNK : 1;
  chain_floor_kernel<<<chunks, THREADS, 0, stream>>>(
      reinterpret_cast<const uint4*>(tbl), T, reinterpret_cast<uint2*>(bp),
      reinterpret_cast<uint4*>(acc_out), status,
      reinterpret_cast<uint4*>(sums));
  return (int)cudaGetLastError();
}
