// K10: canonical (w,k)-minimizers of 2-bit reads with their MurmurHash3.
//
// Replaces dipgenie_tpu/ops/sketch_jax.py `batch_minimizer_kernel` (with
// `murmur_fold64_device`), an XLA function: for every row b of codes
// [B, L] (A=0, C=1, G=2, T=3) and every window j < NW = L - k - w + 2 of w
// consecutive k-mers it writes
//
//   the window's minimum canonical k-mer, the rightmost of equals (`<=`),
//   its start (minpos), emit = the window is valid (j <= lens[b] - k - w
//   + 1) and its minimum differs from window j - 1's (window 0 always
//   emits when valid), and the MurmurHash3_x64_128 of the minimum's k
//   ASCII bytes, its two halves XOR-folded, as hash_hi / hash_lo.
//
// A canonical k-mer is min(forward, reverse complement) packed 2 bits a
// base into the top 2k bits of a uint64_t, so its numeric order is the
// string order (JAX's (hi, lo) u32 pair order); a k-mer starting past
// lens[b] - k is all ones and never wins against a real one. The TPU
// emulated 64-bit products on u32 pairs; here they are native.
//
// What bounds it on the H100: neither bytes (1 byte in, 13 out a window)
// nor the integer rate; a block's shared-memory passes and the hash's
// dependent 64-bit multiplies (~20 a window) are its latency. Design,
// simple first: a block takes TILE windows of one row, stages their codes
// (TILE + w + k - 1 of them, the halo included) in shared memory, packs
// each k-mer once, takes each window's minimum over the staged k-mers
// (window j0 - 1 too, for emit), then hashes every window's winner.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;  // windows (and threads) a block

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

// Little-endian word of the n ASCII bytes of bases [i0, i0 + n) of the
// packed k-mer v.
__device__ __forceinline__ uint64_t bytes_le(uint64_t v, int i0, int n) {
  uint64_t r = 0;
  for (int j = 0; j < n; ++j) {
    const unsigned c = (unsigned)(v >> (62 - 2 * (i0 + j))) & 3u;
    const uint64_t ch = (0x54474341u >> (8 * c)) & 0xffu;  // "ACGT"
    r |= ch << (8 * j);
  }
  return r;
}

// MurmurHash3_x64_128 (seed 0) of the k ASCII bases of v, h1 ^ h2.
__device__ uint64_t murmur_fold64(uint64_t v, int k) {
  const uint64_t c1 = 0x87c37b91114253d5ULL, c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = 0, h2 = 0;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = bytes_le(v, 16 * b, 8), k2 = bytes_le(v, 16 * b + 8, 8);
    k1 *= c1;
    k1 = rotl64(k1, 31);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl64(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52dce729;
    k2 *= c2;
    k2 = rotl64(k2, 33);
    k2 *= c1;
    h2 ^= k2;
    h2 = rotl64(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495ab5;
  }
  const int nt = k & 15, t0 = nblocks * 16;
  if (nt > 8) {
    uint64_t k2 = bytes_le(v, t0 + 8, nt - 8);
    k2 *= c2;
    k2 = rotl64(k2, 33);
    k2 *= c1;
    h2 ^= k2;
  }
  if (nt > 0) {
    uint64_t k1 = bytes_le(v, t0, nt < 8 ? nt : 8);
    k1 *= c1;
    k1 = rotl64(k1, 31);
    k1 *= c2;
    h1 ^= k1;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
  return h1 ^ h2;
}

__global__ void __launch_bounds__(TILE)
sketch_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lens,
              int L, int k, int w, int NW, int tiles,
              uint32_t* __restrict__ hash_hi,
              uint32_t* __restrict__ hash_lo, bool* __restrict__ emit,
              int32_t* __restrict__ minpos) {
  extern __shared__ uint64_t smem[];
  const int b = blockIdx.x / tiles, j0 = (blockIdx.x % tiles) * TILE;
  const int n_win = min(TILE, NW - j0);
  const int base = j0 > 0 ? j0 - 1 : 0;  // first window (and k-mer) staged
  const int nw_s = j0 + n_win - base;      // windows staged
  const int nk_s = nw_s + w - 1;           // k-mers staged
  const int nc_s = nk_s + k - 1;           // codes staged
  uint64_t* kv = smem;                     // [TILE + w] k-mers
  uint64_t* wv = kv + TILE + w;            // [TILE + 1] window minima
  int* wp = (int*)(wv + TILE + 1);         // [TILE + 1] their starts
  uint8_t* cs = (uint8_t*)(wp + TILE + 1); // [TILE + w + k] codes
  const uint8_t* row = codes + (size_t)b * L + base;
  for (int i = threadIdx.x; i < nc_s; i += TILE) cs[i] = row[i];
  __syncthreads();

  const int len = lens[b];
  const int shift = 64 - 2 * k;
  for (int i = threadIdx.x; i < nk_s; i += TILE) {
    uint64_t f = 0, r = 0;
    for (int j = 0; j < k; ++j) {
      f = (f << 2) | cs[i + j];
      r = (r << 2) | (3u - cs[i + k - 1 - j]);
    }
    f <<= shift;
    r <<= shift;
    kv[i] = base + i <= len - k ? (r < f ? r : f) : ~0ULL;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nw_s; i += TILE) {
    uint64_t best = kv[i];
    int pos = 0;
    for (int s = 1; s < w; ++s) {
      const uint64_t c = kv[i + s];
      if (c <= best) {
        best = c;
        pos = s;
      }
    }
    wv[i] = best;
    wp[i] = base + i + pos;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < n_win) {
    const int j = j0 + t, i = j - base;
    const bool valid = j <= len - k - w + 1;
    const bool differs = j == 0 || wv[i] != wv[i - 1];
    const uint64_t h = murmur_fold64(wv[i], k);
    const size_t o = (size_t)b * NW + j;
    hash_hi[o] = (uint32_t)(h >> 32);
    hash_lo[o] = (uint32_t)h;
    emit[o] = valid && differs;
    minpos[o] = wp[i];
  }
}

int smem_bytes(int k, int w) {
  return (TILE + w) * 8 + (TILE + 1) * (8 + 4) + TILE + w + k;
}

}  // namespace

// codes [B, L] u8, lens [B]; outputs [B, NW], NW = L - k - w + 2 >= 1;
// 1 <= k <= 32, w >= 1.
extern "C" int dg_sketch(const uint8_t* codes, const int32_t* lens, int B,
                         int L, int k, int w, uint32_t* hash_hi,
                         uint32_t* hash_lo, bool* emit, int32_t* minpos,
                         cudaStream_t stream) {
  const int NW = L - k - w + 2;
  const int tiles = (NW + TILE - 1) / TILE;
  if (B < 1 || k < 1 || k > 32 || w < 1 || NW < 1 ||
      (long long)B * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(k, w);
  const cudaError_t e = cudaFuncSetAttribute(
      sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  sketch_kernel<<<B * tiles, TILE, bytes, stream>>>(
      codes, lens, L, k, w, NW, tiles, hash_hi, hash_lo, emit, minpos);
  return (int)cudaGetLastError();
}
