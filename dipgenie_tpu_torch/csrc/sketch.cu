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
// nor the integer rate, but its own instructions. Design:
//   * a warp (4 a block) takes a segment of SEG = 256 consecutive windows
//     of the flat range b * NW + j (8 a lane), so a segment of short rows
//     holds several rows and every lane has windows; [B, L] is contiguous,
//     so the codes a segment needs are one span of codes (the bases
//     between rows are read too and their k-mers never enter a window).
//     Each warp works in its own part of shared memory with __syncwarp
//     only: no barrier of the block holds a warp, so the card's warps hide
//     each other's latency (the k-mers and table entries of the w - 1
//     windows' halo after a segment are computed twice);
//   * the span is read 16 codes a lane (one 16-byte load) and packed 16
//     bases a 32-bit word; a k-mer is two funnel shifts of three words,
//     its reverse complement a bit reversal;
//   * each window's minimum is a query of a sparse table (level t the
//     minimum of 2^t k-mers), two entries that overlap, ordered by value
//     ascending then position descending: a total order, so the overlap is
//     exact and the rightmost of equals wins;
//   * only run heads are hashed: a window whose minimum differs from the
//     window before it, or the first of a row or of the segment. The heads
//     are compacted with __ballot_sync / __popc, hashed by all lanes, and
//     each window copies its head's hash (~8x fewer hashes on reads);
//     murmur's ASCII words are built by __byte_perm on "ACGT".
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WPT = 8;         // windows a lane
constexpr int SEG = 32 * WPT;  // windows a warp, at most
constexpr int WARPS = 4;       // warps a block, at most
constexpr int SMEM_TARGET = 48 * 1024;  // fewer warps a block past it
constexpr int SMEM_MAX = 227 * 1024;
constexpr uint32_t ACGT = 0x54474341u;  // "ACGT", little-endian bytes

// A warp's shared memory for a segment of `seg` windows (the host sizes
// it, the kernel lays it out).
struct Layout {
  int seg;    // windows a warp
  int nk;     // k-mers staged at most
  int words;  // packed 16-base words of codes
  int rows;   // rows whose lengths are staged
  int bytes;  // a warp's bytes, a multiple of 8
};

Layout layout(int seg, int B, int L, int NW, int k, int w) {
  Layout s;
  s.seg = seg;
  // rows after the first that seg consecutive windows reach
  int d = (seg + NW - 2) / NW;
  if (d > B - 1) d = B - 1;
  // codes staged at most, the 16-aligned start included
  const int nc = d * (w + k - 2) + seg + w + k + 14;
  s.nk = nc - k + 1;
  s.words = (nc + 15) / 16 + 2;
  // and the rows the 16-aligned start reaches back
  s.rows = d + 2 + 15 / L;
  s.bytes = (8 * (s.nk + seg) + 4 * (s.nk + s.words + s.rows) + 7) / 8 * 8;
  return s;
}

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

// 2-bit groups in reverse order (the first base of x lands in the lowest
// bits).
__device__ __forceinline__ uint64_t pairrev64(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ULL) |
         ((x & 0x5555555555555555ULL) << 1);
}

// The 2-bit codes of 8 bases (base j in bits 2j, 2j + 1) spread to one
// nibble each, then the little-endian ASCII word of the 8 bases.
__device__ __forceinline__ uint64_t ascii8(uint32_t x) {
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (uint64_t)__byte_perm(ACGT, 0, x >> 16) << 32 |
         __byte_perm(ACGT, 0, x & 0xffffu);
}

// The ASCII words of bases 0-7 and 8-15 of x (16 bases, the first on top).
__device__ __forceinline__ void ascii16(uint32_t x, uint64_t& a,
                                        uint64_t& b) {
  x = __brev(x);
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  a = ascii8(x & 0xffffu);
  b = ascii8(x >> 16);
}

__device__ __forceinline__ uint64_t low_bytes(uint64_t x, int n) {
  return n >= 8 ? x : x & ((1ULL << (8 * n)) - 1);
}

// MurmurHash3_x64_128 (seed 0) of the k ASCII bases of v, h1 ^ h2.
__device__ uint64_t murmur_fold64(uint64_t v, int k) {
  const uint64_t c1 = 0x87c37b91114253d5ULL, c2 = 0x4cf5ad432745937fULL;
  uint64_t a0, a1, a2, a3;  // the ASCII words of bases 0-7, ..., 24-31
  ascii16((uint32_t)(v >> 32), a0, a1);
  ascii16((uint32_t)v, a2, a3);
  uint64_t h1 = 0, h2 = 0;
  for (int b = 0; b < k / 16; ++b) {
    uint64_t k1 = b ? a2 : a0, k2 = b ? a3 : a1;
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
  const int nt = k & 15;
  const uint64_t t1 = k >= 16 ? a2 : a0, t2 = k >= 16 ? a3 : a1;
  if (nt > 8) {
    uint64_t k2 = low_bytes(t2, nt - 8);
    k2 *= c2;
    k2 = rotl64(k2, 33);
    k2 *= c1;
    h2 ^= k2;
  }
  if (nt > 0) {
    uint64_t k1 = low_bytes(t1, nt);
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

// Bytes 0-3 of x (each a code 0-3) as 8 bits, the first byte on top.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 3u) << 6) | ((x >> 4) & 0x30u) | ((x >> 14) & 0x0cu) |
         ((x >> 24) & 3u);
}

// x / d for x < 2^32, with m = (2^32 - 1) / d (from the host): the
// product's high word is the quotient or one below it.
__device__ __forceinline__ unsigned div_by(unsigned x, unsigned d,
                                           unsigned m) {
  unsigned q = __umulhi(x, m);
  return x - q * d >= d ? q + 1 : q;
}

__global__ void __launch_bounds__(32 * WARPS)
sketch_kernel(const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ lens, long long ncodes, int L,
              int k, int w, int NW, unsigned mL, unsigned mNW, unsigned total,
              Layout s,
              uint32_t* __restrict__ hash_hi, uint32_t* __restrict__ hash_lo,
              bool* __restrict__ emit, int32_t* __restrict__ minpos) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* tv = (uint64_t*)(smem + warp * s.bytes);  // [nk] table values
  uint64_t* hv = tv + s.nk;                        // [seg] heads' minima
  int* ti = (int*)(hv + s.seg);                    // [nk] winners' indices
  uint32_t* pk = (uint32_t*)(ti + s.nk);           // [words]
  int* lens_s = (int*)(pk + s.words);              // [rows]

  // this warp's windows [g0, g0 + n_win) of the flat range b * NW + j
  const unsigned g0 = (blockIdx.x * (blockDim.x >> 5) + warp) * s.seg;
  if (g0 >= total) return;
  const int n_win = (int)min((unsigned)s.seg, total - g0);
  const unsigned b0 = div_by(g0, NW, mNW), gl = g0 + n_win - 1;
  const unsigned b1 = div_by(gl, NW, mNW);
  const int j0 = (int)(g0 - b0 * NW), j1 = (int)(gl - b1 * NW);
  // staged codes [c0a, c1): from window j0 - 1 (for emit) to the last
  // window's last base, the start rounded down to 16
  const long long c0a = ((long long)b0 * L + j0 - (j0 > 0)) & ~15LL;
  const long long c1 = (long long)b1 * L + j1 + w + k - 1;
  const int nc = (int)(c1 - c0a), nk = nc - k + 1;
  int rb = b0;  // the row of staged code 0
  while ((long long)rb * L > c0a) --rb;
  // word q: codes c0a + 16 q + [0, 16), one 16-byte load where the codes
  // are 16-aligned (c0a is), zeros past the last code; the codes past c1
  // enter no k-mer
  const bool vec = ((uintptr_t)codes & 15) == 0;
  for (int q = lane; q < s.words; q += 32) {
    const long long c = c0a + 16LL * q;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (vec && c + 16 <= ncodes) {
      v = *reinterpret_cast<const uint4*>(codes + c);
    } else {
      uint32_t x[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c + i < ncodes)
          x[i >> 2] |= (uint32_t)codes[c + i] << (8 * (i & 3));
      v = make_uint4(x[0], x[1], x[2], x[3]);
    }
    pk[q] = pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 |
            pack4(v.w);
  }
  for (int r = lane; r <= (int)b1 - rb; r += 32) lens_s[r] = lens[rb + r];
  __syncwarp();

  // canonical k-mers of the staged positions; past a row's length all ones
  const uint64_t kmask = ~0ULL << (64 - 2 * k);
  const unsigned rel0 = (unsigned)(c0a - (long long)rb * L);
  for (int i = lane; i < nk; i += 32) {
    const int q = i >> 4, sh = 2 * (i & 15);
    const uint32_t w0 = pk[q], w1 = pk[q + 1], w2 = pk[q + 2];
    const uint64_t f = ((uint64_t)__funnelshift_l(w1, w0, sh) << 32 |
                        __funnelshift_l(w2, w1, sh)) & kmask;
    const uint64_t r = ~pairrev64(f) << (64 - 2 * k);
    const unsigned rel = rel0 + i, row = div_by(rel, L, mL);
    const int p = (int)(rel - row * L);
    tv[i] = p <= lens_s[row] - k ? (r < f ? r : f) : ~0ULL;
    ti[i] = i;
  }
  __syncwarp();

  // sparse table up to h = 2^lv <= w, in place: level l + 1 from level l
  // (every read of a chunk of 32 entries before its writes; later chunks
  // read only entries no earlier chunk writes)
  int lv = 0;
  while ((2 << lv) <= w) ++lv;
  for (int l = 0; l < lv; ++l) {
    const int h = 1 << l, n = nk - 2 * h + 1;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      uint64_t v = 0;
      int x = 0;
      if (i < n) {
        const uint64_t a = tv[i], b = tv[i + h];
        const bool right = b <= a;  // b's positions are all to the right
        v = right ? b : a;
        x = right ? ti[i + h] : ti[i];
      }
      __syncwarp();
      if (i < n) {
        tv[i] = v;
        ti[i] = x;
      }
      __syncwarp();
    }
  }

  // each lane its windows x = 32 r + lane: minimum, start, emit, and its
  // run's head (a window whose minimum differs from the one before it, or
  // the segment's first)
  const int span = w - (1 << lv);
  int hidx[WPT], pos[WPT];
  unsigned ems = 0;
  int heads = 0;  // the segment's heads so far
#pragma unroll
  for (int r = 0; r < WPT; ++r) {
    const int x = 32 * r + lane;
    bool head = false;
    pos[r] = 0;
    uint64_t val = 0;
    if (x < n_win) {
      const int jj = j0 + x;
      const int db = (int)div_by(jj, NW, mNW);
      const int j = jj - db * NW;
      const long long rs = (long long)(b0 + db) * L;  // the row's first code
      const int i = (int)(rs + j - c0a);
      const uint64_t a = tv[i], c = tv[i + span];
      val = c <= a ? c : a;
      pos[r] = (int)(c0a + (c <= a ? ti[i + span] : ti[i]) - rs);
      bool differs = true;
      if (j > 0) {
        const uint64_t pa = tv[i - 1], pc = tv[i - 1 + span];
        differs = (pc <= pa ? pc : pa) != val;
      }
      head = x == 0 || differs;
      if (differs && j <= lens_s[b0 + db - rb] - k - w + 1) ems |= 1u << r;
    }
    const unsigned hm = __ballot_sync(0xffffffffu, head);
    hidx[r] = heads + __popc(hm & (0xffffffffu >> (31 - lane))) - 1;
    if (head) hv[hidx[r]] = val;
    heads += __popc(hm);
  }
  __syncwarp();
  for (int x = lane; x < heads; x += 32) hv[x] = murmur_fold64(hv[x], k);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < WPT; ++r) {
    const int x = 32 * r + lane;
    if (x < n_win) {
      const uint64_t h = hv[hidx[r]];
      hash_hi[g0 + x] = (uint32_t)(h >> 32);
      hash_lo[g0 + x] = (uint32_t)h;
      emit[g0 + x] = (ems >> r) & 1;
      minpos[g0 + x] = pos[r];
    }
  }
}

}  // namespace

// codes [B, L] u8, lens [B]; outputs [B, NW], NW = L - k - w + 2 >= 1,
// B * NW < 2^32 - 1024; 1 <= k <= 32, w >= 1.
extern "C" int dg_sketch(const uint8_t* codes, const int32_t* lens, int B,
                         int L, int k, int w, uint32_t* hash_hi,
                         uint32_t* hash_lo, bool* emit, int32_t* minpos,
                         cudaStream_t stream) {
  const int NW = L - k - w + 2;
  const long long total = (long long)B * NW;
  if (B < 1 || k < 1 || k > 32 || w < 1 || NW < 1 ||
      total > 0xffffffffLL - SEG * WARPS)
    return (int)cudaErrorInvalidValue;
  // a warp's segment of SEG windows (fewer where its span of codes is
  // long: short rows of long k-mer windows), WARPS warps a block, fewer
  // past SMEM_TARGET
  int seg = SEG, warps = WARPS;
  while (layout(seg, B, L, NW, k, w).bytes * warps > SMEM_TARGET) {
    if (seg > 32) seg /= 2;
    else if (warps > 1) warps /= 2;
    else break;
  }
  const Layout s = layout(seg, B, L, NW, k, w);
  const int bytes = s.bytes * warps;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > SMEM_TARGET) {
    const cudaError_t e = cudaFuncSetAttribute(
        sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per_block = (long long)seg * warps;
  sketch_kernel<<<(unsigned)((total + per_block - 1) / per_block),
                  32 * warps, bytes, stream>>>(
      codes, lens, (long long)B * L, L, k, w, NW, 0xffffffffu / L,
      0xffffffffu / NW, (unsigned)total, s, hash_hi, hash_lo, emit, minpos);
  return (int)cudaGetLastError();
}
