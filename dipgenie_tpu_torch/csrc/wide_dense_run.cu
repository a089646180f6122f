// K2: one run of wide pair-DP transitions over dense 256-pair chunks.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_wide_dense_kernel` (:1388,
// launched by `_wide_call`). On the TPU a chunk's gather was a block-masked
// one-hot matmul per source window and its results were extracted and
// read-modify-written per spanned destination window under static
// branches. Here every candidate is an indexed load from anywhere in the
// [R+1, NB * 1024] state, and each destination's maximum a reduction over
// its pairs, which are one range in plan order.
//
// The traffic it was designed for: phase C of chip_smoke.py (R = 18) has
// 3,900 dense wide transitions in 300 runs, all at NB 18, with 28 dense
// chunks a transition on average (at most 71), 6,400 real pairs at the
// median, and pairs into one destination median 2, mean 3.9, p99 20, max
// 2,304 (a band's last transition into a narrow level, where all of a
// transition's pairs land on fewer than 1,024 destinations).
//
// What bounds it on the H100: a transition is ~7k pairs x 19 rows of
// candidates against a state of 1.4 MB (L2-resident), far below what the
// card moves or computes in the time it takes; the level chain is serial,
// so the cost is one transition's latency across the grid: a grid-wide
// barrier, one round of L2 loads, shared-memory reductions, and the
// slowest block. The kernel it replaced took two launches a transition and
// max-reduced 64-bit keys with L2 atomics (12.0 us a transition on C).
//
// Design: ONE cooperative launch a run, of as many blocks of 1,024 threads
// as the card holds at once (the occupancy API: one an SM, 132 on an H100
// SXM; dg_wide_dense_grid, which plan_to_device asks), co-resident (where
// they cannot be, the launch is refused and the wrapper raises), a
// grid-wide barrier between transitions.
// * State. V is double-buffered in global memory, [2, R+1, NB * 1024]
//   (1.4 MB a buffer at NB 18, 2.4 MB at NB 31: both stay in L2);
//   transition t reads buffer t & 1 (V_in itself at t = 0) and writes
//   buffer (t + 1) & 1, so no block reads what another is writing. Reads of
//   V bypass L1 (ld.global.cg): other SMs wrote them.
// * Slices, no atomics. plan_to_device cuts each transition's written lanes
//   [0, W) into G * m contiguous slices of about equal work (a lane and its
//   pairs; ops/plan.py wide_slices), m the fewest a block that keep a slice
//   within MAX_W lanes and CAND pairs (1 on the H100 for every plan
//   measured); block b takes slices b, G + b, ... of every transition, on
//   every row. The planner sorts a transition's pairs by destination, so a
//   slice's pairs are one range and so are each destination's. Only the
//   slices' first lanes are shipped (int16); a block finds its ranges' ends
//   by searching the sorted words, 16 probes a round by a half-warp, for
//   KCACHE slices at a time. Slices of equal width left a band end's pairs
//   on 15 blocks, which then took 130-200 us; a width cap of 256 lanes made
//   phase E's band ends (40k+ pairs on fewer than 1,024 of ~24k written
//   lanes) merge 14 heavy destinations into one slice, hence MAX_W = 1024.
//   W covers this transition's destination extent and that of the one two
//   before it, the last to write the same buffer (the whole state for the
//   first two), so lanes past it hold NEG from an earlier write, as the
//   plain version's full rewrite leaves them.
// * Candidates, then reductions. A boundary pass over the slice's pairs
//   marks each destination's range (first, end, a stamp of the slice) in
//   shared memory while every thread computes candidates V[r - wsum, gidx]
//   + score of (pair, row) into shared memory (CAND values: all rows at
//   once but for the heaviest slices, which take a few passes), so all of
//   the block's loads of V are in flight together: a walk per cell had
//   each step wait for an L2 round trip. Thread (r, d) then takes the first
//   maximum of d's candidates (strict >) with its ordinal, the winner of
//   the plain version's 64-bit key; a range of more than LONG pairs is
//   reduced by a warp, its lanes' winners combined by __shfl_xor_sync on
//   (value, then the smaller ordinal), so the tie rule holds. The grid,
//   the launch, the staging and the reductions are csrc/coop.cuh's, which
//   K3 / K4 share.
//   Unreached lanes commit NEG with ordinal 0; a winner at a value <=
//   REACH_T commits NEG and keeps its ordinal.
// * Staging. The {packed, score} words of the block's next slice reach the
//   other of two shared-memory buffers by cp.async while this one runs; a
//   slice of more than STAGE pairs reads them from the table.
// * Backpointers start zeroed; only ordinals that are not 0 are written.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): C's wide runs
// 0.0278 s of the forward in `dp-stages` (7.1 us a transition) against the
// replaced kernel's 0.0490 s in the same run; 0.0256 s where the slices'
// first pairs were shipped as well, so the searches cost ~2.2 ms. A
// transition is ~1.3 us of grid barrier after the last block, ~1.5 us of
// candidates and ~1.5 us of reductions in the mean block, the slowest block
// up to 2-3 us later.
#include <cooperative_groups.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

using coop::CAND;
using coop::LONG;
using coop::MAX_W;
using coop::NONE;
using coop::STAGE;
using coop::THREADS;
using coop::word;
using dg::CHUNK;
using dg::NEG;
using dg::REACH_T;

// slices whose ranges a block holds: those of CH + 1 transitions, CH =
// KCACHE / m - 1 (m <= ops/plan.py K2_PER_BLOCK_MAX), one half-warp search
// for each end
constexpr int KCACHE = THREADS / 32;
constexpr int MAX_PER_BLOCK = KCACHE / 2;
constexpr int SMEM_BYTES =
    2 * STAGE * 8 + CAND * 4 + 3 * MAX_W * 4 + KCACHE * (16 + 4);

__device__ __forceinline__ int dst_of(int packed) {
  return (packed >> 2) & 32767;
}

// {packed, score} of pair p: staged (index p - plo) or from the table
template <bool kStaged>
__device__ __forceinline__ int2 pair(const int2* s, const int32_t* dtbl,
                                     int c0, int plo, int p) {
  if constexpr (kStaged) {
    return s[p - plo];
  } else {
    const int32_t* w = word(dtbl, c0, p);
    return make_int2(w[0], w[CHUNK]);
  }
}

__device__ __forceinline__ void commit(int32_t* dstV, int32_t* bpt,
                                       size_t at, int best, int ord) {
  dstV[at] = best > REACH_T ? best : NEG;
  if (ord != 0) bpt[at] = ord;
}

// Mark each destination's range among the slice's pairs [plo, phi):
// first, end and the stamp t + 1 (slots of destinations without pairs keep
// an older stamp).
template <bool kStaged>
__device__ __forceinline__ void mark(const int2* s, const int32_t* dtbl,
                                     int c0, int plo, int phi, int d_lo,
                                     int stamp, int* first, int* end,
                                     int* stamps) {
  for (int p = plo + (int)threadIdx.x; p < phi; p += THREADS) {
    const int dc = dst_of(pair<kStaged>(s, dtbl, c0, plo, p).x) - d_lo;
    const int dp = p > plo ? dst_of(pair<kStaged>(s, dtbl, c0, plo, p - 1).x)
                                 - d_lo : -1;
    const int dn = p + 1 < phi
                       ? dst_of(pair<kStaged>(s, dtbl, c0, plo, p + 1).x) - d_lo
                       : -1;
    if (dc != dp) {
      first[dc] = p;
      stamps[dc] = stamp;
    }
    if (dc != dn) end[dc] = p + 1;
  }
}

// Candidates of the pairs [plo, plo + np) on rows [g0, g0 + rg), their
// words staged or read from the table:
// cand[(r - g0) * np + p - plo] = V[r - wsum, gidx] + score, or NONE where
// the source row is below 0 or the source value below REACH_T. One load of V
// per candidate, all of the block's in flight at once.
template <bool kStaged>
__device__ __forceinline__ void candidates(const int2* s, const int32_t* dtbl,
                                           int c0, int plo, int np, int g0,
                                           int rg, const int32_t* src,
                                           int lds, int* cand) {
  constexpr int U = 4;  // candidates a thread takes at a time
  const int n = np * rg;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    int2 w[U];
    int c[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = min(i0 + j * THREADS, n - 1);
      const int rl = i / np;
      w[j] = pair<kStaged>(s, dtbl, c0, plo, plo + i - rl * np);
      const int rs = g0 + rl - (w[j].x & 3);
      const int g = min((w[j].x >> 17) & 32767, lds - 1);
      c[j] = rs >= 0 ? __ldcg(src + (size_t)rs * lds + g) : NEG;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) cand[i] = c[j] >= REACH_T ? c[j] + w[j].y : NONE;
    }
  }
}

// The cells of rows [g0, g0 + rg) from the candidates: thread (r, d) takes
// the first maximum of d's range, a warp per (range, row) where the range
// is longer than LONG (coop.cuh).
__device__ __forceinline__ void reduce_cells(
    const int* cand, int np, int plo, int g0, int rg, int d_lo, int nd,
    int stamp, const int* first, const int* end, const int* stamps,
    int32_t* dstV, int32_t* bpt, int lanes) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int c = tid; c < nd * rg; c += THREADS) {
    const int rl = c / nd, dl = c - rl * nd;
    const bool has = stamps[dl] == stamp;
    const int e0 = has ? first[dl] : 0, e1 = has ? end[dl] : 0;
    if (e1 - e0 > LONG) continue;
    const int2 w = coop::first_max(cand + rl * np - plo, e0, e1);
    commit(dstV, bpt, (size_t)(g0 + rl) * lanes + d_lo + dl, w.x, w.y);
  }
  int q = 0;
  for (int b = 0; b < nd; b += 32) {
    const int dl = b + lane;
    const bool is_long = dl < nd && stamps[dl] == stamp &&
                         end[dl] - first[dl] > LONG;
    unsigned m = __ballot_sync(0xffffffffu, is_long);
    while (m) {
      const int dj = b + __ffs(m) - 1;
      m &= m - 1;
      for (int rl = 0; rl < rg; ++rl, ++q) {
        if ((q & 31) != warp) continue;
        const int2 w = coop::warp_first_max(cand + rl * np - plo, first[dj],
                                            end[dj], lane);
        if (lane == 0)
          commit(dstV, bpt, (size_t)(g0 + rl) * lanes + d_lo + dj, w.x,
                 w.x == NONE ? 0 : w.y);
      }
    }
  }
}

// The first of pairs [0, n) (their destinations sorted) whose destination
// is at least `cut`, or n: a search by the half-warp `mask` (hl its lane
// 0..15), 16 probes a round.
__device__ __forceinline__ int lower_bound16(const int32_t* dtbl, int c0,
                                             int n, int cut, int hl,
                                             unsigned mask, int shift) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 15) >> 4;
    const int q = lo + hl * step;
    const bool ge = q < hi && dst_of(__ldg(word(dtbl, c0, q))) >= cut;
    const unsigned b = (__ballot_sync(mask, ge) & mask) >> shift;
    if (b) {  // the answer is in (the probe before the first true, it]
      const int j = __ffs(b) - 1;
      hi = lo + j * step;
      lo = j ? lo + (j - 1) * step + 1 : lo;
    } else {  // past the last probe that lies below hi
      lo += min(15, (hi - 1 - lo) / step) * step + 1;
    }
  }
  return lo;
}

// The ranges of the block's slices of transitions [t, t + nt): entry
// (tt * m + j) = {first lane, end lane, first pair, end pair} of slice j *
// G + blockIdx.x of transition t + tt, and c0s[tt] its first chunk. Each
// half-warp searches one end of one slice.
__device__ __forceinline__ void find_ranges(const int32_t* dtbl,
                                            const int2* desc,
                                            const int16_t* cuts, int S,
                                            int G, int m, int t, int nt,
                                            int4* rng, int* c0s) {
  const int h = threadIdx.x >> 4, hl = threadIdx.x & 15;
  const int shift = (threadIdx.x & 16);
  const unsigned mask = 0xFFFFu << shift;
  if (h >= 2 * nt * m) return;
  const int e = h >> 1, side = h & 1;
  const int tt = e / m, j = e - tt * m;
  const int2 d = __ldg(desc + t + tt);  // {first chunk, real pairs}
  const int cut = __ldg(cuts + (size_t)(t + tt) * (S + 1) + j * G +
                        blockIdx.x + side);
  const int p = lower_bound16(dtbl, d.x, d.y, cut, hl, mask, shift);
  if (hl == 0) {
    int* r = reinterpret_cast<int*>(rng + e);
    r[side] = cut;
    r[2 + side] = p;
    if (e == tt * m && side == 0) c0s[tt] = d.x;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wide_dense_kernel(const int32_t* __restrict__ dtbl,
                  const int2* __restrict__ desc,
                  const int16_t* __restrict__ cuts, int T, int R1, int lanes,
                  int m, const int32_t* __restrict__ v_in, int32_t* V,
                  int32_t* __restrict__ bp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pair = reinterpret_cast<int2*>(smem);
  int* cand = reinterpret_cast<int*>(smem + 2 * STAGE * 8);
  int* first = cand + CAND;
  int* end = first + MAX_W;
  int* stamps = end + MAX_W;
  int4* rng = reinterpret_cast<int4*>(stamps + MAX_W);
  int* c0s = reinterpret_cast<int*>(rng + KCACHE);
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, S = G * m, N = T * m;
  const int CH = KCACHE / m - 1;  // transitions between two searches
  for (int i = threadIdx.x; i < MAX_W; i += THREADS) stamps[i] = 0;

  // the ranges of transitions [0, CH], and the words of the first slice
  find_ranges(dtbl, desc, cuts, S, G, m, 0, min(CH + 1, T), rng, c0s);
  __syncthreads();
  coop::stage(dtbl, c0s[0], rng[0].z, rng[0].w, s_pair);
  asm volatile("cp.async.commit_group;" ::: "memory");

  const size_t plane = (size_t)R1 * lanes;
  int tc = 0;  // the first transition whose ranges are held
  // item n: the block's slice j of transition t
  for (int n = 0; n < N; ++n) {
    const int t = n / m, j = n - t * m;
    if (j == 0 && t > 0 && t % CH == 0) {  // after the grid barrier
      tc = t;
      find_ranges(dtbl, desc, cuts, S, G, m, t, min(CH + 1, T - t), rng,
                  c0s);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // n's words staged, ranges found, range slots free
    const int e = (t - tc) * m + j;
    if (n + 1 < N) {
      const int4 C1 = rng[e + 1];
      coop::stage(dtbl, c0s[(n + 1) / m - tc], C1.z, C1.w,
            s_pair + ((n + 1) & 1) * STAGE);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    const int4 C = rng[e];
    const int c0 = c0s[t - tc];
    const int d_lo = C.x, nd = C.y - C.x;
    const int plo = C.z, phi = C.w;
    const int np = phi - plo;
    if (np > CAND) __trap();  // wide_slices keeps a slice within CAND
    const bool staged = np <= STAGE;
    const int2* s = s_pair + (n & 1) * STAGE;
    const int stamp = n + 1;
    const int32_t* src = t == 0 ? v_in : V + (t & 1) * plane;
    const int lds = t == 0 ? 1024 : lanes;
    int32_t* dstV = V + ((t + 1) & 1) * plane;
    int32_t* bpt = bp + (size_t)t * plane;
    // rows a pass of candidates holds (all R + 1 for all but the longest
    // slices)
    const int rg = np ? min(R1, CAND / np) : R1;
    if (staged)
      mark<true>(s, dtbl, c0, plo, phi, d_lo, stamp, first, end, stamps);
    else
      mark<false>(s, dtbl, c0, plo, phi, d_lo, stamp, first, end, stamps);
    for (int g0 = 0; g0 < R1; g0 += rg) {
      const int nr = min(rg, R1 - g0);
      if (g0) __syncthreads();  // the last pass's candidates are read
      if (staged)
        candidates<true>(s, dtbl, c0, plo, np, g0, nr, src, lds, cand);
      else
        candidates<false>(s, dtbl, c0, plo, np, g0, nr, src, lds, cand);
      __syncthreads();  // ranges marked, candidates in place
      reduce_cells(cand, np, plo, g0, nr, d_lo, nd, stamp, first, end,
                   stamps, dstV, bpt, lanes);
    }
    // buffer (t + 1) & 1 complete before t + 1 reads it
    if (j == m - 1) grid.sync();
  }
}

}  // namespace

// The blocks of K2's grid the current device holds at once.
extern "C" int dg_wide_dense_grid(int* blocks) {
  return coop::held_blocks((const void*)wide_dense_kernel, SMEM_BYTES,
                           blocks);
}

// dtbl [nchunks, 2, 256]; desc [T, 2] int32 {first chunk, real pairs};
// cuts [T, G * m + 1] int16, the slices' first lanes (ops/plan.py
// wide_slices); v_in [R1, 1024]; V [2, R1, NB * 1024] (the output state is
// buffer T & 1); bp [T, R1, NB * 1024] zeroed. One cooperative launch of G
// blocks, m slices each a transition; cudaErrorCooperativeLaunchTooLarge
// where the card cannot hold them at once.
extern "C" int dg_wide_dense_run(const int32_t* dtbl, const int32_t* desc,
                                 const int16_t* cuts, int T, int R1, int NB,
                                 int G, int m, const int32_t* v_in,
                                 int32_t* V, int32_t* bp,
                                 cudaStream_t stream) {
  const int lanes = NB * 1024;
  if (T < 0 || R1 < 1 || G < 1 || m < 1 || m > MAX_PER_BLOCK ||
      lanes > G * m * MAX_W)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int2* d2 = reinterpret_cast<const int2*>(desc);
  void* args[] = {(void*)&dtbl, (void*)&d2,   (void*)&cuts, (void*)&T,
                  (void*)&R1,   (void*)&lanes, (void*)&m,   (void*)&v_in,
                  (void*)&V,    (void*)&bp};
  return coop::launch((const void*)wide_dense_kernel, G, SMEM_BYTES, args,
                      stream);
}
