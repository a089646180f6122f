// The window-split wide transition shared by K3 (csrc/wide_split_run.cu:
// a run of transitions in one cooperative launch) and K4
// (csrc/wide_step.cu: one tp rank's partial of one transition, one
// cooperative launch), on K2's cooperative skeleton (csrc/coop.cuh).
//
// A transition reads the window-split chunk table: slot s of a transition
// (or of a rank's share of it) is lane s % 256 of its chunk s / 256,
// packed gidx << 13 | (rel + 1) << 2 | wsum, its destination lane
// win[chunk] * 1024 + rel and its pair ordinal base[chunk] + s % 256. The
// real slots' destinations ascend, so each destination's pairs are one
// run of slots with no pad inside; the pads (rel = -1) sit at the end of
// each window's last chunk.
//
// Slices, no keys, no atomics. ops/plan.py:split_slices cuts each
// transition's written lanes [0, W) into S = G * m slices of about equal
// work (a lane and its pairs), each at most MAX_W lanes and CAND slots,
// and ships the first lane and the first slot of each: block b takes
// slices b, G + b, ... A slice's words reach shared
// memory by cp.async while the block works on the slice before it; the
// block marks each destination's run of slots (first, end, a stamp of the
// slice), computes every candidate V[r - wsum, gidx] + score of (slot, row)
// into shared memory, so all of its loads of V are in flight together,
// then takes each (lane, row)'s first maximum in slot order (strict >:
// ties go to the smallest ordinal, as the TPU kernel's strict `>` across
// chunks gave), a warp per range of more than LONG slots.
//
// Heavy destinations. A destination of more pairs than half of what a
// slice holds (CAND / 2) cannot share a slice with its neighbours, and
// past CAND no slice holds it: at level widths past ~210 a band end puts
// a whole level's pairs on one lane (45,796 at width 214). split_slices
// cuts such a destination into pieces, so a cut falls inside its run of
// slots (the cut's lane carries SPLIT); E's band ends (up to ~3,800) stay
// whole. A slice whose first or last lane is cut that way writes that
// lane's partial winner {value, slot} to rec [S, 2, R + 1] (side 0 the
// first lane, 1 the last), not to the state; on a transition with such a
// cut every block passes one extra grid barrier, and the block owning the
// lane's first cut combines its parts in slot order (strict >) and
// commits the lane.
//
// Commit. K3: V = the winner's value where it is above REACH_T, else NEG;
// bp = its ordinal (0 where no candidate reached the lane) on the lanes
// below the transition's extent, rows tb_bprow[t] + win of bp [nrows, R +
// 1, 1024]. K4: the partial, V = the winner's value (NEG where none), bp
// = its ordinal (-1 where none), [R + 1, NB * 1024] each.
#pragma once

#include <cooperative_groups.h>

#include "coop.cuh"

namespace {

namespace cg = cooperative_groups;
using coop::CAND;
using coop::LONG;
using coop::MAX_W;
using coop::NONE;
using coop::STAGE;
using coop::THREADS;
using dg::CHUNK;
using dg::NEG;
using dg::REACH_T;

constexpr int SMEM_BYTES = 2 * STAGE * 8 + CAND * 4 + 3 * MAX_W * 4;
constexpr int SPLIT = 1 << 30;  // a cut inside its lane's pairs (SPLIT)

// One launch's arguments.
struct Run {
  const int32_t* tbl;   // [chunks, 2, 256] packed words, scores
  const int32_t* win;   // [chunks] destination window
  const int32_t* base;  // [chunks] the chunk's first pair ordinal
  const int4* desc;     // [T] {first chunk, first bp row, bp lanes, split}
  const int2* cuts;     // [T, S + 1] {first lane | SPLIT, first slot}
  int T, R1, lanes, S, m;
  const int32_t* v_in;  // the state before transition 0
  int lds_in;           // its lanes
  int32_t* V0;          // transition t writes V1 if t is even, else V0
  int32_t* V1;          // and reads the other (v_in at t = 0)
  int32_t* bp;          // K3: [nrows, R1, 1024]; K4: the partial's bp plane
  int2* rec;            // [S, 2, R1] partial winners of cut lanes
};

// One transition's view of the run.
struct Tr {
  int c0, bprow, ext;
  const int32_t* src;
  int lds;
  int32_t* vout;
};

struct Slice {
  int d_lo, nd, slo, shi;
  bool fp, lp;  // first / last lane cut from a neighbouring slice
};

__device__ __forceinline__ Tr transition(const Run& x, int t) {
  const int4 d = __ldg(x.desc + t);
  Tr tr;
  tr.c0 = d.x;
  tr.bprow = d.y;
  tr.ext = d.z;
  tr.src = t == 0 ? x.v_in : (t & 1 ? x.V1 : x.V0);
  tr.lds = t == 0 ? x.lds_in : x.lanes;
  tr.vout = (t + 1) & 1 ? x.V1 : x.V0;
  return tr;
}

__device__ __forceinline__ Slice slice_of(const Run& x, int t, int k) {
  const int2* cu = x.cuts + (size_t)t * (x.S + 1);
  const int2 a = __ldg(cu + k), b = __ldg(cu + k + 1);
  Slice s;
  s.fp = (a.x & SPLIT) != 0;
  s.lp = (b.x & SPLIT) != 0;
  s.d_lo = a.x & ~SPLIT;
  s.nd = (b.x & ~SPLIT) + (s.lp ? 1 : 0) - s.d_lo;
  s.slo = a.y;
  s.shi = b.y;
  return s;
}

// {packed, score} of slot p: staged (index p - slo) or from the table
template <bool kStaged>
__device__ __forceinline__ int2 pair(const int2* s, const int32_t* tbl,
                                     int c0, int slo, int p) {
  if constexpr (kStaged) {
    return s[p - slo];
  } else {
    const int32_t* w = coop::word(tbl, c0, p);
    return make_int2(w[0], w[CHUNK]);
  }
}

// Destination lane of slot p, -1 on a pad.
__device__ __forceinline__ int dst_of(const int32_t* win, int c0, int packed,
                                      int p) {
  const int rel = ((packed >> 2) & 2047) - 1;
  return rel < 0 ? -1 : __ldg(win + c0 + (p >> 8)) * 1024 + rel;
}

__device__ __forceinline__ int ordinal(const Run& x, int c0, int slot) {
  return __ldg(x.base + c0 + (slot >> 8)) + (slot & (CHUNK - 1));
}

// Lane d, row r of the transition's output from its winner {best, slot}.
template <bool kPartial>
__device__ __forceinline__ void commit(const Run& x, const Tr& tr, int d,
                                       int r, int best, int slot) {
  const size_t at = (size_t)r * x.lanes + d;
  if constexpr (kPartial) {
    tr.vout[at] = best == NONE ? NEG : best;
    x.bp[at] = best == NONE ? -1 : ordinal(x, tr.c0, slot);
  } else {
    tr.vout[at] = best > REACH_T ? best : NEG;
    if (d < tr.ext)
      x.bp[((size_t)(tr.bprow + (d >> 10)) * x.R1 + r) * 1024 + (d & 1023)] =
          best == NONE ? 0 : ordinal(x, tr.c0, slot);
  }
}

// Lane d_lo + dl of slice k: a cut lane's partial winner to rec, any other
// lane committed.
template <bool kPartial>
__device__ __forceinline__ void put(const Run& x, const Tr& tr,
                                    const Slice& sl, int k, int dl, int r,
                                    int2 w) {
  const bool first = dl == 0 && sl.fp;
  if (first || (dl == sl.nd - 1 && sl.lp)) {
    x.rec[((size_t)k * 2 + (first ? 0 : 1)) * x.R1 + r] = w;
    return;
  }
  commit<kPartial>(x, tr, sl.d_lo + dl, r, w.x, w.y);
}

// Mark each destination's run among the slice's slots [slo, shi): first,
// end and the stamp (slots of lanes without pairs keep an older stamp).
template <bool kStaged>
__device__ __forceinline__ void mark(const int2* s, const Run& x, int c0,
                                     const Slice& sl, int stamp, int* first,
                                     int* end, int* stamps) {
  for (int p = sl.slo + (int)threadIdx.x; p < sl.shi; p += THREADS) {
    const int dc = dst_of(x.win, c0, pair<kStaged>(s, x.tbl, c0, sl.slo, p).x,
                          p);
    if (dc < 0) continue;
    const int dp = p > sl.slo
        ? dst_of(x.win, c0, pair<kStaged>(s, x.tbl, c0, sl.slo, p - 1).x,
                 p - 1) : -1;
    const int dn = p + 1 < sl.shi
        ? dst_of(x.win, c0, pair<kStaged>(s, x.tbl, c0, sl.slo, p + 1).x,
                 p + 1) : -1;
    const int dl = dc - sl.d_lo;
    if (dc != dp) {
      first[dl] = p;
      stamps[dl] = stamp;
    }
    if (dc != dn) end[dl] = p + 1;
  }
}

// Candidates of the slots [slo, slo + np) on rows [g0, g0 + rg):
// cand[(r - g0) * np + p - slo] = V[r - wsum, gidx] + score, or NONE where
// the source row is below 0 or the source value below REACH_T (a pad's is
// never read). One load of V per candidate, all of the block's in flight.
template <bool kStaged>
__device__ __forceinline__ void candidates(const int2* s, const int32_t* tbl,
                                           int c0, int slo, int np, int g0,
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
      w[j] = pair<kStaged>(s, tbl, c0, slo, slo + i - rl * np);
      const int rs = g0 + rl - (w[j].x & 3);
      const bool pad = ((w[j].x >> 2) & 2047) == 0;
      const int g = min((int)((unsigned)w[j].x >> 13), lds - 1);
      c[j] = rs >= 0 && !pad ? __ldcg(src + (size_t)rs * lds + g) : NEG;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) cand[i] = c[j] >= REACH_T ? c[j] + w[j].y : NONE;
    }
  }
}

// The cells of rows [g0, g0 + rg) of slice k from the candidates: thread
// (r, d) takes the first maximum of d's range, a warp per (range, row)
// where the range is longer than LONG (coop.cuh).
template <bool kPartial>
__device__ __forceinline__ void reduce_cells(
    const Run& x, const Tr& tr, const Slice& sl, int k, const int* cand,
    int np, int g0, int rg, int stamp, const int* first, const int* end,
    const int* stamps) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nd = sl.nd;
  for (int c = tid; c < nd * rg; c += THREADS) {
    const int rl = c / nd, dl = c - rl * nd;
    const bool has = stamps[dl] == stamp;
    const int e0 = has ? first[dl] : 0, e1 = has ? end[dl] : 0;
    if (e1 - e0 > LONG) continue;
    put<kPartial>(x, tr, sl, k, dl, g0 + rl,
                  coop::first_max(cand + rl * np - sl.slo, e0, e1));
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
        const int2 w = coop::warp_first_max(cand + rl * np - sl.slo,
                                            first[dj], end[dj], lane);
        if (lane == 0) put<kPartial>(x, tr, sl, k, dj, g0 + rl, w);
      }
    }
  }
}

// After the barrier of a transition with cut lanes: the block owning a
// lane's first cut combines the lane's partial winners in slot order (the
// earlier slice's side 1, then each later slice's side 0; strict >) and
// commits the lane.
template <bool kPartial>
__device__ __forceinline__ void combine(const Run& x, int t, const Tr& tr) {
  const int2* cu = x.cuts + (size_t)t * (x.S + 1);
  for (int kb = 1 + blockIdx.x; kb < x.S; kb += gridDim.x) {
    const int a = __ldg(cu + kb).x;
    if (!(a & SPLIT) || __ldg(cu + kb - 1).x == a) continue;
    for (int r = threadIdx.x; r < x.R1; r += THREADS) {
      int2 b = __ldcg(x.rec + ((size_t)(kb - 1) * 2 + 1) * x.R1 + r);
      for (int j = kb;; ++j) {
        const int2 c = __ldcg(x.rec + (size_t)j * 2 * x.R1 + r);
        if (c.x > b.x) b = c;
        if (__ldg(cu + j + 1).x != a) break;
      }
      commit<kPartial>(x, tr, a & ~SPLIT, r, b.x, b.y);
    }
  }
}

template <bool kPartial>
__global__ void __launch_bounds__(THREADS, 1) split_kernel(const Run x) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pair = reinterpret_cast<int2*>(smem);
  int* cand = reinterpret_cast<int*>(smem + 2 * STAGE * 8);
  int* first = cand + CAND;
  int* end = first + MAX_W;
  int* stamps = end + MAX_W;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, N = x.T * x.m;
  for (int i = threadIdx.x; i < MAX_W; i += THREADS) stamps[i] = 0;
  {
    const Slice s0 = slice_of(x, 0, blockIdx.x);
    coop::stage(x.tbl, __ldg(x.desc).x, s0.slo, s0.shi, s_pair);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  // item n: the block's slice j of transition t
  for (int n = 0; n < N; ++n) {
    const int t = n / x.m, j = n - t * x.m;
    const int k = j * G + blockIdx.x;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // n's slots staged, the last item's smem read
    if (n + 1 < N) {
      const int t1 = (n + 1) / x.m;
      const Slice s1 = slice_of(x, t1, ((n + 1) - t1 * x.m) * G + blockIdx.x);
      coop::stage(x.tbl, __ldg(x.desc + t1).x, s1.slo, s1.shi,
                  s_pair + ((n + 1) & 1) * STAGE);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    const Tr tr = transition(x, t);
    const Slice sl = slice_of(x, t, k);
    const int np = sl.shi - sl.slo;
    if (sl.nd > MAX_W || np > CAND) __trap();  // split_slices keeps them
    if (sl.nd > 0) {
      const int2* s = s_pair + (n & 1) * STAGE;
      const bool staged = np <= STAGE;
      const int stamp = n + 1;
      // rows a pass of candidates holds (all R + 1 but for the longest
      // slices)
      const int rg = np ? min(x.R1, CAND / np) : x.R1;
      if (staged)
        mark<true>(s, x, tr.c0, sl, stamp, first, end, stamps);
      else
        mark<false>(s, x, tr.c0, sl, stamp, first, end, stamps);
      for (int g0 = 0; g0 < x.R1; g0 += rg) {
        const int nr = min(rg, x.R1 - g0);
        if (g0) __syncthreads();  // the last pass's candidates are read
        if (staged)
          candidates<true>(s, x.tbl, tr.c0, sl.slo, np, g0, nr, tr.src,
                           tr.lds, cand);
        else
          candidates<false>(s, x.tbl, tr.c0, sl.slo, np, g0, nr, tr.src,
                            tr.lds, cand);
        __syncthreads();  // runs marked, candidates in place
        reduce_cells<kPartial>(x, tr, sl, k, cand, np, g0, nr, stamp, first,
                               end, stamps);
      }
    }
    if (j == x.m - 1) {
      if (__ldg(x.desc + t).w) {  // the cut lanes' parts are in rec
        grid.sync();
        combine<kPartial>(x, t, tr);
      }
      // the output buffer complete before transition t + 1 reads it
      if (t + 1 < x.T) grid.sync();
    }
  }
}

// One cooperative launch of G blocks (coop::launch).
template <bool kPartial>
int launch(Run x, int G, cudaStream_t stream) {
  if (x.T < 0 || x.R1 < 1 || G < 1 || x.m < 1 || x.S != G * x.m)
    return (int)cudaErrorInvalidValue;
  if (x.T == 0) return 0;
  void* args[] = {(void*)&x};
  return coop::launch((const void*)split_kernel<kPartial>, G, SMEM_BYTES,
                      args, stream);
}

}  // namespace
