// The transition of the per-vertex DP tiers, shared by K13 (fused_dp.cu,
// the fused tier) and K15 (chunk_dp.cu, the chunked tier), and the two
// kernels that run it: the run kernel (a run of narrow transitions in one
// launch, its states in shared memory) and the per-transition kernel (a
// wide transition, its states in global memory).
//
// For a state (r, i2, j2) of level l + 1 the transition takes the max over
// the real predecessor slots p of i2 and q of j2 (sources a = pi[i2, p],
// b = pi[j2, q], edge weights wu, wv) of
//
//   V[r - wu - wv, a, b] + popcount((Hl[a] | Hl[b]) & (Hr[i2] | Hr[j2]))
//                        + popcount((Tl[a] | Tl[b]) ^ (Tr[i2] | Tr[j2]))
//
// over W colour words, counting a candidate only where r >= wu + wv and its
// source is reachable (>= 0). Ties go to the smaller a, then the smaller b,
// then the first slot pair in (p, q) order: slots are in predecessor-index
// order (parallel edges in adjacency order), so this is the exact tier's
// order (dipgenie_tpu/ops/diploid_jax.py:231-237). With no candidate the
// state is NEG.
//
// The tables (ops/vertex_plan.py): per transition a [k2, P] slot table of
// pi << 1 | w words, the in-degree of each destination, and the colour
// words Hl, Tl [k, W], Hr, Tr [k2, W]; a descriptor row of int64 (shape,
// offsets, the edges E into the destination level; DESC_COLS columns), on
// the host and on the device. The host cuts a call's transitions into
// launches (ops/vertex_plan.py:plan_launches).
//
// The run kernel: a run of narrow transitions in one launch of one block.
// V (and K15's SH) lives in dynamic shared memory, double-buffered, one
// consumer barrier a level. A producer warp stages each level's tables
// STAGES levels ahead in a ring (three 1-D bulk copies of the 16-byte
// aligned spans around the slots, the in-degrees and the colour words, on
// one mbarrier a stage; chain_ring.cuh). The score depends on (a, b, i2,
// j2) only, so each level's scores are computed once, into an [E, E]
// table (one entry a thread) during the level before; then a thread takes
// a state and walks its pair's real candidates, reading a score, not
// computing one, in each of the R1 rows. A consumer warp decodes each
// level's edges two levels ahead (first edges, sources, address shares),
// and thread 0 frees a stage after the level's barrier. The level's codes
// (K13) or packed words (K15) collect in shared memory and go out, a
// warp's stores consecutive, during the next level; V and SH leave shared
// memory after the run's last level.
//
// The per-transition kernel: a wide transition (one that does not fit the
// run kernel) in one launch over the card, states in global memory, a warp
// a destination pair and its lanes the rows, each candidate scored once
// by the warp for all the rows.
//
// What bounds them on the H100: a narrow level is a short chain on one SM
// (the candidates' shared-memory loads and compares, one barrier); the
// bytes (tables in, codes out) and operations are far from the card's
// rates. Measured (PERF.md sections 5-6, NVIDIA H100 80GB HBM3, 700 W): a
// narrow level 2.38 us (4,778 cycles, 61% of it the state pass); K13 on
// the MHC-scale graph's first 2,000 transitions 6.41 ms against the
// replaced kernel's 13.53 (one launch a transition, a thread a state,
// the score recomputed in every row), the fused forward 0.341 s against
// 0.802 in 4,201 launches against 119,999.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_ring.cuh"

namespace dgv {

constexpr int NEG = INT_MIN;  // unreachable
// descriptor columns (ops/vertex_plan.py; D_BP is the fused tier's byte
// offset of the transition's codes, D_E the edges into its destinations)
enum { D_K, D_K2, D_P, D_W, D_PRED, D_DEG, D_MASK, D_BP, D_E, DESC_COLS };
constexpr int THREADS = 256;  // the per-transition kernel's block
constexpr int MAX_BLOCKS = 132 * 16;  // a grid-stride loop past this
constexpr int CODE16_SLOTS = 256;  // p * P + q fits 16 bits up to this P
constexpr int RPL_MAX = 4;  // rows a lane carries: R1 to 128 in one walk
// the run kernel (ops/vertex_plan.py mirrors these)
constexpr int RUN_CONSUMERS = 512;
constexpr int RUN_THREADS = RUN_CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 8;                        // the table ring's depth
constexpr int STAGE_BYTES = 2560;                // a level's stage
constexpr int RUN_FIXED = 256;                   // the ring's barriers
// a level's edges and width in a run, at most: its score table is [E, E]
// int16, its decoded edges in the stage's header
constexpr int EDGES_MAX = 64;
constexpr int SCORE_BYTES = 2 * EDGES_MAX * EDGES_MAX;
// a stage: 16 header ints, then off [k2] (each destination's first edge and
// in-degree), edge [E] (source << 16 | destination), ia [E] and jb [E] (an
// edge's share of a state's address as its first and as its second edge),
// then the tables
constexpr int H_OFF = 16, H_EDGE = H_OFF + EDGES_MAX + 1;
constexpr int H_IA = H_EDGE + EDGES_MAX, H_JB = H_IA + EDGES_MAX;
constexpr int STAGE_HEAD = (4 * (H_JB + EDGES_MAX) + 15) / 16 * 16;
// in shared memory a state is [k * k, R1 + GUARD]: each pair's rows after
// GUARD unreachable ones, so that row r - wu - wv is an offset, never < 0
constexpr int GUARD = 2;

struct Tables {
  const int32_t* pred;  // [k2, P]: pi << 1 | w
  const int32_t* deg;   // [k2]
  const uint32_t* hl;   // [k, W]
  const uint32_t* tl;
  const uint32_t* hr;   // [k2, W]
  const uint32_t* tr;
  int k, k2, P, W;
};

// The device addresses of one transition's tables (host side).
inline Tables tables_of(const long long* d, const int32_t* pred,
                        const int32_t* deg, const uint32_t* masks) {
  Tables t;
  t.k = (int)d[D_K];
  t.k2 = (int)d[D_K2];
  t.P = (int)d[D_P];
  t.W = (int)d[D_W];
  t.pred = pred + d[D_PRED];
  t.deg = deg + d[D_DEG];
  t.hl = masks + d[D_MASK];
  t.tl = t.hl + (long long)t.k * t.W;
  t.hr = t.tl + (long long)t.k * t.W;
  t.tr = t.hr + (long long)t.k2 * t.W;
  return t;
}

inline int grid_of(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// Shared-memory bytes of a run whose widest level is kmax wide: the ring,
// two score tables, then [kmax * kmax, R1 + GUARD] states double-buffered:
// V, SH (K15), and the level's codes (int16, K13) or packed words (K15).
inline int run_smem(int kmax, int R1, bool sh) {
  return RUN_FIXED + STAGES * STAGE_BYTES + 2 * SCORE_BYTES +
         (sh ? 24 : 12) * (R1 + GUARD) * kmax * kmax;
}

// Rows a lane carries for R1 rows (the kernel's template argument).
inline int rows_per_lane(int R1) {
  const int rpl = (R1 + 31) / 32;
  return rpl < RPL_MAX ? rpl : RPL_MAX;
}

// ---------------- the per-transition kernel (wide transitions) ----------

// One transition over the card, states [R1, k, k] in global memory. A warp
// takes a destination pair and its lanes 32 * RPL of the rows (lane l rows
// l, l + 32, ...): the warp walks the pair's real slot pairs in step and
// scores each candidate once for all its rows; a lane keeps each of its
// rows' best as a 64-bit key (value << 24 | (4095 - a) << 12 | (4095 - b))
// with the winner's slot pair, and among equal keys the first in (p, q)
// order stays, the tie order above. out: K13's codes of the transition,
// K15's packed words of the transition or null.
//
// The warps take the destination pairs [p0, p1) of the k2 * k2 (all of
// them for K13 and the single-device K15; one tp rank's share for the
// chunked tier over a mesh), and state (r, pair) goes to element r * pitch
// + pair - p0 of vout, shout and out: a share lands in a compact [R1,
// pitch] buffer.
template <bool CHUNK, int RPL>
__global__ void __launch_bounds__(THREADS)
vertex_step_kernel(Tables t, const int32_t* __restrict__ vin,
                   int32_t* __restrict__ vout,
                   const int32_t* __restrict__ shin,
                   int32_t* __restrict__ shout, char* __restrict__ out,
                   int R1, long long p0, long long p1, long long pitch) {
  const long long kk = (long long)t.k * t.k, np = p1 - p0;
  const int lane = threadIdx.x & 31, W = t.W, P = t.P;
  const long long chunks = (R1 + 32 * RPL - 1) / (32 * RPL);
  const long long nwarps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long task = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                        32;
       task < chunks * np; task += nwarps) {
    const long long c = task / np, pair = p0 + (task - c * np);
    const int i2 = (int)(pair / t.k2), j2 = (int)(pair - (long long)i2 * t.k2);
    const int r0 = (int)c * 32 * RPL + lane;
    long long best[RPL];
    int code[RPL];
#pragma unroll
    for (int m = 0; m < RPL; ++m) {
      best[m] = -1;
      code[m] = 0;
    }
    const int di = t.deg[i2], dj = t.deg[j2];
    const int32_t* si = t.pred + (long long)i2 * P;
    const int32_t* sj = t.pred + (long long)j2 * P;
    const uint32_t* hri = t.hr + (long long)i2 * W;
    const uint32_t* hrj = t.hr + (long long)j2 * W;
    const uint32_t* tri = t.tr + (long long)i2 * W;
    const uint32_t* trj = t.tr + (long long)j2 * W;
    const uint32_t hd = hri[0] | hrj[0], td = tri[0] | trj[0];
    for (int p = 0; p < di; ++p) {
      const int ep = si[p];
      const int a = ep >> 1, wu = ep & 1;
      const uint32_t* hla = t.hl + (long long)a * W;
      const uint32_t* tla = t.tl + (long long)a * W;
      const uint32_t ha = hla[0], ta = tla[0];
      for (int q = 0; q < dj; ++q) {
        const int eq = sj[q];
        const int b = eq >> 1, sh = wu + (eq & 1);
        const uint32_t* hlb = t.hl + (long long)b * W;
        const uint32_t* tlb = t.tl + (long long)b * W;
        int sc = __popc((ha | hlb[0]) & hd) + __popc((ta | tlb[0]) ^ td);
        for (int w = 1; w < W; ++w)
          sc += __popc((hla[w] | hlb[w]) & (hri[w] | hrj[w])) +
                __popc((tla[w] | tlb[w]) ^ (tri[w] | trj[w]));
        const long long tie = (long long)((4095 - a) << 12 | (4095 - b));
        const int32_t* vab = vin + (long long)a * t.k + b;
#pragma unroll
        for (int m = 0; m < RPL; ++m) {
          const int s = r0 + 32 * m - sh;
          if (r0 + 32 * m < R1 && s >= 0) {
            const int v = vab[s * kk];
            if (v >= 0) {
              const long long key = (long long)(v + sc) << 24 | tie;
              if (key > best[m]) {
                best[m] = key;
                code[m] = p * P + q;
              }
            }
          }
        }
      }
    }
    // this lane's states out: V', and K13's code (int16 up to
    // CODE16_SLOTS slots, int32 past), or K15's SH' (the winner's source
    // SH plus its popcount((Tl | Tl) ^ (Tr | Tr))) and, where out is given,
    // its packed word pi | pj << 12 | wu << 24 | wv << 25; unreachable
    // states NEG, code 0, SH 0, word 0
#pragma unroll
    for (int m = 0; m < RPL; ++m) {
      const int r = r0 + 32 * m;
      if (r >= R1) break;
      const long long y = r * pitch + (pair - p0);
      const bool ok = best[m] >= 0;
      vout[y] = ok ? (int)(best[m] >> 24) : NEG;
      if (!CHUNK) {
        if (P > CODE16_SLOTS)
          reinterpret_cast<int32_t*>(out)[y] = code[m];
        else
          reinterpret_cast<uint16_t*>(out)[y] = (uint16_t)code[m];
        continue;
      }
      int sh = 0, word = 0;
      if (ok) {
        const int p = code[m] / P, q = code[m] - p * P;
        const int ep = si[p], eq = sj[q];
        const int a = ep >> 1, wu = ep & 1, b = eq >> 1, wv = eq & 1;
        sh = shin[(r - wu - wv) * kk + (long long)a * t.k + b];
        for (int w = 0; w < W; ++w)
          sh += __popc((t.tl[(long long)a * W + w] |
                        t.tl[(long long)b * W + w]) ^ (tri[w] | trj[w]));
        word = a | b << 12 | wu << 24 | wv << 25;
      }
      shout[y] = sh;
      if (out != nullptr) reinterpret_cast<int32_t*>(out)[y] = word;
    }
  }
}

template <bool CHUNK, int RPL>
inline cudaError_t launch_step_rpl(const Tables& tb, const int32_t* vin,
                                   int32_t* vout, const int32_t* shin,
                                   int32_t* shout, char* out, int R1,
                                   long long p0, long long p1,
                                   long long pitch, cudaStream_t stream) {
  const long long chunks = (R1 + 32 * RPL - 1) / (32 * RPL);
  const long long warps = chunks * (p1 - p0);
  vertex_step_kernel<CHUNK, RPL><<<grid_of(32 * warps), THREADS, 0,
                                   stream>>>(tb, vin, vout, shin, shout, out,
                                             R1, p0, p1, pitch);
  return cudaGetLastError();
}

// The per-transition kernel on the destination pairs [p0, p1) (p1 > p0),
// written at pitch; launch_cut passes every pair at pitch k2 * k2.
template <bool CHUNK>
inline cudaError_t launch_step(const Tables& tb, const int32_t* vin,
                               int32_t* vout, const int32_t* shin,
                               int32_t* shout, char* out, int R1,
                               long long p0, long long p1, long long pitch,
                               cudaStream_t stream) {
  switch (rows_per_lane(R1)) {
    case 1:
      return launch_step_rpl<CHUNK, 1>(tb, vin, vout, shin, shout, out, R1,
                                       p0, p1, pitch, stream);
    case 2:
      return launch_step_rpl<CHUNK, 2>(tb, vin, vout, shin, shout, out, R1,
                                       p0, p1, pitch, stream);
    case 3:
      return launch_step_rpl<CHUNK, 3>(tb, vin, vout, shin, shout, out, R1,
                                       p0, p1, pitch, stream);
    default:
      return launch_step_rpl<CHUNK, 4>(tb, vin, vout, shin, shout, out, R1,
                                       p0, p1, pitch, stream);
  }
}

// ---------------- the run kernel (runs of narrow transitions) -----------

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(RUN_CONSUMERS) : "memory");
}

// i / d for 0 <= i < 2^20 by a float reciprocal rd = 1.0f / d (d <= 2^10):
// the product's error stays far inside the 0.5 / d margin.
__device__ __forceinline__ int div_small(int i, float rd) {
  return __float2int_rz(((float)i + 0.5f) * rd);
}

// The producer warp: level l's tables into stage l % STAGES once the
// consumers have freed it (level l - STAGES done); a consumer warp decodes
// the level's edges two levels ahead of its use (decode). A stage: the
// header (k, k2, P, W, the word offsets of the slots, in-degrees and
// colour words from the stage's start, 1 / k2 and 1 / E as floats, E, the
// parallel-edge flag, at int 8 the level's code byte offset), the decoded
// edges, then the three spans.
__device__ __forceinline__ void stage_level(
    const long long (&e)[DESC_COLS], int l, const int32_t* pred,
    const int32_t* deg, const uint32_t* masks, unsigned char* ring,
    uint64_t* full, uint64_t* empty) {
  const int s = l % STAGES;
  if (l >= STAGES) dg::ring::wait(empty + s, ((l / STAGES) - 1) & 1);
  unsigned char* st = ring + s * STAGE_BYTES;
  int* head = reinterpret_cast<int*>(st);
  const int k = (int)e[D_K], k2 = (int)e[D_K2];
  const int P = (int)e[D_P], W = (int)e[D_W], E = (int)e[D_E];
  const char* src[3] = {reinterpret_cast<const char*>(pred + e[D_PRED]),
                        reinterpret_cast<const char*>(deg + e[D_DEG]),
                        reinterpret_cast<const char*>(masks + e[D_MASK])};
  const uint32_t len[3] = {4u * k2 * P, 4u * k2, 8u * (uint32_t)(k + k2) * W};
  uintptr_t lo[3];
  uint32_t at[3], size[3], pos = STAGE_HEAD;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src[r]);
    lo[r] = a & ~(uintptr_t)15;
    size[r] = (uint32_t)(((a + len[r] + 15) & ~(uintptr_t)15) - lo[r]);
    at[r] = pos;
    head[4 + r] = (int)((pos + (a - lo[r])) / 4);
    pos += size[r];
  }
  head[0] = k;
  head[1] = k2;
  head[2] = P;
  head[3] = W;
  head[7] = __float_as_int(1.0f / (float)k2);
  *reinterpret_cast<long long*>(head + 8) = e[D_BP];
  head[11] = __float_as_int(E > 0 ? 1.0f / (float)E : 0.0f);
  head[12] = E;
  dg::ring::expect_bytes(full + s, pos - STAGE_HEAD);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    dg::ring::bulk_load(st + at[r], reinterpret_cast<const void*>(lo[r]),
                        size[r], full + s);
}

// Level m's edges, once its copies have landed (the whole warp; k2 <= 64,
// two destinations a lane): off[i] = f << 16 | d, destination i's first
// edge f (an exclusive scan of the in-degrees) and in-degree d; for edge
// e = f + p (slot p of i, source a, weight w) edge[e] = a << 16 | i,
// ia[e] = a * k * RS - w and jb[e] = a * RS - w, so that state (r, i2,
// j2)'s candidate of edges e1, e2 reads V at (a * k + b) * RS + GUARD + r
// - wu - wv = ia[e1] + jb[e2] + GUARD + r; head[13] is 1 where two slots
// of a destination share a source (parallel edges). The level's barriers
// publish it.
__device__ __forceinline__ void decode(int m, int RS, unsigned char* ring,
                                       uint64_t* full) {
  const int lane = threadIdx.x & 31, s = m % STAGES;
  dg::ring::wait(full + s, (m / STAGES) & 1);
  int* head = reinterpret_cast<int*>(ring + s * STAGE_BYTES);
  const int k = head[0], k2 = head[1], P = head[2];
  const int32_t* slot = head + head[4];
  const int32_t* dg = head + head[5];
  int* off = head + H_OFF;
  int* edge = head + H_EDGE;
  int* ia = head + H_IA;
  int* jb = head + H_JB;
  bool par = false;
  int carry = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    const int d = i < k2 ? dg[i] : 0;
    int c = d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += u;
    }
    const int first = carry + c - d;
    carry += __shfl_sync(0xffffffffu, c, 31);
    if (i < k2) off[i] = first << 16 | d;
    int prev = -1;
    for (int p = 0; p < d; ++p) {
      const int w = slot[i * P + p], a = w >> 1;
      par |= a == prev;
      prev = a;
      edge[first + p] = a << 16 | i;
      ia[first + p] = a * k * RS - (w & 1);
      jb[first + p] = a * RS - (w & 1);
    }
  }
  par = __any_sync(0xffffffffu, par);
  if (lane == 0) head[13] = par;
}

// The producer warp's loop: descriptor rows 32 at a time (a lane a row,
// handed round by shuffles), lane 0 staging each level.
__device__ __forceinline__ void produce(const long long* __restrict__ desc,
                                        int n, const int32_t* pred,
                                        const int32_t* deg,
                                        const uint32_t* masks,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    long long d[DESC_COLS];
    const bool mine = base + lane < n;
#pragma unroll
    for (int c = 0; c < DESC_COLS; ++c)
      d[c] = mine ? __ldg(desc + (long long)(base + lane) * DESC_COLS + c)
                  : 0;
    const int m = min(32, n - base);
    for (int i = 0; i < m; ++i) {
      long long e[DESC_COLS];
#pragma unroll
      for (int c = 0; c < DESC_COLS; ++c)
        e[c] = __shfl_sync(0xffffffffu, d[c], i);
      if (lane == 0)
        stage_level(e, base + i, pred, deg, masks, ring, full, empty);
      __syncwarp();
    }
  }
}

// One level's stage, as the consumers read it.
struct Level {
  const int32_t* slot;  // [k2, P]
  const int32_t *off, *edge, *ia, *jb;
  const uint32_t *hl, *tl, *hr, *tr;
  int k, k2, P, W, E, par;
  float rk2, rE;
  long long bp;  // K13: the level's code byte offset
};

__device__ __forceinline__ Level level_of(const unsigned char* stage) {
  const int* head = reinterpret_cast<const int*>(stage);
  const int4 h0 = reinterpret_cast<const int4*>(stage)[0];
  const int4 h1 = reinterpret_cast<const int4*>(stage)[1];
  const int4 h2 = reinterpret_cast<const int4*>(stage)[2];
  const int4 h3 = reinterpret_cast<const int4*>(stage)[3];
  Level v;
  v.k = h0.x;
  v.k2 = h0.y;
  v.P = h0.z;
  v.W = h0.w;
  v.E = h3.x;
  v.par = h3.y;
  v.slot = head + h1.x;
  v.off = head + H_OFF;
  v.edge = head + H_EDGE;
  v.ia = head + H_IA;
  v.jb = head + H_JB;
  v.hl = reinterpret_cast<const uint32_t*>(head + h1.z);
  v.tl = v.hl + v.k * v.W;
  v.hr = v.tl + v.k * v.W;
  v.tr = v.hr + v.k2 * v.W;
  v.rk2 = __int_as_float(h1.w);
  v.rE = __int_as_float(h2.w);
  v.bp = (long long)(unsigned)h2.x | (long long)h2.y << 32;
  return v;
}

// The level's score table: S[e1 * E + e2] the score of the candidate of
// edges e1 (source a into i2) and e2 (source b into j2). A thread an
// entry, from the consumers' last threads down (the first ones take a
// level's extra states), the decoding warp last.
__device__ __forceinline__ void score_table(const Level& v, int16_t* S,
                                            int tid) {
  const int W = v.W, E = v.E;
  const int t = tid < RUN_CONSUMERS - 32 ? RUN_CONSUMERS - 33 - tid : tid;
  for (int y = t; y < E * E; y += RUN_CONSUMERS) {
    const int e1 = div_small(y, v.rE), e2 = y - e1 * E;
    const int d1 = v.edge[e1], d2 = v.edge[e2];
    const int a = d1 >> 16, i2 = d1 & 0xFFFF, b = d2 >> 16, j2 = d2 & 0xFFFF;
    int sc = 0;
    for (int w = 0; w < W; ++w)
      sc += __popc((v.hl[a * W + w] | v.hl[b * W + w]) &
                   (v.hr[i2 * W + w] | v.hr[j2 * W + w])) +
            __popc((v.tl[a * W + w] | v.tl[b * W + w]) ^
                   (v.tr[i2 * W + w] | v.tr[j2 * W + w]));
    S[y] = (int16_t)sc;
  }
}

// State (r, i2, j2)'s best candidate from its guarded row base vr (V +
// GUARD + r): returns the value (-1 where none reaches the state) and sets
// code = p * P + q. Without parallel edges the slot order is the source
// order, and the first of equal values is the smaller (a, b): a 32-bit
// compare; with them, a 64-bit key carries (4095 - a, 4095 - b).
template <bool PAR>
__device__ __forceinline__ int best_of(const Level& v, const int32_t* vr,
                                       const int16_t* s0, int oi, int di,
                                       int oj, int dj, int& code) {
  int best = -1;
  long long bkey = -1;
  code = 0;
  // one loop over the di * dj candidates in (p, q) order, so that the
  // lanes of two destination pairs in a warp do not split on the nesting
  int p = 0, q = 0, ia = v.ia[oi], pP = 0;
  const int16_t* sp = s0;
  long long ta = PAR ? (long long)(4095 - (v.edge[oi] >> 16)) << 12 : 0;
  for (int c = di * dj; c > 0; --c) {
    const int val = vr[ia + v.jb[oj + q]];
    const int sc = val + sp[q];
    if (PAR) {
      const long long key =
          (long long)sc << 24 | ta | (4095 - (v.edge[oj + q] >> 16));
      if (val >= 0 && key > bkey) {
        bkey = key;
        code = pP + q;
      }
    } else if (val >= 0 && sc > best) {
      best = sc;
      code = pP + q;
    }
    if (++q == dj && c > 1) {
      q = 0;
      ++p;
      ia = v.ia[oi + p];
      pP += v.P;
      sp += v.E;
      if (PAR) ta = (long long)(4095 - (v.edge[oi + p] >> 16)) << 12;
    }
  }
  return PAR ? (bkey >= 0 ? (int)(bkey >> 24) : -1) : best;
}

// Transitions desc[0 .. n) in one block. vin / shin: the state before the
// first, [R1, k, k]; vout / shout: the state after the last. out: K13's
// whole code buffer (the descriptor's byte offsets), K15's packed words of
// the first transition (the others follow it) or null. In shared memory a
// state is [k * k, RS] (RS = R1 + GUARD, a pair's rows together after its
// guards) and a thread takes a state x = pair * R1 + r: a warp's lanes
// share one or two destination pairs. A level's codes or words collect in
// a stage laid out as V and go out after the level's barrier, transposed
// to [R1, k2, k2], a warp's stores consecutive. Each level's score table
// is built during the level before (the first before the loop), so a
// level has one barrier.
template <bool CHUNK>
__global__ void __launch_bounds__(RUN_THREADS, 1)
vertex_run_kernel(const long long* __restrict__ desc, int n, int R1,
                  int kmax, const int32_t* __restrict__ pred,
                  const int32_t* __restrict__ deg,
                  const uint32_t* __restrict__ masks,
                  const int32_t* __restrict__ vin, int32_t* __restrict__ vout,
                  const int32_t* __restrict__ shin,
                  int32_t* __restrict__ shout, char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  unsigned char* ring = smem + RUN_FIXED;
  int16_t* S = reinterpret_cast<int16_t*>(ring + STAGES * STAGE_BYTES);
  const int RS = R1 + GUARD, ns = RS * kmax * kmax;
  int32_t* vb = reinterpret_cast<int32_t*>(S + 2 * EDGES_MAX * EDGES_MAX);
  int32_t* sb = vb + 2 * ns;  // K15 only
  // the level's codes (K13, int16) or packed words (K15, int32)
  int32_t* wb = CHUNK ? sb + 2 * ns : nullptr;
  uint16_t* cb = CHUNK ? nullptr : reinterpret_cast<uint16_t*>(vb + 2 * ns);
  const int tid = threadIdx.x;
  if (tid == 0) dg::ring::init(full, 2 * STAGES);
  __syncthreads();
  if (tid >= RUN_CONSUMERS) {
    produce(desc, n, pred, deg, masks, ring, full, empty);
    return;
  }
  // the last consumer warp decodes each level two ahead (the first two
  // before the loop)
  const bool decoder = tid >= RUN_CONSUMERS - 32;
  for (int x = tid; x < 2 * kmax * kmax; x += RUN_CONSUMERS)
    for (int g = 0; g < GUARD; ++g) vb[x * RS + g] = NEG;
  {
    const int kk0 = (int)(__ldg(desc + D_K) * __ldg(desc + D_K));
    for (int x = tid; x < R1 * kk0; x += RUN_CONSUMERS) {
      const int r = x / kk0, ab = x - r * kk0;
      vb[ab * RS + GUARD + r] = vin[x];
      if (CHUNK) sb[ab * RS + GUARD + r] = shin[x];
    }
  }
  if (decoder)
    for (int m = 0; m < min(n, 2); ++m) decode(m, RS, ring, full);
  consumers_sync();
  score_table(level_of(ring), S, tid);
  consumers_sync();
  const float rR1 = 1.0f / (float)R1;
  // the level before's stage and where it goes
  char* prev_dst = nullptr;
  int prev_kk2 = 0;
  long long words = 0;  // K15: the words of the run's earlier levels
  int k2 = 1;
  for (int l = 0; l < n; ++l) {
    const int s = l % STAGES, cur = (l & 1) * ns, nxt = ns - cur;
    const Level v = level_of(ring + s * STAGE_BYTES);
    k2 = v.k2;
    const int kk2 = v.k2 * v.k2, P = v.P, W = v.W, E = v.E;
    if (prev_dst != nullptr) {  // the level before's codes or words out
      const float rkk = 1.0f / (float)prev_kk2;
      const int m = R1 * prev_kk2;
      // K13: two codes a thread, one 4-byte store (a level's codes start
      // 4-byte aligned)
      for (int g = (CHUNK ? 1 : 2) * tid; g < m;
           g += (CHUNK ? 1 : 2) * RUN_CONSUMERS) {
        const int r = div_small(g, rkk);
        const int x = cur + (g - r * prev_kk2) * RS + GUARD + r;
        if (CHUNK) {
          reinterpret_cast<int32_t*>(prev_dst)[g] = wb[x];
        } else if (g + 1 < m) {
          const int r1 = div_small(g + 1, rkk);
          const int x1 = cur + (g + 1 - r1 * prev_kk2) * RS + GUARD + r1;
          reinterpret_cast<uint32_t*>(prev_dst)[g / 2] =
              (uint32_t)cb[x] | (uint32_t)cb[x1] << 16;
        } else {
          reinterpret_cast<uint16_t*>(prev_dst)[g] = cb[x];
        }
      }
    }
    const int16_t* Sl = S + (l & 1) * EDGES_MAX * EDGES_MAX;
    for (int x = tid; x < R1 * kk2; x += RUN_CONSUMERS) {
      const int pair = div_small(x, rR1), r = x - pair * R1;
      const int i2 = div_small(pair, v.rk2), j2 = pair - i2 * v.k2;
      const int fi = v.off[i2], fj = v.off[j2];
      const int oi = fi >> 16, di = fi & 0xFFFF, oj = fj >> 16, dj = fj & 0xFFFF;
      const int32_t* vr = vb + cur + GUARD + r;
      const int16_t* s0 = Sl + oi * E + oj;
      int code;
      const int val = v.par ? best_of<true>(v, vr, s0, oi, di, oj, dj, code)
                            : best_of<false>(v, vr, s0, oi, di, oj, dj, code);
      const bool ok = val >= 0;
      const int y = nxt + pair * RS + GUARD + r;
      vb[y] = ok ? val : NEG;
      if (!CHUNK) {
        cb[y] = (uint16_t)code;
        continue;
      }
      int sh = 0, word = 0;
      if (ok) {
        const int p = code / P, q = code - p * P;
        const int ea = v.edge[oi + p] >> 16, eb = v.edge[oj + q] >> 16;
        const int wu = v.slot[i2 * P + p] & 1, wv = v.slot[j2 * P + q] & 1;
        sh = sb[cur + GUARD + r + v.ia[oi + p] + v.jb[oj + q]];
        for (int w = 0; w < W; ++w)
          sh += __popc((v.tl[ea * W + w] | v.tl[eb * W + w]) ^
                       (v.tr[i2 * W + w] | v.tr[j2 * W + w]));
        word = ea | eb << 12 | wu << 24 | wv << 25;
      }
      sb[y] = sh;
      wb[y] = word;
    }
    if (decoder && l + 2 < n) decode(l + 2, RS, ring, full);
    if (l + 1 < n) {  // the next level's score table
      const int s1 = (l + 1) % STAGES;
      score_table(level_of(ring + s1 * STAGE_BYTES),
                  S + ((l + 1) & 1) * EDGES_MAX * EDGES_MAX, tid);
    }
    prev_dst = CHUNK ? (out != nullptr ? out + 4 * words : nullptr)
                     : out + v.bp;
    prev_kk2 = kk2;
    words += (long long)R1 * kk2;
    consumers_sync();
    if (tid == 0) dg::ring::arrive_local(empty + s);
  }
  const int last = (n & 1) * ns, kk2 = k2 * k2;
  const float rkk = 1.0f / (float)kk2;
  for (int g = tid; g < R1 * kk2; g += RUN_CONSUMERS) {
    const int r = div_small(g, rkk);
    const int x = last + (g - r * kk2) * RS + GUARD + r;
    vout[g] = vb[x];
    if (CHUNK) shout[g] = sb[x];
    if (prev_dst != nullptr) {
      if (CHUNK)
        reinterpret_cast<int32_t*>(prev_dst)[g] = wb[x];
      else
        reinterpret_cast<uint16_t*>(prev_dst)[g] = cb[x];
    }
  }
}

template <bool CHUNK>
inline cudaError_t launch_run(const long long* desc_dev, int n, int R1,
                              int kmax, const int32_t* pred,
                              const int32_t* deg, const uint32_t* masks,
                              const int32_t* vin, int32_t* vout,
                              const int32_t* shin, int32_t* shout, char* out,
                              cudaStream_t stream) {
  const int smem = run_smem(kmax, R1, CHUNK);
  const cudaError_t e = cudaFuncSetAttribute(
      vertex_run_kernel<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  vertex_run_kernel<CHUNK><<<1, RUN_THREADS, smem, stream>>>(
      desc_dev, n, R1, kmax, pred, deg, masks, vin, vout, shin, shout, out);
  return cudaGetLastError();
}

// The launches of a host cut (ops/vertex_plan.py:plan_launches; [n, 3]
// int64 rows first, end, kmax, 0 for a per-transition launch), the state
// alternating between two global buffers from launch to launch: V before
// the first in va (SH in sa), after launch i in (i even ? vb : va).
// out_of(t) gives a per-transition launch's `out`, out_run(t) a run's.
template <bool CHUNK, typename OutT, typename RunOutT>
inline int launch_cut(const long long* desc, const long long* desc_dev,
                      const long long* cut, int n_launch, int R1,
                      const int32_t* pred, const int32_t* deg,
                      const uint32_t* masks, int32_t* va, int32_t* vb,
                      int32_t* sa, int32_t* sb, OutT out_of,
                      RunOutT out_run, cudaStream_t stream) {
  if (R1 < 1 || n_launch < 0) return (int)cudaErrorInvalidValue;
  int32_t* vbuf[2] = {va, vb};
  int32_t* sbuf[2] = {sa, sb};
  for (int i = 0; i < n_launch; ++i) {
    const long long first = cut[3 * i], end = cut[3 * i + 1];
    const int kmax = (int)cut[3 * i + 2];
    const int c = i & 1;
    if (end <= first || (kmax == 0 && end != first + 1))
      return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (kmax > 0)
      e = launch_run<CHUNK>(desc_dev + first * DESC_COLS, (int)(end - first),
                            R1, kmax, pred, deg, masks, vbuf[c], vbuf[c ^ 1],
                            sbuf[c], sbuf[c ^ 1], out_run(first), stream);
    else {
      const Tables tb = tables_of(desc + first * DESC_COLS, pred, deg, masks);
      const long long kk2 = (long long)tb.k2 * tb.k2;
      e = launch_step<CHUNK>(tb, vbuf[c], vbuf[c ^ 1], sbuf[c], sbuf[c ^ 1],
                             out_of(first), R1, 0, kk2, kk2, stream);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace dgv
