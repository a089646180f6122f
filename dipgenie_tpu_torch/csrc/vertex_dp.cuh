// The transition of the per-vertex DP tiers, shared by K13 (fused_dp.cu,
// the fused tier) and K15 (chunk_dp.cu, the chunked tier).
//
// For a state (r, i2, j2) of level l + 1 the body takes the max over the
// real predecessor slots p of i2 and q of j2 (sources a = pi[i2, p], b =
// pi[j2, q], edge weights wu, wv) of
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
// words Hl, Tl [k, W], Hr, Tr [k2, W]; a host descriptor row of int64
// (shape and offsets, DESC_COLS columns).
//
// The body loops over the real slots only (a destination's in-degree, not
// the padded P): on a level that feeds a narrow one from a wide one the
// in-degree reaches ~200 and the padded P x P of every destination pair
// would multiply the work.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace dgv {

constexpr int NEG = INT_MIN;  // unreachable
// descriptor columns (ops/vertex_plan.py; D_BP is the fused tier's byte
// offset of the transition's backpointer codes)
enum { D_K, D_K2, D_P, D_W, D_PRED, D_DEG, D_MASK, D_BP, DESC_COLS };
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // a grid-stride loop past this
constexpr int CODE16_SLOTS = 256;  // p * P + q fits 16 bits up to this P

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

struct Win {
  int v;  // NEG where no candidate reaches the state
  int a, b, wu, wv, p, q, symd;
  long long src;  // flat index of the winner's source state
};

__device__ __forceinline__ Win best_of(const Tables& t,
                                       const int32_t* __restrict__ V, int r,
                                       int i2, int j2) {
  Win o;
  o.v = NEG;
  o.a = o.b = INT_MAX;
  o.wu = o.wv = o.p = o.q = o.symd = 0;
  o.src = 0;
  const int W = t.W;
  const int di = __ldg(t.deg + i2), dj = __ldg(t.deg + j2);
  const int32_t* si = t.pred + (long long)i2 * t.P;
  const int32_t* sj = t.pred + (long long)j2 * t.P;
  const uint32_t* hri = t.hr + (long long)i2 * W;
  const uint32_t* hrj = t.hr + (long long)j2 * W;
  const uint32_t* tri = t.tr + (long long)i2 * W;
  const uint32_t* trj = t.tr + (long long)j2 * W;
  for (int p = 0; p < di; ++p) {
    const int ep = __ldg(si + p);
    const int a = ep >> 1, wu = ep & 1;
    if (r < wu) continue;
    const uint32_t* hla = t.hl + (long long)a * W;
    const uint32_t* tla = t.tl + (long long)a * W;
    for (int q = 0; q < dj; ++q) {
      const int eq = __ldg(sj + q);
      const int b = eq >> 1, wv = eq & 1;
      const int s = r - wu - wv;
      if (s < 0) continue;
      const long long src = ((long long)s * t.k + a) * t.k + b;
      const int v = __ldg(V + src);
      if (v < 0) continue;
      const uint32_t* hlb = t.hl + (long long)b * W;
      const uint32_t* tlb = t.tl + (long long)b * W;
      int sc = 0, sy = 0;
      for (int w = 0; w < W; ++w) {
        sc += __popc((__ldg(hla + w) | __ldg(hlb + w)) &
                     (__ldg(hri + w) | __ldg(hrj + w)));
        sy += __popc((__ldg(tla + w) | __ldg(tlb + w)) ^
                     (__ldg(tri + w) | __ldg(trj + w)));
      }
      const int cand = v + sc + sy;
      if (cand > o.v || (cand == o.v && (a < o.a || (a == o.a && b < o.b)))) {
        o.v = cand;
        o.a = a;
        o.b = b;
        o.wu = wu;
        o.wv = wv;
        o.p = p;
        o.q = q;
        o.symd = sy;
        o.src = src;
      }
    }
  }
  return o;
}

// (r, i2, j2) of flat state x of [R1, k2, k2]
__device__ __forceinline__ void state_of(long long x, int k2, int& r,
                                         int& i2, int& j2) {
  const long long kk = (long long)k2 * k2;
  r = (int)(x / kk);
  const int rem = (int)(x - r * kk);
  i2 = rem / k2;
  j2 = rem - i2 * k2;
}

}  // namespace dgv
