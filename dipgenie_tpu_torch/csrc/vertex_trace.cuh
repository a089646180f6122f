// The tracebacks of the per-vertex DP tiers: K14 fused_trace (fused_dp.cu,
// the fused tier's codes) and K16 chunk_trace (chunk_dp.cu, a span of the
// chunked tier's packed words), one staged walk (csrc/trace.cu's design).
//
// The walk is serial: transition t's word lies at (r, i2, j2) of its
// [R+1, k2, k2] block, and (i2, j2, r) come from transition t + 1's word.
// Read from global memory every step is a miss or an L2 round trip (C's
// codes are ~1 GB); the bytes a step needs are a few. The design takes the
// reads off the chain: what is left is the walker's own instructions.
//
// One block of three warps:
// * Producer (warp 1). Its BATCH lanes take BATCH transitions at a time in
//   walk order (t descending), descriptors loaded a batch ahead, wait until
//   the walker has freed the batch's ring slots, write a Meta record a
//   transition, arrive on the batch's mbarrier, and bulk-copy
//   (cp.async.bulk) into the slot the 16-byte-aligned span around rows
//   [r - BAND, r] of the transition's block (r the walker's row, published
//   a batch at a time; it only falls, by at most 2 a transition) and, for
//   K14, around its [k2, P] slot table. What does not fit a slot (and
//   K14's int32 codes) takes the L2 path: cp.async.bulk.prefetch.L2 of the
//   same rows (up to PREFETCH_MAX bytes) and the walker reads global
//   memory.
// * Walker (thread 0), a batch at a time: it waits on the batch's barrier,
//   reads the batch's eight records into registers, and takes the eight
//   steps unrolled, with no branch between them. A step's chain is one
//   shared-memory read of the word (K16) or code (K14) at an address two
//   multiply-adds from (r, i2, j2); K14 then takes p = code / P as a
//   multiply-high by the producer's reciprocal and reads the two slot
//   words. The row (a, b, wu, wv) goes into the ring block of its unit of
//   UNIT steps; r and the progress are published once a batch. r is
//   clamped to 0, which only a walk from an unreachable sink needs.
// * Recorder (warp 2). Each finished unit leaves by one bulk store from its
//   ring block. For K14 its lanes first add the unit's popcount((Tl[a] |
//   Tl[b]) ^ (Tr[i2] | Tr[j2])) (i2, j2 the next row's sources, the sink
//   pair (0, 0) for the last): s_het is an exact integer sum, off the
//   walker's chain.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W; the walker's
// clock64 stamps): a staged step ~229 SM cycles for K14, ~123 for K16, and
// ~300 more at the first step of a batch (its barrier and its records); a
// step through L2 ~660 (K14). A step's chain alone is ~100 cycles: the
// bookkeeping and taken branches of a step at a time (a record read and
// the progress published every step: ~465 / ~335 cycles), not the reads,
// set the pace; hence the unrolled batch.
#pragma once

#include "vertex_dp.cuh"

namespace dgt {

using dg::ring::smem_addr;
using dgv::DESC_COLS;

constexpr int THREADS = 96;   // walker, producer, recorder
constexpr int RING = 196608;  // staging bytes
constexpr int SLOT = 6144;    // ring bytes a transition
constexpr int BAND = 2;       // rows staged below the walker's r
constexpr int BATCH = 8;      // transitions the producer takes at a time
constexpr int NSLOT = RING / SLOT / BATCH * BATCH;  // 32
constexpr int UNIT = 64;      // rows a bulk store carries
constexpr int RAW_UNITS = 4;  // units of rows the walker runs ahead
constexpr long long PREFETCH_MAX = 1 << 18;  // bytes of an L2 prefetch
// back-off of the producer's and the recorder's polls of the walker
constexpr unsigned SPIN_NS = 64;
constexpr unsigned RECORD_SPIN_NS = 256;

// What the producer tells the walker about a transition. Its fast path
// reads element x = (r * k2 + i2) * k2 + j2 of the block at ring offset
// coff + x * (2 or 4) (coff wraps: it is the offset of element 0 as if
// the whole block were staged) where r - lo <= span (unsigned), and K14's
// slot words at ring offset toff; the rest of a transition takes the L2
// path (global memory).
struct __align__(16) Meta {
  uint32_t coff;  // the staged rows' element 0 (wrapping)
  int lo;         // the first staged row (NO_ROWS: none)
  uint32_t span;  // staged rows - 1
  int k2;
  uint32_t toff;  // K14: the staged slot table (NO_TABLE: none)
  uint32_t rcp;   // K14: ceil(2^32 / P) for P in 2 .. 256, else 0
  uint32_t pone;  // K14: all ones for P = 1, else 0
  int P;
  int cb;         // K14: code bytes (2, or 4 past 256 slots)
  const char* src;       // the block [R+1, k2, k2], global
  const int32_t* slots;  // K14: the [k2, P] slot table, global
};

constexpr int NO_ROWS = -(1 << 30);
constexpr uint32_t NO_TABLE = 0xFFFFFFFFu;

constexpr int NBAR = NSLOT / BATCH;  // one barrier a batch of slots

struct Smem {
  Meta meta[NSLOT];
  uint64_t bar[NBAR];
  int4 rows[RAW_UNITS * UNIT];  // (a, b, wu, wv) a transition
  volatile int done;   // walk steps finished (a batch at a time)
  volatile int r;      // the walker's r after them
  volatile int freed;  // units whose stores have read their rows
};

constexpr int SMEM_BYTES = RING + (int)sizeof(Smem);

struct Args {
  const long long* desc;  // desc_dev [T, DESC_COLS] of the plan
  const char* blk;        // the blocks: K14 codes, K16 words
  const char* blk_end;    // the end of their buffer
  const int32_t* pred;    // K14: the slot tables
  const int32_t* pred_end;
  const uint32_t* masks;  // K14: the colour words
  const long long* woff;  // K16: each transition's first word, plan-wide
  int t0, T, R;           // transitions t0 .. t0 + T - 1; K14's start r
  int32_t* carry;         // K16: (i2, j2, r) in and out
  int32_t* rows;          // [T, 4], 16-byte aligned
  int32_t* sh;            // K14: s_het
  int32_t* cyc;           // or null: the walker's cycles a step << 1 | staged
};

__device__ __forceinline__ const char* align_down(const char* p) {
  return (const char*)((uintptr_t)p & ~(uintptr_t)15);
}

__device__ __forceinline__ const char* align_up(const char* p) {
  return (const char*)(((uintptr_t)p + 15) & ~(uintptr_t)15);
}

// The 16-byte-aligned span [*a0, *a1) around [lo, hi), clipped to the
// whole 16-byte units inside [beg, end); false where it leaves them.
__device__ __forceinline__ bool span(const char* lo, const char* hi,
                                     const char* beg, const char* end,
                                     const char** a0, const char** a1) {
  *a0 = align_down(lo);
  *a1 = align_up(hi);
  return *a0 >= align_up(beg) && *a1 <= align_down(end);
}

__device__ __forceinline__ const char* pmax(const char* a, const char* b) {
  return a > b ? a : b;
}

__device__ __forceinline__ const char* pmin(const char* a, const char* b) {
  return a < b ? a : b;
}

// An L2 prefetch of the 16-byte units [a0, a1), up to PREFETCH_MAX bytes.
__device__ __forceinline__ void prefetch_l2(const char* a0, const char* a1) {
  if (a1 > a0 && a1 - a0 <= PREFETCH_MAX)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a0),
                 "r"((uint32_t)(a1 - a0))
                 : "memory");
}

// What a producer lane reads of transition t's descriptors: the block's
// width, K14's in-degree and slot table offset, and the block's first
// byte.
struct Desc {
  long long k2, P, po, off;
};

template <bool FUSED>
__device__ __forceinline__ Desc load_desc(const Args& g, int t, bool on,
                                          long long base) {
  Desc d = {1, 1, 0, 0};
  if (!on) return d;
  const long long* row = g.desc + (long long)(g.t0 + t) * DESC_COLS;
  d.k2 = __ldg(row + dgv::D_K2);
  if (FUSED) {
    d.P = __ldg(row + dgv::D_P);
    d.po = __ldg(row + dgv::D_PRED);
    d.off = __ldg(row + dgv::D_BP);
  } else {
    d.off = 4 * (__ldg(g.woff + g.t0 + t) - base);
  }
  return d;
}

// The producer's part for walk step i (one lane): Meta, arrival, copies.
// K14 stages 16-bit codes only: int32 codes (past 256 slots) take the L2
// path.
template <bool FUSED>
__device__ __forceinline__ void stage(Smem& s, unsigned char* ring,
                                      const Args& g, int i, const Desc& d,
                                      int rnow, uint64_t* bar) {
  const int si = i % NSLOT;
  unsigned char* sp = ring + (size_t)si * SLOT;
  const uint32_t base = (uint32_t)si * SLOT;  // the slot's ring offset
  const int cb = FUSED && d.P > dgv::CODE16_SLOTS ? 4 : (FUSED ? 2 : 4);
  const long long row = d.k2 * d.k2 * cb;  // bytes of a row of the block
  const char* src = g.blk + d.off;
  const int hi = max(rnow, 0), lo = max(hi - BAND, 0);
  const char *c0, *c1, *p0 = nullptr, *p1 = nullptr;
  const bool in = span(src + lo * row, src + (hi + 1) * row, g.blk,
                       g.blk_end, &c0, &c1);
  const bool sc = in && c1 - c0 <= SLOT && (!FUSED || cb == 2);
  const uint32_t cbytes = sc ? (uint32_t)(c1 - c0) : 0;
  bool sp_ok = false;
  const int32_t* slots = nullptr;
  if (FUSED) {
    slots = g.pred + d.po;
    sp_ok = span((const char*)slots, (const char*)(slots + d.k2 * d.P),
                 (const char*)g.pred, (const char*)g.pred_end, &p0, &p1) &&
            cbytes + (p1 - p0) <= SLOT;
  }
  const uint32_t pbytes = sp_ok ? (uint32_t)(p1 - p0) : 0;

  Meta& m = s.meta[si];
  m.coff = base + (uint32_t)(long long)(src - c0);
  m.lo = sc ? lo : NO_ROWS;
  m.span = sc ? (uint32_t)(hi - lo) : 0u;
  m.k2 = (int)d.k2;
  if (FUSED) {
    const uint32_t P = (uint32_t)d.P;
    m.toff = sp_ok ? base + cbytes + (uint32_t)((const char*)slots - p0)
                   : NO_TABLE;
    m.rcp = cb == 2 && P >= 2 ? 0xFFFFFFFFu / P + 1 : 0u;
    m.pone = P == 1 ? 0xFFFFFFFFu : 0u;
    m.P = (int)P;
    m.cb = cb;
    m.slots = slots;
  }
  m.src = src;
  // release: the walker's wait on this phase sees the Meta record
  dg::ring::expect_bytes(bar, cbytes + pbytes);
  if (sc) {
    dg::ring::bulk_load(sp, c0, cbytes, bar);
  } else {
    prefetch_l2(pmax(c0, align_up(g.blk)), pmin(c1, align_down(g.blk_end)));
  }
  if (sp_ok) {
    dg::ring::bulk_load(sp + cbytes, p0, pbytes, bar);
  } else if (FUSED) {
    const char* q0 = align_down((const char*)slots);
    const char* q1 = align_up((const char*)(slots + d.k2 * d.P));
    prefetch_l2(pmax(q0, align_up((const char*)g.pred)),
                pmin(q1, align_down((const char*)g.pred_end)));
  }
}

// The producer (lanes 0 .. BATCH - 1 of warp 1).
template <bool FUSED>
__device__ void produce(Smem& s, unsigned char* ring, const Args& g,
                        int lane) {
  const int T = g.T;
  const long long base = FUSED ? 0 : __ldg(g.woff + g.t0);
  Desc dn = load_desc<FUSED>(g, T - 1 - lane, lane < T, base);
  for (int i0 = 0; i0 < T; i0 += BATCH) {
    const int i = i0 + lane;
    const Desc d = dn;
    dn = load_desc<FUSED>(g, T - 1 - (i + BATCH), i + BATCH < T, base);
    // the batch's slots are free once the walker has finished the
    // transitions NSLOT before them
    const int need = min(i0 + BATCH, T) - NSLOT;
    while (s.done < need) __nanosleep(SPIN_NS);
    const int rnow = s.r;
    // the batch's barrier takes one arrival from each of the BATCH lanes
    uint64_t* bar = &s.bar[(i0 / BATCH) % (NSLOT / BATCH)];
    if (i < T)
      stage<FUSED>(s, ring, g, i, d, rnow, bar);
    else
      dg::ring::expect_bytes(bar, 0);
  }
}

// K14's popcount of transition t of the path: (a, b) its sources, (i2,
// j2) its destinations.
__device__ __forceinline__ unsigned shet_of(const Args& g, int t, int a,
                                            int b, int i2, int j2) {
  const long long* row = g.desc + (long long)(g.t0 + t) * DESC_COLS;
  const long long k = __ldg(row + dgv::D_K), k2 = __ldg(row + dgv::D_K2);
  const long long W = __ldg(row + dgv::D_W);
  const uint32_t* tl = g.masks + __ldg(row + dgv::D_MASK) + k * W;
  const uint32_t* tr = tl + (k + k2) * W;
  unsigned n = 0;
  for (long long w = 0; w < W; ++w)
    n += __popc((__ldg(tl + a * W + w) | __ldg(tl + b * W + w)) ^
                (__ldg(tr + i2 * W + w) | __ldg(tr + j2 * W + w)));
  return n;
}

// Walk step i (transition t = T - 1 - i) belongs to unit k = i / UNIT,
// whose rows [unit_lo, T - k * UNIT) lie in ring block k % RAW_UNITS, row t
// at t - unit_lo.
__device__ __forceinline__ int unit_lo(int T, int k) {
  return max(T - (k + 1) * UNIT, 0);
}

// The recorder (warp 2): each unit's rows leave in one bulk store from the
// ring, after (K14) their popcounts are added; a transition's destination
// pair is the row after it, for the unit's last row the first row of the
// unit before in walk order (kept from there), for t = T - 1 the sink.
template <bool FUSED>
__device__ void record(Smem& s, const Args& g, int lane) {
  const int T = g.T;
  unsigned long long sh = 0;
  int pa = 0, pb = 0;
  for (int k = 0; k * UNIT < T; ++k) {
    const int lo = unit_lo(T, k), n = T - k * UNIT - lo;
    while (s.done < min((k + 1) * UNIT, T)) __nanosleep(RECORD_SPIN_NS);
    const int4* blk = s.rows + (k % RAW_UNITS) * UNIT;
    if (FUSED) {
      for (int p = lane; p < n; p += 32) {
        const int4 x = blk[p];
        const int4 y = p + 1 < n ? blk[p + 1] : make_int4(pa, pb, 0, 0);
        sh += shet_of(g, lo + p, x.x, x.y, y.x, y.y);
      }
      pa = blk[0].x;
      pb = blk[0].y;
    }
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              g.rows + (size_t)lo * 4),
          "r"(smem_addr(blk)), "r"(n * 16)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // every store but this one has read its rows: their blocks are free
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      s.freed = k;
    }
    __syncwarp();
  }
  if (FUSED) {
    for (int o = 16; o > 0; o >>= 1) sh += __shfl_down_sync(~0u, sh, o);
  }
  if (lane == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    if (FUSED) *g.sh = (int32_t)(uint32_t)sh;
  }
}

// The fast part of a Meta record, in registers a batch at a time.
struct Fast {
  uint32_t coff;
  int lo;
  uint32_t span;
  int k2;
  uint32_t toff, rcp, pone;
  int P;
};

template <bool FUSED>
__device__ __forceinline__ Fast fast_of(const Meta& m) {
  Fast f;
  const int4 a = *reinterpret_cast<const int4*>(&m);
  f.coff = (uint32_t)a.x;
  f.lo = a.y;
  f.span = (uint32_t)a.z;
  f.k2 = a.w;
  if (FUSED) {
    const int4 b = *(reinterpret_cast<const int4*>(&m) + 1);
    f.toff = (uint32_t)b.x;
    f.rcp = (uint32_t)b.y;
    f.pone = (uint32_t)b.z;
    f.P = b.w;
  }
  return f;
}

// The word (K16) or code (K14) at (r, i2, j2) of a transition the
// producer did not stage, from global memory.
template <bool FUSED>
__device__ __forceinline__ int word_l2(const char* src, int cb, int k2, int r,
                                       int i2, int j2) {
  const long long x = ((long long)r * k2 + i2) * k2 + j2;
  if (FUSED && cb == 2) return __ldg((const uint16_t*)src + x);
  return __ldg((const int32_t*)src + x);
}

// One step of the walk on slot si's transition: from (r, i2, j2) its row
// (a, b, wu, wv). The reads where the producer staged the transition come
// from the ring; the rest (the L2 path, int32 codes, a slot word outside
// the staged table) read global memory through the slot's Meta record.
template <bool FUSED>
__device__ __forceinline__ int4 step(const Smem& s, const unsigned char* ring,
                                     const Fast& f, int si, int r, int i2,
                                     int j2, bool& sc) {
  const uint32_t x = ((uint32_t)r * f.k2 + i2) * f.k2 + j2;
  sc = (uint32_t)(r - f.lo) <= f.span;
  int word;
  if (__builtin_expect(sc, 1)) {
    word = FUSED ? (int)*(const uint16_t*)(ring + (f.coff + 2u * x))
                 : *(const int32_t*)(ring + (f.coff + 4u * x));
  } else {
    const Meta& m = s.meta[si];
    word = word_l2<FUSED>(m.src, FUSED ? m.cb : 4, f.k2, r, i2, j2);
  }
  if (!FUSED)
    return make_int4(word & 0xFFF, (word >> 12) & 0xFFF, (word >> 24) & 1,
                     (word >> 25) & 1);
  // p = code / P: a multiply-high by ceil(2^32 / P) is exact for codes
  // below 2^16 and P up to 256 (P = 1: p = code); int32 codes divide
  const uint32_t code = (uint32_t)word;
  const uint32_t p = __builtin_expect(f.rcp != 0 || f.pone != 0, 1)
                         ? __umulhi(code, f.rcp) + (code & f.pone)
                         : code / (uint32_t)f.P;
  const uint32_t q = code - p * (uint32_t)f.P;
  const uint32_t ia = (uint32_t)i2 * f.P + p, ib = (uint32_t)j2 * f.P + q;
  const uint32_t n = (uint32_t)(f.k2 * f.P);
  int ep, eq;
  if (__builtin_expect(f.toff != NO_TABLE && ia < n && ib < n, 1)) {
    ep = *(const int32_t*)(ring + (f.toff + 4u * ia));
    eq = *(const int32_t*)(ring + (f.toff + 4u * ib));
  } else {
    const int32_t* slots = s.meta[si].slots;
    ep = __ldg(slots + ia);
    eq = __ldg(slots + ib);
  }
  return make_int4(ep >> 1, eq >> 1, ep & 1, eq & 1);
}

// The walk kernel; with STAMP the walker writes g.cyc.
template <bool FUSED, bool STAMP>
__global__ void __launch_bounds__(THREADS, 1) walk_kernel(Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  Smem& s = *reinterpret_cast<Smem*>(smem + RING);
  const int T = g.T, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    dg::ring::init(s.bar, NBAR, BATCH);
    s.done = 0;
    s.r = FUSED ? g.R : g.carry[2];
    s.freed = 0;
  }
  __syncthreads();

  if (warp == 1) {
    if (lane < BATCH) produce<FUSED>(s, ring, g, lane);
    return;
  }
  if (warp == 2) {
    record<FUSED>(s, g, lane);
    return;
  }
  if (tid != 0) return;

  // the walker, a batch of BATCH steps at a time (their slots' fast
  // records read into registers after the batch's barrier, the steps
  // unrolled), a unit of UNIT steps (its ring block) at a time: a step's
  // chain is the word's (or code's) shared-memory read at an address two
  // multiply-adds from (r, i2, j2), then for K14 a multiply-high, a
  // multiply-add and the two slot words' reads
  int i2 = 0, j2 = 0, r = s.r;
  if (!FUSED) {
    i2 = g.carry[0];
    j2 = g.carry[1];
  }
  long long c0 = STAMP ? clock64() : 0;
  for (int k = 0; k * UNIT < T; ++k) {
    const int lo = unit_lo(T, k), end = min((k + 1) * UNIT, T);
    int4* blk = s.rows + (k % RAW_UNITS) * UNIT;
    // the block's rows of unit k - RAW_UNITS have been read by its store
    while (s.freed < k - RAW_UNITS + 1) {
    }
    for (int i0 = k * UNIT; i0 < end; i0 += BATCH) {
      const int b = i0 / BATCH, si0 = (b % NBAR) * BATCH;
      dg::ring::wait(&s.bar[b % NBAR], (b / NBAR) & 1);
      const int nb = min(BATCH, T - i0);
      auto walk1 = [&](const Fast& f, int j) {
        bool sc;
        const int4 row = step<FUSED>(s, ring, f, si0 + j, r, i2, j2, sc);
        const int t = T - 1 - (i0 + j);
        blk[t - lo] = row;
        i2 = row.x;
        j2 = row.y;
        r = max(r - row.z - row.w, 0);
        if (STAMP) {
          const long long c1 = clock64();
          g.cyc[t] = (int32_t)((c1 - c0) << 1) | (int32_t)sc;
          c0 = c1;
        }
      };
      if (__builtin_expect(nb == BATCH, 1)) {
        Fast f[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          f[j] = fast_of<FUSED>(s.meta[si0 + j]);
#pragma unroll
        for (int j = 0; j < BATCH; ++j) walk1(f[j], j);
      } else {  // the walk's last batch
        for (int j = 0; j < nb; ++j)
          walk1(fast_of<FUSED>(s.meta[si0 + j]), j);
      }
      if (i0 + nb == end) {
        // the unit is whole: its rows are visible to the recorder's reads
        // and to its bulk store (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __threadfence_block();
      }
      // every read of the batch's slots is done (their values are in
      // registers): free them, and hand the rows on
      asm volatile("" ::: "memory");
      s.r = r;
      s.done = i0 + nb;
    }
  }
  if (!FUSED) {
    g.carry[0] = i2;
    g.carry[1] = j2;
    g.carry[2] = r;
  }
}

template <bool FUSED, bool STAMP>
inline int launch_as(const Args& g, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      walk_kernel<FUSED, STAMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  walk_kernel<FUSED, STAMP><<<1, THREADS, SMEM_BYTES, stream>>>(g);
  return (int)cudaGetLastError();
}

// One launch of the walk over transitions t0 .. t0 + T - 1.
template <bool FUSED>
inline int launch_walk(const Args& g, cudaStream_t stream) {
  if (g.T < 0 || g.R < 0 || ((uintptr_t)g.rows & 15))
    return (int)cudaErrorInvalidValue;
  if (g.T == 0) return 0;
  return g.cyc ? launch_as<FUSED, true>(g, stream)
               : launch_as<FUSED, false>(g, stream);
}

}  // namespace dgt
