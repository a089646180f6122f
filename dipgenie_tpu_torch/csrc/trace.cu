// K-T: the traceback, one sequential walk over every segment.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_narrow_trace` (:1914, a
// reverse lax.scan per segment over backpointers rematerialised by
// re-running the segment) and the per-segment dispatch around it. Here
// every segment's backpointers stay resident on the card, so one launch
// walks all L-1 transitions from the sink back to level 0.
//
// What bounds it on the H100: the walk is serial. Transition t's bp word
// depends on the lane the walk reached at t + 1, and its table word on that
// bp word. Read from global memory each is a miss: MHC-scale plans hold ~8
// GB of backpointers, far past the 50 MB L2 (the kernel this one replaced,
// one thread reading a host-built descriptor row, its bp word and its table
// word from global memory, took 145 ms for C's 119,999 transitions, 1.2 us
// each). The bytes the walk needs (~90 B a transition) take microseconds.
// The design takes the misses out of the chain; what is left is the
// walker's own instructions, one dependent chain in one thread.
//
// Design: one block of three warps.
// * The descriptors were made with the plan (ops/plan.py trace_columns: 8
//   int32 a transition); the launch gets one row of addresses per segment
//   (its bp arrays, chunk table, w1, symd).
// * Ring. Shared memory holds RING bytes cut into slots of SLOT bytes,
//   one transition each in walk order (t descending), with a Meta record
//   each and an mbarrier for each BATCH slots. Warp 1 is the producer: its
//   BATCH lanes take BATCH transitions at a time (one each, descriptors
//   loaded a batch ahead, the segment's addresses kept until it changes),
//   wait until the walker has freed the batch's slots, write the Meta
//   records and arrive on the batch's barrier, and issue 1-D bulk copies
//   (cp.async.bulk) that complete on it: rows [lo, hi] of the
//   transition's bp block, hi the walker's current r (published in shared
//   memory; r only falls) and lo = hi - BAND (a walk whose r falls further
//   before it gets there reads global memory), and row 0 of each of its
//   real table chunks. What does not fit the slot takes the L2 path: the
//   producer issues cp.async.bulk.prefetch.L2 for the same rows (of every
//   bp row the transition's lanes can fall in) or chunks, and the walker
//   reads its word from global memory. The choice is by size: on C the
//   narrow blocks are staged and the dense wide blocks ([R+1, NB * 1024]
//   int32) take the L2 path.
// * The walker (thread 0) reads its bp word and its packed table word from
//   the slot, the next slot's Meta record (and once a batch its barrier)
//   while the bp word is in flight, and hands {lane, packed, ordinal} to
//   the recorder through shared memory, publishing r and its progress.
// * The recorder (warp 2) turns each UNIT of those into records: the
//   divisions by bin and bout, w1 and symd read from the tables (off the
//   walker's chain), one bulk store a unit (the wrapper pads the output to
//   whole units).
// * The clamps of the plain version stay: a 256-class block clamps the
//   column, a lane past a 1024-class block steps rows (clamped to the
//   array), r < 0 reads row 0; the ordinal's chunk is its floor division
//   by 256. Only a walk from an unreachable sink needs them.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): C's whole
// plan in 25.47 ms (the launch alone) against the replaced kernel's 145.38
// ms in the same run; the narrow transitions take ~420 SM cycles each, all
// reads from shared memory (the walker's instructions), the dense ones
// ~0.75 us (two L2 reads). The design that staged only the tables and read
// every bp word after an L2 prefetch took 41.38 ms in the same run.
#include "dg_common.cuh"

namespace {

using dg::CHUNK;

// descriptor columns (ops/plan.py TRACE_COLS; C_BINS is bin | bout << 16)
enum { C_SEG, C_LANES, C_ROWS, C_BPROW, C_CB, C_NCH, C_BINS, C_FLAGS };
// address columns (ops/trace.py bases)
enum { B_BP0, B_BP1, B_TBL, B_W1, B_SY, NBASE = 6 };

constexpr int THREADS = 96;   // walker, producer, recorder
constexpr int RING = 196608;  // staging bytes
constexpr int SLOT = 6144;    // ring bytes a transition
// bp rows staged below the walk's current r: r falls by at most 2 a
// transition and, on the MHC-scale plans, at most R times in all
constexpr int BAND = 2;
constexpr int BATCH = 8;      // transitions the producer takes at a time
constexpr int NSLOT = RING / SLOT / BATCH * BATCH;  // 32
constexpr int UNIT = 64;      // records a bulk store carries
constexpr int UNIT_BYTES = UNIT * 7 * 4;
constexpr int RAW_UNITS = 4;  // units of raw records the walker runs ahead
// back-off of the producer's and the recorder's polls of the walker's
// progress, so that they leave shared memory to the walker's reads
constexpr unsigned SPIN_NS = 64;
constexpr unsigned RECORD_SPIN_NS = 1000;

// descriptor flags (ops/plan.py TRACE_FLAGS), also the Meta record's
enum { F_DENSE = 1, F_ROWSTEP = 2, F_BP1 = 4, F_BP16 = 8 };

// What the producer tells the walker about a transition. Staged: bp rows
// [lo, hi] at the slot's start (none if lo > hi), then row 0 of the first
// nst chunks at tbl_off. Global: the bp block's first row and the table at
// the transition's first chunk.
struct __align__(16) Meta {
  const char* bp;
  const int32_t* tbl;
  int lanes, rows, lo, hi;
  int nst, flags, tbl_off, pad;
};

struct Smem {
  Meta meta[NSLOT];
  unsigned long long bar[NSLOT / BATCH];  // one a batch of slots
  int4 raw[RAW_UNITS * UNIT];  // {lane, packed, slot, -} a transition
  int32_t recs[2][UNIT * 7];
  volatile int done;      // transitions the walker has finished
  volatile int r;         // the walker's current r
  volatile int rec_low;   // the lowest unit the recorder has stored
};

constexpr int SMEM_BYTES = RING + (int)sizeof(Smem);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_parity(unsigned long long* bar,
                                            uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void load_desc(const int4* desc, int t, bool on,
                                          int4 (&d)[2]) {
  if (on) {
    d[0] = __ldg(desc + (size_t)t * 2);
    d[1] = __ldg(desc + (size_t)t * 2 + 1);
  }
}

__device__ __forceinline__ int col_of(const int4 (&d)[2], int c) {
  const int4 v = d[c >> 2];
  const int j = c & 3;
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The producer's part for transition i (one lane): meta, barrier, copies.
__device__ __forceinline__ void arrive(unsigned long long* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(tx)
               : "memory");
}

__device__ __forceinline__ void stage(Smem& s, unsigned char* ring, int i,
                                      const int4 (&d)[2],
                                      const long long (&b)[NBASE], int R1,
                                      int rnow, unsigned long long* bar) {
  const int si = i % NSLOT;
  unsigned char* sp = ring + (size_t)si * SLOT;
  const int lanes = col_of(d, C_LANES), flags = col_of(d, C_FLAGS);
  const int rows = col_of(d, C_ROWS), bout = col_of(d, C_BINS) >> 16;
  const int nch = col_of(d, C_NCH);
  const bool rowstep = (flags & F_ROWSTEP) != 0;
  const size_t rowbytes = (size_t)lanes * ((flags & F_BP16) ? 2 : 4);
  const char* bpa = (const char*)((flags & F_BP1) ? b[B_BP1] : b[B_BP0]) +
                    (size_t)col_of(d, C_BPROW) * R1 * rowbytes;
  const int32_t* tbl =
      (const int32_t*)b[B_TBL] + (size_t)col_of(d, C_CB) * 2 * CHUNK;

  const int hi = min(max(rnow, 0), R1 - 1);
  const int lo = max(hi - BAND, 0);
  // the bp rows of the array the transition's lanes [0, bout^2) fall in
  const int nwin = rowstep ? min((bout * bout + lanes - 1) / lanes, rows) : 1;
  const uint32_t bpbytes = (uint32_t)((hi - lo + 1) * rowbytes);
  const bool sbp = nwin == 1 && bpbytes <= (uint32_t)SLOT && aligned16(bpa);
  const uint32_t bpst = sbp ? bpbytes : 0;
  const bool stbl = nch > 0 &&
                    bpst + (uint32_t)nch * CHUNK * 4 <= (uint32_t)SLOT &&
                    aligned16(tbl);
  const int nst = stbl ? nch : 0;

  Meta& m = s.meta[si];
  m.bp = bpa;
  m.tbl = tbl;
  m.lanes = lanes;
  m.rows = rows;
  m.lo = sbp ? lo : hi + 1;
  m.hi = hi;
  m.nst = nst;
  m.flags = flags;
  m.tbl_off = (int)bpst;
  // release: the walker's wait on this phase sees the Meta record
  arrive(bar, bpst + (uint32_t)nst * CHUNK * 4);
  if (sbp) {
    bulk_load(sp, bpa + lo * rowbytes, bpst, bar);
  } else if (aligned16(bpa)) {
    for (int w = 0; w < nwin; ++w)
      prefetch_l2(bpa + ((size_t)w * R1 + lo) * rowbytes, bpbytes);
  }
  if (nst) {
    for (int c = 0; c < nst; ++c)
      bulk_load(sp + bpst + c * CHUNK * 4, tbl + (size_t)c * 2 * CHUNK,
                CHUNK * 4, bar);
  } else if (nch > 0 && aligned16(tbl)) {
    prefetch_l2(tbl, nch * CHUNK * 8);
  }
}

// The producer (lanes 0 .. BATCH - 1 of warp 1).
__device__ void produce(Smem& s, unsigned char* ring, const int4* desc,
                        const long long* base, int T, int R1, int lane) {
  int4 d[2], dn[2];
  long long b[NBASE] = {};
  int seg = -1;
  load_desc(desc, T - 1 - lane, lane < T, dn);
  for (int i0 = 0; i0 < T; i0 += BATCH) {
    const int i = i0 + lane;
    const bool on = i < T;
    d[0] = dn[0];
    d[1] = dn[1];
    load_desc(desc, T - 1 - (i + BATCH), i + BATCH < T, dn);
    if (on && col_of(d, C_SEG) != seg) {
      seg = col_of(d, C_SEG);
#pragma unroll
      for (int k = 0; k < NBASE; ++k)
        b[k] = __ldg(base + (size_t)seg * NBASE + k);
    }
    // the batch's slots are free once the walker has finished the
    // transitions NSLOT before them
    const int need = min(i0 + BATCH, T) - NSLOT;
    while (s.done < need) __nanosleep(SPIN_NS);
    const int rnow = s.r;
    // the batch's barrier takes one arrival from each of the BATCH lanes
    unsigned long long* bar = &s.bar[(i0 / BATCH) % (NSLOT / BATCH)];
    if (on)
      stage(s, ring, i, d, b, R1, rnow, bar);
    else
      arrive(bar, 0);
  }
}

// The recorder (warp 2): unit u's raw triples {lane, packed, slot} of
// transitions [64u, 64u + 64) become the records (gidx / bin, gidx % bin,
// lane / bout, lane % bout, w1, wsum - w1, symd), w1 and symd read from the
// tables, and leave in one bulk store.
__device__ void record(Smem& s, const int4* desc, const long long* base,
                       int T, int32_t* recs, int lane) {
  const int top = (T - 1) / UNIT;
  for (int u = top; u >= 0; --u) {
    while (s.done < T - u * UNIT) __nanosleep(RECORD_SPIN_NS);
    int32_t* buf = s.recs[u & 1];
    for (int j = lane; j < UNIT; j += 32) {
      const int t = u * UNIT + j;
      if (t >= T) continue;  // the wrapper's padding rows
      int4 d[2];
      load_desc(desc, t, true, d);
      const int4 raw = s.raw[t % (RAW_UNITS * UNIT)];
      const long long* b = base + (size_t)col_of(d, C_SEG) * NBASE;
      const int packed = raw.y, slotv = raw.z, dl = raw.x;
      const int gidx = (col_of(d, C_FLAGS) & F_DENSE) ? ((packed >> 17) & 32767)
                                                      : (packed >> 13);
      const long long k = (long long)(col_of(d, C_CB) + (slotv >> 8)) * CHUNK +
                          (slotv & (CHUNK - 1));
      const int w1 = __ldg((const int8_t*)__ldg(b + B_W1) + k);
      const int sy = __ldg((const int16_t*)__ldg(b + B_SY) + k);
      const int bin = col_of(d, C_BINS) & 0xFFFF;
      const int bout = col_of(d, C_BINS) >> 16;
      int32_t* o = buf + j * 7;
      o[0] = gidx / bin;
      o[1] = gidx % bin;
      o[2] = dl / bout;
      o[3] = dl % bout;
      o[4] = w1;
      o[5] = (packed & 3) - w1;
      o[6] = sy;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              recs + (size_t)u * UNIT * 7),
          "r"(smem_addr(buf)), "r"(UNIT_BYTES)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the other buffer's store has read it before unit u - 1 fills it
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      s.rec_low = u;
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
trace_kernel(const int4* __restrict__ desc, const long long* __restrict__ base,
             int T, int R, int32_t* recs) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  Smem& s = *reinterpret_cast<Smem*>(smem + RING);
  const int R1 = R + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int top = (T - 1) / UNIT;

  if (tid == 0) {
    for (int k = 0; k < NSLOT / BATCH; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&s.bar[k])),
                   "r"(BATCH)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s.done = 0;
    s.r = R;
    s.rec_low = top + 1;
  }
  __syncthreads();

  if (warp == 1) {
    if (lane < BATCH)
      produce(s, ring, desc, base, T, R1, lane);
    return;
  }
  if (warp == 2) {
    record(s, desc, base, T, recs, lane);
    return;
  }
  if (tid != 0) return;

  // the walker: transition i's chain is its bp word (from the lane), then
  // its packed table word; the next slot's Meta record (and once a batch
  // its barrier) is read while the bp word is in flight
  int dl = 0, r = R, si = 0;
  uint32_t parity = 0;  // of the batch barrier of slot si
  wait_parity(&s.bar[0], 0);
  Meta m = s.meta[0];
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    // a unit's raw triples overwrite those of the unit RAW_UNITS above it
    if (((t & (UNIT - 1)) == UNIT - 1 || i == 0) &&
        t / UNIT + RAW_UNITS <= top) {
      while (s.rec_low > t / UNIT + RAW_UNITS) {
      }
    }
    const unsigned char* sp = ring + (size_t)si * SLOT;
    int rowoff = 0, col;
    if (m.flags & F_ROWSTEP) {
      rowoff = dl / m.lanes;
      col = dl - rowoff * m.lanes;
      rowoff = min(rowoff, m.rows - 1);
    } else {
      col = min(dl, m.lanes - 1);
    }
    const int rr = max(r, 0);
    const bool bp16 = (m.flags & F_BP16) != 0;
    int slotv;
    if (rowoff == 0 && rr >= m.lo && rr <= m.hi) {
      const size_t k = (size_t)(rr - m.lo) * m.lanes + col;
      slotv = bp16 ? (int)((const int16_t*)sp)[k] : ((const int32_t*)sp)[k];
    } else {
      const size_t k = ((size_t)rowoff * R1 + rr) * m.lanes + col;
      slotv = bp16 ? (int)__ldg((const int16_t*)m.bp + k)
                   : __ldg((const int32_t*)m.bp + k);
    }
    int sn = si + 1;
    uint32_t pn = parity;
    if (sn == NSLOT) {
      sn = 0;
      pn ^= 1;
    }
    Meta mn = m;
    if (i + 1 < T) {
      if (sn % BATCH == 0) {  // the next batch's copies have landed
        wait_parity(&s.bar[sn / BATCH], pn);
      }
      mn = s.meta[sn];
    }
    // the plain version's floor division of the ordinal by 256
    const int crow = slotv >> 8;
    const int lc = slotv & (CHUNK - 1);
    const bool staged = crow >= 0 && crow < m.nst;
    const int packed =
        staged ? ((const int32_t*)(sp + m.tbl_off))[crow * CHUNK + lc]
               : __ldg(m.tbl + (long long)crow * 2 * CHUNK + lc);
    s.raw[t & (RAW_UNITS * UNIT - 1)] = make_int4(dl, packed, slotv, 0);
    dl = (m.flags & F_DENSE) ? ((packed >> 17) & 32767) : (packed >> 13);
    r -= packed & 3;
    // every read of this slot is done (its values are in registers): free
    // it, and hand the raw triple to the recorder
    asm volatile("" ::: "memory");
    s.r = r;
    s.done = i + 1;
    si = sn;
    parity = pn;
    m = mn;
  }
}

}  // namespace

// desc [T, 8] int32 (DevPlan.desc), base [segments, 6] int64 (trace.py
// bases); recs [ceil(T / 64) * 64, 7] int32.
extern "C" int dg_trace(const int4* desc, const long long* base, int T, int R,
                        int32_t* recs, cudaStream_t stream) {
  if (T <= 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  trace_kernel<<<1, THREADS, SMEM_BYTES, stream>>>(desc, base, T, R, recs);
  return (int)cudaGetLastError();
}
