// K1: one run of narrow pair-DP transitions.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_narrow_kernel` (:861,
// launched by `_narrow_call`). The TPU kernel gathered with one-hot MXU
// matmuls over balanced s8 digit planes and took the per-destination max
// with a lane-roll segmented scan. Here the gather is an indexed
// shared-memory load and the max is a walk over each destination's pairs.
//
// The traffic it was designed for: the MHC-shaped plan of chip_smoke.py's
// phase C (R = 18, 116,099 narrow transitions in 301 runs) has 100 real
// pairs per transition at the median (mean 124, p99 441, max 1,089), 1.07
// chunks of 256 pairs on average (at most 5), a destination extent of 256
// lanes in all but 436 transitions, and at most 9 pairs into one
// destination at the median transition (p99 64, max 361).
//
// What bounds it on the H100: the level chain is serial (each transition
// reads the state the previous one wrote), and a transition is ~2.4k
// candidates, 2 KB of tables in and 10 KB of backpointers out: far below
// what the card moves or computes in the time one block needs for it. The
// cost is latency and issue per transition on one SM: two block barriers
// (one more per extra block of rows), the longest walk of the block (the
// most pairs into one destination; each pair one shared-memory load of
// its table words and one load of V per row), and the instructions every
// warp runs around them.
//
// Design: ONE block of 1,024 threads walks every transition of the run
// (one launch per run; the TPU kernel's sequential grid is a loop in the
// block).
// * State. V [R+1, lanes] int32, lanes the run's widest extent, lives in
//   dynamic shared memory where it fits (86 KB at R = 18 and 1,024 lanes,
//   21 KB at C's usual 256), else in global memory (the same code with
//   kSharedV false: R has no upper limit). It is updated in place, with two
//   rows of NEG below row 0 so that a source row r - wsum < 0 needs no
//   test. Lanes [hi, lanes) are known to hold NEG, so a transition writes
//   only lanes below max(hi, its real destination lanes).
// * Max without atomics. The planner sorts a transition's pairs by
//   destination over the whole transition and pads only at its end, so
//   the pairs of one destination are one contiguous range. Thread (g, d)
//   owns destination lane d on rows g, g + G, ... (G = 1024 / OUT row
//   groups, RPT rows a thread per block of rows; consecutive warps take
//   consecutive groups, so the low lanes that hold a narrow level's pairs
//   spread over the SM's four schedulers): it walks d's range in plan
//   order, two pairs a step, and keeps the first maximum (a strict `>`)
//   with its pair ordinal in registers. Blocks of rows run from the top
//   row down: the walk of a block reads only its own rows and the two
//   below it, so after one barrier it can write its rows while the next
//   (lower) block is walked.
// * Ranges. The first and one-past-last pair of each destination come from
//   a boundary pass over the staged table words (a pair whose successor
//   has another destination ends its range and starts the next one), into
//   one of two buffers of [1024] uint16 each; a transition clears the
//   entries it used at its commit.
// * Staging. The highest threads, idle in the walk of a narrow level,
//   store the next transition's words (loaded into their registers a
//   transition earlier) into the other of two shared-memory buffers and
//   run its boundary pass while this transition is walked, then load the
//   words of the one after it. Descriptors {first chunk, real pairs, OUT |
//   real destination lanes << 16, bp row} reach a ring in shared memory
//   by cp.async, which no thread waits on. A transition of more than STAGE
//   pairs (8 chunks) is walked straight from global memory, its boundary
//   pass reading global memory too (kept out of the loop's code).
// * Backpointers start zeroed; a thread writes an ordinal only where it is
//   not 0, as int16 stores coalesced over destinations. The forward pass
//   never reads them back.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): 2.44 us a
// narrow transition on C against the replaced kernel's 4.64 in the same
// run. The replaced kernel kept V and the keys in global memory,
// max-reduced with 64-bit L2 atomics and swapped every key back with
// atomicExch; those three cost 0.24 us of its 4.64 together. Of the new
// kernel's time the walks take about half; the other half is the code every
// warp runs per transition, and the commit.
#include "dg_common.cuh"

namespace {

using dg::CHUNK;
using dg::NEG;
using dg::REACH_T;

constexpr int THREADS = 1024;
constexpr int STAGE = 2048;    // pair lanes staged in shared memory
constexpr int PER = STAGE / THREADS;  // staged lanes a thread holds
constexpr int RPT = 5;         // rows a thread walks per block of rows
constexpr int UNROLL = 2;      // pairs a walk takes at a time
constexpr int RING = 8;        // descriptor ring
constexpr int MAX_LANES = 1024;
constexpr int NONE = -2147483647 - 1;  // no valid candidate yet

// the dynamic shared-memory layout: the ring, the staged {packed, score}
// words of two transitions, two pairs of range buffers, then V
constexpr int RING_BYTES = RING * 16;
constexpr int STAGE_BYTES = 2 * STAGE * 8;  // two transitions
constexpr int RANGE_BYTES = 2 * 2 * MAX_LANES * 2;
constexpr int FIXED_BYTES = RING_BYTES + STAGE_BYTES + RANGE_BYTES;

__device__ __forceinline__ int dst_of(int packed) {
  return ((packed >> 2) & 2047) - 1;  // -1 on padded lanes
}

__device__ __forceinline__ const int32_t* word(const int32_t* tbl, int c0,
                                                int p) {
  return tbl + ((size_t)(c0 + (p >> 8)) * 2) * CHUNK + (p & (CHUNK - 1));
}

// One end of a range: pair p (packed word pk) is followed by a pair with
// word pkn (0 past the transition's last pair, which decodes as a pad).
__device__ __forceinline__ void mark(int p, int pk, int pkn, int out,
                                     uint16_t* first, uint16_t* end) {
  const int dc = dst_of(pk), dn = dst_of(pkn);
  if (dc == dn) return;
  if (dc >= 0 && dc < out) end[dc] = (uint16_t)(p + 1);
  if (dn >= 0 && dn < out) first[dn] = (uint16_t)(p + 1);
}

// This thread's table words of a transition: packed, score and the next
// pair's packed word of lanes tid and tid + THREADS.
__device__ __forceinline__ void fetch(const int32_t* tbl, int4 D, int tid,
                                      int (&pk)[PER], int (&sc)[PER],
                                      int (&pkn)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = tid + j * THREADS;
    if (p < D.y) {
      const int32_t* w = word(tbl, D.x, p);
      pk[j] = w[0];
      sc[j] = w[CHUNK];
      pkn[j] = p + 1 < D.y ? *word(tbl, D.x, p + 1) : 0;
    }
  }
}

// The best candidate of a destination on each of its rows: value (NONE if
// there is no valid candidate) and pair ordinal (0 if none).
struct Best {
  int v[RPT];
  int o[RPT];
};

// The best candidates of a destination over its pairs [e0, e1) on the rows
// whose offsets in V are rowoff[k] (row r at (r + 2) * ldv: two rows of NEG
// lie below row 0, so a source row r - wsum < 0 needs no test). UNROLL
// pairs at a time: their table words, then their RPT loads of V each, are
// issued together, and the candidates are then taken in plan order. Pairs
// come from the staged words, or (kStaged false, a transition of more than
// STAGE pairs) from the tables.
template <bool kStaged>
__device__ __forceinline__ Best walk(const int2* s_pair, const int32_t* tbl,
                                     int c0, int e0, int e1, const int32_t* V,
                                     int ldv, int lanes,
                                     const int (&rowoff)[RPT]) {
  Best b;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    b.v[k] = NONE;
    b.o[k] = 0;
  }
#pragma unroll 1
  for (int e = e0; e < e1; e += UNROLL) {
    int2 ps[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int ej = min(e + j, e1 - 1);
      if constexpr (kStaged) {
        ps[j] = s_pair[ej];
      } else {
        const int32_t* w = word(tbl, c0, ej);
        ps[j] = make_int2(w[0], w[CHUNK]);
      }
    }
    int c[UNROLL][RPT];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      // the source lane, clamped so that a table outside its contract
      // cannot read outside V, less wsum rows
      const int src =
          min(ps[j].x >> 13, lanes - 1) - min(ps[j].x & 3, 2) * ldv;
#pragma unroll
      for (int k = 0; k < RPT; ++k) c[j][k] = V[rowoff[k] + src];
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int v = c[j][k] + ps[j].y;
        if (e + j < e1 && c[j][k] >= REACH_T && v > b.v[k]) {
          b.v[k] = v;
          b.o[k] = e + j;
        }
      }
    }
  }
  return b;
}

// The rare paths, kept out of the transition loop's code: the walk and the
// boundary pass of a transition of more than STAGE pairs, from the tables.
struct RowOff {
  int off[RPT];
};

__device__ __noinline__ Best walk_unstaged(const int32_t* tbl, int c0,
                                           int e0, int e1, const int32_t* V,
                                           int ldv, int lanes, RowOff r) {
  return walk<false>(nullptr, tbl, c0, e0, e1, V, ldv, lanes, r.off);
}

__device__ __noinline__ void mark_unstaged(const int32_t* tbl, int4 D,
                                           uint16_t* first) {
  const int out = D.z & 0xFFFF;
  for (int p = threadIdx.x; p < D.y; p += THREADS)
    mark(p, *word(tbl, D.x, p), p + 1 < D.y ? *word(tbl, D.x, p + 1) : 0,
         out, first, first + MAX_LANES);
}

// Thread 0 keeps the descriptor ring ahead of the transitions: at
// transition t it copies descriptor t + 6 into its slot, asynchronously
// (cp.async, no register waits on it), and waits for the copy it issued at
// transition t - 1, so that after the barrier the ring holds t + 1 .. t + 5.
__device__ __forceinline__ void ring_fill(int4* s_desc, const int4* desc,
                                          int i, int T) {
  if (i < T) {
    const unsigned slot =
        (unsigned)__cvta_generic_to_shared(s_desc + (i & (RING - 1)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(slot),
                 "l"(desc + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Stage a transition's words held in registers: {packed, score} into
// s_pair, its range ends into first / end.
__device__ __forceinline__ void stage(int4 D, int tid, const int (&pk)[PER],
                                      const int (&sc)[PER],
                                      const int (&pkn)[PER], int2* s_pair,
                                      uint16_t* first) {
  const int out = D.z & 0xFFFF;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = tid + j * THREADS;
    if (p < D.y) {
      s_pair[p] = make_int2(pk[j], sc[j]);
      mark(p, pk[j], pkn[j], out, first, first + MAX_LANES);
    }
  }
}

template <bool kSharedV>
__global__ void __launch_bounds__(THREADS, 1)
narrow_run_kernel(const int32_t* __restrict__ tbl,
                  const int4* __restrict__ desc, int T, int R1, int lanes,
                  const int32_t* __restrict__ v_in, int32_t* v_out,
                  int16_t* __restrict__ bp256, int16_t* __restrict__ bp1024) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_desc = reinterpret_cast<int4*>(smem);
  int2* s_pair = reinterpret_cast<int2*>(smem + RING_BYTES);
  // first[0], end[0], first[1], end[1], MAX_LANES each
  uint16_t* s_range =
      reinterpret_cast<uint16_t*>(smem + RING_BYTES + STAGE_BYTES);
  // V with its two rows of NEG: in shared memory [R1 + 2, lanes], or the
  // output [R1 + 2, 1024] itself (v_out points at its row 0)
  int32_t* V = kSharedV ? reinterpret_cast<int32_t*>(smem + FIXED_BYTES)
                        : v_out - 2 * 1024;
  const int ldv = kSharedV ? lanes : 1024;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < R1 * 1024; i += THREADS) {
    const int r = i >> 10, l = i & 1023;
    if (!kSharedV || l >= lanes) v_out[i] = v_in[i];
    if (kSharedV && l < lanes) V[(r + 2) * lanes + l] = v_in[i];
  }
  for (int i = tid; i < 2 * ldv; i += THREADS) V[i] = NEG;
  for (int i = tid; i < 4 * MAX_LANES; i += THREADS) s_range[i] = 0;
  // the ring holds transitions t .. t + 4 at transition t (RING slots)
  if (tid < 5) s_desc[tid] = tid < T ? desc[tid] : make_int4(0, 0, 0, 0);
  if (tid == 0) ring_fill(s_desc, desc, 5, T);
  __syncthreads();  // ring and range buffers in place

  // Staging runs on the highest threads first: the low destination lanes,
  // which hold a narrow level's pairs, are walked by the low warps.
  const int sid = THREADS - 1 - tid;
  int pk[PER] = {}, sc[PER] = {}, pkn[PER] = {};
  // transition 0 staged, transition 1 fetched
  if (T > 0) {
    const int4 D0 = s_desc[0];
    if (D0.y <= STAGE) {
      fetch(tbl, D0, sid, pk, sc, pkn);
      stage(D0, sid, pk, sc, pkn, s_pair, s_range);
    } else {
      mark_unstaged(tbl, D0, s_range);
    }
    if (T > 1 && s_desc[1].y <= STAGE) fetch(tbl, s_desc[1], sid, pk, sc, pkn);
  }
  __syncthreads();

  // blocks of rows for G = 4, 2, 1 row groups
  const int nrb4 = (R1 + 4 * RPT - 1) / (4 * RPT);
  const int nrb2 = (R1 + 2 * RPT - 1) / (2 * RPT);
  const int nrb1 = (R1 + RPT - 1) / RPT;
  int4 D = T > 0 ? s_desc[0] : make_int4(0, 0, 0, 0);
  int hi = lanes;  // lanes [hi, lanes) of V hold NEG
  for (int t = 0; t < T; ++t) {
    const int cb = t & 1;
    uint16_t* first = s_range + cb * 2 * MAX_LANES;
    const int4 D1 = s_desc[(t + 1) & (RING - 1)];

    // stage the next transition into the other buffers while this one is
    // walked, and fetch the one after it
    if (t + 1 < T) {
      uint16_t* nfirst = s_range + (cb ^ 1) * 2 * MAX_LANES;
      if (D1.y <= STAGE)
        stage(D1, sid, pk, sc, pkn, s_pair + (cb ^ 1) * STAGE, nfirst);
      else
        mark_unstaged(tbl, D1, nfirst);
      if (t + 2 < T) {
        const int4 D2 = s_desc[(t + 2) & (RING - 1)];
        if (D2.y <= STAGE) fetch(tbl, D2, sid, pk, sc, pkn);
      }
    }

    const int out = D.z & 0xFFFF;
    // G = 1024 / OUT row groups (one for 768 lanes), taken by consecutive
    // warps so that the low destination lanes, which hold a narrow level's
    // pairs, spread over the SM's four schedulers
    const int lg = out == 256 ? 2 : out == 512 ? 1 : 0;
    const int G = 1 << lg;
    const int g = warp & (G - 1);
    const int d = ((warp >> lg) << 5) + lane;
    const int nrb = lg == 2 ? nrb4 : lg == 1 ? nrb2 : nrb1;
    // lanes [wr, OUT) hold NEG already: only [0, wr) are walked and written
    const int ndst = D.z >> 16;
    const int wr = min(max(ndst, hi), out);
    hi = hi > out ? hi : ndst;
    const int ld = out > CHUNK ? 1024 : CHUNK;
    int16_t* bpd = (out > CHUNK ? bp1024 : bp256) + (size_t)D.w * R1 * ld + d;
    const bool mine = d < wr;
    const int e0 = mine ? first[d] : 0;
    const int e1 = mine ? first[MAX_LANES + d] : 0;

    for (int rb = nrb - 1; rb >= 0; --rb) {
      const int r0 = rb * G * RPT + g;
      int rowoff[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        rowoff[k] = (min(r0 + G * k, R1 - 1) + 2) * ldv;
      Best b;
      if (D.y <= STAGE) {
        b = walk<true>(s_pair + cb * STAGE, tbl, D.x, e0, e1, V, ldv, lanes,
                       rowoff);
      } else {
        RowOff ro;
#pragma unroll
        for (int k = 0; k < RPT; ++k) ro.off[k] = rowoff[k];
        b = walk_unstaged(tbl, D.x, e0, e1, V, ldv, lanes, ro);
      }
      __syncthreads();  // every read of this block's rows is done
      if (mine) {
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = r0 + G * k;
          if (r < R1) {
            V[rowoff[k] + d] = b.v[k] > REACH_T ? b.v[k] : NEG;
            // the backpointers start zeroed: write only an ordinal
            if (b.o[k] != 0) bpd[r * ld] = (int16_t)b.o[k];
          }
        }
      }
    }

    // clear the ranges this transition set
    if (g == 0 && e1 > e0) {
      first[d] = 0;
      first[MAX_LANES + d] = 0;
    }
    if (tid == 0) ring_fill(s_desc, desc, t + 6, T);
    D = D1;
    __syncthreads();  // V written, the next transition staged
  }

  if (kSharedV) {
    for (int i = tid; i < R1 * lanes; i += THREADS) {
      const int r = i / lanes, l = i - r * lanes;
      v_out[r * 1024 + l] = V[2 * lanes + i];
    }
  }
}

}  // namespace

// Dynamic shared memory of a launch: V [R1 + 2, lanes] only with shared_v.
extern "C" int dg_narrow_smem_bytes(int R1, int lanes, int shared_v) {
  return FIXED_BYTES + (shared_v ? (R1 + 2) * lanes * 4 : 0);
}

extern "C" int dg_narrow_run(const int32_t* tbl, const int4* desc, int T,
                             int R1, int lanes, int shared_v,
                             const int32_t* v_in, int32_t* v_out,
                             int16_t* bp256, int16_t* bp1024,
                             cudaStream_t stream) {
  const int bytes = dg_narrow_smem_bytes(R1, lanes, shared_v);
  if (R1 < 1 || lanes < 1 || lanes > MAX_LANES || T < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = shared_v ? narrow_run_kernel<true> : narrow_run_kernel<false>;
  // above 48 KB only after this opt-in; past the card's limit it fails
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, THREADS, bytes, stream>>>(tbl, desc, T, R1, lanes, v_in, v_out,
                                        bp256, bp1024);
  return (int)cudaGetLastError();
}

extern "C" const char* dg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
