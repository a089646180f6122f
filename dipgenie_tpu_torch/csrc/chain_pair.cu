// K6: the pair-space level chain, one DP transition per level on 256
// edge-pair lanes.
//
// Replaces scripts/tpu_pair_probe.py `kernel` (launched by `build`), the
// prototype of the narrow-run kernel (narrow_run.cu). The TPU kernel
// gathered V with a float32 one-hot matmul, shifted rows by the weight with
// sublane rolls, took the per-destination max with a log-step lane-roll
// segmented scan on an int32 key `(value << 8) | tie` and extracted the
// segment ends with a second one-hot matmul (offsetting values by 2^22 to
// keep them positive). Here the gather is an indexed shared-memory load,
// and each destination pair walks the run of lanes that ends at lastE[d],
// keeping the largest (value, tie): the larger value, then the larger tie,
// as two 32-bit compares. The order of the walk decides nothing, since
// tie is only promised to lie in [0, 256) and not to follow the lanes.
//
// What bounds it on the H100: latency per level. The chain is serial and
// a level small (19 x 256 candidates on the probes' tables, 6 KB of tables
// in, 9.5 KB of backpointers out plus 2.5 KB of zero padding rows), far
// below what the card moves or computes in the time one block needs for a
// level; what is left on the chain is one barrier, the gathers and the
// commit.
//
// Design (chain_ring.cuh, as K7 in chain_edge.cu): ONE block, one launch
// per chain. 8 consumer warps, a thread a destination pair d over all 19
// rows, its best values in registers; V in shared memory, double-buffered
// (read V[t & 1], write V[(t + 1) & 1]) so that a level needs one barrier,
// its rows r + 2 with rows 0 and 1 NEG guards, so that the weight shift
// r - wsum (wsum in {0, 1, 2}) is an offset and not a branch. A lane's 19
// gathers are issued together and its compares are branch-free. Four
// producer warps, one on each of the SM's schedulers: one lane stages
// rows 0-5 of tbl[t] with one 6,144-byte bulk copy a level, D levels ahead
// in a ring, and all four decode each level two ahead of the consumers,
// a quarter of the lanes each: from one warp ballot of the seg changes a
// round of 32 lanes, every lane's run start (carried across the warps
// over a named barrier), then per destination pair one int4 with its run
// (length and last lane, length 0 where lastE[d] is not a lane) and the
// last lane's gather offset, tie and score. A consumer reads its int4 in
// the window of the level barrier before (between arriving and waiting);
// the other lanes of longer runs come from the decode's per-lane words.
//
// The backpointers go off the consumers' chain: a consumer writes its 19
// int16 into a shared-memory copy of the level's [24, 256] block (BP_STAGES
// of them, rows 19-23 zeroed once), runs fence.proxy.async.shared::cta so
// that the async proxy sees them and a block-scope fence, and arrives at
// the level barrier without releasing (a releasing arrive is a fence at
// the scope of the card); after the barrier one producer lane stores the
// whole 12,288-byte block with one bulk copy (cp.async.bulk ...
// bulk_group). Before the consumers write a stage again, that lane waits
// until the stage's copy has read it (cp.async.bulk.wait_group.read
// BP_STAGES - 2 before it arrives at the barrier that lets them), and
// before the kernel exits for every copy. ops/chain_ring.py mirrors the
// decode and the stages for the CPU tests.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W, raw calls in
// turns): 0.758 us (1,502 cycles) a level on the probe's chain, 0.704 on
// the chain that stays alive, against the replaced kernel's 1.168 / 1.160
// (one block of 1,024 threads in 4 row groups, two barriers a level,
// tables one level ahead in registers, 19 global stores a thread) and
// K7's 0.858 / 0.805. Without any backpointer 0.649 / 0.585; with each
// consumer's 19 global stores in place of the stages and the bulk store
// 0.928 / 0.856; without the proxy fence 0.745 / 0.690; one producer warp
// in place of four 1.189 / 1.135 (its decode held the level).
#include <climits>
#include <cstddef>

#include "chain_ring.cuh"

namespace {

using namespace dg;

constexpr int R1 = 19;
constexpr int NP2 = 256;               // pair lanes, destination pairs
constexpr int GIDX = 0, SC = 1, TIE = 2, SEG = 3, LASTE = 4, WSUM = 5;
constexpr int USED = 6;                // table rows a level reads
constexpr int TBL_ROWS = 8;            // rows of a level's table block
constexpr int D = 8;                   // ring depth (ops/chain_ring.py)
constexpr int BP_ROWS = 24;            // rows of a level's bp block
constexpr int BP_STAGES = 3;           // bp blocks in shared memory
constexpr int KR = R1 + 2;             // rows of V: 2 NEG guards, then r
constexpr int VW = NP2;                // a row of V
constexpr int CONSUMERS = NP2;         // a thread a destination pair
constexpr int PRODUCERS = 4;           // producer warps, one a scheduler
constexpr int THREADS = CONSUMERS + 32 * PRODUCERS;
constexpr int ROUNDS = NP2 / 32 / PRODUCERS;  // decode rounds a warp
constexpr uint32_t TABLE_BYTES = USED * NP2 * 4;
constexpr uint32_t BP_BYTES = BP_ROWS * NP2 * 2;

struct Stage {
  int tbl[USED][NP2];  // rows 0-5 of tbl[t]
  int4 lane[NP2];      // per lane, the decode's first pass (below)
  int4 pre[NP2];       // per destination pair, its second pass (below)
};
struct Smem {
  Stage ring[D];
  int16_t bp[BP_STAGES][BP_ROWS * NP2];
  int V[2][KR * VW];
  uint64_t full[D];  // the stage's tables have landed
  uint64_t dec[D];   // and the producers have decoded them
  int carry[PRODUCERS];  // the decode's last run start of each warp
};
static_assert(BP_STAGES >= 2, "a stage is written while another is stored");
static_assert(sizeof(Stage) % 16 == 0, "stages stay 16-byte aligned");
static_assert(offsetof(Smem, bp) % 16 == 0, "bulk stores read 16-byte units");

// The gather offset of lane e (row r adds r * VW): V[r - wsum, gidx], NEG
// below r = 0 from the guard rows. Masked, so that a table outside its
// contract cannot read outside shared memory.
__device__ __forceinline__ int gather_off(const Stage& st, int e) {
  const int w = min(max(st.tbl[WSUM][e], 0), 2);
  return (2 - w) * VW + (st.tbl[GIDX][e] & (NP2 - 1));
}

// Producer warp w decodes its quarter of a stage, lanes e = (w * ROUNDS +
// k) * 32 + lane of it in round k. First pass: one ballot a round of the
// lanes that start a run (seg differs from the lane before) gives every
// lane's run start, carried over from the rounds before and, across the
// warps, from the last start of the warps before (carry[], exchanged over
// a named barrier of the producers); lane[e] = {run start, gather offset,
// tie, score}. Second pass, after another such barrier: per destination
// pair d, pre[d] = {n | l << 9, the rest of lane[l]} of l = lastE[d] and
// the run of n lanes that ends there (n = 0 where lastE[d] is not a
// lane). Each pass issues all its loads before it uses them. Lane 0 of
// each warp arrives on the stage's `dec` barrier after its warp's writes.
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * PRODUCERS) : "memory");
}

__device__ __forceinline__ void decode(Stage& st, uint64_t* dec, int* carry,
                                       int w, int lane) {
  int seg[ROUNDS], prev[ROUNDS], off[ROUNDS], tie[ROUNDS], sc[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int e = (w * ROUNDS + k) * 32 + lane;
    seg[k] = st.tbl[SEG][e];
    prev[k] = st.tbl[SEG][e > 0 ? e - 1 : 0];
    off[k] = gather_off(st, e);
    tie[k] = st.tbl[TIE][e];
    sc[k] = st.tbl[SC][e];
  }
  unsigned starts[ROUNDS];
  int start[ROUNDS], last = -1;  // -1: no start yet in this warp's lanes
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int e0 = (w * ROUNDS + k) * 32;
    starts[k] = __ballot_sync(~0u, e0 + lane == 0 || seg[k] != prev[k]);
    const unsigned low = starts[k] & (~0u >> (31 - lane));
    start[k] = low ? e0 + 31 - __clz(low) : last;
    last = starts[k] ? e0 + 31 - __clz(starts[k]) : last;
  }
  if (lane == 0) carry[w] = last;
  producers_sync();
  int in = 0;  // lane 0 starts a run, so warp 0 has a start
#pragma unroll
  for (int v = 0; v < PRODUCERS - 1; ++v)
    if (v < w) in = max(in, carry[v]);
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k)
    st.lane[(w * ROUNDS + k) * 32 + lane] = make_int4(
        start[k] >= 0 ? start[k] : in, off[k], tie[k], sc[k]);
  producers_sync();
  int lastE[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k)
    lastE[k] = st.tbl[LASTE][(w * ROUNDS + k) * 32 + lane];
  int4 q[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) q[k] = st.lane[lastE[k] & (NP2 - 1)];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int l = lastE[k] & (NP2 - 1);
    st.pre[(w * ROUNDS + k) * 32 + lane] = make_int4(
        ((unsigned)lastE[k] < NP2 ? l + 1 - q[k].x : 0) | l << 9, q[k].y,
        q[k].z, q[k].w);
  }
  __syncwarp();
  if (lane == 0) ring::arrive_local(dec);
}

// One lane's candidates on the 19 rows, `g` its gathered column (row r at
// g[r * VW]; the guard rows are NEG, as is every unreached state): g + add
// where g is reached, kept where it is larger in value, then in tie. The
// loads are issued together and the compares are branch-free.
__device__ __forceinline__ void consider(const int* g, int add, int tie,
                                         int (&best)[R1], int (&code)[R1]) {
  int v[R1];
#pragma unroll
  for (int r = 0; r < R1; ++r) v[r] = g[r * VW];
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    const int cand = (int)((unsigned)v[r] + (unsigned)add);
    const bool up = (v[r] >= REACH_T) &
                    ((cand > best[r]) | ((cand == best[r]) & (tie > code[r])));
    best[r] = up ? cand : best[r];
    code[r] = up ? tie : code[r];
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(ring::smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk stores have not yet read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
chain_pair_kernel(const int32_t* __restrict__ tbl, int T,
                  int16_t* __restrict__ bp, int32_t* __restrict__ v_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32;

  for (int i = tid; i < 2 * KR * VW; i += THREADS) {
    const int k = (i / VW) % KR;
    (&sm.V[0][0])[i] = k >= 2 && i % VW == 0 ? 0 : NEG;
  }
  // the padding rows of every bp stage, which no state maps to
  for (int i = tid; i < BP_STAGES * (BP_ROWS - R1) * NP2; i += THREADS) {
    const int s = i / ((BP_ROWS - R1) * NP2);
    sm.bp[s][R1 * NP2 + i % ((BP_ROWS - R1) * NP2)] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (tid == 0) {
    ring::init(sm.full, D);
    ring::init(sm.dec, D, PRODUCERS);  // lane 0 of each producer warp
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warps
    const int w = (tid - CONSUMERS) / 32;
    // one lane issues the table copies, one of another warp the bp stores,
    // each after the decode, so that neither holds up the decode's barriers
    const bool loads = tid == CONSUMERS + 64, stores = tid == CONSUMERS + 32;
    auto issue = [&](int t) {
      const int s = t % D;
      ring::expect_bytes(&sm.full[s], TABLE_BYTES);
      ring::bulk_load(sm.ring[s].tbl, tbl + (size_t)t * TBL_ROWS * NP2,
                      TABLE_BYTES, &sm.full[s]);
    };
    // level t's stage, decoded by the producers once its copy landed
    auto decoded = [&](int t) {
      const int s = t % D;
      ring::wait(&sm.full[s], (t / D) & 1);
      decode(sm.ring[s], &sm.dec[s], sm.carry, w, lane);
    };
    if (loads)
      for (int t = 0; t < D && t < T; ++t) issue(t);
    for (int t = 0; t < 2 && t < T; ++t) decoded(t);
    for (int t = 0; t < T; ++t) {
      // the consumers write stage (t + 1) % BP_STAGES after this barrier:
      // level t + 1 - BP_STAGES's store must have read it
      if (stores) bulk_wait_read<BP_STAGES - 2>();
      ring::arrive();
      ring::wait_all();
      // the consumers read level t + 2's decode in the next barrier's
      // window
      if (t + 2 < T) decoded(t + 2);
      if (stores)
        bulk_store(bp + (size_t)t * BP_ROWS * NP2, sm.bp[t % BP_STAGES],
                   BP_BYTES);
      if (loads && t + D < T) issue(t + D);
    }
    // the stores read shared memory and reach global memory before exit
    if (stores) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  const int d = tid;
  int4 p = make_int4(0, 0, 0, 0);
  if (T > 0) {
    ring::wait(&sm.full[0], 0);
    ring::wait(&sm.dec[0], 0);
    p = sm.ring[0].pre[d];
  }
  for (int t = 0; t < T; ++t) {
    const Stage& st = sm.ring[t % D];
    const int* Vc = sm.V[t & 1];
    int best[R1], code[R1];
#pragma unroll
    for (int r = 0; r < R1; ++r) best[r] = INT_MIN, code[r] = -1;
    const int n = p.x & 511, last = p.x >> 9;
    // the last lane from the decode's second pass, the others from its
    // first
    if (n > 0) consider(Vc + p.y, p.w, p.z, best, code);
    for (int k = 1; k < n; ++k) {
      const int4 q = st.lane[last - k];
      consider(Vc + q.y, q.w, q.z, best, code);
    }

    int* Vn = sm.V[(t + 1) & 1] + 2 * VW + d;
    int16_t* bps = sm.bp[t % BP_STAGES] + d;
#pragma unroll
    for (int r = 0; r < R1; ++r) {
      const bool reach = best[r] > REACH_T;
      Vn[r * VW] = reach ? best[r] : NEG;
      bps[r * NP2] = reach ? (int16_t)code[r] : (int16_t)0;
    }
    // the bulk store after the barrier reads bps through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // this thread's shared-memory writes, before an arrive that releases
    // nothing (a releasing arrive fences at the scope of the card)
    __threadfence_block();
    ring::arrive_relaxed();
    if (t + 1 < T) {
      const int s = (t + 1) % D;
      ring::wait(&sm.full[s], ((t + 1) / D) & 1);
      ring::wait(&sm.dec[s], ((t + 1) / D) & 1);
      p = sm.ring[s].pre[d];
    }
    ring::wait_all();
  }
  const int* Vf = sm.V[T & 1] + 2 * VW + d;
  for (int r = 0; r < R1; ++r) v_out[r * NP2 + d] = Vf[r * VW];
}

}  // namespace

extern "C" int dg_chain_pair(const int32_t* tbl, int T, int16_t* bp,
                             int32_t* v_out, cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t rc = cudaFuncSetAttribute(
      chain_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  chain_pair_kernel<<<1, THREADS, bytes, stream>>>(tbl, T, bp, v_out);
  return (int)cudaGetLastError();
}
