// K7: the edge-space level chain, one DP transition per level with the
// edge pairs formed inside the kernel.
//
// Replaces scripts/tpu_edge_probe.py `kernel` (launched by `build`). The
// TPU kernel gathered V by source row and then by source column with two
// batched float32 one-hot matmuls over the concatenation [V[r], V[r - 1]]
// (the edge weight folded into the gather index `w * 16 + src`), and took
// the max per destination pair in two stages, each a log-step roll scan
// on (value, tie) followed by a one-hot matmul extraction at the last edge
// of each destination vertex. Here a gather is an indexed shared-memory
// load, and each destination pair (i2, j2) takes ONE max over the edge
// pairs (e1, e2) of the runs of edges that end at laste[i2] and laste[j2],
// in the total order on (value, tie), tie = (15 - e1) * 16 + (15 - e2).
// The pairs are visited with e1, then e2, falling, so tie rises: a
// candidate at least as large as the best so far wins, a pair of 32-bit
// compares in place of the 64-bit key. The TPU's max over e1 followed by
// a max over e2 picks the same winner.
//
// What bounds it on the H100: latency per level. The chain is serial and
// its work small (256 destination pairs x 19 rows, one edge pair each on
// the probes' tables; 1.8 KB of tables in, 9.5 KB of backpointers out),
// so bytes and operations are far away; what is left on the chain is one
// barrier, the gathers and the commit.
//
// Design (chain_ring.cuh): ONE block, one launch per chain, V in shared
// memory, double-buffered (read V[t & 1], write V[(t + 1) & 1]) so that a
// level needs one barrier. 8 consumer warps, a thread a destination pair
// over all 19 rows; a producer warp stages the tables D levels ahead in a
// ring (three bulk copies a level) and decodes each level two ahead of
// the consumers: per destination vertex one word with its run of edges
// (the last edge, the run's length from one warp ballot of the runs'
// starts) and the gather word of that last edge. Between arriving at
// level t's barrier and waiting on it, a consumer reads its two vertices'
// words and the first edge pair's score; the other edge pairs of runs
// longer than one come from the tables. V's rows are r + 2, rows 0 and 1
// NEG guards, so that the weight shift r - w1 - w2 is an offset and not a
// branch; column 256 is 0 on every row r >= 0, the row stage of an
// invalid edge. A thread's 19 gathers are loads at one offset plus r * W.
// The transposed tables tblr / tbl2r of the TPU's layouts are not read.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): 0.856 us a
// level (0.809 on the chain that stays alive) against the replaced
// kernel's 1.666 (1.676); K6 (one block of 1,024 threads, two barriers a
// level, tables one level ahead) takes 1.181 (1.175) on the same chains.
#include "chain_ring.cuh"

namespace {

using namespace dg;

constexpr int R1 = 19;
constexpr int B = 16;                  // vertices per level
constexpr int EB = 16;                 // edges per level
constexpr int NC = EB * 8, N2 = B * 4, NS = EB * EB;  // words per level
constexpr int D = 8;                   // ring depth (ops/chain_ring.py)
constexpr int W = B * B + 1;           // a row of V: 256 pairs, the 0 column
constexpr int ZERO = B * B;
constexpr int CONSUMERS = B * B;       // a thread a destination pair
constexpr int THREADS = CONSUMERS + 32;
constexpr int KR = R1 + 2;             // rows of V: 2 NEG guards, then r
constexpr int NO_BEST = -2147483647 - 1;

struct Stage {
  int c[NC];    // per edge: rsel, dst, valid
  int two[N2];  // per destination vertex: laste, hp
  int s[NS];
  int desc[B];  // per destination vertex, the producer's decode (below)
};
struct Smem {
  Stage ring[D];
  int V[2][KR * W];
  uint64_t full[D];  // the stage's tables have landed
  uint64_t dec[D];   // and the producer has decoded them
};
constexpr uint32_t TABLE_BYTES = (NC + N2 + NS) * 4;
static_assert(sizeof(Stage) % 16 == 0, "stages stay 16-byte aligned");

// The first edge pair of a destination pair: its runs and what the first
// pair's gather needs.
struct Pre {
  int l1, l2, n1, n2;  // last edges, run lengths (0: no candidate)
  int off, add;
};

// An edge's word for the gathers: the row stage (column block src * 16,
// or the 0 column for an invalid edge, and its weight) and the column
// stage (src and weight).
__device__ __forceinline__ int edge_word(const Stage& st, int e) {
  const int rsel = st.c[e * 8] & (2 * B - 1);  // masked: in shared memory
  const bool valid = st.c[e * 8 + 2] > 0;
  const int col1 = valid ? (rsel % B) * B : ZERO;
  const int w1 = valid ? rsel / B : 0;
  return col1 | w1 << 9 | (rsel % B) << 10 | (rsel / B) << 14;
}

// The gather offset (row r adds r * W) of the edge pair whose words are a
// (row stage) and b (column stage): V[. - w1, s1, .], or 0 for an invalid
// edge, then [r - w2, ., s2]; NEG below r = 0 at each stage from the guard
// rows.
__device__ __forceinline__ int pair_off(int a, int b) {
  return (2 - ((a >> 9) & 1) - (b >> 14)) * W +
         min((a & 511) + ((b >> 10) & (B - 1)), ZERO);
}

// The producer warp decodes a stage: desc[i] = n | l << 5 | word(l) << 9,
// n the length of the run of edges that ends at i's last edge l (0 where i
// has none), its first edge from one ballot of the runs' starts. The lane
// that writes desc[i] arrives on the stage's `dec` barrier.
__device__ __forceinline__ void decode(Stage& st, uint64_t* dec, int lane) {
  const int e = lane % EB;
  const int d = st.c[e * 8 + 1];
  const bool first = e == 0 || d != st.c[(e > 0 ? e - 1 : 0) * 8 + 1];
  const unsigned starts = __ballot_sync(~0u, lane < EB && first);
  const int word = edge_word(st, e);
  const int l = st.two[e * 4];
  const bool ok = st.two[e * 4 + 1] > 0 && (unsigned)l < EB;
  const int last = l & (EB - 1);
  const int n = ok ? last + 1 - (31 - __clz(starts & ((2u << last) - 1)))
                   : 0;
  const int lw = __shfl_sync(~0u, word, last);
  if (lane < B) {
    st.desc[lane] = n | last << 5 | lw << 9;
    ring::arrive_local(dec);
  }
}

// The first edge pair of destination (i2, j2) from the decoded stage.
__device__ __forceinline__ Pre first_pair(const Stage& st, int i2, int j2) {
  const int d1 = st.desc[i2], d2 = st.desc[j2];
  Pre p;
  p.l1 = (d1 >> 5) & (EB - 1);
  p.l2 = (d2 >> 5) & (EB - 1);
  const bool ok = (d1 & 31) && (d2 & 31);
  p.n1 = ok ? d1 & 31 : 0;
  p.n2 = ok ? d2 & 31 : 0;
  p.off = pair_off(d1 >> 9, d2 >> 9);
  p.add = st.s[p.l1 * EB + p.l2];
  return p;
}

__global__ void __launch_bounds__(THREADS, 1)
chain_edge_kernel(const int32_t* __restrict__ tblc,
                  const int32_t* __restrict__ tbl2c,
                  const int32_t* __restrict__ S, int T,
                  int16_t* __restrict__ bp, int32_t* __restrict__ v_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32;

  for (int i = tid; i < 2 * KR * W; i += THREADS) {
    const int k = (i / W) % KR, col = i % W;
    (&sm.V[0][0])[i] = k < 2 ? NEG : (col == 0 || col == ZERO) ? 0 : NEG;
  }
  if (tid == 0) {
    ring::init(sm.full, D);
    ring::init(sm.dec, D, B);  // the 16 lanes that write a decode
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    auto issue = [&](int t) {
      const int s = t % D;
      ring::expect_bytes(&sm.full[s], TABLE_BYTES);
      ring::bulk_load(sm.ring[s].c, tblc + (size_t)t * NC, NC * 4,
                      &sm.full[s]);
      ring::bulk_load(sm.ring[s].two, tbl2c + (size_t)t * N2, N2 * 4,
                      &sm.full[s]);
      ring::bulk_load(sm.ring[s].s, S + (size_t)t * NS, NS * 4, &sm.full[s]);
    };
    // level t's stage, decoded by the whole warp once its copies landed
    auto decoded = [&](int t) {
      const int s = t % D;
      ring::wait(&sm.full[s], (t / D) & 1);
      decode(sm.ring[s], &sm.dec[s], lane);
    };
    if (lane == 0)
      for (int t = 0; t < D && t < T; ++t) issue(t);
    for (int t = 0; t < 2 && t < T; ++t) decoded(t);
    for (int t = 0; t < T; ++t) {
      ring::arrive();
      ring::wait_all();
      // the consumers read level t + 2's decode in the next barrier's
      // window
      if (t + 2 < T) decoded(t + 2);
      if (lane == 0 && t + D < T) issue(t + D);
    }
    return;
  }

  const int i2 = tid / B, j2 = tid % B;
  Pre p{};
  if (T > 0) {
    ring::wait(&sm.full[0], 0);
    ring::wait(&sm.dec[0], 0);
    p = first_pair(sm.ring[0], i2, j2);
  }
  for (int t = 0; t < T; ++t) {
    const Stage& st = sm.ring[t % D];
    const int* Vc = sm.V[t & 1];
    int best[R1], code[R1];
#pragma unroll
    for (int r = 0; r < R1; ++r) best[r] = NO_BEST, code[r] = 0;
    for (int k1 = 0; k1 < p.n1; ++k1) {
      const int e1 = p.l1 - k1;
      for (int k2 = 0; k2 < p.n2; ++k2) {
        const int e2 = p.l2 - k2;
        // the first pair from the decode, the others from the tables
        const int off = (k1 | k2) ? pair_off(edge_word(st, e1),
                                             edge_word(st, e2))
                                  : p.off;
        const int add = (k1 | k2) ? st.s[e1 * EB + e2] : p.add;
        if (add < -8192) continue;
        const int tie = (EB - 1 - e1) * EB + (EB - 1 - e2);
#pragma unroll
        for (int r = 0; r < R1; ++r) {
          // the guard rows are NEG, as is every unreached state
          const int g = Vc[off + r * W];
          const int cand = (int)((unsigned)g + (unsigned)add);
          const bool up = g >= REACH_T && cand >= best[r];
          best[r] = up ? cand : best[r];
          code[r] = up ? tie : code[r];
        }
      }
    }

    int* Vn = sm.V[(t + 1) & 1] + 2 * W + tid;
    int16_t* bpt = bp + (size_t)t * R1 * B * B + tid;
#pragma unroll
    for (int r = 0; r < R1; ++r) {
      const bool reach = best[r] > REACH_T;
      Vn[r * W] = reach ? best[r] : NEG;
      bpt[r * B * B] = reach ? (int16_t)code[r] : (int16_t)0;
    }
    ring::arrive();
    if (t + 1 < T) {
      const int s = (t + 1) % D;
      ring::wait(&sm.full[s], ((t + 1) / D) & 1);
      ring::wait(&sm.dec[s], ((t + 1) / D) & 1);
      p = first_pair(sm.ring[s], i2, j2);
    }
    ring::wait_all();
  }
  const int* Vf = sm.V[T & 1];
  for (int r = 0; r < R1; ++r) v_out[r * B * B + tid] = Vf[(r + 2) * W + tid];
}

}  // namespace

extern "C" int dg_chain_edge(const int32_t* tblc, const int32_t* tbl2c,
                             const int32_t* S, int T, int16_t* bp,
                             int32_t* v_out, cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t rc = cudaFuncSetAttribute(
      chain_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  chain_edge_kernel<<<1, THREADS, bytes, stream>>>(tblc, tbl2c, S, T, bp,
                                                   v_out);
  return (int)cudaGetLastError();
}
