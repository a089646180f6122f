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
// load, and each destination pair (i2, j2) takes ONE flat max over the
// edge pairs (e1, e2) of the runs of edges that end at laste[i2] and
// laste[j2], on the 64-bit key `(value << 8) | tie` with tie = (15 - e1) *
// 16 + (15 - e2). The order on (value, tie) is total, so the flat max and
// the TPU's max over e1 followed by a max over e2 pick the same winner.
//
// What bounds it on the H100: as chain_pair.cu, latency per level (two
// block barriers, dependent shared-memory loads, the level's 1.8 KB of
// tables), not bytes or operations: the chain is serial and one block
// works on it.
//
// Design: ONE block of 1,024 threads loops over the T levels, one launch
// per chain, V [19, 16, 16] int32 in shared memory. Thread (g, i2, j2)
// owns the destination pair on rows g, g + 4, ...; it reads V for all its
// rows, and after a barrier writes V and the int16 backpointers. Each
// thread fetches its word of level t + 1's tables into a register before
// it computes level t. cp.async / TMA prefetch several levels ahead is
// later work. The transposed tables tblr / tbl2r of the TPU's layouts are
// not read.
#include "dg_common.cuh"

namespace {

constexpr int R1 = 19;
constexpr int B = 16;                  // vertices per level
constexpr int EB = 16;                 // edges per level
constexpr int GROUPS = 4;              // row groups: 4 x 256 threads
constexpr int ROWS = (R1 + GROUPS - 1) / GROUPS;
constexpr int NC = EB * 8, N2 = B * 4, NS = EB * EB;  // words per level
constexpr long long NO_KEY = -(1LL << 62);

__global__ void __launch_bounds__(GROUPS * B * B)
chain_edge_kernel(const int32_t* __restrict__ tblc,
                  const int32_t* __restrict__ tbl2c,
                  const int32_t* __restrict__ S, int T,
                  int16_t* __restrict__ bp, int32_t* __restrict__ v_out) {
  using namespace dg;
  __shared__ int s_c[NC];   // per edge: rsel, dst, valid
  __shared__ int s_2[N2];   // per destination vertex: laste, hp
  __shared__ int s_S[NS];
  __shared__ int s_V[R1 * B * B];
  const int tid = threadIdx.x;
  const int grp = tid / (B * B), i2 = (tid / B) % B, j2 = tid % B;

  for (int i = tid; i < R1 * B * B; i += blockDim.x)
    s_V[i] = (i % (B * B) == 0) ? 0 : NEG;
  // the word of a level's tables this thread stages, if any
  const int32_t* src = nullptr;
  int* dst = nullptr;
  size_t stride = 0;
  if (tid < NC) {
    src = tblc + tid, dst = s_c + tid, stride = NC;
  } else if (tid < NC + N2) {
    src = tbl2c + (tid - NC), dst = s_2 + (tid - NC), stride = N2;
  } else if (tid >= 256 && tid < 256 + NS) {
    src = S + (tid - 256), dst = s_S + (tid - 256), stride = NS;
  }
  int next = (src && T > 0) ? src[0] : 0;

  for (int t = 0; t < T; ++t) {
    if (dst) *dst = next;
    __syncthreads();  // level t's tables and level t - 1's V are in place
    if (src && t + 1 < T) next = src[(size_t)(t + 1) * stride];

    long long best[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) best[k] = NO_KEY;
    const int l1 = s_2[i2 * 4], l2 = s_2[j2 * 4];
    if (s_2[i2 * 4 + 1] > 0 && s_2[j2 * 4 + 1] > 0 && l1 >= 0 && l1 < EB &&
        l2 >= 0 && l2 < EB) {
      const int run1 = s_c[l1 * 8 + 1], run2 = s_c[l2 * 8 + 1];
      for (int e1 = l1; e1 >= 0 && s_c[e1 * 8 + 1] == run1; --e1) {
        // rsel = w * 16 + src, masked so that a table outside its contract
        // cannot read outside shared memory
        const int rsel1 = s_c[e1 * 8] & (2 * B - 1);
        const int w1 = rsel1 / B, s1 = rsel1 % B;
        const bool valid1 = s_c[e1 * 8 + 2] > 0;
        for (int e2 = l2; e2 >= 0 && s_c[e2 * 8 + 1] == run2; --e2) {
          const int add = s_S[e1 * EB + e2];
          if (add < -8192) continue;
          const int rsel2 = s_c[e2 * 8] & (2 * B - 1);
          const int w2 = rsel2 / B, s2 = rsel2 % B;
          const int code = (EB - 1 - e1) * EB + (EB - 1 - e2);
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            // rows past R1 - 1 compute on row 0 and are dropped at the
            // commit; no branch depends on whether a state is reachable
            const int r = grp + GROUPS * k < R1 ? grp + GROUPS * k : 0;
            // column stage: A[r - w2, e1, s2], NEG shifted in at r = 0;
            // row stage: V[. - w1, s1, s2], NEG shifted in again, and 0
            // for an edge that is not valid
            const int ra = r - w2, rv = ra - w1;
            const int v = rv >= 0 ? s_V[(rv * B + s1) * B + s2] : NEG;
            const int g = ra < 0 ? NEG : (valid1 ? v : 0);
            const long long key =
                g < REACH_T ? NO_KEY : (long long)(g + add) * 256 + code;
            best[k] = key > best[k] ? key : best[k];
          }
        }
      }
    }
    __syncthreads();  // every read of V and of the tables is done

#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = grp + GROUPS * k;
      if (r >= R1) continue;
      const long long value = best[k] >> 8;
      const bool reach = best[k] != NO_KEY && value > REACH_T;
      const int at = (r * B + i2) * B + j2;
      s_V[at] = reach ? (int)value : NEG;
      bp[(size_t)t * R1 * B * B + at] =
          reach ? (int16_t)(best[k] & 255) : (int16_t)0;
    }
  }
  __syncthreads();
  for (int i = tid; i < R1 * B * B; i += blockDim.x) v_out[i] = s_V[i];
}

}  // namespace

extern "C" int dg_chain_edge(const int32_t* tblc, const int32_t* tbl2c,
                             const int32_t* S, int T, int16_t* bp,
                             int32_t* v_out, cudaStream_t stream) {
  chain_edge_kernel<<<1, GROUPS * B * B, 0, stream>>>(tblc, tbl2c, S, T, bp,
                                                      v_out);
  return (int)cudaGetLastError();
}
