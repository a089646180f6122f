// K5b: the level chain of the floor probe with a DP-shaped body (B = 16
// vertices per level, P = 4 sources per vertex).
//
// Replaces scripts/tpu_floor_probe.py `build_pallas16`. Per level and per
// (p, q) the TPU kernel built a row gather and a column gather of V out of
// 16 selects each ("select-form gathers"), with a roll of V by one r for
// sources of weight 1, and kept a running max of `G * 16 + C`. Here each
// gather is an indexed shared-memory load: for destination (i2, j2),
// u = pi[p, i2], v = pi[q, j2], and the candidate is V[r - pw[q, v] -
// pw[p, u], u, v] with NEG shifted in below r = 0 at each of the two
// stages (the weights are looked up at the source indices, as the probe
// does). There is no validity mask: the probe's body is DP-shaped, not a
// checked DP, and this kernel computes what the probe computes.
//
// What bounds it on the H100: latency per level, as chain_pair.cu: two
// block barriers, 16 dependent shared-memory gathers per destination and
// row, and the level's 16 KB score table, which one block streams in;
// the card's bytes/s and operations/s are far away.
//
// Design: ONE block of 1,024 threads loops over the T levels, one launch
// per chain, V [19, 16, 16] int32 in shared memory. Thread (g, i2, j2)
// owns the destination on rows g, g + 4, ...; it reads V for all its
// rows, and after a barrier writes V and the int16 backpointers. Each
// thread fetches 16 bytes of level t + 1's score table (and a word of its
// pi / pw corner) into registers before it computes level t. cp.async /
// TMA prefetch several levels ahead is later work. The final V goes to
// v_out, which the TPU kernel kept in scratch.
#include "dg_common.cuh"

namespace {

constexpr int R1 = 19;
constexpr int B = 16;
constexpr int P = 4;
constexpr int PB = P * B;
constexpr int GROUPS = 4;              // row groups: 4 x 256 threads
constexpr int ROWS = (R1 + GROUPS - 1) / GROUPS;
constexpr int BLOCK = 8 * 128;         // words of a level's pi / pw block
constexpr int BEST0 = -2147483647;     // -2^31 + 1

__global__ void __launch_bounds__(GROUPS * B * B)
chain_step16_kernel(const int32_t* __restrict__ pit,
                    const int32_t* __restrict__ pwt,
                    const int4* __restrict__ C, int T,
                    int16_t* __restrict__ bp, int32_t* __restrict__ v_out) {
  using namespace dg;
  __shared__ int4 s_C4[PB * PB / 4];
  __shared__ int s_pi[P * B];
  __shared__ int s_pw[P * B];
  __shared__ int s_V[R1 * B * B];
  const int* s_C = reinterpret_cast<const int*>(s_C4);
  const int tid = threadIdx.x;
  const int grp = tid / (B * B), i2 = (tid / B) % B, j2 = tid % B;

  for (int i = tid; i < R1 * B * B; i += blockDim.x)
    s_V[i] = (i % (B * B) == 0) ? 0 : NEG;
  // the word of the pi / pw corner [:4, :16] this thread stages, if any
  const int32_t* src = nullptr;
  int* dst = nullptr;
  if (tid < 2 * P * B) {
    const int k = tid % (P * B);
    src = (tid < P * B ? pit : pwt) + (k / B) * 128 + k % B;
    dst = (tid < P * B ? s_pi : s_pw) + k;
  }
  int4 c4 = make_int4(0, 0, 0, 0);
  int word = 0;
  if (T > 0) {
    c4 = C[tid];
    if (src) word = src[0];
  }

  for (int t = 0; t < T; ++t) {
    s_C4[tid] = c4;
    if (dst) *dst = word;
    __syncthreads();  // level t's tables and level t - 1's V are in place
    if (t + 1 < T) {
      c4 = C[(size_t)(t + 1) * (PB * PB / 4) + tid];
      if (src) word = src[(size_t)(t + 1) * BLOCK];
    }

    int best[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) best[k] = BEST0;
    for (int p = 0; p < P; ++p) {
      const int u = s_pi[p * B + i2];
      const bool u_ok = (unsigned)u < (unsigned)B;
      const int wu = u_ok && s_pw[p * B + u] > 0;
      for (int q = 0; q < P; ++q) {
        const int v = s_pi[q * B + j2];
        const bool v_ok = (unsigned)v < (unsigned)B;
        const int wv = v_ok && s_pw[q * B + v] > 0;
        const unsigned c = (unsigned)s_C[(p * B + i2) * PB + q * B + j2];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int r = grp + GROUPS * k < R1 ? grp + GROUPS * k : 0;
          // column stage: A[r - wv, i2, v]; row stage: V[. - wu, u, v];
          // NEG is shifted in below r = 0 at each stage
          const int rv = r - wv - wu;
          const int g = (u_ok && v_ok && rv >= 0)
                            ? s_V[(rv * B + u) * B + v] : NEG;
          const int key = (int)((unsigned)g * 16u + c);  // wraps like int32
          best[k] = key > best[k] ? key : best[k];
        }
      }
    }
    __syncthreads();  // every read of V and of the tables is done

#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = grp + GROUPS * k;
      if (r >= R1) continue;
      const int value = best[k] >> 4;
      const int at = (r * B + i2) * B + j2;
      s_V[at] = value > -(1 << 18) ? value : NEG;
      bp[(size_t)t * R1 * B * B + at] = (int16_t)(best[k] & 15);
    }
  }
  __syncthreads();
  for (int i = tid; i < R1 * B * B; i += blockDim.x) v_out[i] = s_V[i];
}

}  // namespace

extern "C" int dg_chain_step16(const int32_t* pit, const int32_t* pwt,
                               const int32_t* C, int T, int16_t* bp,
                               int32_t* v_out, cudaStream_t stream) {
  chain_step16_kernel<<<1, GROUPS * B * B, 0, stream>>>(
      pit, pwt, reinterpret_cast<const int4*>(C), T, bp, v_out);
  return (int)cudaGetLastError();
}
