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
// What bounds it on the H100: latency per level, and on one SM the
// level's 77,824 candidates (19 rows x 256 destinations x 16 (p, q)), each
// a data-dependent shared-memory gather: ~2,400 cycles of shared-memory
// wavefronts before bank conflicts. The card's bytes/s and operations/s
// are far away (26 KB and ~156k int32 operations a level).
//
// Design (chain_ring.cuh): one launch per chain, a cluster of CLUSTER
// blocks on as many SMs that split the 19 rows r of every level (block b
// takes rows [b * 19 / CLUSTER, (b + 1) * 19 / CLUSTER), at most two).
// Row r reads rows r, r - 1 and r - 2 of the previous level, so a block
// keeps V's rows from two below its first, and pushes each row it
// computes into the blocks that own rows r + 1 and r + 2: a halo of two
// rows, not a replica of V. A push is an st.async into the peer's shared
// memory that counts its 4 bytes on the peer's `halo` barrier of that V
// buffer, which waits for exactly the halo's bytes; a block's own rows
// are ordered by a block-scope fence. So the one cluster barrier a level
// orders no memory (a relaxed arrive): a releasing arrive on a cluster of
// blocks fenced at cluster scope and took ~1,300 cycles a level. V is
// double-buffered in every block, so that the barrier also keeps a peer
// from pushing into a buffer that is still being read. A block has 8
// consumer warps, a thread a destination (i2, j2) on its block's rows,
// and a producer warp that stages the level's tables D levels ahead (nine
// bulk copies: the [:4, :16] corners of pit and pwt, all of C). Between
// arriving at level t's barrier and waiting on it, a consumer reads level
// t + 1's tables into registers: 16 gather offsets (the weights folded in,
// V's rows being r + 2 with rows 0 and 1 NEG guards; an out-of-range
// source points at column 256, NEG on every row) and 16 scores. A level's
// chain is then the barrier, 16 gathers a row and the commit. The final V
// goes to v_out, which the TPU kernel kept in scratch.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): 0.765 us a
// level against the replaced single-block kernel's 5.318; clusters of
// 1 / 2 / 4 / 7 / 16 blocks 3.77 / 2.05 / 1.35 / 1.06 / 0.775.
#include "chain_ring.cuh"

namespace {

using namespace dg;

constexpr int R1 = 19;
constexpr int B = 16;
constexpr int P = 4;
constexpr int PB = P * B;
constexpr int CLUSTER = 10;            // ops/chain_ring.py STEP16_CLUSTER
constexpr int RMAX = (R1 + CLUSTER - 1) / CLUSTER;  // rows of a block
constexpr int D = 8;                   // ring depth (ops/chain_ring.py)
constexpr int W = B * B + 1;           // a row of V: 256 states, NEG column
constexpr int NEGCOL = B * B;
constexpr int KR = R1 + 2;             // rows of V: 2 NEG guards, then r
constexpr int CONSUMERS = B * B;       // a thread a destination (i2, j2)
constexpr int THREADS = CONSUMERS + 32;
constexpr int BLOCK = 8 * 128;         // words of a level's pi / pw block
constexpr int BEST0 = -2147483647;     // -2^31 + 1
static_assert(CLUSTER >= 1 && CLUSTER <= 16, "a cluster holds 1-16 blocks");

struct Stage {
  int C[PB * PB];
  int pi[P * B];  // the corner [:4, :16] of pit
  int pw[P * B];  // and of pwt
};
struct Smem {
  Stage ring[D];
  int V[2][KR * W];
  uint64_t full[D];
  uint64_t halo[2];  // a V buffer's rows from the peers have landed
};
constexpr uint32_t STAGE_BYTES = sizeof(Stage);
static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");

// The first row of block b, and the block that owns row x.
__device__ __forceinline__ int row_lo(int b) { return b * R1 / CLUSTER; }
__device__ __forceinline__ int owner(int x) {
  return ((x + 1) * CLUSTER - 1) / R1;
}

// Level t's gather offsets and scores of destination (i2, j2), from its
// stage.
__device__ __forceinline__ void tables(const Stage& st, int i2, int j2,
                                       int (&off)[P * P], int (&c)[P * P]) {
  int ub[P], vb[P], uw[P], vw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int u = st.pi[p * B + i2], v = st.pi[p * B + j2];
    const bool u_ok = (unsigned)u < (unsigned)B;
    const bool v_ok = (unsigned)v < (unsigned)B;
    // an out-of-range source reads the NEG column (ub = -1)
    ub[p] = u_ok ? u * B : -1;
    vb[p] = v_ok ? v : -1;
    uw[p] = u_ok && st.pw[p * B + (u & (B - 1))] > 0;
    vw[p] = v_ok && st.pw[p * B + (v & (B - 1))] > 0;
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const bool ok = (ub[p] | vb[q]) >= 0;
      off[p * P + q] = ok ? (2 - uw[p] - vw[q]) * W + ub[p] + vb[q]
                          : 2 * W + NEGCOL;
      c[p * P + q] = st.C[(p * B + i2) * PB + q * B + j2];
    }
}

__global__ void __launch_bounds__(THREADS, 1)
chain_step16_kernel(const int32_t* __restrict__ pit,
                    const int32_t* __restrict__ pwt,
                    const int32_t* __restrict__ C, int T,
                    int16_t* __restrict__ bp, int32_t* __restrict__ v_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32;
  const int rank = (int)ring::cluster_rank();
  const int lo = row_lo(rank), hi = row_lo(rank + 1);

  for (int i = tid; i < 2 * KR * W; i += THREADS) {
    const int k = (i / W) % KR, col = i % W;
    (&sm.V[0][0])[i] = (k >= 2 && col == 0) ? 0 : NEG;
  }
  if (tid == 0) {
    ring::init(sm.full, D);
    ring::init(sm.halo, 2);
  }
  __syncthreads();
  // no peer pushes into this block's V before it is set up
  ring::arrive();
  ring::wait_all();

  if (tid >= CONSUMERS) {  // the producer warp
    auto issue = [&](int t) {
      const int s = t % D;
      if (lane == 0) ring::expect_bytes(&sm.full[s], STAGE_BYTES);
      __syncwarp();
      if (lane < 2 * P) {  // a 64-byte row of a corner
        const int32_t* src = (lane < P ? pit : pwt) + (size_t)t * BLOCK +
                             (lane % P) * 128;
        int* dst = (lane < P ? sm.ring[s].pi : sm.ring[s].pw) +
                   (lane % P) * B;
        ring::bulk_load(dst, src, B * 4, &sm.full[s]);
      } else if (lane == 2 * P) {
        ring::bulk_load(sm.ring[s].C, C + (size_t)t * PB * PB, PB * PB * 4,
                        &sm.full[s]);
      }
    };
    for (int t = 0; t < D && t < T; ++t) issue(t);
    for (int t = 0; t < T; ++t) {
      ring::arrive_relaxed();
      ring::wait_all();
      if (t + D < T) issue(t + D);
    }
    ring::arrive_relaxed();  // the last pushes have landed everywhere
    ring::wait_all();
    return;
  }

  const int i2 = tid / B, j2 = tid % B;
  // the bytes of the two rows below this block's first, pushed by its peers
  const uint32_t halo_bytes = (lo - max(lo - 2, 0)) * B * B * 4;
  int off[P * P], c[P * P];
  if (T > 0) {
    ring::wait(&sm.full[0], 0);
    tables(sm.ring[0], i2, j2, off, c);
  }
  for (int t = 0; t < T; ++t) {
    const int nb = (t + 1) & 1;
    const int* Vc = sm.V[t & 1];
    int* Vn = sm.V[nb];
    // the halo of level t lands in V[nb] and completes phase t / 2 of
    // halo[nb] (a peer's st.async may count its bytes before this)
    if (tid == 0) ring::expect_bytes(&sm.halo[nb], halo_bytes);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      const int r = lo + k;
      if (r >= hi) break;
      int best = BEST0;
#pragma unroll
      for (int pq = 0; pq < P * P; ++pq) {
        const int g = Vc[off[pq] + r * W];
        const int key = (int)((unsigned)g * 16u + (unsigned)c[pq]);
        best = key > best ? key : best;  // the key wraps like int32
      }
      const int value = best >> 4;
      const int nv = value > -(1 << 18) ? value : NEG;
      const int at = (r + 2) * W + tid;
      Vn[at] = nv;
      // rows r + 1 and r + 2 read this one at the next level
#pragma unroll
      for (int x = r + 1; x <= r + 2; ++x) {
        const int dst = owner(x);
        if (x < R1 && dst != rank && (x == r + 1 || dst != owner(r + 1)))
          ring::store_peer(ring::peer_addr(Vn + at, dst), nv,
                           ring::peer_addr(&sm.halo[nb], dst));
      }
      bp[((size_t)t * R1 + r) * B * B + tid] = (int16_t)(best & 15);
    }
    // this block's rows are ordered by a block-scope fence and the peers'
    // by their barrier: the cluster barrier orders no memory
    __threadfence_block();
    ring::arrive_relaxed();
    if (t + 1 < T) {
      ring::wait(&sm.full[(t + 1) % D], ((t + 1) / D) & 1);
      tables(sm.ring[(t + 1) % D], i2, j2, off, c);
    }
    ring::wait(&sm.halo[nb], (t >> 1) & 1);
    ring::wait_all();
  }
  ring::arrive_relaxed();  // the last pushes have landed everywhere
  ring::wait_all();
  const int* Vf = sm.V[T & 1];
  for (int r = lo; r < hi; ++r) v_out[r * B * B + tid] = Vf[(r + 2) * W + tid];
}

cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes() {
  cudaError_t rc = cudaFuncSetAttribute(
      chain_step16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (rc == cudaSuccess && CLUSTER > 8)
    rc = cudaFuncSetAttribute(chain_step16_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
  return rc;
}

}  // namespace

// How many clusters of this kernel the current device holds at once, and
// the cluster's shape: out = {clusters, blocks a cluster, threads a
// block, shared bytes a block}. The wrapper refuses to launch at 0.
extern "C" int dg_chain_step16_fit(int* out) {
  cudaError_t rc = set_attributes();
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(&attr, 0);
  int clusters = 0;
  rc = cudaOccupancyMaxActiveClusters(&clusters, chain_step16_kernel, &cfg);
  out[0] = clusters;
  out[1] = CLUSTER;
  out[2] = THREADS;
  out[3] = (int)sizeof(Smem);
  return (int)rc;
}

extern "C" int dg_chain_step16(const int32_t* pit, const int32_t* pwt,
                               const int32_t* C, int T, int16_t* bp,
                               int32_t* v_out, cudaStream_t stream) {
  cudaError_t rc = set_attributes();
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(&attr, stream);
  rc = cudaLaunchKernelEx(&cfg, chain_step16_kernel, pit, pwt, C, T, bp,
                          v_out);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
