// K2: one run of wide pair-DP transitions over dense 256-pair chunks.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_wide_dense_kernel`
// (launched by `_wide_call`). On the TPU a chunk's gather was a block-
// masked one-hot matmul per source window and its results were extracted
// and read-modify-written per spanned destination window under static
// branches; here a chunk's lanes gather by indexed load from anywhere in
// the [R+1, NB * 1024] state and max-reduce straight into the global
// destination lane with a 64-bit atomicMax (dg_common.cuh), so window
// spans and first-touch masks disappear. The commit rewrites every lane
// of every window, so lanes no kept pair reaches (holes, windows past the
// extent: the round-4 stale-window bug) become NEG by construction.
//
// What bounds it on the H100: a wide transition has up to ~30k pairs x
// (R+1) rows, i.e. tens to a few hundred blocks of work: latency of
// L2-resident gathers and atomics (at R = 18 the state is at most
// 19 x 31 x 4 KB = 2.4 MB and the keys twice that, inside the 50 MB L2), plus
// two launches per transition. Design: a host loop over the run's
// transitions launches (1) one block per chunk, one thread per pair lane,
// looping over rows, and (2) a commit grid over the whole state that
// swaps the keys back to 0 and writes V and the int32 backpointers of the
// transition. Fusing a run into one persistent launch is later work.
#include "dg_common.cuh"

namespace {

__global__ void __launch_bounds__(dg::CHUNK)
wide_candidates(const int32_t* __restrict__ dtbl, int c0, int R1, int lanes,
                const int32_t* __restrict__ V, dg::Key* keys) {
  using namespace dg;
  const int32_t* row0 = dtbl + ((size_t)(c0 + blockIdx.x) * 2) * CHUNK;
  const int packed = row0[threadIdx.x];
  const int score = row0[CHUNK + threadIdx.x];
  if (score == PAD_SC) return;  // dense pads decode as a real lane
  const int gidx = (packed >> 17) & 32767;
  const int dst = (packed >> 2) & 32767;  // win << 10 | rel
  const int wsum = packed & 3;
  const int ordinal = blockIdx.x * CHUNK + threadIdx.x;
  for (int r = wsum; r < R1; ++r) {
    const int c = V[(size_t)(r - wsum) * lanes + gidx];
    if (c < REACH_T) continue;
    atomicMax(&keys[(size_t)r * lanes + dst], make_key(c + score, ordinal));
  }
}

__global__ void wide_commit(int n, int32_t* V, dg::Key* keys, int32_t* bp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const dg::Key k = keys[i];
  keys[i] = 0;
  V[i] = dg::key_value(k);
  bp[i] = dg::key_ordinal(k);
}

}  // namespace

// bounds: HOST array [T + 1] of the transitions' dense chunk ranges.
extern "C" int dg_wide_dense_run(const int32_t* dtbl, const int32_t* bounds,
                                 int T, int R1, int NB, int32_t* V,
                                 dg::Key* keys, int32_t* bp,
                                 cudaStream_t stream) {
  const int lanes = NB * 1024;
  const int n = R1 * lanes;
  const int commit_blocks = (n + 255) / 256;
  for (int t = 0; t < T; ++t) {
    const int nch = bounds[t + 1] - bounds[t];
    if (nch > 0) {
      wide_candidates<<<nch, dg::CHUNK, 0, stream>>>(dtbl, bounds[t], R1,
                                                     lanes, V, keys);
    }
    wide_commit<<<commit_blocks, 256, 0, stream>>>(n, V, keys,
                                                   bp + (size_t)t * n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
