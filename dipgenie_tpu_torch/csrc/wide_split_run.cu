// K3: one run of wide pair-DP transitions over window-split 256-pair
// chunks (every chunk's pairs land in one 1024-lane destination window).
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_wide_split_kernel`
// (launched by `_wide_split_call`), which the JAX package runs for wide
// runs of more than 18 windows (NB 19-31, level widths ~136-177). The port
// sends it every run past 18 windows, up to the planner's 256 (level width
// 512: the window-split packing holds gidx < 2^18), at any R. On the
// TPU a chunk gathered with block-masked one-hot matmuls over the source
// windows in its gather mask, extracted the per-destination winner with a
// segmented scan, and read-modify-wrote its one destination window with a
// strict `>` so that earlier chunks won ties; a presence mask then reset
// absent windows to NEG. Here a chunk's lanes gather by indexed load from
// anywhere in the [R+1, NB * 1024] state and max-reduce straight into the
// global destination lane `wwin * 1024 + rel` with a 64-bit atomicMax on
// the order-independent key of dg_common.cuh (value, then the smallest
// pair ordinal `wbase + lane`): the same winner as the strict `>` RMW. The
// commit rewrites every lane of every window, so lanes no kept pair
// reaches (holes, windows past the extent) become NEG with no presence
// mask, and writes the int32 backpointers of the windows below the
// transition's extent to rows `tb_bprow[t] + win` of bp [nrows, R+1, 1024]
// (hole windows get ordinal 0; the JAX kernel leaves them unwritten).
//
// What bounds it on the H100: at NB = 31 a transition has ~40k pairs x
// (R+1) rows of candidates, gathered from and reduced into a state of
// 19 x 31 x 4 KB = 2.4 MB at R = 18 (keys twice that), all L2-resident;
// the bytes that must reach device memory are the backpointers, ~2 MB per
// transition (R + 1 rows x 4 KB per window). So a transition costs the latency of L2 gathers and atomics
// plus one pass writing its backpointers, and two launches. Design (K2's):
// a host loop over the run's transitions launches (1) one block per chunk,
// one thread per pair lane, looping over rows (dg::window_candidates,
// shared with K4), and (2) a commit grid over the whole state that swaps
// the keys back to 0. A persistent launch per run is later work.
#include "dg_common.cuh"

namespace {

// bp points at row tb_bprow[t]; lanes below ext_lanes have a bp row
__global__ void split_commit(int n, int lanes, int ext_lanes, int32_t* V,
                             dg::Key* keys, int32_t* bp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const dg::Key k = keys[i];
  keys[i] = 0;
  V[i] = dg::key_value(k);
  const int r = i / lanes;
  const int l = i - r * lanes;
  if (l < ext_lanes) {
    const int R1 = n / lanes;
    bp[((size_t)(l >> 10) * R1 + r) * 1024 + (l & 1023)] = dg::key_ordinal(k);
  }
}

}  // namespace

// bounds: HOST array [T + 1] of the transitions' chunk ranges; bprow and
// ext: HOST arrays [T], each transition's first bp row and its extent in
// windows.
extern "C" int dg_wide_split_run(const int32_t* tbl, const int32_t* wwin,
                                 const int32_t* wbase, const int32_t* bounds,
                                 const int32_t* bprow, const int32_t* ext,
                                 int T, int R1, int NB, int32_t* V,
                                 dg::Key* keys, int32_t* bp,
                                 cudaStream_t stream) {
  const int lanes = NB * 1024;
  const int n = R1 * lanes;
  const int commit_blocks = (n + 255) / 256;
  for (int t = 0; t < T; ++t) {
    const int nch = bounds[t + 1] - bounds[t];
    if (nch > 0) {
      dg::window_candidates<<<nch, dg::CHUNK, 0, stream>>>(
          tbl, wwin, wbase, bounds[t], R1, lanes, V, keys);
    }
    split_commit<<<commit_blocks, 256, 0, stream>>>(
        n, lanes, ext[t] * 1024, V, keys, bp + (size_t)bprow[t] * R1 * 1024);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
