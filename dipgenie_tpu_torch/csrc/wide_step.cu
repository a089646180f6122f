// K4: one wide pair-DP transition over one tp rank's share of its
// window-split 256-pair chunks: the rank's partial state, before the merge.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_wide_step_kernel`
// (launched by `_wide_step_call`), which the JAX package runs for every
// wide run under a mesh with a "tp" axis. There each device owns the
// destination windows `win % n_tp`; its kernel set the [R1P, NB * 1024]
// partials (R1P: R + 1 padded to the TPU's 24 or 32 rows, NB <= 31) to
// NEG / -1, then for each of its chunks gathered with
// block-masked one-hot matmuls, extracted the per-destination winner with a
// segmented scan and read-modify-wrote the chunk's window with a strict
// `>`. No commit: a `pmax` over tp and a presence mask follow outside the
// kernel. Here the chunks max-reduce 64-bit keys (dg_common.cuh: value,
// then the smallest ordinal `sbase + lane`, the strict `>` rule) into the
// global lane `swin * 1024 + rel` (dg::window_candidates, K3's pass), and
// one pass over the state turns the keys into the partial: value and
// ordinal where a valid candidate of the rank reached the lane, NEG / -1
// elsewhere (an invalid candidate never shows: NEG, not the TPU kernel's
// internal -OFF), and swaps the keys back to 0 for the next transition.
//
// Here the partial is [R + 1, NB * 1024] for any R and any NB the planner
// makes (up to 256 windows; the window-split packing holds gidx < 2^18).
//
// What bounds it on the H100: a rank reads its share of the transition's
// table (at NB 31 ~40k pairs / n_tp x 8 B), gathers from the replicated
// state (at R = 18, NB = 31: 19 x 31 x 4 KB = 2.4 MB, L2-resident, the
// keys twice that) and writes the partial V and bp planes (4.8 MB): ~2 us
// of device memory
// traffic. It is bound by L2 gather and atomic latency and two launches,
// and on the path by the merge that follows each transition (an
// all_reduce of the 4.8 MB partial). Design: one host call per transition,
// as the merge needs the partial between transitions: (1) one block per
// chunk of the rank's share, one thread per pair lane, looping over rows;
// (2) a grid over the whole state that writes the partial into part
// [2, R1, NB * 1024] (plane 0 V, plane 1 bp) and zeroes the keys. A rank
// with no chunk in the transition launches (2) only.
#include "dg_common.cuh"

namespace {

__global__ void step_partial(int n, dg::Key* keys, int32_t* part) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const dg::Key k = keys[i];
  keys[i] = 0;
  part[i] = k == 0 ? dg::NEG : (int)(k >> 32) - 1 + dg::REACH_T;
  part[n + i] = k == 0 ? -1 : dg::key_ordinal(k);
}

}  // namespace

// stbl, swin, sbase: the rank's share of the run's window-split chunks;
// the transition's are rows [c0, c0 + nch). V [R1, NB * 1024] the state
// before the transition; keys [R1, NB * 1024] all 0 (left all 0).
extern "C" int dg_wide_step(const int32_t* stbl, const int32_t* swin,
                            const int32_t* sbase, int c0, int nch, int R1,
                            int NB, const int32_t* V, dg::Key* keys,
                            int32_t* part, cudaStream_t stream) {
  const int lanes = NB * 1024;
  const int n = R1 * lanes;
  if (nch > 0) {
    dg::window_candidates<<<nch, dg::CHUNK, 0, stream>>>(
        stbl, swin, sbase, c0, R1, lanes, V, keys);
  }
  step_partial<<<(n + 255) / 256, 256, 0, stream>>>(n, keys, part);
  return (int)cudaGetLastError();
}
