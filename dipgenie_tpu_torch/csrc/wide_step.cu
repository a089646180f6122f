// K4: one wide pair-DP transition over one tp rank's share of its
// window-split 256-pair chunks: the rank's partial state, before the merge.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_wide_step_kernel`
// (launched by `_wide_step_call`), which the JAX package runs for every
// wide run under a mesh with a "tp" axis. There each device owns the
// destination windows `win % n_tp`; its kernel set the [R1P, NB * 1024]
// partials (R1P: R + 1 padded to the TPU's 24 or 32 rows, NB <= 31) to
// NEG / -1, then for each of its chunks gathered with block-masked one-hot
// matmuls, extracted the per-destination winner with a segmented scan and
// read-modify-wrote the chunk's window with a strict `>`. No commit: a
// `pmax` over tp and a presence mask follow outside the kernel. Here the
// rank's share runs K3's transition body (csrc/wide_split.cuh: slices of
// the rank's chunks, candidates in shared memory, first-max reductions in
// slot order, a cut heavy destination combined after a grid barrier) and
// writes the partial: value and ordinal `sbase + lane` where a valid
// candidate of the rank reached the lane, NEG / -1 elsewhere (an invalid
// candidate never shows: NEG, not the TPU kernel's internal -OFF), on the
// lanes [0, W) of the transition (ops/plan.py:split_slices, one buffer).
// Lanes past W keep what the buffer holds: the wrapper fills a new
// partial with NEG / -1, and the run's merged partial of the transition
// before holds them there (no rank reached them).
//
// Here the partial is [R + 1, NB * 1024] for any R and any NB the planner
// makes (up to 256 windows; the window-split packing holds gidx < 2^18).
//
// What bounds it on the H100: a rank reads its share of the transition's
// table (at NB 31 ~40k pairs / n_tp x 8 B), gathers from the replicated
// state (at R = 18, NB = 31: 19 x 31 x 4 KB = 2.4 MB, L2-resident) and
// writes the partial's V and bp planes below W (up to 4.8 MB): ~1-2 us of
// device memory traffic. It is bound by one round of L2 gathers, the
// reductions and the slowest block, and on the path by the merge that
// follows each transition (an all_reduce of the partial). Design: one
// cooperative launch a transition, as the merge needs the partial between
// transitions (the kernel K3 runs with T = 1); the kernel it replaced took
// two launches, a 64-bit atomicMax per candidate into a key scratch and a
// pass over the whole state.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): F1's 169
// prefix transitions 2.13-2.17 ms of device time against the replaced
// kernel's 2.14-2.15 (2.48 with its keys' zeroing); writing the whole
// partial every transition instead of the lanes [0, W) costs 0.44 us a
// transition more.
#include "wide_split.cuh"

// stbl, swin, sbase: the rank's share of the run's window-split chunks;
// desc [4] and cuts [G * m + 1, 2]: the transition's rows of the share's
// slice tables (ops/plan.py:split_slices). v [R1, NB * 1024] the state
// before the transition; part [2, R1, NB * 1024] (plane 0 V, plane 1 bp),
// lanes past the transition's W left as they are; rec [G * m, 2, R1] int2
// scratch. K4's grid is K3's (dg_wide_split_grid): the same kernel body
// and shared memory.
extern "C" int dg_wide_step(const int32_t* stbl, const int32_t* swin,
                            const int32_t* sbase, const int32_t* desc,
                            const int32_t* cuts, int R1, int NB, int G, int m,
                            const int32_t* v, int32_t* part, int32_t* rec,
                            cudaStream_t stream) {
  const int lanes = NB * 1024;
  Run x{stbl, swin, sbase, reinterpret_cast<const int4*>(desc),
        reinterpret_cast<const int2*>(cuts), 1, R1, lanes, G * m, m,
        v, lanes, nullptr, part, part + (size_t)R1 * lanes,
        reinterpret_cast<int2*>(rec)};
  return launch<true>(x, G, stream);
}
