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
// absent windows to NEG. Here every candidate is an indexed load from
// anywhere in the state, and each destination's winner a reduction over
// its pairs, which are one run of slots in plan order (csrc/wide_split.cuh,
// the transition body K4 shares).
//
// The traffic it was designed for: phase E of chip_smoke.py (R = 18,
// NB 31) has 3,900 wide transitions in 300 runs of 13, ~40k real pairs a
// transition in ~176 chunks (93% full) onto ~13k destinations of an
// extent of ~25k lanes, 25 pairs into one destination at the median; a
// band's last transition (wide into narrow) puts up to ~3,800 pairs on
// one destination.
//
// What bounds it on the H100: the bytes that must reach device memory are
// the backpointers, ~1.9 MB a transition (R + 1 rows x 4 KB per window
// below the extent); the state (2.4 MB a buffer at NB 31) stays in the
// 50 MB L2. The level chain is serial, so a transition costs a grid-wide
// barrier, one round of L2 gathers, shared-memory reductions and the
// slowest block. The kernel it replaced took two launches a transition, a
// 64-bit atomicMax per candidate into a key array and a pass over the
// whole state to commit it (11.6 us a transition on E).
//
// Design: ONE cooperative launch a run of as many blocks of 1,024 threads
// as the card holds at once (dg_wide_split_grid; one an SM, 132 on an
// H100 SXM; where they cannot be co-resident the launch is refused and
// the wrapper raises), a grid-wide barrier between transitions (two on a
// transition with a cut heavy destination). V is double-buffered in
// global memory, [2, R+1, NB * 1024]: transition t reads buffer t & 1
// (V_in itself at t = 0) and writes buffer (t + 1) & 1, lanes [0, W) only:
// W covers this transition's extent and that of the one two before it, the
// last to write the same buffer (the whole state for the first two), so
// lanes past it hold NEG from an earlier write, as the plain version's
// full rewrite leaves them. Reads of V bypass L1 (ld.global.cg): other SMs
// wrote them. The slices' first lanes and slots are shipped
// (ops/plan.py:split_slices, cut on the card at ship time, ~4 MB on E), so
// a block searches nothing.
//
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W): E's 300
// runs 48.3-48.6 ms of device time (12.0-12.2 us an ordinary transition;
// a band end 15.1 with its heavy destinations cut over slices, 18.1
// without, as now) against the replaced kernel's 44.5-44.6 and K2's
// 47.6-50.8 on the same runs; E's forward 334 ms against 340 through the
// replaced kernel (its host loop of 7,800 launches). A slice costs ~5.6 us
// plus ~4.7 ns a lane and ~6.7 ns a slot (phase stamps): a lane-major
// state, staged chunk tables and rows split over threads were no faster.
#include "wide_split.cuh"

// The blocks of K3's grid the current device holds at once.
extern "C" int dg_wide_split_grid(int* blocks) {
  return coop::held_blocks((const void*)split_kernel<false>, SMEM_BYTES,
                           blocks);
}

// tbl [chunks, 2, 256], wwin, wbase [chunks]; desc [T, 4], cuts [T, G * m
// + 1, 2] (ops/plan.py:split_slices); v_in [R1, 1024]; V [2, R1, NB *
// 1024] (the output state is buffer T & 1); bp [nrows, R1, 1024], every
// row written; rec [G * m, 2, R1] int2 scratch.
extern "C" int dg_wide_split_run(const int32_t* tbl, const int32_t* wwin,
                                 const int32_t* wbase, const int32_t* desc,
                                 const int32_t* cuts, int T, int R1, int NB,
                                 int G, int m, const int32_t* v_in,
                                 int32_t* V, int32_t* bp, int32_t* rec,
                                 cudaStream_t stream) {
  const int lanes = NB * 1024;
  Run x{tbl, wwin, wbase, reinterpret_cast<const int4*>(desc),
        reinterpret_cast<const int2*>(cuts), T, R1, lanes, G * m, m,
        v_in, 1024, V, V + (size_t)R1 * lanes, bp,
        reinterpret_cast<int2*>(rec)};
  return launch<false>(x, G, stream);
}
