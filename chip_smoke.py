#!/usr/bin/env python3
"""Smoke run of dipgenie_tpu_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the script exits non-zero and prints no
result line):

  A. build the CUDA kernels (csrc/*.cu, one nvcc per source, sm_90a), the
     port's native runtime and the JAX package's (the reference CLI of
     phase D), all at once;
  B. every kernel against its plain PyTorch version on the card, exact
     integer equality, on every segment of the three real MHC slices
     (tests/data) and of the random instances of the JAX package's tests,
     once on the main path's routing and once with K3 forced over every
     wide run; then the DP results against the slices' baked exact-tier
     oracles and the random instances' native-tier results; the same, K4's
     shards included, on three graphs past the TPU planner's limits
     (LIMIT_B: R = 40, a wide run of 36 windows, values past 4,100,000)
     against the native tier; and K1's global-state path
     (GLOBAL_STATE_CASE, R = 60: a narrow run whose V does not fit shared
     memory) the same way, then through PairDiploidDP with its launches
     counted, and beside its plain version;
  G. the level-chain probes (K5a chain_floor, K5b chain_step16, K6
     chain_pair, K7 chain_edge; each walks a chain of DP levels in one
     launch: K6 and K7 one block whose producer warp stages the tables in
     a ring, K5b a cluster of blocks on as many SMs, one per share of the
     rows, with the same ring; K5a a scan of the chain's prefix sums over
     the card's blocks): G1 each kernel against its plain version on short
     chains (every output element, exact), K6 and K7 against the numpy
     oracle and against each other; G2 the floor, pair and edge probes at
     their full chain lengths through their entry functions (launch
     counts, per-level slopes; K6 and K7 on the scripts' chain, whose
     states die out, and on one that stays alive), each kernel beside its
     plain version and its bound at the shorter length (K5a beside
     torch.cumsum at both lengths), and the plain versions' slopes on
     short chains; G3
     the compiled parity gate (build/GPU_PARITY.json);
  C. the DP at MHC scale (R = 18, ~4.7e8 states, synthetic MHC-shaped
     graph, wide levels 33-96): launch counts of the main path, forward
     and traceback times, states/s and peak memory, equality with the
     native C++ tier, K-T on the whole plan (trace() and the launch alone
     by CUDA events, the host part by the host clock), K2's grid and
     largest slice, and K1's, K2's and K-T's times beside their plain
     versions' and their bounds on a plan prefix; the DP stage probe on
     the same plan, and K1's time per transition beside phase G's floors;
  U. (after C, on C's graph and native result) the fused and chunked
     tiers (K13 fused_forward and K14 fused_trace, csrc/fused_dp.cu; K15
     chunk_step and K16 chunk_trace, csrc/chunk_dp.cu): U1 each kernel
     against its plain version on every output element, exact, on the
     three slices, the JAX tiers' random graphs, the high in-degree graph
     (in-degree 40) and W's transitions into and out of its widest level
     (1,022; the next in-degree 152) from a random state, then K13 and K15
     over whole plans and across run ends, bands at and one past the run
     kernel's shared-memory edge included, and K15's per-transition
     kernel on tp shares (chunk_share) on every wide transition of C's
     first U_PREFIX, for 1, 2 and 3 ranks: each share equal to its plain
     version, the shares stitched equal to the unshared launch, words
     included; U2 both tiers on C through the
     solver's entry (launches counted against the host cut,
     ops/vertex_plan.py:plan_launches: one a run of narrow transitions,
     one a wide transition, K15 in the forward and the replay, K16 once a
     replay span), then by stages (plan beside plan_pairs', ship, forward
     and traceback by CUDA events, peak memory, states/s), each equal to
     the native tier, K13's device time split between its run and
     per-transition kernels, and each kernel beside its plain version and
     its bound on C's first U_PREFIX transitions; U3 W
     (synth.mhc_shaped_csr with 20 bands of levels 513-1,024 wide, ~2.9e9
     states) through --dp-backend auto: the torch tier's planner stops at
     its window limit with one [W::diploid_dp] line, the fused tier runs
     and equals the native tier; then the chunked tier on W, its peak
     memory beside the fused tier's;
  E. the big-window DP (the same shape on L_E levels, with wide levels
     141-177, ~9.5e8 states, every wide run 31 windows): the same readings for its main
     path through K3 (K-T on the whole plan too), K3 beside its plain
     version and its bound on a prefix, K2 against K3 on the same big runs
     (equal V and traceback records, both times), and K3's device time a
     transition on ordinary and on band-end transitions beside E's
     whole-plan bound;
  F. the tp-sharded wide path (every wide run through K4 on this rank's
     destination windows, merged by all_reduce(MAX) after each
     transition) on phase E's plan, reused: F1 in a one-rank gloo mesh in
     this process (K4's launches, forward and traceback times, peak
     memory, K4's device time beside K3's on the same runs, K4 beside its
     plain version and its bound on a prefix; the DP equal to phase E's,
     which equals the native tier); F2 in F_RANKS gloo ranks spawned on
     the one card, on the plan's first L_F2 levels (the depth is cut to
     keep this script well inside its time; each rank's DP equal to the
     single-device path's on the same levels; forward, merge and traceback
     seconds per rank). The merges of ranks that share a card
     are gloo's, staged through host memory: not a multi-card number;
  S. device sketching, the dp sketch count and the fitter's grid NLL
     (K10 minimizer_sketch, K11 sketch_count, K12 grid_nll and its table
     pass grid_tables) on a synthetic
     pangenome of the MHC's size (S_BP bp, S_WALKS walks, reads from two
     walks at 2x: 131,201 reads of 150 bp): S1 each kernel against its
     plain version on the main path's inputs (all the reads, a haplotype,
     the reads' windows against the haplotypes' table, the histogram's
     default grid) and on seeded ragged reads, K10 also on rows at the
     edges of its blocks (S1_SHAPES), K11 also on the adversarial tables
     of utils/synth.count_tables, on hashes at the ends of the range and
     with no emitted window, exact for K10 and K11, K12 within a relative
     1e-5, grid_tables within a relative 1e-5 an entry and its clamped
     entries equal, each beside its plain version's time and its bound,
     K10's, K11's and K12's as SM-cycles a window, an emitted window and a
     grid point too; S2 the port's anchor stage with device sketching equal, field
     for field, to the host sketcher's, K10's launches and device time for
     the haplotypes and the reads (CUDA events), the drivers' host share
     and the native sketcher's time; S3 fit_histogram with the torch
     backend (grid_tables and K12 on the card, one launch each) equal to
     the numpy backend at the pipeline's options, and its device stages
     (grid_inputs, K12, the readback) each by CUDA events and by the host
     clock after a synchronize, beside the whole fit; S4 F_RANKS gloo ranks spawned on the card with a
     (n_dp = 2, n_tp = 1) mesh: the dp sketch-count step on S2's reads
     (one empty read pads them to an even count) equal to one rank's in
     this process, the dp read sketch equal to S2's sets, then
     dryrun_multichip(2) (entry.py);
  D. the port's CLI with its default flags on three synthetic pangenomes
     (8 walks over 500 kbp; 18 and 24 walks over 200 kbp, whose plans hold
     runs of more than 18 windows, and for 24 walks of more than 31),
     byte-identical FASTA and stdout (apart from the timing line) against
     the JAX package's CLI on its native tier, run as a subprocess; the
     widest run, K3's launches and the peak device memory from the port's
     log; on the 8-walk pangenome the port's CLI also runs with
     --sketch-backend device, its FASTA byte-identical to the native
     tier's;
  F3. the port's pipeline with a mesh of F_RANKS gloo ranks on the card on
     phase D's 18-walk pangenome: each rank's FASTA byte-identical to
     phase D's native-tier FASTA, every wide run through K4;
  F4. the chunked tier over a tp mesh (ops/chunked.py:chunk_step_tp: K15's
     runs on every rank, each wide transition split by destination pairs
     over the ranks, chunk_share, with one all-gather, K16 on every rank)
     through the solver's entry: F4a C on a one-rank gloo mesh in this
     process (the merges' cost alone), then one share of C's widest
     wide transition beside its plain version and its bound; F4b C on
     F_RANKS gloo ranks sharing the card; F4c W's first F4_W_BANDS band(s)
     (a prefix of W closed by a sink: each wide gather through gloo moves
     ~0.4 GB) on F_RANKS ranks through --dp-backend auto, whose planner
     stops at its window limit with one [W::diploid_dp] line naming the
     chunked tier over the mesh. Every rank's result equals the native
     tier (C's, and on W's prefix the single-device chunked tier's and the
     native tier's on the same levels); each part logs forward and
     traceback seconds (CUDA events), the all-gathers (count, bytes, host
     seconds, the host's wait for the card before them), K15's run and
     share launches, K16's launches and the peak memory per rank. The
     ranks' gathers are gloo's, staged through host memory: not a
     multi-card number;
  H. (run after G) the 30 capability checks (K8, K9: csrc/caps_*.cu):
     H1 the probes caps and caps2 through their entry functions (one
     launch per check, 30 PASS lines), then every kernel against its plain
     version and the numpy expectation on every element (floats as floats),
     on the scripts' inputs and on the second inputs; H2 each kernel's time
     per launch beside its plain version's and, where one PyTorch call
     computes the same output, that call's (CUDA events over H_CALLS
     launches, min of 2, in turns), the kernel's and the call's device time
     per launch (profiler), and the bound.

Before the last line it prints the card's name and power limit
(nvidia-smi) and one JSON object of per-kernel results; the last line is
the JSON status object. Logs and tables go to build/chip_smoke/.
Arguments, when given, name the phases to run (``python3 chip_smoke.py C
U``); the per-kernel line then lists the kernels those phases measured.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
DEVICE = "cuda"
SEED = 0
R = 18
L_MHC = 120_000
N_BANDS = L_MHC // 400  # wide bands of 12 levels, as in the MHC graph
# depth of phase E (and F1, on E's plan), cut to keep this script well
# inside its time: its host planner alone took 106-130 s at L_MHC
L_E = L_MHC // 2
L_F2 = L_MHC // 4  # depth of phase F2, a prefix of phase E's plan
PREFIX_TRANSITIONS = 5000
BIG_WIDTHS = (141, 177)  # wide levels of phase E: NB 31 runs
# (n_bp, n_walks) of phase D's pangenomes. The widest expanded-graph
# level grows with the walks: 16 give no run of more than 18 windows, 18
# three runs of 31 windows, 24 runs of 19-31 windows and two of more than
# 31 (levels up to width 214), past the TPU planner's limits
PANGENOMES = ((500_000, 8), (200_000, 18), (200_000, 24))
# phase S's pangenome: the size of the reference's MHC test set (a 4.92
# Mbp reference; SURVEY.md:328) with 8 walks, reads from two of them at 2x
S_BP, S_WALKS, S_K, S_W = 4_920_000, 8, 31, 25
# phase S1's rows at the edges of the sketch kernel's blocks (k, w, B, L;
# csrc/sketch.cu: a block takes 256 windows of the flat range b * NW + j):
# one window a row, 150 bp rows, 256 and 257 windows a row, 400 bp, at the
# CLI's (k, w) and at (32, 3), (5, 1), and rows of 9 bases (a block's
# 16-aligned start reaches back over rows); no B is a multiple of the rows
# a block holds
S1_SHAPES = ((S_K, S_W, 203, S_K + S_W - 1), (S_K, S_W, 1001, 150),
             (S_K, S_W, 13, 256 + S_K + S_W - 2),
             (S_K, S_W, 13, 256 + S_K + S_W - 1), (S_K, S_W, 37, 400),
             (32, 3, 1001, 150), (5, 1, 1001, 150), (5, 1, 301, 9))
S1_COUNT_READS = 4096  # reads whose hashes make S1's adversarial tables
S_CALLS = 20  # kernel launches per CUDA-event timing in phase S1
S_PLAIN_CALLS = 2  # plain-version calls per timing in phase S1
GRID_NLL_RTOL = 1e-5  # K12 against its plain version: |a - b| / max(|b|, 1)
S3_REPEATS = 5  # timings of phase S3's device stages, min taken
# the C entry point of each of phase S's kernels
S_ENTRY = {"minimizer_sketch": "dg_sketch", "sketch_count": "dg_sketch_count",
           "grid_nll": "dg_grid_nll", "grid_tables": "dg_grid_tables"}
# special function unit results a second (one a log): 16 a clock on each
# of the 132 SMs (CUDA C programming guide, compute capability 9.0) at the
# H100 SXM's 1,980 MHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
# phase B's graphs past the TPU planner's limits (utils/synth.py)
LIMIT_B = ("R40", "width190", "values")
PORT_CLI = ["-m", "dipgenie_tpu_torch"]  # the port's CLI, default flags

NPZ = ("mhc_slice_csr", "mhc_slice500_csr", "mhc_slice_wide_csr")
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w", "hom_ptr",
            "hom_colors", "het_ptr", "het_colors")
KERNELS = {
    "narrow_run": ("dipgenie_tpu_torch/csrc/narrow_run.cu",
                   "dipgenie_tpu/ops/diploid_pallas.py:861"),
    # K1 with V in global memory, for runs whose V does not fit shared
    # memory (phase B's GLOBAL_STATE_CASE)
    "narrow_run_global": ("dipgenie_tpu_torch/csrc/narrow_run.cu",
                          "dipgenie_tpu/ops/diploid_pallas.py:861"),
    "wide_dense_run": ("dipgenie_tpu_torch/csrc/wide_dense_run.cu",
                       "dipgenie_tpu/ops/diploid_pallas.py:1388"),
    "wide_split_run": ("dipgenie_tpu_torch/csrc/wide_split_run.cu",
                       "dipgenie_tpu/ops/diploid_pallas.py:1142"),
    "trace": ("dipgenie_tpu_torch/csrc/trace.cu",
              "dipgenie_tpu/ops/diploid_pallas.py:1914"),
    "wide_step": ("dipgenie_tpu_torch/csrc/wide_step.cu",
                  "dipgenie_tpu/ops/diploid_pallas.py:1673"),
    "minimizer_sketch": ("dipgenie_tpu_torch/csrc/sketch.cu",
                         "dipgenie_tpu/ops/sketch_jax.py:229"),
    "sketch_count": ("dipgenie_tpu_torch/csrc/sketch_count.cu",
                     "dipgenie_tpu/parallel/mesh.py:63"),
    "grid_nll": ("dipgenie_tpu_torch/csrc/grid_nll.cu",
                 "dipgenie_tpu/models/fitter.py:191"),
    # the tables _grid_nll_jax builds before its map (:201-233)
    "grid_tables": ("dipgenie_tpu_torch/csrc/grid_nll.cu",
                    "dipgenie_tpu/models/fitter.py:201"),
    "chain_floor": ("dipgenie_tpu_torch/csrc/chain_floor.cu",
                    "scripts/tpu_floor_probe.py:76"),
    "chain_step16": ("dipgenie_tpu_torch/csrc/chain_step16.cu",
                     "scripts/tpu_floor_probe.py:110"),
    "chain_pair": ("dipgenie_tpu_torch/csrc/chain_pair.cu",
                   "scripts/tpu_pair_probe.py:103"),
    "chain_edge": ("dipgenie_tpu_torch/csrc/chain_edge.cu",
                   "scripts/tpu_edge_probe.py:94"),
    # the fused and chunked tiers (XLA device functions of the JAX package)
    "fused_forward": ("dipgenie_tpu_torch/csrc/fused_dp.cu",
                      "dipgenie_tpu/ops/diploid_fused.py:462"),
    "fused_trace": ("dipgenie_tpu_torch/csrc/fused_dp.cu",
                    "dipgenie_tpu/ops/diploid_fused.py:530"),
    "chunk_step": ("dipgenie_tpu_torch/csrc/chunk_dp.cu",
                   "dipgenie_tpu/ops/diploid_jax.py:177"),
    "chunk_trace": ("dipgenie_tpu_torch/csrc/chunk_dp.cu",
                    "dipgenie_tpu/ops/diploid_jax.py:543"),
    # K15's per-transition kernel on one tp rank's destination pairs (the
    # JAX tier's step sharded over tp)
    "chunk_share": ("dipgenie_tpu_torch/csrc/chunk_dp.cu",
                    "dipgenie_tpu/parallel/mesh.py:90"),
}
# the level-chain kernels (phase G), in the order of their probes
CHAINS = ("chain_floor", "chain_step16", "chain_pair", "chain_edge")
# the kernel wrapper of each plan segment kind (ops/plan.py:segment_kind)
KIND_KERNEL = {"narrow": "narrow_run", "wide": "wide_dense_run",
               "wide_split": "wide_split_run", "wide_tp": "wide_step"}
# the path whose launch counts the result line reports for each kernel
MAIN_PATH = {"narrow_run": "C", "narrow_run_global": "B",
             "wide_dense_run": "C", "wide_split_run": "E", "trace": "C",
             "wide_step": "F1", "minimizer_sketch": "S2",
             "grid_nll": "S3", "grid_tables": "S3", "sketch_count": "S4",
             "fused_forward": "U2 fused", "fused_trace": "U2 fused",
             "chunk_step": "U2 chunked", "chunk_trace": "U2 chunked",
             "chunk_share": "F4a",
             **{name: "G" for name in CHAINS}}
TP_SHARDS = (1, 2, 3)  # the tp rank counts of phase B's K4 checks
F_RANKS = 2  # ranks sharing the card in phases F2, F3 and F4
TP_SPANS = ("chunked.tp_gather", "chunked.tp_wait")  # F4's gathers, waits
# phase F4c: W's first bands, a prefix of W closed by a sink (each wide
# transition's all-gather through gloo moves ~0.4 GB: V, SH and the words
# at width 1,022, R = 18)
F4_W_BANDS = 1
# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory bytes/s, and
# the float32 rate outside the tensor cores, taken for the kernels' int32
# adds and compares (the table has no int32 row)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# phase G1's chains (levels, seed, destinations drawn one edge each): the
# probes' own chain, and two whose states are still alive at the end
G1_CHAINS = ((200, 0, 16), (40, 29, 9), (6, 35, 16))
PLAIN_SLOPE = (100, 400)  # chain lengths of the plain versions' slopes
# (bytes, int32 operations) of one level of each chain: the table words the
# function needs in and its backpointers out, each once (K5b: the [:4, :16]
# corner of pit and pwt; K6: six of the block's eight rows in, 19 of its 24
# backpointer rows out, the zero padding not counted; K7: tblc, tbl2c and
# S, not the transposed twins); an add and a max per candidate and row
# (K5a: an add and a mask per element)
CHAIN_WORK = {
    "chain_floor": (8 * 128 * 4 + 8 * 128 * 2, 2 * 8 * 128),
    "chain_step16": (2 * 4 * 16 * 4 + 64 * 64 * 4 + 304 * 16 * 2,
                     2 * 16 * 19 * 256),
    "chain_pair": (6 * 256 * 4 + 19 * 256 * 2, 2 * 19 * 256),
    "chain_edge": ((16 * 8 + 16 * 4 + 16 * 16) * 4 + 19 * 256 * 2,
                   2 * 19 * 256),
}
# cycles the card spins before a call timed behind a spin (~0.2 ms)
SPIN_CYCLES = 400_000
# the chain kernels whose G2 line gives clock cycles a level
CYCLES_A_LEVEL = ("chain_step16", "chain_pair", "chain_edge")
# the probe variant that drives each chain kernel
CHAIN_VARIANT = {"chain_floor": "floor0", "chain_step16": "step16",
                 "chain_pair": "pair16", "chain_edge": "edge16"}
# phase H: the source of each capability check's kernel (K8, K9); KERNELS
# and MAIN_PATH take them in main(), with the line of the script's mk_*
CAPS_SOURCES = {
    "caps_gather.cu": (
        "lane_gather_taa_grouped", "lane_gather_cross_vreg",
        "sublane_gather_8", "sublane_gather_16", "roll_lane", "roll_sublane",
        "dyn_slice_row_bcast", "scalar_prefetch_grid", "strided_slice_lane",
        "roll3d_ax1", "roll3d_ax2"),
    "caps_layout.cu": (
        "lane_bcast_col", "sublane_bcast_row", "tile_lane_concat", "popcount",
        "reshape_lane_groups", "concat3d_ax0", "concat3d_ax1", "concat3d_ax2",
        "convert_f32_i32_3d", "iota_onehot_build", "where3d_iota_mask",
        "transpose2d", "switch_compute"),
    "caps_bulk.cu": ("manual_dma_dynoff", "dma_strided_3d", "dma_in_when"),
    "caps_mma.cu": ("batched_dot_3d", "batched_dot_bcast_lhs", "dot2d_f32"),
}
CAPS_PRODUCTS = ("batched_dot_3d", "batched_dot_bcast_lhs", "dot2d_f32")
TF32_OPS_PER_S = 495e12  # the tensor cores' dense TF32 rate (data sheet)
# K1's us per narrow transition on phase C's prefix before its redesign (the
# kernel it replaced, timed beside it on the same card: PERF.md section 6)
K1_BEFORE_US = 4.7145
# the pairs of a slice K2 stages in shared memory (csrc/wide_dense_run.cu
# STAGE); a larger slice reads its words from the table
K2_STAGE = 2560
H_CALLS = 200  # launches per CUDA-event timing in phase H2
H_PROFILED = 50  # launches per profile of a check in phase H2
# phase U: W, the graph past the torch tier's window limit (MHC-shaped, 20
# bands of levels 513-1,024 wide); C's first U_PREFIX transitions, on which
# K13-K16 are timed beside their plain versions; the JAX tiers' random
# graphs (random_leveled_csr(seed, 12, 5, 8), R = 5)
W_SHAPE = dict(n_bands=20, wmin=513, wmax=1024)
U_PREFIX = 2000
U_RANDOM = (0, 1, 2, 3)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def span_s(name: str) -> float:
    """The seconds in span ``name`` so far in this process (the program's
    registry, ``dipgenie_tpu_torch/utils/timing.py``)."""
    from dipgenie_tpu_torch.utils import timing

    return timing.total(name).ns / 1e9


def bound(nbytes: int, ops: int, ops_per_s: float = OPS_PER_S
          ) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def work(seg, bp_bytes: int, R1: int) -> tuple[int, int]:
    """(bytes, operations) of one run: each table byte the function needs
    read once (K1: the real pairs' words and one descriptor a transition;
    K2 / K3: its real chunks, with wwin and wbase for K3; not the slice
    tables, which only the kernels' design reads), V in and out once, each
    backpointer byte written once; an add and a max per (real pair, row it
    reaches)."""
    import numpy as np

    h = seg.host
    tbl = h.dtbl if seg.kind == "wide" else h.tbl
    real = tbl[: seg.nreal, 1] != -(2**22)
    wsum = tbl[: seg.nreal, 0] & 3
    ops = 2 * int(np.where(real, R1 - wsum, 0).sum())
    if seg.kind == "narrow":
        tables = 8 * int(real.sum()) + 16 * (h.t1 - h.t0)
    else:
        tables = seg.nreal * (4 * 2 * 256 + (8 if seg.kind == "wide_split"
                                             else 0))
    return tables + 2 * R1 * 1024 * 4 + bp_bytes, ops


def k2_slices(dplan) -> str:
    """K2's grid, slices a block and its largest slice in pairs on a
    plan's dense wide runs, and how many slices read their words from the
    table (more than STAGE, csrc/wide_dense_run.cu): "" without such runs."""
    import numpy as np

    segs = [s for s in dplan.segments if s.kind == "wide"]
    if not segs:
        return ""
    most, unstaged = 0, 0
    for seg in segs:
        desc = seg.k2_desc.cpu().numpy()
        cuts = seg.k2_cuts.cpu().numpy().astype(np.int64)
        for ti, (c0, n) in enumerate(desc):
            words = seg.host.dtbl[c0:c0 + -(-n // 256), 0].ravel()[:n]
            pairs = np.diff(np.searchsorted((words >> 2) & 32767, cuts[ti]))
            most = max(most, int(pairs.max()))
            unstaged += int((pairs > K2_STAGE).sum())
    return (f"; K2 grid {segs[0].k2_grid} blocks, "
            f"{max(s.k2_per_block for s in segs)} slice(s) a block, the "
            f"largest slice {most} pairs, {unstaged} slices over "
            f"{K2_STAGE} pairs (read from the table)")


class Smoke:
    def __init__(self, torch, ref_cxx: str):
        self.torch = torch
        self.ref_cxx = ref_cxx  # the compiler of native/libdgcore.so
        from dipgenie_tpu_torch.models import fitter
        from dipgenie_tpu_torch.ops import (
            caps, chain_edge, chain_floor, chain_pair, chunked, fused, narrow,
            sketch, trace, wide, wide_split, wide_step,
        )
        from dipgenie_tpu_torch.parallel import mesh

        self.fns = {
            "chain_floor": (chain_floor.chain_floor,
                            chain_floor.chain_floor_ref),
            "chain_step16": (chain_floor.chain_step16,
                             chain_floor.chain_step16_ref),
            "chain_pair": (chain_pair.chain_pair, chain_pair.chain_pair_ref),
            "chain_edge": (chain_edge.chain_edge, chain_edge.chain_edge_ref),
            "narrow_run": (narrow.narrow_run, narrow.narrow_run_ref),
            "narrow_run_global": (narrow.narrow_run_global,
                                  narrow.narrow_run_ref),
            "wide_dense_run": (wide.wide_dense_run, wide.wide_dense_run_ref),
            "wide_split_run": (wide_split.wide_split_run,
                               wide_split.wide_split_run_ref),
            "trace": (trace.trace, trace.trace_ref),
            "wide_step": (wide_step.wide_step, wide_step.wide_step_ref),
            "minimizer_sketch": (sketch.batch_minimizer,
                                 sketch.batch_minimizer_ref),
            "sketch_count": (mesh.sketch_count, mesh.sketch_count_ref),
            "grid_nll": (fitter.grid_nll, fitter.grid_nll_ref),
            "grid_tables": (fitter.grid_tables, fitter._grid_tables_torch),
            "fused_forward": (fused.fused_forward, fused.fused_forward_ref),
            "fused_trace": (fused.fused_trace, fused.fused_trace_ref),
            "chunk_step": (chunked.chunk_step, chunked.chunk_step_ref),
            "chunk_trace": (chunked.chunk_trace, chunked.chunk_trace_ref),
            "chunk_share": (chunked.chunk_share, chunked.chunk_share_ref),
            **caps.CHECKS,
        }
        self.err = {k: 0 for k in KERNELS}
        self.compared = {k: 0 for k in KERNELS}
        self.launches = {}  # path -> {kernel: launches}
        self.ms, self.plain_ms, self.bound = {}, {}, {}
        self.library_ms = {}  # one PyTorch call computing the same output
        self.device_ms = {}  # phase S1: CUDA-event ms around a launch
        self.prefix_tr = {}  # transitions of each kernel's timed prefix
        self.slopes = {}  # phase G2: probe variant -> Slope
        self.trace_full = {}  # phases C and E: K-T on the whole plan
        self.big = {}  # phase E's plan and result, for phase F
        self.d18 = None  # phase D's 18-walk pangenome and native FASTA
        self.plan_s = {}  # phases C and E: plan_pairs' host seconds
        self.c = None  # phase C's graph and native result, for phase U
        self.s = {}  # phase S's pangenome, reads and anchor stages
        self.smi = ""  # the card's name and power limit (nvidia-smi)

    def counts(self):
        return {k: f[0].launches for k, f in self.fns.items()}

    def reset_counts(self):
        for f, _ in self.fns.values():
            f.launches = 0

    def sync(self):
        self.torch.cuda.synchronize()

    def events(self, n):
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(n)]

    def compare(self, name, got, want):
        """Exact equality of kernel and plain outputs (tuples of tensors;
        floats compared as floats); records the max abs difference."""
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name}: {tuple(g.shape)} {g.dtype} vs "
                  f"{tuple(w.shape)} {w.dtype}")
            if g.numel() and g.is_floating_point():
                d = float((g.double() - w.double()).abs().max())
                self.err[name] = max(self.err[name], d)
            elif g.numel():
                d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                self.err[name] = max(self.err[name], d)
        self.compared[name] += 1
        check(self.err[name] == 0, f"{name} differs from its plain version "
              f"(max abs err {self.err[name]})")

    # ---------------- phase B ----------------
    def run_checked(self, dplan):
        """The forward and traceback with every kernel call checked
        against its plain version on the same inputs."""
        from dipgenie_tpu_torch.ops.diploid_pair import assemble
        from dipgenie_tpu_torch.ops.plan import initial_v

        from dipgenie_tpu_torch.ops.narrow import state_in_shared

        V = initial_v(dplan.R, DEVICE)
        bps = []
        for seg in dplan.segments:
            name = KIND_KERNEL[seg.kind]
            if name == "narrow_run" and not state_in_shared(seg, dplan.R + 1):
                name = "narrow_run_global"
            kern, plain = self.fns[name]
            got = kern(seg, V)
            self.compare(name, got, plain(seg, V))
            V = got[0]
            bps.append(got[1:])
        kern, plain = self.fns["trace"]
        recs = kern(dplan, bps)
        self.compare("trace", recs, plain(dplan, bps))
        self.sync()
        return assemble(int(V[dplan.R, 0]), recs.cpu().numpy())

    def checked_both_routes(self, plan, want, what):
        """The main path's routing, then K3 over every wide run."""
        from dipgenie_tpu_torch.ops.plan import plan_to_device

        for nb_max in (18, 0):
            got = self.run_checked(plan_to_device(plan, DEVICE, nb_max))
            check(got == want, f"{what} (dense_nb_max={nb_max}): DP result "
                  f"{got[:2]} differs from {want[:2]}")

    def phase_b(self):
        import numpy as np

        from dipgenie_tpu_torch.ops.plan import plan_pairs
        from dipgenie_tpu_torch.solver.diploid import (
            csr_arrays, native_forward_csr,
        )
        from dipgenie_tpu_torch.utils.synth import (
            CASES, limit_case, random_leveled_csr,
        )

        t0 = time.time()
        n_seg = 0
        for name in NPZ:
            d = np.load(os.path.join(REPO, "tests", "data", name + ".npz"))
            plan = plan_pairs(*[d[k] for k in CSR_KEYS], int(d["R"]))
            n_seg += len(plan.segments)
            want = (int(d["oracle_value"]), int(d["oracle_shet"]),
                    [tuple(int(x) for x in r) for r in d["oracle_transitions"]])
            self.checked_both_routes(plan, want, name)
            self.tp_shards_checked(plan)
            log(f"B {name}: {plan.L} levels, {len(plan.segments)} segments, "
                f"value {want[0]} s_het {want[1]} == oracle")
        for seed, L, kmax, r, nc in CASES:
            arrs = random_leveled_csr(seed, L, kmax, nc)
            plan = plan_pairs(*arrs, r)
            n_seg += len(plan.segments)
            self.checked_both_routes(plan, native_forward_csr(arrs, r),
                                     f"case {seed}")
            self.tp_shards_checked(plan)
        log(f"B random cases: {len(CASES)} instances == native tier")
        for name in LIMIT_B:
            g, chb, r = limit_case(name)
            arrs = csr_arrays(g, chb)
            plan = plan_pairs(*arrs, r)
            n_seg += len(plan.segments)
            want = native_forward_csr(arrs, r)
            self.checked_both_routes(plan, want, f"limit case {name}")
            self.tp_shards_checked(plan)
            nbs = [s.NB for s in plan.segments if hasattr(s, "NB")]
            log(f"B limit case {name}: R={r}, {plan.L} levels, widest run "
                f"{max(nbs, default=0)} windows, value bound "
                f"{plan.max_abs_value}, value {want[0]} s_het {want[1]} == "
                "native tier")
        n_seg += self.phase_b_global()
        log(f"B kernels == plain on {n_seg} segments, each on both routes "
            f"(calls compared: {self.compared}) in {time.time() - t0:.1f}s")

    def phase_b_global(self):
        """K1's global-state path on GLOBAL_STATE_CASE, whose V does not
        fit shared memory: every call against the plain version on both
        routes; the DP through PairDiploidDP with the launch counts set to 0
        just before and read just after, against the native tier; the
        kernel beside its plain version on the case's narrow runs (CUDA
        events, in turns plain, kernel, kernel, plain) and its bound.
        Returns the plan's segment count."""
        from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
        from dipgenie_tpu_torch.ops.narrow import state_in_shared
        from dipgenie_tpu_torch.ops.plan import (
            initial_v, plan_pairs, plan_to_device,
        )
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import (
            GLOBAL_STATE_CASE, random_leveled_csr,
        )

        seed, L, kmax, r, nc = GLOBAL_STATE_CASE
        arrs = random_leveled_csr(seed, L, kmax, nc)
        plan = plan_pairs(*arrs, r)
        want = native_forward_csr(arrs, r)
        self.checked_both_routes(plan, want, "global-state case")
        dplan = plan_to_device(plan, DEVICE)
        narrow = [s for s in dplan.segments if s.kind == "narrow"]
        big = [s for s in narrow if not state_in_shared(s, r + 1)]
        check(bool(big), "B global-state case: every run fits shared memory")
        self.reset_counts()
        got = PairDiploidDP(dplan, DEVICE).run()
        self.sync()
        launches = self.launches["B"] = self.counts()
        check(got == want, f"B global-state case: DP {got[:2]} differs from "
              f"the native tier's {want[:2]}")
        check(launches["narrow_run_global"] == len(big)
              and launches["narrow_run"] == len(narrow) - len(big),
              f"B global-state case: launches {launches}")
        inputs, V = [], initial_v(r, DEVICE)
        for seg in dplan.segments:
            if any(seg is b for b in big):
                inputs.append((seg, V))
            V = self.fns[KIND_KERNEL[seg.kind]][0](seg, V)[0]
        run = {w: (lambda w=w: [self.fns["narrow_run_global"][w](s, v)
                                for s, v in inputs]) for w in (0, 1)}
        times, outs = {0: [], 1: []}, {}
        for which in (1, 0, 0, 1):
            ms, outs[which] = self.timed(run[which])
            times[which].append(ms)
        for g, w in zip(outs[0], outs[1]):
            self.compare("narrow_run_global", g, w)
        nb, no = 0, 0
        for (seg, _), out in zip(inputs, outs[0]):
            b, o = work(seg, sum(t.numel() * t.element_size()
                                 for t in out[1:]), r + 1)
            nb, no = nb + b, no + o
        name = "narrow_run_global"
        self.ms[name], self.plain_ms[name] = min(times[0]), min(times[1])
        self.bound[name] = bound(nb, no)
        self.prefix_tr[name] = sum(s.t1 - s.t0 for s, _ in inputs)
        log(f"B global-state case: R={r}, {len(big)} of {len(narrow)} narrow "
            f"runs keep V in global memory (lanes "
            f"{[s.lanes for s in big]}); launches "
            f"{ {k: n for k, n in launches.items() if n} }; value "
            f"{want[0]} s_het {want[1]} == native tier; {name} on its "
            f"{self.prefix_tr[name]} transitions: kernel {times[0]} ms, plain "
            f"{times[1]} ms, bound {self.bound[name][0]:.6g} ms "
            f"({self.bound[name][1]})")
        return len(plan.segments)

    def tp_shards_checked(self, plan):
        """K4 on every (transition, rank) shard of every wide run for each
        n_tp of TP_SHARDS, each call against its plain version, from the
        single-device path's states; the ranks' partials merged as their
        all_reduce(MAX) would merge them give the single-device run's
        output state."""
        from dipgenie_tpu_torch.ops.plan import (
            initial_v, plan_to_device, shard_to_device,
        )
        from dipgenie_tpu_torch.ops.wide_split import _state
        from dipgenie_tpu_torch.ops.wide_step import commit

        torch = self.torch
        kern, plain = self.fns["wide_step"]
        dplan = plan_to_device(plan, DEVICE)
        V = initial_v(plan.R, DEVICE)
        for seg, dseg in zip(plan.segments, dplan.segments):
            out = self.fns[KIND_KERNEL[dseg.kind]][0](dseg, V)[0]
            for n_tp in TP_SHARDS if dseg.kind != "narrow" else ():
                segs = [shard_to_device(seg, n_tp, d, DEVICE)
                        for d in range(n_tp)]
                W = _state(segs[0], V)
                bp = torch.empty(W.shape, dtype=torch.int32, device=DEVICE)
                for ti in range(seg.t1 - seg.t0):
                    parts = []
                    for sg in segs:
                        got = kern(sg, ti, W)
                        self.compare("wide_step", got, plain(sg, ti, W))
                        parts.append(got)
                    W = commit(torch.stack(parts).amax(dim=0),
                               segs[0].t["present"][ti], bp)
                check(bool(torch.equal(W[:, :1024], out)),
                      f"B: K4's merged partials (n_tp {n_tp}) differ from "
                      "the single-device run")
            V = out

    # ---------------- phase G ----------------
    def chain_inputs(self, name, T, seed=0, cover=16, weights=True):
        """(the tables of a chain of T levels on the card, as the kernel's
        wrapper takes them; the chain as the oracle takes it, or None)."""
        from dipgenie_tpu_torch.probes import tables

        hostE = None
        if name == "chain_floor":
            arrs = (tables.floor_tables(T, seed),)
        elif name == "chain_step16":
            arrs = tables.step16_tables(T, seed, tie_bits=True)
        elif name == "chain_pair":
            *arrs, hostE = tables.pair_tables(T, seed, cover, weights)
        else:
            *arrs, hostE = tables.edge_tables(T, seed, cover, weights)
        return (tuple(self.torch.from_numpy(a).to(DEVICE) for a in arrs),
                hostE)

    def phase_g(self):
        self.phase_g1()
        self.phase_g2()
        self.phase_g3()

    def phase_g1(self):
        """Each chain kernel against its plain version (every element of
        the backpointers and of the final state), K6 and K7 against the
        oracle and each other."""
        import numpy as np

        from dipgenie_tpu_torch.probes import tables

        for T, seed, cover in G1_CHAINS:
            v = {}
            for name in CHAINS:
                args, hostE = self.chain_inputs(name, T, seed, cover)
                kern, plain = self.fns[name]
                got = kern(*args)
                self.compare(name, got, plain(*args))
                if hostE is not None:
                    v[name] = got[1].cpu().numpy().reshape(
                        tables.R1, tables.B, tables.B)
                    want = tables.committed(tables.chain_oracle(hostE))
                    check(np.array_equal(v[name], want),
                          f"G1 {name} T={T} seed={seed}: final state "
                          "differs from the oracle")
            check(np.array_equal(v["chain_pair"], v["chain_edge"]),
                  f"G1 T={T} seed={seed}: K6 and K7 differ")
            log(f"G1 chains of {T} levels (seed {seed}, {cover} covered "
                "destinations): K5a, K5b, K6, K7 == plain on every element; "
                "K6 == K7 == oracle, "
                f"{int((v['chain_pair'] > tables.NEG).sum())} states alive "
                "at the end")

    def phase_g2(self):
        """The probes at their full chain lengths through their entry
        functions, with the launch counts set to 0 just before and read
        just after; then each kernel beside its plain version."""
        from dipgenie_tpu_torch.probes import edge, floor, pair

        dev = self.torch.device(DEVICE)
        self.reset_counts()
        for variant in floor.VARIANTS:
            self.slopes[variant] = floor.measure(variant, dev)
        for variant, mod in (("pair16", pair), ("edge16", edge)):
            for live in (False, True):
                label = variant + "-live" * live
                s = pair.probe(label, mod.build, dev, pair.T1, pair.T2, live)
                check(s is not None, f"G2 {label}: the probe's check "
                      "against the oracle failed")
                self.slopes[label] = s
        launches = self.launches["G"] = self.counts()
        # a warm-up and two timed chains at each of two lengths; the pair
        # and edge probes check one more chain against the oracle first,
        # and run on two chains
        want = {**dict.fromkeys(KERNELS, 0), "chain_floor": 6,
                "chain_step16": 6, "chain_pair": 14, "chain_edge": 14}
        check(launches == want, f"G2 launches {launches}, want {want}")
        log(f"G2 launches {launches}: one per chain; host-dispatched loops: "
            + ", ".join(f"{v} {self.slopes[v].per_level * 1e6:.3f} us/level"
                        for v in ("scan1", "scandus")))
        lengths = {**{v: x[1:] for v, x in floor.VARIANTS.items()},
                   "pair16": (pair.T1, pair.T2), "edge16": (pair.T1, pair.T2)}
        for name in CHAINS:
            self.time_chain(name, *lengths[CHAIN_VARIANT[name]])

    def time_chain(self, name, T1, T2):
        """A chain kernel beside its plain version on a chain of T1 levels
        (in turns plain, kernel, kernel, plain; CUDA events, min of 2) with
        its bound, and the plain version's slope on short chains. K6 and
        K7 on the chain that stays alive."""
        import functools

        from dipgenie_tpu_torch.ops.chain_edge import check_twins
        from dipgenie_tpu_torch.probes import tables

        kern, plain = self.fns[name]
        live = self.slopes.get(CHAIN_VARIANT[name] + "-live")
        chain = tables.LIVE if live else {}
        args, _ = self.chain_inputs(name, T1, **chain)
        if name == "chain_edge":  # the twins' check stays out of the timing
            check_twins(*args[:4])
            kern = functools.partial(kern, twins_checked=True)
        torch = self.torch
        run = {0: lambda: kern(*args), 1: lambda: plain(*args)}
        library = ""
        if name == "chain_floor":
            # one PyTorch call computes K5a's acc chain (the backpointers'
            # & 0x7FFF left out)
            run[2] = lambda: torch.cumsum(args[0], 0, dtype=torch.int32)
        times, outs = {w: [] for w in run}, {}
        for which in (1, 0, 2, 2, 0, 1) if 2 in run else (1, 0, 0, 1):
            # K5a's chains take tens of us: its calls are timed behind a
            # spin
            ms, outs[which] = self.timed(run[which], spin=2 in run)
            times[which].append(ms)
        self.compare(name, outs[0], outs[1])
        if 2 in run:
            acc = outs[2]
            check(bool(torch.equal(acc[-1], outs[0][1]) and torch.equal(
                (acc & 0x7FFF).to(torch.int16), outs[0][0])),
                "G2 chain_floor: torch.cumsum differs from K5a")
            self.library_ms[name] = min(times[2])
            library = (f", torch.cumsum {times[2]} ms (the same acc chain, "
                       "no mask; each call behind a spin of the card)")
        state = outs[0][1].numel() * outs[0][1].element_size()
        del outs
        nbytes, ops = CHAIN_WORK[name]
        nbound = bound(T1 * nbytes + state, T1 * ops)
        level = bound(nbytes, ops)
        longer = ""
        if 2 in run:  # K5a and torch.cumsum on the longer chain too
            longer = self.time_floor_longer(kern, T2, nbytes, ops, state)
        short = []
        for T in PLAIN_SLOPE:
            a, _ = self.chain_inputs(name, T, **chain)
            short.append(min(self.timed(lambda: plain(*a))[0]
                             for _ in range(2)))
        plain_us = (short[1] - short[0]) / (PLAIN_SLOPE[1] - PLAIN_SLOPE[0]) \
            * 1e3
        self.ms[name] = min(times[0])
        self.plain_ms[name] = min(times[1])
        self.bound[name] = nbound
        s = self.slopes[CHAIN_VARIANT[name]]
        cycles = {}
        if name in CYCLES_A_LEVEL:  # the chain's clock cycles a level
            from dipgenie_tpu_torch.ops.chain_ring import STEP16_CLUSTER

            mhz = self.clock_mhz()
            sms = (f"a cluster of {STEP16_CLUSTER} SMs"
                   if name == "chain_step16" else "one SM")
            cycles = {x: f", {x.per_level * mhz * 1e6:.1f} cycles a level "
                      f"at {mhz:.0f} MHz on {sms}" for x in (s, live) if x}
        alive = ""
        if live:
            alive = ("; on the chain that stays alive "
                     f"{live.per_level * 1e6:.4f} us/level ({live.t1 * 1e3:.4f} -> {live.t2 * 1e3:.4f} "
                     f"ms{cycles.get(live, '')}), and on it what follows")
        log(f"G2 {name} ({CHAIN_VARIANT[name]}): {s.per_level * 1e6:.4f} "
            f"us/level (slope {T1}->{T2}: {s.t1 * 1e3:.4f} -> "
            f"{s.t2 * 1e3:.4f} ms, CUDA events{cycles.get(s, '')}){alive}; "
            f"on a chain of {T1} "
            f"levels "
            f"kernel {times[0]} ms, plain {times[1]} ms{library}, bound "
            f"{nbound[0]:.6g} ms ({nbound[1]}){longer}; per level bound "
            f"{level[0] * 1e6:.4f} ns ({level[1]}: {nbytes} B, {ops} ops), "
            f"plain version {plain_us:.3f} us/level (slope "
            f"{PLAIN_SLOPE[0]}->{PLAIN_SLOPE[1]})")

    def time_floor_longer(self, kern, T, nbytes, ops, state):
        """K5a beside torch.cumsum on a chain of T levels (in turns
        cumsum, kernel, kernel, cumsum; CUDA events, min of 2), the two
        held equal, and the bound there: the text for K5a's G2 line."""
        torch = self.torch
        args, _ = self.chain_inputs("chain_floor", T)
        run = {0: lambda: kern(*args),
               2: lambda: torch.cumsum(args[0], 0, dtype=torch.int32)}
        times, outs = {0: [], 2: []}, {}
        for which in (2, 0, 0, 2):
            ms, outs[which] = self.timed(run[which], spin=True)
            times[which].append(ms)
        acc = outs[2]
        check(bool(torch.equal(acc[-1], outs[0][1]) and torch.equal(
            (acc & 0x7FFF).to(torch.int16), outs[0][0])),
            f"G2 chain_floor: torch.cumsum differs from K5a at {T} levels")
        del outs, acc
        nbound = bound(T * nbytes + state, T * ops)
        return (f"; on a chain of {T} levels kernel {times[0]} ms, "
                f"torch.cumsum {times[2]} ms, bound {nbound[0]:.6g} ms "
                f"({nbound[1]})")

    def phase_g3(self):
        """The compiled parity gate on the card."""
        from dipgenie_tpu_torch.probes import parity_gate

        out = os.path.join(REPO, "build", "GPU_PARITY.json")
        verdict = parity_gate.gate(self.torch.device(DEVICE), out)
        with open(out) as fh:
            written = json.load(fh)
        check(written["ok"] is True and written["cases"] == verdict["cases"]
              and verdict["cases"] >= 24,
              f"G3 parity gate: {[r for r in written['results'] if not r['ok']]}")
        log(f"G3 parity gate: {written['passed']} of {written['cases']} "
            f"cases == exact tier on {written['card']} "
            f"({written['power_limit']}) in {written['wall_s']}s; "
            f"{os.path.relpath(out, REPO)}")

    # ---------------- phase H ----------------
    def phase_h(self):
        self.phase_h1()
        self.phase_h2()

    def phase_h1(self):
        """The probes caps and caps2 through their entry functions, with
        the launch counts set to 0 just before and read just after; then
        every kernel against its plain version and the expectation."""
        import io

        from dipgenie_tpu_torch.ops.caps import NAMES
        from dipgenie_tpu_torch.probes import caps, caps_tables

        out = io.StringIO()
        self.reset_counts()
        with contextlib.redirect_stdout(out):
            rcs = [caps.main(["--device", DEVICE]),
                   caps.main2(["--device", DEVICE])]
        self.sync()
        launches = self.launches["H"] = self.counts()
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"H1 {line}")
        check(rcs == [0, 0] and lines == [f"PASS  {n}" for n in NAMES],
              f"H1 probes caps / caps2 exited {rcs}")
        want = {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(NAMES, 1)}
        check(launches == want, f"H1 launches {launches}, want {want}")
        seeds = (None, *caps_tables.SECOND_SEEDS)
        for name in NAMES:
            kern, plain = self.fns[name]
            for seed in seeds:
                ins, expect = caps_tables.make(name, seed)
                args = caps.to_device(ins, DEVICE)
                got = kern(*args)
                self.compare(name, got, plain(*args))
                self.compare(name, got, self.torch.from_numpy(expect).to(
                    DEVICE))
        log(f"H1 {len(NAMES)} of {len(NAMES)} PASS, one launch each; every "
            "kernel == plain == expectation on every element, on the "
            f"scripts' inputs and the second inputs (seeds {seeds[1:]})")

    def caps_library(self, name, args):
        """(one PyTorch call computing the check's output on ``args``,
        what it leaves out or None), or None where no one call does. Timed
        here beside the kernel only; the port never calls it."""
        torch = self.torch
        a = args[-1]
        if name in ("lane_gather_taa_grouped", "lane_gather_cross_vreg",
                    "sublane_gather_8", "sublane_gather_16"):
            i64 = args[1].long()  # torch.gather takes int64 indices only
            dim = 1 if name.startswith("lane") else 0
            return lambda: torch.gather(args[0], dim, i64), None
        rolls = {"roll_lane": (16, 1), "roll_sublane": (1, 0),
                 "roll3d_ax1": (4, 1), "roll3d_ax2": (4, 2)}
        if name in rolls:
            return lambda: torch.roll(a, *rolls[name]), None
        repeats = {"lane_bcast_col": (1, 256), "sublane_bcast_row": (16, 1),
                   "tile_lane_concat": (1, 19)}
        if name in repeats:
            return lambda: a.repeat(*repeats[name]), None
        views = {"strided_slice_lane": lambda: a[:, 3::16],
                 "transpose2d": lambda: a.t(),
                 "reshape_lane_groups": lambda: a.view(16, 19, 16),
                 "dma_in_when": lambda: a[2]}
        if name in views:  # one copy kernel
            view = views[name]()
            return view.clone if view.is_contiguous() else view.contiguous, \
                None
        if name in ("manual_dma_dynoff", "dma_strided_3d"):
            view = a[8:24] if name == "manual_dma_dynoff" else a[2, :, :8, :8]
            return lambda: torch.add(view, 1), None
        if name == "scalar_prefetch_grid":
            return lambda: torch.index_select(a, 0, args[0]), None
        if name in CAPS_PRODUCTS:
            fn = torch.bmm if name == "batched_dot_3d" else torch.matmul
            return lambda: fn(args[0], a), None
        if name == "concat3d_ax0":
            parts = [torch.full((1, 16, 16), -7, dtype=a.dtype,
                                device=a.device), a[:-1]]
            return lambda: torch.cat(parts, 0), None
        if name in ("concat3d_ax1", "concat3d_ax2"):
            parts, dim = [a, a + 1], int(name[-1])
            return lambda: torch.cat(parts, dim), "A + 1 made beforehand"
        if name == "convert_f32_i32_3d":
            return lambda: a.to(torch.int32), "without the * 2"
        if name == "iota_onehot_build":
            cols = torch.arange(32, dtype=torch.int32, device=a.device)[None]
            return lambda: torch.eq(cols, a), "a bool one-hot, not float32"
        if name == "where3d_iota_mask":
            rows = (torch.arange(16, device=a.device) < 8)[None, :, None]
            return lambda: torch.where(rows, a, -1), None
        return None  # dyn_slice_row_bcast, popcount, switch_compute

    def caps_device_us(self, name, runs):
        """Device us per launch of the kernel and of the library call (or
        None), from one profile of H_PROFILED launches of each: the
        kernel's rows are the caps_* kernels, the call's the others."""
        with self.profiler() as prof:
            for run in runs:
                for _ in range(H_PROFILED):
                    run()
            self.sync()
        rows = self.device_rows(prof, f"profile_H_{name}.txt")
        # a check is one kernel a call: its rows' own count (a profile
        # may miss launches); a library call may launch several
        n = sum(c for k, _, c in rows if "caps_" in k)
        kern = sum(t for k, t, _ in rows if "caps_" in k) / max(n, 1)
        lib = sum(t for k, t, _ in rows if "caps_" not in k) / H_PROFILED
        return kern or None, (lib or None) if len(runs) > 1 else None

    def phase_h2(self):
        """Each check's launch path beside the replaced one (the wrapper
        before the launch record, and the replaced kernel where a kernel
        was redesigned: probes/caps_replaced.py), its plain version and
        the library call, on the scripts' inputs: per call by CUDA events
        over H_CALLS calls (min of 2, in turns plain, replaced, new,
        library, library, new, replaced, plain) and device time per launch
        by the profiler (replaced and new in profiles of their own); and
        its bound."""
        from dipgenie_tpu_torch.ops.caps import NAMES
        from dipgenie_tpu_torch.probes import caps, caps_replaced, caps_tables

        torch = self.torch
        summary = []
        for name in NAMES:
            ins, expect = caps_tables.make(name)
            args = caps.to_device(ins, DEVICE)
            kern, plain = self.fns[name]
            old = caps_replaced.CHECKS[name]
            runs = {"plain": lambda: plain(*args),
                    "replaced": lambda: old(*args),
                    "new": lambda: kern(*args)}
            self.compare(name, old(*args), kern(*args))
            lib = self.caps_library(name, args)
            if lib:
                runs["library"] = lib[0]
                if lib[1] is None:
                    check(bool(torch.equal(lib[0](), torch.from_numpy(
                        expect).to(DEVICE))), f"H2 {name}: the library "
                        "call's output differs from the expectation")
            times = {w: [] for w in runs}
            for which in ("plain", "replaced", "new", "library", "library",
                          "new", "replaced", "plain"):
                if which in runs:
                    times[which].append(self.per_launch_ms(runs[which]))
            dev_o, _ = self.caps_device_us(name + "_replaced",
                                           [runs["replaced"]])
            dev_k, dev_l = self.caps_device_us(
                name, [runs[w] for w in ("new", "library") if w in runs])
            nbytes = expect.nbytes + caps_read_bytes(name, ins)
            if name in CAPS_PRODUCTS:  # a multiply and an add per term
                nbound = bound(nbytes, 2 * expect.size * ins[0].shape[-1],
                               TF32_OPS_PER_S)
            else:  # at most one int32 operation per output element
                nbound = bound(nbytes, expect.size)
            self.ms[name] = min(times["new"])
            self.plain_ms[name] = min(times["plain"])
            self.bound[name] = nbound
            self.library_ms[name] = min(times["library"]) if lib else None

            def us(x):
                return "not in the profile" if x is None else f"{x:.3f} us"

            def ev(which):
                return [round(t * 1e3, 3) for t in times[which]]

            lib_msg = "no one PyTorch call computes it"
            if lib:
                lib_msg = (f"library {ev('library')} us (device {us(dev_l)}"
                           + (f"; {lib[1]}" if lib[1] else "") + ")")
            redesigned = (" (kernel redesigned)"
                          if name in caps_replaced.REDESIGNED else "")
            log(f"H2 {name}{redesigned}: new {ev('new')} us per call "
                f"(device {us(dev_k)}), replaced {ev('replaced')} us "
                f"(device {us(dev_o)}), plain {ev('plain')} us, {lib_msg}; "
                f"bound {nbound[0] * 1e6:.4f} ns ({nbound[1]}: {nbytes} B)")
            summary.append((name, self.ms[name], min(times["replaced"]),
                            self.library_ms[name], dev_k, dev_o))
        with_lib = [x for x in summary if x[3] is not None]
        beat = [x[0] for x in with_lib if x[1] <= x[3]]
        lost = [f"{x[0]} {x[1] * 1e3:.3f} / {x[3] * 1e3:.3f}"
                for x in with_lib if x[1] > x[3]]
        rises = [(x[4] - x[5], x[0]) for x in summary
                 if x[4] is not None and x[5] is not None]
        rise = (f"{max(rises)[0]:+.3f} us ({max(rises)[1]})" if rises
                else "not measured")
        ratio = [x[1] / x[2] for x in summary]
        log(f"H2 new path: {len(beat)} of {len(with_lib)} checks with a "
            f"library call take no longer than it (events, min of 2); "
            f"slower: {lost or 'none'}; new / replaced event time "
            f"{min(ratio):.3f}-{max(ratio):.3f}; the largest device-time "
            f"change new - replaced {rise}; card {self.smi}")

    def per_launch_ms(self, fn):
        """CUDA-event ms per call over H_CALLS calls of ``fn``, after one
        warm-up call."""
        fn()
        a, b = self.events(2)
        self.sync()
        a.record()
        for _ in range(H_CALLS):
            fn()
        b.record()
        self.sync()
        return a.elapsed_time(b) / H_CALLS

    # ---------------- phases C and E ----------------
    def main_path(self, tag, arrs):
        """Plan, ship and run one DP the way the solver does, with the
        launch counts set to 0 just before the counted pass and read just
        after it; checks the counts against the plan and the result
        against the native tier. Returns (plan, dplan, result)."""
        import numpy as np

        from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP, assemble
        from dipgenie_tpu_torch.ops.plan import plan_pairs, plan_to_device
        from dipgenie_tpu_torch.ops.trace import trace
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import dp_states

        torch = self.torch
        states = dp_states(arrs[0], R)
        widths = np.diff(arrs[0])
        log(f"{tag} workload: {len(widths)} levels, "
            f"{int((widths > 32).sum())} wide levels (widths up to "
            f"{int(widths.max())}), {states} DP states (R={R})")
        t0 = time.time()
        plan = plan_pairs(*arrs, R)
        plan_s = self.plan_s[tag] = time.time() - t0
        slices0 = span_s("plan.split_slices")
        t0 = time.time()
        dplan = plan_to_device(plan, DEVICE)
        self.sync()
        ship_s = time.time() - t0
        slices_s = span_s("plan.split_slices") - slices0
        kinds = [s.kind for s in dplan.segments]
        nbs = [s.host.NB for s in dplan.segments if s.kind != "narrow"]
        log(f"{tag} plan {plan_s:.3f}s ({kinds.count('narrow')} narrow, "
            f"{kinds.count('wide')} wide runs of <= 18 windows, "
            f"{kinds.count('wide_split')} of more, NB <= {max(nbs)}); "
            f"ship {ship_s:.3f}s (of it K3's slices {slices_s:.3f}s, host "
            "clock)" + k2_slices(dplan))
        dp = PairDiploidDP(dplan, DEVICE)
        # two warm passes: the card idled through the host planner, and the
        # first pass runs while its clocks come back up
        for _ in range(2):
            dp.forward()
            self.sync()

        ev = self.events(3)
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        ev[0].record()
        V, bps = dp.forward()
        ev[1].record()
        recs = trace(dplan, bps)
        ev[2].record()
        self.sync()
        got = assemble(int(V[R, 0]), recs.cpu().numpy())
        launches = self.launches[tag] = self.counts()
        fwd_s = ev[0].elapsed_time(ev[1]) / 1e3
        tb_s = ev[1].elapsed_time(ev[2]) / 1e3
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} forward {fwd_s:.4f}s, traceback {tb_s:.4f}s (CUDA "
            f"events), {states / fwd_s:.4e} DP states/s, peak memory {peak} "
            f"B, launches {launches}, card {torch.cuda.get_device_name(0)}")
        want = {**dict.fromkeys(KERNELS, 0), "trace": 1,
                **{KIND_KERNEL[k]: kinds.count(k) for k in KIND_KERNEL}}
        check(launches == want, f"{tag} launches {launches}, want {want}")
        self.time_trace_full(tag, dplan, bps, recs)
        del bps, recs
        self.profile_forward(tag, dp)

        t0 = time.time()
        ref = native_forward_csr(arrs, R)
        log(f"{tag} native C++ tier {time.time() - t0:.1f}s (host)")
        check(got == ref, f"{tag} DP differs from the native tier: "
              f"{got[:2]} vs {ref[:2]}")
        log(f"{tag} value {got[0]} s_het {got[1]} and {len(got[2])} "
            "transitions == native tier")
        return plan, dplan, got

    def time_trace_full(self, tag, dplan, bps, want):
        """K-T on the whole plan's backpointers, three times, by CUDA
        events around trace() and around its one launch; the host part (the
        per-segment address rows) by the host clock on a line of its own.
        Every result equals the counted pass's records."""
        from dipgenie_tpu_torch.ops import trace

        times = {"window": [], "launch": []}
        for _ in range(3):
            with self.launch_events("dg_trace") as pairs:
                ms, recs = self.timed(lambda: trace.trace(dplan, bps))
            check(len(pairs) == 1, f"{tag} trace: {len(pairs)} launches")
            check(bool(self.torch.equal(recs, want)),
                  f"{tag} trace differs from the counted pass")
            times["window"].append(ms)
            times["launch"].append(pairs[0][0].elapsed_time(pairs[0][1]))
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            trace.bases(dplan, bps)
            self.sync()
            host.append((time.perf_counter() - t0) * 1e3)
        log(f"{tag} K-T host part (one address row per segment, "
            f"{len(dplan.segments)} rows): {min(host):.4f} ms (host clock; "
            f"all {[round(x, 4) for x in host]})")
        log(f"{tag} K-T on the whole plan ({dplan.L - 1} transitions): "
            f"trace() {min(times['window']):.4f} ms, the launch alone "
            f"{min(times['launch']):.4f} ms (CUDA events; all "
            f"{[round(x, 4) for x in times['window']]} / "
            f"{[round(x, 4) for x in times['launch']]})")
        self.trace_full[tag] = times

    def profile_forward(self, tag, dp):
        """Device busy and idle share of one more forward pass, from a
        torch.profiler trace (kernel rows only); the table goes to
        build/chip_smoke/profile_forward_<tag>.txt."""
        torch = self.torch
        a, b = self.events(2)
        self.sync()
        with self.profiler() as prof:
            a.record()
            out = dp.forward()
            b.record()
            self.sync()
        del out
        wall_us = a.elapsed_time(b) * 1e3
        rows = self.device_rows(prof, f"profile_forward_{tag}.txt")
        busy = sum(t for _, t, _ in rows)
        if not busy:
            log(f"{tag} profile: no device time in the trace; idle share "
                "not measured")
            return
        log(f"{tag} profiled forward {wall_us / 1e6:.4f}s: device busy "
            f"{busy / 1e6:.4f}s, idle share {1 - busy / wall_us:.4f}; "
            + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms x{n}"
                        for k, t, n in rows[:5]))

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def device_rows(self, prof, fname):
        """(kernel name, self device us, count) of a profile, largest
        first; the full table goes to build/chip_smoke/<fname>."""
        avg = prof.key_averages()
        with open(os.path.join(OUT_DIR, fname), "w") as fh:
            fh.write(avg.table(sort_by="self_device_time_total", row_limit=30))
        # gloo's collective annotation carries the device time of its copy
        # back to the card, which the copy's own row already counts
        return sorted(
            ((e.key, e.self_device_time_total, e.count) for e in avg
             if str(e.device_type).endswith("CUDA")
             and e.self_device_time_total > 0
             and not e.key.startswith("gloo:")),
            key=lambda x: -x[1])

    @contextlib.contextmanager
    def launch_events(self, entry):
        """While the block runs, every call of the kernel library's C entry
        point ``entry`` is bracketed by two CUDA events on the current
        stream; yields the list the pairs are appended to."""
        from dipgenie_tpu_torch import kernels

        lib, pairs = kernels.lib(), []
        launch = getattr(lib, entry)

        def bracketed(*args):
            ev = self.events(2)
            ev[0].record()
            rc = launch(*args)
            ev[1].record()
            pairs.append(ev)
            return rc

        setattr(lib, entry, bracketed)
        try:
            yield pairs
        finally:
            setattr(lib, entry, launch)

    def timed(self, fn, spin=False):
        """(CUDA-event ms, output) of one call; with ``spin`` queued behind
        a spin of the card, so that the host's launches and allocations
        stay out of the events and they time the device's work."""
        a, b = self.events(2)
        self.sync()
        if spin and DEVICE == "cuda":
            self.torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        out = fn()
        b.record()
        self.sync()
        return a.elapsed_time(b), out

    def time_prefix(self, tag, dplan, names):
        """Each kernel of ``names`` beside its plain version on the runs
        of the plan's first PREFIX_TRANSITIONS transitions (the trace on
        the prefix's traceback), in turns plain, kernel, kernel, plain
        (CUDA events, min of 2), with the kernel's device time from a
        profile of one more pass and its bound from the prefix's arrays.
        Returns the prefix's (segments, inputs, backpointers)."""
        from dipgenie_tpu_torch.ops.plan import DevPlan, initial_v

        prefix = [s for s in dplan.segments if s.t0 < PREFIX_TRANSITIONS]
        v_ins, bps, V = [], [], initial_v(R, DEVICE)
        for seg in prefix:
            v_ins.append(V)
            V, *bp = self.fns[KIND_KERNEL[seg.kind]][0](seg, V)
            bps.append(tuple(bp))
        sub = DevPlan(R=R, L=prefix[-1].t1 + 1, device=dplan.device,
                      segments=prefix)
        R1 = R + 1
        for name in names:
            if name == "trace":
                run = {w: (lambda w=w: self.fns["trace"][w](sub, bps))
                       for w in (0, 1)}
                n_tr = sub.L - 1
                recs = run[0]()
                # per transition: its descriptor row, its bp word (int32
                # at most), its packed word, w1 and symd in, its record out
                nbytes = (sub.L - 1) * (8 * 4 + 4 + 4 + 1 + 2 + 7 * 4)
                nbound = bound(nbytes, 12 * (sub.L - 1))
            else:
                idx = [i for i, s in enumerate(prefix)
                       if KIND_KERNEL[s.kind] == name]
                run = {w: (lambda w=w, n=name, idx=idx: [
                    self.fns[n][w](prefix[i], v_ins[i]) for i in idx])
                    for w in (0, 1)}
                n_tr = sum(prefix[i].t1 - prefix[i].t0 for i in idx)
                b, o = 0, 0
                for i in idx:
                    nb, no = work(prefix[i], sum(
                        t.numel() * t.element_size() for t in bps[i]), R1)
                    b, o = b + nb, o + no
                nbound = bound(b, o)
            times = {0: [], 1: []}
            outs = {}
            for which in (1, 0, 0, 1):  # plain, kernel, kernel, plain
                ms, outs[which] = self.timed(run[which])
                times[which].append(ms)
            if name == "trace":
                self.compare(name, outs[0], outs[1])
            else:
                for g, w in zip(outs[0], outs[1]):
                    self.compare(name, g, w)
            del outs
            with self.profiler() as prof:
                run[0]()
                self.sync()
            rows = self.device_rows(prof, f"profile_{tag}_{name}.txt")
            device = f"{sum(t for _, t, _ in rows) / 1e3:.3f} ms by the " \
                "profiler"
            if name == "trace":
                # one launch: its own time too, which a profile that holds
                # no row for the kernel cannot give
                with self.launch_events("dg_trace") as pairs:
                    run[0]()
                    self.sync()
                check(len(pairs) == 1, f"{tag} trace: {len(pairs)} launches")
                device = (f"{pairs[0][0].elapsed_time(pairs[0][1]):.3f} ms by "
                          "CUDA events around the launch, "
                          + (device if rows else "no row in the profile"))
            self.ms[name] = min(times[0])
            self.plain_ms[name] = min(times[1])
            self.bound[name] = nbound
            self.prefix_tr[name] = n_tr
            log(f"{tag} {name} on the first {n_tr} transitions of the plan: "
                f"kernel {times[0]} ms (device {device}), plain {times[1]} "
                f"ms, bound {nbound[0]:.6g} ms ({nbound[1]})")
        return prefix, v_ins, bps

    def phase_c(self):
        from dipgenie_tpu_torch.ops.plan import _WideRun, dense_destinations
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        from dipgenie_tpu_torch.probes import dp_stages

        arrs = mhc_shaped_csr(L=L_MHC, seed=SEED, n_bands=N_BANDS)
        plan, dplan, got = self.main_path("C", arrs)
        self.c = {"arrs": arrs, "want": got}
        self.time_prefix("C", dplan, ("narrow_run", "wide_dense_run", "trace"))
        del dplan
        # the walk of the dense tables that picks K2 or K3 for a run and
        # that K2's slicing reads (once a run, inside the ship)
        wide = [s for s in plan.segments if isinstance(s, _WideRun)]
        t0 = time.time()
        heavy = max((dense_destinations(s)[1] for s in wide), default=0)
        log(f"C dense_destinations over its {len(wide)} wide runs "
            f"{time.time() - t0:.3f}s (host clock, part of the ship); the "
            f"heaviest destination {heavy} pairs")
        self.torch.cuda.empty_cache()
        dp_stages.stages(plan, DEVICE, log=lambda m: log("C dp-stages " + m))
        k1_us = self.ms["narrow_run"] / self.prefix_tr["narrow_run"] * 1e3
        log(f"C K1 narrow_run {k1_us:.4f} us per transition on the prefix "
            f"(host-timed, one launch per run; {K1_BEFORE_US} before the "
            "redesign) beside phase G's level-chain floors: " + ", ".join(
                f"{v} {s.per_level * 1e6:.4f} us/level"
                for v, s in self.slopes.items()
                if v not in ("scan1", "scandus")))

    # ---------------- phase U ----------------
    def phase_u(self):
        """The fused and chunked tiers (K13-K16): U1 every kernel against
        its plain version, U2 both tiers on C, U3 W through ``auto``."""
        from dipgenie_tpu_torch.ops import fused
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        if self.c is None:  # phase C not run: its graph and native result
            arrs = mhc_shaped_csr(L=L_MHC, seed=SEED, n_bands=N_BANDS)
            self.c = {"arrs": arrs, "want": native_forward_csr(arrs, R)}
        w = mhc_shaped_csr(L=L_MHC, seed=SEED, **W_SHAPE)
        t0 = time.time()
        wplan = fused.plan_fused(*w, R)
        log(f"U W fused plan {time.time() - t0:.3f}s (host clock)")
        self.phase_u1(wplan)
        self.phase_u2()
        self.phase_u3(w, wplan)

    def phase_u1(self, wplan):
        """K13-K16 against their plain versions, every output element, on
        the real slices, the JAX tiers' random graphs, the high in-degree
        graph and W's transitions into and out of its widest level."""
        import numpy as np

        from dipgenie_tpu_torch.solver.diploid import csr_arrays
        from dipgenie_tpu_torch.utils.synth import (
            high_indegree_graph, random_leveled_csr,
        )

        t0 = time.time()
        cases = []
        for name in NPZ:
            d = np.load(os.path.join(REPO, "tests", "data", name + ".npz"))
            cases.append((name, [d[k] for k in CSR_KEYS], int(d["R"])))
        cases += [(f"random {s}", random_leveled_csr(s, 12, 5, 8), 5)
                  for s in U_RANDOM]
        cases.append(("high in-degree", csr_arrays(*high_indegree_graph()),
                      3))
        for tag, arrs, r in cases:
            self.u_check_graph(tag, arrs, r)
        self.u_check_w(wplan)
        self.u_check_runs(cases)
        self.u_check_walks()
        self.u_check_shares()
        log(f"U1 K13-K16 == their plain versions on every element: "
            f"{len(cases)} graphs and W's widest level "
            f"({time.time() - t0:.1f}s)")

    def u_check_graph(self, tag, arrs, r):
        """Every transition of a graph through K13 and K15 (forward and
        replay) from the plain path's states, then K14 and K16 on the
        whole plan, each against its plain version."""
        import numpy as np

        from dipgenie_tpu_torch.ops import fused
        from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

        torch = self.torch
        plan = fused.plan_fused(*arrs, r)
        desc, R1 = plan.desc, r + 1
        dev = ship(plan.vplan, DEVICE, plan.desc)
        k13, p13 = self.fns["fused_forward"]
        k15, p15 = self.fns["chunk_step"]
        codes = [torch.zeros(plan.bp_bytes, dtype=torch.uint8, device=DEVICE)
                 for _ in range(2)]
        sizes = R1 * desc[:, 1] ** 2
        off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        words = [torch.zeros(int(sizes.sum()), dtype=torch.int32,
                             device=DEVICE) for _ in range(2)]
        V = initial_state(r, int(plan.vplan.widths[0]), DEVICE)
        SH = torch.zeros_like(V)
        for t in range(plan.T):
            got = k13(dev, t, t + 1, V, codes[0])
            want = p13(dev, t, t + 1, V, codes[1])
            self.compare("fused_forward",
                         (got, fused._codes(codes[0], desc[t], R1)),
                         (want, fused._codes(codes[1], desc[t], R1)))
            a = off[t:t + 1]
            g15 = k15(dev, t, t + 1, V, SH, words[0], a)
            w15 = p15(dev, t, t + 1, V, SH, words[1], a)
            n = slice(int(a[0]), int(a[0] + sizes[t]))
            self.compare("chunk_step", (*g15, words[0][n]),
                         (*w15, words[1][n]))
            V, SH = w15
        rows = [self.fns["fused_trace"][i](dev, codes[i], r) for i in (0, 1)]
        self.compare("fused_trace", (rows[0][0], torch.tensor(rows[0][1])),
                     (rows[1][0], torch.tensor(rows[1][1])))
        woff = torch.from_numpy(np.append(off, int(sizes.sum()))).to(DEVICE)
        for spans in ([(0, plan.T)], u_spans(plan.T)):
            self.compare("chunk_trace", *(
                self.u_walk(i, dev, woff, words[i], r, spans)
                for i in (0, 1)))
        check(int(V[r, 0, 0]) >= 0, f"U1 {tag}: the sink is unreachable")
        log(f"U1 {tag}: {plan.T} transitions, in-degree up to "
            f"{int(desc[:, 2].max())}: K13-K16 == plain")

    def u_check_w(self, wplan):
        """K13 and K15 (replay) on W's transitions into and out of its
        widest level, from a random state, against their plain versions."""
        import numpy as np

        from dipgenie_tpu_torch.ops import fused
        from dipgenie_tpu_torch.ops.vertex_plan import ship

        torch = self.torch
        desc, R1 = wplan.desc, R + 1
        dev = ship(wplan.vplan, DEVICE, wplan.desc)
        t_in = int(np.argmax(desc[:, 1]))
        rng = np.random.default_rng(SEED)
        for t in (t_in, t_in + 1):
            k, k2, P = (int(x) for x in desc[t, :3])
            V, SH = self.u_random_state((R1, k, k), rng)
            codes = [torch.zeros(wplan.bp_bytes, dtype=torch.uint8,
                                 device=DEVICE) for _ in range(2)]
            outs = [self.fns["fused_forward"][i](dev, t, t + 1, V, codes[i])
                    for i in (0, 1)]
            self.compare("fused_forward",
                         (outs[0], fused._codes(codes[0], desc[t], R1)),
                         (outs[1], fused._codes(codes[1], desc[t], R1)))
            del codes, outs
            words = [torch.zeros(R1 * k2 * k2, dtype=torch.int32,
                                 device=DEVICE) for _ in range(2)]
            outs = [self.fns["chunk_step"][i](dev, t, t + 1, V, SH, words[i],
                                              [0]) for i in (0, 1)]
            self.compare("chunk_step", (*outs[0], words[0]),
                         (*outs[1], words[1]))
            live = int((outs[1][0] >= 0).sum())
            del words, outs
            self.torch.cuda.empty_cache()
            log(f"U1 W transition {t}: widths {k} -> {k2}, in-degree up to "
                f"{P}, {R1 * k2 * k2} states ({live} reachable): K13 and K15 "
                "== plain")

    def u_check_runs(self, cases):
        """K13 and K15 (forward and replay) over whole plans in one call,
        and cut at a third (a run ended short on each side), against their
        plain versions on every element: U1's graphs, and MHC-shaped graphs
        with a band of levels at and one past the widest the run kernel
        holds at R (its shared-memory edge, for K13 and for K15)."""
        import numpy as np

        from dipgenie_tpu_torch.ops import fused
        from dipgenie_tpu_torch.ops.vertex_plan import (
            initial_state, run_smem_bytes, ship,
        )
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        torch = self.torch
        budget = fused.smem_budget(DEVICE)
        edges = {sh: max(w for w in range(1, 64)
                         if run_smem_bytes(w, R + 1, sh) <= budget)
                 for sh in (False, True)}
        bands = sorted({w + d for w in edges.values() for d in (0, 1)})
        cases = list(cases) + [
            (f"band {w}", mhc_shaped_csr(L=60, seed=w, n_bands=1,
                                         band_len=4, wmin=w, wmax=w), R)
            for w in bands]
        runs = cross = 0
        for tag, arrs, r in cases:
            plan = fused.plan_fused(*arrs, r)
            dev = ship(plan.vplan, DEVICE, plan.desc)
            R1, T = r + 1, plan.T
            sizes = R1 * plan.desc[:, 1] ** 2
            for t0, t1 in ((0, T), (0, max(T // 3, 1)), (max(T // 3, 1), T)):
                if t1 <= t0:
                    continue
                cut = fused.launch_cut(dev, t0, t1, R1, False)
                runs += int((cut[:, 2] > 0).sum())
                cross += int(((cut[:, 2] > 0) & (cut[:, 0] > t0)).sum())
                k = int(plan.vplan.widths[t0])
                V = (initial_state(r, k, DEVICE) if t0 == 0 else
                     self.u_random_state((R1, k, k))[0])
                SH = torch.zeros_like(V)
                codes = [torch.zeros(plan.bp_bytes, dtype=torch.uint8,
                                     device=DEVICE) for _ in range(2)]
                outs = [self.fns["fused_forward"][i](dev, t0, t1, V, codes[i])
                        for i in (0, 1)]
                self.compare("fused_forward", (outs[0], codes[0]),
                             (outs[1], codes[1]))
                o = np.concatenate([[0], np.cumsum(sizes[t0:t1])[:-1]])
                words = [torch.zeros(int(sizes[t0:t1].sum()),
                                     dtype=torch.int32, device=DEVICE)
                         for _ in range(2)]
                outs = [self.fns["chunk_step"][i](dev, t0, t1, V, SH,
                                                  words[i], o)
                        for i in (0, 1)]
                self.compare("chunk_step", (*outs[0], words[0]),
                             (*outs[1], words[1]))
        log(f"U1 K13 and K15 over whole plans and across run ends "
            f"({len(cases)} graphs, {runs} runs, the widest runs at R={R} "
            f"{edges[False]} (K13) and {edges[True]} (K15) wide, bands "
            f"{bands}): == plain")

    def u_check_shares(self):
        """K15's per-transition kernel on tp shares (``chunk_share``) on
        C's first U_PREFIX transitions, from the path's state: every
        per-transition launch of the card's cut split for TP_SHARDS ranks,
        each share equal to its plain version on every element, and the
        shares stitched by ``place`` (as the all-gather stacks them) equal
        to the unshared launch, V, SH and words."""
        from dipgenie_tpu_torch.ops import chunked, fused
        from dipgenie_tpu_torch.ops.vertex_plan import (
            initial_state, plan_vertices, ship,
        )

        torch = self.torch
        plan = plan_vertices(*self.c["arrs"])
        n, R1 = min(U_PREFIX, plan.T), R + 1
        dev = ship(plan, DEVICE)
        k15 = self.fns["chunk_step"][0]
        share, share_ref = self.fns["chunk_share"]
        V = initial_state(R, int(plan.widths[0]), DEVICE)
        SH = torch.zeros_like(V)
        wide = short = 0
        for first, end, kmax in fused.launch_cut(dev, 0, n, R1,
                                                 True).tolist():
            if kmax > 0:
                V, SH = (x.clone() for x in k15(dev, first, end, V, SH))
                continue
            k2 = int(plan.desc[first, 1])
            kk2 = k2 * k2
            words = torch.zeros(R1 * kk2, dtype=torch.int32, device=DEVICE)
            want = (*(x.reshape(-1) for x in k15(
                dev, first, end, V, SH, words, [0])), words)
            for n_tp in TP_SHARDS:
                S = chunked.share_of(kk2, n_tp, 0)[2]
                g = torch.full((n_tp, 3, R1, S), -7, dtype=torch.int32,
                               device=DEVICE)
                for d in range(n_tp):
                    p0, p1, _ = chunked.share_of(kk2, n_tp, d)
                    share(dev, first, V, SH, p0, p1, g[d])
                    self.compare("chunk_share", tuple(
                        g[d, c, :, :p1 - p0] for c in range(3)),
                        share_ref(dev, first, V, SH, p0, p1))
                stitched = []
                for c in range(3):
                    stitched.append(torch.empty(R1 * kk2, dtype=torch.int32,
                                                device=DEVICE))
                    chunked.place(g[:, c], stitched[-1], kk2)
                self.compare("chunk_share", tuple(stitched), want)
                short += kk2 % n_tp != 0
            wide += 1
            V, SH = (x.view(R1, k2, k2).clone() for x in want[:2])
        check(wide > 0 and short > 0, f"U1 shares: {wide} wide transitions, "
              f"{short} short last shares")
        log(f"U1 chunk_share on C's first {n} transitions: {wide} wide "
            f"transitions split for {TP_SHARDS} ranks ({short} splits with "
            "a short last share), each share == plain, the shares stitched "
            "== the unshared launch (V, SH, words)")

    def u_check_walks(self):
        """K14 and K16 on walks with staged transitions and transitions read
        through L2, against their plain versions on every element: levels
        1,000-1,024 wide among narrow ones, and narrow levels whose r falls
        past the rows staged a batch earlier (every second edge a
        recombination); K16 in spans (the last transition alone, the first
        span). The walkers' cycle stamps must show both kinds."""
        import numpy as np

        from dipgenie_tpu_torch.ops import chunked, fused
        from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        torch = self.torch
        falls = list(mhc_shaped_csr(L=300, seed=4, n_bands=2, band_len=3))
        deg = np.diff(falls[1])
        falls[3] = falls[3].copy()
        falls[3][falls[1][:-1][deg == 2] + 1] = 1
        cases = {"wide 1000": mhc_shaped_csr(L=40, seed=3, n_bands=1,
                                             band_len=3, wmin=1000,
                                             wmax=1024),
                 "r falls": tuple(falls)}
        for tag, arrs in cases.items():
            plan = fused.plan_fused(*arrs, R)
            dev = ship(plan.vplan, DEVICE, plan.desc)
            T, R1 = plan.T, R + 1
            V0 = initial_state(R, int(plan.vplan.widths[0]), DEVICE)
            codes = torch.zeros(plan.bp_bytes, dtype=torch.uint8,
                                device=DEVICE)
            fused.fused_forward(dev, 0, T, V0, codes)
            got = self.fns["fused_trace"][0](dev, codes, R)
            want = self.fns["fused_trace"][1](dev, codes, R)
            self.compare("fused_trace", (got[0], torch.tensor(got[1])),
                         (want[0], torch.tensor(want[1])))
            cyc = torch.zeros(T, dtype=torch.int32, device=DEVICE)
            fused.fused_trace(dev, codes, R, cyc)
            k14 = self.u_stamps(cyc)
            sizes = R1 * plan.desc[:, 1] ** 2
            woff = np.zeros(T + 1, np.int64)
            np.cumsum(sizes, out=woff[1:])
            words = torch.zeros(int(woff[-1]), dtype=torch.int32,
                                device=DEVICE)
            chunked.chunk_step(dev, 0, T, V0, torch.zeros_like(V0), words,
                               woff[:-1])
            wdev = torch.from_numpy(woff).to(DEVICE)
            for spans in ([(0, T)], u_spans(T)):
                self.compare("chunk_trace", *(
                    self.u_walk(i, dev, wdev, words, R, spans)
                    for i in (0, 1)))
            chunked.chunk_trace(dev, wdev, 0, T, words, torch.tensor(
                [0, 0, R], dtype=torch.int32, device=DEVICE), torch.zeros(
                (T, 4), dtype=torch.int32, device=DEVICE), cyc)
            k16 = self.u_stamps(cyc)
            check(all(k[0][0] and k[1][0] for k in (k14, k16)),
                  f"U1 {tag}: the walkers' stamps show only one kind of "
                  f"transition: K14 {k14}, K16 {k16}")
            log(f"U1 {tag}: {T} transitions, K14 and K16 == plain; walker "
                f"cycles (staged / through L2): K14 {self.u_cycles(k14)}, "
                f"K16 {self.u_cycles(k16)}")

    def u_stamps(self, cyc):
        """The walker's cycle stamps (cycles << 1 | staged) as ((n, mean,
        median) of the staged steps, the same of the steps read through
        L2)."""
        import numpy as np

        c = cyc.cpu().numpy().astype(np.int64)
        out = []
        for kind in (1, 0):
            x = (c >> 1)[(c & 1) == kind]
            out.append((len(x), float(x.mean()) if len(x) else 0.0,
                        float(np.median(x)) if len(x) else 0.0))
        return tuple(out)

    @staticmethod
    def u_cycles(stamps):
        return " / ".join(f"{n} steps mean {m:.1f} median {md:.0f}"
                          for n, m, md in stamps)

    def u_random_state(self, shape, rng=None):
        """(V, SH) on the card: V with a third of its states unreachable."""
        import numpy as np

        from dipgenie_tpu_torch.ops.vertex_plan import NEG

        rng = np.random.default_rng(SEED) if rng is None else rng
        val = rng.integers(0, 1000, shape)
        V = np.where(rng.random(shape) < 0.33, NEG, val).astype(np.int32)
        SH = rng.integers(0, 50, shape).astype(np.int32)
        return (self.torch.from_numpy(V).to(DEVICE),
                self.torch.from_numpy(SH).to(DEVICE))

    def phase_u2(self):
        """Both tiers on C through the solver's entry (launches counted),
        then by stages: plan, ship (host clock), forward and traceback (CUDA
        events), peak memory; each result equal to the native tier's."""
        from dipgenie_tpu_torch.ops import chunked, fused
        from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices
        from dipgenie_tpu_torch.solver.diploid import vertex_forward
        from dipgenie_tpu_torch.utils.synth import dp_states

        torch = self.torch
        arrs, want = self.c["arrs"], self.c["want"]
        states = dp_states(arrs[0], R)
        T = len(arrs[0]) - 2
        for tier, name in (("fused", "fused"), ("jax", "chunked")):
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            t0 = time.time()
            got = vertex_forward(arrs, R, DEVICE, tier)
            wall = time.time() - t0
            launches = self.launches[f"U2 {name}"] = self.counts()
            check(got == want, f"U2 {name} tier differs from the native "
                  f"tier: {got[:2]} vs {want[:2]}")
            used = {k: v for k, v in launches.items() if v}
            if tier == "fused":
                expect = {"fused_forward": u_launches(arrs, [(0, T)], False),
                          "fused_trace": 1}
            else:
                dp = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, DEVICE)
                expect = {"chunk_step": 2 * u_launches(arrs, dp.spans, True),
                          "chunk_trace": len(dp.spans)}
            check(used == expect, f"U2 {name} launches {used}, want {expect}")
            log(f"U2 {name} tier through the solver's entry: "
                f"{wall:.3f}s (plan, ship, forward, traceback; host clock), "
                f"peak memory {torch.cuda.max_memory_allocated()} B, "
                f"launches {used}; == native tier")

        for name in ("fused", "chunked"):
            t0 = time.time()
            if name == "fused":
                plan = fused.plan_fused(*arrs, R)
                dp = fused.FusedDiploidDP(plan, DEVICE)
            else:
                dp = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, DEVICE)
            plan_s = time.time() - t0
            t0 = time.time()
            dev = dp.ship()
            self.sync()
            ship_s = time.time() - t0
            warm = dp.forward(dev)  # the card idled through the plan
            self.sync()
            del warm
            ev = self.events(3)
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
            if name == "fused":
                V, bp = dp.forward(dev)
                ev[1].record()
                rows, sh = fused.fused_trace(dev, bp, R)
                ev[2].record()
                self.sync()
                got = (int(V[R, 0, 0]), sh,
                       fused.path_transitions(rows.cpu().numpy()))
                cyc = torch.zeros(T, dtype=torch.int32, device=DEVICE)
                fused.fused_trace(dev, bp, R, cyc)
                log(f"U2 K14 on C's whole plan, walker cycles a transition "
                    f"(staged / through L2): "
                    f"{self.u_cycles(self.u_stamps(cyc))}")
                del bp, cyc
            else:
                V, SH, ckpts = dp.forward(dev)
                ev[1].record()
                rows = dp.traceback(dev, ckpts)
                ev[2].record()
                self.sync()
                got = (int(V[R, 0, 0]), int(SH[R, 0, 0]),
                       fused.path_transitions(rows.cpu().numpy()))
            check(got == want, f"U2 {name} (by stages) differs from the "
                  "native tier")
            fwd_s = ev[0].elapsed_time(ev[1]) / 1e3
            tb_s = ev[1].elapsed_time(ev[2]) / 1e3
            peak = torch.cuda.max_memory_allocated()
            pairs = (f"{self.plan_s['C']:.3f}s" if "C" in self.plan_s
                     else "not run")
            log(f"U2 {name} on C ({T} transitions, {states} DP states): plan "
                f"{plan_s:.3f}s (plan_pairs {pairs}), ship {ship_s:.3f}s "
                f"(host clock), forward {fwd_s:.4f}s, "
                f"traceback {tb_s:.4f}s (CUDA events), {states / fwd_s:.4e} "
                f"DP states/s, peak memory {peak} B, card "
                f"{torch.cuda.get_device_name(0)}")
            del dev, rows
            torch.cuda.empty_cache()
        self.u_split(arrs)
        self.u_time(arrs)

    def u_split(self, arrs):
        """K13's device time on C's fused forward (one profiled forward)
        between its run kernel (runs of narrow transitions) and its
        per-transition kernel (wide transitions), beside the launches of
        each."""
        from dipgenie_tpu_torch.ops import fused

        plan = fused.plan_fused(*arrs, R)
        dp = fused.FusedDiploidDP(plan, DEVICE)
        dev = dp.ship()
        cut = fused.launch_cut(dev, 0, plan.T, R + 1, False)
        with self.profiler() as prof:
            ms, (V, bp) = self.timed(lambda: dp.forward(dev))
        del V, bp
        rows = self.device_rows(prof, "profile_U_split.txt")
        run = sum(t for k, t, _ in rows if "vertex_run" in k) / 1e3
        step = sum(t for k, t, _ in rows if "vertex_step" in k) / 1e3
        n_run = int((cut[:, 2] > 0).sum())
        busy = sum(t for _, t, _ in rows) / 1e3
        log(f"U K13 on C's fused forward {ms:.4f} ms (CUDA events): run "
            f"kernel {run:.4f} ms device in {n_run} launches ("
            f"{int((cut[cut[:, 2] > 0, 1] - cut[cut[:, 2] > 0, 0]).sum())} "
            f"transitions), per-transition kernel {step:.4f} ms in "
            f"{len(cut) - n_run} launches; shares of K13's device time "
            f"{run / max(run + step, 1e-9):.4f} / "
            f"{step / max(run + step, 1e-9):.4f}; idle share "
            f"{1 - busy / ms:.4f} (profiler)")
        self.torch.cuda.empty_cache()

    def u_time(self, arrs):
        """K13-K16 beside their plain versions on C's first U_PREFIX
        transitions, in turns plain, kernel, kernel, plain (CUDA events,
        min of 2), with their bounds from the prefix's tables."""
        import dataclasses

        import numpy as np

        from dipgenie_tpu_torch.ops import fused
        from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

        torch = self.torch
        plan = fused.plan_fused(*arrs, R)
        n, R1 = min(U_PREFIX, plan.T), R + 1
        dev = ship(plan.vplan, DEVICE, plan.desc)
        sub = dataclasses.replace(dev, desc=dev.desc[:n],
                                  desc_dev=dev.desc_dev[:n],
                                  widths=dev.widths[:n + 1])
        desc = plan.desc[:n]
        nbytes = int(plan.desc[n, fused.BP_OFF]) if n < plan.T \
            else plan.bp_bytes
        sizes = R1 * desc[:, 1] ** 2
        off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        woff = torch.from_numpy(np.append(off, int(sizes.sum()))).to(DEVICE)
        V0 = initial_state(R, int(plan.vplan.widths[0]), DEVICE)
        SH0 = torch.zeros_like(V0)
        codes = [torch.zeros(nbytes, dtype=torch.uint8, device=DEVICE)
                 for _ in range(2)]
        words = [torch.zeros(int(sizes.sum()), dtype=torch.int32,
                             device=DEVICE) for _ in range(2)]
        def fused_trace(w):
            rows, sh = self.fns["fused_trace"][w](sub, codes[w], R)
            return rows, torch.tensor(sh)

        runs = {
            "fused_forward": lambda w: (
                self.fns["fused_forward"][w](sub, 0, n, V0, codes[w]),
                codes[w]),
            "fused_trace": fused_trace,
            "chunk_step": lambda w: (
                *self.fns["chunk_step"][w](sub, 0, n, V0, SH0, words[w], off),
                words[w]),
            "chunk_trace": lambda w: self.u_walk(w, sub, woff, words[w], R,
                                                 [(0, n)]),
        }
        work = u_work(plan, n)
        for name, run in runs.items():
            times, outs = {0: [], 1: []}, {}
            for which in (1, 0, 0, 1):  # plain, kernel, kernel, plain
                ms, outs[which] = self.timed(lambda: run(which))
                times[which].append(ms)
            self.compare(name, outs[0], outs[1])
            del outs
            with self.profiler() as prof:
                run(0)
                self.sync()
            rows = self.device_rows(prof, f"profile_U_{name}.txt")
            self.ms[name] = min(times[0])
            self.plain_ms[name] = min(times[1])
            self.bound[name] = bound(*work[name])
            self.prefix_tr[name] = n
            busy = sum(t for _, t, _ in rows) / 1e3
            entry = {"fused_trace": "dg_fused_trace",
                     "chunk_trace": "dg_chunk_trace"}.get(name)
            if entry:  # the walkers: one launch, which the profile misses
                with self.launch_events(entry) as pairs:
                    run(0)
                    self.sync()
                device = (f"device {pairs[0][0].elapsed_time(pairs[0][1]):.4f}"
                          " ms by CUDA events around the launch")
            elif busy:
                device = (f"device {busy:.4f} ms by the profiler, idle share "
                          f"{1 - busy / self.ms[name]:.4f}")
            else:
                device = "device not measured: no row in the profile"
            if name in ("fused_trace", "chunk_trace"):
                cyc = torch.zeros(n, dtype=torch.int32, device=DEVICE)
                if name == "fused_trace":
                    fused.fused_trace(sub, codes[0], R, cyc)
                else:
                    self.u_walk(0, sub, woff, words[0], R, [(0, n)], cyc)
                device += (", walker cycles a transition (staged / through "
                           f"L2) {self.u_cycles(self.u_stamps(cyc))}")
            log(f"U {name} on C's first {n} transitions: kernel {times[0]} "
                f"ms ({device}), plain "
                f"{times[1]} ms (CUDA events), bound "
                f"{self.bound[name][0]:.6g} ms ({self.bound[name][1]}; "
                f"{work[name][0]} B, {work[name][1]} int32 operations)")

    def u_walk(self, w, dev, woff, words, r, spans, cyc=None):
        """(rows, carry) of K16 (``w`` 0) or its plain version (1) over
        ``spans`` in that order from the sink at ``r``, each span's words at
        its own offset of the plan-wide ``words``."""
        torch = self.torch
        carry = torch.tensor([0, 0, r], dtype=torch.int32, device=DEVICE)
        out = torch.zeros((dev.T, 4), dtype=torch.int32, device=DEVICE)
        base = woff.cpu().numpy()
        for t0, t1 in spans:
            args = (dev, woff, t0, t1, words[int(base[t0]):], carry,
                    out[t0:t1])
            if cyc is None:
                self.fns["chunk_trace"][w](*args)
            else:
                self.fns["chunk_trace"][w](*args, cyc[t0:t1])
        return out, carry

    def phase_u3(self, w, wplan):
        """W through ``auto``: the torch tier's planner stops at its window
        limit with one [W::diploid_dp] line, the fused tier runs and equals
        the native tier; then the chunked tier on W, its peak memory beside
        the fused tier's."""
        import io

        import numpy as np

        from dipgenie_tpu_torch.ops import chunked, pair_plan
        from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices
        from dipgenie_tpu_torch.solver.diploid import (
            device_forward, native_forward_csr,
        )
        from dipgenie_tpu_torch.utils.synth import dp_states

        torch = self.torch
        widths = np.diff(w[0])
        T = len(widths) - 1
        states = dp_states(w[0], R)
        log(f"U3 W: {len(widths)} levels, {int((widths > 512).sum())} wider "
            f"than 512 (up to {int(widths.max())}), in-degree up to "
            f"{int(wplan.desc[:, 2].max())}, {states} DP states (R={R}), "
            f"fused backpointers {wplan.bp_bytes} B")
        t0 = time.time()
        want = native_forward_csr(w, R)
        log(f"U3 W native C++ tier {time.time() - t0:.1f}s (host)")
        err = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        t0 = time.time()
        with contextlib.redirect_stderr(err):
            got = device_forward(w, R, "auto", DEVICE)
        wall = time.time() - t0
        launches = {k: v for k, v in self.counts().items() if v}
        self.launches["U3"] = launches
        peak_fused = torch.cuda.max_memory_allocated()
        warns = [x for x in err.getvalue().splitlines()
                 if x.startswith("[W::")]
        for line in err.getvalue().splitlines():
            log(f"U3 stderr: {line}")
        check(len(warns) == 1 and f"1024-lane windows, past "
              f"{pair_plan.SPLIT_NB_MAX} (a level wider than 512); running "
              "the fused tier" in warns[0],
              f"U3 the [W::diploid_dp] line: {warns}")
        expect = {"fused_forward": u_launches(w, [(0, T)], False),
                  "fused_trace": 1}
        check(launches == expect, f"U3 launches {launches}, want {expect}")
        check(got == want, f"U3 W through auto differs from the native "
              f"tier: {got[:2]} vs {want[:2]}")
        log(f"U3 W through auto: {wall:.3f}s (the torch tier's planner up "
            f"to its limit, then the fused tier; host clock), peak memory "
            f"{peak_fused} B, launches {launches}; value {got[0]} s_het "
            f"{got[1]} == native tier")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        dp = chunked.DeviceDiploidDP(plan_vertices(*w), R, DEVICE)
        got = dp.run()
        check(got == want, "U3 the chunked tier on W differs from the "
              "native tier")
        log(f"U3 W chunked tier: {time.time() - t0:.3f}s (plan to result, "
            f"host clock), {len(dp.ops)} ops, {len(dp.spans)} spans; "
            f"peak memory {torch.cuda.max_memory_allocated()} B beside the "
            f"fused tier's {peak_fused} B; == native tier")

    def phase_e(self):
        from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
        from dipgenie_tpu_torch.ops.plan import initial_v, plan_to_device
        from dipgenie_tpu_torch.ops.trace import trace
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        t_phase = time.time()
        wmin, wmax = BIG_WIDTHS
        plan, dplan, got = self.main_path(
            "E", mhc_shaped_csr(L=L_E, seed=SEED, n_bands=L_E // 400,
                                wmin=wmin, wmax=wmax))
        self.big = {"plan": plan, "dplan": dplan, "want": got,
                    # phase F2's reference: the single-device path (K1, K3)
                    "want_f2": PairDiploidDP(plan_prefix(dplan, L_F2),
                                             DEVICE).run()}
        self.time_prefix("E", dplan, ("wide_split_run",))

        # K2 against K3 on the same big runs: per run from the same input
        # state (K3, K2, K2, K3), then the whole DP through each
        dplan2 = plan_to_device(plan, DEVICE, dense_nb_max=31)
        big = [i for i, s in enumerate(dplan.segments)
               if s.kind == "wide_split"]
        k3, k2 = self.fns["wide_split_run"][0], self.fns["wide_dense_run"][0]
        v_ins = {}
        V = initial_v(R, DEVICE)
        for i, seg in enumerate(dplan.segments):
            if seg.kind == "wide_split":
                v_ins[i] = V
            V = self.fns[KIND_KERNEL[seg.kind]][0](seg, V)[0]

        def loop(fn, segs):
            return [fn(segs[i], v_ins[i])[0] for i in big]

        times = {"K3": [], "K2": []}
        outs = {}
        for which in ("K3", "K2", "K2", "K3"):
            fn, segs = ((k3, dplan.segments) if which == "K3"
                        else (k2, dplan2.segments))
            ms, outs[which] = self.timed(lambda: loop(fn, segs))
            times[which].append(ms)
        for a, b in zip(outs["K3"], outs["K2"]):
            check(bool(self.torch.equal(a, b)), "E: K2 and K3 V differ")
        del outs
        dev_ms = {}
        for which, fn, segs in (("K3", k3, dplan.segments),
                                ("K2", k2, dplan2.segments)):
            with self.profiler() as prof:
                loop(fn, segs)
                self.sync()
            rows = self.device_rows(prof, f"profile_E_big_runs_{which}.txt")
            dev_ms[which] = sum(t for _, t, _ in rows) / 1e3
        n_tr = sum(dplan.segments[i].t1 - dplan.segments[i].t0 for i in big)
        V3, bps3 = PairDiploidDP(dplan, DEVICE).forward()
        recs3 = trace(dplan, bps3)
        del bps3
        V2, bps2 = PairDiploidDP(dplan2, DEVICE).forward()
        recs2 = trace(dplan2, bps2)
        del bps2
        self.sync()
        check(bool(self.torch.equal(V3, V2) and self.torch.equal(recs3, recs2)),
              "E: the DP through K2 and through K3 differ")
        log(f"E K2 vs K3 on the same {len(big)} big runs ({n_tr} "
            f"transitions, NB 31): K3 {times['K3']} ms, K2 {times['K2']} ms "
            "(CUDA events, one host call per run), device K3 "
            f"{dev_ms['K3']:.3f} ms, K2 {dev_ms['K2']:.3f} ms (profiler); V "
            "of every run and the whole DP's V and traceback records equal"
            + k2_slices(dplan2))
        self.k3_transitions(dplan, big, v_ins)
        log(f"E phase {time.time() - t_phase:.1f}s")

    def k3_transitions(self, dplan, big, v_ins):
        """K3's device time a transition on E's ordinary transitions and on
        its band ends (a run's last, wide into narrow: the heavy
        destinations are there): the big runs cut before their last
        transition against the whole runs, from the same input states
        (profiler, in turns); E's whole-plan bound for K3."""
        import dataclasses

        k3 = self.fns["wide_split_run"][0]

        def cut(seg):  # the run without its last transition
            h, n = seg.host, seg.t1 - seg.t0 - 1
            host = dataclasses.replace(
                h, t1=h.t1 - 1, nrows=int(h.tb_bprow[n]),
                **{f: getattr(h, f)[:n] for f in (
                    "tb_chunkbase", "tb_bits", "tb_bprow", "tb_bin",
                    "tb_bout")})
            return dataclasses.replace(seg, host=host,
                                       k3_desc=seg.k3_desc[:n].contiguous(),
                                       k3_cuts=seg.k3_cuts[:n].contiguous())

        segs = {"whole": [dplan.segments[i] for i in big]}
        segs["cut"] = [cut(s) for s in segs["whole"]]
        dev = {"whole": [], "cut": []}
        for which in ("whole", "cut", "cut", "whole"):
            with self.profiler() as prof:
                for seg, i in zip(segs[which], big):
                    k3(seg, v_ins[i])
                self.sync()
            dev[which].append(sum(t for k, t, _ in self.device_rows(
                prof, f"profile_E_k3_{which}.txt") if "split_kernel" in k))
        n_cut = sum(s.t1 - s.t0 for s in segs["cut"])
        whole, part = min(dev["whole"]), min(dev["cut"])
        nb = no = 0
        for seg in dplan.segments:
            if seg.kind == "wide_split":
                b, o = work(seg, seg.host.nrows * (R + 1) * 1024 * 4, R + 1)
                nb, no = nb + b, no + o
        n_all = sum(s.t1 - s.t0 for s in dplan.segments
                    if s.kind == "wide_split")
        plan_bound = bound(nb, no)
        log(f"E K3 device time (profiler, min of 2): the {len(big)} runs "
            f"{whole / 1e3:.3f} ms, without their band ends {part / 1e3:.3f} "
            f"ms: {part / n_cut:.3f} us an ordinary transition ({n_cut}), "
            f"{(whole - part) / len(big):.3f} us a band end ({len(big)}; all "
            f"{[round(x / 1e3, 3) for x in dev['whole']]} / "
            f"{[round(x / 1e3, 3) for x in dev['cut']]} ms); bound on E's "
            f"whole plan ({n_all} wide transitions) {plan_bound[0]:.6g} ms "
            f"({plan_bound[1]}), {plan_bound[0] / n_all * 1e3:.4f} us a "
            "transition")
        self.k3_slices_warm(dplan)

    def k3_slices_warm(self, dplan):
        """K3's slices of E's plan cut again from the shipped tables, warm
        (the ship cut them first, right after the host planner's idle),
        host clock; equal to the shipped ones."""
        from dipgenie_tpu_torch.ops.plan import chunk_bounds, split_slices
        from dipgenie_tpu_torch.ops.wide_split import ext_windows

        runs = [s for s in dplan.segments if s.kind == "wide_split"]
        self.sync()
        warm0 = span_s("plan.split_slices")
        for seg in runs:
            h = seg.host
            cuts, _, m = split_slices(
                seg.t["tbl"], seg.t["wwin"],
                chunk_bounds(h.tb_chunkbase, seg.nreal), ext_windows(h),
                h.NB * 1024, seg.k3_grid, 2)
            check(m == seg.k3_per_block and bool(self.torch.equal(
                cuts, seg.k3_cuts)), "E: K3's slices cut again differ")
        warm = span_s("plan.split_slices") - warm0
        log(f"E K3's slices cut again, warm: {warm:.3f}s for {len(runs)} "
            f"runs, {warm / len(runs) * 1e3:.3f} ms a run (host clock); "
            "equal to the shipped ones")

    # ---------------- phase F ----------------
    def phase_f1(self):
        """The tp path in a one-rank gloo mesh in this process: K4 on the
        main path with a merge that moves nothing between ranks."""
        import torch.distributed as dist

        from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP, assemble
        from dipgenie_tpu_torch.ops.plan import plan_to_device
        from dipgenie_tpu_torch.ops.trace import trace
        from dipgenie_tpu_torch.parallel.mesh import make_mesh

        torch = self.torch
        plan, want = self.big["plan"], self.big["want"]
        dist.init_process_group("gloo", init_method=pg_file("f1"),
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(n_tp=1)
            slices0 = span_s("plan.split_slices")
            t0 = time.time()
            dplan = plan_to_device(plan, DEVICE, mesh=mesh)
            self.sync()
            ship_s = time.time() - t0
            slices_s = span_s("plan.split_slices") - slices0
            kinds = [s.kind for s in dplan.segments]
            n_wide_tr = sum(s.t1 - s.t0 for s in dplan.segments
                            if s.kind == "wide_tp")
            dp = PairDiploidDP(dplan, DEVICE, mesh=mesh)
            dp.forward()  # warm pass
            self.sync()
            ev = self.events(3)
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            merge0 = span_s("pair.tp_merge")
            ev[0].record()
            V, bps = dp.forward()
            ev[1].record()
            recs = trace(dplan, bps)
            ev[2].record()
            self.sync()
            got = assemble(int(V[R, 0]), recs.cpu().numpy())
            launches = self.launches["F1"] = self.counts()
            fwd_s = ev[0].elapsed_time(ev[1]) / 1e3
            tb_s = ev[1].elapsed_time(ev[2]) / 1e3
            merge_s = span_s("pair.tp_merge") - merge0
            log(f"F1 one-rank tp mesh (gloo): ship {ship_s:.3f}s (of it K4's "
                f"slices {slices_s:.3f}s, host clock), forward "
                f"{fwd_s:.4f}s, traceback {tb_s:.4f}s (CUDA events), of the "
                f"forward {merge_s:.4f}s in {n_wide_tr} merges (spans), "
                f"peak memory {torch.cuda.max_memory_allocated()} B, launches "
                f"{launches}")
            want_l = {**dict.fromkeys(KERNELS, 0),
                      "narrow_run": kinds.count("narrow"), "trace": 1,
                      "wide_step": n_wide_tr}
            check(launches == want_l, f"F1 launches {launches}, want {want_l}")
            check(got == want, f"F1 DP {got[:2]} differs from phase E's "
                  f"{want[:2]}")
            log(f"F1 value {got[0]} s_het {got[1]} and {len(got[2])} "
                "transitions == phase E == native tier")
            del V, bps, recs
            self.profile_forward("F1", dp)
            self.k4_beside_k3(dplan, mesh)
            self.time_k4_prefix(dplan, mesh)
        finally:
            dist.destroy_process_group()
        self.big.pop("dplan")

    def wide_inputs(self, dplan, mesh):
        """{segment index: input state} of the wide_tp runs of a plan."""
        from dipgenie_tpu_torch.ops.plan import initial_v
        from dipgenie_tpu_torch.ops.wide_step import wide_tp_run

        v_ins, V = {}, initial_v(R, DEVICE)
        for i, seg in enumerate(dplan.segments):
            if seg.kind == "wide_tp":
                v_ins[i] = V
                V = wide_tp_run(seg, V, mesh.tp)[0]
            else:
                V = self.fns[KIND_KERNEL[seg.kind]][0](seg, V)[0]
        return v_ins

    def k4_beside_k3(self, dplan, mesh):
        """Device time (profiler) of the big runs through the tp path (K4,
        merge, commit) and through K3, from the same input states."""
        from dipgenie_tpu_torch.ops.wide_step import wide_tp_run

        v_ins = self.wide_inputs(dplan, mesh)
        k3 = self.fns["wide_split_run"][0]
        e_segs = self.big["dplan"].segments
        loops = {
            "K4": lambda: [wide_tp_run(dplan.segments[i], v, mesh.tp)[0]
                           for i, v in v_ins.items()],
            "K3": lambda: [k3(e_segs[i], v)[0] for i, v in v_ins.items()],
        }
        outs, msg = {}, []
        for name in ("K3", "K4", "K4", "K3"):
            ms, outs[name] = self.timed(loops[name])
            msg.append(f"{name} {ms:.2f} ms")
        for a, b in zip(outs["K3"], outs["K4"]):
            check(bool(self.torch.equal(a, b)), "F1: K3 and K4 runs differ")
        del outs
        for name in ("K4", "K3"):
            with self.profiler() as prof:
                loops[name]()
                self.sync()
            rows = self.device_rows(prof, f"profile_F1_big_runs_{name}.txt")
            total = sum(t for _, t, _ in rows) / 1e3
            kern = sum(t for k, t, _ in rows if "split_kernel" in k) / 1e3
            msg.append(f"device {name} kernels {kern:.3f} ms of {total:.3f} "
                       "ms")
        n_tr = sum(dplan.segments[i].t1 - dplan.segments[i].t0 for i in v_ins)
        log(f"F1 the {len(v_ins)} big runs ({n_tr} transitions, NB 31) "
            "from the same states through the tp path and through K3: "
            + ", ".join(msg) + " (CUDA events over one host call per run "
            "or transition; device time by the profiler); V of every run "
            "equal")

    def time_k4_prefix(self, dplan, mesh):
        """K4 beside its plain version on the wide transitions of the plan's
        first PREFIX_TRANSITIONS transitions, each from its own input state
        (in turns plain, kernel, kernel, plain; CUDA events, min of 2),
        with its device time and its bound."""
        import numpy as np
        import torch.distributed as dist

        from dipgenie_tpu_torch.ops.plan import initial_v
        from dipgenie_tpu_torch.ops.wide_split import _state
        from dipgenie_tpu_torch.ops.wide_step import commit, new_partial

        torch = self.torch
        kern, plain = self.fns["wide_step"]
        steps, V = [], initial_v(R, DEVICE)
        for seg in dplan.segments:
            if seg.t0 >= PREFIX_TRANSITIONS:
                break
            if seg.kind != "wide_tp":
                V = self.fns[KIND_KERNEL[seg.kind]][0](seg, V)[0]
                continue
            W = _state(seg, V)
            bp = torch.empty(W.shape, dtype=torch.int32, device=DEVICE)
            for ti in range(seg.t1 - seg.t0):
                steps.append((seg, ti, W))
                part = kern(seg, ti, W)
                dist.all_reduce(part, op=dist.ReduceOp.MAX, group=mesh.tp)
                W = commit(part, seg.t["present"][ti], bp)
            V = W[:, :1024].contiguous()
        # each step writes into its own partial of NEG / -1, filled
        # beforehand (the main path's merge leaves its one buffer so; a
        # call again writes the same lanes with the same values)
        parts = [new_partial(s, R + 1, DEVICE) for s, _, _ in steps]
        run = {0: lambda: [kern(s, ti, W, p)
                           for (s, ti, W), p in zip(steps, parts)],
               1: lambda: [plain(s, ti, W) for s, ti, W in steps]}
        nbytes = ops = 0
        R1 = R + 1
        for s, ti, W in steps:
            c0, c1 = int(s.bounds[ti]), int(s.bounds[ti + 1])
            tbl = s.t["stbl"][c0:c1].cpu().numpy()
            real = ((tbl[:, 0] >> 2) & 2047) > 0
            ops += 2 * int(np.where(real, R1 - (tbl[:, 0] & 3), 0).sum())
            nbytes += (c1 - c0) * (4 * 2 * 256 + 8) + 3 * W.numel() * 4
        nbound = bound(nbytes, ops)
        times, outs = {0: [], 1: []}, {}
        for which in (1, 0, 0, 1):
            ms, outs[which] = self.timed(run[which])
            times[which].append(ms)
        for g, w in zip(outs[0], outs[1]):
            self.compare("wide_step", g, w)
        del outs
        with self.profiler() as prof:
            run[0]()
            self.sync()
        rows = self.device_rows(prof, "profile_F1_wide_step.txt")
        dev_ms = sum(t for _, t, _ in rows) / 1e3
        self.ms["wide_step"] = min(times[0])
        self.plain_ms["wide_step"] = min(times[1])
        self.bound["wide_step"] = nbound
        log(f"F1 wide_step on the {len(steps)} wide transitions of the first "
            f"{PREFIX_TRANSITIONS} transitions of the plan: kernel "
            f"{times[0]} ms (device {dev_ms:.3f} ms by the profiler), plain "
            f"{times[1]} ms, bound {nbound[0]:.6g} ms ({nbound[1]})")

    def phase_f2(self):
        """F_RANKS gloo ranks spawned on the one card, each running the tp
        DP on the first L_F2 levels of phase E's plan (pickled once here,
        loaded by each rank)."""
        import pickle

        want = self.big["want_f2"]
        plan = plan_prefix(self.big.pop("plan"), L_F2)
        path = os.path.join(OUT_DIR, "phase_f_plan.pkl")
        with open(path, "wb") as fh:
            pickle.dump(plan, fh, protocol=5)
        self.torch.cuda.empty_cache()
        try:
            results = spawn_ranks("f2", {"kind": "dp", "plan": path})
        finally:
            os.remove(path)
        for r, res in enumerate(results):
            check(res["result"] == want, f"F2 rank {r}: DP "
                  f"{res['result'][:2]} differs from the single-device "
                  f"path's {want[:2]}")
            log(f"F2 rank {r} of {F_RANKS} (gloo, one card) on the plan's "
                f"first {plan.L} levels: load + ship "
                f"{res['ship_s']:.3f}s, forward {res['forward_s']:.4f}s "
                f"(CUDA events), of it {res['merge_s']:.4f}s in "
                f"{res['launches']['wide_step']} merges (host timer), "
                f"traceback {res['trace_s']:.4f}s, peak memory {res['peak']} "
                f"B, launches {res['launches']}; value {want[0]} == the "
                "single-device path on the same levels")

    def phase_f3(self):
        """The port's pipeline with a mesh of F_RANKS gloo ranks on the
        card, on phase D's 18-walk pangenome (not cut)."""
        gfa, reads, native_fa, n_narrow = self.d18
        results = spawn_ranks("f3", {"kind": "pipeline", "gfa": gfa,
                                     "reads": reads})
        for r, res in enumerate(results):
            check(res["fasta"] == native_fa, f"F3 rank {r}: FASTA differs "
                  "from phase D's native tier")
            line = [x for x in res["log"].splitlines()
                    if "kernel launches" in x]
            check(bool(line), f"F3 rank {r}: torch tier not run")
            counts = {k: int(v) for k, v in (kv.split("=") for kv in
                      line[0].split("launches ", 1)[1].split())}
            check(counts["wide_step"] > 0 and counts["wide_dense_run"] == 0
                  and counts["wide_split_run"] == 0
                  and counts["narrow_run"] == n_narrow
                  and counts["trace"] == 1,
                  f"F3 rank {r}: launches {counts}")
            log(f"F3 rank {r} of {F_RANKS}: pipeline {res['seconds']:.1f}s, "
                f"FASTA byte-identical to the native tier ({len(native_fa)} "
                f"B), launches {counts}")

    # ---------------- phase F4 ----------------
    def phase_f4(self):
        """The chunked tier over a tp mesh: F4a C on a one-rank gloo mesh
        in this process and one share timed, F4b C on F_RANKS ranks, F4c
        W's first bands on F_RANKS ranks through ``auto``."""
        import numpy as np

        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

        if self.c is None:  # phases C and U not run: C and its native result
            arrs = mhc_shaped_csr(L=L_MHC, seed=SEED, n_bands=N_BANDS)
            self.c = {"arrs": arrs, "want": native_forward_csr(arrs, R)}
        self.phase_f4a()
        path = os.path.join(OUT_DIR, "phase_f4_c.npz")
        np.savez(path, **dict(zip(CSR_KEYS, self.c["arrs"])))
        try:
            results = spawn_ranks("f4b", {"kind": "chunked", "arrs": path})
        finally:
            os.remove(path)
        for r, res in enumerate(results):
            check(res["result"] == self.c["want"], f"F4b rank {r}: "
                  f"{res['result'][:2]} differs from the native tier's "
                  f"{self.c['want'][:2]}")
            self.f4_check(f"F4b rank {r}", res)
            log(f"F4b rank {r} of {F_RANKS} (gloo, one card) on C: "
                + self.f4_line(res) + "; == native tier")
        self.phase_f4c()

    def phase_f4a(self):
        """C through the chunked tier's entry on a one-rank gloo mesh in
        this process (every wide transition one share and one gather that
        moves nothing between ranks), then C's widest wide transition's
        first share of F_RANKS timed beside its plain version."""
        import torch.distributed as dist

        from dipgenie_tpu_torch.parallel.mesh import make_mesh
        from dipgenie_tpu_torch.solver.diploid import vertex_forward

        torch = self.torch
        arrs, want = self.c["arrs"], self.c["want"]
        dist.init_process_group("gloo", init_method=pg_file("f4a"),
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(n_tp=1)
            self.torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with timed_chunked(torch) as runs:
                self.reset_counts()
                got = vertex_forward(arrs, R, DEVICE, "jax", mesh)
                launches = self.launches["F4a"] = self.counts()
            res = {"result": got, "peak": torch.cuda.max_memory_allocated(),
                   "launches": launches, **runs[-1]}
        finally:
            dist.destroy_process_group()
        check(got == want, f"F4a C on one rank: {got[:2]} differs from the "
              f"native tier's {want[:2]}")
        self.f4_check("F4a", res)
        log(f"F4a C on a one-rank tp mesh (gloo, in this process): "
            + self.f4_line(res) + "; == native tier")
        self.f4_time_share(res["widest"])

    def f4_check(self, tag, res):
        """The launches and gathers a rank made: K15's run launches and
        shares and the gathers in the forward and again in the replay,
        K16 once a span."""
        c = res["cuts"]
        want = {"chunk_step": 2 * c["runs"], "chunk_share": 2 * c["shares"],
                "chunk_trace": c["spans"]}
        got = {k: res["launches"][k] for k in want}
        check(got == want, f"{tag} launches {got}, want {want}")
        check(res["stats"]["gathers"] == 2 * c["wide"] > 0,
              f"{tag}: {res['stats']['gathers']} gathers, want "
              f"{2 * c['wide']}")

    def f4_line(self, res):
        st, c = res["stats"], res["cuts"]
        return (f"forward {res['forward_s']:.4f}s, traceback "
                f"{res['traceback_s']:.4f}s (CUDA events); {st['gathers']} "
                f"all-gathers ({c['wide']} wide transitions, in the forward "
                f"and the replay) of {st['gather_bytes']} B in "
                f"{res['gather_s']:.4f}s, {res['wait_s']:.4f}s "
                f"waiting for the card before them (spans); launches "
                f"K15 runs {res['launches']['chunk_step']}, K15 shares "
                f"{res['launches']['chunk_share']}, K16 "
                f"{res['launches']['chunk_trace']}; peak memory "
                f"{res['peak']} B; card {self.smi}")

    def f4_time_share(self, widest):
        """``chunk_share`` on rank 0's share of F_RANKS of C's widest wide
        transition, from the chunked path's state, beside its plain version
        (in turns plain, kernel, kernel, plain; CUDA events) and its
        bound."""
        from dipgenie_tpu_torch.ops import chunked
        from dipgenie_tpu_torch.ops.vertex_plan import (
            initial_state, plan_vertices, ship,
        )

        torch = self.torch
        plan = plan_vertices(*self.c["arrs"])
        dev = ship(plan, DEVICE)
        t = widest
        R1, k2 = R + 1, int(plan.desc[t, 1])
        V = initial_state(R, int(plan.widths[0]), DEVICE)
        V, SH = (x.clone() for x in chunked.chunk_step(
            dev, 0, t, V, torch.zeros_like(V)))
        p0, p1, S = chunked.share_of(k2 * k2, F_RANKS, 0)
        outs = [torch.zeros((3, R1, S), dtype=torch.int32, device=DEVICE)
                for _ in range(2)]
        kern, plain = self.fns["chunk_share"]

        def run(w):
            if w == 0:
                return kern(dev, t, V, SH, p0, p1, outs[0])[:, :, :p1 - p0]
            return torch.stack(plain(dev, t, V, SH, p0, p1))

        times, got = {0: [], 1: []}, {}
        for which in (1, 0, 0, 1):
            ms, got[which] = self.timed(lambda: run(which))
            times[which].append(ms)
        self.compare("chunk_share", got[0], got[1])
        with self.launch_events("dg_chunk_step_share") as pairs:
            run(0)
            self.sync()
        device = pairs[0][0].elapsed_time(pairs[0][1])
        self.ms["chunk_share"] = min(times[0])
        self.plain_ms["chunk_share"] = min(times[1])
        nbytes, ops = share_work(plan, t, p0, p1, R1)
        self.bound["chunk_share"] = bound(nbytes, ops)
        log(f"F4a chunk_share on rank 0's share of {F_RANKS} of C's widest "
            f"wide transition {t} (widths {int(plan.desc[t, 0])} -> {k2}, "
            f"pairs [{p0}, {p1})): kernel {times[0]} ms (device "
            f"{device:.4f} ms by CUDA events around the launch), plain "
            f"{times[1]} ms (CUDA events), bound "
            f"{self.bound['chunk_share'][0]:.6g} ms "
            f"({self.bound['chunk_share'][1]}; {nbytes} B, {ops} int32 "
            f"operations); card {self.smi}")

    def phase_f4c(self):
        """W's first F4_W_BANDS band(s), a prefix closed by a sink, on
        F_RANKS ranks through ``device_forward(..., "auto", mesh)``: one
        [W::diploid_dp] line naming the window limit and the chunked tier
        over the mesh; every rank's result equal to the single-device
        chunked tier's and the native tier's on the same levels."""
        import numpy as np

        from dipgenie_tpu_torch.ops import chunked
        from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import dp_states, mhc_shaped_csr

        torch = self.torch
        w = mhc_shaped_csr(L=L_MHC, seed=SEED, **W_SHAPE)
        widths = np.diff(w[0])
        wide = np.flatnonzero(widths >= W_SHAPE["wmin"])
        ends = wide[np.append(np.diff(wide) > 1, True)]  # each band's last
        n_levels = int(ends[F4_W_BANDS - 1]) + 2
        prefix = csr_prefix(w, n_levels)
        pw = np.diff(prefix[0])
        t0 = time.time()
        want = native_forward_csr(prefix, R)
        native_s = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        single = chunked.DeviceDiploidDP(plan_vertices(*prefix), R,
                                         DEVICE).run()
        single_s = time.time() - t0
        single_peak = torch.cuda.max_memory_allocated()
        check(single == want, "F4c the single-device chunked tier on W's "
              "prefix differs from the native tier")
        log(f"F4c W cut to its first {F4_W_BANDS} band(s): levels 0-"
            f"{n_levels - 1} of W's {len(widths)} and a sink, "
            f"{len(pw)} levels, {int((pw > 512).sum())} wider than 512 (up "
            f"to {int(pw.max())}), {dp_states(prefix[0], R)} DP states; "
            f"native tier {native_s:.1f}s (host), single-device chunked "
            f"tier {single_s:.3f}s (plan to result, host clock), peak memory "
            f"{single_peak} B; == native tier")
        torch.cuda.empty_cache()
        path = os.path.join(OUT_DIR, "phase_f4_w.npz")
        np.savez(path, **dict(zip(CSR_KEYS, prefix)))
        try:
            results = spawn_ranks("f4c", {"kind": "chunked", "arrs": path,
                                          "auto": True})
        finally:
            os.remove(path)
        for r, res in enumerate(results):
            warns = [x for x in res["log"].splitlines()
                     if x.startswith("[W::")]
            check(len(warns) == 1 and warns[0].startswith(
                "[W::diploid_dp] torch tier: ") and warns[0].endswith(
                f"running the chunked tier over the tp mesh of {F_RANKS} "
                "ranks"), f"F4c rank {r}: the [W::diploid_dp] line: {warns}")
            check(res["result"] == single == want, f"F4c rank {r}: "
                  f"{res['result'][:2]} differs from the single-device "
                  f"chunked tier's {single[:2]}")
            self.f4_check(f"F4c rank {r}", res)
            log(f"F4c rank {r} of {F_RANKS} (gloo, one card) on W's prefix "
                f"through auto ({warns[0]}): " + self.f4_line(res)
                + "; == the single-device chunked tier == native tier")

    # ---------------- phase S ----------------
    def phase_s(self):
        self.s_data()
        self.phase_s1()
        self.phase_s2()
        self.phase_s3()
        self.phase_s4()

    def s_data(self):
        """Phase S's pangenome, its index and reads, the host anchor stage
        (timed, the reference of S2) and the haplotypes' sorted table."""
        import numpy as np

        from dipgenie_tpu_torch import native
        from dipgenie_tpu_torch.graph.pangenome import PangenomeIndex
        from dipgenie_tpu_torch.io.fastx import read_fastx
        from dipgenie_tpu_torch.io.gfa import read_gfa
        from dipgenie_tpu_torch.ops.sketch import encode_reads
        from dipgenie_tpu_torch.solver.anchors import (
            compute_and_classify_anchors,
        )
        from dipgenie_tpu_torch.utils.synth import pangenome

        work = os.path.join(REPO, "build", "chip_smoke_sketch")
        t0 = time.time()
        gfa, reads_fa = pangenome(work, n_bp=S_BP, n_walks=S_WALKS, seed=SEED)
        gen_s = time.time() - t0
        index = PangenomeIndex.from_gfa(read_gfa(gfa))
        reads = read_fastx(reads_fa)
        seqs = [q for _, q in reads]
        haps = [index.haplotype_seq(h) for h in range(index.num_walks)]
        t0 = time.time()
        host = compute_and_classify_anchors(index, reads, S_K, S_W, 1.0,
                                            verbose=False)
        host_s = time.time() - t0
        # the native sketcher alone, haplotypes then reads (as the anchor
        # stage calls it)
        t0 = time.time()
        hap_min = [native.sketch(np.frombuffer(h.encode("latin-1"), np.uint8),
                                 S_K, S_W)[0] for h in haps]
        nat_hap_s = time.time() - t0
        t0 = time.time()
        [np.unique(h) for h in native.sketch_batch(
            [q.encode("latin-1") for q in seqs], S_K, S_W)]
        nat_reads_s = time.time() - t0
        tbl = np.unique(np.concatenate(hap_min))
        thi = (tbl >> np.uint64(32)).astype(np.uint32)
        tlo = (tbl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        codes, lens, pure = encode_reads(seqs)
        check(bool(pure.all()), "S: the synthetic reads are not pure ACGT")
        lmax = max(len(q) for q in seqs)
        log(f"S pangenome of {S_BP} bp, {index.num_walks} walks "
            f"(haplotypes {min(map(len, haps))}-{max(map(len, haps))} bp), "
            f"{len(seqs)} reads of {min(map(len, seqs))}-{lmax} bp "
            f"({gen_s:.1f}s); host anchor stage {host_s:.3f}s (native "
            f"sketch, join, classify, numpy fit); native sketcher "
            f"{nat_hap_s:.3f}s for the haplotypes, {nat_reads_s:.3f}s for "
            f"the reads (with np.unique); spectrum {host.count_sp_r} hashes, "
            f"table {len(tbl)} haplotype hashes (host clock)")
        self.s = {"gfa": gfa, "reads_fa": reads_fa, "index": index,
                  "reads": reads, "seqs": seqs, "haps": haps, "host": host,
                  "host_s": host_s, "codes": codes, "lens": lens,
                  "thi": thi, "tlo": tlo, "nat_hap_s": nat_hap_s,
                  "nat_reads_s": nat_reads_s, "hap_min": hap_min}

    def time_ms(self, fn, n):
        """CUDA-event ms per call over ``n`` calls of ``fn``, after one
        warm-up call."""
        fn()
        a, b = self.events(2)
        self.sync()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        self.sync()
        return a.elapsed_time(b) / n

    def kernel_beside_plain(self, name, args, bound_work, ops_per_s=OPS_PER_S):
        """``name``'s ms and its plain version's on ``args`` (S_CALLS and
        S_PLAIN_CALLS calls, min of 2 in turns: kernel, plain, plain,
        kernel), its device ms (CUDA events around each launch of its C
        entry point, mean of S_CALLS) and its bound from ``bound_work``
        (bytes, operations)."""
        kern, plain = self.fns[name]
        times = ([], [])
        for which in (0, 1, 1, 0):
            f = (kern, plain)[which]
            n = (S_CALLS, S_PLAIN_CALLS)[which]
            times[which].append(self.time_ms(lambda: f(*args), n))
        self.ms[name], self.plain_ms[name] = min(times[0]), min(times[1])
        self.bound[name] = bound(*bound_work, ops_per_s)
        self.sync()
        with self.launch_events(S_ENTRY[name]) as pairs:
            for _ in range(S_CALLS):
                kern(*args)
            self.sync()
        check(len(pairs) == S_CALLS, f"{name}: {len(pairs)} launches of "
              f"{S_ENTRY[name]} in {S_CALLS} calls")
        self.device_ms[name] = sum(a.elapsed_time(b)
                                   for a, b in pairs) / S_CALLS
        return times

    def phase_s1(self):
        """K10, K11 and K12 against their plain versions on the main
        path's inputs and on seeded ragged reads, timed beside them."""
        import numpy as np

        from dipgenie_tpu_torch.models.fitter import grid_inputs
        from dipgenie_tpu_torch.ops.sketch import encode_reads
        from dipgenie_tpu_torch.parallel.mesh import u32_tensor
        from dipgenie_tpu_torch.utils.synth import ragged_reads

        torch, d = self.torch, self.s
        k10, k10_ref = self.fns["minimizer_sketch"]
        k11, k11_ref = self.fns["sketch_count"]

        def on_card(*arrays):
            return tuple(torch.from_numpy(a).to(DEVICE) for a in arrays)

        reads = on_card(d["codes"], d["lens"])
        hap = on_card(*encode_reads([d["haps"][0]])[:2])
        inputs = [("ragged", on_card(*ragged_reads(SEED, 512, 400, S_K,
                                                    S_W))),
                  ("reads", reads), ("haplotype 0", hap),
                  ("the reads from row 1 (codes not 16-byte aligned)",
                   (reads[0][1:], reads[1][1:]))]
        inputs = [(tag, S_K, S_W, c) for tag, c in inputs] + [
            (f"block edge rows (k {k}, w {w})", k, w,
             on_card(*ragged_reads(SEED + L, B, L, k, w)))
            for k, w, B, L in S1_SHAPES]
        for tag, k, w, (c, n) in inputs:
            got = k10(c, n, k, w)
            self.compare("minimizer_sketch", got, k10_ref(c, n, k, w))
            log(f"S1 minimizer_sketch on {tag} {tuple(c.shape)}: == plain "
                f"version on every element, {int(got[2].sum())} windows "
                "emitted")
        B, L = reads[0].shape
        nw = L - S_K - S_W + 2
        windows = B * nw
        # bytes: codes and lens in, 13 bytes a window out; operations: per
        # window two k-mer packs (2 a base each), w - 1 compare-selects of
        # the minimum and ~64 for the hash
        times = self.kernel_beside_plain(
            "minimizer_sketch", (*reads, S_K, S_W),
            (B * L + 4 * B + 13 * windows,
             windows * (4 * S_K + 2 * (S_W - 1) + 64)))
        log(f"S1 minimizer_sketch on the reads ({B} x {L}, {windows} "
            f"windows): kernel {times[0]} ms (device "
            f"{self.device_ms['minimizer_sketch']:.6g} ms around the launch), "
            f"plain {times[1]} ms, bound "
            f"{self.bound['minimizer_sketch'][0]:.6g} ms "
            f"({self.bound['minimizer_sketch'][1]}); "
            f"{self.sm_cycles(self.ms['minimizer_sketch'], windows)} a window")

        hh, hl, emit, _ = k10(*reads, S_K, S_W)
        tables = (u32_tensor(d["thi"], DEVICE), u32_tensor(d["tlo"], DEVICE))
        args = (hh, hl, emit, *tables)
        got = k11(*args)
        self.compare("sketch_count", got, k11_ref(*args))
        M = len(d["thi"])
        emitted = int(emit.sum())
        times = self.kernel_beside_plain(
            "sketch_count", args,
            (windows + 8 * emitted + 8 * M + 4 * M + 4 * B,
             emitted * (int(np.log2(M)) + 1 + 4)))
        log(f"S1 sketch_count on the reads' {emitted} emitted windows "
            f"against {M} haplotype hashes: == plain version, "
            f"{int(got[0].sum())} hits; kernel {times[0]} ms (device "
            f"{self.device_ms['sketch_count']:.6g} ms), plain "
            f"{times[1]} ms, bound {self.bound['sketch_count'][0]:.6g} ms "
            f"({self.bound['sketch_count'][1]}); "
            f"{self.sm_cycles(self.ms['sketch_count'], emitted)} an emitted "
            "window")
        self.s1_count_edges(hh[:S1_COUNT_READS], hl[:S1_COUNT_READS],
                            emit[:S1_COUNT_READS])

        grid, xs, ys = s_grid(d["host"])
        ins = grid_inputs(*grid, 10, xs, ys, DEVICE)
        kern, plain = self.fns["grid_nll"]
        got, want = kern(*ins), plain(*ins)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              "grid_nll: shape or non-finite values")
        diff = (got.double() - want.double()).abs()
        rel = float((diff / want.double().abs().clamp(min=1.0)).max())
        self.err["grid_nll"] = max(self.err["grid_nll"], float(diff.max()))
        self.compared["grid_nll"] += 1
        check(rel <= GRID_NLL_RTOL, f"grid_nll differs from its plain "
              f"version: relative {rel:.3g} > {GRID_NLL_RTOL}")
        points, nx = got.numel(), len(xs)
        times = self.kernel_beside_plain(
            "grid_nll", ins,
            (4 * points + sum(4 * t.numel() for t in ins), points * nx),
            SFU_PER_S)
        log(f"S1 grid_nll on {points} grid points x {nx} bins: relative "
            f"difference {rel:.3g} (<= {GRID_NLL_RTOL}), max abs "
            f"{self.err['grid_nll']:.6g}; kernel {times[0]} ms (device "
            f"{self.device_ms['grid_nll']:.6g} ms), plain "
            f"{times[1]} ms, bound {self.bound['grid_nll'][0]:.6g} ms "
            f"({self.bound['grid_nll'][1]}: one log a point and bin at "
            f"{SFU_PER_S:.4g}/s); "
            f"{self.sm_cycles(self.ms['grid_nll'], points)} a grid point")
        self.s1_tables(grid, xs)

    def s1_tables(self, grid, xs):
        """The table pass (grid_tables) against _grid_tables_torch on the
        grid's axes, as grid_inputs hands them over (views of one buffer on
        the card): every entry within a relative GRID_NLL_RTOL, clamped
        entries equal; timed beside it, with its bound (the axes read and
        the tables written once; one exp a pdf term of (u, sd or vw, copy,
        bin) and one pow a zeta weight and a ferr term, on the SFUs)."""
        from dipgenie_tpu_torch.models.fitter import axes_on

        torch = self.torch
        U, SD, VW, ZP, ZPH, _, _, SS = grid
        copies = 10
        views = axes_on(DEVICE, U, SD, VW, ZP, ZPH, SS, xs)
        args = (*views[:6], copies, views[6], DEVICE)
        kern, plain = self.fns["grid_tables"]
        floor = torch.tensor(1e-35, dtype=torch.float32, device=DEVICE)
        rel = 0.0
        for g, w in zip(kern(*args), plain(*args)):
            check(g.shape == w.shape and bool(torch.isfinite(g).all())
                  and bool((g >= floor).all()),
                  "grid_tables: shape, non-finite values or below 1e-35")
            diff = (g.double() - w.double()).abs()
            rel = max(rel, float((diff / w.double()).max()))
            self.err["grid_tables"] = max(self.err["grid_tables"],
                                          float(diff.max()))
            clamped = w == floor
            check(torch.equal(g[clamped], w[clamped]),
                  "grid_tables: a clamped entry differs")
        self.compared["grid_tables"] += 1
        check(rel <= GRID_NLL_RTOL, f"grid_tables differs from its plain "
              f"version: relative {rel:.3g} > {GRID_NLL_RTOL}")
        nu, nsd, nvw, nzp, nzph, ns, nx = (len(a) for a in
                                           (U, SD, VW, ZP, ZPH, SS, xs))
        entries = (nu * nsd * nzp + nu * nvw * nzph + ns) * nx
        nbytes = 4 * (nu + nsd + nvw + nzp + nzph + ns + nx + entries)
        ops = (nu * nsd + nu * nvw) * copies * nx \
            + (nzp + nzph) * copies + 2 * ns * nx
        times = self.kernel_beside_plain("grid_tables", args, (nbytes, ops),
                                         SFU_PER_S)
        log(f"S1 grid_tables on {entries} table entries ({copies} copies, "
            f"{nx} bins): relative difference {rel:.3g} (<= "
            f"{GRID_NLL_RTOL}), max abs {self.err['grid_tables']:.6g}, "
            f"clamped entries equal; kernel {times[0]} ms (device "
            f"{self.device_ms['grid_tables']:.6g} ms), plain {times[1]} "
            f"ms, bound {self.bound['grid_tables'][0]:.6g} ms "
            f"({self.bound['grid_tables'][1]}: {nbytes} B, {ops} exp and "
            f"pow)")

    def s1_count_edges(self, hh, hl, emit):
        """K11 against its plain version on the adversarial tables of
        utils/synth.count_tables (built from these windows' emitted
        hashes), on hashes moved to the ends of the range, and with no
        emitted window."""
        import numpy as np

        from dipgenie_tpu_torch.parallel.mesh import u32_tensor
        from dipgenie_tpu_torch.utils.synth import count_tables, edge_hashes

        torch = self.torch
        k11, k11_ref = self.fns["sketch_count"]
        host = [t.cpu().numpy() for t in (hh, hl, emit)]
        e_hh, e_hl = (torch.from_numpy(a.view(np.int32)).to(DEVICE)
                      for a in edge_hashes(*host))
        none = torch.zeros_like(emit)
        done = []
        for name, t_hi, t_lo, dups in count_tables(*host, SEED):
            tables = (u32_tensor(t_hi, DEVICE), u32_tensor(t_lo, DEVICE))
            hits = []
            for args in ((hh, hl, emit), (e_hh, e_hl, emit), (hh, hl, none)):
                for d in dups:
                    got = k11(*args, *tables, d)
                    self.compare("sketch_count", got,
                                 k11_ref(*args, *tables, d))
                    hits.append(str(int(got[0].sum())))
            done.append(f"{name} (M {len(t_hi)}, max_dup "
                        f"{'/'.join(map(str, dups))}: {'/'.join(hits)} hits)")
        log(f"S1 sketch_count on {int(emit.sum())} emitted windows of "
            f"{emit.shape[0]} reads against adversarial tables, == plain "
            f"version with the reads' hashes, with eight moved to hi 0 / "
            f"0xFFFFFFFF, and with none emitted (hits in that order, each "
            f"max_dup): {', '.join(done)}")

    def clock_mhz(self):
        """The card's maximum SM clock (nvidia-smi)."""
        return float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])

    def sm_cycles(self, ms, n):
        """SM-cycles an item of a kernel taking ``ms`` for ``n`` items, on
        every SM of the card at its maximum SM clock (nvidia-smi)."""
        mhz = self.clock_mhz()
        sms = self.torch.cuda.get_device_properties(0).multi_processor_count
        return (f"{ms * 1e-3 * sms * mhz * 1e6 / n:.4g} SM-cycles ({sms} "
                f"SMs at {mhz:.0f} MHz)")

    def phase_s2(self):
        """The anchor stage with device sketching, counted, timed and
        held field for field to S's host anchor stage."""
        import numpy as np

        from dipgenie_tpu_torch.ops.sketch import (
            sketch_long_sequence_device, sketch_reads_device,
        )
        from dipgenie_tpu_torch.solver.anchors import (
            compute_and_classify_anchors,
        )

        d = self.s
        for _ in range(2):  # warm: the card idled through the host stage
            sketch_reads_device(d["seqs"][:4096], S_K, S_W, device=DEVICE)
        self.sync()

        def stage(backend):
            t0 = time.time()
            out = compute_and_classify_anchors(
                d["index"], d["reads"], S_K, S_W, 1.0, verbose=False,
                sketch_backend=backend, device=DEVICE)
            self.sync()
            return out, time.time() - t0

        # in turns, host, device, device, host, after the same warm-up; the
        # first device run is the counted one
        secs = {"host": [stage("host")[1]], "device": []}
        self.reset_counts()
        with self.launch_events("dg_sketch") as pairs:
            dev, dev_s = stage("device")
        launches = self.launches["S2"] = self.counts()
        secs["device"] += [dev_s, stage("device")[1]]
        secs["host"].append(stage("host")[1])
        host = d["host"]
        for f in ("count_sp_r", "hap_minimizer_counts", "fit"):
            check(getattr(host, f) == getattr(dev, f), f"S2 {f} differs")
        for f in ("sp_hashes", "homo_bv", "multiplicity", "occ_sp",
                  "occ_hap", "occ_ptr", "occ_v"):
            check(np.array_equal(getattr(host, f), getattr(dev, f)),
                  f"S2 AnchorData.{f} differs")
        H = len(d["haps"])
        want = {**dict.fromkeys(KERNELS, 0), "minimizer_sketch": H + 1}
        check(launches == want, f"S2 launches {launches}, want {want}")
        ms = [a.elapsed_time(b) for a, b in pairs]
        log(f"S2 anchor stage in turns (host, device, device, host; host "
            f"clock): device sketching {secs['device'][0]:.3f} / "
            f"{secs['device'][1]:.3f}s (min {min(secs['device']):.3f}), "
            f"host sketching {secs['host'][0]:.3f} / {secs['host'][1]:.3f}s "
            f"(min {min(secs['host']):.3f}; cold in S's set-up "
            f"{d['host_s']:.3f}s): every "
            f"AnchorData field equal ({host.count_sp_r} spectrum hashes); "
            f"K10 launches {launches['minimizer_sketch']}: {H} haplotypes "
            f"{sum(ms[:H]):.3f} ms, the reads {sum(ms[H:]):.3f} ms (CUDA "
            "events)")

        # the drivers alone, beside the kernels' device time
        with self.launch_events("dg_sketch") as pairs:
            t0 = time.time()
            for h in d["haps"]:
                sketch_long_sequence_device(h, S_K, S_W, device=DEVICE)
            self.sync()
            t1 = time.time()
            sets = sketch_reads_device(d["seqs"], S_K, S_W, device=DEVICE)
            t2 = time.time()
        ms = [a.elapsed_time(b) for a, b in pairs]
        hap_s, reads_s = t1 - t0, t2 - t1
        dev_hap, dev_reads = sum(ms[:H]) / 1e3, sum(ms[H:]) / 1e3
        nwin = sum(len(h) - S_K - S_W + 2 for h in d["haps"])
        B, L = d["codes"].shape
        hb = bound(sum(map(len, d["haps"])) + 13 * nwin,
                   nwin * (4 * S_K + 2 * (S_W - 1) + 64))
        log(f"S2 drivers: haplotypes {hap_s:.3f}s of which K10 "
            f"{dev_hap * 1e3:.3f} ms (host share "
            f"{1 - dev_hap / hap_s:.4f}), reads {reads_s:.3f}s of which "
            f"K10 {dev_reads * 1e3:.3f} ms (host share "
            f"{1 - dev_reads / reads_s:.4f}); native sketcher "
            f"{d['nat_hap_s']:.3f}s / {d['nat_reads_s']:.3f}s; K10 bound "
            f"{hb[0]:.6g} ms for the haplotypes ({nwin} windows, {hb[1]}), "
            f"{self.bound['minimizer_sketch'][0]:.6g} ms for the reads "
            f"({sketch_reads_device.host_rows} rows by the host scanner)")
        check(len(sets) == len(d["seqs"]), "S2 read sets")
        d["sets"] = sets

    def phase_s3(self):
        """fit_histogram's torch backend (grid_tables and K12 on the card)
        against the numpy backend on S2's histogram at the pipeline's
        options; its device stages one by one, then the whole fit with its
        launches counted."""
        from dipgenie_tpu_torch.models.fitter import fit_histogram

        pairs, opt = s_histogram(self.s["host"])
        t0 = time.time()
        want = fit_histogram(pairs, opt)
        np_s = time.time() - t0
        fit_histogram(pairs, opt, backend="torch", device=DEVICE)  # warm
        stages = self.s3_stages(opt.max_copy)
        self.sync()
        self.reset_counts()
        t0 = time.time()
        got = fit_histogram(pairs, opt, backend="torch", device=DEVICE)
        self.sync()
        torch_s = time.time() - t0
        launches = self.launches["S3"] = self.counts()
        want_l = {**dict.fromkeys(KERNELS, 0), "grid_tables": 1,
                  "grid_nll": 1}
        check(launches == want_l, f"S3 launches {launches}, want {want_l}")
        check(got == want and got == self.s["host"].fit,
              f"S3 torch fit {got} differs from numpy {want}")
        log(f"S3 fit_histogram ({len(pairs)} bins, max_copy {opt.max_copy}):"
            f" torch backend {torch_s:.6f}s, numpy {np_s:.6f}s (host clock);"
            f" parameters and nll ({got.nll!r}) equal; launches grid_tables"
            f" 1, grid_nll 1; its device stages alone, CUDA events / host "
            f"clock after a synchronize (min of {S3_REPEATS}): {stages}")

    def s3_stages(self, copies):
        """grid_inputs (one copy of the axes, grid_tables), K12 and the
        readback of fit_histogram's torch backend (fitter._grid_nll_torch)
        one after the other on S3's grid, each bracketed by CUDA events
        and by the host clock after a synchronize; min of S3_REPEATS."""
        import numpy as np

        from dipgenie_tpu_torch.models.fitter import grid_inputs

        grid, xs, ys = s_grid(self.s["host"])
        names = ("grid_inputs", "grid_nll", "readback")
        fns = (lambda _: grid_inputs(*grid, copies, xs, ys, DEVICE),
               lambda ins: self.fns["grid_nll"][0](*ins),
               lambda out: out.cpu().numpy().astype(np.float64))
        best = {n: [float("inf")] * 2 for n in names}
        for _ in range(S3_REPEATS):
            x = None
            for name, fn in zip(names, fns):
                ev = self.events(2)
                self.sync()
                t0 = time.perf_counter()
                ev[0].record()
                x = fn(x)
                ev[1].record()
                self.sync()
                host_ms = (time.perf_counter() - t0) * 1e3
                b = best[name]
                b[:] = (min(b[0], ev[0].elapsed_time(ev[1])),
                        min(b[1], host_ms))
        return ", ".join(f"{n} {b[0]:.6g} / {b[1]:.6g} ms"
                         for n, b in best.items())

    def phase_s4(self):
        """F_RANKS gloo ranks on the card, mesh (n_dp = F_RANKS, n_tp = 1):
        the dp sketch-count step and the dp read sketch, then
        dryrun_multichip(F_RANKS); the one-rank step in this process is the
        counted run of K11."""
        import numpy as np

        from dipgenie_tpu_torch.parallel.mesh import sharded_sketch_count_step

        d = self.s
        pad = (-len(d["codes"])) % F_RANKS
        codes = np.concatenate(
            [d["codes"], np.zeros((pad, d["codes"].shape[1]), np.uint8)])
        lens = np.concatenate([d["lens"], np.zeros(pad, np.int32)])
        args = (codes, lens, d["thi"], d["tlo"], S_K, S_W)
        sharded_sketch_count_step(None, *args, device=DEVICE)  # warm
        self.sync()
        self.reset_counts()
        t0 = time.time()
        one = sharded_sketch_count_step(None, *args, device=DEVICE)
        self.sync()
        one_s = time.time() - t0
        launches = self.launches["S4"] = self.counts()
        want = {**dict.fromkeys(KERNELS, 0), "minimizer_sketch": 1,
                "sketch_count": 1}
        check(launches == want, f"S4 launches {launches}, want {want}")
        path = os.path.join(OUT_DIR, "phase_s_inputs.npz")
        np.savez(path, codes=codes, lens=lens, thi=d["thi"], tlo=d["tlo"])
        try:
            results = spawn_ranks("s4", {"kind": "sketch", "inputs": path,
                                         "reads": d["reads_fa"],
                                         "mesh": (F_RANKS, 1)})
        finally:
            os.remove(path)
        counts, per_read = (t.cpu().numpy() for t in one)
        flat = np.concatenate(d["sets"])
        sizes = np.asarray([len(x) for x in d["sets"]])
        for r, res in enumerate(results):
            check(np.array_equal(res["counts"], counts)
                  and np.array_equal(res["per_read"], per_read),
                  f"S4 rank {r}: the dp sketch count differs from one rank's")
            check(np.array_equal(res["flat"], flat)
                  and np.array_equal(res["sizes"], sizes),
                  f"S4 rank {r}: the dp read sketch differs from S2's sets")
            log(f"S4 rank {r} of {F_RANKS} (gloo, one card, mesh "
                f"({F_RANKS}, 1)): sketch count {res['count_s']:.3f}s (one "
                f"rank in this process {one_s:.3f}s), read sketch "
                f"{res['reads_s']:.3f}s, dryrun_multichip({F_RANKS}) "
                f"{res['dryrun_s']:.3f}s, launches {res['launches']}; "
                f"{int(counts.sum())} hits == one rank's, read sets == S2's")

    # ---------------- phase D ----------------
    def phase_d(self):
        from dipgenie_tpu_torch.utils.synth import pangenome

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        env["CXX"] = self.ref_cxx
        for n_bp, n_walks in PANGENOMES:
            tag = f"D {n_walks} walks:"
            work = os.path.join(REPO, "build", f"chip_smoke_e2e_{n_walks}")
            t0 = time.time()
            gfa, reads = pangenome(work, n_bp=n_bp, n_walks=n_walks, seed=SEED)
            log(f"{tag} synthetic pangenome of {n_bp} bp, reads from 2 "
                f"walks at 2x ({time.time() - t0:.1f}s)")
            runs = {}
            cmds = [("port", PORT_CLI),
                    ("native", ["-m", "dipgenie_tpu", "--dp-backend",
                                "native"])]
            if n_walks == 8:
                cmds.append(("port_sketch",
                             PORT_CLI + ["--sketch-backend", "device"]))
            for name, cmd in cmds:
                cwd = os.path.join(work, name)
                os.makedirs(cwd, exist_ok=True)
                t0 = time.time()
                p = subprocess.run(
                    [sys.executable, *cmd, "-p2", "-R18", "-g", gfa, "-r",
                     reads, "-o", "out.fa"],
                    cwd=cwd, env=env, capture_output=True, text=True,
                )
                with open(os.path.join(OUT_DIR, f"d{n_walks}_{name}.log"),
                          "w") as fh:
                    fh.write(p.stdout + "\n---- stderr ----\n" + p.stderr)
                check(p.returncode == 0, f"{tag} {name} CLI exited "
                      f"{p.returncode}: {p.stderr[-2000:]}")
                with open(os.path.join(cwd, "out.fa"), "rb") as fh:
                    runs[name] = (p.stdout, p.stderr, fh.read())
                log(f"{tag} {name} CLI {time.time() - t0:.1f}s")
            (po, pe, pf), (no, _, nf) = runs["port"], runs["native"]
            check(pf == nf, f"{tag} FASTA differs between the port and the "
                  "native tier")

            def lines(s):
                return [x for x in s.splitlines() if " took " not in x]

            check(lines(po) == lines(no), f"{tag} stdout differs")
            if "port_sketch" in runs:
                so, se, sf = runs["port_sketch"]
                check(sf == nf and lines(so) == lines(no), f"{tag} the "
                      "port's CLI with --sketch-backend device differs from "
                      "the native tier")
                line = [x for x in se.splitlines() if "device sketch on" in x]
                check(bool(line), f"{tag} device sketching not run")
                log(f"{tag} --sketch-backend device: FASTA byte-identical to "
                    "the native tier's; " + line[0].split("] ", 1)[1])
            plan_line = [x for x in pe.splitlines() if "pair plan ready" in x]
            launch_line = [x for x in pe.splitlines()
                           if "kernel launches" in x]
            check(bool(plan_line) and bool(launch_line),
                  f"{tag} torch tier not run")
            log(f"{tag} " + plan_line[0].split("] ", 1)[1])
            log(f"{tag} " + launch_line[0].split("] ", 1)[1])
            counts = {k: int(v) for k, v in (
                kv.split("=") for kv in
                launch_line[0].split("launches ", 1)[1].split())}
            m = re.search(r"(\d+) narrow and (\d+) wide runs \((\d+) "
                          r"window-split: .*?, (\d+) over \d+ windows; "
                          r"widest (\d+)", plan_line[0])
            n_narrow, n_wide, n_split, n_big, widest = (
                int(x) for x in m.groups())
            want = {"narrow_run": n_narrow, "wide_dense_run": n_wide - n_split,
                    "wide_split_run": n_split, "wide_step": 0,
                    "narrow_run_global": 0, "trace": 1}
            check(counts == want, f"{tag} launches {counts}, want {want}")
            if n_walks > 8:
                check(n_split > 0, f"{tag} no run of more than 18 windows")
                if self.d18 is None:
                    self.d18 = (gfa, reads, nf, n_narrow)
            if n_walks >= 24:
                check(n_big > 0, f"{tag} no run of more than 31 windows")
            peak = re.search(r"peak device memory (\d+) B", launch_line[0])
            log(f"{tag} widest run {widest} windows; K3 ran {n_split} runs "
                f"of more than 18 windows in {counts['wide_split_run']} "
                f"launches, {n_big} of them of more than 31 windows; peak "
                f"device memory {peak.group(1)} B")
            log(f"{tag} FASTA byte-identical ({len(pf)} B) and stdout "
                "identical apart from the timing line")


def s_histogram(anchors):
    """The multiplicity histogram of an anchor stage and the fitter's
    options, as solver/anchors.py:_classify forms them."""
    import numpy as np

    from dipgenie_tpu_torch.models.fitter import KGFitOptions

    uniq, freq = np.unique(anchors.multiplicity, return_counts=True)
    pairs = [(int(m), float(f)) for m, f in zip(uniq, freq) if m > 0]
    top = int(uniq.max())
    return pairs, KGFitOptions(max_copy=10, max_x_use=top, u_hi=float(top),
                               fit_error=True, fit_varw=True)


def s_grid(anchors):
    """``(grid, xs, ys)`` of fit_histogram on ``s_histogram(anchors)``: the
    eight axes (none frozen at these options) and the histogram's bins."""
    import numpy as np

    from dipgenie_tpu_torch.models.fitter import _linspace

    pairs, o = s_histogram(anchors)
    grid = (_linspace(o.u_lo, o.u_hi, o.grid_u),
            _linspace(o.sd_lo, o.sd_hi, o.grid_sd),
            _linspace(o.varw_lo, o.varw_hi, o.grid_varw),
            _linspace(o.zp_lo, o.zp_hi, o.grid_zp),
            _linspace(o.zp_lo, o.zp_hi, o.grid_zp),
            _linspace(o.pd_lo, o.pd_hi, o.grid_pd),
            _linspace(o.pe_lo, o.pe_hi, o.grid_pe),
            _linspace(o.s_lo, o.s_hi, o.grid_s))
    return (grid, np.asarray([m for m, _ in pairs], np.int64),
            np.asarray([f for _, f in pairs], np.float64))


def caps_read_bytes(name: str, ins) -> int:
    """Input bytes a capability check needs, each once: only what it reads
    of a slice, a picked row or selected blocks (each distinct block
    once); every input byte otherwise."""
    needs = {
        "dyn_slice_row_bcast": 4 + 256 * 4,  # A[0, 0] and the row
        "manual_dma_dynoff": 16 * 128 * 4,
        "strided_slice_lane": 16 * 19 * 4,
        "dma_strided_3d": 19 * 8 * 8 * 2,
        "dma_in_when": 8 * 128 * 4,
        "concat3d_ax0": 18 * 256 * 4,  # A[:18]
    }
    if name == "scalar_prefetch_grid":
        return ins[0].nbytes + len(set(ins[0].tolist())) * 8 * 128 * 4
    return needs.get(name, sum(a.nbytes for a in ins))


def u_launches(arrs, spans, with_sh: bool) -> int:
    """K13's (``with_sh`` False) or K15's launches over ``spans`` of a
    graph's transitions at R: the host cut's count on this card."""
    from dipgenie_tpu_torch.ops import fused
    from dipgenie_tpu_torch.ops.vertex_plan import plan_launches, plan_vertices

    desc = plan_vertices(*arrs).desc
    budget = fused.smem_budget(DEVICE)
    return sum(len(plan_launches(desc[t0:t1], R + 1, with_sh, budget))
               for t0, t1 in spans)


def u_spans(T: int):
    """K16's spans in the traceback's order: the last transition alone, a
    middle span, then the first span (which ends the walk)."""
    cuts = sorted({0, max(T // 3, 1), max(T - 1, 1), T})
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a][::-1]


def u_work(plan, n: int) -> dict:
    """(bytes, int32 operations) of K13-K16 on a fused plan's first ``n``
    transitions: each table word a transition needs read once (its slots,
    in-degrees and colour words; K14 its descriptor row, the code it reads,
    two slots and four colour words a word; K16 its two descriptor words
    and the packed word it reads), states in and out once, each code and
    packed word written once, each walker row written once; an add and a
    max per candidate and row it reaches (rows r >= wu + wv), and ten
    operations a colour word per candidate pair for its score."""
    import numpy as np

    desc = plan.desc[:n]
    R1 = plan.R + 1
    pred, deg = plan.vplan.pred, plan.vplan.deg
    cand = 0
    for d in desc:
        k2, P, po, do = int(d[1]), int(d[2]), int(d[4]), int(d[5])
        real = (np.arange(P)[None, :] < deg[do:do + k2, None]).reshape(-1)
        w1 = int((pred[po:po + k2 * P][real] & 1).sum())
        w0 = int(real.sum()) - w1
        rows = w0 * w0 * R1 + 2 * w0 * w1 * max(R1 - 1, 0) + w1 * w1 * max(
            R1 - 2, 0)
        cand += 2 * rows + 10 * int(d[3]) * (w0 + w1) ** 2
    k, k2 = desc[:, 0], desc[:, 1]
    W = desc[:, 3]
    tables = int((4 * k2 * desc[:, 2] + 4 * k2 + 8 * (k + k2) * W).sum())
    v_in, v_out = int((4 * R1 * k * k).sum()), int((4 * R1 * k2 * k2).sum())
    code = np.where(desc[:, 2] <= 256, 2, 4)
    codes = int((R1 * k2 * k2 * code).sum())
    return {
        "fused_forward": (tables + v_in + v_out + codes, cand),
        "fused_trace": (int((64 + code + 8 + 16 * W + 16).sum()),
                        int((6 + 4 * W).sum())),
        "chunk_step": (tables + 2 * v_in + 3 * v_out, cand),
        "chunk_trace": (n * (16 + 4 + 16), 6 * n),
    }


def share_work(plan, t: int, p0: int, p1: int, R1: int) -> tuple[int, int]:
    """(bytes, int32 operations) of K15's per-transition kernel on the
    destination pairs ``[p0, p1)`` of transition ``t`` (``u_work``'s
    count restricted to the pairs): the transition's tables, V and SH in
    once each, V', SH' and the words of the pairs out once; an add and a
    max per candidate and row it reaches, ten operations a colour word per
    candidate pair for its score."""
    import numpy as np

    k, k2, P, W, po, do = (int(x) for x in plan.desc[t, :6])
    deg = plan.deg[do:do + k2].astype(np.int64)
    pred = plan.pred[po:po + k2 * P].reshape(k2, P)
    w1 = ((pred & 1) * (np.arange(P)[None, :] < deg[:, None])).sum(1)
    w0 = deg - w1
    pairs = np.arange(p0, p1)
    i2, j2 = pairs // k2, pairs % k2
    rows = (w0[i2] * w0[j2] * R1 + (w0[i2] * w1[j2] + w1[i2] * w0[j2])
            * max(R1 - 1, 0) + w1[i2] * w1[j2] * max(R1 - 2, 0))
    ops = 2 * int(rows.sum()) + 10 * W * int((deg[i2] * deg[j2]).sum())
    tables = 4 * k2 * P + 4 * k2 + 8 * (k + k2) * W
    return tables + 2 * 4 * R1 * k * k + 3 * 4 * R1 * (p1 - p0), ops


def csr_prefix(arrs, n_levels: int):
    """The CSR arrays of a graph's levels ``0 .. n_levels - 1`` and one
    sink level after them: every vertex of the last kept level gets one
    edge of weight 0 to the sink, which has no colours."""
    import numpy as np

    level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_c, het_ptr, het_c = arrs
    nv = int(level_ptr[n_levels])
    last = int(level_ptr[n_levels - 1])
    ne = int(adj_ptr[last])
    lp = np.append(level_ptr[:n_levels + 1], nv + 1)
    ap = np.concatenate([adj_ptr[:last + 1],
                         ne + np.arange(1, nv - last + 1),
                         [ne + nv - last]]).astype(adj_ptr.dtype)
    av = np.concatenate([adj_v[:ne], np.full(nv - last, nv)]).astype(
        adj_v.dtype)
    aw = np.concatenate([adj_w[:ne], np.zeros(nv - last)]).astype(adj_w.dtype)
    hp = np.append(hom_ptr[:nv + 1], hom_ptr[nv])
    tp = np.append(het_ptr[:nv + 1], het_ptr[nv])
    return (lp, ap, av, aw, hp, hom_c[:int(hom_ptr[nv])], tp,
            het_c[:int(het_ptr[nv])])


@contextlib.contextmanager
def timed_chunked(torch):
    """While the block runs, ``chunked.DeviceDiploidDP`` (which the
    solver's entry builds) is a subclass whose forward and traceback are
    bracketed by CUDA events; yields the list of each run's forward and
    traceback seconds, its share and gather counters, what its cuts hold
    (run launches, wide transitions, this rank's non-empty shares, spans)
    and its widest wide transition."""
    import numpy as np

    from dipgenie_tpu_torch.ops import chunked

    base, runs = chunked.DeviceDiploidDP, []

    class Timed(base):
        def forward(self, dev):
            self.ev = [torch.cuda.Event(enable_timing=True)
                       for _ in range(3)]
            self.tp0 = [span_s(n) for n in TP_SPANS]
            self.ev[0].record()
            out = super().forward(dev)
            self.ev[1].record()
            return out

        def traceback(self, dev, ckpts):
            rows = super().traceback(dev, ckpts)
            self.ev[2].record()
            torch.cuda.synchronize()
            n = 1 if self.mesh is None else self.mesh.n_tp
            d = 0 if self.mesh is None else self.mesh.tp_rank
            cut = np.concatenate(self.cuts)
            wide = cut[cut[:, 2] == 0, 0]
            k2 = self.plan.desc[wide, 1]
            runs.append({
                "forward_s": self.ev[0].elapsed_time(self.ev[1]) / 1e3,
                "traceback_s": self.ev[1].elapsed_time(self.ev[2]) / 1e3,
                "stats": dict(self.stats),
                **{k: span_s(n) - s0 for k, n, s0 in
                   zip(("gather_s", "wait_s"), TP_SPANS, self.tp0)},
                "cuts": {"runs": int((cut[:, 2] > 0).sum()),
                         "wide": len(wide), "spans": len(self.spans),
                         "shares": sum(
                             p1 > p0 for p0, p1, _ in
                             (chunked.share_of(int(x) ** 2, n, d)
                              for x in k2))},
                "widest": int(wide[np.argmax(k2)]) if len(wide) else -1})
            return rows

    chunked.DeviceDiploidDP = Timed
    try:
        yield runs
    finally:
        chunked.DeviceDiploidDP = base


@contextlib.contextmanager
def fd2_to(path: str):
    """File descriptor 2 into ``path`` while the block runs."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w") as fh:
        os.dup2(fh.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)


def plan_prefix(plan, n_levels: int):
    """The whole runs of a PairPlan or a DevPlan that lie within its first
    ``n_levels`` levels, as a plan of its own."""
    import dataclasses

    segs = [s for s in plan.segments if s.t1 < n_levels]
    return dataclasses.replace(plan, L=segs[-1].t1 + 1, segments=segs)


def pg_file(tag: str) -> str:
    """A fresh file:// rendezvous of a gloo group (no TCP port)."""
    path = os.path.join(OUT_DIR, f"pg_{tag}")
    if os.path.exists(path):
        os.remove(path)
    return f"file://{path}"


def spawn_ranks(tag: str, job: dict) -> list:
    """Run ``job`` in F_RANKS ranks spawned on the card, in one gloo group;
    their results in rank order. A rank that fails raises here."""
    import pickle

    import torch.multiprocessing as mp

    init = pg_file(tag)
    out = os.path.join(OUT_DIR, f"rank_{tag}")
    mp.spawn(rank_main, args=(F_RANKS, job, init, out), nprocs=F_RANKS,
             join=True)
    results = []
    for r in range(F_RANKS):
        with open(f"{out}{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
        os.remove(f"{out}{r}.pkl")
    return results


def rank_main(rank: int, world: int, job: dict, init: str, out: str) -> None:
    """One spawned rank of phase F2, F3, F4 or S4 on the card (cuda:0)."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from dipgenie_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(*job.get("mesh", (1, world)))
        fn = {"dp": rank_dp, "pipeline": rank_pipeline,
              "sketch": rank_sketch, "chunked": rank_chunked}[job["kind"]]
        res = fn(torch, mesh, job, f"{out}{rank}")
        with open(f"{out}{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def rank_dp(torch, mesh, job, out):
    """F2: the tp DP on the pickled plan, timed."""
    import pickle

    from dipgenie_tpu_torch.ops import (
        narrow, trace, wide, wide_split, wide_step,
    )
    from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP, assemble
    from dipgenie_tpu_torch.ops.plan import plan_to_device

    t0 = time.time()
    with open(job["plan"], "rb") as fh:
        plan = pickle.load(fh)
    dplan = plan_to_device(plan, DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    ship_s = time.time() - t0
    wrappers = {"narrow_run": narrow.narrow_run,
                "wide_dense_run": wide.wide_dense_run,
                "wide_split_run": wide_split.wide_split_run,
                "trace": trace.trace, "wide_step": wide_step.wide_step}
    for w in wrappers.values():
        w.launches = 0
    merge0 = span_s("pair.tp_merge")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    ev[0].record()
    V, bps = PairDiploidDP(dplan, DEVICE, mesh=mesh).forward()
    ev[1].record()
    recs = trace.trace(dplan, bps)
    ev[2].record()
    torch.cuda.synchronize()
    return {"result": assemble(int(V[R, 0]), recs.cpu().numpy()),
            "ship_s": ship_s, "forward_s": ev[0].elapsed_time(ev[1]) / 1e3,
            "trace_s": ev[1].elapsed_time(ev[2]) / 1e3,
            "merge_s": span_s("pair.tp_merge") - merge0,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": {k: w.launches for k, w in wrappers.items()}}


def rank_pipeline(torch, mesh, job, out):
    """F3: the port's pipeline with the mesh; its log (stderr) and FASTA."""
    import io

    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig

    t0 = time.time()
    with open(f"{out}.log", "w") as fh:
        os.dup2(fh.fileno(), 2)  # the launch line goes to stderr
        Pipeline(job["gfa"], job["reads"], f"{out}.fa",
                 PipelineConfig(mesh=mesh)).run(out=io.StringIO())
        sys.stderr.flush()
    with open(f"{out}.log") as fh, open(f"{out}.fa", "rb") as fa:
        return {"log": fh.read(), "fasta": fa.read(),
                "seconds": time.time() - t0}


def rank_sketch(torch, mesh, job, out):
    """S4: the dp sketch-count step and the dp read sketch with the mesh,
    then dryrun_multichip over every rank."""
    import numpy as np

    from dipgenie_tpu_torch.entry import dryrun_multichip
    from dipgenie_tpu_torch.io.fastx import read_fastx
    from dipgenie_tpu_torch.ops import sketch
    from dipgenie_tpu_torch.parallel import mesh as pmesh

    d = np.load(job["inputs"])
    seqs = [q for _, q in read_fastx(job["reads"])]
    wrappers = {"minimizer_sketch": sketch.batch_minimizer,
                "sketch_count": pmesh.sketch_count}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    counts, per_read = pmesh.sharded_sketch_count_step(
        mesh, d["codes"], d["lens"], d["thi"], d["tlo"], S_K, S_W,
        device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.time()
    sets = sketch.sketch_reads_device(seqs, S_K, S_W, mesh=mesh,
                                      device=DEVICE)
    t2 = time.time()
    launches = {k: w.launches for k, w in wrappers.items()}
    dryrun_multichip(torch.distributed.get_world_size(), device=DEVICE)
    torch.cuda.synchronize()
    return {"counts": counts.cpu().numpy(), "per_read": per_read.cpu().numpy(),
            "flat": np.concatenate(sets),
            "sizes": np.asarray([len(x) for x in sets]),
            "count_s": t1 - t0, "reads_s": t2 - t1,
            "dryrun_s": time.time() - t2, "launches": launches}


def rank_chunked(torch, mesh, job, out):
    """F4b / F4c: the chunked tier over the mesh through the solver's
    entry, ``vertex_forward(..., "jax", mesh)`` or with ``job["auto"]``
    ``device_forward(..., "auto", mesh)``; its log (stderr), result,
    forward and traceback seconds, gathers, launches and peak memory."""
    import numpy as np

    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.solver.diploid import (
        device_forward, vertex_forward,
    )

    d = np.load(job["arrs"])
    arrs = tuple(d[k] for k in CSR_KEYS)
    wrappers = {"chunk_step": chunked.chunk_step,
                "chunk_share": chunked.chunk_share,
                "chunk_trace": chunked.chunk_trace}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with timed_chunked(torch) as runs, fd2_to(f"{out}.log"):
        if job.get("auto"):
            got = device_forward(arrs, R, "auto", DEVICE, mesh)
        else:
            got = vertex_forward(arrs, R, DEVICE, "jax", mesh)
    with open(f"{out}.log") as fh:
        text = fh.read()
    os.remove(f"{out}.log")
    return {"result": got, "log": text,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": {k: w.launches for k, w in wrappers.items()},
            **runs[-1]}


def build_all():
    """Phase A: the CUDA kernels, the port's native runtime and the JAX
    package's (for the reference CLI of phase D), built at once. Returns
    (kernel library path, nvcc log, the compiler that built the reference
    runtime)."""
    from dipgenie_tpu_torch import kernels, native

    out = {}

    def reference_runtime():
        # native/Makefile with the first compiler that links OpenMP: a
        # $CXX wrapper may lack libgomp.spec (native.py does the same)
        for cxx in native.compilers():
            p = subprocess.run(["make", "-s", "-C",
                                os.path.join(REPO, "native"), f"CXX={cxx}"],
                               capture_output=True, text=True)
            if p.returncode == 0:
                out["ref_cxx"] = cxx
                return
        out["ref_cxx"] = None

    def port_runtime():
        out["native"] = native.available()

    threads = [threading.Thread(target=f)
               for f in (reference_runtime, port_runtime)]
    for t in threads:
        t.start()
    path, nvcc_log = kernels.build()
    for t in threads:
        t.join()
    check(out["native"], "the port's native runtime did not build")
    check(out["ref_cxx"] is not None, "native/Makefile failed")
    return path, nvcc_log, out["ref_cxx"]


def add_caps_kernels() -> None:
    """The 30 capability checks of phase H into KERNELS and MAIN_PATH."""
    from dipgenie_tpu_torch.ops.caps import NAMES
    from dipgenie_tpu_torch.probes.caps_tables import CHECKS

    for src, names in CAPS_SOURCES.items():
        for name in names:
            script, line = CHECKS[name][:2]
            KERNELS[name] = (f"dipgenie_tpu_torch/csrc/{src}",
                             f"scripts/{script}.py:{line}")
            MAIN_PATH[name] = "H"
    check(sorted(NAMES) == sorted(n for v in CAPS_SOURCES.values()
                                  for n in v), "CAPS_SOURCES misses a check")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dipgenie_tpu_torch import kernels

    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    path, nvcc_log, ref_cxx = build_all()
    log(f"A kernels ({os.path.relpath(path, REPO)}), the port's native "
        f"runtime and native/libdgcore.so ({ref_cxx}) built in "
        f"{time.time() - t0:.1f}s")
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(nvcc_log)
    kernels.lib()
    add_caps_kernels()

    smoke = Smoke(torch, ref_cxx)
    smoke.smi = smi
    phases = (smoke.phase_b, smoke.phase_g, smoke.phase_h, smoke.phase_c,
              smoke.phase_u, smoke.phase_e, smoke.phase_f1, smoke.phase_f2,
              smoke.phase_s, smoke.phase_d, smoke.phase_f3, smoke.phase_f4)
    only = {a.upper() for a in sys.argv[1:]}
    for phase in phases:
        if only and phase.__name__.split("_")[1].upper() not in only:
            continue
        t0 = time.time()
        phase()
        torch.cuda.empty_cache()
        log(f"{phase.__name__} done in {time.time() - t0:.1f}s")

    result = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": smoke.launches[MAIN_PATH[name]][name],
         "max_abs_err": smoke.err[name], "ms": smoke.ms[name],
         "plain_ms": smoke.plain_ms[name], "bound_ms": smoke.bound[name][0],
         "bound_by": smoke.bound[name][1],
         "library_ms": smoke.library_ms.get(name)}
        for name, (src, rep) in KERNELS.items()
        # a run of some phases only (arguments) lists what it measured
        if not only or (name in smoke.ms
                        and MAIN_PATH[name] in smoke.launches)
    ]}
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
