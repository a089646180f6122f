"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; without an NVIDIA GPU every test skips. On the card run
``python -m pytest tests/test_torch_kernels_gpu.py -q``. Every output is
compared exactly, element by element (the kernels and the plain versions
also agree at unreachable states and stale lanes); the capability checks'
float products take small integers, so they are exact too.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch import kernels
from dipgenie_tpu_torch.models import fitter
from dipgenie_tpu_torch.ops import (
    caps, chain_edge, chain_floor, chain_pair, chain_ring, narrow, sketch,
    trace, wide, wide_split, wide_step,
)
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import (
    DENSE_NB_MAX, NEG, REACH_T, chunk_bounds, coop_grid, initial_v,
    plan_pairs, plan_to_device, shard_to_device, split_slices, wide_slices,
)
from dipgenie_tpu_torch.parallel import mesh as pmesh
from dipgenie_tpu_torch.probes import caps as probe_caps
from dipgenie_tpu_torch.probes import caps_tables, tables
from dipgenie_tpu_torch.sketch.minimizers import sketch_sequence
from dipgenie_tpu_torch.solver.diploid import csr_arrays, native_forward_csr
from dipgenie_tpu_torch.utils.synth import (
    CASES, GLOBAL_STATE_CASE, LIMIT_CASES, count_tables, dense_graph,
    edge_hashes, hand_graph, limit_case, mhc_shaped_csr, parallel_edges_graph,
    ragged_reads, random_leveled_csr, wide_window_graph,
)

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(__file__), "data")
NPZ = ["mhc_slice_csr", "mhc_slice500_csr", "mhc_slice_wide_csr"]
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w", "hom_ptr",
            "hom_colors", "het_ptr", "het_colors")


# the pairs of a slice K2 stages in shared memory, and the slots of one
# K3 / K4 stage (csrc/coop.cuh STAGE)
K2_STAGE = 2560
K3_STAGE = 2560
# each segment kind's kernel wrapper and plain version
RUNS = {"narrow": (narrow.narrow_run, narrow.narrow_run_ref),
        "wide": (wide.wide_dense_run, wide.wide_dense_run_ref),
        "wide_split": (wide_split.wide_split_run,
                       wide_split.wide_split_run_ref)}
# the CASES with wide levels, and a graph with big-window (NB 31) runs
WIDE = [c for c in CASES if 400 <= c[0] < 600] + ["mhc_slice_wide_csr",
                                                  "big_window"]


def case_csr(case):
    """(CSR arrays, R) of a CASES tuple, a tests/data npz name, or
    ``big_window`` (an MHC-shaped graph with two bands of widths
    141..177). This module imports nothing from the test tree, so it also
    collects where an installed package named ``tests`` shadows this
    directory."""
    if case == "big_window":
        return mhc_shaped_csr(L=300, seed=2, n_bands=2, wmin=141,
                              wmax=177), 18
    if isinstance(case, str):
        d = np.load(f"{DATA}/{case}.npz")
        return [d[k] for k in CSR_KEYS], int(d["R"])
    seed, L, kmax, R, nc = case
    return random_leveled_csr(seed, L, kmax, nc), R


def _run_checked(dplan, device):
    """Forward and traceback with every kernel call held against its
    plain version: (V, recs)."""
    V, bps = initial_v(dplan.R, device), []
    for seg in dplan.segments:
        kern, plain = RUNS[seg.kind]
        got, want = kern(seg, V), plain(seg, V)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (seg.kind, seg.t0)
        V, bps = got[0], bps + [got[1:]]
    recs = trace.trace(dplan, bps)
    assert torch.equal(recs, trace.trace_ref(dplan, bps))
    return V, recs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES + NPZ)
def test_kernels_match_plain_versions(case, cuda):
    arrs, R = case_csr(case)
    _run_checked(plan_to_device(plan_pairs(*arrs, R), cuda), cuda)


@pytest.mark.parametrize("case", CASES + [GLOBAL_STATE_CASE])
def test_narrow_global_state_path_matches_plain_version(case, cuda):
    """K1 with V in global memory (``narrow_run_global``) on every narrow
    run of every CASES entry, against the plain version; on
    GLOBAL_STATE_CASE, whose V does not fit shared memory, ``narrow_run``
    itself takes that path (its launch counter moves, the shared path's
    does not) and the DP equals the native tier."""
    arrs, R = case_csr(case)
    plan = plan_pairs(*arrs, R)
    dplan = plan_to_device(plan, cuda)
    V = initial_v(R, cuda)
    for seg in dplan.segments:
        kern = RUNS[seg.kind][0]
        if seg.kind == "narrow":
            kern = narrow.narrow_run_global
        got, want = kern(seg, V), RUNS[seg.kind][1](seg, V)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (seg.kind, seg.t0)
        V = got[0]
    if case == GLOBAL_STATE_CASE:
        for r1, lanes in ((19, 1024), (61, 1024), (19, 256)):
            for shared_v in (False, True):
                assert kernels.lib().dg_narrow_smem_bytes(
                    r1, lanes, shared_v) == narrow.smem_bytes(
                        r1, lanes, shared_v)
        assert not all(narrow.state_in_shared(s, R + 1)
                       for s in dplan.segments if s.kind == "narrow")
        shared, glob = narrow.narrow_run.launches, \
            narrow.narrow_run_global.launches
        _run_checked(dplan, cuda)
        assert narrow.narrow_run_global.launches > glob
        assert PairDiploidDP(dplan, cuda).run() == native_forward_csr(arrs, R)
        assert narrow.narrow_run.launches == shared + sum(
            narrow.state_in_shared(s, R + 1) for s in dplan.segments
            if s.kind == "narrow") * 2


@pytest.mark.parametrize("case", WIDE)
def test_wide_split_kernel_matches_plain_version_and_k2(case, cuda):
    """K3 on every wide run (``dense_nb_max=0``) against its plain version;
    its V and traceback records against K2's on the same runs (their
    backpointers number pairs differently), and the DP against the native
    tier."""
    arrs, R = case_csr(case)
    plan = plan_pairs(*arrs, R)
    v3, r3 = _run_checked(plan_to_device(plan, cuda, dense_nb_max=0), cuda)
    v2, r2 = _run_checked(plan_to_device(plan, cuda, dense_nb_max=31), cuda)
    assert torch.equal(v3, v2) and torch.equal(r3, r2)
    if case == "big_window":
        dplan = plan_to_device(plan, cuda)
        assert {s.kind for s in dplan.segments} == {"narrow", "wide_split"}
        assert PairDiploidDP(dplan, cuda).run() == native_forward_csr(arrs, R)


@pytest.mark.parametrize("name", NPZ)
def test_cuda_dp_matches_mhc_slice_oracle(name, cuda):
    arrs, R = case_csr(name)
    d = np.load(f"{DATA}/{name}.npz")
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    assert PairDiploidDP(plan_pairs(*arrs, R), cuda).run() == want


def test_wrappers_reject_bad_inputs(cuda):
    arrs, R = case_csr("mhc_slice_wide_csr")
    plan = plan_pairs(*arrs, R)
    dplan = plan_to_device(plan, cuda)
    seg_n = next(s for s in dplan.segments if s.kind == "narrow")
    i_w = next(i for i, s in enumerate(dplan.segments) if s.kind == "wide")
    seg_w = dplan.segments[i_w]
    seg_s = plan_to_device(plan, cuda, dense_nb_max=0).segments[i_w]
    v = initial_v(R, cuda)
    with pytest.raises(ValueError, match="dtype"):
        narrow.narrow_run(seg_n, v.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        wide.wide_dense_run(seg_w, v[:, :512].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        narrow.narrow_run(seg_n, v.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        wide_split.wide_split_run(seg_s, v[:, :512].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        wide_split.wide_split_run(seg_s, v.to(torch.int16))


def _with_grid(dseg, grid, buffers=2):
    """Re-slice a K3 segment (or, ``buffers`` 1, a tp share) for a grid of
    ``grid`` blocks, as a card with fewer SMs gets it; returns the most
    slots of one slice."""
    h = dseg.host
    if dseg.kind == "wide_tp":
        tbl, win = dseg.t["stbl"], dseg.t["swin"]
        bounds = dseg.bounds
    else:
        tbl, win = dseg.t["tbl"], dseg.t["wwin"]
        bounds = chunk_bounds(h.tb_chunkbase, dseg.nreal)
    dseg.k3_cuts, split, m = split_slices(tbl, win, bounds,
                                          wide_split.ext_windows(h),
                                          h.NB * 1024, grid, buffers)
    dseg.k3_desc[:, 3] = torch.from_numpy(split)
    dseg.k3_grid, dseg.k3_per_block = grid, m
    return int(torch.diff(dseg.k3_cuts[:, :, 1], dim=1).max())


@pytest.mark.parametrize("grid", [8, 2])
def test_wide_split_kernel_on_a_smaller_grid(grid, cuda):
    """K3 on grids smaller than the card's: 4 (grid 8) or 16 (grid 2)
    slices a block at NB 31, on E-shaped bands, the second of whose band
    ends holds a 3,800-pair destination in one slice; the lane cap leaves
    slices of up to ~22k slots (read from the table, candidates a row or
    two a pass). Bit-equal to the plain version from the DP's own input
    states; K4 on one rank's share the same way."""
    plan = plan_pairs(*case_csr("big_window")[0], 18)
    dplan = plan_to_device(plan, cuda, dense_nb_max=0)
    V, ran, most = initial_v(18, cuda), 0, 0
    for h, seg in zip(plan.segments, dplan.segments):
        if seg.kind == "wide_split":
            most = max(most, _with_grid(seg, grid))
            assert seg.k3_per_block > 1
            got = wide_split.wide_split_run(seg, V)
            for g, w in zip(got, wide_split.wide_split_run_ref(seg, V)):
                assert torch.equal(g, w), (grid, seg.t0)
            share = shard_to_device(h, 1, 0, cuda)
            _with_grid(share, grid, 1)
            W = wide_split._state(share, V)
            for ti in range(h.t1 - h.t0):
                part = wide_step.wide_step(share, ti, W)
                assert torch.equal(part, wide_step.wide_step_ref(share, ti, W))
                bp = torch.empty_like(W)
                W = wide_step.commit(part, share.t["present"][ti], bp)
            assert torch.equal(W[:, :1024], got[0])
            ran += 1
        V = RUNS[seg.kind][0](seg, V)[0]
    assert ran >= 2 and most > 20000 > K3_STAGE


@pytest.mark.parametrize("width", [194, 214])
def test_wide_split_kernel_past_31_windows(width, cuda):
    """K3 on runs of 37 and 45 windows (widths 194 and 214), as phase D's
    24-walk pangenome has them, and K4 on their tp shares for n_tp 1-3:
    each call against its plain version, the DP against the native
    tier. Their band ends put 37,636 and 45,796 pairs on one destination,
    more than half of what a slice holds (214: more than all of it), so
    that destination is cut over slices and combined."""
    g, chb = wide_window_graph(width)
    arrs = csr_arrays(g, chb)
    plan = plan_pairs(*arrs, 2)
    dplan = plan_to_device(plan, cuda)
    nbs = [s.host.NB for s in dplan.segments if s.kind == "wide_split"]
    assert nbs == [{194: 37, 214: 45}[width]]
    assert all(bool(s.k3_desc[-1, 3]) for s in dplan.segments
               if s.kind == "wide_split")
    _run_checked(dplan, cuda)
    V = initial_v(2, cuda)
    for seg, dseg in zip(plan.segments, dplan.segments):
        out = RUNS[dseg.kind][0](dseg, V)[0]
        if dseg.kind == "wide_split":
            for n_tp in (1, 2, 3):
                assert torch.equal(_tp_run_checked(seg, n_tp, V, cuda), out)
        V = out
    assert PairDiploidDP(dplan, cuda).run() == native_forward_csr(arrs, 2)


def test_wide_split_refused_launch_raises(cuda):
    """A grid the card cannot hold at once is refused, and the wrappers
    raise: K3 and K4 have no fallback. The run and a tp share are sliced
    for one block more than the card holds."""
    plan = plan_pairs(*case_csr("big_window")[0], 18)
    dplan = plan_to_device(plan, cuda)
    i, seg = next((i, s) for i, s in enumerate(dplan.segments)
                  if s.kind == "wide_split")
    held = coop_grid("wide_split", cuda)
    assert seg.k3_grid == held > 0
    share = shard_to_device(plan.segments[i], 1, 0, cuda)
    _with_grid(seg, held + 1)
    _with_grid(share, held + 1, 1)
    v = initial_v(18, cuda)
    before = wide_split.wide_split_run.launches, wide_step.wide_step.launches
    with pytest.raises(RuntimeError, match="wide_split_run"):
        wide_split.wide_split_run(seg, v)
    with pytest.raises(RuntimeError, match="wide_step"):
        wide_step.wide_step(share, 0, wide_split._state(share, v))
    assert (wide_split.wide_split_run.launches,
            wide_step.wide_step.launches) == before


def _tp_run_checked(seg, n_tp, v_in, device):
    """A wide run through K4 on every rank's shard in turn, each partial
    held against ``wide_step_ref``, merged as the ranks' all_reduce(MAX)
    would be: the run's output state."""
    segs = [shard_to_device(seg, n_tp, d, device) for d in range(n_tp)]
    V = wide_split._state(segs[0], v_in)
    bp = torch.empty((1, *V.shape), dtype=torch.int32, device=device)
    for ti in range(seg.t1 - seg.t0):
        parts = []
        for s in segs:
            got = wide_step.wide_step(s, ti, V)
            assert torch.equal(got, wide_step.wide_step_ref(s, ti, V))
            parts.append(got)
        merged = torch.stack(parts).amax(dim=0)
        V = wide_step.commit(merged, segs[0].t["present"][ti], bp[0])
    return V[:, :1024]


@pytest.mark.parametrize("case", WIDE)
def test_wide_step_kernel_matches_plain_version(case, cuda):
    """K4 on every (transition, rank) shard of every wide run for n_tp 1-3
    against its plain version, from the single-device path's states; the
    merged partials give K3's output state."""
    arrs, R = case_csr(case)
    plan = plan_pairs(*arrs, R)
    dplan = plan_to_device(plan, cuda, dense_nb_max=0)
    V, n_wide = initial_v(R, cuda), 0
    for seg, dseg in zip(plan.segments, dplan.segments):
        out = RUNS[dseg.kind][0](dseg, V)[0]
        if dseg.kind == "wide_split":
            n_wide += 1
            for n_tp in (1, 2, 3):
                assert torch.equal(_tp_run_checked(seg, n_tp, V, cuda), out)
        V = out
    assert n_wide


def test_tp_dp_one_rank_mesh_matches_native_tier(cuda, tmp_path):
    """The tp path on the card in a one-rank gloo mesh: every wide run
    through K4 and the merge, the traceback over the merged backpointers."""
    import torch.distributed as dist

    from dipgenie_tpu_torch.parallel.mesh import make_mesh

    arrs, R = case_csr("big_window")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        before = wide_step.wide_step.launches
        got = PairDiploidDP(plan_pairs(*arrs, R), cuda,
                            mesh=make_mesh(n_tp=1)).run()
        assert wide_step.wide_step.launches > before
    finally:
        dist.destroy_process_group()
    assert got == native_forward_csr(arrs, R)


@pytest.mark.parametrize("case", LIMIT_CASES)
def test_kernels_past_the_tpu_limits(case, cuda):
    """The graphs past the TPU planner's limits (tests/test_torch_limits.py)
    on the card: K1 and K2 at R + 1 up to 41, K3 at NB 32 and 36, values
    past 4,100,000; every call against its plain version on both routings,
    K4 on every rank's shard of each K3 run for n_tp 1-3, and the DP on the
    main path against the native tier."""
    g, chb, R = limit_case(case)
    arrs = csr_arrays(g, chb)
    plan = plan_pairs(*arrs, R)
    want = native_forward_csr(arrs, R)
    for nb_max in (DENSE_NB_MAX, 0):
        _run_checked(plan_to_device(plan, cuda, nb_max), cuda)
    dplan = plan_to_device(plan, cuda, dense_nb_max=0)
    V = initial_v(R, cuda)
    for seg, dseg in zip(plan.segments, dplan.segments):
        out = RUNS[dseg.kind][0](dseg, V)[0]
        if dseg.kind == "wide_split":
            for n_tp in (1, 2, 3):
                assert torch.equal(_tp_run_checked(seg, n_tp, V, cuda), out)
        V = out
    assert PairDiploidDP(plan, cuda).run() == want


def _k2_case(name):
    """(CSR arrays, R) of K2's edge cases: a destination-window hole and a
    shrinking extent (tests/test_pallas_dp.py:187, :158), the lane-0 pad
    tail of ROADMAP.md Queue 3 item 2 (``[1, 40, 1]``), 2,304 pairs into
    one destination (``[1, 48, 1]``: a slice K2 stages) and 2,704
    (``[1, 52, 1]``: more than K2_STAGE, read from the table), a colourless
    level of ties, and runs of 2, 5, 18 and 31 windows."""
    if name == "hole_window":
        W = 56
        keep = list(range(18)) + list(range(37, W))
        g = hand_graph([1, W, W, 1], [[(0, i, 0) for i in range(W)],
                                      [(i, i, 0) for i in keep],
                                      [(i, 0, 0) for i in range(W)]],
                       {1 + 5: [0], 1 + W + 5: [0]})
        return csr_arrays(g, [True]), 0
    if name == "stale_window":
        W = 40
        starts = np.cumsum([0, 1, W, W, W])
        g = hand_graph([1, W, W, W, 1], [
            [(0, i, 0) for i in range(W)], [(i, i, 0) for i in range(25)],
            [(i, i, 0) for i in range(W)], [(i, 0, 0) for i in range(W)]],
            {int(starts[2] + 30): [0], int(starts[3] + 30): [0]})
        return csr_arrays(g, [True]), 0
    if name in ("pad_tail", "range2304", "range2704"):
        W = {"pad_tail": 40, "range2304": 48, "range2704": 52}[name]
        g = hand_graph([1, W, 1], [[(0, i, 0) for i in range(W)],
                                   [(i, 0, 0) for i in range(W)]],
                       {v: [0] for v in [0, 1 + W] + list(range(1, W))})
        return csr_arrays(g, [False]), 0
    if name == "ties":
        W = 40
        g = hand_graph([1, W, W, 1], [
            [(0, i, 0) for i in range(W)],
            [(i, j, 0) for i in range(W) for j in range(W)],
            [(i, 0, 0) for i in range(W)]])
        return csr_arrays(g, [False]), 2
    width = {"nb2": 40, "nb5": 64, "nb18": 96, "nb31": 140}[name]
    rng = np.random.default_rng(11)
    g = dense_graph(rng, [1, width, width, 1], deg=2, pw=0.2)
    return csr_arrays(g, [bool(x) for x in rng.random(6) < 0.5]), 2


def _reach_t_commits(seg, v):
    """Destination lanes of the run's first transition whose best valid
    candidate has the value REACH_T (committed NEG, ordinal kept)."""
    from dipgenie_tpu_torch.ops.narrow import transition_keys
    from dipgenie_tpu_torch.ops.plan import PAD_SC, chunk_bounds, decode_keys

    h = seg.host
    c0, c1 = chunk_bounds(h.tb2_chunkbase, seg.nreal)[:2]
    words = seg.t["dtbl"][int(c0):int(c1)]
    real = words[:, 1].reshape(-1) != PAD_SC
    packed = words[:, 0].reshape(-1)[real]
    keys = transition_keys(v, (packed >> 17) & 32767, packed & 3,
                           words[:, 1].reshape(-1)[real],
                           (packed >> 2) & 32767,
                           torch.nonzero(real).reshape(-1), h.NB * 1024)
    return int(((keys != 0) & (decode_keys(keys)[0] == NEG)).sum())


@pytest.mark.parametrize("name", ["hole_window", "stale_window", "pad_tail",
                                  "range2304", "range2704", "ties", "nb2",
                                  "nb5", "nb18", "nb31"])
def test_wide_dense_kernel_edge_cases(name, cuda):
    """K2 (one cooperative launch a run) against its plain version, bit
    for bit, on every wide run from the DP's own input state and from two
    drawn states (values around REACH_T, NEG and small scores: ties
    everywhere, and lanes whose winner commits NEG at the value REACH_T
    and keeps its ordinal); then the DP against the native tier."""
    arrs, R = _k2_case(name)
    plan = plan_pairs(*arrs, R)
    dplan = plan_to_device(plan, cuda, dense_nb_max=31)
    wides = [s for s in dplan.segments if s.kind == "wide"]
    assert wides and {s.host.NB for s in wides} <= {2, 5, 18, 31}
    if name.startswith("nb"):
        assert max(s.host.NB for s in wides) == int(name[2:])
    rng = np.random.default_rng(5)
    draws = [(NEG, REACH_T - 1, REACH_T, REACH_T + 1, 0, 1, 2),
             (NEG, REACH_T - 1, REACH_T)]
    V, at_reach_t = initial_v(R, cuda), 0
    for seg in dplan.segments:
        kern, plain = RUNS[seg.kind]
        ins = [V]
        if seg.kind == "wide":
            ins += [torch.from_numpy(rng.choice(d, size=(R + 1, 1024))
                                     .astype(np.int32)).to(cuda)
                    for d in draws]
            at_reach_t += _reach_t_commits(seg, ins[-1])
        for v in ins:
            before = kern.launches
            got, want = kern(seg, v), plain(seg, v)
            assert kern.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, seg.kind, seg.t0)
        V = kern(seg, V)[0]
    if name == "ties":
        assert at_reach_t > 0
    if name.startswith("range"):
        most = _largest_slice(wides[0])
        assert most >= 2000 and (most > K2_STAGE) == (name == "range2704")
    assert PairDiploidDP(dplan, cuda).run() == native_forward_csr(arrs, R)


def _largest_slice(seg):
    """The most pairs of one of K2's slices in a dense wide run."""
    desc = seg.k2_desc.cpu().numpy()
    cuts = seg.k2_cuts.cpu().numpy().astype(np.int64)
    most = 0
    for ti, (c0, n) in enumerate(desc):
        words = seg.host.dtbl[c0:c0 + -(-n // 256), 0].ravel()[:n]
        most = max(most, int(np.diff(np.searchsorted((words >> 2) & 32767,
                                                     cuts[ti])).max()))
    return most


@pytest.mark.parametrize("grid", [8, 2])
def test_wide_dense_kernel_on_a_smaller_grid(grid, cuda):
    """K2 on grids smaller than the card's, as a card with fewer SMs gets
    them: 3 (grid 8) or 9 (grid 2) slices a block at NB 18 and 4 or 16 at
    NB 31, on runs of 13 transitions, so that a block searches its ranges
    again every 9 or 7 (grid 8), 2 or 1 (grid 2) transitions. Bit-equal to
    the plain version from the DP's own input states."""
    for plan in (plan_pairs(*mhc_shaped_csr(L=800, seed=10, n_bands=2), 18),
                 plan_pairs(*case_csr("big_window")[0], 18)):
        dplan = plan_to_device(plan, cuda, dense_nb_max=31)
        V = initial_v(18, cuda)
        ran = 0
        for seg in dplan.segments:
            if seg.kind == "wide":
                desc, cuts, m = wide_slices(seg.host, seg.nreal, grid)
                assert m > 1
                seg.k2_desc = torch.from_numpy(desc).to(cuda)
                seg.k2_cuts = torch.from_numpy(cuts).to(cuda)
                seg.k2_grid, seg.k2_per_block = grid, m
                got, want = wide.wide_dense_run(seg, V), \
                    wide.wide_dense_run_ref(seg, V)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (grid, seg.t0)
                ran += 1
            V = RUNS[seg.kind][0](seg, V)[0]
        assert ran >= 2


def test_wide_dense_refused_launch_raises(cuda):
    """A grid the card cannot hold at once is refused, and the wrapper's
    check raises: K2 has no fallback."""
    arrs, R = _k2_case("nb2")
    dplan = plan_to_device(plan_pairs(*arrs, R), cuda)
    seg = next(s for s in dplan.segments if s.kind == "wide")
    h, T = seg.host, seg.t1 - seg.t0
    assert seg.k2_grid == coop_grid("wide_dense", cuda) > 0
    assert seg.k2_cuts.is_cuda and seg.k2_desc.is_cuda
    V = torch.empty((2, R + 1, h.NB * 1024), dtype=torch.int32, device=cuda)
    bp = torch.zeros((T, R + 1, h.NB * 1024), dtype=torch.int32, device=cuda)
    v = initial_v(R, cuda)
    grid = 1 << 16  # far more blocks than fit on any card at once
    cuts = torch.zeros((T, grid + 1), dtype=torch.int16, device=cuda)
    rc = kernels.lib().dg_wide_dense_run(
        seg.t["dtbl"].data_ptr(), seg.k2_desc.data_ptr(),
        cuts.data_ptr(), T, R + 1, h.NB, grid, 1, v.data_ptr(),
        V.data_ptr(), bp.data_ptr(), kernels.stream_of(v))
    assert rc != 0
    with pytest.raises(RuntimeError, match="wide_dense_run"):
        kernels.raise_on_error(rc, "wide_dense_run")


def _trace_case(name):
    """(plan on the card, backpointers' plan) of K-T's cases: the walks
    cross narrow 256- and 1024-class blocks, dense wide blocks (kept in L2),
    window-split blocks (K3's routing and the big-window graph), and R = 60
    (GLOBAL_STATE_CASE: its 1024-class blocks' rows fill a slot, so their
    tables take the L2 path)."""
    if name == "bands":
        return plan_pairs(*mhc_shaped_csr(L=800, seed=10, n_bands=2), 18), 18
    if name == "bands_split":
        return plan_pairs(*mhc_shaped_csr(L=800, seed=10, n_bands=2), 18), 0
    arrs, R = case_csr({"global_state": GLOBAL_STATE_CASE}.get(name, name))
    return plan_pairs(*arrs, R), 18


@pytest.mark.parametrize("bps_kind", ["forward", "zero", "random"])
@pytest.mark.parametrize("name", ["bands", "bands_split", "big_window",
                                  "global_state", "mhc_slice_wide_csr"])
def test_trace_kernel_matches_plain_version(name, bps_kind, cuda):
    """K-T (one launch) against ``trace_ref``, on the forward pass's
    backpointers, on zeroed ones (every state
    unreachable: the walk takes pair 0 each time) and on drawn ordinals
    below 256 (the walk's r falls below 0 and is read as row 0)."""
    plan, nb_max = _trace_case(name)
    dplan = plan_to_device(plan, cuda, dense_nb_max=nb_max)
    bps = PairDiploidDP(dplan, cuda).forward()[1]
    if bps_kind == "zero":
        bps = [tuple(torch.zeros_like(b) for b in blocks) for blocks in bps]
    elif bps_kind == "random":
        gen = torch.Generator(device=cuda).manual_seed(3)
        bps = [tuple(torch.randint(0, 256, b.shape, generator=gen,
                                   device=cuda, dtype=b.dtype)
                     for b in blocks) for blocks in bps]
    want = trace.trace_ref(dplan, bps)
    if bps_kind == "random" and name.startswith("bands"):
        assert (want[:, 4] + want[:, 5]).sum() > dplan.R  # r went below 0
    before = trace.trace.launches
    got = trace.trace(dplan, bps)
    assert trace.trace.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


# the level-chain kernels: (wrapper, plain version, tables of a chain)
CHAIN_KERNELS = {
    "chain_floor": (chain_floor.chain_floor, chain_floor.chain_floor_ref,
                    lambda T, seed, cover: (tables.floor_tables(T, seed),)),
    "chain_step16": (chain_floor.chain_step16, chain_floor.chain_step16_ref,
                     lambda T, seed, cover: tables.step16_tables(
                         T, seed, tie_bits=True)),
    "chain_pair": (chain_pair.chain_pair, chain_pair.chain_pair_ref,
                   lambda T, seed, cover: tables.pair_tables(
                       T, seed, cover)[:1]),
    "chain_edge": (chain_edge.chain_edge, chain_edge.chain_edge_ref,
                   lambda T, seed, cover: tables.edge_tables(
                       T, seed, cover)[:5]),
}


# chain lengths around the ring of K5b's and K7's tables: one level, a
# ring less one, a ring, a ring and one, two rings and three
D = chain_ring.RING_DEPTH
RING_LENGTHS = (1, D - 1, D, D + 1, 2 * D + 3)


@pytest.mark.parametrize("T,seed,cover", [
    (200, 0, 16), (40, 29, 9), (6, 35, 16), (0, 0, 16),
    *[(T, 29, 9) for T in RING_LENGTHS], *[(T, 35, 16) for T in RING_LENGTHS],
])
@pytest.mark.parametrize("name", list(CHAIN_KERNELS))
def test_chain_kernel_matches_plain_version(name, T, seed, cover, cuda):
    """K5a, K5b, K6 and K7 against their plain versions: every element of
    the backpointers and of the final state, on the probes' own chain, on
    chains whose states are alive at the end (several edges into one
    destination, destinations with none), on an empty chain, and at the
    lengths around the table ring's wrap."""
    kern, plain, make = CHAIN_KERNELS[name]
    args = [torch.from_numpy(a).to(cuda) for a in make(T, seed, cover)]
    before = kern.launches
    got, want = kern(*args), plain(*args)
    assert kern.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("T,seed,cover", [
    (40, 29, 9), *[(T, 29, 9) for T in RING_LENGTHS],
    *[(T, 35, 16) for T in RING_LENGTHS],
])
def test_chain_pair_and_edge_match_the_oracle(T, seed, cover, cuda):
    """K6 and K7 equal the numpy oracle, and so each other, at 40 levels
    and at the lengths around the table ring's wrap."""
    tbl, hostE = tables.pair_tables(T, seed, cover)
    *tabs, _ = tables.edge_tables(T, seed, cover)
    want = tables.committed(tables.chain_oracle(hostE))
    assert (want > tables.NEG).sum() > (500 if T == 40 else 50)
    v6 = chain_pair.chain_pair(torch.from_numpy(tbl).to(cuda))[1]
    v7 = chain_edge.chain_edge(
        *(torch.from_numpy(a).to(cuda) for a in tabs))[1]
    assert np.array_equal(v6.cpu().numpy().reshape(want.shape), want)
    assert np.array_equal(v7.cpu().numpy(), want)


@pytest.mark.parametrize("T", [120, 4 * D - 1, 4 * D, 4 * D + 1, 4 * D + 3])
@pytest.mark.parametrize("which", ["pair", "edge"])
def test_chain_kernels_on_the_chain_that_stays_alive(which, T, cuda):
    """K6 and K7 on ``tables.LIVE`` (every state reachable from level 24
    on), every element against the plain version, also at lengths around
    the wrap of K7's table ring; K6's padding rows come back zero from the
    kernel, and K7 with its twins checked beforehand gives the same."""
    if which == "pair":
        args = [torch.from_numpy(tables.pair_tables(T, **tables.LIVE)[0])
                .to(cuda)]
        got, want = chain_pair.chain_pair(*args), \
            chain_pair.chain_pair_ref(*args)
        assert not got[0][:, 19:].any()
    else:
        args = [torch.from_numpy(a).to(cuda)
                for a in tables.edge_tables(T, **tables.LIVE)[:5]]
        chain_edge.check_twins(*args[:4])
        got, want = chain_edge.chain_edge(*args, twins_checked=True), \
            chain_edge.chain_edge_ref(*args)
    assert bool((got[1] > tables.NEG).all())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_chain_wrappers_reject_bad_inputs(cuda):
    tbl = torch.from_numpy(tables.pair_tables(4)[0]).to(cuda)
    with pytest.raises(ValueError, match="int32"):
        chain_pair.chain_pair(tbl.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        chain_pair.chain_pair(tbl[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        chain_floor.chain_floor(tbl[:, :, :128])
    tabs = [torch.from_numpy(a).to(cuda) for a in tables.edge_tables(4)[:5]]
    tabs[1] = tabs[1].clone()
    tabs[1][0, 0, 0] += 1
    with pytest.raises(ValueError, match="transposes"):
        chain_edge.chain_edge(*tabs)
    # a table 4 bytes past a 16-byte boundary: the bulk copies refuse it
    tabs = [torch.from_numpy(a).to(cuda) for a in tables.edge_tables(4)[:5]]
    for i, name in ((0, "tblc"), (2, "tbl2c"), (4, "S")):
        bad = list(tabs)
        bad[i] = _misaligned(tabs[i])
        with pytest.raises(ValueError, match=f"{name}: .*aligned"):
            chain_edge.chain_edge(*bad)
    step = [torch.from_numpy(a).to(cuda) for a in tables.step16_tables(4)]
    for i, name in enumerate(("pit", "pwt", "C")):
        bad = list(step)
        bad[i] = _misaligned(step[i])
        with pytest.raises(ValueError, match=f"{name}: .*aligned"):
            chain_floor.chain_step16(*bad)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    k = next(k for k in range(4) if (flat[k:].data_ptr() % 16) == 4)
    out = flat[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("T", [1, D - 1, D, D + 1, 2 * D + 3, 60])
def test_chain_step16_guards_sources_outside_the_block(T, cuda):
    """K5b with corner entries of ``pit`` outside ``[0, 16)`` (negative and
    past the block; weights on them too): the kernel guards them and
    equals its plain version on every element."""
    pit, pwt, C = tables.step16_tables(T, seed=5, tie_bits=True)
    rng = np.random.default_rng(T)
    bad = rng.random(pit[:, :4, :16].shape) < 0.2
    pit[:, :4, :16] = np.where(
        bad, rng.choice([-1, 16, 17, -(2**31), 2**31 - 1], bad.shape),
        pit[:, :4, :16])
    pwt[:, :4, :16] = (rng.random(bad.shape) < 0.3).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (pit, pwt, C)]
    got, want = chain_floor.chain_step16(*args), \
        chain_floor.chain_step16_ref(*args)
    assert bad.any() and bool((want[1] > tables.NEG).any())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# K5a's chunks and K6's backpointer stages
FC, FL = chain_floor.FLOOR_CHUNK, chain_floor.FLOOR_LOOK
S_BP = chain_ring.PAIR_BP_STAGES


def _floor_wrapping(T, seed):
    """A floor table of values near +-2^31 and small ones: the int32 sums
    wrap."""
    rng = np.random.default_rng(seed)
    big = rng.choice(np.array([2**31 - 1, -(2**31), 2**31 - 7, 2**30 + 5],
                              np.int64), (T, 8, 128))
    small = rng.integers(-(1 << 20), 1 << 20, (T, 8, 128))
    return np.where(rng.random((T, 8, 128)) < 0.5, big, small).astype(
        np.int32)


@pytest.mark.parametrize("T", [1, FC - 1, FC, FC + 1, 2 * FC,
                               FC * (2 * FL + 3) + 5, 4000, 40000])
@pytest.mark.parametrize("wrap", [False, True])
def test_chain_floor_around_its_chunks(T, wrap, cuda):
    """K5a's scan against its plain version on every backpointer and on
    acc: around a chunk, over enough chunks that a look-back reads several
    windows, at the probe's two chain lengths, on tables whose sums wrap;
    one kernel launch a chain."""
    tbl = _floor_wrapping(T, T) if wrap else tables.floor_tables(T, T)
    args = [torch.from_numpy(tbl).to(cuda)]
    before = chain_floor.chain_floor.launches
    got = chain_floor.chain_floor(*args)
    assert chain_floor.chain_floor.launches == before + 1
    want = chain_floor.chain_floor_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _pair_ties(T, seed):
    """The chain of seed 29, cover 9, with each level's ties permuted at
    random: visiting order cannot decide a winner."""
    tbl = tables.pair_tables(T, 29, 9)[0]
    rng = np.random.default_rng(seed)
    for t in range(T):
        tbl[t, 2] = rng.permutation(256)
    return tbl


def _pair_long_runs(T, seed):
    """Levels of six runs of 1-150 lanes that cross the producer warps'
    quarters, taken by destination pairs 0-5 (the others have none), their
    sources among those pairs, ties permuted."""
    tbl = tables.pair_tables(T, **tables.LIVE)[0]
    rng = np.random.default_rng(seed)
    for t in range(T):
        cuts = np.sort(rng.choice(np.arange(1, 256), 5, replace=False))
        seg = np.searchsorted(cuts, np.arange(256), side="right")
        tbl[t, 3] = seg
        tbl[t, 4] = -1
        tbl[t, 4, :6] = [int(np.flatnonzero(seg == r)[-1]) for r in range(6)]
        tbl[t, 2] = rng.permutation(256)
        tbl[t, 0] = rng.integers(0, 6, 256)
    return tbl


@pytest.mark.parametrize("T", sorted({*RING_LENGTHS, S_BP - 1, S_BP,
                                      S_BP + 1, 2 * S_BP + 1, 40}))
@pytest.mark.parametrize("kind", ["cover9", "live", "ties", "long_runs"])
def test_chain_pair_around_its_bp_stages(kind, T, cuda):
    """K6 against its plain version on every backpointer (padding rows
    zero) and state, at the lengths around the wrap of its backpointer
    stages and of the table ring, on a chain with several lanes into a
    destination and none into others, on the chain that stays alive, with
    ties permuted, and on long runs across the producer warps' quarters."""
    if kind == "cover9":
        tbl = tables.pair_tables(T, 29, 9)[0]
    elif kind == "live":
        tbl = tables.pair_tables(T, **tables.LIVE)[0]
    elif kind == "ties":
        tbl = _pair_ties(T, T)
    else:
        tbl = _pair_long_runs(T, T)
    args = [torch.from_numpy(tbl).to(cuda)]
    got, want = chain_pair.chain_pair(*args), chain_pair.chain_pair_ref(*args)
    assert not got[0][:, 19:].any()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_chain_pair_and_floor_refuse_misaligned_tables(cuda):
    """A table 4 bytes past a 16-byte boundary: K6's bulk copies and K5a's
    16-byte loads refuse it."""
    tbl = torch.from_numpy(tables.pair_tables(4)[0]).to(cuda)
    with pytest.raises(ValueError, match="tbl: .*aligned"):
        chain_pair.chain_pair(_misaligned(tbl))
    tbl = torch.from_numpy(tables.floor_tables(4, 1)).to(cuda)
    with pytest.raises(ValueError, match="tbl: .*aligned"):
        chain_floor.chain_floor(_misaligned(tbl))


def _caps_inputs(name, seed, device):
    ins, expect = caps_tables.make(name, seed)
    return probe_caps.to_device(ins, device), torch.from_numpy(expect)


@pytest.mark.parametrize("seed", [None, *caps_tables.SECOND_SEEDS])
@pytest.mark.parametrize("name", caps.NAMES)
def test_caps_kernel_matches_plain_version_and_expectation(name, seed,
                                                           cuda):
    """Each capability check's kernel (K8 / K9) == its plain version == the
    numpy expectation, every element, exactly (floats as floats), on the
    script's inputs and on the second inputs; one launch per call."""
    kern, plain = caps.CHECKS[name]
    args, want = _caps_inputs(name, seed, cuda)
    before = kern.launches
    got = kern(*args)
    assert kern.launches == before + 1
    ref = plain(*args)
    assert got.dtype == ref.dtype == want.dtype
    assert torch.equal(got, ref) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("name,last", [("manual_dma_dynoff", 48),
                                       ("dma_in_when", 3)])
def test_caps_bulk_copies_at_every_run_time_offset(name, last, seed, cuda):
    """The two bulk copies at a run-time offset, through ``dg_caps``
    itself (the wrappers always pass row 8 / slab 2): every legal row
    (``A[row:row + 16] + 1``) or slab (``A[slab]``), on the script's
    ``A`` and on a seeded random one; an offset one past either end returns
    a non-zero code and launches nothing."""
    ins, (dtype, shape), _, _ = caps.SPECS[name]
    a_shape = ins[0][1]
    if seed is None:
        a_np = caps_tables.make(name)[0][0]
    else:
        a_np = np.random.default_rng(seed).integers(
            -(2**30), 2**30, a_shape, dtype=np.int32)
    a = torch.from_numpy(a_np).to(cuda)
    check_id = caps.NAMES.index(name)

    def call(off, out):
        return kernels.lib().dg_caps(check_id, a.data_ptr(), None,
                                     out.data_ptr(), off,
                                     kernels.stream_of(out))

    for off in range(last + 1):
        out = torch.full(shape, -7, dtype=dtype, device=cuda)
        assert call(off, out) == 0
        want = a[off:off + 16] + 1 if name == "manual_dma_dynoff" else a[off]
        assert torch.equal(out, want), off
    for off in (-1, last + 1):
        out = torch.full(shape, -7, dtype=dtype, device=cuda)
        assert call(off, out) != 0
        torch.cuda.synchronize()
        assert bool((out == -7).all()), off


@pytest.mark.parametrize("name", caps.NAMES)
def test_caps_wrappers_reject_bad_inputs(name, cuda):
    """A wrong dtype, a wrong shape, a non-contiguous tensor, and (for the
    checks with two inputs) one input left on the CPU: each raises."""
    kern = caps.CHECKS[name][0]
    args, _ = _caps_inputs(name, None, cuda)
    i = next(k for k, a in enumerate(args) if a.numel() > 1)

    def with_arg(t):
        return [t if k == i else a for k, a in enumerate(args)]

    a, before = args[i], kern.launches
    other = torch.float32 if a.dtype != torch.float32 else torch.int32
    with pytest.raises(ValueError, match="dtype"):
        kern(*with_arg(a.to(other)))
    with pytest.raises(ValueError, match="shape"):
        kern(*with_arg(a.flatten()[:-1]))
    strided = torch.empty((*a.shape, 2), dtype=a.dtype, device=cuda)[..., 0]
    with pytest.raises(ValueError, match="contiguous"):
        kern(*with_arg(strided))
    if len(args) == 2:
        with pytest.raises(ValueError, match="CUDA tensor"):
            kern(args[0], args[1].cpu())
    assert kern.launches == before


@pytest.mark.parametrize("name", caps.NAMES)
def test_caps_launch_path_rejects_bad_inputs(name, cuda):
    """The launch path (``kernels.Launch``) raises ``ValueError`` before
    any launch on every input: a wrong dtype, a wrong shape, a
    non-contiguous tensor, a CPU tensor among CUDA ones (two-input checks:
    either input), and a copy 4 bytes past a 16-byte boundary. No check
    gives way to its plain version on a CUDA tensor."""
    kern = caps.CHECKS[name][0]
    args, _ = _caps_inputs(name, None, cuda)
    before = kern.launches
    for i, a in enumerate(args):
        def with_arg(t):
            return [t if k == i else x for k, x in enumerate(args)]

        other = torch.float32 if a.dtype != torch.float32 else torch.int32
        with pytest.raises(ValueError, match=f"input {i}: dtype"):
            kern(*with_arg(a.to(other)))
        with pytest.raises(ValueError, match=f"input {i}: shape"):
            kern(*with_arg(torch.cat([a.flatten()] * 2)))
        if a.numel() > 1:  # one element is contiguous at any stride
            strided = torch.empty((*a.shape, 2), dtype=a.dtype,
                                  device=cuda)[..., 0]
            strided.copy_(a)
            with pytest.raises(ValueError,
                               match=f"input {i}: not contiguous"):
                kern(*with_arg(strided))
        with pytest.raises(ValueError, match=f"input {i}: not 16-byte"):
            kern(*with_arg(_misaligned(a)))
        if len(args) == 2:
            with pytest.raises(ValueError,
                               match=f"input {i}: want a CUDA tensor"):
                kern(*with_arg(a.cpu()))
    assert kern.launches == before


@pytest.mark.parametrize("name", caps.NAMES)
def test_caps_launch_path_takes_the_current_stream(name, cuda):
    """A check launched under another current stream runs on that stream
    (``kernels.raw_stream`` == ``torch.cuda.current_stream().cuda_stream``)
    and gives the same output; a non-zero return of the C entry point
    raises ``RuntimeError`` and counts no launch."""
    kern = caps.CHECKS[name][0]
    args, want = _caps_inputs(name, None, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert kernels.raw_stream(cuda.index or 0) == side.cuda_stream
        got = kern(*args)
    side.synchronize()
    assert torch.equal(got.cpu(), want)
    fn, before = kern.launch.fn(), kern.launches
    kern.launch._fn = lambda *a: 1
    try:
        with pytest.raises(RuntimeError, match=f"{name}: CUDA error 1"):
            kern(*args)
    finally:
        kern.launch._fn = fn
    assert kern.launches == before


@pytest.mark.parametrize("name", caps.NAMES)
def test_caps_replaced_path_matches_the_new_one(name, cuda):
    """The replaced launch path and kernels that phase H2 times beside
    the new ones (``probes/caps_replaced.py``) give the same output, on
    the script's inputs and the second inputs."""
    from dipgenie_tpu_torch.probes import caps_replaced

    for seed in (None, *caps_tables.SECOND_SEEDS):
        args, want = _caps_inputs(name, seed, cuda)
        got = caps_replaced.CHECKS[name](*args)
        assert torch.equal(got, caps.CHECKS[name][0](*args))
        assert torch.equal(got.cpu(), want)


# ---------------- K10 sketch, K11 sketch_count, K12 grid_nll ----------------
# (k, w) of the sketch kernel's checks: murmur's block and tail paths (17,
# 31: one block and a 15-byte tail, 32), tail only (16), the CLI's default
SKETCH_KW = [(17, 7), (16, 5), (31, 25), (32, 3), (5, 1)]


# (k, w, B, L) of the kernel's block shapes (csrc/sketch.cu: a block of 256
# windows of the flat range b * NW + j): one window a row (L = k + w - 1, a
# block of 32 rows), 150 bp rows (96 windows, a block over 3 rows), 256 and
# 257 windows a row, 400 bp, rows of 9 and 5 bases; B not a multiple of the
# rows a block holds
SKETCH_CASES = [pytest.param(k, w, 96, 400, id=f"{k}-{w}")
                for k, w in SKETCH_KW] + [
    pytest.param(31, 25, 203, 31 + 25 - 1, id="nw1"),
    pytest.param(17, 7, 77, 17 + 7 - 1, id="nw1-17"),
    pytest.param(31, 25, 1001, 150, id="150bp"),
    pytest.param(32, 3, 1001, 150, id="150bp-32-3"),
    pytest.param(5, 1, 1001, 150, id="150bp-5-1"),
    pytest.param(31, 25, 13, 256 + 31 + 25 - 2, id="nw256"),
    pytest.param(31, 25, 13, 256 + 31 + 25 - 1, id="nw257"),
    pytest.param(31, 25, 37, 400, id="400bp"),
    # rows shorter than 16 bases: a block's 16-aligned start reaches back
    # over several rows
    pytest.param(5, 1, 301, 9, id="short-rows"),
    pytest.param(3, 2, 200, 5, id="short-rows-3-2"),
]


@pytest.mark.parametrize("k,w,B,L", SKETCH_CASES)
def test_sketch_kernel_matches_plain_version(k, w, B, L, cuda):
    codes, lens = ragged_reads(k * 100 + w + B, B, L, k, w)
    args = (torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda))
    before = sketch.batch_minimizer.launches
    got = sketch.batch_minimizer(*args, k, w)
    want = sketch.batch_minimizer_ref(*args, k, w)
    assert sketch.batch_minimizer.launches == before + 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)
    assert bool(got[2].any())


@pytest.mark.parametrize("k", [17, 31])
def test_sketch_drivers_on_the_card_match_the_host_scanner(k, cuda):
    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGT"), int(n)))
            for n in rng.integers(0, 400, 300)]
    seqs += ["ACGTN" * 20, "acgtTTGACCAgg" * 12, "A" * 300]
    got = sketch.sketch_reads_device(seqs, k, 25, device=cuda)
    for i, s in enumerate(seqs):
        assert np.array_equal(got[i], np.unique(
            sketch_sequence(s, k, 25).hashes)), i
    hap = "".join(rng.choice(list("ACGT"), 200_000))
    hs, ps = sketch.sketch_long_sequence_device(hap, k, 25, device=cuda)
    m = sketch_sequence(hap, k, 25)
    assert np.array_equal(hs, m.hashes) and np.array_equal(ps, m.positions)


def _count_table(hh, hl, emit, seed):
    """A table sorted by unsigned (hi, lo): half the emitted hashes, random
    ones, and runs of up to 7 slots of one hi (some of whose lo values are
    emitted hashes, past max_dup for the later slots)."""
    rng = np.random.default_rng(seed)
    hi = hh[emit].cpu().numpy().view(np.uint32)
    lo = hl[emit].cpu().numpy().view(np.uint32)
    pick = rng.random(len(hi)) < 0.5
    t_hi = [hi[pick], rng.integers(0, 2**32, 500, dtype=np.uint64)]
    t_lo = [lo[pick], rng.integers(0, 2**32, 500, dtype=np.uint64)]
    for i in rng.choice(len(hi), 20, replace=False):
        n = int(rng.integers(2, 8))
        t_hi.append(np.full(n, hi[i], np.uint64))
        t_lo.append(np.concatenate([rng.integers(0, 2**32, n - 1,
                                                 dtype=np.uint64), [lo[i]]]))
    t_hi = np.concatenate(t_hi).astype(np.uint32)
    t_lo = np.concatenate(t_lo).astype(np.uint32)
    order = np.lexsort((t_lo, t_hi))
    return t_hi[order], t_lo[order]


@pytest.mark.parametrize("k,w,L", [(31, 25, 150), (5, 1, 9)])
def test_sketch_kernel_on_rows_not_16_aligned(k, w, L, cuda):
    """The rows from 1 on as a view: codes not 16-byte aligned, which the
    kernel reads byte by byte."""
    codes, lens = ragged_reads(L, 301, L, k, w)
    c = torch.from_numpy(codes).to(cuda)[1:]
    n = torch.from_numpy(lens).to(cuda)[1:]
    assert c.data_ptr() % 16
    got = sketch.batch_minimizer(c, n, k, w)
    want = sketch.batch_minimizer_ref(c, n, k, w)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


# the tables of utils/synth.count_tables, their max_dup values, and: the
# hashes moved to the ends of the range (hi 0 and 0xFFFFFFFF); no emitted
# window; the rows from 1 on as views (flags the kernel reads byte by byte)
COUNT_CASES = [pytest.param("random", d, id=f"random-{d}") for d in (4, 1)] + [
    pytest.param(name, d, id=f"{name}-{d}")
    for name, dups in (("mixed", (4, 1, 0)), ("full_bucket", (4,)),
                       ("lonely", (4,)), ("edges", (4,)), ("m1", (4,)),
                       ("one_read", (4,)), ("edge_hashes", (4, 1)),
                       ("none", (4,)), ("rows_view", (4,)))
    for d in dups]


@pytest.mark.parametrize("table,max_dup", COUNT_CASES)
def test_sketch_count_kernel_matches_plain_version(table, max_dup, cuda):
    codes, lens = ragged_reads(3, 256, 200, 17, 7)
    hh, hl, emit, _ = sketch.batch_minimizer(
        torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda),
        17, 7)
    if table == "random":
        t_hi, t_lo = _count_table(hh, hl, emit, 5)
    else:
        host = [t.cpu().numpy() for t in (hh, hl, emit)]
        tabs = {t[0]: t[1:3] for t in count_tables(*host, 5)}
        t_hi, t_lo = tabs.get(table, tabs["edges"])
        if table == "edge_hashes":
            e_hi, e_lo = edge_hashes(*host)
            hh, hl = (torch.from_numpy(a.view(np.int32)).to(cuda)
                      for a in (e_hi, e_lo))
        if table == "none":
            emit = torch.zeros_like(emit)
        if table == "rows_view":  # views from row 1: emit not 16-aligned
            hh, hl, emit = hh[1:], hl[1:], emit[1:]
            assert emit.data_ptr() % 16
    tables = (pmesh.u32_tensor(t_hi, cuda), pmesh.u32_tensor(t_lo, cuda))
    before = pmesh.sketch_count.launches
    got = pmesh.sketch_count(hh, hl, emit, *tables, max_dup)
    want = pmesh.sketch_count_ref(hh, hl, emit, *tables, max_dup)
    assert pmesh.sketch_count.launches == before + 1
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    hits = int(got[0].sum())
    assert int(got[1].sum()) == hits
    assert (hits == 0) == (table == "none" or max_dup == 0)
    if table == "one_read":
        assert int((got[1] > 0).sum()) == 1
    if table in ("random", "mixed"):
        one = pmesh.sharded_sketch_count_step(None, codes, lens, t_hi, t_lo,
                                              17, 7, max_dup, device=cuda)
        assert all(torch.equal(g, x) for g, x in zip(one, got))


def _fit_grid(seed):
    """A default-grid problem of the pipeline's options on a drawn
    histogram: the grid and the histogram's (xs, ys)."""
    rng = np.random.default_rng(seed)
    mult = np.concatenate([np.ones(5000), rng.poisson(3, 1500) + 1,
                           rng.poisson(9, 400) + 1]).astype(int)
    uniq, freq = np.unique(mult, return_counts=True)
    opt = fitter.KGFitOptions(max_copy=10, max_x_use=int(uniq.max()),
                              u_hi=float(uniq.max()))
    lin = fitter._linspace
    grid = (lin(opt.u_lo, opt.u_hi, opt.grid_u),
            lin(opt.sd_lo, opt.sd_hi, opt.grid_sd),
            lin(opt.varw_lo, opt.varw_hi, opt.grid_varw),
            lin(opt.zp_lo, opt.zp_hi, opt.grid_zp),
            lin(opt.zp_lo, opt.zp_hi, opt.grid_zp),
            lin(opt.pd_lo, opt.pd_hi, opt.grid_pd),
            lin(opt.pe_lo, opt.pe_hi, opt.grid_pe),
            lin(opt.s_lo, opt.s_hi, opt.grid_s))
    pairs = [(int(m), float(f)) for m, f in zip(uniq, freq)]
    return grid, uniq.astype(np.int64), freq.astype(np.float64), opt, pairs


def test_grid_nll_kernel_matches_plain_version(cuda):
    """K12 against its plain version on the card at the default grid
    (2,100,875 points): relative difference at most 1e-5 (log ulps and
    the order of the sum), then the torch fitter on the card equals the
    numpy backend exactly."""
    grid, xs, ys, opt, pairs = _fit_grid(3)
    ins = fitter.grid_inputs(*grid, 10, xs, ys, cuda)
    before = fitter.grid_nll.launches
    got = fitter.grid_nll(*ins)
    want = fitter.grid_nll_ref(*ins)
    assert fitter.grid_nll.launches == before + 1
    assert got.shape == want.shape == (7, 7, 5, 7, 7, 7, 5, 5)
    assert bool(torch.isfinite(got).all())
    rel = ((got.double() - want.double()).abs()
           / want.double().abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-5, float(rel)
    a = fitter.fit_histogram(pairs, opt, backend="numpy")
    b = fitter.fit_histogram(pairs, opt, backend="torch", device=cuda)
    assert a.P == b.P and a.nll == b.nll


def _grid_case(name):
    """``(grid, xs, ys, opt, pairs)`` of a K12 check: the default grid
    (``_fit_grid(3)``); VW, PE and SS frozen (fit_varw=False,
    fit_error=False; the kernels' grid takes each at its midpoint, the fit
    at its seed); one bin; 200 bins; 1 and 20 copies."""
    grid, xs, ys, opt, pairs = _fit_grid(3)
    if name == "nx1":
        pairs = [(3, 1e6)]
        opt = fitter.KGFitOptions(max_copy=10, max_x_use=3, u_hi=3.0)
        xs, ys = np.asarray([3]), np.asarray([1e6])
    elif name == "nx200":
        x = np.arange(1, 201)
        f = np.round(1e5 * np.exp(-x / 30.0)) + 1 + (x % 7)
        pairs = [(int(m), float(c)) for m, c in zip(x, f)]
        opt = fitter.KGFitOptions(max_copy=10, max_x_use=200, u_hi=60.0)
        xs, ys = x.astype(np.int64), f.astype(np.float64)
    elif name != "default":
        opt = dataclasses.replace(opt, **{
            "frozen": dict(fit_varw=False, fit_error=False),
            "copies1": dict(max_copy=1), "copies20": dict(max_copy=20)}[name])
    lin, o = fitter._linspace, opt
    frozen = name == "frozen"
    grid = (lin(o.u_lo, o.u_hi, o.grid_u), lin(o.sd_lo, o.sd_hi, o.grid_sd),
            lin(o.varw_lo, o.varw_hi, 1 if frozen else o.grid_varw),
            lin(o.zp_lo, o.zp_hi, o.grid_zp), lin(o.zp_lo, o.zp_hi, o.grid_zp),
            lin(o.pd_lo, o.pd_hi, o.grid_pd),
            lin(o.pe_lo, o.pe_hi, 1 if frozen else o.grid_pe),
            lin(o.s_lo, o.s_hi, 1 if frozen else o.grid_s))
    return grid, xs, ys, opt, pairs


GRID_CASES = ["default", "frozen", "nx1", "nx200", "copies1", "copies20"]


def _rel(got, want):
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_nll_kernel_on_grid_cases(name, cuda):
    """K12 against its plain version on the default grid, with VW, PE and
    SS frozen, on 1 and 200 bins and with 1 and 20 copies (relative 1e-5),
    then the torch fit on the card equals the numpy fit on that case."""
    grid, xs, ys, opt, pairs = _grid_case(name)
    ins = fitter.grid_inputs(*grid, opt.max_copy, xs, ys, cuda)
    before = fitter.grid_nll.launches
    got = fitter.grid_nll(*ins)
    want = fitter.grid_nll_ref(*ins)
    assert fitter.grid_nll.launches == before + 1
    assert got.shape == want.shape == tuple(len(a) for a in grid)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    a = fitter.fit_histogram(pairs, opt, backend="numpy")
    b = fitter.fit_histogram(pairs, opt, backend="torch", device=cuda)
    assert a.P == b.P and a.nll == b.nll


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_tables_kernel_matches_plain_version(name, cuda):
    """The table kernel against _grid_tables_torch on the card: every
    entry within a relative 1e-5 (exp, pow and the sum over copies in
    another order), every clamped entry equal."""
    grid, xs, _, opt, _ = _grid_case(name)
    U, SD, VW, ZP, ZPH, _, _, SS = grid
    want = fitter._grid_tables_torch(U, SD, VW, ZP, ZPH, SS, opt.max_copy,
                                     xs, cuda)
    axes = fitter.axes_on(cuda, U, SD, VW, ZP, ZPH, SS, xs)
    floor = torch.tensor(1e-35, dtype=torch.float32, device=cuda)
    before = fitter.grid_tables.launches
    got = fitter.grid_tables(*axes[:6], opt.max_copy, axes[6], cuda)
    assert fitter.grid_tables.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert bool(torch.isfinite(g).all()) and bool((g >= floor).all())
        rel = ((g.double() - w.double()).abs() / w.double()).max()
        assert float(rel) <= 1e-5, float(rel)
        clamped = w == floor
        assert torch.equal(g[clamped], w[clamped])


def test_grid_inputs_is_one_table_launch(cuda):
    """grid_inputs on the card: one grid_tables launch and no K12 launch;
    pd, pe and y are the axes' float32 values."""
    grid, xs, ys, opt, _ = _grid_case("default")
    before = (fitter.grid_tables.launches, fitter.grid_nll.launches)
    ins = fitter.grid_inputs(*grid, opt.max_copy, xs, ys, cuda)
    assert (fitter.grid_tables.launches,
            fitter.grid_nll.launches) == (before[0] + 1, before[1])
    for t, a in zip(ins[3:], (grid[5], grid[6], ys)):
        assert t.device.type == "cuda" and torch.equal(
            t.cpu(), torch.as_tensor(np.asarray(a, np.float64),
                                     dtype=torch.float32))


def test_grid_tables_rejects_bad_inputs(cuda):
    grid, xs, _, opt, _ = _grid_case("default")
    U, SD, VW, ZP, ZPH, _, _, SS = grid
    views = list(fitter.axes_on(cuda, U, SD, VW, ZP, ZPH, SS, xs))
    before = fitter.grid_tables.launches

    def call(axes, copies=10):
        return fitter.grid_tables(*axes[:6], copies, axes[6], cuda)

    with pytest.raises(ValueError, match="max_copy"):
        call(views, 0)
    with pytest.raises(ValueError, match="max_copy"):
        call(views, 2.5)
    with pytest.raises(ValueError, match="float32"):
        call(views[:2] + [views[2].double()] + views[3:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(views[:3] + [views[3].cpu()] + views[4:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(views[:6] + [xs])
    with pytest.raises(ValueError, match="CUDA tensor"):
        call((U, SD, VW, ZP, ZPH, SS, xs))
    with pytest.raises(ValueError, match="1-D"):
        call(views[:6] + [views[6][:0]])
    with pytest.raises(ValueError, match="1-D"):
        call([views[0].reshape(1, -1)] + views[1:])
    assert fitter.grid_tables.launches == before


def test_sketch_wrappers_reject_bad_inputs(cuda):
    codes, lens = ragged_reads(1, 8, 64, 17, 7)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    before = sketch.batch_minimizer.launches
    with pytest.raises(ValueError, match="k <= 32"):
        sketch.batch_minimizer(c, n, 33, 7)
    with pytest.raises(ValueError, match="lens"):
        sketch.batch_minimizer(c, n.cpu(), 17, 7)
    with pytest.raises(ValueError, match="codes"):
        sketch.batch_minimizer(c.to(torch.int32), n, 17, 7)
    with pytest.raises(ValueError, match="no window"):
        sketch.batch_minimizer(c[:, :20], n, 17, 7)
    assert sketch.batch_minimizer.launches == before
    ins = fitter.grid_inputs(*_fit_grid(0)[0], 10, np.arange(1, 5),
                             np.ones(4), cuda)
    with pytest.raises(ValueError, match="float32"):
        fitter.grid_nll(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fitter.grid_nll(*ins[:5], ins[5].cpu())


def test_parallel_edges_dense_run_goes_to_k3(cuda):
    """A dense run (2 windows) with a destination of 44,100 pairs, more
    than a K2 slice holds, runs through K3 on the card and equals the
    native tier."""
    g, chb = parallel_edges_graph()
    arrs = csr_arrays(g, chb)
    dplan = plan_to_device(plan_pairs(*arrs, 4), cuda)
    assert [s.kind for s in dplan.segments] == ["wide_split"]
    V, recs = _run_checked(dplan, cuda)
    from dipgenie_tpu_torch.ops.diploid_pair import assemble

    got = assemble(int(V[4, 0]), recs.cpu().numpy())
    assert got == native_forward_csr(arrs, 4)


# ---------------- K13-K16: the fused and chunked tiers ----------------

# the JAX tiers' random graphs, the real slices, test_fused_dp_high_indegree's
# graph, and one band of three levels 1,000-1,024 wide (the shape of W,
# ops/vertex_plan.py's widest levels past the pair planner)
VERTEX_CASES = NPZ + list(CASES[:4]) + ["high_indegree", "wide_1000"]


def vertex_case(case):
    """(CSR arrays, R) of a VERTEX_CASES entry."""
    from dipgenie_tpu_torch.utils.synth import high_indegree_graph

    if case == "high_indegree":
        return csr_arrays(*high_indegree_graph()), 3
    if case == "wide_1000":
        return mhc_shaped_csr(L=40, seed=3, n_bands=1, band_len=3,
                              wmin=1000, wmax=1024), 18
    return case_csr(case)


@pytest.mark.parametrize("case", VERTEX_CASES)
def test_fused_kernels_match_plain_versions(case, cuda):
    """K13 on each transition from the plain path's state, every V and
    code element equal to its plain version; K13 over the whole plan in
    one call; K14 on the codes equal to its plain version."""
    from dipgenie_tpu_torch.ops import fused
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = vertex_case(case)
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    bk = torch.empty(plan.bp_bytes, dtype=torch.uint8, device=cuda)
    bp = torch.empty_like(bk)
    V0 = initial_state(R, int(plan.vplan.widths[0]), cuda)
    V, before = V0, fused.fused_forward.launches
    for t in range(plan.T):
        got = fused.fused_forward(dev, t, t + 1, V, bk)
        V = fused.fused_forward_ref(dev, t, t + 1, V, bp)
        assert torch.equal(got, V), t
        assert torch.equal(fused._codes(bk, plan.desc[t], R + 1),
                           fused._codes(bp, plan.desc[t], R + 1)), t
    assert fused.fused_forward.launches == before + sum(
        len(fused.launch_cut(dev, t, t + 1, R + 1, False))
        for t in range(plan.T))
    whole = torch.empty_like(bk)
    before = fused.fused_forward.launches
    assert torch.equal(fused.fused_forward(dev, 0, plan.T, V0, whole), V)
    assert fused.fused_forward.launches == before + len(
        fused.launch_cut(dev, 0, plan.T, R + 1, False))
    cycles = torch.zeros(plan.T, dtype=torch.int32, device=cuda)
    before = fused.fused_trace.launches
    rows, sh = fused.fused_trace(dev, whole, R, cycles)
    assert fused.fused_trace.launches == before + 1
    want = fused.fused_trace_ref(dev, bp, R)
    assert torch.equal(rows, want[0]) and sh == want[1]
    assert fused.path_shet_ref(dev, rows) == sh
    assert (cycles >> 1).min() > 0


def walk_spans(T):
    """K16's spans in the order the traceback takes them: the last
    transition alone, a middle span, then the first span (which ends the
    walk)."""
    cuts = sorted({0, max(T // 3, 1), max(T - 1, 1), T})
    spans = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    return spans[::-1]


@pytest.mark.parametrize("case", VERTEX_CASES)
def test_chunk_kernels_match_plain_versions(case, cuda):
    """K15 on each transition (forward and replay) from the plain path's
    state: V, SH and the packed backpointers equal to its plain version;
    K16 over the whole plan as one span, and in spans (a span of one
    transition, the first span), rows and carry equal to its plain
    version, one launch a span."""
    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = vertex_case(case)
    plan = plan_vertices_of(arrs)
    dev = ship(plan, cuda)
    V = initial_state(R, int(plan.widths[0]), cuda)
    SH = torch.zeros_like(V)
    woff = chunked.word_offsets(plan.desc, R + 1)
    off = woff[:-1]
    bk = torch.empty(int(woff[-1]), dtype=torch.int32, device=cuda)
    bp = torch.empty_like(bk)
    for t in range(plan.T):
        got = chunked.chunk_step(dev, t, t + 1, V, SH, bk, off[t:t + 1])
        fwd = chunked.chunk_step(dev, t, t + 1, V, SH)
        V, SH = chunked.chunk_step_ref(dev, t, t + 1, V, SH, bp,
                                       off[t:t + 1])
        for g in (got, fwd):
            assert torch.equal(g[0], V) and torch.equal(g[1], SH), t
    assert torch.equal(bk, bp)
    wdev = torch.from_numpy(woff).to(cuda)
    for spans in ([(0, plan.T)], walk_spans(plan.T)):
        out = {}
        for which, fn in (("kernel", chunked.chunk_trace),
                          ("plain", chunked.chunk_trace_ref)):
            carry = torch.tensor([0, 0, R], dtype=torch.int32, device=cuda)
            rows = torch.zeros((plan.T, 4), dtype=torch.int32, device=cuda)
            before = chunked.chunk_trace.launches
            for t0, t1 in spans:
                fn(dev, wdev, t0, t1, bp[int(woff[t0]):], carry, rows[t0:t1])
            if which == "kernel":
                assert chunked.chunk_trace.launches == before + len(spans)
            out[which] = (rows, carry)
        assert torch.equal(out["kernel"][0], out["plain"][0])
        assert torch.equal(out["kernel"][1], out["plain"][1])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("case", ["mhc_slice_wide_csr", "wide_1000"])
def test_chunk_share_matches_plain_and_unshared(case, n, cuda):
    """K15's per-transition kernel on each of ``n`` tp ranks' shares of a
    transition's destination pairs (``chunk_share``, compact buffers, the
    last share short where ``k2 * k2`` does not divide by ``n``), from the
    path's state: each share equal to its plain version, and the shares
    stitched by ``place`` equal to the unshared launch, V, SH and words;
    one launch a non-empty share. Every transition of the wide slice (its
    narrow ones too), and the widest of ``wide_1000``."""
    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = vertex_case(case)
    plan = plan_vertices_of(arrs)
    dev = ship(plan, cuda)
    R1 = R + 1
    V = initial_state(R, int(plan.widths[0]), cuda)
    SH = torch.zeros_like(V)
    ts = (range(plan.T) if case == "mhc_slice_wide_csr"
          else [int(np.argmax(plan.desc[:, 1]))])
    if case == "wide_1000":
        V, SH = chunked.chunk_step(dev, 0, ts[0], V, SH)
    for t in ts:
        k2 = int(plan.desc[t, 1])
        kk2 = k2 * k2
        bp = torch.zeros(R1 * kk2, dtype=torch.int32, device=cuda)
        want = chunked.chunk_step(dev, t, t + 1, V, SH, bp, [0])
        S = chunked.share_of(kk2, n, 0)[2]
        g = torch.full((n, 3, R1, S), -7, dtype=torch.int32, device=cuda)
        for d in range(n):
            p0, p1, _ = chunked.share_of(kk2, n, d)
            before = chunked.chunk_share.launches
            chunked.chunk_share(dev, t, V, SH, p0, p1, g[d])
            assert chunked.chunk_share.launches == before + (p1 > p0)
            ref = chunked.chunk_share_ref(dev, t, V, SH, p0, p1)
            for c in range(3):
                assert torch.equal(g[d, c, :, :p1 - p0], ref[c]), (t, d, c)
        for c, w in enumerate((*want, bp)):
            dest = torch.empty(R1 * kk2, dtype=torch.int32, device=cuda)
            chunked.place(g[:, c], dest, kk2)
            assert torch.equal(dest, w.reshape(-1)), (t, c)
        V, SH = (x.clone() for x in want)
    assert int(V[R].max()) >= 0


def band_walk_case():
    """An MHC-shaped graph whose second edges all weigh 1, at R = 18: the
    path's r falls by up to 2 a transition, past the rows the producer
    staged a batch earlier (BAND = 2 below r), until it reaches 0."""
    arrs = list(mhc_shaped_csr(L=300, seed=4, n_bands=2, band_len=3))
    adj_ptr, adj_w = arrs[1], arrs[3].copy()
    deg = np.diff(adj_ptr)
    adj_w[adj_ptr[:-1][deg == 2] + 1] = 1
    arrs[3] = adj_w
    return tuple(arrs), 18


@pytest.mark.parametrize("case", ["wide_1000", "r_falls"])
def test_walks_stage_and_take_l2_path(case, cuda):
    """K14 and K16 on one walk with staged transitions and transitions
    read through L2 (``wide_1000``: levels 1,000-1,024 wide among narrow
    ones; ``r_falls``: narrow levels whose r falls past the staged rows),
    equal to their plain versions; the walkers' cycle stamps say both
    kinds ran."""
    from dipgenie_tpu_torch.ops import chunked, fused
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = vertex_case(case) if case == "wide_1000" else band_walk_case()
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    bp = torch.zeros(plan.bp_bytes, dtype=torch.uint8, device=cuda)
    V0 = initial_state(R, int(plan.vplan.widths[0]), cuda)
    V = fused.fused_forward(dev, 0, plan.T, V0, bp)
    assert int(V[R, 0, 0]) >= 0
    cyc = torch.zeros(plan.T, dtype=torch.int32, device=cuda)
    rows, sh = fused.fused_trace(dev, bp, R, cyc)
    want = fused.fused_trace_ref(dev, bp, R)
    assert torch.equal(rows, want[0]) and sh == want[1]
    staged = (cyc & 1).bool()
    assert staged.any() and not staged.all()
    if case == "r_falls":  # r after each step of the walk, in walk order
        r = R - torch.cumsum(rows[:, 2:].sum(1).flip(0), 0)
        assert int(r.min()) <= 0 and int(R - r[31]) > 2

    woff = chunked.word_offsets(plan.desc, R + 1)
    words = torch.zeros(int(woff[-1]), dtype=torch.int32, device=cuda)
    chunked.chunk_step(dev, 0, plan.T, V0, torch.zeros_like(V0), words,
                       woff[:-1])
    wdev = torch.from_numpy(woff).to(cuda)
    out = {}
    for which in ("kernel", "plain"):
        carry = torch.tensor([0, 0, R], dtype=torch.int32, device=cuda)
        got = torch.zeros((plan.T, 4), dtype=torch.int32, device=cuda)
        if which == "kernel":
            chunked.chunk_trace(dev, wdev, 0, plan.T, words, carry, got, cyc)
        else:
            chunked.chunk_trace_ref(dev, wdev, 0, plan.T, words, carry, got)
        out[which] = (got, carry)
    assert torch.equal(out["kernel"][0], out["plain"][0])
    assert torch.equal(out["kernel"][1], out["plain"][1])
    assert torch.equal(out["kernel"][0], rows)
    staged = (cyc & 1).bool()
    assert staged.any() and not staged.all()


@pytest.mark.parametrize("case", ["mhc_slice_csr", "wide_1000"])
def test_chunked_traceback_on_one_buffer(case, cuda):
    """The traceback of ``DeviceDiploidDP`` (one word buffer for every
    span, the forward's cuts, K16 with the plan-wide offsets) gives the
    rows of the loop it replaced: a buffer a span, offsets from 0 a span,
    the cut made again, the plain walk."""
    from dipgenie_tpu_torch.ops import chunked

    arrs, R = vertex_case(case)
    plan = plan_vertices_of(arrs)
    dp = chunked.DeviceDiploidDP(plan, R, cuda, ckpt_every=3)
    dev = dp.ship()
    _, _, ckpts = dp.forward(dev)
    rows = dp.traceback(dev, ckpts)
    _, _, ckpts = dp.forward(dev)
    old = torch.zeros_like(rows)
    carry = torch.tensor([0, 0, R], dtype=torch.int32, device=cuda)
    woff = torch.from_numpy(chunked.word_offsets(plan.desc, R + 1))
    for t0, t1 in reversed(dp.spans):
        sizes = (R + 1) * plan.desc[t0:t1, 1] ** 2
        off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        bp = torch.empty(int(sizes.sum()), dtype=torch.int32, device=cuda)
        Vr, SHr = ckpts.pop()
        chunked.chunk_step(dev, t0, t1, Vr, SHr, bp, off)
        chunked.chunk_trace_ref(dev, woff, t0, t1, bp, carry, old[t0:t1])
    assert torch.equal(rows, old)
    assert len(dp.spans) > 1


def plan_vertices_of(arrs):
    from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices

    return plan_vertices(*arrs)


@pytest.mark.parametrize("case", VERTEX_CASES)
def test_vertex_tiers_on_card_match_native(case, cuda):
    """Both tiers on the card equal the native tier (the slices' baked
    oracles equal it too)."""
    from dipgenie_tpu_torch.ops import chunked, fused

    arrs, R = vertex_case(case)
    want = native_forward_csr(arrs, R)
    assert fused.FusedDiploidDP(fused.plan_fused(*arrs, R), cuda).run() == want
    assert chunked.DeviceDiploidDP(plan_vertices_of(arrs), R, cuda,
                                   ckpt_every=3).run() == want


def test_vertex_wrappers_reject_bad_inputs(cuda):
    from dipgenie_tpu_torch.ops import chunked, fused
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = vertex_case("mhc_slice_csr")
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    V = initial_state(R, 1, cuda)
    bp = torch.empty(plan.bp_bytes, dtype=torch.uint8, device=cuda)
    before = (fused.fused_forward.launches, chunked.chunk_step.launches)
    with pytest.raises(ValueError, match="dtype"):
        fused.fused_forward(dev, 0, 1, V.long(), bp)
    with pytest.raises(ValueError, match="bp"):
        fused.fused_forward(dev, 0, 1, V, bp.view(torch.int16))
    with pytest.raises(ValueError, match="SH"):
        chunked.chunk_step(dev, 0, 1, V, V.float())
    assert (fused.fused_forward.launches,
            chunked.chunk_step.launches) == before


# ---------------- K13 / K15: runs of narrow transitions in one launch ------

def band_case(width, R=18, L=60, seed=0, band_len=4):
    """(CSR arrays, R): an MHC-shaped graph (narrow widths 2-32) with one
    band of ``band_len`` levels ``width`` wide."""
    return mhc_shaped_csr(L=L, seed=seed, n_bands=1, band_len=band_len,
                          wmin=width, wmax=width), R


def _ties_case():
    """Parallel edges into one destination (each source three times, equal
    weights): exact ties that the first slot pair breaks, inside a run."""
    from dipgenie_tpu_torch.utils.synth import parallel_edges_graph

    return csr_arrays(*parallel_edges_graph(width=8, in_edges=24)), 4


RUN_CASES = {
    # at the shared-memory edges: K15 keeps V and SH double-buffered to
    # width 26 at R = 18, K13 V to width 36 (ops/vertex_plan.py:
    # run_smem_bytes against the card's 232,448 bytes)
    **{f"width{w}": band_case(w) for w in (24, 25, 26, 27, 32, 33, 36, 37)},
    "R0": band_case(20, R=0, L=120, seed=1),
    "R60": band_case(24, R=60, L=80, seed=2),
    "ties": _ties_case(),
    "mhc": (mhc_shaped_csr(L=400, seed=5, n_bands=3), 18),
}


def _random_state(shape, seed, device):
    """V with 40% of its states unreachable, SH small; int32 on device."""
    from dipgenie_tpu_torch.ops.vertex_plan import NEG

    rng = np.random.default_rng(seed)
    val = rng.integers(0, 1000, shape)
    V = np.where(rng.random(shape) < 0.4, NEG, val).astype(np.int32)
    SH = rng.integers(0, 50, shape).astype(np.int32)
    return torch.from_numpy(V).to(device), torch.from_numpy(SH).to(device)


def _cuts(T):
    """Call ranges: the whole plan, and the plan cut at awkward points (a
    run cut short at both ends)."""
    m = [0, 1, max(T // 3, 1), max(T // 3, 1) + 1, T - 1, T]
    return [(0, T), *((a, b) for a, b in zip(sorted(set(m)),
                                            sorted(set(m))[1:]) if b > a)]


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_kernels_match_plain_versions_over_runs(case, cuda):
    """K13 and K15 (forward and replay) over whole runs and across run
    boundaries, from the initial state and from a random state with
    unreachable entries: every V, code, SH and packed word equal to the
    plain versions'; each call launches the host cut's count, runs
    included."""
    from dipgenie_tpu_torch.ops import chunked, fused
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = RUN_CASES[case]
    R1 = R + 1
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    sizes = R1 * plan.desc[:, 1] ** 2
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    kinds = set()
    for t0, t1 in _cuts(plan.T):
        k = int(plan.vplan.widths[t0])
        starts = [_random_state((R1, k, k), t0, cuda)]
        if t0 == 0:
            V0 = initial_state(R, k, cuda)
            starts.append((V0, torch.zeros_like(V0)))
        for V0, SH0 in starts:
            codes = [torch.zeros(plan.bp_bytes, dtype=torch.uint8,
                                 device=cuda) for _ in range(2)]
            cut = fused.launch_cut(dev, t0, t1, R1, False)
            kinds |= {bool(x) for x in cut[:, 2] > 0}
            before = fused.fused_forward.launches
            got = fused.fused_forward(dev, t0, t1, V0, codes[0])
            assert fused.fused_forward.launches == before + len(cut)
            want = fused.fused_forward_ref(dev, t0, t1, V0, codes[1])
            assert torch.equal(got, want), (t0, t1)
            for t in range(t0, t1):
                assert torch.equal(fused._codes(codes[0], plan.desc[t], R1),
                                   fused._codes(codes[1], plan.desc[t], R1)), t
            del codes
            o = off[t0:t1] - off[t0]
            n = int(sizes[t0:t1].sum())
            words = [torch.zeros(n, dtype=torch.int32, device=cuda)
                     for _ in range(2)]
            before = chunked.chunk_step.launches
            g15 = chunked.chunk_step(dev, t0, t1, V0, SH0, words[0], o)
            fwd = chunked.chunk_step(dev, t0, t1, V0, SH0)
            assert chunked.chunk_step.launches == before + 2 * len(
                fused.launch_cut(dev, t0, t1, R1, True))
            w15 = chunked.chunk_step_ref(dev, t0, t1, V0, SH0, words[1], o)
            for g in (g15, fwd):
                assert torch.equal(g[0], w15[0]), (t0, t1)
                assert torch.equal(g[1], w15[1]), (t0, t1)
            assert torch.equal(words[0], words[1]), (t0, t1)
    if case in ("width24", "width25", "width26", "R0", "ties"):
        assert kinds == {True}, kinds  # every transition in a run
    if case in ("width37", "R60"):
        assert kinds == {True, False}, kinds  # runs cut by the band


def test_wide_to_narrow_level_matches_plain_versions(cuda):
    """A band of levels 1,000-1,024 wide feeding a narrow level (in-degree
    past 200): the per-transition kernel on the wide transitions, runs on
    the narrow ones, from a random state; every element equal."""
    from dipgenie_tpu_torch.ops import chunked, fused
    from dipgenie_tpu_torch.ops.vertex_plan import ship

    arrs = mhc_shaped_csr(L=30, seed=4, n_bands=1, band_len=3, wmin=1000,
                          wmax=1024)
    R, R1 = 18, 19
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    t_in = int(np.argmax(plan.desc[:, 2]))
    assert plan.desc[t_in, 2] > 200 and plan.desc[t_in, 0] >= 1000
    for t0, t1 in ((t_in, t_in + 1), (t_in, min(t_in + 6, plan.T))):
        k = int(plan.desc[t0, 0])
        V0, SH0 = _random_state((R1, k, k), t0, cuda)
        codes = [torch.zeros(plan.bp_bytes, dtype=torch.uint8, device=cuda)
                 for _ in range(2)]
        got = fused.fused_forward(dev, t0, t1, V0, codes[0])
        want = fused.fused_forward_ref(dev, t0, t1, V0, codes[1])
        assert torch.equal(got, want)
        assert int((want >= 0).sum()) > 0
        assert torch.equal(codes[0], codes[1])
        del codes
        sizes = R1 * plan.desc[t0:t1, 1] ** 2
        o = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        words = [torch.zeros(int(sizes.sum()), dtype=torch.int32,
                             device=cuda) for _ in range(2)]
        g = chunked.chunk_step(dev, t0, t1, V0, SH0, words[0], o)
        w = chunked.chunk_step_ref(dev, t0, t1, V0, SH0, words[1], o)
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
        assert torch.equal(words[0], words[1])


def test_run_kernel_refused_launch_raises(cuda, monkeypatch):
    """A run whose states the card's shared memory cannot hold, cut for a
    budget past the card's: the run kernel's opt-in is refused and both
    wrappers raise, their counts unmoved; no per-transition retry."""
    from dipgenie_tpu_torch.ops import chunked, fused
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = band_case(30, R=40)
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, cuda, plan.desc)
    monkeypatch.setattr(fused, "smem_budget", lambda device: 1 << 22)
    cut = fused.launch_cut(dev, 0, plan.T, R + 1, False)
    assert len(cut) == 1 and cut[0, 2] >= 30
    V = initial_state(R, 1, cuda)
    bp = torch.zeros(plan.bp_bytes, dtype=torch.uint8, device=cuda)
    before = (fused.fused_forward.launches, chunked.chunk_step.launches)
    with pytest.raises(RuntimeError, match="fused_forward"):
        fused.fused_forward(dev, 0, plan.T, V, bp)
    with pytest.raises(RuntimeError, match="chunk_step"):
        chunked.chunk_step(dev, 0, plan.T, V, torch.zeros_like(V))
    assert (fused.fused_forward.launches,
            chunked.chunk_step.launches) == before


def test_chunk_step_refuses_scattered_word_offsets(cuda):
    """On the card a call's packed words lie one transition after another;
    other offsets raise before any launch."""
    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.ops.vertex_plan import initial_state, ship

    arrs, R = band_case(8, L=12)
    plan = plan_vertices_of(arrs)
    dev = ship(plan, cuda)
    V = initial_state(R, 1, cuda)
    n = (R + 1) * int((plan.desc[:2, 1] ** 2).sum())
    bp = torch.zeros(2 * n, dtype=torch.int32, device=cuda)
    before = chunked.chunk_step.launches
    with pytest.raises(ValueError, match="right after"):
        chunked.chunk_step(dev, 0, 2, V, torch.zeros_like(V), bp,
                           np.array([0, n], np.int64))
    assert chunked.chunk_step.launches == before
