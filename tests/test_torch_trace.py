"""The tables the port's CUDA traceback (K-T) and dense wide kernel (K2)
read, made when the plan is shipped (``ops/plan.py``), on the CPU.

K-T's per-transition columns (``DevPlan.desc``) and the per-segment
address rows ``ops/trace.py`` sends at trace time must give, row for row,
the descriptor table the traceback was first written against (kept here
as ``descriptors_before``: an int64 row of addresses and shapes per
transition, built on the host at every call). K2's slices must cover each
transition's written lanes once, hold no more pairs than the kernel's
shared memory, and cut its destination-sorted pairs into the ranges the
kernel's search finds. The plain ``trace_ref`` stays held to the JAX package
by ``tests/test_torch_dp.py``. Everything is integers: exact equality.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import plan as plan_mod
from dipgenie_tpu_torch.ops import trace
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import (
    K2_GRID_CPU, K2_PER_BLOCK_MAX, K2_SLICE_LANES, K2_SLICE_PAIRS, PAD_SC,
    TRACE_COLS, TRACE_FLAGS, DevPlan, PlanLimit, balanced_cuts, chunk_bounds,
    plan_pairs, plan_to_device, wide_slices,
)
from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

R = 18


@pytest.fixture(scope="module")
def plan():
    """Two MHC-shaped bands (NB 18): narrow runs with 256- and 1024-class
    blocks, dense wide runs, and a band end whose last transition sends
    1,089 pairs into one destination (phase C's plan reaches 2,304)."""
    return plan_pairs(*mhc_shaped_csr(L=800, seed=10, n_bands=2), R)


def descriptors_before(dplan, bps) -> np.ndarray:
    """[L - 1, 11] int64: per transition the address of its bp block, the
    block's lane count, its element size, the addresses of its table, w1
    and symd rows at the transition's first chunk, the dense flag, bin and
    bout, the block's class and the rows of the bp array from the block on
    (the host table the first K-T read)."""
    def addr(t, rows):
        return t.data_ptr() + rows.astype(np.int64) * (
            t.stride(0) * t.element_size())

    desc = np.zeros((max(dplan.L - 1, 0), 11), np.int64)
    for seg, bp in zip(dplan.segments, bps):
        h = seg.host
        d = desc[h.t0:h.t1]
        T = h.t1 - h.t0
        if seg.kind == "narrow":
            wide_bp = (h.tb_bits & 2) != 0
            d[:, 0] = np.where(wide_bp, addr(bp[1], h.tb_bprow),
                               addr(bp[0], h.tb_bprow))
            d[:, 1] = np.where(wide_bp, bp[1].shape[2], bp[0].shape[2])
            d[:, 9] = wide_bp
            d[:, 10] = np.where(wide_bp, bp[1].shape[0], bp[0].shape[0]) \
                - h.tb_bprow
            cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
        elif seg.kind == "wide_split":
            d[:, 0] = addr(bp[0], h.tb_bprow)
            d[:, 9] = 1
            d[:, 10] = bp[0].shape[0] - h.tb_bprow
            cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
        else:
            d[:, 0] = addr(bp[0], np.arange(T))
            d[:, 9] = 1
            d[:, 10] = T - np.arange(T)
            if seg.kind == "wide_tp":
                cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
            else:
                cb, names, d[:, 6] = (h.tb2_chunkbase,
                                      ("dtbl", "dw1", "dsymd"), 1)
        if seg.kind != "narrow":
            d[:, 1] = bp[0].shape[2]
        d[:, 2] = bp[0].element_size()
        for col, name in zip((3, 4, 5), names):
            d[:, col] = addr(seg.t[name], cb)
        d[:, 7] = h.tb_bin
        d[:, 8] = h.tb_bout
    return desc


def descriptors_now(dplan, bps) -> np.ndarray:
    """The same table from the shipped columns and one address row per
    segment, as csrc/trace.cu forms each address."""
    base = np.array([[b[0].data_ptr(), b[-1].data_ptr(),
                      *(t.data_ptr() for t in trace._walk_tables(seg))]
                     for seg, b in zip(dplan.segments, bps)], np.int64)
    c = dict(zip(TRACE_COLS, dplan.desc.numpy().astype(np.int64).T))
    flag = {k: (c["flags"] & v) != 0 for k, v in TRACE_FLAGS.items()}
    b = base[c["seg"]]
    esize = np.where(flag["bp16"], 2, 4)
    bp = np.where(flag["bp1"], b[:, 1], b[:, 0]) \
        + c["bprow"] * (dplan.R + 1) * c["lanes"] * esize
    cb = c["chunkbase"]
    return np.stack([bp, c["lanes"], esize, b[:, 2] + cb * 2048,
                     b[:, 3] + cb * 256, b[:, 4] + cb * 512, flag["dense"],
                     c["bins"] & 0xFFFF, c["bins"] >> 16, flag["rowstep"],
                     c["rows"]], 1)


@pytest.mark.parametrize("routing", ["main", "window_split", "tp"])
def test_shipped_columns_give_the_host_descriptors(plan, routing):
    """Narrow 256- and 1024-class blocks with dense wide runs (the main
    path's routing), window-split runs (K3 over every wide run), and
    ``wide_tp`` runs (rank 0 of a 2-rank mesh): the backpointers are the
    forward pass's own, so their shapes are the ones the kernels make."""
    if routing == "tp":
        dplan = plan_to_device(plan, "cpu",
                               mesh=types.SimpleNamespace(n_tp=2, tp_rank=0))
        bps = [(torch.zeros(trace._bp_shapes(s, R + 1)[0], dtype=torch.int32),)
               if s.kind == "wide_tp" else
               tuple(torch.zeros(sh, dtype=torch.int16)
                     for sh in trace._bp_shapes(s, R + 1))
               for s in dplan.segments]
    else:
        dplan = plan_to_device(plan, "cpu",
                               dense_nb_max=18 if routing == "main" else 0)
        bps = PairDiploidDP(dplan, "cpu").forward()[1]
    kinds = {s.kind for s in dplan.segments}
    assert kinds == {"narrow", {"main": "wide", "window_split": "wide_split",
                                "tp": "wide_tp"}[routing]}
    classes = set(dplan.desc.numpy()[:, TRACE_COLS.index("lanes")])
    assert {256, 1024} <= classes
    for seg, b in zip(dplan.segments, bps):
        assert [tuple(x.shape) for x in b] == trace._bp_shapes(seg, R + 1)
    assert dplan.desc.dtype == torch.int32
    assert dplan.desc.shape == (plan.L - 1, len(TRACE_COLS))
    np.testing.assert_array_equal(descriptors_now(dplan, bps),
                                  descriptors_before(dplan, bps))

    # a plan of the first segments (as chip_smoke.py's prefixes) has the
    # first rows
    sub = dataclasses.replace(dplan, L=dplan.segments[2].t1 + 1,
                              segments=dplan.segments[:3])
    assert torch.equal(sub.desc, dplan.desc[:sub.L - 1])
    by_hand = DevPlan(R=R, L=sub.L, device=sub.device,
                      segments=sub.segments)
    assert torch.equal(by_hand.desc, sub.desc)


def test_shipped_chunk_counts_hold_each_transitions_pairs(plan):
    """``nch`` (the chunks the walk may stage) covers every real pair of
    the transition and no chunk of the next one."""
    dplan = plan_to_device(plan, "cpu")
    c = dict(zip(TRACE_COLS, dplan.desc.numpy().T))
    for seg in dplan.segments:
        h = seg.host
        tbl = h.dtbl if seg.kind == "wide" else h.tbl
        for ti in range(h.t1 - h.t0):
            t = h.t0 + ti
            words = tbl[c["chunkbase"][t]:c["chunkbase"][t] + c["nch"][t]]
            if seg.kind == "wide":
                n = int((words[:, 1] != PAD_SC).sum())
            else:
                n = int((((words[:, 0] >> 2) & 2047) != 0).sum())
            assert n > 0 and (c["nch"][t] - 1) * 256 < n <= c["nch"][t] * 256


def _slice_pairs(h, desc, cuts, ti):
    """The destinations of transition ti's real pairs and each slice's
    pair range [start, end) in them."""
    c0, n = (int(x) for x in desc[ti])
    dst = (h.dtbl[c0:c0 + -(-n // 256), 0].ravel()[:n] >> 2) & 32767
    return dst, np.searchsorted(dst, cuts[ti].astype(np.int64))


@pytest.mark.parametrize("grid", [None, 8])
def test_wide_slices_cover_each_destination_once(plan, grid):
    """Per dense wide transition, for the grid a CPU plan gets and for a
    grid of 8 blocks (3 slices a block at NB 18): the lane slices partition
    [0, W) into runs of at most K2_SLICE_LANES lanes and K2_SLICE_PAIRS
    pairs, balanced by work (a lane and its pairs); W covers the lanes the
    plain version leaves non-NEG in this transition's buffer; each slice's
    pair range, as the kernel's search finds it, is the destination-sorted
    range of its lanes in ``dtbl``; the band end's 1,089-pair destination
    lies in one slice."""
    dplan = plan_to_device(plan, "cpu")
    wides = [s for s in dplan.segments if s.kind == "wide"]
    assert len(wides) == 2
    longest = 0
    for seg in wides:
        h = seg.host
        T = h.t1 - h.t0
        if grid is None:
            G, m = seg.k2_grid, seg.k2_per_block
            desc, cuts = seg.k2_desc.numpy(), seg.k2_cuts.numpy()
            assert (G, m) == (K2_GRID_CPU, 1)
        else:
            G = grid
            desc, cuts, m = wide_slices(h, seg.nreal, G)
            assert m == -(-h.NB * 1024 // (G * K2_SLICE_LANES)) == 3
        S = G * m
        assert desc.shape == (T, 2) and desc.dtype == np.int32
        assert cuts.shape == (T, S + 1) and cuts.dtype == np.int16
        bounds = chunk_bounds(h.tb2_chunkbase, seg.nreal)
        ext = h.tb_bout.astype(np.int64) ** 2
        for ti in range(T):
            assert desc[ti, 0] == bounds[ti]
            words = h.dtbl[bounds[ti]:bounds[ti + 1]]
            real = words[:, 1].ravel() != PAD_SC
            n = int(desc[ti, 1])
            assert n == real.sum() and real[:n].all()
            dst, pair_cuts = _slice_pairs(h, desc, cuts, ti)
            W = int(cuts[ti, -1])
            assert W == (h.NB * 1024 if ti < 2
                         else max(ext[ti], ext[ti - 2]))
            assert dst.max(initial=0) < W <= h.NB * 1024
            lane_cuts = cuts[ti].astype(np.int64)
            assert lane_cuts[0] == 0
            widths = np.diff(lane_cuts)
            assert widths.min() >= 0 and widths.max() <= K2_SLICE_LANES
            assert np.diff(pair_cuts).max() <= K2_SLICE_PAIRS
            lanes = np.concatenate([np.arange(a, b) for a, b in
                                    zip(lane_cuts[:-1], lane_cuts[1:])])
            np.testing.assert_array_equal(lanes, np.arange(W))
            assert pair_cuts[0] == 0 and pair_cuts[-1] == n
            work = np.bincount(dst, minlength=W) + 1
            for k in range(S):
                lo, hi = lane_cuts[k], lane_cuts[k + 1]
                mine = np.flatnonzero((dst >= lo) & (dst < hi))
                np.testing.assert_array_equal(
                    mine, np.arange(pair_cuts[k], pair_cuts[k + 1]))
                assert work[lo:hi].sum() <= work.sum() / S + work.max()
            if n:
                longest = max(longest, np.unique(dst, return_counts=True)[1]
                              .max())
    assert longest > 1000


def test_wide_slices_keep_each_slice_within_the_pair_cap(plan, monkeypatch):
    """Where the slices a block needs for the lanes leave a slice of more
    pairs than the kernel holds, the run gets more slices a block; a
    destination of more pairs than a slice holds, or a grid too small for
    the run even at K2_PER_BLOCK_MAX slices a block, is refused."""
    seg = next(s for s in plan.segments if type(s).__name__ == "_WideRun")
    nreal = int(np.count_nonzero(seg.dbits & 4))
    lanes_only = -(-seg.NB * 1024 // (2 * K2_SLICE_LANES))  # 9
    desc, cuts, m = wide_slices(seg, nreal, 2)
    assert m == lanes_only
    most = max(np.diff(_slice_pairs(seg, desc, cuts, ti)[1]).max()
               for ti in range(len(desc)))
    assert most > 1200
    monkeypatch.setattr(plan_mod, "K2_SLICE_PAIRS", 1200)
    desc, cuts, m = wide_slices(seg, nreal, 2)
    assert lanes_only < m <= K2_PER_BLOCK_MAX and cuts.shape[1] == 2 * m + 1
    for ti in range(len(desc)):
        assert np.diff(_slice_pairs(seg, desc, cuts, ti)[1]).max() <= 1200
    monkeypatch.setattr(plan_mod, "K2_SLICE_PAIRS", 1000)
    with pytest.raises(PlanLimit, match="a destination of 1089 pairs"):
        wide_slices(seg, nreal, 2)
    monkeypatch.setattr(plan_mod, "K2_SLICE_PAIRS", K2_SLICE_PAIRS)
    with pytest.raises(PlanLimit, match="grid of 1"):
        wide_slices(seg, nreal, 1)


@pytest.mark.parametrize("W", [1, 300, 18432, 31744])
def test_balanced_cuts_respect_the_width_cap(W):
    """Work piled on a few lanes still leaves no slice wider than the cap,
    and the cuts cover every lane once."""
    work = np.ones(W, np.int64)
    work[:min(W, 40)] += 5000
    cuts = balanced_cuts(work, K2_GRID_CPU, K2_SLICE_LANES)
    assert cuts[0] == 0 and cuts[-1] == W
    assert np.diff(cuts).min() >= 0
    assert np.diff(cuts).max() <= K2_SLICE_LANES


def test_wide_slices_refuse_unsorted_pairs(plan):
    """K2 walks each destination's pairs as one range: a dense table whose
    pairs are not sorted by destination is refused when it is shipped."""
    seg = next(s for s in plan.segments if type(s).__name__ == "_WideRun")
    bad = dataclasses.replace(seg, dtbl=seg.dtbl.copy())
    row = bad.dtbl[bad.tb2_chunkbase[1], 0]
    j = int(np.flatnonzero(np.diff((row >> 2) & 32767))[0])
    row[j:j + 2] = row[j + 1:j - 1 if j else None:-1]
    with pytest.raises(ValueError, match="not sorted"):
        plan_to_device(dataclasses.replace(plan, segments=[bad]), "cpu")
