"""K3's and K4's slice tables (``ops/plan.py:split_slices``) and a numpy
walk over them that computes what the kernels compute, slice by slice.

The CUDA kernels (``csrc/wide_split.cuh``) run only on the card; here
their tables are held to their contract on the window-split cases of
``test_torch_wide_split.py`` (the JAX package's graphs), on two graphs
past the TPU planner's limits (R 40, a 36-window run) and on an
MHC-shaped graph whose wide levels are E's (widths 141-177, NB 31): the
slices cover ``[0, W)`` within their caps, the first two transitions
(the first one, for K4's one buffer) write the whole state, the cuts skip
the pads at window ends, a destination of more than half a slice's pairs
(a band end past level width ~150: 36,100 pairs at width 190, 45,796 at
214) is cut into parts, and E's band ends (up to 3,844) stay whole. The
walk (candidates from the slice's slots, each lane's first
maximum in slot order, the cut lanes' partial winners combined after the
barrier, the W rule over buffers that start as garbage) equals
``wide_split_run_ref`` (V and every bp row) and, on every tp rank's
share, ``wide_step_ref``: exact equality, integers.
"""

import functools

import numpy as np
import pytest
import torch

from dipgenie_tpu.solver.diploid import csr_arrays
from dipgenie_tpu_torch.ops import plan as plan_mod
from dipgenie_tpu_torch.ops.plan import (
    CHUNK, K2_GRID_CPU, K2_SLICE_LANES, K2_SLICE_PAIRS, NEG, REACH_T,
    SPLIT, PlanLimit, chunk_bounds, plan_pairs, plan_to_device,
    shard_to_device, split_slices,
)
from dipgenie_tpu_torch.ops.narrow import narrow_run_ref
from dipgenie_tpu_torch.ops.wide_split import (
    _state, ext_windows, wide_split_run_ref,
)
from dipgenie_tpu_torch.ops.wide_step import commit, wide_step_ref
from dipgenie_tpu_torch.utils.synth import (
    limit_case, mhc_shaped_csr, wide_window_graph,
)
from tests.test_torch_wide import HAND, WIDE_CASES, _csr_of
from tests.test_torch_wide_split import _dense

NONE = np.iinfo(np.int32).min
GARBAGE = 12345  # what the state buffers hold before the first write
PLAIN = {"narrow": narrow_run_ref, "wide_split": wide_split_run_ref}
CASES = WIDE_CASES + list(HAND) + ["mhc_slice_wide_csr", "width140",
                                   "R40", "width190", "width214", "e_band"]
# a destination of more pairs than this is cut over slices
HEAVY = K2_SLICE_PAIRS // 2


@functools.cache
def _plan(case):
    if case == "width140":
        g, chb = _dense(140)
        arrs, R = list(csr_arrays(g, chb)), 2
    elif case in ("R40", "width190"):
        g, chb, R = limit_case(case)
        arrs = csr_arrays(g, chb)
    elif case == "width214":  # a band end past what one slice holds
        arrs, R = csr_arrays(*wide_window_graph(214)), 2
    elif case == "e_band":  # two bands of E's widths
        arrs, R = mhc_shaped_csr(L=300, seed=0, n_bands=2, wmin=141,
                                 wmax=177), 18
    else:
        arrs, R = _csr_of(case)
    return plan_pairs(*arrs, R)


def _split_segments(case):
    """(host, device) segments of the case's wide runs, all through K3."""
    plan = _plan(case)
    dplan = plan_to_device(plan, "cpu", dense_nb_max=0)
    out = [(s, d) for s, d in zip(plan.segments, dplan.segments)
           if d.kind == "wide_split"]
    assert out
    return plan, out


def _slices(cuts):
    """(k, first lane, lanes, first slot, end slot, first cut, last cut)
    of each slice of one transition's cuts [S + 1, 2]."""
    lane = cuts[:, 0] & ~SPLIT
    cut = (cuts[:, 0] & SPLIT) != 0
    for k in range(len(cuts) - 1):
        yield (k, int(lane[k]), int(lane[k + 1] + cut[k + 1] - lane[k]),
               int(cuts[k, 1]), int(cuts[k + 1, 1]), bool(cut[k]),
               bool(cut[k + 1]))


def _real_pairs(tbl, win, c0, c1):
    """Slots and destinations of the real pairs of chunks [c0, c1)."""
    rel = ((tbl[c0:c1, 0].reshape(-1).astype(np.int64) >> 2) & 2047) - 1
    slots = np.flatnonzero(rel >= 0)
    return slots, win[c0 + slots // CHUNK].astype(np.int64) * 1024 \
        + rel[slots]


def emulate_transition(tbl, win, base, desc, cuts, src, vout, bp,
                       partial):
    """One transition as ``csrc/wide_split.cuh`` computes it: each slice's
    candidates and first maxima, a cut lane's partial winner to ``rec``,
    then the combine of the cut lanes. K3 (``partial`` False) commits to
    ``vout`` and the bp rows of ``bp [nrows, R+1, 1024]``, K4 writes the
    partial (``vout`` and ``bp`` its [R+1, lanes] planes). Returns the
    number of lanes combined."""
    c0, bprow, ext, has_split = (int(x) for x in desc)
    R1 = src.shape[0]
    S = len(cuts) - 1
    rec = np.full((S, 2, R1, 2), GARBAGE, np.int64)
    rows = np.arange(R1)

    def put(d, best, slot):  # d [n] lanes; best, slot [R1, n]
        none = best == NONE
        ords = np.zeros_like(slot)
        ords[~none] = base[c0 + (slot[~none] >> 8)] + (slot[~none] & 255)
        if partial:
            vout[:, d] = np.where(none, NEG, best)
            bp[:, d] = np.where(none, -1, ords)
            return
        vout[:, d] = np.where(best > REACH_T, best, NEG)
        low = d < ext
        d, val = d[low], np.where(none, 0, ords)[:, low]
        bp[(bprow + (d >> 10))[:, None], rows[None, :],
           (d & 1023)[:, None]] = val.T

    for k, d_lo, nd, slo, shi, fp, lp in _slices(cuts):
        p = np.arange(slo, shi)
        words = tbl[c0 + (p >> 8), :, p & 255].astype(np.int64)
        rel = ((words[:, 0] >> 2) & 2047) - 1
        real = rel >= 0  # the pads are skipped
        p, words = p[real], words[real]
        dst = win[c0 + (p >> 8)] * 1024 + rel[real]
        assert ((dst >= d_lo) & (dst < d_lo + nd)).all()
        best = np.full((R1, nd), NONE, np.int64)
        arg = np.zeros((R1, nd), np.int64)
        if len(p):
            rs = rows[:, None] - (words[:, 0] & 3)
            g = np.minimum(words[:, 0] >> 13, src.shape[1] - 1)
            c = np.where(rs >= 0, src[np.maximum(rs, 0), g], NEG)
            cand = np.where(c >= REACH_T, c + words[:, 1], NONE)
            starts = np.flatnonzero(np.r_[True, np.diff(dst) != 0])
            assert len(starts) == len(np.unique(dst))  # one run each
            low = (1 << 20) - 1
            key = (cand << 20) + low - np.arange(len(p))
            kmax = np.maximum.reduceat(key, starts, axis=1)
            at = dst[starts] - d_lo
            best[:, at] = kmax >> 20
            arg[:, at] = p[low - (kmax & low)]
        keep = np.ones(nd, bool)
        if nd and fp:
            keep[0] = False
            rec[k, 0] = np.stack([best[:, 0], arg[:, 0]], 1)
        if nd and lp and keep[-1]:
            keep[-1] = False
            rec[k, 1] = np.stack([best[:, -1], arg[:, -1]], 1)
        put(d_lo + np.flatnonzero(keep), best[:, keep], arg[:, keep])
    combined = 0
    lane = cuts[:, 0]
    for kb in range(1, S):
        a = int(lane[kb])
        if not a & SPLIT or lane[kb - 1] == a:
            continue
        combined += 1
        b = rec[kb - 1, 1].copy()
        j = kb
        while True:
            take = rec[j, 0, :, 0] > b[:, 0]
            b[take] = rec[j, 0][take]
            if lane[j + 1] != a:
                break
            j += 1
        put(np.array([a & ~SPLIT]), b[:, :1], b[:, 1:])
    assert bool(combined) == bool(has_split)
    return combined


def emulate_k3(dseg, v_in):
    """A whole run as K3 walks it, V double-buffered from garbage."""
    h = dseg.host
    R1, T = v_in.shape[0], h.t1 - h.t0
    bufs = [np.full((R1, h.NB * 1024), GARBAGE, np.int64) for _ in "01"]
    bp = np.full((h.nrows, R1, 1024), GARBAGE, np.int64)
    desc, cuts = dseg.k3_desc.numpy(), dseg.k3_cuts.numpy()
    combined = 0
    for t in range(T):
        src = v_in if t == 0 else bufs[t & 1]
        combined += emulate_transition(h.tbl, h.wwin, h.wbase, desc[t],
                                       cuts[t], src, bufs[(t + 1) & 1], bp,
                                       False)
    return bufs[T & 1][:, :1024], bp, combined


def _check_tables(h, cuts, desc, split, bounds, buffers, grid, m,
                  balanced=True):
    """The slice tables of one run's chunks (K3's, or a tp rank's share)
    against their contract; ``balanced``: no slice holds more than twice
    its share of the work (a lane and its pairs) and its heaviest lane or
    piece, as where the lane cap does not bind."""
    T = h.t1 - h.t0
    S = grid * m
    full = h.NB * 1024
    E = ext_windows(h).astype(np.int64) * 1024
    assert cuts.shape == (T, S + 1, 2) and cuts.dtype == np.int32
    assert desc is None or (desc.shape == (T, 4) and desc.dtype == np.int32)
    heavy_cuts = 0
    for ti in range(T):
        lane = cuts[ti, :, 0].astype(np.int64) & ~SPLIT
        cut = (cuts[ti, :, 0] & SPLIT) != 0
        slot = cuts[ti, :, 1].astype(np.int64)
        W = int(lane[-1])
        assert W == (full if ti < buffers
                     else max(E[ti], E[ti - buffers]))
        assert lane[0] == 0 and not cut[0] and not cut[-1]
        assert np.all(np.diff(lane) >= 0) and np.all(np.diff(slot) >= 0)
        width = np.diff(lane) + cut[1:]
        assert width.max() <= K2_SLICE_LANES
        assert np.diff(slot).max() <= K2_SLICE_PAIRS
        slots, dst = _real_pairs(h.tbl if desc is not None else h.stbl,
                                 h.wwin if desc is not None else h.swin,
                                 bounds[ti], bounds[ti + 1])
        end = slots[-1] + 1 if len(slots) else 0
        assert slot[-1] == end and slot[0] == (slots[0] if len(slots) else 0)
        # the cuts lie on real slots: the pads before a cut (a window's
        # tail) end the slice before it
        assert np.isin(slot[:-1], np.append(slots, end)).all()
        assert split[ti] == cut.any()
        # every lane of [0, W) in a slice, a cut lane in each of its parts
        covered = np.zeros(W, np.int64)
        n = len(dst)
        target = (W + n) / S
        for k, d_lo, nd, slo, shi, fp, lp in _slices(cuts[ti]):
            covered[d_lo:d_lo + nd] += 1
            mine = (slots >= slo) & (slots < shi)
            assert ((dst[mine] >= d_lo) & (dst[mine] < d_lo + nd)).all()
            per_lane = np.bincount(dst[mine] - d_lo, minlength=nd) + 1
            assert not balanced or not nd or (per_lane.sum() - fp
                                              <= 2 * target + per_lane.max())
        counts = np.bincount(dst, minlength=W)
        parts = np.bincount(lane[1:-1][cut[1:-1]], minlength=W)
        np.testing.assert_array_equal(covered, 1 + parts)
        heavy_cuts += int(cut.sum())
        assert (counts[parts > 0] > HEAVY).all()  # only heavy lanes cut
        assert not ((counts > HEAVY) & (parts == 0)).any()
        if desc is not None:
            assert tuple(desc[ti]) == (bounds[ti], h.tb_bprow[ti], E[ti],
                                       split[ti])
    return heavy_cuts


@pytest.mark.parametrize("grid", [None, 8])
@pytest.mark.parametrize("case", CASES)
def test_split_slices_cover_each_lane_within_the_caps(case, grid):
    """K3's tables on every window-split run: for the grid a CPU plan
    gets (132) and for a grid of 8 (4 slices a block at NB 31)."""
    _, segs = _split_segments(case)
    for h, dseg in segs:
        bounds = chunk_bounds(h.tb_chunkbase, dseg.nreal)
        if grid is None:
            G, m = dseg.k3_grid, dseg.k3_per_block
            cuts, desc = dseg.k3_cuts.numpy(), dseg.k3_desc.numpy()
            assert G == K2_GRID_CPU
            split = desc[:, 3].astype(bool)
        else:
            G = grid
            cuts, split, m = split_slices(h.tbl, h.wwin, bounds,
                                          ext_windows(h), h.NB * 1024, G, 2)
            cuts = cuts.numpy()
            assert m == -(-h.NB * 1024 // (G * K2_SLICE_LANES))
            desc = np.stack([bounds[:-1], h.tb_bprow,
                             ext_windows(h) * 1024, split], 1)
        _check_tables(h, cuts, desc, split, bounds, 2, G, m,
                      balanced=grid is None)


@pytest.mark.parametrize("n_tp", [1, 2, 3])
@pytest.mark.parametrize("case", ["mhc_slice_wide_csr", "width140",
                                  "width190", "width214", "e_band"])
def test_split_slices_of_tp_shares(case, n_tp):
    """K4's tables on each rank's share: the same contract over the
    rank's chunks, with one partial buffer (W from the transition
    before)."""
    plan, segs = _split_segments(case)
    for h, _ in segs:
        for d in range(n_tp):
            ds = shard_to_device(h, n_tp, d, "cpu")
            split = ds.k3_desc.numpy()[:, 3].astype(bool)
            assert (ds.k3_desc.numpy()[:, 0] == ds.bounds[:-1]).all()
            host = type("Share", (), {"stbl": ds.t["stbl"].numpy(),
                                      "swin": ds.t["swin"].numpy(),
                                      **{k: getattr(h, k) for k in (
                                          "t0", "t1", "NB", "tb_bprow",
                                          "nrows")}})
            _check_tables(host, ds.k3_cuts.numpy(), None, split,
                          ds.bounds, 1, ds.k3_grid, ds.k3_per_block)


def test_band_end_heavy_destination_is_cut_into_parts():
    """Past level width ~150 a band end (a wide level into one vertex)
    puts a whole level's pairs on one destination: 45,796 at width 214,
    more than a slice holds. That destination spans several slices whose
    slot ranges are consecutive parts of its pairs, none more than a
    share and a piece (half a share); the run's other transitions cut
    nothing."""
    _, segs = _split_segments("width214")
    h, dseg = segs[0]
    b = chunk_bounds(h.tb_chunkbase, dseg.nreal)
    T = h.t1 - h.t0
    cuts, split = dseg.k3_cuts.numpy(), dseg.k3_desc.numpy()[:, 3]
    assert split[-1] and not split[:-1].any()
    slots, dst = _real_pairs(h.tbl, h.wwin, b[T - 1], b[T])
    counts = np.bincount(dst)
    heavy = int(np.argmax(counts))
    assert counts[heavy] == 45796 > K2_SLICE_PAIRS
    target = (int(cuts[-1, -1, 0]) + len(dst)) / (len(cuts[-1]) - 1)
    parts = [((slots >= a) & (slots < z)).sum()
             for k, d_lo, nd, a, z, fp, lp in _slices(cuts[-1])
             if d_lo <= heavy < d_lo + nd]
    assert sum(parts) == counts[heavy] and len(parts) >= 2
    assert max(parts) <= 1.5 * target + 2  # a share and a piece


def test_band_end_heavy_destination_sits_in_one_slice():
    """A destination of at most half a slice's pairs is never cut: on
    every transition of E's bands the heaviest destination lies whole in
    one slice, and on the band ends (wide into narrow: ~40k pairs on
    fewer than 1,024 destinations) the second band's 3,844-pair
    destination (E's largest) takes a slice past the kernels' staging of
    2,560 slots (csrc/coop.cuh STAGE: that slice's words are read from
    the table); no transition of E's bands has a cut."""
    _, segs = _split_segments("e_band")
    biggest = most = 0
    for h, dseg in segs:
        cuts = dseg.k3_cuts.numpy()
        assert not dseg.k3_desc.numpy()[:, 3].any()
        assert not (cuts[:, :, 0] & SPLIT).any()
        T = h.t1 - h.t0
        b = chunk_bounds(h.tb_chunkbase, dseg.nreal)
        for ti in range(T):
            slots, dst = _real_pairs(h.tbl, h.wwin, b[ti], b[ti + 1])
            counts = np.bincount(dst)
            heavy = int(np.argmax(counts))
            (slo, shi), = [(a, z) for k, d_lo, nd, a, z, fp, lp
                           in _slices(cuts[ti]) if d_lo <= heavy < d_lo + nd]
            mine = slots[dst == heavy]
            assert slo <= mine.min() and mine.max() < shi
            assert shi - slo >= counts.max()
            if ti == T - 1:
                biggest = max(biggest, int(counts.max()))
                most = max(most, shi - slo)
    assert biggest == 3844 and most >= 3844 > 2560


@pytest.mark.parametrize("case", CASES)
def test_sliced_walk_matches_plain_version(case):
    """The walk over K3's slices equals ``wide_split_run_ref`` from the
    DP's own input state and from a drawn one (ties, values at REACH_T):
    V and every bp row, exactly; the state buffers start as garbage, so a
    lane the W rule leaves unwritten and later read would show."""
    plan, segs = _split_segments(case)
    dplan = plan_to_device(plan, "cpu", dense_nb_max=0)
    R1 = plan.R + 1
    rng = np.random.default_rng(3)
    V = torch.full((R1, 1024), NEG, dtype=torch.int32)
    V[:, 0] = 0
    combined = 0
    for dseg in dplan.segments:
        if dseg.kind == "wide_split":
            drawn = torch.from_numpy(rng.choice(
                (NEG, REACH_T - 1, REACH_T, REACH_T + 1, 0, 1, 2),
                size=(R1, 1024)).astype(np.int32))
            for v in (V, drawn):
                want_v, want_bp = wide_split_run_ref(dseg, v)
                got_v, got_bp, n = emulate_k3(dseg, v.numpy())
                np.testing.assert_array_equal(got_v, want_v.numpy())
                np.testing.assert_array_equal(got_bp, want_bp.numpy())
                combined += n
        V = PLAIN[dseg.kind](dseg, V)[0]
    assert (combined > 0) == (case in ("width190", "width214"))


@pytest.mark.parametrize("case", ["mhc_slice_wide_csr", "hole_window",
                                  "width140", "R40", "width190", "width214",
                                  "e_band"])
def test_sliced_tp_walk_matches_plain_version(case):
    """K4's walk on every rank's share for n_tp 1-3: each standalone
    partial (written into NEG / -1) equals ``wide_step_ref``, and the run
    with one partial buffer that starts as garbage, merged by a max over
    the ranks and committed, gives the plain path's state and bp blocks."""
    plan, segs = _split_segments(case)
    dplan = plan_to_device(plan, "cpu", dense_nb_max=0)
    R1 = plan.R + 1
    V = torch.full((R1, 1024), NEG, dtype=torch.int32)
    V[:, 0] = 0
    for h, dseg in zip(plan.segments, dplan.segments):
        if dseg.kind == "wide_split":
            for n_tp in (1, 2, 3):
                shares = [shard_to_device(h, n_tp, d, "cpu")
                          for d in range(n_tp)]
                W = _state(shares[0], V)
                Wp = W.clone()
                buf = np.full((2, R1, h.NB * 1024), GARBAGE, np.int64)
                for ti in range(h.t1 - h.t0):
                    plain, walked = [], []
                    for ds in shares:
                        args = (ds.t["stbl"].numpy(), ds.t["swin"].numpy(),
                                ds.t["sbase"].numpy(),
                                ds.k3_desc.numpy()[ti],
                                ds.k3_cuts.numpy()[ti])
                        want = wide_step_ref(ds, ti, W)
                        fresh = np.stack([np.full(W.shape, NEG),
                                          np.full(W.shape, -1)])
                        emulate_transition(*args, W.numpy(), fresh[0],
                                           fresh[1], True)
                        np.testing.assert_array_equal(fresh, want.numpy())
                        part = buf.copy()
                        emulate_transition(*args, Wp.numpy(), part[0],
                                           part[1], True)
                        plain.append(want)
                        walked.append(part)
                    present = shares[0].t["present"][ti]
                    bp_w = torch.empty(W.shape, dtype=torch.int32)
                    bp_p = torch.empty(W.shape, dtype=torch.int32)
                    W = commit(torch.stack(plain).amax(dim=0), present, bp_p)
                    buf = np.max(walked, axis=0)
                    Wp = commit(torch.from_numpy(buf.astype(np.int32)),
                                present, bp_w)
                    assert torch.equal(Wp, W) and torch.equal(bp_w, bp_p)
        V = PLAIN[dseg.kind](dseg, V)[0]


def test_split_slices_refuse_unsorted_pairs_and_tight_caps(monkeypatch):
    """A window-split table whose pairs do not ascend by destination is
    refused; a slot cap no slicing can keep is a PlanLimit; a tighter lane
    cap takes more slices a block."""
    _, segs = _split_segments("width140")
    h, dseg = segs[0]
    bounds = chunk_bounds(h.tb_chunkbase, dseg.nreal)
    args = (h.wwin, bounds, ext_windows(h), h.NB * 1024)
    bad = h.tbl.copy()
    row = bad[bounds[1], 0]
    j = int(np.flatnonzero(np.diff((row >> 2) & 2047) > 0)[0])
    row[j], row[j + 1] = row[j + 1], row[j]
    with pytest.raises(ValueError, match="ascend"):
        split_slices(bad, *args, 8, 2)
    monkeypatch.setattr(plan_mod, "K2_SLICE_LANES", 64)
    cuts, _, m = split_slices(h.tbl, *args, 8, 2)
    assert m == 31 * 1024 // (8 * 64) and cuts.shape[1] == 8 * m + 1
    monkeypatch.setattr(plan_mod, "K2_SLICE_PAIRS", 2)
    with pytest.raises(PlanLimit, match="slices a block"):
        split_slices(h.tbl, *args, 8, 2)
