"""dipgenie_tpu_torch K2 (dense wide runs) against the JAX package's
``_wide_dense_kernel`` (Pallas, interpret mode on the CPU).

As in test_torch_narrow.py: the JAX plan and the port's plan are asserted
equal, each side runs on its own plan from the same input state, the
plain PyTorch version runs on CPU tensors, and the tolerance is exact
equality (integers) of V over rows 0..R and the live extent and of
backpointers at reachable states. The wide runs of more than 18 windows,
which go to K3, are in test_torch_wide_split.py.
"""

import numpy as np
import pytest
import torch

from dipgenie_tpu.solver.diploid import (
    _forward_exact, build_color_masks, csr_arrays,
)
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import _WideRun, plan_pairs, plan_to_device
from dipgenie_tpu_torch.ops.wide import wide_dense_run
from tests.test_pallas_dp import _dense_graph, _hand_graph
from tests.test_torch_narrow import (
    case_csr, jax_segments, plans, reach_masks,
)

WIDE_CASES = ([(400 + s, 10, 40, 4, 8) for s in range(3)]
              + [(500 + s, 14, 36, 6, 9) for s in range(2)])


def _stale_window_graph():
    """tests/test_pallas_dp.py:158: a shrinking destination extent."""
    W = 40
    starts = np.cumsum([0, 1, W, W, W])
    edges = [
        [(0, i, 0) for i in range(W)],
        [(i, i, 0) for i in range(25)],
        [(i, i, 0) for i in range(W)],
        [(i, 0, 0) for i in range(W)],
    ]
    colors = {int(starts[2] + 30): [0], int(starts[3] + 30): [0]}
    return _hand_graph([1, W, W, W, 1], edges, colors), [True], 0


def _hole_window_graph():
    """tests/test_pallas_dp.py:187: a destination-window hole."""
    W = 56
    lo, hi = list(range(18)), list(range(37, W))
    edges = [
        [(0, i, 0) for i in range(W)],
        [(i, i, 0) for i in lo + hi],
        [(i, 0, 0) for i in range(W)],
    ]
    g = _hand_graph([1, W, W, 1], edges, {1 + 5: [0], 1 + W + 5: [0]})
    return g, [True], 0


def _int16_overflow_graph():
    """tests/test_pallas_dp.py:104: narrow widths with > 2^15 kept pairs,
    routed to the wide path."""
    rng = np.random.default_rng(7)
    g = _dense_graph(rng, [1, 16, 16, 16, 1], deg=13, pw=0.1)
    return g, [bool(x) for x in rng.random(6) < 0.5], 3


HAND = {"stale_window": _stale_window_graph, "hole_window": _hole_window_graph,
        "int16_overflow": _int16_overflow_graph}


def _csr_of(case):
    if case in HAND:
        g, chb, R = HAND[case]()
        return list(csr_arrays(g, chb)), R
    return case_csr(case)


@pytest.mark.parametrize(
    "case", WIDE_CASES + list(HAND) + ["mhc_slice_wide_csr"])
def test_wide_dense_run_matches_jax_kernel(case):
    arrs, R = _csr_of(case)
    R1 = R + 1
    widths = np.diff(arrs[0])
    jplan, plan = plans(arrs, R)
    dplan = plan_to_device(plan, "cpu")
    reach = np.zeros((R1, 1024), bool)
    reach[:, 0] = True
    n_wide = 0
    for i, seg, v_in, out in jax_segments(jplan):
        masks, reach_next = reach_masks(seg, reach, R1)
        if type(seg).__name__ == "_WideRun":
            n_wide += 1
            jbp, jv = out
            V, pbp = wide_dense_run(
                dplan.segments[i], torch.from_numpy(v_in[:R1].copy()))
            ext = int(widths[seg.t1]) ** 2
            assert np.array_equal(V.numpy()[:, :ext], jv[:R1, :ext])
            assert np.array_equal(V.numpy()[:, :ext] > -(2**18),
                                  reach_next[:, :ext])
            for ti, m in enumerate(masks):
                assert np.array_equal(jbp[ti, :R1][m], pbp.numpy()[ti][m]), ti
        reach = reach_next
    assert n_wide


def test_big_window_run_matches_exact_tier():
    """tests/test_pallas_dp.py:119: width 140 needs 31 windows. The main
    path sends the run to K3, as the JAX package does; K2 runs it too when
    asked to (``dense_nb_max=31``). Both equal the exact tier."""
    rng = np.random.default_rng(11)
    g = _dense_graph(rng, [1, 140, 140, 1], deg=2, pw=0.2)
    chb = [bool(x) for x in rng.random(6) < 0.5]
    plan = plan_pairs(*csr_arrays(g, chb), 2)
    assert plan.segments[0].NB > 18
    Hm, Tm = build_color_masks(g, chb)
    want = _forward_exact(g, 2, Hm, Tm)
    for nb_max, kind in ((18, "wide_split"), (31, "wide")):
        dplan = plan_to_device(plan, "cpu", dense_nb_max=nb_max)
        assert [s.kind for s in dplan.segments] == [kind]
        assert PairDiploidDP(dplan, "cpu").run() == want


def test_dense_pad_tail_on_lane_zero_matches_exact_tier():
    """A dense wide transition whose pairs all land on destination lane 0
    (here into the width-1 sink) with a partial last chunk: the unique
    best pair (39, 39) is the last real lane before the pad tail. The
    port must keep it (exact value 2)."""
    W = 40
    edges = [[(0, i, 0) for i in range(W)], [(i, 0, 0) for i in range(W)]]
    colors = {v: [0] for v in [0, 1 + W] + list(range(1, W))}
    g = _hand_graph([1, W, 1], edges, colors)
    chb = [False]
    plan = plan_pairs(*csr_arrays(g, chb), 0)
    assert [type(s) for s in plan.segments] == [_WideRun]
    Hm, Tm = build_color_masks(g, chb)
    want = _forward_exact(g, 0, Hm, Tm)
    assert want[0] == 2
    assert PairDiploidDP(plan, "cpu").run() == want
