"""dipgenie_tpu_torch K3 (window-split wide runs) against the JAX package's
``_wide_split_kernel`` (Pallas, interpret mode on the CPU), and the
big-window slice as a whole.

Every wide run has window-split tables, so both sides run every wide run
of the corpus through the split kernel, whatever its NB: the JAX plan
through ``_wide_split_call``, the port's (asserted equal to it) through
``wide_split_run`` with ``dense_nb_max=0``. Same input state on both
sides, exact equality (integers) of V over rows 0..R and the live extent,
and of backpointers at reachable states (the JAX kernel never writes the
rows of hole windows). The whole DP on a width-140 graph (NB 31) equals
the JAX Pallas tier and the exact tier; on a width-177 graph (the widest
the planner takes) it equals the exact tier.
"""

import numpy as np
import pytest
import torch

from dipgenie_tpu.ops.diploid_pallas import PairDiploidDP as JaxPairDiploidDP
from dipgenie_tpu.solver.diploid import (
    _forward_exact, build_color_masks, csr_arrays,
)
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import plan_to_device
from dipgenie_tpu_torch.ops.wide_split import ext_windows, wide_split_run
from tests.test_pallas_dp import _dense_graph
from tests.test_torch_narrow import jax_segments, plans, reach_masks
from tests.test_torch_wide import HAND, WIDE_CASES, _csr_of


def _dense(width):
    """tests/test_pallas_dp.py:119 at ``width``: (graph, colour split)."""
    rng = np.random.default_rng(11)
    g = _dense_graph(rng, [1, width, width, 1], deg=2, pw=0.2)
    return g, [bool(x) for x in rng.random(6) < 0.5]


@pytest.mark.parametrize(
    "case", WIDE_CASES + list(HAND) + ["mhc_slice_wide_csr", "width140"])
def test_wide_split_run_matches_jax_kernel(case):
    if case == "width140":
        g, chb = _dense(140)
        arrs, R = list(csr_arrays(g, chb)), 2
    else:
        arrs, R = _csr_of(case)
    R1 = R + 1
    widths = np.diff(arrs[0])
    jplan, plan = plans(arrs, R)
    dplan = plan_to_device(plan, "cpu", dense_nb_max=0)
    reach = np.zeros((R1, 1024), bool)
    reach[:, 0] = True
    n_wide = 0
    for i, seg, v_in, out in jax_segments(jplan, split=True):
        masks, reach_next = reach_masks(seg, reach, R1)
        if type(seg).__name__ == "_WideRun":
            n_wide += 1
            dseg = dplan.segments[i]
            assert dseg.kind == "wide_split"
            jbp, jv = out
            V, pbp = wide_split_run(dseg, torch.from_numpy(v_in[:R1].copy()))
            ext = int(widths[seg.t1]) ** 2
            assert np.array_equal(V.numpy()[:, :ext], jv[:R1, :ext])
            assert np.array_equal(V.numpy()[:, :ext] > -(2**18),
                                  reach_next[:, :ext])
            for ti, (m, nw) in enumerate(zip(masks, ext_windows(seg))):
                for w in range(nw):
                    row = int(seg.tb_bprow[ti]) + w
                    mw = m[:, w * 1024:(w + 1) * 1024]
                    assert np.array_equal(jbp[row, :R1][mw],
                                          pbp.numpy()[row][mw]), (ti, w)
                assert not m[:, nw * 1024:].any()
        reach = reach_next
    assert n_wide


def test_big_window_dp_matches_jax_tier_and_exact_tier():
    """Width 140: the main path sends the NB 31 run to K3, as the JAX
    package does, and the whole DP (forward, traceback, assembly) equals
    the JAX Pallas tier and the exact tier."""
    g, chb = _dense(140)
    jplan, plan = plans(csr_arrays(g, chb), 2)
    dplan = plan_to_device(plan, "cpu")
    assert [(s.kind, s.host.NB) for s in dplan.segments] == [("wide_split", 31)]
    got = PairDiploidDP(dplan, "cpu").run()
    Hm, Tm = build_color_masks(g, chb)
    assert got == _forward_exact(g, 2, Hm, Tm)
    assert got == JaxPairDiploidDP(jplan, interpret=True).run()


def test_widest_window_dp_matches_exact_tier():
    """Width 177, the widest level the planner takes (NB 31): K3 and the
    traceback's row-stepped lanes (up to 31,328) against the exact tier."""
    g, chb = _dense(177)
    _, plan = plans(csr_arrays(g, chb), 2)
    dplan = plan_to_device(plan, "cpu")
    assert [(s.kind, s.host.NB) for s in dplan.segments] == [("wide_split", 31)]
    Hm, Tm = build_color_masks(g, chb)
    assert PairDiploidDP(dplan, "cpu").run() == _forward_exact(g, 2, Hm, Tm)
