"""The plain reference equals the program's exact and native tiers:
``sink_value``, ``s_het`` and ``transitions``; its judge passes their
answers and fails the control's."""

import numpy as np
import pytest

import inputs
import reference
from dipgenie_tpu_torch import native
from dipgenie_tpu_torch.solver import diploid
from dipgenie_tpu_torch.utils import synth


def exact(csr, R):
    g, chb = synth.graph_from_csr(csr)
    Hm, Tm = diploid.build_color_masks(g, chb)
    return diploid._forward_exact(g, R, Hm, Tm)


def reachable(csr, R):
    """The exact tier's answer; the instance is skipped where its sink is
    unreachable at row R (the reference wants a reachable sink)."""
    out = exact(csr, R)
    assert out[0] >= 0, "an instance with an unreachable sink"
    return out


# (seed, L, kmax, ncolors) of synth.random_leveled_csr: weights 0 / 1 (30%
# weigh 1), 0-3 colours a vertex, so ties are everywhere; R from 1 to 18
RANDOM = [((s, L, k, nc), R) for (s, L, k, nc), R in zip(
    [(0, 12, 5, 8), (1, 14, 6, 8), (2, 10, 8, 4), (3, 16, 5, 70),
     (4, 9, 9, 130), (5, 20, 4, 6), (6, 12, 7, 10), (7, 18, 3, 3)],
    [5, 1, 3, 18, 9, 7, 13, 18])]
MHC = [(seed, dict(L=L, n_bands=nb, band_len=bl, wmin=a, wmax=b))
       for seed, L, nb, bl, a, b in [(0, 200, 2, 6, 33, 40),
                                     (5, 150, 1, 4, 60, 70),
                                     (2**31 + 11, 300, 0, 1, 1, 1)]]


def check_equal(csr, R, want):
    ref = reference.forward(csr, R, "cpu")
    got = reference.solve(ref)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    j = reference.judge(ref, *want)
    assert (j["sink_off"], j["s_het_off"], j["steps_off"]) == (0, 0, 0)
    assert j["path_s_het"] == want[1]
    return ref


@pytest.mark.parametrize("case", RANDOM)
def test_reference_equals_exact_on_random_graphs(case):
    args, R = case
    csr = synth.random_leveled_csr(*args)
    check_equal(csr, R, reachable(csr, R))


@pytest.mark.parametrize("case", MHC)
def test_reference_equals_exact_on_mhc_shaped_graphs(case):
    seed, kw = case
    csr = inputs.mhc_shaped_csr(seed=seed, **kw)
    check_equal(csr, 18, reachable(csr, 18))


def test_reference_equals_native_on_a_longer_graph():
    if not native.available():
        pytest.skip("the native tier did not build here")
    csr = inputs.mhc_shaped_csr(seed=3, L=3000, n_bands=6, band_len=12)
    check_equal(csr, 18, diploid.native_forward_csr(csr, 18))


@pytest.mark.parametrize("case", RANDOM[:4] + [(None, MHC[0])])
def test_judge_fails_the_control(case):
    """The control (the reference letting the latest candidate win) is
    not correct: its path departs from the earliest-wins path."""
    if case[0] is None:
        seed, kw = case[1]
        csr, R = inputs.mhc_shaped_csr(seed=seed, **kw), 18
    else:
        csr, R = synth.random_leveled_csr(*case[0]), case[1]
    ref = reference.forward(csr, R, "cpu")
    ctl = reference.solve(reference.forward(csr, R, "cpu", latest=True))
    assert ctl[0] == ref.sink_key() >> 32  # the same best value
    assert reference.judge(ref, *ctl)["steps_off"] > 0


def test_judge_counts_departures():
    csr = synth.random_leveled_csr(0, 12, 5, 8)
    want = exact(csr, 5)
    ref = reference.forward(csr, 5, "cpu")
    bad = list(want[2])
    lv, pi, pj, i2, j2, wu, wv = bad[4]
    bad[4] = (lv, pi, pj, i2, j2, 1 - wu, wv)
    j = reference.judge(ref, want[0], want[1], bad)
    assert j["steps_off"] >= 1
    assert reference.judge(ref, want[0] + 1, want[1], want[2])["sink_off"]
    assert reference.judge(ref, want[0], want[1] + 1, want[2])["s_het_off"]
    assert reference.judge(ref, *want[:2], want[2][:-1])["steps_off"] > 0


def test_popcount():
    x = np.array([0, 1, -1, 2**63 - 1, -(2**63), 0x0F0F], np.int64)
    import torch
    got = reference.popcount(torch.from_numpy(x)).tolist()
    assert got == [bin(int(v) & (2**64 - 1)).count("1") for v in x]
