"""The port's chunked tier over a tp mesh (``ops/chunked.py:chunk_step_tp``,
``DeviceDiploidDP(mesh=)``, ``parallel/mesh.py:sharded_dp_level_step``)
in gloo ranks on the CPU (``tests/torch_tp_ranks.py``).

A wide transition's destination pairs are split into equal shares over
the tp ranks and one all-gather puts them together; runs of narrow
transitions and the walk run on every rank. Every rank's ``(value,
s_het, transitions)`` must equal the JAX package's chunked tier over its
virtual CPU mesh (``DeviceDiploidDP(mesh=make_mesh(n_dp=1, n_tp=2))``) on
two ranks, and the exact tier and the single-rank tier on three, with
share launches asserted to have run; the plain share stitched together
must equal the plain transition. Every comparison is of integers: exact
equality."""

import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import diploid_jax as jd
from dipgenie_tpu.solver.diploid import _forward_exact, build_color_masks
from dipgenie_tpu_torch.ops import chunked, fused
from dipgenie_tpu_torch.ops.vertex_plan import (
    K2, initial_state, plan_launches, plan_vertices, ship,
)
from dipgenie_tpu_torch.solver.diploid import csr_arrays
from dipgenie_tpu_torch.utils import synth
from tests.test_torch_kernels_gpu import DATA, case_csr
from tests.test_torch_vertex_plan import random_case
from tests.torch_tp_ranks import run_ranks

CASES = ("mhc_slice_csr", "mhc_slice_wide_csr", "random0", "wide70")


def wide70_graph():
    """``(ExpandedGraph, color_homo_bv)``: levels [1, 8, 70, 40, 6, 1]:
    a destination level 70 wide, past the run kernel's 64, so that its
    transition is a per-transition launch at any R."""
    rng = np.random.default_rng(70)
    g = synth.dense_graph(rng, [1, 8, 70, 40, 6, 1], deg=3)
    return g, [True, False, False, True, False, True]


def _case(case):
    """(CSR arrays, R) of a case."""
    if case == "random0":
        return random_case(0)
    if case == "wide70":
        return csr_arrays(*wide70_graph()), 3
    return case_csr(case)


def _oracle(case):
    d = np.load(f"{DATA}/{case}.npz")
    return (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])


def _share_launches(arrs, R):
    """The per-transition launches of the CPU cut: their destination
    widths."""
    desc = plan_vertices(*arrs).desc
    cut = plan_launches(desc, R + 1, True, fused.SMEM_OPTIN_CPU)
    return [int(desc[first, K2]) for first, _, kmax in cut if kmax == 0]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Two gloo ranks: the chunked tier on every case, and one sharded
    level step on the wide slice's widest transition."""
    tmp = str(tmp_path_factory.mktemp("chunked_tp2"))
    arrs, R = _case("mhc_slice_wide_csr")
    t = int(np.argmax(plan_vertices(*arrs).desc[:, K2]))
    job = {"chunked": {c: _case(c) for c in CASES},
           "level_step": (arrs, R, t)}
    return run_ranks(2, job, tmp)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_jax_tp_chunked_tier(case, tp2):
    import jax

    from dipgenie_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    arrs, R = _case(case)
    want = jd.DeviceDiploidDP(jd.plan_transitions(*arrs), R,
                              mesh=make_mesh(n_dp=1, n_tp=2)).run()
    if case.startswith("mhc"):
        assert want == _oracle(case)
    shares = len(_share_launches(arrs, R))
    assert [r["tp_rank"] for r in tp2] == [0, 1]
    for r in tp2:
        got, stats = r["chunked"][case]
        assert got == want
        # each wide transition split and gathered in the forward and again
        # in the replay
        assert stats["shares"] == stats["gathers"] == 2 * shares
    if case in ("mhc_slice_wide_csr", "wide70"):
        assert shares > 0


def test_sharded_level_step_matches_unshared_transition(tp2):
    """``sharded_dp_level_step`` on two ranks: V', SH' and the words equal
    the plain transition's from the same state, on both ranks."""
    arrs, R = _case("mhc_slice_wide_csr")
    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    t = int(np.argmax(plan.desc[:, K2]))
    k2 = int(plan.desc[t, K2])
    assert (k2 * k2) % 2  # the second share is short
    for r in tp2:
        V, SH, V2, SH2, words = r["level_step"]
        bp = torch.zeros((R + 1) * k2 * k2, dtype=torch.int32)
        want = chunked.chunk_step_ref(dev, t, t + 1, torch.from_numpy(V),
                                      torch.from_numpy(SH), bp, [0])
        assert np.array_equal(V2, want[0].numpy())
        assert np.array_equal(SH2, want[1].numpy())
        assert np.array_equal(words.reshape(-1), bp.numpy())
        assert (V2 >= 0).any()


def test_three_ranks_match_exact_and_single_rank(tmp_path):
    """Three ranks on the wide slice, whose wide transitions' pair counts
    do not all divide by 3 (short last shares)."""
    arrs, R = _case("mhc_slice_wide_csr")
    widths = _share_launches(arrs, R)
    assert any((k2 * k2) % 3 for k2 in widths)
    want = _oracle("mhc_slice_wide_csr")
    single = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu").run()
    assert single == want
    ranks = run_ranks(3, {"chunked": {"wide": (arrs, R)}}, str(tmp_path))
    assert [r["tp_rank"] for r in ranks] == [0, 1, 2]
    for r in ranks:
        got, stats = r["chunked"]["wide"]
        assert got == want
        assert stats["shares"] == 2 * len(widths) > 0
        assert stats["gather_bytes"] > 0


@pytest.mark.parametrize("case", ["mhc_slice_wide_csr", "wide70"])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_stitched_shares_equal_chunk_step_ref(case, n):
    """``chunk_share`` (its plain version here) on every rank's share of
    the widest transition, the shares stacked as the all-gather stacks
    them and put in place by ``place``: V, SH and the words equal
    ``chunk_step_ref``'s, and ``chunk_share_ref`` equals the plain
    transition's slice of the pairs."""
    arrs, R = _case(case)
    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    t = int(np.argmax(plan.desc[:, K2]))
    R1, k2 = R + 1, int(plan.desc[t, K2])
    kk2 = k2 * k2
    V = initial_state(R, int(plan.widths[0]), "cpu")
    V, SH = chunked.chunk_step_ref(dev, 0, t, V, torch.zeros_like(V))
    bp = torch.zeros(R1 * kk2, dtype=torch.int32)
    want = (*(x.reshape(-1) for x in chunked.chunk_step_ref(
        dev, t, t + 1, V, SH, bp, [0])), bp)
    S = chunked.share_of(kk2, n, 0)[2]
    g = torch.full((n, 3, R1, S), -7, dtype=torch.int32)
    for d in range(n):
        p0, p1, _ = chunked.share_of(kk2, n, d)
        chunked.chunk_share(dev, t, V, SH, p0, p1, g[d])
        ref = chunked.chunk_share_ref(dev, t, V, SH, p0, p1)
        for c in range(3):
            assert torch.equal(ref[c], want[c].view(R1, kk2)[:, p0:p1])
    for c in range(3):
        dest = torch.full((R1 * kk2 + 5,), -9, dtype=torch.int32)
        chunked.place(g[:, c], dest, kk2)
        assert torch.equal(dest[:R1 * kk2], want[c])
        assert (dest[R1 * kk2:] == -9).all()


def test_wide70_needs_share_launches_and_matches_exact():
    """The random wide case: its level 70 wide is a per-transition launch
    under the CPU cut, and the single-device tier equals the exact tier."""
    g, chb = wide70_graph()
    arrs, R = csr_arrays(g, chb), 3
    assert 70 in _share_launches(arrs, R)
    want = _forward_exact(g, R, *build_color_masks(g, chb))
    assert chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu").run() \
        == want
