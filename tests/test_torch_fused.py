"""The port's fused tier (``ops/fused.py``) against the JAX package's
(``dipgenie_tpu/ops/diploid_fused.py``) on the CPU: K13's plain version
against ``_branch_step`` on single transitions (P <= 4, the unrolled
branch; P > 4, the ``fori_loop`` branch), K14's against ``_trace_fn``,
the whole tier against ``FusedDiploidDP``, the baked oracle of the MHC
slice, and the exact tier where the JAX chunked tier cannot run (a level
600 wide, an in-degree of 36). Every comparison is of integers: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import diploid_fused as jf
from dipgenie_tpu.solver.diploid import _forward_exact, build_color_masks
from dipgenie_tpu_torch.ops import fused
from dipgenie_tpu_torch.ops.pair_plan import PlanLimit
from dipgenie_tpu_torch.ops.vertex_plan import NEG, ship
from dipgenie_tpu_torch.solver.diploid import csr_arrays, native_forward_csr
from dipgenie_tpu_torch.utils import synth
from tests.test_torch_kernels_gpu import DATA, case_csr
from tests.test_torch_vertex_plan import random_case

# JAX fused tier's sentinels (diploid_fused.py:53-54)
J_NEG, J_REACH_T = jf.NEG, jf.REACH_T


def width600_graph():
    """``(ExpandedGraph, color_homo_bv)``: widths [1, 600, 1], the source
    to 60 of the 600 (the rest unreachable, which keeps the exact tier's
    pair loop short), every vertex of the wide level to the sink."""
    rng = np.random.default_rng(600)
    edges = [[(0, int(i), int(rng.random() < 0.3))
              for i in rng.choice(600, 60, replace=False)],
             [(i, 0, int(rng.random() < 0.3)) for i in range(600)]]
    colors = {v: sorted(int(c) for c in rng.choice(6, rng.integers(0, 3),
                                                   replace=False))
              for v in range(602)}
    return synth.hand_graph([1, 600, 1], edges, colors), [True, False] * 3


def indeg36_graph():
    """``(ExpandedGraph, color_homo_bv)``: widths [1, 36, 2, 1], every
    vertex of the 36 to both of the 2 (in-degree 36 there)."""
    rng = np.random.default_rng(36)
    edges = [[(0, i, int(rng.random() < 0.3)) for i in range(36)],
             [(i, j, int(rng.random() < 0.3)) for i in range(36)
              for j in range(2)],
             [(0, 0, 0), (1, 0, 1)]]
    colors = {v: sorted(int(c) for c in rng.choice(8, rng.integers(0, 4),
                                                   replace=False))
              for v in range(40)}
    return synth.hand_graph([1, 36, 2, 1], edges, colors), [
        bool(x) for x in rng.random(8) < 0.4]


def random_state(rng, R1, k):
    """A state ``[R1, k, k]``: values 0..999, a third unreachable; the
    JAX fused tier's encoding and the port's."""
    val = rng.integers(0, 1000, (R1, k, k))
    dead = rng.random((R1, k, k)) < 0.33
    return (np.where(dead, J_NEG, val).astype(np.int32),
            torch.from_numpy(np.where(dead, NEG, val).astype(np.int32)))


@pytest.mark.parametrize("widths,deg", [([1, 4, 6, 5, 4], 1),
                                        ([1, 12, 10, 9, 1], 8)])
def test_transition_matches_branch_step(widths, deg):
    """K13's plain version on each transition of a graph from random
    states equals ``_branch_step``: the reachable states, their values,
    and the winning slot pair (the JAX tie code decoded)."""
    rng = np.random.default_rng(sum(widths) + deg)
    g = synth.dense_graph(rng, widths, deg=deg)
    arrs, R = csr_arrays(g, [True, False, False, True, False, True]), 3
    R1 = R + 1
    jplan = jf.plan_fused(*arrs, R)
    jdp = jf.FusedDiploidDP(jplan)
    Bmax = jdp.Bmax
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, "cpu", plan.desc)
    assert (max(b.P for b in jplan.buckets) <= 4) == (deg == 1)
    for t in range(plan.T):
        k, k2, P_ = (int(x) for x in plan.desc[t, :3])
        i = int(jplan.bid[t])
        bk = jplan.buckets[i]
        vj, vp = random_state(rng, R1, Bmax)
        vp = vp[:, :k, :k].contiguous()
        bufs = tuple(jnp.zeros(n, jnp.int16) for n in jdp._buf_sizes())
        f = jf._branch_step(R, bk, Bmax)
        stack = (jplan.pi[i], jplan.pw[i], jplan.pm[i], jplan.hm[i])
        jv, jbufs = f(jnp.asarray(vj), bufs, i, int(jplan.row[t]), *stack)
        jv = np.asarray(jv)[:, :k2, :k2]
        n = R1 * bk.B * bk.B
        tie = np.asarray(jbufs[i])[int(jplan.row[t]) * n:][:n].reshape(
            R1, bk.B, bk.B)[:, :k2, :k2].astype(np.int64) & 0xFFFF
        jp = bk.P - 1 - (tie >> bk.qbits)
        jq = bk.P - 1 - (tie & ((1 << bk.qbits) - 1))

        bp = torch.zeros(plan.bp_bytes, dtype=torch.uint8)
        got = fused.fused_forward_ref(dev, t, t + 1, vp, bp).numpy()
        code = fused._codes(bp, plan.desc[t], R1).numpy().astype(
            np.int64) & 0xFFFF
        reach = got >= 0
        assert np.array_equal(reach, jv > J_REACH_T), t
        assert np.array_equal(got[reach], jv[reach]), t
        assert np.array_equal(code[reach] // P_, jp[reach]), t
        assert np.array_equal(code[reach] % P_, jq[reach]), t
        assert (code[~reach] == 0).all()


def _jax_walk(arrs, R):
    """(s_het, rows [L-1, 4] in level order) of the JAX fused tier's
    forward and ``_trace_fn``."""
    jdp = jf.FusedDiploidDP(jf.plan_fused(*arrs, R))
    stacks, xs = jdp._ship()
    V0, bufs = jdp._initial()
    _, bufs = jdp._forward_fn()(stacks, xs, V0, bufs)
    sh, rows = jdp._trace_fn()(stacks, bufs, tuple(jnp.flip(a, 0)
                                                   for a in xs))
    return int(sh), np.asarray(rows)[::-1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_walker_matches_trace_fn(seed):
    """K14's plain version on the plain forward's codes equals the JAX
    ``_trace_fn`` on its own forward's codes: the same rows and s_het."""
    arrs, R = random_case(seed)
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, "cpu", plan.desc)
    bp = torch.zeros(plan.bp_bytes, dtype=torch.uint8)
    V0 = fused.initial_state(R, 1, "cpu")
    fused.fused_forward_ref(dev, 0, plan.T, V0, bp)
    rows, sh = fused.fused_trace_ref(dev, bp, R)
    jsh, jrows = _jax_walk(arrs, R)
    assert sh == jsh
    assert np.array_equal(rows.numpy(), jrows)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_tier_matches_jax_fused_tier(seed):
    arrs, R = random_case(seed)
    got = fused.FusedDiploidDP(fused.plan_fused(*arrs, R), "cpu").run()
    assert got == jf.FusedDiploidDP(jf.plan_fused(*arrs, R)).run()


def test_fused_tier_matches_mhc_slice_oracle():
    arrs, R = case_csr("mhc_slice_csr")
    d = np.load(f"{DATA}/mhc_slice_csr.npz")
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    assert fused.FusedDiploidDP(fused.plan_fused(*arrs, R), "cpu").run() \
        == want


@pytest.mark.parametrize("name", ["width600", "indeg36"])
def test_fused_tier_matches_exact_past_jax_buckets(name):
    """A level 600 wide and an in-degree of 36: the exact tier's result
    (the JAX chunked tier raises on both: tests/test_torch_chunked.py)."""
    g, chb = (width600_graph if name == "width600" else indeg36_graph)()
    arrs, R = csr_arrays(g, chb), 3
    got = fused.FusedDiploidDP(fused.plan_fused(*arrs, R), "cpu").run()
    assert got == _forward_exact(g, R, *build_color_masks(g, chb))
    assert got[0] > 0


def test_fused_tier_on_high_indegree_graph():
    """``test_fused_dp_high_indegree``'s graph (in-degree up to 40): the
    native tier's result, which equals the exact tier's (the JAX
    package's test holds the two equal there)."""
    g, chb = synth.high_indegree_graph()
    arrs = csr_arrays(g, chb)
    plan = fused.plan_fused(*arrs, 3)
    assert int(plan.desc[:, 2].max()) == 40
    got = fused.FusedDiploidDP(plan, "cpu").run()
    assert got == native_forward_csr(arrs, 3)


def test_memory_limit(monkeypatch):
    """The run needs exactly its backpointers and two state buffers: with
    that much free it runs, with one byte less it raises before the
    forward (the free bytes patched: the CPU sets no limit)."""
    arrs, R = random_case(1)
    plan = fused.plan_fused(*arrs, R)
    need = fused.FusedDiploidDP(plan, "cpu").need_bytes()
    assert need == plan.bp_bytes + 2 * 4 * (R + 1) * int(
        (plan.vplan.widths ** 2).max())
    want = jf.FusedDiploidDP(jf.plan_fused(*arrs, R)).run()
    monkeypatch.setattr(fused, "free_bytes", lambda device: need)
    assert fused.FusedDiploidDP(plan, "cpu").run() == want
    monkeypatch.setattr(fused, "free_bytes", lambda device: need - 1)
    with pytest.raises(PlanLimit, match=f"needs {need} B .* past the "
                       f"{need - 1} B free; use --dp-backend jax or native"):
        fused.FusedDiploidDP(plan, "cpu").run()


def test_codes_past_256_slots_are_int32():
    """In-degree 300 (past 256 slots): that transition's codes are
    int32 and the tier equals the native tier."""
    rng = np.random.default_rng(300)
    edges = [[(0, i, 0) for i in range(300)],
             [(i, j, int(rng.random() < 0.3)) for i in range(300)
              for j in range(2)],
             [(0, 0, 0), (1, 0, 1)]]
    colors = {v: [int(rng.integers(0, 5))] for v in range(304)}
    g = synth.hand_graph([1, 300, 2, 1], edges, colors)
    arrs, R = csr_arrays(g, [True, False, True, False, False]), 2
    plan = fused.plan_fused(*arrs, R)
    assert list(fused.code_bytes(plan.desc[:, 2])) == [2, 4, 2]
    assert fused._codes(torch.zeros(plan.bp_bytes, dtype=torch.uint8),
                        plan.desc[1], R + 1).dtype == torch.int32
    got = fused.FusedDiploidDP(plan, "cpu").run()
    assert got == native_forward_csr(arrs, R)
