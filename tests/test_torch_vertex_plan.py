"""The vertex tables of the port's fused and chunked tiers
(``ops/vertex_plan.py``) against the JAX planner
(``dipgenie_tpu.ops.diploid_jax.plan_transitions``), field for field, and
the port's own limits, each at the limit and one past it. Tables are
integers: exact equality."""

import numpy as np
import pytest

from dipgenie_tpu.ops.diploid_jax import plan_transitions as jax_plan
from dipgenie_tpu.solver.diploid import csr_arrays as jax_csr_arrays
from dipgenie_tpu_torch.ops import vertex_plan
from dipgenie_tpu_torch.ops.pair_plan import PlanLimit
from dipgenie_tpu_torch.ops.vertex_plan import (
    NEG, WIDTH_MAX, initial_state, plan_transitions, plan_vertices, popcount,
    ship,
)
from dipgenie_tpu_torch.solver.diploid import csr_arrays
from dipgenie_tpu_torch.utils import synth
from tests.test_device_kernels import _random_leveled_graph
from tests.test_torch_kernels_gpu import case_csr

FIELDS = ("k", "k2", "pred_i", "pred_w", "pred_m", "Hl", "Tl", "Hr", "Tr")


def random_case(seed):
    """(CSR arrays, R) of the JAX tiers' test graph of ``seed``
    (``tests/test_device_kernels.py``: R = 5)."""
    rng = np.random.default_rng(seed)
    g = _random_leveled_graph(rng)
    chb = [bool(x) for x in rng.random(8) < 0.4]
    return jax_csr_arrays(g, chb), 5


def assert_same_tables(want, got):
    assert len(want) == len(got)
    for t, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (t, f)
                assert np.array_equal(x, y), (t, f)
            else:
                assert x == y, (t, f)


@pytest.mark.parametrize("case", [0, 1, 2, 3, "mhc_slice_csr",
                                  "mhc_slice_wide_csr", "high_indegree"])
def test_tables_match_jax_planner(case):
    """Every transition's slots, weights, masks and colour words equal
    the JAX planner's (its clamping buckets are not hit here)."""
    if isinstance(case, int):
        arrs, _ = random_case(case)
    elif case == "high_indegree":
        arrs = csr_arrays(*synth.high_indegree_graph())
    else:
        arrs, _ = case_csr(case)
    assert_same_tables(jax_plan(*arrs), plan_transitions(*arrs))


def test_tables_past_the_jax_buckets():
    """In-degree 36 and 1,080 colours in a level pair (34 words): the JAX
    planner builds the same tables (its chunked tier's buckets then
    clamp them); the port plans them as they are."""
    g = synth.hand_graph(
        [1, 36, 2, 1],
        [[(0, i, i % 2) for i in range(36)],
         [(i, j, (i + j) % 2) for i in range(36) for j in range(2)],
         [(0, 0, 0), (1, 0, 1)]],
        {1 + i: list(range(30 * i, 30 * i + 30)) for i in range(36)})
    chb = [c % 3 == 0 for c in range(36 * 30)]
    arrs = csr_arrays(g, chb)
    got = plan_transitions(*arrs)
    assert_same_tables(jax_plan(*arrs), got)
    assert got[1].pred_i.shape[1] == 36 and got[1].Hl.shape[1] == 34


def test_width_limit():
    """A level of width WIDTH_MAX plans; one vertex more raises."""
    for width in (WIDTH_MAX, WIDTH_MAX + 1):
        g = synth.hand_graph([1, width, 1],
                             [[(0, i, 0) for i in range(width)],
                              [(i, 0, i % 2) for i in range(width)]])
        arrs = csr_arrays(g, [True])
        if width == WIDTH_MAX:
            plan = plan_vertices(*arrs)
            assert plan.desc[0, 1] == WIDTH_MAX and plan.desc[1, 2] == width
        else:
            with pytest.raises(PlanLimit, match=f"width {width}, past "
                               f"{WIDTH_MAX}.*--dp-backend native"):
                plan_vertices(*arrs)


def test_value_limit(monkeypatch):
    """The value bound (distinct colours of each level pair, summed): a
    graph whose bound is VALUE_MAX plans, one less raises."""
    arrs, _ = random_case(0)
    bound = plan_vertices(*arrs).value_bound
    assert bound > 0
    monkeypatch.setattr(vertex_plan, "VALUE_MAX", bound)
    assert plan_vertices(*arrs).value_bound == bound
    monkeypatch.setattr(vertex_plan, "VALUE_MAX", bound - 1)
    with pytest.raises(PlanLimit, match=f"reach {bound}, past {bound - 1}"):
        plan_vertices(*arrs)


def test_weights_past_one_raise():
    g = synth.hand_graph([1, 2, 1], [[(0, 0, 0), (0, 1, 2)],
                                     [(0, 0, 0), (1, 0, 0)]])
    with pytest.raises(PlanLimit, match="weight other than 0 or 1"):
        plan_vertices(*csr_arrays(g, [True]))


def test_value_bound_holds_every_score():
    """No candidate's score passes its level pair's distinct colours."""
    arrs, _ = random_case(2)
    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    uniq = 0
    for t in range(plan.T):
        c = vertex_plan.candidates(dev, t)
        k, k2 = plan.widths[t], plan.widths[t + 1]
        lp = np.asarray(arrs[0])
        cs = np.concatenate([arrs[5][arrs[4][lp[t]]:arrs[4][lp[t + 2]]],
                             arrs[7][arrs[6][lp[t]]:arrs[6][lp[t + 2]]]])
        n = len(np.unique(cs))
        uniq += n
        assert len(c["score"]) and int(c["score"].max()) <= n
        assert k >= 1 and k2 >= 1
    assert uniq == plan.value_bound


def test_popcount_and_initial_state():
    import torch

    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x0F0F0F0F, -1])
    assert popcount(x).tolist() == [0, 1, 32, 2, 16, 32]
    v = initial_state(3, 2, "cpu")
    assert v.shape == (4, 2, 2) and (v[:, 0, 0] == 0).all()
    assert int((v == NEG).sum()) == 12
