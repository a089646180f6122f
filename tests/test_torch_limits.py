"""dipgenie_tpu_torch past the TPU planner's limits.

The JAX package's planner refuses R >= 32, a wide run of more than 31
1024-lane windows and a DP value bound past 4,100,000 (limits of its TPU
kernels); the port plans on, up to its own limits (``VALUE_MAX``,
``SPLIT_NB_MAX`` in ``ops/pair_plan.py``). On each graph of
``synth.LIMIT_CASES`` the port's torch tier (on the CPU: every kernel's
plain PyTorch version), its native tier and its exact tier give the same
``(sink_value, s_het, transitions)``: integers, so exact equality.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dipgenie_tpu.ops.diploid_pallas import plan_pairs as jax_plan_pairs
from dipgenie_tpu_torch.ops import pair_plan
from dipgenie_tpu_torch.ops.diploid_pair import RUNS, PairDiploidDP
from dipgenie_tpu_torch.ops.pair_plan import (
    NEG, REACH_T, SPLIT_NB_MAX, VALUE_MAX, PlanLimit, _WideRun,
)
from dipgenie_tpu_torch.ops.plan import (
    DENSE_NB_MAX, decode_keys, initial_v, make_keys, plan_pairs,
    plan_to_device,
)
from dipgenie_tpu_torch.solver.diploid import (
    _forward_exact, build_color_masks, csr_arrays, native_forward_csr,
)
from dipgenie_tpu_torch.utils import synth
from dipgenie_tpu_torch.utils.synth import LIMIT_CASES, limit_case
from tests.test_torch_kernels_gpu import _tp_run_checked

TPU_VALUE_BOUND = 4_100_000  # the JAX planner's limit on its value bound


def _plan(name):
    g, chb, R = limit_case(name)
    arrs = csr_arrays(g, chb)
    return g, chb, R, arrs, plan_pairs(*arrs, R)


@pytest.mark.parametrize("name", LIMIT_CASES)
def test_torch_tier_matches_native_and_exact_past_tpu_limits(name):
    """Each case passes one TPU limit (the JAX planner refuses it); the
    torch tier on both routings (the main path's; K3 over every wide run)
    equals the native and the exact tier."""
    g, chb, R, arrs, plan = _plan(name)
    with pytest.raises(ValueError):
        jax_plan_pairs(*arrs, R)
    nbs = [s.NB for s in plan.segments if isinstance(s, _WideRun)]
    want = native_forward_csr(arrs, R)
    if name.startswith("R"):
        assert R >= 32 and nbs and len(nbs) < len(plan.segments)
    elif name.startswith("width"):
        assert max(nbs) > 31
    else:
        assert plan.max_abs_value > TPU_VALUE_BOUND
        assert want[0] > TPU_VALUE_BOUND
    assert want == _forward_exact(g, R, *build_color_masks(g, chb))
    for nb_max in (DENSE_NB_MAX, 0):
        dplan = plan_to_device(plan, "cpu", nb_max)
        assert PairDiploidDP(dplan, "cpu").run() == want, nb_max


@pytest.mark.parametrize("width", [179, 190])
def test_runs_past_31_windows_through_k3_and_k4(width, tmp_path):
    """A level of width 179 needs 32 windows, 190 needs 36: NB is what the
    run needs (no ladder rung), the run has no dense tables and no window
    bitmasks, K2 is refused, and K4's plain version on each of 1-3 ranks'
    shards, merged as the ranks' all_reduce(MAX) merges them, gives K3's
    output state; the DP over a one-rank gloo mesh equals the native
    tier."""
    from dipgenie_tpu_torch.parallel.mesh import make_mesh

    _, _, R, arrs, plan = _plan(f"width{width}")
    wide = [s for s in plan.segments if isinstance(s, _WideRun)]
    assert [s.NB for s in wide] == [-(-width * width // 1024)]
    seg = wide[0]
    assert seg.dtbl.shape == (0, 2, 256) and len(seg.dbits) == 0
    assert not (seg.wpmask.any() or seg.wgmask.any())
    with pytest.raises(ValueError, match="no dense tables"):
        plan_to_device(plan, "cpu", dense_nb_max=seg.NB)
    dplan = plan_to_device(plan, "cpu")
    assert [s.kind for s in dplan.segments if s.host is seg] == ["wide_split"]
    V = initial_v(R, "cpu")
    for host, dseg in zip(plan.segments, dplan.segments):
        out = RUNS[dseg.kind](dseg, V)[0]
        if host is seg:
            for n_tp in (1, 2, 3):
                assert torch.equal(_tp_run_checked(seg, n_tp, V, "cpu"),
                                   out), n_tp
        V = out
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        got = PairDiploidDP(plan, "cpu", mesh=make_mesh(n_tp=1)).run()
    finally:
        dist.destroy_process_group()
    assert got == native_forward_csr(arrs, R)


def test_value_max_round_trips_through_the_key():
    """VALUE_MAX is the largest value whose key's high word, value -
    REACH_T + 1, fits an int32 (ops/plan.py:make_keys, read back signed):
    there it equals the plain version's int64 word, and one above it
    wraps. Keys at and below it decode to their value and ordinal."""
    v = torch.tensor([VALUE_MAX, VALUE_MAX - 1, 4_502_515, 0, REACH_T + 1],
                     dtype=torch.int32)
    ordinal = torch.tensor([0, 1, 2**31, 7, 2**32 - 1])
    val, ordv = decode_keys(make_keys(v, ordinal))
    assert torch.equal(val, v) and torch.equal(ordv, ordinal)
    hi32 = torch.tensor([VALUE_MAX, VALUE_MAX + 1],
                        dtype=torch.int32) - REACH_T + 1
    hi = VALUE_MAX - REACH_T + 1
    assert hi == 2**31 - 1 and hi32.tolist() == [hi, -(2**31)]


@pytest.mark.parametrize("limit", ["values", "windows"])
def test_planner_raises_only_past_the_ports_limits(limit, monkeypatch):
    """The value bound: a graph whose values may reach exactly VALUE_MAX
    plans, one more raises (VALUE_MAX patched down to a small graph's
    bound). The windows: a level of width 513 needs 258 windows, past
    SPLIT_NB_MAX."""
    if limit == "values":
        arrs, R = synth.random_leveled_csr(0, 12, 5, 8), 5
        reach = plan_pairs(*arrs, R).max_abs_value + NEG
        monkeypatch.setattr(pair_plan, "VALUE_MAX", reach)
        assert plan_pairs(*arrs, R).max_abs_value + NEG == reach
        monkeypatch.setattr(pair_plan, "VALUE_MAX", reach - 1)
        match = f"reach {reach}, past {reach - 1}"
    else:
        g = synth.dense_graph(np.random.default_rng(5), [1, 513, 1], deg=2)
        arrs, R = csr_arrays(g, [True] * 6), 2
        match = f"258 1024-lane windows, past {SPLIT_NB_MAX}"
    with pytest.raises(PlanLimit, match=match) as err:
        plan_pairs(*arrs, R)
    assert "--dp-backend native" in str(err.value)


def test_parallel_edges_destination_past_a_k2_slice_goes_to_k3():
    """A dense run (2 windows) whose destination pair gathers 44,100 pairs
    through parallel edges, more than a K2 slice holds (44,032): K2's
    slicing refuses it, so the run goes to K3, which cuts that destination
    over slices; the torch tier then equals the native and exact tiers
    (the port refused this plan before)."""
    from dipgenie_tpu_torch.ops.plan import (
        K2_SLICE_PAIRS, K2_GRID_CPU, dense_destinations, segment_kind,
        wide_slices,
    )

    g, chb = synth.parallel_edges_graph()
    arrs = csr_arrays(g, chb)
    plan = plan_pairs(*arrs, 4)
    (seg,) = plan.segments
    assert isinstance(seg, _WideRun) and seg.NB == 2 <= DENSE_NB_MAX
    assert dense_destinations(seg)[1] == 210 ** 2 > K2_SLICE_PAIRS
    with pytest.raises(PlanLimit, match="a destination of 44100 pairs"):
        wide_slices(seg, int(np.count_nonzero(seg.dbits & 4)), K2_GRID_CPU)
    assert segment_kind(seg) == "wide_split"
    assert segment_kind(seg, 0) == "wide_split"
    dplan = plan_to_device(plan, "cpu")
    assert [s.kind for s in dplan.segments] == ["wide_split"]
    got = PairDiploidDP(dplan, "cpu").run()
    assert got == native_forward_csr(arrs, 4)
    assert got == _forward_exact(g, 4, *build_color_masks(g, chb))
    # one parallel edge fewer (209 ** 2 = 43,681 pairs) stays on K2
    small = synth.parallel_edges_graph(in_edges=209)
    (seg,) = plan_pairs(*csr_arrays(*small), 4).segments
    assert dense_destinations(seg)[1] == 209 ** 2
    assert segment_kind(seg) == "wide"


def test_auto_routes_past_the_window_limit_to_the_fused_tier(capfd):
    """The width-513 graph of the window case above: ``torch`` raises the
    planner's ``WindowLimit`` (its ``[E::main]`` line stays as it was);
    ``auto`` prints one ``[W::diploid_dp]`` line naming the limit and runs
    the fused tier, whose result equals the native tier's; ``fused`` and
    ``jax`` run it with no warning."""
    from dipgenie_tpu_torch.ops.pair_plan import WindowLimit
    from dipgenie_tpu_torch.solver.diploid import device_forward

    g = synth.dense_graph(np.random.default_rng(5), [1, 513, 1], deg=2)
    chb = [True] * 6
    arrs, R = csr_arrays(g, chb), 2
    want = native_forward_csr(arrs, R)
    with pytest.raises(WindowLimit, match="--dp-backend native"):
        device_forward(arrs, R, "torch", "cpu")
    capfd.readouterr()
    assert device_forward(arrs, R, "auto", "cpu") == want
    err = capfd.readouterr().err.splitlines()
    warns = [x for x in err if x.startswith("[W::")]
    assert warns == [
        "[W::diploid_dp] torch tier: a wide run needs 258 1024-lane "
        f"windows, past {SPLIT_NB_MAX} (a level wider than 512); running "
        "the fused tier"]
    for backend in ("fused", "jax"):
        assert device_forward(arrs, R, backend, "cpu") == want
    assert not [x for x in capfd.readouterr().err.splitlines()
                if x.startswith("[W::")]
