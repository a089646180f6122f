"""The program's span registry (``dipgenie_tpu_torch/utils/timing.py``) on
the CPU: the records, their parents and times, the ring's bound, the
collector's pauses, the clock against ``torch.profiler``'s, the ``dg.*``
profiler ranges, and the spans of a solve, of the pair planner and of the
timers folded into the registry (``plan.split_slices``, ``pair.tp_merge``,
``chunked.tp_gather``)."""

import gc
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from dipgenie_tpu_torch.ops import chunked, fused, plan as plan_mod
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import plan_pairs, plan_to_device
from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices
from dipgenie_tpu_torch.solver.diploid import csr_arrays, native_forward_csr
from dipgenie_tpu_torch.utils import synth, timing

R = 3
# the spans of one solve, each with its parent
SOLVE_SPANS = {
    "pair": {"pair.forward": None, "pair.trace": None,
             "pair.assemble": None},
    "fused": {"fused.ship": None, "fused.forward": None,
              "fused.cut": "fused.forward", "fused.trace": None,
              "fused.assemble": None},
}


@pytest.fixture(autouse=True)
def fresh():
    timing.reset()
    yield
    timing.reset()


def wide_graph_csr():
    """CSR arrays of levels [1, 8, 70, 40, 6, 1]: narrow runs, and wide
    transitions (70 wide) for the pair planner's wide runs and the vertex
    tiers' per-transition launches."""
    rng = np.random.default_rng(70)
    g = synth.dense_graph(rng, [1, 8, 70, 40, 6, 1], deg=3)
    return csr_arrays(g, [True, False, False, True, False, True])


@pytest.fixture(scope="module")
def csr():
    return wide_graph_csr()


@pytest.fixture
def card_cut(monkeypatch):
    """The plain forward cuts no launches; have it cut them first, as the
    card's forward does inside ``fused.forward``."""
    ref = fused.fused_forward_ref

    def cut_then_ref(dev, t0, t1, V, bp):
        fused.launch_cut(dev, t0, t1, V.shape[0], False)
        return ref(dev, t0, t1, V, bp)

    monkeypatch.setattr(fused, "fused_forward_ref", cut_then_ref)


def solver(tier, arrs):
    if tier == "pair":
        return PairDiploidDP(plan_pairs(*arrs, R), "cpu")
    return fused.FusedDiploidDP(fused.plan_fused(*arrs, R), "cpu")


def profiled(fn):
    """``(fn(), [(name, start_ns, end_ns)] of its CPU ranges)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as p:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in p.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    return out, ranges


def test_records_parents_and_own_times():
    with timing.span("outer") as outer:
        time.sleep(0.01)
        with timing.span("inner") as inner:
            time.sleep(0.02)
    (o,), (i,) = timing.recent("outer"), timing.recent("inner")
    assert (o, i) == (outer, inner)
    assert o.parent is None and i.parent == "outer"
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert i.ns >= 20e6 and o.ns - i.ns >= 10e6
    assert timing.total("inner") == (1, i.ns, i.gc_ns)
    assert timing.total("nothing") == (0, 0, 0)
    assert timing.recent("nothing") == []


@pytest.mark.parametrize("n", [10, timing.RING + 100])
def test_the_ring_keeps_the_last_records(n):
    for _ in range(n):
        with timing.span("x"):
            pass
    kept = timing.recent("x")
    assert len(kept) == min(n, timing.RING) == len(timing._records)
    assert timing.recent("x", 3) == kept[-3:]
    # the totals count every record, the dropped ones too
    assert timing.total("x").calls == n
    assert (timing.total("x").ns == sum(r.ns for r in kept)) == (
        n <= timing.RING)


def test_collector_pause_lands_in_the_innermost_open_span():
    gc.collect()  # no collection of its own starts in the few allocations
    with timing.span("outer"):
        with timing.span("inner"):
            gc.collect()
        time.sleep(0.001)
    gc.collect()  # no span open: no record gains it
    (o,), (i,) = timing.recent("outer"), timing.recent("inner")
    assert i.gc_ns > 0 and o.gc_ns == 0
    assert i.gc_ns <= i.ns
    assert timing.total("inner").gc_ns == i.gc_ns


@pytest.mark.parametrize("with_ranges", [False, True])
def test_span_clock_is_the_profilers(with_ranges):
    """A span's start and end on the clock of the profiler's events: inside
    a probe range opened around it, and (with ranges on) within 1 ms of
    its own ``dg.*`` range."""
    def body():
        with torch.profiler.record_function("probe"):
            with timing.span("clock") as rec:
                time.sleep(0.002)
        return rec

    if with_ranges:
        with timing.ranges():
            rec, ranges = profiled(body)
    else:
        rec, ranges = profiled(body)
    (probe,) = [r for r in ranges if r[0] == "probe"]
    assert probe[1] <= rec.start_ns < rec.end_ns <= probe[2]
    dg = [r for r in ranges if r[0] == "dg.clock"]
    if not with_ranges:
        assert dg == []
        return
    (dg,) = dg
    assert abs(dg[1] - rec.start_ns) < 1e6 and abs(dg[2] - rec.end_ns) < 1e6


@pytest.mark.parametrize("tier", ["pair", "fused"])
@pytest.mark.parametrize("with_ranges", [False, True])
def test_ranges_only_when_on_and_nested_as_the_spans(csr, card_cut, tier,
                                                     with_ranges):
    dp = solver(tier, csr)
    if with_ranges:
        with timing.ranges():
            _, ranges = profiled(dp.run)
    else:
        _, ranges = profiled(dp.run)
    dg = {r[0][3:]: r for r in ranges if r[0].startswith("dg.")}
    if not with_ranges:
        assert dg == {}
        return
    assert set(dg) == set(SOLVE_SPANS[tier])
    for name, parent in SOLVE_SPANS[tier].items():
        _, a, b = dg[name]
        holders = [n for n, (_, a2, b2) in dg.items()
                   if n != name and a2 <= a and b <= b2]
        assert holders == ([parent] if parent else [])


@pytest.mark.parametrize("tier", ["pair", "fused"])
def test_one_record_per_span_per_run(csr, card_cut, tier):
    dp = solver(tier, csr)
    timing.reset()  # the planner's spans are set-up's
    for n in (1, 2):
        dp.run()
        for name, parent in SOLVE_SPANS[tier].items():
            recs = timing.recent(name)
            assert len(recs) == n, name
            assert recs[-1].parent == parent and recs[-1].ns > 0
    ends = [timing.recent(nm)[-1] for nm in SOLVE_SPANS[tier]
            if SOLVE_SPANS[tier][nm] is None]
    # the top-level spans follow one another in the run's order
    assert all(a.end_ns <= b.start_ns for a, b in zip(ends, ends[1:]))


@pytest.mark.parametrize("tier", ["pair", "fused", "chunked"])
def test_assemble_span_once_per_solve(csr, tier):
    """The columnar build of the transitions stays inside its span: one
    top-level ``<tier>.assemble`` a solve, after the traceback's span (the
    chunked tier, with no span of its own there, records the fused one from
    ``path_transitions``), around a list the native tier agrees with."""
    if tier == "chunked":
        dp = chunked.DeviceDiploidDP(plan_vertices(*csr), R, "cpu")
        name = "fused.assemble"
    else:
        dp = solver(tier, csr)
        name = f"{tier}.assemble"
    want = native_forward_csr(csr, R)
    timing.reset()
    for n in (1, 2, 3):
        assert dp.run() == want
        recs = timing.recent(name)
        assert len(recs) == n and recs[-1].parent is None
        assert recs[-1].ns > 0
        if tier != "chunked":
            (trace,) = timing.recent(f"{tier}.trace", 1)
            assert trace.end_ns <= recs[-1].start_ns


@pytest.mark.parametrize("tier", ["pair", "fused"])
def test_run_results_unchanged_with_tracing(csr, tier):
    want = native_forward_csr(csr, R)
    plain = solver(tier, csr).run()
    with timing.ranges():
        traced, _ = profiled(solver(tier, csr).run)
    assert plain == traced == want


@pytest.mark.parametrize("native", [True, False])
def test_plan_pairs_spans_tables_then_layout(csr, monkeypatch, native):
    if not native:
        monkeypatch.setenv("DIPGENIE_NO_NATIVE_PLANNER", "1")
    plan = plan_pairs(*csr, R)
    (tables,) = timing.recent("pair.plan.tables")
    (layout,) = timing.recent("pair.plan.layout")
    assert tables.parent is None and layout.parent is None
    assert tables.end_ns <= layout.start_ns
    assert PairDiploidDP(plan, "cpu").run() == native_forward_csr(csr, R)


def one_rank_mesh(tmp_path):
    import torch.distributed as dist

    from dipgenie_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    return make_mesh(n_tp=1)


@pytest.mark.parametrize("timer", ["split_slices", "tp_merge", "tp_gather"])
def test_folded_timers_are_spans(csr, tmp_path, timer):
    """The host timers that were attributes (``split_slices.seconds``,
    ``wide_tp_run.merge_seconds``, the chunked stats' seconds) are spans:
    one a slicing, a merge, a gather."""
    import torch.distributed as dist

    from dipgenie_tpu_torch.ops import wide_step

    assert not hasattr(plan_mod.split_slices, "seconds")
    assert not hasattr(wide_step.wide_tp_run, "merge_seconds")
    assert set(chunked.new_stats()) == {"shares", "gathers", "gather_bytes"}
    plan = plan_pairs(*csr, R)
    want = native_forward_csr(csr, R)
    if timer == "split_slices":
        dplan = plan_to_device(plan, "cpu", dense_nb_max=0)
        runs = [s for s in dplan.segments if s.kind == "wide_split"]
        assert runs and len(timing.recent("plan.split_slices")) == len(runs)
        assert PairDiploidDP(dplan, "cpu").run() == want
        return
    mesh = one_rank_mesh(tmp_path)
    try:
        if timer == "tp_merge":
            dplan = plan_to_device(plan, "cpu", mesh=mesh)
            wide = sum(s.host.t1 - s.host.t0 for s in dplan.segments
                       if s.kind == "wide_tp")
            assert PairDiploidDP(dplan, "cpu", mesh=mesh).run() == want
            merges = timing.recent("pair.tp_merge")
            assert wide > 0 and len(merges) == wide
            assert {m.parent for m in merges} == {"pair.forward"}
        else:
            dp = chunked.DeviceDiploidDP(plan_vertices(*csr), R, "cpu",
                                         mesh=mesh)
            assert dp.run() == want
            gathers = timing.recent("chunked.tp_gather")
            assert dp.stats["gathers"] == len(gathers) > 0
            assert timing.recent("chunked.tp_wait") == []  # the CPU's
    finally:
        dist.destroy_process_group()
