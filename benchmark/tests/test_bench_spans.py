"""The per-layer metrics read from the program's span registry
(``dipgenie_tpu_torch/utils/timing.py``): a traced run of each cell at a
tiny size on the CPU reports every one its ``workloads`` list names, from
the window's solves; a program without the registry leaves them out."""

import os

import pytest

import harness
from conftest import ROOT
from dipgenie_tpu_torch.ops import fused
from dipgenie_tpu_torch.utils import timing

SPAN_METRICS = ("readback.assemble_ms", "readback.gc_ms", "fused.ship_ms",
                "fused.cut_ms", "pair.plan_tables_s", "pair.plan_layout_s")


@pytest.fixture
def card_cut(monkeypatch):
    """The plain forward cuts no launches; have it cut them first, as the
    card's forward does."""
    ref = fused.fused_forward_ref

    def cut_then_ref(dev, t0, t1, V, bp):
        fused.launch_cut(dev, t0, t1, V.shape[0], False)
        return ref(dev, t0, t1, V, bp)

    monkeypatch.setattr(fused, "fused_forward_ref", cut_then_ref)


def test_span_metrics_are_listed_with_their_cells():
    bench = harness.load_bench(os.path.join(ROOT, "BENCHMARK.json"))
    per = {m["name"]: m for m in bench["per_layer"]}
    assert set(SPAN_METRICS) <= set(per)
    cells = {w["name"] for w in bench["workloads"]}
    for name in SPAN_METRICS:
        assert set(per[name]["workloads"]) <= cells


@pytest.mark.parametrize("cell", ["mhc4.pair", "mhc4.fused"])
def test_traced_run_reports_the_span_metrics(copy, card_cut, monkeypatch,
                                             cell):
    bench = harness.load_bench(copy / "BENCHMARK.json")
    bench_dir = str(copy / "benchmark")
    timing.reset()
    rec = harness.run_cell(bench, str(copy), cell, 2**31 + 5, 0.3, True,
                           "cpu", bench_dir=bench_dir)
    tier = rec["tier"]
    # one record a solve: the warm solve, the traced warm solve, the window
    assert len(timing.recent(f"{tier}.assemble")) == rec["solves"] + 2
    out = harness.result_line(bench, rec, True, bench_dir=bench_dir)
    assert out["correct"] is True
    want = {m["name"] for m in harness.cell_metrics(bench, cell, True)
            if m["name"] in SPAN_METRICS}
    assert want == ({"readback.assemble_ms", "readback.gc_ms"}
                    | ({"pair.plan_tables_s", "pair.plan_layout_s"}
                       if tier == "pair" else
                       {"fused.ship_ms", "fused.cut_ms"}))
    got = {k: v["value"] for k, v in out["metrics"].items()
           if k in SPAN_METRICS}
    assert set(got) == want
    assert all(v > 0 for k, v in got.items() if k != "readback.gc_ms")
    assert got["readback.gc_ms"] >= 0
    window = timing.recent(f"{tier}.assemble", rec["solves"])
    assert got["readback.assemble_ms"] == pytest.approx(
        sum(s.ns for s in window) / len(window) / 1e6)

    # a version of the program without the registry: the readers are silent
    monkeypatch.delattr(timing, "recent")
    monkeypatch.delattr(timing, "total")
    out = harness.result_line(bench, rec, True, bench_dir=bench_dir)
    assert not set(out["metrics"]) & set(SPAN_METRICS)
    assert {f"{tier}.forward_ms", f"{tier}.trace_ms"} <= set(out["metrics"])
