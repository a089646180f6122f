"""The harness is driven by data: a configuration, a cell and a per-layer
metric dropped next to the real ones are listed and loaded with no edit to
an existing file. A cell's window loop at a tiny size, through the
program's plain versions on the CPU, leaves the record the metrics read."""

import hashlib
import importlib
import inspect
import json
import os
import textwrap

import pytest

import harness


def _digests(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_files_dropped_beside_are_listed_and_loaded(copy):
    before = _digests(copy)
    cfg = json.loads((copy / "benchmark/configs/mhc4_r18.json").read_text())
    cfg.update(name="tiny_r5", R=5,
               params=dict(L=150, n_bands=1, band_len=3, wmin=33, wmax=34))
    (copy / "benchmark/configs/tiny_r5.json").write_text(json.dumps(cfg))
    (copy / "benchmark/metrics/solves_seen.py").write_text(
        "def read(rec):\n    return float(rec['solves'])\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_r5", "source": "a test",
                             "file": "benchmark/configs/tiny_r5.json",
                             "reduced": []})
    bench["workloads"].append({"name": "tiny.fused", "config": "tiny_r5",
                               "traffic": "fused", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "solves_seen", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "device", "moves": "dp_states_per_s",
                               "workloads": ["tiny.fused"]})
    cell, config, traffic = harness.cell_parts(bench, str(copy), "tiny.fused")
    assert config["R"] == 5 and traffic["tier"] == "fused"
    names = [m["name"] for m in harness.cell_metrics(bench, "tiny.fused",
                                                     True)]
    assert "solves_seen" in names and "pair.plan_s" not in names
    rec = harness.run_cell(bench, str(copy), "tiny.fused", 99, 0.5, True,
                           "cpu", bench_dir=str(copy / "benchmark"))
    out = harness.result_line(bench, rec, True,
                              bench_dir=str(copy / "benchmark"))
    assert out["metrics"]["solves_seen"]["value"] == rec["solves"] >= 1
    assert out["correct"] is True
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("cell", ["mhc4.pair", "mhc4.fused"])
@pytest.mark.parametrize("trace", [False, True])
def test_window_record(copy, cell, trace):
    bench = harness.load_bench(copy / "BENCHMARK.json")
    rec = harness.run_cell(bench, str(copy), cell, 2**31 + 3, 0.3, trace,
                           "cpu", bench_dir=str(copy / "benchmark"))
    tier = rec["tier"]
    assert rec["solves"] >= 1 and rec["window_s"] >= 0.3
    assert rec["states"] > 0 and rec["setup_s"] > 0
    assert f"{tier}.plan" in rec["spans"] and "graph" in rec["spans"]
    assert rec["launches"] == 0  # the plain versions launch nothing
    assert rec["checks"] == {k: {"value": 0, "limit": 0}
                             for k in ("sink_off", "s_het_off", "steps_off")}
    out = harness.result_line(bench, rec, trace,
                              bench_dir=str(copy / "benchmark"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    got = set(out["metrics"])
    if not trace:
        assert got == {"dp_states_per_s", "setup_s"}
        assert rec["trace"] is None
        return
    # the layers each tier brackets, a solve's ms each
    for layer in (f"{tier}.forward", f"{tier}.trace"):
        assert len(rec["layers"][layer]) == rec["solves"]
    assert {f"{tier}.plan_s", f"{tier}.forward_ms", f"{tier}.trace_ms",
            "launches_per_solve"} <= got
    # the CPU has no device trace, memory or peaks: those readers are silent
    assert not got & {"device_idle", "forward_roofline", "peak_device_gib"}
    assert rec["trace"]["window_s"] > 0 and rec["trace"]["busy_s"] == 0
    assert "breakdown" in out


@pytest.mark.parametrize("tier", ["pair", "fused"])
def test_traced_solve_mirrors_the_programs_run(tier):
    """``traced_solve`` is a bracketed copy of the program's ``run()``: it
    must follow the body it mirrors, or the per-layer metrics time an old
    body while the window runs the new one."""
    mod = harness.load_tier(tier)
    assert mod.MIRRORS
    for target, digest in mod.MIRRORS.items():
        module, qual = target.split(":")
        obj = importlib.import_module(module)
        for part in qual.split("."):
            obj = getattr(obj, part)
        src = textwrap.dedent(inspect.getsource(obj))
        got = hashlib.sha1(src.encode()).hexdigest()[:16]
        assert got == digest, (
            f"{target} changed (source sha1 {got}, mirrored {digest}): bring "
            f"benchmark/tiers/{tier}.py's traced_solve up to date with it, "
            f"then its MIRRORS digest")
