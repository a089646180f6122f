"""The comparison that decides ``correct`` fails what it must: the
control (the reference with its tie rule reversed, in the program's place)
and the faults a cell can have, planted under the timed path of a run
driven on the CPU at a tiny size. A run on one chip has no exchange
between chips to leave out."""

import pytest

import control
import harness
from dipgenie_tpu_torch.ops import diploid_pair, fused


@pytest.mark.parametrize("config", ["mhc4_r18"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_control_is_not_correct(copy, config, seed):
    bench = harness.load_bench(copy / "BENCHMARK.json")
    res = control.run_control(bench, str(copy), config, seed, "cpu",
                              bench_dir=str(copy / "benchmark"))
    assert res["correct"] is False
    assert res["checks"]["steps_off"]["value"] > 0


def _alter(transitions):
    t = list(transitions)
    lv, pi, pj, i2, j2, wu, wv = t[len(t) // 2]
    t[len(t) // 2] = (lv, pi, pj, i2, j2, 1 - wu, wv)
    return t


def plant_pair(monkeypatch, fault):
    if fault == "answer_altered":
        real = diploid_pair.assemble
        monkeypatch.setattr(diploid_pair, "assemble", lambda v, recs: (
            lambda out: (out[0], out[1], _alter(out[2])))(real(v, recs)))
        return
    # a run returns its state unchanged: every run ("state_unchanged"), or
    # every other run, half of the forward's work left out
    # ("half_left_out")
    seen = []
    for kind, real in list(diploid_pair.RUNS.items()):
        def run(seg, V, real=real):
            V_out, *bp = real(seg, V)
            seen.append(seg)
            drop = fault == "state_unchanged" or len(seen) % 2 == 0
            return (V if drop else V_out, *bp)
        run.launches = 0
        monkeypatch.setitem(diploid_pair.RUNS, kind, run)


def plant_fused(monkeypatch, fault):
    if fault == "answer_altered":
        real = fused.path_transitions
        monkeypatch.setattr(fused, "path_transitions",
                            lambda rows: _alter(real(rows)))
        return
    real = fused.fused_forward

    def forward(dev, t0, t1, V, bp):
        bp.zero_()
        if fault == "state_unchanged":
            return V
        return real(dev, t0, t0 + (t1 - t0) // 2, V, bp)
    forward.launches = 0
    monkeypatch.setattr(fused, "fused_forward", forward)


@pytest.mark.parametrize("cell", ["mhc4.pair", "mhc4.fused"])
@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged",
                                   "half_left_out"])
def test_planted_fault_is_not_correct(copy, monkeypatch, cell, fault):
    (plant_pair if cell.endswith("pair") else plant_fused)(monkeypatch, fault)
    bench = harness.load_bench(copy / "BENCHMARK.json")
    rec = harness.run_cell(bench, str(copy), cell, 5, 0.2, False, "cpu",
                           bench_dir=str(copy / "benchmark"))
    out = harness.result_line(bench, rec, False,
                              bench_dir=str(copy / "benchmark"))
    assert out["correct"] is False
    assert out["failed"] == out["attempted"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())

