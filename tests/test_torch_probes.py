"""The port's probes (``dipgenie_tpu_torch/probes``) against the JAX
package's probe scripts (``scripts/tpu_*_probe.py``), on the CPU.

The scripts' Pallas kernels run in interpret mode: each script is loaded
from its file, ``pl.pallas_call`` is patched to pass ``interpret=True``
and to keep the call's full outputs (the scripts' ``run`` returns a scalar
for the floor kernels and drops the edge kernel's backpointers), and
``jax.disable_jit()`` makes those outputs concrete. The same numpy tables,
made from a seed, go to the script's kernel and to the port's plain
PyTorch version. Everything is integer: the tolerance is exact equality on
every compared element (rows 0..18 of the pair kernel's 24-row
backpointer block; the TPU kernel never writes the rest).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dipgenie_tpu_torch.ops import (
    chain_edge, chain_floor, chain_pair, chain_ring,
)
from dipgenie_tpu_torch.probes import __main__ as probes_main
from dipgenie_tpu_torch.probes import floor, tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# chains whose states are still alive at the end (the scripts' own chain,
# seed 0, dies out within a few levels): (levels, seed, destinations drawn
# one edge each); 9 of 16 leaves destinations with several edges and with
# none
LIVE6 = [(6, 35, 16), (6, 22, 9)]
LIVE40 = [(40, 8, 16), (40, 29, 9)]


def load_script(name):
    """A module of ``scripts/`` loaded from its file, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(monkeypatch):
    """Pallas calls run in interpret mode, eagerly; the dict holds the
    outputs of the last call under ``"out"``."""
    kept = {}
    pallas_call = pl.pallas_call

    def keeping(*args, **kwargs):
        call = pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            kept["out"] = call(*operands)
            return kept["out"]

        return run

    monkeypatch.setattr(pl, "pallas_call", keeping)
    with jax.disable_jit():
        yield kept


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), what


def case_floor0(kept, chain):
    tbl = tables.floor_tables(7, seed=3)
    fn, _ = load_script("tpu_floor_probe").build_pallas0(7)
    fn(tbl)
    bp, acc = chain_floor.chain_floor(*_t([tbl]))
    same(bp, kept["out"], "bp")
    same(acc, tbl.sum(0, dtype=np.int32), "acc")


def case_step16(kept, chain):
    """C with random low 4 bits, so that the backpointers say which (p, q)
    won; the TPU kernel's state stays in scratch, so the state is held
    through the backpointers of the levels after it. ``chain`` is the
    length (5, or one past the CUDA kernel's table ring)."""
    T = chain or 5
    pit, pwt, C = tables.step16_tables(T, seed=0, tie_bits=True)
    fn, _ = load_script("tpu_floor_probe").build_pallas16(T)
    fn(pit, pwt, C)
    bp, v = chain_floor.chain_step16(*_t([pit, pwt, C]))
    same(bp, kept["out"], "bp")
    assert len(np.unique(bp.numpy())) == 16
    assert v.shape == (304, 16) and (v > tables.NEG).any()


def case_step16_outside(kept, chain):
    """Corner entries of ``pit`` outside ``[0, 16)`` (negative, past the
    block, the int32 ends), which the TPU kernel's select-form gathers
    match to nothing: the plain version gathers NEG there too."""
    T = 5
    pit, pwt, C = tables.step16_tables(T, seed=3, tie_bits=True)
    rng = np.random.default_rng(4)
    bad = rng.random((T, 4, 16)) < 0.2
    pit[:, :4, :16] = np.where(
        bad, rng.choice([-1, 16, 17, -(2**31), 2**31 - 1], bad.shape),
        pit[:, :4, :16])
    pwt[:, :4, :16] = (rng.random(bad.shape) < 0.3).astype(np.int32)
    fn, _ = load_script("tpu_floor_probe").build_pallas16(T)
    fn(pit, pwt, C)
    bp, v = chain_floor.chain_step16(*_t([pit, pwt, C]))
    same(bp, kept["out"], "bp")
    assert bad.any() and (v > tables.NEG).any()


def case_pair(kept, chain):
    T, seed, cover = chain
    tbl, _ = tables.pair_tables(T, seed, cover)
    fn, args, _ = load_script("tpu_pair_probe").build(T)
    _, want_v, want_bp = fn(args[0], tbl)
    bp, v = chain_pair.chain_pair(*_t([tbl]))
    same(v, want_v, "v")
    same(bp[:, :19], np.asarray(want_bp)[:, :19], "bp rows 0..18")
    assert not bp[:, 19:].any()
    assert (v > tables.NEG).sum() > 500 and np.count_nonzero(bp) > 1000


def case_edge(kept, chain):
    T, seed, cover = chain
    *tabs, _ = tables.edge_tables(T, seed, cover)
    fn, _, _ = load_script("tpu_edge_probe").build(T)
    fn(*tabs)
    want_bp, want_v = kept["out"]
    bp, v = chain_edge.chain_edge(*_t(tabs))
    same(v, want_v, "v")
    same(bp, want_bp, "bp")
    assert (v > tables.NEG).sum() > 500 and np.count_nonzero(bp) > 1000


# one past the CUDA kernels' table ring (ops/chain_ring.py RING_DEPTH)
PAST_RING = chain_ring.RING_DEPTH + 1


@pytest.mark.parametrize("case,chain", [
    (case_floor0, None), (case_step16, None), (case_step16, PAST_RING),
    (case_step16_outside, None),
    *[(case_pair, c) for c in LIVE6], *[(case_edge, c) for c in LIVE6],
    (case_edge, (PAST_RING, 35, 16)),
], ids=lambda x: x.__name__[5:] if callable(x) else str(x))
def test_plain_version_matches_script_kernel(case, chain, interpreted):
    case(interpreted, chain)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["pair", "edge"])
def test_tables_are_byte_identical_to_the_scripts(which, seed):
    T = 9
    script = load_script(f"tpu_{which}_probe")
    make = tables.pair_tables if which == "pair" else tables.edge_tables
    *want, want_e = script.make_tables(T, seed)
    *got, got_e = make(T, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for g, w in zip(got_e, want_e):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    same(tables.chain_oracle(got_e), script.oracle(want_e), "oracle")


def test_floor_tables_are_byte_identical_to_the_scripts():
    script = load_script("tpu_floor_probe")
    T = 6
    for build, got in (
        (script.build_pallas0, (tables.floor_tables(T),)),
        (script.build_pallas16, tables.step16_tables(T)),
        (script.build_scandus, tables.scandus_tables(T)),
    ):
        _, args = build(T)
        for g, w in zip(got, args):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("chain", LIVE40, ids=str)
@pytest.mark.parametrize("which", ["pair", "edge"])
def test_plain_version_matches_oracle(which, chain):
    """K6's and K7's plain versions equal the numpy oracle on 40 levels,
    and so each other: the two draw the same chain from the same seed."""
    T, seed, cover = chain
    if which == "pair":
        tbl, hostE = tables.pair_tables(T, seed, cover)
        v = chain_pair.chain_pair(*_t([tbl]))[1].reshape(19, 16, 16)
    else:
        *tabs, hostE = tables.edge_tables(T, seed, cover)
        v = chain_edge.chain_edge(*_t(tabs))[1]
    want = tables.committed(tables.chain_oracle(hostE))
    assert (want > tables.NEG).any()
    same(v.numpy().astype(np.int64), want, "v")


@pytest.mark.parametrize("T", [24, 120])
def test_live_chain_keeps_every_state_reachable(T):
    """``tables.LIVE`` is the seed's own draw apart from the weights, and
    every state of it is reachable from level 24 on; the script's chain
    has none left by then."""
    tbl, hostE = tables.pair_tables(T, **tables.LIVE)
    drawn, _ = tables.pair_tables(T, tables.LIVE["seed"])
    assert not tbl[:, 5].any() and drawn[:, 5].any()
    same(np.delete(tbl, 5, axis=1), np.delete(drawn, 5, axis=1), "tbl")
    v = chain_pair.chain_pair(*_t([tbl]))[1].numpy()
    assert (v > tables.NEG).all()
    same(v.reshape(19, 16, 16).astype(np.int64),
         tables.committed(tables.chain_oracle(hostE)), "v")
    dead = chain_pair.chain_pair(*_t([tables.pair_tables(T)[0]]))[1]
    assert not (dead.numpy() > tables.NEG).any()


def test_scandus_matches_script_loop():
    """The host-dispatched loop against the script's ``lax.scan``."""
    T = 4
    fn, args = load_script("tpu_floor_probe").build_scandus(T)
    run, (PI, C, V0, buf) = floor.build_scandus(T, torch.device("cpu"))
    V, buf = run(PI, C, V0, buf)
    assert int(V[0, 0, 0]) + int(buf[0]) == int(fn(*args))
    # the same body in numpy, every element
    PIn, Cn = tables.scandus_tables(T)
    Vn = np.full((19, 16, 16), tables.NEG, np.int32)
    for t in range(T):
        best = np.full((19, 16, 16), -(2**31) + 1, np.int32)
        for p in range(4):
            A = Vn[:, PIn[t][:, p], :]
            for q in range(4):
                G = A[:, :, PIn[t][:, q]]
                best = np.maximum(best, G * 16 + Cn[t][
                    p * 16:p * 16 + 16, q * 16:q * 16 + 16][None])
        Vn = best >> 4
        same(buf[t * 4864:(t + 1) * 4864].numpy(),
             (best & 15).astype(np.int16).reshape(-1), f"bp of level {t}")
    same(V.numpy(), Vn, "V")


def test_edge_wrapper_checks_the_transposed_twins():
    tabs = _t(tables.edge_tables(3)[:5])
    tabs[3] = tabs[3].clone()
    tabs[3][1, 0, 0] += 1
    with pytest.raises(ValueError, match="transposes"):
        chain_edge.chain_edge(*tabs)
    with pytest.raises(ValueError, match="transposes"):
        chain_edge.check_twins(*tabs[:4])
    with pytest.raises(ValueError, match="int32"):
        chain_pair.chain_pair(torch.zeros((2, 8, 256), dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        chain_floor.chain_floor(torch.zeros((2, 8, 256), dtype=torch.int32))


@pytest.mark.parametrize("argv,name", [
    (["floor", "scan1", "--lengths", "3", "6"], "scan1"),
    (["floor", "floor0", "--lengths", "3", "6"], "floor0"),
    (["floor", "step16", "--lengths", "2", "4"], "step16"),
    (["floor", "scandus", "--lengths", "3", "6"], "scandus"),
    (["pair", "3", "6"], "pair16"),
    (["edge", "3", "6"], "edge16"),
], ids=lambda x: x if isinstance(x, str) else "-".join(x[:2]))
def test_probe_prints_a_slope_line_on_the_cpu(argv, name, capsys):
    assert probes_main.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith(f"{name}: ")]
    assert len(line) == 1 and "us/level (slope" in line[0]
    # a CPU time is never printed under a device's name
    assert "not a device time" in line[0] and "CUDA" not in line[0]
    if name in ("pair16", "edge16"):
        # the script's chain, then the one that stays alive
        assert out.count("correctness: OK") == 2
        live = [x for x in out.splitlines() if x.startswith(f"{name}-live: ")]
        assert len(live) == 1 and "us/level (slope" in live[0]
        assert "40 levels: 4864 of 4864" in out


def test_dp_stages_on_the_cpu(capsys):
    assert probes_main.main(["dp-stages", "--device", "cpu", "--L",
                             "300"]) == 0
    out = capsys.readouterr().out
    for stage in ("plan:", "ship:", "forward:", "  narrow:", "  wide:",
                  "traceback:", "run() total:"):
        assert any(x.startswith(stage) for x in out.splitlines()), stage
    assert "CUDA" not in out


def test_stage_marks_ride_on_the_one_forward_loop():
    """``dp_stages`` stamps the runs through ``forward``'s own callback:
    one call per segment, in order, and the same pass as without it."""
    from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
    from dipgenie_tpu_torch.ops.plan import plan_pairs
    from dipgenie_tpu_torch.probes import dp_stages
    from dipgenie_tpu_torch.utils.synth import mhc_shaped_csr

    dp = PairDiploidDP(plan_pairs(*mhc_shaped_csr(L=300, seed=1, n_bands=1),
                                  18), "cpu")
    seen = []
    V, bps = dp.forward(on_segment=seen.append)
    assert seen == dp.dplan.segments and len(bps) == len(seen)
    V2, _, seconds, kinds = dp_stages.forward_by_kind(
        dp, dp_stages._Marks(torch.device("cpu")))
    assert torch.equal(V, V2) and torch.equal(V, dp.forward()[0])
    assert sum(n for n, _, _ in kinds.values()) == len(seen)
    assert sum(tr for _, tr, _ in kinds.values()) == 299
    assert 0 < sum(s for _, _, s in kinds.values()) <= seconds


def test_parity_gate_on_the_cpu_writes_its_verdict(tmp_path, capsys):
    out = tmp_path / "gate" / "PARITY.json"
    assert probes_main.main(["parity-gate", "--device", "cpu", "--limit",
                             "4", "-o", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["ok"] is True and verdict["cases"] == 4
    assert verdict["passed"] == 4 and verdict["backend"] == "cpu"
    assert verdict["card"] is None
    assert [r["case"] for r in verdict["results"]][0] == "rand-0-L12-k5-R5"
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"] is True


def test_parity_gate_lists_the_scripts_cases():
    from dipgenie_tpu_torch.probes import parity_gate

    names = [c[0] for c in parity_gate.cases()]
    assert len(names) == len(set(names)) >= 24
    assert names[-4:] == ["int16-bp-overflow", "ladder-extension-w140",
                          "wide-commit-stale-window",
                          "wide-commit-hole-window"]


@pytest.mark.parametrize("probe,code", [
    ("floor", 1), ("pair", 1), ("edge", 1), ("dp-stages", 1),
    ("parity-gate", 2), ("caps", 1), ("caps2", 1),
])
def test_probe_stops_without_a_card(probe, code, capsys, tmp_path,
                                    monkeypatch):
    """Asked for the card (the default) with none present, a probe exits
    non-zero with a message before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    assert probes_main.main([probe]) == code
    cap = capsys.readouterr()
    assert "torch.cuda.is_available() is false" in cap.err
    assert cap.out == "" and not list(tmp_path.iterdir())


def test_unknown_probe_prints_usage(capsys):
    assert probes_main.main(["nope"]) == 2
    assert "usage:" in capsys.readouterr().err
