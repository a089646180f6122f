"""The capability checks (``probes caps`` / ``caps2``, ``ops/caps.py``)
against the JAX package's capability probes (``scripts/tpu_caps_probe.py``,
``scripts/tpu_caps_probe2.py``, K8 and K9), on the CPU.

The scripts are loaded from their files unchanged, and their Pallas kernels
run in interpret mode (the ``interpreted`` fixture of
``tests/test_torch_probes.py``). For each of the 30 checks, on the
script's inputs and on second inputs drawn from a seed: the port's plain
version == the script's kernel == the numpy expectation. The tolerance is
exact equality of every element; the float outputs are compared as floats
(their inputs are small integers, so every product is exact).
"""

import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import caps
from dipgenie_tpu_torch.probes import __main__ as probes_main
from dipgenie_tpu_torch.probes import caps as probe_caps
from dipgenie_tpu_torch.probes import caps_tables
from tests.test_torch_probes import interpreted, load_script  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [None, *caps_tables.SECOND_SEEDS]


def script_mk(name):
    """The script's ``mk_*`` function of a check."""
    script = caps_tables.CHECKS[name][0]
    mod = load_script(script)
    checks = mod.CAPS if script == "tpu_caps_probe" else dict(mod.CHECKS)
    return checks[name]


def test_checks_are_the_scripts_in_their_order():
    assert list(load_script("tpu_caps_probe").CAPS) == list(caps_tables.K8)
    assert [n for n, _ in load_script("tpu_caps_probe2").CHECKS] == list(
        caps_tables.K9)
    assert caps.NAMES == caps_tables.K8 + caps_tables.K9
    assert list(caps.CHECKS) == list(caps_tables.CHECKS) == list(caps.NAMES)


def test_check_ids_match_the_kernels_header():
    """``dg_caps`` takes a check's index in ``NAMES`` as its id: the enum
    of ``csrc/caps.cuh`` lists the same names in the same order."""
    with open(os.path.join(REPO, "dipgenie_tpu_torch", "csrc",
                           "caps.cuh")) as fh:
        body = re.search(r"enum Check : int \{(.*?)\};", fh.read(), re.S)[1]
    ids = re.findall(r"^\s*([A-Z0-9_]+),?$", body, re.M)
    assert ids[-1] == "N_CHECKS"
    assert [i.lower() for i in ids[:-1]] == list(caps.NAMES)
    assert _header_ids() == list(caps.NAMES)


def _header_ids():
    with open(os.path.join(REPO, "dipgenie_tpu_torch", "csrc",
                           "caps.cuh")) as fh:
        body = re.search(r"enum Check : int \{(.*?)\};", fh.read(), re.S)[1]
    return [i.lower() for i in re.findall(r"^\s*([A-Z0-9_]+),?$", body,
                                          re.M)[:-1]]


@pytest.mark.parametrize("name", caps.NAMES)
def test_launch_record_is_the_spec_and_the_header_id(name):
    """Each wrapper's launch record, made once: the check id of
    ``csrc/caps.cuh``, the inputs' and output's ``(dtype, shape)`` and
    the kernel's argument of ``SPECS``; its ``kernels.Launch`` checks
    against the same tuples and binds ``dg_caps`` only at first use."""
    kern = caps.CHECKS[name][0]
    ins, out, plain, arg = caps.SPECS[name]
    assert kern.record == (_header_ids().index(name), ins, out, arg)
    assert kern.record.check == caps.NAMES.index(name)
    assert caps.CHECKS[name][1] is plain
    launch = kern.launch
    assert (launch.name, launch.entry) == (name, "dg_caps")
    assert launch.ins is kern.record.ins and launch.out is kern.record.out
    assert launch._fn is None
    for dtype, shape in (*ins, out):
        assert isinstance(dtype, torch.dtype) and type(shape) is tuple
        assert all(type(n) is int for n in shape)


@pytest.mark.parametrize("name", caps.NAMES)
def test_launch_check_refuses_cpu_tensors(name):
    """The launch path's checks take only CUDA tensors: on CPU tensors
    (the wrapper sends those to the plain version) and on a wrong count
    of tensors they raise ``ValueError`` before any launch."""
    kern = caps.CHECKS[name][0]
    ins, _ = caps_tables.make(name)
    args = probe_caps.to_device(ins, "cpu")
    with pytest.raises(ValueError, match="input 0: want a CUDA tensor"):
        kern.launch.check(args)
    with pytest.raises(ValueError, match=f"takes {len(args)} tensors"):
        kern.launch.check(args + args[:1])
    with pytest.raises(ValueError, match=f"takes {len(args)} tensors"):
        kern(*args, *args[:1])
    assert kern.launches == 0 and kern.launch._fn is None


@pytest.mark.parametrize("name", caps.NAMES)
def test_tables_are_byte_identical_to_the_scripts(name):
    """The script's arrays byte for byte, its expectation value for value
    (its popcount is int64, the kernel's output int32), and the line of
    its ``mk_*`` function."""
    mk = script_mk(name)
    _, args, want = mk()
    ins, expect = caps_tables.make(name)
    assert len(ins) == len(args)
    for got, w in zip(ins, args):
        w = np.asarray(w)
        assert got.dtype == w.dtype and got.shape == w.shape
        assert got.tobytes() == w.tobytes()
    want = np.asarray(want)
    assert expect.shape == want.shape and np.array_equal(expect, want)
    assert expect.dtype == (np.int32 if name == "popcount" else want.dtype)
    assert inspect.getsourcelines(mk)[1] == caps_tables.CHECKS[name][1]


@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("name", caps.NAMES)
def test_plain_version_matches_script_kernel(name, seed, interpreted):
    """Plain version == the script's Pallas kernel (interpret mode) == the
    numpy expectation, every element; on the CPU the wrapper takes the
    plain version and launches nothing."""
    fn, _, _ = script_mk(name)()
    ins, expect = caps_tables.make(name, seed)
    out = np.asarray(fn(*(jnp.asarray(a) for a in ins)))
    assert out.dtype == expect.dtype and out.shape == expect.shape
    assert np.array_equal(out, expect)
    kern, plain = caps.CHECKS[name]
    args = probe_caps.to_device(ins, "cpu")
    want = torch.from_numpy(expect)
    got = plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(kern(*args), want) and kern.launches == 0


def test_second_inputs_take_the_paths_the_scripts_miss():
    rows = [caps_tables.make("dyn_slice_row_bcast", s)[0][0][0, 0] % 16
            for s in SEEDS]
    assert rows[0] == 0 and all(rows[1:])
    branches = [int(caps_tables.make("switch_compute", s)[0][0][0])
                for s in SEEDS]
    assert sorted(branches) == [0, 1, 2]
    sels = [caps_tables.make("scalar_prefetch_grid", s)[0][0] for s in SEEDS]
    assert all(not np.array_equal(sels[0], s) for s in sels[1:])
    for s in SEEDS[1:]:
        words = caps_tables.make("popcount", s)[0][0]
        assert (words >> 31).any() and (words.view(np.int32) < 0).any()
        x = caps_tables.make("convert_f32_i32_3d", s)[0][0]
        assert ((x < 0) & (x != np.trunc(x))).any()
    # the script's own: no bit 31, no fraction
    assert not (caps_tables.make("popcount")[0][0] >> 31).any()


@pytest.mark.parametrize("probe,names", [("caps", caps_tables.K8),
                                         ("caps2", caps_tables.K9)])
def test_probe_prints_15_pass_lines_on_the_cpu(probe, names, capsys):
    assert probes_main.main([probe, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"PASS  {n}" for n in names]
    assert probes_main.main([probe, names[3], "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"PASS  {names[3]}"]


def test_probe_exits_1_on_a_wrong_or_failing_check(capsys, monkeypatch):
    """Unlike the scripts, which always exit 0, a probe whose check is
    WRONG or FAILs exits 1, and says which."""
    def wrong(a):
        return torch.roll(a, 1, 1)

    def failing(a):
        raise RuntimeError("launch refused")

    monkeypatch.setitem(caps.CHECKS, "roll_lane", (wrong, wrong))
    monkeypatch.setitem(caps.CHECKS, "popcount", (failing, failing))
    assert probes_main.main(["caps", "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 15 and sum(x.startswith("PASS  ") for x in out) == 13
    assert [x for x in out if x.startswith("WRONG roll_lane: got")]
    assert "(4096 of 4096 elements differ)" in out[4]
    assert out[12] == "FAIL  popcount: RuntimeError: launch refused"


def test_probe_rejects_an_unknown_check(capsys):
    with pytest.raises(SystemExit):
        probes_main.main(["caps2", "roll_lane", "--device", "cpu"])
    assert "unknown check 'roll_lane'" in capsys.readouterr().err
