"""The port's driver entry points (``dipgenie_tpu_torch/entry.py``), the
counterparts of ``__graft_entry__.py``, on the CPU: ``entry`` is one K1
run equal to its plain version, and ``dryrun_multichip(4)`` passes in four
gloo ranks (dp 2 × tp 2: the dp sketch count, the tp pair DP on both MHC
slices against their baked oracles)."""

import pytest
import torch

from dipgenie_tpu_torch.entry import dryrun_multichip, entry, load_slice
from dipgenie_tpu_torch.ops.narrow import narrow_run, narrow_run_ref
from tests.torch_tp_ranks import run_ranks


def test_entry_is_one_k1_run_equal_to_its_plain_version():
    fn, args = entry(device="cpu")
    assert fn is narrow_run and args[0].kind == "narrow"
    got, want = fn(*args), narrow_run_ref(*args)
    assert len(got) == 3
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[0].max()) > 0


def test_entry_on_a_missing_card_raises():
    from dipgenie_tpu_torch.device import NoCudaDevice

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDevice):
        entry()


def test_dryrun_needs_its_process_group():
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_four_ranks(tmp_path):
    ranks = run_ranks(4, {"mesh": (2, 2), "dryrun": 4}, str(tmp_path))
    assert [r["dryrun"] for r in ranks] == [True] * 4
    assert [(r["dp_rank"], r["tp_rank"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_slices_carry_their_oracles():
    for name in ("mhc_slice_csr", "mhc_slice_wide_csr"):
        arrs, R, (value, shet, transitions) = load_slice(name)
        assert len(arrs) == 8 and R > 0
        assert len(transitions) == len(arrs[0]) - 2
