"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; without an NVIDIA GPU every test skips. On the card run
``python -m pytest tests/test_torch_kernels_gpu.py -q``. Outputs are
integers: exact equality of every output tensor (the kernels and the plain
versions also agree at unreachable states and stale lanes).
"""

import os

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import narrow, trace, wide
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import initial_v, plan_pairs, plan_to_device
from dipgenie_tpu_torch.utils.synth import CASES, random_leveled_csr

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(__file__), "data")
NPZ = ["mhc_slice_csr", "mhc_slice500_csr", "mhc_slice_wide_csr"]
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w", "hom_ptr",
            "hom_colors", "het_ptr", "het_colors")


def case_csr(case):
    """(CSR arrays, R) of a CASES tuple or a tests/data npz name. This
    module imports nothing from the test tree, so it also collects where
    an installed package named ``tests`` shadows this directory."""
    if isinstance(case, str):
        d = np.load(f"{DATA}/{case}.npz")
        return [d[k] for k in CSR_KEYS], int(d["R"])
    seed, L, kmax, R, nc = case
    return random_leveled_csr(seed, L, kmax, nc), R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES + NPZ)
def test_kernels_match_plain_versions(case, cuda):
    arrs, R = case_csr(case)
    dplan = plan_to_device(plan_pairs(*arrs, R), cuda)
    V, bps = initial_v(R, cuda), []
    for seg in dplan.segments:
        mod, name = (narrow, "narrow_run") if seg.kind == "narrow" else (
            wide, "wide_dense_run")
        got = getattr(mod, name)(seg, V)
        want = getattr(mod, name + "_ref")(seg, V)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, seg.kind, seg.t0)
        V, bps = got[0], bps + [got[1:]]
    assert torch.equal(trace.trace(dplan, bps), trace.trace_ref(dplan, bps))


@pytest.mark.parametrize("name", NPZ)
def test_cuda_dp_matches_mhc_slice_oracle(name, cuda):
    arrs, R = case_csr(name)
    d = np.load(f"{DATA}/{name}.npz")
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    assert PairDiploidDP(plan_pairs(*arrs, R), cuda).run() == want


def test_wrappers_reject_bad_inputs(cuda):
    arrs, R = case_csr("mhc_slice_wide_csr")
    dplan = plan_to_device(plan_pairs(*arrs, R), cuda)
    seg_n = next(s for s in dplan.segments if s.kind == "narrow")
    seg_w = next(s for s in dplan.segments if s.kind == "wide")
    v = initial_v(R, cuda)
    with pytest.raises(ValueError, match="dtype"):
        narrow.narrow_run(seg_n, v.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        wide.wide_dense_run(seg_w, v[:, :512].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        narrow.narrow_run(seg_n, v.t().contiguous().t())
