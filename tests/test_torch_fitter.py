"""The fitter's torch backend (K12 ``grid_nll``, ``models/fitter.py``) on
the CPU, held to the JAX package.

The plain grid NLL equals ``_grid_nll_jax`` within a relative 1e-5 (both
float32; they differ in ``log`` and ``pow`` ulps and in the order of the
sum over bins). ``fit_histogram(backend="torch")`` gives the numpy
backend's parameters and ``nll`` exactly: the float64 re-evaluation of
the best points decides. The kernel is held to the plain version on the
card by ``tests/test_torch_kernels_gpu.py -k grid_nll``.
"""

import numpy as np
import pytest
import torch

from dipgenie_tpu.models import fitter as jax_fitter
from dipgenie_tpu_torch.models import fitter
from dipgenie_tpu_torch.models.fitter import KGFitOptions, fit_histogram

FIELDS = ("u_v", "sd_v", "var_w", "zp_copy", "zp_copy_het", "p_d", "p_e",
          "err_shape")
# the float32 grids' relative difference, |a - b| / max(|b|, 1)
REL_TOL = 1e-5


def _hist3():
    """The histogram of tests/test_fitter.py:13."""
    rng = np.random.default_rng(3)
    mult = np.concatenate(
        [np.ones(5000), rng.poisson(3, 1500) + 1, rng.poisson(9, 400) + 1]
    ).astype(int)
    uniq, freq = np.unique(mult, return_counts=True)
    mm = int(uniq.max())
    return ([(int(m), float(f)) for m, f in zip(uniq, freq)],
            KGFitOptions(max_copy=10, max_x_use=mm, u_hi=float(mm)))


# the histograms of tests/test_fitter.py:84 (near ties, a spike, a tail)
NEAR_TIES = [
    [(m, 100.0) for m in range(1, 13)],
    [(1, 500.0), (2, 900.0), (3, 500.0), (5, 500.0), (6, 900.0),
     (7, 500.0)],
    [(3, 1e6)],
    [(1, 1e5), (2, 3e4), (3, 1e4), (6, 300.0), (12, 290.0)],
]
NEAR_OPT = KGFitOptions(max_copy=4, max_x_use=12, u_hi=6.0, grid_u=3,
                        grid_sd=3, grid_varw=2, grid_pd=3, grid_pe=2,
                        grid_s=2, grid_zp=3)


@pytest.mark.parametrize("sizes", [(3, 3, 2, 3, 3, 2, 2), (2, 4, 3, 2, 3,
                                                           3, 3)])
def test_plain_grid_nll_equals_jax(sizes):
    nu, nsd, nvw, nzp, npd, npe, ns = sizes
    pairs, opt = _hist3()
    xs = np.asarray([m for m, _ in pairs], np.int64)
    ys = np.asarray([f for _, f in pairs], np.float64)
    lin = fitter._linspace
    grid = (lin(1.0, 14.0, nu), lin(0.5, 2.0, nsd), lin(0.71, 4.0, nvw),
            lin(1.01, 4.0, nzp), lin(1.01, 4.0, nzp), lin(0.1, 1.0, npd),
            lin(0.0, 0.1, npe), lin(1.01, 4.0, ns))
    want = jax_fitter._grid_nll_jax(*grid, 10, xs, ys)
    got = fitter._grid_nll_torch(*grid, 10, xs, ys, "cpu")
    assert got.shape == want.shape == (nu, nsd, nvw, nzp, nzp, npd, npe, ns)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= REL_TOL, rel.max()


def test_torch_backend_equals_numpy():
    pairs, opt = _hist3()
    a = fit_histogram(pairs, opt, backend="numpy")
    b = fit_histogram(pairs, opt, backend="torch", device="cpu")
    for f in FIELDS:
        assert getattr(a.P, f) == getattr(b.P, f), f
    assert a.nll == b.nll
    assert (a.valley_x, a.peak_x) == (b.valley_x, b.peak_x)


@pytest.mark.parametrize("case", range(len(NEAR_TIES)))
@pytest.mark.parametrize("seed_k", [1, 4])
def test_torch_backend_equals_numpy_near_ties(case, seed_k):
    pairs = NEAR_TIES[case]
    a = fit_histogram(pairs, NEAR_OPT, exact_topk=1, backend="numpy")
    b = fit_histogram(pairs, NEAR_OPT, exact_topk=seed_k, backend="torch",
                      device="cpu")
    assert a.P == b.P and a.nll == b.nll


def test_torch_backend_on_a_missing_card_raises():
    from dipgenie_tpu_torch.device import NoCudaDevice

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pairs, opt = _hist3()
    with pytest.raises(NoCudaDevice):
        fit_histogram(pairs, opt, backend="torch")
    with pytest.raises(ValueError, match="'numpy' or 'torch'"):
        fit_histogram(pairs, opt, backend="jax")
