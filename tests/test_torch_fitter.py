"""The fitter's torch backend (K12 ``grid_nll``, ``models/fitter.py``) on
the CPU, held to the JAX package.

The plain grid NLL equals ``_grid_nll_jax`` within a relative 1e-5 (both
float32; they differ in ``log`` and ``pow`` ulps and in the order of the
sum over bins), also with frozen axes, one or 200 bins and 1 or 20
copies. ``fit_histogram(backend="torch")`` gives the numpy backend's
parameters and ``nll`` exactly: the float64 re-evaluation of the best
points decides. The host side of the two kernels of ``csrc/grid_nll.cu``
is held here too: the one-copy packing of the axes, ``grid_tables`` on the
CPU, and K12's launch geometry and 32-bit division constants (every grid
point stored exactly once, in an emulation of the kernel's index
arithmetic). The kernels are held to the plain versions on the card by
``tests/test_torch_kernels_gpu.py -k grid``.
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


def _bins(nx):
    """``(xs, ys)``: _hist3's bins, or ``nx`` bins 1..nx of a drawn
    decaying histogram."""
    if nx is None:
        pairs, _ = _hist3()
        return (np.asarray([m for m, _ in pairs], np.int64),
                np.asarray([f for _, f in pairs], np.float64))
    rng = np.random.default_rng(nx)
    xs = np.arange(1, nx + 1, dtype=np.int64)
    return xs, np.round(1e4 * np.exp(-xs / 40.0)) + rng.integers(1, 50, nx)


def _grid(nu, nsd, nvw, nzp, npd, npe, ns):
    """The eight axes; an axis of length 1 is frozen at its midpoint."""
    lin = fitter._linspace
    return (lin(1.0, 14.0, nu), lin(0.5, 2.0, nsd), lin(0.71, 4.0, nvw),
            lin(1.01, 4.0, nzp), lin(1.01, 4.0, nzp), lin(0.1, 1.0, npd),
            lin(0.0, 0.1, npe), lin(1.01, 4.0, ns))


# (u, sd, vw, zp (and zph), pd, pe, s), then optionally (bins, max_copy):
# _hist3's bins and 10 copies when not given
@pytest.mark.parametrize("sizes", [
    (3, 3, 2, 3, 3, 2, 2), (2, 4, 3, 2, 3, 3, 3),
    # fit_varw=False and fit_error=False freeze VW, PE and SS
    pytest.param((3, 3, 1, 3, 3, 1, 1), id="frozen"),
    pytest.param((2, 2, 2, 2, 3, 2, 2, 1, 10), id="nx1"),
    pytest.param((2, 2, 2, 2, 3, 2, 2, 200, 10), id="nx200"),
    pytest.param((2, 3, 2, 2, 3, 2, 2, None, 1), id="copies1"),
    pytest.param((2, 3, 2, 2, 3, 2, 2, None, 20), id="copies20"),
])
def test_plain_grid_nll_equals_jax(sizes):
    nu, nsd, nvw, nzp, npd, npe, ns, *rest = sizes
    nx, max_copy = rest or (None, 10)
    xs, ys = _bins(nx)
    grid = _grid(nu, nsd, nvw, nzp, npd, npe, ns)
    want = jax_fitter._grid_nll_jax(*grid, max_copy, xs, ys)
    got = fitter._grid_nll_torch(*grid, max_copy, xs, ys, "cpu")
    assert got.shape == want.shape == (nu, nsd, nvw, nzp, nzp, npd, npe, ns)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= REL_TOL, rel.max()


def test_axes_on_round_trips_every_axis():
    """grid_inputs' one copy: ten axes packed end to end come back as views
    of one buffer, each equal to the axis's own float32 conversion."""
    rng = np.random.default_rng(5)
    axes = (*_grid(7, 1, 5, 7, 7, 1, 5), np.arange(1, 15, dtype=np.int64),
            rng.uniform(0.0, 1e6, 14))
    views = fitter.axes_on("cpu", *axes)
    assert len(views) == len(axes) == 10
    base = views[0].untyped_storage().data_ptr()
    for a, v in zip(axes, views):
        want = torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32)
        assert v.dtype == torch.float32 and v.shape == want.shape
        assert torch.equal(v, want)
        assert v.untyped_storage().data_ptr() == base


@pytest.mark.parametrize("sizes,nx,max_copy", [
    ((7, 7, 5, 7, 7, 5, 5), None, 10), ((3, 3, 1, 3, 3, 1, 1), None, 10),
    ((2, 2, 2, 2, 3, 2, 2), 1, 1), ((2, 3, 2, 2, 3, 2, 2), 200, 20)])
def test_grid_tables_on_the_cpu_is_the_plain_version(sizes, nx, max_copy):
    xs, _ = _bins(nx)
    U, SD, VW, ZP, ZPH, _, _, SS = _grid(*sizes)
    want = fitter._grid_tables_torch(U, SD, VW, ZP, ZPH, SS, max_copy, xs,
                                     "cpu")
    before = fitter.grid_tables.launches
    for axes in ((U, SD, VW, ZP, ZPH, SS),
                 fitter.axes_on("cpu", U, SD, VW, ZP, ZPH, SS)):
        got = fitter.grid_tables(*axes, max_copy, xs, "cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fitter.grid_tables.launches == before


def _divide(n, div):
    d, mul, shift = (np.uint64(v) for v in div)
    return (n * mul) >> shift


def test_divider_is_exact():
    """K12's 32-bit division: (n * mul) >> shift == n // d over the
    kernel's whole range 0 <= n < 2^31, at the edges and on draws."""
    rng = np.random.default_rng(7)
    ds = [1, 2, 3, 5, 7, 25, 35, 175, 12005, 2 ** 16 + 1, 2 ** 30,
          2 ** 31 - 1, *rng.integers(1, 2 ** 31, 40).tolist()]
    for d in ds:
        div = fitter.divider(d)
        assert div[0] == d and 0 < div[1] < 2 ** 32
        n = np.concatenate([
            np.arange(0, 4 * d + 3) if d < 4096 else np.arange(0, 4099),
            d * np.arange(1, 64) - 1, d * np.arange(1, 64),
            np.arange(2 ** 31 - 300, 2 ** 31),
            rng.integers(0, 2 ** 31, 20000)]).astype(np.uint64)
        n = n[n < 2 ** 31]
        assert np.array_equal(_divide(n, div), n // np.uint64(d)), d


def _kernel_stores(geometry):
    """The flat output index of every store of K12 under ``geometry``, in
    the kernel's own arithmetic (csrc/grid_nll.cu grid_nll_kernel), with
    the outer point's indices."""
    p, slots, blocks, npd, nx = (int(v) for v in geometry[:5])
    per_outer, nps, ns, nzph, nzp, nvw, nsd = geometry[5:].reshape(7, 3)
    assert blocks * fitter.GRID_THREADS >= slots
    slot = np.arange(blocks * fitter.GRID_THREADS, dtype=np.uint64)
    slot = slot[slot < slots]
    o = _divide(slot, per_outer)
    r = slot - o * np.uint64(per_outer[0])
    chunk = _divide(r, nps)
    ps = r - chunk * np.uint64(nps[0])
    ipe = _divide(ps, ns)
    t = _divide(o, nzph)
    izph = o - t * np.uint64(nzph[0])
    t2 = _divide(t, nzp)
    izp = t - t2 * np.uint64(nzp[0])
    t = _divide(t2, nvw)
    ivw = t2 - t * np.uint64(nvw[0])
    iu = _divide(t, nsd)
    isd = t - iu * np.uint64(nsd[0])
    idx = (iu, isd, ivw, izp, izph, ipe, ps - ipe * np.uint64(ns[0]))
    stores = []
    for j in range(p):
        pd = chunk * np.uint64(p) + np.uint64(j)
        keep = pd < npd
        stores.append(((o * np.uint64(npd) + pd) * np.uint64(nps[0])
                       + ps)[keep])
    return np.concatenate(stores), o, idx


@pytest.mark.parametrize("dims", [
    (1, 1, 1, 1, 1, 1, 1, 1, 1), (7, 7, 5, 7, 7, 7, 5, 5, 14),
    (3, 1, 2, 1, 5, 1, 1, 7, 200), (2, 3, 1, 2, 2, 9, 2, 3, 3),
    (1, 2, 1, 1, 3, 16, 1, 1, 1), (2, 1, 3, 1, 1, 17, 3, 1, 5),
    (5, 3, 1, 4, 1, 8, 1, 11, 2)])
def test_grid_nll_geometry_covers_every_point_once(dims):
    """Every grid point is stored by exactly one (thread, j), whatever the
    axes: all 1, the default grid, frozen axes, pd cut in chunks (9: 2
    of 5; 16: 2 of 8; 17: 3 of 6) and a pd axis of 8; the thread's outer
    indices decompose its outer point."""
    geometry = fitter.grid_nll_geometry(dims)
    assert geometry.dtype == np.uint32 and len(geometry) == 5 + 7 * 3
    p, npd = int(geometry[0]), dims[5]
    assert 1 <= p <= fitter.GRID_P_MAX and p * (-(-npd // p)) - npd < p
    stores, o, idx = _kernel_stores(geometry)
    points = int(np.prod(dims[:8]))
    assert np.array_equal(np.sort(stores), np.arange(points, dtype=np.uint64))
    nu, nsd, nvw, nzp, nzph = dims[:5]
    iu, isd, ivw, izp, izph, ipe, is_ = idx
    for i, n in zip(idx, (nu, nsd, nvw, nzp, nzph, dims[6], dims[7])):
        assert (i < np.uint64(n)).all()
    assert np.array_equal(
        (((iu * np.uint64(nsd) + isd) * np.uint64(nvw) + ivw)
         * np.uint64(nzp) + izp) * np.uint64(nzph) + izph, o)


def test_grid_nll_geometry_refuses_what_it_cannot_index():
    with pytest.raises(ValueError, match="empty"):
        fitter.grid_nll_geometry((7, 7, 5, 7, 0, 7, 5, 5, 14))
    with pytest.raises(ValueError, match="32-bit"):
        fitter.grid_nll_geometry((64, 64, 64, 64, 64, 1, 2, 1, 14))


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
