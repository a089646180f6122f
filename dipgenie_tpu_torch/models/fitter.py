"""Histogram mixture-model fitter: full grid search, vectorized.

Reproduces the reference fallback grid fitter (reference: src/Fitter.hpp:
361-407) which evaluates ~2.1M parameter combinations
[u_v, sd_v, var_w, zp_copy, zp_copy_het, p_d, p_e, err_shape] against the
k-mer multiplicity histogram NLL (Fitter.hpp:127-144), with bounds/grids
from KGFitOptions (Fitter.hpp:25-46) and the strict ``<`` first-minimum
tie rule of the nested loops (Fitter.hpp:391-405).

Strategy here (vectorized instead of 8 nested scalar loops):
  1. factorized vectorized NLL over the whole grid (numpy float64, or
     torch float32 with ``backend="torch"``: on the card the two kernels
     of ``csrc/grid_nll.cu``, ``grid_tables`` then K12 ``grid_nll``):
     FHOM[u,sd,zp,x], FHET[u,vw,zph,x], FERR[s,x] are precomputed, then
     combined per (p_d,p_e,s) slice;
  2. the top-K candidates by vectorized NLL are re-evaluated with a
     scalar float64 routine replicating the C++ operation order exactly,
     and the winner is chosen with the loop-order tie-break — making the
     fitted parameters bit-identical to the reference.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from .classifier import KGParams, zeta_weights, derr_old_val, val_hom, val_het


@dataclass
class KGFitOptions:
    """Fitter options (Fitter.hpp:25-46 defaults)."""

    max_copy: int = 20
    max_x_use: int = 200
    smooth_win: int = 7
    fit_error: bool = True
    fit_varw: bool = True
    u_lo: float = 1.0
    u_hi: float = 20.0
    sd_lo: float = 0.5
    sd_hi: float = 2.0
    varw_lo: float = 0.71
    varw_hi: float = 4.0
    pd_lo: float = 0.1
    pd_hi: float = 1.0
    pe_lo: float = 0.0
    pe_hi: float = 0.1
    s_lo: float = 1.01
    s_hi: float = 4.0
    zp_lo: float = 1.01
    zp_hi: float = 4.0
    grid_u: int = 7
    grid_sd: int = 7
    grid_varw: int = 5
    grid_pd: int = 7
    grid_pe: int = 5
    grid_s: int = 5
    grid_zp: int = 7


@dataclass
class KGFitResult:
    P: KGParams
    nll: float
    valley_x: int
    peak_x: int


def _moving_avg(y: list[float], w: int) -> list[float]:
    """Fitter.hpp:56-67."""
    if w < 1:
        return list(y)
    n = len(y)
    h = w // 2
    z = [0.0] * n
    for i in range(n):
        lo, hi = max(0, i - h), min(n - 1, i + h)
        s = sum(y[lo : hi + 1])
        z[i] = s / max(hi - lo + 1, 1)
    return z


def estimate_valley_peak(hist: list[float], smooth_w: int) -> tuple[int, int]:
    """Fitter.hpp:147-159: valley then peak on the smoothed histogram."""
    n = len(hist)
    ys = _moving_avg(hist, smooth_w)
    valley_x = 2
    vmin = ys[2] if n > 2 else 0.0
    for i in range(2, min(n - 2, 50)):
        if ys[i] < vmin:
            vmin = ys[i]
            valley_x = i
        if i > 5 and ys[i] > ys[i - 1] and ys[i - 1] > ys[i - 2]:
            break
    # argmax over [valley+1, min(n-1, valley + 6*(valley+1))]
    lo = max(valley_x + 1, 0)
    hi = min(min(n - 1, valley_x + 6 * (valley_x + 1)), n - 1)
    peak_x = lo
    best = -1.0
    for i in range(lo, hi + 1):
        if ys[i] > best:
            best = ys[i]
            peak_x = i
    return valley_x, peak_x


def _linspace(lo: float, hi: float, k: int) -> np.ndarray:
    """Fitter.hpp:364-372 linspace (lo + t*(hi-lo))."""
    if k <= 1:
        return np.array([(lo + hi) / 2.0])
    t = np.arange(k, dtype=np.float64) / (k - 1)
    return lo + t * (hi - lo)


def _nll_exact(
    u: float, sd: float, vw: float, zp: float, zph: float,
    pd: float, pe: float, s: float,
    max_copy: int, xs: np.ndarray, ys: np.ndarray,
) -> float:
    """Scalar NLL replicating Fitter.hpp:127-144 operation order."""
    P = KGParams(
        zp_copy=zp, zp_copy_het=zph, u_v=u, sd_v=sd, var_w=vw,
        p_d=pd, max_copy=max_copy, p_e=pe, err_shape=s,
    )
    zh = zeta_weights(zp, max_copy)
    zt = zeta_weights(zph, max_copy)
    nll = 0.0
    for x, y in zip(xs.tolist(), ys.tolist()):
        fe = derr_old_val(x, s)
        fhet = val_het(x, P, zt)
        fhom = val_hom(x, P, zh)
        mix = pe * fe + (1.0 - pe) * (pd * fhet + (1.0 - pd) * fhom)
        nll += -y * math.log(mix + 1e-300)
    return nll


def _grid_nll_numpy(
    U, SD, VW, ZP, ZPH, PD, PE, SS, max_copy, xs, ys
) -> np.ndarray:
    """Vectorized NLL over the full grid, float64. Shape
    (|U|,|SD|,|VW|,|ZP|,|ZPH|,|PD|,|PE|,|SS|) in C order = loop order."""
    X = xs.astype(np.float64)

    copies = np.arange(1, max_copy + 1, dtype=np.float64)

    def zeta(zps):
        w = 1.0 / np.power(copies[None, :], zps[:, None])
        return w / w.sum(axis=1, keepdims=True)

    zw_hom = zeta(ZP)  # [zp, copy]
    zw_het = zeta(ZPH)  # [zph, copy]
    inv_s2pi = 0.3989422804014327

    # FHOM[u, sd, zp, x]
    mu = U[:, None] * copies[None, :]  # [u, copy]
    sdc = SD[:, None] * np.sqrt(copies)[None, :]  # [sd, copy]
    z = (X[None, None, None, :] - mu[:, None, :, None]) / sdc[None, :, :, None]
    pdf = inv_s2pi / sdc[None, :, :, None] * np.exp(-0.5 * z * z)
    fhom = np.einsum("zc,uscx->uszx", zw_hom, pdf)
    fhom = np.maximum(fhom, 1e-300)

    # FHET[u, vw, zph, x]
    mu_h = (0.5 * U)[:, None] * copies[None, :]
    sd_base = 0.5 * np.sqrt(np.maximum(VW, 1e-12))
    sdc_h = sd_base[:, None] * np.sqrt(copies)[None, :]  # [vw, copy]
    z = (X[None, None, None, :] - mu_h[:, None, :, None]) / sdc_h[None, :, :, None]
    pdf = inv_s2pi / sdc_h[None, :, :, None] * np.exp(-0.5 * z * z)
    fhet = np.einsum("zc,uvcx->uvzx", zw_het, pdf)
    fhet = np.maximum(fhet, 1e-300)

    # FERR[s, x]
    ferr = np.power(X[None, :], -SS[:, None]) - np.power(X[None, :] + 1.0, -SS[:, None])
    ferr = np.where(ferr > 0.0, ferr, 1e-300)

    nU, nSD, nVW, nZP, nZPH = len(U), len(SD), len(VW), len(ZP), len(ZPH)
    out = np.empty((nU, nSD, nVW, nZP, nZPH, len(PD), len(PE), len(SS)))
    for ipd, pd in enumerate(PD):
        for ipe, pe in enumerate(PE):
            for isx, _s in enumerate(SS):
                # mix[u,sd,vw,zp,zph,x]; fhet axes [u,vw,zph,x], fhom [u,sd,zp,x]
                b = (1.0 - pe) * pd * fhet[:, None, :, None, :, :]
                c = (1.0 - pe) * (1.0 - pd) * fhom[:, :, None, :, None, :]
                mix = pe * ferr[isx][None, None, None, None, None, :] + b + c
                out[:, :, :, :, :, ipd, ipe, isx] = -(
                    np.log(mix + 1e-300) * ys[None, None, None, None, None, :]
                ).sum(axis=-1)
    return out


def _grid_tables_torch(U, SD, VW, ZP, ZPH, SS, max_copy, xs, device):
    """``(fhom [u,sd,zp,x], fhet [u,vw,zph,x], ferr [s,x])`` float32 on
    ``device``: the small tables ``_grid_nll_jax`` builds outside its map,
    in plain torch with its 1e-35 clamps. The plain version of
    ``grid_tables``; the axes are arrays or float32 tensors."""
    f32 = torch.float32

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=f32)
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f32,
                               device=device)

    X = t(xs)
    copies = torch.arange(1, max_copy + 1, dtype=f32, device=device)
    inv_s2pi = 0.3989422804014327

    def zeta(zps):
        w = 1.0 / torch.pow(copies[None, :], t(zps)[:, None])
        return w / w.sum(dim=1, keepdim=True)

    def pdf(mu, sdc):
        z = (X[None, None, None, :] - mu[:, None, :, None]) \
            / sdc[None, :, :, None]
        return inv_s2pi / sdc[None, :, :, None] * torch.exp(-0.5 * z * z)

    Uj = t(U)
    mu = Uj[:, None] * copies[None, :]
    sdc = t(SD)[:, None] * torch.sqrt(copies)[None, :]
    fhom = torch.clamp(torch.einsum("zc,uscx->uszx", zeta(ZP), pdf(mu, sdc)),
                       min=1e-35)
    mu_h = (0.5 * Uj)[:, None] * copies[None, :]
    sd_base = 0.5 * torch.sqrt(torch.clamp(t(VW), min=1e-12))
    sdc_h = sd_base[:, None] * torch.sqrt(copies)[None, :]
    fhet = torch.clamp(
        torch.einsum("zc,uvcx->uvzx", zeta(ZPH), pdf(mu_h, sdc_h)),
        min=1e-35)
    SSj = t(SS)
    ferr = torch.pow(X[None, :], -SSj[:, None]) \
        - torch.pow(X[None, :] + 1.0, -SSj[:, None])
    ferr = torch.where(ferr > 0.0, ferr, 1e-35)
    return fhom.contiguous(), fhet.contiguous(), ferr.contiguous()


TABLE_AXES = ("U", "SD", "VW", "ZP", "ZPH", "SS", "xs")  # grid_tables'


def axes_on(device, *axes) -> tuple[torch.Tensor, ...]:
    """The axes on ``device`` in one host-to-device copy (packed end to
    end in one float32 host array): float32 views of one buffer, in the
    order given."""
    parts = [np.asarray(a, np.float64).astype(np.float32).reshape(-1)
             for a in axes]
    return torch.from_numpy(np.concatenate(parts)).to(device).split(
        [len(a) for a in parts])


def grid_tables(U, SD, VW, ZP, ZPH, SS, max_copy, xs, device):
    """``(fhom, fhet, ferr)`` of ``_grid_tables_torch``. On a CUDA
    ``device`` one launch of ``csrc/grid_nll.cu``'s table kernel on 1-D
    float32 CUDA axes (``axes_on`` puts them there in one copy); on the
    CPU ``_grid_tables_torch``."""
    device = torch.device(device)
    if device.type == "cpu":
        return _grid_tables_torch(U, SD, VW, ZP, ZPH, SS, max_copy, xs,
                                  device)
    axes = (U, SD, VW, ZP, ZPH, SS, xs)
    for name, a in zip(TABLE_AXES, axes):
        kernels.check_tensor(a, name, torch.float32, None, device)
        if a.dim() != 1 or a.numel() < 1:
            raise ValueError(f"{name}: want a non-empty 1-D axis, got shape "
                             f"{tuple(a.shape)}")
    if not isinstance(max_copy, (int, np.integer)) or max_copy < 1:
        raise ValueError(f"max_copy {max_copy!r}: want an int >= 1")
    nu, nsd, nvw, nzp, nzph, ns, nx = (a.numel() for a in axes)
    f32 = dict(dtype=torch.float32, device=axes[0].device)
    fhom = torch.empty((nu, nsd, nzp, nx), **f32)
    fhet = torch.empty((nu, nvw, nzph, nx), **f32)
    ferr = torch.empty((ns, nx), **f32)
    rc = kernels.lib().dg_grid_tables(
        *(a.data_ptr() for a in axes), nu, nsd, nvw, nzp, nzph, ns, nx,
        int(max_copy), fhom.data_ptr(), fhet.data_ptr(), ferr.data_ptr(),
        kernels.stream_of(fhom))
    kernels.raise_on_error(rc, "grid_tables")
    grid_tables.launches += 1
    return fhom, fhet, ferr


grid_tables.launches = 0


def _check_grid(fhom, fhet, ferr, pd, pe, y) -> None:
    for name, a, dim in (("fhom", fhom, 4), ("fhet", fhet, 4),
                         ("ferr", ferr, 2), ("pd", pd, 1), ("pe", pe, 1),
                         ("y", y, 1)):
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32 \
                or a.dim() != dim:
            raise ValueError(f"{name}: want a {dim}-D float32 tensor")
    nx = y.shape[0]
    if fhom.shape[3] != nx or fhet.shape[3] != nx or ferr.shape[1] != nx \
            or fhom.shape[0] != fhet.shape[0]:
        raise ValueError(f"grid tables {tuple(fhom.shape)}, "
                         f"{tuple(fhet.shape)}, {tuple(ferr.shape)} do not "
                         f"agree with {nx} bins")


def grid_nll_ref(fhom, fhet, ferr, pd, pe, y) -> torch.Tensor:
    """Plain PyTorch version of K12: ``[u, sd, vw, zp, zph, pd, pe, s]``
    float32 NLL of every grid point, JAX's map body
    (``dipgenie_tpu/models/fitter.py:245-252``) per (pd, pe) slice."""
    _check_grid(fhom, fhet, ferr, pd, pe, y)
    nu, nsd, nzp, _ = fhom.shape
    _, nvw, nzph, _ = fhet.shape
    out = torch.empty((nu, nsd, nvw, nzp, nzph, len(pd), len(pe),
                       ferr.shape[0]), dtype=torch.float32,
                      device=fhom.device)
    het = fhet[:, None, :, None, :, None, :]
    hom = fhom[:, :, None, :, None, None, :]
    err = ferr[None, None, None, None, None, :, :]
    for ipd in range(len(pd)):
        for ipe in range(len(pe)):
            p, e = pd[ipd], pe[ipe]
            b = (1.0 - e) * p * het
            c = (1.0 - e) * (1.0 - p) * hom
            mix = e * err + b + c
            out[:, :, :, :, :, ipd, ipe, :] = -(
                torch.log(mix + 1e-35) * y).sum(-1)
    return out


GRID_THREADS = 256  # csrc/grid_nll.cu THREADS
GRID_P_MAX = 8  # the most pd values (points) a K12 thread takes


def divider(d: int) -> tuple[int, int, int]:
    """``(d, mul, shift)`` with ``n // d == (n * mul) >> shift`` for every
    ``0 <= n < 2**31`` (``mul`` < 2**32): K12's 32-bit division."""
    p = 31 + (d - 1).bit_length()
    return d, -(-(1 << p) // d), p


@functools.lru_cache(maxsize=64)
def grid_nll_geometry(dims: tuple) -> np.ndarray:
    """K12's launch geometry for a grid of ``dims = (u, sd, vw, zp, zph,
    pd, pe, s, x)``: the uint32 words of ``csrc/grid_nll.cu``'s
    ``Geometry`` (cached: do not write to it). A thread (a slot) takes one
    outer point (u, sd, vw, zp, zph), one (pe, s) and ``p`` consecutive pd
    values; the pd axis is cut in ``chunks`` of ``p`` (the last may be
    short), so an outer point has ``chunks * pe * s`` slots."""
    nu, nsd, nvw, nzp, nzph, npd, npe, ns, nx = (int(d) for d in dims)
    if min(dims) < 1:
        raise ValueError(f"grid of {tuple(dims)} points and bins: an axis "
                         "is empty")
    chunks = -(-npd // GRID_P_MAX)
    p = -(-npd // chunks)
    per_outer = chunks * npe * ns
    slots = nu * nsd * nvw * nzp * nzph * per_outer
    if slots >= 1 << 31 or nx >= 1 << 31:
        raise ValueError(f"grid of {tuple(dims)} points and bins: "
                         f"{slots} threads, past K12's 32-bit indices")
    words = [p, slots, -(-slots // GRID_THREADS), npd, nx]
    for d in (per_outer, npe * ns, ns, nzph, nzp, nvw, nsd):
        words += divider(d)
    geometry = np.asarray(words, np.uint32)
    geometry.setflags(write=False)
    return geometry


def grid_nll(fhom, fhet, ferr, pd, pe, y) -> torch.Tensor:
    """K12. CUDA tensors launch ``csrc/grid_nll.cu`` (one launch); CPU
    tensors take ``grid_nll_ref``."""
    if fhom.device.type == "cpu":
        return grid_nll_ref(fhom, fhet, ferr, pd, pe, y)
    _check_grid(fhom, fhet, ferr, pd, pe, y)
    for name, a in (("fhom", fhom), ("fhet", fhet), ("ferr", ferr),
                    ("pd", pd), ("pe", pe), ("y", y)):
        kernels.check_tensor(a, name, torch.float32, None, fhom.device)
    nu, nsd, nzp, nx = fhom.shape
    _, nvw, nzph, _ = fhet.shape
    dims = (nu, nsd, nvw, nzp, nzph, len(pd), len(pe), ferr.shape[0])
    geometry = grid_nll_geometry((*dims, nx))
    out = torch.empty(dims, dtype=torch.float32, device=fhom.device)
    rc = kernels.lib().dg_grid_nll(
        fhom.data_ptr(), fhet.data_ptr(), ferr.data_ptr(), pd.data_ptr(),
        pe.data_ptr(), y.data_ptr(), geometry.ctypes.data, out.data_ptr(),
        kernels.stream_of(fhom))
    kernels.raise_on_error(rc, "grid_nll")
    grid_nll.launches += 1
    return out


grid_nll.launches = 0


def grid_inputs(U, SD, VW, ZP, ZPH, PD, PE, SS, max_copy, xs, ys, device):
    """The float32 inputs ``(fhom, fhet, ferr, pd, pe, y)`` of K12 for a
    grid on ``device``: one host-to-device copy of the ten axes
    (``axes_on``; pd, pe and y are views of it), then ``grid_tables``
    (one launch on a card)."""
    U, SD, VW, ZP, ZPH, PD, PE, SS, X, Y = axes_on(
        device, U, SD, VW, ZP, ZPH, PD, PE, SS, xs, ys)
    return (*grid_tables(U, SD, VW, ZP, ZPH, SS, max_copy, X, device), PD,
            PE, Y)


def _grid_nll_torch(U, SD, VW, ZP, ZPH, PD, PE, SS, max_copy, xs, ys,
                    device) -> np.ndarray:
    """The float32 grid NLL of ``_grid_nll_jax`` on ``device`` (K12 on the
    card), as float64 ``[u, sd, vw, zp, zph, pd, pe, s]``."""
    out = grid_nll(*grid_inputs(U, SD, VW, ZP, ZPH, PD, PE, SS, max_copy,
                                xs, ys, device))
    return out.cpu().numpy().astype(np.float64)


def fit_histogram(
    hist_pairs: list[tuple[int, float]],
    opt: KGFitOptions | None = None,
    exact_topk: int = 256,
    backend: str = "numpy",
    device="cuda",
) -> KGFitResult:
    """Fit the 8-parameter mixture to a {multiplicity: freq} histogram.

    Matches KGFitterBO::fit (Fitter.hpp:207-407) with the grid backend.
    ``backend="torch"`` ranks the grid in float32 on ``device`` (K12 on
    the card; ``"cpu"`` runs its plain version) before the float64
    re-evaluation, which makes the result the numpy backend's.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"fit_histogram backend {backend!r}: 'numpy' or "
                         "'torch'")
    if backend == "torch":
        device = resolve_device(device)  # before any work
    if opt is None:
        opt = KGFitOptions()
    nmax = max((m for m, _ in hist_pairs), default=0)
    n = min(nmax, opt.max_x_use)
    dense = [0.0] * (n + 1)
    for m, f in hist_pairs:
        if m <= n:
            dense[m] += f
    valley, peak = estimate_valley_peak(dense, opt.smooth_win)

    # seeds (only used for frozen entries; Fitter.hpp:219-247)
    def fwhm(cx: int) -> float:
        # guarded reads: the reference reads H[cx] unchecked (UB when the
        # histogram is shorter than the probe range); seeds only matter for
        # frozen parameters, so clamped reads are safe here.
        def at(i: int) -> float:
            return dense[i] if 0 <= i < len(dense) else 0.0

        pk = at(cx)
        half = pk / 2.0
        L = R = cx
        for i in range(cx, max(1, cx - 10) - 1, -1):
            if at(i) <= half:
                L = i
                break
        for i in range(cx, min(n, cx + 10) + 1):
            if at(i) <= half:
                R = i
                break
        return max(2, R - L) / 2.35

    sd_seed = min(max(fwhm(peak), opt.sd_lo), opt.sd_hi)
    varw_seed = min(max(2.0 * sd_seed * sd_seed, opt.varw_lo), opt.varw_hi)
    total = sum(dense[1 : n + 1])
    left = sum(dense[1 : min(valley, n) + 1])
    pe_seed = left / total if total > 0 else 0.05
    pe_seed = min(max(pe_seed, opt.pe_lo), opt.pe_hi)
    s_seed = 2.0

    # bounds with freezing (Fitter.hpp:289-293)
    lo = [opt.u_lo, opt.sd_lo, opt.varw_lo, opt.zp_lo, opt.zp_lo, opt.pd_lo, opt.pe_lo, opt.s_lo]
    hi = [opt.u_hi, opt.sd_hi, opt.varw_hi, opt.zp_hi, opt.zp_hi, opt.pd_hi, opt.pe_hi, opt.s_hi]
    if not opt.fit_varw:
        lo[2] = hi[2] = varw_seed
    if not opt.fit_error:
        lo[6] = hi[6] = pe_seed
        lo[7] = hi[7] = s_seed

    def grid_or_freeze(l, h, k):
        if abs(h - l) < 1e-12:
            return np.array([l])
        return _linspace(l, h, k)

    U = grid_or_freeze(lo[0], hi[0], opt.grid_u)
    SD = grid_or_freeze(lo[1], hi[1], opt.grid_sd)
    VW = grid_or_freeze(lo[2], hi[2], opt.grid_varw)
    ZP = grid_or_freeze(lo[3], hi[3], opt.grid_zp)
    ZPH = grid_or_freeze(lo[4], hi[4], opt.grid_zp)
    PD = grid_or_freeze(lo[5], hi[5], opt.grid_pd)
    PE = grid_or_freeze(lo[6], hi[6], opt.grid_pe)
    SS = grid_or_freeze(lo[7], hi[7], opt.grid_s)

    xs_all = np.arange(1, n + 1, dtype=np.int64)
    ysd = np.asarray(dense[1:], np.float64)
    mask = ysd > 0
    xs, ys = xs_all[mask], ysd[mask]

    if len(xs) == 0:
        P = KGParams(
            zp_copy=float(ZP[0]), zp_copy_het=float(ZPH[0]), u_v=float(U[0]),
            sd_v=float(SD[0]), var_w=float(VW[0]), p_d=float(PD[0]),
            max_copy=opt.max_copy, p_e=float(PE[0]), err_shape=float(SS[0]),
        )
        return KGFitResult(P, 0.0, valley, peak)

    if backend == "torch":
        nll = _grid_nll_torch(U, SD, VW, ZP, ZPH, PD, PE, SS, opt.max_copy,
                              xs, ys, device)
        # f32 ranking noise seed; the adaptive window below guarantees the
        # true argmin regardless of the seed size
        exact_topk = max(exact_topk, 256)
    else:
        nll = _grid_nll_numpy(U, SD, VW, ZP, ZPH, PD, PE, SS, opt.max_copy,
                              xs, ys)
    flat = nll.reshape(-1)
    k = min(exact_topk, flat.size)
    cand = np.argpartition(flat, k - 1)[:k] if k < flat.size else np.arange(flat.size)
    cand = np.sort(cand)  # loop order for tie-break

    shape = nll.shape

    def exact_of(ci: int) -> float:
        iu, isd, ivw, izp, izph, ipd, ipe, iss = np.unravel_index(ci, shape)
        return _nll_exact(
            float(U[iu]), float(SD[isd]), float(VW[ivw]), float(ZP[izp]),
            float(ZPH[izph]), float(PD[ipd]), float(PE[ipe]), float(SS[iss]),
            opt.max_copy, xs, ys,
        )

    # Adaptive exact-re-eval window: the fixed top-K seed is only a
    # heuristic when the vectorized grid (f32 on device) ranks near-ties
    # wrongly. Grow the window until every unevaluated grid point's
    # vectorized NLL exceeds the best exact NLL by more than the
    # empirically observed approx-vs-exact error (x4 safety margin), at
    # which point no excluded point can beat the current winner.
    evaluated: dict[int, float] = {int(ci): exact_of(int(ci)) for ci in cand}
    while True:
        best_nll = math.inf
        best_idx = -1
        err_emp = 0.0
        for ci in sorted(evaluated):  # ascending ci == loop-order ties
            e = evaluated[ci]
            err_emp = max(err_emp, abs(float(flat[ci]) - e))
            if e < best_nll:
                best_nll = e
                best_idx = ci
        bound = 4.0 * err_emp + 1e-9 * max(1.0, abs(best_nll))
        need = np.nonzero(flat <= best_nll + bound)[0]
        new = [int(ci) for ci in need.tolist() if int(ci) not in evaluated]
        if not new:
            break
        for ci in new:
            evaluated[ci] = exact_of(ci)

    iu, isd, ivw, izp, izph, ipd, ipe, iss = np.unravel_index(best_idx, shape)
    P = KGParams(
        zp_copy=float(ZP[izp]), zp_copy_het=float(ZPH[izph]), u_v=float(U[iu]),
        sd_v=float(SD[isd]), var_w=float(VW[ivw]), p_d=float(PD[ipd]),
        max_copy=opt.max_copy, p_e=float(PE[ipe]), err_shape=float(SS[iss]),
    )
    return KGFitResult(P, best_nll, valley, peak)
