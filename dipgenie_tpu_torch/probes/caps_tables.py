"""Inputs and expectations of the capability checks (``probes caps`` and
``caps2``), as numpy.

The port's own copy of the ``mk_*`` builders of
``scripts/tpu_caps_probe.py`` (K8, 15 checks) and
``scripts/tpu_caps_probe2.py`` (K9, 15 checks): those import JAX at the
top, so the port keeps what it needs. ``make(name)`` gives the script's
arrays byte for byte; ``make(name, seed)`` gives second inputs of the same
shapes and types drawn from ``numpy.random.default_rng(seed)``. They also
take the paths the scripts' inputs never reach: a row other than 0, the
branches 0 and 2, another selection, bit 31, fractional negatives. Each
check's expectation is computed from its inputs as the script's is.
"""

from __future__ import annotations

import numpy as np

R1 = 19
# seeds of the second inputs (the scripts draw from 0, 1 and 2); between
# them, switch_compute takes branches 0 and 2
SECOND_SEEDS = (101, 103)


def _arange(shape, dtype=np.int32):
    return np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)


def _ints(g, shape, lo=-(2**30), hi=2**30, dtype=np.int32):
    return g.integers(lo, hi, shape, dtype=dtype)


def _a(shape, dtype=np.int32):
    """inputs(g) of a check on one array: the script's ``arange``, or
    integers of the same type drawn from ``g``."""
    def inputs(g):
        if g is None:
            return (_arange(shape, dtype),)
        if dtype == np.int16:
            return (_ints(g, shape, -(2**15), 2**15 - 1, np.int16),)
        return (_ints(g, shape),)
    return inputs


def _gather(shape, hi, grouped=False):
    """inputs(g) of a gather: ``A`` and an int32 index below ``hi``, inside
    each 16-lane group when ``grouped`` (the script draws the index from
    seed 0)."""
    def inputs(g):
        r = np.random.default_rng(0) if g is None else g
        a = _arange(shape) if g is None else _ints(g, shape)
        idx = r.integers(0, hi, shape)
        if grouped:
            idx = idx + (np.arange(shape[1]) // 16) * 16
        return a, idx.astype(np.int32)
    return inputs


def _products(seed, lhs, rhs, lhs_hi, rhs_hi):
    """inputs(g) of a float product: small integers, drawn from the
    script's seed or from ``g``."""
    def inputs(g):
        r = np.random.default_rng(seed) if g is None else g
        return (r.integers(0, lhs_hi, lhs).astype(np.float32),
                r.integers(0, rhs_hi, rhs).astype(np.float32))
    return inputs


def _onehot(sel):
    one = np.zeros((sel.size, 32), np.float32)
    one[np.arange(sel.size), sel.reshape(-1)] = 1.0
    return one


def _bcast_lhs(g):
    r = np.random.default_rng(1) if g is None else g
    sel = r.integers(0, 32, 16)
    return _onehot(sel), r.integers(0, 100, (R1, 32, 16)).astype(np.float32)


def _scalar_prefetch(g):
    if g is None:
        return np.array([3, 1, 4, 1, 5, 2, 6, 0], np.int32), _arange(
            (8, 8, 128))
    return g.integers(0, 8, 8).astype(np.int32), _ints(g, (8, 8, 128))


def _popcount_in(g):
    if g is None:
        return (_arange((16, 256), np.uint32),)
    return (g.integers(0, 2**32, (16, 256), dtype=np.uint32),)


def _popcount(a):
    return sum((a >> k) & 1 for k in range(32)).astype(np.int32)


def _convert_in(g):
    if g is None:
        return (_arange((R1, 16, 16), np.float32) - 1000.0,)
    # quarters such as -2.5 and -0.25
    return ((g.integers(-4000, 4000, (R1, 16, 16)) / 4).astype(np.float32),)


def _onehot_in(g):
    if g is None:
        return ((np.arange(16, dtype=np.int32) * 2 % 32).reshape(16, 1),)
    return (g.integers(0, 32, (16, 1)).astype(np.int32),)


def _transpose_in(g):
    if g is None:
        return (_arange((304, 16), np.float32),)
    return (g.integers(-10**6, 10**6, (304, 16)).astype(np.float32),)


def _switch_in(g):
    if g is None:
        return np.asarray([1], np.int32), _arange((R1, 16, 16))
    return (np.asarray([g.choice([0, 2])], np.int32),
            _ints(g, (R1, 16, 16)))


def _switch(b, a):
    """``lax.switch(b, [x + 1, x[:, :8, :8] *= 2, x - 3], a)``; the index
    is clamped to the branches, as ``lax.switch`` clamps it."""
    b = min(max(int(b[0]), 0), 2)
    if b != 1:
        return a + 1 if b == 0 else a - 3
    out = a.copy()
    out[:, :8, :8] *= 2
    return out


# name -> (script, line of its mk_* function, inputs(g), expect(*inputs)).
# inputs(None) are the script's arrays; inputs(g) draw from the numpy
# Generator g. In the scripts' order: K8's 15 checks, then K9's.
CHECKS = {
    "lane_gather_taa_grouped": (
        "tpu_caps_probe", 46, _gather((16, 256), 16, grouped=True),
        lambda a, i: np.take_along_axis(a, i, 1)),
    "lane_gather_cross_vreg": (
        "tpu_caps_probe", 63, _gather((16, 256), 256),
        lambda a, i: np.take_along_axis(a, i, 1)),
    "sublane_gather_8": (
        "tpu_caps_probe", 78, _gather((8, 128), 8),
        lambda a, i: np.take_along_axis(a, i, 0)),
    "sublane_gather_16": (
        "tpu_caps_probe", 93, _gather((16, 128), 16),
        lambda a, i: np.take_along_axis(a, i, 0)),
    "roll_lane": (
        "tpu_caps_probe", 108, _a((16, 256)), lambda a: np.roll(a, 16, 1)),
    "roll_sublane": (
        "tpu_caps_probe", 120, _a((24, 256)), lambda a: np.roll(a, 1, 0)),
    "lane_bcast_col": (
        "tpu_caps_probe", 132, _a((16, 1)),
        lambda a: np.broadcast_to(a, (16, 256)).copy()),
    "sublane_bcast_row": (
        "tpu_caps_probe", 145, _a((1, 256)),
        lambda a: np.broadcast_to(a, (16, 256)).copy()),
    "tile_lane_concat": (
        "tpu_caps_probe", 158, _a((16, 16)), lambda a: np.tile(a, (1, 19))),
    # row A[0, 0] % 16 (a floor modulo), broadcast; the script's is row 0
    "dyn_slice_row_bcast": (
        "tpu_caps_probe", 171, _a((16, 256)),
        lambda a: np.broadcast_to(a[a[0, 0] % 16], (16, 256)).copy()),
    "manual_dma_dynoff": (
        "tpu_caps_probe", 186, _a((64, 128)), lambda a: a[8:24] + 1),
    "scalar_prefetch_grid": (
        "tpu_caps_probe", 215, _scalar_prefetch, lambda sel, a: a[sel]),
    # uint32 words; the script's arange never sets bit 31
    "popcount": ("tpu_caps_probe", 240, _popcount_in, _popcount),
    "strided_slice_lane": (
        "tpu_caps_probe", 252, _a((16, 304)),
        lambda a: a[:, 3::16].copy()),
    "reshape_lane_groups": (
        "tpu_caps_probe", 265, _a((16, 304)),
        lambda a: a.reshape(16, 19, 16).copy()),
    # every float is a small integer: every product and partial sum is
    # exact in float32, and in TF32
    "batched_dot_3d": (
        "tpu_caps_probe2", 43,
        _products(0, (R1, 16, 32), (R1, 32, 16), 100, 2),
        lambda a, b: np.einsum("rij,rjk->rik", a, b)),
    "batched_dot_bcast_lhs": (
        "tpu_caps_probe2", 62, _bcast_lhs,
        lambda one, v: np.matmul(one, v)),
    "concat3d_ax0": (
        "tpu_caps_probe2", 84, _a((R1, 16, 16)),
        lambda a: np.concatenate(
            [np.full((1, 16, 16), -7, np.int32), a[:R1 - 1]], 0)),
    "concat3d_ax1": (
        "tpu_caps_probe2", 97, _a((R1, 16, 16)),
        lambda a: np.concatenate([a, a + 1], 1)),
    "concat3d_ax2": (
        "tpu_caps_probe2", 110, _a((R1, 16, 16)),
        lambda a: np.concatenate([a, a + 1], 2)),
    "roll3d_ax1": (
        "tpu_caps_probe2", 123, _a((R1, 16, 16)), lambda a: np.roll(a, 4, 1)),
    "roll3d_ax2": (
        "tpu_caps_probe2", 135, _a((R1, 16, 16)), lambda a: np.roll(a, 4, 2)),
    # truncation toward zero
    "convert_f32_i32_3d": (
        "tpu_caps_probe2", 147, _convert_in,
        lambda a: a.astype(np.int32) * 2),
    "iota_onehot_build": ("tpu_caps_probe2", 159, _onehot_in, _onehot),
    "where3d_iota_mask": (
        "tpu_caps_probe2", 176, _a((R1, 16, 16)),
        lambda a: np.where(np.arange(16)[None, :, None] < 8, a, -1)),
    "transpose2d": (
        "tpu_caps_probe2", 190, _transpose_in, lambda a: a.T.copy()),
    # the script returns slot 1 of a [2, 19, 8, 8] output: this
    "dma_strided_3d": (
        "tpu_caps_probe2", 202, _a((4, R1, 16, 16), np.int16),
        lambda a: a[2, :, 0:8, 0:8] + 1),
    "switch_compute": ("tpu_caps_probe2", 237, _switch_in, _switch),
    "dma_in_when": (
        "tpu_caps_probe2", 265, _a((4, 8, 128)), lambda a: a[2].copy()),
    "dot2d_f32": (
        "tpu_caps_probe2", 294,
        _products(2, (64, 32), (32, 304), 2, 100), lambda a, b: a @ b),
}
K8 = tuple(n for n, c in CHECKS.items() if c[0] == "tpu_caps_probe")
K9 = tuple(n for n, c in CHECKS.items() if c[0] == "tpu_caps_probe2")


def make(name: str, seed: int | None = None):
    """``(inputs, expectation)`` of a check: the script's arrays, or the
    second inputs drawn from ``seed``."""
    _, _, inputs, expect = CHECKS[name]
    ins = inputs(None if seed is None else np.random.default_rng(seed))
    return ins, expect(*ins)
