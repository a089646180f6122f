"""The benchmark's inputs, made from ``--seed`` with numpy.

Frozen copies of ``mhc_shaped_csr`` and ``dp_states`` of
``dipgenie_tpu_torch/utils/synth.py``: the graph a cell solves and the
states it is credited with belong to the yardstick, so a change to the
program's own copies cannot move them. ``tests/test_bench_inputs.py``
holds them equal to the program's.
"""

from __future__ import annotations

import numpy as np

# the generators a configuration file may name under "generator"
GENERATORS = {}


def generator(fn):
    GENERATORS[fn.__name__] = fn
    return fn


@generator
def mhc_shaped_csr(L: int = 120_000, seed: int = 0, n_bands: int = 300,
                   band_len: int = 12, wmin: int = 33, wmax: int = 96):
    """CSR arrays ``(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr,
    hom_colors, het_ptr, het_colors)`` of a leveled DAG shaped like the MHC
    expanded graph.

    Narrow level widths are Poisson(8) clipped to 2..32 and each vertex
    has out-degree 1 or 2 (30%). A vertex's first edge weighs 0 and a
    second edge 1 with probability 0.43. ~30% of levels carry a new colour
    on 3 vertices of that level and the next (15% of colours HOM).
    ``n_bands`` bands of ``band_len`` levels have widths uniform in
    ``wmin..wmax``."""
    rng = np.random.default_rng(seed)
    widths = np.clip(rng.poisson(8, L), 2, 32)
    gap = (L - 2) // max(n_bands, 1)
    for b in range(n_bands):
        s = 1 + b * gap + int(rng.integers(0, max(gap - band_len, 1)))
        e = min(s + band_len, L - 1)
        widths[s:e] = rng.integers(wmin, wmax + 1, max(e - s, 0))
    widths[0] = widths[-1] = 1
    level_ptr = np.zeros(L + 1, np.int64)
    np.cumsum(widths, out=level_ptr[1:])
    n = int(level_ptr[-1])

    # edges: every vertex of level l < L-1 to 1-2 uniform vertices of l+1
    lvl = np.repeat(np.arange(L), widths)
    deg = np.where(lvl < L - 1, 1 + (rng.random(n) < 0.3), 0)
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=adj_ptr[1:])
    src_lvl = np.repeat(lvl, deg)
    nxt = src_lvl + 1
    adj_v = (level_ptr[nxt] + (rng.random(len(nxt)) * widths[nxt]).astype(
        np.int64)).astype(np.int32)
    second = np.zeros(len(adj_v), bool)
    second[adj_ptr[:-1][deg == 2] + 1] = True
    adj_w = (second & (rng.random(len(adj_v)) < 0.43)).astype(np.int8)

    # colours: 3 vertices of levels l..l+1 for ~30% of levels
    lv = np.flatnonzero(rng.random(L - 1) < 0.3)
    span = level_ptr[lv + 2] - level_ptr[lv]
    verts = level_ptr[lv][:, None] + (
        rng.random((len(lv), 3)) * span[:, None]).astype(np.int64)
    col = np.repeat(np.arange(len(lv)), 3)
    hom = rng.random(max(len(lv), 1)) < 0.15
    vc = np.unique(np.stack([verts.reshape(-1), col], 1), axis=0)
    is_h = hom[vc[:, 1]]
    hom_ptr = np.zeros(n + 1, np.int64)
    het_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(vc[is_h, 0], minlength=n), out=hom_ptr[1:])
    np.cumsum(np.bincount(vc[~is_h, 0], minlength=n), out=het_ptr[1:])
    return (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr,
            vc[is_h, 1].astype(np.int32), het_ptr,
            vc[~is_h, 1].astype(np.int32))


def dp_states(level_ptr, R: int) -> int:
    """DP states of the pair DP: (R + 1) * width^2 over levels 1..L-1."""
    w = np.diff(np.asarray(level_ptr, np.int64))
    return int(np.sum((R + 1) * w[1:] * w[1:]))


def make_graph(config: dict, seed: int):
    """The CSR arrays of a configuration's graph for ``seed``."""
    return GENERATORS[config["generator"]](seed=seed, **config["params"])
