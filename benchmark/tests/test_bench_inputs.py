"""The frozen inputs equal the program's, and the work count equals a
brute-force count over the exact tier's candidates."""

import numpy as np
import pytest

import inputs
import work
from dipgenie_tpu_torch.utils import synth

SHAPES = [dict(L=600, n_bands=4, band_len=12, wmin=33, wmax=96),
          dict(L=400, n_bands=2, band_len=5, wmin=513, wmax=600),
          dict(L=300, n_bands=0)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_frozen_graph_equals_the_programs(seed, shape):
    kw = SHAPES[shape]
    ours = inputs.mhc_shaped_csr(seed=seed, **kw)
    theirs = synth.mhc_shaped_csr(seed=seed, **kw)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for R in (1, 18):
        assert inputs.dp_states(ours[0], R) == synth.dp_states(theirs[0], R)


def test_make_graph_reads_the_config():
    cfg = {"generator": "mhc_shaped_csr",
           "params": dict(L=300, n_bands=2, band_len=4, wmin=40, wmax=50)}
    a = inputs.make_graph(cfg, 3)
    b = synth.mhc_shaped_csr(seed=3, **cfg["params"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def brute_work(csr, R):
    """The count of ``work.forward_work``, by the loops of
    ``_forward_exact``: every source pair (i, j) of a level and every edge
    of each, whether or not the state is reachable."""
    level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom, het_ptr, het = csr
    L = len(level_ptr) - 1
    colours = [set(hom[hom_ptr[v]:hom_ptr[v + 1]].tolist())
               | set(het[het_ptr[v]:het_ptr[v + 1]].tolist())
               for v in range(int(level_ptr[-1]))]
    ops = 0
    for t in range(L - 1):
        on = set()
        for v in range(int(level_ptr[t]), int(level_ptr[t + 2])):
            on |= colours[v]
        words = -(-len(on) // 32)
        lv = range(int(level_ptr[t]), int(level_ptr[t + 1]))
        for u1 in lv:
            for v1 in lv:
                for eu in range(adj_ptr[u1], adj_ptr[u1 + 1]):
                    for ev in range(adj_ptr[v1], adj_ptr[v1 + 1]):
                        w = int(adj_w[eu]) + int(adj_w[ev])
                        ops += 2 * max(0, R + 1 - w) + 8 * words + 1
    k = int(level_ptr[-1] - level_ptr[-2])
    nbytes = (sum(a.nbytes for a in csr) + (R + 1) * k * k * 4
              + (L - 1) * 7 * 4)
    return ops, nbytes


@pytest.mark.parametrize("case", [
    ("random", (0, 12, 5, 8), 5), ("random", (3, 10, 6, 70), 1),
    ("random", (5, 9, 4, 40), 18), ("mhc", dict(L=120, n_bands=2,
                                               band_len=3, wmin=33,
                                               wmax=36), 18)])
def test_work_equals_brute_force(case):
    kind, args, R = case
    if kind == "random":
        csr = synth.random_leveled_csr(*args)
    else:
        csr = inputs.mhc_shaped_csr(seed=1, **args)
    assert work.forward_work(csr, R) == brute_work(csr, R)


def test_least_seconds_uses_the_larger_bound():
    csr = synth.random_leveled_csr(1, 10, 4, 6)
    ops, nbytes = work.forward_work(csr, 3)
    card = {"int32_ops_per_s": 1.0, "hbm_bytes_per_s": 1e30}
    assert work.least_seconds(csr, 3, card) == ops
    card = {"int32_ops_per_s": 1e30, "hbm_bytes_per_s": 1.0}
    assert work.least_seconds(csr, 3, card) == nbytes
    assert work.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert work.peaks("no such card") is None
