"""The port's copies of the host modules against the JAX package's.

``dipgenie_tpu_torch`` holds its own copies of the front end, the pair
planner and the host DP tiers. Each case feeds the same numpy-seeded
inputs through both packages and asserts equal outputs: equal types by
name, equal fields, arrays equal in dtype and value (the outputs are
integers, strings and float64 values computed in the same order, so the
tolerance is exact equality).
"""

import dataclasses
import functools

import numpy as np
import pytest

from tests.test_torch_kernels_gpu import case_csr
from tests.test_torch_narrow import assert_same_plan


def same(a, b, path="out"):
    """Recursive exact equality of two packages' outputs."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, path
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@functools.cache
def _pangenome(tmp_root):
    from dipgenie_tpu_torch.utils.synth import pangenome

    return pangenome(tmp_root, n_bp=20_000, n_walks=8, seed=3)


def _front_end(pkg, gfa, reads_path):
    """GFA -> index -> anchors -> expanded graph -> levelize -> CSR, in the
    pipeline's order, through one package."""
    read_gfa = pkg("io.gfa").read_gfa
    index = pkg("graph.pangenome").PangenomeIndex.from_gfa(read_gfa(gfa))
    reads = pkg("io.fastx").read_fastx(reads_path)
    anchors = pkg("solver.anchors").compute_and_classify_anchors(
        index, reads, 31, 25, 1.0, verbose=False)
    build = pkg("graph.expanded").build_expanded_graph_native(index, anchors)
    chb = [bool(anchors.homo_bv[build.color_to_anchor[c]])
           for c in range(build.num_colors)]
    g = pkg("graph.leveled").levelize_native(build.graph)
    return index, anchors, pkg("solver.diploid").csr_arrays(g, chb)


def _pkg(name):
    import importlib

    return lambda mod: importlib.import_module(f"{name}.{mod}")


JAX, PORT = _pkg("dipgenie_tpu"), _pkg("dipgenie_tpu_torch")


def case_murmur_and_minimizers(rng, tmp_path):
    data = rng.integers(0, 256, (64, 31), dtype=np.uint8)
    seq = "".join(rng.choice(list("ACGTN"), 3000, p=[.24, .24, .24, .24, .04]))
    for pkg in (JAX, PORT):
        yield (pkg("sketch.murmur").murmur3_x64_128_fold64(data, seed=7),
               pkg("sketch.minimizers").sketch_sequence(seq, 15, 10))


def case_fit_histogram(rng, tmp_path):
    mult = np.concatenate([np.ones(5000), rng.poisson(3, 1500) + 1,
                           rng.poisson(9, 400) + 1]).astype(int)
    uniq, freq = np.unique(mult, return_counts=True)
    pairs = [(int(m), float(f)) for m, f in zip(uniq, freq)]
    mm = int(uniq.max())
    for pkg in (JAX, PORT):
        fitter = pkg("models.fitter")
        opt = fitter.KGFitOptions(max_copy=10, max_x_use=mm, u_hi=float(mm))
        yield fitter.fit_histogram(pairs, opt, backend="numpy")


def case_std_sort(rng, tmp_path):
    n = 500
    k1, k2, k3 = (rng.integers(0, m, n).tolist() for m in (40, 3, 2))
    for pkg in (JAX, PORT):
        mod = pkg("utils.stdsort")
        idx = list(range(n))
        mod.std_sort(idx, lambda a, b: (k1[a], k2[a]) < (k1[b], k2[b]))
        yield mod.std_sort_by_keys3(list(range(n)), k1, k2, k3), idx


def case_gfa_index(rng, tmp_path):
    gfa, _ = _pangenome(str(tmp_path))
    for pkg in (JAX, PORT):
        g = pkg("io.gfa").read_gfa(gfa)
        yield g, pkg("graph.pangenome").PangenomeIndex.from_gfa(g)


def case_anchors_expanded_csr(rng, tmp_path):
    gfa, reads = _pangenome(str(tmp_path))
    for pkg in (JAX, PORT):
        yield _front_end(pkg, gfa, reads)


def case_plan_pairs(rng, tmp_path):
    from dipgenie_tpu.ops.diploid_pallas import plan_pairs as jax_plan
    from dipgenie_tpu_torch.ops.pair_plan import plan_pairs as port_plan
    from dipgenie_tpu_torch.utils.synth import CASES

    for case in CASES + ["mhc_slice_wide_csr"]:
        arrs, R = case_csr(case)
        assert_same_plan(jax_plan(*arrs, R), port_plan(*arrs, R))
    return ()


def case_shard_wide_tables(rng, tmp_path):
    """The port's tp shards (no compile-shape padding) against
    ``_shard_wide_tables`` on the real rows of every (transition, device);
    the JAX package's padded rows are not real (sbits 0)."""
    from dipgenie_tpu.ops.diploid_pallas import _shard_wide_tables
    from dipgenie_tpu.ops.diploid_pallas import plan_pairs as jax_plan
    from dipgenie_tpu_torch.ops.pair_plan import shard_wide_tables
    from dipgenie_tpu_torch.utils.synth import CASES

    n_runs = 0
    for case in [c for c in CASES if 400 <= c[0] < 600] + [
            "mhc_slice_wide_csr"]:
        arrs, R = case_csr(case)
        for seg in jax_plan(*arrs, R).segments:
            if type(seg).__name__ != "_WideRun":
                continue
            n_runs += 1
            for n_tp in (2, 3):
                shards, present = shard_wide_tables(seg, n_tp)
                for ti, tab in enumerate(_shard_wide_tables(seg, n_tp)):
                    sbits, swin, sbase, sgmask, tbl, jpresent = tab
                    assert np.array_equal(np.repeat(present[ti], 1024),
                                          jpresent[0])
                    for d, (rows, bounds) in enumerate(shards):
                        r = rows[bounds[ti]:bounds[ti + 1]]
                        n = len(r)
                        assert (sbits[d, :n] & 4).all()
                        assert not sbits[d, n:].any()
                        assert np.array_equal(tbl[d, :n], seg.tbl[r])
                        assert np.array_equal(swin[d, :n], seg.wwin[r])
                        assert np.array_equal(sbase[d, :n], seg.wbase[r])
                        assert np.array_equal(sgmask[d, :n], seg.wgmask[r])
    assert n_runs
    return ()


def case_dense_and_hand_graphs(rng, tmp_path):
    """The port's copies of the JAX tests' ``_dense_graph`` and
    ``_hand_graph`` (``utils/synth.py``): the same draws from the same
    generator state, the same graph, the same CSR arrays."""
    from dipgenie_tpu.solver.diploid import csr_arrays as jax_csr
    from dipgenie_tpu_torch.solver.diploid import csr_arrays as port_csr
    from dipgenie_tpu_torch.utils import synth
    from tests.test_pallas_dp import _dense_graph, _hand_graph

    for seed, widths, deg, pw in ((7, [1, 16, 16, 16, 1], 13, 0.1),
                                  (11, [1, 140, 140, 1], 2, 0.2)):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        g1 = _dense_graph(r1, widths, deg=deg, pw=pw)
        g2 = synth.dense_graph(r2, widths, deg=deg, pw=pw)
        assert r1.random() == r2.random()
        chb = [bool(x) for x in r1.random(6) < 0.5]
        assert vars(g1) == vars(g2)
        same(jax_csr(g1, chb), port_csr(g2, chb))
    edges = [[(0, i, 0) for i in range(5)], [(i, i % 3, i % 2)
                                             for i in range(5)]]
    colors = {2: [1, 0], 7: [0]}
    g1 = _hand_graph([1, 5, 3], edges, colors)
    g2 = synth.hand_graph([1, 5, 3], edges, colors)
    assert vars(g1) == vars(g2)
    return ()


def case_graph_from_csr(rng, tmp_path):
    """``graph_from_csr`` gives back a graph whose CSR arrays (of either
    package) are the arrays it was made from."""
    from dipgenie_tpu.solver.diploid import csr_arrays as jax_csr
    from dipgenie_tpu_torch.solver.diploid import csr_arrays as port_csr
    from dipgenie_tpu_torch.utils.synth import CASES, graph_from_csr

    for case in (CASES[0], CASES[-1], "mhc_slice_wide_csr"):
        arrs, _ = case_csr(case)
        g, chb = graph_from_csr(arrs)
        want = tuple(np.asarray(a) for a in arrs)
        same(port_csr(g, chb), want)
        same(jax_csr(g, chb), want)
    return ()


@pytest.mark.parametrize("case", [
    case_murmur_and_minimizers, case_fit_histogram, case_std_sort,
    case_gfa_index, case_anchors_expanded_csr, case_plan_pairs,
    case_shard_wide_tables, case_dense_and_hand_graphs, case_graph_from_csr,
], ids=lambda f: f.__name__[5:])
def test_port_host_module_matches_jax_package(case, tmp_path_factory):
    rng = np.random.default_rng(17)
    outs = list(case(rng, str(tmp_path_factory.getbasetemp())))
    if outs:
        jax_out, port_out = outs
        same(jax_out, port_out)
