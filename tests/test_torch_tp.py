"""dipgenie_tpu_torch's tp-sharded wide path as a whole: the tp DP and the
pipeline in gloo ranks on the CPU (K4 alone is in
test_torch_wide_step.py).

Ranks spawned from ``tests/torch_tp_ranks.py`` run the
port's ``PairDiploidDP`` with a ``(1, n_tp)`` mesh; every rank's ``(value,
s_het, transitions)`` must equal the exact tier or the baked oracle, the
port's single-device run and, on the MHC wide slice, the JAX package's tp
DP on its virtual CPU mesh. The pipeline's FASTA on every rank must be
byte-identical to the single-process port's and the native tier's.
"""

import io
import os

import numpy as np
import pytest

from dipgenie_tpu.ops.diploid_pallas import PairDiploidDP as JaxPairDiploidDP
from dipgenie_tpu.solver.diploid import (
    _forward_exact, build_color_masks, csr_arrays,
)
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
from dipgenie_tpu_torch.ops.plan import plan_pairs, plan_to_device
from tests.test_torch_narrow import plans
from tests.test_torch_wide import HAND, WIDE_CASES, _csr_of
from tests.test_torch_wide_split import _dense
from tests.torch_tp_ranks import run_ranks

DP_CASES = WIDE_CASES + list(HAND) + ["mhc_slice_wide_csr", "width140"]


def _case(case):
    """(CSR arrays, R, the exact answer) of a DP case."""
    if case == "width140":
        g, chb = _dense(140)
        return list(csr_arrays(g, chb)), 2, _forward_exact(
            g, 2, *build_color_masks(g, chb))
    if case == "mhc_slice_wide_csr":
        d = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 case + ".npz"))
        arrs, R = _csr_of(case)
        return arrs, R, (int(d["oracle_value"]), int(d["oracle_shet"]),
                         [tuple(int(x) for x in r)
                          for r in d["oracle_transitions"]])
    arrs, R = _csr_of(case)
    if case in HAND:
        g, chb, _ = HAND[case]()
    else:
        from tests.test_device_kernels import _random_leveled_graph

        seed, L, kmax, _, nc = case
        rng = np.random.default_rng(seed)
        g = _random_leveled_graph(rng, L=L, kmax=kmax, ncolors=nc)
        chb = [bool(x) for x in rng.random(nc) < 0.4]
    return arrs, R, _forward_exact(g, R, *build_color_masks(g, chb))


def test_make_mesh_needs_a_process_group(tmp_path):
    """No single-process stand-in: no group raises, and so does a world
    size other than n_dp * n_tp."""
    import torch.distributed as dist

    from dipgenie_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(n_tp=1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(n_dp=1, n_tp=2)
        with pytest.raises(ValueError, match="needs 3 ranks"):
            make_mesh(n_dp=3, n_tp=1)
        mesh = make_mesh(n_tp=1)
        assert (mesh.n_dp, mesh.n_tp, mesh.tp_rank) == (1, 1, 0)
        arrs, R = _csr_of("hole_window")
        with pytest.raises(ValueError, match="needs its mesh"):
            PairDiploidDP(plan_to_device(plan_pairs(*arrs, R), "cpu",
                                         mesh=mesh), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pangenome_case(tmp_path_factory):
    """A small synthetic pangenome with wide runs, and the FASTA of the
    single-process port (torch tier on the CPU) and of the native tier."""
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig
    from dipgenie_tpu_torch.utils.synth import pangenome

    root = tmp_path_factory.mktemp("tp_pg")
    gfa, reads = pangenome(str(root), n_bp=20_000, n_walks=8, seed=1)
    fasta = {}
    for backend in ("torch", "native"):
        out = root / f"{backend}.fa"
        cfg = PipelineConfig(device="cpu", dp_backend=backend, verbose=False)
        Pipeline(gfa, reads, str(out), cfg).run(out=io.StringIO())
        fasta[backend] = out.read_bytes()
    return gfa, reads, fasta


@pytest.fixture(scope="module")
def tp2(tmp_path_factory, pangenome_case):
    """Two gloo ranks on every DP case and the pipeline."""
    tmp = str(tmp_path_factory.mktemp("tp2"))
    job = {"dps": {str(c): _case(c)[:2] for c in DP_CASES},
           "pipeline": pangenome_case[:2]}
    return tmp, run_ranks(2, job, tmp)


@pytest.mark.parametrize("case", DP_CASES)
def test_tp_dp_two_ranks_matches_exact_and_single_device(case, tp2):
    arrs, R, want = _case(case)
    _, ranks = tp2
    assert [r["tp_rank"] for r in ranks] == [0, 1]
    single = PairDiploidDP(plan_pairs(*arrs, R), "cpu").run()
    assert single == want
    for r in ranks:
        assert r[str(case)] == want


def test_tp_dp_mhc_wide_slice_matches_jax_tp_dp(tp2):
    """The JAX package's tp DP (``mesh=make_mesh(n_dp=1, n_tp=2)`` on the
    virtual CPU mesh, interpret mode), as tests/test_parallel.py:229."""
    import jax

    from dipgenie_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    arrs, R = _csr_of("mhc_slice_wide_csr")
    jplan, _ = plans(arrs, R)
    want = JaxPairDiploidDP(jplan, interpret=True,
                            mesh=make_mesh(n_dp=1, n_tp=2)).run()
    for r in tp2[1]:
        assert r["mhc_slice_wide_csr"] == want


def test_tp_pipeline_two_ranks_fasta_matches_native_tier(tp2,
                                                         pangenome_case):
    tmp, _ = tp2
    _, _, fasta = pangenome_case
    assert fasta["torch"] == fasta["native"]
    assert len(fasta["native"]) > 30_000
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.fa"), "rb") as fh:
            assert fh.read() == fasta["native"]


def test_tp_dp_three_ranks_matches_exact(tmp_path):
    """Three ranks: NB 31 windows split 11 / 10 / 10."""
    arrs, R, want = _case("width140")
    ranks = run_ranks(3, {"dps": {"width140": (arrs, R)}}, str(tmp_path))
    assert [r["tp_rank"] for r in ranks] == [0, 1, 2]
    for r in ranks:
        assert r["width140"] == want
