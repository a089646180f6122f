"""The port's CLI (``python -m dipgenie_tpu_torch``): JAX-free imports,
the explicit device, rejected TPU flags, and byte-identical output against
the JAX package's CLI on a synthetic pangenome."""

import glob
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from tests.conftest import ref_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600, **kw)


@pytest.fixture(scope="module")
def tiny_pangenome(tmp_path_factory):
    from dipgenie_tpu_torch.utils.synth import pangenome

    return pangenome(str(tmp_path_factory.mktemp("pg")), n_bp=20_000,
                     n_walks=8, seed=1)


def test_port_imports_no_jax(tmp_path):
    """Every module of the port imports in a fresh process without JAX or
    any module of the JAX package landing in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dipgenie_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dipgenie_tpu_torch.__path__, 'dipgenie_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) > 30, names\n"
        "assert {'dipgenie_tpu_torch.parallel.mesh',\n"
        "        'dipgenie_tpu_torch.ops.wide_step',\n"
        "        'dipgenie_tpu_torch.ops.chain_floor',\n"
        "        'dipgenie_tpu_torch.ops.chain_pair',\n"
        "        'dipgenie_tpu_torch.ops.chain_edge',\n"
        "        'dipgenie_tpu_torch.ops.caps',\n"
        "        'dipgenie_tpu_torch.ops.sketch',\n"
        "        'dipgenie_tpu_torch.entry',\n"
        "        *('dipgenie_tpu_torch.probes.' + m for m in (\n"
        "            'tables', 'slope', 'floor', 'pair', 'edge',\n"
        "            'dp_stages', 'parity_gate', 'caps',\n"
        "            'caps_tables'))} <= set(names), names\n"
        "importlib.import_module('dipgenie_tpu_torch.probes.__main__')\n"
        "rc = dipgenie_tpu_torch.cli.main(['--version'])\n"
        "assert rc == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'dipgenie_tpu')]\n"
        "assert not bad, bad\n"
    )
    p = _run(["-c", code], tmp_path)
    assert p.returncode == 0, p.stderr
    assert "PHI version: 1.0" in p.stderr


def test_port_sources_do_not_import_jax_package():
    """A static scan: no import of ``dipgenie_tpu``, ``jax``, ``jaxlib``
    or ``scripts`` in the port's sources (``ops/`` and ``probes/``
    included) or in chip_smoke.py (which runs the JAX package's CLI only
    as a subprocess, as its reference)."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(dipgenie_tpu|jax|jaxlib|scripts)(\.|\s|,|$)",
        re.M)
    files = glob.glob(os.path.join(REPO, "dipgenie_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 40
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"dipgenie_tpu_torch/probes/__main__.py",
            "dipgenie_tpu_torch/probes/parity_gate.py",
            "dipgenie_tpu_torch/probes/caps.py",
            "dipgenie_tpu_torch/probes/caps_tables.py",
            "dipgenie_tpu_torch/ops/chain_edge.py",
            "dipgenie_tpu_torch/ops/caps.py",
            "dipgenie_tpu_torch/ops/sketch.py",
            "dipgenie_tpu_torch/entry.py"} <= names
    assert pattern.search("import jax\n") and pattern.search(
        "    from scripts.tpu_pair_probe import build\n")
    assert not pattern.search("from dipgenie_tpu_torch.ops import plan\n")
    hits = [f for f in files if pattern.search(open(f).read())]
    assert not hits, hits


def _assert_stops_without_card(tmp_path, gfa, reads, flags):
    """Without a card the torch tier on cuda stops with exit code 1
    before any host work, and writes no FASTA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(["-m", "dipgenie_tpu_torch", *flags, "-p2", "-g", gfa, "-r",
              reads, "-o", "out.fa"], tmp_path)
    assert p.returncode == 1
    assert "torch.cuda.is_available() is false" in p.stderr
    assert "Loaded graph" not in p.stderr
    assert not (tmp_path / "out.fa").exists()


def test_cuda_device_without_card_fails_clearly(tmp_path, tiny_pangenome):
    _assert_stops_without_card(tmp_path, *tiny_pangenome,
                               ["--dp-backend", "torch", "--device", "cuda"])


def test_default_flags_without_card_do_not_fall_back(tmp_path,
                                                     tiny_pangenome):
    """The defaults (--dp-backend auto --device cuda) mean the torch tier
    on the card: no CPU tier runs unless asked for."""
    _assert_stops_without_card(tmp_path, *tiny_pangenome, [])


@pytest.mark.parametrize("flags,msg", [
    (["--dp-backend", "pallas"], "TPU tier"),
    (["--dp-backend", "pallas", "--device", "cpu"], "TPU tier"),
    (["--sketch-backend", "device", "-k", "33"], "-k up to 32"),
])
def test_tpu_only_flags_are_rejected(flags, msg, capsys):
    from dipgenie_tpu_torch.cli import main

    assert main([*flags, "-g", "x.gfa", "-r", "x.fq", "-o", "x.fa"]) == 2
    assert msg in capsys.readouterr().err


def _strip(stdout):
    # the timing line and the output path differ between runs
    return [x for x in stdout.splitlines()
            if " took " not in x and "written to" not in x]


@pytest.mark.parametrize("rflag", ["-R18", "-R36"])
def test_torch_cpu_cli_matches_jax_exact_cli(rflag, tmp_path, tiny_pangenome):
    """-R36 is past the TPU planner's R <= 31: the JAX package's exact tier
    and the port's torch tier both run it."""
    gfa, reads = tiny_pangenome
    outs = {}
    for tag, args in (
        ("port", ["-m", "dipgenie_tpu_torch", "--dp-backend", "torch",
                  "--device", "cpu"]),
        ("jax", ["-m", "dipgenie_tpu", "--dp-backend", "exact"]),
    ):
        d = tmp_path / tag
        d.mkdir()
        p = _run([*args, "-p2", rflag, "-g", gfa, "-r", reads, "-o",
                  "out.fa"], d)
        assert p.returncode == 0, p.stderr[-3000:]
        outs[tag] = (p.stdout, (d / "out.fa").read_bytes(), p.stderr)
    assert outs["port"][1] == outs["jax"][1]
    assert len(outs["port"][1]) > 30_000
    assert _strip(outs["port"][0]) == _strip(outs["jax"][0])
    assert "DP value:" in outs["port"][0]
    assert "torch tier on cpu" in outs["port"][2]


def test_cli_past_the_value_bound_prints_one_error_line(tmp_path,
                                                       tiny_pangenome):
    """Past the planner's value bound (``VALUE_MAX`` patched to 0 in the
    CLI's process, so any positive value is past it) the CLI prints one
    ``[E::main]`` line that names the native tier and exits 1: no
    traceback, no FASTA, no fallback."""
    gfa, reads = tiny_pangenome
    code = (
        "import sys\n"
        "from dipgenie_tpu_torch.ops import pair_plan\n"
        "pair_plan.VALUE_MAX = 0\n"
        "from dipgenie_tpu_torch.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    p = _run(["-c", code, "--dp-backend", "torch", "--device", "cpu", "-p2",
              "-R18", "-g", gfa, "-r", reads, "-o", "out.fa"], tmp_path)
    errors = [x for x in p.stderr.splitlines() if x.startswith("[E::")]
    assert p.returncode == 1 and len(errors) == 1, p.stderr[-2000:]
    assert errors[0].startswith("[E::main] DP values may reach ")
    assert "--dp-backend native" in errors[0]
    assert "Traceback" not in p.stderr and "torch tier on" not in p.stderr
    assert not (tmp_path / "out.fa").exists()


@pytest.fixture(scope="module")
def small_pangenome(tmp_path_factory):
    """4 walks over 10 kbp: the JAX chunked tier's CLI compiles a program
    for each op shape, ~100 s on tiny_pangenome's wider levels."""
    from dipgenie_tpu_torch.utils.synth import pangenome

    return pangenome(str(tmp_path_factory.mktemp("pg4")), n_bp=10_000,
                     n_walks=4, seed=1)


@pytest.mark.parametrize("backend", ["fused", "jax"])
def test_vertex_tier_cli_matches_jax_cli(backend, tmp_path, request):
    """``--dp-backend fused|jax --device cpu`` (K13-K16's plain versions)
    and the JAX package's CLI with the same flag: the same FASTA bytes and
    stdout (apart from the timing line)."""
    gfa, reads = request.getfixturevalue(
        "tiny_pangenome" if backend == "fused" else "small_pangenome")
    outs = {}
    for tag, args in (
        ("port", ["-m", "dipgenie_tpu_torch", "--device", "cpu"]),
        ("jax", ["-m", "dipgenie_tpu"]),
    ):
        d = tmp_path / tag
        d.mkdir()
        p = _run([*args, "--dp-backend", backend, "-p2", "-R18", "-g", gfa,
                  "-r", reads, "-o", "out.fa"], d)
        assert p.returncode == 0, p.stderr[-3000:]
        outs[tag] = (p.stdout, (d / "out.fa").read_bytes(), p.stderr)
    assert outs["port"][1] == outs["jax"][1]
    assert len(outs["port"][1]) > 10_000
    assert _strip(outs["port"][0]) == _strip(outs["jax"][0])
    name = "fused" if backend == "fused" else "chunked"
    assert f"{name} tier on cpu" in outs["port"][2]


def test_cli_auto_past_the_window_limit_runs_the_fused_tier(
        tmp_path, tiny_pangenome):
    """``auto`` with the pair planner's window limit patched to 4 in the
    CLI's process (tiny_pangenome's widest run needs 5 windows): one
    ``[W::diploid_dp]`` line naming the limit, then the fused tier writes
    the native tier's FASTA."""
    gfa, reads = tiny_pangenome
    code = (
        "import sys\n"
        "from dipgenie_tpu_torch.ops import pair_plan\n"
        "pair_plan.SPLIT_NB_MAX = 4\n"
        "from dipgenie_tpu_torch.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    outs = {}
    for tag, args in (("auto", ["-c", code, "--device", "cpu"]),
                      ("native", ["-m", "dipgenie_tpu_torch", "--dp-backend",
                                  "native"])):
        d = tmp_path / tag
        d.mkdir()
        p = _run([*args, "-p2", "-R18", "-g", gfa, "-r", reads, "-o",
                  "out.fa"], d)
        assert p.returncode == 0, p.stderr[-3000:]
        outs[tag] = (p.stdout, (d / "out.fa").read_bytes(), p.stderr)
    warns = [x for x in outs["auto"][2].splitlines()
             if x.startswith("[W::")]
    assert len(warns) == 1, outs["auto"][2][-2000:]
    assert warns[0].startswith("[W::diploid_dp] torch tier: a wide run "
                               "needs 5 1024-lane windows, past 4")
    assert "fused tier on cpu" in outs["auto"][2]
    assert outs["auto"][1] == outs["native"][1]
    assert _strip(outs["auto"][0]) == _strip(outs["native"][0])


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory, tiny_pangenome):
    """Two gloo ranks (``tests/torch_tp_ranks.py``) on the CPU: the CLI
    with ``--dp-backend jax`` and ``fused`` and the mesh in its
    ``PipelineConfig`` on the pangenome of ``tests/test_torch_tp.py``, and
    ``auto`` on a graph with a level 600 wide through ``device_forward``;
    the native tier's FASTA of the same pangenome."""
    from dipgenie_tpu_torch.solver.diploid import csr_arrays
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig
    from tests.test_torch_fused import width600_graph
    from tests.torch_tp_ranks import run_ranks

    gfa, reads = tiny_pangenome
    tmp = tmp_path_factory.mktemp("cli_mesh")
    native = tmp / "native.fa"
    Pipeline(gfa, reads, str(native), PipelineConfig(
        device="cpu", dp_backend="native", verbose=False)).run(
            out=io.StringIO())
    argv = ["--device", "cpu", "-p2", "-R18", "-g", gfa, "-r", reads]
    job = {"cli": {b: ["--dp-backend", b, *argv] for b in ("jax", "fused")},
           "auto": {"width600": (csr_arrays(*width600_graph()), 3)}}
    return tmp, run_ranks(2, job, str(tmp)), native.read_bytes()


@pytest.mark.parametrize("backend", ["jax", "fused"])
def test_mesh_vertex_tier_two_ranks_writes_native_fasta(backend, mesh_ranks):
    """Under a mesh of 2 ranks ``--dp-backend jax`` (its wide transitions
    split over the ranks) and ``fused`` (whole on every rank, with one
    ``[W::diploid_dp]`` line saying so) write the native tier's FASTA on
    every rank."""
    tmp, ranks, native = mesh_ranks
    assert len(native) > 30_000
    for r, res in enumerate(ranks):
        rc, err = res["cli"][backend]
        assert rc == 0, err[-3000:]
        assert not [x for x in err.splitlines() if x.startswith("[E::")]
        warns = [x for x in err.splitlines() if x.startswith("[W::")]
        if backend == "fused":
            assert warns == ["[W::diploid_dp] fused tier: not sharded over "
                             "the tp mesh; it runs whole on each of its 2 "
                             "ranks"], err[-2000:]
            assert "fused tier on cpu" in err
        else:
            assert not warns, err[-2000:]
            assert "chunked tier on cpu" in err
            assert "over a tp mesh of 2 ranks" in err
        assert (tmp / f"rank{r}_{backend}.fa").read_bytes() == native


def test_mesh_auto_past_the_window_limit_runs_the_chunked_tier(mesh_ranks):
    """``auto`` under a mesh of 2 ranks on a graph with a level 600 wide:
    one ``[W::diploid_dp]`` line naming the window limit and the chunked
    tier over the mesh, and on every rank the exact tier's result, the
    wide transitions split over the ranks."""
    from dipgenie_tpu.solver.diploid import _forward_exact, build_color_masks
    from tests.test_torch_fused import width600_graph

    g, chb = width600_graph()
    want = _forward_exact(g, 3, *build_color_masks(g, chb))
    for res in mesh_ranks[1]:
        got, err = res["auto"]["width600"]
        warns = [x for x in err.splitlines() if x.startswith("[W::")]
        assert len(warns) == 1, err[-2000:]
        assert warns[0].startswith("[W::diploid_dp] torch tier: a wide run "
                                   "needs ")
        assert warns[0].endswith("(a level wider than 512); running the "
                                 "chunked tier over the tp mesh of 2 ranks")
        assert "chunked tier on cpu" in err
        assert re.search(r"over a tp mesh of 2 ranks: [1-9]\d* wide "
                         r"transitions split", err), err[-2000:]
        assert got == want


def test_toy_diploid_torch_cpu_matches_golden(tmp_path):
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig
    from tests.test_e2e_toy import TOY_DIP_GOLDEN

    gfa, reads = ref_fixture("test.gfa"), ref_fixture("read.fa")
    out = tmp_path / "dip.fa"
    cfg = PipelineConfig(k=5, w=3, recombination_limit=4, ploidy=2,
                         verbose=False, dp_backend="torch", device="cpu")
    buf = io.StringIO()
    Pipeline(gfa, reads, str(out), cfg).run(out=buf)
    assert out.read_text() == TOY_DIP_GOLDEN
    assert "DP value: 14" in buf.getvalue()


def test_toy_haploid_torch_cli_matches_golden(tmp_path):
    from tests.test_e2e_toy import TOY_HAP_GOLDEN

    gfa, reads = ref_fixture("test.gfa"), ref_fixture("read.fa")
    p = _run(["-m", "dipgenie_tpu_torch", "-k5", "-w3", "-p1", "--device",
              "cpu", "-g", gfa, "-r", reads, "-o", "hap.fa"], tmp_path)
    assert p.returncode == 0, p.stderr
    assert (tmp_path / "hap.fa").read_text() == TOY_HAP_GOLDEN
