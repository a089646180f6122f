"""The port's CLI (``python -m dipgenie_tpu_torch``): JAX-free imports,
the explicit device, rejected TPU flags, and byte-identical output against
the JAX package's CLI on a synthetic pangenome."""

import io
import os
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
    code = (
        "import sys\n"
        "import dipgenie_tpu_torch, dipgenie_tpu_torch.cli\n"
        "import dipgenie_tpu_torch.kernels, dipgenie_tpu_torch.device\n"
        "import dipgenie_tpu_torch.ops.diploid_pair\n"
        "import dipgenie_tpu_torch.solver.pipeline\n"
        "import dipgenie_tpu_torch.utils.synth\n"
        "import dipgenie_tpu_torch.utils.native_build\n"
        "rc = dipgenie_tpu_torch.cli.main(['--version'])\n"
        "assert rc == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'], "
        "'jax imported'\n"
    )
    p = _run(["-c", code], tmp_path)
    assert p.returncode == 0, p.stderr
    assert "PHI version: 1.0" in p.stderr


def test_cuda_device_without_card_fails_clearly(tmp_path, tiny_pangenome):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gfa, reads = tiny_pangenome
    p = _run(["-m", "dipgenie_tpu_torch", "--dp-backend", "torch",
              "--device", "cuda", "-g", gfa, "-r", reads, "-o", "out.fa"],
             tmp_path)
    assert p.returncode != 0
    assert "torch.cuda.is_available() is false" in p.stderr
    assert not (tmp_path / "out.fa").exists()


@pytest.mark.parametrize("flags,msg", [
    (["--dp-backend", "pallas"], "TPU tier"),
    (["--dp-backend", "jax"], "TPU tier"),
    (["--sketch-backend", "device"], "not ported"),
])
def test_tpu_only_flags_are_rejected(flags, msg, capsys):
    from dipgenie_tpu_torch.cli import main

    assert main([*flags, "-g", "x.gfa", "-r", "x.fq", "-o", "x.fa"]) == 2
    assert msg in capsys.readouterr().err


def _strip(stdout):
    # the timing line and the output path differ between runs
    return [x for x in stdout.splitlines()
            if " took " not in x and "written to" not in x]


def test_torch_cpu_cli_matches_jax_exact_cli(tmp_path, tiny_pangenome):
    gfa, reads = tiny_pangenome
    outs = {}
    for tag, args in (
        ("port", ["-m", "dipgenie_tpu_torch", "--dp-backend", "torch",
                  "--device", "cpu"]),
        ("jax", ["-m", "dipgenie_tpu", "--dp-backend", "exact"]),
    ):
        d = tmp_path / tag
        d.mkdir()
        p = _run([*args, "-p2", "-R18", "-g", gfa, "-r", reads, "-o",
                  "out.fa"], d)
        assert p.returncode == 0, p.stderr[-3000:]
        outs[tag] = (p.stdout, (d / "out.fa").read_bytes(), p.stderr)
    assert outs["port"][1] == outs["jax"][1]
    assert len(outs["port"][1]) > 30_000
    assert _strip(outs["port"][0]) == _strip(outs["jax"][0])
    assert "DP value:" in outs["port"][0]
    assert "torch tier on cpu" in outs["port"][2]


def test_toy_diploid_torch_cpu_matches_golden(tmp_path):
    from dipgenie_tpu_torch.solver.pipeline import (
        TorchPipeline, TorchPipelineConfig,
    )
    from tests.test_e2e_toy import TOY_DIP_GOLDEN

    gfa, reads = ref_fixture("test.gfa"), ref_fixture("read.fa")
    out = tmp_path / "dip.fa"
    cfg = TorchPipelineConfig(k=5, w=3, recombination_limit=4, ploidy=2,
                              verbose=False, dp_backend="torch",
                              device="cpu")
    buf = io.StringIO()
    TorchPipeline(gfa, reads, str(out), cfg).run(out=buf)
    assert out.read_text() == TOY_DIP_GOLDEN
    assert "DP value: 14" in buf.getvalue()


def test_toy_haploid_torch_cli_matches_golden(tmp_path):
    from tests.test_e2e_toy import TOY_HAP_GOLDEN

    gfa, reads = ref_fixture("test.gfa"), ref_fixture("read.fa")
    p = _run(["-m", "dipgenie_tpu_torch", "-k5", "-w3", "-p1", "--device",
              "cpu", "-g", gfa, "-r", reads, "-o", "hap.fa"], tmp_path)
    assert p.returncode == 0, p.stderr
    assert (tmp_path / "hap.fa").read_text() == TOY_HAP_GOLDEN
