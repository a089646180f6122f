"""No JAX and no JAX package in what the benchmark loads; nothing of the
program in the reference's files; no result without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

# the reference's files: the comparison, the inputs both sides get, the
# work count
PLAIN = ("reference.py", "inputs.py", "work.py")
ALLOWED = {"__future__", "dataclasses", "json", "os", "numpy", "torch"}


def _run(code: str, cwd: str = ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_nothing_loads_jax_or_the_jax_package():
    """Every module of the harness, every tier adapter and metric reader,
    with the program they load: no top-level name ``jax``, ``jaxlib``,
    ``flax`` or ``dipgenie_tpu``, compared whole (``dipgenie_tpu_torch``
    passes)."""
    code = f"""
import json, os, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import harness
bench = harness.load_bench(os.path.join({ROOT!r}, "BENCHMARK.json"))
for w in bench["workloads"]:
    _, _, traffic = harness.cell_parts(bench, {ROOT!r}, w["name"])
    harness.load_tier(traffic["tier"])
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.metric_reader(m["name"])
import run
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([tops, harness.forbidden_modules()]))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    tops, bad = json.loads(out.stdout.splitlines()[-1])
    assert "dipgenie_tpu_torch" in tops
    assert bad == []
    assert not set(tops) & {"jax", "jaxlib", "flax", "dipgenie_tpu"}


def test_forbidden_modules_compares_whole_names():
    import harness
    sys.modules.setdefault("dipgenie_tpu_torch", sys.modules[__name__])
    assert "dipgenie_tpu" not in harness.forbidden_modules()
    fake = type(sys)("jaxlib")
    sys.modules["jaxlib.fake_child"] = fake
    try:
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        del sys.modules["jaxlib.fake_child"]


def test_the_reference_imports_nothing_of_the_program():
    for name in PLAIN:
        with open(os.path.join(BENCH, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ALLOWED, (name, m)
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}]
import reference, inputs, work
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "dipgenie_tpu" not in out.stdout


def test_run_without_a_card_prints_no_result():
    """No CPU fallback: without a card ``run.py`` exits non-zero and its
    standard output holds no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         "mhc4.pair", "--seed", "2147483659", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout


def test_run_without_the_program_fails(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark's folder, a run cannot load the program and fails."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = f"""
import sys
sys.path[:0] = [{str(tmp_path / 'benchmark')!r}, {str(tmp_path)!r}]
import harness
bench = harness.load_bench({str(tmp_path / 'BENCHMARK.json')!r})
harness.run_cell(bench, {str(tmp_path)!r}, "mhc4.fused", 1, 0.1, False, "cpu")
print("RESULT")
"""
    out = _run(code, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "RESULT" not in out.stdout
    assert "dipgenie_tpu_torch" in out.stderr
