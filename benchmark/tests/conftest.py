"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the root of the checkout. The benchmark's modules and the program are
imported from the checkout."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(L=400, n_bands=2, band_len=4, wmin=33, wmax=40)


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark and ``BENCHMARK.json``, each configuration
    shrunk to a tiny graph (the harness reads whatever file the entry
    names)."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    with open(tmp_path / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        p = tmp_path / c["file"]
        cfg = json.loads(p.read_text())
        cfg["params"] = dict(TINY)
        p.write_text(json.dumps(cfg))
    return tmp_path
