"""The capability probes: every check of K8 (``caps``, 15 checks) or K9
(``caps2``, 15 checks) run once on the script's inputs and held to the
script's expectation, exactly, one line each::

    PASS  name
    WRONG name: got [...] expect [...] (n of m elements differ)
    FAIL  name: ErrorType: message

Counterparts of ``scripts/tpu_caps_probe.py`` and
``scripts/tpu_caps_probe2.py`` (same names, order, inputs, expectations
and lines). Unlike the scripts, a probe exits 1 when any line is not
``PASS``.

    python -m dipgenie_tpu_torch.probes caps [name ...] [--device cpu]
    python -m dipgenie_tpu_torch.probes caps2 [name ...] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.caps import CHECKS
from . import caps_tables


def to_device(arrays, device) -> tuple:
    """The tables as the wrappers take them: a uint32 array as its int32
    view."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in arrays)


def run_check(name: str, device: torch.device, seed: int | None = None):
    """``(status, detail)`` of one check through its wrapper; ``status``
    is ``PASS``, ``WRONG`` or ``FAIL``."""
    try:
        ins, expect = caps_tables.make(name, seed)
        got = CHECKS[name][0](*to_device(ins, device)).cpu().numpy()
    except Exception as e:  # noqa: BLE001 - the line names the failure
        msg = str(e).split("\n")[0][:160]
        return "FAIL", f"{type(e).__name__}: {msg}"
    if got.dtype != expect.dtype or got.shape != expect.shape:
        return "WRONG", (f"got {got.dtype} {got.shape}, expect "
                         f"{expect.dtype} {expect.shape}")
    bad = np.count_nonzero(got != expect)
    if bad:
        return "WRONG", (f"got {got.ravel()[:8]} expect {expect.ravel()[:8]} "
                         f"({bad} of {got.size} elements differ)")
    return "PASS", ""


def _main(argv, script: str, names: tuple) -> int:
    ap = argparse.ArgumentParser(
        prog=f"probes {script}", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("checks", nargs="*", metavar="name",
                    help=f"of {', '.join(names)}; default: all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    unknown = [n for n in args.checks if n not in names]
    if unknown:
        ap.error(f"unknown check {unknown[0]!r}")
    device = resolve_device(args.device)
    failed = 0
    for name in args.checks or names:
        status, detail = run_check(name, device)
        failed += status != "PASS"
        print(f"{status:<5} {name}" + (f": {detail}" if detail else ""),
              flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    """``probes caps``: K8's 15 checks."""
    return _main(argv, "caps", caps_tables.K8)


def main2(argv=None) -> int:
    """``probes caps2``: K9's 15 checks."""
    return _main(argv, "caps2", caps_tables.K9)
