"""Compiled parity gate of the pair DP's CUDA kernels.

Counterpart of ``scripts/tpu_parity_gate.py``. The CPU tests run the
kernels' plain PyTorch versions; what ``nvcc`` made of the CUDA sources
shows only on a card. This gate runs the kernel parity matrix through the
compiled kernels (``PairDiploidDP`` on ``cuda``) and holds every case's
``(sink_value, s_het, transitions)`` to the port's exact host tier, bit
for bit: the random instances of ``utils.synth.CASES``, then the int16
backpointer overflow, the width-140 ladder extension and the two
wide-commit regressions (stale window, hole window) of the JAX package's
tests. It writes a JSON verdict with the card's name and power limit.

    python -m dipgenie_tpu_torch.probes parity-gate [-o build/GPU_PARITY.json]

Exit code 0 iff every case matches; 2 when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..device import resolve_device
from ..ops.diploid_pair import PairDiploidDP
from ..ops.plan import plan_pairs
from ..solver.diploid import _forward_exact, build_color_masks, csr_arrays
from ..utils.synth import (
    CASES, dense_graph, graph_from_csr, hand_graph, random_leveled_csr,
)

DEFAULT_OUTPUT = os.path.join("build", "GPU_PARITY.json")


def cases():
    """``(name, graph, color_homo_bv, R)`` of the matrix, in the script's
    order; each graph is made when its turn comes."""
    for seed, L, kmax, R, nc in CASES:
        g, chb = graph_from_csr(random_leveled_csr(seed, L, kmax, nc))
        yield f"rand-{seed}-L{L}-k{kmax}-R{R}", g, chb, R

    # int16 bp overflow -> wide routing (big-pair stress)
    rng = np.random.default_rng(7)
    g = dense_graph(rng, [1, 16, 16, 16, 1], deg=13, pw=0.1)
    yield "int16-bp-overflow", g, [bool(x) for x in rng.random(6) < 0.5], 3

    # a level wider than 132 vertices (more than 17 windows)
    rng = np.random.default_rng(11)
    g = dense_graph(rng, [1, 140, 140, 1], deg=2, pw=0.2)
    yield ("ladder-extension-w140", g,
           [bool(x) for x in rng.random(6) < 0.5], 2)

    # a destination extent that shrinks: windows past it must commit NEG,
    # or a later transition gathers a stale value from them
    W = 40
    starts = np.cumsum([0, 1, W, W, W])
    edges = [
        [(0, i, 0) for i in range(W)],
        [(i, i, 0) for i in range(25)],
        [(i, i, 0) for i in range(W)],
        [(i, 0, 0) for i in range(W)],
    ]
    colors = {int(starts[2] + 30): [0], int(starts[3] + 30): [0]}
    yield ("wide-commit-stale-window",
           hand_graph([1, W, W, W, 1], edges, colors), [True], 0)

    # a window inside the extent that no pair touches must commit NEG
    W = 56
    kept = list(range(18)) + list(range(37, W))
    edges = [
        [(0, i, 0) for i in range(W)],
        [(i, i, 0) for i in kept],
        [(i, 0, 0) for i in range(W)],
    ]
    yield ("wide-commit-hole-window",
           hand_graph([1, W, W, 1], edges, {1 + 5: [0], 1 + W + 5: [0]}),
           [True], 0)


def run_cases(device, limit=None):
    """The verdict of every case (the first ``limit`` when given)."""
    results = []
    for n, (name, g, chb, R) in enumerate(cases()):
        if limit is not None and n >= limit:
            break
        t0 = time.time()
        want = _forward_exact(g, R, *build_color_masks(g, chb))
        plan = plan_pairs(*csr_arrays(g, chb), R)
        got = PairDiploidDP(plan, device).run()
        ok = got == want
        results.append({"case": name, "ok": bool(ok), "value": int(got[0]),
                        "expect": int(want[0]),
                        "wall_s": round(time.time() - t0, 2)})
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: value {got[0]}/"
              f"{want[0]}", file=sys.stderr)
    return results


def card(device):
    """``(name, power limit)`` as nvidia-smi prints them; None on the
    CPU."""
    if device.type != "cuda":
        return None, None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (x.strip() for x in smi.splitlines()[0].split(",", 1))
    return name, limit


def gate(device, output=DEFAULT_OUTPUT, limit=None) -> dict:
    """Run the matrix on ``device`` and write the verdict to ``output``."""
    t0 = time.time()
    results = run_cases(device, limit)
    n_ok = sum(r["ok"] for r in results)
    name, power = card(device)
    verdict = {
        "gate": "cuda-compiled-parity" if device.type == "cuda"
        else "plain-versions-parity",
        "backend": device.type,
        "card": name,
        "power_limit": power,
        "cases": len(results),
        "passed": n_ok,
        "ok": n_ok == len(results),
        "wall_s": round(time.time() - t0, 1),
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "w") as fh:
        json.dump(verdict, fh, indent=1)
        fh.write("\n")
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probes parity-gate")
    ap.add_argument("-o", "--output", default=DEFAULT_OUTPUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--limit", type=int, default=None,
                    help="only the first LIMIT cases")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    verdict = gate(device, args.output, args.limit)
    print(json.dumps({k: verdict[k] for k in (
        "gate", "backend", "card", "power_limit", "cases", "passed", "ok",
        "wall_s")}))
    return 0 if verdict["ok"] else 1
