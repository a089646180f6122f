"""The pair-space chain probe: K6 ``chain_pair`` checked against the numpy
oracle on a short chain, then its per-level slope, on the script's chain
(whose states die out within a few levels) and on a chain that stays alive
(``tables.LIVE``).

Counterpart of ``scripts/tpu_pair_probe.py`` (same chain, same lengths).

    python -m dipgenie_tpu_torch.probes pair [T1 T2] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.chain_pair import chain_pair
from . import tables
from .slope import line, slope, timed

T_CHECK = 40  # the chain length of the correctness check
T1, T2 = 2000, 20000


def build(T, device, live=False):
    """``(fn, args, hostE)`` of a chain of ``T`` levels: the script's, or
    with ``live`` the one of ``tables.LIVE``."""
    tbl, hostE = tables.pair_tables(T, **(tables.LIVE if live else {}))
    return chain_pair, (torch.from_numpy(tbl).to(device),), hostE


def probe(name, build, device, T1, T2, live=False):
    """The check on ``T_CHECK`` levels, then the slope ``T1 -> T2``, as the
    scripts' ``main``, on the script's chain or the ``live`` one. The
    ``Slope``, or None after a mismatch (with the first differing states
    printed). ``build(T, device, live)`` gives ``(fn, args, hostE)``;
    ``fn(*args)`` returns ``(bp, v)``."""
    fn, args, hostE = build(T_CHECK, device, live)
    _, (bp, v) = timed(fn, args, device, f"correctness T={T_CHECK}")
    got = v.cpu().numpy().reshape(tables.R1, tables.B, tables.B)
    want = tables.committed(tables.chain_oracle(hostE))
    if not np.array_equal(got.astype(np.int64), want):
        bad = np.argwhere(got != want)
        print(f"MISMATCH at {bad[:10]}: got {got[tuple(bad[0])]} want "
              f"{want[tuple(bad[0])]}", flush=True)
        return None
    print("correctness: OK", flush=True)
    print(f"bp: shape {tuple(bp.shape)}, nonzero "
          f"{int(torch.count_nonzero(bp))}; states reachable after "
          f"{T_CHECK} levels: {int((got > tables.NEG).sum())} of {got.size}",
          flush=True)
    s = slope(lambda T, dev: build(T, dev, live)[:2], T1, T2, device)
    print(line(name, s, T1, T2, device), flush=True)
    return s


def main(argv=None, name="pair16", build=build) -> int:
    ap = argparse.ArgumentParser(prog=f"probes {name[:4]}")
    ap.add_argument("lengths", nargs="*", type=int, metavar="T",
                    help=f"T1 T2 [{T1} {T2}]")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if len(args.lengths) not in (0, 2):
        ap.error("give both T1 and T2, or neither")
    device = resolve_device(args.device)
    print(f"device: {device}", file=sys.stderr, flush=True)
    lengths = args.lengths or (T1, T2)
    for label, live in ((name, False), (name + "-live", True)):
        if probe(label, build, device, *lengths, live=live) is None:
            return 1
    return 0
