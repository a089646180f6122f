"""The edge-space chain probe: K7 ``chain_edge`` checked against the numpy
oracle on a short chain, then its per-level slope.

Counterpart of ``scripts/tpu_edge_probe.py`` (same chain as the pair
probe's, same lengths).

    python -m dipgenie_tpu_torch.probes edge [T1 T2] [--device cpu]
"""

from __future__ import annotations

import functools

import torch

from ..ops.chain_edge import chain_edge, check_twins
from . import pair, tables


def build(T, device, live=False):
    """``(fn, args, hostE)`` of a chain of ``T`` levels (``pair.build``'s
    chain); the transposed tables are checked here, once, and not inside
    the timed calls."""
    *tabs, hostE = tables.edge_tables(T, **(tables.LIVE if live else {}))
    args = tuple(torch.from_numpy(a).to(device) for a in tabs)
    check_twins(*args[:4])
    return functools.partial(chain_edge, twins_checked=True), args, hostE


def main(argv=None) -> int:
    return pair.main(argv, name="edge16", build=build)
