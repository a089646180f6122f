"""The floor probe: per-level cost of four level-chain structures.

Counterpart of ``scripts/tpu_floor_probe.py`` (same variants and chain
lengths):

  scan1    a loop on the host, one trivial tensor op per level (``c + 1 +
           x[0, 0]``): what a level costs when the host dispatches it
  floor0   K5a ``chain_floor``: one launch, an empty body (the script's
           ``pallas0``); its 1,024 prefix sums are one scan over the
           card's blocks, so it no longer measures one block's floor of
           an empty-body chain
  step16   K5b ``chain_step16``: the same with a (B = 16, P = 4) DP-shaped
           body (the script's ``pallas16``)
  scandus  a loop on the host with a DP-step-sized body per level: table
           loads from stacked arrays, the gathers and the max as a handful
           of tensor ops, the backpointers stored into a carried buffer

``scan1`` and ``scandus`` were ``lax.scan`` programs, compiled into one
device loop; a PyTorch loop dispatches every level's ops from the host,
which is the launch-per-level structure the pair DP avoids.

    python -m dipgenie_tpu_torch.probes floor [variant ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..ops.chain_floor import chain_floor, chain_step16
from . import tables
from .slope import Slope, line, slope

R1, B, P = tables.R1, tables.B, tables.P


def _dev(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def build_scan1(T, device):
    xs = torch.zeros((T, 8, 128), dtype=torch.int32, device=device)

    def run(xs):
        c = torch.zeros((), dtype=torch.int32, device=xs.device)
        for t in range(xs.shape[0]):
            c = c + 1 + xs[t, 0, 0]
        return c

    return run, (xs,)


def build_floor0(T, device):
    return chain_floor, _dev((tables.floor_tables(T),), device)


def build_step16(T, device):
    return chain_step16, _dev(tables.step16_tables(T), device)


def scandus(PI, C, V0, buf):
    """``(V, buf)`` after one pass over the levels of ``PI [T, 16, 4]`` and
    ``C [T, 64, 64]`` from the state ``V0 [19, 16, 16]``, the int16
    backpointers of level ``t`` stored at ``buf[t * 4864:]``."""
    V, n = V0, R1 * B * B
    for t in range(PI.shape[0]):
        pi = PI[t].to(torch.int64).t()  # [p, i]
        Ct = C[t].reshape(P, B, P, B)
        # G[r, p, i2, q, j2] = V[r, pi[p, i2], pi[q, j2]]
        G = V[:, pi][:, :, :, pi]
        best = (G * 16 + Ct[None]).amax(dim=(1, 3))
        V = best >> 4
        buf[t * n:(t + 1) * n] = (best & 15).to(torch.int16).reshape(-1)
    return V, buf


def build_scandus(T, device):
    PI, C = _dev(tables.scandus_tables(T), device)
    V0 = torch.full((R1, B, B), tables.NEG, dtype=torch.int32, device=device)
    buf = torch.zeros(T * R1 * B * B, dtype=torch.int16, device=device)
    return scandus, (PI, C, V0, buf)


VARIANTS = {
    "scan1": (build_scan1, 4000, 40000),
    "floor0": (build_floor0, 4000, 40000),
    "step16": (build_step16, 2000, 20000),
    "scandus": (build_scandus, 2000, 20000),
}


def measure(name: str, device: torch.device, lengths=None) -> Slope:
    """The slope of one variant (its own chain lengths unless
    ``lengths = (T1, T2)``); prints the script's line."""
    build, T1, T2 = VARIANTS[name]
    T1, T2 = lengths or (T1, T2)
    print(f"== {name} ==", file=sys.stderr)
    s = slope(build, T1, T2, device)
    print(line(name, s, T1, T2, device), flush=True)
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probes floor", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"of {', '.join(VARIANTS)}; default: all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--lengths", nargs=2, type=int, metavar=("T1", "T2"),
                    help="chain lengths instead of each variant's own")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variant {unknown[0]!r}")
    device = resolve_device(args.device)
    for name in args.variants or list(VARIANTS):
        measure(name, device, args.lengths)
    return 0
