"""Stage-by-stage breakdown of the pair DP: plan, ship, forward (and the
narrow and wide runs' shares of it), traceback, ``run()`` as a whole.

Counterpart of ``scripts/tpu_e2e_probe.py`` and
``scripts/tpu_split_probe.py`` on the port's ``PairDiploidDP``. The TPU
script got the narrow and wide shares by swapping one kernel kind for an
identity, which makes the DP wrong; here every run of the forward pass is
bracketed by two timestamps and the spans are summed per segment kind, so
the pass that is timed is the pass that is right. On the card the forward
pass, its spans and the traceback are CUDA-event times; plan, ship and
``run()`` are host-clock times that end in a synchronise. With ``--device
cpu`` everything is host clock on the plain PyTorch versions.

The input is ``utils.synth.mhc_shaped_csr`` (``--L`` levels, R = 18), or a
``PairPlan`` pickled by this package (``--plan``; unpickling runs code, so
load only a file this package wrote).

    python -m dipgenie_tpu_torch.probes dp-stages [--L 120000] [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
import time

import torch

from ..device import resolve_device
from ..ops.diploid_pair import PairDiploidDP, assemble
from ..ops.plan import plan_pairs, plan_to_device
from ..ops.trace import trace
from ..utils.synth import dp_states, mhc_shaped_csr
from .slope import clock

R = 18


class _Marks:
    """Timestamps on the device's clock: CUDA events on the card's current
    stream, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        """From mark ``a`` to mark ``b`` (synchronises the card)."""
        if not self.cuda:
            return b - a
        torch.cuda.synchronize(self.device)
        return a.elapsed_time(b) / 1e3


def forward_by_kind(dp: PairDiploidDP, marks: _Marks):
    """One ``dp.forward()`` with a mark after every run: ``(V, bps,
    seconds, {kind: (runs, transitions, seconds)})``."""
    stamps = [marks.mark()]
    V, bps = dp.forward(on_segment=lambda seg: stamps.append(marks.mark()))
    kinds = {}
    for seg, a, b in zip(dp.dplan.segments, stamps, stamps[1:]):
        n, tr, s = kinds.get(seg.kind, (0, 0, 0.0))
        kinds[seg.kind] = (n + 1, tr + seg.t1 - seg.t0,
                           s + marks.seconds(a, b))
    return V, bps, marks.seconds(stamps[0], stamps[-1]), kinds


def stages(plan, device, log=print) -> dict:
    """Ship ``plan`` and time the DP's stages on ``device``; every figure
    goes to ``log`` as a line and comes back in a dict of seconds."""
    device = torch.device(device)
    marks = _Marks(device)

    def sync():
        if marks.cuda:
            torch.cuda.synchronize(device)

    out = {}
    t0 = time.time()
    dplan = plan_to_device(plan, device)
    sync()
    out["ship"] = time.time() - t0
    log(f"ship: {out['ship']:.3f}s (host clock)")
    dp = PairDiploidDP(dplan, device)

    t0 = time.time()
    V, bps = dp.forward()
    sync()
    log(f"forward, first pass: {time.time() - t0:.4f}s (host clock)")
    del V, bps

    V, bps, out["forward"], kinds = forward_by_kind(dp, marks)
    log(f"forward: {out['forward']:.4f}s ({clock(device)})")
    for kind, (n, tr, s) in sorted(kinds.items()):
        out[f"forward_{kind}"] = s
        log(f"  {kind}: {s:.4f}s in {n} runs, {tr} transitions, "
            f"{s / tr * 1e6:.3f} us/transition, "
            f"{s / out['forward']:.3f} of the forward")
    out["kinds"] = kinds

    a = marks.mark()
    recs = trace(dplan, bps)
    b = marks.mark()
    out["traceback"] = marks.seconds(a, b)
    log(f"traceback: {out['traceback']:.4f}s ({clock(device)})")
    value = assemble(int(V[dp.R, 0]), recs.cpu().numpy())
    del V, bps, recs

    for label in ("run() total", "run() again"):
        t0 = time.time()
        again = dp.run()
        sync()
        out["run"] = time.time() - t0
        log(f"{label}: {out['run']:.4f}s (host clock; value {again[0]}, "
            f"s_het {again[1]}, {len(again[2])} transitions)")
        if again != value:
            raise AssertionError("run() differs from the marked pass")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probes dp-stages")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--L", type=int, default=120_000,
                    help="levels of the synthetic MHC-shaped graph [120000]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default="",
                    help="a PairPlan pickled by this package, instead")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    if args.plan:
        with open(args.plan, "rb") as fh:
            plan = pickle.load(fh)
        print(f"plan load: {time.time() - t0:.1f}s (host clock)")
    else:
        arrs = mhc_shaped_csr(L=args.L, seed=args.seed,
                              n_bands=max(args.L // 400, 1))
        print(f"graph: {args.L} levels, {dp_states(arrs[0], R)} DP states "
              f"(R={R}), made in {time.time() - t0:.1f}s")
        t0 = time.time()
        plan = plan_pairs(*arrs, R)
        print(f"plan: {time.time() - t0:.1f}s (host clock)")
    stages(plan, device)
    return 0
