"""The diploid pair DP on one device: forward over the plan's segments in
level order, then one traceback.

Counterpart of ``dipgenie_tpu.ops.diploid_pallas.PairDiploidDP`` with the
same contract: ``run() -> (sink_value, sink_s_het, transitions)``, with
``transitions`` a list of ``(level, pi, pj, i2, j2, wu, wv)``, level
ascending 1..L-1. Every segment's backpointers stay resident on the
device until the traceback (the JAX package re-ran segments to
rematerialise them); on CUDA tensors every step is a kernel of
``csrc/``, on CPU tensors its plain PyTorch version. Narrow runs go to K1,
wide runs to K2 or, beyond ``DENSE_NB_MAX`` windows, K3.

With a ``mesh`` (``parallel.mesh.make_mesh``, one process per rank) every
wide run goes to K4 on this rank's destination windows, merged over the tp
group after each transition (``wide_step.py:wide_tp_run``); narrow runs
and the traceback run on every rank, so every rank returns the same
result, equal to the single-device path's.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..utils import timing
from .narrow import narrow_run
from .plan import DevPlan, PairPlan, initial_v, plan_to_device
from .trace import trace
from .wide import wide_dense_run
from .wide_split import wide_split_run
from .wide_step import wide_step, wide_tp_run

# the kernel wrapper of each segment kind (ops/plan.py:segment_kind); a
# wide_tp run calls its wrapper once per transition, in wide_tp_run
RUNS = {"narrow": narrow_run, "wide": wide_dense_run,
        "wide_split": wide_split_run, "wide_tp": wide_step}


def assemble(sink_value: int, recs: np.ndarray):
    """(sink_value, s_het, transitions) from the ``[L - 1, 7]`` records
    (span ``pair.assemble``)."""
    with timing.span("pair.assemble"):
        recs = np.asarray(recs)
        shet = int(recs[:, 6].sum(dtype=np.int64))
        # the columns as lists of Python ints, zipped into rows in C
        transitions = list(zip(range(1, len(recs) + 1),
                               *recs[:, :6].T.tolist()))
    return sink_value, shet, transitions


class PairDiploidDP:
    def __init__(self, plan: PairPlan | DevPlan, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if isinstance(plan, DevPlan):
            self.dplan = plan
        else:
            self.dplan = plan_to_device(plan, self.device, mesh=mesh)
        if mesh is None and any(s.kind == "wide_tp"
                                for s in self.dplan.segments):
            raise ValueError("a plan of wide_tp segments needs its mesh")
        self.R = self.dplan.R

    def forward(self, on_segment=None):
        """``(V [R+1, 1024] at the last level, per-segment backpointers)``:
        ``(bp256, bp1024)`` of a narrow run, ``(bp,)`` of a wide one.
        ``on_segment(seg)``, if given, is called after each run is queued
        (the stage probe stamps the stream there). Span ``pair.forward``:
        the host's part, the launches queued."""
        with timing.span("pair.forward"):
            V = initial_v(self.R, self.device)
            bps = []
            for seg in self.dplan.segments:
                if seg.kind == "wide_tp":
                    V, *bp = wide_tp_run(seg, V, self.mesh.tp)
                else:
                    V, *bp = RUNS[seg.kind](seg, V)
                bps.append(tuple(bp))
                if on_segment is not None:
                    on_segment(seg)
        return V, bps

    def run(self):
        V, bps = self.forward()
        recs = trace(self.dplan, bps)
        sink_value = int(V[self.R, 0])
        return assemble(sink_value, recs.cpu().numpy())
