"""Milliseconds a solve in the fused forward's launch cut on the host: the
program's span ``fused.cut`` (``fused.launch_cut``, numpy over every
transition), mean over its last records, one a solve of the traced
window. None where the program keeps no spans."""

from statistics import fmean

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "recent"):
        return None
    spans = timing.recent("fused.cut", rec["solves"])
    if len(spans) < rec["solves"]:
        return None
    return fmean(s.ns for s in spans) / 1e6
