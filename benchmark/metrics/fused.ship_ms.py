"""Milliseconds a solve in the fused tier's ship of its tables: the
program's span ``fused.ship`` (``FusedDiploidDP.ship``, host clock, no
synchronise), mean over its last records, one a solve of the traced
window. None where the program keeps no spans."""

from statistics import fmean

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "recent"):
        return None
    spans = timing.recent("fused.ship", rec["solves"])
    if len(spans) < rec["solves"]:
        return None
    return fmean(s.ns for s in spans) / 1e6
