"""Milliseconds a solve in the assembly of the solve's result on the host:
the program's span ``<tier>.assemble`` (``diploid_pair.assemble``,
``fused.path_transitions``), mean over its last records, one a solve of
the traced window. None where the program keeps no spans."""

from statistics import fmean

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "recent"):
        return None
    spans = timing.recent(rec["tier"] + ".assemble", rec["solves"])
    if len(spans) < rec["solves"]:
        return None
    return fmean(s.ns for s in spans) / 1e6
