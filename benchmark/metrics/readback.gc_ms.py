"""Milliseconds a solve that the Python collector paused inside the
program's span ``<tier>.assemble`` (the registry's collector counter),
mean over the span's last records, one a solve of the traced window. None
where the program keeps no spans."""

from statistics import fmean

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "recent"):
        return None
    spans = timing.recent(rec["tier"] + ".assemble", rec["solves"])
    if len(spans) < rec["solves"]:
        return None
    return fmean(s.gc_ns for s in spans) / 1e6
