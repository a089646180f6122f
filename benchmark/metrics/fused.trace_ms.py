"""Milliseconds a solve of the fused tier's traceback: the sink's read and
``path_transitions`` (host clock after a synchronise) and ``fused_trace``
(K14, CUDA events), mean over the traced window's solves."""

from statistics import fmean


def read(rec):
    ms = rec["layers"].get("fused.trace")
    return fmean(ms) if ms else None
