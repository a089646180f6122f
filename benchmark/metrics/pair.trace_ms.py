"""Milliseconds a solve of the pair tier's traceback: ``trace()`` (K-T, CUDA
events) and the read of its records with ``assemble`` (host clock after a
synchronise), mean over the traced window's solves."""

from statistics import fmean


def read(rec):
    ms = rec["layers"].get("pair.trace")
    return fmean(ms) if ms else None
