"""Milliseconds a solve of the fused tier's forward (``FusedDiploidDP.forward``:
K13), mean over the traced window's solves (CUDA events)."""

from statistics import fmean


def read(rec):
    ms = rec["layers"].get("fused.forward")
    return fmean(ms) if ms else None
