"""Milliseconds a solve of the pair tier's forward (``PairDiploidDP.forward``:
K1 / K2 / K3), mean over the traced window's solves (CUDA events)."""

from statistics import fmean


def read(rec):
    ms = rec["layers"].get("pair.forward")
    return fmean(ms) if ms else None
