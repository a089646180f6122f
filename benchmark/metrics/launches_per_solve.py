"""Kernel launches a solve: the program's wrappers' ``launches`` counters,
differenced over the window, over the solves."""


def read(rec):
    return rec["launches"] / rec["solves"]
