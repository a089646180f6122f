"""Seconds from the process's start to the end of the warm solve: the
imports, the kernels from the build cache, the graph, the tier's plan and
ship, one solve."""


def read(rec):
    return rec["setup_s"]
