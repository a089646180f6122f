"""DP states solved a second: the cell's graph's states times the solves
completed in the window, over the window's seconds (host clock; a solve
counts once its result is on the host)."""


def read(rec):
    return rec["states"] * rec["solves"] / rec["window_s"]
