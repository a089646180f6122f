"""The share of the traced window in which no operation runs on the
device, % (the profiler's trace)."""


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
