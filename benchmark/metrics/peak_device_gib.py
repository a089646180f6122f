"""The device's peak allocated memory over set-up and window, GiB
(``torch.cuda.max_memory_allocated``, never reset)."""


def read(rec):
    peak = rec["memory_peak_bytes"]
    return peak / 2**30 if peak else None
