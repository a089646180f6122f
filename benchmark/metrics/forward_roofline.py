"""The forward's share of its roofline, %: the least time its work could
take on this card (``work.py``: counted from the CSR arrays and R) over the
device time of the operations launched inside the forward's spans, a
solve."""

import work


def read(rec):
    t = rec["trace"]
    card = work.peaks(rec["device_kind"])
    if not t or card is None:
        return None
    device_s = t["span_device_s"].get("forward", 0.0) / rec["solves"]
    if device_s <= 0:
        return None
    return 100.0 * work.least_seconds(rec["csr"], rec["R"], card) / device_s
