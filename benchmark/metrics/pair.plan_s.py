"""Seconds of the pair tier's plan in set-up (host clock)."""


def read(rec):
    return rec["spans"].get("pair.plan")
