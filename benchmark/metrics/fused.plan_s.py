"""Seconds of the fused tier's plan in set-up (host clock)."""


def read(rec):
    return rec["spans"].get("fused.plan")
