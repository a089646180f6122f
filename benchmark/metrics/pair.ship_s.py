"""Seconds of the pair tier's ship in set-up (host clock, ended by a synchronise)."""


def read(rec):
    return rec["spans"].get("pair.ship")
