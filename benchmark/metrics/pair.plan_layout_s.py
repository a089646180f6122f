"""Seconds of ``plan_pairs`` in the runs' layout (the narrow mask, the
narrow and wide runs, the value guard): the program's span
``pair.plan.layout``, its total in set-up. None where the program keeps
no spans."""

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "total"):
        return None
    t = timing.total("pair.plan.layout")
    return t.ns / 1e9 if t.calls else None
