"""Seconds of ``plan_pairs`` in the inputs' conversion and the native
planner's one call (``dg_pair_tables``): the program's span
``pair.plan.tables``, its total in set-up. None where the program keeps
no spans."""

from dipgenie_tpu_torch.utils import timing


def read(rec):
    if not hasattr(timing, "total"):
        return None
    t = timing.total("pair.plan.tables")
    return t.ns / 1e9 if t.calls else None
