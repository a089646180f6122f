"""The device's trace of a traced window (``torch.profiler``, CUPTI).

``read`` turns the profiler's events into what the per-layer metrics and
the ``breakdown`` read: the device's busy seconds within the
``bench.window`` range, the device time of the operations launched inside
each ``bench.<span>`` range (a device operation belongs to the range that
holds the runtime call that launched it, matched by correlation id), the
operations that took the most time, and the idle time named by the
innermost ``bench.<span>`` range the host was in when the gap began.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

TOP = 10


def profiler(dev: torch.device):
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals, as sorted disjoint ``(starts, ends)``."""
    if len(starts) == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:], len(s)] - 1
    return s[first], reach[last]


def _innermost(ranges, at: np.ndarray) -> list[str]:
    """The name of the latest-starting range holding each time in ``at``
    (``"window"`` where none does)."""
    ranges = sorted(ranges, key=lambda r: r[1])
    starts = np.array([r[1] for r in ranges], np.int64)
    idx = np.searchsorted(starts, at, side="right") - 1
    out = []
    for i, t in zip(idx.tolist(), at.tolist()):
        while i >= 0 and ranges[i][2] < t:
            i -= 1
        out.append(ranges[i][0] if i >= 0 else "window")
    return out


def _short(name: str, most: int = 120) -> str:
    """A kernel's name without its trailing parameter list, cut to
    ``most`` characters."""
    if name.endswith(")") and not name.startswith("Memcpy"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name if len(name) <= most else name[:most - 3] + "..."


def read(prof, dev: torch.device) -> dict:
    events = prof.profiler.kineto_results.events()
    ranges, launch = [], {}
    ops = []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name.startswith("bench."):
                ranges.append((name[6:], e.start_ns(), e.end_ns()))
            elif name.startswith("cuda"):
                launch[e.correlation_id()] = e.start_ns()
        elif (e.device_type() == DeviceType.CUDA
              and not e.name().startswith("bench.")):
            # (the device's copy of a bench.* range is no operation)
            ops.append((_short(e.name()), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
    win = next((r for r in ranges if r[0] == "window"), None)
    if win is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = win[1], win[2]
    inner = [r for r in ranges if r[0] != "window"]
    starts = np.array([o[1] for o in ops], np.int64)
    ends = np.array([o[2] for o in ops], np.int64)
    keep = (ends > w0) & (starts < w1)
    s, e = _merge(np.clip(starts[keep], w0, w1), np.clip(ends[keep], w0, w1))
    busy_ns = int((e - s).sum())

    # device time by the span that launched it
    span_ns: dict[str, int] = {}
    if ops:
        at = np.array([launch.get(o[3], -1) for o in ops], np.int64)
        names = _innermost(inner, at)
        for o, t, nm in zip(ops, at.tolist(), names):
            if t >= 0:
                span_ns[nm] = span_ns.get(nm, 0) + o[2] - o[1]

    by_name: dict[str, int] = {}
    for o in ops:
        by_name[o[0]] = by_name.get(o[0], 0) + o[2] - o[1]
    device_ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]

    # idle gaps within the window, named by the host's span at their start
    gs = np.r_[w0, e] if len(s) else np.array([w0], np.int64)
    ge = np.r_[s, w1] if len(s) else np.array([w1], np.int64)
    pos = ge > gs
    gs, ge = gs[pos], ge[pos]
    idle: dict[str, int] = {}
    for nm, a, b in zip(_innermost(inner, gs), gs.tolist(), ge.tolist()):
        idle[nm] = idle.get(nm, 0) + b - a
    idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "span_device_s": {k: v / 1e9 for k, v in span_ns.items()},
        "device_ops": [[n, v / 1e9] for n, v in device_ops],
        "idle_gaps": [[n, v / 1e9] for n, v in idle_gaps],
    }
