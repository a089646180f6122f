"""Timing / RSS telemetry: the reference's minigraph-style progress lines
(reference: src/sys.cpp:92-147, src/main.cpp:122), and the program's spans.

Log format parity: "[M::<func>::<wall>*<cpu/wall>] message".

**Spans.** ``with span("pair.assemble"):`` records one ``Span``: its name,
the name of the span open around it on this thread (its parent), its start
and end in ns on the clock of ``torch.profiler``'s events
(``time.time_ns()``, the profiler's ``start_ns()``), and the ns the Python
collector paused inside it. One ``gc.callbacks`` hook adds each
collection's pause to the innermost span open on the collecting thread.
Records stay in memory, the last ``RING`` of them, and each name keeps a
``Total`` for the life of the process; ``recent`` and ``total`` are the
only way out. ``ranges()`` has every span also open a
``torch.profiler.record_function`` range ``dg.<name>`` while the block
runs, so that a profiler's timeline shows the spans beside the kernels;
they are off otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import resource
import sys
import threading
import time
from typing import NamedTuple

_t0 = time.time()


def set_start(t: float | None = None) -> None:
    global _t0
    _t0 = time.time() if t is None else t


def realtime() -> float:
    """Wall time since program start (reference sys.cpp:112)."""
    return time.time() - _t0


def cputime() -> float:
    """User+system CPU time of self+children (reference sys.cpp:92)."""
    ru_self = resource.getrusage(resource.RUSAGE_SELF)
    ru_kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (
        ru_self.ru_utime + ru_self.ru_stime + ru_kids.ru_utime + ru_kids.ru_stime
    )


def peakrss_bytes() -> int:
    """Peak resident set size in bytes (reference sys.cpp:99)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is KB on Linux
    return ru.ru_maxrss * 1024


def log_stage(func: str, msg: str, file=sys.stderr) -> None:
    """Emit a reference-style progress line (main.cpp:122 format)."""
    rt = realtime()
    ratio = cputime() / rt if rt > 0 else 0.0
    print(f"[M::{func}::{rt:.3f}*{ratio:.2f}] {msg}", file=file)


# ---------------------------------------------------------------- spans

RING = 4096  # span records kept, oldest dropped first


class Span:
    """One span's record; times in ns on the profiler's clock."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "gc_ns")

    def __init__(self, name: str, parent: str | None):
        self.name = name
        self.parent = parent
        self.start_ns = self.end_ns = 0
        self.gc_ns = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, parent={self.parent!r}, "
                f"ns={self.ns}, gc_ns={self.gc_ns})")


class Total(NamedTuple):
    """A name's spans over the life of the process."""

    calls: int
    ns: int
    gc_ns: int


_records: collections.deque = collections.deque(maxlen=RING)
_totals: dict[str, list[int]] = {}
_lock = threading.Lock()
_local = threading.local()  # .open: this thread's open spans; .gc0
_ranges = False


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class span:
    """``with span(name):`` records a ``Span`` (see the module docstring);
    the ``with`` gives the record, whose end is set on exit."""

    __slots__ = ("name", "rec", "stack", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self) -> Span:
        if _ranges:
            import torch

            self.range = torch.profiler.record_function("dg." + self.name)
            self.range.__enter__()
        stack = self.stack = _open()
        rec = self.rec = Span(self.name, stack[-1].name if stack else None)
        stack.append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.end_ns = end = time.time_ns()
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        with _lock:
            _records.append(rec)
            t = _totals.get(rec.name)
            if t is None:
                t = _totals[rec.name] = [0, 0, 0]
            t[0] += 1
            t[1] += end - rec.start_ns
            t[2] += rec.gc_ns


def recent(name: str, n: int | None = None) -> list[Span]:
    """The last ``n`` (all kept, where None) records of ``name``, oldest
    first."""
    with _lock:
        recs = [r for r in _records if r.name == name]
    return recs if n is None else recs[max(len(recs) - n, 0):]


def total(name: str) -> Total:
    """``name``'s calls, ns and collector ns since the process began (or
    since ``reset``)."""
    with _lock:
        return Total(*_totals.get(name, (0, 0, 0)))


def reset() -> None:
    """Drop every record and total."""
    with _lock:
        _records.clear()
        _totals.clear()


@contextlib.contextmanager
def ranges():
    """Every span opened inside the block also opens a profiler range
    ``dg.<name>``."""
    global _ranges
    was, _ranges = _ranges, True
    try:
        yield
    finally:
        _ranges = was


def _collector(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` hook: a collection's pause goes to the
    innermost span open on the collecting thread."""
    if phase == "start":
        _local.gc0 = time.perf_counter_ns()
        return
    stack = getattr(_local, "open", None)
    gc0 = getattr(_local, "gc0", None)
    if stack and gc0 is not None:
        stack[-1].gc_ns += time.perf_counter_ns() - gc0


if _collector not in gc.callbacks:
    gc.callbacks.append(_collector)
