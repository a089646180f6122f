"""Timing / RSS telemetry, matching the reference's minigraph-style
progress lines (reference: src/sys.cpp:92-147, src/main.cpp:122).

Log format parity: "[M::<func>::<wall>*<cpu/wall>] message".
"""

from __future__ import annotations

import os
import resource
import sys
import time

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
