"""Diploid-DP live progress bar (reference: src/approximator.cpp:310-350).

Same line shape as the reference:
``\\r[====>    ]  42%  current/total  | 123.4 it/s  | ETA 1m23s``
with a 40-char bar, h/m segments of the ETA printed only when nonzero
(format_hms, approximator.cpp:305-323), throttled to 1% steps plus the
first and final level (approximator.cpp:550-557). The reference writes
to stdout; we write to stderr so piped pipeline output stays clean.
"""

from __future__ import annotations

import math
import sys
import time


def format_hms(seconds: float) -> str:
    s = int(seconds)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    out = ""
    if h:
        out += f"{h}h"
    if h or m:
        out += f"{m}m"
    return out + f"{s}s"


def progress_bar(current: int, total: int, start: float, width: int = 40,
                 stream=None) -> None:
    stream = stream if stream is not None else sys.stderr
    frac = (current / total) if total else 1.0
    n = int(math.floor(frac * width))
    elapsed = time.monotonic() - start
    rate = current / elapsed if elapsed > 0 else 0.0
    eta = (total - current) / rate if rate > 0 and total > current else 0.0
    bar = "".join(
        "=" if i < n else (">" if i == n else " ") for i in range(width)
    )
    stream.write(
        f"\r[{bar}] {int(frac * 100):3d}%  {current}/{total}"
        f"  | {rate:.1f} it/s  | ETA {format_hms(eta)}         "
    )
    stream.flush()
    if current == total:
        stream.write("\n")


class ProgressThrottle:
    """1%-step throttle (approximator.cpp:550-557): fires at the first
    level, every whole percent, and the final level."""

    def __init__(self, total: int, width: int = 40, stream=None):
        self.total = total
        self.width = width
        self.stream = stream
        self.start = time.monotonic()
        self.next_pct = 0

    def update(self, current: int) -> None:
        pct = (current * 100) // self.total if self.total else 100
        if current == 1 or pct >= self.next_pct or current == self.total:
            progress_bar(current, self.total, self.start, self.width,
                         self.stream)
            while self.next_pct <= pct:
                self.next_pct += 1
