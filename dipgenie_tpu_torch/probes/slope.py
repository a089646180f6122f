"""Per-level cost of a chain as a slope between two chain lengths.

Counterpart of ``timed`` / ``slope`` of ``scripts/tpu_floor_probe.py``:
every variant is timed at two lengths ``T1 < T2`` of the same structure,
and the per-level cost is ``(t2 - t1) / (T2 - T1)``, so that the launch,
the allocation of the outputs and whatever else a call pays once cancel.
On the card a call is timed with CUDA events on the current stream. With
``device cpu`` the host clock times the plain PyTorch versions; such a
figure is a CPU time and ``clock`` says so wherever it is printed.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch


class Slope(NamedTuple):
    per_level: float  # seconds per level, (t2 - t1) / (T2 - T1)
    t1: float  # seconds of the chain of T1 levels (min of the reps)
    t2: float  # seconds of the chain of T2 levels


def clock(device: torch.device) -> str:
    """How ``timed`` measures on ``device``, for the printed lines."""
    if device.type == "cuda":
        return f"CUDA events on {torch.cuda.get_device_name(device)}"
    return "host clock on the CPU, plain PyTorch versions: not a device time"


def timed(fn, args, device: torch.device, label: str):
    """``(seconds, output)`` of one ``fn(*args)``."""
    if device.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        a.record()
        out = fn(*args)
        b.record()
        torch.cuda.synchronize(device)
        dt = a.elapsed_time(b) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
    print(f"  {label}: {dt:.6f}s", file=sys.stderr, flush=True)
    return dt, out


def slope(build, T1: int, T2: int, device: torch.device,
          reps: int = 2) -> Slope:
    """``build(T, device) -> (fn, args)``. One warm-up call at each
    length, then the min of ``reps`` calls at each."""
    f1, a1 = build(T1, device)
    f2, a2 = build(T2, device)
    timed(f1, a1, device, f"warmup T={T1}")
    timed(f2, a2, device, f"warmup T={T2}")
    t1 = min(timed(f1, a1, device, f"T={T1} rep{i}")[0] for i in range(reps))
    t2 = min(timed(f2, a2, device, f"T={T2} rep{i}")[0] for i in range(reps))
    return Slope((t2 - t1) / (T2 - T1), t1, t2)


def line(name: str, s: Slope, T1: int, T2: int, device: torch.device) -> str:
    return (f"{name}: {s.per_level * 1e6:.3f} us/level (slope {T1}->{T2}: "
            f"{s.t1 * 1e3:.3f} ms -> {s.t2 * 1e3:.3f} ms; {clock(device)})")
