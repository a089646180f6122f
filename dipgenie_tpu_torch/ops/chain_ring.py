"""The geometry of the level-chain kernels K5b ``chain_step16`` and K7
``chain_edge`` (``csrc/chain_ring.cuh``), mirrored on the host for the CPU
tests and ``chip_smoke.py``'s lines.

* The ring: level ``t``'s tables land in stage ``t % RING_DEPTH``, and
  their copies complete phase ``t // RING_DEPTH`` of that stage's
  barrier, so the consumers wait on parity ``(t // RING_DEPTH) & 1``, in
  the window of level ``t - 1``'s barrier (between arriving and waiting).
  The producer issues levels ``0 .. RING_DEPTH - 1`` before the first
  level, and level ``t + RING_DEPTH`` right after the barrier of level
  ``t``, after which no consumer reads stage ``t % RING_DEPTH``.
* K5b's cluster: ``STEP16_CLUSTER`` blocks split the 19 rows of a level,
  block ``b`` taking ``[b * 19 // n, (b + 1) * 19 // n)``; row ``r`` reads
  rows ``r``, ``r - 1`` and ``r - 2`` of the level before, so its owner
  pushes it into the owners of rows ``r + 1`` and ``r + 2``.

The CUDA sources state the same constants (``D``, ``CLUSTER``);
``tests/test_torch_chain_geometry.py`` holds the two equal.
"""

from __future__ import annotations

R1 = 19  # rows of a level's state
RING_DEPTH = 8  # stages of the table ring (K5b and K7)
STEP16_CLUSTER = 10  # blocks of K5b's cluster


def ring_schedule(T: int, depth: int = RING_DEPTH):
    """The ring's events in an order the kernels allow, as tuples:
    ``("issue", t, stage)`` the producer starts level ``t``'s copies;
    ``("wait", t, stage, parity)`` the consumers wait for level ``t``'s
    tables (level ``t + 1``'s in the window of level ``t``'s barrier);
    ``("barrier", t)`` the barrier of level ``t`` completes (every consumer
    is done with level ``t``'s stage)."""
    events = [("issue", t, t % depth) for t in range(min(depth, T))]
    if T:
        events.append(("wait", 0, 0, 0))
    for t in range(T):
        if t + 1 < T:
            events.append(("wait", t + 1, (t + 1) % depth,
                           ((t + 1) // depth) & 1))
        events.append(("barrier", t))
        if t + depth < T:
            events.append(("issue", t + depth, (t + depth) % depth))
    return events


def row_lo(b: int, n: int = STEP16_CLUSTER) -> int:
    """The first row of block ``b`` of a cluster of ``n``."""
    return b * R1 // n


def owner(x: int, n: int = STEP16_CLUSTER) -> int:
    """The block of a cluster of ``n`` that owns row ``x``."""
    return ((x + 1) * n - 1) // R1


def push_targets(r: int, n: int = STEP16_CLUSTER) -> list[int]:
    """The blocks that the owner of row ``r`` pushes it into: the owners of
    rows ``r + 1`` and ``r + 2``, other than itself, each once."""
    me, out = owner(r, n), []
    for x in (r + 1, r + 2):
        if x < R1 and owner(x, n) != me and owner(x, n) not in out:
            out.append(owner(x, n))
    return out
