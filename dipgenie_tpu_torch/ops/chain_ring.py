"""The geometry of the level-chain kernels K5b ``chain_step16``, K6
``chain_pair`` and K7 ``chain_edge`` (``csrc/chain_ring.cuh``), mirrored on
the host for the CPU tests and ``chip_smoke.py``'s lines.

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
* K6's decode (``pair_decode``, by ``PAIR_PRODUCERS`` warps) and its
  backpointer stages (``bp_schedule``): the consumers write level ``t``'s
  backpointers into stage ``t % PAIR_BP_STAGES`` of shared memory, and one
  bulk store after the barrier of level ``t`` copies the stage out.

The CUDA sources state the same constants (``D``, ``CLUSTER``,
``BP_STAGES``, ``PRODUCERS``); ``tests/test_torch_chain_geometry.py``
holds the two equal.
"""

from __future__ import annotations

R1 = 19  # rows of a level's state
RING_DEPTH = 8  # stages of the table ring (K5b and K7)
STEP16_CLUSTER = 10  # blocks of K5b's cluster
PAIR_BP_STAGES = 3  # K6's backpointer blocks in shared memory
PAIR_PRODUCERS = 4  # K6's producer warps, each decoding a quarter level
NP2 = 256  # K6's pair lanes and destination pairs


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


def pair_decode(tbl_t, producers: int = PAIR_PRODUCERS):
    """K6's decode of one level, ``tbl_t [8, 256]`` int32 (rows gidx, sc,
    tie, seg, lastE, wsum), by ``producers`` warps, warp ``w`` taking the
    rounds of 32 lanes ``w * R .. (w + 1) * R - 1`` (``R = 8 //
    producers``): ``(lane, pre)``. First pass: ``lane[e] = (start, off,
    tie, sc)`` of lane ``e``, ``start`` the first lane of its run of equal
    seg, from a ballot a round of the lanes that start a run, carried over
    the warp's rounds and, where the warp has no start at or below ``e``,
    the last start of the warps before (their ``carry``); ``off =
    pair_gather_off(gidx, wsum)``. Second pass: ``pre[d] = (n | l << 9,
    off, tie, sc)`` of ``l = lastE[d] & 255`` and the run of ``n`` lanes
    that ends there (``n = 0`` where ``lastE[d]`` is not a lane)."""
    gidx, sc, tie, seg, laste, wsum = ([int(x) for x in row]
                                       for row in tbl_t[:6])
    rounds = NP2 // 32 // producers
    lane, carry = [None] * NP2, []
    for w in range(producers):
        local, last = {}, -1
        for k in range(w * rounds, (w + 1) * rounds):
            starts = sum(1 << i for i in range(32) if k * 32 + i == 0
                         or seg[k * 32 + i] != seg[k * 32 + i - 1])
            for i in range(32):
                low = starts & (0xFFFFFFFF >> (31 - i))
                local[k * 32 + i] = k * 32 + low.bit_length() - 1 if low \
                    else last
            last = k * 32 + starts.bit_length() - 1 if starts else last
        carry.append(last)
        into = max([0, *carry[:w]])
        for e, start in local.items():
            lane[e] = (start if start >= 0 else into,
                       pair_gather_off(gidx[e], wsum[e]), tie[e], sc[e])
    pre = []
    for d in range(NP2):
        l = laste[d] & (NP2 - 1)
        start, *rest = lane[l]
        pre.append(((l + 1 - start if 0 <= laste[d] < NP2 else 0) | l << 9,
                    *rest))
    return lane, pre


def pair_gather_off(gidx: int, wsum: int) -> int:
    """K6's gather offset of a lane into V's rows ``r + 2`` (two NEG guard
    rows below row 0; row ``r`` adds ``r * 256``): ``V[r - wsum, gidx]``,
    wsum held to ``[0, 2]`` and gidx to ``[0, 256)``."""
    return (2 - min(max(wsum, 0), 2)) * NP2 + (gidx & (NP2 - 1))


def bp_schedule(T: int, stages: int = PAIR_BP_STAGES):
    """K6's backpointer stages, as tuples in an order the kernel allows:
    ``("write", t, stage)`` the consumers write level ``t``'s block (after
    the barrier of level ``t - 1``); ``("wait", t, n)`` the producer waits,
    before it arrives at level ``t``'s barrier, until at most ``n`` of its
    stores have not read their stage; ``("barrier", t)``; ``("store", t,
    stage)`` the producer's bulk store of level ``t``'s block, after that
    barrier; ``("wait", T, 0)`` before the kernel exits."""
    events = []
    for t in range(T):
        events += [("write", t, t % stages), ("wait", t, stages - 2),
                   ("barrier", t), ("store", t, t % stages)]
    return events + [("wait", T, 0)]
