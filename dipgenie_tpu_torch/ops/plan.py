"""The pair plan on the device, and the bit layouts the kernels read.

Planning is ``ops/pair_plan.plan_pairs`` (numpy plus the native
``dg_pair_tables``): a ``PairPlan`` is a level-ordered list of
``_NarrowRun`` and ``_WideRun`` segments made of 256-pair chunks.
``plan_to_device`` turns every numpy array of every segment into a tensor
on one device and picks each segment's kernel; nothing else is derived
here.

Layouts the port's kernels (and their plain versions) decode:

* Narrow chunk table ``tbl [nchunks, 2, 256] int32``. Row 0 packs
  ``gidx << 13 | (dst + 1) << 2 | wsum``: ``gidx`` is the source pair lane
  ``pi * k + pj`` (flat layout, k = source level width), ``dst`` the
  destination pair lane ``i2 * k2 + j2`` (-1 on padded lanes, whose row 0
  is all zero), ``wsum`` in {0, 1, 2} the recombinations the pair adds.
  Row 1 is the pair's score, ``PAD_SC`` on padded lanes.
* Narrow ``sbits [nchunks] int32``: bits 0-1 the source extent class - 1,
  bit 2 first chunk of its transition, bit 3 last chunk, bit 4 real (the
  rest pad the chunk count up a ladder), bits 5-6 the scan class (unused
  here), bits 7-8 the destination extent class - 1 (the transition writes
  ``OUT = 256 * (class + 1)`` lanes). The dataclass comment beside
  ``_NarrowRun.sbits`` predates this layout.
* Narrow ``tb_desc [T, 4] int32`` (made by ``plan_to_device``, not by the
  planner; ``narrow_desc``): per transition its first chunk row, its real
  pairs ``n`` (lanes ``[0, n)`` of its chunks; the rest are pads), ``OUT |
  tb_bout ** 2 << 16`` (the destination extent and its real pair lanes;
  the bp1024 bit ``tb_bits & 2`` is ``OUT > 256``) and its backpointer
  row ``tb_bprow``. The
  segment's ``lanes`` is the run's widest extent, source or destination:
  K1 keeps V ``[R+1, lanes]`` in shared memory where it fits.
* Window-split wide chunk table ``tbl [nchunks, 2, 256] int32`` (every
  wide run has one): the narrow packing with ``dst`` relative to the
  chunk's destination window ``wwin``, so the global destination lane is
  ``wwin * 1024 + rel``; ``wbase`` is the chunk's first pair ordinal in
  its transition, ``wbits & 4`` marks real chunks. A transition's
  backpointers go to rows ``tb_bprow[t] + win`` of ``bp [nrows, R+1,
  1024]``, one per window below its extent.
* Dense wide chunk table ``dtbl [nchunks, 2, 256] int32``. Row 0 packs
  ``gidx << 17 | win << 12 | rel << 2 | wsum`` with the destination lane
  ``win * 1024 + rel``; padded lanes are all zero there, which decodes as
  the real lane 0, so only ``score == PAD_SC`` in row 1 marks them. A run
  of more than ``DENSE_NB_LIMIT`` (31) windows has no dense table (its
  ``dtbl`` has 0 chunks), so only K3 or K4 run it.
* Dense ``dbits``: 2 last chunk of its transition (commit), 4 real.
* Dense wide slices (made by ``plan_to_device``; ``wide_slices``): K2's
  cooperative grid has ``k2_grid`` blocks, as many as the card holds at
  once (``ops/wide.py:k2_grid``; ``K2_GRID_CPU`` for a plan on the CPU),
  and each block takes ``k2_per_block`` slices of every transition: slice
  ``j * k2_grid + block`` is its j-th. The slices cut the transition's
  written lanes ``[0, W)`` into contiguous runs of about equal work (a
  lane and its pairs), at most ``K2_SLICE_LANES`` lanes and
  ``K2_SLICE_PAIRS`` pairs each. ``DevSegment.k2_desc [T, 2] int32``
  holds per transition its first dense chunk and its real pairs ``n``
  (lanes ``[0, n)`` of its chunks, sorted by destination); ``k2_cuts [T,
  S + 1] int16`` the slices' first lanes (the last ``W``). A block finds its
  slices' pair ranges by searching the destination-sorted words. ``W`` is
  the whole state for the first two transitions (the two state buffers
  start uninitialised), then the larger of this transition's destination
  extent ``tb_bout ** 2`` and that of the transition two before it (the
  last to write the same buffer).
* Traceback columns (made by ``plan_to_device``; ``trace_columns``):
  ``DevPlan.desc [L - 1, 8] int32``, one row per transition, the columns
  of ``TRACE_COLS``: the segment, the bp block's lanes, the rows of its bp
  array from the block on, the block's row, the first chunk row of the
  table the walk reads and the transition's real chunks there, ``bin |
  bout << 16``, and the flags of ``TRACE_FLAGS``: the dense packing, the
  block's class (``rowstep``: a lane past the block steps rows; else it
  clamps), the block in the segment's second bp array (a narrow run's
  bp1024) and int16 backpointers. Only the arrays' addresses wait for the
  traceback (``ops/trace.py``).
* Pair ordinals (the backpointers): a pair's index in its transition's
  preference-sorted pair list, i.e. ``chunk_in_transition * 256 + lane``
  (window-split and dense chunks number the same pairs differently).
  Narrow runs spill them as int16 to ``bp256 [n256, R+1, 256]`` or
  ``bp1024 [n1024, R+1, 1024]`` (row ``tb_bprow``; ``tb_bits & 2`` picks
  bp1024); dense wide runs as int32 to ``bp [T, R+1, NB * 1024]``,
  window-split wide runs as int32 to ``bp [nrows, R+1, 1024]``.

Kernel of a segment: narrow runs K1 (``narrow.py``); wide runs of at
most ``DENSE_NB_MAX`` windows K2 (``wide.py``), wider ones K3
(``wide_split.py``). Under a tp mesh (``parallel/mesh.py``) every wide
run, whatever its NB, is a ``wide_tp`` segment run by K4 (``wide_step.py``)
transition by transition, as the JAX package does (``diploid_pallas.py:
2178``): the segment holds this rank's share of the window-split chunks
(``shard_wide_tables``) as ``stbl``, ``swin`` and ``sbase``, each
transition's share of them in ``bounds``, ``present`` [T, NB] bool, and
the run's whole ``tbl``, ``w1`` and ``symd`` for the traceback. Its merged
backpointers are one int32 ``[R+1, NB * 1024]`` block per transition,
``bp [T, R+1, NB * 1024]``, in the window-split numbering.

Reduction key. For every destination lane and row the wide kernels and
the plain versions keep the best candidate as one 64-bit key, ``(value -
REACH_T + 1) << 32 | (0xFFFFFFFF - ordinal)``, merged with a max. A larger
key is a larger value, then a smaller ordinal: the reference tie rule (the
earliest pair in plan order wins). The max is order-independent, so
parallel atomics give deterministic results, and 0 means "no valid
candidate". The high word stays below 2^31 (the card computes it in int32
and reads it back signed): the planner refuses a graph whose values could
pass ``VALUE_MAX`` (2,147,221,502). K1 keeps no keys: each destination's
pairs are one range in plan order, so it walks them and keeps the first
maximum, which is the same winner. Padded pair lanes never make a
candidate: K1 walks only a transition's real pairs, K3 (and K4) drop pads
by their ``dst + 1 == 0`` sentinel, K2 by ``score == PAD_SC``, before
``value + score`` is formed, and a real score is a popcount (>= 0), so no
real lane looks like a pad, whatever the values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .pair_plan import (  # noqa: F401  (re-exported)
    CHUNK,
    DENSE_NB_LIMIT,
    NEG,
    PAD_SC,
    REACH_T,
    PairPlan,
    PlanLimit,
    _NarrowRun,
    _WideRun,
    plan_pairs,
    shard_wide_tables,
)

# The JAX package sends wide runs of more than 18 windows to its
# window-split kernel (diploid_pallas.py:1140, :2193): there the dense
# kernel's state no longer fit the TPU's VMEM. The H100 has no such limit
# (K2 runs any run that has dense tables, up to DENSE_NB_LIMIT windows),
# but the port keeps the rule so that its path is the reference's path.
DENSE_NB_MAX = 18

_LOW32 = 0xFFFFFFFF

# K2's slices (wide_slices, csrc/wide_dense_run.cu): the widest (MAX_W),
# the most pairs (CAND: its candidates fill the block's shared memory), the
# most a block takes a transition (its cache of pair ranges, KCACHE, holds
# two transitions' worth), and the grid of a plan shipped to the CPU, where
# only the tests read them (an H100 SXM's 132 SMs, one block each)
K2_SLICE_LANES = 1024
K2_SLICE_PAIRS = 44032
K2_PER_BLOCK_MAX = 16
K2_GRID_CPU = 132
# the traceback's per-transition columns (DevPlan.desc, csrc/trace.cu):
# "bins" is bin | bout << 16, "flags" ORs TRACE_FLAGS
TRACE_COLS = ("seg", "lanes", "rows", "bprow", "chunkbase", "nch", "bins",
              "flags")
TRACE_FLAGS = {"dense": 1, "rowstep": 2, "bp1": 4, "bp16": 8}


def segment_kind(seg, dense_nb_max: int = DENSE_NB_MAX, mesh=None) -> str:
    """``narrow`` (K1), ``wide`` (K2, dense chunks), ``wide_split`` (K3,
    window-split chunks) or, under a tp ``mesh``, ``wide_tp`` (K4): the
    kernel that runs a plan segment."""
    if isinstance(seg, _NarrowRun):
        return "narrow"
    if mesh is not None:
        return "wide_tp"
    return "wide_split" if seg.NB > dense_nb_max else "wide"


@dataclass
class DevSegment:
    """One plan segment on a device: ``host`` is the numpy segment (for
    its scalar fields and host-side loops), ``t`` maps every numpy array
    field of it to a tensor on the device."""

    kind: str  # "narrow" | "wide" | "wide_split" | "wide_tp"
    host: _NarrowRun | _WideRun
    t: dict
    nreal: int  # real (non ladder-pad) chunks of the table the kernel runs
    # wide_tp: [T + 1] host chunk bounds of the transitions in this rank's
    # share (stbl)
    bounds: np.ndarray | None = None
    lanes: int = 1024  # narrow: the run's widest extent (narrow_desc)
    # [T, 8] int32 traceback columns (trace_columns; segment column 0)
    trace_cols: np.ndarray | None = None
    # wide (K2): its grid, the slices each block takes a transition, and
    # the slices' tables on the device (wide_slices)
    k2_grid: int = 0
    k2_per_block: int = 0
    k2_desc: torch.Tensor | None = None
    k2_cuts: torch.Tensor | None = None

    @property
    def t0(self) -> int:
        return self.host.t0

    @property
    def t1(self) -> int:
        return self.host.t1


@dataclass
class DevPlan:
    """A plan on a device. ``desc`` (the traceback's columns of every
    transition, see the module docstring) is made from the segments'
    ``trace_cols`` when the plan is made, so a plan of some of another's
    segments has its own."""

    R: int
    L: int
    device: torch.device
    segments: list
    desc: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        cols = [s.trace_cols for s in self.segments]
        desc = (np.concatenate(cols) if cols
                else np.zeros((0, len(TRACE_COLS)), np.int32))
        desc[:, 0] = np.repeat(np.arange(len(cols)), [len(c) for c in cols])
        self.desc = _tensor(desc, self.device)


_REAL_BITS = {"narrow": ("sbits", 16), "wide": ("dbits", 4),
              "wide_split": ("wbits", 4)}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_to_device(seg: _WideRun, n_tp: int, rank: int, device) -> DevSegment:
    """The ``wide_tp`` segment of tp rank ``rank`` of ``n_tp`` for a wide
    run (see the module docstring)."""
    shards, present = shard_wide_tables(seg, n_tp)
    rows, bounds = shards[rank]
    t = {name: _tensor(getattr(seg, name), device)
         for name in ("tbl", "w1", "symd")}
    t["stbl"] = _tensor(seg.tbl[rows], device)
    t["swin"] = _tensor(seg.wwin[rows], device)
    t["sbase"] = _tensor(seg.wbase[rows], device)
    t["present"] = _tensor(present.astype(bool), device)
    return DevSegment(kind="wide_tp", host=seg, t=t, nreal=len(rows),
                      bounds=bounds, trace_cols=trace_columns("wide_tp", seg))


def plan_to_device(plan: PairPlan, device, dense_nb_max: int = DENSE_NB_MAX,
                   mesh=None) -> DevPlan:
    """Every numpy array of every segment as a tensor on ``device``.
    ``dense_nb_max`` picks K2 or K3 for each wide run (0: K3 for all,
    31: K2 for every run of at most 31 windows); the default is the
    reference's rule. A run past 31 windows that it sends to K2 raises:
    such a run has no dense tables. With a ``mesh``
    (``parallel.mesh.Mesh``) every wide run is this rank's ``wide_tp``
    segment instead."""
    device = torch.device(device)
    segs, grid = [], None
    for seg in plan.segments:
        if segment_kind(seg, mesh=mesh) == "wide_tp":
            segs.append(shard_to_device(seg, mesh.n_tp, mesh.tp_rank, device))
            continue
        t = {}
        for f in dataclasses.fields(seg):
            a = getattr(seg, f.name)
            if isinstance(a, np.ndarray):
                t[f.name] = _tensor(a, device)
        kind = segment_kind(seg, dense_nb_max)
        if kind == "wide" and seg.NB > DENSE_NB_LIMIT:
            raise ValueError(
                f"plan_to_device: a wide run of {seg.NB} windows has no "
                f"dense tables (past {DENSE_NB_LIMIT}); K2 cannot run it, "
                f"dense_nb_max={dense_nb_max} sends it there")
        bits, real = _REAL_BITS[kind]
        nreal = int(np.count_nonzero(getattr(seg, bits) & real))
        dseg = DevSegment(kind=kind, host=seg, t=t, nreal=nreal,
                          trace_cols=trace_columns(kind, seg))
        if kind == "narrow":
            desc, dseg.lanes = narrow_desc(seg, nreal)
            t["tb_desc"] = _tensor(desc, device)
        elif kind == "wide":
            if grid is None:
                from .wide import k2_grid

                grid = k2_grid(device)
            desc, cuts, dseg.k2_per_block = wide_slices(seg, nreal, grid)
            dseg.k2_desc = _tensor(desc, device)
            dseg.k2_cuts = _tensor(cuts, device)
            dseg.k2_grid = grid
        segs.append(dseg)
    return DevPlan(R=plan.R, L=plan.L, device=device, segments=segs)


def narrow_desc(seg: _NarrowRun, nreal: int) -> tuple[np.ndarray, int]:
    """``(tb_desc [T, 4] int32, lanes)`` of a narrow run (see the module
    docstring): K1's per-transition descriptors and the run's widest
    extent."""
    base = np.asarray(seg.tb_chunkbase, np.int64)
    bounds = chunk_bounds(seg.tb_chunkbase, nreal).astype(np.int64)
    real = ((seg.tbl[:nreal, 0] >> 2) & 2047) != 0
    cum = np.concatenate([[0], np.cumsum(real.sum(1))])
    sb = seg.sbits[base]
    out = CHUNK * (((sb >> 7) & 3) + 1)
    src = CHUNK * ((sb & 3) + 1)
    ndst = np.asarray(seg.tb_bout, np.int64) ** 2
    desc = np.stack([base, cum[bounds[1:]] - cum[bounds[:-1]],
                     out | (ndst << 16), seg.tb_bprow], 1)
    lanes = int(max(out.max(initial=CHUNK), src.max(initial=CHUNK)))
    return desc.astype(np.int32), lanes


def wide_slices(seg: _WideRun, nreal: int, grid: int
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """``(k2_desc [T, 2] int32, k2_cuts [T, S + 1] int16, per_block)`` of
    a dense wide run for K2's grid of ``grid`` blocks (see the module
    docstring): the fewest slices a block that keep every slice within
    ``K2_SLICE_LANES`` lanes and ``K2_SLICE_PAIRS`` pairs. Raises unless
    every transition's real pairs come first and are sorted by
    destination, which K2's searches and walks rely on; ``PlanLimit`` where
    no slicing fits (a destination of more than ``K2_SLICE_PAIRS`` pairs,
    which a run of at most 31 windows reaches only through repeated
    edges, or a grid too small for the run's lanes)."""
    T = seg.t1 - seg.t0
    full = seg.NB * 1024
    bounds = chunk_bounds(seg.tb2_chunkbase, nreal)
    ext = np.minimum(np.asarray(seg.tb_bout, np.int64) ** 2, full)
    W = np.full(T, full, np.int64)
    W[2:] = np.maximum(ext[2:], ext[:-2])
    dsts = []
    for ti in range(T):
        words = seg.dtbl[bounds[ti]:bounds[ti + 1]]
        real = words[:, 1].ravel() != PAD_SC
        n = int(real.sum())
        dst = (words[:, 0].ravel()[:n] >> 2) & 32767
        if not real[:n].all() or np.any(np.diff(dst) < 0):
            raise ValueError(
                f"wide_slices: transition {seg.t0 + ti}'s dense pairs are "
                "not sorted by destination ahead of the pads")
        dsts.append(dst)
    work = [np.bincount(d, minlength=w) + 1 for d, w in zip(dsts, W)]
    heavy = max((int(w.max()) - 1 for w in work), default=0)
    if heavy > K2_SLICE_PAIRS:
        raise PlanLimit(
            f"wide_slices: a destination of {heavy} pairs in the run at "
            f"level {seg.t0}; K2 holds at most {K2_SLICE_PAIRS} a slice")
    desc = np.stack([bounds[:-1], [len(d) for d in dsts]], 1)
    for m in range(-(-full // (grid * K2_SLICE_LANES)),
                   K2_PER_BLOCK_MAX + 1):
        cuts = np.stack([balanced_cuts(w, grid * m, K2_SLICE_LANES)
                         for w in work]) if T else np.zeros((0, grid * m + 1))
        pairs = max((int(np.diff(np.searchsorted(d, c)).max())
                     for d, c in zip(dsts, cuts)), default=0)
        if pairs <= K2_SLICE_PAIRS:
            return desc.astype(np.int32), cuts.astype(np.int16), m
    raise PlanLimit(
        f"wide_slices: the run at level {seg.t0} ({seg.NB} windows) does "
        f"not fit {K2_PER_BLOCK_MAX} slices a block of a grid of {grid}")


def balanced_cuts(work: np.ndarray, slices: int, cap: int) -> np.ndarray:
    """[slices + 1] lane bounds cutting ``work`` (one entry a lane) into
    contiguous slices of about equal sums, none wider than ``cap`` lanes."""
    W = len(work)
    if W > slices * cap:
        raise ValueError(f"balanced_cuts: {W} lanes do not fit {slices} "
                         f"slices of {cap}")
    cum = np.concatenate([[0], np.cumsum(work)])
    cuts = np.searchsorted(cum, cum[-1] * np.arange(slices + 1) / slices)
    cuts = np.minimum(cuts, W)
    cuts[0], cuts[-1] = 0, W
    if np.all(np.diff(cuts) <= cap):
        return cuts
    for k in range(1, slices):  # cap the widths, leaving room for the rest
        cuts[k] = min(max(cuts[k], cuts[k - 1], W - (slices - k) * cap),
                      cuts[k - 1] + cap)
    return cuts


def trace_columns(kind: str, seg) -> np.ndarray:
    """[T, 8] int32: the traceback's columns (``TRACE_COLS``) of a
    segment's transitions, with the segment column 0 (``DevPlan`` sets
    it). The bp arrays' shapes are the ones the kernels allocate: a narrow
    run's ``bp256 [n256, R+1, 256]`` and ``bp1024 [n1024, R+1, 1024]``
    (int16), a window-split run's ``[nrows, R+1, 1024]``, a dense or tp
    run's ``[T, R+1, NB * 1024]`` (int32)."""
    T = seg.t1 - seg.t0
    ti = np.arange(T)
    f = TRACE_FLAGS
    if kind == "narrow":
        big = (np.asarray(seg.tb_bits) & 2) != 0
        lanes = np.where(big, 1024, CHUNK)
        rows = np.where(big, seg.n1024, seg.n256) - seg.tb_bprow
        bprow = seg.tb_bprow
        flags = f["bp16"] | np.where(big, f["rowstep"] | f["bp1"], 0)
        cb, real = seg.tb_chunkbase, seg.sbits & 16
    elif kind == "wide_split":
        lanes, rows, bprow = 1024, seg.nrows - seg.tb_bprow, seg.tb_bprow
        flags = f["rowstep"]
        cb, real = seg.tb_chunkbase, seg.wbits & 4
    else:  # one [R+1, NB * 1024] block per transition
        lanes, rows, bprow = seg.NB * 1024, T - ti, ti
        if kind == "wide_tp":
            flags = f["rowstep"]
            cb, real = seg.tb_chunkbase, seg.wbits & 4
        else:
            flags = f["rowstep"] | f["dense"]
            cb, real = seg.tb2_chunkbase, seg.dbits & 4
    nch = np.diff(chunk_bounds(cb, int(np.count_nonzero(real))))
    bins = np.asarray(seg.tb_bin, np.int64) | np.asarray(seg.tb_bout,
                                                         np.int64) << 16
    cols = (0, lanes, rows, bprow, cb, nch, bins, flags)
    return np.stack([np.broadcast_to(np.asarray(c, np.int64), (T,))
                     for c in cols], 1).astype(np.int32)


def chunk_bounds(chunkbase: np.ndarray, nreal: int) -> np.ndarray:
    """[T + 1] int32 chunk boundaries of a run's transitions."""
    return np.append(np.asarray(chunkbase, np.int32), np.int32(nreal))


def initial_v(R: int, device) -> torch.Tensor:
    """The DP state before level 0: NEG except lane 0 (the source pair)."""
    v = torch.full((R + 1, 1024), NEG, dtype=torch.int32, device=device)
    v[:, 0] = 0
    return v


def make_keys(cand: torch.Tensor, ordinal: torch.Tensor) -> torch.Tensor:
    """int64 reduction keys of candidate values (``>= REACH_T``) and
    their pair ordinals; callers zero the keys of invalid candidates."""
    hi = (cand.to(torch.int64) - REACH_T + 1) << 32
    return hi | (_LOW32 - ordinal.to(torch.int64))


def decode_keys(keys: torch.Tensor):
    """(V, ordinal) of committed keys: V is NEG where no valid candidate
    reached the lane or the value is not above REACH_T; the ordinal is 0
    where no candidate reached it."""
    val = (keys >> 32) - 1 + REACH_T
    ok = (keys != 0) & (val > REACH_T)
    v = torch.where(ok, val, torch.full_like(val, NEG)).to(torch.int32)
    ordv = torch.where(keys != 0, _LOW32 - (keys & _LOW32), 0)
    return v, ordv
