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
  once (``coop_grid``; ``K2_GRID_CPU`` for a plan on the CPU), and each
  block takes ``k2_per_block`` slices of every transition: slice ``j *
  k2_grid + block`` is its j-th. The slices cut the transition's
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
* Window-split wide slices (made by ``plan_to_device`` for K3 and by
  ``shard_to_device`` for K4's share of a rank; ``split_slices``): K2's
  skeleton, a cooperative grid of ``k3_grid`` blocks (``coop_grid``),
  ``k3_per_block`` slices a block a transition, slice ``j * k3_grid +
  block`` its j-th, each at most ``K2_SLICE_LANES`` lanes and
  ``K2_SLICE_PAIRS`` slots. A transition's slot ``s`` is lane ``s % 256``
  of its chunk ``s // 256``; the real slots' destinations ascend, and the
  pads (``rel = -1``) sit at the end of each window's last chunk. The
  slices cut the written lanes ``[0, W)`` into runs of about equal work
  (a lane and its pairs). A destination of more than ``K2_SLICE_PAIRS //
  2`` pairs (past level widths of ~210 a band end's one destination holds
  a whole level's pairs) is cut into pieces of half a slice's share, and
  the kernel combines the cut lanes' partial winners after a grid
  barrier; lighter destinations, E's band ends (up to ~3,800) among them,
  are never cut. ``DevSegment.k3_cuts [T, S + 1, 2] int32`` holds each
  slice's first lane (``| SPLIT`` where the cut lies inside that lane's
  pairs) and first slot (the last entry ``W`` and one past the last real
  slot): slice k has the lanes ``[lane_k, lane_k+1 + split_k+1)`` and the
  slots ``[slot_k, slot_k+1)``, so a block searches nothing. ``k3_desc
  [T, 4] int32`` holds per transition its first chunk row, its first bp
  row, its bp lanes (extent windows x 1024) and 1 where a cut splits a
  lane (K4: the rank's first chunk of ``stbl``, 0, 0, the flag). ``W``
  is the whole state for the first ``buffers`` transitions, then the
  larger of this transition's extent and that of the transition
  ``buffers`` before it (K3 double-buffers V, K4 reuses one partial
  buffer).
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

Reduction key. For every destination lane and row the plain versions
keep the best candidate as one 64-bit key, ``(value - REACH_T + 1) << 32 |
(0xFFFFFFFF - ordinal)``, merged with a max. A larger key is a larger
value, then a smaller ordinal: the reference tie rule (the earliest pair
in plan order wins). The max is order-independent, and 0 means "no valid
candidate". The high word stays below 2^31 (it is read back signed): the
planner refuses a graph whose values could pass ``VALUE_MAX``
(2,147,221,502). The kernels keep no keys: each destination's pairs are
one range in plan order, so K1 walks them and keeps the first maximum,
which is the same winner, and K2, K3 and K4 take each range's first
maximum in shared memory (a warp's lanes' winners combined on the value,
then the smaller ordinal; ``csrc/coop.cuh``; K3 and K4 combine a cut
heavy destination's parts in slot order). Padded pair lanes never make a
candidate: K1 walks only a transition's real pairs, K3 (and K4) drop pads
by their ``dst + 1 == 0`` sentinel, K2 by ``score == PAD_SC``, before
``value + score`` is formed, and a real score is a popcount (>= 0), so no
real lane looks like a pad, whatever the values.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import timing
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

# The sliced kernels' slices (csrc/coop.cuh; K2: wide_slices, K3 / K4:
# split_slices): the widest (MAX_W), the most pairs or slots (CAND: their
# candidates fill the block's shared memory), the most a block takes a
# transition (K2: its cache of pair ranges, KCACHE, holds two transitions'
# worth; K3 / K4: a bound on the search), and the grid of a plan shipped
# to the CPU, where only the tests read them (an H100 SXM's 132 SMs, one
# block each)
K2_SLICE_LANES = 1024
K2_SLICE_PAIRS = 44032
K2_PER_BLOCK_MAX = 16
K3_PER_BLOCK_MAX = 64
K2_GRID_CPU = 132
# the flag of a K3 / K4 slice's first lane whose cut lies inside that
# lane's pairs (split_slices: only a lane of more than K2_SLICE_PAIRS // 2
# pairs is cut)
SPLIT = 1 << 30
# the traceback's per-transition columns (DevPlan.desc, csrc/trace.cu):
# "bins" is bin | bout << 16, "flags" ORs TRACE_FLAGS
TRACE_COLS = ("seg", "lanes", "rows", "bprow", "chunkbase", "nch", "bins",
              "flags")
TRACE_FLAGS = {"dense": 1, "rowstep": 2, "bp1": 4, "bp16": 8}


def segment_kind(seg, dense_nb_max: int = DENSE_NB_MAX, mesh=None,
                 dense=None) -> str:
    """``narrow`` (K1), ``wide`` (K2, dense chunks), ``wide_split`` (K3,
    window-split chunks) or, under a tp ``mesh``, ``wide_tp`` (K4): the
    kernel that runs a plan segment. A dense run with a destination of more
    pairs than a K2 slice holds (parallel edges into its two nodes) goes to
    K3, which cuts such a destination over slices. ``dense`` is the run's
    ``dense_destinations``, where the caller has them."""
    if isinstance(seg, _NarrowRun):
        return "narrow"
    if mesh is not None:
        return "wide_tp"
    if seg.NB > dense_nb_max or seg.NB > DENSE_NB_LIMIT:
        return "wide_split"
    heavy = (dense if dense is not None else dense_destinations(seg))[1]
    return "wide_split" if heavy > K2_SLICE_PAIRS else "wide"


def dense_destinations(seg: _WideRun) -> tuple[list, int]:
    """``(dsts, heavy)`` of a wide run with dense tables: per transition
    the destination lanes of its real dense pairs, and the most pairs on
    one destination lane in any transition. Raises unless every
    transition's real pairs come first and are sorted by destination,
    which K2's searches and walks rely on. The one walk of ``dtbl`` that
    both ``segment_kind`` (K2 or K3) and ``wide_slices`` read."""
    nreal = int(np.count_nonzero(seg.dbits & 4))
    bounds = chunk_bounds(seg.tb2_chunkbase, nreal)
    dsts, heavy = [], 0
    for ti in range(seg.t1 - seg.t0):
        words = seg.dtbl[bounds[ti]:bounds[ti + 1]]
        real = words[:, 1].ravel() != PAD_SC
        n = int(real.sum())
        dst = (words[:, 0].ravel()[:n] >> 2) & 32767
        if not real[:n].all() or np.any(np.diff(dst) < 0):
            raise ValueError(
                f"dense_destinations: transition {seg.t0 + ti}'s dense "
                "pairs are not sorted by destination ahead of the pads")
        if n:
            change = np.flatnonzero(dst[1:] != dst[:-1]) + 1
            heavy = max(heavy, int(np.diff(change, prepend=0,
                                           append=n).max()))
        dsts.append(dst)
    return dsts, heavy


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
    # wide_split (K3) and wide_tp (K4): the same for the window-split
    # slices (split_slices)
    k3_grid: int = 0
    k3_per_block: int = 0
    k3_desc: torch.Tensor | None = None
    k3_cuts: torch.Tensor | None = None

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
    dseg = DevSegment(kind="wide_tp", host=seg, t=t, nreal=len(rows),
                      bounds=bounds, trace_cols=trace_columns("wide_tp", seg))
    _ship_split_slices(dseg, t["stbl"], t["swin"], bounds, 1)
    return dseg


def _ship_split_slices(dseg: DevSegment, tbl: torch.Tensor,
                       win: torch.Tensor, bounds: np.ndarray,
                       buffers: int) -> None:
    """Set ``dseg``'s K3 / K4 slice tables (see the module docstring) for
    the shipped chunks ``tbl`` / ``win`` whose transitions are ``bounds``,
    cut where they lie."""
    from .wide_split import ext_windows

    h = dseg.host
    ext = ext_windows(h)
    device = tbl.device
    grid = coop_grid("wide_split", device)
    cuts, split, m = split_slices(tbl, win, bounds, ext, h.NB * 1024, grid,
                                  buffers)
    desc = np.zeros((h.t1 - h.t0, 4), np.int32)
    desc[:, 0] = bounds[:-1]
    if dseg.kind == "wide_split":
        desc[:, 1] = h.tb_bprow
        desc[:, 2] = ext * 1024
    desc[:, 3] = split
    dseg.k3_desc = _tensor(desc, device)
    dseg.k3_cuts = cuts
    dseg.k3_grid, dseg.k3_per_block = grid, m


@functools.cache
def coop_grid(kernel: str, device) -> int:
    """Blocks of the cooperative grid of ``kernel`` (``"wide_dense"``: K2;
    ``"wide_split"``: K3 and K4) on ``device``: its SMs times the blocks of
    the kernel one SM holds at once (``csrc/coop.cuh:held_blocks``);
    ``K2_GRID_CPU`` for the CPU. A card that cannot hold a plan's grid
    refuses the launch, and the wrapper raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return K2_GRID_CPU
    from .. import kernels

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(kernels.lib(), f"dg_{kernel}_grid")(ctypes.byref(blocks))
    kernels.raise_on_error(rc, f"{kernel} grid")
    return blocks.value


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
    segs = []
    for seg in plan.segments:
        if mesh is not None and segment_kind(seg, mesh=mesh) == "wide_tp":
            segs.append(shard_to_device(seg, mesh.n_tp, mesh.tp_rank, device))
            continue
        t = {}
        for f in dataclasses.fields(seg):
            a = getattr(seg, f.name)
            if isinstance(a, np.ndarray):
                t[f.name] = _tensor(a, device)
        wide = isinstance(seg, _WideRun)
        if wide and DENSE_NB_LIMIT < seg.NB <= dense_nb_max:
            raise ValueError(
                f"plan_to_device: a wide run of {seg.NB} windows has no "
                f"dense tables (past {DENSE_NB_LIMIT}); K2 cannot run it, "
                f"dense_nb_max={dense_nb_max} sends it there")
        dense = (dense_destinations(seg) if wide and seg.NB <= dense_nb_max
                 else None)
        kind = segment_kind(seg, dense_nb_max, dense=dense)
        bits, real = _REAL_BITS[kind]
        nreal = int(np.count_nonzero(getattr(seg, bits) & real))
        dseg = DevSegment(kind=kind, host=seg, t=t, nreal=nreal,
                          trace_cols=trace_columns(kind, seg))
        if kind == "narrow":
            desc, dseg.lanes = narrow_desc(seg, nreal)
            t["tb_desc"] = _tensor(desc, device)
        elif kind == "wide":
            grid = coop_grid("wide_dense", device)
            desc, cuts, dseg.k2_per_block = wide_slices(seg, nreal, grid,
                                                        dense)
            dseg.k2_desc = _tensor(desc, device)
            dseg.k2_cuts = _tensor(cuts, device)
            dseg.k2_grid = grid
        elif kind == "wide_split":
            _ship_split_slices(dseg, t["tbl"], t["wwin"],
                               chunk_bounds(seg.tb_chunkbase, nreal), 2)
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


def wide_slices(seg: _WideRun, nreal: int, grid: int, dense=None
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """``(k2_desc [T, 2] int32, k2_cuts [T, S + 1] int16, per_block)`` of
    a dense wide run for K2's grid of ``grid`` blocks (see the module
    docstring): the fewest slices a block that keep every slice within
    ``K2_SLICE_LANES`` lanes and ``K2_SLICE_PAIRS`` pairs. ``dense`` is
    the run's ``dense_destinations`` (walked here where not given);
    ``PlanLimit`` where no slicing fits (a destination of more than
    ``K2_SLICE_PAIRS`` pairs, which ``segment_kind`` sends to K3, or a
    grid too small for the run's lanes)."""
    T = seg.t1 - seg.t0
    full = seg.NB * 1024
    bounds = chunk_bounds(seg.tb2_chunkbase, nreal)
    ext = np.minimum(np.asarray(seg.tb_bout, np.int64) ** 2, full)
    W = np.full(T, full, np.int64)
    W[2:] = np.maximum(ext[2:], ext[:-2])
    dsts, heavy = dense if dense is not None else dense_destinations(seg)
    if heavy > K2_SLICE_PAIRS:
        raise PlanLimit(
            f"wide_slices: a destination of {heavy} pairs in the run at "
            f"level {seg.t0}; K2 holds at most {K2_SLICE_PAIRS} a slice")
    work = [np.bincount(d, minlength=w) + 1 for d, w in zip(dsts, W)]
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


def split_slices(tbl, win, bounds: np.ndarray, ext: np.ndarray, full: int,
                 grid: int, buffers: int
                 ) -> tuple[torch.Tensor, np.ndarray, int]:
    """``(k3_cuts [T, S + 1, 2] int32, split [T] bool, per_block)`` of
    window-split chunks (``tbl [n, 2, 256]`` and destination windows ``win
    [n]``, tensors or arrays; transition ``ti``'s chunks
    ``bounds[ti]:bounds[ti + 1]``, its extent ``ext[ti]`` windows) for a
    grid of ``grid`` blocks over a state of ``full`` lanes (see the module
    docstring): the fewest slices a block that keep every slice within
    ``K2_SLICE_LANES`` lanes and
    ``K2_SLICE_PAIRS`` slots; ``split[ti]`` where a cut falls inside a
    heavy destination's pairs. The cuts are made where the tables lie (on
    the card at ship time), every transition of the run at once but those
    with a heavy destination (cut on the host, ``_cut_transition``).
    Raises unless each transition's real pairs ascend by destination
    within its ``W``; ``PlanLimit`` where no slicing fits. Span
    ``plan.split_slices``."""
    with timing.span("plan.split_slices"):
        tbl = torch.as_tensor(tbl)
        dev = tbl.device
        win = torch.as_tensor(win, device=dev)
        T = len(bounds) - 1
        E = np.asarray(ext, np.int64) * 1024
        W = np.full(T, full, np.int64)
        if T > buffers:
            W[buffers:] = np.maximum(E[buffers:], E[:-buffers])
        b = np.asarray(bounds, np.int64) - bounds[0]
        c0, c1 = int(bounds[0]), int(bounds[-1])
        # per transition its chunks, its first slot in the run and its W, in
        # one copy
        nch, base, Wt = torch.from_numpy(
            np.stack([np.diff(b), b[:-1] * CHUNK, W])).to(dev)
        base, Wt = base[:, None], Wt[:, None]
        rel = ((tbl[c0:c1, 0] >> 2) & 2047) - 1
        tr = torch.repeat_interleave(torch.arange(T, device=dev), nch,
                                     output_size=c1 - c0)
        # each real pair's key, its transition * full + its destination lane
        # (ascending within a transition), and its slot in the run
        key = (tr * full + win[c0:c1].long() * 1024)[:, None] + rel
        slots = torch.nonzero(rel.reshape(-1) >= 0).reshape(-1)
        keys = key.reshape(-1)[slots]
        slots = torch.cat([slots, slots.new_zeros(1)])
        unsorted = (keys[1:] < keys[:-1]).any().reshape(1)
        row = torch.arange(T, device=dev)[:, None] * full
        start = torch.searchsorted(keys, row)
        past = torch.searchsorted(keys, row + full)
        # one past each transition's last real slot (0 where it has none)
        end = torch.where(past > start,
                          slots[(past - 1).clamp(min=0)] + 1 - base, 0)
        lane = torch.arange(full, device=dev)
        # the run's transitions in blocks of at most 2^22 (transition, lane)
        # cells, each cut at once (balanced_cuts, a row a transition); one
        # read of the flags a slicing, one of its largest slice
        step = max(1, (1 << 22) // full)
        for m in range(-(-full // (grid * K2_SLICE_LANES)),
                       K3_PER_BLOCK_MAX + 1):
            S = grid * m
            k = torch.arange(S + 1, device=dev)
            at = torch.empty((T, S + 1), dtype=torch.int64, device=dev)
            flags = [unsorted]
            for t0 in range(0, T, step):
                t1 = min(T, t0 + step)
                cells = (t1 - t0) * full
                idx = keys - t0 * full
                mine = (idx >= 0) & (idx < cells)
                counts = torch.zeros(cells, dtype=torch.int64, device=dev)
                counts.index_add_(0, idx.clamp(0, cells - 1), mine.long())
                counts = counts.view(t1 - t0, full)
                inside = lane < Wt[t0:t1]
                cum = torch.nn.functional.pad(
                    torch.cumsum(torch.where(inside, counts + 1, 0), 1),
                    (1, 0))
                # the first lane whose work before it reaches k / S of the
                # row's total, in integers (cum * S >= total * k)
                a = torch.minimum(torch.searchsorted(cum * S, cum[:, -1:] * k),
                                  Wt[t0:t1])
                a[:, :1], a[:, -1:] = 0, Wt[t0:t1]
                at[t0:t1] = a
                flags += [(counts * ~inside).any().reshape(1),
                          counts.amax(1) > K2_SLICE_PAIRS // 2,
                          (torch.diff(a, dim=1) > K2_SLICE_LANES).any(1)]
            f = torch.cat(flags).tolist()
            if f[0]:
                raise ValueError("split_slices: a transition's pairs do not "
                                 "ascend by destination")
            heavy, wide, i = [], [], 1
            for t0 in range(0, T, step):
                n = min(T, t0 + step) - t0
                if f[i]:
                    raise ValueError("split_slices: a pair lands past its "
                                     "transition's W")
                heavy += f[i + 1:i + 1 + n]
                wide += f[i + 1 + n:i + 1 + 2 * n]
                i += 1 + 2 * n
            capped = [t for t in range(T) if wide[t] and not heavy[t]]
            if capped:  # cap the widths, leaving room for the rest
                at[capped] = torch.from_numpy(_cap_widths(
                    at[capped].cpu().numpy(), W[capped], S, K2_SLICE_LANES)
                    ).to(dev)
            # each cut's slot: the first real pair at or past its lane (one
            # past the transition's last where there is none)
            idx = torch.searchsorted(keys, row + at)
            cuts = torch.stack([at, torch.where(idx < past, slots[idx] - base,
                                                end)], 2).to(torch.int32)
            split = np.zeros(T, bool)
            for t in (t for t in range(T) if heavy[t]):
                p0, p1 = int(start[t]), int(past[t])
                c, split[t] = _cut_transition(
                    (slots[p0:p1] - base[t]).cpu().numpy(),
                    (keys[p0:p1] - t * full).cpu().numpy(), int(W[t]), S)
                cuts[t] = torch.from_numpy(c).to(dev)
            if not T or int(torch.diff(cuts[:, :, 1], dim=1).max()
                            ) <= K2_SLICE_PAIRS:
                return cuts, split, m
        raise PlanLimit(
            f"split_slices: a run of {full // 1024} windows does not fit "
            f"{K3_PER_BLOCK_MAX} slices a block of a grid of {grid}")


def _cut_transition(slots: np.ndarray, dst: np.ndarray, W: int, S: int
                    ) -> tuple[np.ndarray, bool]:
    """``([S + 1, 2] cuts, split)`` of one transition's real pairs (their
    slots and ascending destinations) over the lanes ``[0, W)`` where a
    lane holds more than ``K2_SLICE_PAIRS // 2`` pairs: such a lane is cut
    into pieces of half a slice's share of the work, and the lanes and
    pieces are cut into ``S`` runs of about equal work
    (``balanced_cuts``)."""
    n = len(dst)
    counts = np.bincount(dst, minlength=W)
    before = np.cumsum(counts) - counts  # pairs of the lanes before
    slot_of = np.append(slots, slots[-1] + 1 if n else 0)
    piece = max(1, int(np.ceil((W + n) / S / 2)))
    q = np.where(counts > K2_SLICE_PAIRS // 2, -(-counts // piece), 1)
    lane_of = np.repeat(np.arange(W), q)
    j = np.arange(len(lane_of)) - np.repeat(np.cumsum(q) - q, q)
    c, qq = counts[lane_of], q[lane_of]
    first = c * j // qq  # the piece's first pair within its lane
    work = c * (j + 1) // qq - first + (j == 0)
    at = balanced_cuts(work, S, K2_SLICE_LANES)
    lane = np.append(lane_of, W)[at]
    cut = np.append(j > 0, False)[at]
    slot = slot_of[np.append(before[lane_of] + first, n)[at]]
    return (np.stack([lane | np.where(cut, SPLIT, 0), slot], 1),
            bool(cut.any()))


def _cap_widths(cuts: np.ndarray, W: np.ndarray, slices: int, cap: int
                ) -> np.ndarray:
    """Rows of cuts [rows, slices + 1] over ``W`` lanes each with no slice
    wider than ``cap``: each cut moved as little as keeps the slices before
    it within ``cap`` and leaves room for the rest."""
    for k in range(1, slices):
        cuts[:, k] = np.minimum(
            np.maximum(np.maximum(cuts[:, k], cuts[:, k - 1]),
                       W - (slices - k) * cap), cuts[:, k - 1] + cap)
    return cuts


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
    return _cap_widths(cuts[None], np.array([W]), slices, cap)[0]


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
