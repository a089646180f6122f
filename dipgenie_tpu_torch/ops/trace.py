"""The traceback (K-T): one sequential walk from the sink back to level 0
over the resident backpointers of every segment.

Replaces ``_narrow_trace`` (a reverse ``lax.scan``) and the per-segment
orchestration around it in ``dipgenie_tpu/ops/diploid_pallas.py``. The
carry is ``(lane, r)``, starting at the sink pair lane 0 with ``r = R``.
For global transition ``t`` (level ``t`` to ``t + 1``) the walk reads the
pair ordinal ``slot = bp[r, lane]``, the pair's packed table entry at
chunk ``chunkbase + slot // 256``, lane ``slot % 256``, and writes the
record ``(pi, pj, i2, j2, wu, wv, symd)`` to row ``t`` of an
``[L - 1, 7] int32`` tensor; then ``lane = gidx`` and ``r -= wsum``.

Where ``lane`` lies in the backpointers, as ``_narrow_trace`` reads them:
a transition's bp block is ``[R+1, lanes]`` at row ``bprow`` of its array
(row ``ti`` of a dense wide or a ``wide_tp`` run's ``[T, R+1, NB * 1024]``;
a ``wide_tp`` run's slots index its window-split tables, as the JAX
package's host walk of the merged tp backpointers reads them);
for the 1024-class blocks (narrow bp1024, dense wide, window-split wide)
the lane is row ``bprow + lane // lanes``, column ``lane % lanes``, so a
window-split run's lane ``win * 1024 + rel`` is read from its window's
row. The 256-class narrow blocks clamp the column to 255 instead. Rows
are clamped to the array and ``r`` to 0, which only a walk from an
unreachable sink needs.

On the card the walk is one launch of ``csrc/trace.cu``. Everything it
reads about a transition but the arrays' addresses was shipped with the
plan (``DevPlan.desc``, ``ops/plan.py:trace_columns``); ``trace`` sends one
row of addresses per segment.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import timing
from .plan import CHUNK, DevPlan


def _tables(seg, ti: int):
    """(which bp array, its row, chunkbase, table, w1, symd, dense) of
    transition ``ti`` of a segment."""
    h = seg.host
    if seg.kind == "narrow":
        which = 1 if int(h.tb_bits[ti]) & 2 else 0
        return (which, int(h.tb_bprow[ti]), int(h.tb_chunkbase[ti]),
                seg.t["tbl"], seg.t["w1"], seg.t["symd"], False)
    if seg.kind == "wide_split":
        return (0, int(h.tb_bprow[ti]), int(h.tb_chunkbase[ti]),
                seg.t["tbl"], seg.t["w1"], seg.t["symd"], False)
    if seg.kind == "wide_tp":
        return (0, ti, int(h.tb_chunkbase[ti]), seg.t["tbl"], seg.t["w1"],
                seg.t["symd"], False)
    return (0, ti, int(h.tb2_chunkbase[ti]), seg.t["dtbl"], seg.t["dw1"],
            seg.t["dsymd"], True)


def _row_col(blk: torch.Tensor, row: int, lane: int) -> tuple[int, int]:
    """(bp row, column) of ``lane`` in a block array ``[rows, R+1, lanes]``
    whose transition starts at ``row`` (see the module docstring)."""
    lanes = blk.shape[2]
    if lanes == CHUNK:
        return row, min(lane, lanes - 1)
    return min(row + lane // lanes, blk.shape[0] - 1), lane % lanes


def trace_ref(dplan: DevPlan, bps: list) -> torch.Tensor:
    """Plain PyTorch version. ``bps[i]`` is segment i's backpointers:
    ``(bp256, bp1024)`` for a narrow run, ``(bp,)`` for a wide one."""
    recs = torch.zeros((max(dplan.L - 1, 0), 7), dtype=torch.int32)
    lane, r = 0, dplan.R
    for seg, bp in zip(reversed(dplan.segments), reversed(bps)):
        h = seg.host
        for ti in range(h.t1 - h.t0 - 1, -1, -1):
            which, row, cb, tbl, w1t, syt, dense = _tables(seg, ti)
            brow, col = _row_col(bp[which], row, lane)
            slot = int(bp[which][brow, max(r, 0), col])
            crow, lanec = cb + slot // CHUNK, slot % CHUNK
            packed = int(tbl[crow, 0, lanec])
            gidx = (packed >> 17) & 32767 if dense else packed >> 13
            wsum = packed & 3
            w1 = int(w1t[crow, lanec])
            sy = int(syt[crow, lanec])
            bin_, bout = int(h.tb_bin[ti]), int(h.tb_bout[ti])
            recs[h.t0 + ti] = torch.tensor(
                [gidx // bin_, gidx % bin_, lane // bout, lane % bout,
                 w1, wsum - w1, sy], dtype=torch.int32)
            lane, r = gidx, r - wsum
    return recs.to(dplan.device)


def _bp_shapes(seg, R1: int) -> list:
    """The shapes of a segment's backpointer arrays (``trace_columns``)."""
    h = seg.host
    if seg.kind == "narrow":
        return [(h.n256, R1, CHUNK), (h.n1024, R1, 1024)]
    if seg.kind == "wide_split":
        return [(h.nrows, R1, 1024)]
    return [(h.t1 - h.t0, R1, h.NB * 1024)]


def _walk_tables(seg):
    """The chunk table, w1 and symd the walk reads for a segment."""
    names = ("dtbl", "dw1", "dsymd") if seg.kind == "wide" else (
        "tbl", "w1", "symd")
    return [seg.t[n] for n in names]


def bases(dplan: DevPlan, bps: list) -> torch.Tensor:
    """[segments, 6] int64 on the plan's device: per segment the addresses
    of its first and last backpointer array (a narrow run's bp256 and
    bp1024; the one array of a wide run twice), its chunk table, w1 and
    symd, and a 0 that pads the row to 48 bytes. Checks every array."""
    rows = []
    R1 = dplan.R + 1
    card = torch.device(dplan.device)
    card = card.index if card.index is not None else torch.cuda.current_device()
    for seg, blocks in zip(dplan.segments, bps):
        dtype = torch.int16 if seg.kind == "narrow" else torch.int32
        shapes = _bp_shapes(seg, R1)
        if len(blocks) != len(shapes) or not all(
                b.is_cuda and b.get_device() == card and b.dtype == dtype
                and b.shape == sh and b.is_contiguous()
                for b, sh in zip(blocks, shapes)):
            if len(blocks) != len(shapes):
                raise ValueError(f"trace: {len(blocks)} backpointer arrays "
                                 f"for a {seg.kind} segment")
            for b, sh in zip(blocks, shapes):
                kernels.check_tensor(b, "bp", dtype, sh, dplan.device)
        rows.append([blocks[0].data_ptr(), blocks[-1].data_ptr(),
                     *(t.data_ptr() for t in _walk_tables(seg)), 0])
    return torch.tensor(rows, dtype=torch.int64).to(dplan.device)


def trace(dplan: DevPlan, bps: list) -> torch.Tensor:
    """K-T. CUDA backpointers launch ``csrc/trace.cu`` (one launch for
    the whole plan); backpointers on the CPU take ``trace_ref``. Span
    ``pair.trace``."""
    with timing.span("pair.trace"):
        if all(b.device.type == "cpu" for blocks in bps for b in blocks):
            return trace_ref(dplan, bps)
        if len(bps) != len(dplan.segments):
            raise ValueError(f"trace: {len(bps)} backpointer sets for "
                             f"{len(dplan.segments)} segments")
        T = max(dplan.L - 1, 0)
        if dplan.desc.shape[0] != T:
            raise ValueError(f"trace: {dplan.desc.shape[0]} transitions in "
                             f"the plan's columns, want {T}")
        base = bases(dplan, bps)
        # whole blocks of 64 records leave shared memory in one bulk store
        # each
        recs = torch.empty((-(-T // 64) * 64, 7), dtype=torch.int32,
                           device=dplan.device)
        if T:
            rc = kernels.lib().dg_trace(
                dplan.desc.data_ptr(), base.data_ptr(), T, dplan.R,
                recs.data_ptr(), kernels.stream_of(recs))
            kernels.raise_on_error(rc, "trace")
            trace.launches += 1
        return recs[:T]


trace.launches = 0
