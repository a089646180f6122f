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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .plan import CHUNK, DevPlan

# columns of the per-transition descriptor the CUDA walk reads
_DESC_COLS = 11


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


def _descriptors(dplan: DevPlan, bps: list) -> np.ndarray:
    """[L - 1, 11] int64: per transition the address of its bp block, the
    block's lane count, its element size, the addresses of its table,
    w1 and symd rows at the transition's first chunk, the dense flag,
    bin and bout, the block's class (1: a lane past the block steps rows,
    0: it clamps) and the rows of the bp array from the block on."""
    def addr(t, rows):
        return t.data_ptr() + rows.astype(np.int64) * (
            t.stride(0) * t.element_size()
        )

    desc = np.zeros((max(dplan.L - 1, 0), _DESC_COLS), np.int64)
    for seg, bp in zip(dplan.segments, bps):
        h = seg.host
        d = desc[h.t0 : h.t1]
        T = h.t1 - h.t0
        if seg.kind == "narrow":
            wide_bp = (h.tb_bits & 2) != 0
            d[:, 0] = np.where(wide_bp, addr(bp[1], h.tb_bprow),
                               addr(bp[0], h.tb_bprow))
            d[:, 1] = np.where(wide_bp, bp[1].shape[2], bp[0].shape[2])
            d[:, 9] = wide_bp
            d[:, 10] = np.where(wide_bp, bp[1].shape[0], bp[0].shape[0]) \
                - h.tb_bprow
            cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
        elif seg.kind == "wide_split":
            d[:, 0] = addr(bp[0], h.tb_bprow)
            d[:, 9] = 1
            d[:, 10] = bp[0].shape[0] - h.tb_bprow
            cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
        else:  # one [R+1, NB * 1024] block per transition
            d[:, 0] = addr(bp[0], np.arange(T))
            d[:, 9] = 1
            d[:, 10] = T - np.arange(T)
            if seg.kind == "wide_tp":
                cb, names, d[:, 6] = h.tb_chunkbase, ("tbl", "w1", "symd"), 0
            else:
                cb, names, d[:, 6] = (h.tb2_chunkbase,
                                      ("dtbl", "dw1", "dsymd"), 1)
        if seg.kind != "narrow":
            d[:, 1] = bp[0].shape[2]
        d[:, 2] = bp[0].element_size()
        for col, name in zip((3, 4, 5), names):
            d[:, col] = addr(seg.t[name], cb)
        d[:, 7] = h.tb_bin
        d[:, 8] = h.tb_bout
    return desc


def trace(dplan: DevPlan, bps: list) -> torch.Tensor:
    """K-T. CUDA backpointers launch ``csrc/trace.cu`` (one launch for
    the whole plan); backpointers on the CPU take ``trace_ref``."""
    if all(b.device.type == "cpu" for blocks in bps for b in blocks):
        return trace_ref(dplan, bps)
    if len(bps) != len(dplan.segments):
        raise ValueError(f"trace: {len(bps)} backpointer sets for "
                         f"{len(dplan.segments)} segments")
    for seg, blocks in zip(dplan.segments, bps):
        dtype = torch.int16 if seg.kind == "narrow" else torch.int32
        for b in blocks:
            kernels.check_tensor(b, "bp", dtype, None, dplan.device)
    desc = torch.from_numpy(_descriptors(dplan, bps)).to(dplan.device)
    recs = torch.zeros((max(dplan.L - 1, 0), 7), dtype=torch.int32,
                       device=dplan.device)
    lib = kernels.lib()
    rc = lib.dg_trace(desc.data_ptr(), desc.shape[0], dplan.R,
                      recs.data_ptr(), kernels.stream_of(recs))
    kernels.raise_on_error(rc, "trace")
    trace.launches += 1
    return recs


trace.launches = 0
