"""One run of narrow transitions (K1): the CUDA kernel and its plain twin.

Replaces ``_narrow_kernel`` / ``_narrow_call`` of
``dipgenie_tpu/ops/diploid_pallas.py``. For every transition of the run,
every destination pair lane ``d`` and every ``r <= R``::

    V'[r, d] = max over the transition's pairs p with dst(p) = d of
               V[r - wsum(p), gidx(p)] + score(p)   (candidates from a
               source value below REACH_T, or with r < wsum, are skipped)

ties going to the smallest pair ordinal; ``V' <= REACH_T`` commits as
``NEG``. Only lanes ``[0, OUT)`` of the destination extent are written:
lanes past it keep stale values, which no later transition gathers. The
backpointer of ``(r, d)`` is the winner's pair ordinal (0 where no
candidate reached the lane).

On the card the run is one launch of ``csrc/narrow_run.cu``: V lives in
shared memory where ``[R+1, lanes]`` fits (``narrow_run``), else in global
memory (``narrow_run_global``, the same source; each wrapper counts its own
launches).
"""

from __future__ import annotations

import torch

from .. import kernels
from .plan import (
    CHUNK,
    REACH_T,
    DevSegment,
    chunk_bounds,
    decode_keys,
    make_keys,
)


def transition_keys(V, gidx, wsum, score, dst, ordinal, n_out):
    """[R+1, n_out] int64 max-reduced keys of one transition's real pairs
    (all arguments but ``V`` are 1-D over those pairs)."""
    R1 = V.shape[0]
    rows = torch.arange(R1, device=V.device)[:, None]
    src_row = rows - wsum[None, :].to(torch.int64)
    cand = V[src_row.clamp(min=0), gidx[None, :].to(torch.int64)]
    valid = (src_row >= 0) & (cand >= REACH_T)
    keys = torch.where(
        valid, make_keys(cand + score[None, :], ordinal[None, :]), 0
    )
    out = torch.zeros((R1, n_out), dtype=torch.int64, device=V.device)
    idx = dst[None, :].to(torch.int64).expand(R1, -1)
    return out.scatter_reduce_(1, idx, keys, reduce="amax")


def _out_lanes(sbits_first_chunk: int) -> int:
    return CHUNK * (((int(sbits_first_chunk) >> 7) & 3) + 1)


def _backpointers(seg: DevSegment, R1: int, device):
    """Zeroed ``(bp256, bp1024)`` of a run (lanes of a bp1024 block past
    its transition's OUT stay 0)."""
    h = seg.host
    return (torch.zeros((h.n256, R1, CHUNK), dtype=torch.int16,
                        device=device),
            torch.zeros((h.n1024, R1, 1024), dtype=torch.int16,
                        device=device))


def narrow_run_ref(seg: DevSegment, v_in: torch.Tensor):
    """Plain PyTorch version: ``(V_out [R+1, 1024] int32, bp256, bp1024)``
    from ``V_in [R+1, 1024] int32``."""
    h = seg.host
    V = v_in.clone()
    bp256, bp1024 = _backpointers(seg, V.shape[0], V.device)
    tbl = seg.t["tbl"]
    bounds = chunk_bounds(h.tb_chunkbase, seg.nreal)
    for ti in range(h.t1 - h.t0):
        c0, c1 = int(bounds[ti]), int(bounds[ti + 1])
        packed = tbl[c0:c1, 0].reshape(-1)
        score = tbl[c0:c1, 1].reshape(-1)
        dst = ((packed >> 2) & 2047) - 1
        real = dst >= 0
        ordinal = torch.nonzero(real).reshape(-1)
        packed, score, dst = packed[real], score[real], dst[real]
        out = _out_lanes(h.sbits[c0])
        keys = transition_keys(
            V, packed >> 13, packed & 3, score, dst, ordinal, out
        )
        v, ordv = decode_keys(keys)
        V[:, :out] = v
        row = int(h.tb_bprow[ti])
        if int(h.tb_bits[ti]) & 2:
            bp1024[row, :, :out] = ordv.to(torch.int16)
        else:
            bp256[row] = ordv.to(torch.int16)
    return V, bp256, bp1024


# Dynamic shared memory a block may opt into on the H100 (and H200), and
# K1's fixed share of it (csrc/narrow_run.cu: the descriptor ring, two
# transitions' 2,048 staged {packed, score} words and [1024] uint16 range
# pairs)
SHARED_LIMIT = 232_448
_FIXED_BYTES = 8 * 16 + 2 * 2048 * 8 + 2 * 2 * 1024 * 2


def smem_bytes(R1: int, lanes: int, shared_v: bool) -> int:
    """Dynamic shared memory of a K1 launch (``dg_narrow_smem_bytes``): V
    with two rows of NEG below row 0."""
    return _FIXED_BYTES + ((R1 + 2) * lanes * 4 if shared_v else 0)


def state_in_shared(seg: DevSegment, R1: int) -> bool:
    """Whether K1 keeps this run's V ``[R1, seg.lanes]`` in shared memory
    (``narrow_run``) or in global memory (``narrow_run_global``)."""
    return smem_bytes(R1, seg.lanes, True) <= SHARED_LIMIT


def _launch(seg: DevSegment, v_in: torch.Tensor, shared_v: bool):
    kernels.check_tensor(v_in, "v_in", torch.int32, (v_in.shape[0], 1024))
    h = seg.host
    T = h.t1 - h.t0
    R1 = v_in.shape[0]
    tbl, desc = seg.t["tbl"], seg.t["tb_desc"]
    kernels.check_tensor(tbl, "tbl", torch.int32, None, v_in.device)
    kernels.check_tensor(desc, "tb_desc", torch.int32, (T, 4), v_in.device)
    if R1 < 1:
        raise ValueError(f"narrow_run: R + 1 = {R1} rows, want >= 1")
    # zeroed: the kernel writes only the ordinals that are not 0
    bp256, bp1024 = _backpointers(seg, R1, v_in.device)
    # the kernel writes every lane of rows 0..R; with V in global memory it
    # keeps two rows of NEG below row 0 (rows 0 and 1 here)
    V = torch.empty((R1 + 2, 1024), dtype=torch.int32, device=v_in.device)[2:]
    rc = kernels.lib().dg_narrow_run(
        tbl.data_ptr(), desc.data_ptr(), T, R1, seg.lanes, int(shared_v),
        v_in.data_ptr(), V.data_ptr(), bp256.data_ptr(), bp1024.data_ptr(),
        kernels.stream_of(v_in),
    )
    kernels.raise_on_error(rc, "narrow_run")
    return V, bp256, bp1024


def narrow_run(seg: DevSegment, v_in: torch.Tensor):
    """K1. A CUDA ``v_in`` launches ``csrc/narrow_run.cu`` (one launch per
    run) with V in shared memory, or, where the run's V does not fit there
    (``state_in_shared``), goes to ``narrow_run_global``; a CPU ``v_in``
    takes ``narrow_run_ref``."""
    if v_in.device.type == "cpu":
        return narrow_run_ref(seg, v_in)
    if not state_in_shared(seg, v_in.shape[0]):
        return narrow_run_global(seg, v_in)
    out = _launch(seg, v_in, True)
    narrow_run.launches += 1
    return out


def narrow_run_global(seg: DevSegment, v_in: torch.Tensor):
    """K1 with V in global memory: the same kernel, for the runs whose V
    does not fit shared memory (any shape may take it). A CPU ``v_in``
    takes ``narrow_run_ref``."""
    if v_in.device.type == "cpu":
        return narrow_run_ref(seg, v_in)
    out = _launch(seg, v_in, False)
    narrow_run_global.launches += 1
    return out


narrow_run.launches = 0
narrow_run_global.launches = 0
