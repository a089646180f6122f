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


def _alloc(seg: DevSegment, v_in: torch.Tensor):
    R1 = v_in.shape[0]
    h = seg.host
    bp256 = torch.zeros((h.n256, R1, CHUNK), dtype=torch.int16,
                        device=v_in.device)
    bp1024 = torch.zeros((h.n1024, R1, 1024), dtype=torch.int16,
                         device=v_in.device)
    return v_in.clone(), bp256, bp1024


def narrow_run_ref(seg: DevSegment, v_in: torch.Tensor):
    """Plain PyTorch version: ``(V_out [R+1, 1024] int32, bp256, bp1024)``
    from ``V_in [R+1, 1024] int32``."""
    h = seg.host
    V, bp256, bp1024 = _alloc(seg, v_in)
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


def narrow_run(seg: DevSegment, v_in: torch.Tensor):
    """K1. A CUDA ``v_in`` launches ``csrc/narrow_run.cu`` (one launch per
    run); a CPU ``v_in`` takes ``narrow_run_ref``."""
    if v_in.device.type == "cpu":
        return narrow_run_ref(seg, v_in)
    kernels.check_tensor(v_in, "v_in", torch.int32, (v_in.shape[0], 1024))
    h = seg.host
    R1 = v_in.shape[0]
    tensors = {k: seg.t[k] for k in
               ("tbl", "sbits", "tb_chunkbase", "tb_bits", "tb_bprow")}
    for name, t in tensors.items():
        kernels.check_tensor(t, name, torch.int32, None, v_in.device)
    if R1 < 1:
        raise ValueError(f"narrow_run: R + 1 = {R1} rows, want >= 1")
    V, bp256, bp1024 = _alloc(seg, v_in)
    keys = torch.zeros((R1, 1024), dtype=torch.int64, device=v_in.device)
    T = h.t1 - h.t0
    lib = kernels.lib()
    rc = lib.dg_narrow_run(
        tensors["tbl"].data_ptr(), tensors["sbits"].data_ptr(),
        tensors["tb_chunkbase"].data_ptr(), tensors["tb_bits"].data_ptr(),
        tensors["tb_bprow"].data_ptr(), T, seg.nreal, R1,
        V.data_ptr(), keys.data_ptr(), bp256.data_ptr(), bp1024.data_ptr(),
        kernels.stream_of(v_in),
    )
    kernels.raise_on_error(rc, "narrow_run")
    narrow_run.launches += 1
    return V, bp256, bp1024


narrow_run.launches = 0
