"""One run of wide transitions over dense chunks (K2): the CUDA kernel
and its plain twin.

Replaces ``_wide_dense_kernel`` / ``_wide_call`` of
``dipgenie_tpu/ops/diploid_pallas.py``. The main path sends it the wide
runs of at most ``DENSE_NB_MAX`` windows; it also runs the bigger ones
up to ``DENSE_NB_LIMIT`` (31) windows when asked (``plan_to_device(...,
dense_nb_max=31)``): the runs that have dense tables. The transition is the one of
``narrow.py`` over a ``[R+1, NB * 1024]`` state; every lane of every
window is rewritten at each transition, so lanes no kept pair reaches
(holes, windows past the extent) become ``NEG``. The run's output state
is the first 1024 lanes. The kernel writes only the lanes it must for the
same result (``ops/plan.py:wide_slices``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .narrow import transition_keys
from .plan import (
    DENSE_NB_LIMIT, NEG, PAD_SC, DevSegment, chunk_bounds, decode_keys,
)


def _alloc(seg: DevSegment, v_in: torch.Tensor):
    h = seg.host
    R1 = v_in.shape[0]
    lanes = h.NB * 1024
    V = torch.full((R1, lanes), NEG, dtype=torch.int32, device=v_in.device)
    V[:, :1024] = v_in
    bp = torch.zeros((h.t1 - h.t0, R1, lanes), dtype=torch.int32,
                     device=v_in.device)
    return V, bp


def wide_dense_run_ref(seg: DevSegment, v_in: torch.Tensor):
    """Plain PyTorch version: ``(V_out [R+1, 1024] int32, bp [T, R+1,
    NB * 1024] int32)`` from ``V_in [R+1, 1024] int32``."""
    h = seg.host
    V, bp = _alloc(seg, v_in)
    dtbl = seg.t["dtbl"]
    bounds = chunk_bounds(h.tb2_chunkbase, seg.nreal)
    for ti in range(h.t1 - h.t0):
        c0, c1 = int(bounds[ti]), int(bounds[ti + 1])
        packed = dtbl[c0:c1, 0].reshape(-1)
        score = dtbl[c0:c1, 1].reshape(-1)
        real = score != PAD_SC
        ordinal = torch.nonzero(real).reshape(-1)
        packed, score = packed[real], score[real]
        keys = transition_keys(
            V, (packed >> 17) & 32767, packed & 3, score,
            (packed >> 2) & 32767, ordinal, V.shape[1],
        )
        V, bp[ti] = decode_keys(keys)
    return V[:, :1024].contiguous(), bp


def wide_dense_run(seg: DevSegment, v_in: torch.Tensor):
    """K2. A CUDA ``v_in`` launches ``csrc/wide_dense_run.cu`` (one
    cooperative launch per run of ``seg.k2_grid`` blocks over the slices
    ``plan_to_device`` made); a CPU ``v_in`` takes ``wide_dense_run_ref``."""
    if v_in.device.type == "cpu":
        return wide_dense_run_ref(seg, v_in)
    kernels.check_tensor(v_in, "v_in", torch.int32, (v_in.shape[0], 1024))
    h = seg.host
    T, R1 = h.t1 - h.t0, v_in.shape[0]
    dtbl = seg.t["dtbl"]
    kernels.check_tensor(dtbl, "dtbl", torch.int32, None, v_in.device)
    if not 1 <= h.NB <= DENSE_NB_LIMIT:
        raise ValueError(
            f"wide_dense_run: NB = {h.NB}, want 1..{DENSE_NB_LIMIT} (a run "
            "of more windows has no dense tables; K3 runs it)")
    if seg.k2_cuts is None:
        raise ValueError("wide_dense_run: no slices of this run "
                         "(plan_to_device makes them for the runs it sends "
                         "to K2)")
    G, m = seg.k2_grid, seg.k2_per_block
    desc, cuts = seg.k2_desc, seg.k2_cuts
    kernels.check_tensor(desc, "k2_desc", torch.int32, (T, 2), v_in.device)
    kernels.check_tensor(cuts, "k2_cuts", torch.int16, (T, G * m + 1),
                         v_in.device)
    lanes = h.NB * 1024
    # two state buffers, written before they are read; zeroed backpointers
    # (the kernel writes only the ordinals that are not 0)
    V = torch.empty((2, R1, lanes), dtype=torch.int32, device=v_in.device)
    bp = torch.zeros((T, R1, lanes), dtype=torch.int32, device=v_in.device)
    rc = kernels.lib().dg_wide_dense_run(
        dtbl.data_ptr(), desc.data_ptr(), cuts.data_ptr(), T, R1, h.NB, G, m,
        v_in.data_ptr(), V.data_ptr(), bp.data_ptr(),
        kernels.stream_of(v_in),
    )
    kernels.raise_on_error(rc, "wide_dense_run")
    wide_dense_run.launches += 1
    return V[T & 1, :, :1024].contiguous(), bp


wide_dense_run.launches = 0
