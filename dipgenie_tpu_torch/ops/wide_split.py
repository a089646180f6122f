"""One run of wide transitions over window-split chunks (K3): the CUDA
kernel and its plain twin.

Replaces ``_wide_split_kernel`` / ``_wide_split_call`` of
``dipgenie_tpu/ops/diploid_pallas.py``, which the JAX package runs for wide
runs of more than ``DENSE_NB_MAX`` 1024-lane windows (up to 31; the port
runs any run its planner makes, up to ``SPLIT_NB_MAX``). The transition is the
one of ``narrow.py`` over a ``[R+1, NB * 1024]`` state, read from the
window-split tables: a chunk's destination lane is ``wwin * 1024 + rel``
and a pair's ordinal ``wbase + lane``. Every lane of every window is
rewritten at each transition, so lanes no kept pair reaches (holes,
windows past the extent) become ``NEG``. Backpointers go to rows
``tb_bprow[t] + win`` of ``bp [nrows, R+1, 1024]`` int32, one row per
window below the transition's extent; hole windows get ordinal 0. The
run's output state is the first 1024 lanes. The kernel writes only the
lanes it must for the same result, over the slices ``plan_to_device``
made (``ops/plan.py:split_slices``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .narrow import transition_keys
from .pair_plan import SPLIT_NB_MAX
from .plan import CHUNK, NEG, DevSegment, chunk_bounds, decode_keys


def ext_windows(h) -> np.ndarray:
    """[T] int32: each transition's extent in windows (its bp rows)."""
    return np.diff(np.append(h.tb_bprow, h.nrows)).astype(np.int32)


def _state(seg: DevSegment, v_in: torch.Tensor) -> torch.Tensor:
    V = torch.full((v_in.shape[0], seg.host.NB * 1024), NEG,
                   dtype=torch.int32, device=v_in.device)
    V[:, :1024] = v_in
    return V


def wide_split_run_ref(seg: DevSegment, v_in: torch.Tensor):
    """Plain PyTorch version: ``(V_out [R+1, 1024] int32, bp [nrows, R+1,
    1024] int32)`` from ``V_in [R+1, 1024] int32``."""
    h = seg.host
    R1 = v_in.shape[0]
    V = _state(seg, v_in)
    bp = torch.zeros((h.nrows, R1, 1024), dtype=torch.int32,
                     device=v_in.device)
    tbl, wwin, wbase = seg.t["tbl"], seg.t["wwin"], seg.t["wbase"]
    bounds = chunk_bounds(h.tb_chunkbase, seg.nreal)
    ext = ext_windows(h)
    lane = torch.arange(CHUNK, device=v_in.device)
    for ti in range(h.t1 - h.t0):
        c0, c1 = int(bounds[ti]), int(bounds[ti + 1])
        packed = tbl[c0:c1, 0]
        rel = ((packed >> 2) & 2047) - 1
        dst = wwin[c0:c1, None] * 1024 + rel
        ordinal = wbase[c0:c1, None] + lane
        real = rel >= 0
        packed = packed[real]
        keys = transition_keys(
            V, packed >> 13, packed & 3, tbl[c0:c1, 1][real], dst[real],
            ordinal[real], V.shape[1],
        )
        V, ordv = decode_keys(keys)
        row, nw = int(h.tb_bprow[ti]), int(ext[ti])
        bp[row : row + nw] = ordv[:, : nw * 1024].reshape(
            R1, nw, 1024).transpose(0, 1).to(torch.int32)
    return V[:, :1024].contiguous(), bp


def check_slices(seg: DevSegment, T: int, device) -> tuple[int, int]:
    """``(grid, per_block)`` of a segment's slice tables, checked."""
    if seg.k3_cuts is None:
        raise ValueError(f"{seg.kind}: no slices of this run (plan_to_device "
                         "and shard_to_device make them)")
    G, m = seg.k3_grid, seg.k3_per_block
    kernels.check_tensor(seg.k3_desc, "k3_desc", torch.int32, (T, 4), device)
    kernels.check_tensor(seg.k3_cuts, "k3_cuts", torch.int32,
                         (T, G * m + 1, 2), device)
    return G, m


def wide_split_run(seg: DevSegment, v_in: torch.Tensor):
    """K3. A CUDA ``v_in`` launches ``csrc/wide_split_run.cu`` (one
    cooperative launch per run of ``seg.k3_grid`` blocks over the slices
    ``plan_to_device`` made); a CPU ``v_in`` takes ``wide_split_run_ref``."""
    if v_in.device.type == "cpu":
        return wide_split_run_ref(seg, v_in)
    kernels.check_tensor(v_in, "v_in", torch.int32, (v_in.shape[0], 1024))
    h = seg.host
    tensors = {k: seg.t[k] for k in ("tbl", "wwin", "wbase")}
    for name, t in tensors.items():
        kernels.check_tensor(t, name, torch.int32, None, v_in.device)
    if not 1 <= h.NB <= SPLIT_NB_MAX:
        raise ValueError(
            f"wide_split_run: NB = {h.NB}, want 1..{SPLIT_NB_MAX}")
    T, R1 = h.t1 - h.t0, v_in.shape[0]
    G, m = check_slices(seg, T, v_in.device)
    # two state buffers, each lane written before it is read; every bp row
    # is written: the rows of a transition are its windows below the
    # extent, and the transitions' rows tile [0, nrows)
    V = torch.empty((2, R1, h.NB * 1024), dtype=torch.int32,
                    device=v_in.device)
    bp = torch.empty((h.nrows, R1, 1024), dtype=torch.int32,
                     device=v_in.device)
    rec = torch.empty((G * m, 2, R1, 2), dtype=torch.int32,
                      device=v_in.device)
    rc = kernels.lib().dg_wide_split_run(
        tensors["tbl"].data_ptr(), tensors["wwin"].data_ptr(),
        tensors["wbase"].data_ptr(), seg.k3_desc.data_ptr(),
        seg.k3_cuts.data_ptr(), T, R1, h.NB, G, m, v_in.data_ptr(),
        V.data_ptr(), bp.data_ptr(), rec.data_ptr(),
        kernels.stream_of(v_in),
    )
    kernels.raise_on_error(rc, "wide_split_run")
    wide_split_run.launches += 1
    return V[T & 1, :, :1024].contiguous(), bp


wide_split_run.launches = 0
