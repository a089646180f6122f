"""The tp-sharded wide path: K4, one rank's partial of one wide transition
(the CUDA kernel and its plain twin), and the run that merges the ranks'
partials transition by transition.

Replaces ``_wide_step_kernel`` / ``_wide_step_call`` and the orchestration
of ``_run_wide_sharded`` / ``_sharded_jit`` in
``dipgenie_tpu/ops/diploid_pallas.py``. Under a mesh with ``n_tp`` tp ranks
every wide run is a ``wide_tp`` segment (``ops/plan.py``): tp rank ``d``
holds the window-split chunks of the destination windows ``win % n_tp ==
d``. Per transition each rank computes its partial ``part [2, R+1, NB *
1024]`` int32 against the replicated state: plane 0 the best candidate
value of the rank's chunks at each lane (the transition of ``narrow.py``,
ties to the smallest ordinal ``sbase + lane``), plane 1 its ordinal; NEG /
-1 on lanes none of the rank's chunks reaches. Windows are rank-disjoint,
so one ``all_reduce(MAX)`` over the tp group reassembles the whole
transition, and the commit ``where(present & (v > REACH_T), v, NEG)``
gives the next state on every rank. The merged backpointers stay resident
as ``bp [T, R+1, NB * 1024]`` with the unreached lanes' -1 committed as 0
(the traceback never reads them from a reachable sink).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import kernels
from ..utils import timing
from .narrow import transition_keys
from .pair_plan import SPLIT_NB_MAX
from .plan import CHUNK, NEG, REACH_T, DevSegment, _LOW32
from .wide_split import _state, check_slices


def _partial(keys: torch.Tensor) -> torch.Tensor:
    """[2, R+1, lanes] int32 partial of max-reduced keys."""
    has = keys != 0
    v = torch.where(has, (keys >> 32) - 1 + REACH_T, NEG)
    bp = torch.where(has, _LOW32 - (keys & _LOW32), -1)
    return torch.stack((v, bp)).to(torch.int32)


def _share(seg: DevSegment, ti: int) -> tuple[int, int]:
    return int(seg.bounds[ti]), int(seg.bounds[ti + 1])


def wide_step_ref(seg: DevSegment, ti: int, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: this rank's partial ``[2, R+1, NB * 1024]``
    of transition ``ti`` from the state ``v [R+1, NB * 1024]``."""
    c0, c1 = _share(seg, ti)
    tbl = seg.t["stbl"][c0:c1]
    packed = tbl[:, 0]
    rel = ((packed >> 2) & 2047) - 1
    dst = seg.t["swin"][c0:c1, None] * 1024 + rel
    lane = torch.arange(CHUNK, device=v.device)
    ordinal = seg.t["sbase"][c0:c1, None] + lane
    real = rel >= 0
    packed = packed[real]
    keys = transition_keys(v, packed >> 13, packed & 3, tbl[:, 1][real],
                           dst[real], ordinal[real], v.shape[1])
    return _partial(keys)


def new_partial(seg: DevSegment, R1: int, device) -> torch.Tensor:
    """A partial ``[2, R+1, NB * 1024]`` int32 of NEG / -1."""
    part = torch.empty((2, R1, seg.host.NB * 1024), dtype=torch.int32,
                       device=device)
    part[0].fill_(NEG)
    part[1].fill_(-1)
    return part


def wide_step(seg: DevSegment, ti: int, v: torch.Tensor,
              part: torch.Tensor | None = None) -> torch.Tensor:
    """K4. A CUDA ``v`` launches ``csrc/wide_step.cu`` (one cooperative
    launch per transition over this rank's slices, ``shard_to_device``'s);
    a CPU ``v`` takes ``wide_step_ref``. The kernel writes the lanes of
    the transition's slices into ``part`` and returns it; the lanes past
    them must hold NEG / -1 already, as the merged partial of the run's
    transition before holds them. Without ``part`` it writes into a new
    partial of NEG / -1."""
    if v.device.type == "cpu":
        return wide_step_ref(seg, ti, v)
    h = seg.host
    if not 1 <= h.NB <= SPLIT_NB_MAX:
        raise ValueError(f"wide_step: NB = {h.NB}, want 1..{SPLIT_NB_MAX}")
    R1 = v.shape[0]
    shape = (R1, h.NB * 1024)
    kernels.check_tensor(v, "v", torch.int32, shape)
    if part is None:
        part = new_partial(seg, R1, v.device)
    kernels.check_tensor(part, "part", torch.int32, (2, *shape), v.device)
    tensors = {k: seg.t[k] for k in ("stbl", "swin", "sbase")}
    for name, t in tensors.items():
        kernels.check_tensor(t, name, torch.int32, None, v.device)
    G, m = check_slices(seg, h.t1 - h.t0, v.device)
    rec = torch.empty((G * m, 2, R1, 2), dtype=torch.int32, device=v.device)
    rc = kernels.lib().dg_wide_step(
        tensors["stbl"].data_ptr(), tensors["swin"].data_ptr(),
        tensors["sbase"].data_ptr(), seg.k3_desc[ti].data_ptr(),
        seg.k3_cuts[ti].data_ptr(), R1, h.NB, G, m, v.data_ptr(),
        part.data_ptr(), rec.data_ptr(), kernels.stream_of(v),
    )
    kernels.raise_on_error(rc, "wide_step")
    wide_step.launches += 1
    return part


wide_step.launches = 0


def commit(part: torch.Tensor, present: torch.Tensor, bp_out: torch.Tensor):
    """The merged partial of one transition as the next state ``[R+1, NB
    * 1024]`` (NEG outside the present windows and at values not above
    REACH_T); writes its backpointers to ``bp_out`` with -1 as 0."""
    R1, lanes = part.shape[1:]
    v = part[0].view(R1, -1, 1024)
    ok = (v > REACH_T) & present[None, :, None]
    torch.clamp(part[1], min=0, out=bp_out)
    return torch.where(ok, v, NEG).view(R1, lanes)


def wide_tp_run(seg: DevSegment, v_in: torch.Tensor, group):
    """One ``wide_tp`` run on this rank: ``(V_out [R+1, 1024], bp [T, R+1,
    NB * 1024])`` from ``V_in [R+1, 1024]``, the same on every rank of the
    tp ``group``. Each merge is a span ``pair.tp_merge`` (with gloo on a
    card it holds the wait for the transition's K4, which the host staging
    needs)."""
    h = seg.host
    T = h.t1 - h.t0
    V = _state(seg, v_in)
    bp = torch.empty((T, *V.shape), dtype=torch.int32, device=V.device)
    # one partial for the run: K4 writes the whole of it at the first
    # transition, and each merge leaves NEG / -1 past the lanes of the next
    part = (None if V.device.type == "cpu"
            else torch.empty((2, *V.shape), dtype=torch.int32,
                             device=V.device))
    for ti in range(T):
        part = wide_step(seg, ti, V, part)
        with timing.span("pair.tp_merge"):
            dist.all_reduce(part, op=dist.ReduceOp.MAX, group=group)
        V = commit(part, seg.t["present"][ti], bp[ti])
    return V[:, :1024].contiguous(), bp
