"""The fused DP tier (``--dp-backend fused``): one forward over every
transition with every backpointer kept, then one traceback.

Counterpart of ``FusedDiploidDP`` and ``plan_fused`` of
``dipgenie_tpu/ops/diploid_fused.py`` with the same contract: ``run() ->
(sink_value, sink_s_het, transitions)``, ``transitions`` a list of
``(level, pi, pj, i2, j2, wu, wv)``, level ascending 1..L-1. The plan is
the port's per-vertex tables (``vertex_plan.py``, sized to each
transition) plus the backpointers' layout; the JAX plan's bucket ladders,
its ``lax.switch`` shape merging and its stacked per-bucket buffers are
TPU compile-shape workarounds and have no counterpart.

* K13 ``fused_forward`` (``csrc/fused_dp.cu``; replaces ``_forward_fn``,
  ``diploid_fused.py:462``, and its body ``_branch_step`` ``:306-414``):
  the launches ``vertex_plan.plan_launches`` cuts: a run of narrow
  transitions in one launch of one block, V in shared memory, each
  level's scores computed once into a table and a thread a state walking
  its pair's real slot pairs; a wide transition in one launch over the
  card, V in global memory, a warp a destination pair scoring each
  candidate once for all the rows. It writes the winner's slot pair ``p * P + q`` as the state's
  backpointer code: int16 where the transition's in-degree ``P`` is at
  most 256, int32 past that, at the transition's int64 byte offset in one
  flat buffer (0 at unreachable states, which it re-pins to NEG).
* K14 ``fused_trace`` (replaces ``_trace_fn`` ``:530-605``): the walk of
  the codes from the sink back to level 0, each decoded into ``(pi, pj,
  wu, wv)`` from the slot tables, and ``s_het``, the chosen pairs'
  ``popcount((Tl | Tl) ^ (Tr | Tr))`` summed. One launch of the staged
  walk of ``csrc/vertex_trace.cuh``: a producer warp copies each
  transition's code rows ``[r - 2, r]`` and slot table into shared memory
  a batch ahead of the walker; a recorder warp adds ``s_het``
  (``path_shet_ref`` is its plain version) and stores the rows.

A wrapper launches its kernel for CUDA tensors (raising where it cannot)
and takes the plain PyTorch version (``*_ref``) for CPU tensors. The
backpointers' bytes are counted before the forward: past what the card
has free, ``PlanLimit``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..utils import timing
from .pair_plan import PlanLimit
from .vertex_plan import (
    BP_OFF, K, K2, MASK_OFF, P, PRED_OFF, W, DevTables, VertexPlan,
    candidates, initial_state, plan_launches, plan_vertices, popcount, ship,
    transition_ref, _words,
)
CODE16_SLOTS = 256  # a code p * P + q fits 16 bits up to this in-degree


@dataclass
class FusedPlan:
    R: int
    vplan: VertexPlan
    desc: np.ndarray  # the plan's desc with each transition's bp offset
    bp_bytes: int  # the backpointers of every transition

    @property
    def T(self) -> int:
        return self.vplan.T


def code_bytes(P_) -> np.ndarray:
    """Bytes of a backpointer code at in-degree ``P``."""
    return np.where(np.asarray(P_) <= CODE16_SLOTS, 2, 4)


def plan_fused(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
               het_ptr, het_colors, R: int) -> FusedPlan:
    """The fused program of a levelized CSR graph (host): the vertex
    tables and every transition's backpointer offset (int64 bytes, each
    transition 4-byte aligned)."""
    vplan = plan_vertices(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr,
                          hom_colors, het_ptr, het_colors)
    desc = vplan.desc.copy()
    nbytes = (R + 1) * desc[:, K2] ** 2 * code_bytes(desc[:, P])
    nbytes = (nbytes + 3) // 4 * 4
    off = np.zeros(vplan.T + 1, np.int64)
    np.cumsum(nbytes, out=off[1:])
    desc[:, BP_OFF] = off[:-1]
    return FusedPlan(R=R, vplan=vplan, desc=desc, bp_bytes=int(off[-1]))


def _codes(bp: torch.Tensor, desc_row, R1: int) -> torch.Tensor:
    """The ``[R+1, k2, k2]`` codes of one transition, a view of the flat
    byte buffer ``bp``."""
    k2, off = int(desc_row[K2]), int(desc_row[BP_OFF])
    n = R1 * k2 * k2
    dt = torch.int16 if int(desc_row[P]) <= CODE16_SLOTS else torch.int32
    size = 2 if dt == torch.int16 else 4
    return bp[off:off + n * size].view(dt).view(R1, k2, k2)


def fused_forward_ref(dev: DevTables, t0: int, t1: int, V: torch.Tensor,
                      bp: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: transitions ``t0 .. t1 - 1`` from ``V [R+1,
    k, k]`` int32; writes their codes into ``bp`` (uint8, the plan's
    layout) and returns the last V."""
    R1 = V.shape[0]
    for t in range(t0, t1):
        c = candidates(dev, t)
        V, win = transition_ref(dev, t, V, c)
        code = (c["p"] * int(dev.desc[t, P]) + c["q"])[win.clamp(min=0)]
        dst = _codes(bp, dev.desc[t], R1)
        dst.copy_(torch.where(win >= 0, code, 0).to(dst.dtype))
    return V


@functools.cache
def _smem_optin(index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = kernels.lib().dg_vertex_smem_optin(ctypes.addressof(out))
    kernels.raise_on_error(rc, "dg_vertex_smem_optin")
    return out.value


# the H100's opt-in shared memory a block, the budget of a CPU run's cuts
SMEM_OPTIN_CPU = 232_448


def smem_budget(device) -> int:
    """The shared memory a block may opt in to on ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, asked once a card; on
    the CPU ``SMEM_OPTIN_CPU``): the budget of ``plan_launches``."""
    device = torch.device(device)
    if device.type == "cpu":
        return SMEM_OPTIN_CPU
    return _smem_optin(device.index if device.index is not None
                       else torch.cuda.current_device())


def launch_cut(dev: DevTables, t0: int, t1: int, R1: int,
               with_sh: bool) -> np.ndarray:
    """``plan_launches`` of transitions ``t0 .. t1 - 1`` on ``dev``'s card,
    its rows' transitions absolute (``[n, 3]`` int64, contiguous). Span
    ``fused.cut``."""
    with timing.span("fused.cut"):
        cut = plan_launches(dev.desc[t0:t1], R1, with_sh,
                            smem_budget(dev.device))
        cut[:, :2] += t0
        return np.ascontiguousarray(cut)


def check_tables(dev: DevTables) -> None:
    """The run kernel copies the tables in 16-byte-aligned spans."""
    for name in ("pred", "deg", "masks"):
        kernels.check_aligned(getattr(dev, name), name)


def _launch_forward(dev, t0, t1, V, bp):
    """``(the last V, launches)`` after K13 over ``t0 .. t1 - 1`` (the V a
    view of one of two state buffers)."""
    R1 = V.shape[0]
    kernels.check_tensor(V, "V", torch.int32, None, dev.device)
    kernels.check_tensor(bp, "bp", torch.uint8, None, dev.device)
    check_tables(dev)
    cut = launch_cut(dev, t0, t1, R1, False)
    kmax = int(dev.desc[t0:t1, K2].max())
    buf = torch.empty((2, R1 * max(kmax * kmax, V[0].numel())),
                      dtype=torch.int32, device=V.device)
    buf[0, :V.numel()] = V.reshape(-1)
    rc = kernels.lib().dg_fused_forward(
        dev.desc.ctypes.data, dev.desc_dev.data_ptr(), cut.ctypes.data,
        len(cut), R1, dev.pred.data_ptr(), dev.deg.data_ptr(),
        dev.masks.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(),
        bp.data_ptr(), kernels.stream_of(V))
    kernels.raise_on_error(rc, "fused_forward")
    k2 = int(dev.desc[t1 - 1, K2])
    return buf[len(cut) % 2, :R1 * k2 * k2].view(R1, k2, k2), len(cut)


def fused_forward(dev: DevTables, t0: int, t1: int, V: torch.Tensor,
                  bp: torch.Tensor) -> torch.Tensor:
    """K13 over transitions ``t0 .. t1 - 1`` (the launches of
    ``launch_cut``; the count grows by their number). CPU tensors take
    ``fused_forward_ref``."""
    if t1 <= t0:
        return V
    if V.device.type == "cpu":
        return fused_forward_ref(dev, t0, t1, V, bp)
    out, n = _launch_forward(dev, t0, t1, V.contiguous(), bp)
    fused_forward.launches += n
    return out


def fused_trace_ref(dev: DevTables, bp: torch.Tensor, R: int):
    """Plain version of K14: ``(rows [T, 4] int32, s_het)`` from the
    codes; row ``t`` is ``(pi, pj, wu, wv)`` of transition ``t`` on the
    path from the sink pair (0, 0) at ``r = R``, ``s_het`` the walk's own
    sum of its popcounts. ``r`` is clamped to 0, which only a walk from an
    unreachable sink needs."""
    T = dev.T
    rows = torch.zeros((T, 4), dtype=torch.int32, device=bp.device)
    i2 = j2 = 0
    r, sh = R, 0
    for t in range(T - 1, -1, -1):
        d = dev.desc[t]
        P_ = int(d[P])
        code = int(_codes(bp, d, R + 1)[r, i2, j2]) & 0xFFFFFFFF
        if P_ <= CODE16_SLOTS:
            code &= 0xFFFF
        p, q = divmod(code, P_)
        po = int(d[PRED_OFF])
        ep = int(dev.pred[po + i2 * P_ + p])
        eq = int(dev.pred[po + j2 * P_ + q])
        a, wu, b, wv = ep >> 1, ep & 1, eq >> 1, eq & 1
        _, _, _, _, _, tl, _, tr = _words(dev, t)
        sh += int(popcount((tl[a] | tl[b]) ^ (tr[i2] | tr[j2])).sum())
        rows[t] = torch.tensor([a, b, wu, wv], dtype=torch.int32)
        i2, j2, r = a, b, max(r - wu - wv, 0)
    return rows, sh


def path_shet_ref(dev: DevTables, rows: torch.Tensor) -> int:
    """Plain version of K14's recorder: ``s_het`` of a path's ``[T, 4]``
    rows, every transition at once: transition ``t``'s sources ``(a, b)``
    are its row, its destinations the next row's sources (the sink pair (0,
    0) for the last), and it adds ``popcount((Tl[a] | Tl[b]) ^ (Tr[i2] |
    Tr[j2]))`` over its colour words. An exact integer sum in any order."""
    T = dev.T
    if T == 0:
        return 0
    dv = rows.device
    d = torch.from_numpy(dev.desc).to(dv)
    k, k2, W_, mo = d[:, K], d[:, K2], d[:, W], d[:, MASK_OFF]
    src = rows[:, :2].to(torch.int64)
    dst = torch.cat([src[1:], torch.zeros((1, 2), dtype=torch.int64,
                                          device=dv)])
    t = torch.repeat_interleave(torch.arange(T, device=dv), W_)
    w = torch.arange(len(t), device=dv) - (torch.cumsum(W_, 0) - W_)[t]
    tl = mo + k * W_
    tr = tl + (k + k2) * W_
    masks = dev.masks.to(torch.int64) & 0xFFFFFFFF

    def word(plane, v):
        return masks[(plane + v * W_)[t] + w]

    x = ((word(tl, src[:, 0]) | word(tl, src[:, 1]))
         ^ (word(tr, dst[:, 0]) | word(tr, dst[:, 1])))
    return int(popcount(x).sum())


def fused_trace(dev: DevTables, bp: torch.Tensor, R: int, cycles=None):
    """K14: one launch of the staged walk (see ``fused_trace_ref``; the
    rows and ``s_het`` of ``path_shet_ref``). With ``cycles`` (int32
    ``[T]`` on the card) the walker writes its clock cycles a transition
    ``<< 1 | 1`` where the transition's code was read from shared memory.
    CPU tensors take the plain version. Span ``fused.trace``, which holds
    the host's wait for ``s_het``."""
    with timing.span("fused.trace"):
        if bp.device.type == "cpu":
            return fused_trace_ref(dev, bp, R)
        kernels.check_tensor(bp, "bp", torch.uint8, None, dev.device)
        T = dev.T
        if cycles is not None:
            kernels.check_tensor(cycles, "cycles", torch.int32, (T,),
                                 dev.device)
        rows = torch.empty((max(T, 1), 4), dtype=torch.int32,
                           device=bp.device)
        sh = torch.empty(1, dtype=torch.int32, device=bp.device)
        rc = kernels.lib().dg_fused_trace(
            dev.desc_dev.data_ptr(), T, R, dev.pred.data_ptr(),
            dev.pred.numel(), dev.masks.data_ptr(), bp.data_ptr(),
            bp.numel(), rows.data_ptr(), sh.data_ptr(),
            cycles.data_ptr() if cycles is not None else None,
            kernels.stream_of(bp))
        kernels.raise_on_error(rc, "fused_trace")
        if T:
            fused_trace.launches += 1
        return rows[:T], int(sh.item())


fused_forward.launches = 0
fused_trace.launches = 0


def path_transitions(rows: np.ndarray):
    """The ``(level, pi, pj, i2, j2, wu, wv)`` list of a path's ``[T, 4]``
    rows, level ascending (the destination of the last is the sink pair).
    Span ``fused.assemble``."""
    with timing.span("fused.assemble"):
        # the columns as lists of Python ints, zipped into rows in C; a
        # transition's destination is the next row's source
        a, b, wu, wv = np.asarray(rows).T.tolist()
        out = list(zip(range(1, len(a) + 1), a, b, a[1:] + [0], b[1:] + [0],
                       wu, wv))
    return out


def free_bytes(device: torch.device) -> int | None:
    """Bytes the card has free (None on the CPU, which sets no limit)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def check_free(need: int, device: torch.device, what: str, use: str) -> None:
    """``PlanLimit`` where a run needs more than ``free_bytes``."""
    free = free_bytes(device)
    if free is not None and need > free:
        raise PlanLimit(f"the {what} needs {need} B of device memory, past "
                        f"the {free} B free; use {use}")


class FusedDiploidDP:
    """One forward (K13) with every backpointer kept, one traceback (K14).

    Where the run needs more device memory than the card has free after
    the tables are shipped (``free_bytes``), ``PlanLimit`` before the
    forward."""

    def __init__(self, plan: FusedPlan, device="cuda"):
        self.plan = plan
        self.R = plan.R
        self.device = resolve_device(device)

    def need_bytes(self) -> int:
        """The backpointers and the two state buffers."""
        w = self.plan.vplan.widths
        return self.plan.bp_bytes + 2 * 4 * (self.R + 1) * int(
            (w.astype(np.int64) ** 2).max())

    def ship(self) -> DevTables:
        """The tables on the device; raises ``PlanLimit`` where the run
        would not fit the card's free memory. Span ``fused.ship``: the
        host's part, with no synchronise (a copy from pageable memory holds
        the host until it is staged)."""
        with timing.span("fused.ship"):
            dev = ship(self.plan.vplan, self.device, self.plan.desc)
            check_free(self.need_bytes(), self.device,
                       "fused tier's backpointers and states",
                       "--dp-backend jax or native")
        return dev

    def forward(self, dev: DevTables):
        """K13 over every transition: ``(V of the last level, codes)``.
        Span ``fused.forward``: the host's part, the launches queued."""
        with timing.span("fused.forward"):
            p = self.plan
            bp = torch.empty(max(p.bp_bytes, 1), dtype=torch.uint8,
                             device=self.device)
            V = initial_state(self.R, int(p.vplan.widths[0]), self.device)
            return fused_forward(dev, 0, p.T, V, bp), bp

    def run(self):
        if self.plan.T == 0:
            return 0, 0, []
        dev = self.ship()
        V, bp = self.forward(dev)
        value = int(V[self.R, 0, 0])
        rows, sh = fused_trace(dev, bp, self.R)
        return value, sh, path_transitions(rows.cpu().numpy())
