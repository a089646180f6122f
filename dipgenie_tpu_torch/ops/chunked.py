"""The chunked DP tier (``--dp-backend jax``, the JAX CLI's flag name):
a forward that keeps state checkpoints, and a traceback that replays each
span from its checkpoint with backpointers and walks it.

Counterpart of ``DeviceDiploidDP`` of ``dipgenie_tpu/ops/diploid_jax.py``
(``:283-741``) with the same contract: ``run() -> (sink_value,
sink_s_het, transitions)``. Its peak memory is one span's backpointers
and the checkpoints, not the whole plan's backpointers (the fused tier's).

* The program (``build_program``, ``_build_program`` ``:355-387``): runs
  of small transitions (both widths <= 32, in-degree <= 4, one colour
  word) in ops of up to 512 transitions; every other transition is a
  "big" op of its own. The forward keeps ``(V, SH)`` after every
  ``ckpt_every`` = 24 ops (``:650-670``); the traceback replays the spans
  in reverse with backpointers and walks each (``:684-717``).
* K15 ``chunk_step`` (``csrc/chunk_dp.cu``; replaces ``_step_body``
  ``:177-272`` through ``_scan_fn`` ``:440-464`` and ``_big_fn``
  ``:466-484``): the launches ``vertex_plan.plan_launches`` cuts, as the
  fused tier's K13 (a run of narrow transitions in one block, V and SH in
  shared memory; a wide transition over the card), the same maximum,
  carrying ``SH`` (the winner's source SH plus its ``popcount((Tl | Tl) ^
  (Tr | Tr))``); on replay it also writes ``pi | pj << 12 | wu << 24 | wv
  << 25`` (0 at unreachable states).
* K16 ``chunk_trace`` (replaces ``_trace_fn`` ``:543-567``): the walk of
  a replayed span's packed words in reverse from a device carry ``(i2, j2,
  r)``, one launch of the staged walk of ``csrc/vertex_trace.cuh`` (a
  producer warp copies each transition's rows ``[r - 2, r]`` into shared
  memory a batch ahead of the walker). A span passes only ``(t0, t1)``:
  the widths are the descriptors on the card, the offsets one table of
  the plan (``word_offsets``), made once a traceback.

The resize, finalize and path-buffer steps of the JAX tier are plain
tensor code here (states sized to each level, a ``[T, 4]`` path tensor);
its timers (``measure_passes``, ``measure_forward``, for ``bench.py``),
its throttle (a queue-depth workaround for remote TPUs) and its sharding
helpers are not ported (a tp mesh is the next slice's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from .fused import check_free, check_tables, launch_cut, path_transitions
from .vertex_plan import (
    K, K2, P, W, DevTables, VertexPlan, candidates, initial_state, ship,
    transition_ref,
)

SMALL = (32, 4, 1)  # (width, in-degree, colour words) of a small transition
CHUNK_MAX = 512  # small transitions an op holds at most
CKPT_EVERY = 24  # ops between checkpoints


@dataclass(frozen=True)
class Op:
    kind: str  # "scan" (a run of small transitions) | "big"
    t0: int
    t1: int


def is_small(desc_row) -> bool:
    B, P_, W_ = SMALL
    return (max(int(desc_row[K]), int(desc_row[K2])) <= B
            and int(desc_row[P]) <= P_ and int(desc_row[W]) <= W_)


def build_program(desc: np.ndarray, chunk: int = CHUNK_MAX) -> list[Op]:
    """Runs of small transitions cut into ops of at most ``chunk``; every
    other transition an op of its own."""
    small = [is_small(d) for d in desc]
    ops, t, T = [], 0, len(desc)
    while t < T:
        if small[t]:
            e = t
            while e < T and small[e]:
                e += 1
            for s in range(t, e, chunk):
                ops.append(Op("scan", s, min(s + chunk, e)))
            t = e
        else:
            ops.append(Op("big", t, t + 1))
            t += 1
    return ops


def pack(c: dict, win: torch.Tensor) -> torch.Tensor:
    """Packed backpointers ``pi | pj << 12 | wu << 24 | wv << 25`` of the
    winners (0 where ``win`` is -1)."""
    w = win.clamp(min=0)
    word = c["a"][w] | c["b"][w] << 12 | c["wu"][w] << 24 | c["wv"][w] << 25
    return torch.where(win >= 0, word, 0).to(torch.int32)


def chunk_step_ref(dev: DevTables, t0: int, t1: int, V: torch.Tensor,
                   SH: torch.Tensor, bp=None, bp_off=None):
    """Plain version of K15: transitions ``t0 .. t1 - 1`` from ``(V, SH)``
    (``[R+1, k, k]`` int32 each); returns the last ``(V, SH)``. With
    ``bp`` (a flat int32 tensor) transition ``t0 + i`` writes its packed
    backpointers ``[R+1, k2, k2]`` at element ``bp_off[i]``."""
    R1 = V.shape[0]
    for i, t in enumerate(range(t0, t1)):
        c = candidates(dev, t)
        k = V.shape[1]
        Vn, win = transition_ref(dev, t, V, c)
        w = win.clamp(min=0)
        src = (torch.arange(R1, device=V.device)[:, None, None]
               - (c["wu"] + c["wv"])[w])
        sh_src = SH.reshape(-1).to(torch.int64)[
            (src.clamp(min=0) * k + c["a"][w]) * k + c["b"][w]]
        SH = torch.where(win >= 0, sh_src + c["symd"][w], 0).to(torch.int32)
        V = Vn
        if bp is not None:
            n = V.numel()
            o = int(bp_off[i])
            bp[o:o + n] = pack(c, win).reshape(-1)
    return V, SH


def state_buffers(plan: VertexPlan, R: int, device) -> torch.Tensor:
    """``[2, 2, n]`` int32: two V and two SH buffers, each ``n = (R + 1)
    * widest level ** 2``, for ``chunk_step``'s ``bufs``."""
    n = (R + 1) * int((plan.widths.astype(np.int64) ** 2).max())
    return torch.empty((2, 2, n), dtype=torch.int32, device=device)


def _launch_step(dev, t0, t1, V, SH, bp, bp_off, bufs, cut):
    R1 = V.shape[0]
    for name, x in (("V", V), ("SH", SH)):
        kernels.check_tensor(x, name, torch.int32, None, dev.device)
    check_tables(dev)
    if bp is not None:
        kernels.check_tensor(bp, "bp", torch.int32, None, dev.device)
        bp_off = np.ascontiguousarray(bp_off, np.int64)
        if len(bp_off) != t1 - t0:
            raise ValueError("chunk_step: one bp offset a transition")
        size = R1 * dev.desc[t0:t1 - 1, K2] ** 2
        if not np.array_equal(bp_off[1:], bp_off[:-1] + size):
            raise ValueError("chunk_step: bp_off must put each transition's "
                             "words right after the previous one's")
    kmax = int(dev.desc[t0:t1, K2].max())
    n = R1 * max(kmax * kmax, V[0].numel())
    if bufs is None:
        bufs = torch.empty((2, 2, n), dtype=torch.int32, device=V.device)
    elif bufs.shape[2] < n or bufs.device != V.device:
        raise ValueError(f"chunk_step: bufs {tuple(bufs.shape)}, want "
                         f"[2, 2, >= {n}] on {V.device}")
    vb, sb = bufs[0], bufs[1]
    # the states where they are when a previous call left them there
    s = next((i for i in (0, 1) if V.data_ptr() == vb[i].data_ptr()
              and SH.data_ptr() == sb[i].data_ptr()), None)
    if s is None:
        s = 0
        vb[0, :V.numel()] = V.reshape(-1)
        sb[0, :SH.numel()] = SH.reshape(-1)
    if cut is None:
        cut = launch_cut(dev, t0, t1, R1, True)
    rc = kernels.lib().dg_chunk_forward(
        dev.desc.ctypes.data, dev.desc_dev.data_ptr(), cut.ctypes.data,
        len(cut), t0, R1, dev.pred.data_ptr(), dev.deg.data_ptr(),
        dev.masks.data_ptr(), vb[s].data_ptr(), vb[1 - s].data_ptr(),
        sb[s].data_ptr(), sb[1 - s].data_ptr(),
        bp.data_ptr() if bp is not None else None,
        bp_off.ctypes.data if bp is not None else None,
        kernels.stream_of(V))
    kernels.raise_on_error(rc, "chunk_step")
    k2, last = int(dev.desc[t1 - 1, K2]), s ^ (len(cut) % 2)
    m = R1 * k2 * k2
    return (vb[last, :m].view(R1, k2, k2), sb[last, :m].view(R1, k2, k2),
            len(cut))


def chunk_step(dev: DevTables, t0: int, t1: int, V: torch.Tensor,
               SH: torch.Tensor, bp=None, bp_off=None, bufs=None, cut=None):
    """K15 over transitions ``t0 .. t1 - 1`` (the launches of ``cut``,
    ``fused.launch_cut`` of the range where it is None; the count grows by
    their number). With ``bufs``
    (``state_buffers``) the states stay in its slots from call to call:
    where ``V`` and ``SH`` are views of one slot, nothing is copied, and
    the result is views of a slot. On the card ``bp_off`` must lay the
    transitions' words out one after another (as every caller does).
    CPU tensors take ``chunk_step_ref``."""
    if t1 <= t0:
        return V, SH
    if V.device.type == "cpu":
        return chunk_step_ref(dev, t0, t1, V, SH, bp, bp_off)
    *out, n = _launch_step(dev, t0, t1, V.contiguous(), SH.contiguous(), bp,
                           bp_off, bufs, cut)
    chunk_step.launches += n
    return tuple(out)


def word_offsets(desc: np.ndarray, R1: int) -> np.ndarray:
    """``[T + 1]`` int64: each transition's first packed word where every
    transition's ``[R+1, k2, k2]`` words lie one after another (the last
    entry the total). A span ``t0 .. t1 - 1`` keeps transition ``t``'s
    words at ``woff[t] - woff[t0]`` of its buffer."""
    woff = np.zeros(len(desc) + 1, np.int64)
    np.cumsum(R1 * desc[:, K2].astype(np.int64) ** 2, out=woff[1:])
    return woff


def chunk_trace_ref(dev: DevTables, woff: torch.Tensor, t0: int, t1: int,
                    bp: torch.Tensor, carry: torch.Tensor,
                    rows: torch.Tensor) -> None:
    """Plain version of K16: walks transitions ``t1 - 1`` down to ``t0``
    from ``carry = (i2, j2, r)`` (int32 [3], updated in place), writing
    row ``t - t0`` of ``rows [t1 - t0, 4]`` int32 from transition ``t``'s
    packed word at ``(r, i2, j2)`` (its block at element ``woff[t] -
    woff[t0]`` of ``bp``, ``k2`` wide). ``r`` is clamped to 0; no packed
    word of a reachable state takes it below."""
    off = woff[t0:t1 + 1].tolist()
    i2, j2, r = (int(x) for x in carry.tolist())
    for t in range(t1 - 1, t0 - 1, -1):
        k2 = int(dev.desc[t, K2])
        word = int(bp[off[t - t0] - off[0] + (r * k2 + i2) * k2 + j2])
        a, b = word & 0xFFF, (word >> 12) & 0xFFF
        wu, wv = (word >> 24) & 1, (word >> 25) & 1
        rows[t - t0] = torch.tensor([a, b, wu, wv], dtype=torch.int32)
        i2, j2, r = a, b, max(r - wu - wv, 0)
    carry.copy_(torch.tensor([i2, j2, r], dtype=torch.int32))


def chunk_trace(dev: DevTables, woff: torch.Tensor, t0: int, t1: int,
                bp: torch.Tensor, carry: torch.Tensor, rows: torch.Tensor,
                cycles=None) -> None:
    """K16: one launch of the staged walk (see ``chunk_trace_ref``); no
    host copy. ``woff`` is ``word_offsets`` on the card. With ``cycles``
    (int32 ``[t1 - t0]``) the walker writes its clock cycles a transition
    ``<< 1 | 1`` where the transition's word was read from shared memory.
    CPU tensors take the plain version."""
    if bp.device.type == "cpu":
        return chunk_trace_ref(dev, woff, t0, t1, bp, carry, rows)
    n = t1 - t0
    if not 0 <= t0 <= t1 <= dev.T:
        raise ValueError(f"chunk_trace: transitions {t0} .. {t1} of {dev.T}")
    kernels.check_tensor(bp, "bp", torch.int32, None, dev.device)
    kernels.check_tensor(woff, "woff", torch.int64, (dev.T + 1,), dev.device)
    kernels.check_tensor(carry, "carry", torch.int32, (3,), dev.device)
    kernels.check_tensor(rows, "rows", torch.int32, (n, 4), dev.device)
    kernels.check_aligned(rows, "rows")
    if cycles is not None:
        kernels.check_tensor(cycles, "cycles", torch.int32, (n,), dev.device)
    rc = kernels.lib().dg_chunk_trace(
        dev.desc_dev.data_ptr(), woff.data_ptr(), t0, n, bp.data_ptr(),
        bp.numel(), carry.data_ptr(), rows.data_ptr(),
        cycles.data_ptr() if cycles is not None else None,
        kernels.stream_of(bp))
    kernels.raise_on_error(rc, "chunk_trace")
    if n:
        chunk_trace.launches += 1


chunk_step.launches = 0
chunk_trace.launches = 0


class DeviceDiploidDP:
    """The chunked tier on one device: forward with checkpoints (K15),
    then per span in reverse a replay with backpointers (K15) and a walk
    (K16); one host read of the result at the end. The ops only cut the
    spans: K15 runs a span's transitions in one host call.

    Where the checkpoints, the largest span's backpointers and the state
    buffers need more device memory than the card has free after the
    tables are shipped (``fused.check_free``), ``PlanLimit`` before the
    forward."""

    def __init__(self, plan: VertexPlan, R: int, device="cuda",
                 ckpt_every: int = CKPT_EVERY, chunk: int = CHUNK_MAX):
        self.plan = plan
        self.R = R
        self.device = resolve_device(device)
        self.ckpt_every = ckpt_every
        self.ops = build_program(plan.desc, chunk)
        # a checkpoint before ops 0, ckpt_every, 2 * ckpt_every, ...; span
        # i is the transitions of ops [i * ckpt_every, (i + 1) * ckpt_every)
        starts = range(0, len(self.ops), ckpt_every)
        self.spans = [(self.ops[i].t0,
                       self.ops[min(i + ckpt_every, len(self.ops)) - 1].t1)
                      for i in starts]
        self.cuts = None  # each span's launch cut, kept by the forward

    def span_bytes(self, t0: int, t1: int) -> int:
        """Packed backpointer bytes of the span ``t0 .. t1 - 1``."""
        return 4 * (self.R + 1) * int((self.plan.desc[t0:t1, K2] ** 2).sum())

    def need_bytes(self) -> int:
        """Checkpoints, the largest span's backpointers and the state
        buffers of the forward and of the replay."""
        R1, w = self.R + 1, self.plan.widths.astype(np.int64)
        ckpts = sum(2 * 4 * R1 * int(w[t0]) ** 2 for t0, _ in self.spans[1:])
        spans = max((self.span_bytes(*sp) for sp in self.spans), default=0)
        return ckpts + spans + 4 * 2 * 4 * R1 * int((w ** 2).max())

    def ship(self) -> DevTables:
        """The tables on the device; raises ``PlanLimit`` where the run
        would not fit the card's free memory."""
        dev = ship(self.plan, self.device)
        check_free(self.need_bytes(), self.device,
                   "chunked tier's checkpoints, span backpointers and states",
                   "--dp-backend native")
        return dev

    def forward(self, dev: DevTables):
        """K15 over every span (one host call a span): ``(V, SH)`` of the
        last level and each span's checkpoint ``(V, SH)``. Each span's
        launch cut is kept in ``cuts`` for the replay."""
        V = initial_state(self.R, int(self.plan.widths[0]), self.device)
        SH = torch.zeros_like(V)
        bufs = state_buffers(self.plan, self.R, self.device)
        ckpts = []
        self.cuts = [launch_cut(dev, t0, t1, self.R + 1, True)
                     for t0, t1 in self.spans]
        for (t0, t1), cut in zip(self.spans, self.cuts):
            # copies: the next call overwrites the buffers
            ckpts.append((V.clone(), SH.clone()))
            V, SH = chunk_step(dev, t0, t1, V, SH, bufs=bufs, cut=cut)
        return V, SH, ckpts

    def traceback(self, dev: DevTables, ckpts) -> torch.Tensor:
        """Each span in reverse: replay from its checkpoint with
        backpointers (K15, the forward's cut), then walk it (K16), the
        words in one buffer for the largest span. Returns the path's ``[T,
        4]`` rows; the checkpoints are used up."""
        p, R = self.plan, self.R
        rows = torch.zeros((p.T, 4), dtype=torch.int32, device=self.device)
        carry = torch.tensor([0, 0, R], dtype=torch.int32, device=self.device)
        bufs = state_buffers(p, R, self.device)
        woff = word_offsets(p.desc, R + 1)
        woff_dev = torch.from_numpy(woff).to(self.device)
        words = max((self.span_bytes(*sp) for sp in self.spans), default=4)
        bp = torch.empty(max(words // 4, 1), dtype=torch.int32,
                         device=self.device)
        for (t0, t1), cut in zip(reversed(self.spans), reversed(self.cuts)):
            Vr, SHr = ckpts.pop()
            chunk_step(dev, t0, t1, Vr, SHr, bp, woff[t0:t1] - woff[t0],
                       bufs, cut=cut)
            chunk_trace(dev, woff_dev, t0, t1, bp, carry, rows[t0:t1])
        return rows

    def run(self):
        if self.plan.T == 0:
            return 0, 0, []
        dev = self.ship()
        V, SH, ckpts = self.forward(dev)
        value, shet = V[self.R, 0, 0], SH[self.R, 0, 0]
        rows = self.traceback(dev, ckpts)
        return int(value), int(shet), path_transitions(rows.cpu().numpy())
