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

Over a tp mesh (``DeviceDiploidDP(mesh=)``, the counterpart of the JAX
tier's ``mesh=``, ``:283-339``, and of ``parallel/mesh.py:90-109``;
``chunk_step_tp``) every rank runs the same host cut launch by launch. A
run of narrow transitions runs whole on every rank. A per-transition
launch is split by destination pairs: rank ``d`` of ``n`` runs K15's
per-transition kernel on the pairs ``[d * S, (d + 1) * S)`` of the ``k2 *
k2`` (``S = ceil(k2 * k2 / n)``, the last share padded; ``chunk_share``),
writing V', SH' and, on replay, the packed words into a compact ``[C, R+1,
S]`` buffer; one all-gather of equal sizes over the tp group collects the
shares and one copy a plane puts them in place. So every rank holds the
same state, checkpoints and span words as the single-device tier, and
walks them with K16 as it does. (The JAX tier sharded the state's
destination rows and let XLA gather the source rows; here the state stays
replicated, and pairs balance the work better than rows.) The cut depends
on the card's shared-memory opt-in, so the ranks compare their cuts' sums
once before the forward and raise where they differ.

The resize, finalize and path-buffer steps of the JAX tier are plain
tensor code here (states sized to each level, a ``[T, 4]`` path tensor);
its timers (``measure_passes``, ``measure_forward``, for ``bench.py``)
and its throttle (a queue-depth workaround for remote TPUs) are not
ported.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..parallel.mesh import all_gather_equal
from ..utils import timing
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


def _slot(bufs, V, SH):
    """The slot of ``bufs`` that holds ``(V, SH)``, or None."""
    return next((i for i in (0, 1)
                 if V.data_ptr() == bufs[0, i].data_ptr()
                 and SH.data_ptr() == bufs[1, i].data_ptr()), None)


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
    s = _slot(bufs, V, SH)
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


def chunk_share_ref(dev: DevTables, t: int, V: torch.Tensor,
                    SH: torch.Tensor, p0: int, p1: int, words: bool = True):
    """Plain version of K15's per-transition kernel on the destination
    pairs ``[p0, p1)`` of transition ``t``'s ``k2 * k2``: ``(V', SH',
    packed words or None)`` of those pairs, each ``[R+1, p1 - p0]`` int32
    (``chunk_step_ref``'s transition restricted to the share)."""
    R1, k2 = V.shape[0], int(dev.desc[t, K2])
    bp = (torch.zeros(R1 * k2 * k2, dtype=torch.int32, device=V.device)
          if words else None)
    Vn, SHn = chunk_step_ref(dev, t, t + 1, V, SH, bp, [0])

    def cut(x):
        return x.reshape(R1, k2 * k2)[:, p0:p1]

    return cut(Vn), cut(SHn), cut(bp) if words else None


def chunk_share(dev: DevTables, t: int, V: torch.Tensor, SH: torch.Tensor,
                p0: int, p1: int, out: torch.Tensor) -> torch.Tensor:
    """K15's per-transition kernel on the destination pairs ``[p0, p1)``
    of transition ``t`` (one launch of ``dg_chunk_step_share``; the count
    grows by one where the range is not empty): V', SH' and, where ``out``
    has three planes, the packed words, state ``(r, pair)`` at ``out[:, r,
    pair - p0]`` of ``out [2 | 3, R+1, pitch]`` int32 (``pitch >= p1 -
    p0``; the elements past ``p1 - p0`` are left as they were). CPU
    tensors take ``chunk_share_ref``. Returns ``out``."""
    R1, k, k2 = V.shape[0], int(dev.desc[t, K]), int(dev.desc[t, K2])
    C, pitch = out.shape[0], out.shape[2]
    if not (0 <= p0 <= p1 <= k2 * k2 and p1 - p0 <= pitch and C in (2, 3)
            and out.shape[1] == R1):
        raise ValueError(f"chunk_share: pairs [{p0}, {p1}) of {k2 * k2} "
                         f"into out {tuple(out.shape)}")
    if V.device.type == "cpu":
        got = chunk_share_ref(dev, t, V, SH, p0, p1, C == 3)
        for c in range(C):
            out[c, :, :p1 - p0] = got[c]
        return out
    for name, x in (("V", V), ("SH", SH)):
        kernels.check_tensor(x, name, torch.int32, (R1, k, k), dev.device)
    kernels.check_tensor(out, "out", torch.int32, None, dev.device)
    if p1 == p0:
        return out
    rc = kernels.lib().dg_chunk_step_share(
        dev.desc[t].ctypes.data, dev.pred.data_ptr(), dev.deg.data_ptr(),
        dev.masks.data_ptr(), V.data_ptr(), SH.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr() if C == 3 else None, p0, p1, pitch, R1,
        kernels.stream_of(V))
    kernels.raise_on_error(rc, "chunk_share")
    chunk_share.launches += 1
    return out


def share_of(kk2: int, n: int, d: int) -> tuple[int, int, int]:
    """``(p0, p1, S)``: rank ``d`` of ``n``'s destination pairs ``[p0,
    p1)`` of ``kk2`` in equal shares of ``S`` (the last ones short or
    empty)."""
    S = -(-kk2 // n)
    p0 = min(d * S, kk2)
    return p0, min(p0 + S, kk2), S


def place(g: torch.Tensor, dest: torch.Tensor, kk2: int) -> None:
    """The gathered shares ``g [n, R+1, S]`` of one plane (rank ``d``'s
    pairs ``[d * S, (d + 1) * S)``) into ``dest``, a flat tensor holding
    ``[R+1, kk2]`` from its start: one copy for the whole shares, one for
    a short last share."""
    R1, S = g.shape[1], g.shape[2]
    full = kk2 // S
    dest.as_strided((R1, full, S), (kk2, S, 1)).copy_(
        g[:full].permute(1, 0, 2))
    rest = kk2 - full * S
    if rest:
        dest[full * S:].as_strided((R1, rest), (kk2, 1)).copy_(
            g[full, :, :rest])


def new_stats() -> dict:
    """The counters ``chunk_step_tp`` adds to: share launches (CPU or
    card), all-gathers and their bytes (the gathered tensor's). Each
    gather is a span ``chunked.tp_gather``; the host's wait for the card
    before a gather staged through host memory, ``chunked.tp_wait``."""
    return {"shares": 0, "gathers": 0, "gather_bytes": 0}


def _gather(out: torch.Tensor, mesh, stats: dict) -> torch.Tensor:
    import torch.distributed as dist

    if out.is_cuda and dist.get_backend(mesh.tp) == "gloo":
        with timing.span("chunked.tp_wait"):
            torch.cuda.current_stream(out.device).synchronize()
    with timing.span("chunked.tp_gather"):
        g = all_gather_equal(out, mesh.tp)
    stats["gathers"] += 1
    stats["gather_bytes"] += g.numel() * g.element_size()
    return g


def chunk_step_tp(dev: DevTables, t0: int, t1: int, V: torch.Tensor,
                  SH: torch.Tensor, mesh, bp=None, bp_off=None, bufs=None,
                  cut=None, stats: dict | None = None):
    """K15 over transitions ``t0 .. t1 - 1`` on this rank of ``mesh``'s tp
    group: the launches of ``cut`` (``fused.launch_cut`` of the range
    where None), one at a time. A run (``kmax > 0``) runs whole
    (``chunk_step`` on its one-row cut); a per-transition launch runs on
    this rank's share of the destination pairs (``share_of``,
    ``chunk_share``) and one all-gather over ``mesh.tp`` collects the
    shares, which ``place`` puts into the state buffers (and the words
    into ``bp`` at ``bp_off``). Returns ``(V, SH)`` and leaves ``bp`` the
    same on every rank, equal to ``chunk_step``'s. ``bufs`` as for
    ``chunk_step`` (made here on the card where None). CPU tensors take
    the plain versions through the same split and gathers. ``stats``
    (``new_stats``) counts shares and gathers. A failed launch or
    collective raises."""
    if t1 <= t0:
        return V, SH
    R1 = V.shape[0]
    stats = new_stats() if stats is None else stats
    if cut is None:
        cut = launch_cut(dev, t0, t1, R1, True)
    if bp is not None:
        bp_off = np.ascontiguousarray(bp_off, np.int64)
        if len(bp_off) != t1 - t0:
            raise ValueError("chunk_step_tp: one bp offset a transition")
    need = R1 * int(max(dev.desc[t0:t1, K2].max() ** 2, V[0].numel()))
    if bufs is None and V.device.type == "cuda":
        bufs = torch.empty((2, 2, need), dtype=torch.int32, device=V.device)
    elif bufs is not None and bufs.shape[2] < need:
        raise ValueError(f"chunk_step_tp: bufs {tuple(bufs.shape)}, want "
                         f"[2, 2, >= {need}]")
    n, d = mesh.n_tp, mesh.tp_rank
    C = 2 if bp is None else 3
    wide = cut[cut[:, 2] == 0, 0]
    S_max = max((share_of(int(dev.desc[t, K2]) ** 2, n, d)[2] for t in wide),
                default=0)
    share = torch.empty(C * R1 * S_max, dtype=torch.int32, device=V.device)
    for first, end, kmax in cut.tolist():
        off = None if bp is None else bp_off[first - t0:end - t0]
        if kmax > 0:
            V, SH = chunk_step(dev, first, end, V.contiguous(),
                               SH.contiguous(), bp, off, bufs,
                               cut=np.array([[first, end, kmax]], np.int64))
            continue
        k2 = int(dev.desc[first, K2])
        kk2 = k2 * k2
        p0, p1, S = share_of(kk2, n, d)
        out = share[:C * R1 * S].view(C, R1, S)
        chunk_share(dev, first, V.contiguous(), SH.contiguous(), p0, p1, out)
        stats["shares"] += 1
        g = _gather(out, mesh, stats)
        if bufs is None:
            Vd = torch.empty(R1 * kk2, dtype=torch.int32, device=V.device)
            SHd = torch.empty_like(Vd)
        else:
            s = _slot(bufs, V, SH)
            o = 0 if s is None else 1 - s
            Vd, SHd = bufs[0, o, :R1 * kk2], bufs[1, o, :R1 * kk2]
        dests = [Vd, SHd] + ([bp[int(off[0]):]] if bp is not None else [])
        for c, dest in enumerate(dests):
            place(g[:, c], dest, kk2)
        V, SH = Vd.view(R1, k2, k2), SHd.view(R1, k2, k2)
    return V, SH


def check_cuts(cuts, mesh, device) -> None:
    """Raises where the ranks of ``mesh.tp`` cut the launches differently
    (the cut depends on each card's shared-memory opt-in): one all-gather
    of each rank's sum of its cuts, before the forward."""
    flat = np.ascontiguousarray(np.concatenate(cuts) if cuts
                                else np.zeros((0, 3), np.int64))
    mine = torch.tensor([zlib.crc32(flat.tobytes()), len(flat)],
                        dtype=torch.int64, device=device)
    sums = all_gather_equal(mine, mesh.tp).cpu()
    if not bool((sums == sums[0]).all()):
        raise RuntimeError(
            "the chunked tier's tp ranks cut the launches differently "
            f"(crc32, launches a rank: {sums.tolist()}); their cards differ "
            "in shared memory a block")


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
chunk_share.launches = 0
chunk_trace.launches = 0


class DeviceDiploidDP:
    """The chunked tier on one device: forward with checkpoints (K15),
    then per span in reverse a replay with backpointers (K15) and a walk
    (K16); one host read of the result at the end. The ops only cut the
    spans: K15 runs a span's transitions in one host call.

    With a tp ``mesh`` (``parallel.mesh``) every span goes through
    ``chunk_step_tp`` (its wide transitions split over the tp ranks, one
    all-gather each), after one check that every rank cut the launches
    alike; every rank walks and returns the same result. ``stats`` counts
    the shares and gathers (``new_stats``).

    Where the checkpoints, the largest span's backpointers and the state
    buffers (and over a mesh the share and gather buffers) need more
    device memory than the card has free after the tables are shipped
    (``fused.check_free``), ``PlanLimit`` before the forward."""

    def __init__(self, plan: VertexPlan, R: int, device="cuda",
                 ckpt_every: int = CKPT_EVERY, chunk: int = CHUNK_MAX,
                 mesh=None):
        self.plan = plan
        self.R = R
        self.device = resolve_device(device)
        self.mesh = mesh
        self.stats = new_stats()
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
        tp = 0
        if self.mesh is not None:  # a share [3, R1, S] and n of them gathered
            n = self.mesh.n_tp
            tp = 4 * 3 * R1 * -(-int((w ** 2).max()) // n) * (n + 1)
        return ckpts + spans + 4 * 2 * 4 * R1 * int((w ** 2).max()) + tp

    def _step(self, dev, t0, t1, V, SH, bp=None, bp_off=None, bufs=None,
              cut=None):
        if self.mesh is None:
            return chunk_step(dev, t0, t1, V, SH, bp, bp_off, bufs, cut=cut)
        return chunk_step_tp(dev, t0, t1, V, SH, self.mesh, bp, bp_off, bufs,
                             cut=cut, stats=self.stats)

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
        if self.mesh is not None:
            check_cuts(self.cuts, self.mesh, self.device)
        for (t0, t1), cut in zip(self.spans, self.cuts):
            # copies: the next call overwrites the buffers
            ckpts.append((V.clone(), SH.clone()))
            V, SH = self._step(dev, t0, t1, V, SH, bufs=bufs, cut=cut)
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
            self._step(dev, t0, t1, Vr, SHr, bp, woff[t0:t1] - woff[t0],
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
