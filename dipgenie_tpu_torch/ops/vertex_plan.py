"""Per-vertex transition tables of the fused and chunked DP tiers.

The port's copy of ``Transition`` and ``plan_transitions`` of
``dipgenie_tpu/ops/diploid_jax.py:48-145``: for transition ``t`` (level
``t`` to ``t + 1``, widths ``k`` and ``k2``) each destination vertex has
its predecessors in slots ``0 .. deg - 1``, sorted by predecessor index
(edges stable-sorted by destination, so parallel edges keep their
adjacency order), and every vertex of the two levels its HOM and HET
colour bitsets over the level pair's own colour universe (``W`` 32-bit
words). The score of a candidate, sources ``(a, b)`` into destinations
``(i2, j2)``, is ``popcount((Hl[a] | Hl[b]) & (Hr[i2] | Hr[j2])) +
popcount((Tl[a] | Tl[b]) ^ (Tr[i2] | Tr[j2]))``.

Unlike the JAX planner, one vectorised pass builds every transition's
tables into flat arrays (``VertexPlan``), each sized to its transition:
``[k2, P]`` slots with ``P`` the transition's largest in-degree and ``W``
its own colour words, no clamping bucket. ``plan_transitions`` gives the
JAX planner's list of ``Transition`` from them, field for field.

The port's own limits (past each, ``PlanLimit``; the native tier,
``--dp-backend native``, runs the graph):

* ``WIDTH_MAX``: a level up to 4,096 wide, the 12 bits a source index
  has in the chunked tier's packed backpointer ``pi | pj << 12 | wu << 24
  | wv << 25``;
* ``VALUE_MAX``: DP values are int32. A score is at most the number of
  distinct colours of its level pair (HOM colours count in the first
  popcount, HET in the second), so their sum over the transitions bounds
  every value;
* edge weights are 0 or 1 (a recombination), the one bit ``wu`` / ``wv``
  has in the backpointer.

Any in-degree and any number of colours plan. Backpointer memory, the last
limit, is counted by each tier before its forward (``fused.py``,
``chunked.py``).

``plan_launches`` cuts a tier's call over transitions ``t0 .. t1 - 1`` into
kernel launches (``csrc/vertex_dp.cuh``): a maximal run of narrow
transitions whose states fit shared memory is one launch of the run
kernel, every other transition one launch of the per-transition kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .pair_plan import PlanLimit

NEG = -(2**31)  # unreachable state; every reachable value is >= 0
WIDTH_MAX = 4096
VALUE_MAX = 2**31 - 1
# desc columns: the transition's shape and its offsets into the flat tables
K, K2, P, W, PRED_OFF, DEG_OFF, MASK_OFF = range(7)
BP_OFF = 7  # the fused tier's backpointer byte offset (0 in the plan's)
EDGES = 8  # the edges into the destination level (its in-degrees' sum)
DESC_COLS = 9
# the run kernel's shared memory (csrc/vertex_dp.cuh STAGES, STAGE_BYTES,
# STAGE_HEAD, RUN_FIXED, EDGES_MAX, GUARD): after the ring's barriers a
# ring of stages, a level's header, decoded edges and tables in one; two
# score tables of [E, E] int16 (E the level's edges, at most
# RUN_EDGES_MAX, as its width); then the states, a pair's R1 rows after
# RUN_GUARD unreachable ones
RUN_STAGES = 8
RUN_STAGE_BYTES = 2560
RUN_STAGE_HEAD = 1104
RUN_FIXED = 256
RUN_EDGES_MAX = 64
RUN_GUARD = 2


@dataclass
class Transition:
    k: int
    k2: int
    pred_i: np.ndarray  # [k2, P] int32
    pred_w: np.ndarray  # [k2, P] int32
    pred_m: np.ndarray  # [k2, P] bool
    Hl: np.ndarray  # [k, W] uint32
    Tl: np.ndarray
    Hr: np.ndarray  # [k2, W] uint32
    Tr: np.ndarray


@dataclass
class VertexPlan:
    """Every transition's tables, flat. Transition ``t`` holds
    ``pred[pred_off : pred_off + k2 * P]`` (``[k2, P]``, ``pi << 1 | w``,
    0 past a destination's in-degree), ``deg[deg_off : deg_off + k2]``
    and ``masks[mask_off : ...]``: ``Hl``, ``Tl`` (``[k, W]`` each), then
    ``Hr``, ``Tr`` (``[k2, W]``)."""

    widths: np.ndarray  # [L] int64
    desc: np.ndarray  # [L - 1, DESC_COLS] int64
    pred: np.ndarray  # int32
    deg: np.ndarray  # int32, one entry a vertex of levels 1 .. L-1
    masks: np.ndarray  # uint32
    value_bound: int  # no DP value exceeds it

    @property
    def T(self) -> int:
        return len(self.desc)

    def transition(self, t: int) -> Transition:
        """Transition ``t`` as the JAX planner's ``Transition``."""
        k, k2, P_, W_, po, do, mo = (int(x) for x in self.desc[t, :7])
        packed = self.pred[po:po + k2 * P_].reshape(k2, P_)
        m = self.masks[mo:mo + 2 * (k + k2) * W_]
        hl, tl, hr, tr = np.split(m, [k * W_, 2 * k * W_, (2 * k + k2) * W_])
        return Transition(
            k, k2, packed >> 1, packed & 1,
            np.arange(P_)[None, :] < self.deg[do:do + k2, None],
            hl.reshape(k, W_), tl.reshape(k, W_), hr.reshape(k2, W_),
            tr.reshape(k2, W_))


def plan_vertices(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
                  het_ptr, het_colors) -> VertexPlan:
    """The tables of every transition of a levelized CSR graph (host)."""
    level_ptr = np.asarray(level_ptr, np.int64)
    adj_ptr = np.asarray(adj_ptr, np.int64)
    adj_v = np.asarray(adj_v, np.int64)
    adj_w = np.asarray(adj_w, np.int64)
    widths = np.diff(level_ptr)
    L = len(widths)
    T = max(L - 1, 0)
    if L and int(widths.min()) < 1:
        raise ValueError("a level of width 0")
    if L and int(widths.max()) > WIDTH_MAX:
        raise PlanLimit(
            f"a level of width {int(widths.max())}, past {WIDTH_MAX} (the "
            "12 bits of a source index in a packed backpointer); use "
            "--dp-backend native")
    if len(adj_w) and not np.isin(adj_w, (0, 1)).all():
        raise PlanLimit("an edge weight other than 0 or 1 (the one bit a "
                        "weight has in a packed backpointer); use "
                        "--dp-backend native")
    n = int(level_ptr[-1]) if L else 0
    lvl = np.repeat(np.arange(L, dtype=np.int64), widths)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(adj_ptr))
    if len(adj_v) and not (lvl[adj_v] == lvl[src] + 1).all():
        raise ValueError("an edge that does not go to the next level")
    k = widths[:-1] if T else np.zeros(0, np.int64)
    k2 = widths[1:] if T else np.zeros(0, np.int64)

    # predecessor slots: edges stable-sorted by destination
    indeg = np.bincount(adj_v, minlength=n).astype(np.int64)
    P_ = (np.maximum(np.maximum.reduceat(indeg[level_ptr[1]:],
                                         level_ptr[1:-1] - level_ptr[1]), 1)
          if T else np.zeros(0, np.int64))
    pred_off = np.zeros(T + 1, np.int64)
    np.cumsum(k2 * P_, out=pred_off[1:])
    order = np.argsort(adj_v, kind="stable")
    dst, s, w = adj_v[order], src[order], adj_w[order]
    slot = np.arange(len(dst)) - np.searchsorted(dst, dst, side="left")
    t_of = lvl[dst] - 1
    pred = np.zeros(int(pred_off[-1]), np.int32)
    pred[pred_off[t_of] + (dst - level_ptr[t_of + 1]) * P_[t_of] + slot] = (
        (s - level_ptr[t_of]) << 1 | w)

    # colours: each vertex's entries go to the transition it leaves (left)
    # and the one it enters (right), over that level pair's universe
    hom_ptr = np.asarray(hom_ptr, np.int64)
    het_ptr = np.asarray(het_ptr, np.int64)
    cols = np.concatenate([np.asarray(hom_colors, np.int64),
                           np.asarray(het_colors, np.int64)])
    cv = np.concatenate([np.repeat(np.arange(n), np.diff(hom_ptr)),
                         np.repeat(np.arange(n), np.diff(het_ptr))])
    het = np.repeat([False, True], [len(hom_colors), len(het_colors)])
    left = lvl[cv] < L - 1
    right = lvl[cv] >= 1
    e_t = np.concatenate([lvl[cv][left], lvl[cv][right] - 1])
    e_c = np.concatenate([cols[left], cols[right]])
    e_v = np.concatenate([cv[left], cv[right]])
    e_het = np.concatenate([het[left], het[right]])
    e_right = np.repeat([False, True], [int(left.sum()), int(right.sum())])
    nc = int(cols.max()) + 1 if len(cols) else 1
    key = e_t * nc + e_c
    uniq = np.unique(key)
    n_uniq = np.bincount(uniq // nc, minlength=T).astype(np.int64)
    W_ = np.maximum(1, (n_uniq + 31) // 32)
    first = np.zeros(T + 1, np.int64)
    np.cumsum(n_uniq, out=first[1:])
    loc = np.searchsorted(uniq, key) - first[e_t]
    mask_off = np.zeros(T + 1, np.int64)
    np.cumsum(2 * (k + k2) * W_, out=mask_off[1:])
    # plane order Hl, Tl, Hr, Tr; a row is a vertex of its level
    rows_before = np.where(e_right, 2 * k[e_t] + e_het * k2[e_t],
                           e_het * k[e_t])
    row = e_v - level_ptr[e_t + e_right]
    word = (mask_off[e_t] + (rows_before + row) * W_[e_t] + loc // 32)
    masks = np.zeros(int(mask_off[-1]), np.uint32)
    np.bitwise_or.at(masks, word, (np.uint32(1) << (loc % 32)).astype(
        np.uint32))

    value_bound = int(n_uniq.sum())
    if value_bound > VALUE_MAX:
        raise PlanLimit(
            f"DP values may reach {value_bound}, past {VALUE_MAX} (int32); "
            "use --dp-backend native")
    desc = np.zeros((T, DESC_COLS), np.int64)
    desc[:, K], desc[:, K2], desc[:, P], desc[:, W] = k, k2, P_, W_
    desc[:, PRED_OFF] = pred_off[:-1]
    desc[:, DEG_OFF] = level_ptr[1:-1] - level_ptr[1] if T else 0
    desc[:, MASK_OFF] = mask_off[:-1]
    desc[:, EDGES] = (np.add.reduceat(indeg[level_ptr[1]:], level_ptr[1:-1]
                                      - level_ptr[1]) if T else 0)
    deg = indeg[level_ptr[1]:].astype(np.int32) if T else np.zeros(
        0, np.int32)
    return VertexPlan(widths=widths, desc=desc, pred=pred, deg=deg,
                      masks=masks, value_bound=value_bound)


def stage_bytes(desc: np.ndarray) -> np.ndarray:
    """Bytes of each transition's tables in a ring stage of the run kernel:
    the header and the decoded edges, then its slots, in-degrees and colour
    words, each copied as the 16-byte-aligned span around it (at most 16
    bytes more than its size rounded up to 16)."""
    k, k2, P_, W_ = (desc[:, c].astype(np.int64) for c in (K, K2, P, W))

    def span(nbytes):
        return (nbytes + 15) // 16 * 16 + 16

    return (RUN_STAGE_HEAD + span(4 * k2 * P_) + span(4 * k2)
            + span(8 * (k + k2) * W_))


def run_smem_bytes(kmax, R1: int, with_sh: bool):
    """Shared-memory bytes of a run kernel whose widest level is ``kmax``
    wide (``csrc/vertex_dp.cuh:run_smem``): the ring, two score tables,
    then ``[kmax * kmax, R1 + RUN_GUARD]`` states double-buffered: V
    (int32), and the level's codes (int16) for K13, or SH and the packed
    words (int32 each) with ``with_sh`` for K15."""
    kmax = np.asarray(kmax, np.int64)
    return (RUN_FIXED + RUN_STAGES * RUN_STAGE_BYTES
            + 4 * RUN_EDGES_MAX ** 2
            + (24 if with_sh else 12) * (R1 + RUN_GUARD) * kmax * kmax)


def plan_launches(desc: np.ndarray, R1: int, with_sh: bool,
                  budget: int) -> np.ndarray:
    """The kernel launches of the transitions ``desc`` (rows of a plan's
    descriptor table, in order), as ``[n, 3]`` int64 rows ``(first, end,
    kmax)`` indexing those rows, in order. A transition is narrow where its
    tables fit a ring stage, its edges and width ``RUN_EDGES_MAX`` (its
    score table) and its states, double-buffered at its wider level
    (``run_smem_bytes``), ``budget`` bytes of shared memory; a maximal run
    of consecutive narrow transitions is one launch of the run kernel
    (``kmax`` its widest level), every other transition a launch of its
    own on the per-transition kernel (``kmax`` 0)."""
    desc = np.asarray(desc, np.int64).reshape(-1, DESC_COLS)
    n = len(desc)
    if n == 0:
        return np.zeros((0, 3), np.int64)
    w = np.maximum(desc[:, K], desc[:, K2])
    narrow = ((stage_bytes(desc) <= RUN_STAGE_BYTES)
              & (desc[:, EDGES] <= RUN_EDGES_MAX)
              & (desc[:, K2] <= RUN_EDGES_MAX)
              & (run_smem_bytes(w, R1, with_sh) <= budget))
    starts = ~narrow
    starts[0] = True
    starts[1:] |= ~narrow[:-1]
    first = np.flatnonzero(starts)
    end = np.append(first[1:], n)
    kmax = np.where(narrow[first], np.maximum.reduceat(w, first), 0)
    return np.stack([first, end, kmax], 1).astype(np.int64)


def plan_transitions(*csr) -> list[Transition]:
    """The JAX planner's per-transition tables (``Transition`` list) from
    the levelized CSR arrays, with the port's limits."""
    plan = plan_vertices(*csr)
    return [plan.transition(t) for t in range(plan.T)]


@dataclass
class DevTables:
    """A plan's tables on a device: ``desc`` stays on the host too (the C
    entry points read it there to launch the per-transition kernel; the
    run kernel reads ``desc_dev``)."""

    desc: np.ndarray  # [T, DESC_COLS] int64, host
    desc_dev: torch.Tensor  # the same on the device
    pred: torch.Tensor  # int32
    deg: torch.Tensor  # int32
    masks: torch.Tensor  # int32 (the uint32 words' bits)
    widths: np.ndarray

    @property
    def T(self) -> int:
        return len(self.desc)

    @property
    def device(self) -> torch.device:
        return self.pred.device


def ship(plan: VertexPlan, device, desc: np.ndarray | None = None
         ) -> DevTables:
    """Copy the plan's tables to ``device`` (``desc`` replaces the plan's
    own, for the fused tier's backpointer column)."""
    desc = plan.desc if desc is None else desc

    def put(a):
        # at least one element, so that every table has an address
        a = np.ascontiguousarray(a) if len(a) else np.zeros(1, a.dtype)
        return torch.from_numpy(a).to(device)

    return DevTables(desc=np.ascontiguousarray(desc),
                     desc_dev=put(desc.reshape(-1)).view(-1, DESC_COLS)
                     if len(desc) else put(np.zeros(DESC_COLS, np.int64)),
                     pred=put(plan.pred), deg=put(plan.deg),
                     masks=put(plan.masks.view(np.int32)),
                     widths=plan.widths)


def initial_state(R: int, k0: int, device) -> torch.Tensor:
    """V before transition 0: NEG except the source pair (0, 0)."""
    v = torch.full((R + 1, k0, k0), NEG, dtype=torch.int32, device=device)
    v[:, 0, 0] = 0
    return v


# ---------------- the plain transition, shared by K13 and K15 ------------

def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a 32-bit word."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _words(dev: DevTables, t: int):
    """(k, k2, P, W, Hl, Tl, Hr, Tr) of transition ``t``, the masks as
    int64 ``[rows, W]``."""
    k, k2, P_, W_, _, _, mo = (int(x) for x in dev.desc[t, :7])
    m = dev.masks[mo:mo + 2 * (k + k2) * W_].to(torch.int64) & 0xFFFFFFFF
    hl, tl, hr, tr = torch.split(m, [k * W_, k * W_, k2 * W_, k2 * W_])
    return (k, k2, P_, W_, hl.view(k, W_), tl.view(k, W_), hr.view(k2, W_),
            tr.view(k2, W_))


def candidates(dev: DevTables, t: int) -> dict:
    """Every real candidate of transition ``t``: a destination pair and a
    real slot of each, ``(i2, j2, p, q, a, b, wu, wv, score, symd)`` as 1-D
    int64 tensors, in preference order (destination pair, then source
    pair ``(a, b)``, then slot pair: among equal values the first wins,
    which is the exact tier's order, parallel edges included)."""
    k, k2, P_, W_, hl, tl, hr, tr = _words(dev, t)
    po, do = int(dev.desc[t, PRED_OFF]), int(dev.desc[t, DEG_OFF])
    pred = dev.pred[po:po + k2 * P_].view(k2, P_).to(torch.int64)
    deg = dev.deg[do:do + k2].to(torch.int64)
    dst, slot = torch.nonzero(
        torch.arange(P_, device=deg.device)[None, :] < deg[:, None],
        as_tuple=True)
    e = pred[dst, slot]
    E = len(e)
    if E >= 1 << 16:
        raise ValueError(f"transition {t}: {E} edges into one level; the "
                         "plain version ranks up to 2^32 candidates")
    e1 = torch.arange(E, device=e.device).repeat_interleave(E)
    e2 = torch.arange(E, device=e.device).repeat(E)
    c = {"i2": dst[e1], "j2": dst[e2], "p": slot[e1], "q": slot[e2],
         "a": e[e1] >> 1, "b": e[e2] >> 1, "wu": e[e1] & 1, "wv": e[e2] & 1}
    order = torch.argsort(((c["i2"] * k2 + c["j2"]) * k + c["a"]) * k
                          + c["b"], stable=True)
    c = {n: x[order] for n, x in c.items()}
    hu = hl[c["a"]] | hl[c["b"]]
    tu = tl[c["a"]] | tl[c["b"]]
    hd = hr[c["i2"]] | hr[c["j2"]]
    td = tr[c["i2"]] | tr[c["j2"]]
    c["symd"] = popcount(tu ^ td).sum(-1)
    c["score"] = popcount(hu & hd).sum(-1) + c["symd"]
    return c


def transition_ref(dev: DevTables, t: int, V: torch.Tensor,
                   c: dict | None = None):
    """The plain transition: from ``V [R+1, k, k]`` int32, ``(V' [R+1, k2,
    k2] int32, win)`` with ``win`` the winning candidate's index into
    ``c = candidates(dev, t)`` for each state (``[R+1, k2, k2]`` int64, -1
    where no candidate reaches it, and there ``V' = NEG``). A candidate
    counts at row ``r`` where ``r >= wu + wv`` and its source ``V[r - wu -
    wv, a, b]`` is reachable; the largest ``V + score`` wins, ties to the
    first in preference order."""
    c = candidates(dev, t) if c is None else c
    R1, k, _ = V.shape
    k2 = int(dev.desc[t, K2])
    n = len(c["a"])
    rows = torch.arange(R1, device=V.device)[:, None]
    src = rows - (c["wu"] + c["wv"])[None, :]
    flat = V.reshape(R1, k * k).to(torch.int64)
    val = flat[src.clamp(min=0), (c["a"] * k + c["b"])[None, :]]
    ok = (src >= 0) & (val >= 0)
    rank = torch.arange(n, device=V.device, dtype=torch.int64)
    keys = torch.where(ok, (val + c["score"][None, :]) << 32
                       | (0xFFFFFFFF - rank)[None, :], -1)
    out = torch.full((R1, k2 * k2), -1, dtype=torch.int64, device=V.device)
    out.scatter_reduce_(1, (c["i2"] * k2 + c["j2"])[None, :].expand(R1, -1),
                        keys, reduce="amax")
    reach = out >= 0
    Vn = torch.where(reach, out >> 32, NEG).to(torch.int32)
    win = torch.where(reach, 0xFFFFFFFF - (out & 0xFFFFFFFF), -1)
    return Vn.view(R1, k2, k2), win.view(R1, k2, k2)
