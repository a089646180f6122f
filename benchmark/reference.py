"""The plain reference of the diploid pair DP, and the judge of a solve.

Plain PyTorch on any device (the card in a run, the CPU in the tests). It
imports torch and numpy and nothing of the program.

The DP (``dipgenie_tpu_torch/solver/diploid.py:_forward_exact``): a state
is ``(level, r, i, j)``, a pair of vertices ``(i, j)`` of one level and a
row ``r`` in ``0..R``. Level 0 (one vertex) holds 0 at every row. A
candidate of transition ``t`` (level ``t`` to ``t + 1``) is a pair of
edges ``(e1, e2)`` out of level ``t``: from ``(i, j) = (src e1, src e2)``
at row ``r`` to ``(dst e1, dst e2)`` at row ``r + w1 + w2 <= R``, adding

    score = popcount((H[u1] | H[v1]) & (H[u2] | H[v2]))
          + popcount((T[u1] | T[v1]) ^ (T[u2] | T[v2]))

(``H`` / ``T`` a vertex's HOM / HET colours, ``u1, v1`` the sources,
``u2, v2`` the destinations; the second popcount is the candidate's
``symd``). A state keeps the largest value; among equal values the
earliest candidate in ``(i, j, e1's place in u1's edges, e2's place in
v1's edges)`` order wins. The sink's value is at row ``R``; ``s_het`` sums
``symd`` along the path the winners trace back from it.

Each state's value and winner travel as one int64 key, ``value << 32 |
(TIE_MAX - rank)``, so one ``amax`` per destination gives both (the
control, ``latest=True``, stores ``rank`` and lets the latest win). The
forward is a loop over transitions of four tensor operations; what they
index is laid out a block of transitions at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# an unreachable state: value -2^30; a score a level keeps it below 0 for
# any graph of fewer than ~10^7 levels
NEG_KEY = -(1 << 62)
LOW = (1 << 32) - 1
HIGH = -(1 << 32)  # the int64 mask of a key's value word
TIE_MAX = LOW
# candidate rows laid out at once (int64 index and values)
BLOCK_ELEMS = 1 << 27


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 (SWAR; the masks keep arithmetic shifts
    exact)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def colour_words(csr):
    """``(src_h, src_t, dst_h, dst_t)``, each ``[n, M]`` int64 (numpy): a
    vertex's HOM / HET colours as bits of transition-local words, once as
    a source of the transition out of its level and once as a destination
    of the transition into it. A transition numbers the colours found on
    its two levels from 0."""
    level_ptr, _, _, _, hom_ptr, hom, het_ptr, het = csr
    n = int(level_ptr[-1])
    L = len(level_ptr) - 1
    lvl = np.repeat(np.arange(L), np.diff(level_ptr))
    v_h = np.repeat(np.arange(n), np.diff(hom_ptr))
    v_t = np.repeat(np.arange(n), np.diff(het_ptr))
    v = np.concatenate([v_h, v_t])
    c = np.concatenate([hom, het]).astype(np.int64)
    is_h = np.concatenate([np.ones(len(v_h), bool), np.zeros(len(v_t), bool)])
    # (transition, colour) of each entry as a source and as a destination
    roles = []
    for delta in (0, 1):
        t = lvl[v] - delta
        ok = (t >= 0) & (t < L - 1)
        roles.append((v[ok], c[ok], is_h[ok], t[ok]))
    t_all = np.concatenate([r[3] for r in roles])
    c_all = np.concatenate([r[1] for r in roles])
    cmax = int(c_all.max(initial=0)) + 1
    keys = np.unique(t_all * cmax + c_all)
    kt = keys // cmax
    rank_of = np.arange(len(keys)) - np.searchsorted(kt, kt)
    M = max(1, -(-int(rank_of.max(initial=0) + 1) // 64))
    out = []
    for v_r, c_r, h_r, t_r in roles:
        rank = rank_of[np.searchsorted(keys, t_r * cmax + c_r)]
        bit = (np.uint64(1) << (rank % 64).astype(np.uint64)).view(np.int64)
        col = rank // 64
        for want in (True, False):
            words = np.zeros((n, M), np.int64)
            sel = h_r == want
            np.bitwise_or.at(words, (v_r[sel], col[sel]), bit[sel])
            out.append(words)
    return out[0], out[1], out[2], out[3]


@dataclass
class RefDP:
    """The reference's keys of every state, and what decodes them."""
    R: int
    keys: torch.Tensor  # flat: level l's [R+1, k_l^2] at off[l], one dump
    off: np.ndarray  # [L] int64
    widths: np.ndarray  # [L] int64
    level_ptr: np.ndarray
    adj_ptr: torch.Tensor
    adj_v: torch.Tensor
    adj_w: torch.Tensor
    words: tuple  # (src_h, src_t, dst_h, dst_t) on the device
    D: int  # the largest out-degree, the base of an edge's place
    latest: bool

    @property
    def L(self) -> int:
        return len(self.widths)

    def sink_key(self) -> int:
        return int(self.keys[int(self.off[-1]) + self.R])


def _edges(csr, dev):
    """``(source, destination, weight, place in its source's edges)`` of
    every edge, int64 on ``dev``."""
    adj_ptr = torch.as_tensor(np.asarray(csr[1], np.int64), device=dev)
    n = len(adj_ptr) - 1
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  adj_ptr[1:] - adj_ptr[:-1])
    place = torch.arange(len(src), device=dev) - adj_ptr[src]
    return (src, torch.as_tensor(csr[2], device=dev).to(torch.int64),
            torch.as_tensor(csr[3], device=dev).to(torch.int64), place)


def _candidates(csr, edges, t0: int, t1: int, words, D: int, latest: bool):
    """Per candidate of transitions ``t0 .. t1 - 1`` (edge pairs, level by
    level): ``(t, p, q, w, addend)``, ``p`` / ``q`` the source / destination
    pair's place in its level, ``addend`` = ``score << 32`` plus the tie
    field."""
    level_ptr, adj_ptr = csr[0], csr[1]
    src, dst, wt, place = edges
    dev = src.device
    lp = torch.as_tensor(level_ptr[t0:t1 + 2], device=dev)
    wk = lp[1:] - lp[:-1]  # widths of levels t0 .. t1
    e0 = torch.as_tensor(adj_ptr[level_ptr[t0:t1]], device=dev)
    E = torch.as_tensor(adj_ptr[level_ptr[t0 + 1:t1 + 1]], device=dev) - e0
    C = E * E
    t = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), C)
    local = torch.arange(len(t), device=dev) - (torch.cumsum(C, 0) - C)[t]
    e1 = e0[t] + local // E[t]
    e2 = e0[t] + local % E[t]
    u1, v1 = src[e1], src[e2]
    u2, v2 = dst[e1], dst[e2]
    k, k2 = wk[t], wk[t + 1]
    a, b = lp[t], lp[t + 1]
    p = (u1 - a) * k + (v1 - a)
    q = (u2 - b) * k2 + (v2 - b)
    rank = (p * D + place[e1]) * D + place[e2]
    sh, st, dh, dt = words
    hom = popcount((sh[u1] | sh[v1]) & (dh[u2] | dh[v2])).sum(1)
    symd = popcount((st[u1] | st[v1]) ^ (dt[u2] | dt[v2])).sum(1)
    tie = rank if latest else TIE_MAX - rank
    return t + t0, p, q, wt[e1] + wt[e2], ((hom + symd) << 32) + tie


def forward(csr, R: int, device, latest: bool = False) -> RefDP:
    """Every state's key (see the module docstring)."""
    dev = torch.device(device)
    level_ptr = np.asarray(csr[0], np.int64)
    adj_ptr = np.asarray(csr[1], np.int64)
    widths = np.diff(level_ptr)
    L = len(widths)
    if L < 2 or widths[0] != 1 or widths[-1] != 1:
        raise ValueError("the reference wants one source and one sink level")
    D = int(np.diff(adj_ptr).max(initial=1))
    if int(widths.max()) * D >= 1 << 16:
        raise ValueError("a candidate's rank would not fit 32 bits")
    R1 = R + 1
    S = widths * widths
    off = np.zeros(L + 1, np.int64)
    np.cumsum(R1 * S, out=off[1:])
    dump = int(off[-1])
    keys = torch.full((dump + 1,), NEG_KEY, dtype=torch.int64, device=dev)
    keys[:R1] = 0
    words = tuple(torch.as_tensor(x, device=dev) for x in colour_words(csr))
    E = np.diff(adj_ptr[level_ptr[:-1]])[:L - 1]  # edges out of each level
    C = E * E
    rows = torch.arange(R1, device=dev)
    edges = _edges(csr, dev)
    views = [v.view(R1, -1) for v in keys[:dump].split((R1 * S).tolist())]
    t0 = 0
    while t0 < L - 1:
        t1, n_el = t0, 0
        while t1 < L - 1 and (t1 == t0 or n_el + R1 * C[t1] <= BLOCK_ELEMS):
            n_el += R1 * int(C[t1])
            t1 += 1
        t, p, q, w, addend = _candidates(csr, edges, t0, t1, words, D, latest)
        St = torch.as_tensor(S[t0:t1], device=dev)[t - t0]
        ot = torch.as_tensor(off[t0:t1], device=dev)[t - t0]
        src_row = rows[:, None] - w[None, :]
        idx = torch.where(src_row >= 0, ot + src_row * St + p, dump)
        sizes = C[t0:t1].tolist()
        for ix, ad, qq, dst in zip(idx.split(sizes, 1), addend.split(sizes),
                                   q.expand(R1, -1).split(sizes, 1),
                                   views[t0 + 1:t1 + 1]):
            g = torch.take(keys, ix)
            g &= HIGH
            g += ad
            dst.scatter_reduce_(1, qq, g, "amax")
        del idx, t, p, q, w, addend, St, ot, src_row
        t0 = t1
    return RefDP(R=R, keys=keys, off=off[:-1], widths=widths,
                 level_ptr=level_ptr,
                 adj_ptr=torch.as_tensor(adj_ptr, device=dev),
                 adj_v=edges[1], adj_w=edges[2],
                 words=words, D=D, latest=latest)


def _decode(ref: RefDP, level: torch.Tensor, keys: torch.Tensor):
    """The winning candidate of states at ``level`` (their keys): ``(pi,
    pj, wu, wv, symd)`` of the transition into them."""
    dev = keys.device
    tie = keys & LOW
    rank = tie if ref.latest else TIE_MAX - tie
    D = ref.D
    src = level - 1
    k = torch.as_tensor(ref.widths, device=dev)[src]
    a = torch.as_tensor(ref.level_ptr, device=dev)[src]
    pair = rank // (D * D)
    pi, pj = pair // k, pair % k
    u1, v1 = a + pi, a + pj
    e1 = ref.adj_ptr[u1] + (rank // D) % D
    e2 = ref.adj_ptr[v1] + rank % D
    u2, v2 = ref.adj_v[e1], ref.adj_v[e2]
    _, st, _, dt = ref.words
    symd = popcount((st[u1] | st[v1]) ^ (dt[u2] | dt[v2])).sum(1)
    return pi, pj, ref.adj_w[e1], ref.adj_w[e2], symd


def judge(ref: RefDP, sink_value: int, s_het: int, transitions) -> dict:
    """How far one solve departs from the reference: ``sink_off`` /
    ``s_het_off`` (0 or 1) and ``steps_off``, the transitions at which the
    solve's path is not the reference's winner at the state the path has
    reached (or does not link to the next, or is missing). The path's
    states are those the solve's transitions name, rows counted down from
    ``R`` at the sink; where ``steps_off`` is 0 the path is the
    reference's, and ``s_het`` is compared with that path's sum,
    ``path_s_het`` (the reference's winners' ``symd`` at the path's
    states)."""
    T = ref.L - 1
    dev = ref.keys.device
    tr = np.asarray(transitions, np.int64).reshape(-1, 7)
    if len(tr) != T:
        return {"sink_off": int(sink_value != ref.sink_key() >> 32),
                "s_het_off": 1, "steps_off": T, "path_s_het": -1}
    tr = torch.as_tensor(tr, device=dev)
    level, pi, pj, i2, j2, wu, wv = tr.unbind(1)
    # rows: R at the last level, less each later transition's weight
    wsum = wu + wv
    r = ref.R - (torch.flip(torch.cumsum(torch.flip(wsum, [0]), 0), [0])
                 - wsum)
    nxt_i = torch.cat([pi[1:], torch.zeros(1, dtype=torch.int64, device=dev)])
    nxt_j = torch.cat([pj[1:], torch.zeros(1, dtype=torch.int64, device=dev)])
    k2 = torch.as_tensor(ref.widths, device=dev)[1:]
    off = torch.as_tensor(ref.off, device=dev)[1:]
    linked = ((level == torch.arange(1, T + 1, device=dev))
              & (i2 == nxt_i) & (j2 == nxt_j)
              & (i2 >= 0) & (i2 < k2) & (j2 >= 0) & (j2 < k2)
              & (r >= 0) & (r <= ref.R))
    at = off + r.clamp(0, ref.R) * k2 * k2 + (i2.clamp(0) % k2) * k2 \
        + j2.clamp(0) % k2
    keys = ref.keys[at]
    reach = keys >= 0
    # an unreachable state (only a wrong path reaches one) decodes as rank 0
    keys = torch.where(reach, keys, 0 if ref.latest else TIE_MAX)
    lv = torch.arange(1, T + 1, device=dev)
    rpi, rpj, rwu, rwv, symd = _decode(ref, lv, keys)
    ok = (linked & reach & (rpi == pi) & (rpj == pj) & (rwu == wu)
          & (rwv == wv))
    # the path must also start at level 0's one vertex at a row >= 0
    ok[0] = ok[0] & (pi[0] == 0) & (pj[0] == 0) & (r[0] - wsum[0] >= 0)
    path_s_het = int(symd.sum())
    return {"sink_off": int(sink_value != ref.sink_key() >> 32),
            "s_het_off": int(s_het != path_s_het),
            "steps_off": int((~ok).sum()), "path_s_het": path_s_het}


def solve(ref: RefDP):
    """``(sink_value, s_het, transitions)`` of the reference's own path,
    walked on the host from the sink (the control's answer; the judge never
    needs it)."""
    keys = ref.keys.cpu().numpy()
    T = ref.L - 1
    D = ref.D
    adj_ptr = ref.adj_ptr.cpu().numpy()
    adj_w = ref.adj_w.cpu().numpy()
    _, st, _, dt = (x.cpu().numpy() for x in ref.words)
    out = []
    i2 = j2 = 0
    r = ref.R
    sh = 0
    for lvl in range(T, 0, -1):
        k2 = int(ref.widths[lvl])
        key = int(keys[ref.off[lvl] + r * k2 * k2 + i2 * k2 + j2])
        rank = key & LOW
        if not ref.latest:
            rank = TIE_MAX - rank
        if key < 0:
            raise ValueError(f"unreachable state at level {lvl}")
        k = int(ref.widths[lvl - 1])
        pi, pj = divmod(rank // (D * D), k)
        a = int(ref.level_ptr[lvl - 1])
        e1 = int(adj_ptr[a + pi]) + (rank // D) % D
        e2 = int(adj_ptr[a + pj]) + rank % D
        wu, wv = int(adj_w[e1]), int(adj_w[e2])
        b = int(ref.level_ptr[lvl])
        x = (st[a + pi] | st[a + pj]) ^ (dt[b + i2] | dt[b + j2])
        sh += int(popcount(torch.from_numpy(x)).sum())
        out.append((lvl, pi, pj, i2, j2, wu, wv))
        i2, j2, r = pi, pj, r - wu - wv
    out.reverse()
    return ref.sink_key() >> 32, sh, out
