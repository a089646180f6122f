"""Numpy tables and the oracle of the level-chain probes.

Copies of the functions that make the tables in
``scripts/tpu_floor_probe.py``, ``scripts/tpu_pair_probe.py`` and
``scripts/tpu_edge_probe.py``: the same seed gives byte-identical tables
in both packages (``tests/test_torch_probes.py`` holds that), so a chain
run here and a chain run there are the same chain. The chain is a random
leveled graph, every level ``B = 16`` vertices wide with ``EB = 16`` edges
sorted by ``(dst, src)``, ~12% of them of weight 1, and a random score per
edge pair.

The scripts' own chain dies. Every destination has one edge from a random
source, so the set of reachable vertices either empties or fills (from seed
0 it is empty after a few levels), and every path pays ~0.24 of weight per
level out of the 18 that the rows allow, so no state of any seed is
reachable after ~200 levels. ``LIVE`` is a chain that lasts: a seed whose
vertices fill by level 24, drawn without weights (``weights=False``: the
same edges and scores, every weight 0), so that every state is reachable
from then on however long the chain. The probes time both.

``cover`` (not in the scripts, whose every destination vertex has exactly
one edge) draws only the first ``cover`` destinations one edge each and the
rest at random, so that destinations with several edges (ties) and with
none occur; ``cover = B`` draws what the scripts draw.
"""

from __future__ import annotations

import numpy as np

R1 = 19  # R + 1 rows of the state
NEG = -(2**19)  # unreachable state
REACH_T = -(2**18)  # values above this are reachable
B = 16  # vertices per level
EB = 16  # edges per level
NP2 = B * B  # pair lanes
P = 4  # predecessors per vertex of the step16 body
# a chain whose every state is reachable from level 24 on
LIVE = {"seed": 40, "weights": False}


def _level(rng, cover, weights=True):
    """One level's edges (src, dst, w) sorted by (dst, src) and its pair
    scores, drawn in the scripts' order; without ``weights`` every ``w`` is
    0 and the rest is the same draw."""
    dst = np.concatenate([np.arange(cover), rng.integers(0, B, EB - cover)])
    src = rng.integers(0, B, EB)
    w = (rng.random(EB) < 0.12 * weights).astype(np.int32)
    order = np.lexsort((src, dst))
    dst, src, w = dst[order], src[order], w[order]
    sc = rng.integers(0, 50, (EB, EB)).astype(np.int32)
    return src, dst, w, sc


def pair_tables(T: int, seed: int = 0, cover: int = B,
                weights: bool = True):
    """``(tbl [T, 8, 256] int32, hostE)`` of the pair-space chain.

    Rows of ``tbl``: 0 gidx (source pair lane), 1 score, 2 tie (larger is
    preferred), 3 seg (destination pair of the lane; lanes are sorted by
    it), 4 lastE (last lane of each destination pair, -1 if none), 5 wsum;
    rows 6-7 spare. ``hostE`` is the chain as ``chain_oracle`` takes it."""
    rng = np.random.default_rng(seed)
    tbl = np.zeros((T, 8, NP2), np.int32)
    gidx, sc, tie, seg, lastE, wsum = (tbl[:, i] for i in range(6))
    hostE = []
    for t in range(T):
        src, dst, w, s2 = _level(rng, cover, weights)
        hostE.append((src.copy(), dst.copy(), w.copy(), s2))
        # edge pairs sorted by (dstpair, e1, e2): slot order is pred order
        e1 = np.repeat(np.arange(EB), EB)
        e2 = np.tile(np.arange(EB), EB)
        dp = dst[e1] * B + dst[e2]
        po = np.lexsort((e2, e1, dp))
        e1, e2, dp = e1[po], e2[po], dp[po]
        gidx[t] = src[e1] * B + src[e2]
        wsum[t] = w[e1] + w[e2]
        sc[t] = s2[e1, e2]
        tie[t] = NP2 - 1 - np.arange(NP2)
        seg[t] = dp
        le = np.full(NP2, -1, np.int32)
        le[dp] = np.arange(NP2)  # increasing, so the last write wins
        lastE[t] = le
    return tbl, hostE


def edge_tables(T: int, seed: int = 0, cover: int = B,
                weights: bool = True):
    """``(tblc [T, 16, 8], tblr [T, 8, 16], tbl2c [T, 16, 4], tbl2r
    [T, 4, 16], S [T, 16, 16], hostE)`` of the edge-space chain, int32.

    Columns of ``tblc`` per edge: 0 ``w * B + src``, 1 dst, 2 valid;
    columns of ``tbl2c`` per destination vertex: 0 its last edge (-1 if
    none), 1 whether it has one. ``tblr`` and ``tbl2r`` are their
    transposes; ``S`` is the pair score."""
    rng = np.random.default_rng(seed)
    tblc = np.zeros((T, EB, 8), np.int32)
    tbl2c = np.zeros((T, B, 4), np.int32)
    S = np.zeros((T, EB, EB), np.int32)
    hostE = []
    for t in range(T):
        src, dst, w, sc = _level(rng, cover, weights)
        tblc[t, :, 0] = w * B + src
        tblc[t, :, 1] = dst
        tblc[t, :, 2] = 1
        laste = np.full(B, -1, np.int32)
        laste[dst] = np.arange(EB)  # increasing, so the last write wins
        tbl2c[t, :, 0] = laste
        tbl2c[t, :, 1] = (laste >= 0).astype(np.int32)
        S[t] = sc
        hostE.append((src.copy(), dst.copy(), w.copy(), sc))
    tblr = np.swapaxes(tblc, 1, 2).copy()
    tbl2r = np.swapaxes(tbl2c, 1, 2).copy()
    return tblc, tblr, tbl2c, tbl2r, S, hostE


def chain_oracle(hostE):
    """Numpy reference DP over a chain (value only): ``[19, 16, 16]``
    int64, unreached states at or below ``NEG``."""
    V = np.full((R1, B, B), NEG, np.int64)
    V[:, 0, 0] = 0
    for src, dst, w, sc in hostE:
        Vn = np.full((R1, B, B), NEG, np.int64)
        for e1 in range(EB):
            for e2 in range(EB):
                ws = w[e1] + w[e2]
                for r in range(ws, R1):
                    g = V[r - ws, src[e1], src[e2]]
                    if g <= REACH_T:
                        continue
                    c = g + sc[e1, e2]
                    if c > Vn[r, dst[e1], dst[e2]]:
                        Vn[r, dst[e1], dst[e2]] = c
        V = Vn
    return V


def committed(oracle_v):
    """The oracle's state as the kernels commit it: ``NEG`` where
    unreached."""
    return np.where(oracle_v > REACH_T, oracle_v, NEG)


def floor_tables(T: int, seed: int | None = None):
    """``tbl [T, 8, 128]`` int32 of the empty-body floor: zeros as the
    script streams them, or with a ``seed`` random values below 2^20, so
    that a comparison sees every element."""
    if seed is None:
        return np.zeros((T, 8, 128), np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 20, (T, 8, 128)).astype(np.int32)


def step16_tables(T: int, seed: int = 0, tie_bits: bool = False):
    """``(pit [T, 8, 128], pwt [T, 8, 128], C [T, 64, 64])`` int32 of the
    edge-space step body: ``pit[t, p, i]`` the ``p``-th source of vertex
    ``i``, ``pwt`` its weight, both in the corner ``[:4, :16]`` of their
    block; ``C`` the score of each (p, i2, q, j2) times 16. The script's
    ``C`` has zero low bits, so its backpointers are all 0; ``tie_bits``
    adds random low 4 bits, and then the backpointer says which (p, q)
    won."""
    rng = np.random.default_rng(seed)
    pi = rng.integers(0, B, (T, P, B)).astype(np.int32)
    pw = (rng.random((T, P, B)) < 0.12).astype(np.int32)
    C = rng.integers(0, 100, (T, P * B, P * B)).astype(np.int32) * 16
    if tie_bits:
        C += rng.integers(0, 16, C.shape).astype(np.int32)
    pit = np.zeros((T, 8, 128), np.int32)
    pit[:, :P, :B] = pi
    pwt = np.zeros((T, 8, 128), np.int32)
    pwt[:, :P, :B] = pw
    return pit, pwt, C


def scandus_tables(T: int, seed: int = 0):
    """``(PI [T, 16, 4], C [T, 64, 64])`` int32 of the ``scandus`` loop
    (``scripts/tpu_floor_probe.py:build_scandus``)."""
    rng = np.random.default_rng(seed)
    PI = rng.integers(0, B, (T, B, P)).astype(np.int32)
    C = rng.integers(0, 100, (T, P * B, P * B)).astype(np.int32)
    return PI, C
