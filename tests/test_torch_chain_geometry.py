"""The geometry of the level-chain kernels K5b ``chain_step16`` and K7
``chain_edge`` on the CPU: the table ring's stages and parities
(``ops/chain_ring.py`` mirrors ``csrc/chain_ring.cuh``), K5b's split of the
rows over a cluster and the halo each block pushes, and numpy walks of
both kernels' index arithmetic (guard rows, the extra column, the order of
K7's edge pairs) against the plain PyTorch versions. Integer results are
compared exactly, element by element.
"""

import os
import re

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import chain_edge, chain_floor, chain_ring
from dipgenie_tpu_torch.probes import tables

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dipgenie_tpu_torch", "csrc")
R1, B, EB, P = 19, 16, 16, 4
NEG, REACH_T = tables.NEG, tables.REACH_T
W = B * B + 1  # a row of V in shared memory: 256 states and one column
D = chain_ring.RING_DEPTH
RING_LENGTHS = (1, D - 1, D, D + 1, 2 * D + 3)


def _source(name):
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("name", ["chain_step16.cu", "chain_edge.cu"])
def test_ring_depth_matches_the_source(name):
    assert re.search(r"constexpr int D = (\d+);", _source(name)).group(1) \
        == str(chain_ring.RING_DEPTH)


def test_cluster_size_matches_the_source():
    got = re.search(r"constexpr int CLUSTER = (\d+);",
                    _source("chain_step16.cu")).group(1)
    assert int(got) == chain_ring.STEP16_CLUSTER
    assert 2 <= chain_ring.STEP16_CLUSTER <= 16


@pytest.mark.parametrize("n", range(1, 17))
def test_cluster_rows_cover_every_state_once(n):
    """Block ``b`` takes rows ``[row_lo(b), row_lo(b + 1))`` and, a thread
    a destination, every (i2, j2) of them: every state (r, i2, j2) of a
    level once; ``owner`` names the block of each row; no block takes more
    than ``ceil(19 / n)`` rows."""
    seen = np.zeros((R1, B, B), np.int64)
    for b in range(n):
        lo, hi = chain_ring.row_lo(b, n), chain_ring.row_lo(b + 1, n)
        assert 0 <= hi - lo <= -(-R1 // n)
        for r in range(lo, hi):
            assert chain_ring.owner(r, n) == b
            seen[r] += 1  # the block's 256 threads, one (i2, j2) each
    assert chain_ring.row_lo(0, n) == 0 and chain_ring.row_lo(n, n) == R1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", range(1, 17))
def test_push_targets_deliver_exactly_the_halo(n):
    """Row r goes to every other block that reads it at the next level
    (rows r + 1 and r + 2 read it) and to no other."""
    for b in range(n):
        lo, hi = chain_ring.row_lo(b, n), chain_ring.row_lo(b + 1, n)
        if lo == hi:
            continue
        for x in range(max(lo - 2, 0), lo):  # the rows below block b
            assert b in chain_ring.push_targets(x, n), (n, b, x)
    for r in range(R1):
        got = chain_ring.push_targets(r, n)
        assert len(got) == len(set(got)) and chain_ring.owner(r, n) not in got
        for dst in got:
            lo, hi = chain_ring.row_lo(dst, n), chain_ring.row_lo(dst + 1, n)
            assert lo - 2 <= r < lo, (n, r, dst)


@pytest.mark.parametrize("depth", [2, 3, D])
@pytest.mark.parametrize("T", [0, *RING_LENGTHS, 5 * D + 1])
def test_ring_schedule_stages_and_parities(T, depth):
    """An emulation of the stages' barriers: a stage is refilled only after
    the barrier of the level that last used it, every level's tables are
    issued once and before its wait, and the parity a consumer waits on
    passes exactly when that level's copies have completed (a wait on the
    stage's previous use, or before the copies land, would not)."""
    holds = [None] * depth  # the level whose tables each stage holds
    phases = [0] * depth    # completed phases of each stage's barrier
    done, issued, waited = set(), [], []
    for ev in chain_ring.ring_schedule(T, depth):
        if ev[0] == "issue":
            _, t, s = ev
            assert s == t % depth and t not in issued
            assert holds[s] is None or holds[s] in done, (t, holds[s])
            assert t - depth in done or t < depth
            holds[s] = t
            issued.append(t)
            phases[s] += 1  # the copies land: one phase completes
        elif ev[0] == "wait":
            _, t, s, parity = ev
            # in the window of level t - 1's barrier, after its arrive
            assert t - 1 not in done and (t < 2 or t - 2 in done)
            waited.append(t)
            assert holds[s] == t
            # try_wait.parity(p) passes once the phase of parity p is done:
            # the barrier's current phase has the other parity
            assert phases[s] & 1 != parity
            assert (phases[s] - 1) & 1 == parity  # not before the copies
        else:
            done.add(ev[1])
    assert issued == list(range(T)) == waited and done == set(range(T))


def _wrap32(x):
    return ((x + 2**31) % 2**32) - 2**31


def _step16_cluster(pit, pwt, C, n):
    """A numpy walk of K5b as ``n`` blocks run it: each block's V buffers
    (rows r + 2 with two NEG guard rows, a NEG column 256), its rows only,
    the rows it receives from its peers, and every other row of its next
    buffer poisoned each level, so that a read outside the halo shows."""
    T = pit.shape[0]
    V = np.full((n, 2, R1 + 2, W), NEG, np.int64)
    V[:, :, 2:, 0] = 0
    bp = np.zeros((T, R1, B, B), np.int16)
    i2 = np.arange(B)[:, None]
    j2 = np.arange(B)[None, :]
    for t in range(T):
        cur, nxt = t & 1, (t + 1) & 1
        pi = pit[t, :P, :B].astype(np.int64)
        pw = pwt[t, :P, :B]
        ok = (pi >= 0) & (pi < B)
        piw = np.clip(pi, 0, B - 1)
        wt = ok & (pw[np.arange(P)[:, None], piw] > 0)
        offs, cs = [], []
        for p in range(P):
            for q in range(P):
                u, v = piw[p][i2], piw[q][j2]
                good = ok[p][i2] & ok[q][j2]
                off = np.where(good, (2 - wt[p][i2] - wt[q][j2]) * W
                               + u * B + v, 2 * W + B * B)
                offs.append(off)
                cs.append(C[t, p * B + i2, q * B + j2].astype(np.int64))
        for b in range(n):
            flat = V[b, cur].reshape(-1)
            for r in range(chain_ring.row_lo(b, n),
                           chain_ring.row_lo(b + 1, n)):
                best = np.full((B, B), -(2**31) + 1, np.int64)
                for off, c in zip(offs, cs):
                    best = np.maximum(best, _wrap32(flat[off + r * W] * 16
                                                    + c))
                value = best >> 4
                nv = np.where(value > -(2**18), value, NEG).reshape(-1)
                for dst in (b, *chain_ring.push_targets(r, n)):
                    V[dst, nxt, r + 2, :B * B] = nv
                bp[t, r] = best & 15
        for b in range(n):  # what a block neither owns nor receives
            lo, hi = chain_ring.row_lo(b, n), chain_ring.row_lo(b + 1, n)
            keep = set(range(lo, hi)) | {
                x for x in range(R1) if b in chain_ring.push_targets(x, n)}
            for r in set(range(R1)) - keep:
                V[b, nxt, r + 2, :B * B] = 123456789
    v = np.stack([V[chain_ring.owner(r, n), T & 1, r + 2, :B * B]
                  for r in range(R1)])
    return bp.reshape(T, R1 * B, B), v.reshape(R1 * B, B).astype(np.int32)


def _step16_tables(T, seed, outside):
    pit, pwt, C = tables.step16_tables(T, seed, tie_bits=True)
    if outside:
        rng = np.random.default_rng(seed + 100)
        bad = rng.random((T, P, B)) < 0.2
        pit[:, :P, :B] = np.where(
            bad, rng.choice([-1, 16, 17, -(2**31), 2**31 - 1], bad.shape),
            pit[:, :P, :B])
        pwt[:, :P, :B] = (rng.random(bad.shape) < 0.3).astype(np.int32)
    return pit, pwt, C


@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("n", [1, 3, chain_ring.STEP16_CLUSTER, 16])
def test_step16_cluster_walk_matches_plain_version(n, outside):
    """K5b's split over a cluster of ``n`` blocks, with the halo pushes and
    the folded offsets, equals ``chain_step16_ref`` on every backpointer
    and state, over a chain that wraps the ring twice (sources outside the
    block too)."""
    pit, pwt, C = _step16_tables(2 * D + 3, 7, outside)
    bp, v = _step16_cluster(pit, pwt, C, n)
    want_bp, want_v = chain_floor.chain_step16_ref(
        *(torch.from_numpy(a) for a in (pit, pwt, C)))
    assert np.array_equal(bp, want_bp.numpy())
    assert np.array_equal(v, want_v.numpy())
    assert (v > NEG).any()


def _edge_word(c, e):
    """K7's word of edge ``e`` (``csrc/chain_edge.cu:edge_word``): the row
    stage's column block (the 0 column 256 for an invalid edge) and
    weight, the column stage's source and weight."""
    rsel, valid = int(c[e, 0]) & 31, c[e, 2] > 0
    col1 = (rsel % B) * B if valid else B * B
    w1 = rsel // B if valid else 0
    return col1 | w1 << 9 | (rsel % B) << 10 | (rsel // B) << 14


def _edge_decode(c, two):
    """The producer's decode of one level (``decode``): ``desc[i] = n | l
    << 5 | word(l) << 9``, the runs' first edges from the ballot of run
    starts."""
    dst = c[:, 1]
    starts = sum(1 << e for e in range(EB) if e == 0 or dst[e] != dst[e - 1])
    desc = []
    for i in range(B):
        l, hp = int(two[i, 0]), int(two[i, 1])
        last = l & (EB - 1)
        low = starts & ((2 << last) - 1)
        n = last + 1 - (low.bit_length() - 1) if hp > 0 and 0 <= l < EB \
            else 0
        desc.append(n | last << 5 | _edge_word(c, last) << 9)
    return desc


def _pair_off(a, b):
    """The gather offset of the edge words ``a`` (row stage) and ``b``
    (column stage), row r adding r * W."""
    return ((2 - ((a >> 9) & 1) - (b >> 14)) * W
            + min((a & 511) + ((b >> 10) & 15), B * B))


def _edge_walk(tblc, tbl2c, S):
    """A numpy walk of K7's consumer threads on the producer's decode: the
    first edge pair from the two vertices' words, the others from the
    tables, offsets into V's rows r + 2 (two NEG guards; column 256 is 0
    on rows r >= 0, an invalid edge's row stage), the edge pairs with e1,
    then e2, falling, and a candidate at least as large as the best so far
    winning."""
    T = tblc.shape[0]
    V = np.full((R1 + 2, W), NEG, np.int64)
    V[2:, 0] = 0
    V[2:, B * B] = 0
    bp = np.zeros((T, R1, B * B), np.int16)
    rows = np.arange(R1) * W
    for t in range(T):
        c, s = tblc[t], S[t]
        desc = _edge_decode(c, tbl2c[t])
        Vn = V.copy()
        for i2 in range(B):
            for j2 in range(B):
                d1, d2 = desc[i2], desc[j2]
                l1, l2 = (d1 >> 5) & 15, (d2 >> 5) & 15
                n1, n2 = (d1 & 31, d2 & 31) if d1 & 31 and d2 & 31 else (0, 0)
                best = np.full(R1, -(2**31), np.int64)
                code = np.zeros(R1, np.int64)
                for k1 in range(n1):
                    for k2 in range(n2):
                        e1, e2 = l1 - k1, l2 - k2
                        if k1 or k2:
                            off = _pair_off(_edge_word(c, e1),
                                            _edge_word(c, e2))
                        else:
                            off = _pair_off(d1 >> 9, d2 >> 9)
                        add = int(s[e1, e2])
                        if add < -8192:
                            continue
                        g = V.reshape(-1)[off + rows]
                        cand = g + add
                        up = (g >= REACH_T) & (cand >= best)
                        best = np.where(up, cand, best)
                        code = np.where(up, (15 - e1) * 16 + (15 - e2), code)
                reach = best > REACH_T
                Vn[2:, i2 * B + j2] = np.where(reach, best, NEG)
                bp[t, :, i2 * B + j2] = np.where(reach, code, 0)
        V = Vn
    return bp.reshape(T, R1, B, B), V[2:, :B * B].reshape(R1, B, B)


def _edge_case(kind, T):
    if kind == "live":
        return tables.edge_tables(T, **tables.LIVE)[:5]
    if kind == "cover9":
        return tables.edge_tables(T, 22, 9)[:5]
    # invalid edges, skipped pairs and weight-1 edges on a chain that lives
    tblc, _, tbl2c, _, S, _ = tables.edge_tables(T, 35, 16)
    rng = np.random.default_rng(T)
    tblc[:, :, 2] = (rng.random((T, EB)) > 0.15).astype(np.int32)
    S[rng.random(S.shape) < 0.1] = -9000
    return (tblc, np.swapaxes(tblc, 1, 2).copy(), tbl2c,
            np.swapaxes(tbl2c, 1, 2).copy(), S)


@pytest.mark.parametrize("T", [D + 1, 2 * D + 3])
@pytest.mark.parametrize("kind", ["live", "cover9", "invalid"])
def test_edge_walk_matches_plain_version(kind, T):
    """K7's decode and gathers equal ``chain_edge_ref`` on every
    backpointer and state: runs of several edges and destinations with
    none (cover 9), the chain that stays alive, and invalid edges with
    pair scores below -8192."""
    tabs = _edge_case(kind, T)
    bp, v = _edge_walk(tabs[0], tabs[2], tabs[4])
    want_bp, want_v = chain_edge.chain_edge_ref(
        *(torch.from_numpy(a) for a in tabs))
    assert np.array_equal(bp, want_bp.numpy())
    assert np.array_equal(v, want_v.numpy())
    assert (v > NEG).any() and np.count_nonzero(bp) > 1000


@pytest.mark.parametrize("kind", ["live", "cover9", "invalid"])
def test_edge_decode_keeps_the_fields_the_kernel_reads(kind):
    """The producer's packed words against the tables: each destination
    vertex's run (its last edge, the run's length, none where it has no
    edge), and for each edge the source, the weight, and the row stage's
    column block (the 0 column for an invalid edge)."""
    tblc, _, tbl2c, _, _ = _edge_case(kind, 2 * D + 3)
    for t in range(tblc.shape[0]):
        c, two = tblc[t], tbl2c[t]
        for e in range(EB):
            word = _edge_word(c, e)
            src, w, valid = c[e, 0] % B, c[e, 0] // B, c[e, 2] > 0
            assert (word >> 10) & 15 == src and word >> 14 == w
            assert word & 511 == (src * B if valid else B * B)
            assert (word >> 9) & 1 == (w if valid else 0)
        for i, d in enumerate(_edge_decode(c, two)):
            l = int(two[i, 0])
            if l < 0:
                assert d & 31 == 0
                continue
            run = [e for e in range(EB) if c[e, 1] == c[l, 1]]
            assert (d >> 5) & 15 == l == max(run)
            assert d & 31 == len(run) and d >> 9 == _edge_word(c, l)
