"""The geometry of the level-chain kernels K5a ``chain_floor``, K5b
``chain_step16``, K6 ``chain_pair`` and K7 ``chain_edge`` on the CPU: the
table ring's stages and parities (``ops/chain_ring.py`` mirrors
``csrc/chain_ring.cuh``), K5b's split of the rows over a cluster and the
halo each block pushes, K6's decode and backpointer stages, numpy walks of
K5b's, K6's and K7's index arithmetic (guard rows, the extra column, the
order of K7's edge pairs, K6's (value, tie) compares) and of K5a's chunked
scan with its look-back, against the plain PyTorch versions. Integer
results are compared exactly, element by element.
"""

import os
import re

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import (
    chain_edge, chain_floor, chain_pair, chain_ring,
)
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


@pytest.mark.parametrize("name", ["chain_step16.cu", "chain_edge.cu",
                                  "chain_pair.cu"])
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


NP2 = chain_ring.NP2
S_BP = chain_ring.PAIR_BP_STAGES
# chain lengths around the wrap of K6's backpointer stages
BP_LENGTHS = (S_BP - 1, S_BP, S_BP + 1, 2 * S_BP + 1)


def test_pair_bp_stages_match_the_source():
    got = re.search(r"constexpr int BP_STAGES = (\d+);",
                    _source("chain_pair.cu")).group(1)
    assert int(got) == chain_ring.PAIR_BP_STAGES >= 2


def test_pair_producers_match_the_source():
    got = re.search(r"constexpr int PRODUCERS = (\d+);",
                    _source("chain_pair.cu")).group(1)
    assert int(got) == chain_ring.PAIR_PRODUCERS
    assert 8 % chain_ring.PAIR_PRODUCERS == 0


@pytest.mark.parametrize("kind", ["cover9", "ties", "one_run", "no_lane",
                                  "long_runs"])
def test_pair_decode_is_the_same_for_any_producer_split(kind):
    """The run starts carried across the producer warps (a warp with no
    start at or below a lane takes the last start of the warps before)
    equal those of one warp walking all eight rounds, also where runs
    cross the warps' quarters."""
    tbl = _pair_case(kind, 4)
    for t in range(tbl.shape[0]):
        one = chain_ring.pair_decode(tbl[t], 1)
        for n in (2, 4, 8):
            assert chain_ring.pair_decode(tbl[t], n) == one


@pytest.mark.parametrize("name,value", [
    ("CHUNK", chain_floor.FLOOR_CHUNK), ("THREADS", chain_floor.FLOOR_THREADS),
    ("LOOK", chain_floor.FLOOR_LOOK)])
def test_floor_constants_match_the_source(name, value):
    got = re.search(rf"constexpr int {name} = (\d+);",
                    _source("chain_floor.cu")).group(1)
    assert int(got) == value
    assert chain_floor.FLOOR_THREADS * 4 == chain_floor.FLOOR_LANES


@pytest.mark.parametrize("stages", [2, S_BP, 4])
@pytest.mark.parametrize("T", [0, 1, *BP_LENGTHS, *RING_LENGTHS])
def test_bp_schedule_stages_are_read_before_written(T, stages):
    """An emulation of K6's bulk stores: ``wait_group.read n`` leaves only
    the last ``n`` stores unread; the consumers write a stage only once
    the store of the level it held last has read it (counting the
    producer's waits before the barrier that lets them write), every store
    reads the level it stores, once, after that level's barrier, and every
    store has read its stage before the kernel exits."""
    holds = [None] * stages  # the level each stage holds
    issued, read, done = [], set(), set()
    last_wait = {}  # the stores read at the producer's wait before level t
    for ev in chain_ring.bp_schedule(T, stages):
        if ev[0] == "write":
            _, t, s = ev
            assert s == t % stages
            prev = holds[s]
            if prev is not None:  # the consumers write after barrier t - 1
                assert prev in last_wait.get(t - 1, set()), (t, prev)
            holds[s] = t
        elif ev[0] == "wait":
            _, t, n = ev
            read |= set(issued[:max(len(issued) - n, 0)])
            last_wait[t] = set(read)
        elif ev[0] == "barrier":
            done.add(ev[1])
        else:
            _, t, s = ev
            assert t in done and holds[s] == t and t not in issued
            issued.append(t)
    assert issued == list(range(T)) and read == set(issued)


def _pair_walk(tbl):
    """A numpy walk of K6 on the producer's decode (``pair_decode``): a
    consumer a destination pair over all 19 rows, the run's last lane from
    the second pass and the others from the first, gathers at offsets into V's
    rows r + 2 (two NEG guard rows), the candidate that is larger in value,
    then in tie, winning in 32-bit compares, the sum wrapping as int32."""
    T = tbl.shape[0]
    V = np.full((R1 + 2) * NP2, NEG, np.int64)
    V[2 * NP2::NP2] = 0  # lane 0 of every row r >= 0
    bp = np.zeros((T, chain_pair.BP_ROWS, NP2), np.int16)
    rows = np.arange(R1) * NP2
    for t in range(T):
        lane, pre = chain_ring.pair_decode(tbl[t])
        Vn = V.copy()
        for d in range(NP2):
            head, off0, tie0, add0 = pre[d]
            n, last = head & 511, head >> 9
            best = np.full(R1, -(2**31), np.int64)
            code = np.full(R1, -1, np.int64)
            for k in range(n):
                e = last - k
                off, tk, add = (off0, tie0, add0) if k == 0 else lane[e][1:]
                g = V[off + rows]
                cand = _wrap32(g + add)
                up = (g >= REACH_T) & ((cand > best)
                                       | ((cand == best) & (tk > code)))
                best = np.where(up, cand, best)
                code = np.where(up, tk, code)
            reach = best > REACH_T
            Vn[2 * NP2 + rows + d] = np.where(reach, best, NEG)
            bp[t, :R1, d] = np.where(reach, code, 0)
        V = Vn
    return bp, V[2 * NP2:].reshape(R1, NP2).astype(np.int32)


def _pair_case(kind, T):
    """K6's tables: the probes' chains, ties permuted at random, one run of
    all 256 lanes, and destinations without a lane."""
    if kind == "cover9":
        return tables.pair_tables(T, 29, 9)[0]
    if kind == "cover16":
        return tables.pair_tables(T, 35, 16)[0]
    if kind == "live":
        return tables.pair_tables(T, **tables.LIVE)[0]
    rng = np.random.default_rng(T)
    if kind == "ties":  # visiting order cannot decide a winner
        tbl = tables.pair_tables(T, 29, 9)[0]
        for t in range(T):
            tbl[t, 2] = rng.permutation(NP2)
        return tbl
    if kind == "one_run":  # every lane in one run; some pairs take none
        tbl = tables.pair_tables(T, **tables.LIVE)[0]
        tbl[:, 3] = 7
        tbl[:, 4] = np.where(rng.random((T, NP2)) < 0.5, NP2 - 1, -1)
        tbl[:, 2] = [rng.permutation(NP2) for _ in range(T)]
        return tbl
    if kind == "long_runs":  # runs of 1-150 lanes across the quarters
        tbl = tables.pair_tables(T, **tables.LIVE)[0]
        for t in range(T):
            cuts = np.sort(rng.choice(np.arange(1, NP2), 5, replace=False))
            seg = np.searchsorted(cuts, np.arange(NP2), side="right")
            tbl[t, 3] = seg
            tbl[t, 4] = -1
            tbl[t, 4, :6] = [int(np.flatnonzero(seg == r)[-1])
                             for r in range(6)]
            tbl[t, 2] = rng.permutation(NP2)
            tbl[t, 0] = rng.integers(0, 6, NP2)  # from the pairs reached
        return tbl
    # "no_lane": the chain that stays alive with a fifth of its
    # destination pairs' lastE set to -1
    tbl = tables.pair_tables(T, **tables.LIVE)[0]
    tbl[:, 4] = np.where(rng.random((T, NP2)) < 0.2, -1, tbl[:, 4])
    return tbl


@pytest.mark.parametrize("T", [S_BP + 1, D + 1, 2 * D + 3, 30])
@pytest.mark.parametrize("kind", ["cover9", "cover16", "live", "ties",
                                  "no_lane"])
def test_pair_walk_matches_plain_version(kind, T):
    """K6's decode, guard-row offsets and (value, tie) compares equal
    ``chain_pair_ref`` on every backpointer and state: runs of several
    lanes and destinations with none (cover 9), one lane a destination
    (cover 16), the chain that stays alive, ties permuted at random within
    [0, 256), and lastE = -1 on the live chain."""
    tbl = _pair_case(kind, T)
    bp, v = _pair_walk(tbl)
    want_bp, want_v = chain_pair.chain_pair_ref(torch.from_numpy(tbl))
    assert np.array_equal(bp, want_bp.numpy())
    assert np.array_equal(v, want_v.numpy())
    assert np.count_nonzero(bp) > 100


@pytest.mark.parametrize("kind", ["one_run", "long_runs"])
@pytest.mark.parametrize("T", [1, 3])
def test_pair_walk_on_one_run_of_all_lanes(T, kind):
    """A level whose 256 lanes form one run, taken by half the destination
    pairs (the others have none), and levels of six long runs that cross
    the producer warps' quarters, ties permuted: the walk over the whole
    runs equals ``chain_pair_ref``."""
    tbl = _pair_case(kind, T)
    bp, v = _pair_walk(tbl)
    want_bp, want_v = chain_pair.chain_pair_ref(torch.from_numpy(tbl))
    assert np.array_equal(bp, want_bp.numpy())
    assert np.array_equal(v, want_v.numpy())
    assert (v > NEG).any() and (v == NEG).any()


@pytest.mark.parametrize("kind", ["cover9", "ties", "one_run", "no_lane"])
def test_pair_decode_keeps_the_fields_the_kernel_reads(kind):
    """The decode against the tables: every lane's word holds the first
    lane of its run of equal seg, its gather offset, tie and score, and
    each destination pair's word its run's length and last lane (length 0
    where lastE is -1) and the last lane's gather offset, tie and score."""
    tbl = _pair_case(kind, 5)
    for t in range(tbl.shape[0]):
        gidx, sc, tie, seg, laste, wsum = tbl[t, :6]
        lane, pre = chain_ring.pair_decode(tbl[t])
        for e in range(NP2):
            f = e
            while f > 0 and seg[f - 1] == seg[e]:
                f -= 1
            assert lane[e] == (f, (2 - wsum[e]) * NP2 + gidx[e], tie[e],
                               sc[e])
        for d in range(NP2):
            head, off, tk, add = pre[d]
            l = int(laste[d])
            if l < 0:
                assert head & 511 == 0
                continue
            run = [e for e in range(NP2) if seg[e] == seg[l]]
            assert head >> 9 == l == max(run) and head & 511 == len(run)
            assert off == (2 - wsum[l]) * NP2 + gidx[l]
            assert (tk, add) == (tie[l], sc[l])


def _floor_scan(tbl, seed):
    """A numpy walk of K5a's chunked scan: chunks of ``FLOOR_CHUNK``
    levels, each scanned in registers and its sum published (AGG), then a
    look-back ``FLOOR_LOOK`` chunks at a time over the chunks before it,
    adding AGG sums until an inclusive prefix (INC) is met, a window read
    again until it is set down to its first INC; then its own INC, and the
    carry added to its levels. The chunks' steps interleave in a random
    order drawn from ``seed``; the sums wrap as uint32."""
    C, L = chain_floor.FLOOR_CHUNK, chain_floor.FLOOR_LOOK
    T = tbl.shape[0]
    chunks = chain_floor.floor_chunks(T)
    x = tbl.reshape(T, chain_floor.FLOOR_LANES).view(np.uint32)
    status = [0] * chunks
    agg, inc = {}, {}
    bp = np.zeros(x.shape, np.uint32)
    acc = None
    rng = np.random.default_rng(seed)
    # per chunk: its step (0 load and AGG, 1 look-back, 2 done), carry, j
    state = {c: [0, np.zeros(x.shape[1], np.uint32), c - 1]
             for c in range(chunks)}
    while state:
        c = int(rng.choice(list(state)))
        st = state[c]
        part = x[c * C:(c + 1) * C]
        own = part.sum(0, dtype=np.uint32) if len(part) else \
            np.zeros(x.shape[1], np.uint32)
        if st[0] == 0:
            if c == 0:
                inc[0], status[0] = own, 2
                st[0] = 2
            else:
                agg[c], status[c] = own, 1
                st[0] = 1
            if st[0] == 1:
                continue
        elif st[0] == 1:
            j = st[2]
            win = [status[j - q] if j - q >= 0 else 2 for q in range(L)]
            upto = next((q + 1 for q in range(L) if win[q] == 2), L)
            if any(w == 0 for w in win[:upto]):
                continue  # not ready: read the window again later
            for q in range(upto):
                st[1] = st[1] + (inc if win[q] == 2 else agg)[j - q]
            if upto == L and win[L - 1] != 2:
                st[2] = j - L
                continue
            inc[c], status[c] = st[1] + own, 2
            st[0] = 2
        carry = st[1]
        run = np.cumsum(part, 0, dtype=np.uint32) + carry
        bp[c * C:(c + 1) * C] = run & 0x7FFF
        if c == chunks - 1:
            acc = (carry + own).view(np.int32)
        del state[c]
    return (bp.astype(np.int16).reshape(tbl.shape),
            acc.reshape(tbl.shape[1:]))


def _floor_table(T, seed):
    """Values near +-2^31 and small ones, so that the int32 sums wrap."""
    rng = np.random.default_rng(seed)
    big = rng.choice(np.array([2**31 - 1, -(2**31), 2**31 - 7, -(2**31) + 3,
                               2**30 + 5], np.int64), (T, 8, 128))
    small = rng.integers(-(1 << 20), 1 << 20, (T, 8, 128))
    return np.where(rng.random((T, 8, 128)) < 0.5, big, small).astype(np.int32)


_C = chain_floor.FLOOR_CHUNK


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("T", [0, 1, _C - 1, _C, _C + 1,
                               _C * (2 * chain_floor.FLOOR_LOOK + 3) + 5])
def test_floor_scan_matches_plain_version(T, seed):
    """K5a's chunked scan with its look-back, in two random interleavings
    of the chunks, equals ``chain_floor_ref`` on every backpointer and on
    acc, at 0 and 1 levels, around a chunk, and over enough chunks that a
    look-back reads several windows; the sums wrap."""
    tbl = _floor_table(T, seed)
    bp, acc = _floor_scan(tbl, seed)
    want_bp, want_acc = chain_floor.chain_floor_ref(torch.from_numpy(tbl))
    assert np.array_equal(bp, want_bp.numpy())
    assert np.array_equal(acc, want_acc.numpy())
    if T > _C:  # the int32 sums did wrap
        acc64 = tbl.astype(np.int64).sum(0)
        assert (acc64 != acc).any()
