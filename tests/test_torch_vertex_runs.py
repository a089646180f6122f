"""The host cut of the fused and chunked tiers' kernels
(``ops/vertex_plan.py:plan_launches``) and a numpy walk of the run
kernel's level (``csrc/vertex_dp.cuh``: the decoded edges, the score table,
a thread a state with its 32-bit compare where no destination has parallel
edges) against the plain transition; and the chunked tier's spans against
the JAX tier's checkpoints, unchanged by the cut. Everything is integers:
exact equality."""

import os
import re

import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import diploid_jax as jd
from dipgenie_tpu_torch.ops import chunked, fused, vertex_plan as vp
from dipgenie_tpu_torch.ops.vertex_plan import (
    DESC_COLS, EDGES, K, K2, P, W, initial_state, plan_launches,
    plan_vertices, run_smem_bytes, ship, stage_bytes, transition_ref,
)
from dipgenie_tpu_torch.solver.diploid import csr_arrays
from dipgenie_tpu_torch.utils import synth
from tests.test_torch_kernels_gpu import case_csr

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
SMALL_BUDGET = 120_000
CUH = os.path.join(os.path.dirname(vp.__file__), "..", "csrc",
                   "vertex_dp.cuh")


def mhc4000(n_bands=300):
    """``mhc_shaped_csr(L=4000, seed=0)``: at its default 300 bands of 12
    levels most of its levels are wide; with 10 bands it has C's share of
    wide levels (3%)."""
    return plan_vertices(*synth.mhc_shaped_csr(L=4000, seed=0,
                                               n_bands=n_bands))


def narrow_rows(desc, R1, with_sh, budget):
    """The run kernel's conditions, row by row, written out again."""
    out = []
    for d in np.asarray(desc, np.int64):
        k, k2, P_, W_, E = (int(d[c]) for c in (K, K2, P, W, EDGES))
        w = max(k, k2)
        spans = sum((b + 15) // 16 * 16 + 16
                    for b in (4 * k2 * P_, 4 * k2, 8 * (k + k2) * W_))
        states = (24 if with_sh else 12) * (R1 + vp.RUN_GUARD) * w * w
        fixed = (vp.RUN_FIXED + vp.RUN_STAGES * vp.RUN_STAGE_BYTES
                 + 4 * vp.RUN_EDGES_MAX ** 2)
        out.append(vp.RUN_STAGE_HEAD + spans <= vp.RUN_STAGE_BYTES
                   and E <= vp.RUN_EDGES_MAX and k2 <= vp.RUN_EDGES_MAX
                   and fixed + states <= budget)
    return np.array(out, bool)


def check_cut(desc, R1, with_sh, budget):
    """Every transition in exactly one launch, in order; runs of narrow
    transitions at their widest level and within the budget, maximal;
    every other transition a launch of its own. Returns the cut."""
    cut = plan_launches(desc, R1, with_sh, budget)
    n = len(desc)
    assert cut.dtype == np.int64 and cut.shape == (len(cut), 3)
    assert cut[0, 0] == 0 and cut[-1, 1] == n
    assert (cut[1:, 0] == cut[:-1, 1]).all() and (cut[:, 1] > cut[:, 0]).all()
    narrow = narrow_rows(desc, R1, with_sh, budget)
    w = np.maximum(desc[:, K], desc[:, K2])
    for i, (a, b, kmax) in enumerate(cut):
        if kmax:
            assert narrow[a:b].all() and kmax == w[a:b].max()
            assert run_smem_bytes(kmax, R1, with_sh) <= budget
            # maximal: no narrow transition next to the run
            assert a == 0 or not narrow[a - 1]
            assert b == n or not narrow[b]
        else:
            assert b == a + 1 and not narrow[a]
    return cut


@pytest.mark.parametrize("with_sh", [False, True])
@pytest.mark.parametrize("budget", [H100_OPTIN, SMALL_BUDGET])
@pytest.mark.parametrize("n_bands", [300, 10])
def test_cut_on_mhc4000(n_bands, with_sh, budget):
    """The MHC-shaped graph's 3,999 transitions: the runs the maximal ones
    the budget allows; with C's share of wide levels most transitions in a
    few runs."""
    desc = mhc4000(n_bands).desc
    cut = check_cut(desc, 19, with_sh, budget)
    runs = cut[cut[:, 2] > 0]
    covered = int((runs[:, 1] - runs[:, 0]).sum())
    assert len(runs) >= 1
    if n_bands == 10 and budget == H100_OPTIN:
        assert len(runs) < 40 and covered > 0.9 * len(desc)


@pytest.mark.parametrize("case", [0, 1, 2, 3, "mhc_slice_csr",
                                  "mhc_slice_wide_csr", "high_indegree"])
@pytest.mark.parametrize("R1", [1, 6, 19, 61])
def test_cut_on_the_test_graphs(case, R1):
    if case == "high_indegree":
        arrs = csr_arrays(*synth.high_indegree_graph())
    elif isinstance(case, int):
        arrs = synth.random_leveled_csr(case, 12, 5, 8)
    else:
        arrs, _ = case_csr(case)
    desc = plan_vertices(*arrs).desc
    for with_sh in (False, True):
        check_cut(desc, R1, with_sh, H100_OPTIN)


def narrow_desc(widths, P_=2, W_=1):
    """Descriptor rows of a chain of levels ``widths`` wide, each
    destination ``P_`` slots, ``W_`` colour words (offsets 0: the cut
    reads shapes only)."""
    widths = np.asarray(widths, np.int64)
    desc = np.zeros((len(widths) - 1, DESC_COLS), np.int64)
    desc[:, K], desc[:, K2] = widths[:-1], widths[1:]
    desc[:, P], desc[:, W] = P_, W_
    desc[:, EDGES] = widths[1:] * P_
    return desc


def test_a_wide_level_ends_a_run():
    """A 33-wide level (past both kernels' state budget at R = 18) is a
    launch of its own on each side, and cuts the narrow levels into two
    runs; 8-wide levels all round make one run."""
    widths = [1] + [8] * 20 + [33] + [8] * 20 + [1]
    for with_sh in (False, True):
        cut = check_cut(narrow_desc(widths), 19, with_sh, H100_OPTIN)
        assert cut.tolist() == [[0, 20, 8], [20, 21, 0], [21, 22, 0],
                                [22, 42, 8]]
        flat = check_cut(narrow_desc([1] + [8] * 41 + [1]), 19, with_sh,
                         H100_OPTIN)
        assert flat.tolist() == [[0, 42, 8]]


def test_edges_and_tables_end_a_run():
    """A level of more than RUN_EDGES_MAX edges, and one whose tables pass
    a ring stage, are launches of their own."""
    desc = narrow_desc([1] + [8] * 10 + [1])
    desc[4, EDGES] = vp.RUN_EDGES_MAX + 1
    desc[7, W] = 64  # 8 * 16 * 64 bytes of colour words
    assert stage_bytes(desc)[7] > vp.RUN_STAGE_BYTES
    cut = check_cut(desc, 19, False, H100_OPTIN)
    assert cut.tolist() == [[0, 4, 8], [4, 5, 0], [5, 7, 8], [7, 8, 0],
                            [8, 11, 8]]


def test_a_span_end_ends_a_run():
    """The chunked tier calls its kernels a span at a time: a run that
    crosses a span's end is two launches, one each side."""
    desc = mhc4000(10).desc
    whole = plan_launches(desc, 19, True, H100_OPTIN)
    a, b, _ = whole[np.argmax(whole[:, 1] - whole[:, 0])]
    mid = int(a + b) // 2
    left = plan_launches(desc[:mid], 19, True, H100_OPTIN)
    right = plan_launches(desc[mid:], 19, True, H100_OPTIN)
    assert left[-1, 1] == mid and left[-1, 0] == a
    assert right[0, 0] == 0 and right[0, 1] == b - mid
    assert len(left) + len(right) == len(whole) + 1


def test_R60_makes_runs_shorter():
    """At R = 60 the states of the wider narrow levels pass the budget: more
    launches, each run no longer than at R = 18, K15 (SH and words) the
    first to fall out."""
    desc = mhc4000(10).desc
    for with_sh in (False, True):
        c18 = check_cut(desc, 19, with_sh, H100_OPTIN)
        c60 = check_cut(desc, 61, with_sh, H100_OPTIN)
        assert len(c60) > len(c18)
        assert c60[:, 2].max() < c18[:, 2].max()
    assert len(plan_launches(desc, 61, True, H100_OPTIN)) > len(
        plan_launches(desc, 61, False, H100_OPTIN))


def test_budget_edge():
    """A run kernel of widest level w at R1 rows needs run_smem_bytes(w):
    at exactly that budget the levels run, one byte less they do not."""
    desc = narrow_desc([1] + [20] * 6 + [1])
    for with_sh in (False, True):
        need = int(run_smem_bytes(20, 19, with_sh))
        assert plan_launches(desc, 19, with_sh, need).tolist() == [[0, 7, 20]]
        assert (plan_launches(desc, 19, with_sh, need - 1)[:, 2] == 0).sum() \
            >= 6


def test_empty_and_one():
    assert plan_launches(np.zeros((0, DESC_COLS), np.int64), 19, False,
                         H100_OPTIN).shape == (0, 3)
    assert plan_launches(narrow_desc([1, 4]), 19, True,
                         H100_OPTIN).tolist() == [[0, 1, 4]]


def _cuh_int(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", open(CUH).read())
    return m.group(1)


def test_constants_match_the_kernel_source():
    """The cut's mirror of the run kernel's shared-memory layout."""
    ints = {n: int(_cuh_int(n)) for n in ("STAGES", "STAGE_BYTES",
                                          "RUN_FIXED", "EDGES_MAX",
                                          "GUARD")}
    assert ints == {"STAGES": vp.RUN_STAGES,
                    "STAGE_BYTES": vp.RUN_STAGE_BYTES,
                    "RUN_FIXED": vp.RUN_FIXED,
                    "EDGES_MAX": vp.RUN_EDGES_MAX, "GUARD": vp.RUN_GUARD}
    # header ints: 16, off [EDGES_MAX + 1], edge, ia, jb [EDGES_MAX] each
    head = 4 * (16 + vp.RUN_EDGES_MAX + 1 + 3 * vp.RUN_EDGES_MAX)
    assert vp.RUN_STAGE_HEAD == (head + 15) // 16 * 16
    src = open(CUH).read()
    for line in ("H_OFF = 16, H_EDGE = H_OFF + EDGES_MAX + 1;",
                 "H_IA = H_EDGE + EDGES_MAX, H_JB = H_IA + EDGES_MAX;",
                 "STAGE_HEAD = (4 * (H_JB + EDGES_MAX) + 15) / 16 * 16;"):
        assert line in src, line
    assert "enum { D_K, D_K2, D_P, D_W, D_PRED, D_DEG, D_MASK, D_BP, D_E, " \
        "DESC_COLS };" in src and DESC_COLS == 9
    assert "(sh ? 24 : 12) * (R1 + GUARD) * kmax * kmax" in src


def test_edges_column():
    """Column EDGES: the in-degrees of the destination level, summed."""
    plan = mhc4000()
    for t in range(0, plan.T, 37):
        d = plan.desc[t]
        assert d[EDGES] == plan.deg[d[5]:d[5] + d[K2]].sum()


# ---------------- a numpy walk of the run kernel's level ----------------

def decode(plan, t, RS):
    """decode() of csrc/vertex_dp.cuh: off (first edge, in-degree), edge
    (source, destination), ia, jb, and the parallel-edge flag."""
    k, k2, P_ = (int(plan.desc[t, c]) for c in (K, K2, P))
    po, do = int(plan.desc[t, 4]), int(plan.desc[t, 5])
    deg = plan.deg[do:do + k2].astype(np.int64)
    slot = plan.pred[po:po + k2 * P_].reshape(k2, P_).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    edge, ia, jb, par = [], [], [], False
    for i in range(k2):
        srcs = slot[i, :deg[i]] >> 1
        par |= bool((srcs[1:] == srcs[:-1]).any())
        for p in range(deg[i]):
            a, w = int(slot[i, p] >> 1), int(slot[i, p] & 1)
            edge.append((a, i))
            ia.append(a * k * RS - w)
            jb.append(a * RS - w)
    return first, deg, edge, np.array(ia), np.array(jb), par


def walk_level(plan, t, V, parallel=None):
    """The run kernel's level on a state V [R1, k, k]: the score table, then
    a thread a state over its pair's candidates in (p, q) order, a 32-bit
    compare without parallel edges (or where ``parallel`` is False), the
    64-bit key with them. Returns (V', codes)."""
    dev = ship(plan, "cpu")
    R1, k, _ = V.shape
    RS = R1 + vp.RUN_GUARD
    k2, P_ = int(plan.desc[t, K2]), int(plan.desc[t, P])
    first, deg, edge, ia, jb, par = decode(plan, t, RS)
    par = par if parallel is None else parallel
    _, _, _, _, hl, tl, hr, tr = vp._words(dev, t)
    hl, tl, hr, tr = (x.numpy() for x in (hl, tl, hr, tr))
    E = len(edge)
    S = np.zeros((E, E), np.int64)
    for e1, (a, i2) in enumerate(edge):
        for e2, (b, j2) in enumerate(edge):
            S[e1, e2] = sum(
                bin(int((hl[a, w] | hl[b, w]) & (hr[i2, w] | hr[j2, w])))
                .count("1")
                + bin(int((tl[a, w] | tl[b, w]) ^ (tr[i2, w] | tr[j2, w])))
                .count("1") for w in range(hl.shape[1]))
    # shared memory: [k * k, RS], GUARD rows of NEG before each pair's rows
    sm = np.full((k * k, RS), vp.NEG, np.int64)
    sm[:, vp.RUN_GUARD:] = V.numpy().reshape(R1, k * k).T
    flat = sm.reshape(-1)
    Vn = np.full((R1, k2, k2), vp.NEG, np.int64)
    codes = np.zeros((R1, k2, k2), np.int64)
    for i2 in range(k2):
        for j2 in range(k2):
            oi, oj = first[i2], first[j2]
            for r in range(R1):
                best, bkey, code = -1, -1, 0
                for p in range(deg[i2]):
                    for q in range(deg[j2]):
                        val = flat[ia[oi + p] + jb[oj + q] + vp.RUN_GUARD + r]
                        sc = val + S[oi + p, oj + q]
                        if val < 0:
                            continue
                        if par:
                            key = (sc << 24 | (4095 - edge[oi + p][0]) << 12
                                   | (4095 - edge[oj + q][0]))
                            if key > bkey:
                                bkey, code = key, p * P_ + q
                        elif sc > best:
                            best, code = sc, p * P_ + q
                val = (bkey >> 24 if bkey >= 0 else -1) if par else best
                if val >= 0:
                    Vn[r, i2, j2], codes[r, i2, j2] = val, code
    return torch.from_numpy(Vn.astype(np.int32)), codes


def plain_level(plan, t, V):
    dev = ship(plan, "cpu")
    c = vp.candidates(dev, t)
    Vn, win = transition_ref(dev, t, V, c)
    code = (c["p"] * int(plan.desc[t, P]) + c["q"])[win.clamp(min=0)]
    return Vn, torch.where(win >= 0, code, 0).numpy()


def random_state(R1, k, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 6, (R1, k, k))  # small values: many ties
    v[rng.random(v.shape) < 0.3] = vp.NEG
    return torch.from_numpy(v.astype(np.int32))


@pytest.mark.parametrize("name", ["ties", "mhc", "random"])
def test_walk_of_the_run_kernel_matches_the_plain_transition(name):
    """Every transition's level from a random state (values 0-5, so most
    states tie), the 32-bit compare taken wherever no destination has
    parallel edges: V' and codes equal the plain version's."""
    if name == "ties":
        arrs = csr_arrays(*synth.parallel_edges_graph(width=5, in_edges=14))
    elif name == "mhc":
        arrs = synth.mhc_shaped_csr(L=14, seed=3)
    else:
        arrs = synth.random_leveled_csr(7, 8, 5, 6)
    plan = plan_vertices(*arrs)
    seen = set()
    for t in range(plan.T):
        k = int(plan.desc[t, K])
        V = random_state(4, k, t)
        par = decode(plan, t, 6)[5]
        seen.add(par)
        got = walk_level(plan, t, V)
        want = plain_level(plan, t, V)
        assert torch.equal(got[0], want[0]), t
        assert np.array_equal(got[1], want[1]), t
    if name == "ties":
        assert seen == {False, True}


def test_parallel_edges_need_the_wide_key():
    """On a level whose parallel edges differ in weight the 32-bit compare
    alone can keep (a, b) over an equal (a, b') with b' < b reached through
    a later slot of a: the decode flag is what keeps the kernel exact."""
    plan = plan_vertices(*csr_arrays(*synth.parallel_edges_graph(
        width=5, in_edges=14)))
    t = next(t for t in range(plan.T) if decode(plan, t, 6)[5])
    differs = False
    for seed in range(20):
        V = random_state(4, int(plan.desc[t, K]), seed)
        want = plain_level(plan, t, V)
        assert np.array_equal(walk_level(plan, t, V)[1], want[1])
        differs |= not np.array_equal(walk_level(plan, t, V, False)[1],
                                      want[1])
    assert differs


# ---------------- the chunked tier's spans ----------------

@pytest.mark.parametrize("case", ["mhc_slice500_csr", 0, "mhc4000"])
def test_chunked_spans_match_the_jax_checkpoints(case):
    """The spans the chunked tier calls its kernels on (and the host cut
    splits no further than) are the JAX tier's: a checkpoint before ops 0,
    24, 48, ... (``diploid_jax.py:663``), each span the real transitions of
    its ops."""
    if case == "mhc4000":
        arrs = synth.mhc_shaped_csr(L=4000, seed=0)
    elif isinstance(case, int):
        arrs = synth.random_leveled_csr(case, 12, 5, 8)
    else:
        arrs, _ = case_csr(case)
    jdp = jd.DeviceDiploidDP(jd.plan_transitions(*arrs), 18)
    starts = [0] + [oi + 1 for oi in range(len(jdp.ops))
                    if (oi + 1) % jdp.ckpt_every == 0
                    and oi + 1 < len(jdp.ops)]
    ends = starts[1:] + [len(jdp.ops)]
    want = []
    for s, e in zip(starts, ends):
        rows = [r for o in jdp.ops[s:e] for r in o.rows if r >= 0]
        want.append((min(rows), max(rows) + 1))
    dp = chunked.DeviceDiploidDP(plan_vertices(*arrs), 18, "cpu")
    assert dp.spans == want
    assert chunked.CKPT_EVERY == jdp.ckpt_every == 24


def test_fused_codes_offsets_unchanged_by_the_edge_column():
    """The fused tier's code offsets stay in column BP_OFF (7)."""
    arrs, R = case_csr("mhc_slice_csr")
    plan = fused.plan_fused(*arrs, R)
    assert fused.BP_OFF == 7
    nbytes = (R + 1) * plan.desc[:, K2] ** 2 * fused.code_bytes(plan.desc[:, P])
    assert (np.diff(plan.desc[:, 7]) == (nbytes[:-1] + 3) // 4 * 4).all()
    V = initial_state(R, 1, "cpu")
    assert V.shape == (R + 1, 1, 1)
