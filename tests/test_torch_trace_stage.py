"""The tracebacks of the fused and chunked tiers as the staged walk runs
them (``csrc/vertex_trace.cuh``, K14 ``fused_trace`` and K16
``chunk_trace``), on the CPU: the recorder's ``s_het`` pass
(``fused.path_shet_ref``) against the JAX ``_trace_fn`` and against the
walk's own sum (several colour words, int32 codes, an unreachable sink,
in-degrees past 4); the walker's division of a code by its in-degree; a
numpy mirror of the producer's staged rows; the chunked tier's word
offsets against the offsets its loop computed a span, and each span's
launch cut, kept by the forward, against ``plan_launches`` run again.
Everything is integers: exact equality."""

import numpy as np
import pytest
import torch

from dipgenie_tpu_torch.ops import chunked, fused
from dipgenie_tpu_torch.ops.vertex_plan import (
    BP_OFF, K2, P, W, initial_state, plan_launches, plan_vertices, ship,
)
from dipgenie_tpu_torch.solver.diploid import csr_arrays, native_forward_csr
from dipgenie_tpu_torch.utils import synth
from tests.test_torch_fused import _jax_walk, indeg36_graph
from tests.test_torch_kernels_gpu import case_csr
from tests.test_torch_vertex_plan import random_case

BAND = 2  # csrc/vertex_trace.cuh: rows staged below the walker's r
SLOT = 6144  # ring bytes a transition


def colour_words_case():
    """Widths [1, 6, 6, 6, 1], every vertex with 8 of 120 colours: each
    level pair has more than 32 colours (W > 1)."""
    rng = np.random.default_rng(120)
    widths = [1, 6, 6, 6, 1]
    g = synth.dense_graph(rng, widths, deg=3, pw=0.3, ncolors=4)
    for v in range(sum(widths)):
        g.color[v] = sorted(int(c) for c in rng.choice(120, 8,
                                                       replace=False))
    return csr_arrays(g, [bool(x) for x in rng.random(120) < 0.3]), 3


def int32_codes_case():
    """In-degree 300 into level 2 (``test_codes_past_256_slots_are_int32``'s
    graph): that transition's codes are int32."""
    rng = np.random.default_rng(300)
    edges = [[(0, i, 0) for i in range(300)],
             [(i, j, int(rng.random() < 0.3)) for i in range(300)
              for j in range(2)],
             [(0, 0, 0), (1, 0, 1)]]
    colors = {v: [int(rng.integers(0, 5))] for v in range(304)}
    g = synth.hand_graph([1, 300, 2, 1], edges, colors)
    return csr_arrays(g, [True, False, True, False, False]), 2


def unreachable_case():
    """Every edge a recombination (weight 1) over 13 transitions at R = 3:
    no state of the sink level is reachable, and the walk follows code 0
    with r clamped at 0."""
    rng = np.random.default_rng(13)
    g = synth.dense_graph(rng, [1] + [5] * 12 + [1], deg=2, pw=1.0)
    return csr_arrays(g, [True, False] * 3), 3


SHET_CASES = {
    "colour_words": colour_words_case,
    "int32_codes": int32_codes_case,
    "unreachable_sink": unreachable_case,
    "indeg36": lambda: (csr_arrays(*indeg36_graph()), 3),
    "high_indegree": lambda: (csr_arrays(*synth.high_indegree_graph()), 3),
}


def plain_walk(arrs, R):
    """The plan, its tables on the CPU, the plain forward's codes, the
    last V, and the plain walk's ``(rows, s_het)``."""
    plan = fused.plan_fused(*arrs, R)
    dev = ship(plan.vplan, "cpu", plan.desc)
    bp = torch.zeros(plan.bp_bytes, dtype=torch.uint8)
    V0 = initial_state(R, int(plan.vplan.widths[0]), "cpu")
    V = fused.fused_forward_ref(dev, 0, plan.T, V0, bp)
    return plan, dev, bp, V, fused.fused_trace_ref(dev, bp, R)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shet_pass_matches_trace_fn(seed):
    """The recorder's pass over the plain walk's rows gives the JAX
    ``_trace_fn``'s s_het, and the walk's own sum."""
    arrs, R = random_case(seed)
    _, dev, _, _, (rows, sh) = plain_walk(arrs, R)
    jsh, jrows = _jax_walk(arrs, R)
    assert np.array_equal(rows.numpy(), jrows)
    assert fused.path_shet_ref(dev, rows) == sh == jsh


@pytest.mark.parametrize("case", sorted(SHET_CASES))
def test_shet_pass_matches_walk(case):
    """The recorder's pass equals the walk's own sum where the JAX tiers
    cannot go or do not clamp r: several colour words, int32 codes, an
    unreachable sink, in-degrees past 4."""
    arrs, R = SHET_CASES[case]()
    plan, dev, _, V, (rows, sh) = plain_walk(arrs, R)
    desc = plan.desc
    if case == "colour_words":
        assert int(desc[:, W].max()) > 1
    elif case == "int32_codes":
        assert int(desc[:, P].max()) > fused.CODE16_SLOTS
    elif case == "unreachable_sink":
        assert int(V[R, 0, 0]) < 0
    else:
        assert int(desc[:, P].max()) > 4
    if case != "unreachable_sink":
        assert int(V[R, 0, 0]) >= 0
        value, shet, _ = native_forward_csr(arrs, R)
        assert (int(V[R, 0, 0]), sh) == (value, shet)
    assert fused.path_shet_ref(dev, rows) == sh


def test_code_division_by_reciprocal():
    """The walker's p = code / P for 16-bit codes (``csrc/vertex_trace.cuh``):
    the high word of ``code * rcp`` plus ``code & pone``, with ``rcp =
    (2^32 - 1) / P + 1 = ceil(2^32 / P)`` and ``pone`` 0 for P from 2 to
    256, ``rcp`` 0 and ``pone`` all ones for P = 1: exact for every code
    below 2^16."""
    code = np.arange(1 << 16, dtype=np.uint64)
    for P_ in range(1, fused.CODE16_SLOTS + 1):
        rcp = np.uint64(0xFFFFFFFF // P_ + 1 if P_ >= 2 else 0)
        pone = np.uint64(0xFFFFFFFF if P_ == 1 else 0)
        p = ((code * rcp) >> np.uint64(32)) + (code & pone)
        assert np.array_equal(p, code // np.uint64(P_)), P_
        assert (np.uint64(0xFFFFFFFF // P_ + 1) == -(-(1 << 32) // P_)
                or P_ == 1)


def staged_block(buf: np.ndarray, base: int, off: int, row: int, hi: int,
                 nbytes: int):
    """The producer's staging of rows [hi - BAND, hi] of a block at byte
    ``off`` of a buffer at address ``base`` (``stage`` of
    ``csrc/vertex_trace.cuh``): ``(slot bytes, coff, lo)``, ``coff`` the
    slot offset of the block's element 0 modulo 2^32 (element ``x`` at
    ``coff + x * cb``), or None where the 16-byte span does not fit the
    slot or leaves the buffer."""
    lo = max(hi - BAND, 0)
    a0 = (base + off + lo * row) // 16 * 16
    a1 = -(-(base + off + (hi + 1) * row) // 16) * 16
    if a0 < -(-base // 16) * 16 or a1 > (base + nbytes) // 16 * 16:
        return None
    if a1 - a0 > SLOT:
        return None
    return buf[a0 - base:a1 - base], (base + off - a0) % (1 << 32), lo


@pytest.mark.parametrize("case,base", [("mhc_slice_csr", 0),
                                       ("mhc_slice_csr", 4),
                                       ("int32_codes", 0)])
def test_staged_rows_mirror(case, base):
    """For every transition and every r the walker can reach from a
    staging at ``hi``: the 32-bit offset ``coff + x * cb`` (``x = (r * k2 +
    i2) * k2 + j2``, wrapping as the walker's does) lands in the slot, on
    the code at ``(r, i2, j2)`` of the block, with the buffer on a 16-byte
    boundary and 4 bytes past one; int32 codes are never staged."""
    arrs, R = (int32_codes_case() if case == "int32_codes"
               else case_csr(case))
    plan, _, bp, _, _ = plain_walk(arrs, R)
    buf = bp.numpy()
    staged = 0
    for t in range(plan.T):
        k2, P_, off = (int(plan.desc[t, c]) for c in (K2, P, BP_OFF))
        cb = 2 if P_ <= fused.CODE16_SLOTS else 4
        row = k2 * k2 * cb
        codes = fused._codes(bp, plan.desc[t], R + 1).numpy()
        for hi in range(R + 1):
            got = staged_block(buf, base, off, row, hi, len(buf))
            if got is None or cb == 4:
                continue
            slot, coff, lo = got
            for r in range(lo, hi + 1):
                i2, j2 = (r * 7) % k2, (r * 3 + 1) % k2
                x = ((r * k2 + i2) * k2 + j2) % (1 << 32)
                at = (coff + cb * x) % (1 << 32)
                assert at + cb <= len(slot)
                word = slot[at:at + cb].view(np.int16)[0]
                assert word == codes[r, i2, j2], (t, hi, r)
            staged += 1
    assert staged > 0 or case == "int32_codes"


@pytest.mark.parametrize("case", ["mhc_slice_csr", 1])
def test_word_offsets_match_loop(case):
    """The plan-wide word offsets, rebased at each span's first transition,
    are the offsets the traceback's loop computed a span (its words one
    after another from 0), and a span's words fit the one buffer."""
    arrs, R = random_case(case) if isinstance(case, int) else case_csr(case)
    dp = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu",
                                 ckpt_every=2, chunk=4)
    desc = dp.plan.desc
    woff = chunked.word_offsets(desc, R + 1)
    assert len(dp.spans) > 2 and woff[-1] == (R + 1) * int(
        (desc[:, K2] ** 2).sum())
    most = max(dp.span_bytes(*sp) for sp in dp.spans) // 4
    for t0, t1 in dp.spans:
        sizes = (R + 1) * desc[t0:t1, K2] ** 2
        loop = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        assert np.array_equal(woff[t0:t1] - woff[t0], loop)
        assert woff[t1] - woff[t0] == dp.span_bytes(t0, t1) // 4 <= most


@pytest.mark.parametrize("case", ["mhc_slice_csr", 2])
def test_replay_reuses_forward_cut(case, monkeypatch):
    """The forward keeps each span's launch cut; each replay gets that cut
    (the same object), equal to ``plan_launches`` run again on the span at
    the card's budget; the tier's result is unchanged."""
    arrs, R = random_case(case) if isinstance(case, int) else case_csr(case)
    plan = plan_vertices(*arrs)
    want = chunked.DeviceDiploidDP(plan, R, "cpu").run()
    seen = []
    step = chunked.chunk_step

    def spy(dev, t0, t1, *args, cut=None, **kw):
        if len(args) > 2 and args[2] is not None:  # the replay's words
            seen.append((t0, t1, cut))
        return step(dev, t0, t1, *args, cut=cut, **kw)

    monkeypatch.setattr(chunked, "chunk_step", spy)
    dp = chunked.DeviceDiploidDP(plan, R, "cpu", ckpt_every=2, chunk=4)
    assert dp.run() == want
    assert len(dp.cuts) == len(dp.spans) > 2
    assert [(t0, t1) for t0, t1, _ in seen] == dp.spans[::-1]
    for (t0, t1, cut), kept in zip(seen, dp.cuts[::-1]):
        assert cut is kept
        again = plan_launches(plan.desc[t0:t1], R + 1, True,
                              fused.SMEM_OPTIN_CPU)
        again[:, :2] += t0
        assert np.array_equal(cut, again)
