"""The pair planner of the diploid pair DP: a level-ordered list of narrow
and wide runs of 256-pair chunks, with the tables every kernel reads.

A copy of the planner of ``dipgenie_tpu/ops/diploid_pallas.py`` (its
constants, ``_NarrowRun``, ``_WideRun``, ``PairPlan``, ``plan_pairs``,
``_plan_narrow_run`` and ``_plan_wide_run``), held field for field to that
module's by ``tests/test_torch_host_parity.py`` on every graph that
module plans. Where that module raises (R >= 32, a wide run of more than
31 windows, a value bound past 4,100,000: limits of the TPU kernels) this
one plans on, up to its own limits (``VALUE_MAX``, ``SPLIT_NB_MAX``). The
on-disk plan cache and the TPU kernels' digit helpers are left out.
Producer of the per-
transition pair tables: the native ``dg_pair_tables`` (``native.py``),
with the numpy closure in ``plan_pairs`` as reference and fallback.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass

import numpy as np

from ..utils import timing

NEG = -(2**19)  # unreachable sentinel, re-pinned every level

# packed chunk-table layout: tbl is [nchunks, 2, CHUNK]
#   row 0: gidx << 13 | (dst + 1) << 2 | wsum   (gidx < 2^18 = SPLIT_NB_MAX
#          * 1024; dst+1 in [0, 1024] — 0 marks a padded lane; wsum in
#          {0, 1, 2})
#   row 1: score (PAD_SC on padded lanes)
_TBL_ROWS = 2

REACH_T = -(2**18)  # values above this are reachable
PAD_SC = -(2**22)  # score of padded pair lanes (loses every max)
CHUNK = 2**8  # pair lanes per chunk
NARROW_W = 32  # widest level of a narrow run

# The port's own limits. The TPU planner's (R <= 31, at most 31 windows,
# a value bound of 4,100,000) came from its padded rows, its int32 window
# bitmasks and its packed int32 scan key, none of which the port has;
# plans within them are the TPU planner's, field for field.
#
# VALUE_MAX: the largest DP value the plain versions' reduction key holds.
# The key's high word is value - REACH_T + 1 (ops/plan.py:make_keys), read
# back as a signed int32, so value - REACH_T + 1 <= 2^31 - 1; the kernels
# form value + score in int32. Scores are
# popcounts (>= 0), so no value exceeds the plan's bound less |NEG|.
VALUE_MAX = 2**31 - 2 + REACH_T  # 2,147,221,502
# SPLIT_NB_MAX: the most 1024-lane windows a wide run may have, so that
# its window-split gidx fits the 18 bits above `<< 13` (level width 512).
SPLIT_NB_MAX = 256
# DENSE_NB_LIMIT: the most windows a dense table (gidx(15) << 17 | win(5)
# << 12) and the int32 window bitmasks encode. A run past it has neither:
# its dense arrays are empty and its bitmasks 0; K3 / K4 run it.
DENSE_NB_LIMIT = 31


class PlanLimit(ValueError):
    """A graph past one of the port's own limits (``VALUE_MAX``,
    ``SPLIT_NB_MAX``); the native tier (``--dp-backend native``) runs it."""


class WindowLimit(PlanLimit):
    """A wide run past ``SPLIT_NB_MAX`` windows (a level wider than 512).
    ``--dp-backend auto`` runs such a graph on the fused tier."""


# --------------------------------------------------------------------
# host-side colour mask -> per-pair score machinery
# --------------------------------------------------------------------

_POP16 = np.array(
    [bin(i).count("1") for i in range(1 << 16)], dtype=np.uint8
)


def _popcount(a: np.ndarray) -> np.ndarray:
    """Elementwise popcount of uint32/uint64 arrays (numpy-version safe)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a)
    v = a.view(np.uint16) if a.dtype != np.uint16 else a
    return (
        _POP16[v]
        .reshape(a.shape + (a.dtype.itemsize // 2,))
        .sum(-1)
        .astype(np.uint8)
    )


def _level_masks(vs, ve, ptr, colors, uniq):
    """[ve-vs, W] uint32 colour bitsets over the local colour universe."""
    cnt = ve - vs
    W = max(1, (len(uniq) + 31) // 32)
    m = np.zeros((cnt, W), np.uint32)
    seg = colors[ptr[vs] : ptr[ve]]
    if len(seg):
        loc = np.searchsorted(uniq, seg).astype(np.int64)
        rows = np.repeat(
            np.arange(cnt, dtype=np.int64),
            np.diff(ptr[vs : ve + 1]).astype(np.int64),
        )
        np.bitwise_or.at(
            m, (rows, loc // 32), np.uint32(1) << (loc % 32).astype(np.uint32)
        )
    return m


# --------------------------------------------------------------------
# plan
# --------------------------------------------------------------------


@dataclass
class _NarrowRun:
    t0: int  # first transition index (global)
    t1: int  # one past last
    tbl: np.ndarray  # [nchunks_pad, 2, CHUNK] int32 packed blocks
    w1: np.ndarray  # [nchunks, CHUNK] int8   (traceback only)
    symd: np.ndarray  # [nchunks, CHUNK] int16 (traceback only)
    sbits: np.ndarray  # [nchunks_pad] int32 bit0 in1024 bit1 out1024 b2 first b3 last
    sbase: np.ndarray  # [nchunks_pad] int32 chunk ordinal * CHUNK
    r256: np.ndarray  # [nchunks_pad] int32 bp row per out256 transition
    r1024: np.ndarray  # [nchunks_pad] int32
    n256: int
    n1024: int
    # traceback per-transition metadata
    tb_chunkbase: np.ndarray  # [T] int32 first chunk row of transition
    tb_bits: np.ndarray  # [T] int32 (out1024 bit)
    tb_bprow: np.ndarray  # [T] int32 row in bp256 or bp1024
    tb_bin: np.ndarray  # [T] int32 src layout divisor (16/32)
    tb_bout: np.ndarray  # [T] int32 dst layout divisor


@dataclass
class _WideRun:
    """A maximal run of wide / big-pair transitions, executed as ONE
    Pallas kernel over 256-pair chunks with a VMEM-resident
    [R1P, NB*1024] double-buffered state.

    Each chunk's destination lanes live inside one 1024-lane window;
    the kernel gathers predecessors with block-masked one-hot matmuls
    (only source windows present in the chunk, via wgmask bits), does
    the same packed-key segmented max-scan + extract as the narrow
    kernel, then read-modify-writes the destination window of the Vnext
    scratch (strict > keeps the earlier chunk on ties = the plan's
    preference order). Backpointers stream out as one int32
    [R1P, 1024] block per (transition, window)."""

    t0: int
    t1: int
    NB: int  # V windows (SWmax // 1024)
    tbl: np.ndarray  # [nchunks_pad, 2, CHUNK] int32 packed (as narrow)
    w1: np.ndarray  # [nchunks_pad, CHUNK] int8
    symd: np.ndarray  # [nchunks_pad, CHUNK] int16
    wbits: np.ndarray  # [nchunks_pad] int32: 1 window-first, 2 commit
    wwin: np.ndarray  # [nchunks_pad] int32 dst window index
    wpmask: np.ndarray  # [nchunks_pad] int32 dst-window PRESENCE bits
    # (0 past DENSE_NB_LIMIT windows, where no port kernel reads them):
    # bit b set iff the chunk's transition has >= 1 kept pair landing in
    # window b. At commit every V window is rewritten: present windows
    # take the (reach-masked) Vnext value, absent windows — both holes
    # inside the extent and windows past it — are reset to NEG. A
    # round-4 advisor repro showed the previous extent-only commit left
    # stale older-level values in windows >= ext (gathered as live
    # states by later transitions) and promoted raw uninitialized Vnext
    # scratch for hole windows.
    wbase: np.ndarray  # [nchunks_pad] int32 slot base within transition
    wgmask: np.ndarray  # [nchunks_pad] int32 src-window presence bits (0
    # past DENSE_NB_LIMIT windows)
    wrow: np.ndarray  # [nchunks_pad] int32 bp output row
    nrows: int  # real bp rows (sum of ext over transitions)
    # traceback per-transition metadata (same contract as _NarrowRun)
    tb_chunkbase: np.ndarray  # [T] int32
    tb_bits: np.ndarray  # [T] int32 (always 2: 1024-class bp)
    tb_bprow: np.ndarray  # [T] int32 first bp row of transition
    tb_bin: np.ndarray  # [T] int32 src layout divisor (flat k if wide)
    tb_bout: np.ndarray  # [T] int32 dst layout divisor
    # ---- DENSE chunking (round 5, single-chip megakernel) ----
    # The window-split chunks above leave wide chunks only ~34% full on
    # MHC (chunks break at every 1024-lane dst-window boundary); the
    # dense tables pack pairs contiguously — a chunk may span several
    # dst windows — and the dense kernel extracts/RMWs per spanned
    # window. The window-split arrays remain the tables of the
    # tp-sharded path (its pmax merge requires window-disjoint device
    # ownership) and of its traceback. Dense rowA packing:
    #   gidx(15) << 17 | win(5) << 12 | rel(10) << 2 | wsum(2)
    # (padded lanes are all-zero rowA and are identified by
    # score == PAD_SC, NOT by a dst sentinel). A run of more than
    # DENSE_NB_LIMIT windows has no dense tables: every d* array is empty
    # and tb2_chunkbase is 0.
    dtbl: np.ndarray  # [ndch_pad, 2, CHUNK] int32
    dw1: np.ndarray  # [ndch_pad, CHUNK] int8 (traceback)
    dsymd: np.ndarray  # [ndch_pad, CHUNK] int16 (traceback)
    dbits: np.ndarray  # [ndch_pad] int32: 2 commit, 4 real
    dfmask: np.ndarray  # [ndch_pad] int32 first-touch dst-window bits
    dcmask: np.ndarray  # [ndch_pad] int32 spanned dst-window bits
    dgmask: np.ndarray  # [ndch_pad] int32 src-window bits
    dpmask: np.ndarray  # [ndch_pad] int32 transition presence bits
    dtrans: np.ndarray  # [ndch_pad] int32 transition ordinal (bp row)
    dwbase: np.ndarray  # [ndch_pad] int32 chunk pair-ordinal base
    tb2_chunkbase: np.ndarray  # [T] int32 first dense chunk of transition


@dataclass
class PairPlan:
    R: int
    L: int
    segments: list  # _NarrowRun | _WideRun, in level order
    max_abs_value: int  # packed-key overflow guard evidence


def _layout(width: int) -> int:
    """Pair-layout divisor of a narrow level: FLAT (i * width + j).
    Flat layouts (PLAN_FORMAT 8) shrink the padded pair extent of a
    width-k level from the power-of-two 256/1024 to ceil(k^2/256)*256
    (256/512/768/1024): a width-20 level costs a 512-lane gather
    one-hot and a 2-block extract instead of 1024/4 — the one-hot
    builds are the narrow kernel's VPU ceiling (BENCH_NOTES roofline).
    """
    return width


def _ext(width: int) -> int:
    """Padded pair-lane extent of a flat-layout level (1..4 blocks)."""
    return max(1, -(-(width * width) // CHUNK))


def _pad_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# power-of-two rungs: padded chunks execute the full kernel, so tight
# fits beat fewer compile shapes (the persistent cache amortizes them)
_RUN_LADDER = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
               32768, 65536)
# wide-run V window-count ladder (the TPU's VMEM state = 2 * NB * 128 KB
# and compile shapes); past its last rung NB is the windows the run needs
_NB_LADDER = (2, 5, 18, DENSE_NB_LIMIT)
# backpointer output rows (per narrow run) are padded to this ladder so
# the number of distinct Mosaic compile shapes stays small: on MHC,
# (T, n256, n1024) is otherwise unique per run -> 300+ compiles
_BP_LADDER = (1, 4, 16, 64, 256, 1024, 4096, 16384, 65536)

# The narrow kernel spills backpointers as int16 global pair ordinals
# (chunk-local slot + sbase), so a narrow transition must keep at most
# 32768 padded pair lanes; larger transitions route to the wide-gap
# path, whose backpointers are int32.
_NARROW_MAX_PAIRS = 1 << 15


def _scan_class(dstl: np.ndarray, nch: int) -> np.ndarray:
    """Per-256-lane-chunk scan-depth class from the longest run of
    consecutive equal dst values among the REAL lanes: 0 (run <= 4,
    2 scan stages), 1 (<= 16, 4 stages), 2 (any, 8 stages). On MHC
    p50/p90 of the max run are 4/16, so most chunks skip 4-6 of the 8
    segmented-max-scan stages (the scan was ~40% of the narrow kernel).
    Padded lanes need no scanning (every pad is INVALID, and max over
    equal values is depth-independent)."""
    n = len(dstl)
    cls = np.zeros(nch, np.int64)
    if n == 0:
        return cls
    starts = np.flatnonzero(np.r_[True, dstl[1:] != dstl[:-1]]).astype(
        np.int64
    )
    cb = np.arange(CHUNK, n, CHUNK, dtype=np.int64)
    bounds = np.union1d(starts, cb)
    lens = np.diff(np.r_[bounds, n])
    mx = np.zeros(nch, np.int64)
    np.maximum.at(mx, bounds // CHUNK, lens)
    cls[mx > 4] = 1
    cls[mx > 16] = 2
    return cls


def _ladder_fit(x: int, ladder) -> int:
    """Smallest ladder rung >= x; extends by doubling beyond the last
    rung so oversized instances plan (at the cost of a fresh compile)
    instead of crashing."""
    for c in ladder:
        if c >= x:
            return c
    c = ladder[-1]
    while c < x:
        c *= 2
    return c


def plan_pairs(
    level_ptr,
    adj_ptr,
    adj_v,
    adj_w,
    hom_ptr,
    hom_colors,
    het_ptr,
    het_colors,
    R: int,
) -> PairPlan:
    """The plan in two spans: ``pair.plan.tables``, the inputs' conversion
    and the native planner's one call (``dg_pair_tables``), and
    ``pair.plan.layout``, the runs' layout (where the native planner is
    off or missing, the numpy tables are made there, one a transition)."""
    with timing.span("pair.plan.tables"):
        level_ptr = np.asarray(level_ptr, np.int64)
        adj_ptr = np.asarray(adj_ptr, np.int64)
        adj_v = np.asarray(adj_v, np.int64)
        adj_w = np.asarray(adj_w, np.int64)
        hom_ptr = np.asarray(hom_ptr, np.int64)
        het_ptr = np.asarray(het_ptr, np.int64)
        L = len(level_ptr) - 1
        L1 = L - 1
        widths = np.diff(level_ptr)

        # ---- per-transition raw pair tables ----
        # Producer selection: the native OpenMP planner (dg_pair_tables,
        # native/dgcore.cpp) computes every transition's sorted/scored pair
        # arrays in one call (~20x faster than the numpy loop, which pays
        # ~350 us of dispatch overhead per transition — 40+ s on MHC);
        # the numpy closure below remains the reference implementation and
        # the fallback, and tests assert array-exact agreement.
        _nat = None
        if _os.environ.get("DIPGENIE_NO_NATIVE_PLANNER") != "1":
            try:
                from .. import native as _native

                if _native.available():
                    _nat = _native.pair_tables_all(
                        level_ptr, adj_ptr, adj_v, adj_w,
                        hom_ptr, hom_colors, het_ptr, het_colors, R,
                    )
            except Exception:
                _nat = None

    def pair_tables_numpy(l):
        """Sorted pair arrays for transition l -> l+1 (host layouts)."""
        b0, b1, b2 = int(level_ptr[l]), int(level_ptr[l + 1]), int(level_ptr[l + 2])
        k, k2 = b1 - b0, b2 - b1
        e0, e1 = int(adj_ptr[b0]), int(adj_ptr[b1])
        dst = (adj_v[e0:e1] - b1).astype(np.int64)
        w = adj_w[e0:e1].astype(np.int64)
        src = np.repeat(
            np.arange(k, dtype=np.int64),
            np.diff(adj_ptr[b0 : b1 + 1]).astype(np.int64),
        )
        eo = np.arange(len(dst), dtype=np.int64)  # adjacency order

        # local colour universe + masks
        cs = np.concatenate(
            [
                hom_colors[hom_ptr[b0] : hom_ptr[b2]],
                het_colors[het_ptr[b0] : het_ptr[b2]],
            ]
        )
        uniq = np.unique(cs)
        Hl = _level_masks(b0, b1, hom_ptr, hom_colors, uniq)
        Tl = _level_masks(b0, b1, het_ptr, het_colors, uniq)
        Hr = _level_masks(b1, b2, hom_ptr, hom_colors, uniq)
        Tr = _level_masks(b1, b2, het_ptr, het_colors, uniq)

        E = len(dst)
        e1i = np.repeat(np.arange(E), E)
        e2i = np.tile(np.arange(E), E)
        ws = w[e1i] + w[e2i]
        keep = ws <= R
        e1i, e2i, ws = e1i[keep], e2i[keep], ws[keep]
        s1, s2 = src[e1i], src[e2i]
        d1, d2 = dst[e1i], dst[e2i]
        # preference sort: (dstpair, pred_i, pred_j, edge order)
        order = np.lexsort((eo[e2i], eo[e1i], s2, s1, d1 * k2 + d2))
        e1i, e2i, ws = e1i[order], e2i[order], ws[order]
        s1, s2, d1, d2 = s1[order], s2[order], d1[order], d2[order]

        HLu = Hl[s1] | Hl[s2]
        TLu = Tl[s1] | Tl[s2]
        HRu = Hr[d1] | Hr[d2]
        TRu = Tr[d1] | Tr[d2]
        symd = _popcount(TLu ^ TRu).sum(-1).astype(np.int64)
        score = _popcount(HLu & HRu).sum(-1).astype(np.int64) + symd
        w1 = w[e1i]
        return k, k2, s1, s2, d1, d2, ws, score, symd, w1

    def pair_tables_native(l):
        """Slice of the one-call native planner output for transition l."""
        off, s1a, s2a, d1a, d2a, syma, wsa, w1a, sca, _smax = _nat
        sl = slice(int(off[l]), int(off[l + 1]))
        k = int(level_ptr[l + 1] - level_ptr[l])
        k2 = int(level_ptr[l + 2] - level_ptr[l + 1])
        return (
            k, k2,
            s1a[sl].astype(np.int64), s2a[sl].astype(np.int64),
            d1a[sl].astype(np.int64), d2a[sl].astype(np.int64),
            wsa[sl].astype(np.int64), sca[sl].astype(np.int64),
            syma[sl].astype(np.int64), w1a[sl].astype(np.int64),
        )

    pair_tables = pair_tables_native if _nat is not None else pair_tables_numpy

    # kept pair count per transition (pairs with wsum <= R), computed
    # from the edge-weight histogram without materializing E^2 arrays
    def kept_pairs(l):
        if _nat is not None:
            return int(_nat[0][l + 1] - _nat[0][l])
        b0, b1 = int(level_ptr[l]), int(level_ptr[l + 1])
        w = np.minimum(adj_w[int(adj_ptr[b0]) : int(adj_ptr[b1])], R + 1)
        c = np.bincount(w, minlength=R + 2).astype(np.int64)
        conv = np.convolve(c, c)
        return int(conv[: R + 1].sum())

    # value guard: |NEG| plus the sum of the per-level max scores, an
    # upper bound of every DP value plus |NEG| (see VALUE_MAX)
    bound = [abs(NEG)]

    def pair_tables_g(l):
        out = pair_tables(l)
        score = out[7]
        bound[0] += int(score.max(initial=0))
        return out

    with timing.span("pair.plan.layout"):
        narrow = np.zeros(L1, bool)
        for l in range(L1):
            narrow[l] = (
                max(widths[l], widths[l + 1]) <= NARROW_W
                # int16 bp ordinal limit: padded pair lanes must fit 2^15
                and _pad_up(kept_pairs(l), CHUNK) <= _NARROW_MAX_PAIRS
            )

        segments = []
        l = 0
        while l < L1:
            if narrow[l]:
                j = l
                while j < L1 and narrow[j]:
                    j += 1
                seg, _ = _plan_narrow_run(l, j, widths, pair_tables_g, R)
                segments.append(seg)
                l = j
            else:
                j = l
                while j < L1 and not narrow[j]:
                    j += 1
                segments.append(
                    _plan_wide_run(l, j, widths, pair_tables_g, R))
                l = j
        if bound[0] + NEG > VALUE_MAX:
            raise PlanLimit(
                f"DP values may reach {bound[0] + NEG}, past {VALUE_MAX}, "
                "the largest the 64-bit reduction key holds; use "
                "--dp-backend native"
            )
    return PairPlan(R=R, L=L, segments=segments, max_abs_value=bound[0])


def _plan_narrow_run(t0, t1, widths, pair_tables, R):
    # pass 1: per-transition pair tables + chunk counts
    tabs = []
    nchs = []
    running_sc = 0
    for t in range(t0, t1):
        k, k2, s1, s2, d1, d2, ws, score, symd, w1 = pair_tables(t)
        Bin = _layout(int(widths[t]))
        Bout = _layout(int(widths[t + 1]))
        gidx = (s1 * Bin + s2).astype(np.int32)
        dstl = (d1 * Bout + d2).astype(np.int32)
        tabs.append((gidx, ws, score, dstl, w1, symd, Bin, Bout))
        nchs.append(max(1, (len(gidx) + CHUNK - 1) // CHUNK))
        running_sc += int(score.max(initial=0))

    nreal = int(sum(nchs))
    npad = _ladder_fit(nreal, _RUN_LADDER)
    # pass 2: preallocate flat blocks and fill in place (np.stack of
    # thousands of small arrays dominated planning time before)
    tbl = np.zeros((npad, _TBL_ROWS, CHUNK), np.int32)
    tbl[:, 1] = PAD_SC
    # padded to npad rows so traceback arg shapes are laddered too
    w1a = np.zeros((npad, CHUNK), np.int8)
    syma = np.zeros((npad, CHUNK), np.int16)
    sbits = np.zeros(npad, np.int32)
    sbase = np.zeros(npad, np.int32)
    r256 = np.zeros(npad, np.int32)
    r1024 = np.zeros(npad, np.int32)
    T = t1 - t0
    tb_chunkbase = np.zeros(T, np.int32)
    tb_bits = np.zeros(T, np.int32)
    tb_bprow = np.zeros(T, np.int32)
    tb_bin = np.zeros(T, np.int32)
    tb_bout = np.zeros(T, np.int32)

    crow = 0
    n256 = n1024 = 0
    for ti, (gidx, ws, score, dstl, w1, symd, Bin, Bout) in enumerate(tabs):
        n = len(gidx)
        nch = nchs[ti]
        rows = slice(crow, crow + nch)
        padlen = nch * CHUNK
        view = tbl[rows]  # view: slice indexing

        def fill(row, a, padv):
            buf = np.full(padlen, padv, np.int32)
            buf[:n] = a
            view[:, row] = buf.reshape(nch, CHUNK)

        packed = (
            (gidx.astype(np.int32) << 13)
            | ((dstl.astype(np.int32) + 1) << 2)
            | ws.astype(np.int32)
        )
        fill(0, packed, 0)  # pad lanes: gidx 0, dst -1, wsum 0
        fill(1, score, PAD_SC)
        wbuf = np.zeros(padlen, np.int8)
        wbuf[:n] = w1
        w1a[rows] = wbuf.reshape(nch, CHUNK)
        sbuf = np.zeros(padlen, np.int16)
        sbuf[:n] = symd
        syma[rows] = sbuf.reshape(nch, CHUNK)

        # bits: 0-1 src extent class - 1, 2 first, 3 last, 4 real,
        # 5-6 scan class, 7-8 dst extent class - 1
        sext = _ext(Bin)
        dext = _ext(Bout)
        out1024 = dext > 1  # bp block class (int16 256- vs 1024-wide)
        bits = (sext - 1) | ((dext - 1) << 7) | 16
        sbits[rows] = bits | (_scan_class(dstl, nch) << 5).astype(np.int32)
        sbits[crow] |= 4
        sbits[crow + nch - 1] |= 8
        sbase[rows] = np.arange(nch, dtype=np.int32) * CHUNK
        r256[rows] = n256
        r1024[rows] = n1024
        tb_chunkbase[ti] = crow
        tb_bits[ti] = 2 if out1024 else 0
        tb_bprow[ti] = n1024 if out1024 else n256
        tb_bin[ti] = Bin
        tb_bout[ti] = Bout
        if out1024:
            n1024 += 1
        else:
            n256 += 1
        crow += nch

    n256c = max(n256, 1)
    n1024c = max(n1024, 1)
    # padded grid steps: bits 0 (not first/last), bp rows pinned at the
    # last written row so output index maps never regress
    r256[nreal:] = max(n256 - 1, 0)
    r1024[nreal:] = max(n1024 - 1, 0)
    seg = _NarrowRun(
        t0=t0,
        t1=t1,
        tbl=tbl,
        w1=w1a,
        symd=syma,
        sbits=sbits,
        sbase=sbase,
        r256=np.minimum(r256, n256c - 1),
        r1024=np.minimum(r1024, n1024c - 1),
        n256=n256c,
        n1024=n1024c,
        tb_chunkbase=tb_chunkbase,
        tb_bits=tb_bits,
        tb_bprow=tb_bprow,
        tb_bin=tb_bin,
        tb_bout=tb_bout,
    )
    return seg, running_sc


def _plan_wide_run(t0, t1, widths, pair_tables, R):
    # pass 1: pair tables + window budget
    tabs = []
    need_nb = 1
    for t in range(t0, t1):
        k, k2, s1, s2, d1, d2, ws, score, symd, w1 = pair_tables(t)
        # src/dst layout: narrow pair layout at the run's boundaries,
        # flat k*k for wide levels
        Bin = _layout(int(k)) if k <= NARROW_W else int(k)
        Bout = _layout(int(k2)) if k2 <= NARROW_W else int(k2)
        gidx = (s1 * Bin + s2).astype(np.int32)
        dstl = (d1 * Bout + d2).astype(np.int32)
        need_nb = max(
            need_nb,
            (int(gidx.max(initial=0)) >> 10) + 1,
            (int(dstl.max(initial=0)) >> 10) + 1,
        )
        tabs.append((gidx, ws, score, dstl, w1, symd, Bin, Bout))
    if need_nb > SPLIT_NB_MAX:
        raise WindowLimit(
            f"a wide run needs {need_nb} 1024-lane windows, past "
            f"{SPLIT_NB_MAX} (a level wider than 512); use --dp-backend "
            "native"
        )
    dense = need_nb <= DENSE_NB_LIMIT  # dense tables and window bitmasks
    NB = _ladder_fit(need_nb, _NB_LADDER) if dense else need_nb

    # pass 2: chunk each transition, splitting at 1024-lane dst-window
    # boundaries (dst-sorted pairs => windows ascend monotonically)
    chunks = []  # (trans_idx, lane_slice, win)
    per_tr = []  # (nch, ext, rowbase, pmask)
    rowbase = 0
    for ti, (gidx, ws, score, dstl, w1, symd, Bin, Bout) in enumerate(tabs):
        win = dstl >> 10
        # boundaries where the window changes
        cuts = np.flatnonzero(np.diff(win)) + 1
        bounds = np.concatenate([[0], cuts, [len(dstl)]])
        nch = 0
        local = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            for c0 in range(int(b0), int(b1), CHUNK):
                local.append((c0, min(c0 + CHUNK, int(b1)), int(win[c0])))
                nch += 1
        if not local:
            # a transition with ZERO kept pairs (every pair's wsum > R)
            # still needs one all-pad chunk so its commit fires and
            # resets V to NEG — otherwise the previous level's values
            # would leak through as phantom reachable states
            local = [(0, 0, 0)]
            nch = 1
        ext = (int(dstl.max(initial=0)) >> 10) + 1
        pmask = int(
            np.bitwise_or.reduce(np.left_shift(1, np.unique(win)), initial=0)
        ) if len(win) and dense else 0
        per_tr.append((local, ext, rowbase, pmask))
        rowbase += ext
    nrows = rowbase

    nreal = sum(len(local) for local, _, _, _ in per_tr)
    npad = _ladder_fit(nreal, _RUN_LADDER)
    tbl = np.zeros((npad, _TBL_ROWS, CHUNK), np.int32)
    tbl[:, 1] = PAD_SC
    w1a = np.zeros((npad, CHUNK), np.int8)
    syma = np.zeros((npad, CHUNK), np.int16)
    wbits = np.zeros(npad, np.int32)
    wwin = np.zeros(npad, np.int32)
    wpmask = np.zeros(npad, np.int32)
    wbase = np.zeros(npad, np.int32)
    wgmask = np.zeros(npad, np.int32)
    wrow = np.zeros(npad, np.int32)
    T = t1 - t0
    tb_chunkbase = np.zeros(T, np.int32)
    tb_bits = np.full(T, 2, np.int32)  # 1024-class bp for traceback
    tb_bprow = np.zeros(T, np.int32)
    tb_bin = np.zeros(T, np.int32)
    tb_bout = np.zeros(T, np.int32)

    crow = 0
    for ti, (gidx, ws, score, dstl, w1, symd, Bin, Bout) in enumerate(tabs):
        local, ext, rb, pmask = per_tr[ti]
        tb_chunkbase[ti] = crow
        tb_bprow[ti] = rb
        tb_bin[ti] = Bin
        tb_bout[ti] = Bout
        seen_win = set()
        for ci, (c0, c1, win) in enumerate(local):
            n = c1 - c0
            row = crow + ci
            rel = (dstl[c0:c1] - win * 1024).astype(np.int32)
            tbl[row, 0, :n] = (
                (gidx[c0:c1].astype(np.int32) << 13)
                | ((rel + 1) << 2)
                | ws[c0:c1].astype(np.int32)
            )
            tbl[row, 1, :n] = score[c0:c1]
            w1a[row, :n] = w1[c0:c1]
            syma[row, :n] = symd[c0:c1]
            bits = 0
            if win not in seen_win:
                seen_win.add(win)
                bits |= 1  # window-first: init Vnext window + bp block
            if ci == len(local) - 1:
                bits |= 2  # commit Vnext -> Vnow
            bits |= int(_scan_class(rel, 1)[0]) << 5  # scan depth class
            wbits[row] = bits | 4  # bit 4: real (ladder pads skip)
            wwin[row] = win
            wpmask[row] = pmask
            wbase[row] = ci * CHUNK
            if dense:
                wgmask[row] = int(
                    np.bitwise_or.reduce(
                        np.left_shift(1, np.unique(gidx[c0:c1] >> 10)),
                        initial=0,
                    )
                )
            wrow[row] = rb + win
        crow += len(local)
    # padded grid steps: repeat the final row indices (no map regression)
    if nreal:
        wrow[nreal:] = wrow[nreal - 1]
        wwin[nreal:] = wwin[nreal - 1]
        wpmask[nreal:] = wpmask[nreal - 1]

    # ---- pass 3: DENSE chunking for the single-chip megakernel ----
    # pairs pack contiguously into 256-lane chunks that may straddle
    # dst windows (window-split chunks above are only ~34% full on MHC);
    # none past DENSE_NB_LIMIT windows
    ndch_per = [max(1, (len(tab[0]) + CHUNK - 1) // CHUNK) if dense else 0
                for tab in tabs]
    ndreal = int(sum(ndch_per))
    ndpad = _ladder_fit(ndreal, _RUN_LADDER) if dense else 0
    dtbl = np.zeros((ndpad, _TBL_ROWS, CHUNK), np.int32)
    dtbl[:, 1] = PAD_SC
    dw1 = np.zeros((ndpad, CHUNK), np.int8)
    dsymd = np.zeros((ndpad, CHUNK), np.int16)
    dbits = np.zeros(ndpad, np.int32)
    dfmask = np.zeros(ndpad, np.int32)
    dcmask = np.zeros(ndpad, np.int32)
    dgmask = np.zeros(ndpad, np.int32)
    dpmask = np.zeros(ndpad, np.int32)
    dtrans = np.zeros(ndpad, np.int32)
    dwbase = np.zeros(ndpad, np.int32)
    tb2_chunkbase = np.zeros(T, np.int32)
    drow = 0
    for ti, (gidx, ws, score, dstl, w1, symd, Bin, Bout) in enumerate(
            tabs if dense else ()):
        _, _, _, pmask = per_tr[ti]
        tb2_chunkbase[ti] = drow
        n = len(gidx)
        winv = dstl >> 10
        relv = dstl & 1023
        packed = (
            (gidx.astype(np.int32) << 17)
            | (winv.astype(np.int32) << 12)
            | (relv.astype(np.int32) << 2)
            | ws.astype(np.int32)
        )
        seen = 0
        nch = ndch_per[ti]
        dstg = (winv.astype(np.int64) << 10) | relv.astype(np.int64)
        dcls = _scan_class(dstg, nch)
        for ci in range(nch):
            c0, c1 = ci * CHUNK, min((ci + 1) * CHUNK, n)
            m = c1 - c0
            row = drow + ci
            if m > 0:
                dtbl[row, 0, :m] = packed[c0:c1]
                dtbl[row, 1, :m] = score[c0:c1]
                dw1[row, :m] = w1[c0:c1]
                dsymd[row, :m] = symd[c0:c1]
                cm = int(
                    np.bitwise_or.reduce(
                        np.left_shift(1, np.unique(winv[c0:c1])), initial=0
                    )
                )
                dgmask[row] = int(
                    np.bitwise_or.reduce(
                        np.left_shift(1, np.unique(gidx[c0:c1] >> 10)),
                        initial=0,
                    )
                )
            else:
                cm = 0
            dcmask[row] = cm
            dfmask[row] = cm & ~seen
            seen |= cm
            dbits[row] = (
                4 | (2 if ci == nch - 1 else 0) | (int(dcls[ci]) << 5)
            )
            dpmask[row] = pmask
            dtrans[row] = ti
            dwbase[row] = c0
        drow += nch
    if ndreal:
        dtrans[ndreal:] = dtrans[ndreal - 1]
        dpmask[ndreal:] = dpmask[ndreal - 1]

    return _WideRun(
        t0=t0,
        t1=t1,
        NB=NB,
        tbl=tbl,
        w1=w1a,
        symd=syma,
        wbits=wbits,
        wwin=wwin,
        wpmask=wpmask,
        wbase=wbase,
        wgmask=wgmask,
        wrow=wrow,
        nrows=max(nrows, 1),
        tb_chunkbase=tb_chunkbase,
        tb_bits=tb_bits,
        tb_bprow=tb_bprow,
        tb_bin=tb_bin,
        tb_bout=tb_bout,
        dtbl=dtbl,
        dw1=dw1,
        dsymd=dsymd,
        dbits=dbits,
        dfmask=dfmask,
        dcmask=dcmask,
        dgmask=dgmask,
        dpmask=dpmask,
        dtrans=dtrans,
        dwbase=dwbase,
        tb2_chunkbase=tb2_chunkbase,
    )


def shard_wide_tables(seg: _WideRun, n_tp: int):
    """A wide run's window-split chunks divided among ``n_tp`` devices,
    as ``_shard_wide_tables`` (``diploid_pallas.py:1866``) divides them:
    destination windows are owned round-robin (``wwin % n_tp``), so a
    window's chunks all land on one device, in plan order. Without the
    TPU's compile-shape padding: returns ``(shards, present)``, where
    ``shards[d] = (rows, bounds)`` gives device ``d``'s chunk rows of the
    run's tables (int64, plan order) and transition ``ti``'s share
    ``rows[bounds[ti]:bounds[ti + 1]]`` (``bounds`` [T + 1] int32), and
    ``present`` [T, NB] int32 is 1 on the windows the transition's kept
    pairs reach: the windows (``wwin``) of its chunks that hold a real
    pair, which is what ``wpmask`` holds up to ``DENSE_NB_LIMIT``
    windows."""
    nreal = int(np.count_nonzero(seg.wbits & 4))
    chunkbase = np.asarray(seg.tb_chunkbase, np.int64)
    owner = seg.wwin[:nreal] % n_tp
    shards = []
    for d in range(n_tp):
        rows = np.flatnonzero(owner == d)
        bounds = np.searchsorted(rows, np.append(chunkbase, nreal))
        shards.append((rows, bounds.astype(np.int32)))
    T = seg.t1 - seg.t0
    # a real lane's packed word is never 0 ((dst + 1) << 2 >= 4)
    real = np.flatnonzero((seg.tbl[:nreal, 0] != 0).any(axis=1))
    trans = np.searchsorted(chunkbase, real, side="right") - 1
    present = np.zeros((T, seg.NB), np.int32)
    present[trans, seg.wwin[real]] = 1
    return shards, present


