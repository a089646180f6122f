"""Canonical (w,k)-minimizer sketching with string-lexicographic semantics.

Reproduces the reference sketching loops (reference: src/solver.cpp:277-412)
exactly, but vectorized:

  * sequence uppercased; canonical k-mer = lexicographic min of the
    forward k-mer string and its reverse complement *as strings*
    (solver.cpp:309-313). Complement maps only ACGT (misc.cpp:103-115);
    other bytes (N, IUPAC, ...) pass through, and comparison is plain
    byte order — so 'N' sorts between 'G' and 'T'.
  * sliding window of w k-mers; the window minimum with ties broken to
    the *rightmost* minimal k-mer (monotonic-deque pop rule ``>=``,
    solver.cpp:316-326).
  * one minimizer per window, run-compressed on equal consecutive
    *hashes* (solver.cpp:329-335); hash = MurmurHash3_x64_128 XOR-fold.

Two equivalent engines:
  * fast path: pure-ACGT sequences with k<=32 pack each k-mer into a
    62-bit integer whose numeric order equals string order;
  * general path: k-mers represented as ceil(k/8) big-endian uint64
    columns; ranks assigned by lexicographic sort. Handles arbitrary
    bytes exactly like the reference's std::string comparison.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .murmur import murmur3_x64_128_fold64

# uppercase table (::toupper on the whole sequence, solver.cpp:288)
_UPPER = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER[_c] = _c - 32

# complement table: only ACGT mapped (misc.cpp:103-115), case already upper
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b

_CODE2 = np.full(256, 255, np.uint8)
for _i, _a in enumerate(b"ACGT"):
    _CODE2[_a] = _i


@dataclass
class Minimizers:
    """Emitted minimizers of one sequence, in scan order."""

    hashes: np.ndarray  # uint64 [M]
    positions: np.ndarray  # int64 [M], start offset of the k-mer
    k: int


def _pack_cols_be(padded: np.ndarray, n_kmers: int, k: int) -> np.ndarray:
    """[n_kmers, ncols] big-endian uint64 columns of each k-mer."""
    ncols = (k + 7) // 8
    win = np.lib.stride_tricks.sliding_window_view(padded, 8)
    shifts = (np.uint64(8) * (np.uint64(7) - np.arange(8, dtype=np.uint64)))[None, :]
    be = (win.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)
    cols = np.empty((n_kmers, ncols), np.uint64)
    for j in range(ncols):
        cols[:, j] = be[8 * j : 8 * j + n_kmers]
    r = k - 8 * (ncols - 1)
    if r < 8:
        cols[:, ncols - 1] &= np.uint64(~((1 << (8 * (8 - r))) - 1) & (2**64 - 1))
    return cols


def _lex_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise lexicographic a < b over uint64 columns."""
    n, c = a.shape
    lt = np.zeros(n, bool)
    eq = np.ones(n, bool)
    for j in range(c):
        lt |= eq & (a[:, j] < b[:, j])
        eq &= a[:, j] == b[:, j]
    return lt


def _rank_rows(cols: np.ndarray) -> np.ndarray:
    """Dense ranks of rows under lexicographic order (equal rows = equal rank)."""
    n, c = cols.shape
    order = np.lexsort(tuple(cols[:, j] for j in range(c - 1, -1, -1)))
    srt = cols[order]
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    if n > 1:
        new_grp[1:] = np.any(srt[1:] != srt[:-1], axis=1)
    grp = np.cumsum(new_grp) - 1
    ranks = np.empty(n, np.int64)
    ranks[order] = grp
    return ranks


def _pack2bit(codes: np.ndarray, n_kmers: int, k: int) -> np.ndarray:
    """[n_kmers] uint64, 2-bit big-endian packing of each k-mer (k<=32).

    Packs 4 bases at a time via a precomputed quad byte to cut the
    shift-or loop from k to ~k/4 iterations."""
    out = np.zeros(n_kmers, np.uint64)
    n = len(codes)
    if n >= 4:
        quad = (
            (codes[: n - 3].astype(np.uint64) << np.uint64(6))
            | (codes[1 : n - 2].astype(np.uint64) << np.uint64(4))
            | (codes[2 : n - 1].astype(np.uint64) << np.uint64(2))
            | codes[3:].astype(np.uint64)
        )
    else:
        quad = None
    j = 0
    while j + 4 <= k:
        out |= quad[j : j + n_kmers] << np.uint64(2 * (k - 4 - j))
        j += 4
    c = codes.astype(np.uint64)
    while j < k:
        out |= c[j : j + n_kmers] << np.uint64(2 * (k - 1 - j))
        j += 1
    return out


def _window_min_rightmost(ranks: np.ndarray, w: int) -> np.ndarray:
    """Per-window position of the minimum, rightmost on ties.

    O(N) two-block sliding minimum over keys packed as
    ``rank << SH | (maxpos - j)`` so the packed minimum simultaneously
    encodes the minimal rank and, among equals, the largest position j —
    exactly the deque pop rule ``>=`` of solver.cpp:316-326.
    """
    nk = len(ranks)
    sh = max(1, int(nk - 1).bit_length())
    maxpos = (1 << sh) - 1
    packed = (ranks.astype(np.int64) << np.int64(sh)) | (
        np.int64(maxpos) - np.arange(nk, dtype=np.int64)
    )
    nw = nk - w + 1
    pad = (-nk) % w
    arr = np.concatenate(
        [packed, np.full(pad, np.iinfo(np.int64).max, np.int64)]
    )
    blocks = arr.reshape(-1, w)
    prefix = np.minimum.accumulate(blocks, axis=1).reshape(-1)
    suffix = np.minimum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    wmin = np.minimum(suffix[:nw], prefix[w - 1 : w - 1 + nw])
    return np.int64(maxpos) - (wmin & np.int64(maxpos))


def sketch_sequence(seq: str | bytes, k: int, w: int) -> Minimizers:
    """Scan one sequence; returns emitted minimizers (hash, start offset)."""
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("latin-1"), np.uint8)
    else:
        raw = np.frombuffer(bytes(seq), np.uint8)
    up = _UPPER[raw]
    n0 = len(up)
    empty = Minimizers(np.empty(0, np.uint64), np.empty(0, np.int64), k)
    if n0 < w + k - 1:
        return empty
    nk = n0 - k + 1

    cr = _COMP[up][::-1].copy()  # rc of kmer i == cr[n0-k-i : n0-i]

    codes = _CODE2[up]
    pure_acgt = k <= 31 and not np.any(codes == 255)
    if pure_acgt:
        fwd = _pack2bit(codes, nk, k)
        # rc kmer i starts at cr index n0-k-i; pack2bit over cr is indexed by
        # start-in-cr, so rc_i = packed_cr[n0-k-i]
        packed_cr = _pack2bit(_CODE2[cr], nk, k)
        rc = packed_cr[n0 - k - np.arange(nk)]
        is_rc = rc < fwd
        keys = np.where(is_rc, rc, fwd)
        # dense ranks (one sort) so ranks fit alongside a position field
        _, ranks = np.unique(keys, return_inverse=True)
        ranks = ranks.astype(np.int64)
    else:
        pad = np.zeros(7, np.uint8)
        fcols = _pack_cols_be(np.concatenate([up, pad]), nk, k)
        crcols = _pack_cols_be(np.concatenate([cr, pad]), nk, k)
        rcols = crcols[n0 - k - np.arange(nk)]
        is_rc = _lex_lt(rcols, fcols)
        keys = np.where(is_rc[:, None], rcols, fcols)
        ranks = _rank_rows(keys)

    # sliding-window min, rightmost tie (solver.cpp:316-326)
    nw = nk - w + 1
    minpos = _window_min_rightmost(ranks, w)

    # run-compress identical consecutive minimizer positions
    runstart = np.empty(nw, bool)
    runstart[0] = True
    runstart[1:] = minpos[1:] != minpos[:-1]
    cand_pos = minpos[runstart]

    # hash candidate k-mers (canonical bytes)
    m = len(cand_pos)
    take_rc = is_rc[cand_pos]
    rows = np.empty((m, k), np.uint8)
    ar = np.arange(k)
    fidx = np.nonzero(~take_rc)[0]
    if len(fidx):
        rows[fidx] = up[cand_pos[fidx, None] + ar[None, :]]
    ridx = np.nonzero(take_rc)[0]
    if len(ridx):
        rows[ridx] = cr[(n0 - k - cand_pos[ridx])[:, None] + ar[None, :]]
    hashes = murmur3_x64_128_fold64(rows)

    # emit where hash differs from previously emitted (solver.cpp:329-335);
    # prev_hash starts at UINT64_MAX
    emit = np.empty(m, bool)
    emit[0] = hashes[0] != np.uint64(0xFFFFFFFFFFFFFFFF)
    if m > 1:
        emit[1:] = hashes[1:] != hashes[:-1]
    # a suppressed duplicate does NOT update prev_hash in the reference,
    # but a suppressed candidate has hash == prev, so prev is unchanged
    # either way; plain consecutive-diff is exact.
    return Minimizers(hashes[emit], cand_pos[emit], k)
