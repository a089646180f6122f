"""Device sketching (K10 ``minimizer_sketch``): canonical (w,k)-minimizers
of 2-bit reads with their MurmurHash3, the CUDA kernel and its plain twin,
and the drivers that sketch haplotypes and reads with them.

Replaces ``dipgenie_tpu/ops/sketch_jax.py`` (``batch_minimizer_kernel``,
``murmur_fold64_device``, ``sketch_long_sequence_device``,
``sketch_reads_device``), with its semantics, which are the host scanner's
(``sketch/minimizers.py``) for pure-ACGT sequences:

* the canonical k-mer is min(forward, reverse complement) in string
  order; a k-mer starting past ``lens - k`` is all ones and never wins;
* each window of w k-mers takes its minimum, the rightmost of equals;
* a window emits where it is valid (``j <= lens - k - w + 1``) and its
  minimum differs from the previous window's (window 0 always, when
  valid): duplicates are suppressed by k-mer value, which equal values
  hash alike;
* every window's minimum is hashed with MurmurHash3_x64_128 over its k
  ASCII bytes, the two halves XOR-folded to 64 bits.

``batch_minimizer`` returns ``(hash_hi, hash_lo, emit, minpos)``, each
``[B, NW]`` with ``NW = L - k - w + 2``: the hash halves as int32 tensors
holding the u32 bit patterns, ``emit`` bool, ``minpos`` int32 (the
winner's start). On the card it is one launch of ``csrc/sketch.cu``; on
the CPU its plain twin ``batch_minimizer_ref``, which packs a k-mer into
two 16-base lanes and computes the 64-bit hash on 32-bit halves held in
int64 tensors, as the JAX package does on uint32. Two 16-base lanes hold
at most 32 bases, so the device path takes ``k <= 32``.

The drivers send a sequence with a non-ACGT character, or shorter than
``w + k - 1``, to the host scanner, as the JAX package does (the
reference's semantics, not a fallback), and count those rows
(``sketch_reads_device.host_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..sketch.minimizers import sketch_sequence

K_MAX = 32
M32 = 0xFFFFFFFF
# codes a launch of the read driver takes at most ([rows, L] u8; its
# outputs are 13 bytes a window)
LAUNCH_CODES = 1 << 25

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i
_CHARS = (65, 67, 71, 84)  # 'A', 'C', 'G', 'T'


def check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(
            f"device sketching takes 1 <= k <= {K_MAX} (a k-mer is two "
            f"16-base lanes); k = {k}: use --sketch-backend host")


def encode_reads(seqs: list[str], pad_to: int | None = None):
    """Host side: uppercase 2-bit codes. ``(codes [B, L] u8, lens [B]
    int32, pure [B] bool)``, ``L = pad_to`` or the longest sequence; a
    sequence is cut to ``L``; a non-ACGT character codes as 0 and makes its
    row impure (the host path)."""
    B = len(seqs)
    lens = np.fromiter(map(len, seqs), np.int64, B)
    L = pad_to or int(lens.max(initial=1))
    if lens.max(initial=0) > L:
        seqs = [s[:L] for s in seqs]
        lens = np.minimum(lens, L)
    raw = np.frombuffer("".join(seqs).encode("latin-1"), np.uint8)
    flat = _CODE[raw]
    bad = flat == 255
    rows = np.repeat(np.arange(B), lens)
    pure = np.bincount(rows[bad], minlength=B) == 0
    codes = np.zeros((B, L), np.uint8)
    codes[np.arange(L)[None, :] < lens[:, None]] = np.where(bad, 0, flat)
    return codes, lens.astype(np.int32), pure


# ---------------- 64-bit arithmetic on 32-bit halves ----------------
# Every value is an int64 tensor in [0, 2^32), masked after each product
# and left shift (int64 ``>>`` is arithmetic, so values stay non-negative).

def _mul32_lo(a, b):
    """(a * b) mod 2^32."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + (((a1 * b0 + a0 * b1) & 0xFFFF) << 16)) & M32


def _mul32(a, b):
    """The full 64-bit product of two u32 values as (hi, lo)."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    t = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((t << 16) & M32)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (t >> 16)) & M32
    return hi, lo


def _mul64(ah, al, bh, bl):
    hi, lo = _mul32(al, bl)
    return (hi + _mul32_lo(al, bh) + _mul32_lo(ah, bl)) & M32, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _rotl64(h, l, r: int):
    if r == 32:
        return l, h
    if r > 32:
        h, l, r = l, h, r - 32
    return (((h << r) & M32) | (l >> (32 - r)),
            ((l << r) & M32) | (h >> (32 - r)))


def _shr33(h, l):
    return h * 0, h >> 1


def _fmix64(h, l):
    for c in ((0xFF51AFD7, 0xED558CCD), (0xC4CEB9FE, 0x1A85EC53)):
        sh, sl = _shr33(h, l)
        h, l = _mul64(h ^ sh, l ^ sl, *c)
    sh, sl = _shr33(h, l)
    return h ^ sh, l ^ sl


def _le64(cols):
    """(hi, lo) of the little-endian word of up to 8 byte columns."""
    hi, lo = cols[0] * 0, cols[0] * 0
    for i, c in enumerate(cols):
        if i < 4:
            lo = lo | (c << (8 * i))
        else:
            hi = hi | (c << (8 * (i - 4)))
    return hi, lo


_C1 = (0x87C37B91, 0x114253D5)
_C2 = (0x4CF5AD43, 0x2745937F)


def murmur_fold64_ref(cols) -> tuple[torch.Tensor, torch.Tensor]:
    """MurmurHash3_x64_128 (seed 0), XOR-folded, of fixed-length messages:
    ``cols`` is a list of ``length`` int64 tensors of one shape (the
    messages' bytes), or one int64 tensor ``[..., length]``. Returns
    ``(hash_hi, hash_lo)`` int64 tensors in ``[0, 2^32)``."""
    if isinstance(cols, torch.Tensor):
        cols = list(cols.unbind(-1))
    length = len(cols)
    z = cols[0] * 0
    h1h, h1l, h2h, h2l = z, z, z, z

    def mix1(kh, kl):
        kh, kl = _mul64(kh, kl, *_C1)
        kh, kl = _rotl64(kh, kl, 31)
        return _mul64(kh, kl, *_C2)

    def mix2(kh, kl):
        kh, kl = _mul64(kh, kl, *_C2)
        kh, kl = _rotl64(kh, kl, 33)
        return _mul64(kh, kl, *_C1)

    nblocks = length // 16
    for b in range(nblocks):
        k1h, k1l = mix1(*_le64(cols[16 * b:16 * b + 8]))
        h1h, h1l = _rotl64(h1h ^ k1h, h1l ^ k1l, 27)
        h1h, h1l = _add64(h1h, h1l, h2h, h2l)
        h1h, h1l = _add64(*_mul64(h1h, h1l, 0, 5), 0, 0x52DCE729)
        k2h, k2l = mix2(*_le64(cols[16 * b + 8:16 * b + 16]))
        h2h, h2l = _rotl64(h2h ^ k2h, h2l ^ k2l, 31)
        h2h, h2l = _add64(h2h, h2l, h1h, h1l)
        h2h, h2l = _add64(*_mul64(h2h, h2l, 0, 5), 0, 0x38495AB5)
    tail = cols[16 * nblocks:]
    if len(tail) > 8:
        k2h, k2l = mix2(*_le64(tail[8:]))
        h2h, h2l = h2h ^ k2h, h2l ^ k2l
    if tail:
        k1h, k1l = mix1(*_le64(tail[:8]))
        h1h, h1l = h1h ^ k1h, h1l ^ k1l
    h1l, h2l = h1l ^ length, h2l ^ length
    h1h, h1l = _add64(h1h, h1l, h2h, h2l)
    h2h, h2l = _add64(h2h, h2l, h1h, h1l)
    h1h, h1l = _fmix64(h1h, h1l)
    h2h, h2l = _fmix64(h2h, h2l)
    h1h, h1l = _add64(h1h, h1l, h2h, h2l)
    h2h, h2l = _add64(h2h, h2l, h1h, h1l)
    return h1h ^ h2h, h1l ^ h2l


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _check_inputs(codes, lens, k: int, w: int) -> int:
    """Raise unless ``codes [B, L]`` u8 and ``lens [B]`` int32 on one
    device give at least one window; returns NW."""
    check_k(k)
    if not isinstance(codes, torch.Tensor) or codes.dtype != torch.uint8 \
            or codes.dim() != 2:
        raise ValueError(f"codes: want a [B, L] uint8 tensor, got "
                         f"{getattr(codes, 'dtype', type(codes))}")
    if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32 \
            or tuple(lens.shape) != (codes.shape[0],):
        raise ValueError(f"lens: want an int32 tensor [{codes.shape[0]}]")
    if lens.device != codes.device:
        raise ValueError(f"lens on {lens.device}, codes on {codes.device}")
    if w < 1:
        raise ValueError(f"w = {w}, want >= 1")
    nw = codes.shape[1] - k - w + 2
    if nw < 1 or codes.shape[0] < 1:
        raise ValueError(f"codes {tuple(codes.shape)} hold no window of "
                         f"k = {k}, w = {w}")
    return nw


def batch_minimizer_ref(codes: torch.Tensor, lens: torch.Tensor, k: int,
                        w: int):
    """Plain PyTorch version of K10 (see the module docstring)."""
    nw = _check_inputs(codes, lens, k, w)
    B, L = codes.shape
    nk = L - k + 1
    c = codes.to(torch.int64)
    k1, k2 = min(k, 16), k - min(k, 16)

    def pack(cols):
        acc = torch.zeros((B, nk), dtype=torch.int64, device=c.device)
        for col in cols:
            acc = (acc << 2) | col
        return acc << (2 * (16 - len(cols)))

    fcols = [c[:, j:j + nk] for j in range(k)]
    rcols = [3 - fcols[k - 1 - j] for j in range(k)]
    fhi, flo = pack(fcols[:k1]), pack(fcols[k1:])
    rhi, rlo = pack(rcols[:k1]), pack(rcols[k1:])
    is_rc = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    kvalid = (torch.arange(nk, device=c.device)[None, :]
              <= (lens.to(torch.int64)[:, None] - k))
    chi = torch.where(kvalid, torch.where(is_rc, rhi, fhi), M32)
    clo = torch.where(kvalid, torch.where(is_rc, rlo, flo), M32)

    bh, bl = chi[:, :nw], clo[:, :nw]
    bpos = torch.arange(nw, device=c.device).repeat(B, 1)
    for s in range(1, w):
        ch, cl = chi[:, s:s + nw], clo[:, s:s + nw]
        take = (ch < bh) | ((ch == bh) & (cl <= bl))
        bh, bl = torch.where(take, ch, bh), torch.where(take, cl, bl)
        bpos = torch.where(
            take, torch.arange(s, s + nw, device=c.device)[None, :], bpos)

    wvalid = (torch.arange(nw, device=c.device)[None, :]
              <= (lens.to(torch.int64)[:, None] - k - w + 1))
    emit = torch.ones((B, nw), dtype=torch.bool, device=c.device)
    emit[:, 1:] = (bh[:, 1:] != bh[:, :-1]) | (bl[:, 1:] != bl[:, :-1])
    emit &= wvalid

    chars = torch.tensor(_CHARS, dtype=torch.int64, device=c.device)
    byte_cols = [chars[((bh if j < 16 else bl) >> (2 * (15 - j % 16))) & 3]
                 for j in range(k)]
    hh, hl = murmur_fold64_ref(byte_cols)
    return _as_int32(hh), _as_int32(hl), emit, bpos.to(torch.int32)


def batch_minimizer(codes: torch.Tensor, lens: torch.Tensor, k: int, w: int):
    """K10. CUDA tensors launch ``csrc/sketch.cu`` (one launch); CPU
    tensors take ``batch_minimizer_ref``."""
    if codes.device.type == "cpu":
        return batch_minimizer_ref(codes, lens, k, w)
    nw = _check_inputs(codes, lens, k, w)
    kernels.check_tensor(codes, "codes", torch.uint8)
    kernels.check_tensor(lens, "lens", torch.int32, None, codes.device)
    B = codes.shape[0]
    out = [torch.empty((B, nw), dtype=dt, device=codes.device)
           for dt in (torch.int32, torch.int32, torch.bool, torch.int32)]
    rc = kernels.lib().dg_sketch(
        codes.data_ptr(), lens.data_ptr(), B, codes.shape[1], k, w,
        *(t.data_ptr() for t in out), kernels.stream_of(codes))
    kernels.raise_on_error(rc, "batch_minimizer")
    batch_minimizer.launches += 1
    return tuple(out)


batch_minimizer.launches = 0


def join64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """uint64 hashes (numpy, on the host) of int32 hash halves."""
    pair = torch.stack([lo, hi], -1).contiguous()
    return pair.view(torch.int64).reshape(-1).cpu().numpy().view(np.uint64)


def sketch_long_sequence_device(seq: str, k: int, w: int, device="cuda"):
    """Device sketch of one long (haplotype) sequence: ``(hashes uint64,
    positions int64)`` in scan order, those of the host scanner. A
    non-ACGT sequence, or one shorter than ``w + k - 1``, takes the host
    scanner."""
    dev = resolve_device(device)
    check_k(k)
    codes, lens, pure = encode_reads([seq], len(seq))
    if not pure[0] or len(seq) < w + k - 1:
        m = sketch_sequence(seq, k, w)
        return m.hashes, m.positions
    hh, hl, emit, minpos = batch_minimizer(
        torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), k, w)
    sel = emit[0]
    return (join64(hh[0][sel], hl[0][sel]),
            minpos[0][sel].cpu().numpy().astype(np.int64))


def _sketch_rows(seqs: list[str], k: int, w: int, batch: int | None, dev):
    """``(rows, hashes, host_rows)``: the distinct (row, hash) pairs of the
    sequences' minimizers ordered by row then unsigned hash, and the count
    of rows the host scanner took."""
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    on_card = np.nonzero(lens >= w + k - 1)[0]
    on_card = on_card[np.argsort(lens[on_card], kind="stable")]
    host = [int(i) for i in np.nonzero(lens < w + k - 1)[0]]
    rows, hashes = [], []
    s0 = 0
    while s0 < len(on_card):
        # the most rows, shortest first, whose [rows, L] codes fit a launch
        fits = np.arange(1, len(on_card) - s0 + 1) * lens[on_card[s0:]]
        n = max(int(np.searchsorted(fits, LAUNCH_CODES, side="right")), 1)
        chunk = on_card[s0:s0 + (n if batch is None else min(n, batch))]
        codes, clens, pure = encode_reads([seqs[i] for i in chunk],
                                          int(lens[chunk[-1]]))
        hh, hl, emit, _ = batch_minimizer(torch.from_numpy(codes).to(dev),
                                          torch.from_numpy(clens).to(dev),
                                          k, w)
        emit &= torch.from_numpy(pure).to(dev)[:, None]
        r, c = emit.nonzero(as_tuple=True)
        rows.append(chunk[r.cpu().numpy()])
        hashes.append(join64(hh[r, c], hl[r, c]))
        host += [int(i) for i in chunk[~pure]]
        s0 += len(chunk)
    for i in host:
        h = sketch_sequence(seqs[i], k, w).hashes
        rows.append(np.full(len(h), i, np.int64))
        hashes.append(h)
    rows = np.concatenate(rows) if rows else np.empty(0, np.int64)
    hashes = np.concatenate(hashes) if hashes else np.empty(0, np.uint64)
    order = np.lexsort((hashes, rows))
    rows, hashes = rows[order], hashes[order]
    keep = np.ones(len(rows), bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (hashes[1:] != hashes[:-1])
    return rows[keep], hashes[keep], len(host)


def sketch_reads_device(seqs: list[str], k: int, w: int,
                        batch: int | None = None, mesh=None, device="cuda"):
    """Device sketch of many reads: per read, its distinct minimizer hashes
    (``np.unique``: uint64, unsigned ascending), those of the host scanner.
    Reads are packed into as few launches as ``LAUNCH_CODES`` allows
    (``batch`` caps the rows of a launch), shortest first.

    With a ``mesh`` (``parallel.mesh.Mesh``) the reads, padded to a multiple
    of its ``n_dp`` with empty reads, are cut into ``n_dp`` contiguous
    shares; each dp rank sketches its own, and the results are gathered
    over ``mesh.dp``, so every rank returns the same list."""
    dev = resolve_device(device)
    check_k(k)
    n = len(seqs)
    if n == 0:
        return []
    lo, hi = 0, n
    if mesh is not None:
        share = -(-n // mesh.n_dp)
        lo = min(mesh.dp_rank * share, n)
        hi = min(lo + share, n)
    rows, hashes, host = _sketch_rows(seqs[lo:hi], k, w, batch, dev)
    rows = rows + lo
    sketch_reads_device.host_rows = host
    if mesh is not None and mesh.n_dp > 1:
        import torch.distributed as dist

        parts = [None] * mesh.n_dp
        dist.all_gather_object(parts, (rows, hashes, host), group=mesh.dp)
        rows = np.concatenate([p[0] for p in parts])
        hashes = np.concatenate([p[1] for p in parts])
        sketch_reads_device.host_rows = sum(p[2] for p in parts)
    cuts = np.searchsorted(rows, np.arange(1, n))
    return np.split(hashes, cuts)


sketch_reads_device.host_rows = 0
