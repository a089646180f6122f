"""Vectorized MurmurHash3 x64_128 with 64-bit XOR fold.

The reference hashes every minimizer k-mer string with
``MurmurHash3_x64_128(str, len, seed=0)`` and folds the two 64-bit
outputs with XOR (reference: src/solver.cpp:16-24, src/MurmurHash3.cpp:255).
This module reproduces that bit-for-bit, vectorized over a batch of
equal-length byte rows with numpy uint64 lanes (wrapping arithmetic).

Public-domain algorithm (Austin Appleby's MurmurHash3 spec);
implementation here is an independent numpy vectorization.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_M5 = np.uint64(5)
_N1 = np.uint64(0x52DCE729)
_N2 = np.uint64(0x38495AB5)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _fmix64(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * _F1
    k = k ^ (k >> np.uint64(33))
    k = k * _F2
    k = k ^ (k >> np.uint64(33))
    return k


def murmur3_x64_128_fold64(data: np.ndarray, seed: int = 0) -> np.ndarray:
    """Hash each row of a [M, L] uint8 array; returns [M] uint64 = h1^h2."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.ndim == 1:
        data = data[None, :]
    M, L = data.shape
    h1 = np.full(M, seed, np.uint64)
    h2 = np.full(M, seed, np.uint64)
    nblocks = L // 16

    u64 = data[:, : nblocks * 16].reshape(M, nblocks, 2, 8).astype(np.uint64)
    shifts = (np.arange(8, dtype=np.uint64) * np.uint64(8))[None, None, None, :]
    blocks = (u64 << shifts).sum(axis=3, dtype=np.uint64)  # little-endian

    for b in range(nblocks):
        k1 = blocks[:, b, 0]
        k2 = blocks[:, b, 1]
        k1 = _rotl(k1 * _C1, 31) * _C2
        h1 = h1 ^ k1
        h1 = _rotl(h1, 27) + h2
        h1 = h1 * _M5 + _N1
        k2 = _rotl(k2 * _C2, 33) * _C1
        h2 = h2 ^ k2
        h2 = _rotl(h2, 31) + h1
        h2 = h2 * _M5 + _N2

    tail = data[:, nblocks * 16 :].astype(np.uint64)
    nt = L & 15
    if nt > 8:
        k2 = np.zeros(M, np.uint64)
        for i in range(nt - 1, 7, -1):
            k2 = k2 ^ (tail[:, i] << np.uint64(8 * (i - 8)))
        h2 = h2 ^ (_rotl(k2 * _C2, 33) * _C1)
    if nt > 0:
        k1 = np.zeros(M, np.uint64)
        for i in range(min(nt, 8) - 1, -1, -1):
            k1 = k1 ^ (tail[:, i] << np.uint64(8 * i))
        h1 = h1 ^ (_rotl(k1 * _C1, 31) * _C2)

    ln = np.uint64(L)
    h1 = h1 ^ ln
    h2 = h2 ^ ln
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1 ^ h2
