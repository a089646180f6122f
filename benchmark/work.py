"""The work of the DP's forward, counted from the CSR arrays and R alone.

The same count for every tier and every plan layout of one graph, so a
change to the program's layouts cannot move it. ``forward_work`` gives
``(operations, bytes)``:

* operations: for each candidate of each transition (a pair of edges out
  of its level, as ``reference.py`` enumerates them) an add and a max for
  each destination row it reaches (``R + 1 - w1 - w2`` rows), plus its
  score: per 32-bit colour word of the transition (the colours found on
  its two levels), an OR of the two sources' words, an OR of the two
  destinations', an AND or an XOR and a popcount, for HOM and for HET (8),
  and one add of the two popcounts;
* bytes: the CSR arrays read once, the last level's states (int32) and
  the transitions (7 int32 each) written once. Backpointers are left out:
  they are an implementation's choice, not an output.

``least_seconds`` is the larger of operations over the card's int32 rate
and bytes over its memory bandwidth (``peaks.json``).
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None where the table has no row for it."""
    with open(os.path.join(HERE, "peaks.json")) as fh:
        return json.load(fh)["cards"].get(kind)


def colour_words32(level_ptr, hom_ptr, hom, het_ptr, het) -> np.ndarray:
    """Per transition, the 32-bit words that hold the colours found on its
    two levels."""
    L = len(level_ptr) - 1
    n = int(level_ptr[-1])
    lvl = np.repeat(np.arange(L), np.diff(level_ptr))
    v = np.concatenate([np.repeat(np.arange(n), np.diff(hom_ptr)),
                        np.repeat(np.arange(n), np.diff(het_ptr))])
    c = np.concatenate([hom, het]).astype(np.int64)
    t = np.concatenate([lvl[v], lvl[v] - 1])
    cc = np.concatenate([c, c])
    ok = (t >= 0) & (t < L - 1)
    t, cc = t[ok], cc[ok]
    cmax = int(cc.max(initial=0)) + 1
    pairs = np.unique(t * cmax + cc)
    per = np.bincount(pairs // cmax, minlength=L - 1)
    return -(-per // 32)


def forward_work(csr, R: int) -> tuple[int, int]:
    level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom, het_ptr, het = csr
    level_ptr = np.asarray(level_ptr, np.int64)
    adj_ptr = np.asarray(adj_ptr, np.int64)
    L = len(level_ptr) - 1
    # edges out of each level, by weight
    first = adj_ptr[level_ptr[:-1]]
    lvl_of_edge = np.searchsorted(first, np.arange(int(adj_ptr[-1])),
                                  side="right") - 1
    w = np.asarray(adj_w, np.int64)
    wmax = int(w.max(initial=0))
    h = np.zeros((L - 1, wmax + 1), np.int64)
    np.add.at(h, (lvl_of_edge, w), 1)
    row_ops = np.zeros(L - 1, np.int64)
    for a in range(wmax + 1):
        for b in range(wmax + 1):
            row_ops += h[:, a] * h[:, b] * max(0, R + 1 - a - b)
    E = h.sum(1)
    words = colour_words32(level_ptr, hom_ptr, hom, het_ptr, het)
    ops = int(2 * row_ops.sum() + (E * E * (8 * words + 1)).sum())
    k_last = int(level_ptr[-1] - level_ptr[-2])
    nbytes = (sum(np.asarray(a).nbytes for a in csr)
              + (R + 1) * k_last * k_last * 4 + (L - 1) * 7 * 4)
    return ops, int(nbytes)


def least_seconds(csr, R: int, card: dict) -> float:
    ops, nbytes = forward_work(csr, R)
    return max(ops / card["int32_ops_per_s"], nbytes / card["hbm_bytes_per_s"])
