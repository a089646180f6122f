"""Core pangenome data model: forward-strand adjacency, walks, and the
MSA-like topological column order.

Equivalent of the reference ``Solver::read_gfa``
(reference: src/solver.cpp:27-227):

  * forward-strand adjacency: for every arc whose head vertex is on the
    forward strand, append ``tail_seg`` to ``adj_list[head_seg]``
    (solver.cpp:60-91). Orientation of the tail is dropped.
  * walks must be forward-strand only after gfa_walk_flip; a reverse
    vertex aborts (solver.cpp:116-119).
  * MSA-like column order: seed each vertex with its earliest walk
    offset, park never-walked vertices after the last seeded column,
    iterate ``pos[v] >= pos[u]+1`` along every walk to fixpoint, then
    densify to ranks (solver.cpp:127-199).
  * per-vertex adjacency sorted by (column, id) (solver.cpp:216-223).

Vectorized with numpy: the per-walk monotonicity pass is the scan
``pos'[t] = max(pos[t], pos'[t-1]+1)`` computed as
``t + cummax(pos[walk] - t)``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..io.gfa import Gfa


@dataclass
class PangenomeIndex:
    n_vtx: int = 0  # forward-strand (segment) count
    lin_ref: bool = False
    num_walks: int = 0
    node_seq: list[str] = field(default_factory=list)
    node_len: np.ndarray | None = None
    adj_list: list[np.ndarray] = field(default_factory=list)  # sorted by column
    adj_ptr: np.ndarray | None = None  # CSR form of adj_list
    adj_flat: np.ndarray | None = None
    paths: list[np.ndarray] = field(default_factory=list)  # walk -> seg ids
    haps: list[np.ndarray] = field(default_factory=list)  # seg -> walk ids (int64) containing it
    in_paths: np.ndarray | None = None  # [num_walks, n_vtx] 0/1
    hap_id2name: list[str] = field(default_factory=list)
    top_order: np.ndarray | None = None
    top_order_map: np.ndarray | None = None
    dense_pos: np.ndarray | None = None  # MSA column per vertex

    @classmethod
    def from_gfa(cls, g: Gfa) -> "PangenomeIndex":
        self = cls()
        n = g.n_seg
        self.n_vtx = n
        self.node_seq = [s if s is not None else "" for s in g.seg_seqs]
        self.node_len = np.asarray(g.seg_lens, np.int64)

        # forward-strand adjacency (solver.cpp:60-91); edge (head, tail)
        # pairs collected now, sorted + materialized after column order
        if len(g.arcs) == 0:
            self.lin_ref = True
            heads = tails = np.zeros(0, np.int64)
        else:
            arcs = np.asarray(g.arcs, np.int64).reshape(-1, 5)
            fwd = (arcs[:, 0] & 1) == 0
            heads = arcs[fwd, 0] >> 1
            tails = arcs[fwd, 1] >> 1

        # walks (solver.cpp:103-125)
        self.num_walks = len(g.walks)
        self.in_paths = np.zeros((self.num_walks, n), np.int8)
        for wi, w in enumerate(g.walks):
            self.hap_id2name.append(f"{w.sample}.{w.hap}")
            if np.any(w.v & 1):
                print(
                    f"Error: walk {wi} has reverse-strand vertices after flip",
                    file=sys.stderr,
                )
                raise SystemExit(1)
            segs = (w.v >> 1).astype(np.int64)
            self.paths.append(segs)
            self.in_paths[wi, segs] = 1
        # haps[v] = walk ids containing v, in (walk, position) append order
        # (solver.cpp:110-114); vectorized via stable sort by segment
        if n and self.paths:
            all_segs = np.concatenate(self.paths) if self.num_walks else np.zeros(0, np.int64)
            all_wi = np.repeat(
                np.arange(self.num_walks, dtype=np.int64),
                [len(p) for p in self.paths],
            )
            o = np.argsort(all_segs, kind="stable")
            counts = np.bincount(all_segs, minlength=n)
            bounds = np.cumsum(counts)[:-1]
            self.haps = np.split(all_wi[o], bounds)
        else:
            self.haps = [np.zeros(0, np.int64) for _ in range(n)]

        # ---- MSA-like column order (solver.cpp:127-199) ----
        INF = np.iinfo(np.int64).max // 4
        pos = np.full(n, INF, np.int64)
        for pw in self.paths:
            if len(pw) == 0:
                continue
            t = np.arange(len(pw), dtype=np.int64)
            np.minimum.at(pos, pw, t)  # earliest column of each vertex
        seeded = pos != INF
        fallback = (pos[seeded].max() + 1) if seeded.any() else 0
        pos[~seeded] = fallback

        # iterate monotonicity to fixpoint (solver.cpp:158-171)
        iter_cap = max(10, n)
        for _ in range(iter_cap):
            changed = False
            for pw in self.paths:
                if len(pw) < 2:
                    continue
                t = np.arange(len(pw), dtype=np.int64)
                cur = pos[pw]
                scanned = np.maximum.accumulate(cur - t) + t
                if np.any(scanned > cur):
                    changed = True
                    # last-occurrence write == max over occurrences here
                    np.maximum.at(pos, pw, scanned)
            if not changed:
                break

        # densify (solver.cpp:173-189): order by (pos, id), ranks per column
        order = np.lexsort((np.arange(n), pos))
        sorted_pos = pos[order]
        col_start = np.empty(n, bool)
        if n:
            col_start[0] = True
            col_start[1:] = sorted_pos[1:] != sorted_pos[:-1]
        ranks = np.cumsum(col_start) - 1
        dense_pos = np.empty(n, np.int64)
        dense_pos[order] = ranks

        self.top_order = order
        self.top_order_map = np.empty(n, np.int64)
        self.top_order_map[order] = np.arange(n)
        self.dense_pos = dense_pos

        # sort adjacency by (column, id) (solver.cpp:216-223) — one global
        # lexsort over (head, column(tail), tail), then split per head
        if len(heads):
            o = np.lexsort((tails, dense_pos[tails], heads))
            flat = tails[o]
            ptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(heads, minlength=n), out=ptr[1:])
        else:
            flat = np.zeros(0, np.int64)
            ptr = np.zeros(n + 1, np.int64)
        self.adj_ptr = ptr  # CSR view (consumed by the native builder)
        self.adj_flat = flat
        self.adj_list = [flat[ptr[u] : ptr[u + 1]] for u in range(n)]
        return self

    def haplotype_seq(self, h: int) -> str:
        """Concatenated walk sequence (solver.cpp:283-299), raw case."""
        return "".join(self.node_seq[v] for v in self.paths[h])
