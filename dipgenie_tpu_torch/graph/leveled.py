"""CSR view of a levelized expanded graph (native-levelizer output).

Exposes the exact attribute surface the diploid solver and stitcher use
on ExpandedGraph (`adj_list[u]`, `color[v]`, `original_vertex[v]`,
`haplotype[v]`, `level[v]`, `vertices_in_level[l]`), backed by dense
arrays — per-level vertex ids are consecutive, so `vertices_in_level[l]`
is a range. Built by `levelize_native` from a topologically-reordered
ExpandedGraph via dgcore's `dg_levelize_run` (the C++ port of
strict_bfs_levelize_and_reorder, ExpandedGraph.hpp:269-409).
"""

from __future__ import annotations

import numpy as np

from .expanded import ExpandedGraph


class _CsrAdj:
    def __init__(self, adj_ptr, adj_v, adj_w):
        self.ptr = adj_ptr
        self.v = adj_v
        self.w = adj_w

    def __len__(self):
        return len(self.ptr) - 1

    def __getitem__(self, u):
        s, e = int(self.ptr[u]), int(self.ptr[u + 1])
        return list(zip(self.v[s:e].tolist(), self.w[s:e].tolist()))


class _Derived:
    """original_vertex / color accessor: final vertex -> pre-levelize data."""

    def __init__(self, src_old, is_dummy, base, empty_for_dummy):
        self.src_old = src_old
        self.is_dummy = is_dummy
        self.base = base
        self.empty_for_dummy = empty_for_dummy

    def __len__(self):
        return len(self.src_old)

    def __getitem__(self, v):
        if self.empty_for_dummy and self.is_dummy[v]:
            return []
        return self.base[int(self.src_old[v])]


class _LevelRanges:
    def __init__(self, level_ptr):
        self.level_ptr = level_ptr

    def __len__(self):
        return len(self.level_ptr) - 1

    def __getitem__(self, l):
        return range(int(self.level_ptr[l]), int(self.level_ptr[l + 1]))


class LeveledGraph:
    """Duck-typed stand-in for a levelized ExpandedGraph."""

    def __init__(self, level_ptr, adj_ptr, adj_v, adj_w, level, src_old,
                 is_dummy, pre: ExpandedGraph, max_width: int):
        self.level_ptr = level_ptr
        self.csr = (adj_ptr, adj_v, adj_w)
        self.adj_list = _CsrAdj(adj_ptr, adj_v, adj_w)
        self.level = level
        self.src_old = src_old
        self.is_dummy = is_dummy
        self.pre = pre
        self.max_width = max_width
        self.vertices_in_level = _LevelRanges(level_ptr)
        self.original_vertex = _Derived(
            src_old, is_dummy, pre.original_vertex, empty_for_dummy=False
        )
        self.color = _Derived(src_old, is_dummy, pre.color, empty_for_dummy=True)
        hap = np.asarray(pre.haplotype, np.int64)
        self.haplotype = hap[src_old]

    def color_csr(self, color_homo_bv):
        """(hom_ptr, hom_colors, het_ptr, het_colors) over final ids."""
        pre = self.pre
        n = len(self.src_old)
        chb = np.asarray(color_homo_bv, bool)
        if hasattr(pre, "col_ptr"):  # CsrExpandedGraph
            pptr = np.asarray(pre.col_ptr, np.int64)
            pvals = np.asarray(pre.col_v, np.int64)
            pcnt = pptr[1:] - pptr[:-1]
        else:
            pcnt = np.asarray([len(c) for c in pre.color], np.int64)
            pptr = np.zeros(len(pre.color) + 1, np.int64)
            np.cumsum(pcnt, out=pptr[1:])
            pvals = np.fromiter(
                (c for cs in pre.color for c in cs), np.int64, int(pptr[-1])
            )
        src = self.src_old.astype(np.int64)
        lens = np.where(self.is_dummy.astype(bool), 0, pcnt[src])
        total = int(lens.sum())
        if total:
            starts = pptr[src]
            cum = np.cumsum(lens) - lens
            within = np.arange(total) - np.repeat(cum, lens)
            vals = pvals[np.repeat(starts, lens) + within]
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        else:
            vals = np.empty(0, np.int64)
            rows = np.empty(0, np.int64)
        is_h = chb[vals] if total else np.zeros(0, bool)
        hom_ptr = np.zeros(n + 1, np.int64)
        het_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows[is_h], minlength=n), out=hom_ptr[1:])
        np.cumsum(np.bincount(rows[~is_h], minlength=n), out=het_ptr[1:])
        return (hom_ptr, vals[is_h].astype(np.int32),
                het_ptr, vals[~is_h].astype(np.int32))


def levelize_native(g: ExpandedGraph) -> LeveledGraph:
    """Run the C++ levelizer on a (topologically reordered) graph."""
    from .. import native

    lib = native.get_lib()
    n = len(g.adj_list)
    if hasattr(g, "csr"):  # CsrExpandedGraph: arrays already dense
        adj_ptr, adj_v, adj_w = g.csr
        adj_ptr = np.ascontiguousarray(adj_ptr, np.int64)
        adj_v = np.ascontiguousarray(adj_v, np.int32)
        adj_w = np.ascontiguousarray(adj_w, np.int8)
    else:
        deg = np.fromiter((len(a) for a in g.adj_list), np.int64, n)
        adj_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=adj_ptr[1:])
        ne = int(adj_ptr[-1])
        flat = np.fromiter(
            (x for a in g.adj_list for vw in a for x in vw), np.int64, 2 * ne
        )
        adj_v = np.ascontiguousarray(flat[0::2], np.int32)
        adj_w = np.ascontiguousarray(flat[1::2], np.int8)
    rc = lib.dg_levelize_run(n, adj_ptr, adj_v, adj_w)
    if rc == -2:
        raise SystemExit("Uh oh, multiple potential sources found while leveling")
    if rc != 0:
        raise RuntimeError(f"dg_levelize_run failed rc={rc}")
    n1 = lib.dg_levelize_n()
    ne1 = lib.dg_levelize_ne()
    nl = lib.dg_levelize_nl()
    maxw = lib.dg_levelize_maxwidth()
    level = np.empty(n1, np.int32)
    src_old = np.empty(n1, np.int32)
    is_dummy = np.empty(n1, np.int8)
    o_ptr = np.empty(n1 + 1, np.int64)
    o_v = np.empty(ne1, np.int32)
    o_w = np.empty(ne1, np.int8)
    level_ptr = np.empty(nl + 1, np.int64)
    lib.dg_levelize_fetch(level, src_old, is_dummy, o_ptr, o_v, o_w, level_ptr)
    return LeveledGraph(level_ptr, o_ptr, o_v, o_w, level, src_old, is_dummy,
                        g, int(maxw))
