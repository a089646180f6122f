"""Haplotype-expanded graph: construction, topological reorder, strict
BFS levelization with dummy-vertex insertion.

Equivalent of the reference ``ExpandedGraph``
(reference: src/ExpandedGraph.hpp) plus the construction performed in
``Approximator::solve`` (reference: src/approximator.cpp:1014-1256):

  * one chain of vertices per haplotype walk + global source/sink
    (approximator.cpp:1029-1049);
  * one weight-1 edge per off-walk original edge into a shared
    recombination vertex ``w_{u,j}``, which fans out with weight-0 edges
    to every haplotype's copy of the target vertex
    (approximator.cpp:1051-1095);
  * per-anchor-occurrence super-nodes carrying colour sets, with a sweep
    per haplotype that links touching/overlapping anchors and propagates
    colours through containment (approximator.cpp:1114-1246);
  * Kahn topological reorder with the sink forced last
    (ExpandedGraph.hpp:29-102);
  * strict BFS levelization: BFS + topo level relaxation + dummy chains
    so every edge spans exactly one level, then reorder by (level, id)
    (ExpandedGraph.hpp:269-409).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from typing import TYPE_CHECKING

from ..graph.pangenome import PangenomeIndex

if TYPE_CHECKING:
    from ..solver.anchors import AnchorData


@dataclass
class AnchorRec:
    """approximator.cpp AnchorRec: one anchor occurrence on a haplotype."""

    startOrg: int
    endOrg: int
    startExp: int
    endExp: int
    colours: list[int]
    nodeID: int


@dataclass
class ExpandedGraph:
    adj_list: list[list[tuple[int, int]]] = field(default_factory=list)
    color: list[list[int]] = field(default_factory=list)
    original_vertex: list[list[int]] = field(default_factory=list)
    haplotype: list[int] = field(default_factory=list)
    level: list[int] = field(default_factory=list)
    vertices_in_level: list[list[int]] = field(default_factory=list)

    # ---- Kahn reorder, sink last (ExpandedGraph.hpp:29-102) ----
    def topologically_reorder(self, sink: int) -> None:
        n = len(self.adj_list)
        indeg = [0] * n
        for nbrs in self.adj_list:
            for v, _w in nbrs:
                indeg[v] += 1
        q = deque(v for v in range(n) if indeg[v] == 0 and v != sink)
        sink_ready = indeg[sink] == 0
        order: list[int] = []
        while q or sink_ready:
            if q:
                u = q.popleft()
            else:
                u = sink
                sink_ready = False
            order.append(u)
            for v, _w in self.adj_list[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    if v == sink:
                        sink_ready = True
                    else:
                        q.append(v)
        if len(order) != n:
            raise RuntimeError("Graph contains a cycle; topological order impossible")
        new_idx = [0] * n
        for i, u in enumerate(order):
            new_idx[u] = i
        self.color = [self.color[u] for u in order]
        self.original_vertex = [self.original_vertex[u] for u in order]
        self.haplotype = [self.haplotype[u] for u in order]
        if len(self.level) == n:
            self.level = [self.level[u] for u in order]
        new_adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        for old_u in range(n):
            u = new_idx[old_u]
            for old_v, w in self.adj_list[old_u]:
                new_adj[u].append((new_idx[old_v], w))
        self.adj_list = new_adj

    # ---- 0-weight chain compaction (ExpandedGraph.hpp:132-265) ----
    def compactify(self, old_sink: int) -> int:
        """Merge colourless interior 0-weight chains into their
        predecessor. Present for component parity with the reference
        (ExpandedGraph::compactify); the reference pipeline itself never
        calls it (see SURVEY §2.1), but it is useful for shrinking
        graphs before the DP. Returns the new sink id (or -1)."""
        n = len(self.adj_list)
        indeg = [0] * n
        outdeg = [0] * n
        indeg0 = [0] * n
        outdeg0 = [0] * n
        for u in range(n):
            for v, w in self.adj_list[u]:
                outdeg[u] += 1
                indeg[v] += 1
                if w == 0:
                    outdeg0[u] += 1
                    indeg0[v] += 1

        new_adj: list[list[tuple[int, int]]] = []
        new_color: list[list[int]] = []
        new_orig: list[list[int]] = []
        new_hap: list[int] = []
        id_map = [-1] * n
        done = [False] * n
        swallowed = [False] * n

        def add_vertex(old_id: int) -> int:
            nid = len(new_adj)
            id_map[old_id] = nid
            new_adj.append([])
            new_color.append(list(self.color[old_id]))
            new_orig.append(list(self.original_vertex[old_id]))
            new_hap.append(self.haplotype[old_id])
            return nid

        def unique_zero_succ(u: int) -> int:
            succ = -1
            for v, w in self.adj_list[u]:
                if w != 0:
                    continue
                if succ == -1:
                    succ = v
                else:
                    return -2
            return succ

        for u0 in range(n):
            if done[u0]:
                continue
            keep = (
                bool(self.color[u0])
                or indeg0[u0] != indeg[u0]
                or outdeg0[u0] != outdeg[u0]
                or indeg0[u0] != 1
                or outdeg0[u0] != 1
            )
            if not keep:
                continue
            new_u = id_map[u0] if id_map[u0] != -1 else add_vertex(u0)
            done[u0] = True
            for v, w in self.adj_list[u0]:
                if w != 0:
                    nv = id_map[v] if id_map[v] != -1 else add_vertex(v)
                    new_adj[new_u].append((nv, w))
                    continue
                cur = v
                hops = 0
                while (
                    not swallowed[cur]
                    and not self.color[cur]
                    and indeg0[cur] == 1
                    and outdeg0[cur] == 1
                    and indeg[cur] == 1
                    and outdeg[cur] == 1
                ):
                    swallowed[cur] = True
                    new_orig[new_u].extend(self.original_vertex[cur])
                    nxt = unique_zero_succ(cur)
                    assert nxt >= 0
                    cur = nxt
                    hops += 1
                    if hops > n + 5:
                        raise RuntimeError("compactify: suspected 0-weight cycle")
                nv = id_map[cur] if id_map[cur] != -1 else add_vertex(cur)
                new_adj[new_u].append((nv, 0))

        self.adj_list = new_adj
        self.color = new_color
        self.original_vertex = new_orig
        self.haplotype = new_hap

        new_sink = -1
        if 0 <= old_sink < n:
            if id_map[old_sink] != -1:
                new_sink = id_map[old_sink]
            else:
                cur = old_sink
                seen = set()
                while cur not in seen:
                    seen.add(cur)
                    nxt = unique_zero_succ(cur)
                    if nxt < 0:
                        break
                    if id_map[nxt] != -1:
                        new_sink = id_map[nxt]
                        break
                    cur = nxt
        return new_sink

    # ---- strict BFS levelize (ExpandedGraph.hpp:269-409) ----
    def strict_bfs_levelize_and_reorder(self) -> int:
        n0 = len(self.adj_list)
        if n0 == 0:
            return 0
        indeg = [0] * n0
        outdeg = [0] * n0
        for u in range(n0):
            outdeg[u] = len(self.adj_list[u])
            for v, _w in self.adj_list[u]:
                indeg[v] += 1
        source = -1
        for v in range(n0):
            if indeg[v] == 0 and outdeg[v] > 0:
                if source == -1:
                    source = v
                else:
                    raise SystemExit(
                        "Uh oh, multiple potential sources found while leveling"
                    )
        if source < 0:
            raise RuntimeError("bad source index")

        # 1) BFS distances
        dist = [-1] * n0
        dist[source] = 0
        q = deque([source])
        while q:
            u = q.popleft()
            for v, _w in self.adj_list[u]:
                if dist[v] == -1:
                    dist[v] = dist[u] + 1
                    q.append(v)

        # 2) Kahn topo
        indeg2 = indeg[:]
        qk = deque(v for v in range(n0) if indeg2[v] == 0)
        topo: list[int] = []
        while qk:
            u = qk.popleft()
            topo.append(u)
            for v, _w in self.adj_list[u]:
                indeg2[v] -= 1
                if indeg2[v] == 0:
                    qk.append(v)
        if len(topo) != n0:
            raise RuntimeError("Graph contains a cycle; strict leveling requires a DAG")

        # 3) seed/relax levels
        lvl = [0] * n0
        for v in range(n0):
            if dist[v] >= 0:
                lvl[v] = dist[v]
        for u in topo:
            lu = lvl[u]
            for v, _w in self.adj_list[u]:
                if lvl[v] <= lu:
                    lvl[v] = lu + 1

        # 4) dummies for skipped levels
        next_adj: list[list[tuple[int, int]]] = [[] for _ in range(n0)]
        next_color = self.color
        next_orig = self.original_vertex
        next_lvl = lvl
        next_hap = self.haplotype

        def add_dummy(new_level: int, hap: int, inherit_from: int) -> int:
            vid = len(next_adj)
            next_adj.append([])
            next_color.append([])
            next_orig.append(list(next_orig[inherit_from]))
            next_lvl.append(new_level)
            next_hap.append(hap)
            return vid

        for u in range(n0):
            for v, w in self.adj_list[u]:
                gap = next_lvl[v] - next_lvl[u] - 1
                if gap <= 0:
                    next_adj[u].append((v, w))
                else:
                    prev = u
                    for step in range(1, gap + 1):
                        dummy = add_dummy(next_lvl[u] + step, self.haplotype[u], u)
                        next_adj[prev].append((dummy, w if step == 1 else 0))
                        prev = dummy
                    next_adj[prev].append((v, 0))

        self.adj_list = next_adj
        self.color = next_color
        self.original_vertex = next_orig
        self.level = next_lvl
        self.haplotype = next_hap

        # 5) order by (level, id), compute width
        n1 = len(self.adj_list)
        order = sorted(range(n1), key=lambda a: (self.level[a], a))
        max_level = max(self.level) if n1 else 0
        width = [0] * (max_level + 1)
        for v in range(n1):
            width[self.level[v]] += 1
        max_width = max(width) if width else 0

        new_id = [0] * n1
        for i, old in enumerate(order):
            new_id[old] = i
        self.color = [self.color[o] for o in order]
        self.original_vertex = [self.original_vertex[o] for o in order]
        self.level = [self.level[o] for o in order]
        self.haplotype = [self.haplotype[o] for o in order]
        new_adj: list[list[tuple[int, int]]] = [[] for _ in range(n1)]
        for old_u in range(n1):
            u = new_id[old_u]
            for old_v, w in self.adj_list[old_u]:
                new_adj[u].append((new_id[old_v], w))
        self.adj_list = new_adj

        # 7) per-level buckets
        self.vertices_in_level = [[] for _ in range(max_level + 1)]
        for u in range(n1):
            self.vertices_in_level[self.level[u]].append(u)
        return max_width


class _CsrList:
    """List-of-lists view over CSR arrays (read-only)."""

    def __init__(self, ptr, vals):
        self.ptr = ptr
        self.vals = vals

    def __len__(self):
        return len(self.ptr) - 1

    def __getitem__(self, v):
        if v < 0 or v >= len(self.ptr) - 1:
            raise IndexError(v)
        return self.vals[int(self.ptr[v]) : int(self.ptr[v + 1])].tolist()


class _CsrAdjPairs:
    """adj_list view returning [(v, w), ...] per vertex."""

    def __init__(self, ptr, v, w):
        self.ptr = ptr
        self.v = v
        self.w = w

    def __len__(self):
        return len(self.ptr) - 1

    def __getitem__(self, u):
        if u < 0 or u >= len(self.ptr) - 1:
            raise IndexError(u)
        s, e = int(self.ptr[u]), int(self.ptr[u + 1])
        return list(zip(self.v[s:e].tolist(), self.w[s:e].tolist()))


class CsrExpandedGraph:
    """Topologically-reordered expanded graph backed by dense CSR arrays
    (output of the native builder). Duck-types the ExpandedGraph surface
    the haploid solver, levelizer and stitcher use."""

    def __init__(self, adj_ptr, adj_v, adj_w, col_ptr, col_v,
                 org_ptr, org_v, hap):
        self.csr = (adj_ptr, adj_v, adj_w)
        self.col_ptr = col_ptr
        self.col_v = col_v
        self.org_ptr = org_ptr
        self.org_v = org_v
        self.adj_list = _CsrAdjPairs(adj_ptr, adj_v, adj_w)
        self.color = _CsrList(col_ptr, col_v)
        self.original_vertex = _CsrList(org_ptr, org_v)
        self.haplotype = hap
        self.level: list[int] = []
        self.vertices_in_level: list[list[int]] = []


@dataclass
class FlatAnchors:
    """Per-hap post-sweep anchor tables as flat arrays: the fields of the
    sorted AnchorRec lists the diploid stitcher consumes (startOrg,
    endOrg, colours; approximator.cpp:1193-1246)."""

    anc_ptr: "object"  # [nH+1] int64: per-hap anchor ranges
    so: "object"  # [n_anchors] int32
    eo: "object"  # [n_anchors] int32
    cptr: "object"  # [n_anchors+1] int64: colour offsets
    cv: "object"  # int32 colour values


@dataclass
class ExpandedBuild:
    """Result of build_expanded_graph: the graph plus side tables used by
    the diploid path (approximator.cpp:1114-1304)."""

    graph: ExpandedGraph
    sink: int
    anchors_by_hap: "list[list[AnchorRec]] | FlatAnchors"
    color_to_anchor: list[int]
    num_colors: int
    reordered: bool = False  # True when the builder already Kahn-reordered


def build_expanded_graph(
    index: PangenomeIndex, anchors: AnchorData
) -> ExpandedBuild:
    """Approximator::solve construction steps (approximator.cpp:1017-1246)."""
    paths = index.paths
    nH = len(paths)
    n_vtx = index.n_vtx
    number_of_vertices = sum(len(p) for p in paths)

    adj: list[list[tuple[int, int]]] = [[] for _ in range(2 + number_of_vertices)]
    vertex_to_expanded = [[-1] * nH for _ in range(n_vtx)]
    exp_to_original: list[list[int]] = [[] for _ in range(2 + number_of_vertices)]
    vertex_to_hap = [0] * (2 + number_of_vertices)

    sink = len(adj) - 1
    cur = 1
    for h in range(nH):
        adj[0].append((cur, 0))
        pw = paths[h]
        for i, v in enumerate(pw.tolist()):
            vertex_to_expanded[v][h] = cur
            exp_to_original[cur].append(v)
            vertex_to_hap[cur] = h
            if i < len(pw) - 1:
                adj[cur].append((cur + 1, 0))
            else:
                adj[cur].append((sink, 0))
            cur += 1

    # recombination w-vertices (approximator.cpp:1051-1095)
    vertex_w_uv = [[-1] * len(index.adj_list[u]) for u in range(n_vtx)]
    cur = len(adj)
    for h in range(nH):
        pw = paths[h].tolist()
        for i, u in enumerate(pw):
            nxt = pw[i + 1] if i < len(pw) - 1 else None
            au = index.adj_list[u].tolist()
            for j, v in enumerate(au):
                if i == len(pw) - 1 or v != nxt:
                    if vertex_w_uv[u][j] == -1:
                        adj.append([])
                        exp_to_original.append([])
                        vertex_to_hap.append(-1)
                        vertex_w_uv[u][j] = cur
                        cur += 1
                    adj[vertex_to_expanded[u][h]].append((vertex_w_uv[u][j], 1))
                    if not adj[vertex_w_uv[u][j]]:
                        for v_e in vertex_to_expanded[v]:
                            if v_e >= 0:
                                adj[vertex_w_uv[u][j]].append((v_e, 0))

    # anchor super-nodes + colours (approximator.cpp:1114-1176)
    color: list[list[int]] = [[] for _ in range(len(adj))]
    anchors_by_hap: list[list[AnchorRec]] = [[] for _ in range(nH)]
    color_to_anchor: list[int] = []
    next_id = len(adj)
    colour_id = 0
    for a in range(anchors.count_sp_r):
        new_color_used = False
        hits = anchors.anchor_hits[a]
        for h in range(nH):
            for occ in hits[h]:
                if len(occ) == 0:
                    continue
                new_color_used = True
                start_org, end_org = occ[0], occ[-1]
                start_exp = vertex_to_expanded[start_org][h]
                end_exp = vertex_to_expanded[end_org][h]
                if start_exp == end_exp:
                    node_id = start_exp
                else:
                    adj[start_exp].append((next_id, 0))
                    adj.append([(end_exp, 0)])
                    exp_to_original.append(list(occ))
                    color.append([])
                    vertex_to_hap.append(-1)
                    node_id = next_id
                    next_id += 1
                anchors_by_hap[h].append(
                    AnchorRec(start_org, end_org, start_exp, end_exp, [colour_id], node_id)
                )
        if new_color_used:
            color_to_anchor.append(a)
            colour_id += 1

    # sweep per haplotype (approximator.cpp:1193-1246)
    from ..utils.stdsort import std_sort_by_keys3

    for h in range(nH):
        vec = anchors_by_hap[h]
        if not vec:
            continue
        # std::sort by (startExp, endExp): tie order (identical spans with
        # different colours) is observable via colour containment unions,
        # so reproduce libstdc++'s introsort exactly.
        vec = std_sort_by_keys3(
            vec,
            [r.startExp for r in vec],
            [r.endExp for r in vec],
            [0] * len(vec),
        )
        anchors_by_hap[h] = vec
        stk: list[AnchorRec] = []
        for anc in vec:
            while stk and stk[-1].endExp < anc.startExp:
                stk.pop()
            if stk and anc.startExp <= stk[-1].endExp and stk[-1].nodeID != anc.nodeID:
                adj[stk[-1].nodeID].append((anc.nodeID, 0))
            for i in range(len(stk) - 1, -1, -1):
                if anc.endExp <= stk[i].endExp:
                    have = stk[i].colours
                    for c in anc.colours:
                        if c not in have:
                            have.append(c)
                else:
                    break
            stk.append(anc)
        for anc in vec:
            dst = color[anc.nodeID]
            dst.extend(anc.colours)
            dst.sort()
            # unique
            out = []
            prev = None
            for c in dst:
                if c != prev:
                    out.append(c)
                    prev = c
            color[anc.nodeID] = out

    g = ExpandedGraph(
        adj_list=adj,
        color=color,
        original_vertex=exp_to_original,
        haplotype=vertex_to_hap,
    )
    return ExpandedBuild(g, sink, anchors_by_hap, color_to_anchor, colour_id)


def flatten_hits(anchors: "AnchorData", num_walks: int):
    """Flatten Python anchor_hits into the (sp asc, hap asc, emission
    order) occurrence arrays the native builder consumes."""
    import numpy as np

    occ_sp: list[int] = []
    occ_hap: list[int] = []
    occ_ptr: list[int] = [0]
    occ_v: list[int] = []
    for a in range(anchors.count_sp_r):
        hits = anchors.anchor_hits[a]
        for h in range(num_walks):
            for occ in hits[h]:
                occ_sp.append(a)
                occ_hap.append(h)
                occ_v.extend(occ)
                occ_ptr.append(len(occ_v))
    return (
        np.asarray(occ_sp, np.int32),
        np.asarray(occ_hap, np.int32),
        np.asarray(occ_ptr, np.int64),
        np.asarray(occ_v, np.int32),
    )


def build_expanded_graph_native(
    index: PangenomeIndex, anchors: "AnchorData"
) -> ExpandedBuild:
    """Native (dgcore) expanded-graph construction + Kahn reorder.

    Same semantics as build_expanded_graph + topologically_reorder
    (approximator.cpp:1017-1256, ExpandedGraph.hpp:29-102), returning a
    CSR-backed graph and flat anchor tables. Consumes flat occurrence
    arrays if the native anchor stage produced them, else flattens the
    Python anchor_hits."""
    import numpy as np

    from .. import native

    H = index.num_walks
    if anchors.occ_sp is not None:
        occ = (anchors.occ_sp, anchors.occ_hap, anchors.occ_ptr, anchors.occ_v)
    else:
        occ = flatten_hits(anchors, H)

    path_ptr = np.zeros(H + 1, np.int64)
    for h in range(H):
        path_ptr[h + 1] = path_ptr[h] + len(index.paths[h])
    path_v = (
        np.concatenate(index.paths).astype(np.int32)
        if H
        else np.empty(0, np.int32)
    )
    n = index.n_vtx
    if index.adj_ptr is not None:
        oadj_ptr = index.adj_ptr
        oadj_v = index.adj_flat.astype(np.int32)
    else:
        odeg = np.fromiter((len(a) for a in index.adj_list), np.int64, n)
        oadj_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(odeg, out=oadj_ptr[1:])
        oadj_v = (
            np.concatenate(index.adj_list).astype(np.int32)
            if n and oadj_ptr[-1]
            else np.empty(0, np.int32)
        )

    out = native.build_expanded(n, path_ptr, path_v, oadj_ptr, oadj_v, *occ)
    g = CsrExpandedGraph(
        out["adj_ptr"], out["adj_v"], out["adj_w"],
        out["col_ptr"], out["col_v"], out["org_ptr"], out["org_v"],
        out["hap"],
    )
    flat = FlatAnchors(
        out["anc_ptr"], out["anc_so"], out["anc_eo"],
        out["anc_cptr"], out["anc_cv"],
    )
    return ExpandedBuild(
        g, out["sink"], flat, out["color_to_anchor"].tolist(),
        out["num_colors"], reordered=True,
    )
