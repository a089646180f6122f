"""Haploid recombination-constrained DP.

Equivalent of ``Approximator::dp_approximation_solver``
(reference: src/approximator.cpp:44-168):

  * forward DP over the (vertex, recombinations) lattice in topological
    order: ``dp[v][r+w] = max(dp[u][r] + |color(v)|)``
    (approximator.cpp:55-67); dp starts at 0 everywhere, backpointers
    only set on strict improvement;
  * per-r backtrack from the sink collects distinct colours and
    per-colour occurrence counts (approximator.cpp:74-102) and prints an
    approximation-ratio certificate (approximator.cpp:104-113);
  * best r chosen at the knee: first r where the Δcolors angle drops
    below HAP_ANGLE_THRESHOLD=5° (approximator.cpp:115-136);
  * the winning expanded path maps back to original vertices with
    first-seen dedup (approximator.cpp:140-167).

Vectorized over the r axis per edge; relaxation visit order (u
ascending = topo id, r ascending, out-edges in adjacency order) and the
strict-improvement backpointer rule match the reference exactly.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..graph.expanded import ExpandedGraph

HAP_ANGLE_THRESHOLD = 5.0


def _forward_numpy(g: ExpandedGraph, R: int):
    n = len(g.adj_list)
    dp = np.zeros((n, R + 1), np.int64)
    back_vtx = np.full((n, R + 1), -1, np.int64)
    back_r = np.full((n, R + 1), -1, np.int64)
    csize = np.asarray([len(c) for c in g.color], np.int64)

    for u in range(n):
        du = dp[u]
        for v, w in g.adj_list[u]:
            # candidates for r2 in [w, R]: dp[u][r2-w] + |color(v)|
            if w > R:
                continue
            cand = du[: R + 1 - w] + csize[v]
            dst = dp[v]
            sl = slice(w, R + 1)
            better = cand > dst[sl]
            if better.any():
                dst[sl] = np.where(better, cand, dst[sl])
                bv = back_vtx[v]
                br = back_r[v]
                rr = np.arange(0, R + 1 - w)
                bv[sl] = np.where(better, u, bv[sl])
                br[sl] = np.where(better, rr, br[sl])
    return back_vtx, back_r


def _forward_native(g: ExpandedGraph, R: int):
    from .. import native

    n = len(g.adj_list)
    if hasattr(g, "csr"):  # CsrExpandedGraph
        adj_ptr, adj_v, adj_w = g.csr
        cp = np.asarray(g.col_ptr, np.int64)
        csize = cp[1:] - cp[:-1]
    else:
        deg = np.asarray([len(a) for a in g.adj_list], np.int64)
        adj_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=adj_ptr[1:])
        ne = int(adj_ptr[-1])
        adj_v = np.empty(ne, np.int32)
        adj_w = np.empty(ne, np.int8)
        pos = 0
        for u in range(n):
            for v, w in g.adj_list[u]:
                adj_v[pos] = v
                adj_w[pos] = w
                pos += 1
        csize = np.asarray([len(c) for c in g.color], np.int64)
    _dp, bv, br = native.haploid_dp(adj_ptr, adj_v, adj_w, csize, R)
    return bv.astype(np.int64), br.astype(np.int64)


def dp_approximation_solver(g: ExpandedGraph, R: int, out=sys.stdout) -> list[int]:
    n = len(g.adj_list)
    try:
        from .. import native

        use_native = native.available()
    except Exception:  # noqa: BLE001
        use_native = False
    if use_native:
        back_vtx, back_r = _forward_native(g, R)
    else:
        back_vtx, back_r = _forward_numpy(g, R)

    # per-r backtrack (approximator.cpp:74-102), vectorized colour counting
    if hasattr(g, "col_ptr"):  # CsrExpandedGraph
        cptr = np.asarray(g.col_ptr, np.int64)
        cvals = np.asarray(g.col_v, np.int64)
    else:
        cptr = np.zeros(n + 1, np.int64)
        for v in range(n):
            cptr[v + 1] = cptr[v] + len(g.color[v])
        cvals = np.fromiter(
            (c for cs in g.color for c in cs), np.int64, int(cptr[-1])
        )

    def backtrack_path(r: int) -> np.ndarray:
        path = []
        cur_vtx, cur_r = n - 1, r
        while cur_vtx != -1:
            path.append(cur_vtx)
            t = cur_vtx
            cur_vtx = int(back_vtx[t, cur_r])
            cur_r = int(back_r[t, cur_r])
        return np.asarray(path[::-1], np.int64)

    def path_colors(path: np.ndarray) -> np.ndarray:
        lens = cptr[path + 1] - cptr[path]
        total = int(lens.sum())
        if total == 0:
            return np.empty(0, np.int64)
        starts = cptr[path]
        cum = np.cumsum(lens) - lens
        within = np.arange(total) - np.repeat(cum, lens)
        return cvals[np.repeat(starts, lens) + within]

    colors_by_r: list[int] = []
    avg_by_r: list[float] = []
    for r in range(R + 1):
        cols = path_colors(backtrack_path(r))
        uniq, counts = np.unique(cols, return_counts=True)
        colors_by_r.append(len(uniq))
        avg_by_r.append(
            float(counts.sum()) / len(uniq)
            if len(uniq)
            else math.copysign(math.nan, -1.0)  # 0.0/0 → -nan (x86)
        )

    for i in range(len(avg_by_r) - 1):
        print(f"Approximation ratio certificate: {_fmt(avg_by_r[i])}", file=out)

    # knee pick (approximator.cpp:115-136)
    best_r = 0
    max_delta = 0.0
    for i in range(len(colors_by_r) - 1):
        print(f"r: {i} true score: {colors_by_r[i]}", file=out)
        delta = colors_by_r[i + 1] - colors_by_r[i]
        if abs(delta) > max_delta:
            max_delta = abs(delta)
    for r in range(len(colors_by_r) - 1):
        delta = colors_by_r[r + 1] - colors_by_r[r]
        # IEEE semantics of atan(delta/max_delta): 0/0 = -nan, x/0 = ±inf
        if max_delta == 0:
            if delta == 0:
                angle_deg = math.copysign(math.nan, -1.0)
            else:
                angle_deg = math.degrees(math.atan(math.copysign(math.inf, delta)))
        else:
            angle_deg = math.degrees(math.atan(delta / max_delta))
        print(
            f"r: {r} -> {r + 1}, Δcolors: {delta}, angle: {_fmt(angle_deg)}°",
            file=out,
        )
        if angle_deg < HAP_ANGLE_THRESHOLD:
            best_r = r
            break

    print(f"Recombination count: {best_r}", file=sys.stderr)

    # recover path at best_r
    path: list[int] = []
    cur_vtx, cur_r = n - 1, best_r
    while cur_vtx != -1:
        path.append(cur_vtx)
        t = cur_vtx
        cur_vtx = int(back_vtx[t, cur_r])
        cur_r = int(back_r[t, cur_r])
    path.reverse()

    out_path: list[int] = []
    seen: set[int] = set()
    for u in path:
        for u_org in g.original_vertex[u]:
            if u_org not in seen:
                seen.add(u_org)
                out_path.append(u_org)
    return out_path


def _fmt(x: float) -> str:
    """C++ std::cout default float formatting (6 significant digits)."""
    if isinstance(x, float) and math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.6g}"
