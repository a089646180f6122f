"""The diploid solver with the port's device tier.

Counterpart of ``dipgenie_tpu.solver.diploid.diploid_dp_solver``:

* ``torch``: ``csr_arrays`` and ``plan_pairs`` (shared), then the pair DP
  of ``ops/diploid_pair.py`` on ``device``. A ``ValueError`` from the
  planner (R > 31, the packed-value bound, more than 31 windows) is
  raised: there is no fallback tier;
* ``native`` / ``exact``: the shared ``_forward_native`` /
  ``_forward_exact``.

The haplotype stitching and the approximation certificate after the DP
are copied from ``dipgenie_tpu/solver/diploid.py:347-531`` unchanged, so
stdout matches the JAX package line for line apart from the timing line.
"""

from __future__ import annotations

import math
import sys
import time
from collections import deque

from dipgenie_tpu import native
from dipgenie_tpu.graph.expanded import AnchorRec, ExpandedGraph
from dipgenie_tpu.graph.pangenome import PangenomeIndex
from dipgenie_tpu.solver.diploid import (
    _forward_exact,
    _forward_native,
    build_color_masks,
    csr_arrays,
)
from dipgenie_tpu.solver.haploid import _fmt
from dipgenie_tpu.utils.timing import log_stage

from ..ops.diploid_pair import PairDiploidDP
from ..ops.narrow import narrow_run
from ..ops.plan import _WideRun, plan_pairs
from ..ops.trace import trace
from ..ops.wide import wide_dense_run
from ..utils.synth import dp_states

BACKENDS = ("torch", "native", "exact")


def native_forward_csr(arrs, R: int, n_threads: int = 0):
    """(sink_value, sink_s_het, transitions) of the native C++ tier on CSR
    arrays: ``_forward_native`` without the graph object."""
    val, shet, trans = native.diploid_dp(*arrs, R, n_threads, False)
    transitions = []
    i2, j2 = 0, 0
    for l in range(len(arrs[0]) - 2, 0, -1):
        pi, pj, _pr, wu, wv = (int(x) for x in trans[l])
        transitions.append((l, pi, pj, i2, j2, wu, wv))
        i2, j2 = pi, pj
    return val, shet, transitions[::-1]


def torch_forward(arrs, R: int, device):
    """(sink_value, sink_s_het, transitions) of the port's device tier on
    the CSR arrays of a levelized graph."""
    t0 = time.time()
    plan = plan_pairs(*arrs, R)
    n_wide = sum(isinstance(s, _WideRun) for s in plan.segments)
    log_stage(
        "diploid_dp",
        f"pair plan ready in {time.time() - t0:.1f}s: {plan.L} levels, "
        f"{dp_states(arrs[0], R)} DP states, "
        f"{len(plan.segments) - n_wide} narrow and {n_wide} wide runs",
    )
    wrappers = (narrow_run, wide_dense_run, trace)
    before = [w.launches for w in wrappers]
    t0 = time.time()
    result = PairDiploidDP(plan, device).run()
    launched = " ".join(
        f"{w.__name__}={w.launches - b}" for w, b in zip(wrappers, before)
    )
    log_stage(
        "diploid_dp",
        f"torch tier on {device}: ship+forward+traceback in "
        f"{time.time() - t0:.1f}s; kernel launches {launched}",
    )
    return result


def diploid_dp_solver(
    g: ExpandedGraph,
    R: int,
    color_homo_bv: list[bool],
    anchors_by_hap: list[list[AnchorRec]],
    index: PangenomeIndex,
    out=sys.stdout,
    progress: bool = False,
    backend: str = "exact",
    n_threads: int = 0,
    device="cuda",
):
    if backend not in BACKENDS:
        raise ValueError(f"unknown DP backend {backend!r}: {BACKENDS}")
    start_time = time.time()
    L = len(g.vertices_in_level)
    if L > 0 and len(g.vertices_in_level[0]) > 1:
        print("There is more than one source on level zero!", file=out)

    print("Creating hetro/hom-zygous colors per vertex lists", file=out)
    print("Running DP", file=out)
    if backend == "torch":
        sink_val, sink_shet, transitions = torch_forward(
            csr_arrays(g, color_homo_bv), R, device
        )
    elif backend == "native":
        sink_val, sink_shet, transitions = _forward_native(
            g, R, color_homo_bv, n_threads=n_threads, progress=progress
        )
    else:
        Hm, Tm = build_color_masks(g, color_homo_bv)
        sink_val, sink_shet, transitions = _forward_exact(
            g, R, Hm, Tm, progress=progress
        )
    best_r = R
    print(f"DP value: {sink_val}", file=out)

    # ---- weighted edge lists from backtracked transitions ----
    p1_edges: list[tuple[int, int]] = []
    p2_edges: list[tuple[int, int]] = []
    for l, bi, bj, ti, tj, wu, wv in transitions:
        u1 = g.vertices_in_level[l - 1][bi]
        u2 = g.vertices_in_level[l][ti]
        v1 = g.vertices_in_level[l - 1][bj]
        v2 = g.vertices_in_level[l][tj]
        if wu > 0:
            p1_edges.append((u1, u2))
        if wv > 0:
            p2_edges.append((v1, v2))
        if l == L - 1:  # doubled final edge (approximator.cpp:684-692)
            p1_edges.append((u1, u2))
            p2_edges.append((v1, v2))

    r1 = len(p1_edges) - 1
    r2_count = len(p2_edges) - 1

    def find_next_zero_hap(src: int, target_hap: int) -> int:
        if g.haplotype[src] == target_hap and len(g.original_vertex[src]) > 0:
            return src
        q = deque([src])
        visited = {src}
        while q:
            u = q.popleft()
            for v, w in g.adj_list[u]:
                if w != 0:
                    continue
                if v in visited:
                    continue
                visited.add(v)
                if g.haplotype[v] == target_hap and len(g.original_vertex[v]) > 0:
                    return v
                q.append(v)
        return -1

    # per-hap anchor arrays for vectorized colour collection
    import numpy as _np

    anc_so: list[_np.ndarray] = []
    anc_eo: list[_np.ndarray] = []
    anc_cptr: list[_np.ndarray] = []
    anc_cvals: list[_np.ndarray] = []
    from dipgenie_tpu.graph.expanded import FlatAnchors

    if isinstance(anchors_by_hap, FlatAnchors):
        fa = anchors_by_hap
        for h in range(len(fa.anc_ptr) - 1):
            a0, a1 = int(fa.anc_ptr[h]), int(fa.anc_ptr[h + 1])
            anc_so.append(fa.so[a0:a1].astype(_np.int64))
            anc_eo.append(fa.eo[a0:a1].astype(_np.int64))
            cp = fa.cptr[a0 : a1 + 1].astype(_np.int64)
            anc_cptr.append(cp - cp[0])
            anc_cvals.append(
                fa.cv[int(cp[0]) : int(cp[-1])].astype(_np.int64)
            )
    else:
        for vec in anchors_by_hap:
            anc_so.append(_np.asarray([a.startOrg for a in vec], _np.int64))
            anc_eo.append(_np.asarray([a.endOrg for a in vec], _np.int64))
            cp = _np.zeros(len(vec) + 1, _np.int64)
            for ai, a in enumerate(vec):
                cp[ai + 1] = cp[ai] + len(a.colours)
            anc_cptr.append(cp)
            anc_cvals.append(
                _np.fromiter(
                    (c for a in vec for c in a.colours), _np.int64, int(cp[-1])
                )
            )

    def recover(weighted_edges: list[tuple[int, int]], tag: str):
        color_freq: dict[int, int] = {}
        colors: list[int] = []
        hap_seq: list[str] = []
        start_exp = g.vertices_in_level[0][0]
        for ei, edge in enumerate(weighted_edges):
            if len(g.original_vertex[edge[0]]) != 1:
                print(
                    f"{tag}: Vertex {edge[0]} in map back has "
                    f"{len(g.original_vertex[edge[0]])} original vertices",
                    file=out,
                )
                raise SystemExit(1)
            end_exp = edge[0]
            h = g.haplotype[end_exp]
            if start_exp == g.vertices_in_level[0][0]:
                for v in g.vertices_in_level[1]:
                    if g.haplotype[v] == h:
                        start_exp = v
            start_org = g.original_vertex[start_exp][0]
            end_org = g.original_vertex[end_exp][0]
            activated = False
            for t in range(len(index.paths[h])):
                pv = int(index.paths[h][t])
                if pv == start_org:
                    activated = True
                if activated:
                    hap_seq.append(index.node_seq[pv])
                if pv == end_org:
                    activated = False
                    break
            # vectorized: anchors strictly inside (start_org, end_org)
            hit = _np.nonzero((anc_so[h] > start_org) & (anc_eo[h] < end_org))[0]
            if len(hit):
                cp = anc_cptr[h]
                lens = cp[hit + 1] - cp[hit]
                total = int(lens.sum())
                if total:
                    cum = _np.cumsum(lens) - lens
                    within = _np.arange(total) - _np.repeat(cum, lens)
                    cs = anc_cvals[h][_np.repeat(cp[hit], lens) + within]
                    uniq, first, counts = _np.unique(
                        cs, return_index=True, return_counts=True
                    )
                    # preserve first-appearance order for new colours
                    order = _np.argsort(first, kind="stable")
                    for c, n in zip(uniq[order].tolist(), counts[order].tolist()):
                        if c not in color_freq:
                            color_freq[c] = n
                            colors.append(c)
                        else:
                            color_freq[c] += n
            if g.level[edge[1]] == L - 1:
                break
            next_edge = weighted_edges[ei + 1]
            next_hap = g.haplotype[next_edge[0]]
            ns = find_next_zero_hap(edge[1], next_hap)
            if ns != -1:
                start_exp = ns
            else:
                print(
                    f"{tag} (path recovery) Could not find next_hap={next_hap}"
                    f" from {edge[1]} via 0-weight edges",
                    file=out,
                )
        return "".join(hap_seq), color_freq, colors

    hap_1, p1_color_freq, p1_colors = recover(p1_edges, "P1")
    hap_2, p2_color_freq, p2_colors = recover(p2_edges, "P2")

    # ---- approximation certificate (approximator.cpp:932-1004) ----
    p1_hom = sorted({c for c in p1_colors if color_homo_bv[c]})
    p1_het = sorted({c for c in p1_colors if not color_homo_bv[c]})
    p2_hom = sorted({c for c in p2_colors if color_homo_bv[c]})
    p2_het = sorted({c for c in p2_colors if not color_homo_bv[c]})
    inter = sorted(set(p1_hom) & set(p2_hom))
    symd = sorted(set(p1_het) ^ set(p2_het))
    intersection_count = len(inter)
    symdiff_count = len(symd)
    m_G_hom = sum(
        max(p1_color_freq.get(c, 0), p2_color_freq.get(c, 0)) for c in inter
    )
    m_G_het = sum(p1_color_freq.get(c, 0) + p2_color_freq.get(c, 0) for c in symd)

    def fdiv(a: float, b: float) -> float:
        if b == 0:
            if a == 0:
                return math.copysign(math.nan, -1.0)
            return math.copysign(math.inf, a)
        return a / b

    m_G_hom_avg = fdiv(float(m_G_hom), float(intersection_count))
    m_G_het_avg = fdiv(float(m_G_het), float(symdiff_count))
    # std::max(a, b) semantics: returns b only when a < b (NaN-comparisons false)
    m_bar = m_G_het_avg if m_G_hom_avg < m_G_het_avg else m_G_hom_avg
    loss_het = sink_shet - m_G_het
    if math.isnan(m_G_het_avg):
        additive_term = float("nan")
    else:
        additive_term = fdiv(float(loss_het), m_G_het_avg)
    obj = intersection_count + symdiff_count
    print(f"r: {best_r} obj: {obj}", file=out)
    opt_obj_upper_bound = m_bar * (obj + additive_term)
    print(
        "Approximation certificate: multiplicative factor: "
        f"{_fmt(fdiv(opt_obj_upper_bound, float(obj)) if obj else opt_obj_upper_bound * math.inf)}",
        file=out,
    )
    elapsed_ms = int((time.time() - start_time) * 1000)
    print(f"diploid_dp_approximation_solver took {elapsed_ms} ms", file=out)
    return [(r1, r2_count, hap_1, hap_2)]
