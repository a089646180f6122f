"""The diploid solver of the port.

Counterpart of ``dipgenie_tpu.solver.diploid.diploid_dp_solver``, with
its own copies of ``build_color_masks``, ``_forward_exact``, ``csr_arrays``
and ``_forward_native`` (``dipgenie_tpu/solver/diploid.py:50-245``):

* ``torch``: ``csr_arrays`` and the port's ``plan_pairs``, then the pair DP
  of ``ops/diploid_pair.py`` on ``device`` (with ``mesh``, its wide runs
  window-sharded over the mesh's tp ranks). Any R, level widths up to
  512 and DP values up to ``VALUE_MAX`` (2,147,221,502) plan; past the
  last two the planner raises ``PlanLimit``, which is passed on (the CLI
  prints it as one ``[E::main]`` line);
* ``auto``: the torch tier, except that a graph past its window limit (a
  level wider than 512: ``pair_plan.WindowLimit``) goes, with one
  ``[W::diploid_dp]`` line naming the limit and the tier, to the fused
  tier, or with a tp ``mesh`` to the chunked tier over the mesh (the
  counterpart of the JAX ``pallas`` route's fallback to its chunked tier,
  ``dipgenie_tpu/solver/diploid.py:296-307``). Only that planner
  exception routes: a kernel, build, launch or collective error is
  raised;
* ``fused`` / ``jax``: the fused tier (``ops/fused.py``) / the chunked
  tier (``ops/chunked.py``) on ``device``, levels up to 4,096 wide. With a
  tp ``mesh`` the chunked tier splits its wide transitions over the tp
  ranks (``chunked.chunk_step_tp``); the fused tier does not shard, and
  runs whole on every rank with one ``[W::diploid_dp]`` line saying so,
  as the JAX package runs it (``dipgenie_tpu/solver/diploid.py:277-283``);
* ``native`` / ``exact``: the native C++ tier / the exact numpy tier, on
  the host.

The haplotype stitching and the approximation certificate after the DP
are copied from ``dipgenie_tpu/solver/diploid.py:347-531`` unchanged, so
stdout matches the JAX package line for line apart from the timing line.
"""

from __future__ import annotations

import math
import sys
import time
from collections import deque

import numpy as np
import torch

from .. import native
from ..graph.expanded import AnchorRec, ExpandedGraph, FlatAnchors
from ..graph.pangenome import PangenomeIndex
from ..ops import chunked, fused
from ..ops.diploid_pair import RUNS, PairDiploidDP
from ..ops.narrow import narrow_run_global
from ..ops.pair_plan import WindowLimit
from ..ops.plan import (
    DENSE_NB_LIMIT, DENSE_NB_MAX, K2_SLICE_PAIRS, plan_pairs,
)
from ..ops.trace import trace
from ..ops.vertex_plan import P, W, plan_vertices
from ..utils.synth import dp_states
from ..utils import timing
from ..utils.timing import log_stage
from .haploid import _fmt

BACKENDS = ("auto", "torch", "fused", "jax", "native", "exact")
# the tiers that run on the device
DEVICE_TIERS = ("auto", "torch", "fused", "jax")

NEG_INF = -(2**31) // 4


def build_color_masks(
    g: ExpandedGraph, color_homo_bv: list[bool]
) -> tuple[list[int], list[int]]:
    """Per-vertex HOM/HET colour bitsets (approximator.cpp:430-453)."""
    H = [0] * len(g.adj_list)
    T = [0] * len(g.adj_list)
    for v, colors in enumerate(g.color):
        hm = tm = 0
        for c in colors:
            if color_homo_bv[c]:
                hm |= 1 << c
            else:
                tm |= 1 << c
        H[v], T[v] = hm, tm
    return H, T


def _forward_exact(g: ExpandedGraph, R: int, Hm, Tm, progress: bool = False):
    """Exact numpy forward DP; returns (sink_val, sink_shet, transitions).

    transitions[t] = (level, pred_i, pred_j, i2, j2, wu, wv) along the
    backtracked optimal path, level ascending 1..L-1."""
    L = len(g.vertices_in_level)
    n = len(g.adj_list)
    pos_in_level = [-1] * n
    for l in range(L):
        for i, v in enumerate(g.vertices_in_level[l]):
            pos_in_level[v] = i

    # rolling state at current level: [(R+1), k, k]
    val = np.zeros((R + 1, 1, 1), np.int64)
    shet = np.zeros((R + 1, 1, 1), np.int64)
    # per-level backpointer tables, filled for levels 1..L-1
    back: list[dict[str, np.ndarray] | None] = [None] * L

    from ..utils.progress import ProgressThrottle

    bar = ProgressThrottle(L) if progress else None
    rs = np.arange(R + 1)
    for l in range(L - 1):
        lnow = g.vertices_in_level[l]
        lnext = g.vertices_in_level[l + 1]
        k, k2 = len(lnow), len(lnext)
        nval = np.full((R + 1, k2, k2), NEG_INF, np.int64)
        nsh = np.zeros((R + 1, k2, k2), np.int64)
        pi = np.full((R + 1, k2, k2), np.iinfo(np.int32).max, np.int64)
        pj = np.full((R + 1, k2, k2), np.iinfo(np.int32).max, np.int64)
        pr = np.full((R + 1, k2, k2), -1, np.int64)
        wub = np.zeros((R + 1, k2, k2), np.int8)
        wvb = np.zeros((R + 1, k2, k2), np.int8)

        HL: dict[tuple[int, int], int] = {}
        TL: dict[tuple[int, int], int] = {}
        for i in range(k):
            u1 = lnow[i]
            au = g.adj_list[u1]
            for j in range(k):
                v1 = lnow[j]
                src = val[:, i, j]
                if not (src != NEG_INF).any():
                    continue
                hl = Hm[u1] | Hm[v1]
                tl = Tm[u1] | Tm[v1]
                ssrc = shet[:, i, j]
                for u2, wu in au:
                    iu2 = pos_in_level[u2]
                    for v2, wv in g.adj_list[v1]:
                        jv2 = pos_in_level[v2]
                        w = wu + wv
                        if w > R:
                            continue
                        symd = (tl ^ (Tm[u2] | Tm[v2])).bit_count()
                        score = (hl & (Hm[u2] | Hm[v2])).bit_count() + symd
                        lim = R + 1 - w
                        cand = src[:lim] + score
                        dv = nval[w:, iu2, jv2]
                        valid = src[:lim] != NEG_INF
                        better = valid & (
                            (cand > dv)
                            | ((cand == dv) & (i < pi[w:, iu2, jv2]))
                            | (
                                (cand == dv)
                                & (i == pi[w:, iu2, jv2])
                                & (j < pj[w:, iu2, jv2])
                            )
                        )
                        if not better.any():
                            continue
                        bidx = np.nonzero(better)[0]
                        nval[w + bidx, iu2, jv2] = cand[bidx]
                        nsh[w + bidx, iu2, jv2] = ssrc[bidx] + symd
                        pi[w + bidx, iu2, jv2] = i
                        pj[w + bidx, iu2, jv2] = j
                        pr[w + bidx, iu2, jv2] = bidx
                        wub[w + bidx, iu2, jv2] = wu
                        wvb[w + bidx, iu2, jv2] = wv
        back[l + 1] = {"pi": pi, "pj": pj, "pr": pr, "wu": wub, "wv": wvb}
        val, shet = nval, nsh
        if bar is not None:
            bar.update(l + 1)
    if bar is not None:
        bar.update(L)

    best_r = R
    sink_val = int(val[best_r, 0, 0])
    sink_shet = int(shet[best_r, 0, 0])

    i2, j2, r2 = 0, 0, best_r
    transitions: list[tuple[int, int, int, int, int, int, int]] = []
    for l in range(L - 1, 0, -1):
        b = back[l]
        bi = int(b["pi"][r2, i2, j2])
        bj = int(b["pj"][r2, i2, j2])
        br = int(b["pr"][r2, i2, j2])
        wu = int(b["wu"][r2, i2, j2])
        wv = int(b["wv"][r2, i2, j2])
        transitions.append((l, bi, bj, i2, j2, wu, wv))
        i2, j2, r2 = bi, bj, br
    transitions.reverse()
    return sink_val, sink_shet, transitions


def csr_arrays(g, color_homo_bv):
    """Dense CSR arrays of the levelized graph for the native/device DPs:
    (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors, het_ptr,
    het_colors). Accepts an ExpandedGraph or a LeveledGraph CSR view."""
    if hasattr(g, "color_csr"):  # LeveledGraph: already CSR
        hom_ptr, hom_colors, het_ptr, het_colors = g.color_csr(color_homo_bv)
        adj_ptr, adj_v, adj_w = g.csr
        return (g.level_ptr, adj_ptr, adj_v, adj_w,
                hom_ptr, hom_colors, het_ptr, het_colors)

    L = len(g.vertices_in_level)
    n = len(g.adj_list)
    level_ptr = np.zeros(L + 1, np.int64)
    widths = np.fromiter(
        (len(lv) for lv in g.vertices_in_level), np.int64, L
    )
    np.cumsum(widths, out=level_ptr[1:])
    # levelized ids are consecutive per level
    assert all(
        len(lv) == 0 or lv[0] == level_ptr[l]
        for l, lv in enumerate(g.vertices_in_level)
    )

    deg = np.fromiter((len(a) for a in g.adj_list), np.int64, n)
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=adj_ptr[1:])
    ne = int(adj_ptr[-1])
    flat = np.fromiter(
        (x for a in g.adj_list for vw in a for x in vw), np.int64, 2 * ne
    )
    adj_v = flat[0::2].astype(np.int32)
    adj_w = flat[1::2].astype(np.int8)

    ccnt = np.fromiter((len(c) for c in g.color), np.int64, n)
    nc = int(ccnt.sum())
    col_vals = np.fromiter((c for cs in g.color for c in cs), np.int64, nc)
    rows = np.repeat(np.arange(n, dtype=np.int64), ccnt)
    chb = np.asarray(color_homo_bv, bool)
    is_h = chb[col_vals] if nc else np.zeros(0, bool)
    hom_ptr = np.zeros(n + 1, np.int64)
    het_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[is_h], minlength=n), out=hom_ptr[1:])
    np.cumsum(np.bincount(rows[~is_h], minlength=n), out=het_ptr[1:])
    hom_colors = col_vals[is_h].astype(np.int32)
    het_colors = col_vals[~is_h].astype(np.int32)
    return (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
            het_ptr, het_colors)


def native_forward_csr(arrs, R: int, n_threads: int = 0,
                       progress: bool = False):
    """(sink_value, sink_s_het, transitions) of the native C++ tier
    (dgcore) on the CSR arrays of a levelized graph."""
    val, shet, trans = native.diploid_dp(*arrs, R, n_threads, progress)
    transitions = []
    i2, j2 = 0, 0
    for l in range(len(arrs[0]) - 2, 0, -1):
        pi, pj, _pr, wu, wv = (int(x) for x in trans[l])
        transitions.append((l, pi, pj, i2, j2, wu, wv))
        i2, j2 = pi, pj
    return val, shet, transitions[::-1]


def _forward_native(g: ExpandedGraph, R: int, color_homo_bv, n_threads: int = 0,
                    progress: bool = False):
    """Native (dgcore) forward DP; same return contract as _forward_exact."""
    return native_forward_csr(csr_arrays(g, color_homo_bv), R, n_threads,
                              progress)


def torch_forward(arrs, R: int, device, mesh=None):
    """(sink_value, sink_s_het, transitions) of the port's device tier on
    the CSR arrays of a levelized graph; with a tp ``mesh``
    (``parallel.mesh``) every wide run is window-sharded over its ranks."""
    t0 = time.time()
    plan = plan_pairs(*arrs, R)
    t_plan = time.time() - t0
    wrappers = (*RUNS.values(), narrow_run_global, trace)
    before = [w.launches for w in wrappers]
    t0 = time.time()
    dp = PairDiploidDP(plan, device, mesh=mesh)
    kinds = [s.kind for s in dp.dplan.segments]
    n_split = kinds.count("wide_split")
    wide = [s.host for s in dp.dplan.segments if s.kind != "narrow"]
    n_big = sum(s.NB > DENSE_NB_LIMIT for s in wide)
    widest = max(wide, key=lambda s: s.NB, default=None)
    log_stage(
        "diploid_dp",
        f"pair plan ready in {t_plan:.1f}s: {plan.L} levels, "
        f"{dp_states(arrs[0], R)} DP states, "
        f"{kinds.count('narrow')} narrow and {len(wide)} wide runs "
        f"({n_split} window-split: over {DENSE_NB_MAX} windows or a "
        f"destination past {K2_SLICE_PAIRS} pairs, {n_big} over "
        f"{DENSE_NB_LIMIT} windows; widest {widest.NB if wide else 0} windows"
        + (f", its window-split backpointers {widest.nrows * (R + 1) * 4096}"
           " B" if wide else "") + ")"
        + (f"; wide runs over a tp mesh of {mesh.n_tp} ranks"
           if mesh is not None else ""),
    )
    on_card = dp.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dp.device)
    result = dp.run()
    launched = _launches(wrappers, before)
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dp.device)} B" if on_card
            else "")
    log_stage(
        "diploid_dp",
        f"torch tier on {device}: ship+forward+traceback in "
        f"{time.time() - t0:.1f}s{peak}; kernel launches {launched}",
    )
    return result


def _launches(wrappers, before) -> str:
    return " ".join(f"{w.__name__}={w.launches - b}"
                    for w, b in zip(wrappers, before))


def vertex_forward(arrs, R: int, device, backend: str, mesh=None):
    """(sink_value, sink_s_het, transitions) of the fused (``backend``
    ``fused``) or chunked (``jax``) tier on ``device``, with its plan's
    and its run's log lines; the chunked tier's wide transitions split
    over the tp ranks of ``mesh`` where one is given."""
    t0 = time.time()
    if backend == "fused":
        plan = fused.plan_fused(*arrs, R)
        vplan = plan.vplan
    else:
        plan = vplan = plan_vertices(*arrs)
    t_plan = time.time() - t0
    if backend == "fused":
        dp = fused.FusedDiploidDP(plan, device)
        wrappers = (fused.fused_forward, fused.fused_trace)
        name, shape = "fused", f"backpointers {plan.bp_bytes} B"
    else:
        dp = chunked.DeviceDiploidDP(plan, R, device, mesh=mesh)
        wrappers = (chunked.chunk_step, chunked.chunk_share,
                    chunked.chunk_trace)
        name = "chunked"
        shape = (f"{len(dp.ops)} ops, {len(dp.spans)} replay spans of "
                 f"{dp.ckpt_every} ops")
    desc = vplan.desc
    log_stage(
        "diploid_dp",
        f"vertex plan ready in {t_plan:.1f}s: {len(vplan.widths)} levels, "
        f"{dp_states(arrs[0], R)} DP states, widest level "
        f"{int(vplan.widths.max())}, in-degree up to "
        f"{int(desc[:, P].max(initial=0))}, colour words up to "
        f"{int(desc[:, W].max(initial=0))}; {shape}",
    )
    before = [w.launches for w in wrappers]
    tp_spans = ("chunked.tp_gather", "chunked.tp_wait")
    tp_before = [timing.total(n).ns for n in tp_spans]
    t0 = time.time()
    on_card = dp.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dp.device)
    result = dp.run()
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dp.device)} B" if on_card
            else "")
    tp = ""
    if backend == "jax" and mesh is not None:
        st = dp.stats
        gather_s, wait_s = ((timing.total(n).ns - b) / 1e9
                            for n, b in zip(tp_spans, tp_before))
        tp = (f"; over a tp mesh of {mesh.n_tp} ranks: {st['shares']} wide "
              f"transitions split, {st['gathers']} all-gathers of "
              f"{st['gather_bytes']} B in {gather_s:.3f}s, "
              f"{wait_s:.3f}s waiting for the card before them "
              "(host clock)")
    log_stage(
        "diploid_dp",
        f"{name} tier on {device}: ship+forward+traceback in "
        f"{time.time() - t0:.1f}s{peak}; kernel launches "
        f"{_launches(wrappers, before)}{tp}",
    )
    return result


def device_forward(arrs, R: int, backend: str, device, mesh=None):
    """The device tiers (``DEVICE_TIERS``) on the CSR arrays; ``auto``
    routes a graph past the torch tier's window limit to the fused tier,
    or with a tp ``mesh`` to the chunked tier over it."""
    if backend == "fused" and mesh is not None:
        print(f"[W::diploid_dp] fused tier: not sharded over the tp mesh; "
              f"it runs whole on each of its {mesh.n_tp} ranks",
              file=sys.stderr, flush=True)
    if backend in ("fused", "jax"):
        return vertex_forward(arrs, R, device, backend,
                              mesh if backend == "jax" else None)
    try:
        return torch_forward(arrs, R, device, mesh)
    except WindowLimit as e:
        if backend != "auto":
            raise
        limit = str(e).split('; use')[0]
    if mesh is None:
        print(f"[W::diploid_dp] torch tier: {limit}; running the fused tier",
              file=sys.stderr, flush=True)
        return vertex_forward(arrs, R, device, "fused")
    print(f"[W::diploid_dp] torch tier: {limit}; running the chunked tier "
          f"over the tp mesh of {mesh.n_tp} ranks", file=sys.stderr,
          flush=True)
    return vertex_forward(arrs, R, device, "jax", mesh)


def diploid_dp_solver(
    g: ExpandedGraph,
    R: int,
    color_homo_bv: list[bool],
    anchors_by_hap: list[list[AnchorRec]],
    index: PangenomeIndex,
    out=sys.stdout,
    progress: bool = False,
    backend: str = "auto",
    n_threads: int = 0,
    device="cuda",
    mesh=None,
):
    if backend not in BACKENDS:
        raise ValueError(f"unknown DP backend {backend!r}: {BACKENDS}")
    start_time = time.time()
    L = len(g.vertices_in_level)
    if L > 0 and len(g.vertices_in_level[0]) > 1:
        print("There is more than one source on level zero!", file=out)

    print("Creating hetro/hom-zygous colors per vertex lists", file=out)
    print("Running DP", file=out)
    if backend in DEVICE_TIERS:
        sink_val, sink_shet, transitions = device_forward(
            csr_arrays(g, color_homo_bv), R, backend, device, mesh
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
    anc_so: list[np.ndarray] = []
    anc_eo: list[np.ndarray] = []
    anc_cptr: list[np.ndarray] = []
    anc_cvals: list[np.ndarray] = []
    if isinstance(anchors_by_hap, FlatAnchors):
        fa = anchors_by_hap
        for h in range(len(fa.anc_ptr) - 1):
            a0, a1 = int(fa.anc_ptr[h]), int(fa.anc_ptr[h + 1])
            anc_so.append(fa.so[a0:a1].astype(np.int64))
            anc_eo.append(fa.eo[a0:a1].astype(np.int64))
            cp = fa.cptr[a0 : a1 + 1].astype(np.int64)
            anc_cptr.append(cp - cp[0])
            anc_cvals.append(
                fa.cv[int(cp[0]) : int(cp[-1])].astype(np.int64)
            )
    else:
        for vec in anchors_by_hap:
            anc_so.append(np.asarray([a.startOrg for a in vec], np.int64))
            anc_eo.append(np.asarray([a.endOrg for a in vec], np.int64))
            cp = np.zeros(len(vec) + 1, np.int64)
            for ai, a in enumerate(vec):
                cp[ai + 1] = cp[ai] + len(a.colours)
            anc_cptr.append(cp)
            anc_cvals.append(
                np.fromiter(
                    (c for a in vec for c in a.colours), np.int64, int(cp[-1])
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
            hit = np.nonzero((anc_so[h] > start_org) & (anc_eo[h] < end_org))[0]
            if len(hit):
                cp = anc_cptr[h]
                lens = cp[hit + 1] - cp[hit]
                total = int(lens.sum())
                if total:
                    cum = np.cumsum(lens) - lens
                    within = np.arange(total) - np.repeat(cum, lens)
                    cs = anc_cvals[h][np.repeat(cp[hit], lens) + within]
                    uniq, first, counts = np.unique(
                        cs, return_index=True, return_counts=True
                    )
                    # preserve first-appearance order for new colours
                    order = np.argsort(first, kind="stable")
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
