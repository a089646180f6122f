"""Exact ILP/IQP haplotype inference (the reference's ``-a1`` branch).

Semantics equivalent of ILP_index::solve (reference: src/ILP_index.cpp:162-1034),
which the stock reference Makefile compiles out (no -DILP / Gurobi).  This
implementation keeps the exact optimization model but solves it with the
HiGHS branch-and-bound behind ``scipy.optimize.milp`` — no external solver
dependency.

Model (per ploidy copy h = 1..ploidy):

* a source→sink unit flow over (vertex, walk) nodes: walk edges (consecutive
  vertices of a walk, cost 0; ILP_index.cpp:629-650), plus a recombination
  vertex ``w_{u,v}`` for every original arc (u,v) that is not a continuation
  of some walk through u — entering and leaving it costs P/2 each
  (ILP_index.cpp:662-710), so one recombination costs P in total;
* flow conservation at internal walk nodes, w-nodes, sources and sinks
  (ILP_index.cpp:721-810); exactly one source and one sink var per copy
  (ILP_index.cpp:624-626);
* coverage: per anchor occurrence chain (spectrum id i, walk j, occurrence k,
  chain length >= 2) a binary credit var that can be 1 only if ALL chain
  edges are carried by copy h (linear form, ILP_index.cpp:235-264; the QP
  form at :359-514 has identical optima, see note below), with exactly one
  credited occurrence per (i, h) (``z_expr_h == alpha_{i,h}``,
  ILP_index.cpp:271-284);
* ploidy coupling: homozygous ids must be covered by every copy
  (``sum_h alpha_{i,h} == ploidy * alpha_i``, ILP_index.cpp:543), hetero ids
  by exactly one copy (``sum_h beta_{i,h} == beta_i``, ILP_index.cpp:561);
* objective: minimize (P/2)*sum(w-edges) + sum_i (1 - alpha_i)
  + sum_i (1 - beta_i) (ILP_index.cpp:687,705,533,551,821-823).

QP/ILP note (``-q``): in the reference the quadratic mode replaces the
coverage inequality with ``sum_e x_e*a + (1-w)*a == alpha`` summed over
occurrences plus the same ``sum a == alpha``; for binary a with at most one
a = 1 per (i,h) both formulations force "all chain edges taken" — identical
optimal sets, so both flags route to the single linear model here.

``-m1`` (mixed, the default) makes flow-edge vars continuous in [0,1] with
binary credit/coupling vars, ``-m0`` makes everything binary
(ILP_index.cpp:251,644).

Solution extraction mirrors ILP_index.cpp:858-1010: collect the copy's
selected edges, gather their (vertex, walk) endpoints, sort by the MSA
topological order, validate adjacency, count walk switches as
recombinations, and write one FASTA per copy (``{out}_{h}.fa``,
ILP_index.cpp:1019-1034).
"""

from __future__ import annotations

import sys

import numpy as np

from dataclasses import dataclass, field

from ..graph.pangenome import PangenomeIndex
from ..io.fasta import write_fasta
from ..utils.timing import log_stage
from .anchors import AnchorData


@dataclass
class IlpSolution:
    objective: float  # (P/2)*recomb-edges + kmer misses
    misses: float  # sum of (1-alpha) + (1-beta)
    recomb_cost: float  # objective - misses
    copies: list[tuple[int, str]] = field(default_factory=list)
    # per copy: (recombination count, sequence)


class _Model:
    """Bounded-variable MILP accumulator (COO constraint triplets)."""

    def __init__(self) -> None:
        self.var_key: dict[tuple, int] = {}
        self.obj: list[float] = []
        self.integrality: list[int] = []
        self.rows: list[int] = []
        self.cols: list[int] = []
        self.vals: list[float] = []
        self.row_lb: list[float] = []
        self.row_ub: list[float] = []

    def var(self, key: tuple, *, integer: bool) -> int:
        vid = self.var_key.get(key)
        if vid is None:
            vid = len(self.obj)
            self.var_key[key] = vid
            self.obj.append(0.0)
            self.integrality.append(1 if integer else 0)
        return vid

    def has(self, key: tuple) -> bool:
        return key in self.var_key

    def add_obj(self, vid: int, coeff: float) -> None:
        self.obj[vid] += coeff

    def constr(self, terms: list[tuple[int, float]], lb: float, ub: float) -> None:
        r = len(self.row_lb)
        for vid, coeff in terms:
            self.rows.append(r)
            self.cols.append(vid)
            self.vals.append(coeff)
        self.row_lb.append(lb)
        self.row_ub.append(ub)


def _build_model(
    index: PangenomeIndex,
    anchors: AnchorData,
    ploidy: int,
    penalty: int,
    is_mixed: bool,
) -> tuple[_Model, int]:
    """Assemble the MILP. Returns (model, credited-kmer count)."""
    m = _Model()
    H = index.num_walks
    paths = index.paths
    nonempty = [len(paths[j]) > 0 for j in range(H)]
    hits = anchors.anchor_hits
    homo_bv = anchors.homo_bv
    S = anchors.count_sp_r

    # next vertex of u in walk j keyed by the LAST occurrence index, matching
    # the reference's overwrite-on-duplicate map (ILP_index.cpp:653-660)
    next_in_walk: list[dict[int, int]] = []
    for j in range(H):
        p = paths[j]
        nxt: dict[int, int] = {}
        for idx in range(len(p)):
            u = int(p[idx])
            nxt[u] = int(p[idx + 1]) if idx + 1 < len(p) else -1
        next_in_walk.append(nxt)

    edge_int = not is_mixed
    count_kmer_matches = 0
    alpha_i_of: dict[int, int] = {}
    beta_i_of: dict[int, int] = {}

    for h in range(1, ploidy + 1):
        # ── coverage credit vars + per-(i,h) credit coupling ──────────────
        # (ILP_index.cpp:218-357; hom/het split by homo_bv as in the split
        # Anchor_hits_homo/hetero containers)
        for i in range(S):
            per_h_terms: list[tuple[int, float]] = []
            for j in range(H):
                if not nonempty[j]:
                    continue
                for kk, chain in enumerate(hits[i][j]):
                    if len(chain) - 1 <= 0:
                        # the reference adds a dangling binary here and skips
                        # it from every constraint/objective — omit entirely
                        continue
                    cov = m.var(("cov", h, i, j, kk), integer=True)
                    weight = len(chain) - 1
                    terms: list[tuple[int, float]] = [(cov, -float(weight))]
                    for a, b in zip(chain[:-1], chain[1:]):
                        ev = m.var(("we", h, int(a), j, int(b)),
                                   integer=edge_int)
                        terms.append((ev, 1.0))
                    # sum(chain edges) >= weight * cov
                    m.constr(terms, 0.0, np.inf)
                    per_h_terms.append((cov, 1.0))
            if per_h_terms:
                kind = "alpha" if homo_bv[i] else "beta"
                zih = m.var((kind + "_h", h, i), integer=True)
                m.constr(per_h_terms + [(zih, -1.0)], 0.0, 0.0)
                if h == 1:
                    count_kmer_matches += 1
                    store = alpha_i_of if homo_bv[i] else beta_i_of
                    store[i] = -1  # mark; global var made below

        # ── per-copy flow network ──────────────────────────────────────────
        start_terms: list[tuple[int, float]] = []
        end_terms: list[tuple[int, float]] = []
        for j in range(H):
            if not nonempty[j]:
                continue
            sv = m.var(("s", h, j), integer=edge_int)
            ev = m.var(("e", h, j), integer=edge_int)
            start_terms.append((sv, 1.0))
            end_terms.append((ev, 1.0))
        m.constr(start_terms, 1.0, 1.0)  # one source (ILP_index.cpp:625)
        m.constr(end_terms, 1.0, 1.0)  # one sink (ILP_index.cpp:626)

        # walk edges (cost 0)
        for j in range(H):
            p = paths[j]
            for idx in range(len(p) - 1):
                m.var(("we", h, int(p[idx]), j, int(p[idx + 1])),
                      integer=edge_int)

        # recombination vertices and their P/2-cost edges
        # out[(u,j)] / in_[(u,j)] collect flow terms; w-node conservation is
        # emitted inline per (u,v)
        out_terms: dict[tuple[int, int], list[tuple[int, float]]] = {}
        in_terms: dict[tuple[int, int], list[tuple[int, float]]] = {}

        def _out(node, term):
            out_terms.setdefault(node, []).append(term)

        def _in(node, term):
            in_terms.setdefault(node, []).append(term)

        for j in range(H):
            p = paths[j]
            for idx in range(len(p) - 1):
                u, v = int(p[idx]), int(p[idx + 1])
                ev = m.var_key[("we", h, u, j, v)]
                _out((u, j), (ev, 1.0))
                _in((v, j), (ev, 1.0))

        for u in range(index.n_vtx):
            for v in index.adj_list[u]:
                v = int(v)
                w_in: list[tuple[int, float]] = []
                w_out: list[tuple[int, float]] = []
                used = False
                for hj in index.haps[u]:
                    hj = int(hj)
                    if next_in_walk[hj].get(u, -1) == v:
                        continue
                    used = True
                    rv = m.var(("rw", h, u, hj, v), integer=edge_int)
                    m.add_obj(rv, penalty / 2)  # ILP_index.cpp:687
                    _out((u, hj), (rv, 1.0))
                    w_in.append((rv, 1.0))
                if used:
                    for hj in index.haps[v]:
                        hj = int(hj)
                        rv = m.var(("wr", h, u, v, hj), integer=edge_int)
                        m.add_obj(rv, penalty / 2)  # ILP_index.cpp:705
                        _in((v, hj), (rv, 1.0))
                        w_out.append((rv, -1.0))
                    # w-node conservation (ILP_index.cpp:751-773)
                    m.constr(w_in + w_out, 0.0, 0.0)

        # internal walk-node conservation (ILP_index.cpp:721-748)
        for j in range(H):
            p = paths[j]
            for idx in range(1, len(p) - 1):
                node = (int(p[idx]), j)
                terms = [(vid, c) for vid, c in in_terms.get(node, [])]
                terms += [(vid, -c) for vid, c in out_terms.get(node, [])]
                m.constr(terms, 0.0, 0.0)

        # source / sink conservation (ILP_index.cpp:776-810)
        for j in range(H):
            if not nonempty[j]:
                continue
            p = paths[j]
            snode = (int(p[0]), j)
            terms = [(m.var_key[("s", h, j)], 1.0)]
            terms += [(vid, -c) for vid, c in out_terms.get(snode, [])]
            m.constr(terms, 0.0, 0.0)
            enode = (int(p[-1]), j)
            terms = [(vid, c) for vid, c in in_terms.get(enode, [])]
            terms.append((m.var_key[("e", h, j)], -1.0))
            m.constr(terms, 0.0, 0.0)

    # ── ploidy coupling + objective misses (ILP_index.cpp:529-562) ────────
    for i in sorted(alpha_i_of):
        g = m.var(("alpha", i), integer=True)
        m.add_obj(g, -1.0)  # (1 - alpha_i): constant handled by caller
        terms = [(g, -float(ploidy))]
        for h in range(1, ploidy + 1):
            key = ("alpha_h", h, i)
            if key in m.var_key:
                terms.append((m.var_key[key], 1.0))
        m.constr(terms, 0.0, 0.0)
    for i in sorted(beta_i_of):
        g = m.var(("beta", i), integer=True)
        m.add_obj(g, -1.0)
        terms = [(g, -1.0)]
        for h in range(1, ploidy + 1):
            key = ("beta_h", h, i)
            if key in m.var_key:
                terms.append((m.var_key[key], 1.0))
        m.constr(terms, 0.0, 0.0)

    return m, count_kmer_matches


def ilp_solve(
    index: PangenomeIndex,
    anchors: AnchorData,
    hap_file: str,
    hap_name: str,
    *,
    ploidy: int = 2,
    recombination_penalty: int = 100,
    is_mixed: bool = True,
    verbose: bool = True,
    time_limit: float | None = None,
) -> IlpSolution:
    """Build + solve the exact model, write ``{hap_file}_{h}.fa`` per copy."""
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp

    if anchors.occ_sp is not None and not anchors.anchor_hits:
        from .anchors import materialize_hits

        anchors.anchor_hits = materialize_hits(anchors, index.num_walks)

    if verbose:
        log_stage("ilp_solve", "ILP model started")
    m, count_kmer_matches = _build_model(
        index, anchors, ploidy, recombination_penalty, is_mixed
    )
    nvars = len(m.obj)
    ncons = len(m.row_lb)
    n_alpha = sum(1 for k in m.var_key if k[0] == "alpha")
    n_beta = sum(1 for k in m.var_key if k[0] == "beta")
    const_offset = float(n_alpha + n_beta)  # sum of the "1 -" terms
    if verbose:
        pct = 100.0 * count_kmer_matches / max(1, anchors.count_sp_r)
        log_stage("ilp_solve", f"{pct:.2f}% Minimizers are in ILP")
        log_stage(
            "ilp_solve",
            f"Optimized expanded graph constructed "
            f"({nvars} vars, {ncons} constraints)",
        )

    A = sparse.csr_matrix(
        (m.vals, (m.rows, m.cols)), shape=(ncons, nvars)
    )
    options = {"mip_rel_gap": 0.0, "presolve": True}
    if time_limit is not None:
        options["time_limit"] = float(time_limit)
    res = milp(
        c=np.asarray(m.obj),
        constraints=LinearConstraint(A, np.asarray(m.row_lb),
                                     np.asarray(m.row_ub)),
        integrality=np.asarray(m.integrality),
        bounds=Bounds(0.0, 1.0),
        options=options,
    )
    if res.status != 0 or res.x is None:
        raise RuntimeError(f"ILP solve failed: {res.message}")
    obj = float(res.fun) + const_offset
    if verbose:
        log_stage("ilp_solve", f"Model optimized (objective {obj:g})")

    x = res.x
    tom = index.top_order_map
    results: list[tuple[int, str]] = []
    for h in range(1, ploidy + 1):
        # selected (vertex, walk) pairs from this copy's edges
        # (ILP_index.cpp:858-929); >0.5 instead of the reference's literal
        # ==1.0 to be robust to solver roundoff on continuous edge vars
        pv: set[tuple[int, int]] = set()
        for key, vid in m.var_key.items():
            if x[vid] <= 0.5 or key[1] != h:
                continue
            kind = key[0]
            if kind == "we":
                _, _, u, j, v = key
                pv.add((u, j))
                pv.add((v, j))
            elif kind == "rw":  # (u, hj) -> w_{u,v}
                _, _, u, hj, _v = key
                pv.add((u, hj))
            elif kind == "wr":  # w_{u,v} -> (v, hj)
                _, _, _u, v, hj = key
                pv.add((v, hj))
        if not pv:
            results.append((0, ""))
            continue
        seq_pairs = sorted(pv, key=lambda t: (tom[t[0]], t[1]))
        # adjacency validation (ILP_index.cpp:983-1002)
        for (u, _), (v, _) in zip(seq_pairs[:-1], seq_pairs[1:]):
            if v not in index.adj_list[u]:
                raise RuntimeError(f"Error: No edge between {u} and {v}")
        # recombination segments report (ILP_index.cpp:939-979)
        recomb = 0
        prev_hap = seq_pairs[0][1]
        prev_str_id = 0
        str_id = len(index.node_seq[seq_pairs[0][0]])
        segs: list[str] = []
        for u, hj in seq_pairs[1:]:
            str_id += len(index.node_seq[u])
            if hj != prev_hap:
                recomb += 1
                segs.append(
                    f">({index.hap_id2name[prev_hap]},"
                    f"[{prev_str_id},{str_id - 1}])"
                )
                prev_hap = hj
                prev_str_id = str_id
        segs.append(
            f">({index.hap_id2name[seq_pairs[-1][1]]},"
            f"[{prev_str_id},{str_id - 1}])"
        )
        print(f"Recombination count for haplotype {h}: {recomb}",
              file=sys.stderr)
        print(f"Recombined haplotypes for haplotype {h}: " + "".join(segs),
              file=sys.stderr)
        seq = "".join(index.node_seq[u] for u, _ in seq_pairs)
        results.append((recomb, seq))

    for h, (_, seq) in enumerate(results, start=1):
        path = f"{hap_file}_{h}.fa"
        write_fasta(path, [(f"{hap_name}_{h} LN:{len(seq)}", seq)])
        if verbose:
            log_stage(
                "ilp_solve",
                f"Haplotype {h} of size: {len(seq)} written to: {path}",
            )
    # split the objective: recombination-edge cost vs kmer misses
    recomb_cost = sum(
        (recombination_penalty / 2) * x[vid]
        for key, vid in m.var_key.items()
        if key[0] in ("rw", "wr")
    )
    return IlpSolution(
        objective=obj, misses=obj - recomb_cost,
        recomb_cost=recomb_cost, copies=results,
    )
