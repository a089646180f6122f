"""Deterministic synthetic inputs, made from a seed with numpy.

* ``random_leveled_csr``: the random leveled DAGs of the JAX package's
  tests (``tests/test_device_kernels._random_leveled_graph`` with the
  colour split of ``tests/test_pallas_dp.py``), emitted directly as the
  CSR arrays of ``dipgenie_tpu.solver.diploid.csr_arrays`` so that a run
  without the test tree sees the same instances;
* ``dense_graph`` / ``hand_graph``: the controlled fan-out and the
  hand-built leveled DAGs of ``tests/test_pallas_dp.py`` (``_dense_graph``,
  ``_hand_graph``), as the port's ``ExpandedGraph``; ``graph_from_csr``
  turns CSR arrays back into one, for the exact tier;
* ``wide_window_graph`` / ``heavy_chain``: graphs past the TPU planner's
  limits (a wide run of more than 31 windows; DP values past 4,100,000);
  ``parallel_edges_graph``: a dense run with a destination of more pairs
  than a K2 slice holds;
* ``mhc_shaped_csr``: a leveled DAG at the scale of the MHC expanded
  graph, the deployment the DP is sized for;
* ``pangenome``: a GFA v1.1 pangenome (S/L/W lines) plus short reads from
  two of its walks, for the end-to-end CLI;
* ``ragged_reads`` / ``count_tables`` / ``edge_hashes``: the sketch
  kernel's rows and the sketch count's tables and hashes at their edges.
"""

from __future__ import annotations

import os

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _csr(widths, adj, colors, chb):
    """CSR arrays (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
    het_ptr, het_colors) of a leveled graph given as per-vertex lists."""
    level_ptr = np.zeros(len(widths) + 1, np.int64)
    np.cumsum(widths, out=level_ptr[1:])
    n = int(level_ptr[-1])
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in adj], out=adj_ptr[1:])
    adj_v = np.asarray([v for a in adj for v, _ in a], np.int32)
    adj_w = np.asarray([w for a in adj for _, w in a], np.int8)
    hom_ptr = np.zeros(n + 1, np.int64)
    het_ptr = np.zeros(n + 1, np.int64)
    hom, het = [], []
    for v, cs in enumerate(colors):
        hom += [c for c in cs if chb[c]]
        het += [c for c in cs if not chb[c]]
        hom_ptr[v + 1], het_ptr[v + 1] = len(hom), len(het)
    return (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr,
            np.asarray(hom, np.int32), het_ptr, np.asarray(het, np.int32))


# (seed, L, kmax, R, ncolors) of the random instances in
# tests/test_pallas_dp.py (CASES): narrow-only, 16/32 layout mixes, flat
# 512/768 extents, and wide levels (width > 32); then one of the same
# generator with widths to 32 (narrow only) whose last transition sends
# 2,209 pairs (nine chunks, more than K1 stages) into the sink, and which
# holds 512- and 1024-lane transitions
CASES = (
    [(s, 12, 5, 5, 8) for s in range(6)]
    + [(100 + s, 8, 3, 2, 6) for s in range(3)]
    + [(200 + s, 16, 16, 5, 10) for s in range(3)]
    + [(300 + s, 10, 30, 4, 12) for s in range(3)]
    + [(600 + s, 14, 24, 5, 8) for s in range(2)]
    + [(700, 8, 32, 5, 8)]
    + [(400 + s, 10, 40, 4, 8) for s in range(3)]
    + [(500 + s, 14, 36, 6, 9) for s in range(2)]
)
# a narrow run at an R where its V [R+1, 1024] does not fit a block's
# shared memory, so K1 keeps it in global memory (widths to 30)
GLOBAL_STATE_CASE = (300, 10, 30, 60, 12)


def random_leveled_csr(seed: int, L: int, kmax: int, ncolors: int):
    """CSR arrays of the test suites' random instance ``(seed, L, kmax,
    ncolors)``: the same random draws in the same order."""
    rng = np.random.default_rng(seed)
    widths = [1] + [int(rng.integers(1, kmax + 1)) for _ in range(L - 2)]
    widths += [1]
    starts = np.cumsum([0] + widths)
    n = int(starts[-1])
    adj = [[] for _ in range(n)]
    for l in range(L - 1):
        for u in range(starts[l], starts[l + 1]):
            for _ in range(int(rng.integers(1, 3))):
                v = int(rng.integers(starts[l + 1], starts[l + 2]))
                adj[u].append((v, int(rng.random() < 0.3)))
        for v in range(starts[l + 1], starts[l + 2]):
            if not any(v == t for u in range(starts[l], starts[l + 1])
                       for t, _ in adj[u]):
                u = int(rng.integers(starts[l], starts[l + 1]))
                adj[u].append((v, 0))
    colors = []
    for _ in range(n):
        cs = rng.choice(ncolors, size=rng.integers(0, 4), replace=False)
        colors.append(sorted(int(c) for c in cs))
    chb = [bool(x) for x in rng.random(ncolors) < 0.4]
    return _csr(widths, adj, colors, chb)


def _leveled_graph(widths):
    """An edgeless, colourless ``ExpandedGraph`` of the level widths, and
    the first vertex of each level."""
    from ..graph.expanded import ExpandedGraph

    starts = np.cumsum([0] + list(widths))
    n = int(starts[-1])
    g = ExpandedGraph(
        adj_list=[[] for _ in range(n)],
        color=[[] for _ in range(n)],
        original_vertex=[[v] for v in range(n)],
        haplotype=[0] * n,
        level=[l for l, w in enumerate(widths) for _ in range(w)],
        vertices_in_level=[
            list(range(starts[l], starts[l + 1])) for l in range(len(widths))
        ],
    )
    return g, starts


def dense_graph(rng, widths, deg, pw=0.25, ncolors=6):
    """Leveled DAG with controlled fan-out (pair-count stress): the same
    random draws in the same order as ``_dense_graph`` of
    ``tests/test_pallas_dp.py``."""
    g, starts = _leveled_graph(widths)
    for l in range(len(widths) - 1):
        k2 = widths[l + 1]
        for u in range(starts[l], starts[l + 1]):
            for v in rng.choice(k2, size=min(k2, deg), replace=False):
                g.adj_list[u].append(
                    (int(starts[l + 1] + v), int(rng.random() < pw)))
        for v in range(starts[l + 1], starts[l + 2]):
            if not any(v == t for u in range(starts[l], starts[l + 1])
                       for t, _ in g.adj_list[u]):
                u = int(rng.integers(starts[l], starts[l + 1]))
                g.adj_list[u].append((v, 0))
    for v in range(len(g.adj_list)):
        for c in rng.choice(ncolors, size=rng.integers(0, 3), replace=False):
            g.color[v].append(int(c))
        g.color[v].sort()
    return g


def hand_graph(widths, edges, colors=None):
    """Leveled DAG with explicit edges (``_hand_graph`` of
    ``tests/test_pallas_dp.py``): ``edges[l]`` lists ``(i, j, w)``, vertex
    ``i`` of level ``l`` to vertex ``j`` of level ``l + 1`` with weight
    ``w``; ``colors`` maps a vertex to its colours."""
    g, starts = _leveled_graph(widths)
    for l, es in enumerate(edges):
        for i, j, w in es:
            g.adj_list[starts[l] + i].append((int(starts[l + 1] + j), w))
    for v, cs in (colors or {}).items():
        g.color[v] = sorted(cs)
    return g


def graph_from_csr(arrs):
    """``(ExpandedGraph, color_homo_bv)`` of CSR arrays: the graph whose
    ``solver.diploid.csr_arrays`` are ``arrs`` again (a vertex's colours
    sorted)."""
    level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom, het_ptr, het = arrs
    g, _ = _leveled_graph(np.diff(level_ptr).tolist())
    for u in range(len(g.adj_list)):
        g.adj_list[u] = [(int(adj_v[k]), int(adj_w[k]))
                         for k in range(adj_ptr[u], adj_ptr[u + 1])]
        g.color[u] = sorted(
            [int(c) for c in hom[hom_ptr[u]:hom_ptr[u + 1]]]
            + [int(c) for c in het[het_ptr[u]:het_ptr[u + 1]]])
    n_colors = int(max(hom.max(initial=-1), het.max(initial=-1))) + 1
    chb = np.zeros(n_colors, bool)
    chb[hom] = True
    return g, chb.tolist()


def wide_window_graph(width: int):
    """``(ExpandedGraph, color_homo_bv)`` of the width-140 instance of
    ``tests/test_pallas_dp.py:119`` at ``width``: widths ``[1, width,
    width, 1]``, two edges a vertex. Its wide run needs ``ceil(width^2 /
    1024)`` windows: more than 31 from width 179 on."""
    rng = np.random.default_rng(11)
    g = dense_graph(rng, [1, width, width, 1], deg=2, pw=0.2)
    return g, [bool(x) for x in rng.random(6) < 0.5]


def high_indegree_graph():
    """``(ExpandedGraph, color_homo_bv)`` of ``test_fused_dp_high_indegree``
    of ``tests/test_device_kernels.py`` (the same draws in the same order):
    widths ``[1, 40, 40, 40, 1]``, every vertex to 36 of the next level's
    40, so the wide levels' in-degree passes 32; R = 3 there."""
    rng = np.random.default_rng(7)
    widths = [1, 40, 40, 40, 1]
    g, starts = _leveled_graph(widths)
    for l in range(len(widths) - 1):
        k2 = widths[l + 1]
        for u in range(starts[l], starts[l + 1]):
            for v in rng.choice(k2, size=min(k2, 36), replace=False):
                g.adj_list[u].append(
                    (int(starts[l + 1] + v), int(rng.random() < 0.2)))
    for v in range(len(g.adj_list)):
        for c in rng.choice(6, size=rng.integers(0, 3), replace=False):
            g.color[v].append(int(c))
        g.color[v].sort()
    return g, [bool(x) for x in rng.random(6) < 0.5]


def heavy_chain(L: int = 1100, n_hom: int = 4096, seed: int = 0):
    """``(ExpandedGraph, color_homo_bv)`` of a chain of width-2 levels whose
    DP values pass 4,100,000: every vertex carries the same ``n_hom`` HOM
    colours (one shared list), so every pair scores at least ``n_hom``, and
    a quarter of the vertices one more HET colour out of six. A vertex has
    an edge of weight 0 to its own index on the next level and of weight 1
    to the other."""
    rng = np.random.default_rng(seed)
    widths = [1] + [2] * (L - 2) + [1]
    g, starts = _leveled_graph(widths)
    hom = list(range(n_hom))
    for l in range(L - 1):
        for i in range(widths[l]):
            for j in range(widths[l + 1]):
                w = int(i != j and min(widths[l], widths[l + 1]) > 1)
                g.adj_list[starts[l] + i].append((int(starts[l + 1] + j), w))
    for v in range(len(g.color)):
        extra = rng.random() < 0.25
        g.color[v] = hom + [n_hom + int(rng.integers(6))] if extra else hom
    return g, [True] * n_hom + [False] * 6


def parallel_edges_graph(width: int = 40, in_edges: int = 210,
                         seed: int = 0):
    """``(ExpandedGraph, color_homo_bv)`` of widths ``[1, width, width, 1]``
    whose vertex 0 of level 2 has ``in_edges`` in-edges from level 1,
    parallel edges among them (vertex ``e % width`` for ``e <
    in_edges``, weights alternating 0 and 1); every other vertex of level 2
    has one. The destination pair (0, 0) of that transition gathers
    ``in_edges ** 2`` pairs: 44,100 at the defaults, more than a K2 slice
    holds (44,032), in a dense run of ``ceil(width ** 2 / 1024)`` windows."""
    rng = np.random.default_rng(seed)
    widths = [1, width, width, 1]
    edges = [[(0, j, 0) for j in range(width)],
             [(e % width, 0, e % 2) for e in range(in_edges)]
             + [(j, j, 0) for j in range(1, width)],
             [(j, 0, 0) for j in range(width)]]
    colors = {v: [int(c) for c in rng.choice(6, size=rng.integers(0, 3),
                                             replace=False)]
              for v in range(sum(widths))}
    return (hand_graph(widths, edges, colors),
            [bool(x) for x in rng.random(6) < 0.5])


# graphs past each of the TPU planner's limits: R >= 32 (on a random
# instance with wide levels, the JAX tests' case (400, 10, 40, 4, 8) at
# another R), wide runs of 32 and 36 windows, DP values past 4,100,000
LIMIT_CASES = ("R32", "R36", "R40", "width179", "width190", "values")


def limit_case(name: str):
    """``(ExpandedGraph, color_homo_bv, R)`` of a ``LIMIT_CASES`` name."""
    if name.startswith("width"):
        return (*wide_window_graph(int(name[5:])), 2)
    if name == "values":
        return (*heavy_chain(), 4)
    return (*graph_from_csr(random_leveled_csr(400, 10, 40, 8)),
            int(name[1:]))


def ragged_reads(seed: int, B: int, L: int, k: int, w: int):
    """``(codes [B, L] u8, lens [B] int32)`` for the sketch kernel: random
    2-bit codes (past a row's length too) with random lengths, and among
    the first rows an empty one, one a base short of a window, one of
    fewer than k bases, a full one, one of a single base repeated (every
    k-mer equal: rightmost ties) and one of period 2. ``B >= 6``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:4] = (0, k + w - 2, k - 1, L)
    codes[4] = 2
    codes[5] = np.arange(L) % 2
    lens[4:6] = L
    return codes, lens


def count_tables(hh, hl, emit, seed: int):
    """Tables for the sketch count (K11), built from the emitted hashes of
    ``(hh, hl, emit)`` (numpy ``[B, NW]``; the halves as uint32 or their
    int32 bit patterns): a list of ``(name, table_hi, table_lo,
    max_dups)``, the tables uint32 and sorted by unsigned ``(hi, lo)``.

    * ``mixed``: half the emitted hashes, 500 random ones, and 20 runs of
      2-7 slots of one emitted hi whose emitted lo comes last (past
      ``max_dup`` in the longer runs); ``max_dup`` 4, 1 and 0;
    * ``full_bucket``: 40 slots of one emitted hi (its lo third: a hit)
      and 40 of another (its lo eleventh: a miss at ``max_dup`` 4) beside
      200 random ones, so one bucket of the index holds more slots than
      the kernel scans;
    * ``lonely``: one emitted hash whose hi is below 2^31 among 999 random
      ones above it, a hit in a bucket whose neighbours are empty;
    * ``edges``: half the emitted hashes and slots of hi 0 and
      0xFFFFFFFF (the first and the last bucket);
    * ``m1``: one emitted hash, M = 1;
    * ``one_read``: the emitted hashes of the row that has the most, so
      every hit is on one read.
    """
    rng = np.random.default_rng(seed)
    hi = np.asarray(hh)[emit].view(np.uint32).astype(np.uint64)
    lo = np.asarray(hl)[emit].view(np.uint32).astype(np.uint64)

    def rand(n):
        return rng.integers(0, 2**32, n, dtype=np.uint64)

    def table(his, los):
        t_hi = np.concatenate(his).astype(np.uint32)
        t_lo = np.concatenate(los).astype(np.uint32)
        order = np.lexsort((t_lo, t_hi))
        return t_hi[order], t_lo[order]

    def run_of(i, n, at):
        """n slots of hi[i] whose lo values sort lo[i] to slot ``at``."""
        los = np.concatenate([
            rng.integers(0, lo[i], at, dtype=np.uint64), lo[i:i + 1],
            rng.integers(lo[i] + 1, 2**32, n - 1 - at, dtype=np.uint64)])
        return np.full(n, hi[i], np.uint64), los

    out = []
    half = rng.random(len(hi)) < 0.5
    his, los = [hi[half], rand(500)], [lo[half], rand(500)]
    # runs of emitted hashes whose lo is neither near 0 nor near 2^32 - 1
    mid = np.nonzero((lo > 2**20) & (lo < 2**32 - 2**20))[0]
    for i in rng.choice(mid, 20, replace=False):
        n = int(rng.integers(2, 8))
        a, b = run_of(i, n, n - 1)
        his.append(a)
        los.append(b)
    out.append(("mixed", *table(his, los), (4, 1, 0)))
    i1, i2 = rng.choice(mid, 2, replace=False)
    runs = [run_of(i1, 40, 2), run_of(i2, 40, 10)]
    out.append(("full_bucket", *table([r[0] for r in runs] + [rand(200)],
                                      [r[1] for r in runs] + [rand(200)]),
                (4,)))
    i = int(np.nonzero(hi < 2**31)[0][0])
    out.append(("lonely", *table([hi[i:i + 1], rng.integers(
        2**31, 2**32, 999, dtype=np.uint64)], [lo[i:i + 1], rand(999)]),
        (4,)))
    ends = np.array([0, 0, 0, 2**32 - 1, 2**32 - 1, 2**32 - 1], np.uint64)
    out.append(("edges", *table([hi[half], ends], [lo[half], np.array(
        [0, 1, 2**32 - 1, 0, 5, 2**32 - 1], np.uint64)]), (4,)))
    out.append(("m1", *table([hi[:1]], [lo[:1]]), (4,)))
    row = int(np.argmax(np.asarray(emit).sum(1)))
    out.append(("one_read", *table(
        [np.asarray(hh)[row][emit[row]].view(np.uint32)],
        [np.asarray(hl)[row][emit[row]].view(np.uint32)]), (4,)))
    return out


def edge_hashes(hh, hl, emit):
    """Copies of ``(hh, hl)`` (numpy ``[B, NW]`` uint32) whose first eight
    emitted windows hash to the ends of the range: hi 0 with lo 0, 1, 7
    and 0xFFFFFFFF, hi 0xFFFFFFFF with lo 0, 5, 9 and 0xFFFFFFFF (some in
    ``count_tables``'s ``edges`` table, some not)."""
    hh, hl = np.array(hh, np.uint32), np.array(hl, np.uint32)
    r, c = np.nonzero(emit)
    m = 2**32 - 1
    for (a, b), x, y in zip(((0, 0), (0, 1), (0, 7), (0, m), (m, 0), (m, 5),
                             (m, 9), (m, m)), r, c):
        hh[x, y], hl[x, y] = a, b
    return hh, hl


def mhc_shaped_csr(L: int = 120_000, seed: int = 0, n_bands: int = 300,
                   band_len: int = 12, wmin: int = 33, wmax: int = 96):
    """CSR arrays of a leveled DAG shaped like the MHC expanded graph.

    Narrow level widths are Poisson(8) clipped to 2..32 and each vertex
    has out-degree 1 or 2 (30%), as in ``bench.py:synthetic_csr``. As in
    an expanded graph, a vertex's first edge follows its haplotype
    (weight 0) and a second edge is a recombination (weight 1) with
    probability 0.43, so ~10% of edges weigh 1 and no path is forced to
    recombine (with uniform weights the optimum needs more than R = 18
    recombinations past ~1000 levels). ~30% of levels carry a new colour on
    3 vertices of that level and the next (15% of colours HOM). On top,
    ``n_bands`` bands of ``band_len`` levels have widths uniform in
    ``wmin..wmax``: by default 33..96, the wide runs of MHC, at most 18
    1024-lane windows each; 141..177 gives the big-window runs (31
    windows) of a graph built from about twice as many haplotypes."""
    rng = np.random.default_rng(seed)
    widths = np.clip(rng.poisson(8, L), 2, 32)
    gap = (L - 2) // max(n_bands, 1)
    for b in range(n_bands):
        s = 1 + b * gap + int(rng.integers(0, max(gap - band_len, 1)))
        e = min(s + band_len, L - 1)
        widths[s:e] = rng.integers(wmin, wmax + 1, max(e - s, 0))
    widths[0] = widths[-1] = 1
    level_ptr = np.zeros(L + 1, np.int64)
    np.cumsum(widths, out=level_ptr[1:])
    n = int(level_ptr[-1])

    # edges: every vertex of level l < L-1 to 1-2 uniform vertices of l+1
    lvl = np.repeat(np.arange(L), widths)
    deg = np.where(lvl < L - 1, 1 + (rng.random(n) < 0.3), 0)
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=adj_ptr[1:])
    src_lvl = np.repeat(lvl, deg)
    nxt = src_lvl + 1
    adj_v = (level_ptr[nxt] + (rng.random(len(nxt)) * widths[nxt]).astype(
        np.int64)).astype(np.int32)
    second = np.zeros(len(adj_v), bool)
    second[adj_ptr[:-1][deg == 2] + 1] = True
    adj_w = (second & (rng.random(len(adj_v)) < 0.43)).astype(np.int8)

    # colours: 3 vertices of levels l..l+1 for ~30% of levels
    lv = np.flatnonzero(rng.random(L - 1) < 0.3)
    span = level_ptr[lv + 2] - level_ptr[lv]
    verts = level_ptr[lv][:, None] + (
        rng.random((len(lv), 3)) * span[:, None]).astype(np.int64)
    col = np.repeat(np.arange(len(lv)), 3)
    hom = rng.random(max(len(lv), 1)) < 0.15
    vc = np.unique(np.stack([verts.reshape(-1), col], 1), axis=0)
    is_h = hom[vc[:, 1]]
    hom_ptr = np.zeros(n + 1, np.int64)
    het_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(vc[is_h, 0], minlength=n), out=hom_ptr[1:])
    np.cumsum(np.bincount(vc[~is_h, 0], minlength=n), out=het_ptr[1:])
    return (level_ptr, adj_ptr, adj_v, adj_w, hom_ptr,
            vc[is_h, 1].astype(np.int32), het_ptr,
            vc[~is_h, 1].astype(np.int32))


def dp_states(level_ptr, R: int) -> int:
    """DP states of the pair DP: (R + 1) * width^2 over levels 1..L-1."""
    w = np.diff(np.asarray(level_ptr, np.int64))
    return int(np.sum((R + 1) * w[1:] * w[1:]))


def pangenome(out_dir: str, n_bp: int = 1_000_000, n_walks: int = 8,
              seed: int = 0, coverage: float = 2.0, read_len: int = 150,
              site_every: int = 120):
    """Write ``pangenome.gfa`` and ``reads.fq`` under ``out_dir``; returns
    their paths.

    A random reference of ``n_bp`` bases carries a variant site every
    ~``site_every`` bases: a SNP (70%), or an insertion or deletion of
    1-6 bases. Each site is a bubble of two non-empty allele segments
    between shared segments; each of ``n_walks`` walks (W lines,
    ``sample{i}`` haplotype 1) takes the alternative allele with a
    per-site frequency drawn from Beta(0.6, 0.6). Reads of ``read_len``
    bases are sampled uniformly from walks 0 and 1, both strands, at
    ``coverage``x each, error-free."""
    rng = np.random.default_rng(seed)
    ref = _BASES[rng.integers(0, 4, n_bp)].tobytes().decode()
    pos = np.cumsum(rng.integers(site_every // 2, site_every * 3 // 2,
                                 n_bp // site_every + 2))
    pos = pos[(pos > 10) & (pos < n_bp - 20)]
    segs = []  # (name, seq)
    paths = [[] for _ in range(n_walks)]
    links = set()
    prev_ends = None  # segment names the previous block ends with
    cursor = 0

    def add(seq):
        segs.append((f"s{len(segs) + 1}", seq))
        return segs[-1][0]

    def link(a_list, b):
        for a in a_list:
            links.add((a, b))

    for p in pos.tolist():
        if p <= cursor:
            continue
        kind = rng.random()
        if kind < 0.7:  # SNP at p
            ref_al = ref[p]
            alt_al = "ACGT"[(("ACGT".index(ref_al)) + int(rng.integers(1, 4))) % 4]
            end = p + 1
        else:
            k = int(rng.integers(1, 7))
            ref_al = ref[p : p + 1 + (k if kind < 0.85 else 0)]
            if kind < 0.85:  # deletion of k bases after the anchor base
                alt_al = ref[p]
            else:  # insertion of k bases after the anchor base
                alt_al = ref[p] + _BASES[rng.integers(0, 4, k)].tobytes().decode()
            end = p + len(ref_al)
        shared = add(ref[cursor:p])
        if prev_ends is not None:
            link(prev_ends, shared)
        a_ref, a_alt = add(ref_al), add(alt_al)
        link([shared], a_ref)
        link([shared], a_alt)
        freq = rng.beta(0.6, 0.6)
        take_alt = rng.random(n_walks) < freq
        for w in range(n_walks):
            paths[w] += [shared, a_alt if take_alt[w] else a_ref]
        prev_ends = [a_ref, a_alt]
        cursor = end
    tail = add(ref[cursor:])
    if prev_ends is not None:
        link(prev_ends, tail)
    for w in range(n_walks):
        paths[w].append(tail)

    os.makedirs(out_dir, exist_ok=True)
    seqs = dict(segs)
    gfa = os.path.join(out_dir, "pangenome.gfa")
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.1\n")
        for name, seq in segs:
            fh.write(f"S\t{name}\t{seq}\tLN:i:{len(seq)}\n")
        for a, b in sorted(links, key=lambda x: (int(x[0][1:]), int(x[1][1:]))):
            fh.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
        for w, path in enumerate(paths):
            length = sum(len(seqs[s]) for s in path)
            walk = "".join(f">{s}" for s in path)
            fh.write(f"W\tsample{w}\t1\tchr6\t0\t{length}\t{walk}\n")

    reads = os.path.join(out_dir, "reads.fq")
    with open(reads, "w") as fh:
        for w in (0, 1):
            hap = "".join(seqs[s] for s in paths[w])
            n_reads = int(len(hap) * coverage / read_len)
            starts = rng.integers(0, max(len(hap) - read_len, 1), n_reads)
            flips = rng.random(n_reads) < 0.5
            for i, (st, fl) in enumerate(zip(starts.tolist(), flips.tolist())):
                r = hap[st : st + read_len]
                if fl:
                    r = r.translate(_COMP)[::-1]
                fh.write(f"@sim_{w}_{i}\n{r}\n+\n{'I' * len(r)}\n")
    return gfa, reads
