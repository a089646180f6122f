"""Anchor computation, filtering and HOM/HET classification.

Equivalent of the reference ``compute_and_classify_anchors``
(reference: src/solver.cpp:449-887):

  1. sketch every haplotype walk; per-minimizer anchor = the chain of
     walk vertices its k-mer spans, deduped by first appearance then
     sorted by MSA column order (solver.cpp:336-358);
  2. sketch every read; the read spectrum Sp_R maps each distinct hash
     to a dense id in ascending-hash order (std::map semantics,
     solver.cpp:533-547);
  3. hash-join each haplotype's minimizers against the spectrum →
     ``anchor_hits[spectrum_id][hap]`` chains (solver.cpp:563-575);
  4. uninformativeness filter: a spectrum id is dropped whole if any
     identical chain occurs >= threshold*num_walks times across
     haplotypes (solver.cpp:590-633);
  5. chains re-sorted by (first vertex, last vertex), empties last
     (solver.cpp:641-663);
  6. k-mer multiplicity histogram = for each hash, the number of reads
     whose sketch contains it (solver.cpp:711-754);
  7. mixture-model grid fit + classification → homo_bv and the
     homo/hetero splits (solver.cpp:779-887).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..device import resolve_device
from ..graph.pangenome import PangenomeIndex
from ..models.classifier import KGParams, classify_labels, HET, HOM
from ..models.fitter import KGFitOptions, KGFitResult, fit_histogram
from ..sketch.minimizers import Minimizers, sketch_sequence
from ..utils.timing import log_stage

Chain = tuple[int, ...]


@dataclass
class AnchorData:
    count_sp_r: int = 0
    sp_hashes: np.ndarray | None = None  # [S] uint64, ascending; id -> hash
    anchor_hits: list[list[list[Chain]]] = field(default_factory=list)
    homo_bv: np.ndarray | None = None  # [S] int8
    multiplicity: np.ndarray | None = None  # [S] int64 (#reads per hash)
    fit: KGFitResult | None = None
    hap_minimizer_counts: list[int] = field(default_factory=list)
    # flat occurrence arrays (native anchor stage): ordered
    # (spectrum id asc, hap asc, emission order); consumed directly by
    # the native expanded-graph builder.
    occ_sp: np.ndarray | None = None
    occ_hap: np.ndarray | None = None
    occ_ptr: np.ndarray | None = None
    occ_v: np.ndarray | None = None


def _hap_anchor_chains(
    index: PangenomeIndex, h: int, positions: np.ndarray, k: int
) -> list[Chain]:
    """Map minimizer start offsets to vertex chains (solver.cpp:336-358)."""
    path = index.paths[h]
    lens = np.asarray([len(index.node_seq[v]) for v in path], np.int64)
    pstep = np.repeat(np.arange(len(path), dtype=np.int64), lens)
    tom = index.top_order_map
    t0 = pstep[positions]
    t1 = pstep[positions + k - 1]
    out: list[Chain] = []
    for a, b in zip(t0.tolist(), t1.tolist()):
        seg = path[a : b + 1]
        # dedupe by first appearance, then sort by MSA order
        seen: dict[int, None] = {}
        for v in seg.tolist():
            if v not in seen:
                seen[v] = None
        uniq = sorted(seen.keys(), key=lambda v: tom[v])
        out.append(tuple(uniq))
    return out


def compute_and_classify_anchors(
    index: PangenomeIndex,
    reads: list[tuple[str, str]],
    k: int,
    w: int,
    threshold: float,
    verbose: bool = True,
    sketch_backend: str = "host",  # host | device | python
    mesh=None,  # optional parallel.mesh.Mesh: reads shard over its dp ranks
    device="cuda",  # where device sketching runs (K10 on the card)
) -> AnchorData:
    H = index.num_walks
    data = AnchorData()

    use_device = sketch_backend == "device"
    use_native = False
    if use_device:
        from ..ops import sketch as _sketch

        device = resolve_device(device)
        _sketch.check_k(k)
        launches = _sketch.batch_minimizer.launches
    elif sketch_backend in ("host", "auto"):
        from .. import native as _native

        use_native = _native.available()

    # 1) sketch haplotypes
    if verbose:
        print("Number of Minimizers", file=sys.stderr)
    hap_minis = []
    for h in range(H):
        if use_device:
            hs, ps = _sketch.sketch_long_sequence_device(
                index.haplotype_seq(h), k, w, device)
            mins = Minimizers(hs, ps, k)
        elif use_native:
            seq = np.frombuffer(
                index.haplotype_seq(h).encode("latin-1"), np.uint8
            )
            hs, ps = _native.sketch(seq, k, w)
            mins = Minimizers(hs, ps, k)
        else:
            mins = sketch_sequence(index.haplotype_seq(h), k, w)
        hap_minis.append(mins)
        data.hap_minimizer_counts.append(len(mins.hashes))
        if verbose:
            print(f"{index.hap_id2name[h]} : {len(mins.hashes)}", file=sys.stderr)

    # 2) sketch reads -> per-read unique hash sets
    if use_device:
        read_hashes = _sketch.sketch_reads_device(
            [seq for _, seq in reads], k, w, mesh=mesh, device=device)
        if verbose:
            log_stage(
                "compute_and_classify_anchors",
                f"device sketch on {device.type}: {len(reads)} reads, "
                f"{_sketch.sketch_reads_device.host_rows} of them by the host "
                "scanner (non-ACGT or shorter than w + k - 1), "
                f"{_sketch.batch_minimizer.launches - launches} launches",
            )
    elif use_native:
        batched = _native.sketch_batch(
            [seq.encode("latin-1") for _, seq in reads], k, w
        )
        read_hashes = [np.unique(h) for h in batched]
    else:
        read_hashes = [
            np.unique(sketch_sequence(seq, k, w).hashes) for _, seq in reads
        ]

    # 3) spectrum: ascending distinct hashes -> dense ids (std::map order)
    all_hashes = (
        np.concatenate(read_hashes) if read_hashes else np.empty(0, np.uint64)
    )
    sp_hashes = np.unique(all_hashes)
    S = len(sp_hashes)
    data.count_sp_r = S
    data.sp_hashes = sp_hashes
    if verbose:
        log_stage(
            "compute_and_classify_anchors",
            f"Indexed reads with spectrum size: {S}",
        )

    # 4-6) native fast path: join + chains + filter + sort in dgcore,
    # emitting flat occurrence arrays (identical semantics and tie order
    # to the Python path below; validated in tests)
    native_ok = False
    if sketch_backend != "python":
        from .. import native as _nat

        native_ok = _nat.available()
    if native_ok:
        min_ptr = np.zeros(H + 1, np.int64)
        for h in range(H):
            min_ptr[h + 1] = min_ptr[h] + len(hap_minis[h].hashes)
        min_hash = (
            np.concatenate([m.hashes for m in hap_minis]).astype(np.uint64)
            if H
            else np.empty(0, np.uint64)
        )
        min_pos = (
            np.concatenate([m.positions for m in hap_minis]).astype(np.int64)
            if H
            else np.empty(0, np.int64)
        )
        path_ptr = np.zeros(H + 1, np.int64)
        for h in range(H):
            path_ptr[h + 1] = path_ptr[h] + len(index.paths[h])
        path_v = (
            np.concatenate(index.paths).astype(np.int32)
            if H
            else np.empty(0, np.int32)
        )
        (data.occ_sp, data.occ_hap, data.occ_ptr, data.occ_v,
         hap_counts, _nfilt) = _nat.anchor_stage(
            min_ptr, min_hash, min_pos, sp_hashes, path_ptr, path_v,
            index.node_len, index.top_order_map, k, threshold,
        )
        if verbose:
            print("Number of Anchors", file=sys.stderr)
            for h in range(H):
                print(
                    f"{index.hap_id2name[h]} : {int(hap_counts[h])}",
                    file=sys.stderr,
                )
            _log_filtered(int(_nfilt), S)
        _classify(data, read_hashes, sp_hashes, S, verbose)
        return data

    # 4) per-hap hash join (emission order per hap, solver.cpp:563-575)
    anchor_hits: list[list[list[Chain]]] = [[[] for _ in range(H)] for _ in range(S)]
    for h in range(H):
        mins = hap_minis[h]
        if len(mins.hashes) == 0:
            continue
        idx = np.searchsorted(sp_hashes, mins.hashes)
        idx_c = np.clip(idx, 0, max(S - 1, 0))
        matched = (idx < S) & (sp_hashes[idx_c] == mins.hashes) if S else np.zeros(len(mins.hashes), bool)
        mpos = mins.positions[matched]
        mids = idx[matched]
        chains = _hap_anchor_chains(index, h, mpos, k)
        for sp_id, chain in zip(mids.tolist(), chains):
            anchor_hits[sp_id][h].append(chain)

    # 5) uninformativeness filter (solver.cpp:590-633)
    filtered = 0
    nonempty_path = [len(index.paths[h]) > 0 for h in range(H)]
    for r in range(S):
        counts: dict[Chain, int] = {}
        for h in range(H):
            if not nonempty_path[h]:
                continue
            for chain in anchor_hits[r][h]:
                counts[chain] = counts.get(chain, 0) + 1
        if any(c >= threshold * H for c in counts.values()):
            anchor_hits[r] = [[] for _ in range(H)]
            filtered += 1

    # 6) sort occurrences by (first, last), empties last (solver.cpp:641-663).
    # std::sort tie order is observable downstream; lists <= 16 elements hit
    # libstdc++'s insertion sort (stable), longer lists go through the
    # introsort-compatible path.
    from ..utils.stdsort import std_sort_by_keys3

    def chain_keys(chains):
        k1 = [1 if len(c) == 0 else 0 for c in chains]
        k2 = [0 if len(c) == 0 else c[0] for c in chains]
        k3 = [0 if len(c) == 0 else c[-1] for c in chains]
        return k1, k2, k3

    for r in range(S):
        for h in range(H):
            chains = anchor_hits[r][h]
            if len(chains) <= 16:
                chains.sort(
                    key=lambda c: (1,) if len(c) == 0 else (0, c[0], c[-1])
                )
            else:
                anchor_hits[r][h] = std_sort_by_keys3(chains, *chain_keys(chains))
    data.anchor_hits = anchor_hits

    if verbose:
        print("Number of Anchors", file=sys.stderr)
        for h in range(H):
            loc = sum(len(anchor_hits[r][h]) for r in range(S))
            print(f"{index.hap_id2name[h]} : {loc}", file=sys.stderr)
        _log_filtered(filtered, S)

    _classify(data, read_hashes, sp_hashes, S, verbose)
    return data


def _log_filtered(filtered: int, S: int) -> None:
    """Filtered/retained minimizer percentages (solver.cpp:668-693; the
    reference computes these but its print is commented out — we emit
    the intended line)."""
    denom = max(S, 1)
    log_stage(
        "compute_and_classify_anchors",
        f"Filtered/Retained Minimizers: "
        f"{100.0 * filtered / denom:.2f}/{100.0 * (S - filtered) / denom:.2f}%",
    )


def materialize_hits(data: AnchorData, H: int) -> list[list[list[Chain]]]:
    """Reconstruct the Python anchor_hits structure from the flat
    occurrence arrays (native anchor stage output). The flat arrays are
    already filtered and sorted, so this is a pure reshape."""
    S = data.count_sp_r
    hits: list[list[list[Chain]]] = [[[] for _ in range(H)] for _ in range(S)]
    sp = data.occ_sp.tolist()
    hap = data.occ_hap.tolist()
    ptr = data.occ_ptr.tolist()
    vals = data.occ_v.tolist()
    for i, (a, h) in enumerate(zip(sp, hap)):
        hits[a][h].append(tuple(vals[ptr[i] : ptr[i + 1]]))
    return hits


def _classify(data: AnchorData, read_hashes, sp_hashes, S: int,
              verbose: bool) -> None:
    """Histogram + mixture fit + HOM/HET classification
    (solver.cpp:711-887)."""
    # 7) multiplicity histogram: #reads containing each hash
    mult_per_hash = np.zeros(S, np.int64)
    for rh in read_hashes:
        pos = np.searchsorted(sp_hashes, rh)
        mult_per_hash[pos] += 1
    data.multiplicity = mult_per_hash

    uniq_m, freq = np.unique(mult_per_hash, return_counts=True)
    hist_pairs = [(int(m), float(f)) for m, f in zip(uniq_m, freq) if m > 0]
    max_mult = int(uniq_m.max()) if len(uniq_m) else 0

    opt = KGFitOptions(
        max_copy=10, max_x_use=max_mult, u_hi=float(max_mult),
        fit_error=True, fit_varw=True,
    )
    print("Classifying kmers...")
    fit = fit_histogram(hist_pairs, opt)
    data.fit = fit
    P = fit.P
    if verbose:
        print(
            f"[M::compute_and_classify_anchors] Fitted model: best NLL={fit.nll:.2f}, "
            f"u_v={P.u_v:.2f} (hom mean), sd_v={P.sd_v:.2f} (hom SD), "
            f"var_w={P.var_w:.2f}, p_d={P.p_d:.2f}, zp_copy={P.zp_copy:.2f}, "
            f"zp_copy_het={P.zp_copy_het:.2f}, err_shape={P.err_shape:.2f}, "
            f"max_copy={P.max_copy}",
            file=sys.stderr,
        )

    # 8) classification (solver.cpp:830-885). multiplicity >= 1 always here.
    labels = classify_labels(mult_per_hash, P)
    homo_bv = (labels == HOM).astype(np.int8)
    data.homo_bv = homo_bv
    count_homo = int(homo_bv.sum())
    count_het = S - count_homo
    if verbose:
        denom = max(1, count_homo + count_het)
        print(
            f"[M::compute_and_classify_anchors] Phasing done. "
            f"Homozygous: {100.0*count_homo/denom:.2f}%, "
            f"Heterozygous: {100.0*count_het/denom:.2f}%, "
            f"Total kmers: {count_homo+count_het}",
            file=sys.stderr,
        )
