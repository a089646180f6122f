"""ctypes bindings for the native host runtime (``native/dgcore.cpp`` at
the repository root).

The port builds its own copy of the library at first use, with the flags
of ``native/Makefile``, into ``build/dipgenie_tpu_torch/native/<hash of
source and flags>/libdgcore.so`` (``.gitignore`` lists ``build/``). The
library is written under a temporary name and renamed into place, so
concurrent processes never load a half-written file. A compiler named
by ``$CXX`` may lack OpenMP's ``libgomp.spec`` while another g++ on the
host has it, so the build tries ``$CXX``, then ``g++``, then
``/usr/bin/g++``. Every entry point has a pure-Python/numpy fallback
elsewhere in the package, so ``available()`` gating is enough.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "dgcore.cpp")
_BUILD_ROOT = os.path.join(_ROOT, "build", "dipgenie_tpu_torch", "native")
# native/Makefile's CXXFLAGS, then its link line
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-march=native",
             "-Wall", "-shared")
_LDLIBS = ("-lz",)

_lib = None
_warned = False


def _warn_unavailable(detail: str) -> None:
    """One-time loud warning: a silently-missing native runtime would turn
    a ~30 s MHC run into hours on the pure-Python fallback tiers."""
    global _warned
    if _warned or os.environ.get("DIPGENIE_NO_NATIVE_WARNING"):
        return
    _warned = True
    print(
        "[dipgenie-tpu] WARNING: native runtime (libdgcore.so) unavailable — "
        "falling back to the much slower pure-Python tiers.\n"
        f"[dipgenie-tpu]   cause: {detail}",
        file=sys.stderr,
        flush=True,
    )


def library_path() -> str:
    h = hashlib.sha1(" ".join(_CXXFLAGS + _LDLIBS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libdgcore.so")


def compilers() -> list[str]:
    """C++ compilers to try, in order: $CXX, g++, /usr/bin/g++."""
    found = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"]
    return list(dict.fromkeys(c for c in found if c))


def _build(path: str) -> bool:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    errors = []
    for cxx in compilers():
        cmd = [cxx, *_CXXFLAGS, _SRC, "-o", tmp, *_LDLIBS]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            errors.append(f"{cxx}: {e!r}")
            continue
        if p.returncode == 0:
            os.replace(tmp, path)
            return True
        errors.append(f"{' '.join(cmd)}:\n{p.stderr.strip()}")
    _warn_unavailable("native build failed:\n" + "\n".join(errors))
    return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SRC):
        _warn_unavailable(f"source {_SRC} not found")
        return None
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _warn_unavailable(f"cannot load {path}: {e}")
        return None

    c_i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    c_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    c_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")

    lib.dg_sketch.restype = ctypes.c_int64
    lib.dg_sketch.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, c_u64p, c_i64p,
    ]
    lib.dg_sketch_batch.restype = None
    lib.dg_sketch_batch.argtypes = [
        c_u8p, c_i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        c_u64p, c_i64p, ctypes.c_int32,
    ]
    lib.dg_haploid_dp.restype = None
    lib.dg_haploid_dp.argtypes = [
        ctypes.c_int64, ctypes.c_int32, c_i64p, c_i32p, c_i8p, c_i64p,
        c_i32p, c_i32p, c_i32p,
    ]
    lib.dg_backtrack.restype = ctypes.c_int64
    lib.dg_backtrack.argtypes = [
        ctypes.c_int64, ctypes.c_int32, c_i32p, c_i32p, ctypes.c_int32, c_i32p,
    ]
    lib.dg_fastx_run.restype = ctypes.c_int64
    lib.dg_fastx_run.argtypes = [ctypes.c_char_p]
    lib.dg_fastx_names_len.restype = ctypes.c_int64
    lib.dg_fastx_seqs_len.restype = ctypes.c_int64
    lib.dg_fastx_fetch.restype = None
    lib.dg_fastx_fetch.argtypes = [c_u8p, c_u8p, c_i64p, c_i64p]
    c_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.dg_gfa_run.restype = ctypes.c_int64
    lib.dg_gfa_run.argtypes = [ctypes.c_char_p]
    for nm in ("dg_gfa_names_len", "dg_gfa_seqs_len", "dg_gfa_narcs",
               "dg_gfa_nwalks", "dg_gfa_wsamples_len", "dg_gfa_wseqnames_len",
               "dg_gfa_wv_len"):
        getattr(lib, nm).restype = ctypes.c_int64
    lib.dg_gfa_fetch_segs.restype = None
    lib.dg_gfa_fetch_segs.argtypes = [
        c_u8p, c_i64p, c_u8p, c_i64p, c_i8p, c_i64p, c_i8p,
    ]
    lib.dg_gfa_fetch_arcs.restype = None
    lib.dg_gfa_fetch_arcs.argtypes = [c_i64p]
    lib.dg_gfa_fetch_walks.restype = None
    lib.dg_gfa_fetch_walks.argtypes = [
        c_u8p, c_i64p, c_u8p, c_i64p, c_i64p, c_i64p, c_i64p, c_u32p, c_i64p,
    ]
    lib.dg_levelize_run.restype = ctypes.c_int32
    lib.dg_levelize_run.argtypes = [ctypes.c_int64, c_i64p, c_i32p, c_i8p]
    lib.dg_levelize_n.restype = ctypes.c_int64
    lib.dg_levelize_ne.restype = ctypes.c_int64
    lib.dg_levelize_nl.restype = ctypes.c_int64
    lib.dg_levelize_maxwidth.restype = ctypes.c_int32
    lib.dg_levelize_fetch.restype = None
    lib.dg_levelize_fetch.argtypes = [
        c_i32p, c_i32p, c_i8p, c_i64p, c_i32p, c_i8p, c_i64p,
    ]
    lib.dg_std_sort3.restype = None
    lib.dg_std_sort3.argtypes = [c_i64p, c_i64p, c_i64p, c_i32p, ctypes.c_int64]
    lib.dg_anchor_run.restype = ctypes.c_int32
    lib.dg_anchor_run.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        c_i64p, c_u64p, c_i64p,  # per-hap minimizers
        c_u64p, ctypes.c_int64,  # spectrum
        c_i64p, c_i32p,  # paths
        c_i64p, c_i64p,  # node_len, top_order_map
        ctypes.c_int32, ctypes.c_double,
    ]
    lib.dg_anchor_nocc.restype = ctypes.c_int64
    lib.dg_anchor_nv.restype = ctypes.c_int64
    lib.dg_anchor_nfiltered.restype = ctypes.c_int64
    lib.dg_anchor_fetch.restype = None
    lib.dg_anchor_fetch.argtypes = [c_i32p, c_i32p, c_i64p, c_i32p, c_i64p]
    lib.dg_build_run.restype = ctypes.c_int32
    lib.dg_build_run.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        c_i64p, c_i32p,  # paths
        c_i64p, c_i32p,  # original adjacency CSR
        ctypes.c_int64, c_i32p, c_i32p, c_i64p, c_i32p,  # occurrences
    ]
    for nm in ("dg_build_n", "dg_build_ne", "dg_build_ncol", "dg_build_norg",
               "dg_build_sink", "dg_build_nanc", "dg_build_nancv",
               "dg_build_ncta"):
        getattr(lib, nm).restype = ctypes.c_int64
    lib.dg_build_ncolors.restype = ctypes.c_int32
    lib.dg_build_fetch.restype = None
    lib.dg_build_fetch.argtypes = [
        c_i64p, c_i32p, c_i8p,  # adj CSR
        c_i64p, c_i32p,  # colors CSR
        c_i64p, c_i32p,  # original vertices CSR
        c_i32p,  # haplotype
        c_i32p,  # color_to_anchor
        c_i64p, c_i32p, c_i32p, c_i64p, c_i32p,  # anchors per hap
    ]
    lib.dg_diploid_dp.restype = ctypes.c_int32
    lib.dg_diploid_dp.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        c_i64p,  # level_ptr
        c_i64p, c_i32p, c_i8p,  # adjacency CSR
        c_i64p, c_i32p,  # hom colors CSR
        c_i64p, c_i32p,  # het colors CSR
        c_i64p,  # out_shet
        c_i32p,  # out_trans
        ctypes.c_int32, ctypes.c_int32,
    ]
    c_i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
    lib.dg_pair_tables_run.restype = ctypes.c_int32
    lib.dg_pair_tables_run.argtypes = [
        ctypes.c_int64, c_i64p,
        c_i64p, c_i32p, c_i8p,  # adjacency CSR
        c_i64p, c_i32p,  # hom colors CSR
        c_i64p, c_i32p,  # het colors CSR
        ctypes.c_int32, ctypes.c_int32,
    ]
    del c_i16p  # layout documented in dg_pair_tables_view
    lib.dg_pair_tables_total.restype = ctypes.c_int64
    lib.dg_pair_tables_view.restype = None
    lib.dg_pair_tables_view.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.dg_pair_tables_release.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def read_fastx(path: str):
    """Native FASTA/FASTQ(.gz) reader; returns list of (name, seq)."""
    lib = get_lib()
    n = lib.dg_fastx_run(path.encode())
    if n < 0:
        raise OSError(f"cannot open {path}")
    names = np.empty(max(lib.dg_fastx_names_len(), 1), np.uint8)
    seqs = np.empty(max(lib.dg_fastx_seqs_len(), 1), np.uint8)
    name_off = np.empty(n + 1, np.int64)
    seq_off = np.empty(n + 1, np.int64)
    lib.dg_fastx_fetch(names, seqs, name_off, seq_off)
    nb = names.tobytes()
    sb = seqs.tobytes()
    return [
        (
            nb[name_off[i] : name_off[i + 1]].decode("latin-1"),
            sb[seq_off[i] : seq_off[i + 1]].decode("latin-1"),
        )
        for i in range(n)
    ]


def read_gfa_arrays(path: str):
    """Native GFA parse; returns the flat arrays of the finalized graph
    (see dgcore.cpp dg_gfa_run). io/gfa.py assembles the Gfa object."""
    lib = get_lib()
    nseg = lib.dg_gfa_run(path.encode())
    if nseg < 0:
        raise OSError(f"cannot open {path}")
    names = np.empty(max(lib.dg_gfa_names_len(), 1), np.uint8)
    name_off = np.empty(nseg + 1, np.int64)
    seqs = np.empty(max(lib.dg_gfa_seqs_len(), 1), np.uint8)
    seq_off = np.empty(nseg + 1, np.int64)
    has_seq = np.empty(max(nseg, 1), np.int8)
    seg_len = np.empty(max(nseg, 1), np.int64)
    seg_del = np.empty(max(nseg, 1), np.int8)
    lib.dg_gfa_fetch_segs(names, name_off, seqs, seq_off, has_seq, seg_len,
                          seg_del)
    na = lib.dg_gfa_narcs()
    arcs = np.empty(max(na * 5, 1), np.int64)
    lib.dg_gfa_fetch_arcs(arcs)
    nw = lib.dg_gfa_nwalks()
    samples = np.empty(max(lib.dg_gfa_wsamples_len(), 1), np.uint8)
    sample_off = np.empty(nw + 1, np.int64)
    seqnames = np.empty(max(lib.dg_gfa_wseqnames_len(), 1), np.uint8)
    seqname_off = np.empty(nw + 1, np.int64)
    hap = np.empty(max(nw, 1), np.int64)
    st = np.empty(max(nw, 1), np.int64)
    en = np.empty(max(nw, 1), np.int64)
    wv = np.empty(max(lib.dg_gfa_wv_len(), 1), np.uint32)
    wv_off = np.empty(nw + 1, np.int64)
    lib.dg_gfa_fetch_walks(samples, sample_off, seqnames, seqname_off,
                           hap, st, en, wv, wv_off)
    return {
        "nseg": int(nseg), "names": names, "name_off": name_off,
        "seqs": seqs, "seq_off": seq_off, "has_seq": has_seq,
        "seg_len": seg_len, "seg_del": seg_del,
        "arcs": arcs[: na * 5].reshape(-1, 5), "nwalks": int(nw),
        "samples": samples, "sample_off": sample_off,
        "seqnames": seqnames, "seqname_off": seqname_off,
        "hap": hap, "st": st, "en": en, "wv": wv, "wv_off": wv_off,
    }


def sketch(seq_bytes: np.ndarray, k: int, w: int):
    """Native minimizer scan; returns (hashes, positions)."""
    lib = get_lib()
    n = len(seq_bytes)
    out_h = np.empty(max(n, 1), np.uint64)
    out_p = np.empty(max(n, 1), np.int64)
    cnt = lib.dg_sketch(
        np.ascontiguousarray(seq_bytes, np.uint8), n, k, w, out_h, out_p
    )
    return out_h[:cnt].copy(), out_p[:cnt].copy()


def sketch_batch(seqs: list[bytes], k: int, w: int, n_threads: int = 0):
    """Native batch scan; returns list of per-read hash arrays."""
    lib = get_lib()
    offsets = np.zeros(len(seqs) + 1, np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    blob = np.frombuffer(b"".join(seqs), np.uint8) if seqs else np.zeros(1, np.uint8)
    blob = np.ascontiguousarray(blob)
    if len(blob) == 0:
        blob = np.zeros(1, np.uint8)
    out_h = np.empty(max(int(offsets[-1]), 1), np.uint64)
    out_off = np.zeros(len(seqs) + 1, np.int64)
    lib.dg_sketch_batch(blob, offsets, len(seqs), k, w, out_h, out_off, n_threads)
    return [out_h[out_off[i] : out_off[i + 1]].copy() for i in range(len(seqs))]


def haploid_dp(adj_ptr, adj_v, adj_w, color_size, R: int):
    lib = get_lib()
    n = len(adj_ptr) - 1
    dp = np.empty((n, R + 1), np.int32)
    bv = np.empty((n, R + 1), np.int32)
    br = np.empty((n, R + 1), np.int32)
    lib.dg_haploid_dp(
        n, R,
        np.ascontiguousarray(adj_ptr, np.int64),
        np.ascontiguousarray(adj_v, np.int32),
        np.ascontiguousarray(adj_w, np.int8),
        np.ascontiguousarray(color_size, np.int64),
        dp.reshape(-1), bv.reshape(-1), br.reshape(-1),
    )
    return dp, bv, br


def backtrack(bv, br, r: int):
    lib = get_lib()
    n, W = bv.shape
    out = np.empty(n, np.int32)
    ln = lib.dg_backtrack(
        n, W - 1, np.ascontiguousarray(bv.reshape(-1)),
        np.ascontiguousarray(br.reshape(-1)), r, out,
    )
    return out[:ln][::-1].copy()


def anchor_stage(min_ptr, min_hash, min_pos, sp_hashes, path_ptr, path_v,
                 node_len, top_order_map, k: int, threshold: float):
    """Native anchor join + chains + filter + sort (solver.cpp:563-663).

    Returns flat occurrence arrays ordered (spectrum id asc, hap asc,
    emission order): (occ_sp, occ_hap, occ_ptr, occ_v, hap_counts,
    n_filtered)."""
    lib = get_lib()
    nH = len(min_ptr) - 1
    n_vtx = len(node_len)
    rc = lib.dg_anchor_run(
        n_vtx, nH,
        np.ascontiguousarray(min_ptr, np.int64),
        np.ascontiguousarray(min_hash, np.uint64),
        np.ascontiguousarray(min_pos, np.int64),
        np.ascontiguousarray(sp_hashes, np.uint64), len(sp_hashes),
        np.ascontiguousarray(path_ptr, np.int64),
        np.ascontiguousarray(path_v, np.int32),
        np.ascontiguousarray(node_len, np.int64),
        np.ascontiguousarray(top_order_map, np.int64),
        k, threshold,
    )
    if rc != 0:
        raise RuntimeError(f"dg_anchor_run failed rc={rc}")
    nocc = lib.dg_anchor_nocc()
    nv = lib.dg_anchor_nv()
    n_filtered = int(lib.dg_anchor_nfiltered())
    occ_sp = np.empty(max(nocc, 1), np.int32)
    occ_hap = np.empty(max(nocc, 1), np.int32)
    occ_ptr = np.empty(nocc + 1, np.int64)
    occ_v = np.empty(max(nv, 1), np.int32)
    hap_counts = np.empty(max(nH, 1), np.int64)
    lib.dg_anchor_fetch(occ_sp, occ_hap, occ_ptr, occ_v, hap_counts)
    return (occ_sp[:nocc], occ_hap[:nocc], occ_ptr, occ_v[:nv],
            hap_counts[:nH], n_filtered)


def build_expanded(n_vtx, path_ptr, path_v, oadj_ptr, oadj_v,
                   occ_sp, occ_hap, occ_ptr, occ_v):
    """Native expanded-graph construction + Kahn reorder
    (approximator.cpp:1017-1246, ExpandedGraph.hpp:29-102).

    Returns a dict of CSR arrays: adjacency, colours, original vertices,
    haplotype, sink, num_colors, color_to_anchor and the per-hap
    post-sweep anchor tables."""
    lib = get_lib()
    nH = len(path_ptr) - 1
    n_occ = len(occ_sp)
    rc = lib.dg_build_run(
        n_vtx, nH,
        np.ascontiguousarray(path_ptr, np.int64),
        np.ascontiguousarray(path_v, np.int32),
        np.ascontiguousarray(oadj_ptr, np.int64),
        np.ascontiguousarray(oadj_v, np.int32),
        n_occ,
        np.ascontiguousarray(occ_sp, np.int32),
        np.ascontiguousarray(occ_hap, np.int32),
        np.ascontiguousarray(occ_ptr, np.int64),
        np.ascontiguousarray(occ_v, np.int32),
    )
    if rc != 0:
        raise RuntimeError(f"dg_build_run failed rc={rc}")
    n = lib.dg_build_n()
    ne = lib.dg_build_ne()
    ncol = lib.dg_build_ncol()
    norg = lib.dg_build_norg()
    nanc = lib.dg_build_nanc()
    nancv = lib.dg_build_nancv()
    ncta = lib.dg_build_ncta()
    out = {
        "adj_ptr": np.empty(n + 1, np.int64),
        "adj_v": np.empty(max(ne, 1), np.int32),
        "adj_w": np.empty(max(ne, 1), np.int8),
        "col_ptr": np.empty(n + 1, np.int64),
        "col_v": np.empty(max(ncol, 1), np.int32),
        "org_ptr": np.empty(n + 1, np.int64),
        "org_v": np.empty(max(norg, 1), np.int32),
        "hap": np.empty(max(n, 1), np.int32),
        "color_to_anchor": np.empty(max(ncta, 1), np.int32),
        "anc_ptr": np.empty(nH + 1, np.int64),
        "anc_so": np.empty(max(nanc, 1), np.int32),
        "anc_eo": np.empty(max(nanc, 1), np.int32),
        "anc_cptr": np.empty(nanc + 1, np.int64),
        "anc_cv": np.empty(max(nancv, 1), np.int32),
    }
    out["sink"] = int(lib.dg_build_sink())
    out["num_colors"] = int(lib.dg_build_ncolors())
    lib.dg_build_fetch(
        out["adj_ptr"], out["adj_v"], out["adj_w"],
        out["col_ptr"], out["col_v"], out["org_ptr"], out["org_v"],
        out["hap"], out["color_to_anchor"], out["anc_ptr"],
        out["anc_so"], out["anc_eo"], out["anc_cptr"], out["anc_cv"],
    )
    out["adj_v"] = out["adj_v"][:ne]
    out["adj_w"] = out["adj_w"][:ne]
    out["col_v"] = out["col_v"][:ncol]
    out["org_v"] = out["org_v"][:norg]
    out["color_to_anchor"] = out["color_to_anchor"][:ncta]
    out["anc_so"] = out["anc_so"][:nanc]
    out["anc_eo"] = out["anc_eo"][:nanc]
    out["anc_cv"] = out["anc_cv"][:nancv]
    return out


def diploid_dp(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
               het_ptr, het_colors, R: int, n_threads: int = 0,
               progress: bool = False):
    """Returns (sink_value, sink_shet, transitions[L,5])."""
    lib = get_lib()
    L = len(level_ptr) - 1
    nv = len(adj_ptr) - 1
    out_shet = np.zeros(1, np.int64)
    out_trans = np.full(5 * L, -1, np.int32)
    val = lib.dg_diploid_dp(
        nv, L, R,
        np.ascontiguousarray(level_ptr, np.int64),
        np.ascontiguousarray(adj_ptr, np.int64),
        np.ascontiguousarray(adj_v, np.int32),
        np.ascontiguousarray(adj_w, np.int8),
        np.ascontiguousarray(hom_ptr, np.int64),
        np.ascontiguousarray(hom_colors, np.int32),
        np.ascontiguousarray(het_ptr, np.int64),
        np.ascontiguousarray(het_colors, np.int32),
        out_shet, out_trans, n_threads, 1 if progress else 0,
    )
    if val == -(2**31):  # validation sentinel from dg_diploid_dp
        raise ValueError(
            "dg_diploid_dp rejected the workload: R must be >= 0 and every "
            "level width must be < 4096 (backpointer packing limit)"
        )
    return int(val), int(out_shet[0]), out_trans.reshape(L, 5)


def pair_tables_all(level_ptr, adj_ptr, adj_v, adj_w, hom_ptr, hom_colors,
                    het_ptr, het_colors, R: int, n_threads: int = 0):
    """All transitions' sorted/scored edge-pair tables in ONE native call
    (OpenMP over levels) — the hot half of diploid_pallas.plan_pairs.

    Returns (off[L], s1, s2, d1, d2, symd, ws, w1, score, score_max)
    with pair arrays flat over transitions, or None if the instance
    exceeds the native sort-key bounds (the numpy path then reports the
    pallas tier's own limits properly)."""
    lib = get_lib()
    L = len(level_ptr) - 1
    rc = lib.dg_pair_tables_run(
        L,
        np.ascontiguousarray(level_ptr, np.int64),
        np.ascontiguousarray(adj_ptr, np.int64),
        np.ascontiguousarray(adj_v, np.int32),
        np.ascontiguousarray(adj_w, np.int8),
        np.ascontiguousarray(hom_ptr, np.int64),
        np.ascontiguousarray(hom_colors, np.int32),
        np.ascontiguousarray(het_ptr, np.int64),
        np.ascontiguousarray(het_colors, np.int32),
        R, n_threads,
    )
    if rc != 0:
        return None
    total = int(lib.dg_pair_tables_total())
    T = max(L - 1, 0)
    # zero-copy: wrap the native static storage directly. A fresh
    # 0.5 GB copy would pay 10-60 s of first-touch page faults on this
    # class of virtualized host (see dg_pair_tables_view). The views
    # are valid until the next pair_tables_all call; plan_pairs
    # consumes them within one planning pass.
    ptrs = (ctypes.c_void_p * 10)()
    lib.dg_pair_tables_view(ptrs)

    def view(i, n, dt):
        if n == 0:
            return np.empty(0, dt)
        nbytes = np.dtype(dt).itemsize * n
        arr = np.ctypeslib.as_array(
            ctypes.cast(ptrs[i], ctypes.POINTER(ctypes.c_uint8)),
            shape=(nbytes,),
        )
        return arr.view(dt)

    return (
        view(0, T + 1, np.int64),
        view(1, total, np.int16), view(2, total, np.int16),
        view(3, total, np.int16), view(4, total, np.int16),
        view(5, total, np.int16),
        view(6, total, np.int8), view(7, total, np.int8),
        view(8, total, np.int32),
        view(9, T, np.int32),
    )
