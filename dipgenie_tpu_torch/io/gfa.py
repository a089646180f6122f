"""GFA v1.1 reader with walk (W-line) support.

Re-implements the observable behavior of the reference's minigraph-derived
C layer (reference: src/gfa-io.cpp, src/gfa-base.cpp) needed by the
pipeline:

  * segment ids assigned in first-appearance order across S and L lines
    (gfa-base.cpp:75 gfa_add_seg); W lines only look names up
    (gfa-io.cpp:399 gfa_name2id) and silently skip unknown segments.
  * vertex encoding: ``seg_id << 1 | orientation`` (1 = reverse)
    (gfa.h:12-31).
  * arcs from L lines plus symmetric complements added in
    ``gfa_fix_symm_add`` (gfa-base.cpp:269-304); arcs touching segments
    with no sequence/length are deleted (gfa-base.cpp:201-233).
  * walks canonicalized by majority strand: ``gfa_walk_flip``
    (gfa-io.cpp:64-115) flips a walk (reverse + complement each vertex)
    when most of its vertices disagree with the strand of their first
    appearance across all walks.
  * embedded-FASTA mode (gfa-io.cpp:479-499) is supported.

The parser is a clean-room implementation driven by those semantics; it
holds segments/arcs/walks in plain Python/numpy structures.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field

import numpy as np

INT32_MAX = 2**31 - 1


@dataclass
class Walk:
    sample: str
    hap: int
    seqname: str
    st: int
    en: int
    v: np.ndarray  # uint32 vertices: seg<<1 | is_reverse


@dataclass
class Gfa:
    seg_names: list[str] = field(default_factory=list)
    seg_seqs: list[str | None] = field(default_factory=list)
    seg_lens: list[int] = field(default_factory=list)
    seg_del: list[bool] = field(default_factory=list)
    # arcs as (v, w, ov, ow, comp); finalized in place
    arcs: list[tuple[int, int, int, int, int]] = field(default_factory=list)
    walks: list[Walk] = field(default_factory=list)
    name2id: dict[str, int] = field(default_factory=dict)

    @property
    def n_seg(self) -> int:
        return len(self.seg_names)

    @property
    def n_vtx(self) -> int:
        return 2 * len(self.seg_names)

    def add_seg(self, name: str) -> int:
        sid = self.name2id.get(name)
        if sid is None:
            sid = len(self.seg_names)
            self.name2id[name] = sid
            self.seg_names.append(name)
            self.seg_seqs.append(None)
            self.seg_lens.append(0)
            self.seg_del.append(False)
        return sid


def _parse_overlap(fieldstr: str) -> tuple[int, int]:
    """Parse the L-line overlap field (gfa-io.cpp:298-319)."""
    if fieldstr == "*":
        return 0, 0
    if fieldstr.startswith(":"):
        rest = fieldstr[1:]
        ow = int(rest) if rest[:1].isdigit() else INT32_MAX
        return INT32_MAX, ow
    if fieldstr[:1].isdigit():
        # either "<n>:<m>", plain int, or CIGAR
        i = 0
        while i < len(fieldstr) and fieldstr[i].isdigit():
            i += 1
        if i < len(fieldstr) and fieldstr[i].isupper():
            # CIGAR string
            ov = ow = 0
            num = 0
            for ch in fieldstr:
                if ch.isdigit():
                    num = num * 10 + ord(ch) - 48
                else:
                    if ch in "MDN":
                        ov += num
                    if ch in "MIS":
                        ow += num
                    num = 0
            return ov, ow
        if i < len(fieldstr) and fieldstr[i] == ":":
            ov = int(fieldstr[:i])
            rest = fieldstr[i + 1 :]
            ow = int(rest) if rest[:1].isdigit() else INT32_MAX
            return ov, ow
        return int(fieldstr[:i]), INT32_MAX  # bare int, missing ow
    return 0, 0


def _get_tag(fields: list[str], key: str, typ: str) -> str | None:
    prefix = f"{key}:{typ}:"
    for f in fields:
        if f.startswith(prefix):
            return f[len(prefix) :]
    return None


def _open_maybe_gz(fn: str):
    f = open(fn, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rt")
    f.seek(0)
    return _io.TextIOWrapper(f)


def read_gfa(fn: str, backend: str = "auto") -> Gfa:
    """Parse + finalize a GFA file. backend: auto | native | python.

    "auto" uses the C++ streaming parser (native/dgcore.cpp dg_gfa_run)
    when the native runtime is available and falls back to the pure-Python
    path below, which is also the behavioral oracle the native parser is
    tested against (tests/test_native_build.py)."""
    if backend in ("auto", "native"):
        from .. import native as _native

        if _native.available():
            return _gfa_from_arrays(_native.read_gfa_arrays(fn))
        if backend == "native":
            raise RuntimeError("native runtime unavailable")
    return read_gfa_python(fn)


def _gfa_from_arrays(d: dict) -> Gfa:
    """Assemble a Gfa from the native parser's flat arrays."""
    g = Gfa()
    nb = d["names"].tobytes()
    sb = d["seqs"].tobytes()
    no, so = d["name_off"], d["seq_off"]
    has = d["has_seq"]
    for i in range(d["nseg"]):
        g.seg_names.append(nb[no[i] : no[i + 1]].decode("latin-1"))
        g.seg_seqs.append(
            sb[so[i] : so[i + 1]].decode("latin-1") if has[i] else None
        )
    g.seg_lens = d["seg_len"][: d["nseg"]].tolist()
    g.seg_del = [bool(x) for x in d["seg_del"][: d["nseg"]]]
    g.name2id = {nm: i for i, nm in enumerate(g.seg_names)}
    g.arcs = [tuple(int(x) for x in row) for row in d["arcs"]]
    smb = d["samples"].tobytes()
    qnb = d["seqnames"].tobytes()
    smo, qno, wvo = d["sample_off"], d["seqname_off"], d["wv_off"]
    for i in range(d["nwalks"]):
        g.walks.append(
            Walk(
                smb[smo[i] : smo[i + 1]].decode("latin-1"),
                int(d["hap"][i]),
                qnb[qno[i] : qno[i + 1]].decode("latin-1"),
                int(d["st"][i]),
                int(d["en"][i]),
                d["wv"][wvo[i] : wvo[i + 1]].copy(),
            )
        )
    return g


def read_gfa_python(fn: str) -> Gfa:
    g = Gfa()
    is_fa = False
    fa_sid = -1
    fa_seq: list[str] = []

    def finish_fa():
        nonlocal fa_sid
        if fa_sid >= 0:
            seq = "".join(fa_seq)
            g.seg_seqs[fa_sid] = seq
            g.seg_lens[fa_sid] = len(seq)
            fa_sid = -1

    with _open_maybe_gz(fn) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):  # embedded FASTA header (gfa-io.cpp:479)
                is_fa = True
                finish_fa()
                fa_seq = []
                # auto-named segment "s<n+1>" (gfa-io.cpp:442)
                fa_sid = g.add_seg(f"s{g.n_seg + 1}")
                continue
            if is_fa:
                if len(line) >= 3 and line[1] == "\t":  # back to GFA lines
                    finish_fa()
                    is_fa = False
                else:
                    fa_seq.append(line)
                    continue
            if len(line) < 3 or line[1] != "\t":
                continue
            tag = line[0]
            fields = line.split("\t")
            if tag == "S":
                if len(fields) < 3:
                    continue
                name, seq = fields[1], fields[2]
                rest = fields[3:]
                ln_tag = _get_tag(rest, "LN", "i")
                sid = g.add_seg(name)
                if seq == "*":
                    g.seg_seqs[sid] = None
                    g.seg_lens[sid] = int(ln_tag) if ln_tag is not None else 0
                else:
                    g.seg_seqs[sid] = seq
                    g.seg_lens[sid] = len(seq)
            elif tag == "L":
                if len(fields) < 5:
                    continue
                segv, oriv, segw, oriw = fields[1], fields[2], fields[3], fields[4]
                if oriv not in "+-" or oriw not in "+-":
                    continue
                ov, ow = _parse_overlap(fields[5]) if len(fields) > 5 else (0, 0)
                v = g.add_seg(segv) << 1 | (oriv == "-")
                w = g.add_seg(segw) << 1 | (oriw == "-")
                g.arcs.append((v, w, ov, ow, 0))
            elif tag == "W":
                if len(fields) < 7:
                    continue
                sample = fields[1]
                hap = int(fields[2]) if fields[2].lstrip("-").isdigit() else 0
                seqname = fields[3]
                st = int(fields[4]) if fields[4].lstrip("-").isdigit() else 0
                en = int(fields[5]) if fields[5].lstrip("-").isdigit() else 0
                vs: list[int] = []
                walk_str = fields[6]
                i = 0
                n = len(walk_str)
                while i < n:
                    ori = walk_str[i]
                    if ori not in "<>":
                        break
                    j = i + 1
                    while j < n and walk_str[j] not in "<>":
                        j += 1
                    name = walk_str[i + 1 : j]
                    sid = g.name2id.get(name)
                    if sid is not None:
                        vs.append(sid << 1 | (ori == "<"))
                    i = j
                g.walks.append(
                    Walk(sample, hap, seqname, st, en, np.asarray(vs, np.uint32))
                )
    finish_fa()
    _walk_flip(g)
    _finalize(g)
    return g


def write_gfa(g: Gfa, path: str) -> None:
    """GFA v1.1 writer (gfa_print parity, gfa-io.cpp:510-533): S lines
    with LN tag, primary L lines (complement arcs skipped), W lines."""
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.1\n")
        for sid in range(g.n_seg):
            if g.seg_del[sid]:
                continue
            seq = g.seg_seqs[sid] if g.seg_seqs[sid] is not None else "*"
            fh.write(
                f"S\t{g.seg_names[sid]}\t{seq}\tLN:i:{g.seg_lens[sid]}\n"
            )
        for v, w, ov, ow, comp in g.arcs:
            if comp:
                continue
            fh.write(
                f"L\t{g.seg_names[v >> 1]}\t{'-' if v & 1 else '+'}"
                f"\t{g.seg_names[w >> 1]}\t{'-' if w & 1 else '+'}\t{ov}M\n"
            )
        for wk in g.walks:
            walk_str = "".join(
                ("<" if v & 1 else ">") + g.seg_names[v >> 1] for v in wk.v
            )
            fh.write(
                f"W\t{wk.sample}\t{wk.hap}\t{wk.seqname}\t{wk.st}\t{wk.en}"
                f"\t{walk_str}\n"
            )


def _walk_flip(g: Gfa) -> None:
    """Canonicalize walk orientation by majority strand (gfa-io.cpp:64-115)."""
    if not g.walks:
        return
    strand = np.zeros(g.n_seg, np.int8)
    for w in g.walks:
        for v in w.v:
            if strand[v >> 1] == 0:
                strand[v >> 1] = -1 if (v & 1) else 1
    for w in g.walks:
        s = np.where(w.v & 1, -1, 1).astype(np.int8)
        match = int(np.sum(s == strand[w.v >> 1]))
        if match >= len(w.v) - match:
            continue
        w.v = (w.v[::-1] ^ 1).astype(np.uint32)


def _finalize(g: Gfa) -> None:
    """gfa_finalize (gfa-base.cpp:421-430): del empty segs, sort arcs,
    fix semi arcs, add symmetric complements, remove deleted arcs."""
    # fix_no_seg: segments with len 0 are deleted (gfa-base.cpp:201-213)
    for sid in range(g.n_seg):
        if g.seg_lens[sid] == 0:
            g.seg_del[sid] = True

    # arc sort by head vertex, stable (radix by v_lv with lv==0 pre-fix)
    arcs = sorted(range(len(g.arcs)), key=lambda i: g.arcs[i][0])
    arcs = [list(g.arcs[i]) for i in arcs]

    # fix_semi_arc (gfa-base.cpp:235-267): arcs with missing overlap length
    # try to infer from complement; unresolvable → delete. With '*'/CIGAR
    # overlaps this never triggers; implemented for parity with ':'-style.
    by_head: dict[int, list[int]] = {}
    for idx, a in enumerate(arcs):
        by_head.setdefault(a[0], []).append(idx)
    deleted = [False] * len(arcs)
    for idx, a in enumerate(arcs):
        if deleted[idx] or (a[2] != INT32_MAX and a[3] != INT32_MAX):
            continue
        wcomp = a[1] ^ 1
        cands = [
            j
            for j in by_head.get(wcomp, [])
            if not deleted[j] and arcs[j][1] == (a[0] ^ 1)
        ]
        if len(cands) == 1:
            b = arcs[cands[0]]
            is_multi = (
                a[2] != INT32_MAX and b[3] != INT32_MAX and a[2] != b[3]
            ) or (a[3] != INT32_MAX and b[2] != INT32_MAX and a[3] != b[2])
            if not is_multi:
                if b[2] != INT32_MAX:
                    a[3] = b[2]
                if b[3] != INT32_MAX:
                    a[2] = b[3]
                continue
        deleted[idx] = True

    # fix_symm_add (gfa-base.cpp:269-304): sequential complement matching.
    comp = [a[4] for a in arcs]
    new_arcs: list[list[int]] = []
    for idx, a in enumerate(arcs):
        if deleted[idx] or comp[idx]:
            continue
        found = False
        for j in by_head.get(a[1] ^ 1, []):
            if deleted[j] or comp[j]:
                continue
            b = arcs[j]
            if b[1] == (a[0] ^ 1) and b[2] == a[3] and b[3] == a[2]:
                comp[j] = 1
                found = True
                break
        if not found:
            new_arcs.append([a[1] ^ 1, a[0] ^ 1, a[3], a[2], 1])
    arcs.extend(new_arcs)
    comp.extend([1] * len(new_arcs))
    deleted.extend([False] * len(new_arcs))

    # fix_arc_len / cleanup: delete arcs touching deleted segs
    final = []
    for idx, a in enumerate(arcs):
        if deleted[idx]:
            continue
        if g.seg_del[a[0] >> 1] or g.seg_del[a[1] >> 1]:
            continue
        final.append((a[0], a[1], a[2], a[3], comp[idx]))
    final.sort(key=lambda a: (a[0], g.seg_lens[a[0] >> 1] - (a[2] if a[2] != INT32_MAX else 0)))
    g.arcs = final
