"""Streaming FASTA/FASTQ reader over plain or gzipped files.

Equivalent of the reference's kseq-based ``read_ip_reads``
(reference: src/solver.cpp:230-245, src/kseq.h): yields
``(name, sequence)`` pairs, where ``name`` is the first
whitespace-delimited token of the header and multi-line FASTA
sequences are concatenated. FASTQ quality lines are skipped.
"""

from __future__ import annotations

import gzip
import io as _io


def _open_maybe_gz(fn: str):
    f = open(fn, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rt")
    f.seek(0)
    return _io.TextIOWrapper(f)


def read_fastx(fn: str) -> list[tuple[str, str]]:
    """Read all records of a FASTA/FASTQ(.gz) file as (name, seq).

    Uses the native (C++/zlib) reader when available; the Python path
    below is the reference fallback with identical output."""
    try:
        from .. import native

        if native.available():
            return native.read_fastx(fn)
    except Exception:  # noqa: BLE001
        pass
    out: list[tuple[str, str]] = []
    with _open_maybe_gz(fn) as fh:
        it = iter(fh)
        pending: str | None = None
        while True:
            line = pending
            pending = None
            if line is None:
                line = next(it, None)
            if line is None:
                break
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):  # FASTQ record
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq_parts: list[str] = []
                # sequence lines until '+'
                while True:
                    l2 = next(it, None)
                    if l2 is None:
                        break
                    l2 = l2.rstrip("\n")
                    if l2.startswith("+"):
                        # quality: same length as sequence
                        qlen = sum(len(s) for s in seq_parts)
                        got = 0
                        while got < qlen:
                            l3 = next(it, None)
                            if l3 is None:
                                break
                            got += len(l3.rstrip("\n"))
                        break
                    seq_parts.append(l2)
                out.append((name, "".join(seq_parts)))
            elif line.startswith(">"):  # FASTA record
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq_parts = []
                while True:
                    l2 = next(it, None)
                    if l2 is None:
                        break
                    l2 = l2.rstrip("\n")
                    if l2.startswith(">") or l2.startswith("@"):
                        pending = l2
                        break
                    seq_parts.append(l2)
                out.append((name, "".join(seq_parts)))
    return out
