"""FASTA writer, 80 columns per line.

Output format parity with the reference writers:
  haploid: ``>dp_sol LN:<len>``   (approximator.cpp:1271-1277)
  diploid: ``>sol_1 bp:<len>`` / ``>sol_2 bp:<len>`` (approximator.cpp:1311-1325)
"""

from __future__ import annotations


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 80) -> None:
    """records: list of (header_without_gt, sequence)."""
    with open(path, "w") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
