"""Minimal FASTA reader/writer (plain or gzip), no external deps.

Replaces the reference's Bio.SeqIO usage (reference: nimble/parse.py:22).
"""
from __future__ import annotations

import gzip
from typing import Iterator, List, Tuple


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (record_id, sequence) pairs. record_id is the first whitespace-
    delimited token of the header, matching Biopython's record.id."""
    header = None
    chunks: List[str] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line[0] == ">":
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)


def read_fasta(path: str) -> List[Tuple[str, str]]:
    return list(iter_fasta(path))


def write_fasta(path: str, records: List[Tuple[str, str]], width: int = 80) -> None:
    with _open(path, "wt") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")
