"""FASTQ reading: streaming single/paired readers producing fixed-shape
numpy batches for the device pipeline.

Replaces the reference's Bio.SeqIO FASTQ path (reference:
nimble/fastq_barcode_processor.py:251-257) with a batch-oriented reader: the
TPU engine consumes (codes, lengths) arrays, not per-record objects.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from nimble_tpu_torch import seq as seqmod


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclass
class FastqChunk:
    """A chunk of FASTQ records as parallel python lists (host staging)."""

    names: List[bytes]
    seqs: List[bytes]
    quals: List[bytes]

    def __len__(self) -> int:
        return len(self.names)


def iter_fastq_chunks(path: str, chunk_records: int = 1 << 16) -> Iterator[FastqChunk]:
    """Stream a FASTQ(.gz) file in chunks of records."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            sline = f.readline().rstrip()
            f.readline()  # '+' separator
            qline = f.readline().rstrip()
            # record id = first whitespace token after '@'
            name = header[1:].split(None, 1)[0] if len(header) > 1 else b""
            names.append(name)
            seqs.append(sline)
            quals.append(qline)
            if len(names) >= chunk_records:
                yield FastqChunk(names, seqs, quals)
                names, seqs, quals = [], [], []
    if names:
        yield FastqChunk(names, seqs, quals)


def read_fastq(path: str) -> FastqChunk:
    out = FastqChunk([], [], [])
    for chunk in iter_fastq_chunks(path):
        out.names.extend(chunk.names)
        out.seqs.extend(chunk.seqs)
        out.quals.extend(chunk.quals)
    return out


def write_fastq(path: str, records: List[Tuple[str, str, str]]) -> None:
    """records: (name, sequence, quality-string)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for name, s, q in records:
            f.write(f"@{name}\n{s}\n+\n{q}\n")


class FastqReader:
    """Streaming batcher over one or two (paired) FASTQ files.

    Yields dicts of numpy arrays with static shapes (batch, max_len):
      r1_codes, r1_lens, [r2_codes, r2_lens], names (object array of bytes).
    """

    def __init__(
        self,
        r1_path: str,
        r2_path: Optional[str] = None,
        batch_size: int = 8192,
        max_len: int = 256,
    ):
        self.r1_path = r1_path
        self.r2_path = r2_path
        self.batch_size = batch_size
        self.max_len = max_len

    def __iter__(self):
        it1 = iter_fastq_chunks(self.r1_path, self.batch_size)
        it2 = iter_fastq_chunks(self.r2_path, self.batch_size) if self.r2_path else None
        while True:
            c1 = next(it1, None)
            if c1 is None:
                break
            batch = {"names": c1.names}
            codes, lens = seqmod.encode_batch(c1.seqs, self.max_len)
            batch["r1_codes"], batch["r1_lens"] = codes, lens
            batch["r1_quals"] = c1.quals
            if it2 is not None:
                c2 = next(it2, None)
                if c2 is None or len(c2) != len(c1):
                    raise ValueError("paired FASTQ files have different record counts")
                codes2, lens2 = seqmod.encode_batch(c2.seqs, self.max_len)
                batch["r2_codes"], batch["r2_lens"] = codes2, lens2
                batch["r2_quals"] = c2.quals
            yield batch
