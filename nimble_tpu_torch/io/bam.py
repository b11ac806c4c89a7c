"""Native BAM/BGZF codec (no htslib/pysam dependency).

Reading: BGZF blocks are standard gzip members, so Python's zlib/gzip can
decompress a BAM stream directly; records are parsed with struct/numpy.
Writing: proper BGZF blocks (gzip members with the BC/BSIZE extra subfield,
<= 64 KiB) plus the BGZF EOF marker, so outputs are readable by
samtools/pysam/htslib.

This replaces the reference's pysam usage for (a) writing unaligned
CB/UB-tagged BAM from 10x FASTQs (reference: fastq_barcode_processor.py:
186-209, 239-242) and (b) reading BAM input for alignment (reference:
__main__.py:171-180). The reference UMI-sorts BAM input first so its
streaming aligner sees UMI groups adjacently (reference: __main__.py:345-347);
nimble_tpu hash-groups instead, so no sort pass is needed at all.
"""
from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from nimble_tpu_torch import seq as seqmod

BAM_MAGIC = b"BAM\x01"

# 4-bit nibble code -> base character (SAM spec "=ACMGRSVTWYHKDBN")
_NIB_TO_CHAR = b"=ACMGRSVTWYHKDBN"
# base char -> nibble
_CHAR_TO_NIB = {ord("="): 0, ord("A"): 1, ord("C"): 2, ord("M"): 3, ord("G"): 4,
                ord("R"): 5, ord("S"): 6, ord("V"): 7, ord("T"): 8, ord("W"): 9,
                ord("Y"): 10, ord("H"): 11, ord("K"): 12, ord("D"): 13,
                ord("B"): 14, ord("N"): 15}
# 256-entry translate table (upper+lower case; unknown -> N=15)
_NIB_TRANS = bytes(
    _CHAR_TO_NIB.get(c, _CHAR_TO_NIB.get(ord(chr(c).upper()), 15))
    if c < 128 else 15
    for c in range(256)
)
# nibble -> nimble 2-bit code (A=0 C=1 G=2 T=3, else N)
_NIB_TO_CODE = np.full(16, seqmod.N_CODE, dtype=np.int8)
_NIB_TO_CODE[1] = 0
_NIB_TO_CODE[2] = 1
_NIB_TO_CODE[4] = 2
_NIB_TO_CODE[8] = 3

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """Writes BGZF blocks (<= 64 KiB payload each) + EOF marker."""

    MAX_PAYLOAD = 0xFF00

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()
        try:
            from nimble_tpu_torch.io import native as _native

            self._native_compress = (
                _native.bgzf_compress if _native.available() else None
            )
        except Exception:
            self._native_compress = None

    def write(self, data: bytes) -> None:
        self._buf += data
        n_full = (len(self._buf) // self.MAX_PAYLOAD) * self.MAX_PAYLOAD
        if not n_full:
            return
        if self._native_compress is not None:
            # parallel block compress (OpenMP in C++); byte-identical to
            # the serial loop below on the same 0xFF00-byte payloads
            out = self._native_compress(bytes(self._buf[:n_full]))
            if out is not None:
                self._f.write(out)
                del self._buf[:n_full]
                return
        while len(self._buf) >= self.MAX_PAYLOAD:
            self._flush_block(self._buf[: self.MAX_PAYLOAD])
            del self._buf[: self.MAX_PAYLOAD]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(payload)) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12) + extra(6) + comp + crc(4) + isize(4)
        header = (
            b"\x1f\x8b\x08\x04"  # gzip magic, deflate, FEXTRA
            + b"\x00\x00\x00\x00"  # mtime
            + b"\x00\xff"  # XFL, OS
            + struct.pack("<H", 6)  # XLEN
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
        )
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        self._f.write(header + comp + struct.pack("<II", crc, len(payload)))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._f.write(_BGZF_EOF)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class BamRecord:
    name: str
    flag: int
    seq: str
    qual: Optional[bytes]  # phred values (not +33), None if absent
    ref_id: int = -1
    pos: int = -1
    mapq: int = 0
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & 0x40)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & 0x80)


def _encode_tags(tags: Dict[str, object]) -> bytes:
    out = bytearray()
    for key, value in tags.items():
        kb = key.encode()
        if isinstance(value, str):
            out += kb + b"Z" + value.encode() + b"\x00"
        elif isinstance(value, int):
            out += kb + b"i" + struct.pack("<i", value)
        elif isinstance(value, float):
            out += kb + b"f" + struct.pack("<f", value)
        else:
            raise TypeError(f"unsupported tag type for {key}: {type(value)}")
    return bytes(out)


def _encode_record(rec: BamRecord) -> bytes:
    name = rec.name.encode() + b"\x00"
    seq = rec.seq
    seq_bytes = seq if isinstance(seq, bytes) else seq.encode().upper()
    l_seq = len(seq_bytes)
    # nibble packing via one translate + vectorized pair combine (the
    # per-base dict loop was the fastq-to-bam hot spot: 11.8 s/200k pairs)
    nib = np.frombuffer(seq_bytes.translate(_NIB_TRANS), dtype=np.uint8)
    if l_seq & 1:
        nib = np.append(nib, np.uint8(0))
    nibs = ((nib[0::2] << 4) | nib[1::2]).tobytes()
    qual = rec.qual if rec.qual is not None else b"\xff" * l_seq
    # bin computed per spec reg2bin(-1, 0) = 4680 for unmapped
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id,
        rec.pos,
        len(name),
        rec.mapq,
        4680,
        0,  # n_cigar_op
        rec.flag,
        l_seq,
        -1,  # next_refID
        -1,  # next_pos
        0,  # tlen
    )
    payload = body + name + bytes(nibs) + bytes(qual[:l_seq]) + _encode_tags(rec.tags)
    return struct.pack("<i", len(payload)) + payload


class BamWriter:
    """Writes a BAM file (BGZF-compressed) with a SAM header text."""

    def __init__(self, path: str, header_text: str, references: Optional[List[Tuple[str, int]]] = None):
        self._w = BgzfWriter(path)
        refs = references or []
        htext = header_text.encode()
        head = BAM_MAGIC + struct.pack("<i", len(htext)) + htext + struct.pack("<i", len(refs))
        for rname, rlen in refs:
            nb = rname.encode() + b"\x00"
            head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", rlen)
        self._w.write(head)

    def write(self, rec: BamRecord) -> None:
        self._w.write(_encode_record(rec))

    def write_encoded(self, blob: bytes) -> None:
        """Append pre-encoded record bytes (from _encode_record), e.g.
        serialized by worker threads."""
        self._w.write(blob)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _decode_tags(buf: memoryview) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        key = bytes(buf[i : i + 2]).decode()
        typ = chr(buf[i + 2])
        i += 3
        if typ == "Z" or typ == "H":
            j = i
            while j < n and buf[j] != 0:
                j += 1
            tags[key] = bytes(buf[i:j]).decode()
            i = j + 1
        elif typ == "A":
            tags[key] = chr(buf[i]); i += 1
        elif typ in "cC":
            tags[key] = buf[i] if typ == "C" else struct.unpack_from("<b", buf, i)[0]
            i += 1
        elif typ in "sS":
            tags[key] = struct.unpack_from("<h" if typ == "s" else "<H", buf, i)[0]
            i += 2
        elif typ in "iI":
            tags[key] = struct.unpack_from("<i" if typ == "i" else "<I", buf, i)[0]
            i += 4
        elif typ == "f":
            tags[key] = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif typ == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<i", buf, i + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            i += 5 + cnt * size  # array tags skipped (not needed)
        else:
            break
    return tags


class BamReader:
    """Streaming BAM reader; yields BamRecord."""

    def __init__(self, path: str):
        self._f = gzip.open(path, "rb")
        magic = self._f.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._f.read(4))
        self.header_text = self._f.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._f.read(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._f.read(4))
            name = self._f.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._f.read(4))
            self.references.append((name, l_ref))

    def __iter__(self) -> Iterator[BamRecord]:
        read = self._f.read
        while True:
            size_b = read(4)
            if len(size_b) < 4:
                break
            (block_size,) = struct.unpack("<i", size_b)
            buf = memoryview(read(block_size))
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
            off = 32
            name = bytes(buf[off : off + l_read_name - 1]).decode()
            off += l_read_name
            off += 4 * n_cigar
            n_nib = (l_seq + 1) // 2
            nibs = np.frombuffer(buf[off : off + n_nib], dtype=np.uint8)
            off += n_nib
            qual = bytes(buf[off : off + l_seq])
            off += l_seq
            tags = _decode_tags(buf[off:])
            # unpack nibbles -> characters
            chars = np.empty(n_nib * 2, dtype=np.uint8)
            lut = np.frombuffer(_NIB_TO_CHAR, dtype=np.uint8)
            chars[0::2] = lut[nibs >> 4]
            chars[1::2] = lut[nibs & 0xF]
            seq = chars[:l_seq].tobytes().decode()
            if qual and qual[0] == 0xFF:
                qual_out: Optional[bytes] = None
            else:
                qual_out = qual
            yield BamRecord(name, flag, seq, qual_out, ref_id, pos, mapq, tags)

    def close(self):
        self._f.close()


def iter_bam_batches(
    path: str, batch_records: int = 1 << 14, max_len: int = 256
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream a BAM as paired read batches for the alignment engine.

    Consecutive records with the same query name are treated as mates
    (queryname-grouped BAM, as produced by fastq-to-bam; the reference
    achieves adjacency via a samtools UR-tag sort it then deletes —
    reference: __main__.py:312-370 — which nimble_tpu does not need).
    Unpaired records become single-end entries with an empty r2.
    """
    reader = BamReader(path)

    def flush(pairs):
        r1_seqs = [p[0].seq for p in pairs]
        r2_seqs = [(p[1].seq if p[1] is not None else "") for p in pairs]
        r1_codes, r1_lens = seqmod.encode_batch(r1_seqs, max_len)
        r2_codes, r2_lens = seqmod.encode_batch(r2_seqs, max_len)
        batch = {
            "names": [p[0].name for p in pairs],
            "r1_codes": r1_codes,
            "r1_lens": r1_lens,
            "r2_codes": r2_codes,
            "r2_lens": r2_lens,
            "cbs": [str(p[0].tags.get("CB", "")) for p in pairs],
            "umis": [str(p[0].tags.get("UB", "")) for p in pairs],
            "poss": [
                (p[0].pos, p[1].pos if p[1] is not None else -1) for p in pairs
            ],
            "gns": [str(p[0].tags.get("GN", "")) for p in pairs],
        }
        return batch

    pairs: List[Tuple[BamRecord, Optional[BamRecord]]] = []
    prev: Optional[BamRecord] = None
    for rec in reader:
        if rec.flag & 0x100 or rec.flag & 0x800:
            continue  # skip secondary/supplementary
        if prev is not None and rec.name == prev.name:
            r1, r2 = (prev, rec) if not prev.is_read2 else (rec, prev)
            pairs.append((r1, r2))
            prev = None
        else:
            if prev is not None:
                pairs.append((prev, None))
            prev = rec
        if len(pairs) >= batch_records:
            yield flush(pairs)
            pairs = []
    if prev is not None:
        pairs.append((prev, None))
    if pairs:
        yield flush(pairs)
    reader.close()
