"""A BGZF writer and the tagged BAM of 10x pairs that cellranger-style
pipelines hand to `align`: unaligned records in query-name order, R1's
cDNA (flag 77) then R2 (flag 141), each with the CB and UB tags.

BGZF (SAM spec section 4.1): gzip members of at most 64 KiB of payload,
each with the `BC` extra subfield giving its compressed size, then the
empty EOF member. Records have fixed widths here (names of one width, one
read length a mate), so each mate's records are built as one byte matrix.
"""
from __future__ import annotations

import os
import pathlib
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_PAYLOAD = 0xFF00
# 2-bit code -> BAM nibble (A=1 C=2 G=4 T=8)
NIBBLE = np.array([1, 2, 4, 8], dtype=np.uint8)
UNMAPPED_BIN = 4680  # reg2bin(-1, 0)


def bgzf_block(payload: bytes) -> bytes:
    """One BGZF member holding `payload` (at most MAX_PAYLOAD bytes)."""
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<H", 6)
              + b"BC" + struct.pack("<HH", 2, len(comp) + 25))
    return header + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))


def write_bgzf(path, data: bytes, threads: int = 4) -> None:
    """`data` as BGZF blocks plus the EOF block, compressed on `threads`
    threads, written under a temporary name and moved into place."""
    parts = [data[s:s + MAX_PAYLOAD] for s in range(0, len(data), MAX_PAYLOAD)]
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".part")
    with ThreadPoolExecutor(threads) as ex, open(tmp, "wb") as f:
        for blob in ex.map(bgzf_block, parts, chunksize=64):
            f.write(blob)
        f.write(EOF_BLOCK)
    os.replace(tmp, path)


def _mate_records(names: np.ndarray, flag: int, codes: np.ndarray, tags: np.ndarray) -> np.ndarray:
    """(n, record bytes) uint8: each row one BAM record (block_size first),
    unmapped, with quality 40 at every base."""
    n, L = codes.shape
    name_len = names.shape[1] + 1
    fixed = struct.pack("<iiBBHHHiiii", -1, -1, name_len, 0, UNMAPPED_BIN, 0, flag, L, -1, -1, 0)
    nib = NIBBLE[codes]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    seq = (nib[:, 0::2] << 4) | nib[:, 1::2]
    body_len = len(fixed) + name_len + seq.shape[1] + L + tags.shape[1]
    cols = [np.frombuffer(struct.pack("<i", body_len) + fixed, np.uint8)[None, :].repeat(n, 0),
            names, np.zeros((n, 1), np.uint8), seq, np.full((n, L), 40, np.uint8), tags]
    return np.concatenate(cols, axis=1)


def tagged_pairs_bam(path, cb: np.ndarray, umi: np.ndarray, r1: np.ndarray, r2: np.ndarray,
                     threads: int = 4) -> None:
    """A queryname-ordered BAM of n pairs: cb (n, cb_len) and umi (n,
    umi_len) uint8 ASCII, r1 (n, L1) and r2 (n, L2) int8 base codes."""
    n = r1.shape[0]
    width = len(str(max(n - 1, 0)))
    names = np.frombuffer(b"".join(b"p%0*d" % (width, i) for i in range(n)), np.uint8).reshape(n, -1)
    z = np.zeros((n, 1), np.uint8)
    tags = np.concatenate([np.frombuffer(b"CBZ", np.uint8)[None, :].repeat(n, 0), cb, z,
                           np.frombuffer(b"UBZ", np.uint8)[None, :].repeat(n, 0), umi, z], axis=1)
    rec = np.concatenate([_mate_records(names, 77, r1, tags), _mate_records(names, 141, r2, tags)], axis=1)
    text = b"@HD\tVN:1.6\tSO:queryname\n"
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 0)
    write_bgzf(path, head + rec.tobytes(), threads)

