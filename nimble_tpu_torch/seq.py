"""Sequence encoding utilities (host side, numpy-vectorized).

Encoding: A=0, C=1, G=2, T/U=3, anything else (N, IUPAC ambiguity) = 4.
Code 4 invalidates any k-mer window containing it. The device pipeline
consumes int8 code arrays produced here.
"""
from __future__ import annotations

import numpy as np

N_CODE = 4  # sentinel for non-ACGT bases / padding

# 256-entry LUT from ASCII byte -> base code.
_LUT = np.full(256, N_CODE, dtype=np.int8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _LUT[ord(_ch)] = _code
    _LUT[ord(_ch.lower())] = _code

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Complement in code space: A<->T, C<->G, N->N.
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode one sequence string -> int8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis in code space."""
    return _COMP[codes][..., ::-1]


def revcomp(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


def encode_batch(seqs: list[str | bytes], max_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of sequences into a fixed-shape (n, max_len) int8 array.

    Sequences longer than max_len are truncated; shorter ones padded with
    N_CODE. Returns (codes, lengths) where lengths are the (clipped) original
    lengths.
    """
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=n)
    if max_len is None:
        max_len = int(lens.max()) if n else 0
    lens = np.minimum(lens, max_len)
    out = np.full((n, max_len), N_CODE, dtype=np.int8)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode("ascii", errors="replace")
        m = min(len(s), max_len)
        out[i, :m] = _LUT[np.frombuffer(s[:m], dtype=np.uint8)]
    return out, lens


def kmer_codes_u64(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer codes of a 1-D code array as uint64, plus a validity mask.

    code(kmer) = sum_j base[p+j] << 2*(k-1-j)  (first base in the high bits).
    A window is valid iff it contains no N_CODE. Requires k <= 31.
    """
    assert 1 <= k <= 31, k
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    npos = n - k + 1
    c = codes.astype(np.uint64)
    out = np.zeros(npos, dtype=np.uint64)
    for j in range(k):
        out |= (c[j : j + npos] & np.uint64(3)) << np.uint64(2 * (k - 1 - j))
    bad = codes == N_CODE
    # window invalid iff any bad base inside it
    bad_cum = np.concatenate(([0], np.cumsum(bad.astype(np.int64))))
    valid = (bad_cum[k:] - bad_cum[:-k]) == 0
    return out, valid


def revcomp_kmer_u64(code: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed k-mer codes (vectorized uint64)."""
    x = ~code  # complement each 2-bit base (A<->T, C<->G under this encoding)
    # reverse the 2-bit groups within the low 2k bits
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    )
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | (
        (x >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)
    )
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | (
        (x >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)
    )
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)
