"""ctypes bindings for the C++ native IO layer (native/nimble_native.cpp).

Loads (building on first use if the toolchain is present) libnimble_native.so
and exposes a native FASTQ batch reader with the same batch-dict interface as
the pure-Python nimble_tpu_torch.io.fastq.FastqReader. Falls back gracefully:
`available()` gates every caller.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_LIB = None
_LIB_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libnimble_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.nt_fastq_open.restype = ctypes.c_void_p
    lib.nt_fastq_open.argtypes = [ctypes.c_char_p]
    lib.nt_fastq_close.argtypes = [ctypes.c_void_p]
    lib.nt_fastq_read_batch.restype = ctypes.c_int64
    lib.nt_fastq_read_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.nt_format_rows.restype = ctypes.c_int64
    lib.nt_format_rows.argtypes = [
        ctypes.c_int64,   # n_rows
        ctypes.c_void_p,  # uniq_id
        ctypes.c_void_p,  # keep
        ctypes.c_char_p,  # feat_bytes
        ctypes.c_void_p,  # feat_offs
        ctypes.c_void_p,  # score
        ctypes.c_void_p,  # f1
        ctypes.c_void_p,  # f2
        ctypes.c_void_p,  # cb
        ctypes.c_int32,   # cb_w
        ctypes.c_void_p,  # umi
        ctypes.c_int32,   # umi_w
        ctypes.c_void_p,  # gn
        ctypes.c_int32,   # gn_w
        ctypes.c_void_p,  # pos1
        ctypes.c_void_p,  # pos2
        ctypes.c_void_p,  # out
        ctypes.c_int64,   # out_cap
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _fixed_bytes(col) -> tuple:
    """Optional string column -> (contiguous S-dtype array or None, width)."""
    if col is None:
        return None, 0
    arr = np.asarray(col, dtype="S")
    if arr.size == 0:
        return None, 0
    w = arr.dtype.itemsize
    return np.ascontiguousarray(arr), w


def resolve_classes(
    bounds: np.ndarray,
    cols: np.ndarray,
    lexrank: np.ndarray,
    names_bytes: bytes,
    name_offs: np.ndarray,
    discard_multiple: bool,
    discard_multi_hits: int,
    max_hits: int,
):
    """nt_resolve_classes wrapper: CSR membership -> (keep mask, feature
    string pool bytes, offsets). names_bytes/name_offs are in LEX order;
    lexrank maps feature id -> lex position."""
    lib = _load()
    assert lib is not None
    if not hasattr(lib, "_resolve_bound"):
        lib.nt_resolve_classes.restype = ctypes.c_int64
        lib.nt_resolve_classes.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib._resolve_bound = True
    n_u = bounds.shape[0] - 1
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    lexrank = np.ascontiguousarray(lexrank, dtype=np.int32)
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    keep = np.empty(n_u, dtype=np.uint8)
    out_offs = np.empty(n_u + 1, dtype=np.int64)
    # exact bound: every (row, col) pair contributes its name + 1 comma
    name_lens = name_offs[1:] - name_offs[:-1]
    cap = int(name_lens[lexrank[cols]].sum()) + cols.size + 64
    out = np.empty(cap, dtype=np.uint8)
    wrote = lib.nt_resolve_classes(
        n_u,
        bounds.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        lexrank.ctypes.data_as(ctypes.c_void_p),
        names_bytes,
        name_offs.ctypes.data_as(ctypes.c_void_p),
        1 if discard_multiple else 0,
        int(discard_multi_hits),
        int(max_hits),
        keep.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
        out_offs.ctypes.data_as(ctypes.c_void_p),
    )
    if wrote < 0:
        raise RuntimeError("nt_resolve_classes capacity overflow")
    return keep.astype(bool), out[:wrote].tobytes(), out_offs


def format_rows(
    uniq_id: np.ndarray,
    keep: np.ndarray,
    feat_strings,
    score: np.ndarray,
    f1: np.ndarray,
    f2: np.ndarray,
    cbs=None,
    umis=None,
    gns=None,
    pos1=None,
    pos2=None,
) -> bytes:
    """Format passing rows as alignment-results TSV via nt_format_rows.

    uniq_id indexes feat_strings (one string per deduplicated ambiguity
    class); keep masks rows; cbs/umis/gns are optional per-row string
    sequences, pos1/pos2 optional per-row ints. Returns the encoded rows.
    """
    lib = _load()
    assert lib is not None
    n = len(uniq_id)
    uniq_id = np.ascontiguousarray(uniq_id, dtype=np.int32)
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    if isinstance(feat_strings, tuple):
        # pre-pooled (bytes, offsets) straight from resolve_classes
        feat_bytes, feat_offs = feat_strings
        feat_offs = np.ascontiguousarray(feat_offs, dtype=np.int64)
    else:
        pool = [s.encode() for s in feat_strings]
        feat_bytes = b"".join(pool)
        feat_offs = np.zeros(len(pool) + 1, dtype=np.int64)
        if pool:
            np.cumsum([len(b) for b in pool], out=feat_offs[1:])
    score = np.ascontiguousarray(score, dtype=np.int32)
    f1 = np.ascontiguousarray(f1, dtype=np.int32)
    f2 = np.ascontiguousarray(f2, dtype=np.int32)
    cb_arr, cb_w = _fixed_bytes(cbs)
    umi_arr, umi_w = _fixed_bytes(umis)
    gn_arr, gn_w = _fixed_bytes(gns)
    p1 = np.ascontiguousarray(pos1, dtype=np.int32) if pos1 is not None else None
    p2 = np.ascontiguousarray(pos2, dtype=np.int32) if pos2 is not None else None

    # exact-ish capacity bound: per-row feature length + fixed worst case
    flens = (feat_offs[1:] - feat_offs[:-1])[uniq_id]
    kept = keep_u8.astype(bool)
    cap = int(flens[kept].sum()) + int(kept.sum()) * (
        2 * (cb_w + umi_w) + gn_w + 5 * 20 + 12
    ) + 64
    out = np.empty(cap, dtype=np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    wrote = lib.nt_format_rows(
        n,
        ptr(uniq_id),
        ptr(keep_u8),
        feat_bytes,
        ptr(feat_offs),
        ptr(score),
        ptr(f1),
        ptr(f2),
        ptr(cb_arr),
        cb_w,
        ptr(umi_arr),
        umi_w,
        ptr(gn_arr),
        gn_w,
        ptr(p1),
        ptr(p2),
        ptr(out),
        cap,
    )
    if wrote < 0:
        raise RuntimeError("nt_format_rows capacity bound violated")
    return out[:wrote].tobytes()


class NativeFastqFile:
    """Streaming native FASTQ reader producing (codes, lens, raw, offs)."""

    def __init__(self, path: str, batch_records: int, max_len: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.nt_fastq_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(path)
        self.batch_records = batch_records
        self.max_len = max_len
        self._raw_cap = batch_records * 1024 + (1 << 21)

    def read_batch(self):
        n = self.batch_records
        codes = np.empty((n, self.max_len), dtype=np.int8)
        lens = np.empty(n, dtype=np.int32)
        raw = np.empty(self._raw_cap, dtype=np.uint8)
        offs = np.empty(n * 3, dtype=np.int64)
        got = self._lib.nt_fastq_read_batch(
            self._handle,
            n,
            self.max_len,
            codes.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            raw.ctypes.data_as(ctypes.c_void_p),
            self._raw_cap,
            offs.ctypes.data_as(ctypes.c_void_p),
        )
        if got < 0:
            raise RuntimeError("FASTQ record exceeds 1 MiB native buffer guard")
        if got == 0:
            return None
        return codes[:got], lens[:got], raw, offs[: got * 3]

    def close(self):
        if self._handle:
            self._lib.nt_fastq_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _extract_strings(raw: np.ndarray, offs: np.ndarray, field: int, n: int):
    """Extract NUL-terminated byte strings at offs[i*3+field]: one NUL
    scan + vectorized end lookup for the whole batch (a per-record
    bytes.index loop was ~1 s per 200k records)."""
    if n == 0:
        return []
    o = offs[: 3 * n]
    used = min(raw.size, int(o.max()) + 65536)
    nul = np.flatnonzero(raw[:used] == 0)
    idx = np.searchsorted(nul, o[field::3][:n])
    if idx.size and (nul.size == 0 or int(idx.max()) >= nul.size):
        # a tail string longer than the scan margin: rescan everything
        used = raw.size
        nul = np.flatnonzero(raw == 0)
        idx = np.searchsorted(nul, o[field::3][:n])
    buf = raw[:used].tobytes()
    starts = o[field::3][:n]
    ends = nul[idx]
    return [buf[s:e] for s, e in zip(starts.tolist(), ends.tolist())]


class NativeFastqReader:
    """Drop-in replacement for io.fastq.FastqReader backed by C++.

    Yields the same batch dict: r1_codes/r1_lens (+ r2_*) numpy arrays and
    lazily-decoded names/quals.
    """

    def __init__(
        self,
        r1_path: str,
        r2_path: Optional[str] = None,
        batch_size: int = 8192,
        max_len: int = 256,
        with_strings: bool = False,
    ):
        self.r1_path = r1_path
        self.r2_path = r2_path
        self.batch_size = batch_size
        self.max_len = max_len
        self.with_strings = with_strings

    def __iter__(self) -> Iterator[dict]:
        f1 = NativeFastqFile(self.r1_path, self.batch_size, self.max_len)
        f2 = (
            NativeFastqFile(self.r2_path, self.batch_size, self.max_len)
            if self.r2_path
            else None
        )
        try:
            while True:
                b1 = f1.read_batch()
                if b1 is None:
                    break
                codes, lens, raw, offs = b1
                n = codes.shape[0]
                batch = {"r1_codes": codes, "r1_lens": lens}
                if self.with_strings:
                    batch["names"] = _extract_strings(raw, offs, 0, n)
                    batch["r1_seqs"] = _extract_strings(raw, offs, 1, n)
                    batch["r1_quals"] = _extract_strings(raw, offs, 2, n)
                if f2 is not None:
                    b2 = f2.read_batch()
                    if b2 is None or b2[0].shape[0] != n:
                        raise ValueError(
                            "paired FASTQ files have different record counts"
                        )
                    codes2, lens2, raw2, offs2 = b2
                    batch["r2_codes"] = codes2
                    batch["r2_lens"] = lens2
                    if self.with_strings:
                        batch["r2_names"] = _extract_strings(raw2, offs2, 0, n)
                        batch["r2_seqs"] = _extract_strings(raw2, offs2, 1, n)
                        batch["r2_quals"] = _extract_strings(raw2, offs2, 2, n)
                yield batch
        finally:
            f1.close()
            if f2 is not None:
                f2.close()


def _pool(items) -> tuple:
    """List of bytes -> (concatenated pool, (n+1) int64 offsets)."""
    offs = np.zeros(len(items) + 1, dtype=np.int64)
    if items:
        np.cumsum([len(b) for b in items], out=offs[1:])
    return b"".join(items), offs


def encode_bam_pairs(names, s1, q1, s2, q2, cbs, umis) -> Optional[bytes]:
    """Encode read-pairs as BAM record blobs in C++ (nt_encode_bam_pairs):
    R1 flag 77 + R2 flag 141, CB/UB tags, byte-identical to
    io.bam._encode_record. Args are equal-length lists of bytes (quals as
    phred+33 ASCII — shifted natively). Returns None when the native
    library is unavailable (caller falls back to the python encoder)."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_nt_encode_pairs_bound"):
        lib.nt_encode_bam_pairs.restype = ctypes.c_int64
        lib.nt_encode_bam_pairs.argtypes = [
            ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._nt_encode_pairs_bound = True
    n = len(names)
    pools = [_pool(x) for x in (names, s1, q1, s2, q2, cbs, umis)]
    # exact output size: per record 4 + 32 + (name+1) + ceil(l/2) + l + tags
    ln = pools[0][1][1:] - pools[0][1][:-1]
    l1 = pools[1][1][1:] - pools[1][1][:-1]
    l2 = pools[3][1][1:] - pools[3][1][:-1]
    lc = pools[5][1][1:] - pools[5][1][:-1]
    lu = pools[6][1][1:] - pools[6][1][:-1]
    tags = 8 + lc + lu
    per_pair = (
        2 * (36 + 1) + 2 * ln + (l1 + 1) // 2 + l1 + (l2 + 1) // 2 + l2
        + 2 * tags
    )
    cap = int(per_pair.sum()) + 64
    out = np.empty(cap, dtype=np.uint8)
    args = [ctypes.c_int64(n)]
    for pool, offs in pools:
        args += [pool, offs.ctypes.data_as(ctypes.c_void_p)]
    wrote = lib.nt_encode_bam_pairs(
        *args, out.ctypes.data_as(ctypes.c_void_p), cap
    )
    if wrote == -2:
        raise ValueError(
            "read name longer than 254 characters cannot be encoded in a "
            "BAM record (l_read_name is a u8)"
        )
    if wrote < 0:
        raise RuntimeError("nt_encode_bam_pairs capacity overflow")
    return out[:wrote].tobytes()


def bgzf_compress(data: bytes) -> Optional[bytes]:
    """Compress a byte string into BGZF members of 0xFF00-byte payloads in
    C++ (nt_bgzf_compress, OpenMP over blocks) — byte-identical to the
    python BgzfWriter flushing the same payloads serially (same zlib,
    level 6 raw deflate). Returns None when the native library is
    unavailable; the caller falls back to the serial python path."""
    lib = _load()
    if lib is None or not data:
        return None
    if not hasattr(lib, "_nt_bgzf_bound"):
        lib.nt_bgzf_compress.restype = ctypes.c_int64
        lib.nt_bgzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64
        ]
        lib._nt_bgzf_bound = True
    n = len(data)
    nb = (n + 0xFF00 - 1) // 0xFF00
    cap = n + nb * 256 + 64  # header/trailer + worst-case deflate growth
    out = np.empty(cap, dtype=np.uint8)
    wrote = lib.nt_bgzf_compress(
        data, n, out.ctypes.data_as(ctypes.c_void_p), cap
    )
    if wrote < 0:
        raise RuntimeError("nt_bgzf_compress failed")
    return out[:wrote].tobytes()


def _bind_bam(lib):
    if hasattr(lib, "_bam_bound"):
        return
    lib.nt_bam_open.restype = ctypes.c_void_p
    lib.nt_bam_open.argtypes = [ctypes.c_char_p]
    lib.nt_bam_close.argtypes = [ctypes.c_void_p]
    lib.nt_bam_read_batch.restype = ctypes.c_int64
    lib.nt_bam_read_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib._bam_bound = True


class NativeBamFile:
    """Streaming native BAM reader: primary records as code batches with
    flag/pos and name/CB/UB/GN strings."""

    def __init__(self, path: str, batch_records: int, max_len: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        _bind_bam(lib)
        self._lib = lib
        self._handle = lib.nt_bam_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(f"{path}: not found or not a BAM")
        self.batch_records = batch_records
        self.max_len = max_len
        self._raw_cap = batch_records * 512 + (1 << 21)

    def read_batch(self):
        n = self.batch_records
        codes = np.empty((n, self.max_len), dtype=np.int8)
        lens = np.empty(n, dtype=np.int32)
        flags = np.empty(n, dtype=np.int32)
        poss = np.empty(n, dtype=np.int32)
        raw = np.empty(self._raw_cap, dtype=np.uint8)
        offs = np.empty(n * 4, dtype=np.int64)
        got = self._lib.nt_bam_read_batch(
            self._handle,
            n,
            self.max_len,
            codes.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            flags.ctypes.data_as(ctypes.c_void_p),
            poss.ctypes.data_as(ctypes.c_void_p),
            raw.ctypes.data_as(ctypes.c_void_p),
            self._raw_cap,
            offs.ctypes.data_as(ctypes.c_void_p),
        )
        if got < 0:
            raise RuntimeError("malformed BAM record or raw buffer overflow")
        if got == 0:
            return None
        # vectorized string extraction: one NUL scan + one decode for the
        # whole batch, then str slicing (a per-record bytes.index/.decode
        # loop measured 16.5 s/M pairs — the paired-e2e bottleneck)
        o = offs[: 4 * got]
        used = min(raw.size, int(o.max()) + 65536)
        nul = np.flatnonzero(raw[:used] == 0)
        if nul.size == 0 or int(nul[-1]) < int(o.max()):
            # a tail string longer than the scan margin: rescan everything
            used = raw.size
            nul = np.flatnonzero(raw == 0)
        text = raw[:used].tobytes().decode("latin-1")

        def strs(field):
            starts = o[field::4]
            ends = nul[np.searchsorted(nul, starts)]
            return [
                text[s:e]
                for s, e in zip(starts.tolist(), ends.tolist())
            ]

        return {
            "codes": codes[:got],
            "lens": lens[:got],
            "flags": flags[:got],
            "poss": poss[:got],
            "names": strs(0),
            "cbs": strs(1),
            "umis": strs(2),
            "gns": strs(3),
        }

    def close(self):
        if self._handle:
            self._lib.nt_bam_close(self._handle)
            self._handle = None


def iter_native_bam_batches(path: str, batch_records: int = 1 << 14, max_len: int = 256):
    """Paired batch iterator over a BAM via the native reader, yielding the
    same dict shape as nimble_tpu_torch.io.bam.iter_bam_batches (consecutive
    same-name records pair up; unpaired records get an empty r2)."""
    from nimble_tpu_torch import seq as seqmod

    f = NativeBamFile(path, batch_records, max_len)
    pend = None  # one carried record: dict of row-level values
    try:
        while True:
            b = f.read_batch()
            if b is None:
                break
            if pend is not None:
                for k in ("codes", "lens", "flags", "poss"):
                    b[k] = np.concatenate([pend[k][None], b[k]])
                for k in ("names", "cbs", "umis", "gns"):
                    b[k] = [pend[k]] + b[k]
                pend = None
            # pairing pass builds row-index lists only (i2 = -1 when the
            # mate is absent); everything else is numpy gathers — the
            # previous per-record tuple materialization cost ~5.5 s per
            # million pairs
            names = b["names"]
            flags = b["flags"].tolist()
            n = len(names)
            i1 = []
            i2 = []
            j = 0
            while j < n:
                if j + 1 < n and names[j] == names[j + 1]:
                    if flags[j] & 0x80:  # j is read2
                        i1.append(j + 1)
                        i2.append(j)
                    else:
                        i1.append(j)
                        i2.append(j + 1)
                    j += 2
                elif j + 1 == n:
                    pend = {
                        k: b[k][j]
                        for k in ("codes", "lens", "flags", "poss",
                                  "names", "cbs", "umis", "gns")
                    }
                    j += 1
                else:
                    i1.append(j)
                    i2.append(-1)
                    j += 1
            if i1:
                yield _indexed_batch(b, i1, i2, max_len)
        if pend is not None:
            b1 = {
                "codes": pend["codes"][None],
                "lens": np.asarray([pend["lens"]], dtype=np.int32),
                "flags": np.asarray([pend["flags"]], dtype=np.int32),
                "poss": np.asarray([pend["poss"]], dtype=np.int32),
                "names": [pend["names"]],
                "cbs": [pend["cbs"]],
                "umis": [pend["umis"]],
                "gns": [pend["gns"]],
            }
            yield _indexed_batch(b1, [0], [-1], max_len)
    finally:
        f.close()


def _indexed_batch(b, i1, i2, max_len):
    """Assemble a paired batch dict from pairing index lists by gathers."""
    from nimble_tpu_torch import seq as seqmod

    a1 = np.asarray(i1, dtype=np.int64)
    a2 = np.asarray(i2, dtype=np.int64)
    has2 = a2 >= 0
    codes = b["codes"]
    lens = np.asarray(b["lens"], dtype=np.int32)
    poss = np.asarray(b["poss"], dtype=np.int32)
    r2_codes = np.full((a1.size, max_len), seqmod.N_CODE, dtype=np.int8)
    r2_lens = np.zeros(a1.size, dtype=np.int32)
    if has2.any():
        sel = a2[has2]
        r2_codes[has2] = codes[sel]
        r2_lens[has2] = lens[sel]
    p1 = poss[a1]
    p2 = np.where(has2, poss[np.maximum(a2, 0)], -1)
    names = b["names"]
    cbs = b["cbs"]
    umis = b["umis"]
    gns = b["gns"]
    return {
        "names": [names[i] for i in i1],
        "r1_codes": codes[a1],
        "r1_lens": lens[a1],
        "r2_codes": r2_codes,
        "r2_lens": r2_lens,
        "cbs": [cbs[i] for i in i1],
        "umis": [umis[i] for i in i1],
        "poss": list(zip(p1.tolist(), p2.tolist())),
        "gns": [gns[i] for i in i1],
    }
