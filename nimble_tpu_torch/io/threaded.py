"""Threaded FASTQ ingestion: decompress -> record-boundary cut -> parallel
native parse -> bounded prefetch queue.

This is what `align -c/--num_cores` drives (the reference threads its whole
hot path with `-c`, reference nimble/__main__.py:180; here the device does
the alignment, so host decode is the part that must scale). Layout:

  producer thread:  read/zlib-inflate byte chunks, cut at FASTQ record
  (`nimble-read`)   boundaries (every 4th newline), keep R1/R2 in lockstep;
                    each chunk's draw a `pipeline.read` span
  parse pool:       num_threads workers call nt_fastq_parse_buffer (ctypes
  (`nimble-parse`)  releases the GIL; the parse+2-bit-encode loop runs truly
                    parallel across cores); each parse a `pipeline.parse`
                    span
  consumer:         __iter__ drains a bounded queue of parsed futures and
                    yields the same batch dicts as io.fastq.FastqReader

Byte-stream identical output to the sequential readers at any thread count:
record boundaries are derived from newline counts alone, so the batch
partition is deterministic.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from nimble_tpu_torch import observability as obs
from nimble_tpu_torch.io import native as _native

_CHUNK_BYTES = 8 << 20

# libdeflate whole-member inflate runs ~2.4x faster than streaming zlib
# (measured 888 vs 365 MB/s on this host; docs/PERF.md round-3), but needs
# the whole member's output resident. Files whose COMPRESSED size exceeds
# this cap fall back to streaming zlib.
_LIBDEFLATE_MAX_MB = int(
    os.environ.get("NIMBLE_TPU_LIBDEFLATE_MAX_MB", "2048")
)

# Plain (uncompressed) files under this cap are np.memmap'd whole — the OS
# pages them in on demand, so address space (not RAM) is the cost — and
# cut into contiguous zero-copy record views. Larger files stream in 8 MiB
# chunks. Distinct knob from the libdeflate cap above: that one bounds a
# RAM-resident inflate output, this one only bounds a mapping.
_PLAIN_MMAP_MAX_MB = int(
    os.environ.get("NIMBLE_TPU_PLAIN_MMAP_MAX_MB", "65536")
)

_LD = None
_LD_TRIED = False


def _libdeflate():
    """ctypes handle to libdeflate with gzip_decompress_ex bound, or None."""
    global _LD, _LD_TRIED
    if _LD_TRIED:
        return _LD
    _LD_TRIED = True
    for name in ("libdeflate.so.0", "libdeflate.so", "libdeflate.dylib"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            lib = None
    if lib is None:
        return None
    try:
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
        lib.libdeflate_gzip_decompress_ex.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return None
    _LD = lib
    return _LD


def _inflate_whole(path: str) -> Optional[np.ndarray]:
    """Whole-file gzip inflate via libdeflate (multi-member aware).

    Returns a uint8 array of the decompressed bytes, or None when
    libdeflate is unavailable / the file exceeds the size cap / the stream
    is malformed (callers then use streaming zlib, which reports errors
    properly)."""
    lib = _libdeflate()
    if lib is None:
        return None
    try:
        comp = np.fromfile(path, dtype=np.uint8)
    except OSError:
        return None
    if comp.size == 0 or comp.size > _LIBDEFLATE_MAX_MB << 20:
        return None if comp.size else np.empty(0, np.uint8)
    # gzip trailer ISIZE (decompressed size mod 2^32 of the LAST member) is
    # an exact hint for the common single-member case
    isize = int(comp[-4:].view(np.uint32)[0]) if comp.size >= 4 else 0
    cap = max(isize, 4 * comp.size, 32 << 20)
    out = np.empty(cap, np.uint8)
    d = lib.libdeflate_alloc_decompressor()
    try:
        pos = 0
        written = 0
        a_in = ctypes.c_size_t(0)
        a_out = ctypes.c_size_t(0)
        base_in = comp.ctypes.data
        while pos < comp.size:
            while True:
                rc = lib.libdeflate_gzip_decompress_ex(
                    d,
                    base_in + pos,
                    comp.size - pos,
                    out.ctypes.data + written,
                    out.size - written,
                    ctypes.byref(a_in),
                    ctypes.byref(a_out),
                )
                if rc == 3:  # LIBDEFLATE_INSUFFICIENT_SPACE: grow and retry
                    grown = np.empty(out.size * 2 + (64 << 20), np.uint8)
                    grown[:written] = out[:written]
                    out = grown
                    continue
                break
            if rc != 0:
                return None  # malformed: let streaming zlib raise cleanly
            pos += a_in.value
            written += a_out.value
            if a_in.value == 0:
                break  # trailing garbage guard
        return out[:written]
    finally:
        lib.libdeflate_free_decompressor(d)


def _find_nth_newline_arr(arr: np.ndarray, start: int, n: int) -> int:
    """Offset (absolute) of the n-th newline at/after `start`, or -1."""
    lib = _native._load()
    if lib is not None:
        if not hasattr(lib, "_nl_bound"):
            lib.nt_find_nth_newline.restype = ctypes.c_int64
            lib.nt_find_nth_newline.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib._nl_bound = True
        off = lib.nt_find_nth_newline(
            arr.ctypes.data + start, arr.size - start, n
        )
        return start + off if off >= 0 else -1
    nls = np.flatnonzero(arr[start:] == 10)
    if nls.size < n:
        return -1
    return start + int(nls[n - 1])


def _record_buffers_contig(arr: np.ndarray, records_per_batch: int):
    """Contiguous-buffer variant of _record_buffers: cut a whole inflated
    file into per-batch views with zero copies. Same deterministic batch
    partition (every 4*records_per_batch newlines) as the streaming
    cutter, so output is byte-identical either way."""
    need_nl = 4 * records_per_batch
    pos = 0
    while pos < arr.size:
        cut = _find_nth_newline_arr(arr, pos, need_nl)
        if cut < 0:
            tail = arr[pos:]
            if tail.size and bytes(tail).strip():
                yield tail, -1
            return
        yield arr[pos : cut + 1], records_per_batch
        pos = cut + 1


def _stream_chunks(path: str, chunk_bytes: int = _CHUNK_BYTES):
    """Yield decompressed byte chunks from a plain or gzip file."""
    gz = path.endswith(".gz")
    with open(path, "rb") as f:
        if not gz:
            while True:
                b = f.read(chunk_bytes)
                if not b:
                    return
                yield b
        else:
            d = zlib.decompressobj(wbits=31)
            while True:
                raw = f.read(chunk_bytes)
                if not raw:
                    break
                out = d.decompress(raw)
                if out:
                    yield out
                while d.eof and d.unused_data:
                    # multi-member gzip (e.g. bgzf-style concatenation)
                    tail = d.unused_data
                    d = zlib.decompressobj(wbits=31)
                    out = d.decompress(tail)
                    if out:
                        yield out
            out = d.flush()
            if out:
                yield out


def _find_nth_newline(chunk: bytes, n: int) -> int:
    """Offset of the n-th (1-based) newline in chunk (native memchr loop
    when available: the numpy flatnonzero fallback allocates a full index
    vector per call and was the streaming cutter's dominant cost)."""
    lib = _native._load()
    if lib is not None:
        if not hasattr(lib, "_nl_bound"):
            lib.nt_find_nth_newline.restype = ctypes.c_int64
            lib.nt_find_nth_newline.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib._nl_bound = True
        off = lib.nt_find_nth_newline(
            ctypes.cast(ctypes.c_char_p(chunk), ctypes.c_void_p), len(chunk), n
        )
        if off >= 0:
            return off
        raise ValueError("newline count underflow in record cutter")
    arr = np.frombuffer(chunk, dtype=np.uint8)
    nls = np.flatnonzero(arr == 10)
    return int(nls[n - 1])


def _record_buffers(stream, records_per_batch: int):
    """Cut a decompressed byte stream into buffers of exactly
    records_per_batch FASTQ records (4 newlines each); the final buffer
    carries the remainder and is flagged with its (possibly smaller) count
    -1 = "count unknown, parser decides"."""
    need_nl = 4 * records_per_batch
    parts: list = []
    counts: list = []
    total_nl = 0
    for chunk in stream:
        parts.append(chunk)
        c = chunk.count(b"\n")
        counts.append(c)
        total_nl += c
        while total_nl >= need_nl:
            acc = 0
            cut_i = 0
            for i, ci in enumerate(counts):
                if acc + ci >= need_nl:
                    cut_i = i
                    break
                acc += ci
            pos = _find_nth_newline(parts[cut_i], need_nl - acc)
            out = b"".join(parts[:cut_i]) + parts[cut_i][: pos + 1]
            rest = parts[cut_i][pos + 1 :]
            parts = ([rest] if rest else []) + parts[cut_i + 1 :]
            rc = rest.count(b"\n") if rest else 0
            counts = ([rc] if rest else []) + counts[cut_i + 1 :]
            total_nl -= need_nl
            yield out, records_per_batch
    tail = b"".join(parts)
    if tail.strip():
        yield tail, -1


def _parse_counted(buf, n_hint: int, max_len: int, with_strings: bool):
    """_parse_buffer in a `pipeline.parse` span (the parse pool's work)."""
    with obs.span("pipeline.parse"):
        return _parse_buffer(buf, n_hint, max_len, with_strings)


def _parse_buffer(buf, n_hint: int, max_len: int, with_strings: bool):
    """Parse one complete-records buffer (bytes OR a uint8 ndarray view of
    a contiguous inflated file) via the native layer. Returns the same
    tuple shape as NativeFastqFile.read_batch."""
    lib = _native._load()
    if not hasattr(lib, "_parse_bound"):
        lib.nt_fastq_parse_buffer.restype = ctypes.c_int64
        lib.nt_fastq_parse_buffer.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib._parse_bound = True
    if isinstance(buf, np.ndarray):
        ptr = buf.ctypes.data
        if n_hint < 0:
            n_hint = int(np.count_nonzero(buf == 10)) // 4 + 2
    else:
        ptr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)
        if n_hint < 0:
            n_hint = buf.count(b"\n") // 4 + 2
    n = max(n_hint, 1)
    codes = np.empty((n, max_len), dtype=np.int8)
    lens = np.empty(n, dtype=np.int32)
    # name+seq+qual + 3 NULs per record is bounded by the buffer itself
    raw_cap = len(buf) + 4 * n + 64
    raw = np.empty(raw_cap, dtype=np.uint8)
    offs = np.empty(n * 3, dtype=np.int64)
    got = lib.nt_fastq_parse_buffer(
        ptr,
        len(buf),
        n,
        max_len,
        codes.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        raw.ctypes.data_as(ctypes.c_void_p),
        raw_cap,
        offs.ctypes.data_as(ctypes.c_void_p),
    )
    if got < 0:
        raise RuntimeError("FASTQ parse buffer overflow (malformed record?)")
    out = {"codes": codes[:got], "lens": lens[:got]}
    if with_strings:
        out["names"] = _native._extract_strings(raw, offs, 0, got)
        out["seqs"] = _native._extract_strings(raw, offs, 1, got)
        out["quals"] = _native._extract_strings(raw, offs, 2, got)
    return out


class ThreadedFastqReader:
    """Parallel drop-in for io.fastq.FastqReader / io.native.NativeFastqReader.

    num_threads parse workers + one producer thread; at most `prefetch`
    parsed batches buffered ahead of the consumer.
    """

    def __init__(
        self,
        r1_path: str,
        r2_path: Optional[str] = None,
        batch_size: int = 1 << 17,
        max_len: int = 256,
        num_threads: int = 2,
        prefetch: int = 3,
        with_strings: bool = False,
    ):
        if not _native.available():
            raise RuntimeError("native library unavailable")
        self.r1_path = r1_path
        self.r2_path = r2_path
        self.batch_size = batch_size
        self.max_len = max_len
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.with_strings = with_strings
        # decode sharding (multi-process align): skip(r0, r1) -> True means
        # records [r0, r1) belong entirely to other processes, so their
        # bytes are never parsed/encoded — the batch is yielded as a
        # {"skip": n} marker instead. Installed late (the span size is only
        # known once engines are built); checked per batch at submit time,
        # so a racy install merely parses a few extra batches.
        self._skip = None
        self.stats = {"parsed_records": 0, "skipped_records": 0}

    def set_skip(self, fn) -> None:
        self._skip = fn

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_threads, thread_name_prefix="nimble-parse")
        stop = threading.Event()

        def _buffers_for(path):
            """Pick the cutter. Both cutters use the same 4*batch-newline
            partition, so batches are identical either way.

            gz: streaming zlib by default — libdeflate inflates 2.4x
            faster but needs the whole output resident, and on this class
            of VM first-touch page faults run at only ~170-280 MB/s
            (docs/PERF.md round-3), which more than eats the win; hosts
            with normal memory can opt in via NIMBLE_TPU_WHOLE_INFLATE=1.
            plain: whole-file memmap cut into contiguous zero-copy views
            (the OS pages it; cap NIMBLE_TPU_PLAIN_MMAP_MAX_MB)."""
            if path.endswith(".gz"):
                if os.environ.get("NIMBLE_TPU_WHOLE_INFLATE", "") == "1":
                    arr = _inflate_whole(path)
                    if arr is not None:
                        return _record_buffers_contig(arr, self.batch_size)
                return _record_buffers(_stream_chunks(path), self.batch_size)
            try:
                sz = os.path.getsize(path)
            except OSError:
                sz = 1 << 62
            if 0 < sz <= _PLAIN_MMAP_MAX_MB << 20:
                return _record_buffers_contig(
                    np.memmap(path, dtype=np.uint8, mode="r"), self.batch_size
                )
            return _record_buffers(_stream_chunks(path), self.batch_size)

        def draw(g):
            # the next record buffer: the inflate and the record cut
            with obs.span("pipeline.read"):
                return next(g)

        def produce():
            try:
                with obs.span("pipeline.read"):  # a whole-file inflate runs here
                    g1 = _buffers_for(self.r1_path)
                    g2 = _buffers_for(self.r2_path) if self.r2_path else None
                r0 = 0  # global record index of the next batch
                while True:
                    try:
                        buf1, n1 = draw(g1)
                    except StopIteration:
                        break
                    skip = (
                        n1 > 0
                        and self._skip is not None
                        and self._skip(r0, r0 + n1)
                    )
                    if skip:
                        # consume (but never parse) the mate buffer too
                        if g2 is not None:
                            try:
                                draw(g2)
                            except StopIteration:
                                raise ValueError(
                                    "paired FASTQ files have different "
                                    "record counts"
                                )
                        item = ("skip", n1)
                    else:
                        f1 = pool.submit(
                            _parse_counted, buf1, n1, self.max_len,
                            self.with_strings,
                        )
                        f2 = None
                        if g2 is not None:
                            try:
                                buf2, n2 = draw(g2)
                            except StopIteration:
                                raise ValueError(
                                    "paired FASTQ files have different "
                                    "record counts"
                                )
                            f2 = pool.submit(
                                _parse_counted, buf2, n2, self.max_len,
                                self.with_strings,
                            )
                        item = (f1, f2)
                    if n1 > 0:
                        r0 += n1  # tail batches (n1 < 0) are final
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                if g2 is not None:
                    try:
                        draw(g2)
                        raise ValueError(
                            "paired FASTQ files have different record counts"
                        )
                    except StopIteration:
                        pass
                q.put(None)
            except BaseException as e:  # surface reader errors to the consumer
                q.put(e)

        producer = threading.Thread(target=produce, daemon=True, name="nimble-read")
        producer.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                f1, f2 = item
                if f1 == "skip":
                    self.stats["skipped_records"] += f2
                    yield {"skip": f2}
                    continue
                b1 = f1.result()
                self.stats["parsed_records"] += int(b1["codes"].shape[0])
                batch = {"r1_codes": b1["codes"], "r1_lens": b1["lens"]}
                if self.with_strings:
                    batch["names"] = b1["names"]
                    batch["r1_seqs"] = b1["seqs"]
                    batch["r1_quals"] = b1["quals"]
                if f2 is not None:
                    b2 = f2.result()
                    if b2["codes"].shape[0] != b1["codes"].shape[0]:
                        raise ValueError(
                            "paired FASTQ files have different record counts"
                        )
                    batch["r2_codes"] = b2["codes"]
                    batch["r2_lens"] = b2["lens"]
                    if self.with_strings:
                        batch["r2_seqs"] = b2["seqs"]
                        batch["r2_quals"] = b2["quals"]
                yield batch
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
