"""Threaded FASTQ ingestion: inflate -> record-boundary cut -> parallel
native parse -> bounded prefetch queue.

This is what `align -c/--num_cores` drives (the reference threads its whole
hot path with `-c`, reference nimble/__main__.py:180; here the device does
the alignment, so host decode is the part that must scale). Layout:

  producer thread:   cuts each input's bytes into record buffers of
  (`nimble-read`)    4*batch_size newlines, keeps R1/R2 in lockstep; each
                     draw a `pipeline.read` span (waits on the inflate
                     pool included)
  inflate pool:      a gz input of several gzip members has its members
  (`nimble-inflate`) inflated side by side (libdeflate, else zlib; both
                     release the GIL); each task a `pipeline.inflate` span
  parse pool:        workers call nt_fastq_parse_buffer (ctypes releases
  (`nimble-parse`)   the GIL; the parse+2-bit-encode loop runs truly
                     parallel across cores); each parse a `pipeline.parse`
                     span
  consumer:          __iter__ drains a bounded queue of parsed futures and
                     yields the same batch dicts as io.fastq.FastqReader

The two pools share num_threads (the -c budget): the inflate pool takes
_inflate_workers(num_threads) of it when an input has several members, the
parse pool the rest.

Byte-stream identical output to the sequential readers at any thread count
and on every path: every path hands _record_buffers_contig its inflated
bytes in order, which cuts them every 4*batch_size newlines, so the batch
partition is deterministic.

Each input takes one path, chosen from its bytes and named by the run
log's `reader` event:

  members  gz, two or more member starts (bgzip, block-parallel
           compressors): each member is found from the bytes (`1f 8b 08`,
           then a FLG byte with its reserved bits clear) and sized by the
           ISIZE trailer just before the next one, so it is inflated alone
           into a buffer of its own size and checked by its CRC32 and
           ISIZE. Batches are views of those buffers, one copy where a
           batch spans more than one. At most _WINDOW_BYTES of output is
           in flight ahead of the cut, whatever the file's size. A span
           the pool cannot take (a false start inside compressed data, a
           member past the window) is streamed through zlib to the
           member's true end, and the pool goes on from there: a one-member
           file with a false start in its data streams as on the stream
           path, and its event says `stream`;
  stream   gz, one member start (gzip, pigz): streaming zlib in 8 MiB
           chunks;
  plain    uncompressed: a memmap cut into views (streamed above
           NIMBLE_TPU_PLAIN_MMAP_MAX_MB).
"""
from __future__ import annotations

import collections
import ctypes
import mmap
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

# The member path groups consecutive members into inflate tasks of about
# _TASK_BYTES of output (one buffer a task: a bgzip file's 64 KiB members
# go 128 to a task), and keeps at most _WINDOW_BYTES of output in flight
# ahead of the record cut; a member larger than the window is streamed.
_TASK_BYTES = 8 << 20
_WINDOW_BYTES = 256 << 20
_GZ_MAGIC = b"\x1f\x8b\x08"  # gzip ID1 ID2, CM = deflate
_GZ_MIN_MEMBER = 20  # a 10-byte header, an empty deflate block, an 8-byte trailer

# Plain (uncompressed) files under this cap are np.memmap'd whole — the OS
# pages them in on demand, so address space (not RAM) is the cost — and
# cut into contiguous zero-copy record views. Larger files stream in 8 MiB
# chunks.
_PLAIN_MMAP_MAX_MB = int(
    os.environ.get("NIMBLE_TPU_PLAIN_MMAP_MAX_MB", "65536")
)

_LD = None
_LD_TRIED = False


def _libdeflate():
    """ctypes handle to libdeflate with gzip_decompress_ex bound, or None.
    Any thread may ask first: the handle is set before it is marked found."""
    global _LD, _LD_TRIED
    if _LD_TRIED:
        return _LD
    lib = None
    for name in ("libdeflate.so.0", "libdeflate.so", "libdeflate.dylib"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            pass
    try:
        if lib is not None:
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
        lib = None
    _LD = lib
    _LD_TRIED = True
    return _LD


def _inflate_workers(num_threads: int) -> int:
    """The inflate pool's share of a reader's num_threads (the -c budget)
    when an input has several members; the parse pool takes the rest.
    Half, and 4 at most: on an 8-core H100 host, in-process bulk align jobs
    of 1,048,576 reads in 16 members (zlib inflating) took a median
    0.964-0.979 s with 2-4 inflate workers of -c 8 and 0.985-1.047 s with
    5-6; under -c 4, 0.953 s with 2, 1.022 s with 3 and 1.338 s with 1.
    Against a pool of 4 beside a parse pool of all of -c, alternating
    processes: 0.661-0.765 s against 0.744-0.895 s (-c 8), 0.652-0.865 s
    against 0.711-0.834 s (-c 4)."""
    return max(1, min(num_threads // 2, 4))


def _member_start(mm, p: int) -> int:
    """The first member-start candidate at or after p: `1f 8b 08` and a FLG
    byte with its reserved bits clear, with room for a whole member behind
    it; len(mm) where there is none. A candidate may lie inside a member's
    compressed data: the inflate tells them apart."""
    size = len(mm)
    while True:
        p = mm.find(_GZ_MAGIC, p)
        if p < 0 or p + _GZ_MIN_MEMBER > size:
            return size
        if not mm[p + 3] & 0xE0:
            return p
        p += 1


def _isize(mm, end: int) -> int:
    """The ISIZE trailer of a member that ends at `end`."""
    return int.from_bytes(mm[end - 4:end], "little")


def _plausible(span: int, isize: int) -> bool:
    """Whether `span` compressed bytes can be one member of `isize` bytes
    out that the member path holds whole: deflate expands at most 1032-fold,
    and an encoder stores what it cannot shrink (2x and 1 KiB of header
    room here). An ISIZE past the window, wrapped at 4 GiB or read from a
    false candidate's bytes mostly fails this, at no inflate."""
    return (_GZ_MIN_MEMBER <= span <= 2 * isize + 1024
            and isize <= min(1032 * span, _WINDOW_BYTES))


def _count_newlines(arr: np.ndarray) -> int:
    """Newlines in arr, 1 MiB at a time (one bool scratch a call)."""
    step = 1 << 20
    scratch = np.empty(min(step, arr.size), bool)
    n = 0
    for i in range(0, arr.size, step):
        part = arr[i:i + step]
        hit = scratch[:part.size]
        np.equal(part, 10, out=hit)
        n += int(np.count_nonzero(hit))
    return n


def _inflate_members(comp: np.ndarray, members: list, out: np.ndarray):
    """Inflate gzip members [(start, end, offset, isize)] of `comp` into
    `out` at their offsets, in order, up to the first that fails. A member
    is taken only when the inflater returns 0 (its CRC32 and ISIZE
    checked), read exactly [start, end) and wrote exactly isize bytes.
    Returns (members taken, newlines in their bytes). The inflate pool's
    task: a `pipeline.inflate` span."""
    with obs.span("pipeline.inflate"):
        ok = 0
        lib = _libdeflate()
        if lib is not None:
            d = lib.libdeflate_alloc_decompressor()
            a_in, a_out = ctypes.c_size_t(0), ctypes.c_size_t(0)
            src, dst = comp.ctypes.data, out.ctypes.data
            try:
                for s, e, off, isize in members:
                    rc = lib.libdeflate_gzip_decompress_ex(
                        d, src + s, e - s, dst + off, isize,
                        ctypes.byref(a_in), ctypes.byref(a_out))
                    if rc or a_in.value != e - s or a_out.value != isize:
                        break
                    ok += 1
            finally:
                lib.libdeflate_free_decompressor(d)
        else:
            for s, e, off, isize in members:
                d = zlib.decompressobj(wbits=31)
                try:
                    data = d.decompress(comp[s:e], isize + 1)
                except zlib.error:
                    break
                if not d.eof or d.unused_data or len(data) != isize:
                    break
                out[off:off + isize] = np.frombuffer(data, np.uint8)
                ok += 1
        end = members[ok][2] if ok < len(members) else out.size
        return ok, _count_newlines(out[:end])


def _stream_member(mm, s: int):
    """Stream what lies at s, a gzip member as a rule, through zlib, as the
    stream path would: _CHUNK_BYTES of input at a time, as (output, its
    newline count). Returns (the offset after the member, whether it
    ended); where the bytes end first, the file's size. A bad header
    raises what the stream path raises."""
    d = zlib.decompressobj(wbits=31)
    size = len(mm)
    p = s
    while p < size:
        raw = mm[p:p + _CHUNK_BYTES]
        p += len(raw)
        out = d.decompress(raw)
        if out:
            yield np.frombuffer(out, np.uint8), out.count(b"\n")
        if d.eof:
            return p - len(d.unused_data), True
    out = d.flush()
    if out:
        yield np.frombuffer(out, np.uint8), out.count(b"\n")
    return size, False


def _member_chunks(mm, pool, workers: int, info: dict):
    """(inflated bytes, their newline count) of a gz file of several
    members, in file order, each as soon as it is inflated.

    Consecutive members go to the pool in tasks of about _TASK_BYTES, each
    into a buffer of its members' summed ISIZE, with up to 2 tasks a worker
    and _WINDOW_BYTES of output in flight. A span the pool cannot take (a
    false start inside a member's compressed data, an ISIZE past the
    window or wrapped, the bytes after the last member) is streamed by
    _stream_member to the member's true end, and the pool goes on from
    there; so a malformed file yields and raises what the stream path
    does. `info` counts the members read, the false starts met, whether
    any span streamed, and names the path: `members` once the pool has
    inflated a member, else `stream`."""
    comp = np.frombuffer(mm, np.uint8)  # tasks hold it: the map outlives them
    size = len(mm)
    s, e = 0, _member_start(mm, 1)  # the next member's span
    inflight = collections.deque()  # (future, buffer, members)
    ahead = 0  # bytes of output in flight
    while s < size or inflight:
        while s < size and len(inflight) < 2 * workers:
            members, total = [], 0
            while s < size and total < _TASK_BYTES:
                isize = _isize(mm, e)
                if not _plausible(e - s, isize) or (
                        (ahead or total) and ahead + total + isize > _WINDOW_BYTES):
                    break
                members.append((s, e, total, isize))
                total += isize
                s, e = e, _member_start(mm, e + 1)
            if not members:
                break
            out = np.empty(total, np.uint8)
            inflight.append((pool.submit(_inflate_members, comp, members, out), out, members))
            ahead += total
        if inflight:
            fut, out, members = inflight.popleft()
            ahead -= out.size
            ok, nl = fut.result()
            info["members"] += ok
            if ok:
                info["path"] = "members"
                yield (out if ok == len(members) else out[:members[ok][2]]), nl
            if ok == len(members):
                continue
            for f, _, _ in inflight:
                f.cancel()
            inflight.clear()
            ahead = 0
            s, e = members[ok][:2]
        # [s, e) is no member the pool can take: stream the one at s
        info["fallback"] = True
        end, ended = yield from _stream_member(mm, s)
        info["members"] += ended
        while e < end:  # false starts inside the streamed member
            info["merges"] += 1
            e = _member_start(mm, e + 1)
        s, e = end, _member_start(mm, end + 1)


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


def _record_buffers_contig(chunks, records_per_batch: int):
    """Cut contiguous buffers, given in order as (uint8 array, its newline
    count or None), into batches of records_per_batch records: views of a
    buffer, or one copy where a batch spans several. The partition (every
    4*records_per_batch newlines) depends on the bytes alone, not on how
    they come in buffers, so every path gives the same batches. The last
    buffer, if it holds anything but whitespace, comes with the count -1
    ("count unknown, parser decides")."""
    need_nl = 4 * records_per_batch
    carry, carry_nl = [], 0  # the open batch's pieces of earlier buffers
    for arr, nl in chunks:
        pos = 0
        while nl is None or carry_nl + nl >= need_nl:
            cut = _find_nth_newline_arr(arr, pos, need_nl - carry_nl)
            if cut < 0:
                nl = _count_newlines(arr[pos:])
                break
            piece = arr[pos:cut + 1]
            yield (np.concatenate(carry + [piece]) if carry else piece), records_per_batch
            if nl is not None:
                nl -= need_nl - carry_nl
            carry, carry_nl = [], 0
            pos = cut + 1
        if pos < arr.size:
            carry.append(arr[pos:])
            carry_nl += nl
    tail = np.concatenate(carry) if carry else None
    if tail is not None and bytes(tail).strip():
        yield tail, -1


def _stream_chunks(path: str):
    """A plain or gzip file's bytes, streamed _CHUNK_BYTES of the file at a
    time (zlib inflating), as (uint8 view, its newline count)."""

    def counted(b):
        return np.frombuffer(b, np.uint8), b.count(b"\n")

    with open(path, "rb") as f:
        if not path.endswith(".gz"):
            while True:
                b = f.read(_CHUNK_BYTES)
                if not b:
                    return
                yield counted(b)
        d = zlib.decompressobj(wbits=31)
        while True:
            raw = f.read(_CHUNK_BYTES)
            if not raw:
                break
            out = d.decompress(raw)
            if out:
                yield counted(out)
            while d.eof and d.unused_data:
                # multi-member gzip (e.g. bgzf-style concatenation)
                tail = d.unused_data
                d = zlib.decompressobj(wbits=31)
                out = d.decompress(tail)
                if out:
                    yield counted(out)
        out = d.flush()
        if out:
            yield counted(out)


def _gz_starts(path: str):
    """(map, starts) of a gz file: starts is 0 where it does not open with
    a member start, 1 where that is its only one, and 2 where it holds
    another (the member path, which alone keeps the read-only map; None
    elsewhere). A file that cannot be mapped reads as 0."""
    try:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, ValueError):  # absent, empty, not a regular file
        return None, 0
    starts = 0
    if _member_start(mm, 0) == 0:
        starts = 2 if _member_start(mm, 1) < len(mm) else 1
    if starts == 2:
        return mm, 2
    mm.close()
    return None, starts


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

    num_threads workers (parse, and inflate where an input has several gzip
    members) + one producer thread; at most `prefetch` parsed batches
    buffered ahead of the consumer.
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
        paths = [self.r1_path] + ([self.r2_path] if self.r2_path else [])
        gz = [_gz_starts(p) if p.endswith(".gz") else (None, 0) for p in paths]
        workers = _inflate_workers(self.num_threads) if any(mm is not None for mm, _ in gz) else 0
        pool = ThreadPoolExecutor(max_workers=max(1, self.num_threads - workers),
                                  thread_name_prefix="nimble-parse")
        inflate_pool = (ThreadPoolExecutor(max_workers=workers, thread_name_prefix="nimble-inflate")
                        if workers else None)
        stop = threading.Event()

        def _buffers_for(path, mm, starts, reports):
            """The input's record buffers, on the path its bytes call for
            (module docstring; `mm`, `starts`: _gz_starts). The run log's
            `reader` event names the path, the members read (on the other
            gz paths the member starts found, 0 or 1), the false starts
            met, whether a span of the member path streamed, and the
            inflate workers; a member path's event comes from `reports` as
            the producer ends.

            gz of one member: streaming zlib."""
            B = self.batch_size
            event = {"path": "stream", "file": path, "members": 0, "merges": 0, "fallback": False,
                     "workers": workers}
            if mm is not None:
                reports.append(event)
                return _record_buffers_contig(_member_chunks(mm, inflate_pool, workers, event), B)
            if path.endswith(".gz"):
                event["members"] = starts
                obs.runlog().event("reader", **event)
                return _record_buffers_contig(_stream_chunks(path), B)
            obs.runlog().event("reader", **{**event, "path": "plain"})
            try:
                sz = os.path.getsize(path)
            except OSError:
                sz = 1 << 62
            if 0 < sz <= _PLAIN_MMAP_MAX_MB << 20:
                return _record_buffers_contig(
                    [(np.memmap(path, dtype=np.uint8, mode="r"), None)], B
                )
            return _record_buffers_contig(_stream_chunks(path), B)

        def draw(g):
            # the next record buffer: the inflate and the record cut
            with obs.span("pipeline.read"):
                return next(g)

        def put(item) -> bool:
            # False once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            gens, reports = [], []
            end = None  # the consumer's last item: None, or the reader's error
            try:
                with obs.span("pipeline.read"):  # a whole-file inflate runs here
                    for path, (mm, starts) in zip(paths, gz):
                        gens.append(_buffers_for(path, mm, starts, reports))
                g1, g2 = gens[0], (gens[1] if self.r2_path else None)
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
                    if not put(item):
                        return
                if g2 is not None:
                    try:
                        draw(g2)
                        raise ValueError(
                            "paired FASTQ files have different record counts"
                        )
                    except StopIteration:
                        pass
            except BaseException as e:  # surface reader errors to the consumer
                end = e
            finally:
                # free the inputs' buffers and maps before the end is seen
                for g in gens:
                    g.close()
                for event in reports:
                    obs.runlog().event("reader", **event)
            put(end)

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
            if inflate_pool is not None:
                inflate_pool.shutdown(wait=False, cancel_futures=True)
