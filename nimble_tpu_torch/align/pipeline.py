"""Host-side `align` pipeline for the port: read streaming, emission,
several libraries.

Copied from nimble_tpu/align/pipeline.py (which cannot be imported without
jax) with what the group, gband and mono paths need, and driving the torch
engine on an explicit device. The TSV schema, set-size filters, group_on
collapse, trimming, `--probe`, the group paths' short-read repair and the
three emission routes (dense bits, gband band rows, idlist ids) are the
reference's own, so the output is byte-identical.

The port runs one process on one device. It refuses the reference's
`--mesh` and multi-process worlds (ROADMAP Queue 1 item 8) and `--resume`
(item 4); several comma-separated libraries run as one engine each, as the
reference does under NIMBLE_TPU_NO_STACK=1 (stacking is item 6).
"""
from __future__ import annotations

import os
import queue
import sys
import threading
from dataclasses import dataclass
from itertools import chain
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimble_tpu_torch.config import Config, load_library
from nimble_tpu_torch.index.builder import KmerIndex, build_index_for_library
from nimble_tpu_torch.align.engine import AlignEngine, expand_band_rows_np, ids_to_bits_np

TSV_HEADER = [
    "nimble_features",
    "nimble_score",
    "r1_CB",
    "r1_UB",
    "r2_CB",
    "r2_UB",
    "r1_POS",
    "r2_POS",
    "r1_forward_score",
    "r2_forward_score",
    "r1_GN",
]

# spans dispatched to the device and not yet emitted; the reader prefetch
# and the span queue each hold one more
INFLIGHT = 2


def decode_bitsets(bits: np.ndarray, n_features: int) -> np.ndarray:
    """(B, W) uint32 bitsets -> (B, n_features) bool membership matrix."""
    if bits.size == 0:
        return np.zeros((bits.shape[0], n_features), dtype=bool)
    u8 = bits.astype("<u4", copy=False).view(np.uint8).reshape(bits.shape[0], -1)
    expanded = np.unpackbits(u8, axis=1, bitorder="little")
    return expanded[:, :n_features].astype(bool)


@dataclass
class EmitConfig:
    """Host emission parameters derived from the library Config."""

    group_on: bool
    discard_multiple_matches: bool
    discard_multi_hits: int
    max_hits_to_report: int


def _unique_rows(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniq_rows, inverse) like np.unique(bits, axis=0) but much faster:
    each row hashes to one int64, scalars are uniqued, and every row is
    checked against its representative (a collision takes the exact path).
    Unique rows come out in hash order; callers never rely on order."""
    n, W = bits.shape
    if n == 0:
        return bits, np.zeros(0, dtype=np.int64)
    mult = np.random.default_rng(0xC0FFEE).integers(
        1, 1 << 62, size=W, dtype=np.int64
    ) | 1
    h = np.empty(n, dtype=np.int64)
    with np.errstate(over="ignore"):
        for s in range(0, n, 8192):
            blk = bits[s : s + 8192].astype(np.int64)
            blk *= mult[None, :]
            h[s : s + 8192] = blk.sum(axis=1)
    _, first, inverse = np.unique(h, return_index=True, return_inverse=True)
    uniq = bits[first]
    if not np.array_equal(uniq[inverse], bits):  # hash collision
        return np.unique(bits, axis=0, return_inverse=True)
    return uniq, inverse


def resolve_features_compact(
    index: KmerIndex, bits: np.ndarray, emit: EmitConfig
):
    """Decode device bitsets into per-ambiguity-class feature strings:
    group_on collapse, then the set-size filters. Returns (feature string
    per unique class, keep mask per unique class, inverse map read ->
    class)."""
    uniq, inverse = _unique_rows(bits)
    member = decode_bitsets(uniq, index.n_features)
    rows, cols = np.nonzero(member)
    u = member.shape[0]
    return _resolve_classes_from_cols(index, u, rows, cols, emit, inverse)


def _resolve_classes_from_cols(
    index: KmerIndex, u: int, rows: np.ndarray, cols: np.ndarray,
    emit: EmitConfig, inverse: np.ndarray,
):
    """group_on collapse, set-size filters and name pooling — native
    (nt_resolve_classes) or the python fallback. rows must be sorted; cols
    are feature ids below n_features."""
    if emit.group_on:
        cols = index.feature_to_group[cols]
        names = index.group_names
    else:
        names = index.feature_names
    boundaries = np.searchsorted(rows, np.arange(u + 1))

    from nimble_tpu_torch.io import native

    if native.available():
        lexrank, names_bytes, name_offs = _lex_tables(index, emit.group_on, names)
        u_keep, pool, pool_offs = native.resolve_classes(
            boundaries,
            cols,
            lexrank,
            names_bytes,
            name_offs,
            emit.discard_multiple_matches,
            emit.discard_multi_hits,
            emit.max_hits_to_report,
        )
        return (pool, pool_offs), u_keep, inverse

    u_features: List[str] = [""] * u
    u_keep = np.zeros(u, dtype=bool)
    for i in range(u):
        s, e = boundaries[i], boundaries[i + 1]
        if s == e:
            continue
        ids = np.unique(cols[s:e])
        if emit.discard_multiple_matches and ids.size > 1:
            continue
        if emit.discard_multi_hits > 0 and ids.size > emit.discard_multi_hits:
            continue
        if ids.size > emit.max_hits_to_report:
            continue
        u_features[i] = ",".join(sorted(names[g] for g in ids))
        u_keep[i] = True

    return u_features, u_keep, inverse


def resolve_features_band(index: KmerIndex, band_rows: np.ndarray, Pw: int, emit: EmitConfig):
    """pipeline.py:resolve_features_band — resolve_features_compact over
    (n, 1 + 2 Pw) band rows [page | band] without expanding them to W
    words: feature id = page * Pw * 32 + the bit's position in the band."""
    uniq, inverse = _unique_rows(band_rows)
    u = uniq.shape[0]
    u8 = np.ascontiguousarray(uniq[:, 1:], dtype="<i4").view(np.uint8)
    expanded = np.unpackbits(u8.reshape(u, -1), axis=1, bitorder="little")
    rows, bitpos = np.nonzero(expanded)
    cols = (uniq[rows, 0].astype(np.int64) * (Pw * 32) + bitpos).astype(np.int32)
    tail = cols >= index.n_features  # last-word padding bits, if any
    if tail.any():
        rows, cols = rows[~tail], cols[~tail]
    return _resolve_classes_from_cols(index, u, rows, cols, emit, inverse)


def resolve_features_ids(index: KmerIndex, ids: np.ndarray, emit: EmitConfig):
    """pipeline.py:resolve_features_ids — resolve_features_compact over the
    idlist wire's (n, cap) feature-id rows, -1 padded: unique the id rows
    and hand their ids straight to the class resolver, no bitset decode."""
    uniq, inverse = _unique_rows(ids)
    present = (uniq >= 0) & (uniq < index.n_features)  # guard stray ids
    rows, _ = np.nonzero(present)
    cols = uniq[present].astype(np.int32)
    return _resolve_classes_from_cols(index, uniq.shape[0], rows, cols, emit, inverse)


def _lex_tables(index: KmerIndex, group_on: bool, names):
    """Cached per-index lex-order tables for native class resolution:
    (lexrank: id -> lex position, concatenated lex-ordered name bytes,
    offsets), sorted by the same str ordering the fallback's sorted() uses."""
    cache = getattr(index, "_lex_cache", None)
    if cache is None:
        cache = {}
        index._lex_cache = cache
    got = cache.get(group_on)
    if got is None:
        order = sorted(range(len(names)), key=lambda i: names[i])
        lexrank = np.empty(len(names), dtype=np.int32)
        for r, i in enumerate(order):
            lexrank[i] = r
        pool = [names[i].encode() for i in order]
        name_offs = np.zeros(len(pool) + 1, dtype=np.int64)
        if pool:
            np.cumsum([len(b) for b in pool], out=name_offs[1:])
        got = (lexrank, b"".join(pool), name_offs)
        cache[group_on] = got
    return got


def _feature_str(u_features, j: int) -> str:
    """Index the resolve_features_compact string pool (list or
    (bytes, offsets) tuple) as str."""
    if isinstance(u_features, tuple):
        pool, offs = u_features
        return pool[offs[j] : offs[j + 1]].decode()
    return u_features[j]


def resolve_features(index: KmerIndex, bits: np.ndarray, emit: EmitConfig):
    """Per-read view of resolve_features_compact: (feature string per read,
    keep mask per read); dropped reads get ''."""
    u_features, u_keep, inverse = resolve_features_compact(index, bits, emit)
    return [_feature_str(u_features, j) for j in inverse], u_keep[inverse]


def trimmed_lens(lens: np.ndarray, trim: Tuple[int, float]) -> np.ndarray:
    """pipeline.py:trimmed_lens — a read's 3' overhang beyond the target
    length is cut by round(strictness * overhang) bases (strictness 1.0 is
    a hard cap, 0.0 disables trimming)."""
    target, strictness = trim
    if target <= 0 or strictness <= 0:
        return lens
    overhang = np.maximum(lens - target, 0)
    cut = np.rint(strictness * overhang).astype(lens.dtype)
    return lens - cut


@dataclass
class LibraryRunner:
    """One library's engine + emission state + output file."""

    config: Config
    index: KmerIndex
    engine: Optional[AlignEngine]
    emit: EmitConfig
    output_path: str
    trim: Tuple[int, float] = (0, 0.0)  # (target_length, strictness); (0, _) = off
    _file: object = None

    def open(self):
        self._file = open(self.output_path, "wb")
        self._file.write(("\t".join(TSV_HEADER) + "\n").encode())

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def emit_out(self, out, batch) -> int:
        """Append this library's passing rows from host-numpy outputs (rows
        formatted natively when the native library is available)."""
        if out is None:
            return 0
        pass_ = out["pass_"]
        if out.get("ids") is not None:
            u_features, u_keep, inverse = resolve_features_ids(self.index, out["ids"], self.emit)
        elif out.get("band_rows") is not None:
            u_features, u_keep, inverse = resolve_features_band(
                self.index, out["band_rows"], out["band_meta"][0], self.emit
            )
        else:
            u_features, u_keep, inverse = resolve_features_compact(
                self.index, out["bits"], self.emit
            )
        keep = u_keep[inverse] & pass_
        n_kept = int(np.count_nonzero(keep))
        if n_kept == 0:
            return 0
        cbs = batch.get("cbs")
        umis = batch.get("umis")
        poss = batch.get("poss")
        gns = batch.get("gns")
        score = out["score"]
        f1 = out["r1_fwd"]
        f2 = out["r2_fwd"]

        from nimble_tpu_torch.io import native

        if native.available():
            pos_arr = (
                np.asarray(poss, dtype=np.int32) if poss is not None else None
            )
            buf = native.format_rows(
                inverse,
                keep,
                u_features,
                score,
                f1,
                f2,
                cbs=cbs,
                umis=umis,
                gns=gns,
                pos1=pos_arr[:, 0] if pos_arr is not None else None,
                pos2=pos_arr[:, 1] if pos_arr is not None else None,
            )
            self._file.write(buf)
            return n_kept

        lines = []
        for i in np.nonzero(keep)[0]:
            cb = cbs[i] if cbs is not None else ""
            umi = umis[i] if umis is not None else ""
            pos1, pos2 = poss[i] if poss is not None else ("", "")
            gn = gns[i] if gns is not None else ""
            lines.append(
                f"{_feature_str(u_features, inverse[i])}\t{score[i]}\t{cb}\t{umi}\t{cb}\t{umi}\t"
                f"{pos1}\t{pos2}\t{f1[i]}\t{f2[i]}\t{gn}\n"
            )
        self._file.write("".join(lines).encode())
        return len(lines)


def make_runner(library_path: str, output_path: str,
                group_g: Optional[int] = None) -> LibraryRunner:
    """Load a library and its index (the persisted sidecar when fresh; its
    cache key includes group_g, so group and mono indexes cache apart); the
    engine is built later, once the read width is known. group_g = 0 builds
    a mono index (no group entries), None the default group index."""
    config, data = load_library(library_path)
    index = build_index_for_library(library_path, data, config, group_g=group_g)
    emit = EmitConfig(
        group_on=bool(config.group_on),
        discard_multiple_matches=bool(config.discard_multiple_matches),
        discard_multi_hits=int(config.discard_multi_hits),
        max_hits_to_report=int(config.max_hits_to_report),
    )
    return LibraryRunner(config, index, None, emit, output_path)


def _round_len(n: int, minimum: int = 32) -> int:
    """Round a read length up to a multiple of 16 (one packed int32 word)."""
    return max(minimum, -(-int(n) // 16) * 16)


class SpanFeeder:
    """Accumulates packed read batches and carves exact dispatch spans, so
    every dispatch except the last is a full span whatever the reader's
    batch size. Per-read metadata (cbs/umis/poss/gns/names) rides along; the
    sparse N sidecar (`<mate>_nidx` row indices + `<mate>_nrows`) is offset
    on merges and rebased on slices."""

    def __init__(self, span: int, paired: bool):
        self.span = span
        self.paired = paired
        self.parts: List[dict] = []
        self.count = 0

    def add(self, pb: dict) -> List[dict]:
        self.parts.append(pb)
        self.count += pb["r1_lens"].shape[0]
        out = []
        while self.count >= self.span:
            out.append(self._take(self.span))
        return out

    def _take(self, want: int) -> dict:
        """Consume exactly `want` records from the head of parts."""
        taken: List[dict] = []
        need = want
        while need:
            p = self.parts[0]
            n = p["r1_lens"].shape[0]
            if n <= need:
                taken.append(self.parts.pop(0))
                need -= n
            else:
                taken.append(self._slice(p, 0, need))
                self.parts[0] = self._slice(p, need, n)
                need = 0
        self.count -= want
        return self._merge(taken)

    def flush(self) -> Optional[dict]:
        if self.count == 0:
            return None
        out = self._take(self.count)
        self.parts = []
        return out

    def repack_width(self, Lw: int, Lf: int):
        """Zero-pad buffered packed arrays to wider word counts (after a
        max-read-length rebuild; packing is per-read, padding is zeros)."""
        for pb in self.parts:
            for mate in ("r1", "r2") if self.paired else ("r1",):
                w = pb.get(f"{mate}_words")
                if w is not None and w.shape[1] < Lw:
                    pb[f"{mate}_words"] = np.pad(w, ((0, 0), (0, Lw - w.shape[1])))
                r = pb.get(f"{mate}_nrows")
                if r is not None and r.shape[1] < Lf:
                    pb[f"{mate}_nrows"] = np.pad(r, ((0, 0), (0, Lf - r.shape[1])))

    @staticmethod
    def _merge(parts: List[dict]) -> dict:
        if len(parts) == 1:
            return parts[0]
        out: dict = {}
        p0 = parts[0]
        offs = np.cumsum([0] + [p["r1_lens"].shape[0] for p in parts])
        for k, v in p0.items():
            if k.endswith("_nidx"):
                out[k] = np.concatenate(
                    [p[k] + o for p, o in zip(parts, offs)]
                ).astype(np.int32)
            elif isinstance(v, np.ndarray):
                out[k] = np.concatenate([p[k] for p in parts])
            elif isinstance(v, list):
                out[k] = [x for p in parts for x in p[k]]
            else:
                out[k] = v
        return out

    @staticmethod
    def _slice(pb: dict, start: int, end: int) -> dict:
        out: dict = {}
        for k, v in pb.items():
            if k.endswith("_nidx"):
                lo = int(np.searchsorted(v, start))
                hi = int(np.searchsorted(v, end))
                out[k] = (v[lo:hi] - start).astype(np.int32)
                out[k[:-5] + "_nrows"] = pb[k[:-5] + "_nrows"][lo:hi]
            elif k.endswith("_nrows"):
                pass  # handled with its _nidx
            elif isinstance(v, (np.ndarray, list)):
                out[k] = v[start:end]
            else:
                out[k] = v
        return out


def append_path_string(input_path: str, append: str) -> str:
    """Insert a suffix before the (full, possibly multi-part) extension."""
    filename = os.path.basename(input_path)
    root = filename
    ext = ""
    while True:
        root, ext2 = os.path.splitext(root)
        if ext2 == "":
            break
        ext = ext2 + ext
    return os.path.join(os.path.dirname(input_path), root + append + ext)


def _prefetch_iter(gen, depth: int = 3):
    """Drain `gen` on a daemon producer thread through a bounded queue.
    Exceptions re-raise at the consumer; an abandoned consumer sets a stop
    flag so the producer exits and `gen`'s finally (reader close) runs."""
    q = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def run():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # surfaced at the consumer
            err.append(e)
        finally:
            gen.close() if hasattr(gen, "close") else None
            try:
                q.put_nowait(sentinel)
            except queue.Full:
                pass

    threading.Thread(target=run, daemon=True, name="bam-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _make_batches(inputs: Sequence[str], is_bam: bool, batch_records: int,
                  max_len: int, num_cores: int):
    """Reader batch iterator (dicts of r1_codes/r1_lens[, r2_*][, meta]):
    native BAM with a prefetch thread, the threaded native FASTQ reader for
    num_cores > 1, else the native or python single-threaded readers."""
    from nimble_tpu_torch.io import native

    if is_bam:
        # non-regular inputs (FIFOs) go to the python reader: the native
        # open probes the BGZF signature and may reopen the path
        if native.available() and os.path.isfile(inputs[0]):
            return _prefetch_iter(
                native.iter_native_bam_batches(
                    inputs[0], batch_records=batch_records, max_len=max_len
                ),
                depth=INFLIGHT + 1,
            )
        from nimble_tpu_torch.io.bam import iter_bam_batches

        return iter_bam_batches(inputs[0], batch_records=batch_records, max_len=max_len)
    r2 = inputs[1] if len(inputs) == 2 else None
    if num_cores > 1 and native.available():
        from nimble_tpu_torch.io.threaded import ThreadedFastqReader

        return iter(ThreadedFastqReader(
            inputs[0], r2, batch_size=batch_records, max_len=max_len,
            num_threads=num_cores, prefetch=INFLIGHT + 1,
        ))
    if native.available():
        from nimble_tpu_torch.io.native import NativeFastqReader

        return iter(NativeFastqReader(inputs[0], r2, batch_size=batch_records, max_len=max_len))
    from nimble_tpu_torch.io.fastq import FastqReader

    return iter(FastqReader(inputs[0], r2, batch_size=batch_records, max_len=max_len))


def _build_engines(runners: List[LibraryRunner], device: torch.device,
                   strand_filter: str, chunk_size: Optional[int], max_len: int,
                   paired: bool, chunk_cap: Optional[int], log) -> None:
    """(Re)construct each library's engine at a given max read length; the
    run log's `engine` event says which path it took, its chunk size, its
    table bytes and its wire."""
    with log.stage("engine_build", max_len=max_len):
        for r in runners:
            r.engine = AlignEngine(
                r.index, r.config, device,
                strand_filter=strand_filter,
                chunk_size=chunk_size,
                max_len=max_len,
                paired=paired,
                chunk_cap=chunk_cap,
            )
            log.event("engine", path=r.engine.path, chunk_size=r.engine.chunk_size,
                      table_bytes=r.engine.table_bytes, wire=r.engine.wire)


def refuse_unported(mesh: str = "", resume: bool = False) -> None:
    """Raise NotImplementedError for `align` options the port has not taken
    over from the reference, naming the ROADMAP item that will."""
    if mesh:
        raise NotImplementedError("--mesh: multi-GPU align is ROADMAP Queue 1 item 8")
    if resume:
        raise NotImplementedError("--resume is not ported (ROADMAP Queue 1 item 4)")
    if os.environ.get("JAX_COORDINATOR_ADDRESS") or int(os.environ.get("NIMBLE_TPU_NUM_PROCS", "1") or 1) > 1:
        raise NotImplementedError(
            "multi-process align worlds are ROADMAP Queue 1 item 8 "
            "(unset JAX_COORDINATOR_ADDRESS / NIMBLE_TPU_NUM_PROCS)")


def align_files(
    reference: str,
    output: str,
    inputs: Sequence[str],
    device: torch.device,
    strand_filter: str = "unstranded",
    chunk_size: Optional[int] = None,
    max_len: int = 0,
    batch_records: Optional[int] = None,
    trim: str = "",
    num_cores: int = 1,
    probe: str = "group",
) -> int:
    """The `align` subcommand on `device`: 1-2 FASTQs or 1 BAM against a
    comma-separated library list, one output TSV per library. Returns a
    process exit code (nonzero on reader/engine failure).

    probe "group" (the default) probes one (k+g-1)-mer per g read windows;
    "mono" probes every k-window, the reference-faithful per-k-mer
    contract. It is threaded as group_g into the index build (0 = no group
    entries, so the engine takes the mono path), as in the reference.

    max_len <= 0 (the default) sizes the packed read width from the first
    batch's longest read (rounded up to a multiple of 16, at least 32,
    capped at 256; longer reads later trigger an engine rebuild at the wider
    size). An explicit max_len is used as-is and truncates longer reads.

    A feeder thread decodes and 2-bit packs reads (io/packing.py) into
    spans; the main thread dispatches spans to the device, keeping up to
    INFLIGHT in flight; an emission thread copies results back,
    repairs reads shorter than k+g-1 on the host (host_probe.py) and writes
    the TSV rows."""
    from nimble_tpu_torch.io.packing import pack_batch
    from nimble_tpu_torch.observability import Throughput, runlog

    from nimble_tpu_torch.align.host_probe import HostMonoProber, patch_short_reads

    if probe not in ("group", "mono"):
        raise ValueError(f"--probe must be 'group' or 'mono', got {probe!r}")
    group_g = 0 if probe == "mono" else None
    log = runlog()
    library_list = reference.split(",")
    is_bam = os.path.splitext(inputs[0])[-1].lower() == ".bam"
    paired = (len(inputs) == 2) or is_bam

    auto_len = max_len <= 0
    reader_len = max_len if not auto_len else 256

    # per-library trim overrides "<TARGET_LENGTH>:<STRICTNESS>,..." in
    # library order; a missing strictness means a hard cap (1.0). Without
    # --trim, a library's own Config trim settings apply when edited.
    trim_targets = {}
    if trim:
        for i, entry in enumerate(trim.split(",")):
            if not entry:
                continue
            parts = entry.split(":")
            strictness = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            trim_targets[i] = (int(parts[0]), strictness)

    runners: List[LibraryRunner] = []
    with log.stage("index_build", libraries=library_list):
        for lib_idx, library in enumerate(library_list):
            out_append = ""
            if len(library_list) > 1:
                out_append = "." + os.path.splitext(os.path.basename(library))[0]
            runner = make_runner(library, append_path_string(output, out_append), group_g)
            if lib_idx in trim_targets:
                runner.trim = trim_targets[lib_idx]
            elif runner.config.trim_spec() is not None:
                runner.trim = runner.config.trim_spec()
            runners.append(runner)
    for r in runners:
        r.open()

    reader_batch = batch_records or (1 << 17)
    total = 0
    tput = Throughput(log)
    failed = False
    emit_thread = None
    emitq: "queue.Queue" = queue.Queue(maxsize=INFLIGHT)
    emit_exc: List[BaseException] = []
    try:
        batches = _make_batches(inputs, is_bam, reader_batch, reader_len, num_cores)
        first = next(batches, None)
        if first is None:
            for r in runners:
                r.close()
            print(f"Aligned 0 read(-pair)s across {len(runners)} library(ies)")
            return 0
        if auto_len:
            m = int(np.max(first["r1_lens"]))
            if paired and first.get("r2_lens") is not None:
                m = max(m, int(np.max(first["r2_lens"])))
            L = min(_round_len(m), reader_len)
        else:
            L = reader_len

        _build_engines(runners, device, strand_filter, chunk_size, L, paired,
                       batch_records, log)
        span = runners[0].engine.chunk_size
        feeder = SpanFeeder(span, paired)

        def patch_short(r, out, sb):
            # group path only: rows whose shortest mate is under k+g-1 get
            # exact host mono results instead of its unmapped verdict
            group_g = r.engine.params.group_g
            if out is None or group_g < 2:
                return
            min_len = r.index.k + group_g - 1
            l1 = trimmed_lens(sb["r1_lens"], r.trim)
            l2 = trimmed_lens(sb["r2_lens"], r.trim) if paired else None
            if int(l1.min(initial=1 << 30)) >= min_len and (
                l2 is None or int(l2.min(initial=1 << 30)) >= min_len
            ):
                return  # fast path: no short reads in this span
            # rare: short reads in a gband span — densify, so the repair
            # writes mono rows in place
            if out.get("band_rows") is not None:
                Pw, W = out.pop("band_meta")
                out["bits"] = expand_band_rows_np(out.pop("band_rows"), Pw, W)
            elif out.get("ids") is not None:
                out["bits"] = ids_to_bits_np(out.pop("ids"), r.index.bitset_words)
            prober = getattr(r, "_short_prober", None)
            if prober is None:
                prober = HostMonoProber(r.index, r.config, strand_filter)
                r._short_prober = prober
            n_rows = min(len(l1), out["pass_"].shape[0])
            patched = patch_short_reads(
                prober, out, sb, l1[:n_rows],
                l2[:n_rows] if l2 is not None else None, group_g,
            )
            if patched:
                log.event("short_read_patch", rows=patched)

        def finalize(entry):
            nonlocal total
            n, handles, sb = entry
            for r, h in zip(runners, handles):
                out = r.engine.collect_async(h)
                patch_short(r, out, sb)
                r.emit_out(out, sb)
            total += n
            tput.add(n)

        def submit(sb):
            # per-runner trim applies to the lens only; windows beyond the
            # trimmed length are invalidated on the device by `inside`
            handles = []
            for r in runners:
                pb = dict(sb)
                pb["r1_lens"] = trimmed_lens(sb["r1_lens"], r.trim)
                if paired:
                    pb["r2_lens"] = trimmed_lens(sb["r2_lens"], r.trim)
                handles.append(r.engine.align_packed_async(pb))
            return handles

        def emit_worker():
            while True:
                item = emitq.get()
                try:
                    if item is None:
                        return
                    if not emit_exc:  # after a failure: drain, don't work
                        finalize(item)
                except BaseException as e:  # surfaced via qput/drain
                    emit_exc.append(e)
                finally:
                    emitq.task_done()

        emit_thread = threading.Thread(target=emit_worker, daemon=True)
        emit_thread.start()

        def qput(item):
            while True:
                if emit_exc:
                    raise emit_exc[0]
                try:
                    emitq.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def drain():
            emitq.join()
            if emit_exc:
                raise emit_exc[0]

        # reader + 2-bit packing run on their own thread, behind the
        # dispatch loop; the bounded queue caps buffered spans
        spanq: "queue.Queue" = queue.Queue(maxsize=INFLIGHT + 1)

        def feed():
            try:
                L_cur = L
                for batch in chain([first], batches):
                    m = int(np.max(batch["r1_lens"])) if batch["r1_lens"].size else 0
                    r2l = batch.get("r2_lens")
                    if paired and r2l is not None and r2l.size:
                        m = max(m, int(np.max(r2l)))
                    if m > L_cur:
                        L_cur = min(_round_len(m), reader_len)
                        feeder.repack_width((L_cur + 15) // 16, (L_cur + 31) // 32)
                        spanq.put(("rebuild", L_cur))
                    for sb in feeder.add(pack_batch(batch, L_cur)):
                        spanq.put(("span", sb))
                tail = feeder.flush()
                if tail is not None:
                    spanq.put(("span", tail))
                spanq.put(None)
            except BaseException as e:  # surface to the main thread
                spanq.put(e)

        threading.Thread(target=feed, daemon=True).start()
        while True:
            item = spanq.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            kind, payload = item
            if kind == "rebuild":
                # longer reads than the auto-sized width: drain, then rebuild
                # the engines wider (the feeder already re-padded its backlog)
                drain()
                log.event("max_len_rebuild", max_len=payload)
                _build_engines(runners, device, strand_filter, chunk_size,
                               payload, paired, batch_records, log)
            else:
                qput((payload["r1_lens"].shape[0], submit(payload), payload))
        drain()
    except Exception:
        # failures become a nonzero exit code, like the reference's
        import traceback

        traceback.print_exc()
        log.event("align_failed", total=total)
        failed = True
    finally:
        if emit_thread is not None:
            emitq.put(None)
            emit_thread.join()
        for r in runners:
            r.close()
    if failed:
        print(f"align FAILED after {total} read(-pair)s", file=sys.stderr)
        return 1
    log.event("align_done", total=total, **tput.final())
    print(f"Aligned {total} read(-pair)s across {len(runners)} library(ies)")
    return 0
