"""Host-side `align` pipeline for the port: read streaming, emission,
several libraries, checkpoint/resume and multi-process worlds.

Copied from nimble_tpu/align/pipeline.py (which cannot be imported without
jax) with what the group, gband and mono paths need, and driving the torch
engine on an explicit device. The TSV schema, set-size filters, group_on
collapse, trimming, `--probe`, the group paths' short-read repair and the
three emission routes (dense bits, gband band rows, idlist ids) are the
reference's own, so the output is byte-identical.

Several comma-separated libraries run as one engine each. With
NIMBLE_TPU_STACK=1 they run as one stacked engine instead (align/stacked.py:
one merged probe answers every library) wherever the reference stacks them:
they share one trim, k, stride and fit the stack's width, and their stacked
tables can be placed. The stack is opt-in because on the H100 it has lost
to the per-library engines on every workload measured (PERF.md, section 5):
its merged table is far larger and the libraries' tails still run once each.

Checkpoint/resume and worlds are the reference's: a progress sidecar
(`<output>.progress.json`, or `<output>.shardP.progress.json` in a world)
records the read cursor and each output's bytes after every emitted span,
and `--resume` truncates at it and continues. NIMBLE_TPU_NUM_PROCS /
NIMBLE_TPU_PROC_ID start a world of independent processes that own spans
round-robin and write headerless shards, which process 0 splices back into
reader order (_merge_shards). The port records the span in every sidecar
and shard meta, and refuses a resume or a merge whose spans differ. Under
JAX_COORDINATOR_ADDRESS (with JAX_NUM_PROCESSES and JAX_PROCESS_ID) the
processes join a torch.distributed group (parallel/dist.py:
init_distributed) that gives each its rank and the world's size, and the
world runs as that one does.

`--mesh` (parallel/mesh.py) runs every engine on a data x feature grid of
devices: each chunk's row blocks on the data rows' lead devices, the class
bitsets split over a row's devices on the feature axis. Under a coordinator
each process's mesh spans the devices that process sees.
"""
from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimble_tpu_torch.config import Config, load_library
from nimble_tpu_torch.index.builder import KmerIndex, build_index_for_library
from nimble_tpu_torch.align.engine import AlignEngine, expand_band_rows_np, ids_to_bits_np, wire_bytes
from nimble_tpu_torch.align.stacked import NotStackable, StackedEngine
from nimble_tpu_torch import observability as obs

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
# reads between two of align's stdout progress lines
PROGRESS_EVERY = 1_000_000


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
    rows, cols = _set_bits(uniq, _size_cap(emit))
    inside = cols < index.n_features  # last-word padding bits, if any
    return _resolve_classes_from_cols(index, uniq.shape[0], rows[inside], cols[inside], emit, inverse)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _size_cap(emit: EmitConfig) -> Optional[int]:
    """The most features a class may hold and pass the set-size filters;
    None under group_on, where they count the class's groups."""
    if emit.group_on:
        return None
    cap = emit.max_hits_to_report
    if emit.discard_multiple_matches:
        cap = min(cap, 1)
    if emit.discard_multi_hits > 0:
        cap = min(cap, emit.discard_multi_hits)
    return cap


def _set_bits(words: np.ndarray, cap: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(row, bit position) of every set bit of (n, w) 32-bit words, in row
    then position order, as np.nonzero of the decoded bitsets gives them.
    Only the nonzero words are expanded, and none of a row with more than
    `cap` set bits: such a row comes out empty, as the filters would drop
    its class."""
    r, w = np.nonzero(words)
    v = words[r, w].astype(np.uint32)
    if cap is not None:
        count = np.bincount(r, _POPCOUNT8[v.view(np.uint8)].reshape(-1, 4).sum(axis=1), words.shape[0])
        small = count[r] <= cap
        r, w, v = r[small], w[small], v[small]
    j, b = np.nonzero((v[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
    return r[j], w[j] * 32 + b


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
    rows, bitpos = _set_bits(uniq[:, 1:], _size_cap(emit))
    cols = (uniq[rows, 0].astype(np.int64) * (Pw * 32) + bitpos).astype(np.int32)
    inside = cols < index.n_features  # last-word padding bits, if any
    return _resolve_classes_from_cols(index, uniq.shape[0], rows[inside], cols[inside], emit, inverse)


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


def _at_rows(col, rows: np.ndarray):
    """An optional per-read column (a list or an array) at rows."""
    if col is None:
        return None
    if isinstance(col, np.ndarray):
        return col[rows]
    return [col[i] for i in rows]


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
    final_path: str = ""  # in a world: the merged destination (output_path
    # then names this process's headerless shard file)
    _file: object = None
    rows_written: int = 0
    resolved_rows: int = 0  # rows handed to the class resolver (the run log's `align_done`)

    def open(self, header: bool = True):
        self._file = open(self.output_path, "wb")
        if header:
            self._file.write(("\t".join(TSV_HEADER) + "\n").encode())

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def emit_out(self, out, batch) -> int:
        """Append this library's passing rows from host-numpy outputs (rows
        formatted natively when the native library is available).

        Only the rows with `pass_` (as the short-read patch left it) are
        resolved: a row's feature string and keep verdict depend on its own
        class alone, so the others' classes would be thrown away."""
        if out is None:
            return 0
        sel = np.flatnonzero(out["pass_"])
        if sel.size == 0:
            return 0
        with obs.span("pipeline.resolve"):
            if out.get("ids") is not None:
                u_features, u_keep, inverse = resolve_features_ids(self.index, out["ids"][sel], self.emit)
            elif out.get("band_rows") is not None:
                u_features, u_keep, inverse = resolve_features_band(
                    self.index, out["band_rows"][sel], out["band_meta"][0], self.emit
                )
            else:
                u_features, u_keep, inverse = resolve_features_compact(
                    self.index, out["bits"][sel], self.emit
                )
        self.resolved_rows += sel.size
        keep = u_keep[inverse]
        rows = sel[keep]  # the chunk's rows to write, in read order
        if rows.size == 0:
            return 0
        inverse = inverse[keep]
        cbs = _at_rows(batch.get("cbs"), rows)
        umis = _at_rows(batch.get("umis"), rows)
        poss = _at_rows(batch.get("poss"), rows)
        gns = _at_rows(batch.get("gns"), rows)
        score = out["score"][rows]
        f1 = out["r1_fwd"][rows]
        f2 = out["r2_fwd"][rows]

        from nimble_tpu_torch.io import native

        if native.available():
            pos_arr = (
                np.asarray(poss, dtype=np.int32) if poss is not None else None
            )
            buf = native.format_rows(
                inverse,
                np.ones(rows.size, dtype=bool),
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
            self.rows_written += rows.size
            return rows.size

        lines = []
        for i in range(rows.size):
            cb = cbs[i] if cbs is not None else ""
            umi = umis[i] if umis is not None else ""
            pos1, pos2 = poss[i] if poss is not None else ("", "")
            gn = gns[i] if gns is not None else ""
            lines.append(
                f"{_feature_str(u_features, inverse[i])}\t{score[i]}\t{cb}\t{umi}\t{cb}\t{umi}\t"
                f"{pos1}\t{pos2}\t{f1[i]}\t{f2[i]}\t{gn}\n"
            )
        self._file.write("".join(lines).encode())
        self.rows_written += len(lines)
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
    on merges and rebased on slices.

    A batch may arrive as a skip marker `{"skip": n}`: n records the reader
    never parsed because every span they touch belongs to another process of
    a world (io/threaded.py set_skip). A carved span that holds skipped
    records comes out as `{"skip": span}` (such a span is never this
    process's, by the skip predicate's construction), so span indices and
    read cursors stay those of a run that decoded everything."""

    def __init__(self, span: int, paired: bool):
        self.span = span
        self.paired = paired
        self.parts: List[dict] = []
        self.count = 0

    @staticmethod
    def _part_n(p: dict) -> int:
        return p["skip"] if "skip" in p else p["r1_lens"].shape[0]

    def add(self, pb: dict) -> List[dict]:
        self.parts.append(pb)
        self.count += self._part_n(pb)
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
            n = self._part_n(p)
            if n <= need:
                taken.append(self.parts.pop(0))
                need -= n
            else:
                if "skip" in p:
                    taken.append({"skip": need})
                    self.parts[0] = {"skip": n - need}
                else:
                    taken.append(self._slice(p, 0, need))
                    self.parts[0] = self._slice(p, need, n)
                need = 0
        self.count -= want
        if any("skip" in p for p in taken):
            return {"skip": want}
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
    flag so the producer exits and `gen`'s finally (reader close) runs.
    The end marker waits for room like any item: the reference drops it
    when the queue is full at the end (a consumer slower than the reader,
    as in a run whose first span waits for the card), and its consumer
    then waits forever. The producer is the `nimble-read` thread; each
    draw from `gen` is a `pipeline.read` span."""
    q = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def run():
        try:
            while True:
                with obs.span("pipeline.read"):
                    item = next(gen, sentinel)
                if item is sentinel:
                    break
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
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.2)
                    break
                except queue.Full:
                    continue

    threading.Thread(target=run, daemon=True, name="nimble-read").start()
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
    """(reader batch iterator, reader object or None). Batches are dicts of
    r1_codes/r1_lens[, r2_*][, meta]: native BAM with a prefetch thread, the
    threaded native FASTQ reader for num_cores > 1 (returned as the reader
    object too: its set_skip shards decode in a world, its stats count
    what it parsed), else the native or python single-threaded readers."""
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
            ), None
        from nimble_tpu_torch.io.bam import iter_bam_batches

        return iter_bam_batches(inputs[0], batch_records=batch_records, max_len=max_len), None
    r2 = inputs[1] if len(inputs) == 2 else None
    if num_cores > 1 and native.available():
        from nimble_tpu_torch.io.threaded import ThreadedFastqReader

        reader = ThreadedFastqReader(
            inputs[0], r2, batch_size=batch_records, max_len=max_len,
            num_threads=num_cores, prefetch=INFLIGHT + 1,
        )
        return iter(reader), reader
    if native.available():
        from nimble_tpu_torch.io.native import NativeFastqReader

        return iter(NativeFastqReader(inputs[0], r2, batch_size=batch_records, max_len=max_len)), None
    from nimble_tpu_torch.io.fastq import FastqReader

    return iter(FastqReader(inputs[0], r2, batch_size=batch_records, max_len=max_len)), None


def _slice_reader_batch(batch: dict, start: int) -> dict:
    """Tail [start:] of a reader batch dict (arrays and metadata lists),
    taken before pack_batch so the packed wire's N sidecar never needs
    rebasing."""
    return {k: v[start:] if v is not None else None for k, v in batch.items()}


def _build_engines(runners: List[LibraryRunner], device: torch.device,
                   strand_filter: str, chunk_size: Optional[int], max_len: int,
                   paired: bool, chunk_cap: Optional[int], log, mesh_plan=None) -> Optional[StackedEngine]:
    """(Re)construct the engines at a given max read length
    (pipeline.py:_build_engines): one engine per library, or, when
    NIMBLE_TPU_STACK=1 opts in, ONE stacked engine for every library where
    the reference stacks them (several libraries, one trim,
    StackedEngine.compatible, no feature-split mesh), unless their stacked
    tables cannot be placed (NotStackable, the run log's `stacked_engine`
    event with `refused`). Every engine runs on `mesh_plan` when one is
    given. The run log's `engine` event says which path each engine took,
    its chunk size, its table bytes and its wire; a stacked engine's also
    the libraries it answers; under a mesh also each shard's table bytes.
    Returns the stacked engine, or None (engines on the runners)."""
    meshed = {} if mesh_plan is None else {"mesh": [mesh_plan.n_data, mesh_plan.n_feature]}
    with log.stage("engine_build", max_len=max_len):
        stacked = None
        indexes = [r.index for r in runners]
        configs = [r.config for r in runners]
        if (len(runners) > 1 and len({r.trim for r in runners}) == 1
                and (mesh_plan is None or mesh_plan.n_feature == 1)
                and os.environ.get("NIMBLE_TPU_STACK", "") == "1"
                and StackedEngine.compatible(indexes, configs)):
            try:
                stacked = StackedEngine(indexes, configs, device, strand_filter=strand_filter,
                                        chunk_size=chunk_size, max_len=max_len, paired=paired,
                                        chunk_cap=chunk_cap, mesh=mesh_plan)
            except NotStackable as e:
                log.event("stacked_engine", n_libraries=len(runners), max_len=max_len, refused=str(e))
        if stacked is not None:
            for r in runners:
                r.engine = None
            if meshed:
                meshed["shard_table_bytes"] = stacked.shard_table_bytes
            log.event("stacked_engine", n_libraries=len(runners), group_g=stacked.group_g, max_len=max_len)
            log.event("engine", path=stacked.path, chunk_size=stacked.chunk_size,
                      table_bytes=stacked.table_bytes, wire=stacked.wire, n_libraries=len(runners), **meshed)
            return stacked
        for r in runners:
            r.engine = AlignEngine(
                r.index, r.config, device,
                strand_filter=strand_filter,
                chunk_size=chunk_size,
                max_len=max_len,
                paired=paired,
                chunk_cap=chunk_cap,
                mesh=mesh_plan,
            )
            if meshed:
                meshed["shard_table_bytes"] = r.engine.shard_table_bytes
            log.event("engine", path=r.engine.path, chunk_size=r.engine.chunk_size,
                      table_bytes=r.engine.table_bytes, wire=r.engine.wire, **meshed)
    return None


def warm_engine(index: KmerIndex, config: Config, device: torch.device, read_len: int,
                strand_filter: str = "unstranded", chunk_size: Optional[int] = None,
                paired: bool = False) -> List[str]:
    """`index --warm READ_LEN` (reference __main__.py:221-250): build the
    engine that the first `align` of reads this long would build on
    `device`, with align's arguments for the same flags (so the same path,
    the same gband sidecar next to the saved index), and run one warm span
    through it (AlignEngine.warmup). Its parts go to the run log as the
    stages `engine_build` (with the `engine` and `gband_sidecar` events),
    `warm_kernels` and `warm_step`. Returns the lines `index --warm`
    prints: the path and chunk, the strand filter and mates, table bytes,
    the kernel library (built or found), each sidecar (built or loaded)
    and the warm step's wall."""
    from nimble_tpu_torch.observability import runlog

    log = runlog()
    max_len = min(_round_len(read_len), 256)
    runner = LibraryRunner(config, index, None, None, "")  # warm emits nothing
    t0 = time.perf_counter()
    # align's own engine construction, with what the CLI's align passes it
    # (no reader batch to cap the chunk)
    _build_engines([runner], device, strand_filter, chunk_size, max_len, paired, None, log)
    build_s = time.perf_counter() - t0
    engine = runner.engine
    warm = engine.warmup()
    lines = [f"Warmed the {engine.path} engine on {device} for reads of {read_len} (max_len {engine.max_len}, "
             f"chunk {engine.chunk_size}, {strand_filter}, {'paired' if paired else 'single-end'}): "
             f"tables {engine.table_bytes} bytes, engine build {build_s:.2f} s"]
    k = warm["kernels"]
    if k is None:
        lines.append("  kernel library: none on the CPU (the plain torch versions run)")
    else:
        how = f"built in {k['build_s']:.2f} s" if k["built"] else "found"
        lines.append(f"  kernel library: {k['path']} ({how})")
    side = getattr(index, "gband_sidecar", None)
    if side is None:
        lines.append("  sidecars: none on this path")
    else:
        lost = "" if side["source"] == "loaded" or side["written"] else ", not written"
        lines.append(f"  gband sidecar: {side['path']} ({side['source']} in {side['wall_s']:.2f} s{lost})")
    lines.append(f"  warm step: {warm['step_s']:.3f} s")
    return lines


def _align_world() -> Tuple[int, int]:
    """(process_id, num_processes) of a multi-process `align`
    (pipeline.py:_align_world). Under JAX_COORDINATOR_ADDRESS the process
    joins the coordinated world first (parallel/dist.py:init_distributed),
    whose group is then authoritative (align_files destroys it when it
    ends). Without a coordinator, the NIMBLE_TPU_NUM_PROCS /
    NIMBLE_TPU_PROC_ID pair drives independent processes over a shared
    filesystem. Default: one process."""
    from nimble_tpu_torch.parallel.dist import init_distributed

    if init_distributed():
        import torch.distributed as dist

        return dist.get_rank(), dist.get_world_size()
    n = int(os.environ.get("NIMBLE_TPU_NUM_PROCS", "1") or 1)
    if n <= 1:
        return 0, 1
    pid = int(os.environ.get("NIMBLE_TPU_PROC_ID", "0") or 0)
    if not 0 <= pid < n:
        raise ValueError(f"NIMBLE_TPU_PROC_ID {pid} out of range for {n} procs")
    return pid, n


def _write_shard_meta(output: str, pid: int, span_meta, total: int, span: Optional[int]) -> None:
    """Persist this shard's span-order byte accounting and its span, then
    the `.done` sentinel (the merge barrier; written LAST so a visible
    sentinel implies a complete meta)."""
    with open(f"{output}.shard{pid}.meta.json", "w") as f:
        json.dump({"spans": span_meta, "total": total, "span": span}, f)
    with open(f"{output}.shard{pid}.done", "w"):
        pass


def _copy_bytes(src, dst, n: int) -> None:
    """Copy exactly n bytes from src to dst, 16 MiB at a time."""
    while n:
        buf = src.read(min(n, 1 << 24))
        if not buf:
            raise ValueError(f"shard {src.name} ends {n} bytes short of its meta")
        dst.write(buf)
        n -= len(buf)


def _merge_shards(output: str, final_paths: Sequence[str], world_n: int) -> int:
    """Process 0's merge: wait for every shard's `.done` sentinel on the
    shared filesystem, then splice shard files back into reader order.

    Each process owns spans round-robin by span index and its shard file
    holds its spans' rows contiguously in ascending index order, so the
    merged file (header + span byte ranges in global index order) is
    byte-identical to a single-process run. The shards must agree on the
    span and hold every span index once, or nothing is merged (ValueError).
    The copy streams. Returns the merged read total."""
    from nimble_tpu_torch.observability import runlog

    t0 = time.perf_counter()
    timeout = float(os.environ.get("NIMBLE_TPU_MERGE_TIMEOUT_S", "3600"))
    deadline = time.monotonic() + timeout
    for p in range(world_n):
        sentinel = f"{output}.shard{p}.done"
        while not os.path.exists(sentinel):
            if time.monotonic() > deadline:
                raise TimeoutError(f"merge barrier: {sentinel} never appeared")
            time.sleep(0.2)

    metas = []
    for p in range(world_n):
        with open(f"{output}.shard{p}.meta.json") as f:
            metas.append(json.load(f))
    spans = {p: m["span"] for p, m in enumerate(metas) if m.get("span") is not None}
    if len(set(spans.values())) > 1:
        raise ValueError("the world's processes disagree on the span (reads a dispatch), "
                         f"so their shards cannot be merged: {spans} by process "
                         "(give every process the same --device and --chunk-size)")
    # (span_idx, owner, bytes_by_final_path), globally ordered
    schedule = sorted((idx, p, by_lib) for p, m in enumerate(metas) for idx, by_lib in m["spans"])
    if [e[0] for e in schedule] != list(range(len(schedule))):
        raise ValueError(f"the shards' span indices are not 0..{len(schedule) - 1} once each")
    total = sum(m["total"] for m in metas)
    t_copy = time.perf_counter()
    for fp in final_paths:
        shard_files = [open(f"{fp}.shard{p}", "rb") for p in range(world_n)]
        try:
            with open(fp, "wb") as out:
                out.write(("\t".join(TSV_HEADER) + "\n").encode())
                for _idx, p, by_lib in schedule:
                    _copy_bytes(shard_files[p], out, by_lib.get(fp, 0))
        except BaseException:
            if os.path.exists(fp):
                os.remove(fp)  # no partial merged file
            raise
        finally:
            for f in shard_files:
                f.close()
    for fp in final_paths:
        for p in range(world_n):
            os.remove(f"{fp}.shard{p}")
    for p in range(world_n):
        os.remove(f"{output}.shard{p}.meta.json")
        os.remove(f"{output}.shard{p}.done")
    runlog().event("merge", barrier_s=t_copy - t0, copy_s=time.perf_counter() - t_copy,
                   bytes=sum(os.path.getsize(fp) for fp in final_paths))
    return total


def align_files(
    reference: str,
    output: str,
    inputs: Sequence[str],
    device: torch.device,
    strand_filter: str = "unstranded",
    chunk_size: Optional[int] = None,
    max_len: int = 0,
    batch_records: Optional[int] = None,
    resume: bool = False,
    trim: str = "",
    num_cores: int = 1,
    probe: str = "group",
    mesh: str = "",
) -> int:
    """The `align` subcommand on `device`: 1-2 FASTQs or 1 BAM against a
    comma-separated library list, one output TSV per library. Returns a
    process exit code (nonzero on reader/engine failure, on a refused
    resume or mesh and on a failed merge).

    mesh: an `--mesh` spec (parallel/mesh.py:align_mesh): every engine runs
    on that grid of `device`'s devices, and the run log's `mesh` event gives
    its axes. A grid larger than the visible cards exits 1, naming both
    counts, before any file is written.

    probe "group" (the default) probes one (k+g-1)-mer per g read windows;
    "mono" probes every k-window, the reference-faithful per-k-mer
    contract. It is threaded as group_g into the index build (0 = no group
    entries, so the engine takes the mono path), as in the reference.

    max_len <= 0 (the default) sizes the packed read width from the first
    batch's longest read (rounded up to a multiple of 16, at least 32,
    capped at 256; longer reads later trigger an engine rebuild at the wider
    size, the span staying fixed). An explicit max_len is used as-is and
    truncates longer reads.

    A feeder thread decodes and 2-bit packs reads (io/packing.py) into
    spans of the engine's chunk; the main thread dispatches spans to the
    device, keeping up to INFLIGHT in flight; an emission thread copies
    results back, repairs reads shorter than k+g-1 on the host
    (host_probe.py), writes the TSV rows and then the progress sidecar.

    Checkpoint/resume: after every emitted span the sidecar
    (`<output>.progress.json`) records the read cursor, each output's rows
    and bytes, and the span (atomic replace). With resume=True a run
    truncates each output at its recorded bytes, fast-forwards the reader to
    the cursor and appends; a sidecar without `reads_done` or with another
    span is refused (exit 1).

    Worlds (NIMBLE_TPU_NUM_PROCS = N, NIMBLE_TPU_PROC_ID = 0..N-1): each
    process aligns the spans it owns (span index mod N) into a headerless
    `<output>.shardP`, checkpoints to `<output>.shardP.progress.json` with
    each span's bytes, and writes its shard meta; process 0 merges the
    shards into reader order (_merge_shards), byte-identical to one
    process's run. With -c the threaded reader parses only the batches
    whose spans this process owns (set_skip). Under JAX_COORDINATOR_ADDRESS
    the world's ranks come from the coordinator (_align_world), and the
    process group is destroyed when the run ends, on error too."""
    import torch.distributed as dist

    from nimble_tpu_torch.observability import runlog
    from nimble_tpu_torch.parallel.mesh import align_mesh

    if probe not in ("group", "mono"):
        raise ValueError(f"--probe must be 'group' or 'mono', got {probe!r}")
    try:
        mesh_plan = align_mesh(mesh, device)
    except ValueError as e:
        print(f"align --mesh {mesh}: {e}", file=sys.stderr)
        return 1
    if mesh_plan is not None:
        runlog().event("mesh", n_data=mesh_plan.n_data, n_feature=mesh_plan.n_feature,
                       devices=[str(d) for d in mesh_plan.devices])
    try:
        return _align_files(reference, output, inputs, device, strand_filter, chunk_size, max_len,
                            batch_records, resume, trim, num_cores, probe, mesh_plan)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _align_files(reference: str, output: str, inputs: Sequence[str], device: torch.device,
                 strand_filter: str, chunk_size: Optional[int], max_len: int,
                 batch_records: Optional[int], resume: bool, trim: str, num_cores: int, probe: str,
                 mesh_plan) -> int:
    """align_files' run, with the mesh parsed: all of it one `align` span,
    under NIMBLE_TPU_PROFILE one torch.profiler trace on every thread. The
    counters start from zero, and their totals go to the run log when the
    run ends, failed or not."""
    obs.reset_counters()
    try:
        with obs.profile(device), obs.span("align"):
            return _align_run(reference, output, inputs, device, strand_filter, chunk_size, max_len,
                              batch_records, resume, trim, num_cores, probe, mesh_plan)
    finally:
        obs.write_counters(obs.runlog())


def _align_run(reference: str, output: str, inputs: Sequence[str], device: torch.device,
               strand_filter: str, chunk_size: Optional[int], max_len: int,
               batch_records: Optional[int], resume: bool, trim: str, num_cores: int, probe: str,
               mesh_plan) -> int:
    """The align itself. Its threads: the reader's (`nimble-read`, with
    `nimble-parse` and, on a gz of several members, `nimble-inflate`
    workers sharing -c), the feeder (`nimble-feed`: the 2-bit
    pack and the span cut), this one (dispatch) and emission
    (`nimble-emit`); each counts its busy and wait time in spans
    (observability.COUNTERS)."""
    from nimble_tpu_torch.io.packing import pack_batch

    from nimble_tpu_torch.align.host_probe import HostMonoProber, patch_short_reads

    group_g = 0 if probe == "mono" else None
    log = obs.runlog()
    world_pid, world_n = _align_world()
    if world_n > 1:
        log.event("world", pid=world_pid, n=world_n)
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
    if world_n > 1:
        # each process writes the spans it owns into a headerless shard;
        # process 0 splices them back into reader order
        for r in runners:
            r.final_path = r.output_path
            r.output_path = f"{r.output_path}.shard{world_pid}"

    # one sidecar per process: a killed process of a world resumes its own
    # spans while the other shards stand
    progress_path = output + (".progress.json" if world_n == 1 else f".shard{world_pid}.progress.json")
    reads_done = 0
    resumed_total = 0
    resumed_span = None
    resumed_spans: List = []
    if resume and os.path.exists(progress_path):
        with open(progress_path) as f:
            prog = json.load(f)
        if "reads_done" not in prog:
            print("progress sidecar predates the packed pipeline; restart without --resume",
                  file=sys.stderr)
            return 1
        reads_done = prog["reads_done"]
        resumed_total = prog.get("total_done", 0)
        resumed_span = prog.get("span")  # absent in the reference's sidecars
        resumed_spans = [(idx, by_lib) for idx, by_lib in prog.get("spans", [])]
        for r in runners:
            byte_off = prog.get("bytes_written", {}).get(r.output_path)
            if os.path.exists(r.output_path) and byte_off is not None:
                os.truncate(r.output_path, byte_off)  # drop the rows after the checkpoint
            r.rows_written = prog.get("rows_written", {}).get(r.output_path, 0)
        print(f"Resuming from read {reads_done}")
        for r in runners:
            r._file = open(r.output_path, "ab")
    else:
        for r in runners:
            r.open(header=world_n == 1)

    span = None
    checkpoints = [0, 0.0]  # sidecar writes and their seconds (the run log's `checkpoints`)
    wire = [0]  # bytes of the spans' outputs copied to the host (the run log's `align_done`)
    fast_forward_s = [0.0]  # the feeder's seconds to reach a resumed cursor

    def save_progress(done_reads, spans=None, total_done=0):
        t0 = time.perf_counter()
        offsets = {}
        for r in runners:
            r._file.flush()
            offsets[r.output_path] = r._file.tell()
        payload = {
            "reads_done": done_reads,
            "rows_written": {r.output_path: r.rows_written for r in runners},
            "bytes_written": offsets,
            "span": span,
        }
        if world_n > 1:
            payload["spans"] = spans or []
            payload["total_done"] = total_done
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, progress_path)  # atomic: a kill never leaves half a sidecar
        checkpoints[0] += 1
        checkpoints[1] += time.perf_counter() - t0

    reader_batch = batch_records or int(os.environ.get("NIMBLE_TPU_READER_BATCH", "0") or 0) or (1 << 17)
    total = resumed_total if world_n > 1 else 0
    span_meta: List[Tuple[int, Dict[str, int]]] = list(resumed_spans)
    aligned = 0  # reads this process aligned in this run
    progress = [PROGRESS_EVERY, 0, 0.0]  # the next line's reads; the last line's reads and wall
    failed = False
    reader_obj = None
    emit_thread = None
    emitq: "queue.Queue" = queue.Queue(maxsize=INFLIGHT)
    emit_exc: List[BaseException] = []
    try:
        batches, reader_obj = _make_batches(inputs, is_bam, reader_batch, reader_len, num_cores)
        with obs.span("pipeline.first_batch"):
            first = next(batches, None)
        if first is None:
            for r in runners:
                r.close()
            if os.path.exists(progress_path):
                os.remove(progress_path)
            if world_n > 1:
                _write_shard_meta(output, world_pid, [], 0, None)
                if world_pid == 0:
                    _merge_shards(output, [r.final_path for r in runners], world_n)
            print(f"Aligned 0 read(-pair)s across {len(runners)} library(ies)")
            return 0
        if auto_len:
            m = int(np.max(first["r1_lens"]))
            if paired and first.get("r2_lens") is not None:
                m = max(m, int(np.max(first["r2_lens"])))
            L = min(_round_len(m), reader_len)
        else:
            L = reader_len

        stacked = _build_engines(runners, device, strand_filter, chunk_size, L, paired,
                                 batch_records, log, mesh_plan)
        # the span stays fixed for the whole run (a rebuild to a wider read
        # length keeps it), so span indices, ownership and resume cursors
        # are those of any run with the same span
        span = stacked.chunk_size if stacked is not None else runners[0].engine.chunk_size
        if resumed_span is not None and resumed_span != span:
            raise ValueError(
                f"--resume: the progress sidecar {progress_path} was written with a span of "
                f"{resumed_span} reads, this run's span is {span} (give the same --device and "
                "--chunk-size as the interrupted run)")
        if world_n > 1 and reader_obj is not None and hasattr(reader_obj, "set_skip"):
            # decode sharding: parse only the batches that touch a span
            # this process owns (inflate and newline cutting still run in
            # every process)
            def skip_pred(r0: int, r1: int) -> bool:
                return all(s % world_n != world_pid
                           for s in range(r0 // span, max(r0, r1 - 1) // span + 1))

            reader_obj.set_skip(skip_pred)
        feeder = SpanFeeder(span, paired)

        def patch_short(r, out, sb):
            # group paths only: rows whose shortest mate is under k+g-1 get
            # exact host mono results instead of their unmapped verdict
            group_g = stacked.group_g if stacked is not None else r.engine.params.group_g
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

        def report_progress():
            # the stdout progress line: the rate since the align began and
            # since the last line
            wall = obs.counter_totals()["align"][0]
            reads0, wall0 = progress[1], progress[2]
            print(f"Processed {aligned} reads ({aligned / wall:,.0f} reads/s cumulative, "
                  f"{(aligned - reads0) / max(wall - wall0, 1e-9):,.0f} current)", flush=True)
            progress[:] = [progress[0] + PROGRESS_EVERY, aligned, wall]

        def finalize(entry):
            # the span's rows are written before its checkpoint, so the
            # sidecar only ever names spans whose bytes are complete
            nonlocal total, aligned
            reads_end, n, handles, sb, span_idx = entry
            pre = [r._file.tell() for r in runners] if world_n > 1 else None
            wire[0] += wire_bytes(handles if stacked is not None else [e for h in handles for e in h])
            with obs.span("engine.collect"):
                if stacked is not None:
                    outs = stacked.collect_async(handles) or [None] * len(runners)
                else:
                    outs = [r.engine.collect_async(h) for r, h in zip(runners, handles)]
            with obs.span("pipeline.emit"):
                for r, out in zip(runners, outs):
                    patch_short(r, out, sb)
                    r.emit_out(out, sb)
                total += n
                aligned += n
                if aligned >= progress[0]:
                    report_progress()
                if world_n > 1:
                    span_meta.append((span_idx, {r.final_path: r._file.tell() - p for r, p in zip(runners, pre)}))
                    save_progress(reads_end, spans=span_meta, total_done=total)
                else:
                    save_progress(reads_end)

        def submit(sb):
            # per-runner trim applies to the lens only; windows beyond the
            # trimmed length are invalidated on the device by `inside`. A
            # stack's libraries share one trim.
            if stacked is not None:
                pb = dict(sb)
                pb["r1_lens"] = trimmed_lens(sb["r1_lens"], runners[0].trim)
                if paired:
                    pb["r2_lens"] = trimmed_lens(sb["r2_lens"], runners[0].trim)
                return stacked.align_packed_async(pb)
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

        emit_thread = threading.Thread(target=emit_worker, daemon=True, name="nimble-emit")
        emit_thread.start()

        def qput(item):
            with obs.span("pipeline.backpressure"):
                while True:
                    if emit_exc:
                        raise emit_exc[0]
                    try:
                        emitq.put(item, timeout=0.5)
                        return
                    except queue.Full:
                        continue

        def drain():
            with obs.span("pipeline.backpressure"):
                emitq.join()
            if emit_exc:
                raise emit_exc[0]

        # the dispatch cursor; spans before a resumed cursor never dispatch
        # again, and every checkpoint but the last sits on a span boundary
        cursor = reads_done
        span_counter = reads_done // span

        def dispatch(sb):
            nonlocal cursor, span_counter
            if "skip" in sb:  # a span this process never decoded: never its own
                span_counter += 1
                cursor += sb["skip"]
                return
            n = sb["r1_lens"].shape[0]
            span_idx = span_counter
            span_counter += 1
            cursor += n
            if world_n > 1 and span_idx % world_n != world_pid:
                return  # another process owns this span
            with obs.span("engine.submit"):
                handles = submit(sb)
            qput((cursor, n, handles, sb, span_idx))

        # reader + 2-bit packing run on their own thread, behind the
        # dispatch loop; the bounded queue caps buffered spans
        spanq: "queue.Queue" = queue.Queue(maxsize=INFLIGHT + 1)

        def feed():
            try:
                to_skip = reads_done  # the resume fast-forward
                t_ff = time.perf_counter()
                L_cur = L
                reader = chain([first], batches)
                while True:
                    with obs.span("pipeline.feed_wait"):
                        batch = next(reader, None)
                    if batch is None:
                        break
                    if "skip" in batch:
                        # a decode-sharded batch: counted like real records,
                        # by the fast-forward and by the feeder
                        n = batch["skip"]
                        if to_skip >= n:
                            to_skip -= n
                            continue
                        if to_skip:
                            batch = {"skip": n - to_skip}
                            to_skip = 0
                        with obs.span("pipeline.pack"):
                            sbs = feeder.add(batch)
                        for sb in sbs:
                            spanq.put(("span", sb))
                        continue
                    n = batch["r1_lens"].shape[0]
                    if to_skip >= n:
                        to_skip -= n
                        continue
                    if to_skip:
                        batch = _slice_reader_batch(batch, to_skip)
                        to_skip = 0
                    if reads_done and not fast_forward_s[0]:
                        fast_forward_s[0] = time.perf_counter() - t_ff
                    m = int(np.max(batch["r1_lens"])) if batch["r1_lens"].size else 0
                    r2l = batch.get("r2_lens")
                    if paired and r2l is not None and r2l.size:
                        m = max(m, int(np.max(r2l)))
                    if m > L_cur:
                        L_cur = min(_round_len(m), reader_len)
                        feeder.repack_width((L_cur + 15) // 16, (L_cur + 31) // 32)
                        spanq.put(("rebuild", L_cur))
                    with obs.span("pipeline.pack"):
                        sbs = feeder.add(pack_batch(batch, L_cur))
                    for sb in sbs:
                        spanq.put(("span", sb))
                with obs.span("pipeline.pack"):
                    tail = feeder.flush()
                if tail is not None:
                    spanq.put(("span", tail))
                spanq.put(None)
            except BaseException as e:  # surface to the main thread
                spanq.put(e)

        threading.Thread(target=feed, daemon=True, name="nimble-feed").start()
        while True:
            with obs.span("pipeline.starved"):
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
                # free the old engines' tables before the new ones are built
                stacked = None
                for r in runners:
                    r.engine = None
                stacked = _build_engines(runners, device, strand_filter, chunk_size,
                                         payload, paired, batch_records, log, mesh_plan)
            else:
                dispatch(payload)
        drain()
    except Exception:
        # failures become a nonzero exit code, like the reference's; the
        # progress sidecar survives for `align --resume`
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
    if os.path.exists(progress_path):
        os.remove(progress_path)
    if world_n > 1:
        _write_shard_meta(output, world_pid, span_meta, total, span)
        if world_pid == 0:
            try:
                total = _merge_shards(output, [r.final_path for r in runners], world_n)
            except (OSError, TimeoutError, ValueError) as e:
                print(f"align: merging the world's shards failed: {e}", file=sys.stderr)
                log.event("align_merge_failed", error=str(e))
                return 1
            log.event("align_merged", total=total, world_n=world_n)
    log.event("checkpoints", n=checkpoints[0], wall_s=checkpoints[1])
    if reads_done:
        log.event("resume", reads_done=reads_done, fast_forward_s=fast_forward_s[0])
    wall = obs.counter_totals()["align"][0]
    log.event("align_done", total=total, reads=aligned, wall_s=round(wall, 3),
              reads_per_s=round(aligned / wall, 1) if wall > 0 else 0.0, wire_bytes=wire[0],
              resolved_rows=sum(r.resolved_rows for r in runners))
    rstats = getattr(reader_obj, "stats", None)
    if rstats and rstats.get("skipped_records"):
        log.event("decode_shard", **rstats)
        print(f"Decode shard: parsed {rstats['parsed_records']} skipped {rstats['skipped_records']} records")
    print(f"Aligned {total} read(-pair)s across {len(runners)} library(ies)")
    return 0
