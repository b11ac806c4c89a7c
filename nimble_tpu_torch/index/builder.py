"""K-mer index builder: library -> device-resident tensors.

Replaces the reference backend's startup-time colored de-Bruijn-graph /
k-mer index (rust-pseudoaligner lineage; reference contract:
nimble/types.py:10-32 and SURVEY §2.8) with a TPU-first layout:

  * a two-choice bucketed hash table over packed k-mer codes.  Every key
    lives in one of two buckets of BUCKET_SLOTS slots, so a device lookup is
    exactly two 8-slot bucket gathers + compares — a fixed, SIMD-friendly
    probe cost, unlike linear probing whose worst-case displacement every
    vector lane must pay.  Keys are uint64 k-mer codes split into (hi, lo)
    uint32 pairs (TPU int64 is emulated; uint32 is native).
  * an equivalence-class ("color") table: each distinct feature set gets a
    class id; the hash value of a k-mer is its class id.  Classes are stored
    both as CSR lists (host decode) and as a bitset matrix
    (n_classes, bitset_words) uint32 for the device AND-intersection.
  * optional Hamming-1 neighborhood expansion implementing
    Config.num_mismatches > 0.
  * a feature -> group mapping implementing Config.group_on.

The builder is fully numpy-vectorized (no per-k-mer Python loops): greedy
two-choice insertion runs in rounds over all unplaced keys, and equivalence
classes are identified with 4x32-bit set hashes + count + first/last feature.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from nimble_tpu_torch import seq as seqmod
from nimble_tpu_torch.config import Config, Data
from nimble_tpu_torch.index.hashing import bucket_hashes_np, mix32_np

BUCKET_SLOTS = 4
STASH_SIZE = 8
_INSERT_ROUNDS = 32


@dataclass
class KmerIndex:
    """Host-side index container; the table fields are the tensors shipped
    to the device.

    Keys are CANONICAL k-mer codes (min of forward and reverse-complement);
    every entry carries two class values so one probe answers both read
    orientations: val_same = equivalence class of features whose reference
    k-mer occurs in the canonical orientation, val_diff = class for the
    non-canonical orientation (-1 = absent). This halves probe traffic vs a
    forward-k-mer index queried twice (once per read orientation) and keeps
    inverted-repeat references exact (each orientation keeps its own class).
    """

    k: int
    n_buckets: int
    # hash table, flattened (n_buckets * BUCKET_SLOTS,)
    table_hi: np.ndarray  # uint32 canonical-code high words
    table_lo: np.ndarray  # uint32 canonical-code low words
    table_vsame: np.ndarray  # int32 class id for canonical orientation, -1 empty/absent
    table_vdiff: np.ndarray  # int32 class id for the other orientation
    # overflow stash, (STASH_SIZE,)
    stash_hi: np.ndarray
    stash_lo: np.ndarray
    stash_vsame: np.ndarray
    stash_vdiff: np.ndarray
    # equivalence classes
    class_offsets: np.ndarray  # int64 (n_classes + 1,) CSR into class_features
    class_features: np.ndarray  # int32 feature ids, sorted within class
    class_bits: np.ndarray  # uint32 (n_classes, bitset_words)
    # features / groups
    feature_names: List[str]
    group_names: List[str]
    feature_to_group: np.ndarray  # int32 (n_features,)
    group_bits_words: int  # bitset words for group space
    n_kmers: int
    # group-probe entries: one entry per distinct CANONICAL (k+g-1)-mer
    # occurring in the library, so ONE device row gather answers g read
    # windows at once (the gather is the measured per-ROW bottleneck; see
    # align/engine group-probe path). pair_vals[:, i] is the class id of the
    # i-th k-window of the canonical code; pair_vals[:, g+i] the class id of
    # the i-th k-window of its reverse complement (-1 = that window's k-mer
    # is absent from the index — possible only at library sequence ends).
    pair_g: int = 0  # windows per entry (0 = no group entries)
    pair_hi: Optional[np.ndarray] = None  # uint32 canonical code high words
    pair_lo: Optional[np.ndarray] = None  # uint32 low words
    pair_vals: Optional[np.ndarray] = None  # int32 (n_pairs, 2g) class ids

    @property
    def has_pairs(self) -> bool:
        return self.pair_g >= 2 and self.pair_hi is not None and self.pair_hi.size > 0

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def n_classes(self) -> int:
        return len(self.class_offsets) - 1

    @property
    def bitset_words(self) -> int:
        return self.class_bits.shape[1]

    def class_feature_list(self, class_id: int) -> List[int]:
        s, e = self.class_offsets[class_id], self.class_offsets[class_id + 1]
        return self.class_features[s:e].tolist()

    # ---- host oracle lookups (mirror the device probe exactly) ----
    def lookup_canonical_np(
        self, hi: np.ndarray, lo: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe CANONICAL codes: (hi, lo) uint32 -> (val_same, val_diff)
        int32 class ids (-1 for miss/absent)."""
        hi = hi.astype(np.uint32, copy=False)
        lo = lo.astype(np.uint32, copy=False)
        h1, h2 = bucket_hashes_np(hi, lo, self.n_buckets)
        vs = np.full(hi.shape, -1, dtype=np.int32)
        vd = np.full(hi.shape, -1, dtype=np.int32)
        occupied_s = self.table_vsame
        occupied_d = self.table_vdiff
        for h in (h1, h2):
            base = h.astype(np.int64) * BUCKET_SLOTS
            for s in range(BUCKET_SLOTS):
                idx = base + s
                match = (
                    (self.table_hi[idx] == hi)
                    & (self.table_lo[idx] == lo)
                    & ((occupied_s[idx] >= 0) | (occupied_d[idx] >= 0))
                )
                vs = np.where(match, occupied_s[idx], vs)
                vd = np.where(match, occupied_d[idx], vd)
        for s in range(STASH_SIZE):
            match = (
                (self.stash_hi[s] == hi)
                & (self.stash_lo[s] == lo)
                & ((self.stash_vsame[s] >= 0) | (self.stash_vdiff[s] >= 0))
            )
            vs = np.where(match, self.stash_vsame[s], vs)
            vd = np.where(match, self.stash_vdiff[s], vd)
        return vs, vd

    def lookup_np(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """Forward-orientation lookup oracle: query FORWARD k-mer codes
        (hi, lo) uint32 -> class id of the forward match (-1 miss)."""
        code = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        rc = seqmod.revcomp_kmer_u64(code, self.k)
        same = code <= rc
        canon = np.where(same, code, rc)
        vs, vd = self.lookup_canonical_np(
            (canon >> np.uint64(32)).astype(np.uint32),
            (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
        return np.where(same, vs, vd)

    def save(self, path: str, cache_key: str = "") -> None:
        pairs = {}
        if self.has_pairs:
            pairs = {
                "pair_g": np.int32(self.pair_g),
                "pair_hi": self.pair_hi,
                "pair_lo": self.pair_lo,
                "pair_vals": self.pair_vals,
            }
        np.savez_compressed(
            path,
            cache_key=np.array(cache_key),
            **pairs,
            k=self.k,
            n_buckets=self.n_buckets,
            table_hi=self.table_hi,
            table_lo=self.table_lo,
            table_vsame=self.table_vsame,
            table_vdiff=self.table_vdiff,
            stash_hi=self.stash_hi,
            stash_lo=self.stash_lo,
            stash_vsame=self.stash_vsame,
            stash_vdiff=self.stash_vdiff,
            class_offsets=self.class_offsets,
            class_features=self.class_features,
            class_bits=self.class_bits,
            feature_names=np.array(self.feature_names, dtype=object),
            group_names=np.array(self.group_names, dtype=object),
            feature_to_group=self.feature_to_group,
            group_bits_words=self.group_bits_words,
            n_kmers=self.n_kmers,
        )
        # derived-table sidecars (gband) persist next to the index file;
        # without this a FRESHLY-BUILT index (first align / index --warm)
        # had no _cache_path, so the minutes-scale gband host build was
        # thrown away and redone by the next process (observed: a 20k
        # `index --warm` + `align` pair built the same 4.6M-entry sidecar
        # twice, ~6 min each on a 2-core host)
        self._cache_path = path

    @classmethod
    def load(cls, path: str) -> "KmerIndex":
        z = np.load(path, allow_pickle=True)
        pairs = {}
        if "pair_hi" in z.files:
            pairs = {f: z[f] for f in ("pair_hi", "pair_lo", "pair_vals")}
            pairs["pair_g"] = int(z["pair_g"])
        obj = cls(
            **pairs,
            k=int(z["k"]),
            n_buckets=int(z["n_buckets"]),
            table_hi=z["table_hi"],
            table_lo=z["table_lo"],
            table_vsame=z["table_vsame"],
            table_vdiff=z["table_vdiff"],
            stash_hi=z["stash_hi"],
            stash_lo=z["stash_lo"],
            stash_vsame=z["stash_vsame"],
            stash_vdiff=z["stash_vdiff"],
            class_offsets=z["class_offsets"],
            class_features=z["class_features"],
            class_bits=z["class_bits"],
            feature_names=list(z["feature_names"]),
            group_names=list(z["group_names"]),
            feature_to_group=z["feature_to_group"],
            group_bits_words=int(z["group_bits_words"]),
            n_kmers=int(z["n_kmers"]),
        )
        # derived-table sidecars (e.g. the gband build, minutes of host
        # work at millions of entries) cache next to the index file
        obj._cache_path = path
        return obj


# bump to invalidate persisted .idx.npz caches when the index layout changes
INDEX_FORMAT_VERSION = 4  # v4: group entries default to g=6 (was 2)

# windows per group-probe entry: a (k+GROUP_G-1)-mer contains GROUP_G
# consecutive k-windows, so one device row gather answers GROUP_G windows
# (6x fewer probe rows at g=6). Measured on v5e (scripts/ablate_group3/4):
# g=6 beats g=2/3/4 at every chunk size (3.5M reads/s vs 1.7M at chunk
# 65536). Max 8 (per-window presence masks pack as four 8-bit fields in one
# int32); override via NIMBLE_TPU_GROUP_G (0 disables group entries).
GROUP_G = 6


def _group_g() -> int:
    import os

    try:
        return int(os.environ.get("NIMBLE_TPU_GROUP_G", GROUP_G))
    except ValueError:
        return GROUP_G


def _attach_group_entries(index: KmerIndex, data: Data, g: Optional[int] = None) -> KmerIndex:
    """Compute the group-probe entries for an index: one entry per distinct
    canonical (k+g-1)-mer in the library, carrying the class ids of its g
    constituent k-windows in both orientations (looked up in the k-mer table
    itself, so entries are consistent with the mono probe by construction).

    Skipped when num_mismatches > 0 (a read k-mer can then match via its
    Hamming neighborhood while the containing (k+g-1)-mer is not a library
    group — the group probe would silently lose the mismatch tolerance) and
    when the widened code would not fit 62 bits."""
    g = _group_g() if g is None else g
    k = index.k
    kg = k + g - 1
    if g < 2 or g > 8 or kg > 31:
        return index
    chunks = []
    for sequence in data.sequences:
        codes = seqmod.encode(sequence)
        gm, valid = seqmod.kmer_codes_u64(codes, kg)
        if gm.size:
            chunks.append(gm[valid])
    if not chunks:
        return index
    X = np.concatenate(chunks)
    if X.size == 0:
        return index
    rc = seqmod.revcomp_kmer_u64(X, kg)
    X = np.unique(np.minimum(X, rc))
    R = seqmod.revcomp_kmer_u64(X, kg)

    kmask = np.uint64((1 << (2 * k)) - 1)
    vals = np.empty((X.shape[0], 2 * g), dtype=np.int32)
    for i in range(g):
        # i-th k-window of a (k+g-1)-mer: drop i bases off the front and
        # g-1-i off the back (first base lives in the high bits)
        shift = np.uint64(2 * (g - 1 - i))
        for col, src in ((i, X), (g + i, R)):
            win = (src >> shift) & kmask
            vals[:, col] = index.lookup_np(
                (win >> np.uint64(32)).astype(np.uint32),
                (win & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            )
    index.pair_g = g
    index.pair_hi = (X >> np.uint64(32)).astype(np.uint32)
    index.pair_lo = (X & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    index.pair_vals = vals
    return index


def index_cache_path(library_path: str) -> str:
    return library_path + ".idx.npz"


def index_cache_key(
    library_path: str, k: Optional[int], group_g: Optional[int] = None
) -> str:
    """Cache key for a persisted index: format version + explicit-k override
    + probe grouping + content hash of the library JSON (which embeds the
    Config, so kmer_length/num_mismatches/group_on changes invalidate it)."""
    import hashlib

    g = _group_g() if group_g is None else int(group_g)
    h = hashlib.sha256()
    with open(library_path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return (
        f"v{INDEX_FORMAT_VERSION}:k={int(k or 0)}:g={g}:"
        f"{h.hexdigest()[:24]}"
    )


def build_index_for_library(
    library_path: str,
    data: Data,
    config: Optional[Config] = None,
    k: Optional[int] = None,
    cache: Optional[bool] = None,
    group_g: Optional[int] = None,
):
    """Build the device index for a library file, transparently reusing the
    persisted `<library>.idx.npz` sidecar when its cache key matches (the
    reference rebuilds its dBG index at every alignment startup — SURVEY
    §2.4; a 20k-allele library costs minutes to index, so `align` must not).
    Set cache=False or NIMBLE_TPU_NO_INDEX_CACHE=1 to force a rebuild.
    group_g: probe-grouping override (see build_index); part of the cache
    key, so group and mono indexes cache independently-validly. The run
    log's `index` event says whether the index was loaded or built."""
    import os
    import time

    from nimble_tpu_torch.observability import runlog

    t0 = time.perf_counter()
    if cache is None:
        cache = os.environ.get("NIMBLE_TPU_NO_INDEX_CACHE", "") != "1"
    key = None
    cache_path = index_cache_path(library_path)
    if cache:
        try:
            key = index_cache_key(library_path, k, group_g)
            if os.path.exists(cache_path):
                with np.load(cache_path, allow_pickle=True) as z:
                    fresh = "cache_key" in z.files and str(z["cache_key"]) == key
                if fresh:
                    index = KmerIndex.load(cache_path)
                    runlog().event("index", path=cache_path, source="loaded",
                                   wall_s=round(time.perf_counter() - t0, 4))
                    return index
        except (OSError, ValueError, KeyError):
            key = None  # unreadable library/cache: build, don't persist
    index = build_index(data, config, k=k, group_g=group_g)
    written = False
    if cache and key is not None:
        try:
            index.save(cache_path, cache_key=key)
            written = True
        except OSError:
            pass  # read-only library dir: caching is best-effort
    runlog().event("index", path=cache_path, source="built", written=written,
                   wall_s=round(time.perf_counter() - t0, 4))
    return index


def _collect_kmer_feature_pairs(
    data: Data, k: int, feature_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All (kmer code, feature id) pairs over the library's forward strands."""
    codes_list = []
    feats_list = []
    for row, sequence in enumerate(data.sequences):
        codes = seqmod.encode(sequence)
        km, valid = seqmod.kmer_codes_u64(codes, k)
        km = km[valid]
        codes_list.append(km)
        feats_list.append(np.full(km.shape[0], feature_ids[row], dtype=np.int32))
    if not codes_list:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int32)
    return np.concatenate(codes_list), np.concatenate(feats_list)


def _expand_hamming1(codes: np.ndarray, feats: np.ndarray, k: int, chunk: int = 1 << 20):
    """Hamming-1 neighborhood expansion for num_mismatches == 1: every
    reference k-mer also maps its 3k single-base variants to its feature.
    XOR with a nonzero 2-bit delta at a position enumerates exactly the other
    three bases there."""
    out_codes = [codes]
    out_feats = [feats]
    deltas = np.array([1, 2, 3], dtype=np.uint64)
    for start in range(0, codes.shape[0], chunk):
        c = codes[start : start + chunk]
        f = feats[start : start + chunk]
        for pos in range(k):
            variants = c[:, None] ^ (deltas[None, :] << np.uint64(2 * pos))
            out_codes.append(variants.reshape(-1))
            out_feats.append(np.repeat(f, 3))
    return np.concatenate(out_codes), np.concatenate(out_feats)


# Hamming-2 expansion multiplies entries by 1 + 3k + 9*C(k,2) (~1900x at
# k=21); refuse to build tables beyond this bound rather than thrash
HAMMING2_MAX_ENTRIES = 1 << 28


def _expand_hamming2(codes: np.ndarray, feats: np.ndarray, k: int, chunk: int = 1 << 14):
    """Hamming-<=2 neighborhood expansion for num_mismatches == 2: every
    reference k-mer also maps all single- and double-base variants to its
    feature. Entry count is guarded by HAMMING2_MAX_ENTRIES (the caller
    raises a clear error instead of an OOM; reference contract:
    nimble/types.py:14 exposes num_mismatches as a free integer, but the
    backend's cost there is the same combinatorial blowup)."""
    n = codes.shape[0]
    per = 1 + 3 * k + 9 * (k * (k - 1) // 2)
    if n * per > HAMMING2_MAX_ENTRIES:
        raise ValueError(
            f"num_mismatches=2 expansion needs {n * per:,} index entries for "
            f"{n:,} k-mers at k={k} (limit {HAMMING2_MAX_ENTRIES:,}); use a "
            "smaller library/k or num_mismatches<=1"
        )
    deltas = np.array([1, 2, 3], dtype=np.uint64)
    pair_xors = []
    for p1 in range(k):
        for p2 in range(p1 + 1, k):
            a = deltas << np.uint64(2 * p1)
            b = deltas << np.uint64(2 * p2)
            pair_xors.append((a[:, None] ^ b[None, :]).reshape(-1))
    pair_xors = np.concatenate(pair_xors)  # 9*C(k,2) masks

    codes1, feats1 = _expand_hamming1(codes, feats, k)
    out_codes = [codes1]
    out_feats = [feats1]
    for start in range(0, n, chunk):
        c = codes[start : start + chunk]
        f = feats[start : start + chunk]
        variants = c[:, None] ^ pair_xors[None, :]
        out_codes.append(variants.reshape(-1))
        out_feats.append(np.repeat(f, pair_xors.shape[0]))
    return np.concatenate(out_codes), np.concatenate(out_feats)


def _assign_classes(
    sorted_codes: np.ndarray, sorted_feats: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group (code, feature) pairs (sorted+deduped by (code, feature)) into
    unique codes and equivalence classes.

    Returns (unique_codes, class_id_per_code, class_offsets, class_features).
    Class identity uses 4 independent 32-bit set hashes + (count, first, last)
    — effectively a 128-bit fingerprint of the feature set, collision-safe for
    non-adversarial input.
    """
    n = sorted_codes.shape[0]
    if n == 0:
        return (
            np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=np.int32),
            np.zeros(1, dtype=np.int64),
            np.zeros(0, dtype=np.int32),
        )
    new_code = np.empty(n, dtype=bool)
    new_code[0] = True
    new_code[1:] = sorted_codes[1:] != sorted_codes[:-1]
    starts = np.flatnonzero(new_code)
    unique_codes = sorted_codes[starts]
    counts = np.diff(np.append(starts, n))

    fu = sorted_feats.astype(np.uint32)
    # two independent 32-bit set hashes + count + first + last feature:
    # ~96 bits of fingerprint, collision-safe for non-adversarial input
    salts = (0xA511E9B3, 0xC90FDAA2)
    sig = [counts.astype(np.uint32)]
    for salt in salts:
        h = mix32_np(fu ^ np.uint32(salt), fu)
        # order-independent set hash: wrap-around sum within each code group
        cs = np.concatenate((np.zeros(1, dtype=np.uint64), np.cumsum(h, dtype=np.uint64)))
        group_sums = cs[np.append(starts[1:], n)] - cs[starts]
        sig.append((group_sums & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    sig.append(sorted_feats[starts].astype(np.uint32))  # first feature
    sig.append(sorted_feats[np.append(starts[1:], n) - 1].astype(np.uint32))  # last

    fingerprint = np.stack(sig, axis=1)
    _, rep_idx, class_of_code = np.unique(
        fingerprint, axis=0, return_index=True, return_inverse=True
    )
    class_of_code = class_of_code.astype(np.int32)

    # CSR from one representative code per class
    rep_starts = starts[rep_idx]
    rep_counts = counts[rep_idx]
    n_classes = rep_idx.shape[0]
    class_offsets = np.zeros(n_classes + 1, dtype=np.int64)
    np.cumsum(rep_counts, out=class_offsets[1:])
    gather = rep_starts.repeat(rep_counts) + (
        np.arange(class_offsets[-1]) - class_offsets[:-1].repeat(rep_counts)
    )
    class_features = sorted_feats[gather]
    return unique_codes, class_of_code, class_offsets, class_features


def _build_hash_table(
    hi: np.ndarray, lo: np.ndarray, vsame: np.ndarray, vdiff: np.ndarray, n_buckets: int
):
    """Greedy two-choice insertion, vectorized in rounds. Returns table
    arrays + stash arrays; raises if the stash overflows (caller grows the
    table and retries)."""
    n_slots = n_buckets * BUCKET_SLOTS
    table_hi = np.zeros(n_slots, dtype=np.uint32)
    table_lo = np.zeros(n_slots, dtype=np.uint32)
    table_vsame = np.full(n_slots, -1, dtype=np.int32)
    table_vdiff = np.full(n_slots, -1, dtype=np.int32)
    loads = np.zeros(n_buckets, dtype=np.int32)

    h1, h2 = bucket_hashes_np(hi, lo, n_buckets)
    pending = np.arange(hi.shape[0])

    for _ in range(_INSERT_ROUNDS):
        if pending.size == 0:
            break
        p_h1 = h1[pending]
        p_h2 = h2[pending]
        l1 = loads[p_h1]
        l2 = loads[p_h2]
        target = np.where(l1 <= l2, p_h1, p_h2).astype(np.int64)

        order = np.argsort(target, kind="stable")
        t_sorted = target[order]
        boundary = np.empty(t_sorted.shape[0], dtype=bool)
        if t_sorted.size:
            boundary[0] = True
            boundary[1:] = t_sorted[1:] != t_sorted[:-1]
        group_id = np.cumsum(boundary) - 1
        group_start = np.flatnonzero(boundary)
        rank = np.arange(t_sorted.shape[0]) - group_start[group_id]

        slot_in_bucket = loads[t_sorted] + rank
        ok = slot_in_bucket < BUCKET_SLOTS
        keys = pending[order[ok]]
        slots = t_sorted[ok] * BUCKET_SLOTS + slot_in_bucket[ok]
        table_hi[slots] = hi[keys]
        table_lo[slots] = lo[keys]
        table_vsame[slots] = vsame[keys]
        table_vdiff[slots] = vdiff[keys]
        np.add.at(loads, t_sorted[ok], 1)
        pending = pending[order[~ok]]

    stash_hi = np.zeros(STASH_SIZE, dtype=np.uint32)
    stash_lo = np.zeros(STASH_SIZE, dtype=np.uint32)
    stash_vsame = np.full(STASH_SIZE, -1, dtype=np.int32)
    stash_vdiff = np.full(STASH_SIZE, -1, dtype=np.int32)
    if pending.size > STASH_SIZE:
        raise RuntimeError(f"hash table overflow: {pending.size} unplaced keys")
    if pending.size:
        stash_hi[: pending.size] = hi[pending]
        stash_lo[: pending.size] = lo[pending]
        stash_vsame[: pending.size] = vsame[pending]
        stash_vdiff[: pending.size] = vdiff[pending]
    return (
        table_hi,
        table_lo,
        table_vsame,
        table_vdiff,
        stash_hi,
        stash_lo,
        stash_vsame,
        stash_vdiff,
    )


def _class_bitsets(class_offsets, class_features, n_features: int) -> np.ndarray:
    words = max(1, -(-n_features // 32))
    n_classes = class_offsets.shape[0] - 1
    bits = np.zeros((n_classes, words), dtype=np.uint32)
    class_ids = np.repeat(np.arange(n_classes), np.diff(class_offsets))
    flat = bits.reshape(-1)
    np.bitwise_or.at(
        flat,
        class_ids * words + (class_features >> 5),
        (np.uint32(1) << (class_features & 31).astype(np.uint32)),
    )
    return flat.reshape(n_classes, words)


def _group_mapping(config, data, names, feature_ids, feature_names):
    """Config.group_on -> (group_names, feature_to_group int32)."""
    n_features = len(feature_names)
    if config.group_on:
        if config.group_on not in data.headers:
            raise ValueError(
                f"group_on column {config.group_on!r} not found in library headers"
            )
        col = data.column(config.group_on)
        group_names: List[str] = []
        group_to_gid = {}
        feature_to_group = np.zeros(n_features, dtype=np.int32)
        for i, name in enumerate(names):
            gname = col[i]
            gid = group_to_gid.get(gname)
            if gid is None:
                gid = len(group_names)
                group_to_gid[gname] = gid
                group_names.append(gname)
            feature_to_group[feature_ids[i]] = gid
    else:
        group_names = list(feature_names)
        feature_to_group = np.arange(n_features, dtype=np.int32)
    return group_names, feature_to_group


def build_index(
    data: Data,
    config: Optional[Config] = None,
    k: Optional[int] = None,
    use_native: Optional[bool] = None,
    group_g: Optional[int] = None,
) -> KmerIndex:
    """Build the full device index from a library's Data + Config.

    Dispatches to the native C++ builder (index/native.py) when available —
    semantics-equivalent, minutes -> seconds on large libraries; class
    numbering may differ from the numpy build. use_native=False (or env
    NIMBLE_TPU_NO_NATIVE_INDEX=1) forces the pure-numpy path.

    group_g: explicit probe-grouping override — 0 builds a mono (per-k-mer)
    probe index, >=2 a g-window group index; None defers to
    NIMBLE_TPU_GROUP_G / the GROUP_G default (the `align --probe` flag
    threads through here)."""
    import os

    if use_native is None:
        use_native = os.environ.get("NIMBLE_TPU_NO_NATIVE_INDEX", "") != "1"
    if (config or Config()).num_mismatches > 1:
        use_native = False  # the C++ builder implements Hamming-1 only
    index = None
    if use_native:
        try:
            from nimble_tpu_torch.index.native import build_index_native

            index = build_index_native(data, config, k)
        except RuntimeError:
            pass  # no toolchain / stale .so: fall back to numpy
    if index is None:
        index = _build_index_numpy(data, config, k)
    if (config or Config()).num_mismatches == 0:
        index = _attach_group_entries(index, data, g=group_g)
    return index


def _build_index_numpy(
    data: Data, config: Optional[Config] = None, k: Optional[int] = None
) -> KmerIndex:
    """Pure-numpy reference implementation of the index build."""
    config = config or Config()
    k = int(k or config.kmer_length)
    if not (1 <= k <= 31):
        raise ValueError(f"kmer_length must be in [1, 31], got {k}")

    # feature ids: one per distinct sequence_name, in first-occurrence order
    names = data.sequence_names
    feature_names: List[str] = []
    name_to_fid = {}
    feature_ids = np.empty(len(names), dtype=np.int32)
    for i, name in enumerate(names):
        fid = name_to_fid.get(name)
        if fid is None:
            fid = len(feature_names)
            name_to_fid[name] = fid
            feature_names.append(name)
        feature_ids[i] = fid
    n_features = len(feature_names)

    codes, feats = _collect_kmer_feature_pairs(data, k, feature_ids)
    if config.num_mismatches == 1:
        codes, feats = _expand_hamming1(codes, feats, k)
    elif config.num_mismatches == 2:
        codes, feats = _expand_hamming2(codes, feats, k)
    elif config.num_mismatches > 2:
        raise ValueError(
            f"num_mismatches={config.num_mismatches} is not supported "
            "(Hamming expansion beyond 2 is combinatorially infeasible at "
            "library scale); use num_mismatches in [0, 2]"
        )

    # canonicalize: key = canonical code, strand bit = whether the reference
    # k-mer was NOT in canonical orientation. augmented = canon*2 + strand
    # fits in 64 bits for k <= 31 (2k+1 <= 63 bits).
    if codes.size:
        rc = seqmod.revcomp_kmer_u64(codes, k)
        same = codes <= rc
        canon = np.where(same, codes, rc)
        codes = (canon << np.uint64(1)) | (~same).astype(np.uint64)

    # unique (augmented code, feature) pairs, sorted by (code, feature)
    if codes.size:
        order = np.lexsort((feats, codes))
        codes = codes[order]
        feats = feats[order]
        keep = np.empty(codes.shape[0], dtype=bool)
        keep[0] = True
        keep[1:] = (codes[1:] != codes[:-1]) | (feats[1:] != feats[:-1])
        codes = codes[keep]
        feats = feats[keep]

    aug_codes, class_of_aug, class_offsets, class_features = _assign_classes(
        codes, feats
    )

    # merge strand pairs: one table entry per canonical code with
    # (val_same, val_diff)
    canon_codes_all = aug_codes >> np.uint64(1)
    strand_all = (aug_codes & np.uint64(1)).astype(np.int32)
    if canon_codes_all.size:
        new_canon = np.empty(canon_codes_all.shape[0], dtype=bool)
        new_canon[0] = True
        new_canon[1:] = canon_codes_all[1:] != canon_codes_all[:-1]
        entry_idx = np.cumsum(new_canon) - 1
        n_entries = int(entry_idx[-1]) + 1
        unique_canon = canon_codes_all[np.flatnonzero(new_canon)]
        vsame = np.full(n_entries, -1, dtype=np.int32)
        vdiff = np.full(n_entries, -1, dtype=np.int32)
        is_same = strand_all == 0
        vsame[entry_idx[is_same]] = class_of_aug[is_same]
        vdiff[entry_idx[~is_same]] = class_of_aug[~is_same]
    else:
        unique_canon = np.zeros(0, dtype=np.uint64)
        vsame = np.zeros(0, dtype=np.int32)
        vdiff = np.zeros(0, dtype=np.int32)
    n_kmers = unique_canon.shape[0]

    # table sizing: slots >= 2x keys (load <= 0.5), power-of-two buckets
    min_buckets = max(1, -(-n_kmers * 2 // BUCKET_SLOTS))
    n_buckets = 1 << max(1, int(np.ceil(np.log2(min_buckets))))

    hi = (unique_canon >> np.uint64(32)).astype(np.uint32)
    lo = (unique_canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    while True:
        try:
            tables = _build_hash_table(hi, lo, vsame, vdiff, n_buckets)
            break
        except RuntimeError:
            n_buckets *= 2

    class_bits = _class_bitsets(class_offsets, class_features, n_features)
    group_names, feature_to_group = _group_mapping(
        config, data, names, feature_ids, feature_names
    )

    return KmerIndex(
        k=k,
        n_buckets=n_buckets,
        table_hi=tables[0],
        table_lo=tables[1],
        table_vsame=tables[2],
        table_vdiff=tables[3],
        stash_hi=tables[4],
        stash_lo=tables[5],
        stash_vsame=tables[6],
        stash_vdiff=tables[7],
        class_offsets=class_offsets,
        class_features=class_features,
        class_bits=class_bits,
        feature_names=feature_names,
        group_names=group_names,
        feature_to_group=feature_to_group,
        group_bits_words=max(1, -(-len(group_names) // 32)),
        n_kmers=n_kmers,
    )
