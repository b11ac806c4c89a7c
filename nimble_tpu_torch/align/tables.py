"""Device tables of the align paths: nimble_tpu/align/engine.py:
_device_tables, every branch, as a dict of int32 tensors.

The builders below are numpy copies of engine.py's `_single_hash_placement`,
`_group_entry_payload`, `_build_group_tables`, `_build_mono_tables`, the
two-choice bucket of `_device_tables` (with inline bitsets for W <= 16,
without them for W > 16), `_build_class_bands(_robust)`, `_np_band_combine`,
`_build_groupband_tables`, `_build_groupcls_tables` and
`_build_monocls_tables`, with the same constants, so that every key lands in
the same bucket and slot as in the reference (the reference module cannot be
imported without jax). Each builder returns the reference's own keys as
numpy arrays; `tables_from_reference` turns them into the port's tensors.
One path's tables are shipped, never the arrays it does not read (the
two-choice bucket beside a mono, group, gband, groupcls or monocls table;
`class_bits` where no class-id intersection runs); the bitset width W is
read off the stash planes or `class_bits`, or carried as a plain int
(`gband_words`, `class_words`) where the step reads only bands
(`table_words`).

Wide paths (W > 16), chosen as `_device_tables` chooses them: with the group
probe, gband, else groupcls (class ids per probe row, the runs-compacted
intersection over `class_bits`); without it, or when neither group table can
be placed, monocls (a single-hash class-id table), else the two-choice
class-id bucket. On those two the class bitsets ship as `class_bits`, or,
where every class fits a 2-page band (`build_class_bands`, strict), as the
band rows re-laid like the gband table (`class_page`, `class_band`) with W
as `class_words`.

Group bucket row layout (S = MONO_SLOTS slots):
  [hi x S | lo x S | vs_and (W, S) | vd_and (W, S) | mask x S]
Mono bucket row layout, on the host (planar, slot-minor, the reference's):
  [hi x S | lo x S | vs_bits (W, S) | vd_bits (W, S)]
and as shipped (`relayout_mono`: slot-major, the mono_probe kernel's):
  [hi x S | lo x S | slot 0: vs_bits (W), vd_bits (W) | slot 1: ... ]
with its stash shipped as one (n_stash, 2 + 2W) matrix of
  [hi | lo | vs_bits (W) | vd_bits (W)] rows (`mono_stash`).
Two-choice inline bucket row layout (S = BUCKET_SLOTS slots):
  [hi x S | lo x S | vsame x S | vdiff x S | vs_bits (S, W) | vd_bits (S, W)]
Gband (wide, W > 16) tables, single-hash and dense:
  gband_bucket probe rows [hi x S | lo x S | w0 x S | w1 x S] (packed: w0 =
  idx_s | vs<<18 | vd<<24, w1 = idx_d | rvs<<18 | rvd<<24) or, with 2^18 or
  more band rows or g > 6, [hi x S | lo x S | idx_s x S | idx_d x S |
  mask x S]; gband_table half rows [page | band (2 Pw)], one per distinct
  pre-ANDed (k+g-1)-mer payload and orientation; the stash as five planes.
  The table is shipped re-laid (`relayout_gband`, the band_tree_expand
  kernel's): a page vector `gband_page` (n_rows,) and the band rows
  `gband_band` (n_rows, 2 Pw), 256 bytes each at Pw = 32.
Groupcls bucket row layout (wide): [hi x S | lo x S | cls cols (2g, S) |
  mask x S], the g windows' class ids of the canonical code (vs) then of
  its reverse complement (vd), -1 where absent.
Monocls bucket row layout (wide): [hi x S | lo x S | vs x S | vd x S].
Two-choice class-id bucket (wide, S = BUCKET_SLOTS): [hi x S | lo x S |
  vsame x S | vdiff x S], with the index's own stash planes.
"""
from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from nimble_tpu_torch.index.builder import BUCKET_SLOTS, KmerIndex
from nimble_tpu_torch.index.hashing import bucket_hashes_np
from nimble_tpu_torch.observability import runlog

MONO_SLOTS = 4
# the byte cap of every single-hash placement (group, mono, gband, groupcls,
# monocls), read at import as the reference reads it (engine.py:115)
MONO_MAX_BYTES = int(os.environ.get("NIMBLE_TPU_MONO_MAX_BYTES", 6 << 30))
MONO_MAX_STASH = 64
MONO_TIGHT_STASH = 8
GROUP_MAX_WORDS = 8
INLINE_BITS_MAX_WORDS = 16  # up to 512 features

GROUP_KEYS = (
    "group_bucket",
    "group_stash_hi",
    "group_stash_lo",
    "group_stash_vs_and",
    "group_stash_vd_and",
    "group_stash_mask",
)
# the reference's mono keys; the port ships the four stash planes as one
# `mono_stash` matrix, the layout the mono_probe kernel reads
MONO_KEYS = (
    "mono_bucket",
    "mono_stash_hi",
    "mono_stash_lo",
    "mono_stash_vs_bits",
    "mono_stash_vd_bits",
)
INLINE_KEYS = ("bucket", "stash_hi", "stash_lo", "stash_vs_bits", "stash_vd_bits")
GROUPCLS_KEYS = (
    "groupcls_bucket",
    "groupcls_stash_hi",
    "groupcls_stash_lo",
    "groupcls_stash_cols",
    "groupcls_stash_mask",
)
MCLS_KEYS = ("mcls_bucket", "mcls_stash_hi", "mcls_stash_lo", "mcls_stash_vs", "mcls_stash_vd")
# the wide two-choice probe: the class-id bucket and the index's stash
CLASSES_KEYS = ("bucket", "stash_hi", "stash_lo", "stash_vsame", "stash_vdiff")

# classes allowed to exceed the page span before robust banding gives up
BAND_OUTLIER_CAP = 64
# working-set budget of the gband build's blocked pre-AND (bytes of one
# (block, Wb) int32 plane); tests shrink it to force the multi-block path
GBAND_PREAND_BLOCK_BYTES = 128 << 20
# the persisted sidecar's layout version, shared with the reference
GBAND_FORMAT_VERSION = 3
GBAND_KEYS = (
    "gband_bucket",
    "gband_table",
    "gband_stash_hi",
    "gband_stash_lo",
    "gband_stash_idx_s",
    "gband_stash_idx_d",
    "gband_stash_mask",
)


def table_words(tables: Dict[str, torch.Tensor]) -> int:
    """Bitset width W of a table set of any path."""
    for k in ("gband_words", "class_words"):
        if k in tables:
            return int(tables[k])
    if "group_stash_vs_and" in tables:
        return int(tables["group_stash_vs_and"].shape[1])
    if "mono_stash" in tables:
        return (int(tables["mono_stash"].shape[1]) - 2) // 2
    if "class_bits" in tables:
        return int(tables["class_bits"].shape[1])
    return int(tables["stash_vs_bits"].shape[1])


def _bits_of(index: KmerIndex):
    W = index.bitset_words
    class_bits_i32 = index.class_bits.view(np.int32)

    def bits_of(vals: np.ndarray) -> np.ndarray:
        out = np.zeros((vals.shape[0], W), dtype=np.int32)
        occ = vals >= 0
        out[occ] = class_bits_i32[vals[occ]]
        return out

    return bits_of


def _occupied_entries(index: KmerIndex):
    """The index's occupied canonical entries, two-choice table then stash:
    (hi, lo, vs, vd), vs / vd the class ids of the canonical code and of
    its reverse complement (-1 = absent)."""
    occ = (index.table_vsame >= 0) | (index.table_vdiff >= 0)
    socc = (index.stash_vsame >= 0) | (index.stash_vdiff >= 0)
    hi = np.concatenate([index.table_hi[occ], index.stash_hi[socc]])
    lo = np.concatenate([index.table_lo[occ], index.stash_lo[socc]])
    vs = np.concatenate([index.table_vsame[occ], index.stash_vsame[socc]])
    vd = np.concatenate([index.table_vdiff[occ], index.stash_vdiff[socc]])
    return hi, lo, vs, vd


def _single_hash_placement(hi: np.ndarray, lo: np.ndarray, entry_words: int, slots: int):
    """engine.py:_single_hash_placement — grow-until-tight single-hash
    placement. Returns None (infeasible under MONO_MAX_BYTES/MONO_MAX_STASH)
    or (nb2, bucket_ids, slot_ids, placed_keys, stash_keys)."""
    n = hi.shape[0]
    best = None
    for extra in (1, 2, 3, 4, 5, 6):
        nb2 = 1 << max(1, int(np.ceil(np.log2(n))) + extra)
        if nb2 * slots * entry_words * 4 > MONO_MAX_BYTES:
            break
        h, _ = bucket_hashes_np(hi, lo, nb2)
        order = np.argsort(h, kind="stable")
        h_sorted = h[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        boundary[1:] = h_sorted[1:] != h_sorted[:-1]
        start = np.flatnonzero(boundary)
        group = np.cumsum(boundary) - 1
        rank = np.arange(n) - start[group]
        placed = rank < slots
        n_over = int((~placed).sum())
        if best is None or n_over < best[0]:
            best = (n_over, nb2, h_sorted, order, rank, placed)
        if n_over <= MONO_TIGHT_STASH:
            break
    if best is None or best[0] > MONO_MAX_STASH:
        return None
    _, nb2, h_sorted, order, rank, placed = best
    return (
        nb2,
        h_sorted[placed].astype(np.int64),
        rank[placed].astype(np.int64),
        order[placed],
        order[~placed],
    )


def _group_entry_payload(index: KmerIndex, bits_of):
    """engine.py:_group_entry_payload — per pair-entry (vs_and, vd_and,
    mask_word): the g windows' class bitsets pre-ANDed per orientation and
    the packed 4 x g-bit presence mask."""
    g = index.pair_g
    W = index.bitset_words
    vals = index.pair_vals
    n = index.pair_hi.shape[0]

    def and_mask(cols):
        acc = np.full((n, W), -1, dtype=np.int32)
        mask = np.zeros(n, dtype=np.int32)
        for i in range(cols.shape[1]):
            present = cols[:, i] >= 0
            cbits = bits_of(cols[:, i])
            acc[present] &= cbits[present]
            mask |= present.astype(np.int32) << i
        return acc, mask

    vs_and, vs_mask = and_mask(vals[:, :g])
    vd_and, vd_mask = and_mask(vals[:, g:])
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)
    return vs_and, vd_and, mask_word


def build_group_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_group_tables as numpy arrays. None when the index
    has no group entries, g > 8, or placement blows its budget."""
    if not index.has_pairs:
        return None
    g = index.pair_g
    W = index.bitset_words
    hi = index.pair_hi
    lo = index.pair_lo
    if g > 8:
        return None
    entry = 2 + 2 * W + 1
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement
    vs_and, vd_and, mask_word = _group_entry_payload(index, _bits_of(index))

    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for w in range(W):
        table[b, 2 * S + w * S + s] = vs_and[keys, w]
        table[b, 2 * S + W * S + w * S + s] = vd_and[keys, w]
    table[b, 2 * S + 2 * W * S + s] = mask_word[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "vs_and": np.zeros((pad, W), dtype=np.int32),
        "vd_and": np.zeros((pad, W), dtype=np.int32),
        "mask": np.zeros(pad, dtype=np.int32),
    }
    if n_stash:
        gs["hi"][:n_stash] = hi[skeys].view(np.int32)
        gs["lo"][:n_stash] = lo[skeys].view(np.int32)
        gs["vs_and"][:n_stash] = vs_and[skeys]
        gs["vd_and"][:n_stash] = vd_and[skeys]
        gs["mask"][:n_stash] = mask_word[skeys]
    return {
        "group_bucket": table,
        "group_stash_hi": gs["hi"],
        "group_stash_lo": gs["lo"],
        "group_stash_vs_and": gs["vs_and"],
        "group_stash_vd_and": gs["vd_and"],
        "group_stash_mask": gs["mask"],
    }


def build_mono_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_mono_tables as numpy arrays: every occupied
    two-choice entry reinserted by h1 into single-hash buckets of MONO_SLOTS
    slots. None when the index is empty or placement blows its budget."""
    W = index.bitset_words
    hi, lo, vs, vd = _occupied_entries(index)
    if hi.shape[0] == 0:
        return None
    entry = 2 + 2 * W
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement
    bits_of = _bits_of(index)
    vs_bits = bits_of(vs)
    vd_bits = bits_of(vd)

    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel: canonical hi < 2^30 never matches
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for w in range(W):
        table[b, 2 * S + w * S + s] = vs_bits[keys, w]
        table[b, 2 * S + W * S + w * S + s] = vd_bits[keys, w]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    ms_hi = np.full(pad, -1, dtype=np.int32)  # padding rows can never match
    ms_lo = np.zeros(pad, dtype=np.int32)
    ms_vsb = np.zeros((pad, W), dtype=np.int32)
    ms_vdb = np.zeros((pad, W), dtype=np.int32)
    if n_stash:
        ms_hi[:n_stash] = hi[skeys].view(np.int32)
        ms_lo[:n_stash] = lo[skeys].view(np.int32)
        ms_vsb[:n_stash] = vs_bits[skeys]
        ms_vdb[:n_stash] = vd_bits[skeys]
    return {
        "mono_bucket": table,
        "mono_stash_hi": ms_hi,
        "mono_stash_lo": ms_lo,
        "mono_stash_vs_bits": ms_vsb,
        "mono_stash_vd_bits": ms_vdb,
    }


def _two_choice_bucket(index: KmerIndex, extra: int) -> np.ndarray:
    """The index's two-choice table as (n_buckets, 4S + extra) rows
    [hi x S | lo x S | vsame x S | vdiff x S | extra words, unset]."""
    nb = index.n_buckets
    S = BUCKET_SLOTS
    packed = np.empty((nb, 4 * S + extra), dtype=np.int32)
    packed[:, 0:S] = index.table_hi.reshape(nb, S).view(np.int32)
    packed[:, S : 2 * S] = index.table_lo.reshape(nb, S).view(np.int32)
    packed[:, 2 * S : 3 * S] = index.table_vsame.reshape(nb, S)
    packed[:, 3 * S : 4 * S] = index.table_vdiff.reshape(nb, S)
    return packed


def build_inline_tables(index: KmerIndex) -> Dict[str, np.ndarray]:
    """The two-choice inline bucket of engine.py:_device_tables (W <= 16)
    and its stash bitsets, as numpy arrays: the fallback when mono
    placement is infeasible."""
    nb = index.n_buckets
    S = BUCKET_SLOTS
    W = index.bitset_words
    bits_of = _bits_of(index)
    packed = _two_choice_bucket(index, 2 * S * W)
    packed[:, 4 * S : 4 * S + S * W] = bits_of(index.table_vsame).reshape(nb, S * W)
    packed[:, 4 * S + S * W :] = bits_of(index.table_vdiff).reshape(nb, S * W)
    return {
        "bucket": packed,
        "stash_hi": index.stash_hi.view(np.int32),
        "stash_lo": index.stash_lo.view(np.int32),
        "stash_vs_bits": bits_of(index.stash_vsame),
        "stash_vd_bits": bits_of(index.stash_vdiff),
    }


def build_classes_tables(index: KmerIndex) -> Dict[str, np.ndarray]:
    """The two-choice bucket of engine.py:_device_tables for W > 16, which
    carries class ids and no inline bitsets, and the index's stash planes,
    as numpy arrays: the wide fallback when monocls placement is
    infeasible (engine.py:lookup_classes reads them)."""
    return {
        "bucket": _two_choice_bucket(index, 0),
        "stash_hi": index.stash_hi.view(np.int32),
        "stash_lo": index.stash_lo.view(np.int32),
        "stash_vsame": index.stash_vsame.astype(np.int32),
        "stash_vdiff": index.stash_vdiff.astype(np.int32),
    }


def build_monocls_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_monocls_tables as numpy arrays: every occupied
    two-choice entry reinserted by h1 into single-hash buckets of
    MONO_SLOTS slots, with class ids as payload, planar rows [hi x S | lo x
    S | vs x S | vd x S] (one 64-byte row a window). None when the index is
    empty or placement blows its budget."""
    hi, lo, vs, vd = _occupied_entries(index)
    if hi.shape[0] == 0:
        return None
    placement = _single_hash_placement(hi, lo, 4, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    S = MONO_SLOTS
    table = np.zeros((nb2, S * 4), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[:, 2 * S :] = -1  # class planes default to miss
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    table[b, 2 * S + s] = vs[keys]
    table[b, 3 * S + s] = vd[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    ms = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "vs": np.full(pad, -1, dtype=np.int32),
        "vd": np.full(pad, -1, dtype=np.int32),
    }
    if n_stash:
        ms["hi"][:n_stash] = hi[skeys].view(np.int32)
        ms["lo"][:n_stash] = lo[skeys].view(np.int32)
        ms["vs"][:n_stash] = vs[skeys]
        ms["vd"][:n_stash] = vd[skeys]
    return {"mcls_bucket": table, **{f"mcls_stash_{k}": v for k, v in ms.items()}}


def build_groupcls_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_groupcls_tables as numpy arrays: single-hash
    buckets over the canonical (k+g-1)-mer entries with the g windows'
    class ids of both orientations as payload and the packed 4 x g-bit
    presence mask (the narrow group table's), rows [hi x S | lo x S | cls
    cols (2g, S) | mask x S]. None when the index has no group entries,
    g > 8, or placement blows its budget."""
    g = index.pair_g
    hi = index.pair_hi
    lo = index.pair_lo
    vals = index.pair_vals
    if hi is None or hi.shape[0] == 0 or g > 8:
        return None
    n = hi.shape[0]
    entry = 2 + 2 * g + 1
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    present = (vals >= 0).astype(np.int32)
    vs_mask = np.zeros(n, dtype=np.int32)
    vd_mask = np.zeros(n, dtype=np.int32)
    for i in range(g):
        vs_mask |= present[:, i] << i
        vd_mask |= present[:, g + i] << i
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)

    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[:, 2 * S : 2 * S + 2 * g * S] = -1  # class planes default to miss
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for c in range(2 * g):
        table[b, 2 * S + c * S + s] = vals[keys, c]
    table[b, 2 * S + 2 * g * S + s] = mask_word[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "cols": np.full((pad, 2 * g), -1, dtype=np.int32),
        "mask": np.zeros(pad, dtype=np.int32),
    }
    if n_stash:
        gs["hi"][:n_stash] = hi[skeys].view(np.int32)
        gs["lo"][:n_stash] = lo[skeys].view(np.int32)
        gs["cols"][:n_stash] = vals[skeys]
        gs["mask"][:n_stash] = mask_word[skeys]
    return {"groupcls_bucket": table, **{f"groupcls_stash_{k}": v for k, v in gs.items()}}


def _class_spans(cb: np.ndarray, W: int):
    """First and last nonzero word of every class bitset (0, 0 if empty)."""
    nz = cb != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, W - 1 - nz[:, ::-1].argmax(axis=1), 0)
    return first, last


def _band_rows(cb: np.ndarray, ok: np.ndarray, first: np.ndarray, Pw: int, W: int) -> np.ndarray:
    """(C, 1 + 2 Pw) rows [page | band] of the classes marked ok, each class
    stored as the aligned 2-page window at page first // Pw; other rows are
    page 0 and all zero."""
    C = cb.shape[0]
    pages = np.where(ok, first // Pw, 0).astype(np.int32)
    Wpad = (-(-W // Pw) + 1) * Pw
    cbp = np.zeros((C, Wpad), dtype=np.int32)
    cbp[ok, :W] = cb[ok]
    idx = pages[:, None] * Pw + np.arange(2 * Pw)[None, :]
    band = np.take_along_axis(cbp, idx, axis=1)
    return np.concatenate([pages[:, None], band], axis=1)


def build_class_bands(index: KmerIndex):
    """engine.py:_build_class_bands — every class bitset as a 2-page band
    at a page-aligned offset, page size Pw = roundup8(max span). Returns
    (Pw, bandrow) with bandrow (C, 1 + 2 Pw) int32, or None when W <= 16,
    the index has no classes, or 3 Pw > W (banding is not worth it).
    Kept on the index object, as the reference keeps it: the engine's
    tables and its chunk sizing both ask."""
    cached = getattr(index, "_torch_class_bands", "unset")
    if cached != "unset":
        return cached
    W = index.bitset_words
    cb = index.class_bits.view(np.int32)
    out = None
    if cb.shape[0] and W > INLINE_BITS_MAX_WORDS:
        first, last = _class_spans(cb, W)
        Pw = max(8, -(-int(np.max(last - first + 1)) // 8) * 8)
        if 3 * Pw <= W:
            out = Pw, _band_rows(cb, np.ones(cb.shape[0], dtype=bool), first, Pw, W)
    index._torch_class_bands = out
    return out


def build_class_bands_robust(index: KmerIndex):
    """engine.py:_build_class_bands_robust — build_class_bands tolerant of
    up to BAND_OUTLIER_CAP classes whose bitset does not fit an aligned
    2-page window (cross-family k-mer collisions): Pw comes from the 99.99th
    percentile span, misfit classes get zeroed rows and ok = False, and the
    gband builder pre-ANDs the entries touching them at full width. Returns
    (Pw, bandrow, ok) or None."""
    strict = build_class_bands(index)
    if strict is not None:
        Pw, bandrow = strict
        return Pw, bandrow, np.ones(bandrow.shape[0], dtype=bool)
    W = index.bitset_words
    cb = index.class_bits.view(np.int32)
    if not cb.shape[0] or W <= INLINE_BITS_MAX_WORDS:
        return None
    first, last = _class_spans(cb, W)
    Pw = max(8, -(-int(np.percentile(last - first + 1, 99.99)) // 8) * 8)
    ok = (last // Pw - first // Pw) <= 1
    if 3 * Pw > W or int((~ok).sum()) > BAND_OUTLIER_CAP:
        return None
    return Pw, _band_rows(cb, ok, first, Pw, W), ok


def np_band_combine(po, bo, has, pi, bi, pres, Pw: int):
    """engine.py:_np_band_combine — fold the banded class (pi, bi, pres)
    into the accumulator (po, bo, has): an AND in the frame of the higher
    page, empty when the pages differ by 2 or more."""
    n = po.shape[0]
    d = pi - po
    up_o = np.concatenate([bo[:, Pw:], np.zeros((n, Pw), np.int32)], axis=1)
    up_i = np.concatenate([bi[:, Pw:], np.zeros((n, Pw), np.int32)], axis=1)
    nb = np.where((d == 0)[:, None], bo & bi, 0)
    nb = np.where((d == 1)[:, None], up_o & bi, nb)
    nb = np.where((d == -1)[:, None], bo & up_i, nb)
    np_page = np.maximum(po, pi)
    both = has & pres
    bo = np.where(both[:, None], nb, np.where(pres[:, None], bi, bo))
    po = np.where(both, np_page, np.where(pres, pi, po))
    return po, bo, has | pres


def _preand_bands(cols: np.ndarray, pages_all, band_all, Pw: int):
    """(n, g) window class ids -> (page, band, mask): each entry's present
    windows' bands ANDed, in blocks of GBAND_PREAND_BLOCK_BYTES so the
    temporaries of np_band_combine stay cache-sized."""
    n = cols.shape[0]
    Wb = 2 * Pw
    po = np.zeros(n, dtype=np.int32)
    bo = np.zeros((n, Wb), dtype=np.int32)
    mask = np.zeros(n, dtype=np.int32)
    block = max(1, GBAND_PREAND_BLOCK_BYTES // (Wb * 4))
    for lo_i in range(0, n, block):
        hi_i = min(lo_i + block, n)
        cb = cols[lo_i:hi_i]
        pb = po[lo_i:hi_i]
        bb = bo[lo_i:hi_i]
        hb = np.zeros(hi_i - lo_i, dtype=bool)
        mb = mask[lo_i:hi_i]
        for i in range(cb.shape[1]):
            c = cb[:, i]
            pres = c >= 0
            cc = np.clip(c, 0, None)
            pb, bb, hb = np_band_combine(pb, bb, hb, pages_all[cc], band_all[cc], pres, Pw)
            mb |= pres.astype(np.int32) << i
        po[lo_i:hi_i] = pb
        bo[lo_i:hi_i] = bb
        mask[lo_i:hi_i] = mb
    return po, bo, mask


def _fix_outlier_entries(index: KmerIndex, cols, po, bo, band_ok, Pw: int):
    """Exact full-width pre-AND of the entries touching an outlier (misfit)
    class, re-banded. Returns (po, bo, ok); ok is False when a result still
    misfits its 2-page window."""
    pres_all = cols >= 0
    bad = pres_all & ~band_ok[np.clip(cols, 0, None)]
    rows_idx = np.nonzero(bad.any(axis=1))[0]
    if rows_idx.size == 0:
        return po, bo, True
    cb = index.class_bits.view(np.int32)
    W = index.bitset_words
    acc = np.zeros((rows_idx.size, W), dtype=np.int32)
    has = np.zeros(rows_idx.size, dtype=bool)
    for i in range(cols.shape[1]):
        c = cols[rows_idx, i]
        pres = c >= 0
        row = cb[np.clip(c, 0, None)]
        both = has & pres
        acc = np.where(both[:, None], acc & row, np.where((pres & ~has)[:, None], row, acc))
        has |= pres
    f, l = _class_spans(acc, W)
    if np.any((l // Pw - f // Pw) > 1):
        return po, bo, False
    pages = (f // Pw).astype(np.int32)
    Wpad = (-(-W // Pw) + 1) * Pw
    accp = np.zeros((rows_idx.size, Wpad), dtype=np.int32)
    accp[:, :W] = acc
    gidx = pages[:, None] * Pw + np.arange(2 * Pw)[None, :]
    po = po.copy()
    bo = bo.copy()
    po[rows_idx] = pages
    bo[rows_idx] = np.take_along_axis(accp, gidx, axis=1)
    return po, bo, True


def build_groupband_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_groupband_tables in its default layout (single-hash
    placement, dense bucket) as numpy arrays, under the reference's keys
    (with its `gband_single` and `gband_packedrow` markers, so a sidecar
    written from them loads in either package). None when the index has no
    group entries or g > 8, banding is infeasible, an outlier entry stays
    wide, or placement blows its budget."""
    if not index.has_pairs or index.pair_g > 8:
        return None
    bands = build_class_bands_robust(index)
    if bands is None:
        return None
    Pw, bandrow, band_ok = bands
    g = index.pair_g
    hi = index.pair_hi
    lo = index.pair_lo
    vals = index.pair_vals
    n = hi.shape[0]
    placement = _single_hash_placement(hi, lo, 4, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    pages_all = bandrow[:, 0]
    band_all = bandrow[:, 1:]
    p_s, b_s, vs_mask = _preand_bands(vals[:, :g], pages_all, band_all, Pw)
    p_d, b_d, vd_mask = _preand_bands(vals[:, g:], pages_all, band_all, Pw)
    if not band_ok.all():
        p_s, b_s, ok_s = _fix_outlier_entries(index, vals[:, :g], p_s, b_s, band_ok, Pw)
        p_d, b_d, ok_d = _fix_outlier_entries(index, vals[:, g:], p_d, b_d, band_ok, Pw)
        if not (ok_s and ok_d):
            return None
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)
    # half rows [page | band], one per entry and orientation, deduplicated:
    # a column-mixing int64 hash, verified row for row, with an exact
    # lexsort unique on a collision
    half = np.concatenate(
        [np.concatenate([p_s[:, None], b_s], axis=1),
         np.concatenate([p_d[:, None], b_d], axis=1)]
    ).astype(np.int32)
    hsh = np.zeros(half.shape[0], dtype=np.int64)
    for j in range(half.shape[1]):
        hsh = (hsh ^ half[:, j].astype(np.int64)) * np.int64(-7046029254386353131)
        hsh ^= hsh >> 29
    _, first_idx, inverse = np.unique(hsh, return_index=True, return_inverse=True)
    dedup = half[first_idx]
    if np.array_equal(dedup[inverse], half):
        band_table = dedup
        remap = inverse.astype(np.int32)
    else:
        band_table, remap = np.unique(half, axis=0, return_inverse=True)
        remap = remap.reshape(-1).astype(np.int32)
    remap_s, remap_d = remap[:n], remap[n:]

    S = MONO_SLOTS
    packed_rows = band_table.shape[0] < (1 << 18) and g <= 6
    if packed_rows:
        w0 = remap_s | ((mask_word & 0x3F) << 18) | (((mask_word >> 8) & 0x3F) << 24)
        w1 = remap_d | (((mask_word >> 16) & 0x3F) << 18) | (((mask_word >> 24) & 0x3F) << 24)
        planes = (w0, w1)
    else:
        planes = (remap_s, remap_d, mask_word)
    table = np.zeros((nb2, S * (2 + len(planes))), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for i, plane in enumerate(planes):
        table[b, (2 + i) * S + s] = plane[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "idx_s": np.zeros(pad, dtype=np.int32),
        "idx_d": np.zeros(pad, dtype=np.int32),
        "mask": np.zeros(pad, dtype=np.int32),
    }
    if n_stash:
        gs["hi"][:n_stash] = hi[skeys].view(np.int32)
        gs["lo"][:n_stash] = lo[skeys].view(np.int32)
        gs["idx_s"][:n_stash] = remap_s[skeys]
        gs["idx_d"][:n_stash] = remap_d[skeys]
        gs["mask"][:n_stash] = mask_word[skeys]
    out = {
        "gband_bucket": table,
        "gband_table": band_table,
        **{f"gband_stash_{k}": v for k, v in gs.items()},
        "gband_single": np.zeros((1,), np.int32),
    }
    if packed_rows:
        out["gband_packedrow"] = np.zeros((1,), np.int32)
    return out


def gband_sidecar_path(index: KmerIndex) -> Optional[str]:
    """The reference's sidecar of the default gband layout, next to the
    persisted index (None for an index that was never saved or loaded)."""
    cp = getattr(index, "_cache_path", None)
    return f"{cp}.gband.single.dense.npz" if cp else None


def gband_fingerprint(index: KmerIndex) -> np.ndarray:
    """The reference's sidecar fingerprint: format version, entry count,
    sampled sums of the entry keys, g and W."""
    n = index.pair_hi.shape[0]
    step = max(1, n // 997)
    return np.array(
        [
            GBAND_FORMAT_VERSION,
            n,
            int(index.pair_hi[::step].astype(np.int64).sum()),
            int(index.pair_lo[::step].astype(np.int64).sum()),
            index.pair_g,
            index.bitset_words,
        ],
        dtype=np.int64,
    )


def groupband_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """build_groupband_tables, read from and written to the sidecar that
    the reference reads and writes (same file, fingerprint and keys), and
    kept on the index object for later engines of the same process. An
    unreadable or stale sidecar is rebuilt; writing it is best-effort."""
    cached = getattr(index, "_torch_gband", "unset")
    if cached != "unset":
        return cached
    disk = gband_sidecar_path(index) if index.has_pairs else None
    out = None
    if disk and os.path.exists(disk):
        try:
            with np.load(disk) as z:
                if np.array_equal(z["__fp"], gband_fingerprint(index)):
                    out = {k: z[k] for k in z.files if k != "__fp"}
        except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
            out = None  # unreadable: rebuild below
    if out is None:
        out = build_groupband_tables(index)
        if out is not None and disk:
            try:
                tmp = f"{disk}.{os.getpid()}.tmp.npz"
                np.savez(tmp, __fp=gband_fingerprint(index), **out)
                os.replace(tmp, disk)
            except OSError:
                pass
    index._torch_gband = out
    return out


def _relay_bands(table: torch.Tensor, stage: str):
    """relayout_gband of a [page | band] table already on its device, timed
    as the run log's `stage` (the copy to the card stays out of it).
    Returns (page, band)."""
    with runlog().stage(stage, rows=table.shape[0], bytes=table.numel() * 4, device=str(table.device)):
        if table.is_cuda:
            torch.cuda.synchronize(table.device)
        out = relayout_gband(table)
        if table.is_cuda:
            torch.cuda.synchronize(table.device)
    return out


def _as_tensor(a, device) -> torch.Tensor:
    """A numpy array as an int32 tensor on `device`; copies on the host only
    what is not already writable contiguous int32."""
    return torch.from_numpy(np.require(a, np.int32, ["C", "W"])).to(device)


def _gband_to_device(np_tables, W: int, device) -> Dict[str, torch.Tensor]:
    """The gband arrays the step reads, as tensors, plus W as a plain int.
    Only the default layout is taken: the reference's two-choice and
    indirect layouts (NIMBLE_TPU_GBAND_PLACEMENT=two,
    NIMBLE_TPU_GBAND_INDIRECT=1) are not ported, and no ROADMAP item
    queues them."""
    if "gband_single" not in np_tables or "gband_ptr8" in np_tables:
        raise NotImplementedError(
            "only the single-hash dense gband layout is ported; the reference's two-choice "
            "(NIMBLE_TPU_GBAND_PLACEMENT=two) and indirect (NIMBLE_TPU_GBAND_INDIRECT=1) "
            "layouts are not")
    width = np_tables["gband_bucket"].shape[1]
    if width != MONO_SLOTS * (4 if "gband_packedrow" in np_tables else 5):
        raise ValueError(f"gband bucket rows of {width} words do not match the packed-row marker")
    out = {k: _as_tensor(np_tables[k], device) for k in GBAND_KEYS if k != "gband_table"}
    out["gband_page"], out["gband_band"] = _relay_bands(
        _as_tensor(np_tables["gband_table"], device), "gband_relayout")
    return {**out, "gband_words": int(W)}


def _class_tables_to_device(np_tables, keys, class_bits: np.ndarray, bandrow: Optional[np.ndarray],
                            device) -> Dict[str, torch.Tensor]:
    """A wide class-id path's arrays (`keys`) as tensors, with the class
    bitsets the intersection reads: `class_bits` (C, W), or, where the
    strict class bands exist, their rows re-laid as `class_page` (C,) and
    `class_band` (C, 2 Pw) (the run log's `class_relayout` stage) and W as
    the plain int `class_words`."""
    out = {k: _as_tensor(np_tables[k], device) for k in keys}
    if bandrow is None:
        out["class_bits"] = _as_tensor(class_bits, device)
    else:
        out["class_page"], out["class_band"] = _relay_bands(_as_tensor(bandrow, device), "class_relayout")
        out["class_words"] = int(class_bits.shape[1])
    return out


def relayout_gband(table: torch.Tensor):
    """Split a (n_rows, 1 + 2 Pw) gband table of [page | band] rows into its
    page vector (n_rows,) and its band rows (n_rows, 2 Pw), new contiguous
    tensors on the table's device: a band row starts on a 4 Pw-byte
    boundary, so a warp's read of half a row is whole 32-byte sectors.
    Returns (page, band)."""
    return table[:, 0].contiguous(), table[:, 1:].contiguous()


# rows of the mono table re-laid at a time (bounds the transient copy)
RELAYOUT_ROWS = 1 << 20


def relayout_mono(bucket: torch.Tensor, W: int) -> torch.Tensor:
    """Re-lay a (nb2, S (2 + 2W)) mono table from the planar layout to the
    slot-major one, in place, RELAYOUT_ROWS rows at a time: the keys stay,
    the values (vs/vd, w, s) become (s, vs/vd, w), so that a matched slot's
    2W words are one contiguous run. Returns bucket."""
    S = bucket.shape[1] // (2 + 2 * W)
    for a in range(0, bucket.shape[0], RELAYOUT_ROWS):
        vals = bucket[a : a + RELAYOUT_ROWS, 2 * S :]
        vals.copy_(vals.reshape(-1, 2, W, S).permute(0, 3, 1, 2).reshape(vals.shape))
    return bucket


def tables_from_reference(np_tables, device, owned: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's `_device_tables(index)` output, taken as numpy arrays,
    -> the port's tensors on `device`, for the path the reference's
    `_score_mate` would take on them: group, else gband (W from its
    `class_bits` placeholder; its band table split by relayout_gband, the
    run log's `gband_relayout` stage), else groupcls, else monocls, else
    mono (re-laid slot-major), else the two-choice inline bucket (W <= 16),
    else the wide two-choice class-id bucket; the class-id paths with
    `class_bits` or, where the reference ships `class_bandrow`, the band
    rows re-laid (`_class_tables_to_device`). Only that path's entries are
    carried. The mono table is re-laid on `device`, as the run log's
    `mono_relayout` stage; on the CPU, in a copy of the caller's array,
    unless `owned` says the arrays are this call's to change (device_tables'
    fresh build), so that a multi-GB table is not duplicated on the host."""
    as_t = lambda a: _as_tensor(a, device)
    has = lambda keys: all(k in np_tables for k in keys)
    if has(GROUP_KEYS):
        return {k: as_t(np_tables[k]) for k in GROUP_KEYS}
    if has(GBAND_KEYS):
        return _gband_to_device(np_tables, np_tables["class_bits"].shape[1], device)
    class_bits = np_tables.get("class_bits")
    if has(GROUPCLS_KEYS):
        return _class_tables_to_device(np_tables, GROUPCLS_KEYS, class_bits, None, device)
    if has(MCLS_KEYS):
        return _class_tables_to_device(np_tables, MCLS_KEYS, class_bits, np_tables.get("class_bandrow"), device)
    if has(MONO_KEYS):
        stash = np.concatenate(
            [np.asarray(np_tables["mono_stash_hi"])[:, None],
             np.asarray(np_tables["mono_stash_lo"])[:, None],
             np_tables["mono_stash_vs_bits"], np_tables["mono_stash_vd_bits"]],
            axis=1,
        )
        bucket = as_t(np_tables["mono_bucket"])
        if bucket.device.type == "cpu" and not owned:  # the tensor may share the caller's array
            bucket = bucket.clone()
        with runlog().stage("mono_relayout", rows=bucket.shape[0], bytes=bucket.numel() * 4,
                            device=str(bucket.device)):
            if bucket.is_cuda:  # the copy to the card stays out of the stage
                torch.cuda.synchronize(bucket.device)
            relayout_mono(bucket, stash.shape[1] // 2 - 1)
            if bucket.is_cuda:
                torch.cuda.synchronize(bucket.device)
        return {"mono_bucket": bucket, "mono_stash": as_t(stash)}
    if has(INLINE_KEYS):
        return {k: as_t(np_tables[k]) for k in INLINE_KEYS}
    if has(CLASSES_KEYS) and class_bits is not None:
        return _class_tables_to_device(np_tables, CLASSES_KEYS, class_bits, np_tables.get("class_bandrow"), device)
    raise ValueError(f"reference tables carry no group, mono or two-choice entries (keys {sorted(np_tables)})")


def device_tables(index: KmerIndex, device, group_ok: bool = True) -> Dict[str, torch.Tensor]:
    """The tables of one path on `device`, chosen as the reference's
    `_device_tables(index, group_ok=group_ok)` chooses. W <= 16: the group
    table when allowed, the index has group entries, W <= 8 and placement
    fits; else the mono table when placement fits; else the two-choice
    inline bucket. W > 16, when allowed and the index has group entries:
    the gband tables when banding works and they place, else the groupcls
    table when it places. Otherwise the monocls table when it places, else
    the two-choice class-id bucket, each with the strict class bands where
    every class fits one (`build_class_bands`), else with `class_bits`."""
    W = index.bitset_words
    if W <= INLINE_BITS_MAX_WORDS:
        tables = None
        if group_ok and W <= GROUP_MAX_WORDS:
            tables = build_group_tables(index)
        if tables is None:
            tables = build_mono_tables(index)
        if tables is None:
            tables = build_inline_tables(index)
        return tables_from_reference(tables, device, owned=True)  # built for this call
    class_bits = index.class_bits.view(np.int32)
    if group_ok and index.has_pairs:
        gband = groupband_tables(index)
        if gband is not None:
            return _gband_to_device(gband, W, device)
        gcls = build_groupcls_tables(index)
        if gcls is not None:
            return _class_tables_to_device(gcls, GROUPCLS_KEYS, class_bits, None, device)
    tables, keys = build_monocls_tables(index), MCLS_KEYS
    if tables is None:
        tables, keys = build_classes_tables(index), CLASSES_KEYS
    bands = build_class_bands(index)
    return _class_tables_to_device(tables, keys, class_bits, bands[1] if bands else None, device)
