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
Gband (wide, W > 16) tables, in the reference's four layouts (gband_mode:
single-hash or two-choice placement, dense or indirect rows):
  gband_bucket probe rows, one per bucket (dense) or one per occupied
  bucket after an all-empty row 0 (indirect, reached through the
  (nb2 / 8, 8) pointer rows gband_ptr8): [hi x S | lo x S | w0 x S |
  w1 x S] (packed: w0 = idx_s | vs<<18 | vd<<24, w1 = idx_d | rvs<<18 |
  rvd<<24) or, with 2^18 or more band rows or g > 6, [hi x S | lo x S |
  idx_s x S | idx_d x S | mask x S]; gband_table half rows [page | band (2 Pw)], one per distinct
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
import time
import zipfile
from functools import partial
from typing import Dict, Optional, Tuple

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
# a gband layout: (two-choice placement, indirect rows), and all four
GbandMode = Tuple[bool, bool]
GBAND_MODES = ((False, False), (True, False), (False, True), (True, True))
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


def _single_hash_placement(hi: np.ndarray, lo: np.ndarray, entry_words: int):
    """engine.py:_single_hash_placement — grow-until-tight single-hash
    placement into buckets of MONO_SLOTS slots. Returns None (infeasible
    under MONO_MAX_BYTES/MONO_MAX_STASH) or (nb2, bucket_ids, slot_ids,
    placed_keys, stash_keys)."""
    n = hi.shape[0]
    best = None
    for extra in (1, 2, 3, 4, 5, 6):
        nb2 = 1 << max(1, int(np.ceil(np.log2(n))) + extra)
        if nb2 * MONO_SLOTS * entry_words * 4 > MONO_MAX_BYTES:
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
        placed = rank < MONO_SLOTS
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
    placement = _single_hash_placement(hi, lo, entry)
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
    placement = _single_hash_placement(hi, lo, entry)
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
    placement = _single_hash_placement(hi, lo, 4)
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
    placement = _single_hash_placement(hi, lo, entry)
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


def gband_mode() -> GbandMode:
    """The gband layout the environment asks for, read at each build as the
    reference reads it: (two_choice, indirect). NIMBLE_TPU_GBAND_PLACEMENT=two
    places the entries by two-choice placement (a ~16x denser table, probed
    in two buckets); NIMBLE_TPU_GBAND_INDIRECT=1 stores only the occupied
    buckets, as rows reached through an 8-lane pointer array."""
    return (os.environ.get("NIMBLE_TPU_GBAND_PLACEMENT", "single") == "two",
            os.environ.get("NIMBLE_TPU_GBAND_INDIRECT", "0") == "1")


def _two_choice_placement(hi: np.ndarray, lo: np.ndarray, slots: int, stash_cap: int = 64):
    """engine.py:_two_choice_placement — greedy lesser-loaded rounds, then
    random-walk cuckoo eviction (the reference's seed), into next_pow2
    bucket tables grown until the overflow fits stash_cap. Returns None or
    (nb2, bucket_ids, slot_ids, placed_keys, stash_keys)."""
    n = hi.shape[0]
    target = max(1, int(np.ceil(n / (slots * 0.6))))
    nb2 = 1 << max(1, int(np.ceil(np.log2(target))))
    for _ in range(4):
        h1, h2 = bucket_hashes_np(hi, lo, nb2)
        slot_key = np.full(nb2 * slots, -1, dtype=np.int64)
        loads = np.zeros(nb2, dtype=np.int32)
        pending = np.arange(n)
        for _r in range(16):
            if pending.size == 0:
                break
            p1, p2 = h1[pending], h2[pending]
            tgt = np.where(loads[p1] <= loads[p2], p1, p2).astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            t_sorted = tgt[order]
            boundary = np.empty(t_sorted.shape[0], dtype=bool)
            boundary[0] = True
            boundary[1:] = t_sorted[1:] != t_sorted[:-1]
            group_start = np.flatnonzero(boundary)
            rank = np.arange(t_sorted.shape[0]) - group_start[np.cumsum(boundary) - 1]
            slot = loads[t_sorted] + rank
            ok = slot < slots
            slot_key[t_sorted[ok] * slots + slot[ok]] = pending[order[ok]]
            np.add.at(loads, t_sorted[ok], 1)
            pending = pending[order[~ok]]
        rng = np.random.default_rng(0x1C0FFEE)
        for _r in range(512):
            if pending.size <= stash_cap:
                break
            p1, p2 = h1[pending], h2[pending]
            pick = rng.integers(0, 2, size=pending.size) == 1
            tgt = np.where(pick, p1, p2).astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            t_sorted = tgt[order]
            first = np.empty(t_sorted.size, dtype=bool)
            first[0] = True
            first[1:] = t_sorted[1:] != t_sorted[:-1]
            win = order[first]  # one winner per bucket this round
            flat = tgt[win] * slots + rng.integers(0, slots, size=win.size)
            evicted = slot_key[flat]
            slot_key[flat] = pending[win]
            keep = np.ones(pending.size, dtype=bool)
            keep[win] = False
            pending = np.concatenate([pending[keep], evicted[evicted >= 0]])
        if pending.size <= stash_cap:
            occ = np.flatnonzero(slot_key >= 0)
            return nb2, occ // slots, occ % slots, slot_key[occ], pending
        nb2 <<= 1
    return None


def _gband_placement(index: KmerIndex, two_choice: bool):
    """The gband entries' placement: two-choice (no byte cap), else
    single-hash under MONO_MAX_BYTES."""
    if two_choice:
        return _two_choice_placement(index.pair_hi, index.pair_lo, MONO_SLOTS)
    return _single_hash_placement(index.pair_hi, index.pair_lo, 4)


def gband_payload(index: KmerIndex, bands):
    """The layout-independent part of engine.py:_build_groupband_tables:
    the g windows' class bands of every entry pre-ANDed per orientation,
    the entries touching an outlier class fixed at full width, the packed
    4 x g-bit presence mask word, and the half rows [page | band]
    deduplicated (a column-mixing int64 hash, verified row for row, with an
    exact lexsort unique on a collision). Returns (band_table, remap_s,
    remap_d, mask_word), the last three per entry in the index's order, or
    None when an outlier entry stays wide."""
    Pw, bandrow, band_ok = bands
    g = index.pair_g
    vals = index.pair_vals
    n = vals.shape[0]
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
    return band_table, remap[:n], remap[n:], mask_word


def _entry_key(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 or uint32 words -> one uint64 key each."""
    return (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) | lo.view(np.uint32).astype(np.uint64)


def gband_payload_of(tables, index: KmerIndex):
    """gband_payload read back from the gband arrays of another layout of
    the same index, so that a new layout costs only its placement: every
    entry's key sits in one occupied bucket slot (any row: the dense
    layout's or the indirect one's packed rows) or one stash row; a packed
    row's 6-bit fields hold all of its mask word (packed rows need g <= 6);
    the keys map back to the index's entry order through pair_hi / pair_lo;
    and band_table's order comes from the dedup hash, not from the layout,
    so it is taken as it is. None unless the arrays hold each entry exactly
    once."""
    S = MONO_SLOTS
    bucket = tables["gband_bucket"]
    # the occupied rows, gathered once (a sparse table is mostly empty):
    # an empty slot's hi is the EMPTY sentinel -1 and a canonical hi is
    # >= 0, so a row is occupied where the AND of its hi words is >= 0
    hi_and = bucket[:, 0].copy()
    for j in range(1, S):
        hi_and &= bucket[:, j]
    bucket = bucket[np.flatnonzero(hi_and >= 0)]
    occ = bucket[:, :S] != -1
    socc = tables["gband_stash_hi"] != -1
    keys = np.concatenate([_entry_key(bucket[:, :S][occ], bucket[:, S : 2 * S][occ]),
                           _entry_key(tables["gband_stash_hi"][socc], tables["gband_stash_lo"][socc])])
    if "gband_packedrow" in tables:
        # w0 = idx_s | vs<<18 | vd<<24, w1 = idx_d | rvs<<18 | rvd<<24
        w0, w1 = bucket[:, 2 * S : 3 * S][occ], bucket[:, 3 * S : 4 * S][occ]
        idx_s, idx_d = w0 & 0x3FFFF, w1 & 0x3FFFF
        mword = (((w0 >> 18) & 0x3F) | (((w0 >> 24) & 0x3F) << 8)
                 | (((w1 >> 18) & 0x3F) << 16) | (((w1 >> 24) & 0x3F) << 24))
    else:
        idx_s, idx_d, mword = (bucket[:, i * S : (i + 1) * S][occ] for i in (2, 3, 4))
    idx_s = np.concatenate([idx_s, tables["gband_stash_idx_s"][socc]])
    idx_d = np.concatenate([idx_d, tables["gband_stash_idx_d"][socc]])
    mword = np.concatenate([mword, tables["gband_stash_mask"][socc]])
    want = _entry_key(index.pair_hi, index.pair_lo)
    n = want.shape[0]
    if keys.shape[0] != n or n == 0:
        return None
    order = np.argsort(keys)
    at = order[np.minimum(np.searchsorted(keys, want, sorter=order), n - 1)]
    if not np.array_equal(keys[at], want) or np.unique(at).shape[0] != n:
        return None
    as_i32 = lambda a: a[at].astype(np.int32)
    return np.asarray(tables["gband_table"]), as_i32(idx_s), as_i32(idx_d), as_i32(mword)


def gband_layout(index: KmerIndex, payload, placement, mode: GbandMode) -> Dict[str, np.ndarray]:
    """The layout part of engine.py:_build_groupband_tables: the placed
    entries' probe rows (packed [hi | lo | w0 | w1] rows when the band rows
    fit 18 bits and g <= 6, else the 5-plane rows), dense (one row per
    bucket) or indirect (the occupied buckets' rows after an all-empty row
    0, and the (nb2 / 8, 8) pointer rows `gband_ptr8`), the stash as five
    planes, and the reference's markers: `gband_single` for single-hash
    placement, `gband_packedrow` for packed rows. The keys in the
    reference's order, so that a sidecar written from them has its
    members in the same order."""
    two_choice, indirect = mode
    band_table, remap_s, remap_d, mask_word = payload
    nb2, b, s, keys, skeys = placement
    hi, lo, g = index.pair_hi, index.pair_lo, index.pair_g
    if indirect:
        occ_buckets = np.unique(b)
        n_rows = occ_buckets.shape[0] + 1
        ptr = np.zeros(nb2, dtype=np.int32)  # empty buckets -> row 0
        ptr[occ_buckets] = np.arange(1, n_rows, dtype=np.int32)
        rb = ptr[b]
        ptr8 = ptr.reshape(-1, 8)
    else:
        n_rows, rb, ptr8 = nb2, b, None
    S = MONO_SLOTS
    packed_rows = band_table.shape[0] < (1 << 18) and g <= 6
    if packed_rows:
        w0 = remap_s | ((mask_word & 0x3F) << 18) | (((mask_word >> 8) & 0x3F) << 24)
        w1 = remap_d | (((mask_word >> 16) & 0x3F) << 18) | (((mask_word >> 24) & 0x3F) << 24)
        planes = (w0, w1)
    else:
        planes = (remap_s, remap_d, mask_word)
    table = np.zeros((n_rows, S * (2 + len(planes))), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[rb, s] = hi[keys].view(np.int32)
    table[rb, S + s] = lo[keys].view(np.int32)
    for i, plane in enumerate(planes):
        table[rb, (2 + i) * S + s] = plane[keys]

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
    out = {"gband_bucket": table}
    if ptr8 is not None:
        out["gband_ptr8"] = ptr8
    out["gband_table"] = band_table
    out.update({f"gband_stash_{k}": v for k, v in gs.items()})
    if not two_choice:
        out["gband_single"] = np.zeros((1,), np.int32)
    if packed_rows:
        out["gband_packedrow"] = np.zeros((1,), np.int32)
    return out


def build_groupband_tables(index: KmerIndex, mode: Optional[GbandMode] = None) -> Optional[Dict[str, np.ndarray]]:
    """engine.py:_build_groupband_tables from scratch, in the layout `mode`
    ((two_choice, indirect); default the environment's, gband_mode), as
    numpy arrays under the reference's keys (gband_layout). None when the
    index has no group entries or g > 8, banding is infeasible, placement
    blows its budget, or an outlier entry stays wide."""
    if not index.has_pairs or index.pair_g > 8:
        return None
    mode = gband_mode() if mode is None else mode
    bands = build_class_bands_robust(index)
    if bands is None:
        return None
    placement = _gband_placement(index, mode[0])
    if placement is None:
        return None
    payload = gband_payload(index, bands)
    if payload is None:
        return None
    return gband_layout(index, payload, placement, mode)


def gband_sidecar_path(index: KmerIndex, mode: Optional[GbandMode] = None) -> Optional[str]:
    """The reference's sidecar of a gband layout (default the environment's),
    next to the persisted index: `<index>.gband.{single|two}[.dense].npz`
    (None for an index that was never saved or loaded)."""
    cp = getattr(index, "_cache_path", None)
    if not cp:
        return None
    two_choice, indirect = gband_mode() if mode is None else mode
    return f"{cp}.gband.{'two' if two_choice else 'single'}{'' if indirect else '.dense'}.npz"


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


def load_gband_sidecar(path: Optional[str], index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """A sidecar's arrays, None when it is absent, unreadable or stale."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if np.array_equal(z["__fp"], gband_fingerprint(index)):
                return {k: z[k] for k in z.files if k != "__fp"}
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
        pass
    return None


def _derived_payload(index: KmerIndex, mode: GbandMode):
    """The payload of another layout's tables of this index, taken from the
    index object's cache, else from a fresh sidecar on disk: (payload,
    where it came from), or (None, None)."""
    cache = index.__dict__.get("_torch_gband", {})
    others = [m for m in GBAND_MODES if m != mode]
    held = [m for m in others if cache.get(m) is not None]
    for other in sorted(held, key=lambda m: cache[m]["gband_bucket"].size):  # the smallest first
        payload = gband_payload_of(cache[other], index)
        if payload is not None:
            return payload, "memory"
    for other in others:
        path = gband_sidecar_path(index, other)
        tables = load_gband_sidecar(path, index)
        payload = None if tables is None else gband_payload_of(tables, index)
        if payload is not None:
            return payload, path
    return None, None


def groupband_tables(index: KmerIndex) -> Optional[Dict[str, np.ndarray]]:
    """The gband tables of the layout the environment asks for (gband_mode),
    read from and written to the sidecar that the reference reads and
    writes for it (same file, fingerprint, keys and member order), and kept
    per layout on the index object for later engines of the same process,
    as the reference's `_gband_cache`. An unreadable or stale sidecar is
    rebuilt; writing it is best-effort. Where another layout's tables of
    the index are at hand (in memory or in a fresh sidecar), only the
    placement runs: their payload is read back (gband_payload_of) and laid
    out anew, which gives the from-scratch build's arrays. Where the tables
    came from ("loaded", "derived" with `derived_from`, or "built"), and in
    how many seconds, is kept as `index.gband_sidecar` and is the run log's
    `gband_sidecar` event."""
    mode = gband_mode()
    cache = index.__dict__.setdefault("_torch_gband", {})
    if mode in cache:
        return cache[mode]
    t0 = time.perf_counter()
    disk = gband_sidecar_path(index, mode) if index.has_pairs else None
    out = load_gband_sidecar(disk, index)
    source, written, origin = "loaded", False, None
    if out is None and index.has_pairs and index.pair_g <= 8:
        payload, origin = _derived_payload(index, mode)
        if payload is None:
            source, out = "built", build_groupband_tables(index, mode)
        else:
            placement = _gband_placement(index, mode[0])
            source = "derived"
            out = None if placement is None else gband_layout(index, payload, placement, mode)
        if out is not None and disk:
            try:
                tmp = f"{disk}.{os.getpid()}.tmp.npz"
                np.savez(tmp, __fp=gband_fingerprint(index), **out)
                os.replace(tmp, disk)
                written = True
            except OSError:
                pass
    if out is not None:
        index.gband_sidecar = {"path": disk, "source": source, "written": written,
                               "wall_s": round(time.perf_counter() - t0, 4)}
        if origin is not None:
            index.gband_sidecar["derived_from"] = origin
        runlog().event("gband_sidecar", **index.gband_sidecar)
    cache[mode] = out
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


def _nbytes(arrays: dict) -> int:
    """Bytes of the numpy arrays among a table set's values."""
    return sum(a.nbytes for a in arrays.values() if isinstance(a, np.ndarray))


def _copy_to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Every array as an int32 tensor on `device` (`_as_tensor`), timed as
    the run log's `tables.copy` stage with the tensors' `bytes`; the card
    is synchronized before the stage ends."""
    with runlog().stage("tables.copy", device=str(device)) as end:
        out = {k: _as_tensor(a, device) for k, a in arrays.items()}
        end["bytes"] = sum(t.numel() * t.element_size() for t in out.values())
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return out


def _gband_to_device(np_tables, W: int, device) -> Dict[str, torch.Tensor]:
    """The gband arrays the step reads, as tensors, plus W as a plain int:
    the probe rows, the stash planes, the band table re-laid
    (relayout_gband), the pointer rows `gband_ptr8` of the indirect layout,
    and, where the reference's `gband_single` marker is absent (two-choice
    placement), the marker `gband_two` (True) that sends each probe to its
    second bucket too."""
    width = np_tables["gband_bucket"].shape[1]
    if width != MONO_SLOTS * (4 if "gband_packedrow" in np_tables else 5):
        raise ValueError(f"gband bucket rows of {width} words do not match the packed-row marker")
    keys = GBAND_KEYS + ("gband_ptr8",) * ("gband_ptr8" in np_tables)
    out = _copy_to_device({k: np_tables[k] for k in keys}, device)
    out["gband_page"], out["gband_band"] = _relay_bands(out.pop("gband_table"), "gband_relayout")
    if "gband_single" not in np_tables:
        out["gband_two"] = True
    return {**out, "gband_words": int(W)}


def _class_tables_to_device(np_tables, keys, class_bits: np.ndarray, bandrow: Optional[np.ndarray],
                            device) -> Dict[str, torch.Tensor]:
    """A wide class-id path's arrays (`keys`) as tensors, with the class
    bitsets the intersection reads: `class_bits` (C, W), or, where the
    strict class bands exist, their rows re-laid as `class_page` (C,) and
    `class_band` (C, 2 Pw) (the run log's `class_relayout` stage) and W as
    the plain int `class_words`."""
    arrays = {k: np_tables[k] for k in keys}
    if bandrow is None:
        arrays["class_bits"] = class_bits
    else:
        arrays["class_bandrow"] = bandrow
    out = _copy_to_device(arrays, device)
    if bandrow is not None:
        out["class_page"], out["class_band"] = _relay_bands(out.pop("class_bandrow"), "class_relayout")
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
    carried, copied as the run log's `tables.copy` stage. The mono table is
    re-laid on `device`, as the run log's `mono_relayout` stage; on the
    CPU, in a copy of the caller's array, unless `owned` says the arrays
    are this call's to change (device_tables' fresh build), so that a
    multi-GB table is not duplicated on the host."""
    has = lambda keys: all(k in np_tables for k in keys)
    if has(GROUP_KEYS):
        return _copy_to_device({k: np_tables[k] for k in GROUP_KEYS}, device)
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
        out = _copy_to_device({"mono_bucket": np_tables["mono_bucket"], "mono_stash": stash}, device)
        bucket = out["mono_bucket"]
        if bucket.device.type == "cpu" and not owned:  # the tensor may share the caller's array
            bucket = bucket.clone()
        with runlog().stage("mono_relayout", rows=bucket.shape[0], bytes=bucket.numel() * 4,
                            device=str(bucket.device)):
            if bucket.is_cuda:  # the copy to the card stays out of the stage
                torch.cuda.synchronize(bucket.device)
            relayout_mono(bucket, stash.shape[1] // 2 - 1)
            if bucket.is_cuda:
                torch.cuda.synchronize(bucket.device)
        return {"mono_bucket": bucket, "mono_stash": out["mono_stash"]}
    if has(INLINE_KEYS):
        return _copy_to_device({k: np_tables[k] for k in INLINE_KEYS}, device)
    if has(CLASSES_KEYS) and class_bits is not None:
        return _class_tables_to_device(np_tables, CLASSES_KEYS, class_bits, np_tables.get("class_bandrow"), device)
    raise ValueError(f"reference tables carry no group, mono or two-choice entries (keys {sorted(np_tables)})")


def device_tables(index: KmerIndex, device, group_ok: bool = True, inline_ok: bool = True) -> Dict[str, torch.Tensor]:
    """The tables of one path on `device`, chosen as the reference's
    `_device_tables(index, inline_ok=inline_ok, group_ok=group_ok)` chooses
    (`_host_tables`). Their build on the host (or the gband sidecar's load)
    is the run log's `tables.host` stage, with the host arrays' `bytes`;
    their copy to `device` is `tables.copy`."""
    with runlog().stage("tables.host") as end:
        arrays, to_device = _host_tables(index, group_ok, inline_ok)
        end["bytes"] = _nbytes(arrays)
    return to_device(device)


def _host_tables(index: KmerIndex, group_ok: bool = True, inline_ok: bool = True):
    """(the path's host arrays, the call that puts them on a device) of the
    path device_tables takes. W <= 16 (and inline_ok): the group table
    when allowed, the index has group entries, W <= 8 and placement fits;
    else the mono table when placement fits; else the two-choice inline
    bucket. Otherwise (W > 16, or any W without inline_ok, as a
    feature-split mesh asks), when allowed and the index has group entries:
    the gband tables when banding works and they place, else the groupcls
    table when it places. Otherwise the monocls table when it places, else
    the two-choice class-id bucket, each with the strict class bands where
    every class fits one (`build_class_bands`, never at W <= 16), else with
    `class_bits`."""
    W = index.bitset_words
    if inline_ok and W <= INLINE_BITS_MAX_WORDS:
        tables = None
        if group_ok and W <= GROUP_MAX_WORDS:
            tables = build_group_tables(index)
        if tables is None:
            tables = build_mono_tables(index)
        if tables is None:
            tables = build_inline_tables(index)
        return tables, partial(tables_from_reference, tables, owned=True)  # built for this call
    class_bits = index.class_bits.view(np.int32)
    if group_ok and index.has_pairs:
        gband = groupband_tables(index)
        if gband is not None:
            return gband, partial(_gband_to_device, gband, W)
        gcls = build_groupcls_tables(index)
        if gcls is not None:
            return {**gcls, "class_bits": class_bits}, partial(
                _class_tables_to_device, gcls, GROUPCLS_KEYS, class_bits, None)
    tables, keys = build_monocls_tables(index), MCLS_KEYS
    if tables is None:
        tables, keys = build_classes_tables(index), CLASSES_KEYS
    bands = build_class_bands(index)
    bandrow = bands[1] if bands else None
    shipped = {"class_bits": class_bits} if bandrow is None else {"class_bandrow": bandrow}
    return {**{k: tables[k] for k in keys}, **shipped}, partial(
        _class_tables_to_device, tables, keys, class_bits, bandrow)
