"""Device tables of the narrow align paths: the W <= 16 branch of
nimble_tpu/align/engine.py:_device_tables, as a dict of int32 tensors.

The builders below are numpy copies of engine.py's `_single_hash_placement`,
`_group_entry_payload`, `_build_group_tables`, `_build_mono_tables` and the
two-choice inline bucket of `_device_tables`, with the same constants, so
that every key lands in the same bucket and slot as in the reference (the
reference module cannot be imported without jax). Each builder returns the
reference's own keys as numpy arrays; `tables_from_reference` turns them
into the port's tensors. One path's tables are shipped, never the arrays it
does not read (`class_bits`, the two-choice bucket beside a mono or group
table); the bitset width W is read off the stash planes (`table_words`).

Group bucket row layout (S = MONO_SLOTS slots):
  [hi x S | lo x S | vs_and (W, S) | vd_and (W, S) | mask x S]
Mono bucket row layout (planar, slot-minor):
  [hi x S | lo x S | vs_bits (W, S) | vd_bits (W, S)]
with its stash shipped as one (n_stash, 2 + 2W) matrix of
  [hi | lo | vs_bits (W) | vd_bits (W)] rows (`mono_stash`).
Two-choice inline bucket row layout (S = BUCKET_SLOTS slots):
  [hi x S | lo x S | vsame x S | vdiff x S | vs_bits (S, W) | vd_bits (S, W)]
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nimble_tpu.index.builder import BUCKET_SLOTS, KmerIndex
from nimble_tpu.index.hashing import bucket_hashes_np

MONO_SLOTS = 4
MONO_MAX_BYTES = 6 << 30
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


def table_words(tables: Dict[str, torch.Tensor]) -> int:
    """Bitset width W of a group, mono or two-choice table set."""
    if "group_stash_vs_and" in tables:
        return int(tables["group_stash_vs_and"].shape[1])
    if "mono_stash" in tables:
        return (int(tables["mono_stash"].shape[1]) - 2) // 2
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
    occ = (index.table_vsame >= 0) | (index.table_vdiff >= 0)
    socc = (index.stash_vsame >= 0) | (index.stash_vdiff >= 0)
    hi = np.concatenate([index.table_hi[occ], index.stash_hi[socc]])
    lo = np.concatenate([index.table_lo[occ], index.stash_lo[socc]])
    vs = np.concatenate([index.table_vsame[occ], index.stash_vsame[socc]])
    vd = np.concatenate([index.table_vdiff[occ], index.stash_vdiff[socc]])
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


def build_inline_tables(index: KmerIndex) -> Dict[str, np.ndarray]:
    """The two-choice inline bucket of engine.py:_device_tables (W <= 16)
    and its stash bitsets, as numpy arrays: the fallback when mono
    placement is infeasible."""
    nb = index.n_buckets
    S = BUCKET_SLOTS
    W = index.bitset_words
    bits_of = _bits_of(index)
    packed = np.empty((nb, 4 * S + 2 * S * W), dtype=np.int32)
    packed[:, 0:S] = index.table_hi.reshape(nb, S).view(np.int32)
    packed[:, S : 2 * S] = index.table_lo.reshape(nb, S).view(np.int32)
    packed[:, 2 * S : 3 * S] = index.table_vsame.reshape(nb, S)
    packed[:, 3 * S : 4 * S] = index.table_vdiff.reshape(nb, S)
    packed[:, 4 * S : 4 * S + S * W] = bits_of(index.table_vsame).reshape(nb, S * W)
    packed[:, 4 * S + S * W :] = bits_of(index.table_vdiff).reshape(nb, S * W)
    return {
        "bucket": packed,
        "stash_hi": index.stash_hi.view(np.int32),
        "stash_lo": index.stash_lo.view(np.int32),
        "stash_vs_bits": bits_of(index.stash_vsame),
        "stash_vd_bits": bits_of(index.stash_vdiff),
    }


def tables_from_reference(np_tables, device) -> Dict[str, torch.Tensor]:
    """The reference's `_device_tables(index)` output, taken as numpy arrays,
    -> the port's tensors on `device`, for the path the reference's
    `_score_mate` would take on them: group, else mono, else two-choice.
    Only that path's entries are carried."""
    # copies only what is not already writable contiguous int32 (a
    # multi-GB table is not duplicated on the host)
    as_t = lambda a: torch.from_numpy(np.require(a, np.int32, ["C", "W"])).to(device)
    if all(k in np_tables for k in GROUP_KEYS):
        return {k: as_t(np_tables[k]) for k in GROUP_KEYS}
    if all(k in np_tables for k in MONO_KEYS):
        stash = np.concatenate(
            [np.asarray(np_tables["mono_stash_hi"])[:, None],
             np.asarray(np_tables["mono_stash_lo"])[:, None],
             np_tables["mono_stash_vs_bits"], np_tables["mono_stash_vd_bits"]],
            axis=1,
        )
        return {"mono_bucket": as_t(np_tables["mono_bucket"]), "mono_stash": as_t(stash)}
    missing = [k for k in INLINE_KEYS if k not in np_tables]
    if missing:
        raise ValueError(f"reference tables carry no group, mono or two-choice entries (missing {missing})")
    return {k: as_t(np_tables[k]) for k in INLINE_KEYS}


def device_tables(index: KmerIndex, device, group_ok: bool = True) -> Dict[str, torch.Tensor]:
    """The tables of one narrow path on `device`, chosen as the reference's
    `_device_tables(index, group_ok=group_ok)` chooses for W <= 16: the
    group table when allowed, the index has group entries, W <= 8 and
    placement fits; else the mono table when placement fits; else the
    two-choice inline bucket."""
    W = index.bitset_words
    if W > INLINE_BITS_MAX_WORDS:
        raise ValueError(f"{W}-word bitsets are wider than the inline paths take ({INLINE_BITS_MAX_WORDS})")
    tables = None
    if group_ok and W <= GROUP_MAX_WORDS:
        tables = build_group_tables(index)
    if tables is None:
        tables = build_mono_tables(index)
    if tables is None:
        tables = build_inline_tables(index)
    return tables_from_reference(tables, device)
