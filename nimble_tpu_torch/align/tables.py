"""Group-probe device tables: the group branch of
nimble_tpu/align/engine.py:_device_tables, as a dict of int32 tensors.

The builders below are numpy copies of engine.py's `_single_hash_placement`,
`_group_entry_payload` and `_build_group_tables`, with the same constants, so
that every key lands in the same bucket and slot as in the reference (the
reference module cannot be imported without jax). Only what the group path
reads is built: the group bucket table and its stash. The two-choice
`bucket` table and `class_bits` are not shipped; the bitset width W is read
off the stash planes.

Group bucket row layout (S = MONO_SLOTS slots):
  [hi x S | lo x S | vs_and (W, S) | vd_and (W, S) | mask x S]
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nimble_tpu.index.builder import KmerIndex
from nimble_tpu.index.hashing import bucket_hashes_np

MONO_SLOTS = 4
MONO_MAX_BYTES = 6 << 30
MONO_MAX_STASH = 64
MONO_TIGHT_STASH = 8
GROUP_MAX_WORDS = 8

GROUP_KEYS = (
    "group_bucket",
    "group_stash_hi",
    "group_stash_lo",
    "group_stash_vs_and",
    "group_stash_vd_and",
    "group_stash_mask",
)


def group_words(tables: Dict[str, torch.Tensor]) -> int:
    """Bitset width W of a group table set."""
    return int(tables["group_stash_vs_and"].shape[1])


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


def tables_from_reference(np_tables, device) -> Dict[str, torch.Tensor]:
    """The reference's `_device_tables(index)` output, taken as numpy arrays,
    -> the port's tensors on `device`. Only the group entries are carried."""
    missing = [k for k in GROUP_KEYS if k not in np_tables]
    if missing:
        raise ValueError(f"reference tables have no group entries (missing {missing})")
    return {
        k: torch.from_numpy(np.array(np_tables[k], dtype=np.int32)).to(device)
        for k in GROUP_KEYS
    }


def device_tables(index: KmerIndex, device) -> Optional[Dict[str, torch.Tensor]]:
    """Group-probe tables on `device`, or None when the index cannot take the
    narrow group path (W > GROUP_MAX_WORDS, no group entries, or infeasible
    placement)."""
    if index.bitset_words > GROUP_MAX_WORDS:
        return None
    tables = build_group_tables(index)
    if tables is None:
        return None
    return tables_from_reference(tables, device)
