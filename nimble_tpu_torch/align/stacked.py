"""Stacked multi-library alignment: ONE probe per window answers every
library (nimble_tpu/align/stacked.py).

The libraries' canonical entries are merged by key into one table whose
slot payload is the concatenation of each library's bitset segment, so one
row gather answers all L libraries; the per-library tails (window masks,
coverage, orientation, mate combination, score filters) then run on the
word slices [w0:w1] of that payload. A window that matches library A but not
B carries B's miss in B's segment (all-zero bits on the mono stack; mask 0
on the group stack), which B's tail treats exactly as B's standalone engine
treats a miss, so every library's output is its standalone engine's.

Two stacks, chosen as the reference chooses them:
  * the group stack (`build_stacked_group_tables`, `stacked_align_step_group`)
    when every library has group entries with one g, fits the group path
    (W <= GROUP_MAX_WORDS, stride 1), reads are at least k+g-1 long and
    NIMBLE_TPU_NO_GROUP_PROBE is not 1: the window stage at k+g-1 on the
    `kmer_keys` kernel, one merged row gather per probe position
    (`stacked_group_probe`, L mask words a slot), shipped as the reference
    builds it;
  * else the mono stack (`build_stacked_tables`, `stacked_align_step`): the
    window stage at k on `kmer_keys`, the stride slice, and the `mono_probe`
    kernel at S = STACK_SLOTS and W = W_cat, on the table re-laid slot-major
    with its stash as one (n_stash, 2 + 2 W_cat) matrix
    (`tables.tables_from_reference`).

Stacking needs equal k and stride and W_cat = sum of the libraries' W <=
STACK_MAX_WORDS (`StackedEngine.compatible`); a stack whose tables cannot be
placed raises NotStackable, and the pipeline then builds one engine per
library, as the reference does on its ValueError.

What the reference keeps for its TPU relay and this port leaves out: the
scanned multi-chunk dispatch (`scan_chunks`), and the mesh branch (multi-GPU
is ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimble_tpu_torch.config import Config
from nimble_tpu_torch.index.builder import KmerIndex
from nimble_tpu_torch.align.engine import (
    PACKED_EXTRA,
    AlignParams,
    ChunkDispatch,
    _group_keys,
    _score_bits,
    _select_orientation,
    _window_keys,
    chunk_from_per_read,
    combine_mates,
    coverage_score2,
    group_win_matched,
    pack_outputs,
    unpack_outputs,
)
from nimble_tpu_torch.align.kernels import mono_probe
from nimble_tpu_torch.align.tables import (
    GROUP_MAX_WORDS,
    MONO_KEYS,
    _as_tensor,
    _bits_of,
    _group_entry_payload,
    _occupied_entries,
    _single_hash_placement,
    tables_from_reference,
)

# combined bitset width of a stack: up to 2048 (padded) feature bits
STACK_MAX_WORDS = 64
# slots per stacked bucket: narrower rows than the single-library mono
# table because the per-slot payload is L libraries wide
STACK_SLOTS = 2

STACKED_GROUP_KEYS = ("sg_bucket", "sg_stash_hi", "sg_stash_lo", "sg_stash_vs_and",
                      "sg_stash_vd_and", "sg_stash_mask")


class NotStackable(ValueError):
    """The libraries cannot share one stacked table (width, placement or
    an empty key set): align them with one engine each."""


def _lib_entries(index: KmerIndex) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """stacked.py:_lib_entries — one library's occupied canonical entries
    as (key u64, vs_bits, vd_bits), the bits decoded from its class table
    ((n, W) int32; zero = absent orientation)."""
    bits_of = _bits_of(index)
    hi, lo, vs, vd = _occupied_entries(index)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return keys, bits_of(vs), bits_of(vd)


def _seg_offsets(indexes: Sequence[KmerIndex]) -> np.ndarray:
    """Each library's first word in the concatenated payload, and W_cat."""
    offs = np.zeros(len(indexes) + 1, dtype=np.int64)
    np.cumsum([ix.bitset_words for ix in indexes], out=offs[1:])
    return offs


def _merge(per_lib, offs: np.ndarray, fill: int):
    """Union of the libraries' keys (sorted) and each key's concatenated
    (vs, vd) payload, `fill` in the segments of libraries without the key.
    Returns (keys, vs_cat, vd_cat, positions of each library's keys)."""
    all_keys = np.unique(np.concatenate([e[0] for e in per_lib]))
    W_cat = int(offs[-1])
    vs_cat = np.full((all_keys.shape[0], W_cat), fill, dtype=np.int32)
    vd_cat = np.full((all_keys.shape[0], W_cat), fill, dtype=np.int32)
    where = []
    for li, (keys, vsb, vdb, *_rest) in enumerate(per_lib):
        pos = np.searchsorted(all_keys, keys)
        vs_cat[pos, offs[li] : offs[li + 1]] = vsb
        vd_cat[pos, offs[li] : offs[li + 1]] = vdb
        where.append(pos)
    return all_keys, vs_cat, vd_cat, where


def _place(all_keys: np.ndarray, planes, entry: int, S: int):
    """Single-hash placement of the merged keys and their payload planes
    (each (n, width) int32): the (nb2, S * entry) table of rows
    [hi x S | lo x S | plane 0 (width, S) | plane 1 ...] and the stash rows
    of each, padded to at least one row with hi = -1 (no canonical key has
    it). None when placement blows its budget."""
    hi = (all_keys >> np.uint64(32)).astype(np.uint32)
    lo = (all_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    placement = _single_hash_placement(hi, lo, entry, S)
    if placement is None:
        return None
    nb2, b, s, keys_idx, skeys = placement
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys_idx].view(np.int32)
    table[b, S + s] = lo[keys_idx].view(np.int32)
    col = 2 * S
    for plane in planes:
        for w in range(plane.shape[1]):
            table[b, col + w * S + s] = plane[keys_idx, w]
        col += plane.shape[1] * S
    n_stash = int(skeys.shape[0])
    pad = max(1, n_stash)
    st_hi = np.full(pad, -1, dtype=np.int32)
    st_lo = np.zeros(pad, dtype=np.int32)
    st_planes = [np.zeros((pad, p.shape[1]), dtype=np.int32) for p in planes]
    if n_stash:
        st_hi[:n_stash] = hi[skeys].view(np.int32)
        st_lo[:n_stash] = lo[skeys].view(np.int32)
        for sp, p in zip(st_planes, planes):
            sp[:n_stash] = p[skeys]
    return table, st_hi, st_lo, st_planes


def build_stacked_tables(indexes: Sequence[KmerIndex]) -> Optional[dict]:
    """stacked.py:build_stacked_tables as numpy arrays: the libraries'
    entries merged by canonical key into one mono table (the reference's
    planar, slot-minor layout) whose slot payload is [vs_all | vd_all],
    vs_all = lib 0's vs | lib 1's vs | ..., with the reference's mono keys
    and ("seg_words", offsets). None when the stack is wider than
    STACK_MAX_WORDS, holds no key or cannot be placed."""
    offs = _seg_offsets(indexes)
    W_cat = int(offs[-1])
    if W_cat > STACK_MAX_WORDS:
        return None
    per_lib = [_lib_entries(ix) for ix in indexes]
    if sum(e[0].shape[0] for e in per_lib) == 0:
        return None
    all_keys, vs_cat, vd_cat, _ = _merge(per_lib, offs, 0)
    placed = _place(all_keys, (vs_cat, vd_cat), 2 + 2 * W_cat, STACK_SLOTS)
    if placed is None:
        return None
    table, st_hi, st_lo, (st_vs, st_vd) = placed
    return {
        "mono_bucket": table,
        "mono_stash_hi": st_hi,
        "mono_stash_lo": st_lo,
        "mono_stash_vs_bits": st_vs,
        "mono_stash_vd_bits": st_vd,
        "seg_words": tuple(int(v) for v in offs),
    }


def build_stacked_group_tables(indexes: Sequence[KmerIndex]) -> Optional[dict]:
    """stacked.py:build_stacked_group_tables as numpy arrays: the merged
    group table, rows
      [hi x S | lo x S | vs_and (W_cat, S) | vd_and (W_cat, S) |
       mask_lib0 x S | ... | mask_lib{L-1} x S]
    with S = STACK_SLOTS. A key absent from library li carries mask 0 and
    the AND identity (-1) in li's segment. Returns the sg_* arrays with
    ("seg_words", offsets) and ("pair_g", g), or None when the libraries
    lack group entries of one g, the stack is too wide, holds no key or
    cannot be placed (the caller then takes the mono stack)."""
    if not all(ix.has_pairs for ix in indexes):
        return None
    gs = {ix.pair_g for ix in indexes}
    if len(gs) != 1:
        return None
    offs = _seg_offsets(indexes)
    W_cat = int(offs[-1])
    L_libs = len(indexes)
    if W_cat > STACK_MAX_WORDS:
        return None
    per_lib = []
    for ix in indexes:
        vs_and, vd_and, mask_word = _group_entry_payload(ix, _bits_of(ix))
        keys = (ix.pair_hi.astype(np.uint64) << np.uint64(32)) | ix.pair_lo.astype(np.uint64)
        per_lib.append((keys, vs_and, vd_and, mask_word))
    if sum(e[0].shape[0] for e in per_lib) == 0:
        return None
    all_keys, vs_cat, vd_cat, where = _merge(per_lib, offs, -1)
    masks = np.zeros((all_keys.shape[0], L_libs), dtype=np.int32)
    for li, pos in enumerate(where):
        masks[pos, li] = per_lib[li][3]
    placed = _place(all_keys, (vs_cat, vd_cat, masks), 2 + 2 * W_cat + L_libs, STACK_SLOTS)
    if placed is None:
        return None
    table, st_hi, st_lo, (st_vs, st_vd, st_mask) = placed
    return {
        "sg_bucket": table,
        "sg_stash_hi": st_hi,
        "sg_stash_lo": st_lo,
        "sg_stash_vs_and": st_vs,
        "sg_stash_vd_and": st_vd,
        "sg_stash_mask": st_mask,
        "seg_words": tuple(int(v) for v in offs),
        "pair_g": gs.pop(),
    }


def stacked_group_probe(hi_i, lo_i, h1, fwd_c, valid, tables, W_cat: int, g: int):
    """stacked.py:stacked_group_probe — engine.group_probe over the merged
    table, with L mask words a slot. Returns (and_f (B, Q, W_cat), mask_f
    (B, Q, L), and_r, mask_r): per-library g-bit window-presence fields in
    forward coordinates."""
    B, Q = hi_i.shape
    S = STACK_SLOTS
    L_libs = tables["sg_stash_mask"].shape[1]
    row = tables["sg_bucket"][h1.long()]  # (B, Q, S * entry)
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, Q, 1, S)
    zero = torch.zeros((), dtype=torch.int32, device=row.device)
    planes = row[..., 2 * S :].reshape(B, Q, 2 * W_cat + L_libs, S)
    # at most one slot matches (keys are unique): the int64 sum holds
    # exactly that slot's int32 word
    picked = torch.where(sel, planes, zero).sum(dim=3).to(torch.int32)
    vs_and, vd_and = picked[..., :W_cat], picked[..., W_cat : 2 * W_cat]
    mword = picked[..., 2 * W_cat :]  # (B, Q, L)
    for s in range(tables["sg_stash_hi"].shape[0]):
        m = ((tables["sg_stash_hi"][s] == hi_i) & (tables["sg_stash_lo"][s] == lo_i))[..., None]
        vs_and = vs_and | torch.where(m, tables["sg_stash_vs_and"][s], zero)
        vd_and = vd_and | torch.where(m, tables["sg_stash_vd_and"][s], zero)
        mword = mword | torch.where(m, tables["sg_stash_mask"][s], zero)

    gmask = (1 << g) - 1
    fc = fwd_c[..., None]
    and_f = torch.where(fc, vs_and, vd_and)
    and_r = torch.where(fc, vd_and, vs_and)
    # `>>` is arithmetic on int32: the & gmask keeps only the g-bit field
    mask_f = torch.where(fc, mword, mword >> 8) & gmask
    mask_r = torch.where(fc, mword >> 24, mword >> 16) & gmask
    v = valid[..., None]
    return and_f, torch.where(v, mask_f, zero), and_r, torch.where(v, mask_r, zero)


def group_window(codes, lens, tables, p0: AlignParams, g: int):
    """The group stack's window stage (stacked.py:_group_rows' first half):
    the kmer_keys kernel at k+g-1, then the grid and tail probe keys
    (engine._group_keys) -> (jstar, planes)."""
    return _group_keys(codes, lens, p0.k + g - 1, g, tables["sg_bucket"].shape[0])


def group_probe_rows(keys, tables, W_cat: int, g: int):
    """ONE merged-table probe per position, shared by every library ->
    (and_f, mask_f, and_r, mask_r, Q, jstar)."""
    jstar, cat = keys
    and_f, mask_f, and_r, mask_r = stacked_group_probe(*cat, tables, W_cat, g)
    return and_f, mask_f, and_r, mask_r, cat[0].shape[1] - 1, jstar


def group_tail(rows, codes, lens, p: AlignParams, li: int, w0: int, w1: int, g: int):
    """Library li's tail of one mate on the group stack: its window masks
    and coverage, then the orientation and the AND over its word slice
    [w0:w1] -> (bits, score, score_f, score_r)."""
    and_f, mask_f, and_r, mask_r, Q, jstar = rows
    L = codes.shape[1]
    P = L - p.k + 1
    mf, mr = mask_f[..., li], mask_r[..., li]
    sf, sr = coverage_score2(group_win_matched(mf, Q, g, P, jstar),
                             group_win_matched(mr, Q, g, P, jstar), lens, p.k, L, 1)
    return _select_orientation(and_f[..., w0:w1], and_r[..., w0:w1], mf != 0, mr != 0, sf, sr, p)


def mono_window(codes, lens, tables, p0: AlignParams):
    """The mono stack's window stage (stacked.py:_probe_rows' first half):
    the kmer_keys kernel at k and the stride slice (contiguous planes)."""
    return _window_keys(codes, lens, tables["mono_bucket"].shape[0], p0)


def mono_probe_rows(keys, tables, W_cat: int):
    """ONE mono_probe kernel launch over the merged table at S =
    STACK_SLOTS, W = W_cat -> (bits_f, bits_r), each (B, P, W_cat)."""
    hi_i, lo_i, h1, _h2, fc, pal, valid = keys
    return mono_probe(tables["mono_bucket"], h1, hi_i, lo_i, fc, pal, valid, tables["mono_stash"], W_cat)


def mono_tail(rows, codes, lens, p: AlignParams, li: int, w0: int, w1: int):
    """Library li's tail of one mate on the mono stack: matched windows and
    coverage from its word slice [w0:w1], the orientation and the AND."""
    return _score_bits(rows[0][..., w0:w1], rows[1][..., w0:w1], lens, codes.shape[1], p)


def library_tails(params: Sequence[AlignParams], seg_words: Sequence[int], tail, mates, rows) -> List[dict]:
    """Each library's outputs: `tail(rows[m], codes, lens, p, li, w0, w1)`
    of each mate m (mates: [(codes, lens)] or two), then combine_mates with
    the library's own params."""
    outs = []
    for li, p in enumerate(params):
        w0, w1 = int(seg_words[li]), int(seg_words[li + 1])
        m = [tail(r, codes, lens, p, li, w0, w1) for r, (codes, lens) in zip(rows, mates)]
        r2 = (mates[1][1], m[1]) if len(m) > 1 else (None, None)
        outs.append(combine_mates(p, mates[0][1], m[0], *r2))
    return outs


def _mates(r1_codes, r1_lens, r2_codes, r2_lens):
    return [(r1_codes, r1_lens)] + ([(r2_codes, r2_lens)] if r2_codes is not None else [])


def stacked_align_step_group(tables, params: Sequence[AlignParams], seg_words: Sequence[int], g: int,
                             r1_codes, r1_lens, r2_codes=None, r2_lens=None) -> List[dict]:
    """stacked.py:stacked_align_step_group — one merged group probe stream
    per mate; per library its window masks, coverage, orientation and mate
    combination. Returns one align_step output dict per library."""
    W_cat = int(seg_words[-1])
    mates = _mates(r1_codes, r1_lens, r2_codes, r2_lens)
    rows = [group_probe_rows(group_window(c, ln, tables, params[0], g), tables, W_cat, g) for c, ln in mates]
    return library_tails(params, seg_words, lambda *a: group_tail(*a, g), mates, rows)


def stacked_align_step(tables, params: Sequence[AlignParams], seg_words: Sequence[int],
                       r1_codes, r1_lens, r2_codes=None, r2_lens=None) -> List[dict]:
    """stacked.py:stacked_align_step — one mono probe per mate, L
    per-library tails. Returns one align_step output dict per library."""
    W_cat = int(seg_words[-1])
    mates = _mates(r1_codes, r1_lens, r2_codes, r2_lens)
    rows = [mono_probe_rows(mono_window(c, ln, tables, params[0]), tables, W_cat) for c, ln in mates]
    return library_tails(params, seg_words, mono_tail, mates, rows)


def pack_stacked(outs: List[dict]) -> torch.Tensor:
    """The libraries' outputs -> ONE flat int32 tensor, row-major (B,
    sum of (W_l + PACKED_EXTRA)): each row the libraries' pack_outputs rows
    side by side."""
    B = outs[0]["score"].shape[0]
    return torch.cat([pack_outputs(o).reshape(B, -1) for o in outs], dim=1).reshape(-1)


class StackedEngine(ChunkDispatch):
    """stacked.py:StackedEngine — AlignEngine's batch interface on one
    device, but one step returns every library's outputs from a single probe
    stream. `path` is "stacked-group" or "stacked-mono"; the wire is the
    full format, each library's (B, W_l + 3) rows side by side."""

    wire = "full"

    @staticmethod
    def compatible(indexes: Sequence[KmerIndex], configs: Sequence[Config]) -> bool:
        """Equal k, equal stride and a combined width within
        STACK_MAX_WORDS (stacked.py:438)."""
        ks = {ix.k for ix in indexes}
        strides = {int(getattr(c, "kmer_stride", 1)) for c in configs}
        if len(ks) != 1 or len(strides) != 1:
            return False
        return sum(ix.bitset_words for ix in indexes) <= STACK_MAX_WORDS

    def __init__(
        self,
        indexes: Sequence[KmerIndex],
        configs: Sequence[Config],
        device: torch.device,
        strand_filter: str = "unstranded",
        chunk_size: Optional[int] = 2048,
        max_len: int = 256,
        paired: bool = False,
        chunk_cap: Optional[int] = None,
    ):
        self.indexes = list(indexes)
        self.device = torch.device(device)
        self.max_len = max(max_len, indexes[0].k)
        self.paired = paired
        self.params = [AlignParams.from_config(c, ix, strand_filter) for c, ix in zip(configs, indexes)]
        self._check_max_len()

        # the group stack first, under the gates of AlignEngine's group mode
        # for every library, so that stacked and per-library outputs stay
        # byte-identical for any mix of widths (stacked.py:468-479)
        group_ok = (
            all(ix.has_pairs for ix in indexes)
            and len({ix.pair_g for ix in indexes}) == 1
            and all(ix.bitset_words <= GROUP_MAX_WORDS for ix in indexes)
            and all(p.stride == 1 for p in self.params)
            and self.max_len >= indexes[0].k + indexes[0].pair_g - 1
            and os.environ.get("NIMBLE_TPU_NO_GROUP_PROBE", "") != "1"
        )
        np_tables = build_stacked_group_tables(indexes) if group_ok else None
        self.group_g = 0
        if np_tables is not None:
            self.group_g = int(np_tables.pop("pair_g"))
        else:
            np_tables = build_stacked_tables(indexes)
        if np_tables is None:
            raise NotStackable("libraries not stackable (width/memory budget)")
        self.seg_words = np_tables.pop("seg_words")
        if self.group_g:
            self.tables: Dict[str, torch.Tensor] = {k: _as_tensor(np_tables[k], self.device)
                                                    for k in STACKED_GROUP_KEYS}
        else:
            # re-laid slot-major with its stash as one matrix, as mono_probe reads it
            self.tables = tables_from_reference({k: np_tables[k] for k in MONO_KEYS}, self.device, owned=True)
        self._lib_widths = [int(self.seg_words[i + 1] - self.seg_words[i]) for i in range(len(indexes))]

        if chunk_size is None:
            chunk_size = chunk_from_per_read(self._per_read(), paired, self.device)
            if chunk_cap is not None and chunk_cap < chunk_size:
                # a chunk larger than the read batches would pad every batch
                chunk_size = max(1 << int(np.log2(max(chunk_cap, 1))), 1)
        self.chunk_size = chunk_size

    def _per_read(self) -> int:
        """The stacked step's int32 words of transients per read
        (stacked.py:488-504)."""
        W_cat = int(self.seg_words[-1])
        k = self.indexes[0].k
        P = self.max_len - k + 1
        if self.group_g:
            g = self.group_g
            PP = max(self.max_len - (k + g - 1) + 1, 1)
            Q = (PP + g - 1) // g + 1
            return (Q * STACK_SLOTS * (2 + 2 * W_cat + len(self.indexes)) + 4 * Q * W_cat
                    + (10 * PP + 6 * P) * len(self.indexes))
        return P * STACK_SLOTS * (2 + 2 * W_cat) + 2 * P * W_cat + 10 * P

    @property
    def path(self) -> str:
        return "stacked-group" if self.group_g else "stacked-mono"

    def step_outputs(self, *args) -> List[dict]:
        """One chunk through the stacked step -> one output dict per library."""
        if self.group_g:
            return stacked_align_step_group(self.tables, self.params, self.seg_words, self.group_g, *args)
        return stacked_align_step(self.tables, self.params, self.seg_words, *args)

    def _step(self, *args):
        return pack_stacked(self.step_outputs(*args)), self.wire

    def collect_async(self, pending) -> Optional[List[Dict[str, np.ndarray]]]:
        """Copy dispatched outputs to host numpy and split them by library
        -> one output dict per library (stacked.py:679)."""
        if not pending:
            return None
        row_w = sum(w + PACKED_EXTRA for w in self._lib_widths)
        per_call = [flat.cpu().numpy().reshape(-1, row_w)[:valid] for flat, _wire, valid in pending]
        result = []
        off = 0
        for w in self._lib_widths:
            chunks = [unpack_outputs(np.ascontiguousarray(a[:, off : off + w + PACKED_EXTRA]).reshape(-1),
                                     w, a.shape[0]) for a in per_call]
            result.append({k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]})
            off += w + PACKED_EXTRA
        return result
