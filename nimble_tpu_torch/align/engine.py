"""The align steps and their engine, in torch.

Ports every path of nimble_tpu/align/engine.py:_score_mate:
  * group (`_score_mate_group`, W <= 8): per mate, the window stage at
    k+g-1 (`kernels.kmer_keys`), one group-table row gather per probe
    position (`group_probe`), window masks and coverage scores for both
    orientations, orientation select and the AND intersection;
  * gband (`_score_mate_groupband`, W > 16): the same window stage and
    probe grid, one packed probe-row gather per position and bucket
    (`gband_probe`: one bucket under single-hash placement, two under
    two-choice, each through a pointer row in the indirect layout),
    masks and scores, the orientation chosen from the masks alone, then the
    selected orientation's band rows gathered, ANDed and expanded to W words
    (`kernels.band_tree_expand`);
  * groupcls (`_score_mate_classes`, W > 16 when gband cannot be built):
    the same window stage and probe grid, the probe rows carrying the g
    windows' class ids (`groupcls_probe`), masks and scores, the orientation
    chosen from the scores, then the class-bits intersection of the
    selected orientation's classes (`kernels.intersect_class_bits`);
  * mono (`_score_mate_mono`): the window stage at k, the stride slice, the
    fused mono-table probe (`kernels.mono_probe`), coverage and the same
    orientation select and AND;
  * two-choice inline (`_score_mate_inline`), the fallback when mono
    placement is infeasible: the window stage at k and `lookup_inline_bits`
    in plain torch (the reference has no kernel for it);
  * monocls and the wide two-choice probe (`_score_mate_classes`, W > 16
    without the group probe): the window stage at k, the stride slice, one
    class-id probe per window (`lookup_monocls`, or `lookup_classes` when
    monocls placement is infeasible), coverage, the orientation, then the
    selected classes intersected over `class_bits`
    (`kernels.intersect_class_bits`) or, where every class fits a 2-page
    band, over their band rows (`intersect_class_bands`:
    `kernels.band_tree_expand`);
then mate combination, score filters and the output wire: the full
`pack_outputs` format, or on the gband path the reference's device emit cap
with its idlist wire (`pack_outputs_idlist`) or band rows. Every function is
held bit for bit against its reference counterpart (tests/test_torch_*.py).

Exactness rules that torch imposes (the reference computes in uint32 and
int32 under XLA):
  * `>>` on an int32 tensor is arithmetic, so every right shift of a packed
    word is masked to the field it extracts;
  * `sum` over int32 returns int64: slot-select sums are cast back to int32
    (at most one term is nonzero, so the cast is exact);
  * indices are int64 (`.long()`);
  * the `score_percent * len` compare is float32 on both sides.

What the reference keeps for its TPU relay and this port leaves out: the
scanned multi-chunk dispatch, `_to_host`, the compact dictionary codec and
its overflow rerun, and the CPU chunk cap keyed on the JAX backend. The
reference picks its gband wire only on the scanned TPU dispatch; the port
picks it on every device, since both give the same TSV and the dense
(B, W) rows cost the host far more to resolve than ids.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nimble_tpu_torch import observability as obs
from nimble_tpu_torch.config import Config
from nimble_tpu_torch.index.builder import BUCKET_SLOTS, STASH_SIZE, KmerIndex
from nimble_tpu_torch.align.kernels import (
    N_CODE,
    RUN_BLOCK,
    _to_i32,
    and_reduce_bits,
    band_tree_expand,
    intersect_class_bits,
    kmer_keys,
    mono_probe,
)
from nimble_tpu_torch.align.tables import (
    GROUP_MAX_WORDS,
    INLINE_BITS_MAX_WORDS,
    MONO_SLOTS,
    build_class_bands,
    device_tables,
    table_words,
)


@dataclass(frozen=True)
class AlignParams:
    """Static alignment parameters derived from Config (engine.py:48)."""

    k: int
    n_buckets: int
    score_threshold: int
    score_filter: int
    score_percent: float
    intersect_level: int
    require_valid_pair: bool
    strand_filter: str  # "unstranded" | "fiveprime" | "threeprime"
    stride: int = 1
    # windows per group-probe row (0 = no group table; set by AlignEngine)
    group_g: int = 0

    @classmethod
    def from_config(cls, config: Config, index: KmerIndex, strand_filter: str = "unstranded"):
        return cls(
            k=index.k,
            n_buckets=index.n_buckets,
            score_threshold=int(config.score_threshold),
            score_filter=int(config.score_filter),
            score_percent=float(config.score_percent),
            intersect_level=int(config.intersect_level),
            require_valid_pair=bool(config.require_valid_pair),
            strand_filter=strand_filter,
            stride=int(getattr(config, "kmer_stride", 1)),
        )


# auto chunk sizing (engine.py:135-204): budget the dominant per-read
# intermediates against ~1 GB of device transients, rounded to a power of two
AUTO_CHUNK_BUDGET = 1 << 30
AUTO_CHUNK_MIN = 1 << 10
AUTO_CHUNK_MAX = 1 << 17
CPU_CHUNK_MAX = 1 << 13  # keeps host RAM sane when the device is the CPU

# packed-output columns after the W bits words (engine.py:1146)
PACKED_EXTRA = 3
MAX_LEN_LIMIT = 16383  # keeps every score strictly inside a uint16 half


def auto_chunk_size(index: KmerIndex, max_len: int, paired: bool,
                    device: torch.device, group_ok: bool = True,
                    band_words: int = 0) -> int:
    """Largest power-of-two chunk whose working set on the engine's path
    fits AUTO_CHUNK_BUDGET, by the reference's formulas (engine.py:156):
    group when group_ok and the index has group entries at W <= 8; the
    W <= 16 mono/inline path; at W > 16 with group_ok and group entries,
    the banded group formula, else groupcls's; else monocls's (or the wide
    two-choice's), with banded rows where the strict class bands exist. On
    the CPU at most CPU_CHUNK_MAX. A gband engine passes its 2 Pw-word bands
    as `band_words`: the reference sizes a library that only its robust
    banding takes by its groupcls formula, the port every gband engine by
    the bands it runs."""
    k = index.k
    L = max(max_len, k)
    P = L - k + 1
    W = index.bitset_words
    S = BUCKET_SLOTS
    if group_ok and index.has_pairs and W <= GROUP_MAX_WORDS:
        g = index.pair_g
        PP = max(L - (k + g - 1) + 1, 1)
        Q = (PP + g - 1) // g + 1
        per_read = Q * S * (2 + 2 * W + 1) + 4 * Q * W + 10 * PP + 6 * P
    elif W <= INLINE_BITS_MAX_WORDS:
        per_read = P * S * (2 + 2 * W) + 2 * P * W + 10 * P
    elif group_ok and index.has_pairs:
        g = index.pair_g
        PP = max(L - (k + g - 1) + 1, 1)
        Q = (PP + g - 1) // g + 1
        if not band_words:
            bands = build_class_bands(index)
            band_words = 2 * bands[0] if bands is not None else 0
        if band_words:
            # 20-word probe rows + one (1 + Wb)-word band row per position,
            # with the plain band tree's transients ~3x (engine.py:183-187)
            per_read = Q * (5 * MONO_SLOTS + 3 * (1 + band_words)) + 10 * PP
        else:
            # groupcls: probe rows S (2 + 2g + 1) per group position plus the
            # runs intersection's (chunk, RUN_BLOCK, W) block
            per_read = Q * MONO_SLOTS * (2 + 2 * g + 1) + 6 * Q * g + 10 * PP + RUN_BLOCK * W
    else:
        # monocls or the wide two-choice probe
        bands = build_class_bands(index)
        blk = RUN_BLOCK * ((1 + 4 * bands[0]) if bands is not None else W)
        per_read = P * 4 * MONO_SLOTS + 12 * P + blk
    return chunk_from_per_read(per_read, paired, device)


def chunk_from_per_read(per_read: int, paired: bool, device: torch.device) -> int:
    """engine.py:_chunk_from_per_read — the largest power-of-two chunk whose
    `per_read` int32 words of transients a read (each mate) fit
    AUTO_CHUNK_BUDGET; on the CPU at most CPU_CHUNK_MAX."""
    bytes_per_read = per_read * 4 * (2 if paired else 1)
    chunk = 1 << int(np.log2(max(AUTO_CHUNK_BUDGET // max(bytes_per_read, 1), 1)))
    if device.type == "cpu":
        chunk = min(chunk, CPU_CHUNK_MAX)
    return int(np.clip(chunk, AUTO_CHUNK_MIN, AUTO_CHUNK_MAX))


def pack_outputs(out: dict) -> torch.Tensor:
    """align_step outputs -> ONE flat int32 tensor, row-major (B, W+3):
    bits | score|r1_fwd<<16 | r1_rev|r2_fwd<<16 | r2_rev|pass_<<16."""
    s = {k: out[k].to(torch.int32) for k in ("score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev")}
    c0 = s["score"] | (s["r1_fwd"] << 16)
    c1 = s["r1_rev"] | (s["r2_fwd"] << 16)
    c2 = s["r2_rev"] | (out["pass_"].to(torch.int32) << 16)
    cols = [out["bits"].to(torch.int32), c0[:, None], c1[:, None], c2[:, None]]
    return torch.cat(cols, dim=1).reshape(-1)


def unpack_outputs(flat: np.ndarray, W: int, valid: int) -> dict:
    """Host-side inverse of pack_outputs, sliced to the valid row count."""
    arr = flat.reshape(-1, W + PACKED_EXTRA)[:valid]
    lo = lambda c: arr[:, W + c] & 0xFFFF
    hi = lambda c: (arr[:, W + c] >> 16) & 0xFFFF
    return {
        "bits": arr[:, :W],
        "score": lo(0),
        "r1_fwd": hi(0),
        "r1_rev": lo(1),
        "r2_fwd": hi(1),
        "r2_rev": lo(2),
        "pass_": (hi(2) & 1).astype(bool),
    }


def popcount32_rows(words: torch.Tensor) -> torch.Tensor:
    """engine.py:_popcount32_rows — (B, W) int32 -> (B,) set-bit count, the
    feature-set size. Computed on the uint32 value held in int64, so no
    int32 product overflows."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0x3F).sum(dim=1)


def compress_band_rows(bits: torch.Tensor, Pw: int) -> torch.Tensor:
    """engine.py:compress_band_rows — (B, W) bitsets -> (B, 1 + 2 Pw) rows
    [page | band] anchored at the first nonzero page. Exact for every gband
    result except the paired intersect_level = 1 union, which the engine
    ships in the full format."""
    B, W = bits.shape
    n_pages = -(-W // Pw)
    bp = F.pad(bits, (0, (n_pages + 1) * Pw - W))
    page_has = (bp[:, : n_pages * Pw].reshape(B, n_pages, Pw) != 0).any(dim=2)
    page = torch.argmax(page_has.to(torch.int8), dim=1)  # first nonzero page, else 0
    cols = page[:, None] * Pw + torch.arange(2 * Pw, device=bits.device)[None, :]
    band = torch.gather(bp, 1, cols)
    return torch.cat([page.to(torch.int32)[:, None], band], dim=1)


def pack_outputs_idlist(out: dict, cap: int, Pw: int, packed16: bool = False,
                        hdr1: bool = False) -> torch.Tensor:
    """engine.py:pack_outputs_idlist — the gband emission wire when the emit
    cap is on: per read a header [score | r1_fwd<<16, r2_fwd<<14 | pass_<<28]
    (hdr1: one word score | r1_fwd<<10 | r2_fwd<<19 | pass_<<28) and the
    class's feature ids, the top `cap` set-bit positions of its band row
    (`out["_band"]`, from compress_band_rows) in descending order, -1 padded
    (all -1 for rows that do not pass); packed16 ships the ids as int16
    pairs with 0xFFFF for absent. Flat int32."""
    band = out["_band"]
    C = band.shape[0]
    dev = band.device
    is_pass = out["pass_"].to(torch.int32) == 1
    base = band[:, 0] * (Pw * 32)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    nb = 2 * Pw
    pos = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None] * 32 + shifts[None, None, :]
    b = (band[:, 1:, None] >> shifts[None, None, :]) & 1  # (C, nb, 32) band bits
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    vals = torch.where(b == 1, pos, neg).reshape(C, nb * 32)
    # the only ties are the -1 fill, so the top values are exact
    top = torch.topk(vals, cap, dim=1).values
    ids = torch.where((top >= 0) & is_pass[:, None], base[:, None] + top, neg)
    score = out["score"].to(torch.int32)
    f1 = out["r1_fwd"].to(torch.int32)
    f2 = out["r2_fwd"].to(torch.int32)
    pass_ = out["pass_"].to(torch.int32)
    if hdr1:
        hdr = (score | (f1 << 10) | (f2 << 19) | (pass_ << 28))[:, None]
    else:
        hdr = torch.stack([score | (f1 << 16), (f2 << 14) | (pass_ << 28)], dim=1)
    if packed16:
        idu = torch.where(ids >= 0, ids, torch.full((), 0xFFFF, dtype=torch.int32, device=dev)).long()
        if cap & 1:
            idu = torch.cat([idu, torch.full((C, 1), 0xFFFF, dtype=torch.int64, device=dev)], dim=1)
        ids = _to_i32(idu[:, 0::2] | (idu[:, 1::2] << 16))
    return torch.cat([hdr, ids], dim=1).reshape(-1)


def unpack_outputs_idlist(flat: np.ndarray, C: int, cap: int, valid: int,
                          packed16: bool = False, hdr1: bool = False) -> dict:
    """engine.py:unpack_outputs_idlist — host inverse of pack_outputs_idlist:
    ids (valid, cap), -1 padded; scores and pass_ as int; rev scores 0."""
    nh = 1 if hdr1 else 2
    row_w = nh + (((cap + 1) // 2) if packed16 else cap)
    if flat.size % (C * row_w) != 0:
        raise ValueError(
            f"payload size {flat.size} not a multiple of idlist chunk length {C * row_w} "
            f"(C={C}, cap={cap}, packed16={packed16}, hdr1={hdr1})")
    rows = flat.reshape(-1, row_w)
    ids = rows[:, nh:][:valid]
    if packed16:
        n = ids.shape[0]
        un = np.empty((n, 2 * ids.shape[1]), dtype=np.int32)
        un[:, 0::2] = ids & 0xFFFF
        un[:, 1::2] = (ids >> 16) & 0xFFFF
        un[un == 0xFFFF] = -1
        ids = un[:, :cap]
    if hdr1:
        w = rows[:, 0]
        score, f1, f2, pass_ = w & 0x3FF, (w >> 10) & 0x1FF, (w >> 19) & 0x1FF, (w >> 28) & 1
    else:
        w0, w1 = rows[:, 0], rows[:, 1]
        score, f1, f2, pass_ = w0 & 0xFFFF, (w0 >> 16) & 0xFFFF, (w1 >> 14) & 0x3FFF, (w1 >> 28) & 1
    return {
        "ids": ids,
        "score": score[:valid],
        "r1_fwd": f1[:valid],
        "r1_rev": np.zeros(valid, np.int32),
        "r2_fwd": f2[:valid],
        "r2_rev": np.zeros(valid, np.int32),
        "pass_": pass_[:valid],
    }


def expand_band_rows_np(rows: np.ndarray, Pw: int, W: int) -> np.ndarray:
    """engine.py:expand_band_rows_np — host inverse of compress_band_rows:
    (N, 1 + 2 Pw) -> (N, W)."""
    n = rows.shape[0]
    n_pages = -(-W // Pw)
    out = np.zeros((n, (n_pages + 1) * Pw), dtype=np.int32)
    cols = rows[:, 0][:, None] * Pw + np.arange(2 * Pw)[None, :]
    np.put_along_axis(out, cols, rows[:, 1:], axis=1)
    return out[:, :W]


def ids_to_bits_np(ids: np.ndarray, W: int) -> np.ndarray:
    """engine.py:ids_to_bits_np — (n, cap) feature-id rows, -1 padded ->
    dense (n, W) int32 bitsets."""
    n = ids.shape[0]
    bits = np.zeros((n, W * 32), dtype=np.uint8)
    rows, _ = np.nonzero(ids >= 0)
    bits[rows, ids[ids >= 0]] = 1
    packed = np.packbits(bits.reshape(n, W, 32), axis=2, bitorder="little")
    return packed.view("<u4").reshape(n, W).astype(np.int32)


def emit_cap_of(config: Config) -> int:
    """The reference's device emit cap (engine.py:2958-2967): with group_on
    empty, host emission drops every class larger than max_hits_to_report
    (or the discard_multiple_matches / discard_multi_hits bounds), so the
    device clears pass_ for them; 0 (off) when group_on is set."""
    if str(getattr(config, "group_on", "") or ""):
        return 0
    cap = int(getattr(config, "max_hits_to_report", 0) or 0)
    if getattr(config, "discard_multiple_matches", False):
        cap = min(cap, 1) if cap else 1
    dmh = int(getattr(config, "discard_multi_hits", 0) or 0)
    if dmh > 0:
        cap = min(cap, dmh) if cap else dmh
    return max(cap, 0)


def unpack_reads(words: torch.Tensor, L: int, nflags: Optional[torch.Tensor] = None):
    """Inverse of io.packing.pack_codes: (B, ceil(L/16)) int32 packed words ->
    (B, L) int8 base codes, with N_CODE restored at flagged positions."""
    B, Lw = words.shape
    dev = words.device
    rep = words[:, :, None].expand(B, Lw, 16).reshape(B, Lw * 16)[:, :L]
    sh = torch.from_numpy((2 * (np.arange(L) % 16)).astype(np.int32)).to(dev)
    codes = ((rep >> sh[None, :]) & 3).to(torch.int8)
    if nflags is not None:
        Lf = nflags.shape[1]
        nrep = nflags[:, :, None].expand(B, Lf, 32).reshape(B, Lf * 32)[:, :L]
        nsh = torch.from_numpy((np.arange(L) % 32).astype(np.int32)).to(dev)
        isn = ((nrep >> nsh[None, :]) & 1) != 0
        codes = torch.where(isn, torch.tensor(N_CODE, dtype=torch.int8, device=dev), codes)
    return codes


def group_probe(hi_i, lo_i, h1, fwd_c, valid, tables, W: int, g: int):
    """engine.py:group_probe — ONE group-table row gather per probe position
    answers g read windows in both orientations. Returns (and_f, mask_f,
    and_r, mask_r): the pre-ANDed (B, Q, W) int32 bitsets and (B, Q) g-bit
    window-presence masks of the read's forward / reverse orientation, in
    forward coordinates."""
    B, Q = hi_i.shape
    bucket = tables["group_bucket"]
    S = bucket.shape[1] // (2 + 2 * W + 1)
    row = bucket[h1.long()]  # (B, Q, S*entry)
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, Q, 1, S)
    vs_and = row[..., 2 * S : 2 * S + W * S].reshape(B, Q, W, S)
    vd_and = row[..., 2 * S + W * S : 2 * S + 2 * W * S].reshape(B, Q, W, S)
    # at most one slot matches (keys are unique): sum-select it
    zero = torch.zeros((), dtype=torch.int32, device=row.device)
    vs_and = torch.where(sel, vs_and, zero).sum(dim=3).to(torch.int32)
    vd_and = torch.where(sel, vd_and, zero).sum(dim=3).to(torch.int32)
    mword = torch.where(match, row[..., 2 * S + 2 * W * S :], zero).sum(dim=2).to(torch.int32)
    for s in range(tables["group_stash_hi"].shape[0]):
        m = (tables["group_stash_hi"][s] == hi_i) & (tables["group_stash_lo"][s] == lo_i)
        vs_and = vs_and | torch.where(m[..., None], tables["group_stash_vs_and"][s], zero)
        vd_and = vd_and | torch.where(m[..., None], tables["group_stash_vd_and"][s], zero)
        mword = mword | torch.where(m, tables["group_stash_mask"][s], zero)

    gmask = (1 << g) - 1
    fc = fwd_c[..., None]
    and_f = torch.where(fc, vs_and, vd_and)
    and_r = torch.where(fc, vd_and, vs_and)
    # `>>` is arithmetic on int32: the & gmask keeps only the g-bit field
    mask_f = torch.where(fwd_c, mword, mword >> 8) & gmask
    mask_r = torch.where(fwd_c, mword >> 24, mword >> 16) & gmask
    mask_f = torch.where(valid, mask_f, zero)
    mask_r = torch.where(valid, mask_r, zero)
    return and_f, mask_f, and_r, mask_r


def group_win_matched(mask, Q: int, g: int, P: int, jstar):
    """engine.py:group_win_matched — (B, Q+1) group masks -> per-window
    matched bools (B, P): unpack the grid masks (probe q answers windows
    g*q .. g*q+g-1), then OR in the tail probe's windows at jstar + i."""
    B = mask.shape[0]
    pos = torch.arange(P, device=mask.device)[None, :]
    planes = [((mask[:, :Q] >> i) & 1).bool() for i in range(g)]
    m = torch.stack(planes, dim=2).reshape(B, Q * g)
    if Q * g < P:
        m = torch.cat([m, m.new_zeros((B, P - Q * g))], dim=1)
    tmask = mask[:, Q]
    for i in range(g):
        tm = ((tmask >> i) & 1).bool()
        m = m | ((pos == (jstar + i)[:, None]) & tm[:, None])
    return m


def coverage_score2(matched_f, matched_r, lens, k: int, L: int, stride: int = 1):
    """engine.py:coverage_score2 — both orientations' coverage scores (bases
    covered by >= 1 matched window) in one int32 cumsum: the forward window
    count rides the low uint16 half and the reverse count the high half."""
    B, P = matched_f.shape
    dev = matched_f.device
    packed = matched_f.to(torch.int32) + (matched_r.to(torch.int32) << 16)
    mc = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev),
         torch.cumsum(packed, dim=1, dtype=torch.int32)],
        dim=1,
    )
    b = np.arange(L)
    j_high = b // stride
    j_low = -((-(b - k + 1)) // stride)
    hi_idx = torch.from_numpy(np.minimum(j_high + 1, P)).to(dev)
    lo_idx = torch.from_numpy(np.clip(j_low, 0, P)).to(dev)
    win = mc[:, hi_idx] - mc[:, lo_idx]  # (B, L), two uint16 fields
    in_read = torch.arange(L, device=dev)[None, :] < lens[:, None]
    cov_f = ((win & 0xFFFF) > 0) & in_read
    cov_r = (((win >> 16) & 0xFFFF) > 0) & in_read
    return cov_f.sum(dim=1).to(torch.int32), cov_r.sum(dim=1).to(torch.int32)


def _use_fwd(score_f, score_r, p):
    """The orientation a read is scored in, under the strand filter."""
    if p.strand_filter == "fiveprime":
        return torch.ones_like(score_f, dtype=torch.bool)
    if p.strand_filter == "threeprime":
        return torch.zeros_like(score_f, dtype=torch.bool)
    return score_f >= score_r  # unstranded: higher-scoring orientation, ties -> forward


def _select_orientation(bits_f_w, bits_r_w, matched_f, matched_r, score_f, score_r, p):
    """engine.py:_select_orientation -> (bits, score, fwd_score, rev_score)."""
    use_fwd = _use_fwd(score_f, score_r, p)
    sel_rows = torch.where(use_fwd[:, None, None], bits_f_w, bits_r_w)
    matched_sel = torch.where(use_fwd[:, None], matched_f, matched_r)
    bits = and_reduce_bits(sel_rows, matched_sel)
    score = torch.where(use_fwd, score_f, score_r)
    return bits, score, score_f, score_r


def _group_keys(codes, lens, kg: int, g: int, n_buckets: int, h2: bool = False):
    """The group paths' probe keys: the window stage at k+g-1, then the
    grid probes at 0, g, 2g, ... plus ONE tail probe per read at the
    data-dependent position j* = clamp(len - (k+g-1), 0, PP-1), appended as
    an extra column and extracted with a one-hot masked sum, so every
    window of a clean read is answered. Returns (jstar, [hi, lo, h1,
    fwd_canon, valid]), each plane (B, Q+1), with the second bucket hash
    h2 appended when `h2` asks for it (gband under two-choice placement)."""
    PP = codes.shape[1] - kg + 1  # group positions
    hi_i, lo_i, h1, h2_i, fwd_c, _palin, valid = kmer_keys(codes, lens, kg, n_buckets)
    jstar = torch.clamp(lens - kg, 0, PP - 1)
    onehot = torch.arange(PP, device=codes.device)[None, :] == jstar[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=codes.device)
    cat = []
    for a in (hi_i, lo_i, h1, fwd_c, valid) + ((h2_i,) if h2 else ()):
        t = torch.where(onehot, a.to(torch.int32), zero).sum(dim=1, keepdim=True)
        cat.append(torch.cat([a[:, ::g], t.to(a.dtype)], dim=1))
    return jstar, cat


def _score_mate_group(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate_group — probe canonical (k+g-1)-mers on the
    stride-g grid plus the tail probe (`_group_keys`). Reads shorter than
    k+g-1 come back unmapped (the pipeline repairs them on the host)."""
    g = p.group_g
    B, L = codes.shape
    P = L - p.k + 1  # k-windows
    with obs.span("engine.keys"):
        jstar, cat = _group_keys(codes, lens, p.k + g - 1, g, tables["group_bucket"].shape[0])
    W = table_words(tables)
    with obs.span("engine.probe"):
        and_f, mask_f, and_r, mask_r = group_probe(*cat, tables, W, g)
    Q = cat[0].shape[1] - 1

    with obs.span("engine.score"):
        score_f, score_r = coverage_score2(
            group_win_matched(mask_f, Q, g, P, jstar),
            group_win_matched(mask_r, Q, g, P, jstar),
            lens, p.k, L, 1,
        )
    # the AND is order-independent and each probe's windows are pre-ANDed:
    # the (B, Q+1, W) probe planes feed the intersection directly
    with obs.span("engine.select"):
        return _select_orientation(and_f, and_r, mask_f != 0, mask_r != 0, score_f, score_r, p)


def _gband_bucket(h, hi_c, lo_c, tables):
    """engine.py:_score_mate_groupband's probe_bucket: ONE probe-row gather
    per position (after, in the indirect layout, the 8-lane pointer row
    gather and its lane select) -> the matched slot's half-row indices of
    both orientations (idx_s, idx_d; -1 on a miss) and its packed 4 x g-bit
    window-presence mask word (0 on a miss)."""
    bucket = tables["gband_bucket"]
    S = MONO_SLOTS
    dev = bucket.device
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    hh = h.long()
    if "gband_ptr8" in tables:
        # a bucket id is below nb2, nonnegative: >> 3 and & 7 split it
        # exactly into its pointer row and lane; the int32 pointer names
        # the bucket's packed row (row 0: all empty)
        ptr = tables["gband_ptr8"][hh >> 3]  # (B, Q+1, 8)
        hh = ptr.gather(-1, (hh & 7)[..., None])[..., 0].long()
    row = bucket[hh]  # (B, Q+1, 4S or 5S)
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (row[..., 0:S] == hi_c[..., None]) & (row[..., S : 2 * S] == lo_c[..., None])
    if bucket.shape[1] == 4 * S:
        # packed rows: w0 = idx_s | vs<<18 | vd<<24, w1 = idx_d | rvs<<18 | rvd<<24
        w0 = torch.where(match, row[..., 2 * S : 3 * S], neg).amax(dim=-1)
        w1 = torch.where(match, row[..., 3 * S : 4 * S], neg).amax(dim=-1)
        idx_s = torch.where(w0 >= 0, w0 & 0x3FFFF, neg)
        idx_d = torch.where(w1 >= 0, w1 & 0x3FFFF, neg)
        # every field is masked after its shift
        mword = (((w0 >> 18) & 0x3F) | (((w0 >> 24) & 0x3F) << 8)
                 | (((w1 >> 18) & 0x3F) << 16) | (((w1 >> 24) & 0x3F) << 24))
        return idx_s, idx_d, torch.where(w0 >= 0, mword, zero)
    idx_s = torch.where(match, row[..., 2 * S : 3 * S], neg).amax(dim=-1)
    idx_d = torch.where(match, row[..., 3 * S : 4 * S], neg).amax(dim=-1)
    # at most one slot matches (keys are unique): sum-select it
    return idx_s, idx_d, torch.where(match, row[..., 4 * S : 5 * S], zero).sum(dim=-1).to(torch.int32)


def gband_probe(hi_c, lo_c, h1_c, valid_c, tables, h2_c=None):
    """engine.py:_score_mate_groupband's bucket probes + stash sweep: the
    h1 bucket (`_gband_bucket`), under two-choice placement (`gband_two`)
    the h2 bucket too, combined as the reference combines them (max for
    the indices, | for the mask word: a key sits in one bucket at most),
    then the stash. Returns (idx_s, idx_d, mword), the mask word zeroed
    where the position is invalid or missed."""
    idx_s, idx_d, mword = _gband_bucket(h1_c, hi_c, lo_c, tables)
    if "gband_two" in tables:
        i2s, i2d, m2 = _gband_bucket(h2_c, hi_c, lo_c, tables)
        idx_s, idx_d, mword = torch.maximum(idx_s, i2s), torch.maximum(idx_d, i2d), mword | m2
    zero = torch.zeros((), dtype=torch.int32, device=mword.device)
    for s in range(tables["gband_stash_hi"].shape[0]):
        m = (tables["gband_stash_hi"][s] == hi_c) & (tables["gband_stash_lo"][s] == lo_c)
        idx_s = torch.where(m, tables["gband_stash_idx_s"][s], idx_s)
        idx_d = torch.where(m, tables["gband_stash_idx_d"][s], idx_d)
        mword = mword | torch.where(m, tables["gband_stash_mask"][s], zero)
    hit = valid_c & (idx_s >= 0)
    return idx_s, idx_d, torch.where(hit, mword, zero)


def gband_keys(codes, lens, tables, p: AlignParams):
    """The window stage of the gband path: `_group_keys` at k+g-1, hashed
    into nb2 buckets (the dense table's rows, or eight per pointer row of
    the indirect one), with h2 under two-choice placement."""
    nb = (tables["gband_ptr8"].shape[0] * 8 if "gband_ptr8" in tables
          else tables["gband_bucket"].shape[0])
    return _group_keys(codes, lens, p.k + p.group_g - 1, p.group_g, nb, h2="gband_two" in tables)


def gband_select(keys, lens, L: int, tables, p: AlignParams):
    """The probe stage of the gband path, from gband_keys' output: the
    probe (`gband_probe`), window masks and coverage scores of both
    orientations, the orientation (from the masks alone), and the selected
    orientation's half row per position: s when the canonical orientation
    agrees with the read's selected one, else d. Returns (idx_sel, has_sel,
    score, score_f, score_r)."""
    g = p.group_g
    P = L - p.k + 1
    jstar, (hi_c, lo_c, h1_c, fwd_cc, valid_c, *h2_c) = keys
    Q = hi_c.shape[1] - 1
    with obs.span("engine.probe"):
        idx_s, idx_d, mword = gband_probe(hi_c, lo_c, h1_c, valid_c, tables, *h2_c)

    with obs.span("engine.score"):
        gmask = (1 << g) - 1
        # `>>` is arithmetic on int32: the & gmask keeps only the g-bit field
        mask_f = torch.where(fwd_cc, mword, mword >> 8) & gmask
        mask_r = torch.where(fwd_cc, mword >> 24, mword >> 16) & gmask
        score_f, score_r = coverage_score2(
            group_win_matched(mask_f, Q, g, P, jstar),
            group_win_matched(mask_r, Q, g, P, jstar),
            lens, p.k, L, 1,
        )
    with obs.span("engine.select"):
        use_fwd = _use_fwd(score_f, score_r, p)
        u = use_fwd[:, None]
        idx_sel = torch.where(fwd_cc == u, idx_s, idx_d)
        has_sel = torch.where(u, mask_f, mask_r) != 0
        return idx_sel, has_sel, torch.where(use_fwd, score_f, score_r), score_f, score_r


def gband_expand(idx_sel, has_sel, tables) -> torch.Tensor:
    """The intersection stage of the gband path: the selected half rows
    gathered, ANDed and expanded to W words (`kernels.band_tree_expand`)."""
    return band_tree_expand(tables["gband_page"], tables["gband_band"], idx_sel, has_sel, table_words(tables))


def _score_mate_groupband(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate_groupband — the wide (W > 16) group path with
    banded pre-ANDed payloads: the same probe grid + tail and mask/score
    semantics as the narrow group path, but each probe position resolves to
    the index of a page-banded 2-page half row already holding the AND of
    its g windows' classes for one orientation. use_fwd is decided from the
    probe masks alone, so only the selected orientation's half rows are
    gathered, ANDed and expanded to W words: gband_keys, gband_select,
    gband_expand."""
    with obs.span("engine.keys"):
        keys = gband_keys(codes, lens, tables, p)
    idx_sel, has_sel, *scores = gband_select(keys, lens, codes.shape[1], tables, p)
    with obs.span("engine.select"):
        return (gband_expand(idx_sel, has_sel, tables), *scores)


def groupcls_probe(hi_i, lo_i, h1, fwd_c, valid, tables, g: int):
    """engine.py:groupcls_probe — ONE groupcls-table row gather per probe
    position answers g windows' class ids in both orientations. Returns
    (cls_f, cls_r, mask_f, mask_r): per-window class ids (B, Q g) int32, -1
    a miss, column q g + i the window at probe position q + i in forward
    coordinates for both orientations (the reverse orientation's g columns
    reversed within each probe, `torch.flip` for the reference's [..., ::-1]),
    and the g-bit presence masks (B, Q), as group_probe's."""
    B, Q = hi_i.shape
    bucket = tables["groupcls_bucket"]
    S = bucket.shape[1] // (2 + 2 * g + 1)
    dev = bucket.device
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    row = bucket[h1.long()]  # (B, Q, S * entry)
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
    cols = row[..., 2 * S : 2 * S + 2 * g * S].reshape(B, Q, 2 * g, S)
    # at most one slot matches (keys are unique): max-select it, a miss -1
    vals = torch.where(match[:, :, None, :], cols, neg).amax(dim=3)  # (B, Q, 2g)
    mword = torch.where(match, row[..., 2 * S + 2 * g * S :], zero).sum(dim=2).to(torch.int32)
    for s in range(tables["groupcls_stash_hi"].shape[0]):
        m = (tables["groupcls_stash_hi"][s] == hi_i) & (tables["groupcls_stash_lo"][s] == lo_i)
        vals = torch.where(m[..., None], tables["groupcls_stash_cols"][s], vals)
        mword = mword | torch.where(m, tables["groupcls_stash_mask"][s], zero)
    fc = fwd_c[..., None]
    vs_cols, vd_cols = vals[..., :g], vals[..., g:]
    cls_f = torch.where(fc, vs_cols, vd_cols)
    cls_r = torch.flip(torch.where(fc, vd_cols, vs_cols), dims=[2])
    v = valid[..., None]
    cls_f = torch.where(v, cls_f, neg).reshape(B, Q * g)
    cls_r = torch.where(v, cls_r, neg).reshape(B, Q * g)
    gmask = (1 << g) - 1
    # `>>` is arithmetic on int32: the & gmask keeps only the g-bit field
    mask_f = torch.where(fwd_c, mword, mword >> 8) & gmask
    mask_r = torch.where(fwd_c, mword >> 24, mword >> 16) & gmask
    return cls_f, cls_r, torch.where(valid, mask_f, zero), torch.where(valid, mask_r, zero)


def lookup_inline_bits(hi_i, lo_i, h1, h2, fwd_c, palin, valid, tables, W: int):
    """engine.py:lookup_inline_bits from precomputed canonical keys and both
    bucket hashes: two-choice probe of the inline bucket (one row per hash
    candidate carries keys and both orientations' bitsets) plus the index
    stash. Returns (bits_f, bits_r), each (B, P, W) int32, all-zero = miss."""
    B, P = hi_i.shape
    S = BUCKET_SLOTS
    zero = torch.zeros((), dtype=torch.int32, device=hi_i.device)
    vs_bits = torch.zeros((B, P, W), dtype=torch.int32, device=hi_i.device)
    vd_bits = torch.zeros_like(vs_bits)
    for h in (h1, h2):
        row = tables["bucket"][h.long()]  # (B, P, 4S + 2SW)
        vsb = row[..., 4 * S : 4 * S + S * W].reshape(B, P, S, W)
        vdb = row[..., 4 * S + S * W :].reshape(B, P, S, W)
        occupied = ((vsb | vdb) != 0).any(dim=-1)  # (B, P, S)
        match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None]) & occupied
        # at most one slot matches: sum-select it, exact in int64
        sel = match[..., None]
        vs_bits = vs_bits | torch.where(sel, vsb, zero).sum(dim=2).to(torch.int32)
        vd_bits = vd_bits | torch.where(sel, vdb, zero).sum(dim=2).to(torch.int32)
    for s in range(STASH_SIZE):
        # empty stash rows carry all-zero bitsets: a spurious key match
        # against one contributes nothing
        m = ((tables["stash_hi"][s] == hi_i) & (tables["stash_lo"][s] == lo_i))[..., None]
        vs_bits = vs_bits | torch.where(m, tables["stash_vs_bits"][s], zero)
        vd_bits = vd_bits | torch.where(m, tables["stash_vd_bits"][s], zero)
    fc = fwd_c[..., None]
    bits_f = torch.where(fc, vs_bits, vd_bits)
    bits_r = torch.where(palin[..., None], vs_bits, torch.where(fc, vd_bits, vs_bits))
    v = valid[..., None]
    return torch.where(v, bits_f, zero), torch.where(v, bits_r, zero)


def _window_keys(codes, lens, n_buckets: int, p: AlignParams):
    """The window stage at k, every p.stride-th window kept (contiguous)."""
    planes = kmer_keys(codes, lens, p.k, n_buckets)
    if p.stride > 1:
        planes = tuple(a[:, :: p.stride].contiguous() for a in planes)
    return planes


def _score_bits(bits_f_w, bits_r_w, lens, L: int, p: AlignParams):
    """Per-window bitsets of both orientations -> coverage scores and the
    selected orientation's AND intersection (engine.py:2560-2567)."""
    with obs.span("engine.score"):
        matched_f = (bits_f_w != 0).any(dim=-1)
        matched_r = (bits_r_w != 0).any(dim=-1)
        score_f, score_r = coverage_score2(matched_f, matched_r, lens, p.k, L, p.stride)
    with obs.span("engine.select"):
        return _select_orientation(bits_f_w, bits_r_w, matched_f, matched_r, score_f, score_r, p)


def _score_mate_mono(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate, window-kernel mono branch: canonical k-mer
    keys hashed into the mono table, one fused probe per kept window."""
    bucket = tables["mono_bucket"]
    with obs.span("engine.keys"):
        hi_i, lo_i, h1, _h2, fwd_c, palin, valid = _window_keys(codes, lens, bucket.shape[0], p)
    with obs.span("engine.probe"):
        bits_f_w, bits_r_w = mono_probe(
            bucket, h1, hi_i, lo_i, fwd_c, palin, valid, tables["mono_stash"], table_words(tables)
        )
    return _score_bits(bits_f_w, bits_r_w, lens, codes.shape[1], p)


def _score_mate_inline(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate, two-choice inline branch (mono placement was
    infeasible): keys and both hashes at the index's n_buckets."""
    with obs.span("engine.keys"):
        hi_i, lo_i, h1, h2, fwd_c, palin, valid = _window_keys(codes, lens, p.n_buckets, p)
    with obs.span("engine.probe"):
        bits_f_w, bits_r_w = lookup_inline_bits(
            hi_i, lo_i, h1, h2, fwd_c, palin, valid, tables, table_words(tables)
        )
    return _score_bits(bits_f_w, bits_r_w, lens, codes.shape[1], p)


def lookup_classes(hi_i, lo_i, h1, h2, fwd_c, palin, valid, tables):
    """engine.py:lookup_classes from precomputed canonical keys and both
    bucket hashes: the two-choice probe of the wide class-id bucket (one
    row per hash candidate), then the index's STASH_SIZE stash rows.
    Returns (cls_f, cls_r) (B, P) int32 class ids, -1 a miss: cls_f for
    the read's forward strand, cls_r for its reverse complement, both in
    forward coordinates."""
    S = BUCKET_SLOTS
    dev = hi_i.device
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    vs = torch.full(hi_i.shape, -1, dtype=torch.int32, device=dev)
    vd = torch.full(hi_i.shape, -1, dtype=torch.int32, device=dev)
    for h in (h1, h2):
        row = tables["bucket"][h.long()]  # (B, P, 4S)
        bk_vs, bk_vd = row[..., 2 * S : 3 * S], row[..., 3 * S : 4 * S]
        match = ((row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
                 & ((bk_vs >= 0) | (bk_vd >= 0)))
        # at most one slot matches (keys are unique): max-select it
        vs = torch.maximum(vs, torch.where(match, bk_vs, neg).amax(dim=-1))
        vd = torch.maximum(vd, torch.where(match, bk_vd, neg).amax(dim=-1))
    for s in range(STASH_SIZE):
        svs, svd = tables["stash_vsame"][s], tables["stash_vdiff"][s]
        m = (tables["stash_hi"][s] == hi_i) & (tables["stash_lo"][s] == lo_i) & ((svs >= 0) | (svd >= 0))
        vs = torch.where(m, svs, vs)
        vd = torch.where(m, svd, vd)
    return _orient_classes(vs, vd, fwd_c, palin, valid)


def _orient_classes(vs, vd, fwd_c, palin, valid):
    """Canonical-key class ids (vs: the canonical code's, vd: its reverse
    complement's) -> (cls_f, cls_r) of the read's two orientations, -1
    where the window is invalid."""
    neg = torch.full((), -1, dtype=torch.int32, device=vs.device)
    cls_f = torch.where(fwd_c, vs, vd)
    cls_r = torch.where(palin, vs, torch.where(fwd_c, vd, vs))
    return torch.where(valid, cls_f, neg), torch.where(valid, cls_r, neg)


def lookup_monocls(hi_i, lo_i, h1, fwd_c, palin, valid, tables):
    """engine.py:lookup_monocls from precomputed canonical keys and the
    monocls bucket hash: ONE row gather per window answers both
    orientations' class ids, then the stash sweep. Returns (cls_f, cls_r)
    (B, P) int32, -1 a miss."""
    bucket = tables["mcls_bucket"]
    S = bucket.shape[1] // 4
    neg = torch.full((), -1, dtype=torch.int32, device=bucket.device)
    row = bucket[h1.long()]  # (B, P, 4S)
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
    # at most one slot matches (keys are unique): max-select it, a miss -1
    vs = torch.where(match, row[..., 2 * S : 3 * S], neg).amax(dim=-1)
    vd = torch.where(match, row[..., 3 * S : 4 * S], neg).amax(dim=-1)
    for s in range(tables["mcls_stash_hi"].shape[0]):
        m = (tables["mcls_stash_hi"][s] == hi_i) & (tables["mcls_stash_lo"][s] == lo_i)
        vs = torch.where(m, tables["mcls_stash_vs"][s], vs)
        vd = torch.where(m, tables["mcls_stash_vd"][s], vd)
    return _orient_classes(vs, vd, fwd_c, palin, valid)


def intersect_class_bands(class_ids: torch.Tensor, matched: torch.Tensor, class_page: torch.Tensor,
                          class_band: torch.Tensor, W: int) -> torch.Tensor:
    """engine.py:intersect_class_bands — the AND of the matched positions'
    banded class bitsets, expanded to (B, W) int32: one band_tree_expand
    launch over all P positions (idx_sel = the class ids, has_sel =
    matched). The reference folds one row per run, RUN_BLOCK runs at a time,
    through the page-select tree; the band AND is the exact set
    intersection and idempotent, so folding every matched position in any
    order gives the same bits. `build_class_bands` makes Pw a multiple of 8
    with 3 Pw <= W, as the kernel needs."""
    return band_tree_expand(class_page, class_band, class_ids, matched, W)


def class_keys(codes, lens, tables, p: AlignParams):
    """The window stage of the class-id paths: on groupcls the (k+g-1)-mer
    grid and tail (`_group_keys`, -> (jstar, planes)); on monocls the
    k-mer planes hashed into its bucket, on the wide two-choice probe at the
    index's n_buckets (h1 and h2), each after the stride slice."""
    if p.group_g >= 2 and "groupcls_bucket" in tables:
        return _group_keys(codes, lens, p.k + p.group_g - 1, p.group_g, tables["groupcls_bucket"].shape[0])
    nb = tables["mcls_bucket"].shape[0] if "mcls_bucket" in tables else p.n_buckets
    return _window_keys(codes, lens, nb, p)


def class_probe(keys, lens, L: int, tables, p: AlignParams):
    """The probe stage of the class-id paths, from class_keys' output:
    per-window class ids of both orientations (`groupcls_probe`,
    `lookup_monocls` or `lookup_classes`), their coverage scores, and the
    orientation (the read's strand filter, else the higher score). Only
    the selected orientation's classes go on to the intersection. Returns
    (cls_sel, score, score_f, score_r)."""
    if p.group_g >= 2 and "groupcls_bucket" in tables:
        g = p.group_g
        jstar, cat = keys
        with obs.span("engine.probe"):
            cls_f, cls_r, mask_f, mask_r = groupcls_probe(*cat, tables, g)
        Q = cat[0].shape[1] - 1
        P = L - p.k + 1
        with obs.span("engine.score"):
            score_f, score_r = coverage_score2(group_win_matched(mask_f, Q, g, P, jstar),
                                               group_win_matched(mask_r, Q, g, P, jstar), lens, p.k, L, 1)
    else:
        hi, lo, h1, h2, fc, pal, valid = keys
        with obs.span("engine.probe"):
            if "mcls_bucket" in tables:
                cls_f, cls_r = lookup_monocls(hi, lo, h1, fc, pal, valid, tables)
            else:
                cls_f, cls_r = lookup_classes(hi, lo, h1, h2, fc, pal, valid, tables)
        with obs.span("engine.score"):
            score_f, score_r = coverage_score2(cls_f >= 0, cls_r >= 0, lens, p.k, L, p.stride)
    with obs.span("engine.select"):
        use_fwd = _use_fwd(score_f, score_r, p)
        return (torch.where(use_fwd[:, None], cls_f, cls_r), torch.where(use_fwd, score_f, score_r),
                score_f, score_r)


def intersect_class_slices(cls_sel: torch.Tensor, slices) -> torch.Tensor:
    """The feature axis of a mesh: intersect_class_bits once per column
    slice of the padded class bitsets, each on its slice's device over a
    copy of the selected class ids, the (B, W_pad / M) results concatenated
    along the words on the ids' device. Exact, because the AND is
    elementwise over words; a slice of at most 32 words takes the plain
    version's gather branch even where W is wide (and the kernel its rule
    for W <= 32), which gives the same bits."""
    lead = cls_sel.device
    parts = []
    for cb in slices:
        ids = cls_sel.to(cb.device)
        parts.append(intersect_class_bits(ids, ids >= 0, cb).to(lead))
    return torch.cat(parts, dim=1)


def intersect_classes(cls_sel, tables) -> torch.Tensor:
    """The intersection stage of the class-id paths: the selected classes'
    bitsets ANDed, over their band rows where the strict class bands were
    shipped (`intersect_class_bands`; under a feature-split mesh whole on
    the row's lead device, expanded to the padded width), else over the
    feature slices of a mesh (`intersect_class_slices`), else over
    `class_bits` (`intersect_class_bits`; always so on groupcls)."""
    if "class_band" in tables:
        return intersect_class_bands(cls_sel, cls_sel >= 0, tables["class_page"], tables["class_band"],
                                     table_words(tables))
    if "class_slices" in tables:
        return intersect_class_slices(cls_sel, tables["class_slices"])
    return intersect_class_bits(cls_sel, cls_sel >= 0, tables["class_bits"])


def _score_mate_classes(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate_groupcls, and _score_mate's wide class-id
    branch (monocls or the two-choice probe): class_keys, class_probe,
    intersect_classes. On groupcls the grid and tail columns feed the runs
    intersection directly (a tail column repeating a grid window's class
    is idempotent); the reads shorter than k+g-1 that it leaves unmapped
    are the pipeline's to repair, as on the group path."""
    with obs.span("engine.keys"):
        keys = class_keys(codes, lens, tables, p)
    cls_sel, *scores = class_probe(keys, lens, codes.shape[1], tables, p)
    with obs.span("engine.select"):
        return (intersect_classes(cls_sel, tables), *scores)


def _score_mate(codes, lens, tables, p: AlignParams):
    """engine.py:_score_mate's dispatch: group, gband or groupcls when the
    params carry g >= 2 and the tables that path's bucket; the class-id
    step on monocls or the wide two-choice bucket; else mono, else the
    two-choice inline bucket (W <= 16)."""
    if p.group_g >= 2 and "group_bucket" in tables:
        return _score_mate_group(codes, lens, tables, p)
    if p.group_g >= 2 and "gband_bucket" in tables:
        return _score_mate_groupband(codes, lens, tables, p)
    if (p.group_g >= 2 and "groupcls_bucket" in tables) or "mcls_bucket" in tables or "stash_vsame" in tables:
        return _score_mate_classes(codes, lens, tables, p)
    if "mono_bucket" in tables:
        return _score_mate_mono(codes, lens, tables, p)
    if "stash_vs_bits" in tables:
        return _score_mate_inline(codes, lens, tables, p)
    raise ValueError(f"tables of no align path for group_g = {p.group_g} (keys {sorted(tables)})")


def align_step(tables, p: AlignParams, r1_codes, r1_lens, r2_codes=None, r2_lens=None):
    """engine.py:align_step on the ported paths. Returns dict: bits (B, W)
    int32, score, r1_fwd/r1_rev/r2_fwd/r2_rev orientation scores (B,) int32,
    pass_ (B,) bool."""
    m1 = _score_mate(r1_codes, r1_lens, tables, p)
    m2 = _score_mate(r2_codes, r2_lens, tables, p) if r2_codes is not None else None
    with obs.span("engine.combine"):
        return combine_mates(p, r1_lens, m1, r2_lens, m2)


def _mate_valid(p: AlignParams, bits, score, lens):
    # float32 on both sides, exactly as the reference's jnp compare
    pct = torch.tensor(p.score_percent, dtype=torch.float32, device=score.device)
    return (
        (score >= p.score_threshold)
        & (score.to(torch.float32) >= pct * lens.to(torch.float32))
        & (bits != 0).any(dim=1)
    )


def combine_mates(p: AlignParams, r1_lens, m1, r2_lens=None, m2=None):
    """engine.py:combine_mates — mate hit-set combination + score filters."""
    bits1, score1, f1, r1 = m1
    valid1 = _mate_valid(p, bits1, score1, r1_lens)
    zero = torch.zeros((), dtype=torch.int32, device=score1.device)
    if m2 is not None:
        bits2, score2, f2, r2 = m2
        valid2 = _mate_valid(p, bits2, score2, r2_lens)
        b1 = torch.where(valid1[:, None], bits1, zero)
        b2 = torch.where(valid2[:, None], bits2, zero)
        union = b1 | b2
        inter = b1 & b2
        both = valid1 & valid2
        single = torch.where(valid1[:, None], b1, b2)
        # 0: intersect, empty -> unmapped pair; 1: intersect, falling back
        # to the union when empty; 2: both mates must hit and intersect
        if p.intersect_level == 1:
            inter_nonempty = (inter != 0).any(dim=1)
            paired = torch.where(inter_nonempty[:, None], inter, union)
            bits = torch.where(both[:, None], paired, single)
        elif p.intersect_level == 2:
            bits = torch.where(both[:, None], inter, zero)
        else:
            bits = torch.where(both[:, None], inter, single)
        score = torch.where(valid1, score1, zero) + torch.where(valid2, score2, zero)
        any_valid = valid1 | valid2
        if p.require_valid_pair:
            any_valid = both
            bits = torch.where(both[:, None], bits, zero)
    else:
        bits = torch.where(valid1[:, None], bits1, zero)
        score = torch.where(valid1, score1, zero)
        any_valid = valid1
        f2 = r2 = torch.zeros_like(score1)

    pass_ = any_valid & (score >= p.score_filter) & (bits != 0).any(dim=1)
    return {
        "bits": bits,
        "score": score,
        "r1_fwd": f1,
        "r1_rev": r1,
        "r2_fwd": f2,
        "r2_rev": r2,
        "pass_": pass_,
    }


def wire_bytes(pending) -> int:
    """Bytes of the dispatched outputs of pending entries (AlignEngine's
    pending-list contract): what collecting them copies to the host."""
    return sum(f.numel() * f.element_size() for flats, _, _ in pending for f in flats)


def _tensors(tables: dict):
    """The tensors of a table set, a mesh's class slices included."""
    for v in tables.values():
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, tuple):
            yield from (t for t in v if isinstance(t, torch.Tensor))


class AlignEngine:
    """Alignment engine over fixed-shape chunks (engine.py:2698) on any path
    of the reference's (group, gband, groupcls, mono, monocls or either
    two-choice probe), chosen as the reference chooses it, on one device or
    on a mesh (parallel/mesh.py).

    A host batch is cut into fixed-shape chunks of `chunk_size` reads,
    padded with N codes and zero lengths (engine.py:AlignEngine's `_pad`,
    align_batch_async and align_packed_async). Each chunk is cut into one
    row block per shard (`shards`: a (lead device, tables) pair per data row
    of the mesh, else the one pair (device, tables)); block d moves to shard
    d's device and goes through align_step on that shard's tables and this
    engine's wire (`pack`). Every shard's step is launched
    before any is collected. A packed-wire batch (io.packing.pack_batch) is
    unpacked on the device with its dense N flags. Each pending entry is
    ([flat tensor per shard], wire tag, valid rows of the chunk).

    Under a mesh (engine.py:2758-2776) the chunk is rounded up to a multiple
    of n_data and each data row runs a one-device step on its lead device,
    the same code for a 1 x 1 grid. A feature split
    (n_feature > 1) builds the tables the reference builds for it
    (device_tables with inline_ok and group_ok off: monocls or the wide
    two-choice bucket at every W) and intersects each column slice of the
    class bitsets on its own device (`intersect_class_slices`); the bits
    are W_pad = ceil(W / M) M words wide, the padding words zero, and
    `table_words` says W_pad. Where the class bands are shipped, the banded
    intersection runs whole on the lead device and expands to W_pad. The
    window kernel runs on every shard (the reference turns its Pallas
    window stage off under a mesh for its SPMD partitioner; the output is
    the same).

    The output wire (`wire`) is static per engine and tags every dispatched
    chunk: "full" (`pack_outputs`, (B, W+3)) on every path but gband, and
    on gband for paired intersect_level = 1, whose union may span more than
    two pages;
    on the gband path "idlist" (`pack_outputs_idlist`) when the emit cap
    (`emit_cap_of`) is on, else "band" (band rows [page | 2 Pw band] in the
    full format's place)."""

    def __init__(
        self,
        index: KmerIndex,
        config: Config,
        device: torch.device,
        strand_filter: str = "unstranded",
        chunk_size: Optional[int] = 2048,
        max_len: int = 256,
        paired: bool = False,
        group_probe: Optional[bool] = None,
        chunk_cap: Optional[int] = None,
        mesh=None,
    ):
        self.index = index
        self.config = config
        self.mesh = mesh
        # under a mesh the grid's devices replace `device`
        self.device = torch.device(device) if mesh is None else mesh.lead(0)
        self.params = AlignParams.from_config(config, index, strand_filter)
        self.max_len = max(max_len, index.k)
        self.paired = paired
        W = index.bitset_words
        if self.max_len > MAX_LEN_LIMIT:
            raise ValueError(f"max_len {self.max_len} > {MAX_LEN_LIMIT} (packed uint16 scores)")
        # group probe (engine.py:2740-2747): one (k+g-1)-mer gather answers g
        # windows, when the index has group entries, W <= 8 (group) or
        # W > 16 (gband or groupcls), reads are probed at stride 1 and are at
        # least k+g-1 long, and NIMBLE_TPU_NO_GROUP_PROBE is not 1; else
        # mono (monocls at W > 16)
        group_ok = (
            index.has_pairs
            and (W <= GROUP_MAX_WORDS or W > INLINE_BITS_MAX_WORDS)
            and self.params.stride == 1
            and self.max_len >= index.k + index.pair_g - 1
            and os.environ.get("NIMBLE_TPU_NO_GROUP_PROBE", "") != "1"
        )
        if group_probe is not None:
            group_ok = group_ok and group_probe
        # inlined bitsets cannot split over the feature axis: a feature
        # split takes the separate class table (engine.py:2765-2770)
        if mesh is not None and mesh.n_feature > 1:
            group_ok = False
        tables = device_tables(index, self.device, group_ok=group_ok,
                               inline_ok=mesh is None or mesh.n_feature == 1)
        gband = "gband_bucket" in tables
        if gband or "group_bucket" in tables or "groupcls_bucket" in tables:
            self.params = replace(self.params, group_g=index.pair_g)
        self.band_pw = int(tables["gband_band"].shape[1]) // 2 if gband else 0

        if chunk_size is None:
            chunk_size = auto_chunk_size(index, self.max_len, paired, self.device, group_ok,
                                         band_words=2 * self.band_pw)
            if chunk_cap is not None and chunk_cap < chunk_size:
                # a chunk larger than the read batches would pad every batch
                chunk_size = max(1 << int(np.log2(max(chunk_cap, 1))), 1)
        if mesh is not None:
            chunk_size = -(-chunk_size // mesh.n_data) * mesh.n_data  # the chunk tiles the data axis
        self.chunk_size = chunk_size
        self._place(tables, mesh)

        # the emission wire (engine.py:2931-2998)
        self.wire = "full"
        self.emit_cap = 0
        self.idlist = None  # (cap, Pw, packed16, hdr1)
        if gband and (not paired or self.params.intersect_level != 1):
            self.emit_cap = emit_cap_of(config)
            if self.emit_cap > 0:
                # int16 id pairs need ids below 0xFFFF, the absent sentinel;
                # hdr1 needs score <= 2 max_len in 10 bits
                self.wire = "idlist"
                self.idlist = (self.emit_cap, self.band_pw, index.n_features <= 32767,
                               2 * self.max_len <= 1023)
            else:
                self.wire = "band"

    # the key that only one path's tables carry -> the path's name
    PATHS = (("group_bucket", "group"), ("gband_bucket", "gband"), ("groupcls_bucket", "groupcls"),
             ("mono_bucket", "mono"), ("stash_vs_bits", "two-choice inline"), ("mcls_bucket", "monocls"),
             ("stash_vsame", "two-choice"))

    @property
    def path(self) -> str:
        """The path this engine's tables take, by the reference's name; a
        class-id path intersecting class bands says so."""
        name = next(n for k, n in self.PATHS if k in self.tables)
        return name + " (class bands)" if "class_band" in self.tables else name

    @property
    def table_bytes(self) -> int:
        """Bytes of the tables on the engine's devices, each tensor counted
        once (several shards on one device share one copy)."""
        seen = {}
        for _, tables in self.shards:
            for t in _tensors(tables):
                seen[(t.device, t.data_ptr())] = t.numel() * t.element_size()
        return sum(seen.values())

    @property
    def shard_table_bytes(self) -> list:
        """Bytes of each shard's tables, its class slices included."""
        return [sum(t.numel() * t.element_size() for t in _tensors(tables)) for _, tables in self.shards]

    def _place(self, tables: dict, mesh) -> None:
        """Set `tables` and `shards`: one-device tables on `device`, or,
        under a mesh, one table set per data row (parallel/mesh.py:
        shard_tables), `tables` being data row 0's."""
        if mesh is None:
            self.shards = [(self.device, tables)]
        else:
            from nimble_tpu_torch.parallel.mesh import shard_tables

            self.shards = list(zip([mesh.lead(d) for d in range(mesh.n_data)], shard_tables(tables, mesh)))
        self.tables = self.shards[0][1]

    def _pad(self, arr, n, fill):
        if arr.shape[0] == n:
            return arr
        pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width, constant_values=fill)

    @staticmethod
    def _to_dev(a: np.ndarray, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dtype)

    def _launch(self, mates, valid: int):
        """One chunk of host arrays, per mate (codes, lens) or packed
        (words, lens, dense N flags), each of chunk_size rows -> a pending
        entry: the chunk's row block d through shard d's step on its
        device, every shard launched before any result is read."""
        Cd = self.chunk_size // len(self.shards)
        flats, wire = [], None
        for d, (dev, tables) in enumerate(self.shards):
            rows = slice(d * Cd, (d + 1) * Cd)
            args = []
            with obs.span("engine.h2d"):
                for arrays in mates:
                    if len(arrays) == 3:
                        words, lens, nflags = (a[rows] for a in arrays)
                        codes = unpack_reads(self._to_dev(words, dev, torch.int32), self.max_len,
                                             self._to_dev(nflags, dev, torch.int32))
                    else:
                        codes, lens = arrays[0][rows], arrays[1][rows]
                        codes = self._to_dev(codes, dev, torch.int8)
                    args += [codes, self._to_dev(lens, dev, torch.int32)]
            with obs.span("engine.step"):
                flat, wire = self.pack(align_step(tables, self.params, *args))
            flats.append(flat)
        return flats, wire, valid

    def _host_shards(self, pending):
        """Copy each pending entry's shard outputs to host numpy, in shard
        order -> (array, wire tag, the shard's valid rows, its rows): shard
        d of a chunk with `valid` rows holds clamp(valid - d Cd, 0, Cd)."""
        for flats, wire, valid in pending:
            Cd = self.chunk_size // len(flats)
            for d, flat in enumerate(flats):
                with obs.span("engine.d2h"):
                    arr = flat.cpu().numpy()
                yield arr, wire, min(max(valid - d * Cd, 0), Cd), Cd

    def align_batch_async(self, r1_codes: np.ndarray, r1_lens: np.ndarray,
                          r2_codes: Optional[np.ndarray] = None,
                          r2_lens: Optional[np.ndarray] = None):
        """Dispatch a host batch of int8 codes chunk by chunk (no wait).
        Returns [([flat device tensor per shard], wire tag, valid rows)] for
        collect_async."""
        n = r1_codes.shape[0]
        C = self.chunk_size
        pending = []
        for start in range(0, n, C):
            end = min(start + C, n)
            mates = [(self._pad(r1_codes[start:end], C, N_CODE), self._pad(r1_lens[start:end], C, 0))]
            if self.paired:
                mates.append((self._pad(r2_codes[start:end], C, N_CODE), self._pad(r2_lens[start:end], C, 0)))
            pending.append(self._launch(mates, end - start))
        return pending

    def align_packed_async(self, pb: dict):
        """Dispatch a packed-wire batch (io.packing.pack_batch dict) chunk by
        chunk, with dense N flags. Same pending-list contract as
        align_batch_async."""
        n = pb["r1_words"].shape[0]
        C = self.chunk_size
        Lf = (self.max_len + 31) // 32
        pending = []
        for start in range(0, n, C):
            end = min(start + C, n)
            mates = []
            for mate in ("r1", "r2") if self.paired else ("r1",):
                nidx = pb[f"{mate}_nidx"]
                nrows = pb[f"{mate}_nrows"]
                lo = int(np.searchsorted(nidx, start))
                hi = int(np.searchsorted(nidx, end))
                dense = np.zeros((C, Lf), dtype=np.int32)
                dense[nidx[lo:hi] - start] = nrows[lo:hi]
                mates.append((self._pad(pb[f"{mate}_words"][start:end], C, 0),
                              self._pad(pb[f"{mate}_lens"][start:end], C, 0), dense))
            pending.append(self._launch(mates, end - start))
        return pending

    def align_batch(self, r1_codes: np.ndarray, r1_lens: np.ndarray,
                    r2_codes: Optional[np.ndarray] = None,
                    r2_lens: Optional[np.ndarray] = None):
        """Align a host batch of any size; returns host numpy outputs."""
        return self.collect_async(self.align_batch_async(r1_codes, r1_lens, r2_codes, r2_lens))

    def pack(self, out):
        """align_step's outputs on this engine's wire -> (flat tensor, wire
        tag)."""
        with obs.span("engine.pack"):
            if self.wire == "full":
                return pack_outputs(out), self.wire
            rows = compress_band_rows(out["bits"], self.band_pw)
            if self.wire == "band":
                return pack_outputs({**out, "bits": rows}), self.wire
            cap, Pw, packed16, hdr1 = self.idlist
            # the band rows hold every nonzero word: counting them counts
            # the class; classes over the cap never reach the TSV
            out = {**out, "pass_": out["pass_"] & (popcount32_rows(rows[:, 1:]) <= cap), "_band": rows}
            return pack_outputs_idlist(out, cap, Pw, packed16=packed16, hdr1=hdr1), self.wire

    def collect_async(self, pending):
        """Copy dispatched outputs to host numpy and unpack each chunk by
        the wire tag it was dispatched with: "full" gives dense `bits`,
        "band" gives `band_rows` with `band_meta` = (Pw, W), "idlist" gives
        `ids` (engine.py:collect_async with expand_band=False). A chunk's
        shards are unpacked each with its own valid rows and concatenated
        in shard order."""
        outs = []
        W = table_words(self.tables)
        for arr, wire, valid, rows in self._host_shards(pending):
            with obs.span("engine.unpack"):
                if wire == "idlist":
                    cap, _, packed16, hdr1 = self.idlist
                    outs.append(unpack_outputs_idlist(arr, rows, cap, valid, packed16, hdr1))
                elif wire == "band":
                    out = unpack_outputs(arr, 1 + 2 * self.band_pw, valid)
                    out["band_rows"] = out.pop("bits")
                    outs.append(out)
                else:
                    outs.append(unpack_outputs(arr, W, valid))
        if not outs:
            return None
        with obs.span("engine.unpack"):
            merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if "band_rows" in merged:
            merged["band_meta"] = (self.band_pw, W)
        return merged

    def warmup(self) -> dict:
        """Run one zero-filled span through align_packed_async ->
        collect_async (engine.py:AlignEngine.warmup, which compiles the
        dispatch programs; the port has none to compile, and no
        `scan_chunks`, so one span). On cuda it first builds the kernel
        library (kernels.build) unless it is there already; the span then
        loads it and launches the path's kernels once. Both are the run
        log's stages `warm_kernels` and `warm_step`. Returns {"kernels":
        None on the CPU, else {"path", "built", "build_s"}; "step_s": the
        span's wall}."""
        from nimble_tpu_torch.align import kernels as K
        from nimble_tpu_torch.observability import runlog

        log = runlog()
        kernels = None
        if self.device.type == "cuda":
            with log.stage("warm_kernels"):
                path = K.library_path()
                built = not os.path.exists(path)
                t0 = time.perf_counter()
                K.build()
                kernels = {"path": path, "built": built, "build_s": time.perf_counter() - t0}
        span, L = self.chunk_size, self.max_len
        pb = {}
        for mate in ("r1", "r2") if self.paired else ("r1",):
            pb[f"{mate}_words"] = np.zeros((span, (L + 15) // 16), dtype=np.int32)
            pb[f"{mate}_lens"] = np.full(span, L, dtype=np.int32)
            pb[f"{mate}_nidx"] = np.zeros(0, dtype=np.int32)
            pb[f"{mate}_nrows"] = np.zeros((0, (L + 31) // 32), dtype=np.int32)
        with log.stage("warm_step", span=span, max_len=L, paired=self.paired):
            t0 = time.perf_counter()
            self.collect_async(self.align_packed_async(pb))  # .cpu() waits for the card
            step_s = time.perf_counter() - t0
        return {"kernels": kernels, "step_s": step_s}


# The benchmark's engine layer (benchmark/layers/engine.json) wraps
# `ChunkDispatch.align_packed_async`; the name stays for it, as AlignEngine
# itself, until that wrap point names AlignEngine.
ChunkDispatch = AlignEngine
