"""Device-side quantification: the UMI pipeline as torch segment ops.

The port's counterpart of the reference's quant/device.py (`report
--device`): per-read (cb, umi) group ids, feature bitsets and scores go to
the device, and the whole
  groupby -> per-UMI proportional-thresholding fixpoint -> intersection
pipeline runs as segment operations over ALL UMI groups at once, in
float32 as the reference computes it. The host finish (decode, count,
sort) is the reference's.

Where it differs from the reference, and why the output does not:

- Determinism on the card. `index_add_` and `scatter_add_` add float32 in
  atomic order on CUDA, so sums, and decisions near a tie, would change
  from run to run. The rows are sorted by group id once, with a stable
  sort on the device, and every float sum is a `torch.segment_reduce` over
  the contiguous segments, which adds each segment in a fixed order. The
  stable sort keeps each group's rows in input order, the order in which
  the reference's `segment_sum` adds them on the CPU. Integer and boolean
  reductions (row counts, the intersection) do not depend on order.
- The fixpoint is a Python loop with one host read of the `changed` flag
  per iteration (the reference: `lax.while_loop`); the report runs once,
  not inside a step.
- Word blocks. The reference scans one 32-feature word at a time, so its
  transient memory is O(N*32 + G*32) and never the dense (N, n_features)
  matrix. This module takes several words per block while the block's
  transients stay under BLOCK_BYTES. Feature sums are independent across
  words, so blocking changes no sum.

Duplicate-row merging (convert_df_to_proper_umi's groupby-sum) is
unnecessary here, as in the reference: merging rows with equal (group,
features) leaves both the proportional score distribution and the
intersection invariant.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimble_tpu_torch.device import resolve_device
from nimble_tpu_torch.observability import runlog

# Transient budget of one word block, in bytes. A block of b words holds
# about four (rows + groups, 32 * b) arrays of 4-byte elements at once
# (the expanded bits, their float32 contributions, the feature sums and
# the comparison masks), so b = BLOCK_BYTES // (16 * 32 * (N + G)), at
# least 1. One word (the reference's unit) is the floor, whatever N.
BLOCK_BYTES = 1 << 30
_BLOCK_CELL_BYTES = 16


def factorize(values: Sequence) -> Tuple[np.ndarray, List]:
    """Host helper: values -> (int32 codes, uniques in first-seen order)."""
    codes = np.empty(len(values), dtype=np.int32)
    uniq: Dict = {}
    order = []
    for i, v in enumerate(values):
        code = uniq.get(v)
        if code is None:
            code = len(order)
            uniq[v] = code
            order.append(v)
        codes[i] = code
    return codes, order


def _int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor of the same bit
    patterns (no reliance on how an out-of-range cast wraps)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns, as int32. The
    reference's SWAR steps, on the pattern's unsigned value in int64, so
    that no shift drags the sign bit and the final multiply cannot
    overflow."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0x3F).to(torch.int32)


def _expand_bits(bits: torch.Tensor, n_features: int) -> torch.Tensor:
    """(N, W) int32 bitsets -> (N, n_features) bool membership."""
    N, W = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    expanded = (bits[:, :, None] >> shifts) & 1  # (N, W, 32); masks the sign
    return expanded.reshape(N, W * 32)[:, :n_features].bool()


def _pack_bits(mask: torch.Tensor, W: int) -> torch.Tensor:
    """(G, n_features) bool -> (G, W) int32 bitsets."""
    G, n_features = mask.shape
    padded = torch.zeros((G, W * 32), dtype=torch.int64, device=mask.device)
    padded[:, :n_features] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return _int32_bits((padded.reshape(G, W, 32) << shifts).sum(dim=2))


def _tie_eps() -> float:
    """Tie-proximity epsilon for the device report guard: ratios within
    this distance of the threshold are flagged as float32-order-sensitive.
    Default 1e-5 (~84 float32 ULPs at ratio scale 1). NIMBLE_TPU_TIE_EPS
    overrides (read at each call); 0 disables the guard."""
    try:
        return float(os.environ.get("NIMBLE_TPU_TIE_EPS", "1e-5"))
    except ValueError:
        return 1e-5


def _valid_words(W: int, n_features: int) -> np.ndarray:
    """(W,) int32 bit patterns of the features that exist (the last word's
    tail bits never survive). Built as uint32 (bit 31 overflows int32) and
    shipped as int32 bit patterns, as the reference does."""
    valid = np.zeros(W * 32, dtype=np.int64)
    valid[:n_features] = 1
    return (valid.reshape(W, 32) << np.arange(32)).sum(axis=1).astype(np.uint32).view(np.int32)


def device_umi_pipeline(
    group_ids: torch.Tensor,  # (N,) int, values in [0, n_groups)
    bits: torch.Tensor,  # (N, W) int32 feature bitsets
    scores: torch.Tensor,  # (N,) float32
    n_groups: int,
    n_features: int,
    threshold: float,
    tie_eps: float = 0.0,
    stats: Optional[dict] = None,
):
    """Full thresholding + intersection over all groups at once, on the
    device the tensors live on.

    Returns (inter_bits (n_groups, W) int32, group_alive (n_groups,) bool,
    reached_intersection (n_groups,) bool, near_ties int32): the per-group
    feature intersection after thresholding, whether the group survived
    (non-empty intersection), whether it reached the intersection stage at
    all, and, when tie_eps > 0, the count of (group, feature) score ratios
    within tie_eps of the threshold at the initial and at the final state
    (0 when tie_eps == 0 or thresholding is off). `stats`, when given,
    receives the fixpoint's iteration count under "iterations" and the
    word block under "block_words".
    """
    dev = bits.device
    N, W = bits.shape
    G = n_groups
    f32 = torch.float32
    thr = torch.tensor(threshold, dtype=f32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    valid_words = torch.from_numpy(_valid_words(W, n_features)).to(dev)

    # one stable sort by group: each group's rows become one contiguous
    # segment, in input order
    order = torch.sort(group_ids.to(torch.int64), stable=True)
    gid = order.values
    bits = bits[order.indices]
    scores = scores.to(f32)[order.indices]
    lengths = torch.bincount(gid, minlength=G)
    if lengths.numel() != G:
        raise ValueError(f"group ids reach past n_groups = {G}")

    def segment(x: torch.Tensor, reduce: str, initial: float) -> torch.Tensor:
        # (N, C) float32 rows sorted by group -> (G, C); each segment is
        # reduced in one fixed order, the same in every run. Kept 2-D
        # (C >= 1) even for one column. The lengths sum to N by
        # construction, so their check (a host sync per call) is skipped.
        return torch.segment_reduce(x, reduce, lengths=lengths, axis=0, initial=initial, unsafe=True)

    wb = max(1, min(W, BLOCK_BYTES // (_BLOCK_CELL_BYTES * 32 * (N + G))))
    blocks = [(w0, min(W, w0 + wb)) for w0 in range(0, W, wb)]

    def expand(w: torch.Tensor) -> torch.Tensor:  # (n, b) int32 -> (n, 32 b) in {0, 1}
        return ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)

    def pack(mask: torch.Tensor) -> torch.Tensor:  # (g, 32 b) bool -> (g, b) int32
        m = mask.reshape(mask.shape[0], -1, 32).to(torch.int64)
        return _int32_bits((m << shifts.to(torch.int64)).sum(dim=2))

    def active(surv: torch.Tensor, w0: int, w1: int) -> torch.Tensor:
        return bits[:, w0:w1] & surv[gid, w0:w1]

    def score_split(surv: torch.Tensor):
        """Per-row score per surviving feature, and the group totals over
        rows that still have a feature."""
        k = torch.zeros(N, dtype=torch.int64, device=dev)
        for w0, w1 in blocks:
            k += popcount32(active(surv, w0, w1)).sum(dim=1)
        has = k > 0
        spf = torch.where(has, scores / k.clamp(min=1).to(f32), torch.zeros((), dtype=f32, device=dev))
        totals = segment(torch.where(has, scores, 0.0)[:, None], "sum", 0.0)[:, 0]
        safe_tot = torch.maximum(totals, torch.tensor(1e-30, dtype=f32, device=dev))
        return spf, totals, safe_tot

    def body(surv: torch.Tensor):
        spf, totals, safe_tot = score_split(surv)
        tot_pos = totals > 0
        new = torch.empty_like(surv)
        changed = torch.zeros((), dtype=torch.bool, device=dev)
        for w0, w1 in blocks:
            fscores = segment(expand(active(surv, w0, w1)).to(f32) * spf[:, None], "sum", 0.0)
            sbits = expand(surv[:, w0:w1]).bool()
            # drop features strictly below threshold among current
            # survivors; groups with zero total drop nothing (0/0 -> NaN ->
            # no drop in the reference)
            drops = sbits & (fscores / safe_tot[:, None] < thr) & tot_pos[:, None]
            changed |= drops.any()
            new[:, w0:w1] = pack(sbits & ~drops)
        return new, changed

    init_surviving = valid_words[None, :].expand(G, W).contiguous()
    surviving = init_surviving
    iterations = 0
    if threshold > 0:
        changed = True
        while changed:
            surviving, flag = body(surviving)
            iterations += 1
            changed = bool(flag)  # the one host read of the iteration

    # per-row filtered features; rows with empty filtered sets drop out
    row_kept = torch.zeros(N, dtype=torch.bool, device=dev)
    for w0, w1 in blocks:
        row_kept |= (active(surviving, w0, w1) != 0).any(dim=1)

    # segmented intersection: min over kept rows per group (excluded rows
    # count as all ones), per word block
    inter_words = torch.empty((G, W), dtype=torch.int32, device=dev)
    for w0, w1 in blocks:
        vals = torch.where(row_kept[:, None], expand(active(surviving, w0, w1)), 1).to(f32)
        inter_words[:, w0:w1] = pack(segment(vals, "min", 1.0) == 1)
    inter_words &= valid_words[None, :]

    kept_counts = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, gid, row_kept.to(torch.int64))
    group_alive = (kept_counts > 0) & (inter_words != 0).any(dim=1)
    inter_bits = torch.where(group_alive[:, None], inter_words, 0)
    # a group that kept rows but intersected empty is "dropped" in the
    # reference's printed accounting; a group whose rows all died in
    # thresholding never reaches intersection and is not counted there
    reached_intersection = kept_counts > 0

    # tie-proximity guard: count (group, feature) score ratios within
    # tie_eps of the threshold at BOTH the initial state and the final
    # survivor state, on the ORIGINAL per-row bitsets, so that
    # boundary-dropped features count too
    near_ties = torch.zeros((), dtype=torch.int64, device=dev)
    if threshold > 0 and tie_eps > 0:
        eps = torch.tensor(tie_eps, dtype=f32, device=dev)
        for surv in (init_surviving, surviving):
            spf, _, safe_tot = score_split(surv)
            for w0, w1 in blocks:
                fscores = segment(expand(bits[:, w0:w1]).to(f32) * spf[:, None], "sum", 0.0)
                ratio = fscores / safe_tot[:, None]
                near_ties += ((fscores > 0) & ((ratio - thr).abs() <= eps)).sum()
    if stats is not None:
        stats["iterations"] = iterations
        stats["block_words"] = wb
    return inter_bits, group_alive, reached_intersection, near_ties.to(torch.int32)


def rows_to_bitsets(
    rows: Sequence[Tuple[str, str, str, float]],
) -> Tuple[List[str], List[str], np.ndarray, np.ndarray, List[str]]:
    """Alignment-TSV report rows (cb, umi, features-string, score) -> the
    device pipeline's inputs: (cbs, umis, (N, W) int32 bitsets, scores,
    feature_names). Features factorize in first-seen order; duplicate names
    within one row dedupe via the bitset (matching the reference's set
    semantics)."""
    name_to_id: Dict[str, int] = {}
    names: List[str] = []
    fids: List[int] = []
    per_row = np.empty(len(rows), dtype=np.int64)
    for i, (_, _, f, _) in enumerate(rows):
        parts = f.split(",")
        per_row[i] = len(parts)
        for name in parts:
            fid = name_to_id.get(name)
            if fid is None:
                fid = len(names)
                name_to_id[name] = fid
                names.append(name)
            fids.append(fid)
    W = max(1, -(-len(names) // 32))
    # build as uint32 (bit 31 overflows int32), ship as int32 bit patterns
    bits = np.zeros((len(rows), W), dtype=np.uint32)
    fid = np.asarray(fids, dtype=np.int64)
    row = np.repeat(np.arange(len(rows)), per_row)
    np.bitwise_or.at(bits, (row, fid >> 5), (np.uint32(1) << (fid & 31).astype(np.uint32)))
    cbs = [r[0] for r in rows]
    umis = [r[1] for r in rows]
    scores = np.array([r[3] for r in rows], dtype=np.float64)
    return cbs, umis, bits.view(np.int32), scores, names


def report_device_rows(
    rows: Sequence[Tuple[str, str, str, float]],
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    device="cuda",
) -> Tuple[List[Tuple[str, int, str]], int]:
    """Drop-in device-path equivalent of quant.exact.report_rows: report
    rows in, ((feature, count, cb) rows, dropped-UMI count) out, with the
    pipeline on `device` ('cuda', 'cpu' or a torch.device)."""
    dev = resolve_device(device) if isinstance(device, str) else device
    if not rows:
        return [], 0
    with runlog().stage("report_bitsets", rows=len(rows)):
        cbs, umis, bits, scores, names = rows_to_bitsets(rows)
    return report_device(
        cbs, umis, bits, scores, names, threshold, disable_thresholding,
        with_dropped=True, device=dev,
    )


def report_distributed_rows(
    rows: Sequence[Tuple[str, str, str, float]],
    n_shards: int,
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    device="cuda",
) -> Tuple[List[Tuple[str, int, str]], int]:
    """Distributed-path equivalent of quant.exact.report_rows: deals the
    rows round-robin over n_shards shards (as if each shard had aligned its
    own slice of the read stream) and runs the (cb, umi) bucket exchange +
    per-shard device pipeline (parallel/dist.py), the shards on
    cuda:0..N-1 or, for device 'cpu', N CPU shards."""
    from nimble_tpu_torch.parallel.dist import distributed_report, shard_devices

    devices = shard_devices(n_shards, device)
    if not rows:
        return [], 0
    with runlog().stage("report_bitsets", rows=len(rows)):
        cbs, umis, bits, scores, names = rows_to_bitsets(rows)
    shard_rows = [[] for _ in range(n_shards)]
    for i in range(len(rows)):
        shard_rows[i % n_shards].append((cbs[i], umis[i], bits[i], float(scores[i])))
    return distributed_report(
        devices, shard_rows, names, threshold, disable_thresholding,
        with_dropped=True,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def report_device(
    cbs: Sequence[str],
    umis: Sequence[str],
    bits: np.ndarray,
    scores: np.ndarray,
    feature_names: Sequence[str],
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    with_dropped: bool = False,
    device="cuda",
):
    """Per-cell count matrix from align outputs via the device pipeline on
    `device` ('cuda' by default, which raises without a card; 'cpu' runs
    the same ops on the CPU).

    Input rows are (cb, umi, feature-bitset, score). Output rows are
    (feature, count, cell_barcode) sorted like the reference. With
    with_dropped=True returns (rows, dropped-UMI count): UMIs that reached
    intersection but intersected empty, matching the exact path's
    accounting. Each part's wall goes to the run log (NIMBLE_TPU_RUNLOG),
    with the pipeline's CUDA-event time and fixpoint iterations on the
    card."""
    dev = resolve_device(device) if isinstance(device, str) else device
    n = len(cbs)
    if n == 0:
        return ([], 0) if with_dropped else []
    log = runlog()
    with log.stage("report_factorize", rows=n):
        group_ids_np, uniq_keys = factorize(list(zip(cbs, umis)))
    n_groups = len(uniq_keys)
    n_features = len(feature_names)
    threshold = 0.0 if disable_thresholding else float(threshold)
    tie_eps = _tie_eps()

    with log.stage("report_h2d"):
        group_ids = torch.from_numpy(group_ids_np).to(dev)
        bits_d = torch.from_numpy(np.ascontiguousarray(bits.astype(np.int32))).to(dev)
        scores_d = torch.from_numpy(scores.astype(np.float32)).to(dev)
        _sync(dev)
    stats: dict = {}
    with log.stage("report_pipeline"):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = device_umi_pipeline(
            group_ids, bits_d, scores_d, n_groups, n_features, threshold, tie_eps, stats,
        )
        if dev.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
    with log.stage("report_d2h"):
        inter_bits, alive, reached, near_ties = (t.cpu().numpy() for t in out)
    near_ties = int(near_ties)
    log.event(
        "report_device", device=str(dev), rows=n, groups=n_groups, words=bits_d.shape[1],
        iterations=stats["iterations"], block_words=stats["block_words"], near_ties=near_ties,
        pipeline_ms=ev[0].elapsed_time(ev[1]) if dev.type == "cuda" else None,
    )
    dropped = int(np.sum(reached & ~alive))
    if near_ties:
        print(
            f"WARNING: {near_ties} per-UMI feature score ratio(s) within "
            f"{_tie_eps():g} of the {threshold:g} threshold — float32 "
            "accumulation order can flip these decisions vs the exact "
            "float64 host path. For bit-exact output rerun without "
            "--device/--distributed (the host report is the oracle).",
            file=sys.stderr,
        )
    with log.stage("report_count"):
        rows = _count_rows(inter_bits, alive, uniq_keys, feature_names)
    return (rows, dropped) if with_dropped else rows


def _count_rows(inter_bits: np.ndarray, alive: np.ndarray, uniq_keys, feature_names):
    """Host finish: decode the surviving intersections, count UMIs per
    (cb, feature-string), sort by (cb, feature), as the reference's loop
    over groups does. Each distinct intersection is decoded once, and the
    counting and sorting run on integer codes."""
    from nimble_tpu_torch.align.pipeline import _unique_rows, decode_bitsets

    live = np.flatnonzero(alive)
    sets, inverse = _unique_rows(inter_bits[live])
    member = decode_bitsets(sets.view(np.uint32), len(feature_names))
    labels = [",".join(sorted(feature_names[f] for f in np.flatnonzero(m))) for m in member]
    code_of: Dict[str, int] = {}
    cb_code = np.fromiter((code_of.setdefault(uniq_keys[g][0], len(code_of)) for g in live.tolist()),
                          dtype=np.int64, count=live.size)
    cbs = list(code_of)
    key, counts = np.unique(cb_code * len(labels) + np.asarray(inverse).reshape(-1), return_counts=True)
    c, s = np.divmod(key, max(1, len(labels)))
    keep = np.array([bool(lab) for lab in labels], dtype=bool)[s]
    c, s, counts = c[keep], s[keep], counts[keep]

    def ranks(strings):  # string order as integer ranks
        r = np.empty(len(strings), dtype=np.int64)
        r[sorted(range(len(strings)), key=strings.__getitem__)] = np.arange(len(strings))
        return r

    order = np.lexsort((ranks(labels)[s], ranks(cbs)[c]))
    return [(labels[si], n, cbs[ci])
            for ci, si, n in zip(c[order].tolist(), s[order].tolist(), counts[order].tolist())]
