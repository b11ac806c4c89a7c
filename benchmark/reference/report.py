"""The plain reference of `report`: per-cell counts from align TSV rows.

The contract (the nimble reference's pandas pipeline, nimble/__main__.py
and nimble/utils.py):

  1. each row's features are sorted; rows of one (cell, UMI, features)
     merge, their scores summed in row order;
  2. within each (cell, UMI), every row's score is spread evenly over its
     features and each feature's share of the UMI's total is taken; the
     features whose share is below `threshold` go, and the scores are
     spread again over each row's features less those (rows with none left
     drop out of the total), until a pass drops nothing; the features that
     hold a share then survive;
  3. a UMI's call is the intersection of its rows' surviving feature sets;
     an empty call drops the UMI;
  4. each cell counts its UMIs per call: lines `call<TAB>count<TAB>cell`,
     sorted by cell, then call.

Sums run in the pandas pipeline's order (rows in key order, features in
their listed order), so every float comparison comes out as it does there.
"""
from __future__ import annotations

from collections import defaultdict


def _shares(rows, dropped):
    """{feature: summed share} and the total over rows that keep a feature."""
    share, total = {}, 0
    for feats, score in rows:
        kept = [f for f in feats if f not in dropped]
        if not kept:
            continue
        total = total + score
        for f in kept:
            share[f] = share.get(f, 0) + score / len(kept)
    return share, total


def _below(s: float, total: float, threshold: float) -> bool:
    if total == 0:  # pandas' division: 0/0 is NaN, s/0 is an infinity
        return s != 0 and (float("-inf") if s < 0 else float("inf")) < threshold
    return s / total < threshold


def umi_call(rows, threshold: float):
    """The call of one UMI's rows [(features list, score)]: a sorted list,
    [] when the UMI drops. Each pass spreads the scores over the rows'
    features less those that the pass before found below the threshold,
    as the pandas pipeline does, until a pass finds none."""
    share, total = _shares(rows, set())
    while share:
        gone = {f for f, s in share.items() if _below(s, total, threshold)}
        if not gone:
            break
        share, total = _shares(rows, gone)
    calls = [set(feats) & set(share) for feats, _ in rows]
    calls = [c for c in calls if c]
    return sorted(set.intersection(*calls)) if calls else []


def counts(tsv_lines, threshold: float = 0.05) -> str:
    """The counts file's text of an align TSV's data lines."""
    merged = {}
    for line in tsv_lines:
        f = line.rstrip("\n").split("\t")
        feats, score, cb, umi = f[0], int(f[1]), f[2], f[3]
        if not (feats and cb and umi):
            continue
        key = (cb, umi, ",".join(sorted(feats.split(","))))
        merged[key] = merged.get(key, 0) + score
    by_umi = defaultdict(list)
    for (cb, umi, feats), score in sorted(merged.items()):
        by_umi[(cb, umi)].append((feats.split(","), score))
    tally = defaultdict(int)
    for (cb, _umi), rows in by_umi.items():
        call = umi_call(rows, threshold)
        if call:
            tally[(cb, ",".join(call))] += 1
    return "".join(f"{call}\t{n}\t{cb}\n" for (cb, call), n in sorted(tally.items()))
