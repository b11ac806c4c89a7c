"""Exact quantification: per-UMI thresholding, intersection, counting.

This is the exactness-critical path: it must produce bit-identical count
matrices to the reference's pandas implementation (reference:
nimble/utils.py:119-224, nimble/__main__.py:234-297). The reference iterates
pandas groups in sorted key order and accumulates float scores in row order;
we reproduce the same operation order with plain Python floats (IEEE double),
so results match to the last bit while running orders of magnitude faster than
the reference's per-group DataFrame construction.

Row model: a "row" is one (cb, umi, features, score) tuple, where features is
a comma-separated string of feature names (an ambiguity class).
"""
from __future__ import annotations

from itertools import groupby as _groupby
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Row = Tuple[str, str, str, float]  # (cb, umi, features, score)


def convert_rows_to_proper_umi(rows: Iterable[Row]) -> List[Row]:
    """Sort each row's feature list, then group by (cb, umi, features) and
    sum scores (reference: __main__.py:234-252). Output is sorted by the
    group key, matching pandas groupby(sort=True); within-group score
    summation happens in input row order, matching pandas' sequential
    cython group-sum.
    """
    agg: Dict[Tuple[str, str, str], float] = {}
    for cb, umi, features, score in rows:
        key = (cb, umi, ",".join(sorted(features.split(","))))
        if key in agg:
            agg[key] = agg[key] + score
        else:
            agg[key] = score
    return [(cb, umi, f, s) for (cb, umi, f), s in sorted(agg.items())]


def _threshold_one_umi(
    group: Sequence[Row], threshold: float
) -> List[Tuple[str, str, str, float, str]]:
    """Iterative proportional thresholding for one (cb, umi) group
    (reference: utils.py:120-191). Returns rows extended with the
    filtered_features string ('' when empty).

    Algorithm: distribute each row's score equally over its (possibly
    duplicated) features; iteratively drop features whose share of
    total_score is strictly below threshold, redistributing scores over
    surviving features and recomputing total_score excluding rows with no
    surviving features, until fixpoint or empty.
    """
    # Initial proportional scores; accumulation order matches the reference's
    # row-order iteration + groupby('feature') sequential sum.
    feature_scores: Dict[str, float] = {}
    total_score = 0
    for _, _, features_str, score in group:
        features = features_str.split(",")
        score_per_feature = score / len(features)
        total_score = total_score + score
        for feature in features:
            if feature in feature_scores:
                feature_scores[feature] = feature_scores[feature] + score_per_feature
            else:
                feature_scores[feature] = score_per_feature

    filtered_features_set: Optional[set] = None

    def ratio_below(s: float, total: float) -> bool:
        # mirror pandas IEEE division: 0/0 -> NaN (never < threshold),
        # s/0 -> +-inf (reference: utils.py:146-147 divides without guards)
        if total == 0:
            if s == 0:
                return False
            return (float("-inf") if s < 0 else float("inf")) < threshold
        return s / total < threshold

    while True:
        if not feature_scores:
            filtered_features_set = set()
            break

        to_drop = {f for f, s in feature_scores.items() if ratio_below(s, total_score)}
        if not to_drop:
            filtered_features_set = set(feature_scores)
            break

        new_scores: Dict[str, float] = {}
        total_score = 0
        any_row = False
        for _, _, features_str, score in group:
            features = [f for f in features_str.split(",") if f not in to_drop]
            if not features:
                continue
            any_row = True
            score_per_feature = score / len(features)
            total_score = total_score + score
            for feature in features:
                if feature in new_scores:
                    new_scores[feature] = new_scores[feature] + score_per_feature
                else:
                    new_scores[feature] = score_per_feature

        if not any_row:
            filtered_features_set = set()
            break
        feature_scores = new_scores

    out = []
    for cb, umi, features_str, score in group:
        kept = set(features_str.split(",")) & filtered_features_set
        filtered = ",".join(sorted(kept)) if kept else ""
        out.append((cb, umi, features_str, score, filtered))
    return out


def per_umi_thresholding(
    rows: Sequence[Row], threshold: float
) -> List[Tuple[str, str, str, float, str]]:
    """Apply the per-UMI thresholding fixpoint to every (cb, umi) group and
    drop rows whose filtered_features comes out empty (reference:
    utils.py:119-207). `rows` must already be grouped/sorted by (cb, umi)
    as produced by convert_rows_to_proper_umi; output preserves row order,
    matching the reference's inner merge back onto the input frame.
    """
    out: List[Tuple[str, str, str, float, str]] = []
    for _, group_iter in _groupby(rows, key=lambda r: (r[0], r[1])):
        group = list(group_iter)
        for row in _threshold_one_umi(group, threshold):
            if row[4] != "":
                out.append(row)
    return out


def intersect_lists(list_of_lists: Sequence[Sequence[str]]) -> List[str]:
    """Sorted intersection of feature lists (reference: utils.py:221-224)."""
    if not list_of_lists:
        return []
    return sorted(set.intersection(*map(set, list_of_lists)))


def umi_intersection(
    rows: Sequence[Tuple[str, str, str, float, str]]
) -> List[Tuple[str, str, List[str]]]:
    """Per (cb, umi): intersect the filtered_features sets of all its rows
    (reference: utils.py:209-224). Input rows carry filtered_features at
    index 4 (or index 2 for 3-tuples in no-thresholding tests). Output is
    sorted by (cb, umi)."""
    grouped: Dict[Tuple[str, str], List[List[str]]] = {}
    for row in rows:
        cb, umi = row[0], row[1]
        filtered = row[4] if len(row) >= 5 else row[2]
        grouped.setdefault((cb, umi), []).append(filtered.split(","))
    return [
        (cb, umi, intersect_lists(lists)) for (cb, umi), lists in sorted(grouped.items())
    ]


def count_matrix(
    intersections: Sequence[Tuple[str, str, List[str]]]
) -> List[Tuple[str, int, str]]:
    """Drop empty intersections, then count surviving UMIs per
    (cell_barcode, feature) where feature is the comma-joined (possibly still
    ambiguous) intersection (reference: __main__.py:277-293). Output rows are
    (feature, count, cell_barcode), sorted by (cell_barcode, feature) to match
    pandas groupby output order. Returns (rows, dropped_umi_count)."""
    counts: Dict[Tuple[str, str], int] = {}
    dropped = 0
    for cb, _, features in intersections:
        if len(features) == 0:
            dropped += 1
            continue
        key = (cb, ",".join(features))
        counts[key] = counts.get(key, 0) + 1
    rows = [(feature, n, cb) for (cb, feature), n in sorted(counts.items())]
    return rows, dropped


def report_rows(
    rows: Iterable[Row], threshold: float = 0.05, disable_thresholding: bool = False
) -> Tuple[List[Tuple[str, int, str]], int]:
    """Full report pipeline over parsed rows: proper-UMI conversion ->
    thresholding -> intersection -> counting (reference: __main__.py:254-293).
    Returns (count rows, dropped-UMI count)."""
    merged = convert_rows_to_proper_umi(rows)
    if disable_thresholding:
        thresholded = [(cb, umi, f, s, f) for cb, umi, f, s in merged]
    else:
        thresholded = per_umi_thresholding(merged, threshold)
    intersections = umi_intersection(thresholded)
    return count_matrix(intersections)
