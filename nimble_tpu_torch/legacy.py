"""Legacy bulk-RNA report path: filter chain over a features/score TSV.

Rebuilds the reference's older non-UMI quantification flow (reference:
nimble/reporting.py, nimble/parse.py:39-57, nimble/utils.py:57-114): the
aligner TSV of the form `features\tscore\t...metadata` is run through the
library Config's `filters` chain (minPct, minCount), dropped references are
removed from ambiguity classes, and equal classes are collapsed with summed
scores. This is the bulk quantification mode: features -> score-sum table
instead of per-cell counts.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple


def parse_filter_config(reference_path: str) -> Tuple[List[str], List[object]]:
    """Read the filters list from a library JSON (reference: parse.py:61-72)."""
    with open(reference_path) as f:
        data = json.load(f)
    methods = []
    values = []
    for method in data[0]["filters"]:
        methods.append(method["name"])
        values.append(method["value"])
    return methods, values


def parse_legacy_results(input_path: str):
    """Legacy aligner TSV -> (rows, header). Each row is
    (feature_list, score, metadata_fields) (reference: parse.py:39-57)."""
    rows = []
    with open(input_path) as f:
        header = next(f).rstrip("\n")
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            features = [x for x in fields[0].split(",") if x]
            score = float(fields[1]) if "." in fields[1] else int(fields[1])
            rows.append((features, score, fields[1:]))
    return rows, header


def _reference_scores(rows) -> Dict[str, float]:
    totals: Dict[str, float] = {}
    for features, score, _ in rows:
        for ref in set(features):
            totals[ref] = totals.get(ref, 0) + score
    return totals


def _min_pct(rows, pct: Optional[float]):
    """Drop references below a fraction of total score (reference:
    reporting.py:14-33; default 0.01)."""
    if pct is None:
        pct = 0.01
    total = sum(score for _, score, _ in rows)
    if total == 0:
        return rows
    ref_scores = _reference_scores(rows)
    to_drop = {r for r, s in ref_scores.items() if s / total < pct}
    return [
        ([f for f in features if f not in to_drop], score, meta)
        for features, score, meta in rows
    ]


def _min_count(rows, count: Optional[float]):
    """Drop references below an absolute score sum (reference:
    reporting.py:37-55; default 5)."""
    if count is None:
        count = 5
    ref_scores = _reference_scores(rows)
    to_drop = {r for r, s in ref_scores.items() if s < count}
    return [
        ([f for f in features if f not in to_drop], score, meta)
        for features, score, meta in rows
    ]


_FILTERS = {"minPct": _min_pct, "minCount": _min_count}


def apply_filters(rows, methods: Sequence[str], values: Sequence[object]):
    """Chain filters in order (reference: reporting.py:59-79)."""
    for method, value in zip(methods, values):
        if method not in _FILTERS:
            raise ValueError(f"No such filter, {method}")
        rows = _FILTERS[method](rows, value)
    return rows


def collapse_and_write(rows, header: str, output_path: str) -> None:
    """Collapse equal ambiguity classes summing scores; emit
    `features\tscore\t...metadata` (reference: utils.py:57-114). The
    metadata kept for a class is from its last contributing row; empty
    classes (all references filtered) are dropped."""
    cache: Dict[str, Tuple[float, List[str]]] = {}
    for features, score, meta in rows:
        if not features:
            continue
        key = ",".join(features)
        if key in cache:
            score = cache[key][0] + score
        cache[key] = (score, meta)
    with open(output_path, "w") as f:
        f.write(header + "\n")
        for key, (score, meta) in cache.items():
            score_str = str(int(score)) if float(score).is_integer() else str(score)
            rest = meta[1:]
            f.write("\t".join([key, score_str] + rest) + "\n")


def bulk_report(
    methods: Sequence[str], values: Sequence[object], results_path: str, output_path: str
) -> None:
    """The legacy bulk report API (reference: reporting.py:73-79)."""
    rows, header = parse_legacy_results(results_path)
    rows = apply_filters(rows, methods, values)
    collapse_and_write(rows, header, output_path)
