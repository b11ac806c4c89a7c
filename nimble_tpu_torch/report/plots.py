"""HTML QC report generation (the `plot` subcommand).

Rebuilds the reference's QC report content (reference:
nimble/report_generation.py:342-719) on top of nimble_tpu's fast exact
quantification primitives instead of pandas groupby-apply loops:

  * whole-dataset summary page: total UMIs/cells, read-mates-per-UMI and
    per-cell distributions, features-per-UMI/cell distributions, top-two
    feature-ratio density;
  * threshold simulation pages at [0, 0.05, 0.10, 0.20, 0.50]: per
    read-mate categorization (unchanged / reduced features / zero passing)
    for both the thresholding and intersection steps, with top-20
    feature-transition tables (the hottest part of reference plotting —
    re-running per_umi_thresholding per threshold — runs through our exact
    row pipeline);
  * per-unambiguous-feature pages: read-mates/UMI histogram, input-BAM
    position density, r1/r2 forward-score violins, nimble-vs-input-call
    (r1_GN) confusion matrix;

concatenated into one self-contained HTML with base64-inlined PNGs.
"""
from __future__ import annotations

import base64
import os
from collections import Counter, defaultdict
from io import BytesIO
from typing import Dict, List, Sequence, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

from nimble_tpu_torch.quant.exact import (
    convert_rows_to_proper_umi,
    per_umi_thresholding,
    umi_intersection,
)
from nimble_tpu_torch.report.tsv import is_na, read_alignment_tsv, _parse_scores

THRESHOLDS = [0, 0.05, 0.10, 0.20, 0.50]
TOP_N = 20


def _b64(fig) -> str:
    buf = BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    return base64.b64encode(buf.read()).decode()


def _hist_image(values, title, xlabel, bins=50, discrete=False) -> str:
    fig, ax = plt.subplots(figsize=(8, 6))
    values = np.asarray(values)
    if discrete and values.size:
        lo, hi = int(values.min()), int(values.max())
        ax.hist(values, bins=np.arange(lo, hi + 2) - 0.5, edgecolor="white")
    else:
        ax.hist(values, bins=bins, edgecolor="white")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Frequency")
    return _b64(fig)


def _kde_image(values, title, xlabel) -> str:
    fig, ax = plt.subplots(figsize=(8, 6))
    values = np.asarray(values, dtype=float)
    values = values[np.isfinite(values)]
    if values.size > 1 and values.std() > 0:
        # gaussian KDE, Scott bandwidth
        bw = values.std() * values.size ** (-1 / 5)
        xs = np.linspace(values.min() - 3 * bw, values.max() + 3 * bw, 400)
        dens = np.exp(
            -0.5 * ((xs[:, None] - values[None, :]) / bw) ** 2
        ).sum(axis=1) / (values.size * bw * np.sqrt(2 * np.pi))
        ax.plot(xs, dens)
        ax.fill_between(xs, dens, alpha=0.25)
    elif values.size:
        ax.axvline(values[0])
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Density")
    return _b64(fig)


def _position_segments(positions, gap=150_000, pad=10_000, max_panels=5):
    """Split sorted positions into dense segments separated by gaps wider
    than `gap` (doubling `gap` until at most max_panels segments remain);
    each segment is padded by `pad` on both sides. Mirrors the reference's
    discontinuity handling for position-density plots (reference:
    nimble/report_generation.py:194-270) so features aligned against
    multi-exon / spliced references get one panel per covered region
    instead of one unreadable axis."""
    pos = np.sort(np.unique(np.asarray(positions, dtype=np.float64)))
    if pos.size == 0:
        return []
    while True:
        breaks = np.flatnonzero(np.diff(pos) > gap)
        if breaks.size <= max_panels - 1:
            break
        gap *= 2
    segments = []
    lo = pos[0]
    for b in breaks:
        segments.append((max(0.0, lo - pad), pos[b] + pad))
        lo = pos[b + 1]
    segments.append((max(0.0, lo - pad), pos[-1] + pad))
    return segments


def _panel_kde(ax, values, lo, hi, color, style):
    """One KDE curve clipped to [lo, hi] (bw_adjust=0.5-style narrow
    bandwidth, matching the reference's seaborn settings)."""
    values = np.asarray(values, dtype=np.float64)
    values = values[(values >= lo) & (values <= hi)]
    if values.size < 2 or values.std() == 0:
        if values.size:
            ax.axvline(values[0], color=color, linestyle=style, alpha=0.7)
        return
    bw = 0.5 * 1.06 * values.std(ddof=1) * values.size ** (-0.2)
    xs = np.linspace(lo, hi, 200)
    dens = np.exp(
        -0.5 * ((xs[:, None] - values[None, :]) / bw) ** 2
    ).sum(axis=1) / (values.size * bw * np.sqrt(2 * np.pi))
    ax.plot(xs, dens, color=color, linestyle=style)


def _position_density_figure(feature, p1, p2) -> str:
    """Per-feature input-BAM position density with discontinuity-split
    panels (shared y, one panel per covered region)."""
    segments = _position_segments(np.concatenate([p1, p2]))
    # drop panels with fewer than 2 positions in both mates
    segments = [
        (lo, hi)
        for lo, hi in segments
        if ((p1 >= lo) & (p1 <= hi)).sum() > 1 or ((p2 >= lo) & (p2 <= hi)).sum() > 1
    ] or segments[:1]
    fig, axes = plt.subplots(
        1, len(segments), figsize=(12, 6), sharey=True, squeeze=False
    )
    axes = axes[0]
    for ax, (lo, hi) in zip(axes, segments):
        _panel_kde(ax, p1, lo, hi, "tab:blue", "--")
        if p2.size:
            _panel_kde(ax, p2, lo, hi, "tab:red", "-")
        ax.set_xlim(lo, hi)
    axes[-1].legend(
        handles=[
            plt.Line2D([], [], color="tab:blue", linestyle="--", label="r1_POS"),
            plt.Line2D([], [], color="tab:red", linestyle="-", label="r2_POS"),
        ],
        loc="upper right",
    )
    fig.suptitle(f"Position Density: {feature}")
    fig.supxlabel("Input-BAM position")
    fig.supylabel("Density")
    return _b64(fig)


def _bar_image(categories, counts, title, xlabel, ylabel) -> str:
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.bar(categories, counts)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _b64(fig)


def _jinja_env():
    from jinja2 import Environment, FileSystemLoader

    templates_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "templates")
    return Environment(loader=FileSystemLoader(templates_dir))


def _extract_rows(cols: Dict[str, List[str]]):
    """TSV columns -> clean (cb, umi, features, score) rows (reference
    preprocessing: report_generation.py:369-383)."""
    scores = _parse_scores(cols["nimble_score"])
    rows = []
    for cb, umi, feats, score in zip(
        cols["r1_CB"], cols["r1_UB"], cols["nimble_features"], scores
    ):
        if score is None or is_na(cb) or is_na(umi) or is_na(feats):
            continue
        if cb == "" or umi == "" or feats == "":
            continue
        rows.append((cb, umi, feats, score))
    return rows


def _top_two_ratio(group) -> float:
    scores: Dict[str, float] = {}
    for _, _, feats_str, score in group:
        feats = feats_str.split(",")
        spf = score / len(feats)
        for f in feats:
            scores[f] = scores.get(f, 0.0) + spf
    top = sorted(scores.values(), reverse=True)[:2]
    if len(top) == 2:
        denom = top[0] + top[1]
        return top[0] / denom if denom else float("nan")
    if len(top) == 1:
        return 1.0
    return float("nan")


def generate_summary_page(merged_rows) -> str:
    """The whole-dataset summary (reference: report_generation.py:369-513)."""
    by_umi: Dict[Tuple[str, str], list] = defaultdict(list)
    for row in merged_rows:
        by_umi[(row[0], row[1])].append(row)

    umi_score_sums = []
    umi_feature_counts = []
    top_two = []
    cell_scores: Dict[str, float] = defaultdict(float)
    cell_features: Dict[str, set] = defaultdict(set)
    for (cb, umi), group in by_umi.items():
        total = sum(r[3] for r in group)
        feats = set()
        for r in group:
            feats.update(r[2].split(","))
        umi_score_sums.append(total)
        umi_feature_counts.append(len(feats))
        top_two.append(_top_two_ratio(group))
        cell_scores[cb] += total
        cell_features[cb].update(feats)

    env = _jinja_env()
    template = env.get_template("initial_report_template.html")
    return template.render(
        summary_stats={
            "total_umis": len(by_umi),
            "total_cells": len(cell_scores),
        },
        umi_read_counts_image=_hist_image(
            umi_score_sums,
            "Distribution of Number of Read-Mates per UMI",
            "Number of Read-Mates per UMI",
        ),
        umi_feature_counts_image=_hist_image(
            umi_feature_counts,
            "Distribution of Number of Features per UMI",
            "Number of Features per UMI",
            discrete=True,
        ),
        cell_read_counts_image=_hist_image(
            list(cell_scores.values()),
            "Distribution of Number of Read-Mates per Cell",
            "Number of Read-Mates per Cell",
        ),
        cell_feature_counts_image=_hist_image(
            [len(v) for v in cell_features.values()],
            "Distribution of Number of Unique Features per Cell",
            "Number of Features per Cell",
            discrete=True,
        ),
        top_two_ratio_image=_kde_image(
            top_two,
            "Density Plot of Top Feature Ratio over Top Two Features per UMI",
            "Top Feature Ratio",
        ),
    )


def simulate_threshold(merged_rows, threshold: float):
    """One threshold simulation (reference: simulate_thresholds,
    report_generation.py:607-688): per-row (original, post-threshold,
    post-intersection) features + categories."""
    if threshold == 0:
        thresholded = [(cb, umi, f, s, f) for cb, umi, f, s in merged_rows]
    else:
        thresholded = per_umi_thresholding(merged_rows, threshold)

    filt_by_key = {(r[0], r[1], r[2]): r[4] for r in thresholded}
    inter_by_umi = {
        (cb, umi): ",".join(feats) for cb, umi, feats in umi_intersection(thresholded)
    }

    combined = []
    for cb, umi, feats, _ in merged_rows:
        filtered = filt_by_key.get((cb, umi, feats), "")
        post = inter_by_umi.get((cb, umi), "")
        if filtered == "":
            tcat = "zero passing threshold"
        elif feats == filtered:
            tcat = "unchanged"
        else:
            tcat = "reduced features"
        if post == "":
            icat = "zero passing intersection"
        elif feats == post:
            icat = "unchanged"
        else:
            icat = "reduced features"
        combined.append(
            {
                "cb": cb,
                "umi": umi,
                "original_features": feats,
                "filtered_features": filtered,
                "post_intersection_features": post,
                "threshold_category": tcat,
                "intersection_category": icat,
            }
        )
    return combined


def generate_threshold_page(combined, threshold: float) -> str:
    tcounts = Counter(r["threshold_category"] for r in combined)

    transitions = Counter(
        (r["original_features"], r["filtered_features"])
        for r in combined
        if r["threshold_category"] == "reduced features" and r["filtered_features"]
    )
    top_transitions = [
        {"original_features": o, "filtered_features": f, "count": c}
        for (o, f), c in transitions.most_common(TOP_N)
    ]
    zero_t = Counter(
        r["original_features"]
        for r in combined
        if r["threshold_category"] == "zero passing threshold"
    )
    top_zero_t = [
        {"original_features": o, "count": c} for o, c in zero_t.most_common(TOP_N)
    ]

    # intersection categories are at UMI level
    umi_cat = {}
    for r in combined:
        umi_cat[(r["cb"], r["umi"])] = r["intersection_category"]
    icounts = Counter(umi_cat.values())

    seen = set()
    itransitions = Counter()
    zero_i = Counter()
    for r in combined:
        key = (r["cb"], r["umi"])
        if key in seen:
            continue
        seen.add(key)
        if (
            r["intersection_category"] == "reduced features"
            and r["post_intersection_features"]
        ):
            itransitions[(r["original_features"], r["post_intersection_features"])] += 1
        elif r["intersection_category"] == "zero passing intersection":
            zero_i[r["original_features"]] += 1
    top_itransitions = [
        {"original_features": o, "post_intersection_features": f, "count": c}
        for (o, f), c in itransitions.most_common(TOP_N)
    ]
    top_zero_i = [
        {"original_features": o, "count": c} for o, c in zero_i.most_common(TOP_N)
    ]

    env = _jinja_env()
    template = env.get_template("threshold_report_template.html")
    return template.render(
        threshold=threshold,
        threshold_category_counts_image=_bar_image(
            list(tcounts.keys()),
            list(tcounts.values()),
            f"Thresholding Step: Category Counts for Threshold {threshold}",
            "Category",
            "Number of Read-Mates",
        ),
        top_threshold_transitions=top_transitions,
        top_zero_passing_threshold_features=top_zero_t,
        intersection_category_counts_image=_bar_image(
            list(icounts.keys()),
            list(icounts.values()),
            f"Intersection Step: Category Counts for Threshold {threshold}",
            "Category",
            "Number of UMIs",
        ),
        top_intersection_transitions=top_itransitions,
        top_zero_passing_features=top_zero_i,
    )


def generate_feature_page(cols, row_idx: List[int], feature: str) -> str:
    """Per-feature page (reference: generate_plots_for_feature,
    report_generation.py:298-340)."""
    umi_counts = Counter(
        (cols["r1_CB"][i], cols["r1_UB"][i]) for i in row_idx
    )
    umi_hist = _hist_image(
        list(umi_counts.values()),
        f"Read-Mates per UMI: {feature}",
        "Read-Mates per UMI",
        discrete=True,
    )

    def numeric(colname):
        if colname not in cols:
            return None
        vals = []
        for i in row_idx:
            v = cols[colname][i]
            if is_na(v):
                continue
            try:
                vals.append(float(v))
            except ValueError:
                return None
        return np.asarray(vals)

    position_density_image = None
    p1 = numeric("r1_POS")
    p2 = numeric("r2_POS")
    if p1 is not None and p1.size and p1.max() >= 0:
        p1 = p1[p1 >= 0]
        p2 = p2[p2 >= 0] if p2 is not None else np.empty(0)
        position_density_image = _position_density_figure(feature, p1, p2)

    score_violin_image = None
    s1 = numeric("r1_forward_score")
    s2 = numeric("r2_forward_score")
    if s1 is not None and s1.size:
        fig, ax = plt.subplots(figsize=(12, 6))
        data = [s1] + ([s2] if s2 is not None and s2.size else [])
        ax.violinplot(data, showmedians=True)
        ax.set_xticks(range(1, len(data) + 1))
        ax.set_xticklabels(["r1_forward_score", "r2_forward_score"][: len(data)])
        ax.set_title(f"Forward score in bp: {feature}")
        score_violin_image = _b64(fig)

    confusion_image = None
    if "r1_GN" in cols:
        gn_counts = Counter(
            cols["r1_GN"][i] for i in row_idx if not is_na(cols["r1_GN"][i]) and cols["r1_GN"][i]
        )
        if gn_counts:
            labels = [k for k, _ in gn_counts.most_common(15)]
            values = np.array([[gn_counts[l] for l in labels]])
            fig, ax = plt.subplots(figsize=(12, 3))
            im = ax.imshow(values, cmap="viridis", aspect="auto")
            ax.set_yticks([0])
            ax.set_yticklabels([feature])
            ax.set_xticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=45, ha="right")
            for j, l in enumerate(labels):
                ax.text(j, 0, str(gn_counts[l]), ha="center", va="center", color="w")
            ax.set_title(f"nimble call vs input call (r1_GN): {feature}")
            confusion_image = _b64(fig)

    env = _jinja_env()
    template = env.get_template("feature_report_template.html")
    return template.render(
        feature_name=feature,
        umi_hist_image=umi_hist,
        position_density_image=position_density_image,
        score_violin_image=score_violin_image,
        confusion_image=confusion_image,
    )


def concatenate_reports(reports: Sequence[str], output_file: str) -> None:
    with open(output_file, "w") as f:
        f.write(
            """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="UTF-8">
<meta name="viewport" content="width=device-width, initial-scale=1.0">
<title>Combined Report</title>
<style>
  body { font-family: Arial, sans-serif; margin: 40px; }
  h1, h2 { color: #333; }
  img { width: 70%; height: 50%; margin-top: 20px; }
  table { border-collapse: collapse; }
  td, th { border: 1px solid #aaa; padding: 4px 8px; }
</style>
</head>
<body>
"""
        )
        for report in reports:
            f.write(report + "\n<br/>\n")
        f.write("</body></html>")


def write_empty_html_report(output: str) -> None:
    with open(output, "w") as f:
        f.write(
            "<html><head></head><body><p>Report output skipped due to empty "
            "input dataframe.</p></body></html>"
        )


def generate_plots(cols: Dict[str, List[str]], output_file: str) -> None:
    rows = _extract_rows(cols)
    if not rows:
        print("Dataframe empty after filtration, skipping plot.")
        write_empty_html_report(output_file)
        return

    merged = convert_rows_to_proper_umi(rows)
    reports = [generate_summary_page(merged)]
    for threshold in THRESHOLDS:
        print(f"Simulating UMI count proportion threshold: {threshold}")
        combined = simulate_threshold(merged, threshold)
        reports.append(generate_threshold_page(combined, threshold))

    # per-feature pages for unambiguous features
    feature_rows: Dict[str, List[int]] = defaultdict(list)
    for i, f in enumerate(cols["nimble_features"]):
        if not is_na(f) and f and "," not in f:
            feature_rows[f].append(i)
    for feature, idxs in feature_rows.items():
        print(f"Generating plots for feature {feature}")
        reports.append(generate_feature_page(cols, idxs, feature))

    print("Writing final report")
    concatenate_reports(reports, output_file)


def plot_command(input_file: str, output_file: str) -> None:
    """The `plot` subcommand (reference: __main__.py:454-468)."""
    if not os.path.exists(input_file) or os.path.getsize(input_file) == 0:
        print("Input file is empty.")
        return
    cols = read_alignment_tsv(input_file)
    if cols is None:
        print("Input file is empty.")
        return
    print(f"Loading alignment data from {input_file}")
    generate_plots(cols, output_file)
