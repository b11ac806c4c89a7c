"""Alignment-results TSV I/O and the `report` subcommand implementation.

The alignment TSV schema matches the reference backend's output (reference
consumers: nimble/__main__.py:237-241, nimble/report_generation.py:275-288):
a header row, then one row per aligned read-pair with at least
nimble_features, nimble_score, r1_CB, r1_UB (+ mirrored r2_*), r1_POS,
r2_POS, r1_forward_score, r2_forward_score, and arbitrary extra columns.

`report` converts that TSV into the per-cell count matrix
(feature\tcount\tcell_barcode, no header; reference: __main__.py:254-310).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

# pandas' default NA token set (subset relevant to TSV cells), so our parser
# drops the same rows pandas would (reference: __main__.py:244).
_NA_TOKENS = {
    "",
    "#N/A",
    "#N/A N/A",
    "#NA",
    "-1.#IND",
    "-1.#QNAN",
    "-NaN",
    "-nan",
    "1.#IND",
    "1.#QNAN",
    "<NA>",
    "N/A",
    "NA",
    "NULL",
    "NaN",
    "None",
    "n/a",
    "nan",
    "null",
}


def is_na(value: str) -> bool:
    return value in _NA_TOKENS


def read_tsv(path: str) -> Tuple[List[str], List[List[str]]]:
    """Read a TSV into (header, rows-of-strings). No quoting (the reference
    reads with csv.QUOTE_NONE; reference: __main__.py:219)."""
    with open(path) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines:
        return [], []
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:]]
    return header, rows


def read_alignment_tsv(path: str) -> Optional[Dict[str, List[str]]]:
    """Read the alignment TSV as a column dict, or None when the input is
    empty / has no data rows (reference: check_df_from_input,
    __main__.py:213-232)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    header, rows = read_tsv(path)
    if not header or not rows:
        return None
    cols: Dict[str, List[str]] = {name: [] for name in header}
    ncol = len(header)
    for row in rows:
        # pandas pads short rows with NaN
        for i, name in enumerate(header):
            cols[name] = cols[name]
        for i in range(ncol):
            cols[header[i]].append(row[i] if i < len(row) else "")
    return cols


def _parse_scores(values: Sequence[str]) -> List[Optional[float]]:
    """Parse a score column with pandas-like dtype inference: all-integral ->
    int, otherwise float; NA tokens -> None."""
    parsed: List[Optional[float]] = []
    any_float = False
    for v in values:
        if is_na(v):
            parsed.append(None)
            any_float = True  # presence of NaN makes pandas use float64
            continue
        try:
            parsed.append(int(v))
        except ValueError:
            parsed.append(float(v))
            any_float = True
    if any_float:
        parsed = [float(p) if p is not None else None for p in parsed]
    return parsed


def extract_report_rows(cols: Dict[str, List[str]]):
    """r1_CB/r1_UB/nimble_features/nimble_score -> quant rows, dropping
    null/empty cells (reference: convert_df_to_proper_umi,
    __main__.py:234-252)."""
    cbs = cols["r1_CB"]
    umis = cols["r1_UB"]
    feats = cols["nimble_features"]
    scores = _parse_scores(cols["nimble_score"])
    rows = []
    for cb, umi, f, s in zip(cbs, umis, feats, scores):
        if s is None or is_na(cb) or is_na(umi) or is_na(f):
            continue
        if cb == "" or umi == "" or f == "":
            continue
        rows.append((cb, umi, f, s))
    return rows


def write_empty_counts(output: str) -> None:
    print("No data to parse from input file, writing empty output.")
    open(output, "w").close()


def write_counts(output: str, rows: Sequence[Tuple[str, int, str]]) -> None:
    """feature\tcount\tcell_barcode, tab-separated, no header, no index
    (reference: __main__.py:290-293)."""
    with open(output, "w") as f:
        for feature, count, cb in rows:
            f.write(f"{feature}\t{count}\t{cb}\n")


def _value_counts_str(values: Sequence[str]) -> str:
    """pandas value_counts().to_dict() rendered as 'k(v); ...': descending
    count, ties in first-appearance order (reference: summarize_fields,
    __main__.py:307-310)."""
    counts: Dict[str, int] = {}
    first_seen: Dict[str, int] = {}
    for i, v in enumerate(values):
        if is_na(v):
            continue
        if v not in counts:
            first_seen[v] = i
            counts[v] = 0
        counts[v] += 1
    items = sorted(counts.items(), key=lambda kv: (-kv[1], first_seen[kv[0]]))
    return "; ".join(f"{k}({v})" for k, v in items)


def summarize_fields(
    cols: Dict[str, List[str]], columns: Sequence[str], output_file: str
) -> None:
    """Per-UMI value-count summaries of arbitrary TSV columns (reference:
    __main__.py:307-310). Groups by the renamed 'umi' (r1_UB) column."""
    umis = cols["r1_UB"]
    grouped: Dict[str, Dict[str, List[str]]] = {}
    for i, umi in enumerate(umis):
        g = grouped.setdefault(umi, {c: [] for c in columns})
        for c in columns:
            g[c].append(cols[c][i])
    with open(output_file, "w") as f:
        f.write("umi\t" + "\t".join(columns) + "\n")
        for umi in sorted(grouped):
            vals = [_value_counts_str(grouped[umi][c]) for c in columns]
            f.write(umi + "\t" + "\t".join(vals) + "\n")


def report(
    input: str,
    output: str,
    summarize_columns_list: Optional[Sequence[str]] = None,
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    engine: str = "host",
    stream: Optional[bool] = None,
    device="cuda",
) -> None:
    """The `report` subcommand (reference: __main__.py:254-297).

    engine selects the UMI pipeline: "host" is the exact float64 path (the
    bit-exactness oracle); "device" runs it as torch segment ops on
    `device` (quant/device.py: 'cuda' by default, which raises without a
    card, or 'cpu'). The reference's "distributed" engine is not ported
    (ROADMAP Queue 1 item 8) and raises.

    stream (host engine only): run the host path via bounded spill buckets
    (quant/stream.py) so inputs larger than RAM work, bit-identically.
    None = auto: stream when the input exceeds NIMBLE_TPU_REPORT_STREAM_MB
    (default 4096).

    Each part's wall goes to the run log (NIMBLE_TPU_RUNLOG)."""
    if engine == "distributed":
        raise NotImplementedError("report --distributed is not ported (ROADMAP Queue 1 item 8)")
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")
    if engine == "device":
        from nimble_tpu_torch.device import resolve_device

        device = resolve_device(device) if isinstance(device, str) else device
    else:
        if stream is None:
            cap_mb = int(os.environ.get("NIMBLE_TPU_REPORT_STREAM_MB", "4096"))
            stream = (
                os.path.exists(input)
                and os.path.getsize(input) > cap_mb << 20
            )
        if stream:
            from nimble_tpu_torch.quant.stream import stream_report

            stream_report(
                input,
                output,
                summarize_columns_list,
                threshold,
                disable_thresholding,
            )
            return
    from nimble_tpu_torch.observability import runlog

    log = runlog()
    with log.stage("report_parse"):
        cols = read_alignment_tsv(input)
    if cols is None:
        write_empty_counts(output)
        return

    with log.stage("report_extract"):
        rows = extract_report_rows(cols)
    if not rows:
        write_empty_counts(output)
        return

    if engine == "device":
        from nimble_tpu_torch.quant.device import report_device_rows

        counts, dropped = report_device_rows(rows, threshold, disable_thresholding, device=device)
    else:
        from nimble_tpu_torch.quant.exact import report_rows

        counts, dropped = report_rows(rows, threshold, disable_thresholding)
    print(f"Dropped {dropped} UMIs due to empty intersections")
    with log.stage("report_write"):
        write_counts(output, counts)

    if summarize_columns_list:
        # The reference prepends the literal prefix to the whole output path
        # (reference: __main__.py:296); we preserve that behavior.
        summary_output = "summarize." + output
        summarize_fields(cols, summarize_columns_list, summary_output)


def write_alignment_tsv(path: str, header: Sequence[str], rows) -> None:
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        for row in rows:
            f.write("\t".join(str(v) for v in row) + "\n")
