"""Streaming exact report: the bit-identical host pipeline over alignment
TSVs larger than RAM.

The reference's report path loads the whole TSV into pandas (reference:
nimble/__main__.py:219 pd.read_csv); this engine emits TSVs ~100x faster
than the reference produces them, so at its own throughput the in-memory
exact path (report/tsv.py + quant/exact.py) becomes the memory bottleneck.

Why streaming preserves bit-identity:

- Every stage of the exact pipeline (convert_rows_to_proper_umi's
  groupby-sum, the thresholding fixpoint, the per-UMI intersection) is
  independent across (cb, umi) groups; only the final count matrix (keyed
  (cell_barcode, feature), summed over UMIs) and the dropped-UMI counter
  cross groups, and both are additive. So rows are partitioned by a
  DETERMINISTIC hash of (cb, umi) into bounded spill buckets (crc32, not
  Python hash: PYTHONHASHSEED varies), each bucket preserving input row
  order, and the unmodified quant.exact.report_rows runs per bucket.
  Within-group float accumulation order is input row order in both paths.

- The single global coupling is pandas' column-wide dtype inference
  (report/tsv.py:_parse_scores): ANY float-formatted or NA score cell
  anywhere in the file — including in rows later dropped for NA cb/umi —
  makes EVERY score a float64. Pass 1 computes that flag over all score
  cells while spilling, and per-bucket parsing applies it globally.

- summarize (--summarize) groups by umi only, with first-appearance tie
  order inside each group, so it gets its own umi-hashed bucket set; its
  output (one line per umi) is output-sized, held in memory, and emitted
  in globally sorted umi order.
"""
from __future__ import annotations

import os
import tempfile
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from nimble_tpu_torch.report.tsv import is_na, write_counts, write_empty_counts
from nimble_tpu_torch.quant.exact import report_rows

# Unit separator: cannot appear in TSV cells (they are tab/newline-free by
# construction), so spill rows join cells with it losslessly.
_SEP = "\x1f"


def _n_buckets(input_size: int, bucket_bytes: int) -> int:
    return max(1, min(512, -(-input_size // max(1, bucket_bytes))))


class _Spill:
    """Round-robin-by-hash spill writer: n_buckets append-only text files
    in a private temp dir, buffered per bucket."""

    def __init__(self, n_buckets: int, tmpdir: str, tag: str):
        self.n = n_buckets
        self.paths = [
            os.path.join(tmpdir, f"{tag}_{i:04d}.spill") for i in range(n_buckets)
        ]
        self.files = [open(p, "w", buffering=1 << 20) for p in self.paths]

    def put(self, key: str, cells: Sequence[str]) -> None:
        b = zlib.crc32(key.encode()) % self.n
        self.files[b].write(_SEP.join(cells) + "\n")

    def close_writes(self) -> None:
        for f in self.files:
            f.close()

    def read_bucket(self, i: int) -> List[List[str]]:
        with open(self.paths[i]) as f:
            return [line.rstrip("\n").split(_SEP) for line in f]


def _score_is_float(v: str) -> Tuple[bool, bool]:
    """(is_na_or_unparseable_as_int, row_is_droppable_na) for a score cell,
    mirroring report/tsv.py:_parse_scores inference per cell."""
    if is_na(v):
        return True, True
    try:
        int(v)
        return False, False
    except ValueError:
        float(v)  # raises like the in-memory path on garbage
        return True, False


def stream_report(
    input: str,
    output: str,
    summarize_columns_list: Optional[Sequence[str]] = None,
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    bucket_bytes: int = 64 << 20,
    tmpdir: Optional[str] = None,
) -> None:
    """Streaming bit-identical equivalent of report/tsv.py:report's
    in-memory path. bucket_bytes bounds per-bucket memory (default 64 MiB
    of input bytes per bucket; #buckets capped at 512)."""
    if not os.path.exists(input) or os.path.getsize(input) == 0:
        write_empty_counts(output)
        return

    size = os.path.getsize(input)
    nb = _n_buckets(size, bucket_bytes)
    summarize_columns_list = list(summarize_columns_list or [])

    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        with open(input) as f:
            header_line = f.readline()
            if not header_line:
                write_empty_counts(output)
                return
            header = header_line.rstrip("\n").split("\t")
            col_idx = {name: i for i, name in enumerate(header)}
            try:
                i_cb = col_idx["r1_CB"]
                i_umi = col_idx["r1_UB"]
                i_f = col_idx["nimble_features"]
                i_s = col_idx["nimble_score"]
            except KeyError:
                # same failure mode as the in-memory path's cols[...] access
                raise
            i_sum = [col_idx[c] for c in summarize_columns_list]

            spill = _Spill(nb, td, "cbumi")
            sspill = (
                _Spill(nb, td, "umi") if summarize_columns_list else None
            )
            any_float = False
            any_rows = False

            def cell(row: List[str], i: int) -> str:
                return row[i] if i < len(row) else ""

            # NOTE: blank lines are NOT skipped — read_tsv turns an interior
            # blank line into an all-empty row whose "" score cell flips the
            # column-wide float inference, and file iteration yields exactly
            # read_tsv's row set (the trailing-newline phantom is popped by
            # both: iteration never yields it, read_tsv pops it).
            for line in f:
                row = line.rstrip("\n").split("\t")
                any_rows = True
                s = cell(row, i_s)
                isf, drop_na = _score_is_float(s)
                any_float = any_float or isf
                cb, umi, feats = cell(row, i_cb), cell(row, i_umi), cell(row, i_f)
                if sspill is not None:
                    sspill.put(umi, [umi] + [cell(row, j) for j in i_sum])
                if drop_na or is_na(cb) or is_na(umi) or is_na(feats):
                    continue
                if cb == "" or umi == "" or feats == "":
                    continue
                spill.put(cb + "\x00" + umi, [cb, umi, feats, s])
            spill.close_writes()
            if sspill is not None:
                sspill.close_writes()

        if not any_rows:
            write_empty_counts(output)
            return

        counts: Dict[Tuple[str, str], int] = {}
        dropped = 0
        for b in range(nb):
            rows = [
                (cb, umi, feats, float(s) if any_float else int(s))
                for cb, umi, feats, s in spill.read_bucket(b)
            ]
            if not rows:
                continue
            part, d = report_rows(rows, threshold, disable_thresholding)
            dropped += d
            for feature, n, cb in part:
                key = (cb, feature)
                counts[key] = counts.get(key, 0) + n

        if not counts and dropped == 0:
            # no surviving parse rows at all: the in-memory path would have
            # hit the extract_report_rows-empty branch
            write_empty_counts(output)
            return

        print(f"Dropped {dropped} UMIs due to empty intersections")
        write_counts(
            output,
            [(feature, n, cb) for (cb, feature), n in sorted(counts.items())],
        )

        if sspill is not None:
            from nimble_tpu_torch.report.tsv import _value_counts_str

            out_lines: Dict[str, str] = {}
            for b in range(nb):
                grouped: Dict[str, List[List[str]]] = {}
                for row in sspill.read_bucket(b):
                    grouped.setdefault(row[0], []).append(row[1:])
                for umi, vals in grouped.items():
                    rendered = [
                        _value_counts_str([v[j] for v in vals])
                        for j in range(len(summarize_columns_list))
                    ]
                    out_lines[umi] = umi + "\t" + "\t".join(rendered) + "\n"
            summary_output = "summarize." + output
            with open(summary_output, "w") as sf:
                sf.write("umi\t" + "\t".join(summarize_columns_list) + "\n")
                for umi in sorted(out_lines):
                    sf.write(out_lines[umi])
