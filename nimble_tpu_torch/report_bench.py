"""The report engines on the card, through the port's CLI.

Writes `bench_data.write_report_tsv`'s workload (an align TSV of a 10x
run) and runs `report` on it with the host-exact engine, `--stream` and
`--device` (twice), printing each run's wall and rows/s and `--device`'s
wall split by part from the run log (TSV parse, extract_report_rows,
rows_to_bitsets + factorize, H2D, the pipeline in CUDA events with its
fixpoint iterations, D2H, decode + count + write). Every `--device` output
is held to the host report (`hold_to_host`), the two `--device` runs to
each other and `--stream` to the host report. `chip_smoke.py` runs the
same functions in its report phase.

Usage (needs a card):
  python3 -m nimble_tpu_torch.report_bench WORK [--rows N]
(over HLA-100's feature names, seed 11: the workload of chip_smoke.py's
report phase (b), at N rows)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SEED = 11  # the workload's seed, here and in chip_smoke.py's report phase
ENGINES = (("host", []), ("--stream", ["--stream"]), ("--device", ["--device"]),
           ("--device again", ["--device"]))


def say(msg: str) -> None:
    print(f"[report] {msg}", flush=True)


def run_report(tsv: str, out: str, flags=()):
    """One `report` through the CLI in this process, with the run log on
    (NIMBLE_TPU_RUNLOG must be set before the first report of the process).
    Returns (wall s, {stage: wall s} of this run, its report_device event or
    None)."""
    from nimble_tpu_torch.__main__ import main

    log = os.environ["NIMBLE_TPU_RUNLOG"]
    seen = os.path.getsize(log) if os.path.exists(log) else 0
    t0 = time.perf_counter()
    rc = main(["report", "-i", tsv, "-o", out, *flags])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"report {' '.join(flags)} exited {rc}")
    with open(log) as f:
        f.seek(seen)
        events = [json.loads(ln) for ln in f if ln.strip()]
    stages = {e["stage"]: e["wall_s"] for e in events if e["event"] == "stage_end"}
    dev = [e for e in events if e["event"] == "report_device"]
    return wall, stages, dev[-1] if dev else None


def _count_rows(path: str) -> dict:
    """A count TSV as {(feature, cell): count}."""
    with open(path) as f:
        return {(a, c): n for a, n, c in (ln.rstrip("\n").split("\t") for ln in f)}


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def hold_to_host(label: str, host: str, dev: str, near_ties: int) -> int:
    """`--device`'s counts against the host report's: byte-identical, or,
    where the tie guard counted near ties, at most 2 x near_ties count rows
    differ (one flipped decision moves one UMI between two rows). Prints
    the differing rows; returns their number."""
    if _same_bytes(host, dev):
        say(f"{label}: --device == host, byte-identical (near_ties {near_ties})")
        return 0
    a, b = _count_rows(host), _count_rows(dev)
    diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    say(f"{label}: --device differs from host in {len(diff)} count rows, near_ties {near_ties}: "
        + "; ".join(f"{k[1]} {k[0]} host {a.get(k)} device {b.get(k)}" for k in diff[:20]))
    if near_ties == 0 or len(diff) > 2 * near_ties:
        raise AssertionError(f"{label}: --device differs from the host report in {len(diff)} count rows "
                             f"with near_ties = {near_ties}")
    return len(diff)


def device_split(label: str, wall: float, st: dict, ev: dict) -> dict:
    """Print `--device`'s wall by part, from the run's stage log; return
    the parts in seconds."""
    parts = {
        "TSV parse": st["report_parse"],
        "extract_report_rows": st["report_extract"],
        "rows_to_bitsets + factorize": st["report_bitsets"] + st["report_factorize"],
        "H2D": st["report_h2d"],
        "pipeline": st["report_pipeline"],
        "D2H": st["report_d2h"],
        "decode + count + write": st["report_count"] + st["report_write"],
    }
    parts["other"] = wall - sum(parts.values())
    say(f"{label}: split of {wall:.3f} s: " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
        + f"; pipeline {ev['pipeline_ms']:.3f} ms in CUDA events, {ev['iterations']} fixpoint iterations, "
        f"{ev['groups']} UMIs, W = {ev['words']}, {ev['block_words']} words a block, "
        f"near_ties {ev['near_ties']}")
    return parts


def bench(work: str, n_rows: int, names, seed: int, tag: str, engines=ENGINES) -> dict:
    """Write the workload under `work` and run each engine on it. Fails
    unless `--stream` equals the host report, the `--device` runs give the
    same bytes and near_ties, and `--device` holds to the host report.
    Returns {engine: (wall s, output path, report_device event)} and the
    workload's counts under "workload"."""
    from nimble_tpu_torch import bench_data

    os.makedirs(work, exist_ok=True)
    tsv = os.path.join(work, f"{tag}.tsv")
    t0 = time.perf_counter()
    info = bench_data.write_report_tsv(tsv, n_rows, names, seed)
    say(f"{tag}: wrote {n_rows} rows ({info['umis']} UMIs, {info['cells']} cells, "
        f"{os.path.getsize(tsv) / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
    runs = {"workload": info}
    for label, flags in engines:
        out = os.path.join(work, f"{tag}_{len(runs)}.tsv")
        if label.startswith("--device"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        wall, st, ev = run_report(tsv, out, flags)
        runs[label] = (wall, out, ev)
        say(f"{tag} {label}: {wall:.3f} s, {n_rows / wall:,.0f} rows/s")
        if ev is not None:
            device_split(f"{tag} {label}", wall, st, ev)
            say(f"{tag} {label}: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    host = runs["host"][1]
    if "--stream" in runs and not _same_bytes(host, runs["--stream"][1]):
        raise AssertionError(f"{tag}: --stream differs from the host report")
    devs = [runs[k] for k in runs if k.startswith("--device")]
    for _, out, ev in devs[1:]:
        if not _same_bytes(devs[0][1], out) or ev["near_ties"] != devs[0][2]["near_ties"]:
            raise AssertionError(f"{tag}: two --device runs differ")
    if len(devs) > 1:
        say(f"{tag}: the {len(devs)} --device runs give the same bytes and near_ties ({devs[0][2]['near_ties']})")
    hold_to_host(tag, host, devs[0][1], devs[0][2]["near_ties"])
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="report_bench", description=__doc__.split("\n\n")[0])
    parser.add_argument("work", help="directory for the workload, outputs and run log")
    parser.add_argument("--rows", type=int, default=2_097_152)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("report_bench: torch.cuda.is_available() is False; this bench needs a CUDA card",
              file=sys.stderr)
        return 1
    from nimble_tpu_torch import bench_data
    from nimble_tpu_torch.native_build import build_native

    build_native()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"{torch.cuda.get_device_name(0)} ({smi}), host cores {os.cpu_count()}")
    os.makedirs(args.work, exist_ok=True)
    os.environ.setdefault("NIMBLE_TPU_RUNLOG", os.path.join(args.work, "runlog.jsonl"))
    bench(args.work, args.rows, bench_data.hla100_names(), SEED, f"hla100_{args.rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
