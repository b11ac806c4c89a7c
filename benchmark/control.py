"""The control of the check: the plain reference put in the program's
place with one guarantee of the configuration broken, judged by the same
comparison as a run's jobs. It has to come out not correct.

The configuration states `num_mismatches: 0`: a read's k-mer counts only
where the library holds that exact k-mer. The control compares k-mer keys
on their low 32 bits (the last 16 bases) instead of all 2k: the narrower
key that splitting keys into 32-bit words tempts. Its outputs for one job
at the cell's own size, on each seed given, are compared with the
reference's; a number that stays at its limit of 0 would let the control
pass.

    python3 -m benchmark.control --workload <cell> --seeds <a,b,c> [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

from benchmark import check, gen, spec
from benchmark.run import Cell, reference_outputs

KEY_MASK = 0xFFFFFFFF


def readings(cell: dict, seed: int, device: str, library: str) -> dict:
    """The control's compared numbers for one job's input of `seed`."""
    c = Cell(cell, pathlib.Path(tempfile.gettempdir()))
    inputs = c.reads(seed)
    tsv, counts = reference_outputs(c, library, inputs, device)
    ctl_tsv, ctl_counts = reference_outputs(c, library, inputs, device, key_mask=KEY_MASK)
    out = {"tsv_rows_differing": check.lines_differing(tsv, ctl_tsv), "rows": tsv.count("\n") - 1}
    if counts is not None:
        out["count_lines_differing"] = check.lines_differing(counts, ctl_counts)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    with tempfile.TemporaryDirectory() as d:
        library = str(pathlib.Path(d) / "library.json")
        gen.write_library(library, cell["config"], cell["root"])
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            got = readings(cell, seed, args.device, library)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                              "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
