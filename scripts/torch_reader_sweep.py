"""Size the port's FASTQ reader pools on a card's host: whole bulk `align`
jobs, in this process, on the `hla100-bulk-se` benchmark cell's own input.

    python3 scripts/torch_reader_sweep.py [--variants 8,8:3,4:1] [--reps 4] \
        [--reader] [--seed N] [--tag NAME]

Run it from the root of a checkout (the checkout's `benchmark/` and
`nimble_tpu_torch/` are imported from the current directory, so the same
file times a parent checkout too). A variant is `C` (`align -c C`) or
`C:W` (the inflate pool's share of it, `io/threaded.py:_inflate_workers`,
set to W); the default is one variant, `-c` the cores this process may
use. Variants take turns, round robin; each prints its job walls, their
median, reads/s and the median seconds per job of the run log's
counters, and its first job's `reader` events. With `--reader`, the
reader alone is timed too at the first variant's `-c` on the cell's file
and on a one-member copy of it (the stream path), then the first touch
of a 224 MiB buffer against a second write of it.
"""
import argparse
import contextlib
import gzip
import io
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time
import zlib

KEYS = ("align", "index_build", "engine_build", "pipeline.first_batch", "pipeline.starved", "engine.submit",
        "pipeline.read", "pipeline.inflate", "pipeline.parse", "pipeline.pack", "pipeline.emit")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2147480001)
    ap.add_argument("--variants", default="")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--reader", action="store_true")
    ap.add_argument("--tag", default=os.getcwd())
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch

    from benchmark import run, spec
    from nimble_tpu_torch import __main__ as cli
    from nimble_tpu_torch import observability as obs
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.io import threaded
    from nimble_tpu_torch.native_build import build_native

    def say(*a):
        print(f"[{args.tag}]", *a, flush=True)

    torch.cuda.init()
    cell = spec.load_cell("hla100-bulk-se")
    t = time.perf_counter()
    build_native()
    K.build()
    c = run.Cell(cell, spec.HERE / ".cache")
    c.ensure_library(cli.main, "cuda")
    inputs = c.make_inputs(args.seed)
    variants = [tuple(int(x) for x in v.split(":")) for v in args.variants.split(",")] if args.variants else [
        (len(os.sched_getaffinity(0)),)]
    say("setup", round(time.perf_counter() - t, 2), "inputs", inputs["main"])
    work = pathlib.Path(tempfile.mkdtemp(prefix="reader_sweep_"))
    logp = work / "run.jsonl"
    os.environ["NIMBLE_TPU_RUNLOG"] = str(logp)
    obs._GLOBAL = obs.RunLog(str(logp))
    rl = run.Runlog(logp)

    def job(files, cores):
        values = c.values("cuda", cores, tsv=work / "job.tsv", counts="", work=work)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            for step in c.t["steps"]:
                rc = cli.main(run.fill(step["argv"], values, files))
                torch.cuda.synchronize()
                assert rc == 0
        wall = time.perf_counter() - t0
        ev = rl.new_events()
        readers = [{k: e[k] for k in e if k not in ("t", "t_ns", "event")} for e in ev if e["event"] == "reader"]
        return wall, run.job_record(ev)["stages"], readers

    cores = variants[0][0]
    job(inputs["warm"], cores)
    job(inputs["main"], cores)
    orig = getattr(threaded, "_inflate_workers", None)
    res = {v: [] for v in variants}
    for rep in range(args.reps):
        for v in variants:
            if orig is not None:
                threaded._inflate_workers = (lambda n, w=v[1]: w) if len(v) > 1 else orig
            wall, stages, readers = job(inputs["main"], v[0])
            res[v].append((wall, stages))
            if rep == 0:
                say("variant", v, "reader events", json.dumps(readers))
    if orig is not None:
        threaded._inflate_workers = orig
    for v, rows in res.items():
        walls = [w for w, _ in rows]
        med = statistics.median(walls)
        parts = {k: round(statistics.median([s.get(k, 0.0) for _, s in rows]), 3) for k in KEYS}
        say("variant", v, "job walls", [round(w, 3) for w in walls], "median", round(med, 3),
            "reads/s", round(cell["traffic"]["reads"] / med), "median stages", json.dumps(parts))
    if not args.reader:
        return

    path = inputs["main"][0]
    raw = gzip.decompress(open(path, "rb").read())
    one = work / "one.fastq.gz"
    co = zlib.compressobj(1, zlib.DEFLATED, 31)
    one.write_bytes(co.compress(raw) + co.flush())
    say("file", path, os.path.getsize(path), "one member", os.path.getsize(one), "out", len(raw))
    del raw

    def read(p):
        obs.reset_counters()
        t0 = time.perf_counter()
        n = sum(b["r1_codes"].shape[0] for b in threaded.ThreadedFastqReader(
            str(p), batch_size=1 << 17, max_len=112, num_threads=cores))
        wall = time.perf_counter() - t0
        tot = obs.counter_totals()
        return wall, n, {k: round(tot[k][0], 3) for k in ("pipeline.read", "pipeline.inflate", "pipeline.parse")
                         if k in tot}

    for rep in range(3):
        for label, p in (("one member", one), ("members", path)):
            wall, n, tot = read(p)
            say("reader", label, "wall", round(wall, 3), "reads", n, json.dumps(tot))
    for rep in range(2):
        t0 = time.perf_counter()
        a = np.empty(224 << 20, np.uint8)
        a.fill(1)
        t1 = time.perf_counter()
        a.fill(2)
        t2 = time.perf_counter()
        del a
        say("224 MiB first touch", round(t1 - t0, 4), "s, again", round(t2 - t1, 4), "s")


if __name__ == "__main__":
    main()
