"""One benchmark run of a cell, as `python3 -m benchmark.run` makes it
(set-up, window, check), with the card's memory after every CLI call.

    python3 scripts/torch_bench_memory.py --workload hla20k-bulk-se \
        --seed N [--seconds 51]

Run it from the root of a checkout on a machine with a CUDA card. After
each call of the port's CLI entry (the index build of a checkout's first
run, the warm job, every job of the window) it prints the call, its wall,
`torch.cuda.memory_allocated()` and `torch.cuda.max_memory_allocated()`
since the process started. For each job it prints the run log's stage
walls (`index_build`, `engine_build`, `tables.host`, `tables.copy`,
`tables.place`, `engine.d2h`, ...) and byte counts (`tables.host`,
`tables.copy` and `tables.place` bytes, `align_done`'s `wire_bytes`), where the program writes them. The
peak after the window against the peak after the first job says whether
a job's tables outlive it. The last line is the run's result line.
"""
import argparse
import json
import os
import sys
import time

STAGES = ("index_build", "engine_build", "tables.host", "tables.copy", "tables.place", "engine.submit", "engine.d2h",
          "engine.collect", "pipeline.emit", "align")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()

    import torch

    sys.path.insert(0, os.getcwd())  # the checkout's benchmark/ and nimble_tpu_torch/
    from benchmark import run, spec
    from nimble_tpu_torch import __main__ as cli

    cell = spec.load_cell(args.workload)
    calls = []
    orig = cli.main

    def main_(argv):
        t0 = time.perf_counter()
        try:
            return orig(argv)
        finally:
            torch.cuda.synchronize()
            calls.append({"call": argv[0], "wall_s": round(time.perf_counter() - t0, 3),
                          "allocated": torch.cuda.memory_allocated(), "peak": torch.cuda.max_memory_allocated()})
            print("memory", json.dumps(calls[-1]), file=sys.stderr, flush=True)

    cli.main = main_
    counts = []
    job_record = run.job_record

    def job_record_(events):
        ends = {e["stage"]: e.get("bytes") for e in events if e.get("event") == "stage_end"}
        done = [e for e in events if e.get("event") == "align_done"]
        counts.append({"tables.host": ends.get("tables.host"), "tables.copy": ends.get("tables.copy"),
                       "tables.place": ends.get("tables.place"),
                       "wire_bytes": done[-1].get("wire_bytes") if done else None,
                       "engine": [(e["path"], e["chunk_size"], e["table_bytes"]) for e in events
                                  if e.get("event") == "engine"]})
        return job_record(events)

    run.job_record = job_record_
    cache = spec.HERE / ".cache"
    res = run.run_cell(cell, args.seed, args.seconds, False, "cuda", cache, run.host_cores()["cores"])
    for i, (j, c) in enumerate(zip(res["jobs"], counts[-len(res["jobs"]):])):
        print("job", i, json.dumps({k: round(j["stages"][k], 4) for k in STAGES if k in j["stages"]}),
              f"wall {j['wall_s']:.3f} s", "bytes", json.dumps(c), file=sys.stderr)
    aligns = [c for c in calls if c["call"] == "align"]
    first_job = aligns[1]["peak"] if len(aligns) > 1 else None  # aligns[0] is the warm job
    print("peaks", json.dumps({"after_warm_job": aligns[0]["peak"], "after_first_job": first_job,
                               "after_window": res["memory_peak_bytes"],
                               "window_over_first_job": res["memory_peak_bytes"] / first_job if first_job else None}),
          file=sys.stderr)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]}
    print(json.dumps(run.result_line(cell, res, False, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
