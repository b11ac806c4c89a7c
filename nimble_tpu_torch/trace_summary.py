"""What an `align` under NIMBLE_TPU_PROFILE spent, read from its trace.

    python3 -m nimble_tpu_torch.trace_summary TRACE [--runlog RUNLOG]

TRACE is the `*.pt.trace.json` that observability.profile wrote (or its
directory, which must hold one). Prints one JSON object:

  * `threads`: per thread, {range name: [host seconds, ranges]} of the
    program's ranges (the trace's `user_annotation` records). A thread is
    named by the run log's `profile` event, which maps the trace's thread
    ids to the threads' names, else by its id;
  * `device_s`: the card's seconds (kernels, copies, sets) by the innermost
    range the launching thread was in at the launch, "outside any range"
    for the rest; `device_total_s` their sum. The engine's stage ranges
    (`engine.keys`, `engine.probe`, ...) so give each stage's device-only
    time;
  * `stamps`: for each `stage_start` of the run log, the stage, `us`: the
    microseconds from its stamps to the start of the nearest range of that
    name (the run log's clock is the trace's), 0 where the range starts
    between `t_ns` and `open_ns` (the clock before and after the range
    opened), negative before `t_ns`, positive after `open_ns`; and
    `open_us`: the time the range took to open.
"""
from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(path: str) -> dict:
    if os.path.isdir(path):
        found = glob.glob(os.path.join(path, "*.pt.trace.json"))
        if len(found) != 1:
            raise ValueError(f"{path} holds {len(found)} traces, not one")
        path = found[0]
    with open(path) as f:
        return json.load(f)


def _innermost(ranges, t):
    """The name of the latest-starting range of `ranges` ((start, end,
    name), by start, the outer first where two start together) that holds
    time t, or None. The program's ranges nest on a thread, so that range
    is the innermost."""
    i = bisect.bisect_right(ranges, t, key=lambda r: r[0]) - 1
    while i >= 0:
        s, e, name = ranges[i]
        if e >= t:
            return name
        i -= 1
    return None


def summarize(trace: dict, events=()) -> dict:
    """The summary of `trace` (a loaded trace) beside `events` (the run
    log's records)."""
    names = {}
    for e in events:
        if e.get("event") == "profile":
            names.update({int(k): v for k, v in e.get("threads", {}).items()})
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges, launches, device = {}, {}, []
    for e in trace.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation":
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat in DEVICE_CATS:
            device.append((e.get("args", {}).get("correlation"), e.get("dur", 0)))
    threads = {}
    for tid, rs in ranges.items():
        rs.sort(key=lambda r: (r[0], -r[1]))
        table = threads.setdefault(names.get(tid, str(tid)), {})
        for s, e, name in rs:
            host = table.setdefault(name, [0.0, 0])
            host[0] += (e - s) / 1e6
            host[1] += 1
    device_s = {}
    for corr, dur in device:
        tid, ts = launches.get(corr, (None, None))
        name = _innermost(ranges[tid], ts) if tid in ranges else None
        key = name or "outside any range"
        device_s[key] = device_s.get(key, 0.0) + dur / 1e6
    starts = {}
    for rs in ranges.values():
        for s, _, name in rs:
            starts.setdefault(name, []).append(base_us + s)
    stamps = []
    for e in events:
        if e.get("event") == "stage_start" and "t_ns" in e and e["stage"] in starts:
            t, t_open = e["t_ns"] / 1e3, e.get("open_ns", e["t_ns"]) / 1e3
            off = (min(s - t, 0) + max(s - t_open, 0) for s in starts[e["stage"]])
            stamps.append({"stage": e["stage"], "us": min(off, key=abs), "open_us": t_open - t})
    return {"threads": threads, "device_s": dict(sorted(device_s.items(), key=lambda kv: -kv[1])),
            "device_total_s": sum(device_s.values()), "stamps": stamps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nimble_tpu_torch.trace_summary", description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="the trace file, or the NIMBLE_TPU_PROFILE directory holding it")
    ap.add_argument("--runlog", help="the align's run log (NIMBLE_TPU_RUNLOG)")
    args = ap.parse_args(argv)
    events = []
    if args.runlog:
        with open(args.runlog) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
    json.dump(summarize(load_trace(args.trace), events), sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
