"""One run of one cell: `python3 -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`, from the root of a checkout, on a
machine that holds the cell's CUDA cards.

A run is one process, as a user's `align` is:

  1. set-up: the port imported, the card found, the kernel library built
     (first run of a checkout) or found; the configuration's library and
     the port's index in `benchmark/.cache/<config>/<probe>/`, built by the
     traffic's `index_argv` on the first run; the seed's sample made by
     the traffic's generator (`generators/`) and written by its writer
     (`writers/`), cached per seed; one warm job on its first
     `warm_reads` reads;
  2. the window: whole jobs back to back, each the traffic's `steps` in
     order, every step a call of the port's CLI entry
     (`nimble_tpu_torch.__main__.main`, in this process) with its argument
     template filled in (`-c` the cores this process may use, `--device
     cuda`) and its environment, until `--seconds` have passed; the job in
     flight finishes. Each job pays its index and table load, as every
     `align` does. With `--trace 1` the window runs under torch.profiler
     with spans around each layer (trace.py);
  3. the check: every job's TSV (and counts) against the plain reference
     (`reference/`), and the engine path each job took;
  4. one JSON line on stdout, the compared numbers beside their limits on
     stderr and under `checks` in that line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import check, gen, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nimble_tpu")


def say(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of sys.modules that the run must not hold, compared
    whole (nimble_tpu_torch is not nimble_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Runlog:
    """The port's run log (NIMBLE_TPU_RUNLOG, a JSONL file this process
    owns): the events each job appended."""

    def __init__(self, path: pathlib.Path):
        self.path, self.seen = path, 0

    def new_events(self) -> list:
        if not self.path.exists():
            return []
        with open(self.path, "rb") as f:
            f.seek(self.seen)
            data = f.read()
        self.seen += len(data)
        return [json.loads(ln) for ln in data.splitlines() if ln.strip()]


def job_record(events: list) -> dict:
    """The stages' walls and the engines' paths of one job's events."""
    stages = {}
    for e in events:
        if e.get("event") == "stage_end":
            stages[e["stage"]] = stages.get(e["stage"], 0.0) + e["wall_s"]
    return {"stages": stages, "paths": [e["path"] for e in events if e.get("event") == "engine"]}


def fill(argv: list, values: dict, inputs: list) -> list:
    """A step's argument template filled in: "{inputs}" stands for every
    input file, other words are formatted with `values`."""
    out = []
    for word in argv:
        out.extend(inputs if word == "{inputs}" else [word.format(**values)])
    return out


@contextlib.contextmanager
def environ(env: dict):
    """`env` set in os.environ for the block, the old values put back."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Cell:
    """One cell's files and inputs under a cache directory. The traffic
    names its generator (`generators/<generator>.py`), its input writer
    (`writers/<input>.py`), the port's index command (`index_argv`) and a
    job's CLI steps (`steps`: argument templates, environment, a name)."""

    def __init__(self, cell: dict, cache: pathlib.Path):
        self.spec, self.cfg, self.t = cell, cell["config"], cell["traffic"]
        self.here, self.root = cell["here"], cell["root"]
        self.probe = self.t["probe"]
        self.dir = cache / self.cfg["name"] / self.probe
        self.library = self.dir / f"{self.cfg['name']}.json"
        self.inputs_root = cache / "inputs" / f"{self.cfg['name']}-{cell['workload']}"
        self.counts = any("{counts}" in w for step in self.t["steps"] for w in step["argv"])

    def values(self, device: str, cores: int, **kw) -> dict:
        return {"library": str(self.library), "probe": self.probe, "device": device, "cores": cores, **kw}

    def ensure_library(self, cli_main, device: str) -> str:
        """The library JSON and the port's index (with its sidecars) in the
        cache: built on a checkout's first run, as a user builds once per
        library, by the traffic's `index_argv`."""
        ready = self.dir / "ready"
        lib = self.cfg["library"]
        lib_bytes = (self.root / lib["file"]).read_bytes().hex() if "file" in lib else ""
        stamp = json.dumps([lib, self.cfg.get("library_config"), lib_bytes, self.t["index_argv"], self.probe],
                           sort_keys=True)
        if ready.exists() and ready.read_text() == stamp:
            return "found"
        self.dir.mkdir(parents=True, exist_ok=True)
        gen.write_library(self.library, self.cfg, self.root)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(fill(self.t["index_argv"], self.values(device, 1), []))
        if rc:
            raise RuntimeError(f"the index command exited {rc}")
        ready.write_text(stamp)
        return "built"

    def reads(self, seed: int) -> dict:
        """The seed's reads in memory, as the traffic's generator makes
        them: r1 (n, L) int8, and for pairs r2 and the CB and UB tags as
        uint8 arrays (cb, umi). They stay arrays through the window: a list
        of a tuple a pair would be objects the program's garbage collector
        walks, which a user's process does not hold."""
        lib = gen.library_alleles(self.cfg["library"], self.root)
        out = spec.plugin("generators", self.t["generator"], self.here).make(
            gen.rng_of(seed), lib, self.t["reads"], self.t)
        out.setdefault("r2", None)
        return out

    def make_inputs(self, seed: int) -> dict:
        """`reads(seed)` and their files: {"main", "warm"} input paths
        (lists; warm holds the first `warm_reads`), written by the traffic's
        writer. Files are cached per seed; other seeds' inputs of this cell
        are removed first."""
        out = self.reads(seed)
        w = self.t["warm_reads"]
        d = self.inputs_root / str(seed)
        if self.inputs_root.exists():
            for other in self.inputs_root.iterdir():
                if other.name != str(seed):
                    shutil.rmtree(other, ignore_errors=True)
        d.mkdir(parents=True, exist_ok=True)
        ready = d / "ready"
        cached = ready.exists()
        if cached:
            files = json.loads(ready.read_text())
        else:
            writer = spec.plugin("writers", self.t["input"], self.here)
            arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
            files = {"main": writer.write(d / "main", arrays),
                     "warm": writer.write(d / "warm", {k: v[:w] for k, v in arrays.items()})}
            ready.write_text(json.dumps(files))
        return {**out, **files, "cached": cached}


def cpu_s() -> float:
    """The CPU seconds this process has used so far, all its threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_cores() -> dict:
    """The cores this process may use (its CPU affinity), with what
    os.cpu_count() says beside them."""
    return {"cores": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count()}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str, cache: pathlib.Path,
             cores: int, t_start: float = T_START) -> dict:
    """Set-up, window and check of one run; returns the result line's
    fields and the readings for the metrics."""
    import torch

    from nimble_tpu_torch import __main__ as cli
    from nimble_tpu_torch import observability
    from nimble_tpu_torch.native_build import build_native

    c = Cell(cell, cache)
    work = pathlib.Path(tempfile.mkdtemp(prefix="nimble_bench_"))
    runlog = Runlog(work / "runlog.jsonl")
    os.environ["NIMBLE_TPU_RUNLOG"] = str(runlog.path)
    observability._GLOBAL = observability.RunLog(str(runlog.path))  # this run's log, opened now
    parts = {"start-up": time.perf_counter() - t_start}
    try:
        t = time.perf_counter()
        ok, how = build_native()
        parts[f"native host library ({'ready' if ok else how})"] = time.perf_counter() - t
        t = time.perf_counter()
        if device == "cuda":
            from nimble_tpu_torch.align import kernels as K

            built = not os.path.exists(K.library_path())
            K.build()
            parts[f"kernel library ({'built' if built else 'found'})"] = time.perf_counter() - t
        t = time.perf_counter()
        how = c.ensure_library(cli.main, device)
        parts[f"library, index and sidecar ({how})"] = time.perf_counter() - t
        t = time.perf_counter()
        inputs = c.make_inputs(seed)
        parts[f"inputs ({'found' if inputs['cached'] else 'written'})"] = time.perf_counter() - t
        runlog.new_events()

        def job(i: int, files, trace_span=contextlib.nullcontext) -> dict:
            """The traffic's steps in order, each a call of the port's CLI
            entry with its arguments and environment; a step that exits
            nonzero or raises fails the job and ends it."""
            out = work / f"job{i}.tsv"
            rec = {"tsv": out, "reads": 0, "failed": ""}
            if c.counts:
                rec["counts"] = work / f"job{i}.counts.tsv"
            values = c.values(device, cores, tsv=out, counts=rec.get("counts", ""), work=work)
            c0 = cpu_s()
            t0 = time.perf_counter()
            try:
                with trace_span(), contextlib.redirect_stdout(io.StringIO()):
                    for step in c.t["steps"]:
                        t1 = time.perf_counter()
                        with environ(step.get("env", {})):
                            rc = cli.main(fill(step["argv"], values, files))
                            if device == "cuda":
                                torch.cuda.synchronize()
                        rec[f"{step['name']}_s"] = time.perf_counter() - t1
                        if rc:
                            rec["failed"] = f"{step['name']} exited {rc}"
                            break
            except Exception as e:  # a job that raises is counted failed; the run goes on
                rec["failed"] = f"{type(e).__name__}: {e}"
            rec["wall_s"] = time.perf_counter() - t0
            rec["cpu_s"] = cpu_s() - c0
            rec.update(job_record(runlog.new_events()))
            return rec

        t = time.perf_counter()
        warm = job(-1, inputs["warm"])
        parts["warm job"] = time.perf_counter() - t
        if warm["failed"]:
            raise RuntimeError(f"the warm job failed: {warm['failed']}")
        setup_s = time.perf_counter() - t_start
        say("set-up", f"{setup_s:.3f} s:", ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))

        if trace:
            from benchmark.kernel_bytes import Counter
            from benchmark.trace import JOB_SPAN, Profiler, Spans

            spans = Spans(spec.load_layers(cell["here"]), Counter())
            spans.install()
            profiler = Profiler()
            profiler.start()
            span = lambda: torch.profiler.record_function(JOB_SPAN)  # noqa: E731
        else:
            span = contextlib.nullcontext
        jobs = []
        t_w0 = time.perf_counter()
        while True:
            rec = job(len(jobs), inputs["main"], span)
            rec["reads"] = c.t["reads"]
            jobs.append(rec)
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        traced = None
        if trace:
            events = profiler.stop()
            spans.remove()
            from benchmark.trace import reduce_events

            t = time.perf_counter()
            traced = reduce_events(events, spans.kernels, spans.names)
            del events
            traced["kernel_bytes"] = spans.counter.total()
            traced["kernel_launches"] = spans.counter.launches
            say("trace", f"read in {time.perf_counter() - t:.3f} s:",
                json.dumps({k: v for k, v in traced.items() if k not in ("device_ops", "idle_gaps")}))
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        checks = check_jobs(c, jobs, inputs, device)
        for rec in jobs:
            rec["rows"] = sum(1 for _ in open(rec["tsv"])) - 1 if rec["tsv"].exists() else 0
            rec.pop("tsv"), rec.pop("counts", None)
        return {"setup_s": setup_s, "setup_parts": parts, "window_s": window_s, "jobs": jobs,
                "trace": traced, "memory_peak_bytes": peak, "checks": checks}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def reference_outputs(c: Cell, library: str, inputs: dict, device: str, key_mask: int = -1):
    """(the align TSV's text, the counts file's text or None) that the
    plain reference works out for a job on `inputs`; `key_mask` narrows
    its k-mer keys (the control)."""
    from benchmark.reference import align as ref
    from benchmark.reference import report as ref_report

    g = c.cfg["g"] if c.probe == "group" else 0
    t = [time.perf_counter()]
    ix = ref.Index(library, c.cfg["k"], g, device, key_mask=key_mask)
    t.append(time.perf_counter())
    tags = None
    if inputs.get("cb") is not None:
        tags = list(zip((x.tobytes().decode() for x in inputs["cb"]), (u.tobytes().decode() for u in inputs["umi"])))
    rows = ref.tsv_rows(ix, c.probe, inputs["r1"], inputs["r2"], tags,
                        block=65536 if device == "cuda" else 16384)
    t.append(time.perf_counter())
    counts = ref_report.counts(rows, c.t["report_threshold"]) if c.counts else None
    t.append(time.perf_counter())
    say(f"reference: index {t[1] - t[0]:.3f} s ({ix.n_classes} classes), rows {t[2] - t[1]:.3f} s, "
        f"counts {t[3] - t[2]:.3f} s")
    return check.TSV_HEADER + "".join(rows), counts


def check_jobs(c: Cell, jobs: list, inputs: dict, device: str) -> dict:
    """{name: (value, limit)}: each job's TSV (and counts) against the
    reference's, the jobs that took another engine path or failed."""
    t = time.perf_counter()
    expected, counts = reference_outputs(c, str(c.library), inputs, device)
    checks = {"tsv_rows_differing": sum(check.lines_differing(expected, check.read_text(j["tsv"])) for j in jobs)}
    if c.counts:
        checks["count_lines_differing"] = sum(
            check.lines_differing(counts, check.read_text(j["counts"])) if "counts" in j else len(counts.splitlines())
            for j in jobs)
    want = c.spec["cell"]["engine_path"]
    checks["jobs_off_path"] = sum(1 for j in jobs if not j["paths"] or any(p != want for p in j["paths"]))
    checks["jobs_failed"] = sum(1 for j in jobs if j["failed"])
    for j in jobs:
        if j["failed"]:
            say("job failed:", j["failed"])
        elif not j["paths"] or any(p != want for p in j["paths"]):
            say(f"job took the {j['paths']} paths, not {want!r}")
    say(f"reference: {expected.count(chr(10)) - 1} rows a job, checked in {time.perf_counter() - t:.3f} s")
    return {name: (value, 0) for name, value in checks.items()}


def result_line(cell: dict, res: dict, trace: bool, device_info: dict) -> dict:
    """The last line's object: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and, last, the compared numbers."""
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = spec.metric_reader(m["name"], cell["here"])(res)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=res["memory_peak_bytes"])
    line = {"correct": all(v <= lim for v, lim in res["checks"].values()),
            "attempted": len(res["jobs"]), "failed": sum(1 for j in res["jobs"] if j["failed"]),
            "metrics": metrics, "device": device}
    if trace and res["trace"].get("window_s"):
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = {"device_ops": res["trace"]["device_ops"], "idle_gaps": res["trace"]["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res["checks"].items()}
    return line


def disk_written() -> str:
    try:
        with open("/proc/self/io") as f:
            io_ = dict(ln.split(": ") for ln in f.read().splitlines())
        own = f"{io_['wchar']} bytes written ({io_['write_bytes']} reached the disk)"
    except (OSError, KeyError):
        own = "unknown bytes written"
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_oublock * 512
    return f"this process: {own}; its children: {kids} bytes to disk"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        say(f"needs {cell['chips']} CUDA card(s), found {n}: no result")
        return 2
    torch.cuda.init()
    cache = spec.HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    say("card", card_info(), f"(roofline shares against {3.35:.2f} TB/s)")
    cores = host_cores()
    say("host", json.dumps(cores), f"torch threads {torch.get_num_threads()}")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", cache, cores["cores"])
    bad = forbidden_modules()
    if bad:
        say(f"sys.modules holds {bad} after the window: no result")
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]}
    line = result_line(cell, res, bool(args.trace), info)
    say(f"{len(res['jobs'])} jobs in {res['window_s']:.3f} s:",
        json.dumps([{k: v for k, v in j.items() if k != "paths"} for j in res["jobs"]]))
    say(disk_written())
    for name, c in line["checks"].items():
        say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
