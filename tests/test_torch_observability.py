"""The port's spans, counters, run log and NIMBLE_TPU_PROFILE trace
(nimble_tpu_torch/observability.py), on the CPU.

A counter sums its spans' time from any number of threads at once; the run
log stays whole JSON lines under concurrent writers. A CPU `align` writes
one `stage_end` total per counter at its end, beside its `index_build` and
`engine_build` stages, and the dispatch thread's spans cover its wall. No
range of the program opens without NIMBLE_TPU_PROFILE, even under another
profiler; with it, the trace holds the spans of the pipeline's threads and
the engine's stages, on the run log's clock, and the TSV is the golden's
either way. `trace_summary` reads such a trace. A span costs under 1 us
without a profiler. Inside `engine_build` the tables' host build and their
copy are stages of their own with their bytes; `align_done` carries the
bytes of the wire and the rows the emission resolved."""
import json
import os
import shutil
import statistics
import sys
import threading
import time

import pytest
import torch

from nimble_tpu_torch import observability as obs
from nimble_tpu_torch import trace_summary
from nimble_tpu_torch.__main__ import main as port_cli
from tests.test_torch_host_parity import GOLD, native_in_both

# the names the program gives its ranges: counters, stages, engine stages
ENGINE_RANGES = {"engine.h2d", "engine.step", "engine.keys", "engine.probe", "engine.score", "engine.select",
                 "engine.combine", "engine.pack", "engine.d2h", "engine.unpack"}
PROGRAM_NAMES = set(obs.COUNTERS) | ENGINE_RANGES | {"index_build", "engine_build"}
# the dispatch thread's spans and stages that make up an align
MAIN = ("index_build", "pipeline.first_batch", "engine_build", "pipeline.starved", "engine.submit",
        "pipeline.backpressure")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    native_in_both()
    root = tmp_path_factory.mktemp("torch_observability")
    for f in ("lib_base.json", "r1.fastq", "r2.fastq"):
        shutil.copy(GOLD / f, root / f)
    return root


def align(inputs, tmp_path, name, monkeypatch, profile_dir=None):
    """The port's CPU align of the goldens' pairs under -c 2 (the threaded
    reader), with a run log of its own -> (TSV bytes, the log's events)."""
    if profile_dir is None:
        monkeypatch.delenv("NIMBLE_TPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("NIMBLE_TPU_PROFILE", str(profile_dir))
    log = tmp_path / f"{name}.jsonl"
    out = tmp_path / f"{name}.tsv"
    monkeypatch.setattr(obs, "_GLOBAL", obs.RunLog(str(log)))
    try:
        rc = port_cli(["align", "--reference", str(inputs / "lib_base.json"), "--output", str(out), "--input",
                       str(inputs / "r1.fastq"), str(inputs / "r2.fastq"), "--device", "cpu", "-c", "2"])
    finally:
        obs._GLOBAL.close()
        monkeypatch.setattr(obs, "_GLOBAL", None)
    assert rc == 0
    return out.read_bytes(), [json.loads(ln) for ln in log.read_text().splitlines()]


def totals(events):
    return {e["stage"]: e for e in events if e["event"] == "stage_end" and e["stage"] in obs.COUNTERS}


def run_threads(n, work):
    """`work(i)` on n threads at once, the interpreter switching threads
    as often as it can; each join bounded."""
    start = threading.Barrier(n)
    threads = [threading.Thread(target=lambda i=i: (start.wait(), work(i))) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


THREADS = [4, 2 * (os.cpu_count() or 4)]  # four, and more threads than cores


@pytest.mark.parametrize("n", THREADS)
def test_span_sums_nested_and_from_many_threads(n):
    obs.reset_counters()
    with obs.span("align"):
        with obs.span("engine.submit"):
            time.sleep(0.02)
        with obs.span("engine.submit"):
            with obs.span("engine.keys"):  # a range only: no counter
                time.sleep(0.01)

    def work(i):
        for _ in range(500):
            with obs.span("pipeline.pack"):
                pass
        with obs.span("pipeline.parse"):
            time.sleep(0.05)

    run_threads(n, work)
    got = obs.counter_totals()
    assert got["align"][1] == 1 and got["engine.submit"][1] == 2
    assert got["engine.submit"][0] >= 0.03 and got["align"][0] >= got["engine.submit"][0]
    assert got["pipeline.pack"][1] == 500 * n and got["pipeline.parse"][1] == n
    assert 0.05 * n <= got["pipeline.parse"][0] < 0.05 * n + 2.0  # n threads' 0.05 s each, overlapping
    assert "engine.keys" not in got and got["pipeline.read"] == (0.0, 0)
    obs.reset_counters()
    assert all(v == (0.0, 0) for v in obs.counter_totals().values())


def test_an_open_span_counts_up_to_now():
    obs.reset_counters()
    with obs.span("align"):
        time.sleep(0.02)
        wall, n = obs.counter_totals()["align"]
        assert wall >= 0.02 and n == 0
    assert obs.counter_totals()["align"][1] == 1


@pytest.mark.parametrize("n", THREADS)
def test_runlog_from_many_threads_writes_whole_lines(tmp_path, n):
    log = obs.RunLog(str(tmp_path / "log.jsonl"))
    pad = "x" * 3000  # lines longer than a pipe's atomic write

    def work(i):
        for j in range(300):
            log.event("w", thread=i, j=j, pad=pad)

    run_threads(n, work)
    log.close()
    events = [json.loads(ln) for ln in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(events) == 300 * n and all(e["pad"] == pad for e in events)
    for i in range(n):
        assert [e["j"] for e in events if e["thread"] == i] == list(range(300))
    assert all(abs(e["t_ns"] / 1e9 - log.t0 - e["t"]) < 1e-3 for e in events)


def test_align_writes_every_counter_once(inputs, tmp_path, monkeypatch, capsys):
    tsv, events = align(inputs, tmp_path, "plain", monkeypatch)
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()
    got = totals(events)
    assert set(got) == set(obs.COUNTERS)
    assert [e["stage"] for e in events if e["event"] == "stage_end"].count("pipeline.pack") == 1
    assert all(got[n]["thread"] == obs.COUNTERS[n] and got[n]["wall_s"] >= 0 for n in got)
    for name in ("align", "engine.submit", "pipeline.pack", "pipeline.read", "pipeline.parse",
                 "engine.collect", "pipeline.emit", "pipeline.resolve", "pipeline.first_batch", "pipeline.starved"):
        assert got[name]["count"] >= 1, name
    stages = [e["stage"] for e in events if e["event"] == "stage_end"]
    assert stages.count("index_build") == 1 and stages.count("engine_build") == 1
    walls = {e["stage"]: e["wall_s"] for e in events if e["event"] == "stage_end"}
    assert sum(walls[s] for s in MAIN) >= 0.8 * walls["align"]
    done = [e for e in events if e["event"] == "align_done"]
    assert len(done) == 1 and done[0]["reads"] == 19 and 0 < done[0]["wall_s"] <= walls["align"] + 1e-3
    assert not any(e["event"] == "throughput" for e in events)


def check_table_stages_and_wire(events, reads: int, W: int) -> None:
    """One `tables.host` and one `tables.copy` stage_end inside the one
    `engine_build`, each with bytes; one `engine.d2h` and one
    `engine.unpack` counter total; `align_done`'s `wire_bytes` the full
    wire's flat size, (W + 3) words a read of every chunk."""
    kinds = [(e["event"], e.get("stage")) for e in events]
    start, end = kinds.index(("stage_start", "engine_build")), kinds.index(("stage_end", "engine_build"))
    for name in ("tables.host", "tables.copy"):
        ends = [i for i, k in enumerate(kinds) if k == ("stage_end", name)]
        assert len(ends) == 1 and start < ends[0] < end, name
        assert events[ends[0]]["bytes"] > 0, name
    for name in ("engine.d2h", "engine.unpack"):
        got = [e for e in events if e["event"] == "stage_end" and e["stage"] == name]
        assert len(got) == 1 and got[0]["thread"] == "nimble-emit" and got[0]["count"] >= 1, name
    chunk = next(e["chunk_size"] for e in events if e["event"] == "engine")
    done = next(e for e in events if e["event"] == "align_done")
    assert done["wire_bytes"] == -(-reads // chunk) * chunk * (W + 3) * 4


def test_align_stages_the_tables_and_counts_the_wire(inputs, tmp_path, monkeypatch, capsys):
    _, events = align(inputs, tmp_path, "wire", monkeypatch)
    assert [e["path"] for e in events if e["event"] == "engine"] == ["group"]
    _, data = json.loads((inputs / "lib_base.json").read_text())
    n_features = len(dict(zip(data["headers"], data["columns"]))["sequence_name"])
    check_table_stages_and_wire(events, 19, -(-n_features // 32))
    host, copy = ([e for e in events if e.get("stage") == s and e["event"] == "stage_end"][0]
                  for s in ("tables.host", "tables.copy"))
    assert host["bytes"] == copy["bytes"]  # the group path ships every array it builds


def test_align_counts_the_resolve_of_the_passing_rows(inputs, tmp_path, monkeypatch, capsys):
    """`pipeline.resolve`, the emission thread's resolve of a span's
    passing rows, is a counter of `nimble-emit` inside `pipeline.emit`;
    `align_done`'s `resolved_rows` counts the rows it was handed: at least
    the rows written, at most the reads."""
    assert obs.COUNTERS["pipeline.resolve"] == "nimble-emit"
    tsv, events = align(inputs, tmp_path, "resolve", monkeypatch)
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()
    got = totals(events)
    assert got["pipeline.resolve"]["count"] >= 1
    assert got["pipeline.resolve"]["wall_s"] <= got["pipeline.emit"]["wall_s"]
    done = next(e for e in events if e["event"] == "align_done")
    assert 0 < tsv.count(b"\n") - 1 <= done["resolved_rows"] <= done["reads"]


def test_no_profile_opens_no_range(inputs, tmp_path, monkeypatch, capsys):
    import torch.autograd.profiler
    import torch.profiler

    def refuse(*a, **kw):
        raise AssertionError("a range was opened without NIMBLE_TPU_PROFILE")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    tsv, events = align(inputs, tmp_path, "unset", monkeypatch)
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()
    assert not any(e["event"] == "profile" for e in events)


def test_another_profiler_sees_no_program_range(inputs, tmp_path, monkeypatch, capsys):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsv, _ = align(inputs, tmp_path, "foreign", monkeypatch)
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)  # the profiler did trace the align
    assert not names & PROGRAM_NAMES
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()


@pytest.fixture
def profiled(inputs, tmp_path, monkeypatch, capsys):
    trace_dir = tmp_path / "trace"
    tsv, events = align(inputs, tmp_path, "profiled", monkeypatch, profile_dir=trace_dir)
    assert f"Profiler trace written to {trace_dir}" in capsys.readouterr().err
    return tsv, events, trace_summary.load_trace(str(trace_dir))


def test_profile_traces_every_thread_on_the_run_logs_clock(profiled):
    tsv, events, trace = profiled
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()
    ranges = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    tids = {}
    for e in ranges:
        tids.setdefault(e["name"], set()).add(e["tid"])
    want = ("pipeline.pack", "pipeline.starved", "pipeline.emit", "index_build")
    assert all(n in tids for n in want)
    assert len(set().union(*(tids[n] for n in want))) >= 3
    assert {"engine.h2d", "engine.step", "engine.keys", "engine.probe", "engine.combine", "engine.pack",
            "engine.d2h", "engine.unpack", "engine_build", "pipeline.read"} <= set(tids)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    start = min(base_us + e["ts"] for e in ranges if e["name"] == "index_build")
    stamp = next(e["t_ns"] for e in events if e["event"] == "stage_start" and e["stage"] == "index_build")
    assert abs(start - stamp / 1e3) <= 5000
    prof = [e for e in events if e["event"] == "profile"]
    assert len(prof) == 1 and prof[0]["all_threads"] is True
    assert {"nimble-read", "nimble-feed", "nimble-emit"} <= set(prof[0]["threads"].values())


def test_trace_summary_names_the_threads(profiled):
    _, events, trace = profiled
    got = trace_summary.summarize(trace, events)
    threads = got["threads"]
    assert "pipeline.pack" in threads["nimble-feed"] and "pipeline.read" in threads["nimble-read"]
    assert {"pipeline.emit", "pipeline.resolve", "engine.collect"} <= set(threads["nimble-emit"])
    main = next(t for t in threads.values() if "align" in t)
    assert main["align"][1] == 1 and main["engine.submit"][1] >= 1
    assert {s["stage"] for s in got["stamps"]} >= {"index_build", "engine_build"}
    assert all(abs(s["us"]) <= 5000 for s in got["stamps"])
    assert got["device_s"] == {} and got["device_total_s"] == 0  # no card on the CPU


def test_trace_summary_puts_device_time_under_the_innermost_range():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "engine.step", "tid": 1, "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "engine.keys", "tid": 1, "ts": 110, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "engine.probe", "tid": 1, "ts": 140, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "engine.d2h", "tid": 2, "ts": 300, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 115, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "tid": 1, "ts": 145, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 170, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 2, "ts": 310, "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 400, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "k1", "tid": 7, "ts": 120, "dur": 3, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "kmer_keys", "tid": 7, "ts": 150, "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "tid": 7, "ts": 180, "dur": 7, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "tid": 7, "ts": 320, "dur": 11,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "k5", "tid": 7, "ts": 410, "dur": 13, "args": {"correlation": 5}},
    ]
    got = trace_summary.summarize({"traceEvents": ev, "baseTimeNanoseconds": 0})
    assert got["device_s"] == pytest.approx({"engine.keys": 3e-6, "engine.probe": 5e-6, "engine.step": 7e-6,
                                             "engine.d2h": 11e-6, "outside any range": 13e-6})
    assert got["device_total_s"] == pytest.approx(39e-6)
    assert got["threads"]["1"]["engine.step"] == [pytest.approx(1e-4), 1]


def test_profile_without_all_threads_still_traces(inputs, tmp_path, monkeypatch, capsys):
    """A torch without profile_all_threads: the trace still holds the
    dispatch thread's ranges, and the run log says the others are missing."""
    monkeypatch.setattr(obs, "_all_threads_config", lambda: None)
    tsv, events = align(inputs, tmp_path, "one_thread", monkeypatch, profile_dir=tmp_path / "trace")
    assert tsv == (GOLD / "golden_base.tsv").read_bytes()
    assert [e["all_threads"] for e in events if e["event"] == "profile"] == [False]
    names = {e.get("name") for e in trace_summary.load_trace(str(tmp_path / "trace"))["traceEvents"]}
    assert {"align", "index_build", "engine.submit"} <= names


def test_a_failed_align_still_writes_its_counters(inputs, tmp_path, monkeypatch, capsys):
    from nimble_tpu_torch.align import pipeline

    def boom(*a, **kw):
        raise RuntimeError("no card")

    monkeypatch.setattr(pipeline.LibraryRunner, "emit_out", boom)
    log = tmp_path / "failed.jsonl"
    monkeypatch.setattr(obs, "_GLOBAL", obs.RunLog(str(log)))
    try:
        rc = port_cli(["align", "--reference", str(inputs / "lib_base.json"), "--output",
                       str(tmp_path / "failed.tsv"), "--input", str(inputs / "r1.fastq"), "--device", "cpu"])
    finally:
        obs._GLOBAL.close()
        monkeypatch.setattr(obs, "_GLOBAL", None)
    assert rc == 1
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert any(e["event"] == "align_failed" for e in events)
    got = totals(events)
    assert set(got) == set(obs.COUNTERS) and got["align"]["count"] == 1 and got["engine.submit"]["count"] == 1


def test_span_costs_under_a_microsecond_without_a_profiler():
    """Median over many rounds of a round's spans less the same loop with
    nothing in it, per span."""
    span = obs.span
    n = 2000

    def one_round(name):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span(name):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t2 = time.perf_counter_ns()
        return ((t1 - t0) - (t2 - t1)) / n

    assert not obs._PROFILING and not torch.autograd._profiler_enabled()
    for name in ("pipeline.pack", "engine.keys", "engine.d2h", "engine.unpack"):
        cost = statistics.median(one_round(name) for _ in range(301))
        assert cost <= 1000, (name, cost)
    obs.reset_counters()
