"""Observability: the run log, named spans with their counters, and the
operator's profiler trace.

The reference's only observability is stdout prints with explicit flushes
for pipeline-runner visibility (reference: __main__.py:169,328; SURVEY §5.5).
nimble_tpu_torch keeps those prints and adds:

  * RunLog — a JSONL event log, enabled via NIMBLE_TPU_RUNLOG=<path> or
    explicitly by the caller. Every event carries `t` (seconds since the
    log opened) and `t_ns` (time.time_ns(), the clock of the profiler's
    trace). The pipeline's threads all write to it: each write takes a
    lock, so every line is one whole JSON record;
  * stage() — a timed stage of the run log (`stage_start`, which also
    carries `open_ns`, the clock once the stage's range is open, then
    `stage_end` with its `wall_s` and the fields its block adds, such as
    `bytes`), also a range of the profiler's trace;
  * span() — a named span. The names of COUNTERS are counters: each span
    adds its elapsed time and one to its name's per-align total, from any
    thread, and `write_counters` puts the totals in the run log at the end
    of an align. Under profile() every span is also a
    torch.profiler.record_function range on the thread that opened it;
    other names are such ranges only;
  * profile() — torch.profiler over a whole align, every thread
    (NIMBLE_TPU_PROFILE=<dir>), for TensorBoard-compatible host and device
    traces.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Optional

# counter name -> the thread that opens it (the pipeline names its threads
# so; "main" is the thread that called align)
COUNTERS = {
    "align": "main",
    "pipeline.first_batch": "main",
    "pipeline.starved": "main",
    "engine.submit": "main",
    "pipeline.backpressure": "main",
    "pipeline.read": "nimble-read",
    "pipeline.inflate": "nimble-inflate",
    "pipeline.parse": "nimble-parse",
    "pipeline.feed_wait": "nimble-feed",
    "pipeline.pack": "nimble-feed",
    "engine.collect": "nimble-emit",
    "engine.d2h": "nimble-emit",
    "engine.unpack": "nimble-emit",
    "pipeline.emit": "nimble-emit",
    "pipeline.resolve": "nimble-emit",
}

_PROFILING = False  # set by profile() alone: no range opens under another profiler
_THREADS = {}  # native thread id -> thread name, of the threads that opened a range
_LOCAL = threading.local()  # per thread: the stack of open (span, range) pairs
_clock = time.perf_counter_ns


def _open_range(s) -> None:
    import torch

    stack = getattr(_LOCAL, "ranges", None)
    if stack is None:
        stack = _LOCAL.ranges = []
        _THREADS[threading.get_native_id()] = threading.current_thread().name
    r = torch.profiler.record_function(s.name)
    r.__enter__()
    stack.append((s, r))


def _close_range(s, exc) -> None:
    stack = getattr(_LOCAL, "ranges", None)
    if stack and stack[-1][0] is s:  # a span opened before the profiler has no range
        stack.pop()[1].__exit__(*exc)


class _Range:
    """A profile range of `name`, opened only while profile() runs."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _PROFILING:
            _open_range(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if _PROFILING:
            _close_range(self, (exc_type, exc, tb))
        return False


class _Counter(_Range):
    """A counter: the clock at each enter and at each exit, appended to two
    lists (list.append is atomic, so any thread may open it, and spans that
    overlap on several threads still sum right: the time is the exits' sum
    less the enters')."""

    __slots__ = ("enters", "exits")

    def __init__(self, name: str):
        super().__init__(name)
        self.enters, self.exits = [], []

    def __enter__(self):
        if _PROFILING:
            _open_range(self)
        self.enters.append(_clock())
        return self

    def __exit__(self, exc_type, exc, tb):
        self.exits.append(_clock())
        if _PROFILING:
            _close_range(self, (exc_type, exc, tb))
        return False


class _Spans(dict):
    """name -> its span: a _Counter for each name of COUNTERS, a _Range
    made on first use for any other name."""

    def __missing__(self, name: str) -> _Range:
        return self.setdefault(name, _Range(name))


_SPANS = _Spans((name, _Counter(name)) for name in COUNTERS)

# `with span(name):` — a counter's time (names of COUNTERS) and, under
# profile(), a record_function range of `name` on the calling thread.
# Without a profiler a counter costs two clock reads and two list appends,
# any other name two flag tests; `span` is the table's own lookup, which
# costs no Python call. One align at a time: the counters are the
# process's.
span = _SPANS.__getitem__


def reset_counters() -> None:
    """Zero every counter: an align's totals start here."""
    for name in COUNTERS:
        c = _SPANS[name]
        c.enters.clear()
        c.exits.clear()


def counter_totals() -> dict:
    """{name: (seconds, spans closed)} of every counter; a span still open
    counts up to now."""
    now = _clock()
    out = {}
    for name in COUNTERS:
        c = _SPANS[name]
        exits, enters = list(c.exits), list(c.enters)
        ns = sum(exits) - sum(enters) + (len(enters) - len(exits)) * now
        out[name] = (ns / 1e9, len(exits))
    return out


def write_counters(log: "RunLog") -> None:
    """One `stage_end` record per counter, zeros included: its seconds,
    its spans and the thread that opens it."""
    for name, (wall, n) in counter_totals().items():
        log.event("stage_end", stage=name, wall_s=round(wall, 6), count=n, thread=COUNTERS[name])


class RunLog:
    """Append-only JSONL event log; writes from several threads each take
    the lock, so lines never interleave."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("NIMBLE_TPU_RUNLOG")
        self._f = open(self.path, "a") if self.path else None
        self._lock = threading.Lock()
        self.t0 = time.time()

    def event(self, kind: str, **fields: Any) -> None:
        self._write(time.time_ns(), kind, fields)

    def _write(self, now: int, kind: str, fields: dict) -> None:
        if self._f is None:
            return
        record = {"t": round(now / 1e9 - self.t0, 6), "t_ns": now, "event": kind}
        record.update(fields)
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._f is not None:
                self._f.write(line)
                self._f.flush()

    @contextlib.contextmanager
    def stage(self, name: str, **fields: Any):
        """A timed stage: `stage_start` with `fields`, then `stage_end`
        with its `wall_s` and whatever the block put into the dict it is
        given (a count known only at the end, such as `bytes`). The
        `stage_start` record's `t_ns` is the clock just before the stage's
        range opens and its `open_ns` the clock once it is open: opening a
        range can wait for the GIL (up to the interpreter's 5 ms switch
        interval behind each busy thread) or for a core, so the range
        starts between the two. The record is written once the range is
        open, so that the write's own wait is not between them."""
        end = {}
        t0 = time.time()
        now = time.time_ns()
        try:
            with span(name):
                self._write(now, "stage_start", {"stage": name, **fields, "open_ns": time.time_ns()})
                yield end
        finally:
            self.event("stage_end", stage=name, wall_s=round(time.time() - t0, 4), **end)

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None


_GLOBAL: Optional[RunLog] = None


def runlog() -> RunLog:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = RunLog()
    return _GLOBAL


def _all_threads_config():
    """torch.profiler's experimental config that records ranges on every
    thread, or None where this torch has no such option."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile(device=None, trace_dir: Optional[str] = None):
    """torch.profiler trace context; no-op (and no import of torch.profiler)
    unless a directory is configured. It traces the host on every thread,
    plus the card when `device` is a CUDA device, opens the spans' ranges
    while it runs, and writes the trace into the directory in TensorBoard's
    form (torch.profiler.tensorboard_trace_handler). The run log's
    `profile` event maps the trace's thread ids to the threads' names."""
    global _PROFILING
    trace_dir = trace_dir or os.environ.get("NIMBLE_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = _all_threads_config()
    try:
        with torch_profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir),
                           experimental_config=config):
            _PROFILING = True
            try:
                yield
            finally:
                _PROFILING = False
    finally:
        runlog().event("profile", dir=trace_dir, all_threads=config is not None,
                       threads={str(k): v for k, v in _THREADS.items()})
        print(f"Profiler trace written to {trace_dir}", file=sys.stderr)
