"""Observability: structured run logs, stage timers, a throughput counter.

The reference's only observability is stdout prints with explicit flushes
for pipeline-runner visibility (reference: __main__.py:169,328; SURVEY §5.5).
nimble_tpu keeps those prints and adds:

  * RunLog — structured JSONL event log (stage start/end, reads/s counters,
    correction statistics), enabled via NIMBLE_TPU_RUNLOG=<path> or
    explicitly by the caller;
  * stage() — wall-clock stage timer context manager feeding the run log;
  * profile() — torch.profiler trace context (NIMBLE_TPU_PROFILE=<dir>), for
    TensorBoard-compatible host and device traces of the alignment hot loop;
  * Throughput — a running reads/s counter.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional


class RunLog:
    """Append-only JSONL event log. Thread-unsafe by design: the host
    pipeline is single-writer (SURVEY §5.2)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("NIMBLE_TPU_RUNLOG")
        self._f = open(self.path, "a") if self.path else None
        self.t0 = time.time()

    def event(self, kind: str, **fields: Any) -> None:
        if self._f is None:
            return
        record = {"t": round(time.time() - self.t0, 6), "event": kind}
        record.update(fields)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    @contextlib.contextmanager
    def stage(self, name: str, **fields: Any):
        self.event("stage_start", stage=name, **fields)
        t0 = time.time()
        try:
            yield self
        finally:
            self.event("stage_end", stage=name, wall_s=round(time.time() - t0, 4))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


_GLOBAL: Optional[RunLog] = None


def runlog() -> RunLog:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = RunLog()
    return _GLOBAL


@contextlib.contextmanager
def profile(device=None, trace_dir: Optional[str] = None):
    """torch.profiler trace context; no-op (and no import of torch.profiler)
    unless a directory is configured. It traces the host, plus the card when
    `device` is a CUDA device, and writes the trace into the directory in
    TensorBoard's form (torch.profiler.tensorboard_trace_handler)."""
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
    try:
        with torch_profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
            yield
    finally:
        print(f"Profiler trace written to {trace_dir}", file=sys.stderr)


class Throughput:
    """Running reads/s counter for progress reporting."""

    def __init__(self, log: Optional[RunLog] = None, report_every: int = 1_000_000):
        self.log = log
        self.report_every = report_every
        self.total = 0
        self._next = report_every
        self.t0 = time.time()
        self._last_t = self.t0
        self._last_total = 0

    def add(self, n: int) -> None:
        self.total += n
        if self.total >= self._next:
            now = time.time()
            dt = now - self.t0
            rate = self.total / dt if dt > 0 else 0.0
            # marginal rate since the last report separates steady state
            # from the JIT-compile-dominated first interval
            mdt = now - self._last_t
            marg = (self.total - self._last_total) / mdt if mdt > 0 else 0.0
            print(
                f"Processed {self.total} reads "
                f"({rate:,.0f} reads/s cumulative, {marg:,.0f} current)",
                flush=True,
            )
            if self.log:
                self.log.event(
                    "throughput",
                    reads=self.total,
                    reads_per_s=round(rate, 1),
                    current_reads_per_s=round(marg, 1),
                )
            self._last_t = now
            self._last_total = self.total
            self._next += self.report_every

    def final(self) -> Dict[str, float]:
        dt = time.time() - self.t0
        return {
            "reads": self.total,
            "wall_s": round(dt, 3),
            "reads_per_s": round(self.total / dt, 1) if dt > 0 else 0.0,
        }
