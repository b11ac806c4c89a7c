"""The traced run: spans around the calls into each layer, the profiler
over the measured window, and the reduction of its trace to what the
per-layer metrics read.

Spans are `torch.profiler.record_function` ranges installed by attribute
on the port's module references, as `layers/*.json` lists them; nothing
inside the program changes. A kernel wrapper's span also counts the bytes
of its launch (kernel_bytes.Counter).

The reduction keeps, of the card's records (kernels, copies, sets), those
the program launched: work launched inside a `bench.count` range (the byte
counters, after each counted launch) is left out.
"""
from __future__ import annotations

import bisect
import heapq
import importlib

import torch

from benchmark.kernel_bytes import Counter

COUNT_SPAN = "bench.count"
JOB_SPAN = "bench.job"


def _resolve(wrap: dict):
    """(object that holds the attribute, attribute name) of a wrap point
    `module` + `attr` ("name" or "Class.name")."""
    owner = importlib.import_module(wrap["module"])
    *path, name = wrap["attr"].split(".")
    for part in path:
        owner = getattr(owner, part)
    if not hasattr(owner, name):
        raise AttributeError(f"{wrap['module']} has no {wrap['attr']}")
    return owner, name


class Spans:
    """Installs and removes the layers' wrappers."""

    def __init__(self, layers: dict, counter: Counter):
        self.layers, self.counter, self._undo = layers, counter, []
        self.kernels = {}  # kernel wrapper name -> kernel function name in the trace
        self.names = {JOB_SPAN}

    def _wrapper(self, orig, span: str, count: str):
        counter = self.counter

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(span):
                result = orig(*args, **kwargs)
                if count:
                    counter.add(count, args)
                return result

        wrapped.__wrapped__ = orig
        return wrapped

    def install(self) -> None:
        for wraps in self.layers.values():
            for w in wraps:
                owner, name = _resolve(w)
                orig = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
                setattr(owner, name, self._wrapper(orig, w["span"], w.get("bytes", "")))
                self._undo.append((owner, name, orig))
                self.names.add(w["span"])
                if "kernel" in w:
                    self.kernels[w["attr"]] = w["kernel"]

    def remove(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


def _merge(intervals):
    """Sorted, merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def reduce_events(events, kernels: dict, span_names) -> dict:
    """The traced window's numbers from the profiler's events (objects with
    name(), device_type(), start_ns(), duration_ns(), start_thread_id(),
    correlation_id()): the window (first job's start to last job's end),
    the card's busy seconds, its operations by time, each hand kernel's
    seconds and records, and the idle time by the innermost span the host
    was in."""
    device, spans, runtime, counting = [], [], [], {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        if _is_device(e):
            # the card's copy of a host range is no work of the card
            if name not in span_names and name != COUNT_SPAN:
                device.append((s, s + d, name, e.correlation_id()))
            continue
        if name == COUNT_SPAN:
            counting.setdefault(e.start_thread_id(), []).append((s, s + d))
        elif name.startswith("cu"):
            runtime.append((s, e.start_thread_id(), e.correlation_id()))
        elif name in span_names:
            spans.append((s, s + d, name))
    excluded = set()
    for tid in counting:
        counting[tid].sort()
    for s, tid, corr in runtime:
        ranges = counting.get(tid)
        if ranges:
            i = bisect.bisect_right(ranges, (s, float("inf"))) - 1
            if i >= 0 and ranges[i][0] <= s <= ranges[i][1]:
                excluded.add(corr)
    kept = [x for x in device if x[3] not in excluded]
    jobs = [(s, e) for s, e, n in spans if n == JOB_SPAN]
    if not jobs:
        return {}
    w0, w1 = min(s for s, _ in jobs), max(e for _, e in jobs)
    ours = [(max(s, w0), min(e, w1), n) for s, e, n, _ in kept if e > w0 and s < w1]
    busy = _merge((s, e) for s, e, _ in ours)
    by_op, kernel_s, kernel_n = {}, {}, {}
    for s, e, n in ours:
        by_op[n] = by_op.get(n, 0) + (e - s)
        for wrapper, fn in kernels.items():
            if fn in n:
                kernel_s[wrapper] = kernel_s.get(wrapper, 0) + (e - s) / 1e9
                kernel_n[wrapper] = kernel_n.get(wrapper, 0) + 1
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    # each stretch of a gap goes to the innermost span the host was in
    # then: the latest-started span still open
    idle = {}
    order = sorted(spans)
    points = sorted({p for s, e, _ in spans for p in (s, e)})
    heap, i = [], 0
    for a, b in gaps:
        cuts = [a] + points[bisect.bisect_right(points, a):bisect.bisect_left(points, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            while i < len(order) and order[i][0] <= x:
                heapq.heappush(heap, (-order[i][0], order[i][1], order[i][2]))
                i += 1
            while heap and heap[0][1] <= x:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "outside any span"
            idle[name] = idle.get(name, 0) + (y - x)
    top = lambda d: [[k[:160], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_records": len(ours),
        "excluded_records": len(device) - len(kept),
        "device_ops": top(by_op),
        "idle_gaps": top(idle),
        "kernel_s": kernel_s,
        "kernel_records": kernel_n,
    }


class Profiler:
    """torch.profiler over the measured window, on the host and the card."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self):
        """Stop tracing; return the trace's events."""
        self._prof.stop()
        return self._prof.profiler.kineto_results.events()
