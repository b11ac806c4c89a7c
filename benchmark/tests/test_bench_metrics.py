"""Each metric's reader on a canned run record."""
from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.kernel_bytes import bound_s

JOB = {"reads": 1000, "failed": "", "align_s": 2.0, "report_s": 4.0, "rows": 600, "wall_s": 6.0,
       "stages": {"index_build": 0.25, "engine_build": 0.75}, "paths": ["group"]}
REC = {"setup_s": 12.5, "window_s": 10.0, "jobs": [dict(JOB), dict(JOB), dict(JOB, failed="boom")],
       "trace": {"window_s": 9.5, "busy_s": 0.95, "kernel_s": {"kmer_keys": 0.002, "band_tree_expand": 0.001},
                 "kernel_bytes": {"kmer_keys": 3.35e9, "band_tree_expand": 1.675e9}}}
WANT = {
    "align_reads_per_s": 200.0,
    "tenx_pairs_per_s": 200.0,
    "setup_s": 12.5,
    "index.load_s": 0.25,
    "tables.build_s": 0.75,
    "pipeline.stream_reads_per_s": 2000 / 2.0,
    "pipeline.pairs_per_s.tenx": 2000 / 4.0,
    "report.rows_per_s": 1200 / 8.0,
    "engine.device_ns_per_read": 0.95e9 / 2000,
    "kernels.roofline_share": 100.0 * (bound_s(3.35e9) + bound_s(1.675e9)) / 0.003,
    "device.idle_share": 90.0,
    "device.idle_share.tenx": 90.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert spec.metric_reader(name)(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["engine.device_ns_per_read", "kernels.roofline_share", "device.idle_share",
                                  "device.idle_share.tenx", "report.rows_per_s"])
def test_nothing_to_read_gives_none(name):
    rec = {"setup_s": 1.0, "window_s": 1.0, "jobs": [dict(JOB, report_s=0.0, rows=0)],
           "trace": {"window_s": 1.0, "busy_s": 0.0, "kernel_s": {}, "kernel_bytes": {}}}
    rec["jobs"][0].pop("report_s")
    assert spec.metric_reader(name)(rec) is None


def test_every_metric_of_benchmark_json_is_canned():
    import json

    b = json.loads((spec.bench_root() / "BENCHMARK.json").read_text())
    assert {m["name"] for m in b["end_to_end"] + b["per_layer"]} == set(WANT)


def test_trace_reduction():
    """Busy time is the union of the program's device records; work in a
    bench.count range is left out; idle time goes to the innermost span."""
    from benchmark.trace import reduce_events

    class E:
        def __init__(self, name, s, d, dev=False, tid=1, corr=0):
            self._n, self._s, self._d, self._dev, self._t, self._c = name, s, d, dev, tid, corr

        def name(self): return self._n
        def start_ns(self): return self._s
        def duration_ns(self): return self._d
        def device_type(self): return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"
        def start_thread_id(self): return self._t
        def correlation_id(self): return self._c

    ev = [E("bench.job", 0, 1000), E("index.load", 0, 300), E("engine.dispatch", 400, 300),
          E("kmer_keys_kernel(int)", 450, 100, dev=True, corr=1), E("Memcpy HtoD", 500, 100, dev=True, corr=2),
          E("bench.count", 600, 50), E("cudaLaunchKernel", 610, 5, corr=3),
          E("sort_kernel", 700, 200, dev=True, corr=3)]
    got = reduce_events(ev, {"kmer_keys": "kmer_keys_kernel"}, {"bench.job", "index.load", "engine.dispatch"})
    assert got["window_s"] == pytest.approx(1e-6)
    assert got["busy_s"] == pytest.approx(150e-9)
    assert got["kernel_s"] == {"kmer_keys": pytest.approx(100e-9)}
    assert got["excluded_records"] == 1
    idle = dict(got["idle_gaps"])
    assert idle == {"index.load": pytest.approx(300e-9), "bench.job": pytest.approx(400e-9),
                    "engine.dispatch": pytest.approx(150e-9)}
