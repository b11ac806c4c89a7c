"""The `hla20k-bulk-se` cell: its nine per-layer readers on a canned run
record (the value, and None where there is nothing to read), its entries
in BENCHMARK.json, and the cell cut to 700 alleles on 1,200-base genes run
on the CPU, where it takes groupcls as the full library does on the card."""
from __future__ import annotations

import json

import pytest

from benchmark import run, spec

CELL = "hla20k-bulk-se"
B = json.loads((spec.bench_root() / "BENCHMARK.json").read_text())

STAGES = {"index_build": 3.0, "engine_build": 6.0, "tables.host": 4.5, "tables.copy": 0.75,
          "engine.submit": 1.25, "engine.d2h": 0.5, "engine.collect": 0.625}
JOB = {"reads": 1000, "failed": "", "align_s": 10.0, "rows": 12, "wall_s": 10.5, "stages": STAGES,
       "paths": ["groupcls"]}
BAD = dict(JOB, failed="boom", stages={k: 100.0 for k in STAGES})
REC = {"setup_s": 20.0, "window_s": 52.0, "jobs": [dict(JOB), dict(JOB, stages=dict(STAGES, **{
    "index_build": 1.0, "tables.host": 2.5, "tables.copy": 0.25, "engine.submit": 0.75, "engine.d2h": 1.5,
    "engine.collect": 1.375})), BAD],
       "trace": {"window_s": 50.0, "busy_s": 5.0, "kernel_s": {"kmer_keys": 0.002, "intersect_class_bits": 0.004},
                 "kernel_bytes": {"kmer_keys": 1e9}}}
WANT = {
    "index.load_s.hla20k": 2.0,
    "tables.host_s.hla20k": 3.5,
    "tables.copy_s.hla20k": 0.5,
    "engine.submit_s.hla20k": 1.0,
    "engine.d2h_s.hla20k": 1.0,
    "engine.collect_s.hla20k": 1.0,
    "engine.device_ns_per_read.hla20k": 5.0e9 / 2000,
    "device.idle_share.hla20k": 90.0,
    "kernels.intersect_class_bits_ns_per_read.hla20k": 0.004e9 / 2000,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert spec.metric_reader(name)(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_gives_none(name):
    """An untraced run of a parent without the table stages and the d2h
    counter; a traced run on a path without the kernel; every job failed."""
    bare = {"index_build": 3.0, "engine_build": 6.0}
    rec = {"setup_s": 1.0, "window_s": 1.0, "jobs": [dict(JOB, stages=bare), dict(BAD)], "trace": None}
    if name.startswith(("tables.", "engine.d2h", "engine.submit", "engine.collect")):
        assert spec.metric_reader(name)(rec) is None
    rec["trace"] = {"window_s": 1.0, "busy_s": 0.0, "kernel_s": {"kmer_keys": 0.1}, "kernel_bytes": {}}
    if not name.startswith(("index.", "tables.", "engine.submit", "engine.d2h", "engine.collect")):
        assert spec.metric_reader(name)(rec) is None
    if name != "device.idle_share.hla20k":  # a share of the window, whatever the jobs did
        assert spec.metric_reader(name)({"setup_s": 1.0, "window_s": 1.0, "jobs": [dict(BAD)],
                                         "trace": REC["trace"]}) is None


def test_entries():
    cfg = next(c for c in B["configs"] if c["name"] == "hla20k")
    assert cfg["file"] == "benchmark/configs/hla20k.json" and cfg["reduced"] == ["library"]
    cell = next(w for w in B["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hla20k", "bulk-se", 1)
    assert json.loads((spec.HERE / "cells" / f"{CELL}.json").read_text()) == {"engine_path": "groupcls"}
    rate = next(m for m in B["end_to_end"] if m["name"] == "align_reads_per_s")
    assert rate["workloads"][-1] == CELL
    mine = {m["name"]: m for m in B["per_layer"] if m["name"].endswith(".hla20k")}
    assert set(mine) == set(WANT)
    assert all(m["workloads"] == [CELL] and m["moves"] == "align_reads_per_s" for m in mine.values())
    lib = json.loads((spec.HERE / "configs" / "hla20k.json").read_text())["library"]
    assert [x["alleles"] for x in lib["loci"]] == [6200, 7400, 6400]


@pytest.fixture(scope="module")
def cut_cell():
    """The cell with its library cut to 700 alleles (31 : 37 : 32) on
    1,200-base genes, jobs of 2,000 reads, half from the library."""
    cell = spec.load_cell(CELL)
    lib = cell["config"]["library"]
    lib["length"] = 1200
    lib["loci"] = [dict(x, alleles=n) for x, n in zip(lib["loci"], (217, 259, 224))]
    cell["traffic"].update(reads=2000, warm_reads=300, on_library_share=0.5)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_cut_cell_runs_groupcls_on_the_cpu(cut_cell, tmp_path, trace):
    res = run.run_cell(cut_cell, 2**31 + 23, 0.2, trace, "cpu", tmp_path, 2)
    line = run.result_line(cut_cell, res, trace, {"platform": "cpu"})
    assert line["correct"] is True and line["checks"]["jobs_off_path"]["value"] == 0
    assert all(j["paths"] == ["groupcls"] for j in res["jobs"])
    if trace:
        # the run log's stages and counters; the CPU has no device trace
        got = {k for k in line["metrics"] if k.endswith(".hla20k")}
        assert got == {"index.load_s.hla20k", "tables.host_s.hla20k", "tables.copy_s.hla20k",
                       "engine.submit_s.hla20k", "engine.d2h_s.hla20k", "engine.collect_s.hla20k"}
        assert all(line["metrics"][k]["value"] > 0 for k in got)
    else:
        assert set(line["metrics"]) == {"align_reads_per_s", "setup_s"}
