"""`pipeline.resolve_s`: the mean over a run's jobs that did not fail of
the program's `pipeline.resolve` counter (the emission thread's resolve of
the passing rows), None where no job holds it, as in a program that has
no such counter; its entry in BENCHMARK.json; and a traced run of the
`hla20k-bulk-se` cell, cut to 700 alleles on the CPU, that reports it."""
from __future__ import annotations

import json

import pytest

from benchmark import run, spec

CELL = "hla20k-bulk-se"
NAME = "pipeline.resolve_s"
B = json.loads((spec.bench_root() / "BENCHMARK.json").read_text())


def job(stages, failed=""):
    return {"reads": 1000, "failed": failed, "align_s": 10.0, "stages": stages, "paths": ["groupcls"]}


def test_reader_means_the_jobs_that_did_not_fail():
    rec = {"jobs": [job({"pipeline.resolve": 0.03, "pipeline.emit": 0.5}), job({"pipeline.resolve": 0.05}),
                    job({"pipeline.resolve": 9.0}, failed="boom")]}
    assert spec.metric_reader(NAME)(rec) == pytest.approx(0.04)


@pytest.mark.parametrize("jobs", [
    [job({"index_build": 3.0, "engine_build": 6.0, "pipeline.emit": 7.5})],  # a program without the counter
    [job({"pipeline.resolve": 1.0}, failed="boom")],
    [],
], ids=["no-counter", "all-failed", "no-jobs"])
def test_nothing_to_read_gives_none(jobs):
    assert spec.metric_reader(NAME)({"jobs": jobs}) is None


def test_entry():
    m = B["per_layer"][-1]
    assert m == {"name": NAME, "unit": "s", "better": "lower", "source": "program_span", "layer": "pipeline",
                 "moves": "align_reads_per_s", "workloads": [CELL]}


def test_traced_cut_cell_reports_it(tmp_path):
    """The cell with its library cut to 700 alleles (31 : 37 : 32) on
    1,200-base genes, jobs of 2,000 reads, half from the library."""
    cell = spec.load_cell(CELL)
    lib = cell["config"]["library"]
    lib["length"] = 1200
    lib["loci"] = [dict(x, alleles=n) for x, n in zip(lib["loci"], (217, 259, 224))]
    cell["traffic"].update(reads=2000, warm_reads=300, on_library_share=0.5)
    res = run.run_cell(cell, 2**31 + 29, 0.2, True, "cpu", tmp_path, 2)
    line = run.result_line(cell, res, True, {"platform": "cpu"})
    assert line["correct"] is True
    jobs = [j for j in res["jobs"] if not j["failed"]]
    assert jobs and all(0 < j["stages"]["pipeline.resolve"] <= j["stages"]["pipeline.emit"] for j in jobs)
    assert line["metrics"][NAME]["value"] > 0
