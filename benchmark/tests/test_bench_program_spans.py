"""The per-layer metrics that read the program's own counters: each the
mean over a run's jobs that did not fail of one `stage_end` total that
`nimble_tpu_torch.observability.write_counters` puts in the run log at the
end of an align, None where no job holds it. On the CPU, a traced run of
each cell reports every one of its cell's metrics, read from what the
program wrote, and the dispatch thread's spans cover its align."""
from __future__ import annotations

import json

import pytest

from bench_helpers import tiny_cell
from benchmark import run, spec

B = json.loads((spec.bench_root() / "BENCHMARK.json").read_text())
# metric -> the counter it reads
COUNTER = {
    "pipeline.first_batch_s": "pipeline.first_batch",
    "pipeline.read_s": "pipeline.read",
    "pipeline.pack_s": "pipeline.pack",
    "pipeline.starved_s": "pipeline.starved",
    "engine.submit_s": "engine.submit",
    "pipeline.backpressure_s": "pipeline.backpressure",
    "engine.collect_s": "engine.collect",
    "pipeline.emit_s": "pipeline.emit",
    "pipeline.read_s.tenx": "pipeline.read",
    "pipeline.starved_s.tenx": "pipeline.starved",
    "engine.submit_s.tenx": "engine.submit",
    "pipeline.backpressure_s.tenx": "pipeline.backpressure",
}
# the dispatch thread's spans and stages that make up an align
MAIN = ("index_build", "pipeline.first_batch", "engine_build", "pipeline.starved", "engine.submit",
        "pipeline.backpressure")


def job(stages, failed=""):
    return {"reads": 100, "failed": failed, "align_s": 1.0, "stages": stages, "paths": ["group"]}


@pytest.mark.parametrize("name", sorted(COUNTER))
def test_reader_means_the_jobs_that_did_not_fail(name):
    c = COUNTER[name]
    rec = {"jobs": [job({c: 0.25, "index_build": 9.0}), job({c: 0.75}), job({c: 100.0}, failed="boom")]}
    assert spec.metric_reader(name)(rec) == pytest.approx(0.5)


@pytest.mark.parametrize("name", sorted(COUNTER))
def test_reader_without_the_counter_gives_none(name):
    rec = {"jobs": [job({"index_build": 0.1, "engine_build": 0.2}), job({COUNTER[name]: 1.0}, failed="boom")]}
    assert spec.metric_reader(name)(rec) is None


def test_entries_name_a_counter_of_the_program():
    from nimble_tpu_torch.observability import COUNTERS

    entries = {m["name"]: m for m in B["per_layer"] if m["name"] in COUNTER}
    assert set(entries) == set(COUNTER)
    for name, m in entries.items():
        assert COUNTER[name] in COUNTERS
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "s", "lower")
        assert m["workloads"] == (["hla100-10x-pairs"] if name.endswith(".tenx") else ["hla100-bulk-se"])


@pytest.mark.parametrize("workload", ["hla100-bulk-se", "hla100-10x-pairs"])
def test_traced_run_reports_every_counter_metric(tmp_path, workload):
    cell = tiny_cell(workload, reads=1500)
    res = run.run_cell(cell, 2 ** 31 + 17, 0.2, True, "cpu", tmp_path, 2)
    line = run.result_line(cell, res, True, {"platform": "cpu"})
    assert line["correct"] is True
    mine = [m["name"] for m in cell["per_layer"] if m["name"] in COUNTER]
    assert mine and all(line["metrics"][name]["value"] >= 0 for name in mine)
    for j in res["jobs"]:
        assert j["stages"]["pipeline.read"] > 0 and j["stages"]["engine.submit"] > 0
        assert sum(j["stages"][s] for s in MAIN) >= 0.8 * j["stages"]["align"]
