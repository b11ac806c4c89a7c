"""The `hla20k-kmer-bulk-se` cell: its eight per-layer readers on a canned
run record (the value, and None where there is nothing to read), its
entries in BENCHMARK.json, its cell resolved to the per-k-mer probe on
`hla20k`'s own library draw, and the cell cut to 700 alleles on 1,200-base
genes run on the CPU, where it takes monocls as the full library does on
the card."""
from __future__ import annotations

import json

import pytest

from benchmark import gen, run, spec
from benchmark.kernel_bytes import bound_s

CELL = "hla20k-kmer-bulk-se"
B = json.loads((spec.bench_root() / "BENCHMARK.json").read_text())

STAGES = {"index_build": 3.0, "engine_build": 2.0, "tables.host": 1.5, "tables.monocls": 1.25,
          "tables.copy": 0.25, "engine.submit": 1.25}
JOB = {"reads": 1000, "failed": "", "align_s": 10.0, "rows": 12, "wall_s": 10.5, "stages": STAGES,
       "paths": ["monocls"]}
BAD = dict(JOB, failed="boom", stages={k: 100.0 for k in STAGES})
REC = {"setup_s": 20.0, "window_s": 52.0, "jobs": [dict(JOB), dict(JOB, stages=dict(STAGES, **{
    "index_build": 1.0, "tables.host": 0.5, "tables.monocls": 0.25, "engine.submit": 0.75})), BAD],
       "trace": {"window_s": 50.0, "busy_s": 5.0, "kernel_s": {"kmer_keys": 0.002, "intersect_class_bits": 0.004},
                 "kernel_bytes": {"kmer_keys": 3.35e9}}}
WANT = {
    "tables.monocls_s.kmer": 0.75,
    "index.load_s.kmer": 2.0,
    "tables.host_s.kmer": 1.0,
    "engine.submit_s.kmer": 1.0,
    "engine.device_ns_per_read.kmer": 5.0e9 / 2000,
    "device.idle_share.kmer": 90.0,
    "kernels.intersect_class_bits_ns_per_read.kmer": 0.004e9 / 2000,
    "kernels.roofline_share.kmer": 100.0 * bound_s(3.35e9) / 0.002,
}
PROGRAM = ("index.", "tables.", "engine.submit")  # read from the run log, not the trace


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert spec.metric_reader(name)(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_gives_none(name):
    """An untraced run of a parent without the `tables.monocls` stage; a
    traced run on a path without the kernels; every job failed."""
    bare = {"index_build": 3.0, "engine_build": 6.0}
    rec = {"setup_s": 1.0, "window_s": 1.0, "jobs": [dict(JOB, stages=bare), dict(BAD)], "trace": None}
    if name != "index.load_s.kmer":
        assert spec.metric_reader(name)(rec) is None
    for trace in ({"window_s": 1.0, "busy_s": 0.0, "kernel_s": {}, "kernel_bytes": {}}, {}):
        rec["trace"] = trace  # no kernel of the cell; a traced window that held no job
        if not name.startswith(PROGRAM):
            assert spec.metric_reader(name)(rec) is None
    if name not in ("device.idle_share.kmer", "kernels.roofline_share.kmer"):  # whatever the jobs did
        assert spec.metric_reader(name)({"setup_s": 1.0, "window_s": 1.0, "jobs": [dict(BAD)],
                                         "trace": REC["trace"]}) is None


def test_entries():
    cfg = next(c for c in B["configs"] if c["name"] == "hla20k-kmer")
    assert cfg["file"] == "benchmark/configs/hla20k-kmer.json" and cfg["reduced"] == ["library"]
    assert cfg["source"] == "https://github.com/BimberLab/nimble-aligner"  # the contract's own
    assert cfg["source"] != next(c for c in B["configs"] if c["name"] == "hla20k")["source"]
    cell = next(w for w in B["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hla20k-kmer", "bulk-se-kmer", 1)
    assert json.loads((spec.HERE / "cells" / f"{CELL}.json").read_text()) == {"engine_path": "monocls"}
    rate = next(m for m in B["end_to_end"] if m["name"] == "align_reads_per_s")
    assert rate["workloads"][-1] == CELL
    mine = {m["name"]: m for m in B["per_layer"] if m["name"].endswith(".kmer")}
    assert set(mine) == set(WANT) and [m["name"] for m in B["per_layer"][-len(WANT):]] == list(WANT)
    assert all(m["workloads"] == [CELL] and m["moves"] == "align_reads_per_s" for m in mine.values())


def test_cell_is_hla20k_under_the_per_k_mer_probe():
    """The configuration keeps hla20k's library, Config, k and g, so both
    cells draw one library; the traffic is bulk-se's but for its probe."""
    kmer, group = spec.load_cell(CELL), spec.load_cell("hla20k-bulk-se")
    assert kmer["traffic"]["probe"] == "mono" and group["traffic"]["probe"] == "group"
    assert {k: v for k, v in kmer["traffic"].items() if k not in ("probe", "about")} == \
        {k: v for k, v in group["traffic"].items() if k not in ("probe", "about")}
    for key in ("library", "library_config", "k", "g", "reduced"):
        assert kmer["config"][key] == group["config"][key], key
    assert kmer["config"]["source"] == next(c for c in B["configs"] if c["name"] == "hla20k-kmer")["source"]
    assert "--probe" in kmer["traffic"]["index_argv"] and "{probe}" in kmer["traffic"]["steps"][0]["argv"]
    lib = kmer["config"]["library"]
    assert [x["alleles"] for x in lib["loci"]] == [6200, 7400, 6400]
    cut = dict(lib, length=300, loci=[dict(x, alleles=3) for x in lib["loci"]])
    a, b = gen.library_alleles(cut), gen.library_alleles(dict(group["config"]["library"], **{
        "length": 300, "loci": cut["loci"]}))
    assert a["names"] == b["names"] and (a["codes"] == b["codes"]).all()


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
def test_cut_cell_runs_monocls_on_the_cpu(cut_cell, tmp_path, trace):
    res = run.run_cell(cut_cell, 2**31 + 31, 0.2, trace, "cpu", tmp_path, 2)
    line = run.result_line(cut_cell, res, trace, {"platform": "cpu"})
    assert line["correct"] is True and line["checks"]["jobs_off_path"]["value"] == 0
    assert all(j["paths"] == ["monocls"] for j in res["jobs"])
    if trace:
        # the run log's stages and counters; the CPU has no device trace
        got = {k for k in line["metrics"] if k.endswith(".kmer")}
        assert got == {"index.load_s.kmer", "tables.host_s.kmer", "tables.monocls_s.kmer", "engine.submit_s.kmer"}
        assert all(line["metrics"][k]["value"] > 0 for k in got)
        assert line["metrics"]["tables.monocls_s.kmer"]["value"] < line["metrics"]["tables.host_s.kmer"]["value"]
    else:
        assert set(line["metrics"]) == {"align_reads_per_s", "setup_s"}
