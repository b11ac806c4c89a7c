"""BENCHMARK.json against the contract, and the loaders of its cells,
metrics and layers."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run, spec

ROOT = spec.bench_root()
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|per_tok)")


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for key, want in groups.items():
        names = [e["name"] for e in B[key]]
        assert len(names) == len(set(names)), key
        for e in B[key]:
            assert set(e) - {"workloads"} == want, (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_cells_metrics_and_configs_agree():
    cells = {w["name"]: w for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in B["configs"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    for name in cells:
        reports = [m for m in B["end_to_end"] if name in m.get("workloads", cells)]
        assert len(reports) >= 2 and any(name in m.get("workloads", cells) for m in B["per_layer"])
    for c in B["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"])) and path.exists()
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_every_cell_loads(workload):
    cell = spec.load_cell(workload)
    t = cell["traffic"]
    assert callable(spec.plugin("generators", t["generator"]).make)
    assert callable(spec.plugin("writers", t["input"]).write)
    assert t["probe"] in ("group", "mono") and t["index_argv"][0] == "index"
    assert t["steps"][0]["name"] == "align" and len({s["name"] for s in t["steps"]}) == len(t["steps"])
    for step in t["steps"]:
        run.fill(step["argv"], {k: "x" for k in ("library", "probe", "device", "cores", "tsv", "counts", "work")},
                 ["in"])
    assert isinstance(cell["cell"]["engine_path"], str)
    assert cell["config"]["name"] == next(w["config"] for w in B["workloads"] if w["name"] == workload)
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"]) and cell["per_layer"]


def test_steps_fill_and_environment(monkeypatch):
    assert run.fill(["align", "--input", "{inputs}", "-c", "{cores}"], {"cores": 3}, ["a", "b"]) == \
        ["align", "--input", "a", "b", "-c", "3"]
    monkeypatch.setenv("BENCH_TEST_OLD", "1")
    monkeypatch.delenv("BENCH_TEST_NEW", raising=False)
    with run.environ({"BENCH_TEST_OLD": "2", "BENCH_TEST_NEW": 5}):
        assert os.environ["BENCH_TEST_OLD"] == "2" and os.environ["BENCH_TEST_NEW"] == "5"
    assert os.environ["BENCH_TEST_OLD"] == "1" and "BENCH_TEST_NEW" not in os.environ


def test_host_cores():
    got = run.host_cores()
    assert 1 <= got["cores"] <= (got["cpu_count"] or got["cores"])


@pytest.mark.parametrize("metric", [m["name"] for m in B["end_to_end"] + B["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


def test_every_layer_wraps_something_of_the_port():
    from benchmark.trace import _resolve

    layers = spec.load_layers()
    named = {m["layer"] for m in B["per_layer"]}
    assert set(layers) <= named
    for wraps in layers.values():
        for w in wraps:
            owner, name = _resolve(w)
            assert callable(getattr(owner, name)), w
