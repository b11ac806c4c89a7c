"""The loaders: a cell of BENCHMARK.json with its configuration, traffic mix
and cell file, the per-layer and end-to-end metric readers, the traffic's
generators and input writers, and the layers' wrap points, each found by
name under the benchmark's folder."""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def bench_root(here: pathlib.Path = HERE) -> pathlib.Path:
    """The checkout's root: the directory that holds BENCHMARK.json."""
    return here.parent


def load_cell(workload: str, root: pathlib.Path = None, here: pathlib.Path = HERE) -> dict:
    """{"workload", "here", "chips", "config", "traffic", "cell",
    "end_to_end", "per_layer"} of one workload: its BENCHMARK.json entry
    resolved to the configuration file, `traffic/<traffic>.json`,
    `cells/<workload>.json`, and the metrics that this cell reports; `here`
    is the benchmark folder the files came from."""
    root = root or bench_root(here)
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "workload": workload,
        "here": here,
        "root": root,
        "chips": int(w["chips"]),
        "config": load_json(root / cfg_entry["file"]),
        "traffic": load_json(here / "traffic" / f"{w['traffic']}.json"),
        "cell": load_json(here / "cells" / f"{workload}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }


def plugin(folder: str, name: str, here: pathlib.Path = HERE):
    """The module `<folder>/<name>.py` of the benchmark's folder."""
    path = here / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: pathlib.Path = HERE):
    """`read(record)` of `metrics/<name>.py`: the metric's number from a
    run's record, or None when the record holds nothing to read."""
    return plugin("metrics", name, here).read


def load_layers(here: pathlib.Path = HERE) -> dict:
    """{layer file stem: its wrap points}, every file of `layers/`."""
    return {p.stem: load_json(p)["wraps"] for p in sorted((here / "layers").glob("*.json"))}
