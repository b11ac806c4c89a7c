"""A whole run on the CPU past the look for a card, the last line's
schema, and the refusals: no card, or a directory without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import tiny_cell
from benchmark import run, spec


@pytest.mark.parametrize("workload,trace", [("hla100-bulk-se", 0), ("hla100-10x-pairs", 1),
                                             ("hla100-bulk-se", 1)])
def test_run_and_line(tmp_path, workload, trace):
    cell = tiny_cell(workload)
    res = run.run_cell(cell, 2**31 + 77, 0.5, bool(trace), "cpu", tmp_path, 2)
    line = run.result_line(cell, res, bool(trace), {"platform": "cpu", "kind": "cpu", "count": 1})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = cell["per_layer"] if trace else cell["end_to_end"]
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    for name, m in line["metrics"].items():
        assert isinstance(m["value"], float) and m["unit"] == next(x["unit"] for x in want if x["name"] == name)
    if not trace:
        assert set(line["metrics"]) == names
    else:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert all(set(c) == {"value", "limit"} and c["value"] == 0 for c in line["checks"].values())
    assert "jobs_off_path" in line["checks"] and "tsv_rows_differing" in line["checks"]
    json.dumps(line)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "hla100-bulk-se", "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA card" in err


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    (no program) exits nonzero and prints no result."""
    root = spec.bench_root()
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hla100-bulk-se", "--seed", "3",
                          "--seconds", "1"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
