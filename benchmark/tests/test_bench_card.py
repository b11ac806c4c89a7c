"""One short run of a cell on the card (skips without one)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hla100-bulk-se", "--seed",
                          "2147483999", "--seconds", "2"], cwd=spec.bench_root(), capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
