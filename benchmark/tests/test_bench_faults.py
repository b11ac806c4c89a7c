"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have: a step that leaves
its state unchanged (the TSV stays as opened), half of the batch left out,
an answer altered where it is produced, and a job on another engine path.
No cell runs across chips, so there is no exchange to leave out."""
from __future__ import annotations

import numpy as np
import pytest

from bench_helpers import tiny_cell
from benchmark import run
from nimble_tpu_torch.align import pipeline

EMIT = pipeline.LibraryRunner.emit_out


def unchanged(self, out, batch):
    return 0


def half_left_out(self, out, batch):
    if out is not None:
        out = dict(out, pass_=out["pass_"] & (np.arange(len(out["pass_"])) % 2 == 0))
    return EMIT(self, out, batch)


def altered(self, out, batch):
    if out is not None:
        score = out["score"].copy()
        score[np.flatnonzero(out["pass_"])[:1]] += 1
        out = dict(out, score=score)
    return EMIT(self, out, batch)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["hla100-bulk-se", "hla100-10x-pairs"])
def test_fault_is_not_correct(tmp_path, monkeypatch, workload, fault):
    cell = tiny_cell(workload, reads=1500)
    monkeypatch.setattr(pipeline.LibraryRunner, "emit_out", fault)
    res = run.run_cell(cell, 11, 0.2, False, "cpu", tmp_path, 2)
    line = run.result_line(cell, res, False, {"platform": "cpu"})
    assert line["correct"] is False
    assert line["checks"]["tsv_rows_differing"]["value"] > 0


def test_another_path_is_not_correct(tmp_path):
    cell = tiny_cell("hla100-bulk-se", reads=1500)
    cell["cell"] = {"engine_path": "gband"}
    res = run.run_cell(cell, 12, 0.2, False, "cpu", tmp_path, 2)
    line = run.result_line(cell, res, False, {"platform": "cpu"})
    assert line["correct"] is False and line["checks"]["jobs_off_path"]["value"] >= 1
