"""The control (the reference with its k-mer keys compared on 32 bits)
comes out not correct at a size a test can hold."""
from __future__ import annotations

import pytest

from bench_helpers import tiny_cell
from benchmark import control, gen


@pytest.mark.parametrize("workload,probe", [("hla100-bulk-se", "group"), ("hla100-10x-pairs", "group"),
                                            ("hla100-bulk-se", "mono")])
def test_control_fails(tmp_path, workload, probe):
    cell = tiny_cell(workload, reads=1500)
    cell["traffic"]["probe"] = probe
    lib = tmp_path / "lib.json"
    gen.write_library(lib, cell["config"])
    got = control.readings(cell, 2**31 + 5, "cpu", str(lib))
    assert got["rows"] > 300
    assert got["tsv_rows_differing"] > 0
    if "count_lines_differing" in got:
        assert got["count_lines_differing"] > 0
