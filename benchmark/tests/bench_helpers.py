"""Small copies of the benchmark's cells for tests on the CPU."""
from __future__ import annotations

import contextlib
import io

from benchmark import spec


def tiny_cell(workload: str, reads: int = 2500, alleles: int = 12, cells: int = 40, on_library: float = 0.5,
              **kw) -> dict:
    """The cell of `workload` cut to a CPU test: at most `alleles` alleles
    a locus, `reads` reads (or pairs) a job, and `on_library` of them from
    the library, so that a small job has rows to compare. So narrow a
    library takes the narrow path of its probe (group or mono)."""
    cell = spec.load_cell(workload, **kw)
    lib = cell["config"]["library"]
    lib["loci"] = [dict(x, alleles=min(x["alleles"], alleles)) for x in lib["loci"]]
    cell["traffic"]["reads"] = reads
    cell["traffic"]["warm_reads"] = min(300, reads)
    cell["traffic"]["on_library_share"] = on_library
    cell["cell"] = {"engine_path": cell["traffic"]["probe"]}
    if "cells" in cell["traffic"]:
        cell["traffic"]["cells"] = cells
    return cell


def cli(args) -> int:
    """The port's CLI, in this process, its prints dropped."""
    from nimble_tpu_torch import __main__ as port

    with contextlib.redirect_stdout(io.StringIO()):
        return port.main(args)
