"""A later change adds a configuration, a traffic mix, a cell, a per-layer
metric and a layer with new files and BENCHMARK.json entries alone: in a
copy of the benchmark, with no file edited, the new cell runs and reports
the new metric, and the new layer's span is installed. The new
configuration names a library file, and the new mix is a new kind of job:
its own steps (align with an environment variable, then report), a
generator and a writer of its own."""
from __future__ import annotations

import json
import shutil

from benchmark import gen, run, spec


def test_add_by_files_only(tmp_path):
    root = spec.bench_root()
    here = tmp_path / "benchmark"
    shutil.copytree(root / "benchmark", here, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = json.loads((root / "BENCHMARK.json").read_text())
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}

    cfg = json.loads((here / "configs" / "hla100.json").read_text())
    small = dict(cfg, library=dict(cfg["library"], loci=[dict(x, alleles=9) for x in cfg["library"]["loci"]]))
    (here / "libraries").mkdir()
    gen.write_library(here / "libraries" / "dummy.json", small)
    cfg.update(name="dummy", library={"file": "benchmark/libraries/dummy.json", "locus_separator": "*"})
    (here / "configs" / "dummy.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "bulk-se.json").read_text())
    steps = [dict(traffic["steps"][0], env={"NIMBLE_TPU_READER_BATCH": "256"}),
             {"name": "report", "argv": ["report", "-i", "{tsv}", "-o", "{counts}"]}]
    (here / "traffic" / "dummy-se.json").write_text(json.dumps(dict(
        traffic, reads=1200, warm_reads=200, on_library_share=0.5, generator="dummy", input="dummy",
        steps=steps, report_threshold=0.05)))
    (here / "generators" / "dummy.py").write_text(
        'from benchmark import gen\n\n\ndef make(rng, lib, n, t):\n    return gen.sample_single(rng, lib, n, t)\n')
    (here / "writers" / "dummy.py").write_text(
        'from benchmark import gen\n\n\ndef write(stem, reads):\n    p = stem.with_name(stem.name + ".fq.gz")\n'
        '    gen.write_fastq_gz(p, reads["r1"])\n    return [str(p)]\n')
    (here / "cells" / "dummy-cell.json").write_text(json.dumps({"engine_path": "group"}))
    (here / "metrics" / "dummy.rows_per_job.py").write_text(
        '"""TSV rows a job."""\n\n\ndef read(rec):\n    return sum(j["rows"] for j in rec["jobs"]) / len(rec["jobs"])\n')
    (here / "layers" / "dummy.json").write_text(json.dumps({"about": "the trim of each library", "wraps": [
        {"module": "nimble_tpu_torch.align.pipeline", "attr": "trimmed_lens", "span": "dummy.trim"}]}))
    b["configs"].append({"name": "dummy", "source": "https://example.org/dummy", "file": "benchmark/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-se", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "align_reads_per_s":
            m["workloads"].append("dummy-cell")
    b["per_layer"].append({"name": "dummy.rows_per_job", "unit": "rows", "better": "higher", "source": "host_clock",
                           "layer": "dummy", "moves": "align_reads_per_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    after = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added

    cell = spec.load_cell("dummy-cell", root=tmp_path, here=here)
    assert [m["name"] for m in cell["per_layer"]] == ["dummy.rows_per_job"]
    for trace in (False, True):
        res = run.run_cell(cell, 5, 0.2, trace, "cpu", tmp_path / "cache", 2)
        line = run.result_line(cell, res, trace, {"platform": "cpu"})
        assert line["correct"] is True and "count_lines_differing" in line["checks"]
        assert all("report_s" in j for j in res["jobs"])
        if trace:
            assert line["metrics"]["dummy.rows_per_job"]["value"] > 100
        else:
            assert set(line["metrics"]) == {"align_reads_per_s", "setup_s"}
    assert "dummy" in spec.load_layers(here)
