"""The plain reference against the port's `--device cpu` CLI on a small
library: both probes, single-end reads and 10x pairs with their report."""
from __future__ import annotations

import pytest

from bench_helpers import cli
from benchmark import bgzf, check, gen
from benchmark.reference import align as ref
from benchmark.reference import report as ref_report

CFG = {"library": {"seed": 0, "loci": [{"name": "F", "alleles": 25}] * 2, "length": 3000, "snps": 30,
                   "name_format": "F{f}*{a:03d}", "reference_genome": "test"},
       "library_config": {"score_threshold": 20, "score_filter": 25, "score_percent": 0.5, "num_mismatches": 0,
                          "discard_multiple_matches": False, "intersect_level": 0, "group_on": "",
                          "discard_multi_hits": 0, "require_valid_pair": False, "data_type": "RNA",
                          "filters": [], "max_hits_to_report": 10, "trim_target_length": 50,
                          "trim_strictness": 0.9}}
TENX = {"error_rate": 0.01, "cb_len": 16, "umi_len": 12, "r1_cdna": 72, "r2_len": 100, "gap": 120, "cells": 60}


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    d = tmp_path_factory.mktemp("lib")
    gen.write_library(d / "lib.json", CFG)
    return d / "lib.json", gen.library_alleles(CFG["library"])["codes"]


@pytest.mark.parametrize("probe", ["group", "mono"])
def test_single_end(library, tmp_path, probe):
    lib, alleles = library
    reads = gen.single_reads(gen.rng_of(2**31 + 99), alleles, 3000,
                             {"read_len": 100, "error_rate": 0.02, "rc_share": 0.5})
    gen.write_fastq_gz(tmp_path / "r.fastq.gz", reads)
    assert cli(["align", "--reference", str(lib), "--output", str(tmp_path / "o.tsv"), "--input",
                str(tmp_path / "r.fastq.gz"), "-c", "2", "--device", "cpu", "--probe", probe]) == 0
    ix = ref.Index(str(lib), 21, 6 if probe == "group" else 0, "cpu")
    rows = ref.tsv_rows(ix, probe, reads, block=1024)
    assert 1000 < len(rows) < 3000
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), (tmp_path / "o.tsv").read_text()) == 0


@pytest.mark.parametrize("probe", ["group", "mono"])
def test_tenx_pairs_and_report(library, tmp_path, probe):
    lib, alleles = library
    p = gen.tenx_pairs(gen.rng_of(31), alleles, 2500, TENX)
    cb = p["cells"][p["cell"]]
    bgzf.tagged_pairs_bam(tmp_path / "p.bam", cb, p["umi"], p["r1"], p["r2"])
    out, counts = tmp_path / "o.tsv", tmp_path / "c.tsv"
    assert cli(["align", "--reference", str(lib), "--output", str(out), "--input", str(tmp_path / "p.bam"),
                "-c", "2", "--device", "cpu", "--probe", probe]) == 0
    assert cli(["report", "-i", str(out), "-o", str(counts)]) == 0
    ix = ref.Index(str(lib), 21, 6 if probe == "group" else 0, "cpu")
    tags = [(c.tobytes().decode(), u.tobytes().decode()) for c, u in zip(cb, p["umi"])]
    rows = ref.tsv_rows(ix, probe, p["r1"], p["r2"], tags, block=1024)
    assert 1000 < len(rows) <= 2500
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), out.read_text()) == 0
    want = ref_report.counts(rows)
    assert want and check.lines_differing(want, counts.read_text()) == 0


def test_the_probes_differ_where_a_read_has_errors(library):
    """The group probe drops the windows of a (k+g-1)-mer that holds an
    error; the per-k-mer probe keeps them: some reads score apart."""
    lib, alleles = library
    reads = gen.single_reads(gen.rng_of(5), alleles, 400, {"read_len": 100, "error_rate": 0.03, "rc_share": 0.5})
    import torch

    c = torch.from_numpy(reads)
    lens = torch.full((len(reads),), 100)
    s_g = ref.score_mate(ref.Index(str(lib), 21, 6, "cpu"), c, lens, "group")[1]
    s_m = ref.score_mate(ref.Index(str(lib), 21, 0, "cpu"), c, lens, "mono")[1]
    assert bool((s_g <= s_m).all()) and bool((s_g < s_m).any())


def test_report_reference_on_a_handmade_umi():
    rows = ["a,b\t100\tC1\tU1\t\t\t\t\t0\t0\t\n", "a\t100\tC1\tU1\t\t\t\t\t0\t0\t\n",
            "c\t4\tC1\tU1\t\t\t\t\t0\t0\t\n", "b\t50\tC2\tU9\t\t\t\t\t0\t0\t\n"]
    # U1: a 150, b 50, c 4 of 204 -> c (0.0196) goes; then a,b over rows 1-2
    # and 'a' survive, so the UMI's call is the intersection {a}
    assert ref_report.counts(rows) == "a\t1\tC1\nb\t1\tC2\n"


def test_report_reference_against_the_ports_report(tmp_path):
    """bench_data's 10x align TSV (UMIs of 1-16 reads, a tenth of them off
    by an allele) through both reports."""
    from nimble_tpu_torch import bench_data

    tsv = tmp_path / "r.tsv"
    bench_data.write_report_tsv(tsv, 20000, bench_data.hla100_names(), seed=3)
    assert cli(["report", "-i", str(tsv), "-o", str(tmp_path / "c.tsv")]) == 0
    want = ref_report.counts(tsv.read_text().splitlines(keepends=True)[1:])
    assert len(want.splitlines()) > 1000
    assert check.lines_differing(want, (tmp_path / "c.tsv").read_text()) == 0
