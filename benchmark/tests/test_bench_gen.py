"""The frozen generators against nimble_tpu_torch/bench_data.py's draws at
its fixed seeds, at a small size."""
from __future__ import annotations

import gzip

import numpy as np

from benchmark import gen, spec
from nimble_tpu_torch import bench_data, seq


def fastq_codes(path) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        lines = f.read().split("\n")
    return np.stack([seq.encode(s) for s in lines[1::4] if s])


ONE_LOCUS = {"seed": 0, "length": 3000, "loci": [{"name": "x", "alleles": 100}], "snps": 30,
             "name_format": "allele{a:03d}", "reference_genome": "hla bench"}


def test_one_locus_is_bench_datas_hla100():
    lib = gen.library_alleles(ONE_LOCUS)
    assert np.array_equal(lib["codes"], bench_data.hla100_alleles(np.random.default_rng(0)))
    assert lib["names"] == bench_data.hla100_names()


def test_independent_loci_are_bigindexs(tmp_path):
    lib = gen.library_alleles({"seed": 0, "length": 3000, "loci": [{"name": "F", "alleles": 1000}] * 2,
                               "snps": 25, "name_format": "F{f:02d}*{a:04d}"})
    _path, want = bench_data.wide_library(tmp_path, families=2)
    assert np.array_equal(lib["codes"], want)
    assert lib["names"] == bench_data.wide_names(2)


def test_hla100_loci_share_an_ancestor():
    lib = gen.library_alleles(spec.load_cell("hla100-bulk-se")["config"]["library"])
    assert lib["codes"].shape == (100, 3000) and lib["loci"] == ["A", "B", "C"]
    assert np.bincount(lib["locus"]).tolist() == [31, 37, 32]
    assert lib["names"][0] == "HLA-A*000" and lib["names"][-1] == "HLA-C*031"
    apart = lambda i, j: (lib["codes"][i] != lib["codes"][j]).mean()  # noqa: E731
    assert 0.005 < apart(0, 1) < 0.03  # two alleles of HLA-A
    assert 0.08 < apart(0, 40) < 0.16  # HLA-A against HLA-B


def test_a_library_file_gives_its_alleles(tmp_path):
    cfg = spec.load_cell("hla100-bulk-se")["config"]
    gen.write_library(tmp_path / "lib.json", cfg)
    got = gen.library_alleles({"file": "lib.json", "locus_separator": "*"}, tmp_path)
    want = gen.library_alleles(cfg["library"])
    assert got["names"] == want["names"] and np.array_equal(got["codes"], want["codes"])
    assert np.array_equal(got["locus"], want["locus"]) and got["loci"] == ["HLA-A", "HLA-B", "HLA-C"]
    gen.write_library(tmp_path / "copy.json", {"library": {"file": "lib.json"}}, tmp_path)
    assert (tmp_path / "copy.json").read_bytes() == (tmp_path / "lib.json").read_bytes()


def test_alleles_of_many_lengths():
    rng = np.random.default_rng(4)
    alleles = rng.integers(0, 4, (3, 900)).astype(np.int8)
    lens = np.array([150, 900, 400])
    t = {"read_len": 100, "error_rate": 0.0, "rc_share": 0.0}
    reads = gen.single_reads(gen.rng_of(9), alleles, 600, t, lens)
    text = [gen.ACGT[a[:n]].tobytes() for a, n in zip(alleles, lens)]
    assert all(any(gen.ACGT[r].tobytes() in s for s in text) for r in reads)
    p = gen.tenx_pairs(gen.rng_of(9), alleles, 200, {"cb_len": 16, "umi_len": 12, "r1_cdna": 30, "r2_len": 40,
                                                      "gap": 20, "cells": 5, "error_rate": 0.0}, lens)
    assert all(any(gen.ACGT[r].tobytes() in s for s in text) for r in p["r1"])


def test_a_sample_is_one_genotype_and_a_share_of_the_reads():
    lib = gen.library_alleles(spec.load_cell("hla100-bulk-se")["config"]["library"])
    t = {"read_len": 100, "error_rate": 0.0, "rc_share": 0.0, "alleles_per_locus": 2, "on_library_share": 0.25,
         "off_library": {"transcripts": 50, "length": 3000}}
    seen = []

    def draw(rng, alleles, m, t_, lens):
        seen.append(alleles)
        return gen.single_reads(rng, alleles, m, t_, lens)

    on, off, order = gen.sample(gen.rng_of(2**33 + 1), lib, 4000, t, draw)
    assert on.shape == (1000, 100) and off.shape == (3000, 100) and sorted(order) == list(range(4000))
    rows = [np.flatnonzero((lib["codes"] == a).all(1))[0] for a in seen[0]]
    assert len(rows) == 6 and [lib["locus"][r] for r in rows] == [0, 0, 1, 1, 2, 2]
    text = [gen.ACGT[lib["codes"][r]].tobytes() for r in rows]
    assert all(any(gen.ACGT[x].tobytes() in s for s in text) for x in on[:200])
    k = 21
    lib_kmers = {c[i:i + k].tobytes() for c in lib["codes"] for i in range(0, 3000 - k + 1)}
    assert not any(x[i:i + k].tobytes() in lib_kmers for x in off[:300] for i in range(0, 80, 7))
    reads = gen.sample_single(gen.rng_of(2**33 + 1), lib, 4000, t)["r1"]
    assert np.array_equal(reads, np.concatenate([on, off])[order])
    other = gen.genotype(gen.rng_of(2**33 + 2), lib, 2)
    assert len({tuple(gen.genotype(gen.rng_of(s), lib, 2)) for s in range(8)}) > 1 and other.shape == (6,)


def test_a_tenx_sample_keeps_its_pairs_together():
    lib = gen.library_alleles(spec.load_cell("hla100-10x-pairs")["config"]["library"])
    t = dict(spec.load_cell("hla100-10x-pairs")["traffic"], cells=20, on_library_share=0.5)
    got = gen.sample_tenx(gen.rng_of(7), lib, 600, t)
    assert got["r1"].shape == (600, 72) and got["r2"].shape == (600, 100)
    assert got["cb"].shape == (600, 16) and got["umi"].shape == (600, 12)
    assert len({c.tobytes() for c in got["cb"]}) <= 20
    pure = {k: v for k, v in t.items() if k not in ("alleles_per_locus", "on_library_share")}
    whole = gen.sample_tenx(gen.rng_of(7), lib, 300, pure)
    want = gen.tenx_pairs(gen.rng_of(7), lib["codes"], 300, pure)
    assert np.array_equal(whole["r1"], want["r1"]) and np.array_equal(whole["cb"], want["cells"][want["cell"]])


def test_single_reads_are_write_singles(tmp_path):
    rng = np.random.default_rng(0)
    alleles = bench_data.hla100_alleles(rng)
    t = spec.load_cell("hla100-bulk-se")["traffic"]
    got = gen.single_reads(rng, alleles, 3000, t)
    _lib, fq = bench_data.write_single(tmp_path, 3000)
    assert np.array_equal(got, fastq_codes(fq))
    gen.write_fastq_gz(tmp_path / "mine.fastq.gz", got)
    assert np.array_equal(fastq_codes(tmp_path / "mine.fastq.gz"), got)


def test_tenx_pairs_are_write_paireds(tmp_path):
    t = dict(spec.load_cell("hla100-10x-pairs")["traffic"])
    rng = np.random.default_rng(42)
    got = gen.tenx_pairs(rng, bench_data.hla100_alleles(np.random.default_rng(0)), 2000, t)
    r1, r2, wl = bench_data.write_paired(tmp_path, 2000)
    want1, want2 = fastq_codes(r1), fastq_codes(r2)
    cb = gen.ACGT.searchsorted(got["cells"][got["cell"]])  # ACGT is sorted: its index is the code
    umi = gen.ACGT.searchsorted(got["umi"])
    assert np.array_equal(np.concatenate([cb, umi, got["r1"]], axis=1), want1)
    assert np.array_equal(got["r2"], want2)
    with open(wl) as f:
        assert [ln.strip() for ln in f] == [c.tobytes().decode() for c in got["cells"]]


def test_the_seed_sets_the_reads():
    alleles = np.random.default_rng(3).integers(0, 4, (5, 400)).astype(np.int8)
    t = {"read_len": 100, "error_rate": 0.01, "rc_share": 0.5}
    a = gen.single_reads(gen.rng_of(2**31 + 12345), alleles, 500, t)
    assert np.array_equal(a, gen.single_reads(gen.rng_of(2**31 + 12345), alleles, 500, t))
    assert not np.array_equal(a, gen.single_reads(gen.rng_of(2**31 + 12346), alleles, 500, t))
    assert gen.single_reads(gen.rng_of(-7), alleles, 10, t).shape == (10, 100)
