"""The benchmark's BGZF/BAM writer read back by the port's BAM reader."""
from __future__ import annotations

import numpy as np

from benchmark import bgzf, gen
from nimble_tpu_torch.io import bam


def pairs(n=700):
    rng = np.random.default_rng(5)
    t = {"cb_len": 16, "umi_len": 12, "r1_cdna": 72, "r2_len": 100, "gap": 120, "cells": 30, "error_rate": 0.01}
    p = gen.tenx_pairs(rng, rng.integers(0, 4, (4, 3000)).astype(np.int8), n, t)
    return p["cells"][p["cell"]], p["umi"], p["r1"], p["r2"]


def test_records_read_back(tmp_path):
    cb, umi, r1, r2 = pairs()
    path = tmp_path / "p.bam"
    bgzf.tagged_pairs_bam(path, cb, umi, r1, r2)
    recs = list(bam.BamReader(str(path)))
    assert len(recs) == 2 * len(r1)
    for i in (0, 1, len(r1) - 1):
        a, b = recs[2 * i], recs[2 * i + 1]
        assert (a.flag, b.flag) == (77, 141) and a.name == b.name
        assert a.seq == gen.ACGT[r1[i]].tobytes().decode() and b.seq == gen.ACGT[r2[i]].tobytes().decode()
        assert a.tags == b.tags == {"CB": cb[i].tobytes().decode(), "UB": umi[i].tobytes().decode()}
        assert a.qual == bytes([40]) * 72


def test_batches_pair_the_mates(tmp_path):
    cb, umi, r1, r2 = pairs(500)
    path = tmp_path / "p.bam"
    bgzf.tagged_pairs_bam(path, cb, umi, r1, r2)
    batches = list(bam.iter_bam_batches(str(path), batch_records=128))
    assert sum(len(b["names"]) for b in batches) == 500
    got1 = np.concatenate([b["r1_codes"] for b in batches])
    got2 = np.concatenate([b["r2_codes"] for b in batches])
    assert np.array_equal(got1[:, :72], r1) and np.array_equal(got2[:, :100], r2)
    assert (np.concatenate([b["r1_lens"] for b in batches]) == 72).all()
    assert [c for b in batches for c in b["cbs"]] == [c.tobytes().decode() for c in cb]


def test_bgzf_blocks_and_eof(tmp_path):
    import gzip

    data = bytes(range(256)) * 1000
    bgzf.write_bgzf(tmp_path / "x.gz", data)
    raw = (tmp_path / "x.gz").read_bytes()
    assert raw.endswith(bgzf.EOF_BLOCK) and raw[12:14] == b"BC"
    assert gzip.decompress(raw) == data
