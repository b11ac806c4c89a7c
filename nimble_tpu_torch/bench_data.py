"""The bench workloads, written from fixed seeds.

HLA-100: the same draws, in the same order, as the repository's
`scripts/make_bench_fastq.py` (the library JSON and the single-end gz FASTQ)
and `scripts/make_paired_bench.py` (10x-shaped R1/R2 gz FASTQs and the cell
barcode whitelist), so that a workload written here holds the same records.
The library: 100 alleles x 3 kb sharing one backbone (30 substitutions
each); reads: 100 bp with 1% substitutions, half reverse-complemented.

The 20k-allele HLA/KIR library (`write_wide`): scripts/bigindex.py's
build_library with its seed and draws (20 families x 1,000 alleles x 3 kb,
25 SNPs each: 20,000 features, W = 625 words), and reads and pairs drawn
from it; or its first families alone, in family order or allele-major.

The stacked workload (`write_stacked`): scripts/stackscale.py's three
libraries with HLA-100's 100 alleles each (stackscale has 40), reads drawn
round-robin from them as stackscale draws them, and 10x-shaped pairs.

The report workload (`write_report_tsv`): an align TSV as a 10x run's
`align` writes it, over a library's feature names, for `report`.
"""
from __future__ import annotations

import gzip
import json
import pathlib

import numpy as np

from nimble_tpu_torch import seq as seqmod
from nimble_tpu_torch.config import Config, Data

N_ALLELES = 100
ALLELE_LEN = 3000
READ_LEN = 100
ERROR_RATE = 0.01
# the paired reads: R1 = CB + UMI + R1_CDNA bases, R2 = R2_LEN bases
R1_CDNA = 72
R2_LEN = 100
CB_LEN = 16
UMI_LEN = 12
N_CELLS = 1000

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def hla100_alleles(rng: np.random.Generator) -> np.ndarray:
    """The library's (N_ALLELES, ALLELE_LEN) int8 codes, drawn from `rng`."""
    backbone = rng.integers(0, 4, size=ALLELE_LEN).astype(np.int8)
    alleles = []
    for _ in range(N_ALLELES):
        s = backbone.copy()
        pos = rng.integers(0, ALLELE_LEN, size=30)
        s[pos] = rng.integers(0, 4, size=30).astype(np.int8)
        alleles.append(s)
    return np.stack(alleles)


def hla100_names():
    """The HLA-100 library's feature names, in library order."""
    return [f"allele{i:03d}" for i in range(N_ALLELES)]


def write_single(outdir, n_reads: int):
    """`hla100.json` and `reads_<n_reads>.fastq.gz` in outdir. Returns
    (library path, FASTQ path)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    mat = hla100_alleles(rng)
    data = Data()
    for i, s in enumerate(mat):
        for col, v in zip(data.columns, ("hla bench", hla100_names()[i], str(ALLELE_LEN), seqmod.decode(s))):
            col.append(v)
    lib_path = outdir / "hla100.json"
    with open(lib_path, "w") as f:
        json.dump([Config().to_dict(), data.__dict__], f)

    fq_path = outdir / f"reads_{n_reads}.fastq.gz"
    qual = b"I" * READ_LEN
    chunk = 1 << 17
    with gzip.open(fq_path, "wb", compresslevel=1) as f:
        for written in range(0, n_reads, chunk):
            n = min(chunk, n_reads - written)
            src = rng.integers(0, N_ALLELES, size=n)
            st = rng.integers(0, ALLELE_LEN - READ_LEN + 1, size=n)
            codes = mat[src[:, None], st[:, None] + np.arange(READ_LEN)[None, :]]
            err = rng.random((n, READ_LEN)) < ERROR_RATE
            codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
            rc = rng.random(n) < 0.5
            codes[rc] = seqmod.revcomp_codes(codes[rc])
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (written + i, r.tobytes(), qual)
                             for i, r in enumerate(_LUT[codes])))
    return str(lib_path), str(fq_path)


def write_paired(outdir, n_pairs: int):
    """`whitelist.txt`, `paired_r1_<n_pairs>.fastq.gz` and
    `paired_r2_<n_pairs>.fastq.gz` in outdir, from the library of
    write_single. Returns (R1 path, R2 path, whitelist path)."""
    return _write_pairs(outdir, n_pairs, hla100_alleles(np.random.default_rng(0))[None], "paired")


def _write_pairs(outdir, n_pairs: int, mats: np.ndarray, tag: str):
    """10x-shaped pairs from the alleles of one or more libraries (mats:
    (n_libraries, alleles, ALLELE_LEN)), pair i from library i mod
    n_libraries: `whitelist.txt`, `<tag>_r1_<n_pairs>.fastq.gz` and
    `<tag>_r2_<n_pairs>.fastq.gz` in outdir. One library gives the draws of
    scripts/make_paired_bench.py."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    cells = _LUT[rng.integers(0, 4, size=(N_CELLS, CB_LEN))]
    wl = outdir / "whitelist.txt"
    with open(wl, "w") as f:
        for c in cells:
            f.write(c.tobytes().decode() + "\n")

    r1p = outdir / f"{tag}_r1_{n_pairs}.fastq.gz"
    r2p = outdir / f"{tag}_r2_{n_pairs}.fastq.gz"
    q1 = b"I" * (CB_LEN + UMI_LEN + R1_CDNA)
    q2 = b"I" * R2_LEN
    chunk = 1 << 16
    with gzip.open(r1p, "wb", compresslevel=1) as f1, gzip.open(r2p, "wb", compresslevel=1) as f2:
        for done in range(0, n_pairs, chunk):
            n = min(chunk, n_pairs - done)
            lib = ((done + np.arange(n)) % mats.shape[0])[:, None]
            src = rng.integers(0, mats.shape[1], size=n)
            st = rng.integers(0, ALLELE_LEN - (R1_CDNA + 120 + R2_LEN), size=n)
            c1 = mats[lib, src[:, None], st[:, None] + np.arange(R1_CDNA)[None, :]].astype(np.int8)
            st2 = st + R1_CDNA + 120
            c2 = seqmod.revcomp_codes(mats[lib, src[:, None], st2[:, None] + np.arange(R2_LEN)[None, :]]
                                      .astype(np.int8))
            for c in (c1, c2):
                err = rng.random(c.shape) < ERROR_RATE
                c[...] = np.where(err, rng.integers(0, 4, size=c.shape), c).astype(np.int8)
            cb = cells[rng.integers(0, N_CELLS, size=n)]
            umi = _LUT[rng.integers(0, 4, size=(n, UMI_LEN))]
            s1, s2 = _LUT[c1], _LUT[c2]
            f1.write(b"".join(b"@p%d\n%s%s%s\n+\n%s\n" % (done + i, cb[i].tobytes(), umi[i].tobytes(),
                                                            s1[i].tobytes(), q1) for i in range(n)))
            f2.write(b"".join(b"@p%d\n%s\n+\n%s\n" % (done + i, s2[i].tobytes(), q2) for i in range(n)))
    return str(r1p), str(r2p), str(wl)


# the stacked workload: scripts/stackscale.py's libraries, with N_PER_LIB
# raised from 40 to HLA-100's N_ALLELES
STACK_LIBS = 3


def stacked_names(seed: int):
    """Library `seed`'s feature names, in library order (stackscale's)."""
    return [f"l{seed}a{i:03d}" for i in range(N_ALLELES)]


def write_stacked(outdir, n_reads: int, n_pairs: int = 0, alleles: int = N_ALLELES):
    """The multi-library workload of scripts/stackscale.py: STACK_LIBS
    libraries (seeds 0, 1, 2), each N_ALLELES alleles of its own 3 kb
    backbone with 30 positions redrawn (lib_workload's draws, which are
    hla100_alleles'), as `stacked<seed>.json`; `stacked_reads_<n>.fastq.gz`,
    100 bp reads drawn round-robin from the libraries with stackscale's
    draws (seed 9; 1% substitutions; half reverse-complemented, seed 1);
    and with n_pairs, 10x-shaped pairs drawn round-robin from them
    (_write_pairs). `alleles` < N_ALLELES keeps each library's first
    alleles, and draws the reads from them: a small copy for tests. Returns
    (library paths, FASTQ path, (R1, R2, whitelist) or None)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    mats = np.stack([hla100_alleles(np.random.default_rng(seed))[:alleles] for seed in range(STACK_LIBS)])
    libs = []
    for seed, mat in enumerate(mats):
        data = Data()
        for name, a in zip(stacked_names(seed), mat):
            for col, v in zip(data.columns, (f"lib{seed}", name, str(ALLELE_LEN), seqmod.decode(a))):
                col.append(v)
        path = outdir / f"stacked{seed}.json"
        with open(path, "w") as f:
            json.dump([Config().to_dict(), data.__dict__], f)
        libs.append(str(path))

    rng = np.random.default_rng(9)
    codes = np.empty((n_reads, READ_LEN), dtype=np.int8)
    for i in range(n_reads):
        a = mats[i % STACK_LIBS, rng.integers(0, alleles)]
        st = rng.integers(0, ALLELE_LEN - READ_LEN + 1)
        codes[i] = a[st : st + READ_LEN]
    err = rng.random(codes.shape) < ERROR_RATE
    codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
    rc = np.random.default_rng(1).random(n_reads) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    fq = outdir / f"stacked_reads_{n_reads}.fastq.gz"
    qual = b"I" * READ_LEN
    with gzip.open(fq, "wb", compresslevel=1) as f:
        for start in range(0, n_reads, 1 << 17):
            f.write(b"".join(b"@s%d\n%s\n+\n%s\n" % (start + i, r.tobytes(), qual)
                             for i, r in enumerate(_LUT[codes[start : start + (1 << 17)]])))
    pairs = _write_pairs(outdir, n_pairs, mats, "stacked") if n_pairs else None
    return libs, str(fq), pairs


# the 20k-allele library (published shape, not cut) and its reads
WIDE_FAMILIES = 20
WIDE_ALLELES = 1000
WIDE_LEN = 3000
WIDE_SNPS = 25
WIDE_ERROR = 0.01


def _wide_order(families: int, interleaved: bool):
    """(family, allele) of each feature of a wide library, in library order."""
    if interleaved:
        return [(f, a) for a in range(WIDE_ALLELES) for f in range(families)]
    return [(f, a) for f in range(families) for a in range(WIDE_ALLELES)]


def wide_names(families: int = WIDE_FAMILIES, interleaved: bool = False):
    """A wide library's feature names, in library order (the 20k library's
    by default)."""
    return [f"F{fam:02d}*{a:04d}" for fam, a in _wide_order(families, interleaved)]


def wide_library(outdir, families: int = WIDE_FAMILIES, interleaved: bool = False):
    """scripts/bigindex.py:build_library's 20k-allele library, with its seed
    and draws (the alleles of scripts/make_big20k_cli.py too), written as
    `big20k.json`, a [Config, Data] JSON; or its first `families` families
    (the same draws), written as `wide<families>.json`. `interleaved`
    writes the features allele-major (feature a * families + f, as
    `wide<families>_interleaved.json`), so that a class's features are not
    contiguous in library order. Returns (path, alleles (n, 3,000) int8 in
    the library's order)."""
    rng = np.random.default_rng(0)
    by_family = np.empty((families, WIDE_ALLELES, WIDE_LEN), dtype=np.int8)
    for fam in range(families):
        bb = rng.integers(0, 4, size=WIDE_LEN).astype(np.int8)
        for a in range(WIDE_ALLELES):
            s = bb.copy()
            pos = rng.integers(0, WIDE_LEN, size=WIDE_SNPS)
            s[pos] = rng.integers(0, 4, size=WIDE_SNPS).astype(np.int8)
            by_family[fam, a] = s
    order = _wide_order(families, interleaved)
    data = Data()
    alleles = np.empty((len(order), WIDE_LEN), dtype=np.int8)
    for i, ((fam, a), name) in enumerate(zip(order, wide_names(families, interleaved))):
        alleles[i] = by_family[fam, a]
        for col, v in zip(data.columns, ("hla_kir_20k", name, str(WIDE_LEN),
                                         seqmod.decode(alleles[i]))):
            col.append(v)
    if families == WIDE_FAMILIES and not interleaved:
        name = "big20k.json"
    else:
        name = f"wide{families}{'_interleaved' if interleaved else ''}.json"
    lib = pathlib.Path(outdir) / name
    with open(lib, "w") as f:
        json.dump([Config().to_dict(), data.__dict__], f)
    return str(lib), alleles


def _allele_reads(rng, alleles, src, start):
    """READ_LEN bases of allele `src` from `start`, with WIDE_ERROR
    substitutions."""
    codes = alleles[src[:, None], start[:, None] + np.arange(READ_LEN)[None, :]]
    err = rng.random(codes.shape) < WIDE_ERROR
    return np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)


def _fastq_records(codes, prefix: bytes, first: int, suffix: bytes = b"") -> bytes:
    qual = b"I" * codes.shape[1]
    return b"".join(b"@%s%d%s\n%s\n+\n%s\n" % (prefix, first + i, suffix, r.tobytes(), qual)
                    for i, r in enumerate(_LUT[codes]))


def write_wide(outdir, n_reads: int, n_pairs: int, families: int = WIDE_FAMILIES,
               interleaved: bool = False):
    """A wide library (`wide_library`: the 20k-allele one by default) and
    gz FASTQs of n_reads single-end 100 bp reads from random alleles (half
    reverse-complemented) and of n_pairs pairs whose mates come from one
    200-400 bp fragment of one allele, either strand; 1% substitutions.
    Returns (library path, FASTQ path, R1 path, R2 path)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    lib, alleles = wide_library(outdir, families, interleaved)
    n_al = alleles.shape[0]
    rng = np.random.default_rng(7)
    block = 1 << 17
    tag = "20k" if lib.endswith("big20k.json") else pathlib.Path(lib).stem
    fq = outdir / f"reads{tag}_{n_reads}.fastq.gz"
    with gzip.open(fq, "wb", compresslevel=1) as f:
        for s0 in range(0, n_reads, block):
            n = min(block, n_reads - s0)
            codes = _allele_reads(rng, alleles, rng.integers(0, n_al, size=n),
                                  rng.integers(0, WIDE_LEN - READ_LEN + 1, size=n))
            rc = rng.random(n) < 0.5
            codes[rc] = seqmod.revcomp_codes(codes[rc])
            f.write(_fastq_records(codes, b"r", s0))
    r1 = outdir / f"pairs{tag}_r1_{n_pairs}.fastq.gz"
    r2 = outdir / f"pairs{tag}_r2_{n_pairs}.fastq.gz"
    with gzip.open(r1, "wb", compresslevel=1) as f1, gzip.open(r2, "wb", compresslevel=1) as f2:
        for s0 in range(0, n_pairs, block):
            n = min(block, n_pairs - s0)
            src = rng.integers(0, n_al, size=n)
            frag = rng.integers(200, 401, size=n)
            st = (rng.random(n) * (WIDE_LEN - frag + 1)).astype(np.int64)
            head = _allele_reads(rng, alleles, src, st)
            tail = seqmod.revcomp_codes(_allele_reads(rng, alleles, src, st + frag - READ_LEN))
            flip = (rng.random(n) < 0.5)[:, None]  # fragments of either strand
            f1.write(_fastq_records(np.where(flip, tail, head), b"p", s0, b"/1"))
            f2.write(_fastq_records(np.where(flip, head, tail), b"p", s0, b"/2"))
    return lib, str(fq), str(r1), str(r2)


# the report workload: a 10x run's align TSV
REPORT_CELLS = 10_000
REPORT_FAMILY = 10  # consecutive feature names form one family
REPORT_MAX_READS = 16  # reads per UMI: min(geometric(1/4), 16), mean 3.96
REPORT_OFF = 0.10  # share of reads that add or swap an allele
REPORT_SCORES = (60, 150)


def write_report_tsv(path, n_rows: int, feature_names, seed: int) -> dict:
    """An align TSV (the port's TSV_HEADER, tagged r1/r2 CB and UB) of
    n_rows reads, for `report`. Each UMI has 1-16 reads (mean ~4) in one of
    REPORT_CELLS cells and a true set of 1-4 alleles of one family (blocks
    of REPORT_FAMILY consecutive names of `feature_names`); a read carries
    that set, except that REPORT_OFF of the reads add an allele of the
    family or swap one, so thresholding drops features and some UMIs
    intersect empty. Scores are integers 60-150. Rows come in random order.
    Returns the counts {"umis", "cells"}."""
    from nimble_tpu_torch.align.pipeline import TSV_HEADER

    rng = np.random.default_rng(seed)
    fam_n = len(feature_names) // REPORT_FAMILY
    if fam_n == 0:
        raise ValueError(f"need at least {REPORT_FAMILY} feature names")
    per = np.minimum(rng.geometric(0.25, size=n_rows), REPORT_MAX_READS)
    n_umi = int(np.searchsorted(np.cumsum(per), n_rows)) + 1
    umi_of = np.repeat(np.arange(n_umi), per[:n_umi])[:n_rows]
    cells = _LUT[rng.integers(0, 4, size=(REPORT_CELLS, CB_LEN))].view(f"S{CB_LEN}").ravel()
    cell = rng.integers(0, REPORT_CELLS, size=n_umi)
    umis = _LUT[rng.integers(0, 4, size=(n_umi, UMI_LEN))].view(f"S{UMI_LEN}").ravel()
    fam = rng.integers(0, fam_n, size=n_umi)
    size = rng.integers(1, 5, size=n_umi)
    rank = np.argsort(np.argsort(rng.random((n_umi, REPORT_FAMILY)), axis=1), axis=1)
    member = (rank < size[:, None])[umi_of]  # (n_rows, family) true sets

    # off reads: add one allele of the family that is not in the set; half
    # of them also drop one that is (a swap)
    off = rng.random(n_rows) < REPORT_OFF
    swap = off & (rng.random(n_rows) < 0.5)
    keys = rng.random((n_rows, REPORT_FAMILY))
    add = np.argmax(np.where(member, -1.0, keys), axis=1)
    rem = np.argmax(np.where(member, keys, -1.0), axis=1)
    rows = np.arange(n_rows)
    member[rows[swap], rem[swap]] = False
    member[rows[off], add[off]] = True

    pattern = (member << np.arange(REPORT_FAMILY)).sum(axis=1)
    code = fam[umi_of] * (1 << REPORT_FAMILY) + pattern
    uniq, inverse = np.unique(code, return_inverse=True)
    labels = []
    for c in uniq.tolist():
        base = (c >> REPORT_FAMILY) * REPORT_FAMILY
        labels.append(",".join(feature_names[base + j] for j in range(REPORT_FAMILY) if c >> j & 1))
    score = rng.integers(REPORT_SCORES[0], REPORT_SCORES[1] + 1, size=n_rows)
    pos = rng.integers(0, ALLELE_LEN - READ_LEN, size=n_rows)
    order = rng.permutation(n_rows)

    block = 1 << 17
    with open(path, "w") as f:
        f.write("\t".join(TSV_HEADER) + "\n")
        for s0 in range(0, n_rows, block):
            idx = order[s0:s0 + block]
            lab = [labels[i] for i in inverse[idx].tolist()]
            cb = cells[cell[umi_of[idx]]].astype(str).tolist()
            ub = umis[umi_of[idx]].astype(str).tolist()
            f.write("".join(
                f"{a}\t{sc}\t{c}\t{u}\t{c}\t{u}\t{p}\t{p + 220}\t{sc}\t0\t\n"
                for a, sc, c, u, p in zip(lab, score[idx].tolist(), cb, ub, pos[idx].tolist())
            ))
    return {"umis": n_umi, "cells": int(np.unique(cell).size)}
