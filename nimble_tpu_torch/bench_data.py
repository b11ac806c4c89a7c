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


def write_single(outdir, n_reads: int):
    """`hla100.json` and `reads_<n_reads>.fastq.gz` in outdir. Returns
    (library path, FASTQ path)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    mat = hla100_alleles(rng)
    data = Data()
    for i, s in enumerate(mat):
        for col, v in zip(data.columns, ("hla bench", f"allele{i:03d}", str(ALLELE_LEN), seqmod.decode(s))):
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
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    mat = hla100_alleles(np.random.default_rng(0))
    rng = np.random.default_rng(42)
    cells = _LUT[rng.integers(0, 4, size=(N_CELLS, CB_LEN))]
    wl = outdir / "whitelist.txt"
    with open(wl, "w") as f:
        for c in cells:
            f.write(c.tobytes().decode() + "\n")

    r1p = outdir / f"paired_r1_{n_pairs}.fastq.gz"
    r2p = outdir / f"paired_r2_{n_pairs}.fastq.gz"
    q1 = b"I" * (CB_LEN + UMI_LEN + R1_CDNA)
    q2 = b"I" * R2_LEN
    chunk = 1 << 16
    with gzip.open(r1p, "wb", compresslevel=1) as f1, gzip.open(r2p, "wb", compresslevel=1) as f2:
        for done in range(0, n_pairs, chunk):
            n = min(chunk, n_pairs - done)
            src = rng.integers(0, N_ALLELES, size=n)
            st = rng.integers(0, ALLELE_LEN - (R1_CDNA + 120 + R2_LEN), size=n)
            c1 = mat[src[:, None], st[:, None] + np.arange(R1_CDNA)[None, :]].astype(np.int8)
            st2 = st + R1_CDNA + 120
            c2 = seqmod.revcomp_codes(mat[src[:, None], st2[:, None] + np.arange(R2_LEN)[None, :]].astype(np.int8))
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


# the 20k-allele library (published shape, not cut) and its reads
WIDE_FAMILIES = 20
WIDE_ALLELES = 1000
WIDE_LEN = 3000
WIDE_SNPS = 25
WIDE_ERROR = 0.01


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
    if interleaved:
        order = [(f, a) for a in range(WIDE_ALLELES) for f in range(families)]
    else:
        order = [(f, a) for f in range(families) for a in range(WIDE_ALLELES)]
    data = Data()
    alleles = np.empty((len(order), WIDE_LEN), dtype=np.int8)
    for i, (fam, a) in enumerate(order):
        alleles[i] = by_family[fam, a]
        for col, v in zip(data.columns, ("hla_kir_20k", f"F{fam:02d}*{a:04d}", str(WIDE_LEN),
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
