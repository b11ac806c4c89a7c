"""The one traffic generator: libraries from a configuration's parameters
(or its library file), reads and 10x pairs from a traffic mix's parameters
and the run's seed.

The draws are those of `nimble_tpu_torch/bench_data.py` (the reference
repository's bench scripts), frozen here so that a later change to the
program cannot move the yardstick, with the sample drawn on top:

  * a library is loci of alleles (`library_alleles`): each locus a random
    backbone, or one departing from a shared ancestor, and each allele
    its locus's backbone with `snps` random substitutions, from the
    configuration's fixed `seed`;
  * a sample (`sample`) is one genotype, `alleles_per_locus` alleles of
    each locus, and a share `on_library_share` of its reads from them;
    the rest come from random transcripts the library does not hold;
  * single reads (`single_reads`) are write_single's draws: per block of
    2^17, the source allele, the start, the substitutions, then the strand;
  * 10x pairs (`tenx_pairs`) are _write_pairs's draws: the cell barcodes
    first, then per block of 2^16 the allele, the fragment start, both
    mates' substitutions, the cell and the UMI.

Reads come from `numpy.random.default_rng(seed)` with the run's seed, so
one seed gives one input.
"""
from __future__ import annotations

import gzip
import json
import os
import pathlib
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_of(seed: int) -> np.random.Generator:
    """The generator of a run's seed (any whole number, negative ones too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of (n, L) base codes 0-3."""
    return (3 - codes[..., ::-1]).astype(np.int8)


def library_alleles(lib: dict, root: pathlib.Path = None) -> dict:
    """A configuration's `library` as {"names", "codes" (n, max_len) int8,
    "lens" (n,), "locus" (n,) locus index of each allele, "loci" (names)},
    in library order.

    Generator parameters: `loci` [{"name", "alleles"}] in order; with
    `locus_snps`, one random ancestor of `length` bases that each locus's
    backbone departs from by `locus_snps` random substitutions (paralogous
    genes), else one random backbone a locus; each allele its locus's
    backbone with `snps` random substitutions, all from the fixed `seed`.
    One locus without `locus_snps` is bench_data's HLA-100 draw; loci of
    1,000 alleles and 25 SNPs are scripts/bigindex.py's families.

    Or a library file: `file`, a [Config, Data] JSON under the checkout
    (`root`), whose sequence names give the locus before `locus_separator`.
    """
    if "file" in lib:
        with open(pathlib.Path(root or ".") / lib["file"]) as f:
            _cfg, data = json.load(f)
        cols = dict(zip(data["headers"], data["columns"]))
        names, seqs = list(cols["sequence_name"]), cols["sequence"]
        lens = np.array([len(x) for x in seqs], dtype=np.int64)
        codes = np.full((len(seqs), int(lens.max())), 0, dtype=np.int8)
        lut = np.full(256, 0, dtype=np.int8)
        lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
        for i, x in enumerate(seqs):
            codes[i, :len(x)] = lut[np.frombuffer(x.encode(), np.uint8)]
        sep = lib.get("locus_separator", "*")
        loci = sorted({n.split(sep)[0] for n in names})
        locus = np.array([loci.index(n.split(sep)[0]) for n in names], dtype=np.int64)
        return {"names": names, "codes": codes, "lens": lens, "locus": locus, "loci": loci}
    rng = np.random.default_rng(lib["seed"])
    length, snps, loci = lib["length"], lib["snps"], lib["loci"]
    n = sum(x["alleles"] for x in loci)
    codes = np.empty((n, length), dtype=np.int8)
    locus = np.empty(n, dtype=np.int64)
    names = []
    ancestor = rng.integers(0, 4, size=length).astype(np.int8) if "locus_snps" in lib else None
    i = 0
    for f, x in enumerate(loci):
        if ancestor is None:
            backbone = rng.integers(0, 4, size=length).astype(np.int8)
        else:
            backbone = ancestor.copy()
            pos = rng.integers(0, length, size=lib["locus_snps"])
            backbone[pos] = rng.integers(0, 4, size=lib["locus_snps"]).astype(np.int8)
        for a in range(x["alleles"]):
            s = backbone.copy()
            pos = rng.integers(0, length, size=snps)
            s[pos] = rng.integers(0, 4, size=snps).astype(np.int8)
            codes[i], locus[i] = s, f
            names.append(lib["name_format"].format(locus=x["name"], f=f, a=a))
            i += 1
    return {"names": names, "codes": codes, "lens": np.full(n, length, dtype=np.int64), "locus": locus,
            "loci": [x["name"] for x in loci]}


def write_library(path, cfg: dict, root: pathlib.Path = None) -> None:
    """The [Config, Data] library JSON that `align --reference` reads,
    written whole to a temporary name and then moved into place: the
    configuration's library file as it is, or the generated alleles under
    its `library_config`."""
    lib = cfg["library"]
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".part")
    if "file" in lib:
        shutil.copyfile(pathlib.Path(root or ".") / lib["file"], tmp)
    else:
        al = library_alleles(lib)
        seqs = [ACGT[a].tobytes().decode() for a in al["codes"]]
        data = {"headers": ["reference_genome", "sequence_name", "nt_length", "sequence"],
                "columns": [[lib["reference_genome"]] * len(seqs), al["names"],
                            [str(n) for n in al["lens"]], seqs]}
        with open(tmp, "w") as f:
            json.dump([cfg["library_config"], data], f)
    os.replace(tmp, path)


def _starts(rng: np.random.Generator, lens: np.ndarray, span: int, m: int) -> np.ndarray:
    """m random starts of a `span`-base stretch on alleles of `lens` bases
    (one length: bench_data's draw)."""
    if lens.min() == lens.max():
        return rng.integers(0, int(lens[0]) - span + 1, size=m)
    return (rng.random(m) * (lens - span + 1)).astype(np.int64)


def single_reads(rng: np.random.Generator, alleles: np.ndarray, n: int, t: dict, lens=None) -> np.ndarray:
    """(n, read_len) int8 single-end reads: a random start on a random
    allele, substitutions at `error_rate`, a share `rc_share` reverse-
    complemented."""
    L, block = t["read_len"], 1 << 17
    n_al = alleles.shape[0]
    lens = np.full(n_al, alleles.shape[1]) if lens is None else np.asarray(lens)
    out = np.empty((n, L), dtype=np.int8)
    for s0 in range(0, n, block):
        m = min(block, n - s0)
        src = rng.integers(0, n_al, size=m)
        st = _starts(rng, lens[src], L, m)
        codes = alleles[src[:, None], st[:, None] + np.arange(L)[None, :]]
        err = rng.random((m, L)) < t["error_rate"]
        codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
        rc = rng.random(m) < t["rc_share"]
        codes[rc] = revcomp(codes[rc])
        out[s0:s0 + m] = codes
    return out


def tenx_pairs(rng: np.random.Generator, alleles: np.ndarray, n: int, t: dict, lens=None, cells=None) -> dict:
    """n 10x pairs: R1 = cell barcode + UMI + `r1_cdna` bases, R2 =
    `r2_len` bases of the other strand `gap` bases on. Returns the cells'
    barcodes (cells, cb_len) uint8 ASCII (drawn first, unless given), and
    per pair `cell` (n,), `umi` (n, umi_len) uint8 ASCII, `r1` (n, r1_cdna)
    and `r2` (n, r2_len) int8."""
    c_len, u_len, l1, l2, gap = t["cb_len"], t["umi_len"], t["r1_cdna"], t["r2_len"], t["gap"]
    block = 1 << 16
    n_al = alleles.shape[0]
    lens = np.full(n_al, alleles.shape[1]) if lens is None else np.asarray(lens)
    if cells is None:
        cells = ACGT[rng.integers(0, 4, size=(t["cells"], c_len))]
    cell = np.empty(n, dtype=np.int64)
    umi = np.empty((n, u_len), dtype=np.uint8)
    r1 = np.empty((n, l1), dtype=np.int8)
    r2 = np.empty((n, l2), dtype=np.int8)
    for s0 in range(0, n, block):
        m = min(block, n - s0)
        src = rng.integers(0, n_al, size=m)
        st = _starts(rng, lens[src], l1 + gap + l2 + 1, m)
        c1 = alleles[src[:, None], st[:, None] + np.arange(l1)[None, :]].astype(np.int8)
        c2 = revcomp(alleles[src[:, None], (st + l1 + gap)[:, None] + np.arange(l2)[None, :]])
        for c in (c1, c2):
            err = rng.random(c.shape) < t["error_rate"]
            c[...] = np.where(err, rng.integers(0, 4, size=c.shape), c).astype(np.int8)
        cell[s0:s0 + m] = rng.integers(0, t["cells"], size=m)
        umi[s0:s0 + m] = ACGT[rng.integers(0, 4, size=(m, u_len))]
        r1[s0:s0 + m], r2[s0:s0 + m] = c1, c2
    return {"cells": cells, "cell": cell, "umi": umi, "r1": r1, "r2": r2}


def genotype(rng: np.random.Generator, lib: dict, per_locus: int) -> np.ndarray:
    """The alleles one sample carries: `per_locus` draws (with replacement,
    so a locus can be homozygous) from each locus's alleles, in locus
    order, as indices into the library."""
    out = []
    for f in range(len(lib["loci"])):
        idx = np.flatnonzero(lib["locus"] == f)
        out.append(idx[rng.integers(0, len(idx), size=per_locus)])
    return np.concatenate(out)


def sample(rng: np.random.Generator, lib: dict, n: int, t: dict, draw):
    """`draw(rng, alleles, m, t, lens)` over one sample: with
    `alleles_per_locus`, the reads come from one genotype drawn from the
    seed; with `on_library_share` < 1, exactly round(n * share) of them
    come from the library and the rest from `off_library` random
    transcripts (the rest of a transcriptome, which the library does not
    hold), in an order drawn from the seed. Returns (on-library draw,
    off-library draw or None, the order (n,) or None). Without either key
    it is `draw` over the whole library, bench_data's draws."""
    sel = (genotype(rng, lib, t["alleles_per_locus"]) if "alleles_per_locus" in t
           else np.arange(len(lib["names"])))
    share = t.get("on_library_share", 1.0)
    m = int(round(n * share))
    on = draw(rng, lib["codes"][sel], m, t, lib["lens"][sel])
    if m == n:
        return on, None, None
    off_t = t["off_library"]
    transcripts = rng.integers(0, 4, size=(off_t["transcripts"], off_t["length"])).astype(np.int8)
    return on, draw(rng, transcripts, n - m, t, None), rng.permutation(n)


def _merge(on: np.ndarray, off, order):
    return on if off is None else np.concatenate([on, off])[order]


def sample_single(rng: np.random.Generator, lib: dict, n: int, t: dict) -> dict:
    """One sample's single-end reads: {"r1" (n, read_len)}."""
    on, off, order = sample(rng, lib, n, t, single_reads)
    return {"r1": _merge(on, off, order)}


def sample_tenx(rng: np.random.Generator, lib: dict, n: int, t: dict) -> dict:
    """One sample's 10x pairs, the cells' barcodes drawn first: {"r1",
    "r2", "cb" (n, cb_len), "umi" (n, umi_len)}, uint8 ASCII tags."""
    cells = ACGT[rng.integers(0, 4, size=(t["cells"], t["cb_len"]))]

    def draw(rng_, alleles, m, t_, lens):
        return tenx_pairs(rng_, alleles, m, t_, lens, cells)

    on, off, order = sample(rng, lib, n, t, draw)
    return {k: _merge(on[src], None if off is None else off[src], order)
            for k, src in (("r1", "r1"), ("r2", "r2"), ("umi", "umi"))} | {
        "cb": cells[_merge(on["cell"], None if off is None else off["cell"], order)]}


def _records(codes: np.ndarray, prefix: bytes, first: int, width: int) -> bytes:
    """FASTQ records of (n, L) codes named prefix + the read's index at a
    fixed width, quality I, assembled as one byte matrix."""
    n, L = codes.shape
    head = np.frombuffer(b"".join(b"@%s%0*d\n" % (prefix, width, first + i) for i in range(n)),
                         dtype=np.uint8).reshape(n, -1)
    body = np.concatenate([ACGT[codes], np.full((n, 1), ord("\n"), np.uint8),
                           np.frombuffer(b"+\n", np.uint8)[None, :].repeat(n, 0),
                           np.full((n, L), ord("I"), np.uint8), np.full((n, 1), ord("\n"), np.uint8)],
                          axis=1)
    return np.concatenate([head, body], axis=1).tobytes()


def write_fastq_gz(path, codes: np.ndarray, prefix: bytes = b"r", threads: int = 4) -> None:
    """One gz FASTQ of (n, L) codes: blocks of records compressed on
    `threads` threads as gzip members, written in order under a temporary
    name and moved into place."""
    block = 1 << 16
    parts = [codes[s:s + block] for s in range(0, codes.shape[0], block)]

    width = len(str(max(codes.shape[0] - 1, 0)))

    def member(i):
        return gzip.compress(_records(parts[i], prefix, i * block, width), compresslevel=1, mtime=0)

    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".part")
    with ThreadPoolExecutor(threads) as ex, open(tmp, "wb") as f:
        for blob in ex.map(member, range(len(parts))):
            f.write(blob)
    os.replace(tmp, path)
