#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nimble_tpu_torch).

Drives the port's three align paths — `align` on the default group probe
and on the mono probe (`--probe mono`, `num_mismatches` 1) against narrow
libraries, and on the wide banded group path (gband) against the 20k-allele
HLA/KIR library — on one CUDA card, after building and checking their
kernels:

  1. device: card, power limit, torch/CUDA versions; the native host IO
     library (native/), built with the first compiler that can
     (nimble_tpu_torch/native_build.py, as the port's CLI builds it);
  2. kernel build: nvcc of nimble_tpu_torch/csrc/*.cu, one process per
     source, all started together;
  3. kmer_keys kernel == its plain torch version on all 7 planes, exactly,
     at the arguments the group path passes it (read from the engine that
     `align` builds for the HLA-100 workload) and at edge shapes; both
     timed with CUDA events;
  4. the 18 align goldens of tests/goldens/, byte-identical on cuda (15 on
     the group path, 3 on the mono path);
  5. the group path at real size: HLA-100 library, 2,097,152 single-end
     100 bp reads (scripts/make_bench_fastq.py), then 262,144 10x-shaped
     pairs through fastq-to-bam -> align -> report;
  6. mono_probe kernel == its plain torch version on both outputs, exactly,
     at the arguments the mono path passes it for HLA-100 under
     `--probe mono`, at the 16.7M-bucket table of HLA-100 under
     `num_mismatches = 1`, at B*P not a multiple of the block, at W = 16
     (a 500-feature library), with a full 64-row stash, and on synthetic
     tables with random orientation flags (palindromes, S != 4); timed
     with CUDA events at the main-path shape and at the large table;
  7. the mono path at real size: the same 2,097,152 reads and 262,144 BAM
     pairs under `--probe mono`, and 524,288 reads of the same generator
     against HLA-100 with `num_mismatches = 1`;
  8. the same 65,536 reads through `align --device cuda` and `--device cpu`
     give byte-identical TSVs, on the group probe and on `--probe mono`;
  9. the wide workload: the 20k-allele library of scripts/bigindex.py (20
     families x 1,000 alleles x 3 kb, 25 SNPs each: 20,000 features,
     W = 625 words), its index (C++ builder), 1,048,576 single-end 100 bp
     reads and 262,144 pairs (two FASTQs, both mates from one fragment of
     one allele), 1% substitutions; the engine build timed by part (index
     load, gband host build + sidecar write, sidecar load, copy to the
     card);
 10. band_tree_expand kernel == its plain torch version, exactly, on the
     (idx_sel, has_sel) the gband step passes it for real reads at the
     main-path shape (the engine `align` builds: L = 112, W = 625,
     Pw = 32) and at the reference bench's L = 100, and on synthetic
     tables (B not a multiple of the block, (W, Pw, Q1) = (100, 16, 7) and
     (70, 8, 5), Pw != 32, Q1 = 40, all-miss reads, out-of-range indices
     where no position contributes); timed with CUDA events;
 11. the gband path at real size: the single-end and paired runs;
 12. 16,384 of those reads through `align --device cuda` and `--device
     cpu` give byte-identical TSVs on the gband path.

Each main-path run zeroes the kernels' launch counts just before it and
reads them just after; the run fails unless every kernel of its path ran.
It prints its wall, and the index load and engine build inside it (the
pipeline's stage log, NIMBLE_TPU_RUNLOG).

Any failure raises (exit code != 0). The second-to-last line is a JSON
record of the kernels; the last line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Of the JAX package it imports only jax-free shared host modules
(nimble_tpu.io, .config, .index.builder, ...), as the port itself does;
jax is made unimportable before anything else is imported.

Usage: python3 chip_smoke.py   (from the repository root; needs one card)
"""
import sys

sys.modules["jax"] = None  # the port must never import jax: any attempt raises here

import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "goldens")
SKIP_GOLDENS = {"legacy_filters"}  # shared host code, not an align case
MONO_GOLDENS = {"probe_mono", "mismatch1", "mismatch2"}
FLAG_CASES = {
    "probe_mono": ["--probe", "mono"],
    "strand_fiveprime": ["--strand_filter", "fiveprime"],
}
SINGLE_END_CASES = {"strand_fiveprime"}

READ_LEN = 100  # scripts/make_bench_fastq.py's read length
N_READS = 2_097_152
N_PAIRS = 262_144
N_CMP_READS = 65_536
N_NM1_READS = 524_288
MONO = ["--probe", "mono"]

# the 20k-allele HLA/KIR library of scripts/bigindex.py (published shape,
# not cut) and its reads; the reads are cut from the reference's 2M
WIDE_FAMILIES = 20
WIDE_ALLELES = 1000
WIDE_LEN = 3000
WIDE_SNPS = 25
WIDE_ERROR = 0.01
N_WIDE_READS = 1_048_576
N_WIDE_PAIRS = 262_144
N_WIDE_CMP = 16_384
WIDE_KERNELS = ["kmer_keys", "band_tree_expand"]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd, **kw):
    """Run a subprocess to its end; raise on a nonzero exit."""
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd} exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def cli(args):
    """The port's CLI in-process; raise on a nonzero exit code."""
    from nimble_tpu_torch.__main__ import main

    rc = main(args)
    if rc != 0:
        raise RuntimeError(f"nimble_tpu_torch {' '.join(args)} exited {rc}")


def cuda_ms(fn, reps: int = 25) -> float:
    """Median of `reps` CUDA-event timings of fn(), after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tsv_rows(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f) - 1


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"{name} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()} | host cores {os.cpu_count()}")
    from nimble_tpu_torch.native_build import build_native

    _ok, how = build_native()  # before the shared loader first looks
    from nimble_tpu.io import native

    native_ok = native.available()
    if not native_ok:
        how += "; host IO runs the slower python readers and fallbacks, output is unchanged"
    say("device", f"native host IO available: {native_ok} ({how})")
    return name, smi


def phase_build():
    from nimble_tpu_torch.align import kernels as K

    t0 = time.perf_counter()
    path = K.build()
    srcs = sorted(f for f in os.listdir(K.CSRC) if f.endswith(".cu"))
    say("build", f"kernel library ({', '.join(srcs)}) built in {time.perf_counter() - t0:.2f} s: {path}")


def phase_data(work: str):
    """The main path's workload: the HLA-100 library, its index and the
    single-end reads."""
    se = os.path.join(work, "se")
    t0 = time.perf_counter()
    run([sys.executable, "scripts/make_bench_fastq.py", se, str(N_READS)])
    lib = os.path.join(se, "hla100.json")
    fq = os.path.join(se, f"reads_{N_READS}.fastq.gz")
    say("data", f"generated HLA-100 + {N_READS} reads in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["index", "--reference", lib])
    say("data", f"index built in {time.perf_counter() - t0:.2f} s")
    return lib, fq


def main_path_shape(lib: str):
    """(B, L, k, n_buckets) that the main path's align passes to kmer_keys:
    the engine that `align` builds for this library and 100 bp reads."""
    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    r = make_runner(lib, os.devnull)
    eng = AlignEngine(r.index, r.config, torch.device("cuda"), chunk_size=None,
                      max_len=_round_len(READ_LEN), paired=False)
    return (eng.chunk_size, eng.max_len, eng.params.k + eng.params.group_g - 1,
            eng.tables["group_bucket"].shape[0])


def phase_kernel(main_shape):
    from nimble_tpu_torch.align import kernels as K

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    MAIN_B, MAIN_L, MAIN_K, N_BUCKETS = main_shape
    say("kernel", f"main-path arguments: B={MAIN_B} L={MAIN_L} k={MAIN_K} n_buckets={N_BUCKETS}")
    cases = [(MAIN_B, MAIN_L, MAIN_K), (4099, 112, 16), (4099, 112, 21), (4099, 112, 31),
             (1001, 150, 26), (3, 40, 26)]
    names = ("c_hi", "c_lo", "h1", "h2", "fwd_canon", "palindrome", "valid")
    max_err = 0
    main_inputs = None
    for B, L, k in cases:
        codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
        codes[rng.random((B, L)) < 0.01] = 4  # N bases
        lens = rng.integers(1, L + 1, size=B).astype(np.int32)  # some < k, most < L
        lens[: B // 2] = L
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        got = K.kmer_keys(c, ln, k, N_BUCKETS)
        want = K.kmer_keys_reference(c, ln, k, N_BUCKETS)
        torch.cuda.synchronize()
        for nm, a, b in zip(names, got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"kmer_keys {nm} {a.dtype}{tuple(a.shape)} != twin {b.dtype}{tuple(b.shape)}")
            err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"kmer_keys != twin on {nm} at B={B} L={L} k={k} (max |diff| {err})")
        say("kernel", f"B={B} L={L} k={k}: all 7 planes equal the twin")
        if (B, L, k) == (MAIN_B, MAIN_L, MAIN_K):
            main_inputs = (c, ln)
    c, ln = main_inputs
    ms = cuda_ms(lambda: K.kmer_keys(c, ln, MAIN_K, N_BUCKETS))
    plain_ms = cuda_ms(lambda: K.kmer_keys_reference(c, ln, MAIN_K, N_BUCKETS))
    P = MAIN_L - MAIN_K + 1
    gbs = MAIN_B * P * 19 / (ms * 1e-3) / 1e9
    say("kernel", f"B={MAIN_B} L={MAIN_L} k={MAIN_K}: kernel {ms:.4f} ms (median of 25, "
        f"{gbs:.1f} GB/s of outputs), twin {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def phase_goldens(work: str):
    gdir = os.path.join(work, "goldens")
    os.makedirs(gdir)
    for f in os.listdir(GOLD):
        if f.endswith(".json") or f in ("r1.fastq", "r2.fastq"):
            shutil.copy(os.path.join(GOLD, f), gdir)
    cases = sorted(
        f[len("golden_"):-len(".tsv")] for f in os.listdir(GOLD)
        if f.startswith("golden_") and f.endswith(".tsv")
    )
    cases = [c for c in cases if c not in SKIP_GOLDENS]
    if len(cases) != 18 or not MONO_GOLDENS <= set(cases):
        raise AssertionError(f"expected 18 align goldens (3 on the mono path), found {cases}")
    for case in cases:
        lib = f"lib_{case}.json" if os.path.exists(os.path.join(GOLD, f"lib_{case}.json")) else "lib_base.json"
        inputs = [os.path.join(gdir, "r1.fastq")]
        if case not in SINGLE_END_CASES:
            inputs.append(os.path.join(gdir, "r2.fastq"))
        out = os.path.join(gdir, f"out_{case}.tsv")
        cli(["align", "--reference", os.path.join(gdir, lib), "--output", out,
             "--input", *inputs, *FLAG_CASES.get(case, []), "--device", "cuda"])
        with open(out, "rb") as f, open(os.path.join(GOLD, f"golden_{case}.tsv"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"golden {case}: cuda output differs from tests/goldens/golden_{case}.tsv")
    say("goldens", f"{len(cases)} align goldens byte-identical on cuda "
        f"({len(cases) - len(MONO_GOLDENS)} group path, {len(MONO_GOLDENS)} mono path)")


def drive(label: str, args, n: int, kernels, lo: float = 0.3):
    """One main-path run: zero every kernel's launch count, run `align` on
    cuda, read the counts. Fails unless each kernel of the path launched and
    the pass rate (TSV rows per read or pair) lies in (lo, 1]. Returns
    (wall s, rows, counts)."""
    from nimble_tpu_torch.align import kernels as K

    wrappers = {"kmer_keys": K.kmer_keys, "mono_probe": K.mono_probe,
                "band_tree_expand": K.band_tree_expand}
    for w in wrappers.values():
        w.launches = 0
    out = args[args.index("--output") + 1]
    log = os.environ["NIMBLE_TPU_RUNLOG"]
    seen = os.path.getsize(log) if os.path.exists(log) else 0
    t0 = time.perf_counter()
    cli(["align", *args, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(log) as f:
        f.seek(seen)
        stages = [json.loads(ln) for ln in f if ln.strip()]
    setup = {e["stage"]: e["wall_s"] for e in stages if e["event"] == "stage_end"}
    t_setup = setup.get("index_build", 0.0) + setup.get("engine_build", 0.0)
    counts = {name: w.launches for name, w in wrappers.items()}
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: the path never launched the {name} kernel")
    rows = tsv_rows(out)
    if not lo < rows / n <= 1.0:
        raise AssertionError(f"{label}: pass rate {rows / n:.4f} outside ({lo}, 1]")
    say("main", f"{label}: {n} in {wall:.2f} s wall, {n / wall:,.0f}/s, pass rate {rows / n:.4f}, "
        f"launches {counts}; set-up {t_setup:.2f} s (index load {setup.get('index_build', 0.0):.2f}, "
        f"engine build {setup.get('engine_build', 0.0):.2f}), after it {n / max(wall - t_setup, 1e-9):,.0f}/s")
    return wall, rows, counts


def phase_main_path(work: str, name: str, lib: str, fq: str):
    """The group path at real size: single-end gz FASTQ, then tagged BAM
    pairs -> report. Returns the BAM path and the launch counts."""
    cores = str(os.cpu_count() or 1)
    say("main", f"group path on {name}, -c {cores}")
    _, _, se = drive("group single-end reads", ["--reference", lib, "--output", os.path.join(work, "se", "out.tsv"),
                                                 "--input", fq, "-c", cores], N_READS, ["kmer_keys"])

    pe = os.path.join(work, "pe")
    run([sys.executable, "scripts/make_paired_bench.py", pe, str(N_PAIRS)])
    bam = os.path.join(pe, "tagged.bam")
    t0 = time.perf_counter()
    cli(["fastq-to-bam", "--r1-fastq", os.path.join(pe, f"paired_r1_{N_PAIRS}.fastq.gz"),
         "--r2-fastq", os.path.join(pe, f"paired_r2_{N_PAIRS}.fastq.gz"),
         "--map", os.path.join(pe, "whitelist.txt"), "--output", bam, "-c", cores])
    say("main", f"fastq-to-bam {N_PAIRS} pairs: {time.perf_counter() - t0:.2f} s")
    pout = os.path.join(pe, "out.tsv")
    _, _, pe_counts = drive("group BAM pairs", ["--reference", lib, "--output", pout, "--input", bam,
                                                "-c", cores], N_PAIRS, ["kmer_keys"])
    counts = os.path.join(pe, "counts.tsv")
    t0 = time.perf_counter()
    cli(["report", "-i", pout, "-o", counts])
    if os.path.getsize(counts) == 0:
        raise AssertionError("report wrote an empty count matrix for barcoded pairs")
    say("main", f"report {time.perf_counter() - t0:.2f} s")
    return bam, {k: se[k] + pe_counts[k] for k in se}


def phase_mono_data(work: str, lib: str):
    """The mono path's workloads: the HLA-100 mono index (`index --probe
    mono`), and HLA-100 with num_mismatches = 1 (a copy of hla100.json with
    that Config field changed) with 524,288 reads of the same generator."""
    t0 = time.perf_counter()
    cli(["index", "--reference", lib, "--probe", "mono"])
    say("data", f"HLA-100 mono index built in {time.perf_counter() - t0:.2f} s")
    nm1 = os.path.join(work, "nm1")
    run([sys.executable, "scripts/make_bench_fastq.py", nm1, str(N_NM1_READS)])
    with open(os.path.join(nm1, "hla100.json")) as f:
        config, data = json.load(f)
    config["num_mismatches"] = 1
    nm1_lib = os.path.join(nm1, "hla100_nm1.json")
    with open(nm1_lib, "w") as f:
        json.dump([config, data], f)
    t0 = time.perf_counter()
    cli(["index", "--reference", nm1_lib])
    say("data", f"HLA-100 num_mismatches=1 index built in {time.perf_counter() - t0:.2f} s")
    return nm1_lib, os.path.join(nm1, f"reads_{N_NM1_READS}.fastq.gz")


def mono_engine(lib: str, group_g):
    """The engine that `align` builds for this library and 100 bp reads
    (single-end), on the mono path."""
    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    r = make_runner(lib, os.devnull, group_g=group_g)
    eng = AlignEngine(r.index, r.config, torch.device("cuda"), chunk_size=None,
                      max_len=_round_len(READ_LEN), paired=False)
    if "mono_bucket" not in eng.tables or eng.params.group_g != 0:
        raise AssertionError(f"{lib}: the engine did not take the mono path ({sorted(eng.tables)})")
    return eng


def fastq_head(fq: str, B: int, L: int):
    """The first B reads of a gz FASTQ as host (codes, lens), width L."""
    import gzip

    from nimble_tpu import seq as seqmod

    seqs = []
    with gzip.open(fq, "rt") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                seqs.append(line.strip())
                if len(seqs) == B:
                    break
    return seqmod.encode_batch(seqs, max_len=L)


def fastq_codes(fq: str, B: int, L: int, seed: int):
    """The first B reads of a FASTQ as (codes, lens) on the card, with 1% of
    bases set to N and some reads cut short (under k and under L)."""
    codes, lens = fastq_head(fq, B, L)
    rng = np.random.default_rng(seed)
    codes[rng.random(codes.shape) < 0.01] = 4
    cut = rng.random(lens.shape[0]) < 0.05
    lens[cut] = rng.integers(1, lens.max() + 1, size=int(cut.sum()))
    dev = torch.device("cuda")
    return torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)


def _full_stash(bucket, stash, planes, W: int):
    """A copy of a mono table with bucket slots that the given windows probe
    moved into the stash until it holds MONO_MAX_STASH rows: the same key
    set, so the probe's answers must not change, and the sweep meets keys
    that the reads really have."""
    from nimble_tpu_torch.align import kernels as K

    h1, hi, lo, _fc, _pal, valid = (a.cpu().numpy() for a in planes)
    t = bucket.cpu().numpy().copy()
    S = t.shape[1] // (2 + 2 * W)
    rows = h1[valid]
    keys = set()
    moved = []
    for b, qh, ql in zip(rows, hi[valid], lo[valid]):
        for s in range(S):
            if t[b, s] == qh and t[b, S + s] == ql and (qh, ql) not in keys:
                keys.add((qh, ql))
                moved.append(np.concatenate([[qh, ql], t[b, 2 * S + np.arange(2 * W) * S + s]]))
                t[b, s] = -1
                t[b, S + s] = 0
                t[b, 2 * S + np.arange(2 * W) * S + s] = 0
        if stash.shape[0] + len(moved) >= K.MONO_MAX_STASH:
            break
    new_stash = np.concatenate([stash.cpu().numpy(), np.array(moved, dtype=np.int32)])
    dev = bucket.device
    return torch.from_numpy(t).to(dev), torch.from_numpy(new_stash).to(dev)


def w16_case(B: int, L: int):
    """A 500-feature library (W = 16 words, the widest the mono path takes):
    its mono tables on the card and B reads drawn from it."""
    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Config, Data
    from nimble_tpu.index.builder import build_index
    from nimble_tpu_torch.align.tables import device_tables

    rng = np.random.default_rng(16)
    backbone = rng.integers(0, 4, size=1500).astype(np.int8)
    data = Data()
    alleles = []
    for i in range(500):
        a = backbone.copy()
        pos = rng.integers(0, a.shape[0], size=20)
        a[pos] = rng.integers(0, 4, size=20)
        alleles.append(a)
        for col, v in zip(data.columns, ("w16", f"allele{i}", "1500", seqmod.decode(a))):
            col.append(v)
    index = build_index(data, Config(), group_g=0)
    if index.bitset_words != 16:
        raise AssertionError(f"the 500-feature library has W = {index.bitset_words}, not 16")
    tables = device_tables(index, torch.device("cuda"))
    src = rng.integers(0, 500, size=B)
    st = rng.integers(0, 1500 - L + 1, size=B)
    codes = np.stack(alleles)[src[:, None], st[:, None] + np.arange(L)[None, :]].astype(np.int8)
    rc = rng.random(B) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    lens = np.full(B, L, dtype=np.int32)
    dev = torch.device("cuda")
    return index.k, tables, torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)


def synthetic_planes(B: int, P: int, W: int, S: int, n_stash: int, seed: int):
    """A mono table with unique random keys, half of the queried keys in
    their buckets and some in the stash, and random fwd_canon / palindrome /
    valid flags: every orientation case, including palindromes (which odd
    k never makes) and S != 4 (the kernel's scalar key loads)."""
    rng = np.random.default_rng(seed)
    nb2, E = 1 << 12, 2 + 2 * W
    hi = rng.integers(0, 1 << 30, size=B * P).astype(np.int32)
    lo = np.arange(B * P, dtype=np.int32)
    h1 = rng.integers(0, nb2, size=B * P).astype(np.int32)
    bucket = rng.integers(-(1 << 31), 1 << 31, size=(nb2, S * E), dtype=np.int64).astype(np.int32)
    bucket[:, :S] = -1
    for i in range(0, B * P, 2):
        bucket[h1[i], i % S] = hi[i]
        bucket[h1[i], S + i % S] = lo[i]
    stash = rng.integers(-(1 << 31), 1 << 31, size=(n_stash, E), dtype=np.int64).astype(np.int32)
    stash[:, 0], stash[:, 1] = hi[1 : 2 * n_stash : 2], lo[1 : 2 * n_stash : 2]
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a.reshape(B, P) if a.ndim == 1 else a).to(dev)
    flags = [t(rng.random(B * P) < f) for f in (0.5, 0.2, 0.8)]
    return t(bucket), t(stash), (t(h1), t(hi), t(lo), *flags)


def check_mono(label: str, bucket, stash, W: int, codes=None, lens=None, k: int = 0, planes=None):
    """mono_probe == mono_probe_reference, exactly, on both outputs, for the
    windows of these reads hashed into this table (or for the given key
    planes). Returns the planes and the max |diff|."""
    from nimble_tpu_torch.align import kernels as K

    if planes is None:
        hi, lo, h1, _h2, fc, pal, valid = K.kmer_keys(codes, lens, k, bucket.shape[0])
        planes = (h1, hi, lo, fc, pal, valid)
    hi = planes[1]
    got = K.mono_probe(bucket, *planes, stash, W)
    want = K.mono_probe_reference(bucket, *planes, stash, W)
    torch.cuda.synchronize()
    max_err = 0
    for nm, a, b in zip(("bits_f", "bits_r"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"mono_probe {nm} {a.dtype}{tuple(a.shape)} != plain {b.dtype}{tuple(b.shape)}")
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if err or not torch.equal(a, b):
            raise AssertionError(f"mono_probe != plain version on {nm} at {label} (max |diff| {err})")
    hit = float((got[0] != 0).any(dim=-1).float().mean())
    B, P = hi.shape
    say("kernel", f"mono_probe {label}: B={B} P={P} W={W} S={bucket.shape[1] // (2 + 2 * W)} "
        f"nb2={bucket.shape[0]} stash={stash.shape[0]}: both outputs equal the plain version "
        f"(windows hit {hit:.3f})")
    return planes, max_err


def phase_mono_kernel(lib: str, fq: str, nm1_lib: str, nm1_fq: str):
    """mono_probe against its plain version at the mono path's arguments
    and edge cases; timed at the main-path shape and at the large table."""
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align.tables import table_words

    eng = mono_engine(lib, group_g=0)
    B, L, k = eng.chunk_size, eng.max_len, eng.params.k
    bucket, stash = eng.tables["mono_bucket"], eng.tables["mono_stash"]
    W = table_words(eng.tables)
    say("kernel", f"mono main-path arguments (align --probe mono, HLA-100): B={B} L={L} k={k} "
        f"P={L - k + 1} W={W} S={bucket.shape[1] // (2 + 2 * W)} nb2={bucket.shape[0]} stash={stash.shape[0]}")
    codes, lens = fastq_codes(fq, B, L, seed=1)
    planes, max_err = check_mono("main path", bucket, stash, W, codes, lens, k)
    ms = cuda_ms(lambda: K.mono_probe(bucket, *planes, stash, W))
    plain_ms = cuda_ms(lambda: K.mono_probe_reference(bucket, *planes, stash, W))
    say("kernel", f"mono_probe main path: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)")

    full_bucket, full_stash = _full_stash(bucket, stash, planes, W)
    if full_stash.shape[0] != K.MONO_MAX_STASH:
        raise AssertionError(f"the full-stash table holds {full_stash.shape[0]} stash rows")
    errs = [max_err]
    errs.append(check_mono("full 64-row stash", full_bucket, full_stash, W, codes, lens, k)[1])
    errs.append(check_mono("B=4099 (B*P not a multiple of 256)", bucket, stash, W,
                           codes[:4099].contiguous(), lens[:4099].contiguous(), k)[1])
    wk, wt, wc, wl = w16_case(4099, L)
    errs.append(check_mono("W=16 library", wt["mono_bucket"], wt["mono_stash"], table_words(wt), wc, wl, wk)[1])
    for sW, sS, n_stash in ((4, 4, 64), (5, 2, 7), (16, 3, 1)):
        sb, ss, sp = synthetic_planes(1001, 37, sW, sS, n_stash, seed=sW)
        errs.append(check_mono(f"synthetic keys and flags (palindromes, S={sS})", sb, ss, sW, planes=sp)[1])
    del eng, full_bucket, full_stash, wt

    t0 = time.perf_counter()
    eng = mono_engine(nm1_lib, group_g=None)  # num_mismatches = 1: no group entries
    nb, ns = eng.tables["mono_bucket"], eng.tables["mono_stash"]
    torch.cuda.synchronize()
    nW = table_words(eng.tables)
    say("kernel", f"num_mismatches=1 table: {tuple(nb.shape)} int32 = {nb.numel() * 4 / 1e9:.2f} GB, "
        f"stash {ns.shape[0]}; index load + table build + copy to the card {time.perf_counter() - t0:.2f} s")
    codes, lens = fastq_codes(nm1_fq, eng.chunk_size, eng.max_len, seed=2)
    planes, err = check_mono("num_mismatches=1", nb, ns, nW, codes, lens, eng.params.k)
    errs.append(err)
    big_ms = cuda_ms(lambda: K.mono_probe(nb, *planes, ns, nW))
    big_plain = cuda_ms(lambda: K.mono_probe_reference(nb, *planes, ns, nW))
    say("kernel", f"mono_probe num_mismatches=1 table: kernel {big_ms:.4f} ms, plain {big_plain:.4f} ms (median of 25)")
    del eng, nb, ns, planes
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms


def phase_mono_main(work: str, lib: str, fq: str, bam: str, nm1_lib: str, nm1_fq: str):
    """The mono path at real size. Returns the summed launch counts."""
    cores = str(os.cpu_count() or 1)
    both = ["kmer_keys", "mono_probe"]
    runs = [
        drive("mono single-end reads (--probe mono)",
              ["--reference", lib, "--output", os.path.join(work, "se", "out_mono.tsv"),
               "--input", fq, "-c", cores, *MONO], N_READS, both),
        drive("mono BAM pairs (--probe mono)",
              ["--reference", lib, "--output", os.path.join(work, "pe", "out_mono.tsv"),
               "--input", bam, "-c", cores, *MONO], N_PAIRS, both),
        drive("num_mismatches=1 single-end reads",
              ["--reference", nm1_lib, "--output", os.path.join(work, "nm1", "out.tsv"),
               "--input", nm1_fq, "-c", cores], N_NM1_READS, both, lo=0.05),
    ]
    return {k: sum(r[2][k] for r in runs) for k in both}


def phase_cuda_vs_cpu(work: str):
    d = os.path.join(work, "cmp")
    run([sys.executable, "scripts/make_bench_fastq.py", d, str(N_CMP_READS)])
    lib = os.path.join(d, "hla100.json")
    fq = os.path.join(d, f"reads_{N_CMP_READS}.fastq.gz")
    for probe, flags in (("group", []), ("mono", MONO)):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = os.path.join(d, f"out_{probe}_{dev}.tsv")
            t0 = time.perf_counter()
            cli(["align", "--reference", lib, "--output", outs[dev], "--input", fq, *flags, "--device", dev])
            say("cmp", f"align --probe {probe} --device {dev}: {time.perf_counter() - t0:.2f} s")
        with open(outs["cuda"], "rb") as a, open(outs["cpu"], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"align --probe {probe}: --device cuda and --device cpu TSVs differ")
        say("cmp", f"{N_CMP_READS} reads, --probe {probe}: cuda and cpu TSVs byte-identical "
            f"({tsv_rows(outs['cuda'])} rows)")


def wide_library(d: str):
    """scripts/bigindex.py:build_library's 20k-allele library, with its seed
    and draws (the alleles of scripts/make_big20k_cli.py too), written as a
    [Config, Data] JSON. Returns (path, alleles (20,000, 3,000) int8)."""
    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Config, Data

    rng = np.random.default_rng(0)
    data = Data()
    alleles = np.empty((WIDE_FAMILIES * WIDE_ALLELES, WIDE_LEN), dtype=np.int8)
    for fam in range(WIDE_FAMILIES):
        bb = rng.integers(0, 4, size=WIDE_LEN).astype(np.int8)
        for a in range(WIDE_ALLELES):
            s = bb.copy()
            pos = rng.integers(0, WIDE_LEN, size=WIDE_SNPS)
            s[pos] = rng.integers(0, 4, size=WIDE_SNPS).astype(np.int8)
            alleles[fam * WIDE_ALLELES + a] = s
            for col, v in zip(data.columns, ("hla_kir_20k", f"F{fam:02d}*{a:04d}", str(WIDE_LEN),
                                             seqmod.decode(s))):
                col.append(v)
    lib = os.path.join(d, "big20k.json")
    with open(lib, "w") as f:
        json.dump([Config().to_dict(), data.__dict__], f)
    return lib, alleles


def _allele_reads(rng, alleles, src, start):
    """READ_LEN bases of allele `src` from `start`, with WIDE_ERROR
    substitutions."""
    codes = alleles[src[:, None], start[:, None] + np.arange(READ_LEN)[None, :]]
    err = rng.random(codes.shape) < WIDE_ERROR
    return np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)


def _fastq_records(codes, prefix: bytes, first: int, suffix: bytes = b"") -> bytes:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = b"I" * codes.shape[1]
    return b"".join(b"@%s%d%s\n%s\n+\n%s\n" % (prefix, first + i, suffix, r.tobytes(), qual)
                    for i, r in enumerate(lut[codes]))


def phase_wide_data(work: str):
    """The gband path's workload: the 20k-allele library and its index; gz
    FASTQs of N_WIDE_READS single-end reads from random alleles (half
    reverse-complemented), of their first N_WIDE_CMP, and of N_WIDE_PAIRS
    pairs whose mates come from one 200-400 bp fragment of one allele."""
    import gzip

    from nimble_tpu import seq as seqmod

    d = os.path.join(work, "wide")
    os.makedirs(d)
    t0 = time.perf_counter()
    lib, alleles = wide_library(d)
    n_al = alleles.shape[0]
    rng = np.random.default_rng(7)
    block = 1 << 17
    fq = os.path.join(d, f"reads20k_{N_WIDE_READS}.fastq.gz")
    cmp_fq = os.path.join(d, f"reads20k_{N_WIDE_CMP}.fastq.gz")
    with gzip.open(fq, "wb", compresslevel=1) as f:
        for s0 in range(0, N_WIDE_READS, block):
            n = min(block, N_WIDE_READS - s0)
            codes = _allele_reads(rng, alleles, rng.integers(0, n_al, size=n),
                                  rng.integers(0, WIDE_LEN - READ_LEN + 1, size=n))
            rc = rng.random(n) < 0.5
            codes[rc] = seqmod.revcomp_codes(codes[rc])
            f.write(_fastq_records(codes, b"r", s0))
            if s0 == 0:
                with gzip.open(cmp_fq, "wb", compresslevel=1) as g:
                    g.write(_fastq_records(codes[:N_WIDE_CMP], b"r", 0))
    r1 = os.path.join(d, f"pairs20k_r1_{N_WIDE_PAIRS}.fastq.gz")
    r2 = os.path.join(d, f"pairs20k_r2_{N_WIDE_PAIRS}.fastq.gz")
    with gzip.open(r1, "wb", compresslevel=1) as f1, gzip.open(r2, "wb", compresslevel=1) as f2:
        for s0 in range(0, N_WIDE_PAIRS, block):
            n = min(block, N_WIDE_PAIRS - s0)
            src = rng.integers(0, n_al, size=n)
            frag = rng.integers(200, 401, size=n)
            st = (rng.random(n) * (WIDE_LEN - frag + 1)).astype(np.int64)
            head = _allele_reads(rng, alleles, src, st)
            tail = seqmod.revcomp_codes(_allele_reads(rng, alleles, src, st + frag - READ_LEN))
            flip = (rng.random(n) < 0.5)[:, None]  # fragments of either strand
            f1.write(_fastq_records(np.where(flip, tail, head), b"p", s0, b"/1"))
            f2.write(_fastq_records(np.where(flip, head, tail), b"p", s0, b"/2"))
    say("data", f"generated the 20k-allele library ({n_al} alleles x {WIDE_LEN} bp), {N_WIDE_READS} reads "
        f"and {N_WIDE_PAIRS} pairs in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["index", "--reference", lib])
    say("data", f"20k index built (C++ builder) and saved in {time.perf_counter() - t0:.2f} s")
    return lib, fq, cmp_fq, r1, r2


def check_band(label: str, table, idx_sel, has_sel, W: int, Pw: int):
    """band_tree_expand == band_tree_expand_reference, exactly. Returns
    (max |diff|, the kernel's output)."""
    from nimble_tpu_torch.align import kernels as K

    got = K.band_tree_expand(table, idx_sel, has_sel, W, Pw)
    want = K.band_tree_expand_reference(table, idx_sel, has_sel, W, Pw)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"band_tree_expand {got.dtype}{tuple(got.shape)} != plain "
                             f"{want.dtype}{tuple(want.shape)} at {label}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got, want):
        raise AssertionError(f"band_tree_expand != plain version at {label} (max |diff| {err})")
    B, Q1 = idx_sel.shape
    say("kernel", f"band_tree_expand {label}: B={B} Q1={Q1} W={W} Pw={Pw} rows={table.shape[0]}: equals "
        f"the plain version (positions with a row {float(has_sel.float().mean()):.3f}, reads with bits "
        f"{float((got != 0).any(dim=1).float().mean()):.3f})")
    return err, got


def band_case(B: int, W: int, Pw: int, Q1: int, seed: int, miss: int = 3, n_rows: int = 4096):
    """A band table on the card (dense random bands, 2% zero, every page
    present) and per-read positions near one page: at it or one page up,
    2% two pages up (an empty AND), 30% without a row (index -1 or
    past the table's end, which the gather clamps), the first `miss` reads
    without any. Returns (table, idx_sel, has_sel)."""
    rng = np.random.default_rng(seed)
    n_pages = -(-W // Pw)
    page = np.sort(np.arange(n_rows) % n_pages).astype(np.int32)
    band = np.bitwise_or.reduce(
        rng.integers(-(1 << 31), 1 << 31, size=(4, n_rows, 2 * Pw), dtype=np.int64), axis=0).astype(np.int32)
    band[rng.random(n_rows) < 0.02] = 0
    start = np.searchsorted(page, np.arange(n_pages))
    count = np.searchsorted(page, np.arange(n_pages), side="right") - start
    base = rng.integers(0, n_pages, size=(B, 1))
    up = (rng.random((B, Q1)) < 0.3).astype(np.int64) + 2 * (rng.random((B, Q1)) < 0.02)
    pg = np.minimum(base + up, n_pages - 1)
    idx = start[pg] + (rng.random((B, Q1)) * count[pg]).astype(np.int64)
    has = rng.random((B, Q1)) < 0.7
    has[:miss] = False
    idx = np.where(has, idx, np.where(rng.random((B, Q1)) < 0.5, -1, n_rows + 7)).astype(np.int32)
    dev = torch.device("cuda")
    table = np.concatenate([page[:, None], band], axis=1)
    return tuple(torch.from_numpy(a).to(dev) for a in (table, idx, has))


BAND_CASES = [
    # label, B, W, Pw, Q1, reads without a row
    ("B=4099 (not a multiple of the 8-read block)", 4099, 625, 32, 16, 3),
    ("(W, Pw, Q1) = (100, 16, 7)", 4096, 100, 16, 7, 3),
    ("(W, Pw, Q1) = (70, 8, 5)", 4096, 70, 8, 5, 3),
    ("Pw=24 (W not a multiple of Pw)", 4096, 625, 24, 16, 3),
    ("Q1=40 (256 bp reads)", 4096, 625, 32, 40, 3),
    ("all-miss reads", 1000, 625, 32, 16, 1000),
]


def phase_wide_kernel(lib: str, fq: str):
    """The engine `align` builds for the 20k library, timed by part, then
    band_tree_expand against its plain version on the (idx_sel, has_sel)
    its gband step passes for the first chunk of real reads, and on the
    synthetic cases; timed at the main-path shape."""
    from nimble_tpu.index.builder import KmerIndex
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    r = make_runner(lib, os.devnull)
    t_load = time.perf_counter() - t0
    index = r.index
    t0 = time.perf_counter()
    host = TT.groupband_tables(index)
    t_build = time.perf_counter() - t0
    side = TT.gband_sidecar_path(index)
    if host is None or not side or not os.path.exists(side):
        raise AssertionError(f"the 20k library built no gband tables or no sidecar ({side})")
    t0 = time.perf_counter()
    eng = TE.AlignEngine(index, r.config, dev, chunk_size=None, max_len=_round_len(READ_LEN))
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    if "gband_bucket" not in eng.tables or eng.wire != "idlist":
        raise AssertionError(f"the 20k engine is not on the gband idlist path ({sorted(eng.tables)}, {eng.wire})")
    t0 = time.perf_counter()
    fresh = KmerIndex.load(index._cache_path)
    t_reload = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = TT.groupband_tables(fresh)
    t_side = time.perf_counter() - t0
    for k in ("gband_bucket", "gband_table"):
        if not np.array_equal(again[k], host[k]):
            raise AssertionError(f"the sidecar's {k} differs from the fresh build")
    table = eng.tables["gband_table"]
    bucket = eng.tables["gband_bucket"]
    W, Pw = TT.table_words(eng.tables), eng.band_pw
    say("wide", f"W={W} Pw={Pw} g={index.pair_g} features={index.n_features} classes={index.n_classes} "
        f"group entries={index.pair_hi.shape[0]}; gband_bucket {tuple(bucket.shape)} = "
        f"{bucket.numel() * 4 / 1e9:.2f} GB, gband_table {tuple(table.shape)} = {table.numel() * 4 / 1e6:.1f} MB, "
        f"stash {eng.tables['gband_stash_hi'].shape[0]}; sidecar {os.path.getsize(side) / 1e9:.2f} GB")
    say("wide", f"engine build by part: index load {t_load:.2f} s (again: {t_reload:.2f} s), gband host "
        f"build + sidecar write {t_build:.2f} s, sidecar load {t_side:.2f} s, tables to the card {t_h2d:.2f} s")
    del again, host, fresh

    errs = []
    # the CLI's read width (100 bp reads round up to L = 112), then the
    # reference bench's L = 100 (scripts/bigindex.py: B = 65,536, Q1 = 14)
    for max_len in (_round_len(READ_LEN), READ_LEN):
        if eng is None:
            eng = TE.AlignEngine(index, r.config, dev, chunk_size=None, max_len=max_len)
        B, L = eng.chunk_size, eng.max_len
        codes, lens = fastq_head(fq, B, L)
        seen = []
        orig = TE.band_tree_expand

        def capture(tbl, idx_sel, has_sel, w, pw):
            seen.append((idx_sel.clone(), has_sel.clone()))
            return orig(tbl, idx_sel, has_sel, w, pw)

        TE.band_tree_expand = capture
        try:
            eng.align_batch(codes, lens)
        finally:
            TE.band_tree_expand = orig
        idx_sel, has_sel = seen[0]
        label = "main path" if max_len != READ_LEN else "L=100 (the reference bench's width)"
        say("kernel", f"band_tree_expand {label} arguments (20k library): B={B} L={L} "
            f"Q1={idx_sel.shape[1]} W={W} Pw={Pw}")
        errs.append(check_band(label, table, idx_sel, has_sel, W, Pw)[0])
        t_ms = cuda_ms(lambda: K.band_tree_expand(table, idx_sel, has_sel, W, Pw))
        t_plain = cuda_ms(lambda: K.band_tree_expand_reference(table, idx_sel, has_sel, W, Pw))
        say("kernel", f"band_tree_expand {label}: kernel {t_ms:.4f} ms ({B * W * 4 / (t_ms * 1e-3) / 1e9:.1f} "
            f"GB/s of outputs), plain {t_plain:.4f} ms (median of 25)")
        if max_len != READ_LEN:
            ms, plain_ms = t_ms, t_plain
        eng = None
        del seen, idx_sel, has_sel
    del r, index, table, bucket
    for i, (label, sB, sW, sPw, sQ1, miss) in enumerate(BAND_CASES):
        t, ix, hs = band_case(sB, sW, sPw, sQ1, seed=i, miss=miss)
        err, got = check_band(label, t, ix, hs, sW, sPw)
        if got[:miss].any():
            raise AssertionError(f"band_tree_expand {label}: reads without a row have bits")
        errs.append(err)
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms


def phase_wide_main(work: str, lib: str, fq: str, r1: str, r2: str):
    """The gband path at real size. Returns the summed launch counts."""
    cores = str(os.cpu_count() or 1)
    d = os.path.join(work, "wide")
    runs = [
        drive("gband single-end reads (20k library)",
              ["--reference", lib, "--output", os.path.join(d, "out_se.tsv"), "--input", fq, "-c", cores],
              N_WIDE_READS, WIDE_KERNELS, lo=0.1),
        drive("gband pairs (20k library, two FASTQs)",
              ["--reference", lib, "--output", os.path.join(d, "out_pe.tsv"), "--input", r1, r2, "-c", cores],
              N_WIDE_PAIRS, WIDE_KERNELS, lo=0.1),
    ]
    return {k: sum(r[2][k] for r in runs) for k in WIDE_KERNELS}


def phase_wide_cmp(work: str, lib: str, cmp_fq: str):
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(work, "wide", f"out_cmp_{dev}.tsv")
        t0 = time.perf_counter()
        cli(["align", "--reference", lib, "--output", outs[dev], "--input", cmp_fq, "--device", dev])
        say("cmp", f"align (20k library, gband) --device {dev}: {time.perf_counter() - t0:.2f} s")
    with open(outs["cuda"], "rb") as a, open(outs["cpu"], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("align on the 20k library: --device cuda and --device cpu TSVs differ")
    say("cmp", f"{N_WIDE_CMP} reads, 20k library: cuda and cpu TSVs byte-identical ({tsv_rows(outs['cuda'])} rows)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import nimble_tpu_torch  # noqa: F401  (raises outside a checkout of the repo)

    t_start = time.perf_counter()
    name, _smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="nimble_smoke_") as work:
        # the pipeline's stage log (index and engine build walls) for drive()
        os.environ["NIMBLE_TPU_RUNLOG"] = os.path.join(work, "runlog.jsonl")
        lib, fq = phase_data(work)
        kk_err, kk_ms, kk_plain = phase_kernel(main_path_shape(lib))
        phase_goldens(work)
        bam, group_counts = phase_main_path(work, name, lib, fq)
        nm1_lib, nm1_fq = phase_mono_data(work, lib)
        mp_err, mp_ms, mp_plain = phase_mono_kernel(lib, fq, nm1_lib, nm1_fq)
        mono_counts = phase_mono_main(work, lib, fq, bam, nm1_lib, nm1_fq)
        phase_cuda_vs_cpu(work)
        wlib, wfq, wcmp, wr1, wr2 = phase_wide_data(work)
        bt_err, bt_ms, bt_plain = phase_wide_kernel(wlib, wfq)
        wide_counts = phase_wide_main(work, wlib, wfq, wr1, wr2)
        phase_wide_cmp(work, wlib, wcmp)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "kmer_keys",
            "route": "cuda",
            "source": "nimble_tpu_torch/csrc/kmer_keys.cu",
            "replaces": "nimble_tpu/align/kernels.py:157",
            "launches": group_counts["kmer_keys"] + mono_counts["kmer_keys"] + wide_counts["kmer_keys"],
            "max_abs_err": kk_err,
            "ms": kk_ms,
            "plain_ms": kk_plain,
        },
        {
            "name": "mono_probe",
            "route": "cuda",
            "source": "nimble_tpu_torch/csrc/mono_probe.cu",
            "replaces": "nimble_tpu/align/kernels.py:273",
            "launches": mono_counts["mono_probe"],
            "max_abs_err": mp_err,
            "ms": mp_ms,
            "plain_ms": mp_plain,
        },
        {
            "name": "band_tree_expand",
            "route": "cuda",
            "source": "nimble_tpu_torch/csrc/band_tree_expand.cu",
            "replaces": "nimble_tpu/align/kernels.py:394",
            "launches": wide_counts["band_tree_expand"],
            "max_abs_err": bt_err,
            "ms": bt_ms,
            "plain_ms": bt_plain,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
