#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nimble_tpu_torch).

Drives the port's two align paths — `align` on the default group probe and
on the mono probe (`--probe mono`, `num_mismatches` 1) against narrow
libraries — on one CUDA card, after building and checking their kernels:

  1. device: card, power limit, torch/CUDA versions; the native host IO
     library (native/), built with the first compiler that can;
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
     give byte-identical TSVs, on the group probe and on `--probe mono`.

Each main-path run zeroes the kernels' launch counts just before it and
reads them just after; the run fails unless every kernel of its path ran.

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
    how = build_native()
    from nimble_tpu.io import native

    native_ok = native.available()
    if not native_ok:
        how += "; host IO runs the slower python readers and fallbacks, output is unchanged"
    say("device", f"native host IO available: {native_ok} ({how})")
    return name, smi


def build_native() -> str:
    """Build native/libnimble_native.so before the shared loader first looks
    for it. The loader runs `make -C native` with the environment's CXX, which
    may name a compiler without OpenMP support; the Makefile's `CXX ?= g++`
    takes an override, so the system compilers are tried after it."""
    native_dir = os.path.join(REPO, "native")
    if os.path.exists(os.path.join(native_dir, "libnimble_native.so")):
        return "library already present"
    failures = []
    for cxx in (None, "g++", "/usr/bin/g++", "c++"):
        cmd = ["make", "-C", native_dir] + ([f"CXX={cxx}"] if cxx else [])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        label = f"CXX={cxx}" if cxx else f"CXX={os.environ.get('CXX', 'g++')} (environment)"
        if res.returncode == 0:
            return f"built with {label}" + (f" after {len(failures)} failed tries" if failures else "")
        lines = (res.stderr or res.stdout).strip().splitlines()
        err = [ln for ln in lines if "error" in ln.lower()][:1] or lines[-1:]
        failures.append(f"{label}: {' '.join(err)}")
    return "`make -C native` failed: " + " | ".join(failures)


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

    wrappers = {"kmer_keys": K.kmer_keys, "mono_probe": K.mono_probe}
    for w in wrappers.values():
        w.launches = 0
    out = args[args.index("--output") + 1]
    t0 = time.perf_counter()
    cli(["align", *args, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: the path never launched the {name} kernel")
    rows = tsv_rows(out)
    if not lo < rows / n <= 1.0:
        raise AssertionError(f"{label}: pass rate {rows / n:.4f} outside ({lo}, 1]")
    say("main", f"{label}: {n} in {wall:.2f} s wall, {n / wall:,.0f}/s, pass rate {rows / n:.4f}, "
        f"launches {counts}")
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


def fastq_codes(fq: str, B: int, L: int, seed: int):
    """The first B reads of a FASTQ as (codes, lens) on the card, with 1% of
    bases set to N and some reads cut short (under k and under L)."""
    import gzip

    from nimble_tpu import seq as seqmod

    seqs = []
    with gzip.open(fq, "rt") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                seqs.append(line.strip())
                if len(seqs) == B:
                    break
    codes, lens = seqmod.encode_batch(seqs, max_len=L)
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
        lib, fq = phase_data(work)
        kk_err, kk_ms, kk_plain = phase_kernel(main_path_shape(lib))
        phase_goldens(work)
        bam, group_counts = phase_main_path(work, name, lib, fq)
        nm1_lib, nm1_fq = phase_mono_data(work, lib)
        mp_err, mp_ms, mp_plain = phase_mono_kernel(lib, fq, nm1_lib, nm1_fq)
        mono_counts = phase_mono_main(work, lib, fq, bam, nm1_lib, nm1_fq)
        phase_cuda_vs_cpu(work)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "kmer_keys",
            "route": "cuda",
            "source": "nimble_tpu_torch/csrc/kmer_keys.cu",
            "replaces": "nimble_tpu/align/kernels.py:157",
            "launches": group_counts["kmer_keys"] + mono_counts["kmer_keys"],
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
