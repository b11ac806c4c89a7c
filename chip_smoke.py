#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nimble_tpu_torch).

Drives the port's main path — `align` on the default group probe against a
narrow library — on one CUDA card, after building and checking its kernel:

  1. device: card, power limit, torch/CUDA versions; the native host IO
     library (native/), built with the first compiler that can;
  2. kernel build: nvcc of nimble_tpu_torch/csrc/*.cu;
  3. kmer_keys kernel == its torch twin on all 7 planes, exactly, at the
     arguments the main path passes it (read from the engine that `align`
     builds for the HLA-100 workload) and at edge shapes; both timed with
     CUDA events;
  4. the 15 group-path goldens of tests/goldens/, byte-identical on cuda;
  5. the main path at real size: HLA-100 library, 2,097,152 single-end
     100 bp reads (scripts/make_bench_fastq.py), then 262,144 10x-shaped
     pairs through fastq-to-bam -> align -> report;
  6. the same 65,536 reads through `align --device cuda` and `--device cpu`
     give byte-identical TSVs.

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
SKIP_GOLDENS = {"legacy_filters", "probe_mono", "mismatch1", "mismatch2"}
FLAG_CASES = {
    "probe_mono": ["--probe", "mono"],
    "strand_fiveprime": ["--strand_filter", "fiveprime"],
}
SINGLE_END_CASES = {"strand_fiveprime"}

READ_LEN = 100  # scripts/make_bench_fastq.py's read length
N_READS = 2_097_152
N_PAIRS = 262_144
N_CMP_READS = 65_536


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
    say("build", f"kmer_keys library built in {time.perf_counter() - t0:.2f} s: {path}")


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
    if len(cases) != 15:
        raise AssertionError(f"expected 15 group-path goldens, found {len(cases)}")
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
    say("goldens", f"{len(cases)} group-path goldens byte-identical on cuda")


def phase_main_path(work: str, name: str, lib: str, fq: str):
    from nimble_tpu_torch.align import kernels as K

    cores = os.cpu_count() or 1
    out = os.path.join(work, "se", "out.tsv")
    K.kmer_keys.launches = 0
    t0 = time.perf_counter()
    cli(["align", "--reference", lib, "--output", out, "--input", fq,
         "-c", str(cores), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.kmer_keys.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the kmer_keys kernel")
    rows = tsv_rows(out)
    rate = rows / N_READS
    if not 0.3 < rate <= 1.0:
        raise AssertionError(f"pass rate {rate:.4f} outside (0.3, 1] on 1%-error reads drawn from the library")
    say("main", f"align {N_READS} single-end reads on {name}: {wall:.2f} s wall, "
        f"{N_READS / wall:,.0f} reads/s, pass rate {rate:.4f}, kmer_keys launches {launches}, -c {cores}")

    pe = os.path.join(work, "pe")
    run([sys.executable, "scripts/make_paired_bench.py", pe, str(N_PAIRS)])
    bam = os.path.join(pe, "tagged.bam")
    t0 = time.perf_counter()
    cli(["fastq-to-bam", "--r1-fastq", os.path.join(pe, f"paired_r1_{N_PAIRS}.fastq.gz"),
         "--r2-fastq", os.path.join(pe, f"paired_r2_{N_PAIRS}.fastq.gz"),
         "--map", os.path.join(pe, "whitelist.txt"), "--output", bam, "-c", str(cores)])
    f2b = time.perf_counter() - t0
    pout = os.path.join(pe, "out.tsv")
    t0 = time.perf_counter()
    cli(["align", "--reference", lib, "--output", pout, "--input", bam,
         "-c", str(cores), "--device", "cuda"])
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    prows = tsv_rows(pout)
    if not 0.3 < prows / N_PAIRS <= 1.0:
        raise AssertionError(f"paired pass rate {prows / N_PAIRS:.4f} outside (0.3, 1]")
    counts = os.path.join(pe, "counts.tsv")
    t0 = time.perf_counter()
    cli(["report", "-i", pout, "-o", counts])
    rep = time.perf_counter() - t0
    if os.path.getsize(counts) == 0:
        raise AssertionError("report wrote an empty count matrix for barcoded pairs")
    say("main", f"paired: fastq-to-bam {f2b:.2f} s, align {N_PAIRS} pairs {pwall:.2f} s "
        f"({N_PAIRS / pwall:,.0f} pairs/s, pass rate {prows / N_PAIRS:.4f}), report {rep:.2f} s")
    return launches


def phase_cuda_vs_cpu(work: str):
    d = os.path.join(work, "cmp")
    run([sys.executable, "scripts/make_bench_fastq.py", d, str(N_CMP_READS)])
    lib = os.path.join(d, "hla100.json")
    fq = os.path.join(d, f"reads_{N_CMP_READS}.fastq.gz")
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(d, f"out_{dev}.tsv")
        t0 = time.perf_counter()
        cli(["align", "--reference", lib, "--output", outs[dev], "--input", fq, "--device", dev])
        say("cmp", f"align --device {dev}: {time.perf_counter() - t0:.2f} s")
    with open(outs["cuda"], "rb") as a, open(outs["cpu"], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("align --device cuda and --device cpu TSVs differ")
    say("cmp", f"{N_CMP_READS} reads: cuda and cpu TSVs byte-identical ({tsv_rows(outs['cuda'])} rows)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import nimble_tpu_torch  # noqa: F401  (raises outside a checkout of the repo)

    name, _smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="nimble_smoke_") as work:
        lib, fq = phase_data(work)
        max_err, ms, plain_ms = phase_kernel(main_path_shape(lib))
        phase_goldens(work)
        launches = phase_main_path(work, name, lib, fq)
        phase_cuda_vs_cpu(work)
    print(json.dumps({"kernels": [{
        "name": "kmer_keys",
        "route": "cuda",
        "source": "nimble_tpu_torch/csrc/kmer_keys.cu",
        "replaces": "nimble_tpu/align/kernels.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
