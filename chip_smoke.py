#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nimble_tpu_torch).

Drives every align path of the port — `align` on the default group probe
and on the mono probe (`--probe mono`, `num_mismatches` 1) against narrow
libraries; on the wide banded group path (gband) against the 20k-allele
HLA/KIR library; on the other wide paths (monocls with class bands or
class bits, groupcls, the wide two-choice probe); and three libraries in
one `align`, one engine each — and every other subcommand and flag
(`index --warm`, `report --device` and `--distributed`, resumes, worlds,
the profiler, `align --mesh` and the coordinated world) on one CUDA card,
after building and checking their kernels:

  1. device: card, power limit, torch/CUDA versions; the native host IO
     library (native/), built with the first compiler that can
     (nimble_tpu_torch/native_build.py, as the port's CLI builds it);
  2. kernel build: nvcc of nimble_tpu_torch/csrc/*.cu, one process per
     source, all started together; each kernel's registers and static
     shared memory as ptxas reports them;
  3. kmer_keys kernel == its plain torch version on all 7 planes, exactly,
     at the arguments the group path passes it (captured from the engine
     that `align` builds for the HLA-100 workload, on the first chunk of its
     reads), on random codes at that shape, at every k in {1, 2, 16, 21,
     26, 31} with L in {k, 40, 100, 112, 150, 301}, and on rows at odd
     addresses; codes outside 0-4 and lens below k included;
  4. the 18 align goldens of tests/goldens/, byte-identical on cuda (15 on
     the group path, 3 on the mono path);
  5. the group path at real size: HLA-100 library, 1,048,576 single-end
     100 bp reads (nimble_tpu_torch/bench_data.py), then 262,144 10x-shaped
     pairs through fastq-to-bam -> align -> report;
  6. mono_probe kernel == its plain torch version on both outputs, exactly,
     at the arguments the mono path passes it for HLA-100 under
     `--probe mono`, at the 16.7M-bucket table of HLA-100 under
     `num_mismatches = 1`, at B*P not a multiple of the block, at W = 16
     (a 500-feature library), with a full 64-row stash, and on synthetic
     tables with random orientation flags (palindromes, S != 4); the
     engine build's slot-major re-lay of the large table timed (the
     pipeline's stage log);
  7. the mono path at real size: the same 1,048,576 reads and 262,144 BAM
     pairs under `--probe mono`, and 524,288 reads of the same generator
     against HLA-100 with `num_mismatches = 1`;
  8. the same 65,536 reads through `align --device cuda` and `--device cpu`
     give byte-identical TSVs, on the group probe and on `--probe mono`;
  9. the wide workload (bench_data.write_wide): the 20k-allele library of
     scripts/bigindex.py (20 families x 1,000 alleles x 3 kb, 25 SNPs each:
     20,000 features, W = 625 words), its index (C++ builder), 524,288
     single-end 100 bp reads and 262,144 pairs (two FASTQs, both mates from
     one fragment of one allele), 1% substitutions; the engine build timed
     by part (index load, gband host build + sidecar write, sidecar load,
     copy to the card);
 10. band_tree_expand kernel == its plain torch version, exactly, on the
     (idx_sel, has_sel) the gband step passes it for real reads at the
     main-path shape (the engine `align` builds: L = 112, W = 625,
     Pw = 32) and at the reference bench's L = 100, with their page spread
     (reads with no row, one page, two adjacent pages, a gap of 2), and on
     synthetic tables (BAND_CASES: B not a multiple of the block,
     (W, Pw, Q1) = (100, 16, 7) and (70, 8, 5), Pw = 24 and 48, Q1 = 1 and
     40, all-miss reads, pages {P-1, P} with the P-1 rows first and last,
     a gap of 2 at the last position only, one contribution on the last
     page, out-of-range indices with and without a contribution);
 11. the gband path at real size: the single-end and paired runs;
 12. 16,384 of those reads through `align --device cuda` and `--device
     cpu` give byte-identical TSVs on the gband path;
 13. first, the intersect_class_bits kernel == its plain version, exactly,
     on synthetic arguments: B = 1,001 (not a multiple of the kernel's 8
     warps a block), W in {1, 17, 32, 33, 157, 625} crossed with P in {1,
     31, 33, 92, 120}, and (B, P, W) = (77, 1,600, 33) and (9, 16,383,
     157), whose run lists need more than 48 KB of shared memory a block,
     and (9, 16,383, 1,563), the width of 50k features; each with two
     all-miss reads, a read alternating two classes (every position starts
     a run), a read matched everywhere with id -1 and 2% of matched
     positions with id -1 (row 0 at W <= 32, all ones above); then on
     family-blocked bitsets (kernel_bench.family_case: each class a subset
     of one ~32-word block, so that the kernel's active list of still-set
     words thins out, empties or stays full mid-read, and starts past lane
     31) at W in {33, 157, 625, 1,563} x P in {40, 96}, at (9, 16,383,
     1,563) and at (5, 16,383, 30,000), whose rows the kernel walks in two
     tiles of words;
     then (A) monocls at W = 625: the 20k library off the group probe
     (NIMBLE_TPU_NO_GROUP_PROBE=1 on the index phase 9 built, which the
     reference also takes to monocls, rather than a second 20k index for
     `--probe mono`); its classes fit the strict class bands, so the step
     intersects them with band_tree_expand (checked against its plain
     version at Q1 = P, timed), and the same chunk's step is timed again
     over class_bits (its output equal to the banded step's), with
     intersect_class_bits checked and timed on the class ids that step
     passes it at W = 625 (231,709 classes); the first 131,072 of its
     reads and 32,768 of its pairs, and 16,384 reads cuda against cpu;
 14. (B) groupcls at W = 157: the first 5 families of the wide generator
     written allele-major (bench_data, `interleaved`: 5,000 alleles whose
     classes are not contiguous, so robust banding fails), default probe,
     131,072 reads, 32,768 pairs, 16,384 reads cuda against cpu;
 15. (C) monocls with class bands at W = 125: the first 4 families in
     family order (no k-mer shared between families), `--probe mono`,
     131,072 reads, 16,384 reads cuda against cpu; band_tree_expand == its
     plain version at the class ids the step passes it (Q1 = P), timed;
 16. (E) monocls with class bits at W = 157: B's library under `--probe
     mono`, 131,072 reads, 16,384 reads cuda against cpu;
 17. (D) the wide two-choice probe: B's library under `--probe mono` with
     the placement cap (tables.MONO_MAX_BYTES, what NIMBLE_TPU_MONO_MAX_BYTES
     sets at import) one byte under monocls's smallest table; 131,072
     reads, 16,384 reads cuda against cpu.
 18. the report (`report`, then `report --device` on the card): (a) the
     tagged pairs' align TSV of phase 5, host against `--device` (and
     `--device cpu`); (b) bench_data.write_report_tsv, 262,144 rows
     (cut from 2,097,152; `python3 -m nimble_tpu_torch.report_bench`
     runs any size) over HLA-100's names (10,000 cells, 1-16 reads a UMI, 10% off
     reads), host exact, `--stream` and `--device` twice, each with its
     wall and rows/s, and `--device`'s wall split by part from the run
     log (TSV parse, extract_report_rows, rows_to_bitsets + factorize,
     H2D, the pipeline in CUDA events with its fixpoint iterations, D2H,
     decode + count + write); (c) 262,144 rows over the 20k library's
     names (W = 625), host and `--device`, with the pipeline's time and
     the peak device memory. Every `--device` output must equal the host
     report byte for byte, or, where the tie guard counted near ties,
     differ in at most 2 x near_ties count rows; the two `--device` runs
     of (b) must give the same bytes and near_ties; `--stream` must equal
     the host report.
 19. several libraries in one `align`, one engine per library, on
     bench_data.write_stacked's workload (scripts/stackscale.py's three
     libraries with 100 alleles each): (a) 262,144 single-end reads on the
     group path, (b) the same under `--probe mono`, (c) 65,536 10x-shaped
     pairs through fastq-to-bam -> align -> report. Each run's three
     `engine` events must name its path and its kernels must launch, and
     every library's TSV must equal that library aligned alone on the card,
     byte for byte; (d) 16,384 reads of the three libraries on cuda against
     cpu on both paths, byte-identical.
 20. `align --resume` and multi-process worlds (NIMBLE_TPU_NUM_PROCS /
     NIMBLE_TPU_PROC_ID), each output byte-identical to the uninterrupted
     run of an earlier phase: (a) phase 5's 1,048,576 reads, the run killed
     (os._exit(9) right after its 6th span's rows, before their checkpoint)
     and resumed (`Resuming from read N`, N a multiple of the span, no
     sidecar left); (b) a world of two processes on them (-c halved,
     reader batches of half a span), launched together, beside one process
     alone in a subprocess and phase 5's wall: merged == phase 5's TSV, no
     shard left, each process's `Decode shard` line at most 0.7 of the reads
     parsed, the merge's copy timed; (c) that world with process 0 killed
     after 3 of its spans and resumed; (d) a world of two on phase 5's BAM
     pairs (ownership alone shards them); (e) the 20k library (gband) on
     phase 11's 524,288 reads: a world of two (its kill and resume, which
     the CPU tests hold at a small width, left out for the time limit); (f)
     kill and resume under `--probe mono` on the first 262,144 of phase 5's
     reads, against the uninterrupted mono run of the same cut. Killed runs
     and world processes are subprocesses of the port's CLI, each with a run
     log of its own whose `engine` events must name the path; every process
     that ends must launch its path's kernels; the resumes run in this
     process and their launches count.
 21. BASELINE config 4 as a user runs it, one process of the port's CLI per
     subcommand, each timed from launch to exit, on phase 5's 262,144
     tagged pairs and HLA-100: fastq-to-bam -> `index --warm 100 --paired`
     on a fresh copy of the library, with the kernel library removed first
     (so warm builds it, as on a fresh checkout; its printed parts shown)
     -> align (its run log must show the index loaded and nothing built:
     no index, gband sidecar or kernel library; its TSV == phase 5's) ->
     report (== phase 5's counts) -> plot (left out, and said so, where
     matplotlib is not installed, as on the H100 machine); beside it one
     cold align on a
     second fresh copy with no index and no kernel library (the same
     bytes). The processes' kmer_keys launches count.
 22. NIMBLE_TPU_PROFILE: one in-process align of phase 8's 65,536 reads
     under torch.profiler; its trace must name the kmer_keys kernel (the
     symbol csrc/kmer_keys.cu launches) and its TSV equal the same run
     unprofiled.
 23. `report --distributed 1` on the card, in-process, on phase 18's (b)
     and (c) TSVs: --device's bytes, and within --device's near-tie rule
     the host report's; rows/s beside --device's, the exchange's blk and
     buffer rows. `--distributed 2` on the one card must exit nonzero,
     naming the device count.
 24. `align --mesh` and the coordinated world: (a) `--mesh auto` (a 1 x 1
     grid, through the engine's split, launch and concatenate path) on
     phase 5's 1,048,576 reads and 262,144 BAM pairs, each TSV == phase
     5's, walls beside phase 5's, the run log's `mesh` event printed; (b)
     engines on make_mesh(n_data, n_feature, [cuda:0] x n) (distinct cards
     where n are visible) for the grids
     (2, 1), (1, 2) and (2, 2) on the first 16,384 reads of HLA-100 (the
     group path on the data split, monocls at W = 4 on the feature split)
     and of the 20k library off the group probe with its
     class table as class_bits (monocls, the 579 MB table split in two on
     the feature axis); the (2, 1) grid also on HLA-100's mono index
     (mono_probe) and on the 20k library with its class bands
     (band_tree_expand); every grid's score, pass_ and full bits (padding
     words included) == the same grid on [cpu] x n with the plain
     versions, the (2, 1) grids == the unmeshed cuda engine, and every
     intersect_class_bits call of a grid's step (one per feature slice)
     == its plain version, with the reads each slice empties at its first
     row (kernel_bench.intersect_walk); each shard's
     table bytes and plan_index_placement of the 20k index at the card's
     memory printed; (c) a coordinated world of two CLI processes on
     phase 5's reads (JAX_COORDINATOR_ADDRESS on a free port, gloo, both
     on cuda:0): merged TSV == phase 5's, no shard or sentinel left, walls
     beside phase 20 (b)'s world; (d) `--mesh data=2` on the one card
     exits 1, names the one device and writes no file.
 25. (run right after phase 12) the gband path's other table layouts on
     the 20k library (W = 625): the index of phase 9 loaded, the default
     layout's tables (single-hash placement, dense rows) from its sidecar,
     then each of the reference's other layouts (NIMBLE_TPU_GBAND_PLACEMENT=
     two, NIMBLE_TPU_GBAND_INDIRECT=1 and both) derived from them (only the
     placement runs), written to its own sidecar and loaded back; each
     layout's table bytes on the card, its sidecar's derivation and load,
     its engine build (the copy to the card); one 65,536-read step of each
     by stage (window, probe, band_tree_expand, combine + pack), in turns,
     its packed output equal to the default's; then phase 12's 16,384 reads
     through `align` under the two-choice and the indirect layout, each on
     the gband path with its sidecar loaded, its TSV byte-identical to
     phase 12's cuda TSV, its kernels launched;
On 13-17 the engine `align` builds must take the named path (the run log's
`engine` event), kmer_keys == its plain version at the arguments it passes
for the first chunk of the reads, and that chunk's step is timed by stage
(window, probe, intersection, combine + pack; kernel_bench.class_stages)
with CUDA events. On B, E and D (over class_bits) intersect_class_bits ==
its plain version (torch.equal) at the arguments the engine passes it for
that chunk, timed with what its walk needs (kernel_bench.intersect_walk:
the runs a read walks, its distinct classes, the sectors a run needs, the
reads emptied early) and the bytes, bound and share of that count and of
the full-row count, the step's stages timed again with the plain version
in its place; their `align` runs must launch it, as phase 24's grids over
the 20k library's class_bits must. Depths cut to fit them: phases 5 and 7 from 2,097,152
reads to 1,048,576, phase 9 from 1,048,576 reads to 524,288.

Each kernel is timed at its main-path arguments, captured from the
engine's align_batch on the first chunk of the workload's reads
(kernel_bench.captured): its time on the card is
that of one launch replayed from a CUDA graph, back to back with others,
median of 25 (nimble_tpu_torch/kernel_bench.py). Printed beside it: one
wrapper call timed with CUDA events (the host's launch latency included),
the plain version's time, the bytes the call must move, its bound at
3.35 TB/s and the share of the bound it reaches.

Each main-path run zeroes the kernels' launch counts just before it and
reads them just after; the run fails unless every kernel of its path ran.
It prints its wall, the engine's path, chunk and table bytes, and the index
load and engine build inside it (the pipeline's stage log,
NIMBLE_TPU_RUNLOG).

Any failure raises (exit code != 0). The second-to-last line is a JSON
record of the kernels; the last line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It imports nothing of the JAX package (nimble_tpu) and no jax: both are
made unimportable before anything else is imported. Its workloads come
from the port's own generator (nimble_tpu_torch/bench_data.py).

Usage: python3 chip_smoke.py   (from the repository root; needs one card)
       python3 chip_smoke.py --mesh-only   (phases 1-3, 5, 9 and 24; with
       several cards visible, phase 24's grids take distinct cards and
       `--mesh auto` all of them)
"""
import sys

sys.modules["jax"] = None  # the port must never import jax: any attempt raises here
sys.modules["nimble_tpu"] = None  # nor the JAX package

import contextlib
import copy
import gzip
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
import types

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

READ_LEN = 100  # the bench reads' length (nimble_tpu_torch/bench_data.py)
N_READS = 1_048_576  # cut from 2,097,152 to make room for phases 13-17
N_PAIRS = 262_144
N_CMP_READS = 65_536
N_NM1_READS = 524_288
MONO = ["--probe", "mono"]

# the 20k-allele HLA/KIR library's reads (bench_data.write_wide); cut from
# the reference's 2M, then from 1,048,576 to make room for phases 13-17
N_WIDE_READS = 524_288
N_WIDE_PAIRS = 262_144
N_WIDE_CMP = 16_384
WIDE_KERNELS = ["kmer_keys", "band_tree_expand"]

# the class-id wide paths (phases 13-17): single-end reads, pairs and the
# reads through cuda and cpu of each; reads and pairs cut from 262,144 and
# 65,536 to make room for phase 20
N_CLS_READS = 131_072
N_CLS_PAIRS = 32_768
N_CLS_CMP = 16_384
GCLS_FAMILIES = 5  # groupcls: 5,000 alleles written allele-major, W = 157
BAND_FAMILIES = 4  # banded monocls: 4,000 alleles in family order, W = 125
NO_GROUP = {"NIMBLE_TPU_NO_GROUP_PROBE": "1"}

# the report phase (18): bench_data.write_report_tsv's workload, cut to
# keep the script inside its time: (b) from 2,097,152 rows to 1,048,576,
# then both to half to make room for phase 20, and (b) to half again for
# the intersection's checks of phases 13 and 24 (the script ran 1,010-1,176
# s on two H100 hosts before); (c) stays at 262,144 rows, the fewest that
# name all 20,000 features (W = 625) of the 20k library
N_REPORT_ROWS = 262_144
N_REPORT_WIDE = 262_144

# several libraries in one `align` (phase 19): bench_data.write_stacked's
# three libraries; reads and pairs cut to half for the same reason as the
# report's
N_MULTI_READS = 262_144
N_MULTI_PAIRS = 65_536
N_MULTI_CMP = 16_384

# `align --resume` and worlds (phase 20): the mono cut of (f), and how many
# spans a killed run emits before os._exit(9): (a) and (f) single runs, (c)
# process 0 of a world
N_MONO_CUT = 262_144
KILL_SPANS = 6
MONO_KILL_SPANS = 3
WORLD_KILL_SPANS = 3

# `--mesh` and the coordinated world (phase 24): (b)'s reads of each
# workload, its grids of the one card, and every (b) engine's chunk, on the
# card and on the CPU
N_MESH_READS = 16_384
MESH_GRIDS = ((2, 1), (1, 2), (2, 2))
MESH_CHUNK = 8_192

# seconds a phase 20 subprocess may run (its stacks are printed if it
# hangs), and process 0's wait for the other shards
PROC_DEADLINE_S = 240
MERGE_TIMEOUT_S = 180

# the port's CLI in a process of its own, as `python -m nimble_tpu_torch`
# runs it (jax and the JAX package unimportable). KILL_AFTER_EMITS=n ends it with os._exit(9) right after the
# n-th LibraryRunner.emit_out: that span's rows are written, its checkpoint
# is not, nothing is cleaned up. A process that ends prints its wall (the
# CLI's main, torch's import and the card's start-up excluded) and its
# kernels' launch counts
PROC_RUNNER = """
import faulthandler, json, os, sys, time
faulthandler.dump_traceback_later(%d, exit=True)  # a hung process prints every thread's stack and ends
sys.modules["jax"] = None
sys.modules["nimble_tpu"] = None
import torch
import nimble_tpu_torch.align.pipeline as P
from nimble_tpu_torch.align import kernels as K
kill = int(os.environ.get("KILL_AFTER_EMITS", "0") or 0)
if kill:
    emit_out = P.LibraryRunner.emit_out
    calls = [0]
    def wrapped(self, out, batch):
        n = emit_out(self, out, batch)
        calls[0] += 1
        if calls[0] >= kill:
            os._exit(9)
        return n
    P.LibraryRunner.emit_out = wrapped
from nimble_tpu_torch.__main__ import main
t0 = time.perf_counter()
rc = main(sys.argv[1:])
if torch.cuda.is_initialized():
    torch.cuda.synchronize()
print("RESULT " + json.dumps({"wall_s": time.perf_counter() - t0, "launches": {
    n: getattr(K, n).launches for n in ("kmer_keys", "mono_probe", "band_tree_expand", "intersect_class_bits")}}),
    flush=True)
sys.exit(rc)
""" % PROC_DEADLINE_S


_T0 = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """A line of the log, with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] [{phase}] {msg}", flush=True)


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

    _ok, how = build_native()  # before the native loader first looks
    from nimble_tpu_torch.io import native

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
    # ptxas -v of each kernel: registers, spills, static shared memory (the
    # kmer_keys packed arrays; the mono_probe stash is dynamic, per launch)
    log = path + ".ptxas.txt"
    if os.path.exists(log):
        src, entry = "", ""
        with open(log) as f:
            for ln in f:
                if ln.startswith("== "):
                    src = ln[3:].strip()
                elif "Compiling entry function" in ln:
                    entry = ln.split("'")[1]
                elif "Used" in ln and "registers" in ln:
                    m = re.search(r"ILb(\d)ELb(\d)E", entry)
                    kind = f" <vkeys={m.group(1)}, vvals={m.group(2)}>" if m else ""
                    say("build", f"{src}{kind}: {ln.split(':', 1)[1].strip()}")


def phase_data(work: str):
    """The main path's workload: the HLA-100 library, its index and the
    single-end reads."""
    from nimble_tpu_torch import bench_data

    se = os.path.join(work, "se")
    t0 = time.perf_counter()
    lib, fq = bench_data.write_single(se, N_READS)
    say("data", f"generated HLA-100 + {N_READS} reads in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["index", "--reference", lib])
    say("data", f"index built in {time.perf_counter() - t0:.2f} s")
    return lib, fq


def stage_wall(name: str) -> float:
    """The wall of the last `name` stage in the pipeline's stage log."""
    with open(os.environ["NIMBLE_TPU_RUNLOG"]) as f:
        ends = [e for e in map(json.loads, filter(str.strip, f))
                if e["event"] == "stage_end" and e["stage"] == name]
    if not ends:
        raise AssertionError(f"the stage log holds no {name} stage")
    return ends[-1]["wall_s"]


# kmer_keys shapes beyond the main path's: every k the wrapper takes at its
# ends and in between, reads as short as k, widths that are not a multiple
# of 16 (narrower loads) and reads longer than one 256-code segment
KMER_KS = (1, 2, 16, 21, 26, 31)
KMER_LS = ("k", 40, 100, 112, 150, 301)


def check_kmer(label: str, c, ln, k: int, n_buckets: int) -> int:
    """kmer_keys == kmer_keys_reference on all 7 planes, exactly."""
    from nimble_tpu_torch.align import kernels as K

    names = ("c_hi", "c_lo", "h1", "h2", "fwd_canon", "palindrome", "valid")
    got = K.kmer_keys(c, ln, k, n_buckets)
    want = K.kmer_keys_reference(c, ln, k, n_buckets)
    torch.cuda.synchronize()
    max_err = 0
    for nm, a, b in zip(names, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"kmer_keys {nm} {a.dtype}{tuple(a.shape)} != twin {b.dtype}{tuple(b.shape)}")
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"kmer_keys != twin on {nm} at {label} (max |diff| {err})")
    return max_err


def kmer_codes(rng, B: int, L: int, dev):
    """Random codes with 1% N bases and 1% codes outside 0-4 (a base is
    code & 3, only 4 is N); lens from 0 to L, half of them L."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.01] = 4
    odd = rng.random((B, L)) < 0.01
    codes[odd] = rng.choice(np.array([-128, -4, -1, 5, 7, 127], np.int8), size=int(odd.sum()))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[: B // 2] = L
    return torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)


def phase_kernel(lib: str, fq: str):
    """kmer_keys against its plain version at the arguments the group path
    passes it for the first chunk of the bench reads, on random codes at
    that shape and on the shape grid; timed at the main path's arguments."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import kernels as K

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    _, eng = KB.engine(lib)
    args = KB.captured(eng, *KB.fastq_head(fq, eng.chunk_size, eng.max_len), "kmer_keys")
    del eng
    c, ln, MAIN_K, N_BUCKETS = args
    MAIN_B, MAIN_L = c.shape
    say("kernel", f"main-path arguments (align, HLA-100, the first chunk of the bench reads): B={MAIN_B} "
        f"L={MAIN_L} k={MAIN_K} n_buckets={N_BUCKETS}")
    max_err = check_kmer("the main path", *args)
    rc, rl = kmer_codes(rng, MAIN_B, MAIN_L, dev)
    max_err = max(max_err, check_kmer("random codes at the main-path shape", rc, rl, MAIN_K, N_BUCKETS))
    say("kernel", f"B={MAIN_B} L={MAIN_L} k={MAIN_K}: all 7 planes equal the twin (the main path's "
        "arguments, and random codes at that shape)")
    n_grid = 0
    for k in KMER_KS:
        for L in KMER_LS:
            L = k if L == "k" else L
            gc, gl = kmer_codes(rng, 4099, L, dev)
            max_err = max(max_err, check_kmer(f"B=4099 L={L} k={k}", gc, gl, k, 1 << 17))
            n_grid += 1
    # rows that start at odd addresses: a view one byte into a buffer
    buf, _ = kmer_codes(rng, 1, 1001 * 113 + 1, dev)
    odd = buf.view(-1)[1:].view(1001, 113)
    max_err = max(max_err, check_kmer("odd row addresses", odd, torch.full((1001,), 113, dtype=torch.int32,
                                                                         device=dev), 21, 1 << 10))
    say("kernel", f"{n_grid} shapes (B=4099, k in {KMER_KS}, L in {KMER_LS}) and odd row addresses: "
        "all 7 planes equal the twin")
    ms = KB.device_ms(lambda: K.kmer_keys(*args))
    call_ms = cuda_ms(lambda: K.kmer_keys(*args))
    plain_ms = cuda_ms(lambda: K.kmer_keys_reference(*args))
    n_bytes = KB.kernel_bytes("kmer_keys", args)
    bound = KB.bound_ms(n_bytes)
    say("kernel", f"kmer_keys B={MAIN_B} L={MAIN_L} k={MAIN_K}: kernel {ms:.4f} ms on the card (median of 25, "
        f"CUDA graph), {n_bytes / 1e6:.1f} MB, bound {bound:.4f} ms, share {bound / ms:.3f}; one wrapper call "
        f"{call_ms:.4f} ms (CUDA events, launch included); twin {plain_ms:.4f} ms")
    return max_err, ms, plain_ms, bound


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


def drive(label: str, args, n: int, kernels, lo: float = 0.3, path: str = "", n_engines: int = 0):
    """One main-path run: zero every kernel's launch count, run `align` on
    cuda, read the counts. Fails unless each kernel of the path launched,
    every engine took `path` (when given; the run log's `engine` events),
    the run built `n_engines` engines (when given) and the pass rate (TSV
    rows per read or pair) lies in (lo, 1]. Returns (wall s, rows,
    counts)."""
    from nimble_tpu_torch.align import kernels as K

    wrappers = {"kmer_keys": K.kmer_keys, "mono_probe": K.mono_probe,
                "band_tree_expand": K.band_tree_expand, "intersect_class_bits": K.intersect_class_bits}
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
    engines = [e for e in stages if e["event"] == "engine"]
    engine = engines[-1]
    if path and any(e["path"] != path for e in engines):
        raise AssertionError(f"{label}: the engines took the {[e['path'] for e in engines]} paths, not {path}")
    if n_engines and len(engines) != n_engines:
        raise AssertionError(f"{label}: {len(engines)} engine events, not {n_engines}")
    counts = {name: w.launches for name, w in wrappers.items()}
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: the path never launched the {name} kernel")
    rows = sum(tsv_rows(o) for o in lib_outputs(out, args[args.index("--reference") + 1]))
    if not lo < rows / n <= 1.0:
        raise AssertionError(f"{label}: pass rate {rows / n:.4f} outside ({lo}, 1]")
    relay = "".join(f", of it the {what} re-lay {setup[stage]:.4f}" for stage, what in
                    (("mono_relayout", "mono table's"), ("gband_relayout", "band table's"),
                     ("class_relayout", "class bands'")) if stage in setup)
    relay += "".join(f"; {e['n']} progress checkpoints in {e['wall_s']:.4f} s" for e in stages
                     if e["event"] == "checkpoints")
    say("main", f"{label}: {n} in {wall:.2f} s wall, {n / wall:,.0f}/s, pass rate {rows / n:.4f}, "
        f"launches {counts}; path {engine['path']}, chunk {engine['chunk_size']}, tables "
        f"{sum(e['table_bytes'] for e in engines) / 1e9:.3f} GB over {len(engines)} engine(s); set-up {t_setup:.2f} s (index load "
        f"{setup.get('index_build', 0.0):.2f}, engine build {setup.get('engine_build', 0.0):.2f}{relay}), "
        f"after it {n / max(wall - t_setup, 1e-9):,.0f}/s")
    return wall, rows, counts


def lib_outputs(out: str, reference: str):
    """The TSVs `align --output out --reference reference` writes: `out`
    for one library, one `out` with `.<library>` before its extension for
    each of several."""
    from nimble_tpu_torch.align.pipeline import append_path_string

    libs = reference.split(",")
    if len(libs) == 1:
        return [out]
    return [append_path_string(out, "." + os.path.splitext(os.path.basename(lib))[0]) for lib in libs]


def same_bytes(label: str, a: str, b: str, reference: str) -> int:
    """Every library's TSV of run a equals run b's, byte for byte. Returns
    the rows they hold."""
    rows = 0
    for x, y in zip(lib_outputs(a, reference), lib_outputs(b, reference)):
        with open(x, "rb") as f, open(y, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{label}: {os.path.basename(x)} differs from {os.path.basename(y)}")
        rows += tsv_rows(x)
    return rows


def phase_main_path(work: str, name: str, lib: str, fq: str):
    """The group path at real size: single-end gz FASTQ, then tagged BAM
    pairs -> report. Returns the BAM path and the launch counts."""
    from nimble_tpu_torch import bench_data

    cores = str(os.cpu_count() or 1)
    say("main", f"group path on {name}, -c {cores}")
    se_wall, _, se = drive("group single-end reads", ["--reference", lib, "--output",
                                                       os.path.join(work, "se", "out.tsv"), "--input", fq,
                                                       "-c", cores], N_READS, ["kmer_keys"])

    pe = os.path.join(work, "pe")
    r1, r2, whitelist = bench_data.write_paired(pe, N_PAIRS)
    bam = os.path.join(pe, "tagged.bam")
    t0 = time.perf_counter()
    cli(["fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2, "--map", whitelist, "--output", bam, "-c", cores])
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
    return bam, pout, se_wall, {k: se[k] + pe_counts[k] for k in se}, (r1, r2, whitelist)


def phase_mono_data(work: str, lib: str):
    """The mono path's workloads: the HLA-100 mono index (`index --probe
    mono`), and HLA-100 with num_mismatches = 1 (a copy of hla100.json with
    that Config field changed) with 524,288 reads of the same generator."""
    from nimble_tpu_torch import bench_data

    t0 = time.perf_counter()
    cli(["index", "--reference", lib, "--probe", "mono"])
    say("data", f"HLA-100 mono index built in {time.perf_counter() - t0:.2f} s")
    nm1 = os.path.join(work, "nm1")
    nm1_src, nm1_fq = bench_data.write_single(nm1, N_NM1_READS)
    with open(nm1_src) as f:
        config, data = json.load(f)
    config["num_mismatches"] = 1
    nm1_lib = os.path.join(nm1, "hla100_nm1.json")
    with open(nm1_lib, "w") as f:
        json.dump([config, data], f)
    t0 = time.perf_counter()
    cli(["index", "--reference", nm1_lib])
    say("data", f"HLA-100 num_mismatches=1 index built in {time.perf_counter() - t0:.2f} s")
    return nm1_lib, nm1_fq


def mono_engine(lib: str, group_g):
    """The engine that `align` builds for this library and 100 bp reads
    (single-end), on the mono path."""
    from nimble_tpu_torch import kernel_bench as KB

    _, eng = KB.engine(lib, group_g)
    if "mono_bucket" not in eng.tables or eng.params.group_g != 0:
        raise AssertionError(f"{lib}: the engine did not take the mono path ({sorted(eng.tables)})")
    return eng


def fastq_codes(fq: str, B: int, L: int, seed: int):
    """The first B reads of a FASTQ as (codes, lens) on the card, with 1% of
    bases set to N and some reads cut short (under k and under L)."""
    from nimble_tpu_torch import kernel_bench as KB

    codes, lens = KB.fastq_head(fq, B, L)
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
                vals = 2 * S + 2 * W * s + np.arange(2 * W)  # slot-major on the card
                moved.append(np.concatenate([[qh, ql], t[b, vals]]))
                t[b, s] = -1
                t[b, S + s] = 0
                t[b, vals] = 0
        if stash.shape[0] + len(moved) >= K.MONO_MAX_STASH:
            break
    new_stash = np.concatenate([stash.cpu().numpy(), np.array(moved, dtype=np.int32)])
    dev = bucket.device
    return torch.from_numpy(t).to(dev), torch.from_numpy(new_stash).to(dev)


def w16_case(B: int, L: int):
    """A 500-feature library (W = 16 words, the widest the mono path takes):
    its mono tables on the card and B reads drawn from it."""
    from nimble_tpu_torch import seq as seqmod
    from nimble_tpu_torch.config import Config, Data
    from nimble_tpu_torch.index.builder import build_index
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
        f"nb2={bucket.shape[0]} stash rows={stash.shape[0]} (n_stash={int((stash[:, 0] != -1).sum())} "
        f"keys, the rest padding; {stash.numel() * 4} B of shared memory a block): "
        f"both outputs equal the plain version (windows hit {hit:.3f})")
    return planes, max_err


def time_mono(label: str, args):
    """The kernel's time on the card, its bytes and bound on these
    arguments, and the plain version's time. Returns (ms, plain ms, bound
    ms)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import kernels as K

    n_bytes = KB.kernel_bytes("mono_probe", args)
    bound = KB.bound_ms(n_bytes)
    ms = KB.device_ms(lambda: K.mono_probe(*args))
    call_ms = cuda_ms(lambda: K.mono_probe(*args))
    plain_ms = cuda_ms(lambda: K.mono_probe_reference(*args))
    say("kernel", f"mono_probe {label}: kernel {ms:.4f} ms on the card (CUDA graph, median of 25), "
        f"{n_bytes / 1e6:.1f} MB, bound {bound:.4f} ms, share {bound / ms:.3f}; one wrapper call "
        f"{call_ms:.4f} ms (CUDA events, launch included); plain {plain_ms:.4f} ms")
    return ms, plain_ms, bound


def mono_main_args(eng, fq: str):
    """mono_probe's arguments on the mono path for the first chunk of the
    FASTQ's reads, captured from the engine."""
    from nimble_tpu_torch import kernel_bench as KB

    return KB.captured(eng, *KB.fastq_head(fq, eng.chunk_size, eng.max_len), "mono_probe")


def phase_mono_kernel(lib: str, fq: str, nm1_lib: str, nm1_fq: str):
    """mono_probe against its plain version at the mono path's arguments
    and edge cases; timed at the main path's arguments and at the large
    table."""
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align.tables import table_words

    eng = mono_engine(lib, group_g=0)
    B, L, k = eng.chunk_size, eng.max_len, eng.params.k
    bucket, stash = eng.tables["mono_bucket"], eng.tables["mono_stash"]
    W = table_words(eng.tables)
    say("kernel", f"mono main-path arguments (align --probe mono, HLA-100): B={B} L={L} k={k} "
        f"P={L - k + 1} W={W} S={bucket.shape[1] // (2 + 2 * W)} nb2={bucket.shape[0]} stash={stash.shape[0]}")
    args = mono_main_args(eng, fq)
    planes, max_err = check_mono("main path (the first chunk of the bench reads)", bucket, stash, W,
                                 planes=args[1:7])
    ms, plain_ms, bound = time_mono("main path", args)
    codes, lens = fastq_codes(fq, B, L, seed=1)
    errs = [max_err, check_mono("the same reads, 1% N bases, 5% cut short", bucket, stash, W, codes, lens, k)[1]]

    full_bucket, full_stash = _full_stash(bucket, stash, planes, W)
    if full_stash.shape[0] != K.MONO_MAX_STASH:
        raise AssertionError(f"the full-stash table holds {full_stash.shape[0]} stash rows")
    errs.append(check_mono("full 64-row stash", full_bucket, full_stash, W, codes, lens, k)[1])
    errs.append(check_mono("B=4099 (B*P not a multiple of 256)", bucket, stash, W,
                           codes[:4099].contiguous(), lens[:4099].contiguous(), k)[1])
    wk, wt, wc, wl = w16_case(4099, L)
    errs.append(check_mono("W=16 library", wt["mono_bucket"], wt["mono_stash"], table_words(wt), wc, wl, wk)[1])
    for sW, sS, n_stash in ((4, 4, 64), (5, 2, 7), (16, 3, 1)):
        sb, ss, sp = synthetic_planes(1001, 37, sW, sS, n_stash, seed=sW)
        errs.append(check_mono(f"synthetic keys and flags (palindromes, S={sS})", sb, ss, sW, planes=sp)[1])
    del eng, args, full_bucket, full_stash, wt

    t0 = time.perf_counter()
    eng = mono_engine(nm1_lib, group_g=None)  # num_mismatches = 1: no group entries
    nb, ns = eng.tables["mono_bucket"], eng.tables["mono_stash"]
    torch.cuda.synchronize()
    nW = table_words(eng.tables)
    say("kernel", f"num_mismatches=1 table: {tuple(nb.shape)} int32 = {nb.numel() * 4 / 1e9:.2f} GB, "
        f"stash {ns.shape[0]}; index load + table build + copy to the card {time.perf_counter() - t0:.2f} s, "
        f"of it the slot-major re-lay on the card {stage_wall('mono_relayout'):.4f} s (stage log)")
    args = mono_main_args(eng, nm1_fq)
    errs.append(check_mono("num_mismatches=1 (the first chunk of its reads)", nb, ns, nW, planes=args[1:7])[1])
    codes, lens = fastq_codes(nm1_fq, eng.chunk_size, eng.max_len, seed=2)
    errs.append(check_mono("num_mismatches=1, 1% N bases, 5% cut short", nb, ns, nW, codes, lens,
                           eng.params.k)[1])
    time_mono("num_mismatches=1 table", args)
    del eng, nb, ns, args
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, bound


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
    from nimble_tpu_torch import bench_data

    lib, fq = bench_data.write_single(os.path.join(work, "cmp"), N_CMP_READS)
    for probe, flags in (("group", []), ("mono", MONO)):
        compare_devices(f"HLA-100, --probe {probe}", lib, fq, flags, N_CMP_READS)
    return lib, fq


def phase_wide_data(work: str):
    """The gband path's workload (bench_data.write_wide): the 20k-allele
    library and its index; gz FASTQs of N_WIDE_READS single-end reads, of
    their first N_WIDE_CMP, and of N_WIDE_PAIRS pairs."""
    from nimble_tpu_torch import bench_data

    d = os.path.join(work, "wide")
    t0 = time.perf_counter()
    lib, fq, r1, r2 = bench_data.write_wide(d, N_WIDE_READS, N_WIDE_PAIRS)
    cmp_fq = gz_head(fq, os.path.join(d, f"reads20k_{N_WIDE_CMP}.fastq.gz"), N_WIDE_CMP)
    n_al = bench_data.WIDE_FAMILIES * bench_data.WIDE_ALLELES
    say("data", f"generated the 20k-allele library ({n_al} alleles x {bench_data.WIDE_LEN} bp), "
        f"{N_WIDE_READS} reads and {N_WIDE_PAIRS} pairs in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["index", "--reference", lib])
    say("data", f"20k index built (C++ builder) and saved in {time.perf_counter() - t0:.2f} s")
    return lib, fq, cmp_fq, r1, r2


def check_band(label: str, pages, bands, idx_sel, has_sel, W: int):
    """band_tree_expand == band_tree_expand_reference, exactly, on a
    re-laid table (pages, bands). Returns (max |diff|, the kernel's
    output)."""
    from nimble_tpu_torch.align import kernels as K

    got = K.band_tree_expand(pages, bands, idx_sel, has_sel, W)
    want = K.band_tree_expand_reference(pages, bands, idx_sel, has_sel, W)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"band_tree_expand {got.dtype}{tuple(got.shape)} != plain "
                             f"{want.dtype}{tuple(want.shape)} at {label}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got, want):
        raise AssertionError(f"band_tree_expand != plain version at {label} (max |diff| {err})")
    B, Q1 = idx_sel.shape
    say("kernel", f"band_tree_expand {label}: B={B} Q1={Q1} W={W} Pw={bands.shape[1] // 2} rows={bands.shape[0]}: equals "
        f"the plain version (positions with a row {float(has_sel.float().mean()):.3f}, reads with bits "
        f"{float((got != 0).any(dim=1).float().mean()):.3f})")
    return err, got


def band_case(B: int, W: int, Pw: int, Q1: int, seed: int, miss: int = 3, kind: str = "mixed",
              n_rows: int = 4096):
    """A band table on the card (dense random bands, 2% zero, every page
    present, rows sorted by page) and per-read positions, the first `miss`
    reads without any; a position without a row has index -1 or one past
    the table's end, which the gather clamps. By `kind`:
      * mixed: near one page, at it or one page up, 2% two pages up (an
        empty AND), 30% without a row;
      * low first / low last: every position contributes, at pages
        {P - 1, P}, the P - 1 ones first or last;
      * late gap: every position at one page but the last, two pages up;
      * last page: one contribution per read, on the last page;
      * clamped: mixed around the first or the last page, with 20% of the
        contributing positions at index -1 or n_rows + 7 (the first or the
        last row, whose page is the read's).
    Returns the table re-laid as the engine ships it (tables.relayout_gband),
    idx_sel and has_sel: (pages, bands, idx_sel, has_sel)."""
    from nimble_tpu_torch.align.tables import relayout_gband

    rng = np.random.default_rng(seed)
    n_pages = -(-W // Pw)
    page = np.sort(np.arange(n_rows) % n_pages).astype(np.int32)
    band = np.bitwise_or.reduce(
        rng.integers(-(1 << 31), 1 << 31, size=(4, n_rows, 2 * Pw), dtype=np.int64), axis=0).astype(np.int32)
    band[rng.random(n_rows) < 0.02] = 0
    start = np.searchsorted(page, np.arange(n_pages))
    count = np.searchsorted(page, np.arange(n_pages), side="right") - start
    odd = np.arange(B)[:, None] % 2 == 1
    base = np.where(odd, n_pages - 1, 0) if kind == "clamped" else rng.integers(0, n_pages, size=(B, 1))
    up = (rng.random((B, Q1)) < 0.3).astype(np.int64) + 2 * (rng.random((B, Q1)) < 0.02)
    pg = np.minimum(base + up, n_pages - 1)
    has = rng.random((B, Q1)) < 0.7
    if kind in ("low first", "low last"):
        low = np.arange(Q1) < max(Q1 // 2, 1)
        pg = rng.integers(1, n_pages, size=(B, 1)) - (low if kind == "low first" else low[::-1])
        has[:] = True
    elif kind == "late gap":
        pg = np.repeat(rng.integers(0, n_pages - 2, size=(B, 1)), Q1, axis=1)
        pg[:, -1] += 2
        has[:] = True
    elif kind == "last page":
        pg[:] = n_pages - 1
        has[:] = False
        has[np.arange(B), rng.integers(0, Q1, size=B)] = True
    has[:miss] = False
    idx = start[pg] + (rng.random((B, Q1)) * count[pg]).astype(np.int64)
    if kind == "clamped":
        clamp = has & (rng.random((B, Q1)) < 0.2) & (pg == base)
        idx = np.where(clamp, np.where(odd, n_rows + 7, -1), idx)
    idx = np.where(has, idx, np.where(rng.random((B, Q1)) < 0.5, -1, n_rows + 7)).astype(np.int32)
    dev = torch.device("cuda")
    table = torch.from_numpy(np.concatenate([page[:, None], band], axis=1)).to(dev)
    return (*relayout_gband(table), *(torch.from_numpy(a).to(dev) for a in (idx, has)))


BAND_CASES = [
    # label, B, W, Pw, Q1, reads without a row, kind
    ("B=4099 (not a multiple of the 8-read block)", 4099, 625, 32, 16, 3, "mixed"),
    ("(W, Pw, Q1) = (100, 16, 7)", 4096, 100, 16, 7, 3, "mixed"),
    ("(W, Pw, Q1) = (70, 8, 5)", 4096, 70, 8, 5, 3, "mixed"),
    ("Pw=24 (W not a multiple of Pw)", 4096, 625, 24, 16, 3, "mixed"),
    ("Q1=40 (256 bp reads)", 4096, 625, 32, 40, 3, "mixed"),
    ("Pw=48 (frames wider than 64 words)", 4096, 625, 48, 16, 3, "mixed"),
    ("all-miss reads", 1000, 625, 32, 16, 1000, "mixed"),
    ("Q1=1", 4096, 625, 32, 1, 3, "mixed"),
    ("pages {P-1, P}, the P-1 rows first", 4096, 625, 32, 16, 3, "low first"),
    ("pages {P-1, P}, the P-1 rows last", 4096, 625, 32, 16, 3, "low last"),
    ("Q1=40, pages {P-1, P}, the P-1 rows last", 4096, 625, 32, 40, 3, "low last"),
    ("a gap of 2 at the last position only", 4096, 625, 32, 16, 3, "late gap"),
    ("one contribution on the last, partial page", 4096, 625, 32, 16, 3, "last page"),
    ("one contribution on the last page (Pw=24: one word)", 4096, 625, 24, 16, 3, "last page"),
    ("contributing indices -1 and n_rows+7 (clamped)", 4096, 625, 32, 16, 3, "clamped"),
]


def phase_wide_kernel(lib: str, fq: str):
    """The engine `align` builds for the 20k library, timed by part, then
    band_tree_expand against its plain version on the (idx_sel, has_sel)
    its gband step passes for the first chunk of real reads, and on the
    synthetic cases; timed at the main-path shape. Returns the error, the
    times and (the index loaded again from its file, with the default
    gband tables loaded from the sidecar; the library's config; the two
    loads' seconds)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.index.builder import KmerIndex
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
    bands = eng.tables["gband_band"]
    bucket = eng.tables["gband_bucket"]
    W, Pw = TT.table_words(eng.tables), eng.band_pw
    say("wide", f"W={W} Pw={Pw} g={index.pair_g} features={index.n_features} classes={index.n_classes} "
        f"group entries={index.pair_hi.shape[0]}; gband_bucket {tuple(bucket.shape)} = "
        f"{bucket.numel() * 4 / 1e9:.2f} GB, gband_band {tuple(bands.shape)} = {bands.numel() * 4 / 1e6:.1f} MB, "
        f"stash {eng.tables['gband_stash_hi'].shape[0]}; sidecar {os.path.getsize(side) / 1e9:.2f} GB")
    say("wide", f"engine build by part: index load {t_load:.2f} s (again: {t_reload:.2f} s), gband host "
        f"build + sidecar write {t_build:.2f} s, sidecar load {t_side:.2f} s, tables to the card {t_h2d:.2f} s "
        f"(of it the band table's re-lay on the card {stage_wall('gband_relayout'):.4f} s, stage log)")
    del again, host
    loaded = (fresh, r.config, t_reload, t_side)  # for phase 25: the index and its default tables as loaded

    errs = []
    # the CLI's read width (100 bp reads round up to L = 112), then the
    # reference bench's L = 100 (scripts/bigindex.py: B = 65,536, Q1 = 14)
    for max_len in (_round_len(READ_LEN), READ_LEN):
        if eng is None:
            eng = TE.AlignEngine(index, r.config, dev, chunk_size=None, max_len=max_len)
        B, L = eng.chunk_size, eng.max_len
        args = KB.captured(eng, *KB.fastq_head(fq, B, L), "band_tree_expand")
        pages, _, idx_sel, has_sel, _ = args
        label = "main path" if max_len != READ_LEN else "L=100 (the reference bench's width)"
        say("kernel", f"band_tree_expand {label} arguments (20k library): B={B} L={L} "
            f"Q1={idx_sel.shape[1]} W={W} Pw={Pw}")
        errs.append(check_band(label, *args)[0])
        sp = KB.band_spread(pages, idx_sel, has_sel)
        say("kernel", f"band_tree_expand {label}: page spread over reads: no row {sp['no_row']:.4f}, one page "
            f"{sp['one_page']:.4f}, two adjacent pages {sp['adjacent']:.4f}, a gap of 2 or more {sp['gap2']:.4f}; "
            f"{sp['mean_rows']:.2f} contributing positions a read")
        t_ms = KB.device_ms(lambda: K.band_tree_expand(*args))
        call_ms = cuda_ms(lambda: K.band_tree_expand(*args))
        t_plain = cuda_ms(lambda: K.band_tree_expand_reference(*args))
        n_bytes = KB.kernel_bytes("band_tree_expand", args)
        t_bound = KB.bound_ms(n_bytes)
        rows = int(torch.unique(idx_sel[has_sel]).numel())
        say("kernel", f"band_tree_expand {label}: kernel {t_ms:.4f} ms on the card (CUDA graph, median of 25), "
            f"{n_bytes / 1e6:.1f} MB ({rows} distinct band rows), bound {t_bound:.4f} ms, share "
            f"{t_bound / t_ms:.3f}; one wrapper call {call_ms:.4f} ms (CUDA events, launch included); "
            f"plain {t_plain:.4f} ms")
        if max_len != READ_LEN:
            ms, plain_ms, bound = t_ms, t_plain, t_bound
        eng = None
        del args, idx_sel, has_sel
    del r, index, bands, bucket
    for i, (label, sB, sW, sPw, sQ1, miss, kind) in enumerate(BAND_CASES):
        err, got = check_band(label, *band_case(sB, sW, sPw, sQ1, seed=i, miss=miss, kind=kind), sW)
        if got[:miss].any():
            raise AssertionError(f"band_tree_expand {label}: reads without a row have bits")
        lit = (got != 0).any(dim=1)
        if kind == "late gap" and lit.any():
            raise AssertionError(f"band_tree_expand {label}: a read with a gap of 2 has bits")
        if kind != "late gap" and miss < sB and not lit.any():
            raise AssertionError(f"band_tree_expand {label}: no read has bits, so nothing was compared")
        errs.append(err)
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, bound, loaded


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


def compare_devices(label: str, lib: str, fq: str, flags=(), n: int = N_WIDE_CMP, path: str = ""):
    """The same reads through `align --device cuda` and `--device cpu`:
    the TSVs must be byte-identical, and every engine of both runs must
    take `path` when it is given (the run log's `engine` events). Returns
    the cuda run's TSV."""
    outs = {}
    log = os.environ["NIMBLE_TPU_RUNLOG"]
    for dev in ("cuda", "cpu"):
        base = os.path.splitext(lib.split(",")[0])[0]
        outs[dev] = f"{base}.cmp_{re.sub(r'[^A-Za-z0-9]+', '_', label)}_{dev}.tsv"
        seen = os.path.getsize(log) if os.path.exists(log) else 0
        t0 = time.perf_counter()
        cli(["align", "--reference", lib, "--output", outs[dev], "--input", fq, *flags, "--device", dev])
        say("cmp", f"align ({label}) --device {dev}: {time.perf_counter() - t0:.2f} s")
        if not path:
            continue
        with open(log) as f:
            f.seek(seen)
            paths = [e["path"] for e in map(json.loads, filter(str.strip, f)) if e["event"] == "engine"]
        if not paths or any(p != path for p in paths):
            raise AssertionError(f"align ({label}) --device {dev}: the engines took the {paths} paths, not {path}")
    rows = same_bytes(f"align ({label}), --device cuda against --device cpu", outs["cuda"], outs["cpu"], lib)
    say("cmp", f"{n} reads, {label}: cuda and cpu TSVs byte-identical ({rows} rows)")
    return outs["cuda"]


# the gband layouts (phase 25): the reference's layouts beside the default
# (single-hash placement, dense rows), each as (tag, environment); `align`
# runs the first two on phase 12's reads
GBAND_LAYOUTS = (
    ("two-choice", {"NIMBLE_TPU_GBAND_PLACEMENT": "two", "NIMBLE_TPU_GBAND_INDIRECT": "0"}),
    ("indirect", {"NIMBLE_TPU_GBAND_PLACEMENT": "single", "NIMBLE_TPU_GBAND_INDIRECT": "1"}),
    ("two-choice indirect", {"NIMBLE_TPU_GBAND_PLACEMENT": "two", "NIMBLE_TPU_GBAND_INDIRECT": "1"}),
)
DEFAULT_LAYOUT = {"NIMBLE_TPU_GBAND_PLACEMENT": "single", "NIMBLE_TPU_GBAND_INDIRECT": "0"}
LAYOUT_STEP_B = 65_536


def phase_gband_layouts(lib: str, fq: str, cmp_fq: str, cmp_tsv: str, loaded, smi: str):
    """The gband path's other table layouts on the 20k library (W = 625),
    beside the default: in this process, on the index phase 10 loaded from
    its file with the default layout's tables loaded from their sidecar
    (`loaded`), each other layout's tables derived from the tables already
    held (only the placement runs) and written to its own sidecar, then
    loaded back; each layout's engine (the copy to
    the card and its table bytes there); one LAYOUT_STEP_B-read step of
    each by stage (window, probe, band_tree_expand, combine + pack;
    kernel_bench.gband_stages), in turns, two rounds, each layout's packed
    output equal to the default's, and its probe again with the stash cut
    to one empty row (what the stash sweep costs). Then `align` on phase
    12's reads under
    the first two layouts: each engine on the gband path, its sidecar
    loaded, the TSV byte-identical to phase 12's cuda TSV. Returns the
    launch counts of those runs."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.pipeline import _round_len

    dev = torch.device("cuda")
    index, config, t_index, t_default = loaded
    say("layouts", f"phase 10's index load {t_index:.2f} s and default sidecar load {t_default:.2f} s; {smi}")
    codes, lens = KB.fastq_head(fq, LAYOUT_STEP_B, _round_len(READ_LEN))
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    engines = {}
    for tag, env in (("default", DEFAULT_LAYOUT),) + GBAND_LAYOUTS:
        with environ(env):
            t0 = time.perf_counter()
            host = TT.groupband_tables(index)
            t_side = time.perf_counter() - t0
            side = dict(index.gband_sidecar)
            want = "loaded" if tag == "default" else "derived"  # the default: phase 10's load, held
            if host is None or side["source"] != want or not os.path.exists(side["path"]):
                raise AssertionError(f"layout {tag}: tables {side} ({want} expected)")
            t_load = t_default
            if tag != "default":  # the derived layout's sidecar, loaded back
                t0 = time.perf_counter()
                again = TT.load_gband_sidecar(side["path"], index)
                t_load = time.perf_counter() - t0
                if again is None or list(again) != list(host) or any(
                        not np.array_equal(again[k], host[k]) for k in host):
                    raise AssertionError(f"layout {tag}: its sidecar does not load back to the same tables")
                del again
            t0 = time.perf_counter()
            eng = TE.AlignEngine(index, config, dev, chunk_size=LAYOUT_STEP_B, max_len=_round_len(READ_LEN))
            torch.cuda.synchronize()
            t_h2d = time.perf_counter() - t0
        if eng.path != "gband":
            raise AssertionError(f"layout {tag}: the engine took {eng.path}")
        engines[tag] = eng
        host_bytes = sum(v.nbytes for v in host.values())
        say("layouts", f"{tag}: gband_bucket {tuple(host['gband_bucket'].shape)}"
            + (f", gband_ptr8 {tuple(host['gband_ptr8'].shape)}" if "gband_ptr8" in host else "")
            + f", stash {int((host['gband_stash_hi'] != -1).sum())}; tables on the card "
            f"{eng.table_bytes / 1e9:.4f} GB (host arrays {host_bytes / 1e9:.4f} GB, sidecar "
            f"{os.path.getsize(side['path']) / 1e9:.4f} GB); sidecar "
            + ("loaded in phase 10" if tag == "default" else f"{side['source']} in {t_side:.2f} s")
            + (f" from {os.path.basename(side['derived_from'])}" if "derived_from" in side else "")
            + f", its load {t_load:.2f} s; engine build (copy to the card, band re-lay) {t_h2d:.2f} s; "
            f"{smi}")
    outs = {}
    for tag, eng in engines.items():
        x = None
        for _, fn in KB.gband_stages(eng, c, ln):
            x = fn(x)
        outs[tag] = x
        if not torch.equal(x, outs["default"]):
            raise AssertionError(f"layout {tag}: the step's packed output differs from the default layout's")
    stages = {tag: [] for tag in engines}
    for _ in range(2):
        for tag, eng in engines.items():
            stages[tag].append(KB.stage_ms(KB.gband_stages(eng, c, ln)))
    for tag, rounds in stages.items():
        say("layouts", f"{tag}: one step by stage, B={LAYOUT_STEP_B} L={c.shape[1]} (CUDA events, the card "
            "idle before each stage, median of 5; two rounds in turns with the other layouts): "
            + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in st.items()) + " ms" for st in rounds)
            + f"; {smi}")
    for tag, eng in engines.items():
        # the probe with the stash cut to one empty row (its output is
        # not the step's): what the stash sweep costs the probe
        nostash = {**eng.tables, **{k: eng.tables[k][:1].clone() for k in TT.GBAND_KEYS if "stash" in k}}
        nostash["gband_stash_hi"].fill_(-1)
        cut = types.SimpleNamespace(tables=nostash, params=eng.params, pack=eng.pack)
        st = KB.stage_ms(KB.gband_stages(cut, c, ln)[:2])
        say("layouts", f"{tag}: the probe without its {eng.tables['gband_stash_hi'].shape[0]}-row stash sweep "
            f"{st['probe']:.3f} ms (window {st['window']:.3f} ms; CUDA events, median of 5); {smi}")
    del engines, outs, c, ln, index, host, loaded, nostash, cut
    torch.cuda.empty_cache()

    counts = {k: 0 for k in WIDE_KERNELS}
    for tag, env in GBAND_LAYOUTS[:2]:
        out = os.path.join(os.path.dirname(cmp_tsv), f"layout_{tag.replace(' ', '_')}.tsv")
        log = os.environ["NIMBLE_TPU_RUNLOG"]
        seen = os.path.getsize(log)
        with environ(env):
            _, rows, run = drive(f"gband {tag} layout (20k library)", ["--reference", lib, "--output", out,
                                                                         "--input", cmp_fq],
                                 N_WIDE_CMP, WIDE_KERNELS, lo=0.1, path="gband")
        with open(log) as f:
            f.seek(seen)
            sides = [e for e in map(json.loads, filter(str.strip, f)) if e["event"] == "gband_sidecar"]
        if not sides or any(e["source"] != "loaded" for e in sides):
            raise AssertionError(f"align ({tag} layout): the gband tables were not loaded from the sidecar: {sides}")
        same_bytes(f"align ({tag} layout) against the default layout", out, cmp_tsv, lib)
        say("layouts", f"{N_WIDE_CMP} reads, {tag} layout: TSV byte-identical to the default layout's "
            f"({rows} rows); sidecar {os.path.basename(sides[-1]['path'])} loaded in {sides[-1]['wall_s']:.2f} s; "
            f"{smi}")
        counts = {k: counts[k] + run[k] for k in WIDE_KERNELS}
    return counts


def gz_head(src: str, dst: str, n: int) -> str:
    """The first n records of a gz FASTQ, written to dst."""
    with gzip.open(src, "rb") as f, gzip.open(dst, "wb", compresslevel=1) as g:
        g.write(b"".join(itertools.islice(f, 4 * n)))
    return dst


@contextlib.contextmanager
def environ(values):
    """os.environ with `values` set, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_cls_data(work: str, tag: str, families: int, interleaved: bool, n_pairs: int, flags=()):
    """A cut of the wide generator's library (`families` families, family
    order or allele-major), N_CLS_READS single-end reads, n_pairs pairs and
    the first N_CLS_CMP reads; its index (`index` with `flags`)."""
    from nimble_tpu_torch import bench_data

    d = os.path.join(work, tag)
    t0 = time.perf_counter()
    lib, fq, r1, r2 = bench_data.write_wide(d, N_CLS_READS, n_pairs, families=families, interleaved=interleaved)
    cmp_fq = gz_head(fq, os.path.join(d, f"cmp_{N_CLS_CMP}.fastq.gz"), N_CLS_CMP)
    say("data", f"generated {os.path.basename(lib)} ({families * bench_data.WIDE_ALLELES} alleles"
        f"{', allele-major' if interleaved else ''}), {N_CLS_READS} reads and {n_pairs} pairs in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["index", "--reference", lib, *flags])
    say("data", f"{os.path.basename(lib)} index{''.join(' ' + f for f in flags)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    return lib, fq, (r1, r2), cmp_fq


def check_intersect(label: str, class_ids, matched, class_bits, quiet: bool = False) -> int:
    """intersect_class_bits == intersect_class_bits_reference, exactly
    (torch.equal), on these arguments on the card. Returns the max |diff|
    (0)."""
    from nimble_tpu_torch.align import kernels as K

    got = K.intersect_class_bits(class_ids, matched, class_bits)
    want = K.intersect_class_bits_reference(class_ids, matched, class_bits)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"intersect_class_bits {got.dtype}{tuple(got.shape)} != plain "
                             f"{want.dtype}{tuple(want.shape)} at {label}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got, want):
        raise AssertionError(f"intersect_class_bits != plain version at {label} (max |diff| {err})")
    if not quiet:
        (B, P), (C, W) = class_ids.shape, class_bits.shape
        say("kernel", f"intersect_class_bits {label}: B={B} P={P} C={C} W={W}: equals the plain version "
            f"(matched positions {float(matched.float().mean()):.3f}, reads with bits "
            f"{float((got != 0).any(dim=1).float().mean()):.3f})")
    return err


def intersect_case(B: int, P: int, C: int, W: int, seed: int):
    """Intersection arguments on the card (tests/test_torch_intersect.py's
    cases): class ids in runs of about 3 positions, 10% of positions
    unmatched (half of them with an id the mask must hide), 2% matched
    with id -1; reads 0-1 all-miss, read 2 alternating two classes (every
    position starts a run), read 3 matched everywhere with id -1; dense
    bitsets (15/16 of the bits set), so that many-run ANDs keep bits."""
    rng = np.random.default_rng(seed)
    cb = np.bitwise_or.reduce(rng.integers(-(1 << 31), 1 << 31, size=(4, C, W), dtype=np.int64),
                              axis=0).astype(np.int32)
    new = rng.random((B, P)) < 0.3
    new[:, 0] = True
    ids = np.take_along_axis(rng.integers(0, C, size=(B, P)), np.cumsum(new, axis=1) - 1, axis=1).astype(np.int32)
    matched = rng.random((B, P)) >= 0.1
    ids[~matched & (rng.random((B, P)) < 0.5)] = -1
    ids[matched & (rng.random((B, P)) < 0.02)] = -1
    matched[:2] = False
    ids[2] = np.where(np.arange(P) % 2 == 0, 3, 5)
    matched[2] = True
    ids[3], matched[3] = -1, True
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, matched, cb))


# intersect_class_bits on synthetic arguments: every W crossed with every P
# at B = INTERSECT_B (not a multiple of the kernel's 8 warps a block), and
# run lists too long for 8 warps' shared memory; then family-blocked
# bitsets (kernel_bench.family_case, as tests/test_torch_intersect.py), at
# FAMILY_W x FAMILY_P and in long reads, the widest walked in two tiles
INTERSECT_W = (1, 17, 32, 33, 157, 625)
INTERSECT_P = (1, 31, 33, 92, 120)
INTERSECT_B = 1_001
INTERSECT_LONG = ((77, 1_600, 33), (9, 16_383, 157))  # (B, P, W): 64 KB of lists, 3 warps a block
FAMILY_W = (33, 157, 625, 1_563)
FAMILY_P = (40, 96)
FAMILY_LONG = ((9, 16_383, 1_563), (5, 16_383, 30_000))  # 50k features; a row past shared memory


def phase_intersect_kernel() -> int:
    """intersect_class_bits == its plain version on the synthetic cases:
    intersect_case's dense bitsets at W in INTERSECT_W (W % 4 != 0 among
    them, both sides of 32) crossed with P in INTERSECT_P and the long run
    lists, and at (9, 16,383, 1,563); family_case's family-blocked ones,
    whose active lists thin out, empty or stay full mid-read, at FAMILY_W x
    FAMILY_P and FAMILY_LONG. Returns the max |diff|."""
    from nimble_tpu_torch import kernel_bench as KB

    t0 = time.perf_counter()
    err = 0
    cases = [(INTERSECT_B, P, W) for W in INTERSECT_W for P in INTERSECT_P] + [*INTERSECT_LONG, FAMILY_LONG[0]]
    for B, P, W in cases:
        args = intersect_case(B, P, 3000, W, seed=B * P + W)
        err = max(err, check_intersect(f"synthetic B={B} P={P} W={W}", *args, quiet=True))
    say("kernel", f"intersect_class_bits == its plain version on {len(cases)} dense synthetic cases (B={INTERSECT_B}, "
        f"W in {INTERSECT_W} x P in {INTERSECT_P}; (B, P, W) in {(*INTERSECT_LONG, FAMILY_LONG[0])}; all-miss "
        f"reads, a read whose every position starts a run, matched positions with id -1 on both sides of W = 32) "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    family = [(INTERSECT_B, P, W) for W in FAMILY_W for P in FAMILY_P] + list(FAMILY_LONG)
    for B, P, W in family:
        C = 1_000 if W > 10_000 else 3_000  # at least 6 + the family count (938 at W = 30,000)
        args = tuple(torch.from_numpy(a).to(dev) for a in KB.family_case(B, P, C, W, seed=B * P + W))
        err = max(err, check_intersect(f"family-blocked B={B} P={P} W={W}", *args, quiet=True))
        if P > 1_000:
            continue
        walk = KB.intersect_walk(*args)
        say("kernel", f"intersect_class_bits family-blocked B={B} P={P} W={W}: equals the plain version; runs a "
            f"read {walk['mean_runs']:.2f} (max {walk['max_runs']}), distinct classes {walk['distinct_classes']:.2f}, "
            f"sectors a run {walk['sectors_per_run']:.2f}, reads emptied with runs left {walk['emptied_early']} of {B}")
    say("kernel", f"intersect_class_bits == its plain version on {len(family)} family-blocked cases in "
        f"{time.perf_counter() - t0:.1f} s")
    return err


def time_intersect(tag: str, what: str, args):
    """intersect_class_bits on the arguments of path `tag` (`what` they
    are): == its plain version, the kernel's time (kernel_bench.device_ms),
    the plain version's; what the walk needs (kernel_bench.intersect_walk:
    the runs a read walks, its distinct classes, the sectors a run needs,
    the reads emptied early) and the bytes, bound and share it gives,
    beside the full-row count's. Either share above 1.05 is a fault in the
    count. Returns (max |diff|, ms, plain ms, bound ms)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import kernels as K

    err = check_intersect(f"{tag} ({what})", *args)
    ms = KB.device_ms(lambda: K.intersect_class_bits(*args))
    plain = cuda_ms(lambda: K.intersect_class_bits_reference(*args))
    walk, n_bytes, full_bytes = KB.intersect_bytes(args)
    bound, full_bound = KB.bound_ms(n_bytes), KB.bound_ms(full_bytes)
    say(tag, f"intersect_class_bits B={args[0].shape[0]} P={args[0].shape[1]} "
        f"C={args[2].shape[0]} W={args[2].shape[1]}: kernel {ms:.4f} ms on the card (CUDA graph, median of 25); "
        f"the walk's sectors {n_bytes / 1e6:.1f} MB, bound {bound:.4f} ms, share {bound / ms:.3f}; full rows "
        f"{full_bytes / 1e6:.1f} MB, bound {full_bound:.4f} ms, share {full_bound / ms:.3f}; plain {plain:.4f} ms; "
        f"runs a read: mean {walk['mean_runs']:.2f}, max {walk['max_runs']}; distinct classes a read "
        f"{walk['distinct_classes']:.2f}; sectors a run needs {walk['sectors_per_run']:.2f}; reads emptied with "
        f"runs left {walk['emptied_early']}, empty after the first row {walk['empty_at_first']}")
    if max(bound, full_bound) / ms > 1.05:
        raise AssertionError(f"{tag}: intersect_class_bits ran faster than its bound ({ms:.4f} ms against "
                             f"{bound:.4f} and {full_bound:.4f}): the byte count is wrong")
    return err, ms, plain, bound


def phase_cls_engine(tag: str, lib: str, fq: str, path: str, group_g=None, bits_too: bool = False):
    """The engine that `align` builds for `lib` and 100 bp single-end reads,
    which must take `path`: its tables; the kmer_keys kernel, and
    band_tree_expand at Q1 = P on the class bands or intersect_class_bits
    over class_bits, against its plain version on the arguments the engine
    passes it for the first chunk of fq's reads (intersect_class_bits
    timed with its bytes, bound and runs); that chunk's step timed by
    stage (kernel_bench.class_stages), and with `bits_too` on the class
    bands, timed again over class_bits instead (its output must equal the
    banded step's; intersect_class_bits checked and timed on the class ids
    that step passes it). Returns (kmer_keys max |diff|, band_tree_expand
    (max |diff|, ms, plain ms, bound ms) or None, intersect_class_bits's
    the same or None)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align import tables as TT

    t0 = time.perf_counter()
    r, eng = KB.engine(lib, group_g)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if eng.path != path:
        raise AssertionError(f"{tag}: the engine took the {eng.path} path, not {path} ({sorted(eng.tables)})")
    W = TT.table_words(eng.tables)
    banded = "class_band" in eng.tables
    if ("class_bits" in eng.tables) == banded:
        raise AssertionError(f"{tag}: the engine ships {sorted(eng.tables)}")
    sizes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in eng.tables.items()
                      if isinstance(v, torch.Tensor) and v.numel() > 4096)
    say(tag, f"engine: path {eng.path}, W={W}, g={eng.params.group_g}, chunk {eng.chunk_size}, tables "
        f"{eng.table_bytes / 1e9:.3f} GB on the card ({sizes}); index load + table build + copy {t_build:.2f} s")
    if banded:
        Pw, _ = TT.build_class_bands(r.index)
        first, last = TT._class_spans(r.index.class_bits.view(np.int32), W)
        say(tag, f"strict class bands hold: the widest class spans {int((last - first + 1).max())} of {W} words, "
            f"so Pw = {Pw} and 3 Pw <= W")
    if path == "groupcls":
        cb = r.index.class_bits.view(np.int32)
        first, last = TT._class_spans(cb, W)
        span = last - first + 1
        robust = TT.build_class_bands_robust(r.index)
        say(tag, f"robust banding {'infeasible' if robust is None else 'feasible'}: {int((span > W // 2).sum())} of "
            f"{cb.shape[0]} classes span more than half of the {W} words (99.99th percentile span "
            f"{np.percentile(span, 99.99):.0f}); {r.index.pair_hi.shape[0]} group entries")
    codes, lens = KB.fastq_head(fq, eng.chunk_size, eng.max_len)
    kargs = KB.captured(eng, codes, lens, "kmer_keys")
    err = check_kmer(f"{tag} (the first chunk)", *kargs)
    say(tag, f"kmer_keys B={kargs[0].shape[0]} L={kargs[0].shape[1]} k={kargs[2]} n_buckets={kargs[3]} (the "
        "engine's first chunk): all 7 planes equal the plain version")
    band = None
    if banded:
        bargs = KB.captured(eng, codes, lens, "band_tree_expand")
        b_err, _ = check_band(f"{tag} (class ids of the first chunk, Q1 = P)", *bargs)
        sp = KB.band_spread(*KB.band_args(bargs)[:3])
        ms = KB.device_ms(lambda: K.band_tree_expand(*bargs))
        plain = cuda_ms(lambda: K.band_tree_expand_reference(*bargs))
        n_bytes = KB.kernel_bytes("band_tree_expand", bargs)
        bound = KB.bound_ms(n_bytes)
        say(tag, f"band_tree_expand B={bargs[2].shape[0]} Q1={bargs[2].shape[1]} W={W} "
            f"Pw={bargs[1].shape[1] // 2}: kernel {ms:.4f} ms on the card (CUDA graph, median of 25), "
            f"{n_bytes / 1e6:.1f} MB, bound {bound:.4f} ms, share {bound / ms:.3f}; plain {plain:.4f} ms; "
            f"reads: no row {sp['no_row']:.4f}, one page {sp['one_page']:.4f}, two adjacent pages "
            f"{sp['adjacent']:.4f}, a gap of 2 or more {sp['gap2']:.4f}; {sp['mean_rows']:.2f} positions a read")
        band = (b_err, ms, plain, bound)
    inter = None
    if not banded:
        iargs = KB.captured(eng, codes, lens, "intersect_class_bits")
        inter = time_intersect(tag, "the first chunk's class ids", iargs)
    dev = torch.device("cuda")
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    print_stages(tag, "one step by stage", KB.stage_ms(KB.class_stages(eng, c, ln)), c.shape)
    if not banded:
        with plain_intersection():
            print_stages(tag, "the same step with the plain intersection (intersect_class_bits_reference)",
                         KB.stage_ms(KB.class_stages(eng, c, ln)), c.shape)
    if banded and bits_too:
        # the same step over class_bits, as on a library without the bands:
        # the class-bits intersection at this W, on these reads' classes
        unbanded = types.SimpleNamespace(params=eng.params, tables={
            **{k: v for k, v in eng.tables.items() if k not in ("class_page", "class_band", "class_words")},
            "class_bits": torch.from_numpy(r.index.class_bits.view(np.int32)).to(dev)})
        outs = []
        for e in (eng, unbanded):
            x = None
            for _, fn in KB.class_stages(e, c, ln):
                x = fn(x)
            outs.append(x)
        if not torch.equal(*outs):
            raise AssertionError(f"{tag}: the step over class_bits differs from the step over the class bands")
        # what intersect_classes passes the kernel on this step
        t, p = unbanded.tables, eng.params
        cls_sel = TE.class_probe(TE.class_keys(c, ln, t, p), ln, c.shape[1], t, p)[0]
        inter = time_intersect(tag, "the first chunk's class ids over class_bits",
                               (cls_sel, cls_sel >= 0, t["class_bits"]))
        print_stages(tag, "the same step over class_bits (intersect_class_bits at this W; output equal to the "
                     "banded step's)", KB.stage_ms(KB.class_stages(unbanded, c, ln)), c.shape)
        with plain_intersection():
            print_stages(tag, "the step over class_bits with the plain intersection "
                         "(intersect_class_bits_reference)", KB.stage_ms(KB.class_stages(unbanded, c, ln)), c.shape)
        del unbanded, outs
    del eng, r
    torch.cuda.empty_cache()
    return err, band, inter


@contextlib.contextmanager
def plain_intersection():
    """The engine's intersect_class_bits swapped for its plain version, for
    a stage split beside the kernel's."""
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import kernels as K

    TE.intersect_class_bits = K.intersect_class_bits_reference
    try:
        yield
    finally:
        TE.intersect_class_bits = K.intersect_class_bits


def print_stages(tag: str, what: str, st: dict, shape) -> None:
    total = sum(v for k, v in st.items() if k != "step")
    say(tag, f"{what}, B={shape[0]} L={shape[1]} (CUDA events, the card idle before each stage, median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in st.items())
        + f"; the intersection is {st['intersection'] / total:.3f} of the stages' sum")


def phase_cls(work: str, tag: str, lib: str, fq: str, cmp_fq: str, path: str, flags=(), pairs=None,
              group_g=None, bits_too: bool = False):
    """A class-id wide path: phase_cls_engine, then N_CLS_READS single-end
    reads (and N_CLS_PAIRS pairs) through `align` on cuda, then N_CLS_CMP
    reads on cuda and cpu. Returns (kmer_keys max |diff|, band_tree_expand
    result or None, intersect_class_bits result or None, summed launch
    counts)."""
    cores = str(os.cpu_count() or 1)
    banded = path.endswith("(class bands)")
    kernels = ["kmer_keys", "band_tree_expand" if banded else "intersect_class_bits"]
    err, band, inter = phase_cls_engine(tag, lib, fq, path, group_g, bits_too)
    base = os.path.splitext(lib)[0]
    runs = [drive(f"{tag} single-end reads", ["--reference", lib, "--output", f"{base}.se.tsv", "--input", fq,
                                              "-c", cores, *flags], N_CLS_READS, kernels, lo=0.05, path=path)]
    if pairs:
        runs.append(drive(f"{tag} pairs (two FASTQs)", ["--reference", lib, "--output", f"{base}.pe.tsv",
                                                         "--input", *pairs, "-c", cores, *flags],
                          N_CLS_PAIRS, kernels, lo=0.05, path=path))
    compare_devices(tag, lib, cmp_fq, flags, N_CLS_CMP)
    return err, band, inter, {k: sum(r[2][k] for r in runs) for k in runs[0][2]}


def phase_cls_paths(work: str, wlib: str, wfq: str, wr1: str, wr2: str, wcmp: str):
    """Phases 13-17: the 20k library off the group probe (monocls with
    class bands, W = 625, and its step over class_bits), the allele-major
    library (groupcls), a family-order library under --probe mono (monocls,
    class bands), the allele-major one under --probe mono (monocls, class
    bits), then with the placement cap below its monocls table (the wide
    two-choice probe); first intersect_class_bits on its synthetic cases.
    Returns (kmer_keys max |diff|, band_tree_expand (max |diff|, ms, plain
    ms, bound ms) on each class-band path, intersect_class_bits's by tag
    ("A" over class_bits, "B", "E", "D") and its synthetic max |diff|,
    summed launch counts)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.pipeline import make_runner

    synth_err = phase_intersect_kernel()
    d = os.path.join(work, "wide")
    fq = gz_head(wfq, os.path.join(d, f"reads20k_{N_CLS_READS}.fastq.gz"), N_CLS_READS)
    pairs = [gz_head(src, os.path.join(d, f"pairs20k_r{i}_{N_CLS_PAIRS}.fastq.gz"), N_CLS_PAIRS)
             for i, src in ((1, wr1), (2, wr2))]
    results = []
    with environ(NO_GROUP):  # the 20k index as phase 9 built it, off the group probe
        results.append(phase_cls(work, "A", wlib, fq, wcmp, "monocls (class bands)", pairs=pairs, bits_too=True))
    blib, bfq, bpairs, bcmp = phase_cls_data(work, "gcls", GCLS_FAMILIES, True, N_CLS_PAIRS)
    results.append(phase_cls(work, "B", blib, bfq, bcmp, "groupcls", pairs=bpairs))
    clib, cfq, _, ccmp = phase_cls_data(work, "band", BAND_FAMILIES, False, 0, MONO)
    results.append(phase_cls(work, "C", clib, cfq, ccmp, "monocls (class bands)", MONO, group_g=0))
    t0 = time.perf_counter()
    cli(["index", "--reference", blib, *MONO])
    say("data", f"{os.path.basename(blib)} index --probe mono built in {time.perf_counter() - t0:.2f} s")
    results.append(phase_cls(work, "E", blib, bfq, bcmp, "monocls", MONO, group_g=0))
    n_keys, cap = KB.two_choice_cap(make_runner(blib, os.devnull, group_g=0).index)
    say("data", f"{os.path.basename(blib)}: {n_keys} keys, the placement cap set to {cap} B "
        "(NIMBLE_TPU_MONO_MAX_BYTES, as read at import)")
    default_cap = TT.MONO_MAX_BYTES
    TT.MONO_MAX_BYTES = cap
    try:
        results.append(phase_cls(work, "D", blib, bfq, bcmp, "two-choice", MONO, group_g=0))
    finally:
        TT.MONO_MAX_BYTES = default_cap
    counts = {k: sum(r[3][k] for r in results) for k in results[0][3]}
    inters = {tag: r[2] for tag, r in zip("ABCED", results) if r[2] is not None}
    return max(r[0] for r in results), [r[1] for r in results if r[1] is not None], (inters, synth_err), counts


def phase_report(work: str, pout: str):
    """`report` on the host and `report --device` on the card
    (nimble_tpu_torch/report_bench.py): (a) the tagged pairs' align TSV of
    phase 5, also under `--device cpu`; (b) write_report_tsv's workload
    over HLA-100's names, host exact, --stream and --device twice; (c) the
    same generator over the 20k library's names (W = 625), host and
    --device."""
    from nimble_tpu_torch import bench_data
    from nimble_tpu_torch import report_bench as RB

    d = os.path.join(work, "report")
    os.makedirs(d, exist_ok=True)

    # (a) the chain as a user runs it
    outs = {k: os.path.join(d, f"a_{k}.tsv") for k in ("host", "cuda", "cpu")}
    wall_h, _, _ = RB.run_report(pout, outs["host"])
    wall_d, _, ev = RB.run_report(pout, outs["cuda"], ["--device"])
    RB.hold_to_host("(a) tagged pairs", outs["host"], outs["cuda"], ev["near_ties"])
    _, _, ev_cpu = RB.run_report(pout, outs["cpu"], ["--device", "cpu"])
    with open(outs["cuda"], "rb") as f, open(outs["cpu"], "rb") as g:
        same = f.read() == g.read()
    say("report", f"(a) {tsv_rows(pout)} rows of phase 5's tagged pairs: host {wall_h:.2f} s, --device "
        f"{wall_d:.2f} s; --device cpu == cuda bytes: {same}, near_ties cuda {ev['near_ties']} "
        f"cpu {ev_cpu['near_ties']}")

    # (b) a realistic UMI workload; (c) full width, W = 625
    b_runs = RB.bench(d, N_REPORT_ROWS, bench_data.hla100_names(), RB.SEED, "(b)")
    runs = RB.bench(d, N_REPORT_WIDE, bench_data.wide_names(), RB.SEED, "(c)",
                    engines=RB.ENGINES[:1] + RB.ENGINES[2:3])
    if runs["--device"][2]["words"] != 625:
        raise AssertionError(f"(c): the bitsets are {runs['--device'][2]['words']} words wide, not 625")
    return {"(b)": b_runs, "(c)": runs}


def phase_multi_data(work: str):
    """The multi-library workload (bench_data.write_stacked): three
    libraries of 100 alleles, N_MULTI_READS single-end reads round-robin
    from them, their first N_MULTI_CMP, N_MULTI_PAIRS 10x-shaped pairs as a
    tagged BAM; each library's index for the group probe and for `--probe
    mono`."""
    from nimble_tpu_torch import bench_data

    d = os.path.join(work, "multi")
    t0 = time.perf_counter()
    libs, fq, (r1, r2, whitelist) = bench_data.write_stacked(d, N_MULTI_READS, N_MULTI_PAIRS)
    cmp_fq = gz_head(fq, os.path.join(d, f"multi_cmp_{N_MULTI_CMP}.fastq.gz"), N_MULTI_CMP)
    say("multi", f"generated {len(libs)} libraries x {bench_data.N_ALLELES} alleles, {N_MULTI_READS} reads and "
        f"{N_MULTI_PAIRS} pairs in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bam = os.path.join(d, "tagged.bam")
    cli(["fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2, "--map", whitelist, "--output", bam,
         "-c", str(os.cpu_count() or 1)])
    say("multi", f"fastq-to-bam {N_MULTI_PAIRS} pairs: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for lib in libs:
        cli(["index", "--reference", lib])
        cli(["index", "--reference", lib, *MONO])
    say("multi", f"group and mono indexes of the {len(libs)} libraries built in {time.perf_counter() - t0:.2f} s")
    return ",".join(libs), fq, cmp_fq, bam


def phase_multi(work: str, ref: str, fq: str, cmp_fq: str, bam: str):
    """Phase 19: the three libraries in one `align` on cuda, one engine per
    library (three `engine` events, each on the path named), every
    library's TSV byte for byte against that library aligned alone on
    cuda: (a) the single-end reads on the group path, (b) the same under
    `--probe mono`, (c) the 10x pairs' tagged BAM, then `report` of each
    library; (d) N_MULTI_CMP reads on cuda against cpu on both paths.
    Returns the summed launch counts of the three-library runs."""
    cores = str(os.cpu_count() or 1)
    base = os.path.join(work, "multi")
    libs = ref.split(",")
    counts = []
    for tag, inputs, n, flags, path, kernels in (
            ("(a) single-end reads", [fq], N_MULTI_READS, [], "group", ["kmer_keys"]),
            ("(b) single-end reads, --probe mono", [fq], N_MULTI_READS, MONO, "mono", ["kmer_keys", "mono_probe"]),
            ("(c) 10x pairs (tagged BAM)", [bam], N_MULTI_PAIRS, [], "group", ["kmer_keys"])):
        name = re.sub(r"[^a-z0-9]+", "_", tag.lower()).strip("_")
        out = os.path.join(base, f"{name}.tsv")
        args = ["--input", *inputs, "-c", cores, *flags]
        wall, rows, c = drive(f"{tag}, {len(libs)} libraries", ["--reference", ref, "--output", out, *args], n,
                              kernels, path=path, n_engines=len(libs))
        counts.append(c)
        alone = 0.0
        for lib, got in zip(libs, lib_outputs(out, ref)):
            lib_name = os.path.splitext(os.path.basename(lib))[0]
            want = os.path.join(base, f"{name}.alone.{lib_name}.tsv")
            # a third of the reads come from each library
            w, _, _ = drive(f"{tag}, {lib_name} alone", ["--reference", lib, "--output", want, *args], n, kernels,
                            lo=0.1, path=path, n_engines=1)
            alone += w
            same_bytes(f"{tag}: {lib_name} beside the others against alone", got, want, lib)
        say("multi", f"{tag}: every library's TSV == that library aligned alone ({rows} rows); wall "
            f"{wall:.2f} s, the three alone {alone:.2f} s summed")
        if tag.startswith("(c)"):
            t0 = time.perf_counter()
            for got in lib_outputs(out, ref):
                counts_tsv = got + ".counts"
                cli(["report", "-i", got, "-o", counts_tsv])
                if os.path.getsize(counts_tsv) == 0:
                    raise AssertionError(f"report wrote an empty count matrix for {os.path.basename(got)}")
            say("multi", f"(c) report of each library's TSV: {time.perf_counter() - t0:.2f} s")
    for flags, path in (([], "group"), (MONO, "mono")):
        compare_devices(f"(d) three libraries, {path}", ref, cmp_fq, flags, N_MULTI_CMP, path=path)
    return {k: sum(c[k] for c in counts) for k in counts[0]}


_PROCS = []  # every subprocess phase 20 starts, killed if the phase fails


def start_cli(tag: str, argv, env, d: str):
    """The port's CLI on `argv` through PROC_RUNNER in a subprocess with
    `env` over os.environ, a run log of its own and its output in a file.
    Returns (tag, Popen, run log path, output path, start time)."""
    base = os.path.join(d, re.sub(r"[^A-Za-z0-9]+", "_", tag).strip("_"))
    full = {**os.environ, "NIMBLE_TPU_MERGE_TIMEOUT_S": str(MERGE_TIMEOUT_S), **env,
            "NIMBLE_TPU_RUNLOG": base + ".jsonl"}
    with open(base + ".out", "w") as out:
        p = subprocess.Popen([sys.executable, "-c", PROC_RUNNER, *argv], cwd=REPO,
                             env=full, stdout=out, stderr=subprocess.STDOUT)
    _PROCS.append(p)
    return tag, p, base + ".jsonl", base + ".out", time.perf_counter()


def start_align(tag: str, args, env, d: str):
    """`align ... --device cuda` through start_cli."""
    return start_cli(tag, ["align", *args, "--device", "cuda"], env, d)


def proc_output(proc) -> str:
    with open(proc[3]) as f:
        return f.read()


def wait_procs(procs, rcs):
    """Wait for start_align processes together. Each must exit with its
    code in `rcs` (9: killed); the first that does not, or a deadline past
    PROC_DEADLINE_S, kills the rest and raises with its output. Returns each
    process's seconds from its launch to its exit."""
    walls = [None] * len(procs)
    deadline = time.perf_counter() + PROC_DEADLINE_S + 30
    while None in walls:
        for i, (tag, p, _, _, t0) in enumerate(procs):
            if walls[i] is None and p.poll() is not None:
                walls[i] = time.perf_counter() - t0
                if p.returncode != rcs[i]:
                    for q in procs:
                        if q[1].poll() is None:
                            q[1].kill()
                    raise AssertionError(f"{tag}: exited {p.returncode}, not {rcs[i]}:\n"
                                         f"{proc_output(procs[i])[-6000:]}")
        if time.perf_counter() > deadline:
            for q in procs:
                if q[1].poll() is None:
                    q[1].kill()
            raise AssertionError("processes still running at the deadline: " + "; ".join(
                f"{q[0]}:\n{proc_output(q)[-3000:]}" for q, w in zip(procs, walls) if w is None))
        time.sleep(0.05)
    return walls


def run_events(log: str):
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def check_align(proc, path: str, kernels=(), rc: int = 0):
    """A start_align process that exited `rc`: every engine it built must
    take `path`, and one that ended (rc 0) must have launched each of
    `kernels`. Returns (output, RESULT dict or None, run log events)."""
    tag, _, log, _, _ = proc
    out = proc_output(proc)
    events = run_events(log)
    paths = [e["path"] for e in events if e["event"] == "engine"]
    if not paths or any(x != path for x in paths):
        raise AssertionError(f"{tag}: the engines took the {paths} paths, not {path}")
    res = None
    if rc == 0:
        res = json.loads(re.search(r"^RESULT (.*)$", out, re.M).group(1))
        for k in kernels:
            if res["launches"][k] <= 0:
                raise AssertionError(f"{tag}: the process never launched the {k} kernel")
    return out, res, events


def same_file(label: str, got: str, want: str) -> int:
    with open(got, "rb") as f, open(want, "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{label}: {got} differs from {want}")
    return tsv_rows(got)


def no_leftovers(label: str, d: str) -> None:
    left = sorted(f for f in os.listdir(d) if ".shard" in f or ".progress.json" in f)
    if left:
        raise AssertionError(f"{label}: left {left} behind")


def resume_here(label: str, args, n: int, kernels, path: str, want_from: int, env=None):
    """`align --resume` in this process through drive(), so its launches
    count; it must print `Resuming from read want_from`. Returns (launch
    counts, the run log's `resume` event)."""
    log = os.environ["NIMBLE_TPU_RUNLOG"]
    seen = os.path.getsize(log)
    buf = io.StringIO()
    try:
        with environ(env or {}), contextlib.redirect_stdout(buf):
            _, _, counts = drive(label, [*args, "--resume"], n, kernels, path=path)
    finally:
        sys.stdout.write(buf.getvalue())
    m = re.search(r"Resuming from read (\d+)", buf.getvalue())
    if not m or int(m.group(1)) != want_from:
        raise AssertionError(f"{label}: printed {m and m.group(0)!r}, not resuming from read {want_from}")
    with open(log) as f:
        f.seek(seen)
        ev = [e for e in map(json.loads, filter(str.strip, f)) if e["event"] == "resume"]
    say("resume", f"{label}: resumed from read {want_from}, the fast-forward to it "
        f"{ev[-1]['fast_forward_s']:.3f} s after the first batch")
    return counts, ev[-1]


def kill_at(label: str, args, spans: int, path: str, d: str, env=None):
    """One run killed after `spans` emitted spans; its sidecar must survive
    and name the spans before the last. Returns the sidecar."""
    out = args[args.index("--output") + 1]
    proc = start_align(label, args, {"KILL_AFTER_EMITS": str(spans), **(env or {})}, d)
    wall, = wait_procs([proc], [9])
    check_align(proc, path, rc=9)
    prog_path = out + ".progress.json"
    with open(prog_path) as f:
        prog = json.load(f)
    if prog["reads_done"] != (spans - 1) * prog["span"]:
        raise AssertionError(f"{label}: the sidecar names read {prog['reads_done']}, not {spans - 1} spans "
                             f"of {prog['span']}")
    say("resume", f"{label}: killed (exit 9) after {spans} spans, {wall:.2f} s from launch; its sidecar names "
        f"{prog['reads_done']} reads, span {prog['span']}")
    return prog


def decode_shard_lines(label: str, outs, n: int) -> None:
    for p, out in enumerate(outs):
        m = re.search(r"Decode shard: parsed (\d+) skipped (\d+) records", out)
        if not m:
            raise AssertionError(f"{label}: process {p} printed no Decode shard line")
        parsed, skipped = int(m.group(1)), int(m.group(2))
        say("world", f"{label}: process {p}: {m.group(0)} ({parsed / n:.3f} parsed)")
        if parsed + skipped != n or parsed > 0.7 * n:
            raise AssertionError(f"{label}: process {p} parsed {parsed} and skipped {skipped} of {n}")


WORLD_WALLS = {}  # label -> the world's wall, for later phases to print beside their own


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the coordinator's)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world(label: str, args, n_proc: int, n: int, want: str, path: str, kernels, d: str, env=None,
          kill0: int = 0, coordinated: bool = False):
    """A world of n_proc processes of `align`, launched together, ranked by
    NIMBLE_TPU_NUM_PROCS / NIMBLE_TPU_PROC_ID, or with `coordinated` by a
    coordinator (JAX_COORDINATOR_ADDRESS on a free port, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID); process 0 killed after kill0 of its spans when kill0 >
    0 (then no merge yet). Otherwise the merged TSV must equal `want` and
    no shard file may stay. Returns (outputs, RESULT dicts, the world's
    wall: first launch to process 0's exit, process 0's run log events)."""
    out = args[args.index("--output") + 1]
    addr = f"127.0.0.1:{free_port()}"
    ranks = [{"JAX_COORDINATOR_ADDRESS": addr, "JAX_NUM_PROCESSES": str(n_proc), "JAX_PROCESS_ID": str(p)}
             if coordinated else {"NIMBLE_TPU_NUM_PROCS": str(n_proc), "NIMBLE_TPU_PROC_ID": str(p)}
             for p in range(n_proc)]
    procs = [start_align(f"{label} p{p}", args, {**ranks[p], **(env or {}),
                                                 **({"KILL_AFTER_EMITS": str(kill0)} if kill0 and p == 0 else {})}, d)
             for p in range(n_proc)]
    rcs = [9 if kill0 and p == 0 else 0 for p in range(n_proc)]
    wall = wait_procs(procs, rcs)[0]  # process 0 was launched first
    WORLD_WALLS[label] = wall
    results = [check_align(pr, path, kernels, rc) for pr, rc in zip(procs, rcs)]
    if kill0:
        return [r[0] for r in results], [r[1] for r in results], wall, results[0][2]
    rows = same_file(f"{label}: the merged TSV", out, want)
    no_leftovers(label, os.path.dirname(out))
    merged = [e for e in results[0][2] if e["event"] == "merge"]
    if not merged:
        raise AssertionError(f"{label}: process 0 logged no merge event")
    m = merged[-1]
    say("world", f"{label}: {n_proc} processes, merged TSV == {os.path.basename(want)} ({rows} rows), no shard "
        f"left; world wall {wall:.2f} s (first launch to process 0's exit), merge: {m['bytes'] / 1e6:.1f} MB "
        f"copied in {m['copy_s']:.3f} s after {m['barrier_s']:.3f} s at the barrier; "
        + "; ".join(f"p{p}: {r[1]['wall_s']:.2f} s inside main, launches {r[1]['launches']}"
                    for p, r in enumerate(results)))
    return [r[0] for r in results], [r[1] for r in results], wall, results[0][2]


def phase_resume(work: str, lib: str, fq: str, bam: str, pout: str, se_wall: float, wlib: str, wfq: str):
    """Phase 20: `align --resume` after a hard kill and worlds of processes
    (NIMBLE_TPU_NUM_PROCS / NIMBLE_TPU_PROC_ID) on the card, each output
    byte-identical to the uninterrupted run of an earlier phase: (a) kill
    and resume on phase 5's reads; (b) a two-process world on them, beside
    one process alone; (c) that world with process 0 killed and resumed;
    (d) a two-process world on phase 5's BAM pairs; (e) a two-process
    world on the 20k library (gband); (f) kill and resume
    under `--probe mono` on N_MONO_CUT reads. Resumes run in this process
    (their launches count); killed runs and world processes run in
    subprocesses. Returns the summed launch counts of the in-process runs."""
    t_phase = time.perf_counter()
    d = os.path.join(work, "p20")
    os.makedirs(d)
    cores = os.cpu_count() or 1
    half = str(max(1, cores // 2))
    se_want = os.path.join(work, "se", "out.tsv")
    counts = []
    try:
        # (a) kill after KILL_SPANS spans, then --resume here
        a_out = os.path.join(d, "a.tsv")
        a_args = ["--reference", lib, "--output", a_out, "--input", fq, "-c", str(cores)]
        prog = kill_at("(a) group single-end reads", a_args, KILL_SPANS, "group", d)
        span = prog["span"]
        c, _ = resume_here("(a) resume", a_args, N_READS, ["kmer_keys"], "group", prog["reads_done"])
        counts.append(c)
        rows = same_file("(a) resumed TSV", a_out, se_want)
        no_leftovers("(a)", d)
        say("resume", f"(a) resumed TSV == phase 5's se/out.tsv ({rows} rows), no sidecar left")

        # (b) one process alone, then a world of two, -c halved, reader
        # batches of half a span (each inside one span, so skippable)
        wenv = {"NIMBLE_TPU_READER_BATCH": str(span // 2)}
        single_out = os.path.join(d, "b_single.tsv")
        proc = start_align("(b) one process", ["--reference", lib, "--output", single_out, "--input", fq,
                                               "-c", str(cores)], {}, d)
        single_wall, = wait_procs([proc], [0])
        _, res, _ = check_align(proc, "group", ["kmer_keys"])
        same_file("(b) one process's TSV", single_out, se_want)
        b_args = ["--reference", lib, "--output", os.path.join(d, "b.tsv"), "--input", fq, "-c", half]
        outs, _, wall, _ = world("(b) world", b_args, 2, N_READS, se_want, "group", ["kmer_keys"], d, wenv)
        decode_shard_lines("(b) world", outs, N_READS)
        say("world", f"(b) {N_READS} reads: world of 2 (-c {half} each) {wall:.2f} s, one process in a subprocess "
            f"{single_wall:.2f} s ({res['wall_s']:.2f} s inside main), phase 5's run in this process "
            f"{se_wall:.2f} s; one process / world {single_wall / wall:.3f}")

        # (c) the world of (b), process 0 killed after WORLD_KILL_SPANS of
        # its spans, then resumed here (it merges)
        c_out = os.path.join(d, "c.tsv")
        c_args = ["--reference", lib, "--output", c_out, "--input", fq, "-c", half]
        world("(c) world, process 0 killed", c_args, 2, N_READS, se_want, "group", ["kmer_keys"], d, wenv,
              kill0=WORLD_KILL_SPANS)
        with open(c_out + ".shard0.progress.json") as f:
            p0 = json.load(f)
        # process 0 owns spans 0, 2, 4, ...: its checkpoint sits after the
        # last of them before the one it was killed in
        want_from = (2 * (WORLD_KILL_SPANS - 2) + 1) * span
        if p0["reads_done"] != want_from:
            raise AssertionError(f"(c) process 0's sidecar names read {p0['reads_done']}, not {want_from}")
        c, _ = resume_here("(c) process 0 resumed", c_args, N_READS, ["kmer_keys"], "group", want_from,
                           {**wenv, "NIMBLE_TPU_NUM_PROCS": "2", "NIMBLE_TPU_PROC_ID": "0"})
        counts.append(c)
        rows = same_file("(c) merged TSV", c_out, se_want)
        no_leftovers("(c)", d)
        say("world", f"(c) merged TSV after process 0's resume == phase 5's se/out.tsv ({rows} rows), no shard left")

        # (d) a world of two on the BAM pairs: the BAM reader has no
        # set_skip, ownership alone shards the work
        d_args = ["--reference", lib, "--output", os.path.join(d, "d.tsv"), "--input", bam, "-c", half]
        world("(d) BAM pairs world", d_args, 2, N_PAIRS, pout, "group", ["kmer_keys"], d)

        # (e) the 20k library (gband): a world of two. Its kill and resume
        # (about 46 s of the script on an H100 host) is left out for the time
        # limit; tests/test_torch_resume.py holds gband resumes on the CPU
        wide_want = os.path.join(work, "wide", "out_se.tsv")
        # the span of phase 11's single-end run on the card: the largest
        # gband chunk in the run log (pairs halve it, the CPU caps it)
        gband_span = max(e["chunk_size"] for e in run_events(os.environ["NIMBLE_TPU_RUNLOG"])
                         if e["event"] == "engine" and e["path"] == "gband")
        ew_args = ["--reference", wlib, "--output", os.path.join(d, "e_world.tsv"), "--input", wfq, "-c", half]
        outs = world("(e) gband world", ew_args, 2, N_WIDE_READS, wide_want, "gband", WIDE_KERNELS, d,
                     {"NIMBLE_TPU_READER_BATCH": str(gband_span // 2)})[0]
        decode_shard_lines("(e) gband world", outs, N_WIDE_READS)

        # (f) --probe mono on the first N_MONO_CUT reads: uninterrupted,
        # killed, resumed
        cut = gz_head(fq, os.path.join(d, f"reads_{N_MONO_CUT}.fastq.gz"), N_MONO_CUT)
        f_full = os.path.join(d, "f_full.tsv")
        _, _, c = drive("(f) mono, uninterrupted", ["--reference", lib, "--output", f_full, "--input", cut,
                                                    "-c", str(cores), *MONO], N_MONO_CUT, ["kmer_keys", "mono_probe"],
                        path="mono")
        counts.append(c)
        f_out = os.path.join(d, "f.tsv")
        f_args = ["--reference", lib, "--output", f_out, "--input", cut, "-c", str(cores), *MONO]
        prog = kill_at("(f) mono single-end reads", f_args, MONO_KILL_SPANS, "mono", d)
        c, _ = resume_here("(f) resume (--probe mono)", f_args, N_MONO_CUT, ["kmer_keys", "mono_probe"], "mono",
                           prog["reads_done"])
        counts.append(c)
        rows = same_file("(f) resumed TSV", f_out, f_full)
        no_leftovers("(f)", d)
        say("resume", f"(f) resumed mono TSV == the uninterrupted mono run ({rows} rows), no sidecar left")
    finally:
        for p in _PROCS:
            if p.poll() is None:
                p.kill()
                p.wait()
    say("resume", f"phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def run_cli(tag: str, argv, d: str, rc: int = 0, env=None):
    """One process of the port's CLI (start_cli), waited for; it must exit
    `rc`. Returns (seconds from launch to exit, its output, its RESULT dict
    or None, its run log events)."""
    proc = start_cli(tag, argv, env or {}, d)
    wall, = wait_procs([proc], [rc])
    say("proc", f"{tag}: exit {rc}, {wall:.2f} s from launch to exit")
    out = proc_output(proc)
    res = json.loads(re.search(r"^RESULT (.*)$", out, re.M).group(1)) if rc == 0 else None
    return wall, out, res, run_events(proc[2])


def fresh_library(lib: str, d: str) -> str:
    """A copy of a library JSON in a directory of its own: no index, no
    sidecar beside it."""
    os.makedirs(d)
    return shutil.copy(lib, d)


def built_nothing(label: str, events) -> None:
    """An align's run log: the index loaded, no kernel library, index or
    gband sidecar built."""
    idx = [e["source"] for e in events if e["event"] == "index"]
    built = [e["event"] for e in events if e["event"] == "kernel_build"
             or (e["event"] in ("index", "gband_sidecar") and e["source"] == "built")]
    if idx != ["loaded"] or built:
        raise AssertionError(f"{label}: index {idx}, built {built}: not everything was loaded")


def phase_pipeline(work: str, lib: str, pairs, bam_p5: str, pout: str):
    """Phase 21: BASELINE config 4 as a user runs it, one process of the
    port's CLI per subcommand (PROC_RUNNER), on phase 5's tagged pairs and
    HLA-100: fastq-to-bam -> index --warm 100 --paired on a fresh copy of
    the library (after the kernel library is removed, so that warm builds
    it, as on a fresh checkout) -> align -> report -> plot. The align must
    load what warm left (its run log) and write phase 5's TSV, the report
    its counts. Beside it, one cold align on a second fresh copy, with no
    index and no kernel library: the same bytes. Returns the launch counts
    of warm, the warmed align and the cold align."""
    from nimble_tpu_torch.align import kernels as K

    t_phase = time.perf_counter()
    d = os.path.join(work, "p21")
    os.makedirs(d)
    cores = str(os.cpu_count() or 1)
    r1, r2, whitelist = pairs
    walls, counts = {}, []
    try:
        bam = os.path.join(d, "tagged.bam")
        walls["fastq-to-bam"], *_ = run_cli("fastq-to-bam", ["fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2,
                                                             "--map", whitelist, "--output", bam, "-c", cores], d)
        with open(bam, "rb") as f, open(bam_p5, "rb") as g:
            bam_same = f.read() == g.read()

        # the cold align: a fresh library, no index, no kernel library
        shutil.rmtree(K.BUILD_DIR, ignore_errors=True)
        cold_lib = fresh_library(lib, os.path.join(d, "cold"))
        cold_tsv = os.path.join(d, "cold.tsv")
        cold_wall, _, res, ev = run_cli("align (cold)", ["align", "--reference", cold_lib, "--output", cold_tsv,
                                                         "--input", bam, "-c", cores, "--device", "cuda"], d)
        counts.append(res["launches"])
        cold_built = {e["event"]: e["wall_s"] for e in ev if e["event"] in ("index", "kernel_build")}
        if set(cold_built) != {"index", "kernel_build"}:
            raise AssertionError(f"the cold align built {sorted(cold_built)}, not the index and the kernel library")
        same_file("the cold align's TSV", cold_tsv, pout)

        # index --warm, then the pipeline on what it left
        shutil.rmtree(K.BUILD_DIR, ignore_errors=True)
        warm_lib = fresh_library(lib, os.path.join(d, "warm"))
        walls["index --warm"], out, res, ev = run_cli("index --warm", ["index", "--reference", warm_lib, "--warm",
                                                                       "100", "--paired"], d)
        counts.append(res["launches"])
        for ln in out.splitlines():
            if ln.startswith(("Indexed", "Warmed", "  ")):
                say("pipeline", f"index --warm: {ln.strip()}")
        if not [e for e in ev if e["event"] == "kernel_build"] or "kernel library: " not in out:
            raise AssertionError("index --warm did not build the kernel library")
        tsv = os.path.join(d, "out.tsv")
        walls["align"], _, res, ev = run_cli("align", ["align", "--reference", warm_lib, "--output", tsv, "--input",
                                                       bam, "-c", cores, "--device", "cuda"], d)
        counts.append(res["launches"])
        built_nothing("align after index --warm", ev)
        if res["launches"]["kmer_keys"] <= 0:
            raise AssertionError("the warmed align never launched the kmer_keys kernel")
        rows = same_file("the warmed align's TSV", tsv, pout)
        st = {e["stage"]: e["wall_s"] for e in ev if e["event"] == "stage_end"}
        counts_tsv = os.path.join(d, "counts.tsv")
        walls["report"], *_ = run_cli("report", ["report", "-i", tsv, "-o", counts_tsv], d)
        same_file("the count TSV", counts_tsv, os.path.join(os.path.dirname(pout), "counts.tsv"))
        html = os.path.join(d, "report.html")
        if importlib.util.find_spec("matplotlib") is None:
            say("pipeline", "plot left out: matplotlib is not installed here, and the port's plot, like the "
                "reference's, draws its figures with it")
        else:
            walls["plot"], *_ = run_cli("plot", ["plot", "--input_file", tsv, "--output_file", html], d)
            if os.path.getsize(html) == 0:
                raise AssertionError("plot wrote an empty report")
    finally:
        for p in _PROCS:
            if p.poll() is None:
                p.kill()
                p.wait()
    total = sum(walls.values())
    say("pipeline", "walls from launch to exit: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; sum {total:.2f} s, {N_PAIRS / total:,.0f} pairs/s; fastq-to-bam alone "
        f"{N_PAIRS / walls['fastq-to-bam']:,.0f} pairs/s (its BAM == phase 5's: {bam_same})")
    say("pipeline", f"align after warm: index load {st.get('index_build', 0.0):.2f} s, engine build "
        f"{st.get('engine_build', 0.0):.2f} s, nothing built, TSV == phase 5's ({rows} rows), counts == phase "
        f"5's; cold align {cold_wall:.2f} s (index build {cold_built['index']:.2f} s, kernel library "
        f"{cold_built['kernel_build']:.2f} s) against the warmed {walls['align']:.2f} s, the same bytes")
    say("pipeline", f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_profile(work: str, lib: str, fq: str):
    """Phase 22: one in-process align of phase 8's reads under
    NIMBLE_TPU_PROFILE; the trace must name the kmer_keys kernel (the
    symbol csrc/kmer_keys.cu launches), hold the feeder's and the emission
    thread's spans and the engine's stage ranges with the kmer_keys kernel
    under `engine.keys` (trace_summary), with each range of a stage of the
    run log starting between its stamps (`t_ns`, `open_ns`; 1 ms of slack),
    and the TSV must equal the unprofiled
    run's. Returns the launch counts of both runs."""
    from nimble_tpu_torch import trace_summary

    d = os.path.join(work, "p22")
    trace_dir = os.path.join(d, "trace")
    os.makedirs(d)
    outs = {k: os.path.join(d, f"{k}.tsv") for k in ("profiled", "plain")}
    log = os.environ["NIMBLE_TPU_RUNLOG"]
    seen = os.path.getsize(log)
    with environ({"NIMBLE_TPU_PROFILE": trace_dir}):
        wall_p, _, c1 = drive("(22) profiled group reads", ["--reference", lib, "--output", outs["profiled"],
                                                            "--input", fq], N_CMP_READS, ["kmer_keys"], path="group")
    with open(log, "rb") as f:  # the profiled run's events alone
        f.seek(seen)
        profiled = [json.loads(ln) for ln in f.read(os.path.getsize(log) - seen).splitlines() if ln.strip()]
    wall, _, c2 = drive("(22) the same, unprofiled", ["--reference", lib, "--output", outs["plain"], "--input", fq],
                        N_CMP_READS, ["kmer_keys"], path="group")
    rows = same_file("(22) the profiled TSV", outs["profiled"], outs["plain"])
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"(22) the trace directory holds {traces}, not one trace")
    with open(traces[0]) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    kk = [e for e in kernels if "kmer_keys_kernel" in e.get("name", "")]
    if not kk:
        raise AssertionError(f"(22) the trace names no kmer_keys_kernel among its {len(kernels)} kernels")
    summary = trace_summary.summarize(trace, profiled)
    spans = {name: set(table) for name, table in summary["threads"].items()}
    if not ({"pipeline.pack"} <= spans.get("nimble-feed", set())
            and {"engine.collect", "pipeline.emit"} <= spans.get("nimble-emit", set())):
        raise AssertionError(f"(22) the trace lacks the feeder's or the emission thread's spans: {spans}")
    stages = ("engine.keys", "engine.probe", "engine.score", "engine.select", "engine.combine", "engine.pack")
    if not all(summary["device_s"].get(s, 0) > 0 for s in stages):
        raise AssertionError(f"(22) a stage range holds no device time: {summary['device_s']}")
    late = [s for s in summary["stamps"] if abs(s["us"]) > 1000]
    if late or not summary["stamps"]:
        raise AssertionError(f"(22) the run log's stage stamps are off their ranges: {summary['stamps']}")
    say("profile", "(22) device s by stage range: " + ", ".join(
        f"{k} {v:.4f}" for k, v in summary["device_s"].items()) + "; stamps within "
        f"{max(abs(s['us']) for s in summary['stamps']):.0f} us")
    say("profile", f"(22) {os.path.basename(traces[0])}, {os.path.getsize(traces[0]) / 1e6:.1f} MB: "
        f"{len(kernels)} kernel records, {len(kk)} of them {kk[0]['name'][:60]!r} "
        f"({sum(e['dur'] for e in kk) / 1e3:.4f} ms on the card); TSV == the unprofiled run's ({rows} rows); "
        f"wall {wall_p:.2f} s profiled, {wall:.2f} s not")
    return {k: c1[k] + c2[k] for k in c1}


def phase_distributed(work: str, reports):
    """Phase 23: `report --distributed 1` on the card, in-process, on phase
    18's (b) and (c) TSVs: --device's bytes, and within its near-tie rule
    the host report's; rows/s beside --device's, the exchange's blk and
    buffer rows. Then `--distributed 2` on this machine's one card must
    refuse, naming the device count."""
    from nimble_tpu_torch import report_bench as RB

    d = os.path.join(work, "report")
    log = os.environ["NIMBLE_TPU_RUNLOG"]
    for tag, n in (("(b)", N_REPORT_ROWS), ("(c)", N_REPORT_WIDE)):
        runs = reports[tag]
        tsv = os.path.join(d, f"{tag}.tsv")
        out = os.path.join(d, f"{tag}_distributed1.tsv")
        wall, _, ev = RB.run_report(tsv, out, ["--distributed", "1"])
        xc = [e for e in run_events(log) if e["event"] == "report_distributed"][-1]
        same_file(f"(23) {tag} --distributed 1 against --device", out, runs["--device"][1])
        RB.hold_to_host(f"(23) {tag} --distributed 1", runs["host"][1], out, ev["near_ties"])
        dev_wall = runs["--device"][0]
        say("distributed", f"(23) {tag} {n} rows: --distributed 1 {wall:.3f} s, {n / wall:,.0f} rows/s, against "
            f"--device {dev_wall:.3f} s, {n / dev_wall:,.0f} rows/s; == --device's bytes; exchange blk {xc['blk']}, "
            f"buffer_rows {xc['buffer_rows']}, placement {xc['place_s']:.3f} s, exchange {xc['exchange_s']:.3f} s")
    n_dev = torch.cuda.device_count()
    out = os.path.join(d, "refused.tsv")
    _, text, _, _ = run_cli("report --distributed 2", ["report", "-i", os.path.join(d, "(b).tsv"), "-o", out,
                                                       "--distributed", str(n_dev + 1)], d, rc=1)
    want = f"needs {n_dev + 1} CUDA devices, and {n_dev} {'is' if n_dev == 1 else 'are'} visible"
    if want not in text or os.path.exists(out):
        raise AssertionError(f"(23) --distributed {n_dev + 1} did not refuse as it should:\n{text[-2000:]}")
    say("distributed", f"(23) --distributed {n_dev + 1} on {n_dev} card(s) refused (exit 1): {want}")


def dense_out(out: dict, W: int) -> dict:
    """An engine's outputs with dense `bits`, whatever its wire."""
    from nimble_tpu_torch.align.engine import expand_band_rows_np, ids_to_bits_np

    if "band_rows" in out:
        Pw, Wm = out.pop("band_meta")
        out["bits"] = expand_band_rows_np(out.pop("band_rows"), Pw, Wm)
    if "ids" in out:
        out["bits"] = ids_to_bits_np(out.pop("ids"), W)
    return out


def last_event(name: str) -> dict:
    """The run log's last `name` event."""
    return [e for e in run_events(os.environ["NIMBLE_TPU_RUNLOG"]) if e["event"] == name][-1]


def mesh_grids(tag: str, index, config, codes, lens, grids, kernels, group_probe=None):
    """Phase 24 (b) on one workload: for each grid, an engine on
    make_mesh(n_data, n_feature, devices) (its launches counted from zero),
    the devices cuda:0 .. cuda:n-1 where n cards are visible, else cuda:0
    n times, and the same grid on [cpu] * n with the plain versions;
    score, pass_ and the full bits, padding words included, must agree
    exactly, and the (2, 1) grid must equal the unmeshed cuda engine.
    Returns (summed launch counts, max |diff|)."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len
    from nimble_tpu_torch.parallel.mesh import make_mesh

    wrappers = {"kmer_keys": K.kmer_keys, "mono_probe": K.mono_probe, "band_tree_expand": K.band_tree_expand,
                "intersect_class_bits": K.intersect_class_bits}
    counts = {k: 0 for k in wrappers}
    W = index.bitset_words
    L = _round_len(READ_LEN)
    dev = torch.device("cuda", 0)
    cards = torch.cuda.device_count()

    def build(grid, d):
        t0 = time.perf_counter()
        n = 0 if grid is None else grid[0] * grid[1]
        devices = [torch.device("cuda", i) for i in range(n)] if d.type == "cuda" and n <= cards else [d] * n
        mesh = None if grid is None else make_mesh(*grid, devices)
        eng = AlignEngine(index, config, d, chunk_size=MESH_CHUNK, max_len=L, group_probe=group_probe, mesh=mesh)
        return eng, time.perf_counter() - t0

    max_err = 0
    for grid in grids:
        eng, t_build = build(grid, dev)
        for w in wrappers.values():
            w.launches = 0
        calls = []

        def capture(ids, matched, class_bits):  # every intersection of the step, each slice's
            calls.append((ids.clone(), matched.clone(), class_bits))
            return K.intersect_class_bits(ids, matched, class_bits)

        TE.intersect_class_bits = capture
        t0 = time.perf_counter()
        try:
            got = dense_out(eng.align_batch(codes, lens), W)
            torch.cuda.synchronize()
        finally:
            TE.intersect_class_bits = K.intersect_class_bits
        wall = time.perf_counter() - t0
        for k, w in wrappers.items():
            counts[k] += w.launches
        ran = {k: w.launches for k, w in wrappers.items()}
        for k in kernels:
            if ran[k] <= 0:
                raise AssertionError(f"(24) {tag} {grid}: the grid never launched the {k} kernel")
        for i, args in enumerate(calls):  # the kernel against its plain version on each slice's arguments
            max_err = max(max_err, check_intersect(f"(24) {tag} {grid} call {i}", *args, quiet=True))
            walk = KB.intersect_walk(*args)
            say("mesh", f"(24b) {tag} grid {grid[0]}x{grid[1]} intersect_class_bits call {i}: B={args[0].shape[0]} "
                f"W={args[2].shape[1]} equals the plain version; reads empty after the first row "
                f"{walk['empty_at_first']}, emptied with runs left {walk['emptied_early']}; sectors a run needs "
                f"{walk['sectors_per_run']:.2f}; runs a read {walk['mean_runs']:.2f}")
        del calls
        path, shard_bytes, chunk, held = eng.path, eng.shard_table_bytes, eng.chunk_size, eng.table_bytes
        where = [str(x) for x in eng.mesh.devices]
        del eng
        torch.cuda.empty_cache()
        cpu, t_cpu_build = build(grid, torch.device("cpu"))
        t0 = time.perf_counter()
        want = dense_out(cpu.align_batch(codes, lens), W)
        cpu_wall = time.perf_counter() - t0
        del cpu
        W_pad = -(-W // grid[1]) * grid[1]
        if got["bits"].shape != (codes.shape[0], W_pad):
            raise AssertionError(f"(24) {tag} {grid}: bits {got['bits'].shape}, not ({codes.shape[0]}, {W_pad})")
        for k in ("score", "pass_", "bits"):
            err = int(np.abs(got[k].astype(np.int64) - want[k].astype(np.int64)).max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"(24) {tag} {grid}: {k} on the card differs from the CPU grid's (max |diff| {err})")
        extra = ""
        if grid == (2, 1):
            base, _ = build(None, dev)
            alone = dense_out(base.align_batch(codes, lens), W)
            del base
            torch.cuda.empty_cache()
            if not all(np.array_equal(alone[k], got[k]) for k in ("score", "pass_", "bits")):
                raise AssertionError(f"(24) {tag} (2, 1): the grid differs from the unmeshed cuda engine")
            extra = "; == the unmeshed cuda engine"
        say("mesh", f"(24b) {tag} grid {grid[0]}x{grid[1]} on {where}: path {path}, chunk "
            f"{chunk}, W {W} -> {W_pad}, shards' table bytes {[round(b / 1e6, 1) for b in shard_bytes]} MB "
            f"({held / 1e6:.1f} MB held on the cards); build "
            f"{t_build:.2f} s, {codes.shape[0]} reads {wall:.3f} s, launches {ran}; == the same grid on [cpu] x "
            f"{grid[0] * grid[1]} (build {t_cpu_build:.2f} s, run {cpu_wall:.2f} s): score, pass_ and bits with "
            f"padding, {int(got['pass_'].sum())} passing{extra}")
    return counts, max_err


def phase_mesh(work: str, lib: str, fq: str, bam: str, pout: str, se_wall: float, wlib: str, wfq: str):
    """Phase 24: `align --mesh` and the coordinated world on the one card.
    (a) `--mesh auto` (a 1 x 1 grid) on phase 5's reads and BAM pairs, each
    TSV == phase 5's; (b) grids (2, 1), (1, 2) and (2, 2) of cuda:0 on the
    first N_MESH_READS reads of HLA-100 (group, and monocls at W = 4 on the
    feature split), of HLA-100's mono index ((2, 1): mono_probe), and of
    the 20k library off the group probe over class_bits (monocls, its class table split on the feature axis)
    and with its class bands ((2, 1): band_tree_expand), each held against
    the same grid of CPU shards and (2, 1) against the unmeshed engine; (c)
    a coordinated world of two CLI processes on phase 5's reads, merged TSV
    == phase 5's; (d) `--mesh
    data=N+1` on N cards exits 1. Returns the in-process runs' summed launch
    counts and (b)'s max |diff| by kernel."""
    from nimble_tpu_torch import kernel_bench as KB
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner
    from nimble_tpu_torch.config import load_library
    from nimble_tpu_torch.index.builder import build_index
    from nimble_tpu_torch.parallel.mesh import plan_index_placement

    t_phase = time.perf_counter()
    d = os.path.join(work, "p24")
    os.makedirs(d)
    cores = str(os.cpu_count() or 1)
    half = str(max(1, (os.cpu_count() or 1) // 2))
    se_want = os.path.join(work, "se", "out.tsv")
    counts = []

    # (a) --mesh auto: one shard on the one card, through the split path
    a_se = os.path.join(d, "a_se.tsv")
    wall, _, c = drive("(24a) --mesh auto, group single-end reads", ["--reference", lib, "--output", a_se, "--input",
                                                                     fq, "-c", cores, "--mesh", "auto"],
                       N_READS, ["kmer_keys"], path="group")
    counts.append(c)
    span = last_event("engine")["chunk_size"]
    mesh_ev = last_event("mesh")
    rows = same_file("(24a) --mesh auto single-end TSV", a_se, se_want)
    a_pe = os.path.join(d, "a_pe.tsv")
    pe_wall, _, c = drive("(24a) --mesh auto, group BAM pairs", ["--reference", lib, "--output", a_pe, "--input", bam,
                                                                "-c", cores, "--mesh", "auto"],
                          N_PAIRS, ["kmer_keys"], path="group")
    counts.append(c)
    pe_rows = same_file("(24a) --mesh auto pairs TSV", a_pe, pout)
    say("mesh", f"(24a) the mesh event: {json.dumps({k: mesh_ev[k] for k in ('n_data', 'n_feature', 'devices')})}; "
        f"TSVs == phase 5's ({rows} and {pe_rows} rows); walls {wall:.2f} s (phase 5: {se_wall:.2f} s) and "
        f"{pe_wall:.2f} s for the pairs")

    # (c) a coordinated world of two on phase 5's reads, as phase 20 (b)'s
    # world but ranked by the coordinator
    wenv = {"NIMBLE_TPU_READER_BATCH": str(span // 2)}
    c_args = ["--reference", lib, "--output", os.path.join(d, "c.tsv"), "--input", fq, "-c", half]
    try:
        outs, res, cwall, _ = world("(24c) coordinated world", c_args, 2, N_READS, se_want, "group", ["kmer_keys"],
                                    d, wenv, coordinated=True)
    finally:
        for p in _PROCS:
            if p.poll() is None:
                p.kill()
                p.wait()
    decode_shard_lines("(24c) coordinated world", outs, N_READS)
    say("mesh", f"(24c) coordinated world of 2 (JAX_COORDINATOR_ADDRESS, gloo): {cwall:.2f} s (p0 "
        f"{res[0]['wall_s']:.2f} s and p1 {res[1]['wall_s']:.2f} s inside main); phase 20 (b)'s "
        f"NIMBLE_TPU_NUM_PROCS world {WORLD_WALLS.get('(b) world', float('nan')):.2f} s")

    # (d) a grid larger than the visible cards
    from nimble_tpu_torch.__main__ import main as port_main

    n_dev = torch.cuda.device_count()
    out = os.path.join(d, "refused.tsv")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port_main(["align", "--reference", lib, "--output", out, "--input", fq, "--mesh", f"data={n_dev + 1}",
                        "--device", "cuda"])
    want = (f"needs {n_dev + 1} devices, and {n_dev} {'is' if n_dev == 1 else 'are'} visible: "
            f"{[f'cuda:{i}' for i in range(n_dev)]}")
    if rc != 1 or want not in err.getvalue() or os.path.exists(out):
        raise AssertionError(f"(24d) --mesh data={n_dev + 1} did not refuse as it should (exit {rc}):\n"
                             f"{err.getvalue()[-2000:]}")
    say("mesh", f"(24d) --mesh data={n_dev + 1} on {n_dev} card(s): exit 1, no file; {want}")

    # (b) grids of the one card against the same grids of CPU shards; the
    # monocls host tables are built once per index and shared by every
    # engine (they are not changed by the engines)
    L = _round_len(READ_LEN)
    codes, lens = KB.fastq_head(fq, N_MESH_READS, L)
    wcodes, wlens = KB.fastq_head(wfq, N_MESH_READS, L)
    memo = {}
    build_monocls = TT.build_monocls_tables

    def monocls_once(ix):
        if id(ix.table_hi) not in memo:
            memo[id(ix.table_hi)] = build_monocls(ix)
        return memo[id(ix.table_hi)]

    TT.build_monocls_tables = monocls_once
    errs = {"kmer_keys": 0, "mono_probe": 0, "band_tree_expand": 0, "intersect_class_bits": 0}
    try:
        r = make_runner(lib, os.devnull)
        c, e = mesh_grids("HLA-100", r.index, r.config, codes, lens, MESH_GRIDS, ["kmer_keys"])
        counts.append(c)
        errs["kmer_keys"] = max(errs["kmer_keys"], e)
        config, data = load_library(lib)
        mono_ix = build_index(data, config, group_g=0)  # in memory: the sidecar keeps the group index
        c, e = mesh_grids("HLA-100 mono index", mono_ix, config, codes, lens, [(2, 1)], ["kmer_keys", "mono_probe"])
        counts.append(c)
        errs["mono_probe"] = max(errs["mono_probe"], e)
        w = make_runner(wlib, os.devnull)
        plan = plan_index_placement(w.index, n_chips=2, device=torch.device("cuda", 0))
        say("mesh", f"(24b) plan_index_placement of the 20k index at this card's "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB: {json.dumps(plan)}")
        bits_ix = copy.copy(w.index)
        bits_ix._torch_class_bands = None  # the class table as class_bits, split on the feature axis
        c, e = mesh_grids("20k library, class_bits", bits_ix, w.config, wcodes, wlens, MESH_GRIDS,
                          ["kmer_keys", "intersect_class_bits"], group_probe=False)
        counts.append(c)
        errs["kmer_keys"] = max(errs["kmer_keys"], e)
        errs["intersect_class_bits"] = max(errs["intersect_class_bits"], e)
        c, e = mesh_grids("20k library, class bands", w.index, w.config, wcodes, wlens, [(2, 1)],
                          ["kmer_keys", "band_tree_expand"], group_probe=False)
        counts.append(c)
        errs["band_tree_expand"] = max(errs["band_tree_expand"], e)
        memo.clear()
        del r, w, bits_ix, mono_ix
    finally:
        TT.build_monocls_tables = build_monocls
    say("mesh", f"phase 24 in {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(c[k] for c in counts) for k in counts[0]}, errs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--mesh-only"]):
        print("usage: python3 chip_smoke.py [--mesh-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import nimble_tpu_torch  # noqa: F401  (raises outside a checkout of the repo)

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nimble_smoke_") as work:
        # the pipeline's stage log (index and engine build walls) for
        # drive(); set before the first event (the kernel build's) opens it
        os.environ["NIMBLE_TPU_RUNLOG"] = os.path.join(work, "runlog.jsonl")
        name, smi = phase_device()
        phase_build()
        lib, fq = phase_data(work)
        if argv:
            # phase 24 alone, with the phases whose files it reads (5, 9):
            # on a machine of several cards its grids take distinct cards
            bam, pout, se_wall, _, _ = phase_main_path(work, name, lib, fq)
            wlib, wfq = phase_wide_data(work)[:2]
            print(json.dumps({"mesh_only": phase_mesh(work, lib, fq, bam, pout, se_wall, wlib, wfq)}))
            say("done", f"phases 1-3, 5, 9 and 24 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        kk_err, kk_ms, kk_plain, kk_bound = phase_kernel(lib, fq)
        phase_goldens(work)
        bam, pout, se_wall, group_counts, pairs = phase_main_path(work, name, lib, fq)
        nm1_lib, nm1_fq = phase_mono_data(work, lib)
        mp_err, mp_ms, mp_plain, mp_bound = phase_mono_kernel(lib, fq, nm1_lib, nm1_fq)
        mono_counts = phase_mono_main(work, lib, fq, bam, nm1_lib, nm1_fq)
        cmp_lib, cmp_fq = phase_cuda_vs_cpu(work)
        wlib, wfq, wcmp, wr1, wr2 = phase_wide_data(work)
        bt_err, bt_ms, bt_plain, bt_bound, wide_loaded = phase_wide_kernel(wlib, wfq)
        wide_counts = phase_wide_main(work, wlib, wfq, wr1, wr2)
        gband_tsv = compare_devices("20k library, gband", wlib, wcmp)
        layout_counts = phase_gband_layouts(wlib, wfq, wcmp, gband_tsv, wide_loaded, smi)
        del wide_loaded
        cls_err, cls_bands, (cls_inters, ic_synth_err), cls_counts = phase_cls_paths(work, wlib, wfq, wr1, wr2,
                                                                                     wcmp)
        reports = phase_report(work, pout)
        multi_counts = phase_multi(work, *phase_multi_data(work))
        resume_counts = phase_resume(work, lib, fq, bam, pout, se_wall, wlib, wfq)
        pipeline_counts = phase_pipeline(work, lib, pairs, bam, pout)
        profile_counts = phase_profile(work, cmp_lib, cmp_fq)
        phase_distributed(work, reports)
        mesh_counts, mesh_errs = phase_mesh(work, lib, fq, bam, pout, se_wall, wlib, wfq)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # no single PyTorch call computes any of these functions: library_ms null
    # times and bounds at each kernel's main path (intersect_class_bits's at
    # groupcls B's first chunk); launches summed over every path's runs,
    # errors over every check
    runs = (group_counts, mono_counts, wide_counts, layout_counts, cls_counts, multi_counts, resume_counts,
            pipeline_counts, profile_counts, mesh_counts)
    kernels = [
        ("kmer_keys", "nimble_tpu/align/kernels.py:157", sum(c["kmer_keys"] for c in runs),
         max(kk_err, cls_err, mesh_errs["kmer_keys"]), kk_ms, kk_plain, kk_bound),
        ("mono_probe", "nimble_tpu/align/kernels.py:273",
         mono_counts["mono_probe"] + multi_counts["mono_probe"] + resume_counts["mono_probe"]
         + mesh_counts["mono_probe"],
         max(mp_err, mesh_errs["mono_probe"]), mp_ms, mp_plain, mp_bound),
        ("band_tree_expand", "nimble_tpu/align/kernels.py:394",
         wide_counts["band_tree_expand"] + layout_counts["band_tree_expand"] + cls_counts["band_tree_expand"]
         + resume_counts["band_tree_expand"]
         + mesh_counts["band_tree_expand"], max(bt_err, mesh_errs["band_tree_expand"], *(b[0] for b in cls_bands)),
         bt_ms, bt_plain, bt_bound),
        ("intersect_class_bits", "nimble_tpu/align/engine.py:2392 (XLA while_loop, no pallas_call)",
         sum(c.get("intersect_class_bits", 0) for c in runs),
         max(ic_synth_err, mesh_errs["intersect_class_bits"], *(r[0] for r in cls_inters.values())),
         *cls_inters["B"][1:]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"nimble_tpu_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
         "bound_by": "bytes", "library_ms": None}
        for name, replaces, launches, err, ms, plain, bound in kernels
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
