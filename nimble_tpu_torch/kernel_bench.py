"""Kernel times, and the main paths' set-up and walls, of the checkout this
file sits in, on inputs taken from the port's main paths.

  python3 -m nimble_tpu_torch.kernel_bench prepare WORK
  python3 -m nimble_tpu_torch.kernel_bench run WORK

`prepare` writes the workloads into WORK with the port's generator
(bench_data.py): HLA-100 with 2,097,152 single-end reads, a copy of it for
`--probe mono` and one with num_mismatches = 1, and the 20k-allele library
with 1,048,576 reads and 262,144 pairs. It builds their indexes and the 20k
library's gband sidecar, so that `run` loads them, and lists the paths in
WORK/workloads.json.

`run` prints one JSON line:
  * `align --device cuda` on HLA-100 single-end reads (group probe and
    `--probe mono`) and on the 20k library's reads and pairs, first in the
    process: wall, rate, and the index load and engine build from the
    pipeline's stage log;
  * each kernel's time on the card (`device_ms`) on the arguments that the
    engine `align` builds passes it for the first chunk of the workload's
    reads, captured from engine.align_batch (`captured`): kmer_keys on the
    group path (HLA-100), mono_probe on the mono path (HLA-100 under
    `--probe mono`, and the 2.68 GB table of num_mismatches = 1) and
    band_tree_expand on the gband path (20k library), each with the bytes
    the call must move and its bound (`kernel_bytes`, `bound_ms`).
    mono_probe is timed once more on the same planes with every window
    invalid: its streams alone, no table reads;
  * the 20k engine's set-up by part: index load, gband sidecar load, copy
    to the card.

`run` calls only what the port has had since its gband slice and takes
each table in the layout that checkout's engine ships, so this file, copied
into an older checkout's nimble_tpu_torch/ and run from that checkout's
root, times that checkout on the same WORK. Compare two checkouts in one
call on one card: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import sys
import time

import numpy as np

# bytes per second of the H100 SXM's HBM3 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
READ_LEN = 100
N_READS = 2_097_152
N_WIDE_READS = 1_048_576
N_WIDE_PAIRS = 262_144

# base codes as the port's seq.encode_batch gives them: ACGT -> 0-3, else 4
_CODES = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODES[_b] = _CODES[_b + 32] = _i


def device_ms(fn, reps: int = 25, per_graph: int = 10) -> float:
    """The card's time for one call of fn(): fn() captured `per_graph`
    times into a CUDA graph, the graph replayed `reps` times between CUDA
    events, the median replay divided by per_graph. The launches replay
    back to back, so the host's launch latency is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and first-call work outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float) -> float:
    """The least time the card needs to move n_bytes through HBM."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def kmer_keys_bytes(B: int, L: int, k: int) -> int:
    """Codes and lens read once, seven (B, P) planes written once."""
    return B * L + 4 * B + 19 * B * (L - k + 1)


def mono_probe_bytes(n_windows: int, W: int, table_bytes: int) -> int:
    """Per window: h1, hi, lo and three flag bytes read, bits_f and bits_r
    (2W words) written; plus the table bytes this input needs, once."""
    return n_windows * (15 + 8 * W) + table_bytes


def mono_table_bytes(bucket, h1, hi, lo, valid, W: int) -> int:
    """The table bytes one mono_probe call needs: the S key pairs of each
    distinct row that a valid window probes, and the 2W value words of each
    distinct slot that a valid window matches (either row layout)."""
    import torch

    S = bucket.shape[1] // (2 + 2 * W)
    rows = h1[valid].long()
    keys = bucket[rows, : 2 * S]
    match = (keys[:, :S] == hi[valid][:, None]) & (keys[:, S:] == lo[valid][:, None])
    slot = rows[:, None] * S + torch.arange(S, device=bucket.device)
    n_rows = int(torch.unique(rows).numel())
    n_slots = int(torch.unique(slot[match]).numel())
    return n_rows * 8 * S + n_slots * 8 * W


def band_tree_expand_bytes(B: int, Q1: int, W: int, row_bytes: int) -> int:
    """idx_sel and has_sel read, (B, W) written; plus the distinct band rows
    this input needs, once."""
    return B * Q1 * 5 + 4 * B * W + row_bytes


def kernel_bytes(name: str, args) -> int:
    """The bytes the wrapper `name` must move for these arguments."""
    import torch

    if name == "kmer_keys":
        codes, _lens, k, _nb = args
        return kmer_keys_bytes(codes.shape[0], codes.shape[1], k)
    if name == "mono_probe":
        bucket, h1, hi, lo, _fc, _pal, valid, stash, W = args
        return mono_probe_bytes(hi.numel(), W, mono_table_bytes(bucket, h1, hi, lo, valid, W) + stash.numel() * 4)
    table, idx_sel, has_sel, W, _pw = args
    rows = int(torch.unique(idx_sel[has_sel]).numel())
    return band_tree_expand_bytes(idx_sel.shape[0], idx_sel.shape[1], W, rows * table.shape[1] * 4)


def fastq_head(fq: str, B: int, L: int):
    """The first B reads of a gz FASTQ as host (codes (B, L) int8, N-padded,
    lens int32)."""
    codes = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    with gzip.open(fq, "rb") as f:
        for i, line in enumerate(f):
            if i // 4 == B:
                break
            if i % 4 == 1:
                s = np.frombuffer(line.rstrip(b"\n"), dtype=np.uint8)[:L]
                codes[i // 4, : s.shape[0]] = _CODES[s]
                lens[i // 4] = s.shape[0]
    return codes, lens


def captured(eng, codes, lens, name: str):
    """The arguments of the first call that eng.align_batch(codes, lens)
    makes to the kernel wrapper `name` (the engine module's reference to
    it). The engine's tables are kept as they are; other tensors are
    copied."""
    from nimble_tpu_torch.align import engine as TE

    orig = getattr(TE, name)
    tables = [t for t in eng.tables.values() if hasattr(t, "data_ptr")]
    seen = []

    def capture(*args):
        if not seen:
            seen.append(tuple(a.clone() if hasattr(a, "clone") and not any(a is t for t in tables) else a
                              for a in args))
        return orig(*args)

    setattr(TE, name, capture)
    try:
        eng.align_batch(codes, lens)
    finally:
        setattr(TE, name, orig)
    if not seen:
        raise AssertionError(f"the engine never called {name}")
    return seen[0]


def engine(lib: str, group_g=None, device: str = "cuda", chunk_size=None):
    """(runner, the engine that `align` builds for this library and 100 bp
    single-end reads, on the card unless the caller asks for the CPU)."""
    import torch

    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    r = make_runner(lib, os.devnull, group_g=group_g)
    eng = AlignEngine(r.index, r.config, torch.device(device), chunk_size=chunk_size,
                      max_len=_round_len(READ_LEN), paired=False)
    return r, eng


def time_kernel(name: str, args) -> dict:
    from nimble_tpu_torch.align import kernels as K

    fn = getattr(K, name)
    ms = device_ms(lambda: fn(*args))
    n_bytes = kernel_bytes(name, args)
    shape = [list(a.shape) if hasattr(a, "shape") else a for a in args]
    return {"ms": ms, "bytes": n_bytes, "bound_ms": bound_ms(n_bytes), "share": bound_ms(n_bytes) / ms,
            "args": shape}


def align_run(args, n: int) -> dict:
    """`align --device cuda` in-process: wall, rate, and the stage log's
    index load and engine build."""
    import torch

    from nimble_tpu_torch.__main__ import main

    log = os.environ["NIMBLE_TPU_RUNLOG"]
    seen = os.path.getsize(log) if os.path.exists(log) else 0
    t0 = time.perf_counter()
    if main(["align", *args, "--device", "cuda"]) != 0:
        raise RuntimeError(f"align {' '.join(args)} failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(log) as f:
        f.seek(seen)
        ends = [json.loads(ln) for ln in f if ln.strip()]
    stage = {e["stage"]: e["wall_s"] for e in ends if e["event"] == "stage_end"}
    setup = stage.get("index_build", 0.0) + stage.get("engine_build", 0.0)
    return {"n": n, "wall_s": wall, "per_s": n / wall, "index_load_s": stage.get("index_build"),
            "engine_build_s": stage.get("engine_build"), "mono_relayout_s": stage.get("mono_relayout"),
            "after_setup_per_s": n / max(wall - setup, 1e-9)}


def prepare(work: str) -> dict:
    from nimble_tpu_torch import bench_data
    from nimble_tpu_torch.__main__ import main
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.pipeline import make_runner
    from nimble_tpu_torch.native_build import build_native

    build_native()  # the C++ index builder for the 20k library
    p = {}
    p["lib"], p["fq"] = bench_data.write_single(os.path.join(work, "se"), N_READS)
    p["mono_lib"] = os.path.join(work, "mono", "hla100.json")
    os.makedirs(os.path.dirname(p["mono_lib"]))
    shutil.copy(p["lib"], p["mono_lib"])
    with open(p["lib"]) as f:
        config, data = json.load(f)
    config["num_mismatches"] = 1
    p["nm1_lib"] = os.path.join(work, "nm1", "hla100_nm1.json")
    os.makedirs(os.path.dirname(p["nm1_lib"]))
    with open(p["nm1_lib"], "w") as f:
        json.dump([config, data], f)
    p["wide_lib"], p["wide_fq"], p["wide_r1"], p["wide_r2"] = bench_data.write_wide(
        os.path.join(work, "wide"), N_WIDE_READS, N_WIDE_PAIRS)
    for lib, flags in ((p["lib"], []), (p["mono_lib"], ["--probe", "mono"]), (p["nm1_lib"], []),
                       (p["wide_lib"], [])):
        if main(["index", "--reference", lib, *flags]) != 0:
            raise RuntimeError(f"index {lib} failed")
    TT.groupband_tables(make_runner(p["wide_lib"], os.devnull).index)  # writes the sidecar
    with open(os.path.join(work, "workloads.json"), "w") as f:
        json.dump(p, f)
    return p


def run(work: str) -> dict:
    import torch

    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.native_build import build_native

    with open(os.path.join(work, "workloads.json")) as f:
        p = json.load(f)
    os.environ["NIMBLE_TPU_RUNLOG"] = os.path.join(work, f"runlog_{os.getpid()}.jsonl")
    build_native()
    K.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {"root": root, "device": torch.cuda.get_device_name(0), "kernels": {}, "align": {}}
    kern = out["kernels"]
    idx_file = p["wide_lib"] + ".idx.npz"
    side_file = idx_file + ".gband.single.dense.npz"
    stamps = [os.path.getmtime(idx_file), os.path.getmtime(side_file)]

    # the walls first, in a fresh process, as a user's run sees them
    cores = str(os.cpu_count() or 1)
    tsv = os.path.join(work, f"out_{os.getpid()}.tsv")
    runs = (("group single-end", ["--reference", p["lib"], "--input", p["fq"]], N_READS),
            ("mono single-end", ["--reference", p["mono_lib"], "--input", p["fq"], "--probe", "mono"], N_READS),
            ("gband single-end (20k)", ["--reference", p["wide_lib"], "--input", p["wide_fq"]], N_WIDE_READS),
            ("gband pairs (20k)", ["--reference", p["wide_lib"], "--input", p["wide_r1"], p["wide_r2"]],
             N_WIDE_PAIRS))
    for label, args, n in runs:
        out["align"][label] = align_run([*args, "--output", tsv, "-c", cores], n)

    _, eng = engine(p["lib"])
    codes, lens = fastq_head(p["fq"], eng.chunk_size, eng.max_len)
    kern["kmer_keys"] = time_kernel("kmer_keys", captured(eng, codes, lens, "kmer_keys"))
    for label, lib, g in (("mono_probe", p["mono_lib"], 0), ("mono_probe num_mismatches=1", p["nm1_lib"], None)):
        del eng
        torch.cuda.empty_cache()
        _, eng = engine(lib, g)
        codes, lens = fastq_head(p["fq"], eng.chunk_size, eng.max_len)
        args = captured(eng, codes, lens, "mono_probe")
        kern[label] = time_kernel("mono_probe", args)
        kern[label]["windows_hit"] = float((K.mono_probe(*args)[0] != 0).any(dim=-1).float().mean())
        if g == 0:  # the streams alone: no valid window, no table reads
            kern["mono_probe no valid window"] = time_kernel(
                "mono_probe", args[:6] + (torch.zeros_like(args[6]),) + args[7:])
    del eng, args
    torch.cuda.empty_cache()

    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    t0 = time.perf_counter()
    r = make_runner(p["wide_lib"], os.devnull)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    TT.groupband_tables(r.index)
    t_side = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = AlignEngine(r.index, r.config, torch.device("cuda"), chunk_size=None, max_len=_round_len(READ_LEN))
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    out["wide_setup"] = {"index_load_s": t_load, "sidecar_load_s": t_side, "to_card_s": t_h2d,
                         "rebuilt_in_run": stamps != [os.path.getmtime(idx_file), os.path.getmtime(side_file)]}
    codes, lens = fastq_head(p["wide_fq"], eng.chunk_size, eng.max_len)
    kern["band_tree_expand"] = time_kernel("band_tree_expand", captured(eng, codes, lens, "band_tree_expand"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("prepare", "run"))
    ap.add_argument("work", help="directory of the workloads (made by prepare)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    if args.step == "prepare":
        t0 = time.perf_counter()
        prepare(args.work)
        print(json.dumps({"prepared": args.work, "s": time.perf_counter() - t0}), flush=True)
    else:
        print(json.dumps(run(args.work)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
