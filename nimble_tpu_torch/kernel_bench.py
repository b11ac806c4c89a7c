"""Kernel times, and the main paths' set-up and walls, of the checkout this
file sits in, on inputs taken from the port's main paths.

  python3 -m nimble_tpu_torch.kernel_bench prepare WORK
  python3 -m nimble_tpu_torch.kernel_bench run WORK
  python3 -m nimble_tpu_torch.kernel_bench variants WORK

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
    to the card; the page spread of band_tree_expand's arguments.

`variants` prints one JSON line: band_tree_expand on those arguments
against experimental variants of it, built from csrc/band_tree_expand.cu
with a patch (`band_variants`).

`class_stages` and `stage_ms` cut one step of a class-id wide path
(groupcls, monocls, the wide two-choice probe) into its stages and time
each on the card, and `stacked_stages` one step of the stacked engine
(window, merged probe, the libraries' tails, pack); chip_smoke.py prints
them.

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
    pages, idx_sel, has_sel, W, Pw = band_args(args)
    rows = int(torch.unique(idx_sel[has_sel]).numel())
    return band_tree_expand_bytes(idx_sel.shape[0], idx_sel.shape[1], W, rows * (1 + 2 * Pw) * 4)


def band_args(args):
    """(page vector, idx_sel, has_sel, W, Pw) of band_tree_expand's
    arguments, from the re-laid table (pages, bands, idx_sel, has_sel, W) or
    from the [page | band] table of older checkouts (table, idx_sel,
    has_sel, W, Pw)."""
    if args[0].dim() == 1:
        pages, bands, idx_sel, has_sel, W = args
        return pages, idx_sel, has_sel, W, bands.shape[1] // 2
    table, idx_sel, has_sel, W, Pw = args
    return table[:, 0], idx_sel, has_sel, W, Pw


def band_spread(pages, idx_sel, has_sel) -> dict:
    """The page spread band_tree_expand's design depends on, over reads:
    the share with no contributing position, with all at one page, at two
    adjacent pages and with a gap of 2 or more (an empty AND, no band word
    read), and the mean count of contributing positions."""
    import torch

    pages = pages[idx_sel.long().clamp(0, pages.shape[0] - 1)].long()
    top = torch.where(has_sel, pages, torch.iinfo(torch.int64).min).amax(dim=1)
    low = torch.where(has_sel, pages, torch.iinfo(torch.int64).max).amin(dim=1)
    some = has_sel.any(dim=1)
    gap = torch.where(some, top - low, -1)
    share = lambda m: float(m.float().mean())
    return {"no_row": share(~some), "one_page": share(gap == 0), "adjacent": share(gap == 1),
            "gap2": share(gap >= 2), "mean_rows": float(has_sel.sum(dim=1).float().mean())}


def _band_variant_lib(patch):
    """csrc/band_tree_expand.cu with `patch` applied to its text, built
    alone with the library's nvcc flags and loaded."""
    import ctypes
    import subprocess
    import tempfile

    from nimble_tpu_torch.align import kernels as K

    with open(os.path.join(K.CSRC, "band_tree_expand.cu")) as f:
        src = patch(f.read())
    os.makedirs(K.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=K.BUILD_DIR)
    cu, so = os.path.join(tmp, "variant.cu"), os.path.join(tmp, "variant.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    tail = [i64, i32, p, p, i64, i32, i32, p, p]  # n_rows, Pw, idx, has, B, Q1, W, out, stream
    for name, head in (("nt_band_tree_expand", [i32, p, p]), ("nt_band_tree_expand_table", [i32, p])):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = ctypes.c_int, head + tail
    return lib


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise AssertionError(f"band variant: {old!r} is not in csrc/band_tree_expand.cu")
    return src.replace(old, new)


# ordinary (write-back) stores instead of streaming ones
_ORDINARY_STORES = lambda s: _replace(_replace(s, "__stcs(", "ordinary_store("), "namespace {\n", """namespace {
template <class T> __device__ __forceinline__ void ordinary_store(T* p, T v) { *p = v; }
""")
# the zeros stored 4 bytes at a time, one word a lane
_SCALAR_ZEROS = lambda s: _replace(_replace(s, "store_outside(out_r", "store_outside_scalar(out_r"),
                                   "__global__ void", """__device__ void store_outside_scalar(int32_t* out_r, int W, int f0,
                                                                 int nf, int lane) {
  for (int w = lane; w < W; w += 32) {
    if (static_cast<unsigned>(w - f0) >= static_cast<unsigned>(nf)) __stcs(out_r + w, 0);
  }
}

__global__ void""")
# the reference's [page | band] rows of 1 + 2 Pw words, one table
_INTERLEAVED_TABLE = lambda s: s + """
extern "C" int nt_band_tree_expand_table(int device, const void* table, int64_t n_rows, int Pw, const void* idx,
                                         const void* has, int64_t B, int Q1, int W, void* out, void* stream) {
  const int32_t* rows = static_cast<const int32_t*>(table);
  const int64_t E = 1 + 2 * static_cast<int64_t>(Pw);
  return launch(device, Rows{rows, rows + 1, E, E, n_rows}, Pw, idx, has, B, Q1, W, out, stream);
}
"""


def band_variants(args, rounds: int = 2) -> dict:
    """band_tree_expand and experimental variants of it, on the same
    arguments, timed in turn `rounds` times (device_ms, ms):
      * kernel: the committed kernel, on the re-laid table;
      * stores only: Q1 = 0, so the kernel writes the zero output and reads
        no table;
      * page pass only: one more position per read at a row whose page lies
        past the output, so every page is read, the frame is empty and no
        band word is read;
      * ordinary stores: the kernel with write-back stores for st.global.cs;
      * 4-byte zeros: the kernel storing the zeros one word a lane, not 16
        bytes where they are aligned;
      * interleaved table: the kernel reading the reference's [page | band]
        rows of 1 + 2 Pw words, the table as it was before the re-lay;
      * zero_ of the output: PyTorch's fill of a (B, W) int32 tensor, the
        card's own rate for the output's bytes.
    The variants' outputs are checked against the kernel's."""
    import torch

    from nimble_tpu_torch.align import kernels as K

    pages, bands, idx, has, W = args
    n_rows, Pw = bands.shape[0], bands.shape[1] // 2
    B, Q1 = idx.shape
    dev = bands.device
    want = K.band_tree_expand(*args)
    zeros = torch.zeros_like(want)
    page_args = (torch.cat([pages, torch.tensor([1 << 30], dtype=torch.int32, device=dev)]),
                 torch.cat([bands, torch.zeros_like(bands[:1])]),
                 torch.cat([idx, torch.full((B, 1), n_rows, dtype=torch.int32, device=dev)], dim=1).contiguous(),
                 torch.cat([has, torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1).contiguous(), W)
    none = (pages, bands, idx[:, :0].contiguous(), has[:, :0].contiguous(), W)
    ordinary = _band_variant_lib(_ORDINARY_STORES).nt_band_tree_expand
    scalar = _band_variant_lib(_SCALAR_ZEROS).nt_band_tree_expand
    interleaved = _band_variant_lib(_INTERLEAVED_TABLE).nt_band_tree_expand_table
    table = torch.cat([pages[:, None], bands], dim=1)
    out = torch.empty_like(want)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    d = K._device_index(dev)

    def call(fn, *head):
        err = fn(d, *head, n_rows, Pw, idx.data_ptr(), has.data_ptr(), B, Q1, W, out.data_ptr(), stream())
        if err != 0:
            raise RuntimeError(f"band variant launch failed: cudaError {err}")
        return out

    variants = {
        "kernel": lambda: K.band_tree_expand(*args),
        "stores only": lambda: K.band_tree_expand(*none),
        "page pass only": lambda: K.band_tree_expand(*page_args),
        "ordinary stores": lambda: call(ordinary, pages.data_ptr(), bands.data_ptr()),
        "4-byte zeros": lambda: call(scalar, pages.data_ptr(), bands.data_ptr()),
        "interleaved table": lambda: call(interleaved, table.data_ptr()),
        "zero_ of the output": lambda: out.zero_(),
    }
    for name, fn in variants.items():
        res = fn().clone()
        torch.cuda.synchronize()
        expect = zeros if name in ("stores only", "page pass only", "zero_ of the output") else want
        if not torch.equal(res, expect):
            raise AssertionError(f"band variant {name!r} gives other bits")
    times = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            times[name].append(device_ms(fn))
    return times


def class_stages(eng, codes, lens):
    """One single-end step of a class-id engine (groupcls, monocls or the
    wide two-choice probe) on these reads, cut into its stages: (name, fn)
    pairs, each fn taking the previous one's result (the first takes None).
    Run in order they are pack_outputs(align_step(...)): the window stage
    (`class_keys`, the kmer_keys kernel), the probe (`class_probe`: class
    ids, coverage, orientation), the intersection (`intersect_classes`) and
    `combine_mates` + `pack_outputs`."""
    from nimble_tpu_torch.align import engine as TE

    t, p, L = eng.tables, eng.params, codes.shape[1]
    return [
        ("window", lambda _: TE.class_keys(codes, lens, t, p)),
        ("probe", lambda keys: TE.class_probe(keys, lens, L, t, p)),
        ("intersection", lambda pr: (TE.intersect_classes(pr[0], t), *pr[1:])),
        ("combine + pack", lambda mate: TE.pack_outputs(TE.combine_mates(p, lens, mate))),
    ]


def stacked_stages(eng, codes, lens):
    """One single-end step of a stacked engine on these reads, cut into its
    stages as class_stages cuts a class-id step: the window stage (the
    kmer_keys kernel, at k+g-1 on the group stack, at k on the mono stack),
    the merged probe (`stacked_group_probe`, or the mono_probe kernel at S =
    STACK_SLOTS, W = W_cat), the L libraries' tails (window masks,
    coverage, orientation and AND on each word slice, combine_mates) and
    the pack of every library's outputs into one flat tensor."""
    from nimble_tpu_torch.align import stacked as TS

    t, ps, seg = eng.tables, eng.params, eng.seg_words
    W_cat, g = int(seg[-1]), eng.group_g
    mates = [(codes, lens)]
    if g:
        window = lambda _: TS.group_window(codes, lens, t, ps[0], g)
        probe = lambda keys: TS.group_probe_rows(keys, t, W_cat, g)
        tail = lambda *a: TS.group_tail(*a, g)
    else:
        window = lambda _: TS.mono_window(codes, lens, t, ps[0])
        probe = lambda keys: TS.mono_probe_rows(keys, t, W_cat)
        tail = TS.mono_tail
    return [
        ("window", window),
        ("merged probe", probe),
        ("tails", lambda rows: TS.library_tails(ps, seg, tail, mates, [rows])),
        ("pack", TS.pack_stacked),
    ]


def stage_ms(stages, reps: int = 5) -> dict:
    """Each stage's time (ms) on the card: CUDA events around it, the card
    idle before it, so a stage's time is the longer of its kernels' and its
    host's launches (what the step spends on it); and "step", the stages
    run back to back. Median of `reps` rounds after one warm-up round."""
    import torch

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out

    times = {name: [] for name, _ in stages}
    times["step"] = []
    for _ in range(reps + 1):
        x = None
        for name, fn in stages:
            torch.cuda.synchronize()
            ms, x = timed(lambda: fn(x))
            times[name].append(ms)

        def whole():
            y = None
            for _, fn in stages:
                y = fn(y)
            return y

        torch.cuda.synchronize()
        times["step"].append(timed(whole)[0])
    return {k: statistics.median(v[1:]) for k, v in times.items()}


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
    makes to the kernel wrapper `name` (the engine's and the stacked
    engine's module references to it). The engine's tables are kept as
    they are; other tensors are copied."""
    from nimble_tpu_torch.align import engine as TE
    from nimble_tpu_torch.align import kernels as K
    from nimble_tpu_torch.align import stacked as TS

    orig = getattr(K, name)
    holders = [m for m in (TE, TS) if getattr(m, name, None) is orig]
    tables = [t for t in eng.tables.values() if hasattr(t, "data_ptr")]
    seen = []

    def capture(*args):
        if not seen:
            seen.append(tuple(a.clone() if hasattr(a, "clone") and not any(a is t for t in tables) else a
                              for a in args))
        return orig(*args)

    for m in holders:
        setattr(m, name, capture)
    try:
        eng.align_batch(codes, lens)
    finally:
        for m in holders:
            setattr(m, name, orig)
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


def stacked_engine(libs, group_g=None, device: str = "cuda", chunk_size=None):
    """The stacked engine that `align` builds for these libraries and 100 bp
    single-end reads, on the card unless the caller asks for the CPU."""
    import torch

    from nimble_tpu_torch.align.pipeline import _round_len, make_runner
    from nimble_tpu_torch.align.stacked import StackedEngine

    rs = [make_runner(lib, os.devnull, group_g=group_g) for lib in libs]
    return StackedEngine([r.index for r in rs], [r.config for r in rs], torch.device(device),
                         chunk_size=chunk_size, max_len=_round_len(READ_LEN), paired=False)


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
            "gband_relayout_s": stage.get("gband_relayout"),
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
    args = captured(eng, codes, lens, "band_tree_expand")
    kern["band_tree_expand"] = time_kernel("band_tree_expand", args)
    kern["band_tree_expand"]["spread"] = band_spread(*band_args(args)[:3])
    return out


def variants(work: str) -> dict:
    """band_variants on the arguments the 20k engine passes band_tree_expand
    for the first chunk of the workload's reads, with their page spread."""
    import torch

    from nimble_tpu_torch.align import kernels as K

    with open(os.path.join(work, "workloads.json")) as f:
        p = json.load(f)
    K.build()
    _, eng = engine(p["wide_lib"])
    codes, lens = fastq_head(p["wide_fq"], eng.chunk_size, eng.max_len)
    args = captured(eng, codes, lens, "band_tree_expand")
    del eng
    return {"device": torch.cuda.get_device_name(0), "args": [list(a.shape) for a in args[:4]] + [args[4]],
            "spread": band_spread(*band_args(args)[:3]), "ms": band_variants(args)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("prepare", "run", "variants"))
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
        print(json.dumps((run if args.step == "run" else variants)(args.work)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
