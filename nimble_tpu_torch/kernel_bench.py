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

  python3 -m nimble_tpu_torch.kernel_bench intersect WORK [--against CU ...]

`intersect` writes the class-id workloads into WORK (`intersect_workloads`:
chip_smoke.py's A, B, E and D at one chunk of reads) and prints a JSON line
for each and one for all: intersect_class_bits on the arguments each
engine passes it, this checkout's kernel beside the kernel built from each
`--against` source (another checkout's csrc/intersect_class_bits.cu, e.g.
the parent's, unpacked with `git archive` into a gitignored directory),
times, the walk's needs, bytes and bounds (`intersect`).

`class_stages` and `stage_ms` cut one step of a class-id wide path
(groupcls, monocls, the wide two-choice probe) into its stages and time
each on the card (`intersect_walk`: the runs a read's intersection walks
and the row sectors they need); chip_smoke.py prints them.

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


def intersect_class_bits_bytes(B: int, P: int, W: int, row_bytes: int) -> int:
    """class_ids and matched read, (B, W) written; plus the row_bytes of
    class rows this input needs (`intersect_walk`)."""
    return 5 * B * P + 4 * B * W + row_bytes


def intersect_class_bits_full_row_bytes(B: int, P: int, W: int, n_rows: int) -> int:
    """The count before the walk: class_ids and matched read, (B, W)
    written, and each of the n_rows distinct classes at matched positions
    read whole, once."""
    return 5 * B * P + 4 * B * W + 4 * W * n_rows


def intersect_walk(class_ids, matched, class_bits) -> dict:
    """What the intersection kernel needs of class_bits on these arguments,
    stepping each read's runs in the kernel's order (run starts by
    csrc/intersect_class_bits.cu's rule): a read's first run needs its
    whole row, each later run the 32-byte sectors of its row that hold a
    word still nonzero in the read's running AND just before that run (AND
    with a zero word is zero whatever the row holds). `row_bytes` counts
    each distinct (class, sector of its row) that some read needs once, 32
    bytes, and a sector at either end of a row, which it shares with the
    next row, only for the row's own words, so that a whole row counts its
    4W bytes and no sector counts twice. Also: the runs a read walks (mean,
    max), its distinct classes (mean), the sectors a run needs (mean over
    runs, each read's own), the reads whose AND emptied with runs left,
    the reads whose first row is zero (`empty_at_first`), and the distinct
    classes at matched positions that the full-row count reads whole
    (`full_rows`)."""
    import torch

    B, P = class_ids.shape
    C, W = class_bits.shape
    dev = class_bits.device
    neg = -1 if W > 32 else 0  # the row a matched negative id names, if any
    cls = torch.where(matched, torch.where(class_ids < 0, neg, class_ids.clamp(max=C - 1)), -1).long()
    prev = torch.cat([torch.full_like(cls[:, :1], -2), cls[:, :-1]], dim=1)
    start = (cls >= 0) & (cls != prev)
    n = start.sum(dim=1)
    R = int(n.max()) if B else 0
    runs = torch.full((B, R + 1), -1, dtype=torch.long, device=dev)
    runs.scatter_(1, torch.where(start, start.cumsum(dim=1) - 1, R), cls)
    runs = runs[:, :R]
    S = W // 8 + 2  # the sectors a row can touch
    words = torch.arange(W, device=dev)
    need = torch.zeros(C * S, dtype=torch.bool, device=dev)
    emptied = torch.zeros(B, dtype=torch.bool, device=dev)
    n_sectors = at_first = 0
    acc = None
    for i in range(R):
        c = runs[:, i]
        has = c >= 0
        cl = c.clamp(min=0)
        live = has[:, None] if acc is None else has[:, None] & (acc != 0)
        sector = ((cl * W) % 8)[:, None] + words[None, :]
        hit = torch.zeros((B, S), dtype=torch.int32, device=dev).scatter_add_(
            1, sector // 8, live.expand(B, W).int()) > 0
        n_sectors += int(hit.sum())
        need[(cl[:, None] * S + torch.arange(S, device=dev))[hit]] = True
        row = torch.where(has[:, None], class_bits[cl], torch.full((), -1, dtype=class_bits.dtype, device=dev))
        acc = row if acc is None else acc & row
        empty = has & (acc == 0).all(dim=1)
        if i == 0:
            at_first = int(empty.sum())
        emptied |= empty & (n > i + 1)
    hit = need.nonzero()[:, 0]
    lo = 8 * (hit % S) - (hit // S) * W % 8  # the sector's first word in its row
    row_bytes = int(4 * ((lo + 8).clamp(max=W) - lo.clamp(min=0)).clamp(min=0).sum())
    ordered = runs.sort(dim=1).values
    first = torch.cat([torch.ones_like(ordered[:, :1], dtype=torch.bool), ordered[:, 1:] != ordered[:, :-1]], dim=1)
    return {"mean_runs": float(n.double().mean()) if B else 0.0, "max_runs": R,
            "distinct_classes": float(((ordered >= 0) & first).sum(dim=1).double().mean()) if B else 0.0,
            "sectors_per_run": n_sectors / max(int(n.sum()), 1), "emptied_early": int(emptied.sum()),
            "empty_at_first": at_first,
            "row_bytes": row_bytes, "full_rows": int(torch.unique(class_ids[matched]).numel())}


def intersect_bytes(args) -> tuple:
    """(intersect_walk's dict, the bytes it counts, the full-row count) of
    intersect_class_bits' arguments."""
    class_ids, matched, class_bits = args
    walk = intersect_walk(*args)
    shape = (*class_ids.shape, class_bits.shape[1])
    return (walk, intersect_class_bits_bytes(*shape, walk["row_bytes"]),
            intersect_class_bits_full_row_bytes(*shape, walk["full_rows"]))


def family_case(B: int, P: int, C: int, W: int, seed: int):
    """Intersection arguments in a real library's layout, as numpy (ids,
    matched, class_bits): the W words cut into max(2, ceil(W / 32))
    family blocks of W // that many words (about 32), spread evenly and
    disjoint; each class a random subset of its family's block (each word
    zero with probability 1/20, else 15/16 of its bits set); classes 0-3
    all ones, class 4 only its last word set (all ones) and class 5 a
    random last word. Class ids come in runs of about 1.5 positions, 5% of
    positions unmatched (half of them with an id the mask must hide). By
    read r % 8: 0-4 draw from one family, so the running AND's live words
    thin out and may run out; 5 also holds, matched mid-read, one class of
    the family half the blocks away, so the AND empties there; 6 only the
    all-ones classes, so every word stays live; 7 only classes 4 and 5, so
    the one live word is the last (past lane 31 where W > 32). Needs
    C >= 6 + the family count."""
    rng = np.random.default_rng(seed)
    n_fam = max(2, -(-W // 32))
    span = W // n_fam
    starts = np.linspace(0, W - span, n_fam).round().astype(np.int64)
    fam = np.arange(C) % n_fam
    cb = np.zeros((C, W), dtype=np.int64)
    dense = np.bitwise_or.reduce(rng.integers(-(1 << 31), 1 << 31, size=(4, C, span), dtype=np.int64), axis=0)
    np.put_along_axis(cb, starts[fam][:, None] + np.arange(span), np.where(rng.random((C, span)) < 0.05, 0, dense),
                      axis=1)
    cb[:6] = 0
    cb[:4] = -1
    cb[4, -1], cb[5, -1] = -1, rng.integers(1, 1 << 31)
    members = [np.nonzero(fam[6:] == f)[0] + 6 for f in range(n_fam)]
    new = rng.random((B, P)) < 0.65
    new[:, 0] = True
    run = np.cumsum(new, axis=1) - 1
    ids = np.empty((B, P), dtype=np.int64)
    matched = rng.random((B, P)) >= 0.05
    for r in range(B):
        f = rng.integers(n_fam)
        pool = {6: np.arange(4), 7: np.array([4, 5])}.get(r % 8, members[f])
        ids[r] = rng.choice(pool, size=P)[run[r]]
        if r % 8 == 5:
            ids[r, P // 2] = rng.choice(members[(f + n_fam // 2) % n_fam])
            matched[r, P // 2] = True
    ids[~matched & (rng.random((B, P)) < 0.5)] = -1
    return ids.astype(np.int32), matched, cb.astype(np.int32)


def kernel_bytes(name: str, args) -> int:
    """The bytes the wrapper `name` must move for these arguments."""
    import torch

    if name == "kmer_keys":
        codes, _lens, k, _nb = args
        return kmer_keys_bytes(codes.shape[0], codes.shape[1], k)
    if name == "mono_probe":
        bucket, h1, hi, lo, _fc, _pal, valid, stash, W = args
        return mono_probe_bytes(hi.numel(), W, mono_table_bytes(bucket, h1, hi, lo, valid, W) + stash.numel() * 4)
    if name == "intersect_class_bits":
        return intersect_bytes(args)[1]
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


def gband_stages(eng, codes, lens):
    """One single-end step of a gband engine on these reads, cut into its
    stages as class_stages cuts a class-id step: the window stage
    (`gband_keys`, the kmer_keys kernel at k+g-1, h2 too under two-choice
    placement), the probe (`gband_select`: the bucket probes, through the
    pointer rows in the indirect layout, the stash, masks, coverage and the
    orientation), `band_tree_expand` (`gband_expand`) and `combine_mates` +
    the engine's wire (`AlignEngine.pack`)."""
    from nimble_tpu_torch.align import engine as TE

    t, p, L = eng.tables, eng.params, codes.shape[1]
    return [
        ("window", lambda _: TE.gband_keys(codes, lens, t, p)),
        ("probe", lambda keys: TE.gband_select(keys, lens, L, t, p)),
        ("band_tree_expand", lambda sel: (TE.gband_expand(sel[0], sel[1], t), *sel[2:])),
        ("combine + pack", lambda mate: eng.pack(TE.combine_mates(p, lens, mate))[0]),
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


# the class-id workloads of intersect_workloads: chip_smoke.py's phases
# 13 (A), 14 (B), 16 (E) and 17 (D), one chunk of reads each
N_CLS_READS = 131_072
GCLS_FAMILIES = 5


def _cls_args(lib: str, group_g, fq: str, cap=None, class_bits: bool = False, device: str = "cuda"):
    """The arguments that the engine `align` builds for lib (group_g as
    `align` passes it; with `class_bits`, off the group probe and over
    class_bits rather than the class bands; under the placement cap `cap`,
    tables.MONO_MAX_BYTES, where given) passes intersect_class_bits for the
    first chunk of fq's reads, and its path; on the card unless the caller
    asks for the CPU."""
    import copy

    import torch

    from nimble_tpu_torch.align import tables as TT
    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import _round_len, make_runner

    r = make_runner(lib, os.devnull, group_g=group_g)
    index = r.index
    if class_bits:
        index = copy.copy(index)
        index._torch_class_bands = None  # bands infeasible: the class table ships as class_bits
    default_cap = TT.MONO_MAX_BYTES
    TT.MONO_MAX_BYTES = default_cap if cap is None else cap
    try:
        eng = AlignEngine(index, r.config, torch.device(device), chunk_size=None, max_len=_round_len(READ_LEN),
                          paired=False, group_probe=False if class_bits else None)
    finally:
        TT.MONO_MAX_BYTES = default_cap
    codes, lens = fastq_head(fq, eng.chunk_size, eng.max_len)
    return captured(eng, codes, lens, "intersect_class_bits"), eng.path


def two_choice_cap(index) -> tuple:
    """(the keys of a --probe mono index, the placement cap one byte below
    monocls's smallest candidate table): under that cap (tables.
    MONO_MAX_BYTES) no placement fits, and the engine takes the wide
    two-choice probe."""
    import math

    from nimble_tpu_torch.align import tables as TT

    n_keys = int(((index.table_vsame >= 0) | (index.table_vdiff >= 0)).sum()
                 + ((index.stash_vsame >= 0) | (index.stash_vdiff >= 0)).sum())
    return n_keys, (1 << (math.ceil(math.log2(n_keys)) + 1)) * TT.MONO_SLOTS * 4 * 4 - 1


def intersect_workloads(work: str) -> dict:
    """The arguments the class-id engines pass intersect_class_bits for the
    first chunk of their reads, as chip_smoke.py's phases pass them, by
    tag: A the 20k library off the group probe over class_bits (monocls, W
    = 625), B its first 5 families written allele-major (groupcls, W =
    157), E B's library under --probe mono (monocls), D E under a placement
    cap one byte below monocls's smallest table (the wide two-choice
    probe). Writes the libraries, N_CLS_READS reads each and their indexes
    into WORK."""
    from nimble_tpu_torch import bench_data
    from nimble_tpu_torch.__main__ import main
    from nimble_tpu_torch.align.pipeline import make_runner
    from nimble_tpu_torch.native_build import build_native

    build_native()  # the C++ index builder for the 20k library
    alib, afq, _, _ = bench_data.write_wide(os.path.join(work, "wide"), N_CLS_READS, 0)
    blib, bfq, _, _ = bench_data.write_wide(os.path.join(work, "gcls"), N_CLS_READS, 0, families=GCLS_FAMILIES,
                                            interleaved=True)
    for lib, flags in ((alib, []), (blib, []), (blib, ["--probe", "mono"])):
        if main(["index", "--reference", lib, *flags]) != 0:
            raise RuntimeError(f"index {lib} failed")
    cap = two_choice_cap(make_runner(blib, os.devnull, group_g=0).index)[1]
    cases = {"A": (alib, None, afq, None, True, "monocls"), "B": (blib, None, bfq, None, False, "groupcls"),
             "E": (blib, 0, bfq, None, False, "monocls"), "D": (blib, 0, bfq, cap, False, "two-choice")}
    out = {}
    for tag, (lib, g, fq, cap_, bits, path) in cases.items():
        args, took = _cls_args(lib, g, fq, cap_, bits)
        if took != path:
            raise AssertionError(f"{tag}: the engine took the {took} path, not {path}")
        out[tag] = args
    return out


def _intersect_lib(cu: str, build_dir: str):
    """An intersect_class_bits source (another checkout's
    csrc/intersect_class_bits.cu) built alone with the library's nvcc flags
    into a directory under build_dir, and loaded: its
    nt_intersect_class_bits."""
    import ctypes
    import subprocess
    import tempfile

    from nimble_tpu_torch.align import kernels as K

    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(tempfile.mkdtemp(dir=build_dir), "intersect.so")
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", so, cu], check=True, capture_output=True)
    fn = ctypes.CDLL(so).nt_intersect_class_bits
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.restype, fn.argtypes = ctypes.c_int, [i32, p, p, i64, i32, p, i64, i32, p, p]
    return fn


def intersect(work: str, against) -> dict:
    """intersect_class_bits on A's, B's, E's and D's arguments
    (intersect_workloads): this checkout's kernel and the kernel of each
    source in `against` (built alone into WORK/builds), each == the plain
    version (torch.equal), timed with device_ms in the order: the others,
    this one, this one, the others; with what the walk needs
    (intersect_walk) and the bytes, bound and share of that count and of
    the full-row count."""
    import subprocess

    import torch

    from nimble_tpu_torch.align import kernels as K

    K.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    others = {cu: _intersect_lib(cu, os.path.join(work, "builds")) for cu in against}
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cases": {}}
    for tag, args in intersect_workloads(work).items():
        ids, matched, class_bits = args
        (B, P), (C, W) = ids.shape, class_bits.shape
        res = torch.empty((B, W), dtype=torch.int32, device=ids.device)

        def call(fn):
            err = fn(K._device_index(ids.device), ids.data_ptr(), matched.data_ptr(), B, P, class_bits.data_ptr(), C,
                     W, res.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"intersect_class_bits of another source failed: cudaError {err}")
            return res

        fns = {cu: (lambda fn=fn: call(fn)) for cu, fn in others.items()}
        want = K.intersect_class_bits_reference(*args)
        for label, fn in {"kernel": lambda: K.intersect_class_bits(*args), **fns}.items():
            got = fn().clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{tag}: {label} != the plain version")
        times = {label: [] for label in ("kernel", *fns)}
        for label in (*fns, "kernel", "kernel", *fns):
            times[label].append(device_ms(fns.get(label, lambda: K.intersect_class_bits(*args))))
        walk, n_bytes, full = intersect_bytes(args)
        out["cases"][tag] = {"B": B, "P": P, "C": C, "W": W, "ms": times, "walk": walk, "bytes": n_bytes,
                             "bound_ms": bound_ms(n_bytes), "full_row_bytes": full, "full_row_bound_ms": bound_ms(full)}
        print(json.dumps({tag: out["cases"][tag]}), flush=True)
        del args, ids, matched, class_bits, res, want
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("prepare", "run", "variants", "intersect"))
    ap.add_argument("work", help="directory of the workloads (made by prepare; by intersect itself)")
    ap.add_argument("--against", nargs="*", default=[],
                    help="intersect: other intersect_class_bits sources to time beside this checkout's")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    if args.step == "prepare":
        t0 = time.perf_counter()
        prepare(args.work)
        print(json.dumps({"prepared": args.work, "s": time.perf_counter() - t0}), flush=True)
    elif args.step == "intersect":
        print(json.dumps(intersect(args.work, args.against)), flush=True)
    else:
        print(json.dumps((run if args.step == "run" else variants)(args.work)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
