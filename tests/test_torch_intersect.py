"""The class-bits intersection of the class-id paths
(nimble_tpu_torch/align/kernels.py:intersect_class_bits): a numpy model of
csrc/intersect_class_bits.cu (its run lists, and its active list of the
words still set: compacted after the first row and after each group of
runs, the early exit) == the plain torch version == the reference's
nimble_tpu.align.engine.intersect_class_bits (XLA, on the CPU), exactly,
on dense bitsets and on family-blocked ones whose lists shrink, empty or
stay full mid-read; the wrapper's CPU path and argument checks; the
kernel's byte count (kernel_bench.intersect_walk) against a brute-force
count. The kernel against its plain version runs only where a card is
visible."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu.align import engine as E
from nimble_tpu_torch import kernel_bench as KB
from nimble_tpu_torch.align import engine as TE
from nimble_tpu_torch.align import kernels as K

LANES = 32  # a warp
UNROLL = 8  # runs whose listed words a lane loads together


def _popc(x: int) -> int:
    return bin(x).count("1")


def _compact(keep, entries, base: int, below, dest) -> int:
    """A ballot over `keep` and the kept lanes' entries written, in order,
    from dest[base] (popcount of the lanes below); returns the count."""
    mask = sum(1 << int(i) for i in np.nonzero(keep)[0])  # __ballot_sync
    for i in np.nonzero(keep)[0]:
        dest[base + _popc(mask & below[i])] = entries[i]
    return _popc(mask)


def kernel_model(ids, matched, cb, tile=None):
    """csrc/intersect_class_bits.cu in numpy, one warp (32 lanes) per read.
    Pass 1: 32-position segments, `prev` by a shift up with the previous
    segment's last class in lane 0 (-2 before the first), the run starts
    compacted by ballot and popcount into the warp's run list. Pass 2, for
    each tile of `tile` words (the whole row by default): the first run's
    row loaded whole into the accumulator, its nonzero words' indices
    compacted into the active list; then each group of UNROLL runs walks
    the list 32 entries at a time, every lane loading its listed word of
    the group's rows through flat 64-bit row offsets (all ones past the
    last run), ANDing them into the accumulator and the nonzero ones
    compacted again in place (every lane reads before the ballot, writes
    after it); the walk stops when the list is empty; the accumulator is
    stored. A read with no run stores all ones if a position matched, else
    zeros. Returns (bits, runs per read, per read the list's length after
    the first row and after each group, per read its first listed word)."""
    B, P = ids.shape
    C, W = cb.shape
    tile = W if tile is None else tile
    flat = cb.reshape(-1)
    negative = 0 if W <= 32 else -1
    lane = np.arange(LANES)
    below = [(1 << int(lane_i)) - 1 for lane_i in lane]
    out = np.empty((B, W), dtype=np.int32)
    n_runs = np.empty(B, dtype=np.int64)
    lengths, first_word = [], np.full(B, -1, dtype=np.int64)
    for r in range(B):
        runs = np.full(P, -7, dtype=np.int64)  # the warp's run list: P entries of shared memory
        n, any_matched, carry = 0, False, -2
        for q0 in range(0, P, LANES):
            q = q0 + lane
            inside = q < P
            m = np.zeros(LANES, dtype=bool)
            m[inside] = matched[r, q[inside]]
            idv = np.zeros(LANES, dtype=np.int64)
            idv[inside] = ids[r, q[inside]]
            cls = np.where(m, np.where(idv < 0, negative, np.minimum(idv, C - 1)), -1)
            prev = np.concatenate([[carry], cls[:-1]])  # __shfl_up_sync; lane 0 takes the carry
            carry = int(cls[-1])  # __shfl_sync from lane 31
            any_matched |= bool(m.any())
            n += _compact((cls >= 0) & (cls != prev), cls, n, below, runs)
        assert (runs[:n] >= 0).all() and n <= P
        n_runs[r] = n
        trace = []
        lengths.append(trace)
        if n == 0:
            out[r] = -1 if any_matched else 0
            continue
        for t0 in range(0, W, tile):
            tw = min(tile, W - t0)
            acc = np.full(tw, 12345, dtype=np.int32)  # shared memory, written before it is read
            live = np.full(tw, -7, dtype=np.int64)
            m = 0
            for w0 in range(0, tw, LANES):
                w = w0 + lane
                v = np.where(w < tw, flat[runs[0] * W + t0 + np.minimum(w, tw - 1)], 0).astype(np.int32)
                acc[w[w < tw]] = v[w < tw]
                m += _compact(v != 0, w, m, below, live)
            if t0 == 0 and m:
                first_word[r] = live[0]
            trace.append(m)
            i = 1
            while i < n and m > 0:
                rows = [runs[i + k] if i + k < n else None for k in range(UNROLL)]
                kept = 0
                for j0 in range(0, m, LANES):
                    j = j0 + lane
                    inside = j < m
                    w = np.where(inside, live[np.minimum(j, m - 1)], 0)  # every lane reads first
                    a = np.where(inside, acc[w], 0).astype(np.int32)
                    for row in rows:
                        a &= flat[row * W + t0 + w] if row is not None else np.int32(-1)
                    a = np.where(inside, a, 0).astype(np.int32)
                    acc[w[inside]] = a[inside]
                    kept += _compact(a != 0, w, kept, below, live)
                m = kept
                trace.append(m)
                i += UNROLL
            out[r, t0 : t0 + tw] = acc
    return out, n_runs, lengths, first_word


def _case(B: int, P: int, C: int, W: int, seed: int):
    """Class ids in runs of about 3 positions, 10% of positions unmatched
    (half of them with an id the mask must hide) and some matched with id
    -1; reads 0-1 all-miss, read 2 alternating two classes (every position
    starts a run), read 3 matched everywhere with id -1. Dense bitsets
    (15/16 of the bits set), so that many-run ANDs keep bits."""
    rng = np.random.default_rng(seed)
    cb = np.bitwise_or.reduce(rng.integers(-(1 << 31), 1 << 31, size=(4, C, W), dtype=np.int64),
                              axis=0).astype(np.int32)
    new = rng.random((B, P)) < 0.3
    new[:, 0] = True
    run = np.cumsum(new, axis=1) - 1
    ids = np.take_along_axis(rng.integers(0, C, size=(B, P)), run, axis=1).astype(np.int32)
    matched = rng.random((B, P)) >= 0.1
    ids[~matched & (rng.random((B, P)) < 0.5)] = -1
    ids[matched & (rng.random((B, P)) < 0.02)] = -1
    matched[:2] = False
    ids[2] = np.where(np.arange(P) % 2 == 0, 3, 5)
    matched[2] = True
    ids[3], matched[3] = -1, True
    return ids, matched, cb


_reference_jit = jax.jit(E.intersect_class_bits)  # one compile a shape, not one an op


def _reference(ids, matched, cb):
    return np.asarray(_reference_jit(jnp.asarray(ids), jnp.asarray(matched), jnp.asarray(cb)))


@pytest.mark.parametrize("P", [1, 31, 33, 92, 120])
@pytest.mark.parametrize("W", [1, 17, 32, 33, 157, 625])
def test_kernel_model_matches_plain_version_and_reference(W, P):
    ids, matched, cb = _case(12, P, 40, W, seed=1000 * W + P)
    got, n_runs, _, _ = kernel_model(ids, matched, cb)
    plain = K.intersect_class_bits_reference(torch.from_numpy(ids), torch.from_numpy(matched), torch.from_numpy(cb))
    want = _reference(ids, matched, cb)
    assert plain.dtype == torch.int32 and np.array_equal(plain.numpy(), want)
    assert np.array_equal(got, want)
    assert not want[:2].any() and n_runs[2] == P
    # read 3: every position matched with id -1 -> row 0 (W <= 32) or all ones
    assert np.array_equal(want[3], cb[0] if W <= 32 else np.full(W, -1, np.int32))
    if P > 3 * K.RUN_BLOCK:  # more runs than three of the reference's blocks
        assert n_runs.max() > 3 * K.RUN_BLOCK and want[4:].any()


@pytest.mark.parametrize("W", [17, 33])
def test_matched_negative_ids_follow_the_reference_branch(W):
    """A matched position with id -1 ANDs row 0 for W <= 32 (the gather of
    clip(ids, 0)) and all ones for W > 32 (an empty run slot), beside
    ordinary classes and whichever side of a run it falls on."""
    rng = np.random.default_rng(W)
    cb = rng.integers(-(1 << 31), 1 << 31, size=(6, W), dtype=np.int64).astype(np.int32)
    ids = np.array([[-1, -1, -1], [4, -1, 4], [-1, 2, 2], [2, 2, -1]], dtype=np.int32)
    matched = np.ones_like(ids, dtype=bool)
    want = _reference(ids, matched, cb)
    row0 = cb[0] if W <= 32 else np.full(W, -1, np.int32)
    assert np.array_equal(want, np.stack([row0, cb[4] & row0, cb[2] & row0, cb[2] & row0]))
    got = kernel_model(ids, matched, cb)[0]
    plain = K.intersect_class_bits(torch.from_numpy(ids), torch.from_numpy(matched), torch.from_numpy(cb))
    assert np.array_equal(got, want) and np.array_equal(plain.numpy(), want)


def _groups(n: int) -> int:
    """The groups of UNROLL runs after a read's first run."""
    return -(-(n - 1) // UNROLL) if n else 0


@pytest.mark.parametrize("P", [40, 96])
@pytest.mark.parametrize("W", [33, 157, 625, 1563])
def test_family_blocked_lists_shrink_empty_or_stay_full(W, P):
    """Classes confined to family blocks of about 32 words
    (kernel_bench.family_case, which chip_smoke.py also runs on the card):
    the model == the plain version == the reference, while the active list
    shrinks and keeps words to the end in some reads, empties with runs
    left in others (the early exit), stays at W on the all-ones reads and
    starts past lane 31 on the last-word reads."""
    ids, matched, cb = KB.family_case(16, P, 120, W, seed=10 * W + P)
    got, n_runs, lengths, first = kernel_model(ids, matched, cb)
    plain = K.intersect_class_bits_reference(torch.from_numpy(ids), torch.from_numpy(matched), torch.from_numpy(cb))
    want = _reference(ids, matched, cb)
    assert np.array_equal(plain.numpy(), want) and np.array_equal(got, want)
    early = [len(t) - 1 < _groups(n) for t, n in zip(lengths, n_runs)]
    assert all(t[-1] == 0 for t, e in zip(lengths, early) if e)
    assert early[5] and early[13]  # a class of another family mid-read
    assert lengths[6] == [W] * (_groups(n_runs[6]) + 1) and want[6].tolist() == [-1] * W  # all ones
    assert first[7] == W - 1 and not want[7, :-1].any() and want[7, -1] != 0  # the last word alone
    assert any(0 < t[-1] < t[0] and not e for t, e in zip(lengths, early))  # thinned, not emptied
    assert max(n_runs) > 3 * UNROLL


@pytest.mark.parametrize("tile", [1, 32, 50])
def test_kernel_model_in_tiles_matches_whole_rows(tile):
    """A row walked in tiles of words (the kernel's way past what shared
    memory holds beside the run list), each with its own first row, list
    and early exit, gives the whole row's bits."""
    ids, matched, cb = KB.family_case(16, 60, 80, 157, seed=tile)
    want = _reference(ids, matched, cb)
    assert np.array_equal(kernel_model(ids, matched, cb, tile=tile)[0], want)
    dense = _case(8, 60, 40, 157, seed=tile)
    assert np.array_equal(kernel_model(*dense, tile=tile)[0], _reference(*dense))


def _brute_walk(ids, matched, cb):
    """intersect_walk's row bytes and reads emptied early, by loops: the
    absolute 32-byte sectors of the words each run needs (all its row's at
    a read's first run, then the words nonzero in the running AND), each
    (class, sector) pair once, at the row's own words in that sector."""
    B, P = ids.shape
    C, W = cb.shape
    need, emptied = set(), 0
    for r in range(B):
        runs, prev = [], -2
        for q in range(P):
            c = (0 if W <= 32 else -1) if ids[r, q] < 0 else min(int(ids[r, q]), C - 1)
            c = c if matched[r, q] else -1
            if c >= 0 and c != prev:
                runs.append(c)
            prev = c
        acc = None
        for i, c in enumerate(runs):
            for w in range(W):
                if acc is None or acc[w] != 0:
                    need.add((c, (c * W + w) // 8))
            acc = cb[c].copy() if acc is None else acc & cb[c]
            if not acc.any() and i + 1 < len(runs):
                emptied += 1
                break
    row_bytes = sum(4 * (min(W, 8 * s + 8 - c * W) - max(0, 8 * s - c * W)) for c, s in need)
    return row_bytes, emptied


@pytest.mark.parametrize("kind", ["family", "dense"])
@pytest.mark.parametrize("W", [17, 33, 157])
def test_walk_bytes_equal_a_brute_force_count(W, kind):
    """kernel_bench.intersect_walk (torch, every read a step at a time) ==
    a brute-force count by loops, and the bytes it gives are at most the
    full-row count's."""
    arrays = KB.family_case(24, 40, 80, W, seed=W) if kind == "family" else _case(24, 40, 30, W, seed=W)
    args = [torch.from_numpy(a) for a in arrays]
    walk, n_bytes, full = KB.intersect_bytes(args)
    row_bytes, emptied = _brute_walk(*arrays)
    assert (walk["row_bytes"], walk["emptied_early"]) == (row_bytes, emptied)
    assert n_bytes == 5 * 24 * 40 + 4 * 24 * W + row_bytes <= full
    n_runs = kernel_model(*arrays)[1]
    assert (walk["mean_runs"], walk["max_runs"]) == (n_runs.mean(), n_runs.max())


def test_wrapper_on_the_cpu_runs_the_plain_version():
    """The engine reaches the wrapper itself (kernel_bench.captured patches
    it by name), and on CPU tensors it runs the plain version, launching
    nothing."""
    assert TE.intersect_class_bits is K.intersect_class_bits
    ids, matched, cb = (torch.from_numpy(a) for a in _case(9, 40, 30, 70, seed=3))
    before = K.intersect_class_bits.launches
    got = K.intersect_class_bits(ids, matched, cb)
    assert got.dtype == torch.int32 and got.shape == (9, 70)
    assert torch.equal(got, K.intersect_class_bits_reference(ids, matched, cb))
    assert K.intersect_class_bits.launches == before


def _args():
    return [torch.from_numpy(a) for a in _case(6, 20, 10, 40, seed=7)]


def _with(i, value):
    args = _args()
    args[i] = value(args[i])
    return args


@pytest.mark.parametrize(
    "args, err",
    [
        (lambda: _with(0, lambda a: a.to(torch.int64)), "class_ids must be"),
        (lambda: _with(0, lambda a: a[0]), "class_ids must be"),
        (lambda: _with(0, lambda a: a[:, :0]), "class_ids must be"),
        (lambda: _with(1, lambda a: a.to(torch.uint8)), "matched must be"),
        (lambda: _with(1, lambda a: a[:, 1:]), "matched must be"),
        (lambda: _with(2, lambda a: a.to(torch.int64)), "class_bits must be"),
        (lambda: _with(2, lambda a: a[:, :0]), "class_bits must be"),
        (lambda: _with(0, lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta")), "one device"),
        (lambda: _with(0, lambda a: a.t().contiguous().t()), "contiguous"),
        (lambda: _with(2, lambda a: torch.cat([a, a], dim=1)[:, ::2]), "contiguous"),
    ],
    ids=["ids-dtype", "ids-rank", "ids-empty", "matched-dtype", "matched-shape", "bits-dtype",
         "bits-empty", "device-mix", "strided-ids", "strided-bits"],
)
def test_wrapper_rejects_bad_arguments(args, err):
    with pytest.raises(ValueError, match=err):
        K.intersect_class_bits(*args())


def test_bytes_and_runs_of_a_call():
    """kernel_bytes: 5 B a position, the (B, W) output and the row sectors
    the walk needs (here a read's first row whole: the all-zero rows empty
    every AND at once); the full-row count reads each distinct class at a
    matched position whole. intersect_walk counts the kernel's run starts
    (a matched -1 names row 0 at W <= 32 and no row above)."""
    ids = torch.tensor([[3, 3, 5, 3], [7, -1, 7, 7], [1, 1, 1, 1]], dtype=torch.int32)
    matched = torch.tensor([[True, True, True, True], [True, True, True, False], [False] * 4])
    cb = torch.zeros((8, 40), dtype=torch.int32)
    assert KB.kernel_bytes("intersect_class_bits", (ids, matched, cb)) == 5 * 12 + 4 * 3 * 40 + 2 * 4 * 40
    assert KB.intersect_class_bits_bytes(3, 4, 40, 320) == 5 * 12 + 4 * 3 * 40 + 320
    assert KB.intersect_class_bits_full_row_bytes(3, 4, 40, 4) == 5 * 12 + 4 * 3 * 40 + 4 * 40 * 4
    walk = KB.intersect_walk(ids, matched, cb)
    assert walk == {"mean_runs": 5 / 3, "max_runs": 3, "distinct_classes": 1.0, "sectors_per_run": 10 / 5,
                    "emptied_early": 2, "empty_at_first": 2, "row_bytes": 320, "full_rows": 4}
    walk = KB.intersect_walk(ids, matched, cb[:, :17])
    assert (walk["mean_runs"], walk["max_runs"]) == (6 / 3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("B, P, W", [(65536, 92, 625), (1001, 120, 157), (77, 33, 17), (5, 1, 33)])
def test_cuda_kernel_matches_plain_version(B, P, W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ids, matched, cb = (torch.from_numpy(a).cuda() for a in _case(B, P, 3000 if B > 1000 else 40, W, seed=B))
    before = K.intersect_class_bits.launches
    got = K.intersect_class_bits(ids, matched, cb)
    want = K.intersect_class_bits_reference(ids, matched, cb)
    torch.cuda.synchronize()
    assert K.intersect_class_bits.launches == before + 1
    assert torch.equal(got, want)
