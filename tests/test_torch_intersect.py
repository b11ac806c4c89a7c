"""The class-bits intersection of the class-id paths
(nimble_tpu_torch/align/kernels.py:intersect_class_bits): a numpy model of
csrc/intersect_class_bits.cu's indexing == the plain torch version == the
reference's nimble_tpu.align.engine.intersect_class_bits (XLA, on the CPU),
exactly; the wrapper's CPU path and argument checks; the kernel's byte
count and run statistics. The kernel against its plain version runs only
where a card is visible."""
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
UNROLL = 4  # runs whose rows a lane loads together


def _popc(x: int) -> int:
    return bin(x).count("1")


def kernel_model(ids, matched, cb):
    """csrc/intersect_class_bits.cu in numpy, one warp (32 lanes) per read:
    32-position segments, `prev` by a shift up with the previous segment's
    last class in lane 0 (-2 before the first), the run starts as a ballot
    mask compacted by popcount into the warp's run list, then 32-lane word
    tiles ANDing the listed rows UNROLL at a time through flat 64-bit row
    offsets, the last group padded with all ones. Returns (bits, runs per
    read)."""
    B, P = ids.shape
    C, W = cb.shape
    flat = cb.reshape(-1)
    negative = 0 if W <= 32 else -1
    lane = np.arange(LANES)
    below = [(1 << int(lane_i)) - 1 for lane_i in lane]
    out = np.empty((B, W), dtype=np.int32)
    n_runs = np.empty(B, dtype=np.int64)
    for r in range(B):
        runs = np.full(P, -7, dtype=np.int64)  # the warp's list: P entries of shared memory
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
            start = (cls >= 0) & (cls != prev)
            starts = sum(1 << int(i) for i in np.nonzero(start)[0])  # __ballot_sync
            any_matched |= bool(m.any())
            for i in np.nonzero(start)[0]:
                runs[n + _popc(starts & below[i])] = cls[i]
            n += _popc(starts)
        assert (runs[:n] >= 0).all() and n <= P
        for w0 in range(0, W, LANES):
            w = w0 + lane
            live = w < W
            acc = np.full(LANES, -1, dtype=np.int32)
            for i in range(0, n, UNROLL):
                for k in range(UNROLL):
                    if i + k < n:
                        acc &= flat[runs[i + k] * W + np.where(live, w, 0)]
                    else:
                        acc &= np.int32(-1)
            out[r, w[live]] = acc[live] if any_matched else 0
        n_runs[r] = n
    return out, n_runs


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
    got, n_runs = kernel_model(ids, matched, cb)
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
    got, _ = kernel_model(ids, matched, cb)
    plain = K.intersect_class_bits(torch.from_numpy(ids), torch.from_numpy(matched), torch.from_numpy(cb))
    assert np.array_equal(got, want) and np.array_equal(plain.numpy(), want)


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
    """kernel_bytes: 5 B a position, the (B, W) output and each distinct
    class at a matched position once; run_stats counts the kernel's run
    starts (a matched -1 names row 0 at W <= 32 and no row above)."""
    ids = torch.tensor([[3, 3, 5, 3], [7, -1, 7, 7], [1, 1, 1, 1]], dtype=torch.int32)
    matched = torch.tensor([[True, True, True, True], [True, True, True, False], [False] * 4])
    cb = torch.zeros((8, 40), dtype=torch.int32)
    assert KB.kernel_bytes("intersect_class_bits", (ids, matched, cb)) == 5 * 12 + 4 * 3 * 40 + 4 * 40 * 4
    assert KB.intersect_class_bits_bytes(3, 4, 40, 4) == 5 * 12 + 4 * 3 * 40 + 4 * 40 * 4
    assert KB.run_stats(ids, matched, 40) == {"mean_runs": 5 / 3, "max_runs": 3}
    assert KB.run_stats(ids, matched, 17) == {"mean_runs": 6 / 3, "max_runs": 3}


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
