"""The port's kernels (nimble_tpu_torch/align/kernels.py) against the
reference: `kmer_keys` against `kmer_keys_pallas` in interpret mode and the
engine's jnp path, exactly, on all 7 planes; `mono_probe`'s argument checks
(its values are held in tests/test_torch_mono.py). The CUDA kernels against
their plain torch versions run only where a card is visible."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nimble_tpu.align.engine import _bitcast_i32, _canonical_keys, kmer_hi_lo
from nimble_tpu.align.kernels import kmer_keys_pallas
from nimble_tpu.index.hashing import bucket_hashes_jnp
from nimble_tpu_torch.align import kernels as K

PLANES = ("c_hi", "c_lo", "h1", "h2", "fwd_canon", "palindrome", "valid")


def _reads(seed: int, B: int, L: int, k: int):
    """Random reads with N bases; lens span below k, between k and L, and L."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.03] = 4
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    lens[:3] = (k - 1, k, L)
    return codes, lens


def _jnp_planes(codes, lens, k, n_buckets):
    hi, lo, valid = kmer_hi_lo(jnp.asarray(codes), jnp.asarray(lens), k)
    c_hi, c_lo, fwd, pal = _canonical_keys(hi, lo, k)
    h1, h2 = bucket_hashes_jnp(c_hi, c_lo, n_buckets)
    return [np.asarray(x) for x in (
        _bitcast_i32(c_hi), _bitcast_i32(c_lo), h1.astype(jnp.int32),
        h2.astype(jnp.int32), fwd, pal, valid)]


@pytest.mark.parametrize("k", [16, 21, 26, 31])
def test_kmer_keys_matches_pallas_and_jnp(k):
    B, L, n_buckets = 21, 80, 1 << 12
    codes, lens = _reads(k, B, L, k)
    got = K.kmer_keys(torch.from_numpy(codes), torch.from_numpy(lens), k, n_buckets)
    pallas = kmer_keys_pallas(jnp.asarray(codes), jnp.asarray(lens), k, n_buckets, interpret=True)
    ref = _jnp_planes(codes, lens, k, n_buckets)
    for name, g, p, r in zip(PLANES, got, pallas, ref):
        want_dtype = torch.bool if name in ("fwd_canon", "palindrome", "valid") else torch.int32
        assert g.dtype == want_dtype and g.shape == (B, L - k + 1), name
        assert np.array_equal(g.numpy(), np.asarray(p)), f"{name} != kmer_keys_pallas"
        assert np.array_equal(g.numpy(), r), f"{name} != jnp path"
    # the cases are not vacuous: some windows are invalid, some keys >= 2^31
    assert not got[6].all() and got[6].any()
    assert (got[0] < 0).any() or (got[1] < 0).any()


def test_kmer_keys_palindromes():
    """Even k admits reverse-complement palindromes: flagged on both sides,
    canonical key = forward key."""
    k = 16
    pal = "ACGTACGTACGTACGT"  # its own reverse complement
    codes = np.array([["ACGT".index(c) for c in pal * 2]], dtype=np.int8)
    lens = np.array([32], dtype=np.int32)
    got = K.kmer_keys(torch.from_numpy(codes), torch.from_numpy(lens), k, 1 << 8)
    ref = _jnp_planes(codes, lens, k, 1 << 8)
    assert got[5].any()
    for name, g, r in zip(PLANES, got, ref):
        assert np.array_equal(g.numpy(), r), name


@pytest.mark.parametrize(
    "codes_dtype, lens_dtype, L, k, n_buckets, err",
    [
        (torch.int32, torch.int32, 40, 21, 256, "int8"),
        (torch.int8, torch.int64, 40, 21, 256, "int32"),
        (torch.int8, torch.int32, 40, 0, 256, "k must be"),
        (torch.int8, torch.int32, 40, 32, 256, "k must be"),
        (torch.int8, torch.int32, 40, 21, 384, "power of two"),
        (torch.int8, torch.int32, 30, 31, 256, "shorter than k"),
    ],
)
def test_kmer_keys_rejects_bad_arguments(codes_dtype, lens_dtype, L, k, n_buckets, err):
    codes, lens = _reads(0, 4, L, 21)
    with pytest.raises(ValueError, match=err):
        K.kmer_keys(torch.from_numpy(codes).to(codes_dtype),
                    torch.from_numpy(lens).to(lens_dtype), k, n_buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, k", [(65536, 112, 26), (1001, 112, 16), (333, 64, 31)])
def test_cuda_kernel_matches_twin(B, L, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    codes, lens = _reads(B, B, L, k)
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(lens).cuda()
    before = K.kmer_keys.launches
    got = K.kmer_keys(c, ln, k, 1 << 18)
    want = K.kmer_keys_reference(c, ln, k, 1 << 18)
    torch.cuda.synchronize()
    assert K.kmer_keys.launches == before + 1
    for name, g, w in zip(PLANES, got, want):
        assert torch.equal(g, w), name


def _mono_args(B=5, P=7, W=3, S=4, n_stash=2, seed=0):
    """Random mono-probe arguments with unique keys: bucket rows whose slots
    hold some of the queried keys, a stash holding others."""
    rng = np.random.default_rng(seed)
    nb2 = 64
    E = 2 + 2 * W
    hi = rng.integers(0, 1 << 20, size=(B, P)).astype(np.int32)
    lo = np.arange(B * P, dtype=np.int32).reshape(B, P)  # unique keys
    h1 = rng.integers(0, nb2, size=(B, P)).astype(np.int32)
    bucket = rng.integers(-(1 << 31), 1 << 31, size=(nb2, S * E), dtype=np.int64).astype(np.int32)
    bucket[:, :S] = -1
    flat_b, flat_p = np.unravel_index(np.arange(B * P), (B, P))
    for i in range(0, B * P, 2):  # every other key sits in its bucket
        b, p = flat_b[i], flat_p[i]
        slot = i % S
        bucket[h1[b, p], slot] = hi[b, p]
        bucket[h1[b, p], S + slot] = lo[b, p]
    stash = rng.integers(-(1 << 31), 1 << 31, size=(n_stash, E), dtype=np.int64).astype(np.int32)
    stash[:, 0] = hi.reshape(-1)[1 : 2 * n_stash : 2]
    stash[:, 1] = lo.reshape(-1)[1 : 2 * n_stash : 2]
    flags = [rng.random((B, P)) < f for f in (0.5, 0.1, 0.8)]
    t = torch.from_numpy
    return (t(bucket), t(h1), t(hi), t(lo), *[t(f) for f in flags], t(stash), W)


def test_mono_probe_cpu_runs_the_plain_version():
    args = _mono_args()
    got = K.mono_probe(*args)
    want = K.mono_probe_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (5, 7, 3)
        assert torch.equal(g, w)
    assert (got[0] != 0).any() and (got[1] != 0).any()


def _replace(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda a: _replace(a, 0, a[0].to(torch.int64)), "bucket must be"),
        (lambda a: _replace(a, 0, a[0][:, :-1].contiguous()), "bucket must be"),
        (lambda a: _replace(a, 7, a[7][:, :-1].contiguous()), "stash must be"),
        (lambda a: _replace(a, 7, torch.zeros((65, 8), dtype=torch.int32)), "more than 64"),
        (lambda a: _replace(a, 1, a[1].to(torch.int64)), "h1 must be"),
        (lambda a: _replace(a, 6, a[6].to(torch.uint8)), "valid must be"),
        (lambda a: _replace(a, 2, a[2][:, :-1].contiguous()), "lo_i must be|hi_i|h1 must be"),
        (lambda a: _replace(a, 3, torch.zeros((5, 14), dtype=torch.int32)[:, ::2]), "contiguous"),
        (lambda a: _replace(a, 8, 0), "W must be"),
    ],
    ids=["bucket-dtype", "bucket-width", "stash-width", "stash-rows", "h1-dtype",
         "valid-dtype", "plane-shape", "strided-plane", "W"],
)
def test_mono_probe_rejects_bad_arguments(mutate, err):
    with pytest.raises(ValueError, match=err):
        K.mono_probe(*mutate(_mono_args()))


@pytest.mark.cuda
@pytest.mark.parametrize("B, W, Pw, Q1", [(65536, 625, 32, 14), (1001, 100, 16, 7), (70, 70, 8, 5),
                                          (333, 625, 24, 40)])
def test_cuda_band_tree_expand_matches_plain_version(B, W, Pw, Q1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(B)
    n_rows = 4096
    table = rng.integers(-(1 << 31), 1 << 31, size=(n_rows, 1 + 2 * Pw), dtype=np.int64).astype(np.int32)
    table[:, 0] = rng.integers(0, -(-W // Pw), size=n_rows)
    base = rng.integers(0, n_rows - 4, size=(B, 1))
    idx = (base + rng.integers(0, 4, size=(B, Q1))).astype(np.int32)  # neighbouring rows
    has = rng.random((B, Q1)) < 0.7
    has[:3] = False
    args = [torch.from_numpy(a).cuda() for a in (table, idx, has)]
    before = K.band_tree_expand.launches
    got = K.band_tree_expand(*args, W, Pw)
    want = K.band_tree_expand_reference(*args, W, Pw)
    torch.cuda.synchronize()
    assert K.band_tree_expand.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B, P, W, S, n_stash", [(1001, 92, 4, 4, 3), (333, 40, 16, 4, 64), (77, 30, 5, 2, 0)])
def test_cuda_mono_probe_matches_plain_version(B, P, W, S, n_stash):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _mono_args(B, P, W, S, n_stash, seed=B)]
    before = K.mono_probe.launches
    got = K.mono_probe(*args)
    want = K.mono_probe_reference(*args)
    torch.cuda.synchronize()
    assert K.mono_probe.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
