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


# the segment of csrc/kmer_keys.cu: codes per segment and windows per segment
SEG = 256
CHUNK = SEG - 32
M32 = np.uint64(0xFFFFFFFF)


def _rev2(x):
    """Reverse the sixteen 2-bit groups of uint64-held 32-bit words."""
    x = ((x & np.uint64(0x33333333)) << np.uint64(2)) | ((x >> np.uint64(2)) & np.uint64(0x33333333))
    x = ((x & np.uint64(0x0F0F0F0F)) << np.uint64(4)) | ((x >> np.uint64(4)) & np.uint64(0x0F0F0F0F))
    x = ((x & np.uint64(0x00FF00FF)) << np.uint64(8)) | ((x >> np.uint64(8)) & np.uint64(0x00FF00FF))
    return ((x << np.uint64(16)) & M32) | (x >> np.uint64(16))


def _field64(words, pos):
    """(B, n) uint64-held 32-bit words, (m,) base positions -> (B, m) the 64
    bits from each position on: two funnel shifts over three words."""
    i, s = pos >> 4, (2 * (pos & 15)).astype(np.uint64)
    w0, w1, w2 = words[:, i], words[:, i + 1], words[:, i + 2]
    funnel = lambda hi, lo: (((hi << np.uint64(32)) | lo) << s) >> np.uint64(32)
    return (funnel(w0, w1) << np.uint64(32)) | funnel(w1, w2)


def kmer_keys_model(codes, lens, k, n_buckets):
    """A numpy model of csrc/kmer_keys.cu's indexing: per segment of up to
    SEG codes, the forward 2-bit words (16 a word, first base high), the
    reversed complement words and the N mask words (32 a word, first base
    low); each window's forward key, reverse complement and N test read off
    them as fields. Returns the 7 planes as numpy arrays."""
    from nimble_tpu_torch.index.hashing import bucket_hashes_np

    B, L = codes.shape
    P = L - k + 1
    key_shift = np.uint64(64 - 2 * k)
    c_hi = np.zeros((B, P), np.uint32)
    c_lo, fc, pal, valid = np.zeros_like(c_hi), np.zeros((B, P), bool), np.zeros((B, P), bool), np.zeros((B, P), bool)
    raw = codes.view(np.uint8)
    for p0 in range(0, P, CHUNK):
        n = min(SEG, L - p0)
        nw = (n + 15) // 16
        nwin = min(CHUNK, P - p0)
        seg = np.zeros((B, 16 * nw), np.uint8)
        seg[:, :n] = raw[:, p0 : p0 + n]
        base = (seg & 3).astype(np.uint64).reshape(B, nw, 16)
        fw = (base << (2 * (15 - np.arange(16, dtype=np.uint64)))).sum(axis=2)  # (B, nw)
        fwd = np.zeros((B, SEG // 16 + 2), np.uint64)
        fwd[:, :nw] = fw
        rc = np.zeros_like(fwd)
        rc[:, :nw] = _rev2(~fw & M32)[:, ::-1]
        isn = np.zeros((B, 32 * (SEG // 32 + 1)), np.uint64)
        isn[:, : 16 * nw] = seg == 4
        nm = (isn.reshape(B, -1, 32) << np.arange(32, dtype=np.uint64)).sum(axis=2)
        i = np.arange(nwin)
        f = _field64(fwd, i) >> key_shift
        r = _field64(rc, 16 * nw - i - k) >> key_shift
        mi = i >> 5
        nbits = ((nm[:, mi + 1] << np.uint64(32)) | nm[:, mi]) >> (i & 31).astype(np.uint64)
        has_n = (nbits & np.uint64((1 << k) - 1)) != 0
        canon = np.where(f <= r, f, r)
        sl = slice(p0, p0 + nwin)
        c_hi[:, sl] = (canon >> np.uint64(32)).astype(np.uint32)
        c_lo[:, sl] = (canon & M32).astype(np.uint32)
        fc[:, sl], pal[:, sl] = f <= r, f == r
        valid[:, sl] = ~has_n & (p0 + i + k <= lens[:, None])
    h1, h2 = bucket_hashes_np(c_hi, c_lo, n_buckets)
    return [c_hi.view(np.int32), c_lo.view(np.int32), h1.astype(np.int32), h2.astype(np.int32), fc, pal, valid]


@pytest.mark.parametrize("L", ["k", 40, 100, 112, 150, 301])
@pytest.mark.parametrize("k", [1, 2, 16, 21, 26, 31])
def test_kmer_keys_kernel_model_matches_plain_version(k, L):
    """The segment / packed-array indexing of the CUDA kernel, modelled in
    numpy, == kmer_keys_reference on every plane: N bases, codes outside
    0-4 (bases are code & 3, only 4 is N), lens below k, reads spanning
    several segments."""
    L = k if L == "k" else L
    B, n_buckets = 9, 1 << 10
    rng = np.random.default_rng(100 * k + L)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    odd = rng.random((B, L)) < 0.02
    codes[odd] = rng.choice(np.array([-128, -4, -1, 5, 7, 12, 127], np.int8), size=int(odd.sum()))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[:3] = (max(k - 1, 0), k, L)
    codes[3, :] = 0  # an all-A read: forward keys are 0, reverse complements all ones
    got = kmer_keys_model(codes, lens, k, n_buckets)
    want = K.kmer_keys_reference(torch.from_numpy(codes), torch.from_numpy(lens), k, n_buckets)
    for name, g, w in zip(PLANES, got, want):
        assert np.array_equal(g, w.numpy()), name


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
    args = [torch.from_numpy(a).cuda() for a in (table[:, 0].copy(), table[:, 1:].copy(), idx, has)]
    before = K.band_tree_expand.launches
    got = K.band_tree_expand(*args, W)
    want = K.band_tree_expand_reference(*args, W)
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
