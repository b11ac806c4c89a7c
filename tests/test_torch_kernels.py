"""The port's window stage (nimble_tpu_torch/align/kernels.py) against the
reference: `kmer_keys_pallas` in interpret mode and the engine's jnp path,
exactly, on all 7 planes. The CUDA kernel against its torch twin runs only
where a card is visible."""
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
