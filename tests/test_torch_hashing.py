"""The port's bucket hashes (nimble_tpu_torch/index/hashing.py) against the
reference's numpy spec (nimble_tpu/index/hashing.py), bit for bit."""
import numpy as np
import pytest
import torch

from nimble_tpu.index.hashing import bucket_hashes_np, mix32_np
from nimble_tpu_torch.index.hashing import bucket_hashes, mix32, mul32


def _keys(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)
    hi = np.concatenate([hi, edge, edge[::-1]])
    lo = np.concatenate([lo, edge, edge])
    assert (hi >= 1 << 31).any() and (lo >= 1 << 31).any()
    return hi, lo


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("n_buckets", [1, 2, 1 << 10, 1 << 18, 1 << 31])
def test_bucket_hashes_match_numpy(n_buckets):
    hi, lo = _keys(n_buckets)
    want1, want2 = bucket_hashes_np(hi, lo, n_buckets)
    got1, got2 = bucket_hashes(_t(hi), _t(lo), n_buckets)
    assert got1.dtype == torch.int64
    assert np.array_equal(got1.numpy(), want1.astype(np.int64))
    assert np.array_equal(got2.numpy(), want2.astype(np.int64))


def test_bucket_hashes_take_int32_bit_patterns():
    """Keys given as int32 bit patterns (the device tables' storage) hash
    like their uint32 values."""
    hi, lo = _keys(7)
    want1, want2 = bucket_hashes_np(hi, lo, 1 << 16)
    got1, got2 = bucket_hashes(
        torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32)), 1 << 16
    )
    assert np.array_equal(got1.numpy(), want1.astype(np.int64))
    assert np.array_equal(got2.numpy(), want2.astype(np.int64))


def test_mix32_and_mul32_match_uint32_arithmetic():
    a, b = _keys(3)
    assert np.array_equal(mix32(_t(a), _t(b)).numpy(), mix32_np(a, b).astype(np.int64))
    for c in (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1):
        want = (a.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        assert np.array_equal(mul32(_t(a), c).numpy(), want.astype(np.int64))
