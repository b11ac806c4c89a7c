"""Torch twin of nimble_tpu/index/hashing.py: the bucket hash spec on int64
tensors holding uint32 values.

torch has no usable uint32 arithmetic on the CPU (`>>` on uint32 is not
implemented), so values travel as int64 in [0, 2^32) and are masked back to
32 bits after every multiply and shift. Each 32-bit multiplier is split into
16-bit halves so that no intermediate product exceeds 2^48: nothing relies on
int64 overflow."""
from __future__ import annotations

import torch

from nimble_tpu.index.hashing import _C1, _C2, _GOLDEN

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) -> int64 in [0, 2^32)."""
    return x.long() & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # high half only contributes its low 16 bits
    return (lo + hi) & MASK32


def mix32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """nimble_tpu.index.hashing.mix32_np on int64 tensors."""
    x = (mul32(u32(a), _GOLDEN) + u32(b)) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def bucket_hashes(hi: torch.Tensor, lo: torch.Tensor, n_buckets: int):
    """The two candidate bucket ids of each (hi, lo) key, as int64.
    n_buckets must be a power of two."""
    mask = n_buckets - 1
    hi, lo = u32(hi), u32(lo)
    h1 = mix32(lo, hi) & mask
    h2 = mix32(hi ^ _C2, lo ^ _C1) & mask
    return h1, h2
