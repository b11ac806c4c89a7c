"""The bytes each hand kernel of the port must move for one launch's
arguments, and the least time the card needs for them.

The arithmetic is a frozen copy of nimble_tpu_torch/kernel_bench.py's
(`kmer_keys_bytes`, `mono_probe_bytes`/`mono_table_bytes`,
`band_tree_expand_bytes`, `bound_ms`): inputs read once, outputs written
once, and each distinct table row (or slot) that this input needs read
once. The data-dependent counts (distinct rows and slots) are taken on the
card as tensors, so that counting a launch inside the measured window
never waits for the card; `Counter` sums them and reads the total once.

`intersect_class_bits` is not counted: what it needs of its rows depends
on a walk of each read's runs (kernel_bench.intersect_walk) that syncs with
the host at every step.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet


def bound_s(n_bytes: float) -> float:
    """The least time the card needs to move n_bytes through HBM."""
    return n_bytes / HBM_BYTES_PER_S


def kmer_keys_bytes(B: int, L: int, k: int) -> int:
    """Codes and lens read once, seven (B, P) planes written once."""
    return B * L + 4 * B + 19 * B * (L - k + 1)


def n_distinct(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The number of distinct non-negative `values` where `keep`, as a
    0-d int64 tensor on their device (no host sync)."""
    v = torch.where(keep, values.long(), -1).flatten().sort().values
    n = 1 + (v[1:] != v[:-1]).sum() if v.numel() else torch.zeros((), dtype=torch.long, device=v.device)
    return n - (v[:1] < 0).sum()


def mono_probe_bytes(args) -> torch.Tensor:
    """Per window: h1, hi, lo and three flag bytes read, bits_f and bits_r
    (2W words) written; the S key pairs of each distinct row that a valid
    window probes and the 2W value words of each distinct slot a valid
    window matches; the stash."""
    bucket, h1, hi, lo, _fc, _pal, valid, stash, W = args
    S = bucket.shape[1] // (2 + 2 * W)
    rows = torch.where(valid, h1, 0).long()
    keys = bucket[rows, : 2 * S]
    match = (keys[..., :S] == hi[..., None]) & (keys[..., S:] == lo[..., None]) & valid[..., None]
    slot = rows[..., None] * S + torch.arange(S, device=bucket.device)
    table = n_distinct(rows, valid) * 8 * S + n_distinct(slot, match) * 8 * W
    return hi.numel() * (15 + 8 * W) + table + stash.numel() * 4


def band_tree_expand_bytes(args) -> torch.Tensor:
    """idx_sel and has_sel read, (B, W) written; each distinct band row of
    the re-laid table (a page word and 2 Pw band words) that this input
    needs, once."""
    _pages, bands, idx_sel, has_sel, W = args
    B, Q1 = idx_sel.shape
    return B * Q1 * 5 + 4 * B * W + n_distinct(idx_sel, has_sel) * (1 + bands.shape[1]) * 4


COUNTS = {
    "kmer_keys": lambda args: kmer_keys_bytes(args[0].shape[0], args[0].shape[1], args[2]),
    "mono_probe": mono_probe_bytes,
    "band_tree_expand": band_tree_expand_bytes,
}


class Counter:
    """Sums the bytes of each counted kernel's launches. Shape-only counts
    add up on the host; data-dependent ones are taken on the card after
    the launch, on its stream, inside a `bench.count` range, so that the
    trace's reader can leave their device work out and they never overlap
    the kernel they count."""

    def __init__(self):
        self.host = {}
        self.dev = {}
        self.launches = {}

    def add(self, name: str, args) -> None:
        fn = COUNTS.get(name)
        if fn is None:
            return
        self.launches[name] = self.launches.get(name, 0) + 1
        dev = next(a for a in args if isinstance(a, torch.Tensor)).device
        if name == "kmer_keys" or dev.type != "cuda":
            got = fn(args)
            if isinstance(got, torch.Tensor):
                got = int(got)
            self.host[name] = self.host.get(name, 0) + got
            return
        with torch.profiler.record_function("bench.count"):
            got = fn(args)
            acc = self.dev.get(name)
            self.dev[name] = got if acc is None else acc + got

    def total(self) -> dict:
        """{kernel: bytes} over every launch counted (one host sync)."""
        out = dict(self.host)
        for name, t in self.dev.items():
            out[name] = out.get(name, 0) + int(t)
        return out
