"""nimble_tpu_torch/kernel_bench.py's helpers on the CPU (its timing needs
the card): the FASTQ head reader against seq.encode_batch, the arguments
captured from the engine's align_batch against the engine's own inputs and
tables, and the byte counts the bounds are taken from."""
import gzip

import numpy as np
import pytest
import torch

from nimble_tpu_torch import bench_data
from nimble_tpu_torch import kernel_bench as KB
from nimble_tpu_torch import seq as seqmod
from nimble_tpu_torch.align import kernels as K


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return bench_data.write_single(tmp_path_factory.mktemp("se"), 300)


@pytest.mark.parametrize("B, L", [(300, 112), (17, 100), (5, 64)])
def test_fastq_head_equals_encode_batch(bench, B, L):
    _, fq = bench
    with gzip.open(fq, "rt") as f:
        seqs = [ln.strip() for i, ln in enumerate(f) if i % 4 == 1][:B]
    codes, lens = KB.fastq_head(fq, B, L)
    want_codes, want_lens = seqmod.encode_batch(seqs, max_len=L)
    assert codes.dtype == want_codes.dtype and np.array_equal(codes, want_codes)
    assert lens.dtype == want_lens.dtype and np.array_equal(lens, want_lens)


@pytest.mark.parametrize("probe", ["group", "mono"])
def test_captured_arguments_are_the_main_paths(bench, probe):
    """The kernel's first call in align_batch, on the engine's own tables:
    kmer_keys gets the chunk's codes at k+g-1 and the group table's size;
    mono_probe the mono table itself and the planes of kmer_keys at k."""
    lib, fq = bench
    _, eng = KB.engine(lib, group_g=0 if probe == "mono" else None, device="cpu", chunk_size=64)
    codes, lens = KB.fastq_head(fq, 64, eng.max_len)
    p = eng.params
    if probe == "group":
        args = KB.captured(eng, codes, lens, "kmer_keys")
        c, ln, k, nb = args
        assert torch.equal(c, torch.from_numpy(codes)) and torch.equal(ln, torch.from_numpy(lens))
        assert (k, nb) == (p.k + p.group_g - 1, eng.tables["group_bucket"].shape[0])
        assert KB.kernel_bytes("kmer_keys", args) == 64 * eng.max_len + 4 * 64 + 19 * 64 * (eng.max_len - k + 1)
        return
    args = KB.captured(eng, codes, lens, "mono_probe")
    bucket, h1, hi, lo, fc, pal, valid, stash, W = args
    assert bucket is eng.tables["mono_bucket"] and stash is eng.tables["mono_stash"]
    hi_w, lo_w, h1_w, _h2, fc_w, pal_w, valid_w = K.kmer_keys(
        torch.from_numpy(codes), torch.from_numpy(lens), p.k, bucket.shape[0])
    for got, want in ((h1, h1_w), (hi, hi_w), (lo, lo_w), (fc, fc_w), (pal, pal_w), (valid, valid_w)):
        assert torch.equal(got, want)
    n = KB.kernel_bytes("mono_probe", args)
    streams = KB.mono_probe_bytes(hi.numel(), W, 0)
    rows = int(torch.unique(h1[valid]).numel())
    assert streams + rows * 8 * 4 + stash.numel() * 4 < n <= streams + rows * (8 * 4 + 4 * 8 * W) + stash.numel() * 4
