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


def test_band_spread_counts_reads_by_their_pages():
    """Each read falls in one class by its contributing pages: none, one
    page, two adjacent pages, a gap of 2 or more; indices clamp as the
    gather clamps them."""
    pages = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    idx = torch.tensor([[0, 1, 9], [2, 2, 0], [1, 2, 0], [3, -5, 3], [3, 3, 3]], dtype=torch.int32)
    has = torch.tensor([[False, False, False], [True, True, False], [True, True, False],
                        [True, True, False], [True, False, True]])
    sp = KB.band_spread(pages, idx, has)  # no row; page 2; pages 1-2; pages 3 and 0 (clamped); page 3
    assert sp == pytest.approx({"no_row": 0.2, "one_page": 0.4, "adjacent": 0.2, "gap2": 0.2, "mean_rows": 1.6})


@pytest.mark.parametrize("patch, marks", [(KB._ORDINARY_STORES, ("ordinary_store(", "__stcs(")),
                                          (KB._SCALAR_ZEROS, ("store_outside_scalar(out_r", None)),
                                          (KB._INTERLEAVED_TABLE, ("nt_band_tree_expand_table", None))])
def test_band_variant_patches_apply_to_the_kernel_source(patch, marks):
    """The experimental variants of band_variants find what they replace in
    csrc/band_tree_expand.cu, and a source without it is refused."""
    with open(f"{K.CSRC}/band_tree_expand.cu") as f:
        src = f.read()
    new, gone = marks
    out = patch(src)
    assert new not in src and new in out
    assert gone is None or gone not in out
    if patch is not KB._INTERLEAVED_TABLE:
        with pytest.raises(AssertionError, match="is not in"):
            patch("// an unrelated source\n")


def test_band_args_read_both_table_layouts():
    """kernel_bytes and the page spread take band_tree_expand's arguments as
    this checkout passes them (the re-laid table) and as older checkouts do
    (one [page | band] table), with the same bytes."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.integers(0, 5, size=(40, 1 + 2 * 8)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-2, 45, size=(6, 4)).astype(np.int32))
    has = torch.from_numpy(rng.random((6, 4)) < 0.7)
    split = (table[:, 0].contiguous(), table[:, 1:].contiguous(), idx, has, 30)
    old = (table, idx, has, 30, 8)
    assert KB.kernel_bytes("band_tree_expand", split) == KB.kernel_bytes("band_tree_expand", old)
    rows = int(torch.unique(idx[has]).numel())
    assert KB.kernel_bytes("band_tree_expand", split) == 6 * 4 * 5 + 4 * 6 * 30 + rows * 17 * 4
    for a, b in zip(KB.band_args(split), KB.band_args(old)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("probe, key", [("group", "groupcls_bucket"), ("mono", "mcls_bucket")])
def test_class_stages_compose_the_step(tmp_path, probe, key):
    """The stages that chip_smoke.py times, run in order, are the class-id
    paths' align_step + pack_outputs (one family of the wide generator:
    W = 32, no bands; groupcls, and monocls under --probe mono)."""
    from nimble_tpu_torch.align import engine as T

    lib, fq, _, _ = bench_data.write_wide(tmp_path, 64, 0, families=1)
    _, eng = KB.engine(lib, group_g=0 if probe == "mono" else None, device="cpu", chunk_size=64)
    assert key in eng.tables and "class_bits" in eng.tables
    codes, lens = (torch.from_numpy(a) for a in KB.fastq_head(fq, 64, eng.max_len))
    x = None
    stages = KB.class_stages(eng, codes, lens)
    for _, fn in stages:
        x = fn(x)
    assert [name for name, _ in stages] == ["window", "probe", "intersection", "combine + pack"]
    want = T.pack_outputs(T.align_step(eng.tables, eng.params, codes, lens))
    assert torch.equal(x, want) and T.unpack_outputs(want.numpy(), 32, 64)["pass_"].any()
