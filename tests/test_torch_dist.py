"""`report --distributed N` in the port (nimble_tpu_torch/parallel/dist.py)
against the reference's (nimble_tpu/parallel/dist.py over its 8-device CPU
mesh, tests/conftest.py) and the exact host report, after tests/test_dist.py
and tests/test_mesh_cli.py:176: the hashes and the bucket exchange equal the
reference's, and the count TSV is byte-identical to both for N in {1, 2, 3,
8}, on a skewed barcode, under a forced salt fallback, with empty shards and
on an empty TSV. On cuda, N above the visible device count is refused before
any work."""
import numpy as np
import pytest
import torch

import nimble_tpu.parallel.dist as ref_dist
import nimble_tpu_torch.parallel.dist as port_dist
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.parallel.mesh import make_mesh
from nimble_tpu.quant.exact import report_rows
from nimble_tpu_torch.__main__ import main as port_cli
from tests.test_dist import to_bits

CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 8)


def write_align_tsv(path, rows):
    """An align TSV holding the columns `report` reads, one row per (cb,
    umi, features, score)."""
    with open(path, "w") as f:
        f.write("nimble_features\tnimble_score\tr1_CB\tr1_UB\n")
        for cb, umi, feats, score in rows:
            f.write(f"{feats}\t{score}\t{cb}\t{umi}\n")
    return str(path)


def mixed_rows(seed: int = 7):
    """12 cells x 10 UMIs, 1-3 reads a UMI over 25 features, 1-3 features a
    read (tests/test_dist.py's workload)."""
    rng = np.random.default_rng(seed)
    vocab = [f"g{i:02d}" for i in range(25)]
    rows = []
    for cell in range(12):
        for umi in range(10):
            for _ in range(int(rng.integers(1, 4))):
                feats = sorted(rng.choice(25, size=int(rng.integers(1, 4)), replace=False))
                rows.append((f"CELL{cell:02d}", f"UMI{umi:02d}", ",".join(vocab[f] for f in feats),
                             int(rng.integers(1, 60))))
    return rows


def skewed_rows(seed: int = 3):
    """One barcode holding half the rows (an over-sequenced cell): 400 rows
    over 200 UMIs, beside 40 cells of 10 rows."""
    rng = np.random.default_rng(seed)
    vocab = [f"g{i:02d}" for i in range(10)]
    rows = [("HOTCELL", f"UMI{umi:03d}", vocab[int(rng.integers(0, 10))], 30) for umi in range(200) for _ in range(2)]
    rows += [(f"CELL{cell:02d}", f"UMI{umi:03d}", vocab[int(rng.integers(0, 10))], 30)
             for cell in range(40) for umi in range(10)]
    return rows


def three_ways(tmp_path, tsv, n: int, tag: str = ""):
    """The port's `report --distributed n --device cpu`, the reference's
    `report --distributed n` and the port's host report on one TSV; returns
    their bytes."""
    outs = {k: tmp_path / f"{tag}{k}{n}.tsv" for k in ("port", "ref", "host")}
    assert port_cli(["report", "-i", tsv, "-o", str(outs["port"]), "--distributed", str(n), "--device", "cpu"]) == 0
    assert ref_cli(["report", "-i", tsv, "-o", str(outs["ref"]), "--distributed", str(n)]) == 0
    assert port_cli(["report", "-i", tsv, "-o", str(outs["host"])]) == 0
    return [outs[k].read_bytes() for k in ("port", "ref", "host")]


def test_hashes_equal_reference():
    strings = np.array(["AAACCTGAGAAGGCCT", "AAACCTGAGAAGGCCA", "UMI0001", "", "ÅÄÖ-é"], dtype=object)
    for s in strings:
        for salt in (0, 1, 7):
            assert port_dist.hash64(s, salt) == ref_dist.hash64(s, salt)
    for salt in (0, 3):
        assert np.array_equal(port_dist._hash_unique(strings, salt), ref_dist._hash_unique(strings, salt))
    got = port_dist._collision_free_hashes(strings)
    assert np.array_equal(got, ref_dist._collision_free_hashes(strings))
    assert np.array_equal(port_dist._combined_key(got), ref_dist._combined_key(got))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_bucket_exchange_roundtrip(n_shards):
    """Shard s receives the s-th block of every source shard, in source
    order, as the reference's all_to_all delivers it."""
    blk, width = 3, 2
    rows = np.arange(n_shards * n_shards * blk * width, dtype=np.int32).reshape(n_shards, n_shards * blk, width)
    valid = np.random.default_rng(n_shards).random((n_shards, n_shards * blk)) < 0.7
    got = port_dist.cb_bucket_all_to_all([CPU] * n_shards, rows, valid)
    want_rows, want_valid = ref_dist.cb_bucket_all_to_all(make_mesh(n_data=n_shards, n_feature=1).mesh, rows, valid)
    assert len(got) == n_shards
    for s, (r, v) in enumerate(got):
        assert r.device == CPU and np.array_equal(r.numpy(), want_rows[s])
        assert np.array_equal(v.numpy(), want_valid[s])
        for src in range(n_shards):
            assert np.array_equal(r[src * blk : (src + 1) * blk].numpy(), rows[src, s * blk : (s + 1) * blk])


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("workload", ["mixed", "skewed"])
def test_distributed_report_matches_reference_and_exact(workload, n_shards):
    """distributed_report over round-robin shards: the reference's counts,
    dropped UMIs and exchange statistics, and the exact host counts; on the
    skewed barcode the padded buffer stays within 3x the rows."""
    rows = mixed_rows() if workload == "mixed" else skewed_rows()
    vocab = sorted({f for r in rows for f in r[2].split(",")})
    shard_rows = [[] for _ in range(n_shards)]
    for i, (cb, umi, feats, score) in enumerate(rows):
        shard_rows[i % n_shards].append((cb, umi, to_bits(feats, vocab), float(score)))
    got, dropped, stats = port_dist.distributed_report([CPU] * n_shards, shard_rows, vocab, 0.05,
                                                       with_dropped=True, with_stats=True)
    want = ref_dist.distributed_report(make_mesh(n_data=n_shards, n_feature=1).mesh, shard_rows, vocab, 0.05,
                                       with_dropped=True, with_stats=True)
    assert (got, dropped, stats) == want
    assert got == report_rows(rows, 0.05)[0]
    if workload == "skewed":
        assert stats["buffer_rows"] <= 3 * stats["rows"], stats


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("workload", ["mixed", "skewed", "tagged"])
def test_report_distributed_cli_matches_reference_and_host(tmp_path, workload, n_shards):
    if workload == "tagged":
        from tests.test_torch_goldens import tagged_tsv

        tsv = tagged_tsv(tmp_path / "tagged.tsv")
    else:
        tsv = write_align_tsv(tmp_path / "in.tsv", mixed_rows() if workload == "mixed" else skewed_rows())
    port, ref, host = three_ways(tmp_path, tsv, n_shards)
    assert host and port == ref == host


def test_salt_fallback(tmp_path, monkeypatch):
    """A collision in the salt-0 family (forced in both packages) moves both
    to a salted family: the same bytes as the host report."""
    salts = []

    def colliding(real):
        def hash_unique(strings, salt):
            h = real(strings, salt)
            salts.append(salt)
            if salt == 0 and len(strings) >= 2:
                h[1] = h[0]
            return h
        return hash_unique

    for mod in (port_dist, ref_dist):
        monkeypatch.setattr(mod, "_hash_unique", colliding(mod._hash_unique))
    tsv = write_align_tsv(tmp_path / "in.tsv", mixed_rows(seed=5))
    port, ref, host = three_ways(tmp_path, tsv, 4)
    assert host and port == ref == host
    assert salts.count(1) >= 4  # cb and umi, in both packages


def test_empty_shards(tmp_path):
    """Two (cb, umi) groups over 8 shards leave shards with nothing."""
    rows = [("c1", "U1", "A", 30), ("c1", "U1", "A,B", 20), ("c2", "U2", "B", 30)]
    tsv = write_align_tsv(tmp_path / "in.tsv", rows)
    port, ref, host = three_ways(tmp_path, tsv, 8)
    assert port == ref == host == b"A\t1\tc1\nB\t1\tc2\n"


@pytest.mark.parametrize("content", ["", "nimble_features\tnimble_score\tr1_CB\tr1_UB\n"], ids=["empty", "header-only"])
def test_empty_tsv(tmp_path, content):
    tsv = tmp_path / "in.tsv"
    tsv.write_text(content)
    port, ref, host = three_ways(tmp_path, str(tsv), 2)
    assert port == ref == host == b""


def test_more_shards_than_cuda_devices_refuses(tmp_path, monkeypatch):
    """On cuda, N above torch.cuda.device_count() raises before any work,
    naming the count and --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tsv = write_align_tsv(tmp_path / "in.tsv", mixed_rows())
    out = tmp_path / "out.tsv"
    with pytest.raises(ValueError, match=r"needs 2 CUDA devices, and 1 is visible; pass --device cpu"):
        port_cli(["report", "-i", tsv, "-o", str(out), "--distributed", "2"])
    assert not out.exists()
    assert port_dist.shard_devices(1, "cuda") == [torch.device("cuda", 0)]
    assert port_dist.shard_devices(3, "cpu") == [CPU] * 3
    with pytest.raises(ValueError, match="at least one shard"):
        port_dist.shard_devices(0, "cpu")
