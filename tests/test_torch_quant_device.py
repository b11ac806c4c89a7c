"""The port's device report (nimble_tpu_torch/quant/device.py) on the CPU,
against the reference's device engine (nimble_tpu/quant/device.py, jax on
the CPU) and the port's exact host report: every case of
tests/test_quant_device.py through `report_device(..., device="cpu")`,
`device_umi_pipeline`'s four outputs on seeded inputs, its bit helpers on
edge patterns, and the report workload of `bench_data.write_report_tsv`.
Every compared output is an integer, a bool or a string: equality is
exact throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import jit

from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.quant import device as R
from nimble_tpu_torch import bench_data
from nimble_tpu_torch.__main__ import main as cli
from nimble_tpu_torch.quant import device as P
from nimble_tpu_torch.quant.exact import convert_rows_to_proper_umi, per_umi_thresholding, report_rows
from nimble_tpu_torch.report.tsv import extract_report_rows, read_alignment_tsv


def to_bits(features, vocab):
    W = max(1, -(-len(vocab) // 32))
    out = np.zeros(W, dtype=np.uint32)
    for f in features.split(","):
        i = vocab.index(f)
        out[i // 32] |= np.uint32(1 << (i % 32))
    return out.view(np.int32)


def run_three(rows, threshold, vocab=None, disable=False):
    """(reference device report, port device report on the cpu, port host
    report) of the same rows."""
    if vocab is None:
        vocab = sorted({f for _, _, fs, _ in rows for f in fs.split(",")})
    cbs = [r[0] for r in rows]
    umis = [r[1] for r in rows]
    bits = np.stack([to_bits(r[2], vocab) for r in rows])
    scores = np.array([r[3] for r in rows], dtype=np.float64)
    ref = R.report_device(cbs, umis, bits, scores, vocab, threshold, disable, with_dropped=True)
    got = P.report_device(cbs, umis, bits, scores, vocab, threshold, disable, with_dropped=True, device="cpu")
    host = report_rows(rows, threshold, disable)
    return ref, got, host


def random_rows(seed, n_features, cells, umis, reads, span=None):
    """(rows, 0.05, vocab): each UMI has 1-`reads` reads of 1-3 features,
    drawn from all features or from a window of `span` at a random base."""
    rng = np.random.default_rng(seed)
    vocab = [f"f{i:05d}" for i in range(n_features)]
    rows = []
    for cell in range(cells):
        for umi in range(umis):
            base = 0 if span is None else int(rng.integers(0, n_features - span))
            for _ in range(int(rng.integers(1, reads + 1))):
                k = int(rng.integers(1, 4))
                pool = n_features if span is None else span
                feats = sorted(rng.choice(pool, size=k, replace=False) + base)
                rows.append((f"cell{cell}", f"UMI{umi}", ",".join(vocab[f] for f in feats),
                             int(rng.integers(1, 100))))
    return rows, 0.05, vocab


# the cases of tests/test_quant_device.py: (rows, threshold, vocab, disable)
REPORT_CASES = {
    "basic": ([("cell1", "U1", "A,B", 10), ("cell1", "U1", "A,C", 20), ("cell2", "U2", "D", 5)], 0.2),
    "pipeline-one-row": ([("c1", "U1", "A,B,C", 3)], 0.4),
    "pipeline-one-feature": ([("c1", "U1", "A", 10)], 0.9),
    "pipeline-three-umis": ([("c1", "U1", "A,B", 10), ("c1", "U1", "A,C", 20), ("c2", "U2", "D,E", 30),
                             ("c2", "U2", "D,F", 40), ("c3", "U3", "G", 50)], 0.2),
    "pipeline-duplicate-rows": ([("c1", "U1", "A,B", 10), ("c1", "U1", "A,B", 10)], 0.1),
    "pipeline-five-umis": ([("c1", "U1", "A,B", 10), ("c1", "U1", "A,C", 20), ("c1", "U2", "B,D", 15),
                            ("c2", "U3", "E,F", 5), ("c2", "U3", "F,G", 35), ("c3", "U4", "H,I", 25),
                            ("c3", "U5", "I,J", 15), ("c3", "U5", "H,J", 10)], 0.2),
    "pipeline-zero-score": ([("c1", "U1", "A,B", 0), ("c1", "U1", "C,D", 20)], 0.1),
    "pipeline-boundary-survives": ([("c1", "U1", "A,B", 10)], 0.5),
    "disable-thresholding": ([("c1", "U1", "A,B,C", 1)], 0.4, None, True),
    # 8 cells x 30 UMIs x 1-4 reads over 40 features
    "random-workload": (*random_rows(0, 40, 8, 30, 4),),
    # the word-blocked pipeline at HLA/KIR scale: W = 625 words
    "wide-20k": (*random_rows(11, 20000, 6, 8, 3, span=4),),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_report_device_cases(case):
    rows, threshold, *rest = REPORT_CASES[case]
    vocab = rest[0] if rest else None
    disable = rest[1] if len(rest) > 1 else False
    ref, got, host = run_three(rows, threshold, vocab, disable)
    assert got == ref
    assert got == host
    if case == "disable-thresholding":
        assert got[0] == [("A,B,C", 1, "c1")]


TIE = [("c1", "U1", "A", 3.0), ("c1", "U1", "B", 1.0)]  # B's ratio is exactly 0.25


# rows, threshold, NIMBLE_TPU_TIE_EPS, disable_thresholding, warns
TIE_CASES = {
    "exact-boundary-warns": (TIE, 0.25, None, False, True),
    "clear-ratios-quiet": ([("c1", "U1", "A,B", 10.0), ("c1", "U1", "A,C", 20.0)], 0.2, None, False, False),
    "guard-disabled-by-env": (TIE, 0.25, "0", False, False),
    "thresholding-disabled-quiet": (TIE, 0.25, None, True, False),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_tie_guard(case, capsys, monkeypatch):
    rows, threshold, env, disable, warns = TIE_CASES[case]
    if env is not None:
        monkeypatch.setenv("NIMBLE_TPU_TIE_EPS", env)
    vocab = sorted({f for _, _, fs, _ in rows for f in fs.split(",")})
    cbs, umis = [r[0] for r in rows], [r[1] for r in rows]
    bits = np.stack([to_bits(r[2], vocab) for r in rows])
    scores = np.array([r[3] for r in rows], dtype=np.float64)
    ref = R.report_device(cbs, umis, bits, scores, vocab, threshold, disable, with_dropped=True)
    ref_err = capsys.readouterr().err
    got = P.report_device(cbs, umis, bits, scores, vocab, threshold, disable, with_dropped=True, device="cpu")
    err = capsys.readouterr().err
    assert got == ref == report_rows(rows, threshold, disable)
    assert ("WARNING" in err) == ("WARNING" in ref_err) == warns
    assert err == ref_err  # the reference's words
    if warns:
        assert "threshold" in err


def test_factorize():
    codes, uniq = P.factorize(["b", "a", "b", "c"])
    assert codes.tolist() == [0, 1, 0, 2]
    assert uniq == ["b", "a", "c"]
    ref_codes, ref_uniq = R.factorize(["b", "a", "b", "c"])
    assert codes.dtype == ref_codes.dtype and np.array_equal(codes, ref_codes) and uniq == ref_uniq


def test_empty():
    assert P.report_device([], [], np.zeros((0, 1)), np.zeros(0), ["A"], device="cpu") == []
    assert P.report_device_rows([], device="cpu") == ([], 0)


def test_report_device_rows_matches_reference():
    rows, _, _ = random_rows(3, 70, 5, 20, 6)
    got = P.report_device_rows(rows, 0.05, device="cpu")
    assert got == R.report_device_rows(rows, 0.05) == report_rows(rows, 0.05)
    assert P.rows_to_bitsets(rows)[2].tobytes() == R.rows_to_bitsets(rows)[2].tobytes()


def test_rows_to_bitsets_matches_reference():
    """First-seen factorization, duplicate names in one row, feature 31 of
    a word (the sign bit) and several words."""
    names = [f"g{i}" for i in range(70)]
    rows = [("c", "u", "g31,g0,g31", 5), ("c", "u", "g63", 7), ("d", "v", ",".join(names[::-1]), 9)]
    got = P.rows_to_bitsets(rows)
    ref = R.rows_to_bitsets(rows)
    assert got[0] == ref[0] and got[1] == ref[1] and got[4] == ref[4]
    assert got[2].dtype == ref[2].dtype == np.int32 and np.array_equal(got[2], ref[2])
    assert got[3].dtype == ref[3].dtype and np.array_equal(got[3], ref[3])


def test_report_device_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        P.report_device_rows([("c", "u", "A", 1.0)])


# --- device_umi_pipeline against the reference's, output for output ---


def pipeline_case(name):
    """Seeded (group_ids, bits, scores, n_groups, n_features, threshold,
    tie_eps) for one named case."""
    seed = sum(map(ord, name))
    rng = np.random.default_rng(seed)
    F = {"w1": 32, "w4": 100, "w625": 20000}.get(name, 100)
    W = -(-F // 32)
    N, G = 600, 150
    gid = rng.integers(0, G, N).astype(np.int32)
    bits = np.zeros((N, W), dtype=np.uint32)
    for i in range(N):
        base = int(rng.integers(0, F - 8)) if F > 40 else 0
        for f in rng.choice(min(F, 8 if F > 40 else F), size=int(rng.integers(1, 5)), replace=False) + base:
            bits[i, f >> 5] |= np.uint32(1 << (f & 31))
    scores = rng.integers(60, 151, N).astype(np.float32)
    threshold, eps = 0.05, 1e-5
    if name == "sign-bit":  # feature 31 of every word set on half the rows
        bits[::2] |= np.uint32(1 << 31)
    elif name == "zero-total":  # groups 0-9 have only zero scores
        scores[gid < 10] = 0.0
    elif name == "all-die":  # two disjoint equal reads per group: each ratio 0.5 < 0.6
        gid = np.repeat(np.arange(N // 2, dtype=np.int32), 2)
        G = N // 2
        bits[:] = 0
        bits[0::2, 0] = 1
        bits[1::2, 0] = 2
        scores[:] = 50.0
        threshold = 0.6
    elif name == "threshold-0":
        threshold = 0.0
    elif name == "ties":  # integer ratios that land exactly on 0.25
        scores = rng.choice([1.0, 3.0, 4.0, 12.0], size=N).astype(np.float32)
        threshold = 0.25
    elif name == "empty-groups":  # group ids leave gaps and the tail empty
        gid = (gid // 2) * 2
        G += 20
    elif name == "skewed":  # one group holds a third of the rows
        gid[: N // 3] = 7
    return gid, bits.view(np.int32), scores, G, F, threshold, eps


PIPELINE_CASES = ["w1", "w4", "w625", "sign-bit", "zero-total", "all-die", "threshold-0", "ties",
                  "empty-groups", "skewed"]

_ref_pipeline = jit(R.device_umi_pipeline, static_argnums=(3, 4, 5, 6))


def port_pipeline(gid, bits, scores, G, F, threshold, eps, stats=None):
    out = P.device_umi_pipeline(torch.from_numpy(gid), torch.from_numpy(bits), torch.from_numpy(scores),
                                G, F, threshold, eps, stats)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("case", PIPELINE_CASES)
def test_pipeline_matches_reference(case):
    gid, bits, scores, G, F, threshold, eps = pipeline_case(case)
    ref = [np.asarray(x) for x in _ref_pipeline(jnp.asarray(gid), jnp.asarray(bits), jnp.asarray(scores),
                                                G, F, threshold, eps)]
    stats = {}
    got = port_pipeline(gid, bits, scores, G, F, threshold, eps, stats)
    for name, r, g in zip(("inter_bits", "group_alive", "reached_intersection", "near_ties"), ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape, name
        assert np.array_equal(r, g), name
    alive, reached = got[1], got[2]
    assert stats["iterations"] >= (1 if threshold > 0 else 0)
    if case == "sign-bit":
        assert (got[0][got[1]] < 0).any()  # bit 31 survives into the intersection
    if case == "all-die":
        assert not reached.any()
    if case == "zero-total":
        assert alive.any()
    if case == "ties":
        assert int(got[3]) > 0
    if case == "empty-groups":
        assert not reached[1::2].any()


def test_pipeline_word_blocks_change_nothing(monkeypatch):
    """A budget of one word a block gives the same outputs as one block of
    all words."""
    case = pipeline_case("w625")
    whole = port_pipeline(*case, stats=(st := {}))
    assert st["block_words"] == 625
    monkeypatch.setattr(P, "BLOCK_BYTES", 1)
    one = port_pipeline(*case, stats=(st1 := {}))
    assert st1["block_words"] == 1
    for a, b in zip(whole, one):
        assert np.array_equal(a, b)


def test_pipeline_two_runs_equal():
    case = pipeline_case("ties")
    a, b = port_pipeline(*case), port_pipeline(*case)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA, 0x0F0F0F0F,
                 0xF0F0F0F0, 0x01010101, 0x80808080, 0xFF000000, 0x00FFFFFF, 0x80000001, 0xFFFFFFFE],
                dtype=np.uint32)


def test_popcount32_edge_patterns():
    x = np.concatenate([EDGE, np.random.default_rng(5).integers(0, 1 << 32, 256, dtype=np.uint64)
                        .astype(np.uint32)]).view(np.int32)
    got = P.popcount32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    assert got.tolist() == [bin(int(v)).count("1") for v in x.view(np.uint32)]
    assert np.array_equal(got, np.asarray(R.popcount32(jnp.asarray(x))))


def test_expand_and_pack_bits_match_reference():
    bits = np.stack([EDGE, EDGE[::-1]], axis=1).view(np.int32)  # (16, 2): bit 31 on many rows
    for n_features in (64, 40, 33):
        got = P._expand_bits(torch.from_numpy(bits), n_features).numpy()
        ref = np.asarray(R._expand_bits(jnp.asarray(bits), n_features))
        assert np.array_equal(got, ref)
        packed = P._pack_bits(torch.from_numpy(got), 2).numpy()
        assert packed.dtype == np.int32
        assert np.array_equal(packed, np.asarray(R._pack_bits(jnp.asarray(ref), 2)))
    assert np.array_equal(P._pack_bits(P._expand_bits(torch.from_numpy(bits), 64), 2).numpy(), bits)


def test_valid_words_match_reference():
    for W, F in ((1, 32), (1, 31), (2, 33), (625, 20000)):
        valid = np.zeros(W * 32, dtype=np.int64)
        valid[:F] = 1
        ref = (valid.reshape(W, 32) << np.arange(32)).sum(axis=1).astype(np.uint32).view(np.int32)
        assert np.array_equal(P._valid_words(W, F), ref)


# --- the report workload (bench_data.write_report_tsv) ---


def test_write_report_tsv(tmp_path):
    """Same seed, same bytes; the port's host report reads it; at a small
    size it has UMIs with several reads, features dropped by thresholding
    and empty intersections, and the device report equals the host one."""
    a, b, c = (tmp_path / f"{x}.tsv" for x in "abc")
    info = bench_data.write_report_tsv(a, 4000, bench_data.hla100_names(), 3)
    bench_data.write_report_tsv(b, 4000, bench_data.hla100_names(), 3)
    bench_data.write_report_tsv(c, 4000, bench_data.hla100_names(), 4)
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()
    rows = extract_report_rows(read_alignment_tsv(str(a)))
    assert len(rows) == 4000
    sizes = {}
    for cb, umi, _, _ in rows:
        sizes[(cb, umi)] = sizes.get((cb, umi), 0) + 1
    assert len(sizes) == info["umis"]
    assert sum(v > 1 for v in sizes.values()) > len(sizes) // 2 and max(sizes.values()) <= 16
    merged = convert_rows_to_proper_umi(rows)
    thresholded = per_umi_thresholding(merged, 0.05)
    assert sum(r[4] != r[2] for r in thresholded) > 0  # features dropped by thresholding
    assert len(thresholded) < len(merged)  # and whole rows
    counts, dropped = report_rows(rows, 0.05)
    assert counts and dropped > 0  # empty intersections
    assert P.report_device_rows(rows, 0.05, device="cpu") == (counts, dropped)
    names = {f for _, _, fs, _ in rows for f in fs.split(",")}
    assert names <= set(bench_data.hla100_names())
    wide = bench_data.wide_names()
    assert len(wide) == 20000 and wide[0] == "F00*0000" and wide[-1] == "F19*0999"


def test_report_device_cli_on_report_workload(tmp_path):
    """`report --device cpu` of the port, the reference CLI's `report
    --device` and the port's host report give the same bytes on the report
    workload, which has near ties at the 0.05 threshold."""
    tsv = str(tmp_path / "in.tsv")
    bench_data.write_report_tsv(tsv, 3000, bench_data.hla100_names(), 9)
    outs = {k: str(tmp_path / f"{k}.tsv") for k in ("host", "dev", "ref")}
    assert cli(["report", "-i", tsv, "-o", outs["host"]]) == 0
    assert cli(["report", "-i", tsv, "-o", outs["dev"], "--device", "cpu"]) == 0
    assert ref_cli(["report", "-i", tsv, "-o", outs["ref"], "--device"]) == 0
    got = {k: open(v, "rb").read() for k, v in outs.items()}
    assert got["host"] and got["dev"] == got["ref"] == got["host"]


def test_hold_to_host_rule(tmp_path):
    """report_bench's comparison (chip_smoke.py's report phase): the same
    bytes pass; otherwise at most 2 x near_ties count rows may differ, and
    none when near_ties is 0."""
    from nimble_tpu_torch.report_bench import hold_to_host

    host = tmp_path / "host.tsv"
    host.write_text("A\t2\tc1\nB\t1\tc1\nA\t1\tc2\n")
    moved = tmp_path / "moved.tsv"  # one UMI moved from (A, c1) to (B, c1)
    moved.write_text("A\t1\tc1\nB\t2\tc1\nA\t1\tc2\n")
    worse = tmp_path / "worse.tsv"
    worse.write_text("A\t1\tc1\nB\t2\tc1\nA\t2\tc2\n")
    assert hold_to_host("same", str(host), str(host), 0) == 0
    assert hold_to_host("one flip", str(host), str(moved), 1) == 2
    with pytest.raises(AssertionError):
        hold_to_host("no ties", str(host), str(moved), 0)
    with pytest.raises(AssertionError):
        hold_to_host("too many", str(host), str(worse), 1)


def test_report_bench_needs_a_card(tmp_path, monkeypatch, capsys):
    from nimble_tpu_torch import report_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert report_bench.main([str(tmp_path / "work"), "--rows", "100"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
