"""The port's group-path align step and engine (nimble_tpu_torch/align/
engine.py) against the reference's jitted `align_step` and `AlignEngine`,
on identical tables (`tables_from_reference`) and identical reads. Exact on
every output key: everything is integer except one float32 compare, which
both sides make in float32."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config, Data
from tests.test_torch_host_parity import build_both
from nimble_tpu.io.packing import pack_codes_np
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align.tables import tables_from_reference

CPU = torch.device("cpu")
OUT_KEYS = ("bits", "score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev", "pass_")


def _library(n_features: int = 40, length: int = 600, seed: int = 11):
    """HLA-like: variants of one backbone plus two unrelated sequences, so
    reads hit multi-feature classes; 40 features -> W = 2 bitset words."""
    rng = np.random.default_rng(seed)
    backbone = rng.integers(0, 4, size=length).astype(np.int8)
    seqs = []
    for i in range(n_features):
        s = backbone.copy() if i < n_features - 2 else rng.integers(0, 4, size=length).astype(np.int8)
        pos = rng.integers(0, length, size=12)
        s[pos] = rng.integers(0, 4, size=12)
        seqs.append(s)
    data = Data()
    for i, s in enumerate(seqs):
        data.columns[0].append("lib")
        data.columns[1].append(f"f{i}")
        data.columns[2].append(str(length))
        data.columns[3].append(seqmod.decode(s))
    return seqs, data


@pytest.fixture(scope="module")
def lib():
    seqs, data = _library()
    index, port_index = build_both(data, Config())
    assert index.has_pairs and index.bitset_words == 2
    ref_tables = E._device_tables(index)
    assert "group_bucket" in ref_tables
    tables = tables_from_reference({k: np.asarray(v) for k, v in ref_tables.items()}, CPU)
    return seqs, index, port_index, ref_tables, tables


def _reads(seqs, B: int, L: int, seed: int):
    """Reads sampled from the library with 2% substitutions, some N bases,
    half reverse-complemented, lens from below k+g-1 up to L."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, dtype=np.int8)
    lens = rng.integers(10, L + 1, size=B).astype(np.int32)
    lens[: B // 2] = L
    lens[:4] = (20, 25, 26, 27)  # around k+g-1 = 26
    for i in range(B):
        src = seqs[rng.integers(0, len(seqs))]
        st = rng.integers(0, len(src) - L + 1)
        r = src[st : st + L].copy()
        err = rng.random(L) < 0.02
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        if rng.random() < 0.5:
            r = seqmod.revcomp_codes(r[None, :])[0]
        r[rng.random(L) < 0.01] = 4
        codes[i, : lens[i]] = r[: lens[i]]
    codes[-3:] = rng.integers(0, 4, size=(3, L))  # unrelated reads
    return codes, lens


def _params(index, port_index, config, strand):
    ref = dataclasses.replace(
        E.AlignParams.from_config(config, index, strand), group_g=index.pair_g, window_kernel=False
    )
    port = dataclasses.replace(T.AlignParams.from_config(config, port_index, strand), group_g=port_index.pair_g)
    return ref, port


CASES = [
    # strand, intersect_level, require_valid_pair, paired, score_percent
    ("unstranded", 0, False, False, 0.5),
    ("fiveprime", 0, False, False, 0.5),
    ("threeprime", 0, False, False, 0.8),
    ("unstranded", 0, False, True, 0.5),
    ("unstranded", 1, False, True, 0.5),
    ("unstranded", 2, False, True, 0.7),
    ("unstranded", 0, True, True, 0.5),
    ("fiveprime", 1, True, True, 0.5),
    ("threeprime", 2, False, True, 0.5),
]


@pytest.mark.parametrize("strand, level, rvp, paired, pct", CASES)
def test_align_step_matches_reference(lib, strand, level, rvp, paired, pct):
    seqs, index, port_index, ref_tables, tables = lib
    config = Config(intersect_level=level, require_valid_pair=rvp, score_percent=pct)
    p_ref, p_port = _params(index, port_index, config, strand)
    B, L = 48, 64
    c1, l1 = _reads(seqs, B, L, seed=1)
    args = [c1, l1]
    if paired:
        args += list(_reads(seqs, B, L, seed=2))
    want = jax.jit(lambda t, *a: E.align_step(t, p_ref, *a))(
        ref_tables, *[jnp.asarray(a) for a in args]
    )
    got = T.align_step(tables, p_port, *[torch.from_numpy(a) for a in args])
    for k in OUT_KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        assert np.array_equal(g, w.astype(g.dtype)), k
    # not vacuous: some reads pass, some fail, scores vary
    assert 0 < got["pass_"].sum() < B
    assert len(np.unique(got["score"].numpy())) > 3


def test_pack_outputs_round_trip(lib):
    seqs, index, port_index, ref_tables, tables = lib
    p_ref, p_port = _params(index, port_index, Config(), "unstranded")
    c1, l1 = _reads(seqs, 32, 64, seed=3)
    c2, l2 = _reads(seqs, 32, 64, seed=4)
    out = T.align_step(tables, p_port, *[torch.from_numpy(a) for a in (c1, l1, c2, l2)])
    flat = T.pack_outputs(out).numpy()
    ref_flat = np.asarray(E.pack_outputs({k: jnp.asarray(v.numpy()) for k, v in out.items()}))
    assert np.array_equal(flat, ref_flat)
    back = T.unpack_outputs(flat, port_index.bitset_words, 30)
    for k in OUT_KEYS:
        assert np.array_equal(back[k], out[k].numpy()[:30].astype(back[k].dtype)), k


def test_unpack_reads_round_trip():
    rng = np.random.default_rng(5)
    B, L = 17, 70
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.05] = 4
    lens = np.full(B, L, dtype=np.int32)
    words, nidx, nrows = pack_codes_np(codes, lens, L)
    dense = np.zeros((B, (L + 31) // 32), dtype=np.int32)
    dense[nidx] = nrows
    got = T.unpack_reads(torch.from_numpy(words), L, torch.from_numpy(dense)).numpy()
    assert np.array_equal(got, codes)
    ref = np.asarray(E.unpack_reads(jnp.asarray(words), L, jnp.asarray(dense)))
    assert np.array_equal(got, ref)
    no_n = T.unpack_reads(torch.from_numpy(words), L).numpy()
    assert np.array_equal(no_n, np.where(codes == 4, 0, codes))


@pytest.mark.parametrize("paired", [False, True])
def test_engine_matches_reference_engine(lib, paired):
    """AlignEngine end to end (chunking, padding, pack/unpack), through both
    the int8 and the packed-wire dispatch, against the reference engine."""
    seqs, index, port_index, _, _ = lib
    config = Config(intersect_level=1)
    n, L = 150, 64
    c1, l1 = _reads(seqs, n, L, seed=6)
    c2, l2 = _reads(seqs, n, L, seed=7) if paired else (None, None)
    ref = E.AlignEngine(index, config, chunk_size=64, max_len=L, paired=paired)
    port = T.AlignEngine(port_index, config, CPU, chunk_size=64, max_len=L, paired=paired)
    assert port.params.group_g == ref.params.group_g == index.pair_g
    want = ref.align_batch(c1, l1, c2, l2)
    got = port.align_batch(c1, l1, c2, l2)
    pb = {}
    for m, (c, ln) in (("r1", (c1, l1)), ("r2", (c2, l2))):
        if c is not None:
            w, i, r = pack_codes_np(c, ln, L)
            pb.update({f"{m}_words": w, f"{m}_lens": ln, f"{m}_nidx": i, f"{m}_nrows": r})
    packed = port.collect_async(port.align_packed_async(pb))
    for k in OUT_KEYS:
        assert got[k].shape[0] == n
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(packed[k], want[k]), k


@pytest.mark.parametrize("max_len, paired", [(64, False), (112, False), (112, True), (256, True)])
def test_auto_chunk_size_matches_reference_on_cpu(lib, max_len, paired):
    _, index, port_index, _, _ = lib
    assert T.auto_chunk_size(port_index, max_len, paired, CPU) == E.auto_chunk_size(index, max_len, paired)


def test_auto_chunk_size_uncapped_on_cuda(lib):
    _, _, index, _, _ = lib
    cuda = T.auto_chunk_size(index, 112, False, torch.device("cuda"))
    assert cuda > T.auto_chunk_size(index, 112, False, CPU) == T.CPU_CHUNK_MAX
    assert cuda == 1 << 17 == T.AUTO_CHUNK_MAX


def test_engine_refuses_unported_paths(lib):
    """A library wider than 512 features (W = 19 > 16) takes the reference's
    groupcls path with its tables; a step on tables of no path (the group
    tables without the group probe's g) raises."""
    _, _, index, _, tables = lib
    _, wide = _library(n_features=600, length=60)
    ref_wide, wide_index = build_both(wide, Config())
    assert wide_index.bitset_words == 19
    eng = T.AlignEngine(wide_index, Config(), CPU)
    assert eng.params.group_g == wide_index.pair_g and eng.wire == "full"
    want = tables_from_reference({k: np.asarray(v) for k, v in E._device_tables(ref_wide).items()}, CPU)
    assert set(eng.tables) == set(want) and "groupcls_bucket" in want
    assert all(torch.equal(eng.tables[k], want[k]) for k in want)
    p = T.AlignParams.from_config(Config(), index)  # group_g = 0: not the group path
    with pytest.raises(ValueError, match="tables of no align path"):
        T.align_step(tables, p, torch.zeros((2, 40), dtype=torch.int8), torch.full((2,), 40, dtype=torch.int32))


@pytest.mark.parametrize(
    "make, kw",
    [
        (lambda index: (index, Config(kmer_stride=2)), {}),
        (lambda index: (build_both(_library()[1], Config(), group_g=0)[1], Config()), {}),
        (lambda index: (index, Config()), {"max_len": 24}),
        (lambda index: (index, Config()), {"group_probe": False}),
        (lambda index: (build_both(_library(n_features=300, length=200)[1], Config())[1], Config()), {}),
    ],
    ids=["stride2", "no-group-entries", "max-len-24", "group-probe-off", "w10"],
)
def test_engine_takes_the_mono_path_where_the_group_path_cannot(lib, make, kw):
    """Where the reference's group_ok is false (engine.py:2740-2750), the
    engine ships the mono table and runs with group_g = 0."""
    _, _, index, _, _ = lib
    idx, config = make(index)
    eng = T.AlignEngine(idx, config, CPU, **kw)
    assert set(eng.tables) == {"mono_bucket", "mono_stash"}
    assert eng.params.group_g == 0


@pytest.mark.parametrize(
    "emit",
    [
        dict(group_on=False, discard_multiple_matches=False, discard_multi_hits=0, max_hits_to_report=10),
        dict(group_on=False, discard_multiple_matches=True, discard_multi_hits=0, max_hits_to_report=10),
        dict(group_on=False, discard_multiple_matches=False, discard_multi_hits=3, max_hits_to_report=2),
    ],
    ids=["default", "discard-multiple", "multi-hits"],
)
def test_resolve_features_matches_reference(lib, emit):
    """The copied host emission helpers give the reference's per-read
    feature strings and keep masks on the port's align output."""
    from nimble_tpu.align import pipeline as RP
    from nimble_tpu_torch.align import pipeline as TP

    seqs, index, port_index, _, tables = lib
    _, p_port = _params(index, port_index, Config(), "unstranded")
    c1, l1 = _reads(seqs, 64, 64, seed=8)
    bits = T.align_step(tables, p_port, torch.from_numpy(c1), torch.from_numpy(l1))["bits"].numpy()
    want = RP.resolve_features(index, bits, RP.EmitConfig(**emit))
    got = TP.resolve_features(port_index, bits, TP.EmitConfig(**emit))
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert 0 < got[1].sum() < len(got[1])
