"""The port's mono path (nimble_tpu_torch/align/{tables,kernels,engine}.py)
against the reference, exactly: the mono and two-choice inline tables
element for element, the mono probe against the reference's `mono_probe`
and `mono_select_pallas` (interpret mode), and `align_step` / `AlignEngine`
on every output key, on the mono path and on the two-choice fallback.
Everything compared is integer except one float32 compare, which both sides
make in float32."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.align.kernels import mono_select_pallas
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index
from nimble_tpu.index.hashing import bucket_hashes_jnp
from nimble_tpu.io.packing import pack_codes_np
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import kernels as K
from nimble_tpu_torch.align.tables import (
    INLINE_KEYS,
    MONO_KEYS,
    build_inline_tables,
    build_mono_tables,
    device_tables,
    table_words,
    tables_from_reference,
)

CPU = torch.device("cpu")
OUT_KEYS = ("bits", "score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev", "pass_")


PALINDROMES = ("ACGTACGTACGTACGT", "AATTCCGGCCGGAATT", "GGATCCATGGATCC")


def _library(n_features: int, length: int, seed: int, palindromes: bool = False):
    """HLA-like: variants of one backbone plus two unrelated sequences, so
    reads hit multi-feature classes. With palindromes, the backbone carries
    reverse-complement palindromes, which even k turns into palindromic
    windows."""
    rng = np.random.default_rng(seed)
    backbone = rng.integers(0, 4, size=length).astype(np.int8)
    if palindromes:
        for i, pal in enumerate(PALINDROMES * 3):
            st = 20 + i * (length - 40) // 9
            backbone[st : st + len(pal)] = seqmod.encode(pal)
    seqs = []
    data = Data()
    for i in range(n_features):
        s = backbone.copy() if i < n_features - 2 else rng.integers(0, 4, size=length).astype(np.int8)
        pos = rng.integers(0, length, size=12)
        s[pos] = rng.integers(0, 4, size=12)
        seqs.append(s)
        data.columns[0].append("lib")
        data.columns[1].append(f"f{i}")
        data.columns[2].append(str(length))
        data.columns[3].append(seqmod.decode(s))
    return seqs, data


def _reads(seqs, B: int, L: int, seed: int):
    """Reads sampled from the library with 2% substitutions, some N bases,
    half reverse-complemented, lens from below k (21) up to L."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, dtype=np.int8)
    lens = rng.integers(10, L + 1, size=B).astype(np.int32)
    lens[: B // 2] = L
    lens[:5] = np.minimum((15, 20, 21, 22, 25), L)  # around k, below k+g-1 = 26
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


# name -> (n_features, length, seed, num_mismatches, k): W = 2, W = 10, a
# Hamming-1 library (no group entries; the index holds every neighbour),
# and k = 16 over a backbone with palindromes
LIBS = {
    "w2": (40, 600, 11, 0, 21),
    "w10": (300, 200, 12, 0, 21),
    "mismatch1": (6, 100, 13, 1, 21),
    "pal16": (20, 300, 17, 0, 16),
}
LIBS_W = {"w2": 2, "w10": 10, "mismatch1": 1, "pal16": 1}


@pytest.fixture(scope="module")
def libs():
    out = {}
    for name, (n, length, seed, nm, k) in LIBS.items():
        seqs, data = _library(n, length, seed, palindromes=name == "pal16")
        config = Config(num_mismatches=nm, kmer_length=k)
        index = build_index(data, config, group_g=0 if nm == 0 else None)
        ref = {k: np.asarray(v) for k, v in E._device_tables(index, group_ok=False).items()}
        out[name] = (seqs, config, index, ref)
    return out


@pytest.mark.parametrize("name", sorted(LIBS))
def test_mono_and_inline_tables_equal_reference(libs, name):
    _, _, index, ref = libs[name]
    assert not index.has_pairs and set(MONO_KEYS) <= set(ref)
    mono = build_mono_tables(index)
    inline = build_inline_tables(index)
    for k in MONO_KEYS:
        assert mono[k].dtype == np.int32 and np.array_equal(mono[k], ref[k]), k
    for k in INLINE_KEYS:
        assert inline[k].dtype == np.int32 and np.array_equal(inline[k], ref[k]), k
    # a non-empty stash, so its comparison is not vacuous
    assert (mono["mono_stash_hi"] != -1).sum() > 0
    dev = device_tables(index, CPU)
    assert set(dev) == {"mono_bucket", "mono_stash"}
    assert np.array_equal(dev["mono_bucket"].numpy(), ref["mono_bucket"])
    stash = np.concatenate([ref["mono_stash_hi"][:, None], ref["mono_stash_lo"][:, None],
                            ref["mono_stash_vs_bits"], ref["mono_stash_vd_bits"]], axis=1)
    assert np.array_equal(dev["mono_stash"].numpy(), stash)
    assert table_words(dev) == index.bitset_words == LIBS_W[name]


def test_inline_tables_when_mono_placement_fails(libs, monkeypatch):
    """With mono placement infeasible, device_tables ships the two-choice
    inline bucket, as the reference's _device_tables keeps it."""
    from nimble_tpu_torch.align import tables as TT

    _, _, index, ref = libs["w2"]
    monkeypatch.setattr(TT, "build_mono_tables", lambda index: None)
    dev = TT.device_tables(index, CPU)
    assert set(dev) == set(INLINE_KEYS)
    for k in INLINE_KEYS:
        assert np.array_equal(dev[k].numpy(), ref[k]), k
    assert table_words(dev) == 2


def _into_inline_stash(ref, hit):
    """The reference two-choice tables with bucket entries whose keys are
    among `hit` (int64 keys the reads probe) moved into the index stash's
    empty rows: the same key set, so the probe must not change, and its
    stash sweep answers real windows."""
    t = {k: np.array(v) for k, v in ref.items() if k not in MONO_KEYS}
    S = 4
    W = t["stash_vs_bits"].shape[1]
    bucket = t["bucket"]
    free = np.flatnonzero(~(t["stash_vs_bits"] | t["stash_vd_bits"]).any(axis=1))
    occupied = (bucket[:, 2 * S : 4 * S] >= 0).reshape(-1, 2, S).any(axis=1)
    rows, slots = np.nonzero(occupied)
    probed = np.flatnonzero(np.isin(_key64(bucket[rows, slots], bucket[rows, S + slots]), hit))
    for r, i in zip(free, probed):
        b, s = rows[i], slots[i]
        t["stash_hi"][r], t["stash_lo"][r] = bucket[b, s], bucket[b, S + s]
        t["stash_vs_bits"][r] = bucket[b, 4 * S + s * W : 4 * S + (s + 1) * W]
        t["stash_vd_bits"][r] = bucket[b, 4 * S + S * W + s * W : 4 * S + S * W + (s + 1) * W]
        bucket[b, [s, S + s]] = 0
        bucket[b, [2 * S + s, 3 * S + s]] = -1
        bucket[b, 4 * S + s * W : 4 * S + (s + 1) * W] = 0
        bucket[b, 4 * S + S * W + s * W : 4 * S + S * W + (s + 1) * W] = 0
    return t, min(len(free), len(probed))


@pytest.mark.parametrize("name", ["w2", "pal16"])
def test_inline_probe_with_a_stash_matches_reference(libs, name):
    """lookup_inline_bits == the reference's, with hit keys in the index
    stash (real indexes rarely overflow into it)."""
    seqs, _, index, ref = libs[name]
    W, k = index.bitset_words, index.k
    codes, lens = _reads(seqs, 37, 60, seed=5)
    hi, lo, valid = E.kmer_hi_lo(jnp.asarray(codes), jnp.asarray(lens), k)
    c_hi, c_lo, _, _ = E._canonical_keys(hi, lo, k)
    hit = _key64(E._bitcast_i32(c_hi), E._bitcast_i32(c_lo))[np.asarray(valid)]
    t, moved = _into_inline_stash(ref, hit)
    assert moved >= 4
    want_f, want_r = E.lookup_inline_bits(hi, lo, valid, {key: jnp.asarray(v) for key, v in t.items()},
                                          index.n_buckets, k, W)
    tables = tables_from_reference(t, CPU)
    planes = K.kmer_keys(torch.from_numpy(codes), torch.from_numpy(lens), k, index.n_buckets)
    got_f, got_r = T.lookup_inline_bits(*planes, tables, W)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert (got_f.numpy() != 0).any()


def _keys(codes, lens, k, nb):
    hi, lo, valid = E.kmer_hi_lo(jnp.asarray(codes), jnp.asarray(lens), k)
    c_hi, c_lo, fc, pal = E._canonical_keys(hi, lo, k)
    h1, _ = bucket_hashes_jnp(c_hi, c_lo, nb)
    return E._bitcast_i32(c_hi), E._bitcast_i32(c_lo), h1, fc, pal, valid


def _key64(hi, lo):
    return np.asarray(hi).astype(np.int64) << 32 | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)


def _moved_to_stash(ref, n_move: int, hit):
    """The reference mono tables with n_move occupied bucket slots, whose
    keys are among `hit` (int64 keys the reads probe), moved into extra
    stash rows: the same key set, so both probes must give the same bits,
    and the stash sweep answers windows the reads really have."""
    t = {k: np.array(v) for k, v in ref.items()}
    W = t["mono_stash_vs_bits"].shape[1]
    bucket = t["mono_bucket"]
    S = bucket.shape[1] // (2 + 2 * W)
    rows, slots = np.nonzero(bucket[:, :S] != -1)
    probed = np.flatnonzero(np.isin(_key64(bucket[rows, slots], bucket[rows, S + slots]), hit))
    pick = np.random.default_rng(0).choice(probed, size=n_move, replace=False)
    extra = {"hi": [], "lo": [], "vs": [], "vd": []}
    for i in pick:
        b, s = rows[i], slots[i]
        extra["hi"].append(bucket[b, s])
        extra["lo"].append(bucket[b, S + s])
        extra["vs"].append(bucket[b, 2 * S + np.arange(W) * S + s])
        extra["vd"].append(bucket[b, 2 * S + W * S + np.arange(W) * S + s])
        bucket[b, s] = -1
        bucket[b, S + s] = 0
        bucket[b, 2 * S + np.arange(2 * W) * S + s] = 0
    t["mono_stash_hi"] = np.concatenate([t["mono_stash_hi"], extra["hi"]]).astype(np.int32)
    t["mono_stash_lo"] = np.concatenate([t["mono_stash_lo"], extra["lo"]]).astype(np.int32)
    t["mono_stash_vs_bits"] = np.concatenate([t["mono_stash_vs_bits"], extra["vs"]]).astype(np.int32)
    t["mono_stash_vd_bits"] = np.concatenate([t["mono_stash_vd_bits"], extra["vd"]]).astype(np.int32)
    return t


@pytest.mark.parametrize("name, n_move", [("w2", 0), ("w2", 40), ("w10", 20), ("mismatch1", 0), ("pal16", 10)])
def test_mono_probe_matches_reference_and_pallas(libs, name, n_move):
    """The port's mono_probe on CPU (its plain version) == the reference's
    mono_probe (XLA branch) == mono_select_pallas in interpret mode on the
    gathered, transposed rows, at B not a multiple of 8."""
    seqs, _, index, ref = libs[name]
    W = index.bitset_words
    k = index.k
    B, L = 37, 60
    codes, lens = _reads(seqs, B, L, seed=3)
    nb2 = ref["mono_bucket"].shape[0]
    hi_i, lo_i, h1, fc, pal, valid = _keys(codes, lens, k, nb2)
    if n_move:
        ref = _moved_to_stash(ref, n_move, _key64(hi_i, lo_i)[np.asarray(valid)])
    rt = {key: jnp.asarray(v) for key, v in ref.items()}
    want_f, want_r = E.mono_probe(hi_i, lo_i, h1, fc, pal, valid, rt, W)

    tables = tables_from_reference(ref, CPU)
    assert tables["mono_stash"].shape[0] == ref["mono_stash_hi"].shape[0]
    as_t = lambda a: torch.from_numpy(np.array(a))
    got_f, got_r = K.mono_probe(tables["mono_bucket"], as_t(h1).to(torch.int32), as_t(hi_i),
                                as_t(lo_i), as_t(fc), as_t(pal), as_t(valid),
                                tables["mono_stash"], W)
    assert got_f.dtype == torch.int32 and got_f.shape == (B, L - k + 1, W)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))

    S = ref["mono_bucket"].shape[1] // (2 + 2 * W)
    rowT = jnp.transpose(rt["mono_bucket"][h1.astype(jnp.int32)], (2, 0, 1))
    pf, pr = mono_select_pallas(rowT, hi_i, lo_i, fc, pal, valid, jnp.asarray(tables["mono_stash"].numpy()),
                                S, W, interpret=True, block_b=16)
    assert np.array_equal(np.asarray(pf).transpose(1, 2, 0), got_f.numpy())
    assert np.array_equal(np.asarray(pr).transpose(1, 2, 0), got_r.numpy())
    # not vacuous: windows hit in both orientations, and some hit the stash
    hits = (got_f.numpy() != 0).any(axis=-1)
    assert 0 < hits.sum() < hits.size and (got_r.numpy() != 0).any()
    if name == "pal16":  # palindromic windows hit, so their select is tested
        assert (np.asarray(pal) & np.asarray(valid) & hits).any()
    if n_move:
        st = tables["mono_stash"].numpy()
        assert st.shape[0] <= K.MONO_MAX_STASH
        assert (np.isin(_key64(hi_i, lo_i), _key64(st[:, 0], st[:, 1])) & np.asarray(valid)).any()


def _params(index, config, strand, group_g=0):
    ref = dataclasses.replace(E.AlignParams.from_config(config, index, strand),
                              group_g=group_g, window_kernel=False)
    port = dataclasses.replace(T.AlignParams.from_config(config, index, strand), group_g=group_g)
    return ref, port


def _ref_tables(ref, path):
    """The reference tables as the given path reads them: with the mono keys
    (mono path) or without them (the two-choice fallback)."""
    if path == "mono":
        return ref
    return {k: v for k, v in ref.items() if k not in MONO_KEYS}


CASES = [
    # lib, strand, intersect_level, require_valid_pair, paired, score_percent, stride
    ("w2", "unstranded", 0, False, False, 0.5, 1),
    ("w2", "fiveprime", 0, False, False, 0.5, 2),
    ("w2", "threeprime", 0, False, False, 0.8, 3),
    ("w2", "unstranded", 1, False, True, 0.5, 1),
    ("w2", "unstranded", 2, False, True, 0.7, 2),
    ("w2", "unstranded", 0, True, True, 0.5, 3),
    ("w10", "unstranded", 0, False, True, 0.5, 1),
    ("w10", "threeprime", 1, True, True, 0.5, 2),
    ("mismatch1", "unstranded", 0, False, True, 0.5, 1),
    ("mismatch1", "fiveprime", 2, False, False, 0.5, 3),
    ("pal16", "unstranded", 0, False, True, 0.5, 1),
    ("pal16", "threeprime", 1, False, False, 0.5, 2),
]


@pytest.mark.parametrize("path", ["mono", "inline"])
@pytest.mark.parametrize("lib_name, strand, level, rvp, paired, pct, stride", CASES)
def test_align_step_matches_reference(libs, path, lib_name, strand, level, rvp, paired, pct, stride):
    seqs, base_config, index, ref = libs[lib_name]
    config = dataclasses.replace(base_config, intersect_level=level, require_valid_pair=rvp,
                                 score_percent=pct, kmer_stride=stride)
    p_ref, p_port = _params(index, config, strand)
    rt = _ref_tables(ref, path)
    tables = tables_from_reference(rt, CPU)
    assert ("mono_bucket" in tables) == (path == "mono")
    B, L = 40, 64
    c1, l1 = _reads(seqs, B, L, seed=1)
    args = [c1, l1]
    if paired:
        args += list(_reads(seqs, B, L, seed=2))
    want = jax.jit(lambda t, *a: E.align_step(t, p_ref, *a))(
        {k: jnp.asarray(v) for k, v in rt.items()}, *[jnp.asarray(a) for a in args]
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


def _packed(c1, l1, c2, l2, L):
    pb = {}
    for m, (c, ln) in (("r1", (c1, l1)), ("r2", (c2, l2))):
        if c is not None:
            w, i, r = pack_codes_np(c, ln, L)
            pb.update({f"{m}_words": w, f"{m}_lens": ln, f"{m}_nidx": i, f"{m}_nrows": r})
    return pb


@pytest.mark.parametrize(
    "lib_name, config_kw, engine_kw, L",
    [
        ("w2", {}, {}, 64),  # mono index: no group entries
        ("w2", {"kmer_stride": 2}, {"paired": True}, 64),
        ("w10", {}, {"paired": True}, 64),  # 8 < W <= 16
        ("mismatch1", {}, {}, 64),
        ("group", {}, {"group_probe": False}, 64),  # group index, group probe off
        ("group", {}, {"paired": True}, 24),  # reads shorter than k+g-1
    ],
    ids=["mono-index", "stride2", "w10", "mismatch1", "group-probe-off", "max-len-24"],
)
def test_engine_matches_reference_engine(libs, lib_name, config_kw, engine_kw, L):
    """AlignEngine end to end on the mono path (chunking, padding,
    pack/unpack, int8 and packed-wire dispatch) against the reference
    engine, for every way the reference reaches it."""
    if lib_name == "group":
        seqs, data = _library(*LIBS["w2"][:3])
        index = build_index(data, Config())
        assert index.has_pairs
        base = Config()
    else:
        seqs, base, index, _ = libs[lib_name]
    config = dataclasses.replace(base, intersect_level=1, **config_kw)
    paired = engine_kw.get("paired", False)
    kw = dict(chunk_size=64, max_len=L, paired=paired, group_probe=engine_kw.get("group_probe"))
    ref = E.AlignEngine(index, config, **kw)
    port = T.AlignEngine(index, config, CPU, **kw)
    assert port.params.group_g == ref.params.group_g == 0
    assert "mono_bucket" in port.tables and "mono_bucket" in ref.tables
    n = 150
    c1, l1 = _reads(seqs, n, L, seed=6)
    c2, l2 = _reads(seqs, n, L, seed=7) if paired else (None, None)
    want = ref.align_batch(c1, l1, c2, l2)
    got = port.align_batch(c1, l1, c2, l2)
    packed = port.collect_async(port.align_packed_async(_packed(c1, l1, c2, l2, L)))
    for k in OUT_KEYS:
        assert got[k].shape[0] == n
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(packed[k], want[k]), k
    assert 0 < got["pass_"].sum() < n


@pytest.mark.parametrize("max_len, paired", [(64, False), (112, False), (112, True), (256, True)])
@pytest.mark.parametrize("lib_name", ["w2", "w10"])
def test_auto_chunk_size_inline_branch_matches_reference(libs, lib_name, max_len, paired):
    _, _, index, _ = libs[lib_name]
    want = E.auto_chunk_size(index, max_len, paired, group_ok=False)
    assert T.auto_chunk_size(index, max_len, paired, CPU, group_ok=False) == want
    # an index without group entries takes the inline branch by itself
    assert T.auto_chunk_size(index, max_len, paired, CPU) == want
