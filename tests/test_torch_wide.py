"""The port's other wide paths (W > 16 bitset words) against the reference,
exactly: groupcls (the class-id group probe and the runs-compacted class-bits
intersection), monocls (the single-hash class-id probe, with class_bits or
with the class bands and band_tree_expand) and the wide two-choice probe
(lookup_classes), which the reference takes when its gband, groupcls or
monocls tables cannot be built or placed. Tables element for element, the
path chosen at every link of the fallback chain under NIMBLE_TPU_MONO_MAX_BYTES,
both intersections on adversarial ids, `align_step` on every output key,
`AlignEngine` and `auto_chunk_size`. Models: tests/test_wide_paths.py.
Everything compared is integer except one float32 compare, which both sides
make in float32."""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nimble_tpu.align import engine as E
from nimble_tpu.config import Config
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import tables as TT
from tests.test_torch_gband import _outlier_index, _same_tables, family_seqs, groupcls_seqs, make_data, read_batch
from tests.test_torch_host_parity import build_both

CPU = torch.device("cpu")
OUT_KEYS = ("bits", "score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev", "pass_")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_LEN = 21


def w19_seqs():
    """600 random 60 bp features: W = 19, the W <= 32 branch of
    intersect_class_bits; classes are single features, so no banding."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, 4, size=60).astype(np.int8) for _ in range(600)]


@pytest.fixture(scope="module")
def libs():
    """name -> (reference index, port index, sequences, read length)."""
    out = {}
    for name, seqs, kw, L in (("wide", groupcls_seqs(), {}, 100),
                              ("family_mono", family_seqs(), {"group_g": 0}, 100),
                              ("w19", w19_seqs(), {}, 60)):
        ref, port = build_both(make_data(seqs), Config(), k=K_LEN, **kw)
        out[name] = (ref, port, seqs, L)
    assert out["wide"][0].bitset_words == 35 and out["family_mono"][0].bitset_words == 75
    assert out["w19"][0].bitset_words == 19
    return out


def _fresh(index):
    """A copy of an index without the tables either package caches on it."""
    index = copy.copy(index)
    for attr in ("_band_cache", "_band_cache_robust", "_gband_cache", "_torch_gband", "_torch_class_bands"):
        index.__dict__.pop(attr, None)
    return index


def _set_cap(monkeypatch, cap: int):
    monkeypatch.setattr(E, "MONO_MAX_BYTES", cap)
    monkeypatch.setattr(TT, "MONO_MAX_BYTES", cap)


# a cap under which no single-hash table of these libraries places
SMALL_CAP = 1 << 16

# id -> (library, group_ok, cap, the key only that path ships)
PATHS = {
    "groupcls": ("wide", True, None, "groupcls_bucket"),
    "monocls": ("wide", False, None, "mcls_bucket"),
    "monocls-banded": ("family_mono", True, None, "mcls_bucket"),
    "two-choice": ("wide", False, SMALL_CAP, "stash_vsame"),
    "two-choice-banded": ("family_mono", True, SMALL_CAP, "stash_vsame"),
    "groupcls-w19": ("w19", True, None, "groupcls_bucket"),
    "monocls-w19": ("w19", False, None, "mcls_bucket"),
}


def _path(libs, monkeypatch, name):
    """(ref index, port index, seqs, L, group_ok, the reference's numpy
    tables, the port's device tables) of one wide path."""
    lib, group_ok, cap, key = PATHS[name]
    ref, port, seqs, L = libs[lib]
    if cap is not None:
        _set_cap(monkeypatch, cap)
    ref_np = {k: np.asarray(v) for k, v in E._device_tables(ref, group_ok=group_ok).items()}
    tables = TT.device_tables(port, CPU, group_ok=group_ok)
    assert key in ref_np and key in tables
    assert ("class_bandrow" in ref_np) == ("class_band" in tables) == name.endswith("banded")
    return ref, port, seqs, L, group_ok, ref_np, tables


@pytest.mark.parametrize("name", list(PATHS))
def test_wide_tables_equal_reference(libs, monkeypatch, name):
    """The port's builders (groupcls's on the CPU device) equal the
    reference's element for element, and the port ships exactly the arrays
    its step reads, equal to the reference's: class_bits without bands, the
    re-laid band rows and W with them, never the two-choice bucket beside a
    single-hash table."""
    ref, port, _, _, group_ok, ref_np, tables = _path(libs, monkeypatch, name)
    _same_tables(tables, ref_np)
    W = ref.bitset_words
    assert TT.table_words(tables) == W
    if "groupcls_bucket" in tables:
        entries = {k: torch.from_numpy(v) for k, v in TT.groupcls_entries(port).items()}
        got = {k: v.numpy() for k, v in TT.build_groupcls_tables(entries)[0].items()}
        want, keys = E._build_groupcls_tables(ref), TT.GROUPCLS_KEYS
    elif "mcls_bucket" in tables:
        got, want = TT.build_monocls_tables(port), E._build_monocls_tables(ref)
        keys = TT.MCLS_KEYS
    else:
        got, want = TT.build_classes_tables(port), ref_np
        keys = TT.CLASSES_KEYS
        assert TT.build_monocls_tables(port) is None and ref_np["bucket"].shape[1] == 16
    assert set(keys) | {"class_bits", "class_page", "class_band", "class_words"} >= set(tables)
    for k in keys:
        assert got[k].dtype == np.int32 and np.array_equal(got[k], np.asarray(want[k])), k
    bands, ref_bands = TT.build_class_bands(port), E._build_class_bands(ref)
    assert (bands is None) == (ref_bands is None)
    if bands is not None:
        assert bands[0] == ref_bands[0] and np.array_equal(bands[1], ref_bands[1])
        assert torch.equal(tables["class_page"], torch.from_numpy(ref_bands[1][:, 0]))
        assert torch.equal(tables["class_band"], torch.from_numpy(ref_bands[1][:, 1:]))
    else:
        assert np.array_equal(tables["class_bits"].numpy(), ref.class_bits.view(np.int32))
    if name in ("groupcls", "monocls"):  # a non-empty stash, so its comparison is not vacuous
        stash = got["groupcls_stash_hi" if name == "groupcls" else "mcls_stash_hi"]
        assert (stash != -1).sum() > 0


def test_mono_max_bytes_reads_the_environment():
    """NIMBLE_TPU_MONO_MAX_BYTES sets the placement cap of both packages at
    import; unset, both take 6 GB."""
    code = ("import nimble_tpu.align.engine as E, nimble_tpu_torch.align.tables as T; "
            "print(E.MONO_MAX_BYTES, T.MONO_MAX_BYTES)")
    env = {k: v for k, v in os.environ.items() if k != "NIMBLE_TPU_MONO_MAX_BYTES"}
    for value, want in ((None, 6 << 30), ("123456", 123456)):
        if value is not None:
            env["NIMBLE_TPU_MONO_MAX_BYTES"] = value
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**env, "JAX_PLATFORMS": "cpu"},
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout.split() == [str(want)] * 2


def test_the_fallback_chain_under_the_placement_cap(monkeypatch):
    """On one wide library with group entries, both packages walk the same
    chain and ship equal tables at every link: gband; groupcls once robust
    banding fails (BAND_OUTLIER_CAP = 0 on a library with two outlier
    classes: the cap alone cannot part them, as gband's 4-word entries
    place wherever groupcls's 2g + 3 do); monocls once the cap is under
    groupcls's smallest table; the two-choice bucket once it is under
    monocls's too."""
    ref, port = _outlier_index()
    S = TT.MONO_SLOTS
    n_pairs = port.pair_hi.shape[0]
    n_keys = int(((port.table_vsame >= 0) | (port.table_vdiff >= 0)).sum()
                 + ((port.stash_vsame >= 0) | (port.stash_vdiff >= 0)).sum())
    smallest = lambda n, words: (1 << (int(np.ceil(np.log2(n))) + 1)) * S * words * 4
    chain = [
        (None, None, "gband_bucket"),
        (0, None, "groupcls_bucket"),
        (0, smallest(n_pairs, 2 + 2 * port.pair_g + 1) - 1, "mcls_bucket"),
        (0, smallest(n_keys, 4) - 1, "stash_vsame"),
    ]
    for outlier_cap, cap, key in chain:
        if outlier_cap is not None:
            monkeypatch.setattr(E, "BAND_OUTLIER_CAP", outlier_cap)
            monkeypatch.setattr(TT, "BAND_OUTLIER_CAP", outlier_cap)
        if cap is not None:
            _set_cap(monkeypatch, cap)
        r, p = _fresh(ref), _fresh(port)
        ref_np = {k: np.asarray(v) for k, v in E._device_tables(r).items()}
        got = TT.device_tables(p, CPU)
        assert key in ref_np and key in got, (key, sorted(ref_np), sorted(got))
        _same_tables(got, ref_np)
        eng = T.AlignEngine(_fresh(port), Config(), CPU)
        want_g = port.pair_g if key in ("gband_bucket", "groupcls_bucket") else 0
        assert key in eng.tables and eng.params.group_g == want_g


# --- the intersections ----------------------------------------------------


def _run_ids(B: int, P: int, C: int, seed: int):
    """Per read runs of 1-6 equal class ids (about P / 3.5 runs, several
    times RUN_BLOCK), 10% of positions unmatched (half of them with an id
    that the mask must hide), and three all-miss reads."""
    rng = np.random.default_rng(seed)
    ids = np.empty((B, P), dtype=np.int32)
    for b in range(B):
        j = 0
        while j < P:
            n = int(rng.integers(1, 7))
            ids[b, j : j + n] = rng.integers(0, C)
            j += n
    matched = rng.random((B, P)) >= 0.1
    ids[~matched & (rng.random((B, P)) < 0.5)] = -1
    matched[:3] = False
    return ids, matched


@pytest.mark.parametrize("W", [19, 40, 157])
def test_intersect_class_bits_matches_reference(W):
    """More runs than RUN_BLOCK in every read, all-miss reads, unmatched
    positions with and without an id: the static-bound block loop equals
    the reference's while_loop."""
    rng = np.random.default_rng(W)
    C, B, P = 50, 64, 120
    # dense bitsets (15/16 of the bits set), so that many-run ANDs keep bits
    cb = np.bitwise_or.reduce(rng.integers(-(1 << 31), 1 << 31, size=(4, C, W), dtype=np.int64),
                              axis=0).astype(np.int32)
    ids, matched = _run_ids(B, P, C, seed=W)
    newrun = matched & (np.where(matched, ids, -1) != np.concatenate(
        [np.full((B, 1), -2), np.where(matched, ids, -1)[:, :-1]], axis=1))
    assert newrun.sum(axis=1).max() > 3 * T.RUN_BLOCK == 3 * E.RUN_BLOCK
    want = np.asarray(E.intersect_class_bits(jnp.asarray(ids), jnp.asarray(matched), jnp.asarray(cb)))
    got = T.intersect_class_bits(torch.from_numpy(ids), torch.from_numpy(matched), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert not want[:3].any() and want[3:].any(axis=1).mean() > 0.5


def test_intersect_class_bands_matches_reference(libs):
    """The banded intersection (one band_tree_expand over every matched
    position) equals the reference's runs-and-blocks fold on the class
    ids that real reads give, with runs broken by random ids (every fourth
    read) and misses."""
    ref, port, seqs, L = libs["family_mono"]
    Pw, bandrow = E._build_class_bands(ref)
    codes, lens, _ = read_batch(seqs, 64, L, seed=31)
    tables = TT.device_tables(port, CPU)
    p = T.AlignParams.from_config(Config(), port)
    hi, lo, h1, _h2, fc, pal, valid = T._window_keys(
        torch.from_numpy(codes), torch.from_numpy(lens), tables["mcls_bucket"].shape[0], p)
    ids = T.lookup_monocls(hi, lo, h1, fc, pal, valid, tables)[0].numpy()
    rng = np.random.default_rng(5)
    noise = (rng.random(ids.shape) < 0.03) & (np.arange(ids.shape[0]) % 4 == 0)[:, None]
    ids = np.where(noise, rng.integers(0, bandrow.shape[0], size=ids.shape), ids).astype(np.int32)
    matched = ids >= 0
    W = ref.bitset_words
    want = np.asarray(E.intersect_class_bands(jnp.asarray(ids), jnp.asarray(matched), jnp.asarray(bandrow), W))
    got = T.intersect_class_bands(torch.from_numpy(ids), torch.from_numpy(matched), tables["class_page"],
                                  tables["class_band"], W)
    assert np.array_equal(got.numpy(), want)
    assert want.any(axis=1).mean() > 0.2 and not want.all()


# --- the align step and the engine ---------------------------------------

CASES = [
    # strand, intersect_level, require_valid_pair, paired
    ("unstranded", 0, False, False),
    ("fiveprime", 1, True, True),
    ("threeprime", 2, False, True),
    ("unstranded", 0, False, True),
]


@pytest.mark.parametrize("strand, level, rvp, paired", CASES)
@pytest.mark.parametrize("name", list(PATHS))
def test_align_step_matches_reference(libs, monkeypatch, name, strand, level, rvp, paired):
    """Every output key, single-end and paired (half the mates from the
    same allele), the three strand filters, every intersect_level and
    require_valid_pair; N bases, reverse-complemented reads and reads
    shorter than k+g-1 among them."""
    ref, port, seqs, L, group_ok, ref_np, tables = _path(libs, monkeypatch, name)
    g = ref.pair_g if "groupcls_bucket" in tables else 0
    config = Config(intersect_level=level, require_valid_pair=rvp, score_percent=0.5)
    p_ref = dataclasses.replace(E.AlignParams.from_config(config, ref, strand), group_g=g, window_kernel=False)
    p_port = dataclasses.replace(T.AlignParams.from_config(config, port, strand), group_g=g)
    B = 48
    c1, l1, src = read_batch(seqs, B, L, seed=1)
    args = [c1, l1]
    if paired:
        src2 = np.where(np.arange(B) % 2 == 0, src, np.random.default_rng(9).integers(0, len(seqs), B))
        args += list(read_batch(seqs, B, L, seed=2, src=src2)[:2])
    want = E.align_step({k: jnp.asarray(v) for k, v in ref_np.items()}, p_ref, *[jnp.asarray(a) for a in args])
    got = T.align_step(tables, p_port, *[torch.from_numpy(a) for a in args])
    for k in OUT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and np.array_equal(got[k].numpy(), w.astype(got[k].numpy().dtype)), k
    assert got["pass_"].any() and len(np.unique(got["score"].numpy())) > 3


@pytest.mark.parametrize("name", ["groupcls", "monocls", "monocls-banded", "two-choice"])
def test_engine_matches_reference_engine(libs, monkeypatch, name):
    """AlignEngine on each wide path: the reference's path and group_g, the
    full wire, and the reference engine's outputs over several chunks."""
    lib, group_ok, cap, key = PATHS[name]
    ref, port, seqs, L = libs[lib]
    if cap is not None:
        _set_cap(monkeypatch, cap)
    cfg = Config(score_percent=0.5)
    c1, l1, _ = read_batch(seqs, 80, L, seed=41)
    want = E.AlignEngine(ref, cfg, max_len=L, chunk_size=32, group_probe=group_ok).align_batch(c1, l1)
    eng = T.AlignEngine(port, cfg, CPU, max_len=L, chunk_size=32, group_probe=group_ok)
    assert key in eng.tables and eng.wire == "full"
    assert eng.params.group_g == (port.pair_g if key == "groupcls_bucket" else 0)
    got = eng.align_batch(c1, l1)
    for k in OUT_KEYS:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize(
    "lib, group_ok, max_len, paired",
    [("wide", True, 100, False), ("wide", True, 256, True), ("wide", False, 100, False),
     ("wide", False, 150, True), ("family_mono", True, 100, False), ("family_mono", True, 256, True),
     ("w19", True, 60, False), ("w19", False, 60, True)],
)
def test_auto_chunk_size_wide_branches(libs, lib, group_ok, max_len, paired):
    """The groupcls branch, the monocls / two-choice branch with and
    without class bands, equal to the reference's; uncapped on cuda, by
    the reference's formula."""
    ref, port, _, _ = libs[lib]
    got = T.auto_chunk_size(port, max_len, paired, CPU, group_ok)
    assert got == E.auto_chunk_size(ref, max_len, paired, group_ok)
    cuda = T.auto_chunk_size(port, max_len, paired, torch.device("cuda"), group_ok)
    assert cuda >= got and (cuda == got or got == T.CPU_CHUNK_MAX)
    k, W, S = port.k, port.bitset_words, TT.MONO_SLOTS
    P = max_len - k + 1
    if group_ok and port.has_pairs:
        g = port.pair_g
        PP = max_len - (k + g - 1) + 1
        Q = (PP + g - 1) // g + 1
        per_read = Q * S * (2 + 2 * g + 1) + 6 * Q * g + 10 * PP + T.RUN_BLOCK * W
    else:
        bands = TT.build_class_bands(port)
        per_read = P * 4 * S + 12 * P + T.RUN_BLOCK * ((1 + 4 * bands[0]) if bands else W)
    want = 1 << int(np.log2((1 << 30) // (per_read * 4 * (2 if paired else 1))))
    assert cuda == int(np.clip(want, T.AUTO_CHUNK_MIN, T.AUTO_CHUNK_MAX))
