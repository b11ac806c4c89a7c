"""The port's wide banded group path ("gband", W > 16 bitset words) against
the reference, exactly: the class bands and gband tables element for element
(robust outlier banding, the 5-plane probe rows of g = 7, the blocked
pre-AND), the shared `.gband` sidecar in both directions, the band
intersection's plain version against `_band_tree` + `_expand_band` and
`band_tree_expand_pallas` in interpret mode, `align_step` on every output
key, the idlist wire word for word and the engine's emit cap. Libraries the
reference sends to its other wide paths are refused. Everything compared is
integer except one float32 compare, which both sides make in float32."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.align.kernels import band_tree_expand_pallas
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import KmerIndex, build_index
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import kernels as K
from nimble_tpu_torch.align import tables as TT

CPU = torch.device("cpu")
OUT_KEYS = ("bits", "score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev", "pass_")
K_LEN = 21


def family_seqs(seed: int = 47, families: int = 8, alleles: int = 300, length: int = 400,
                shared=None):
    """HLA/KIR-shaped: `families` distinct backbones x `alleles` variants
    with 5 substitutions each, so every class lies inside one family's
    contiguous span (8 x 300 -> W = 75 words, Pw = 16). `shared` = (block,
    members): the block is written at 180 into those (family, allele)
    members, making classes that span families."""
    rng = np.random.default_rng(seed)
    seqs = []
    for fam in range(families):
        bb = rng.integers(0, 4, size=length).astype(np.int8)
        for a in range(alleles):
            s = bb.copy()
            s[rng.integers(0, length, size=5)] = rng.integers(0, 4, size=5)
            if shared is not None and (fam, a) in shared[1]:
                s[180 : 180 + len(shared[0])] = shared[0]
            seqs.append(s)
    return seqs


def make_data(seqs) -> Data:
    data = Data()
    for i, s in enumerate(seqs):
        for col, v in zip(data.columns, ("fam", f"f{i:04d}", str(len(s)), seqmod.decode(s))):
            col.append(v)
    return data


def read_batch(seqs, B: int, L: int, seed: int, src=None):
    """Reads drawn from the library (from alleles `src` when given) with
    2% substitutions, some N bases, half reverse-complemented, lens from
    below k+g-1 = 26 up to L. Returns (codes, lens, source allele)."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, dtype=np.int8)
    lens = rng.integers(10, L + 1, size=B).astype(np.int32)
    lens[: B // 2] = L
    lens[:4] = (20, 25, 26, 27)
    if src is None:
        src = rng.integers(0, len(seqs), size=B)
    for i in range(B):
        s = seqs[src[i]]
        st = rng.integers(0, len(s) - L + 1)
        r = s[st : st + L].copy()
        err = rng.random(L) < 0.02
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        if rng.random() < 0.5:
            r = seqmod.revcomp_codes(r[None, :])[0]
        r[rng.random(L) < 0.01] = 4
        codes[i, : lens[i]] = r[: lens[i]]
    codes[-3:] = rng.integers(0, 4, size=(3, L))  # unrelated reads
    return codes, lens, src


@pytest.fixture(scope="module")
def fam():
    seqs = family_seqs()
    data = make_data(seqs)
    index = build_index(data, Config(), k=K_LEN)
    assert index.bitset_words == 75 and index.has_pairs
    ref_np = {k: np.asarray(v) for k, v in E._device_tables(index).items()}
    assert "gband_bucket" in ref_np
    return seqs, data, index, ref_np, TT.tables_from_reference(ref_np, CPU)


def _assert_tables_equal(got, ref):
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        assert got[k].dtype == np.int32 and np.array_equal(got[k], np.asarray(v)), k


def _outlier_index():
    """test_wide_paths.py:558's library: a 24 bp block shared by two
    alleles of different families makes cross-family outlier classes."""
    rng = np.random.default_rng(53)
    shared = rng.integers(0, 4, size=24).astype(np.int8)
    seqs = family_seqs(seed=54, shared=(shared, {(0, 7), (7, 5)}))
    return build_index(make_data(seqs), Config(), k=K_LEN)


@pytest.mark.parametrize("case", ["family", "outlier", "g7", "blocked"])
def test_gband_tables_equal_reference(fam, monkeypatch, case):
    """The port's builders equal the reference's on the family library, on
    the robust (outlier) path, with g = 7 (the 5-plane probe rows) and with
    the pre-AND forced into many tiny blocks."""
    _, data, index, _, _ = fam
    if case == "outlier":
        index = _outlier_index()
        Pw, _, ok = TT.build_class_bands_robust(index)
        assert TT.build_class_bands(index) is None and not ok.all()
    elif case == "g7":
        index = build_index(data, Config(), k=K_LEN, group_g=7)
    elif case == "blocked":
        index = build_index(data, Config(), k=K_LEN)  # no cached reference build
        block = 1 << 15  # 256 rows of 2 Pw = 32 words: hundreds of blocks
        assert index.pair_hi.shape[0] > 100 * block // (32 * 4)
        monkeypatch.setattr(TT, "GBAND_PREAND_BLOCK_BYTES", block)
        monkeypatch.setattr(E, "GBAND_PREAND_BLOCK_BYTES", block)
    for port_fn, ref_fn in ((TT.build_class_bands, E._build_class_bands),
                            (TT.build_class_bands_robust, E._build_class_bands_robust)):
        got, want = port_fn(index), ref_fn(index)
        assert (got is None) == (want is None)
        for g, w in zip(got or (), want or ()):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    got = TT.build_groupband_tables(index)
    ref = E._build_groupband_tables(index)
    _assert_tables_equal(got, ref)
    assert ("gband_packedrow" in got) == (case != "g7")
    if case == "family":  # a non-empty stash, so its comparison is not vacuous
        assert (got["gband_stash_hi"] != -1).sum() > 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_gband_sidecar_loads_in_both_packages(fam, tmp_path, monkeypatch, writer):
    """A sidecar written by either package loads in the other (same file,
    fingerprint and keys) and equals a fresh build; a stale one is rebuilt."""
    _, _, index, _, _ = fam
    fresh = TT.build_groupband_tables(index)
    path = str(tmp_path / "lib.json.idx.npz")
    copy.copy(index).save(path)  # save() records the path on the object
    if writer == "reference":
        E._build_groupband_tables(KmerIndex.load(path))
    else:
        TT.groupband_tables(KmerIndex.load(path))
    side = TT.gband_sidecar_path(KmerIndex.load(path))
    assert side == path + ".gband.single.dense.npz"

    def no_build(*a, **kw):
        raise AssertionError("rebuilt although the sidecar is fresh")

    with monkeypatch.context() as m:
        m.setattr(TT, "build_groupband_tables", no_build)
        m.setattr(E, "_single_hash_placement", no_build)
        _assert_tables_equal(TT.groupband_tables(KmerIndex.load(path)), fresh)
        _assert_tables_equal(
            {k: np.asarray(v) for k, v in E._build_groupband_tables(KmerIndex.load(path)).items()}, fresh)
    with np.load(side) as z:
        stale = {k: z[k] for k in z.files}
    stale["__fp"] = stale["__fp"] + 1
    np.savez(side, **stale)
    _assert_tables_equal(TT.groupband_tables(KmerIndex.load(path)), fresh)
    with open(side, "r+b") as f:  # a torn write: unreadable, rebuilt
        f.truncate(f.seek(0, 2) // 2)
    _assert_tables_equal(TT.groupband_tables(KmerIndex.load(path)), fresh)


def test_device_tables_ship_only_the_gband_step(fam):
    _, _, index, ref_np, tables = fam
    dev = TT.device_tables(index, CPU)
    assert set(dev) == set(TT.GBAND_KEYS) | {"gband_words"}
    assert TT.table_words(dev) == TT.table_words(tables) == 75
    for k in TT.GBAND_KEYS:
        assert torch.equal(dev[k], tables[k]) and np.array_equal(dev[k].numpy(), ref_np[k]), k


# --- the band intersection: plain version, Pallas, sequential fold ------


def _band_case(W: int, Pw: int, Q1: int, B: int = 24, seed: int = 3):
    """tests/test_pallas_kernels.py:87's inputs, made dense enough that
    most intersections stay nonempty: per read a base page with positions
    at it or one page off, dense random bands, runs of repeated positions,
    some misses, three all-miss reads."""
    rng = np.random.default_rng(seed)
    Wb = 2 * Pw
    base = rng.integers(0, -(-W // Pw) - 1, size=(B, 1))
    page = (base + (rng.random((B, Q1)) < 0.2)).astype(np.int32)
    band = np.bitwise_or.reduce(
        rng.integers(-(1 << 31), 1 << 31, size=(3, B, Q1, Wb), dtype=np.int64), axis=0).astype(np.int32)
    for j in range(1, Q1):
        same = rng.random(B) < 0.6
        page[same, j] = page[same, j - 1]
        band[same, j] = band[same, j - 1]
    has = rng.random((B, Q1)) < 0.8
    has[:3] = False
    return page, band, has


def _as_table(page, band, seed: int = 0):
    """The (page, band) values as table rows reached through shuffled
    indices: (table, idx_sel)."""
    B, Q1 = page.shape
    perm = np.random.default_rng(seed).permutation(B * Q1)
    rows = np.concatenate([page.reshape(-1, 1), band.reshape(B * Q1, -1)], axis=1)
    table = np.empty_like(rows)
    table[perm] = rows
    return torch.from_numpy(table), torch.from_numpy(perm.reshape(B, Q1).astype(np.int32))


@pytest.mark.parametrize("W, Pw, Q1", [(625, 32, 14), (100, 16, 7), (70, 8, 5)])
def test_band_tree_expand_plain_version_matches_reference(W, Pw, Q1):
    page, band, has = _band_case(W, Pw, Q1)
    pg, bd, hs = E._band_tree(jnp.asarray(page), jnp.asarray(band), jnp.asarray(has), Pw)
    want = np.asarray(E._expand_band(pg, bd, hs, W, Pw))
    packed = np.concatenate(
        [np.transpose(band, (1, 0, 2)), page.T[..., None], has.T[..., None].astype(np.int32)], axis=-1)
    pallas = np.asarray(band_tree_expand_pallas(jnp.asarray(packed), W, Pw, interpret=True))
    assert np.array_equal(want, pallas)
    table, idx = _as_table(page, band)
    got = K.band_tree_expand(table, idx, torch.from_numpy(has), W, Pw)
    assert got.dtype == torch.int32 and got.shape == (page.shape[0], W)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(K.band_tree_expand_reference(table, idx, torch.from_numpy(has), W, Pw), got)
    assert not want[:3].any() and want[3:].any()


def sequential_fold(page, band, has, W: int, Pw: int):
    """The CUDA kernel's algorithm in plain torch: positions folded one
    after another into one accumulator (not a halving tree), then expanded."""
    B, Q1 = page.shape
    acc_p = torch.zeros(B, dtype=torch.int32)
    acc_b = torch.zeros((B, 2 * Pw), dtype=torch.int32)
    acc_h = torch.zeros(B, dtype=torch.bool)
    for q in range(Q1):
        acc_p, acc_b, acc_h = K.band_combine(acc_p, acc_b, acc_h, page[:, q], band[:, q], has[:, q], Pw)
    return K.expand_band(acc_p, acc_b, acc_h, W, Pw)


def _adversarial(W: int, Pw: int, Q1: int, seed: int):
    """Pages one, two and more apart, zero bands at differing pages (an
    empty intersection keeps a page that later positions meet), all-miss
    reads, single contributions and bands on the last, partial page."""
    rng = np.random.default_rng(seed)
    n_pages = -(-W // Pw)
    B = 64
    base = rng.integers(0, n_pages, size=(B, 1))
    page = np.clip(base + rng.integers(-3, 4, size=(B, Q1)), 0, n_pages - 1).astype(np.int32)
    band = rng.integers(-(1 << 31), 1 << 31, size=(B, Q1, 2 * Pw), dtype=np.int64).astype(np.int32)
    band[rng.random((B, Q1)) < 0.2] = 0
    band[..., :Pw][rng.random((B, Q1)) < 0.2] = 0
    has = rng.random((B, Q1)) < 0.7
    has[:4] = False  # all miss
    has[4:8] = False
    has[4:8, rng.integers(0, Q1)] = True  # one contribution
    page[8:16] = n_pages - 1  # the last page, partial when Pw does not divide W
    page[16:24, ::2] = 0
    page[16:24, 1::2] = 2  # two apart: empty
    band[24:32, 0] = 0  # an early empty band at a low page
    return page, band, has


@pytest.mark.parametrize("W, Pw, Q1, seed", [(625, 32, 14, 1), (100, 16, 7, 2), (70, 8, 5, 3),
                                            (75, 16, 40, 4), (77, 24, 9, 5)])
def test_sequential_fold_matches_the_tree(W, Pw, Q1, seed):
    """Any pairing order gives the same bits (kernels.py:329-333): the
    kernel's sequential fold equals _band_tree + _expand_band."""
    page, band, has = _adversarial(W, Pw, Q1, seed)
    pg, bd, hs = E._band_tree(jnp.asarray(page), jnp.asarray(band), jnp.asarray(has), Pw)
    want = np.asarray(E._expand_band(pg, bd, hs, W, Pw))
    got = sequential_fold(torch.from_numpy(page), torch.from_numpy(band), torch.from_numpy(has), W, Pw)
    assert np.array_equal(got.numpy(), want)
    table, idx = _as_table(page, band, seed)
    assert np.array_equal(K.band_tree_expand(table, idx, torch.from_numpy(has), W, Pw).numpy(), want)
    assert want.any() and not want[:4].any()


def _bte_args():
    page, band, has = _band_case(100, 16, 7, B=5)
    table, idx = _as_table(page, band)
    return [table, idx, torch.from_numpy(has), 100, 16]


def _replace(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda a: _replace(a, 4, 12), "multiple of 8"),
        (lambda a: _replace(a, 3, 40), "3 \\* Pw <= W"),
        (lambda a: _replace(a, 0, a[0][:, :-1].contiguous()), "gband_table must be"),
        (lambda a: _replace(a, 0, a[0].to(torch.int64)), "gband_table must be"),
        (lambda a: _replace(a, 1, a[1].to(torch.int64)), "idx_sel must be"),
        (lambda a: _replace(a, 2, a[2].to(torch.uint8)), "has_sel must be"),
        (lambda a: _replace(a, 1, torch.zeros((5, 14), dtype=torch.int32)[:, ::2]), "contiguous"),
    ],
    ids=["Pw", "W", "table-width", "table-dtype", "idx-dtype", "has-dtype", "strided"],
)
def test_band_tree_expand_rejects_bad_arguments(mutate, err):
    with pytest.raises(ValueError, match=err):
        K.band_tree_expand(*mutate(_bte_args()))


# --- the align step -----------------------------------------------------


def _params(index, config, strand):
    ref = dataclasses.replace(
        E.AlignParams.from_config(config, index, strand), group_g=index.pair_g, window_kernel=False)
    port = dataclasses.replace(T.AlignParams.from_config(config, index, strand), group_g=index.pair_g)
    return ref, port


CASES = [
    # strand, intersect_level, require_valid_pair, paired
    ("unstranded", 0, False, False),
    ("fiveprime", 0, False, False),
    ("threeprime", 0, False, False),
    ("unstranded", 0, False, True),
    ("unstranded", 1, False, True),
    ("unstranded", 2, False, True),
    ("unstranded", 0, True, True),
    ("fiveprime", 1, True, True),
    ("threeprime", 2, False, True),
]


@pytest.mark.parametrize("strand, level, rvp, paired", CASES)
def test_align_step_matches_reference(fam, strand, level, rvp, paired):
    """Single-end and paired (half the mates from the same allele), every
    intersect_level, require_valid_pair, the three strand filters, N bases,
    reverse-complemented reads and reads shorter than k+g-1."""
    seqs, _, index, ref_np, tables = fam
    config = Config(intersect_level=level, require_valid_pair=rvp, score_percent=0.5)
    p_ref, p_port = _params(index, config, strand)
    B, L = 48, 100
    c1, l1, src = read_batch(seqs, B, L, seed=1)
    args = [c1, l1]
    if paired:
        src2 = np.where(np.arange(B) % 2 == 0, src, np.random.default_rng(9).integers(0, len(seqs), B))
        args += list(read_batch(seqs, B, L, seed=2, src=src2)[:2])
    ref_t = {k: jnp.asarray(v) for k, v in ref_np.items()}
    want = jax.jit(lambda t, *a: E.align_step(t, p_ref, *a))(ref_t, *[jnp.asarray(a) for a in args])
    got = T.align_step(tables, p_port, *[torch.from_numpy(a) for a in args])
    for k in OUT_KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        assert np.array_equal(g, w.astype(g.dtype)), k
    assert 0 < got["pass_"].sum() < B
    assert len(np.unique(got["score"].numpy())) > 3


def test_align_step_reads_through_the_stash(fam):
    """Reads that carry a stashed (k+g-1)-mer at a probe position, in both
    orientations: the step equals the reference's, and the stash decides
    the answer (the same tables without it give other bits)."""
    seqs, _, index, ref_np, tables = fam
    kg = K_LEN + index.pair_g - 1
    lib = torch.from_numpy(np.stack(seqs))
    c_hi, c_lo, *_ = K.kmer_keys(lib, torch.full((lib.shape[0],), lib.shape[1], dtype=torch.int32),
                                 kg, tables["gband_bucket"].shape[0])
    key = lambda h, l: (np.asarray(h).astype(np.int64) << 32) | (np.asarray(l).astype(np.int64) & 0xFFFFFFFF)
    stashed = key(ref_np["gband_stash_hi"], ref_np["gband_stash_lo"])[ref_np["gband_stash_hi"] != -1]
    allele, pos = np.nonzero(np.isin(key(c_hi, c_lo), stashed))
    assert allele.size
    L = 100
    rng = np.random.default_rng(4)
    pick = rng.choice(allele.size, size=min(48, allele.size), replace=False)
    codes = np.empty((pick.size, L), dtype=np.int8)
    for i, j in enumerate(pick):
        s, p = seqs[allele[j]], int(pos[j])
        st = p if p + L <= s.shape[0] else p + kg - L  # the grid's first probe or the tail probe
        codes[i] = s[st : st + L]
    codes[1::2] = seqmod.revcomp_codes(codes[1::2])
    lens = np.full(pick.size, L, dtype=np.int32)
    p_ref, p_port = _params(index, Config(), "unstranded")
    ref_t = {k: jnp.asarray(v) for k, v in ref_np.items()}
    want = jax.jit(lambda t, *a: E.align_step(t, p_ref, *a))(ref_t, jnp.asarray(codes), jnp.asarray(lens))
    got = T.align_step(tables, p_port, torch.from_numpy(codes), torch.from_numpy(lens))
    for k in OUT_KEYS:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype)), k
    no_stash = {**tables, "gband_stash_hi": torch.full_like(tables["gband_stash_hi"], -1)}
    without = T.align_step(no_stash, p_port, torch.from_numpy(codes), torch.from_numpy(lens))
    assert not torch.equal(without["score"], got["score"])


# --- the wire and the engine --------------------------------------------


def test_band_rows_and_popcount_match_reference():
    rng = np.random.default_rng(9)
    W, Pw = 70, 8
    bits = np.zeros((40, W), dtype=np.int32)
    for i in range(40):
        pg = int(rng.integers(0, -(-W // Pw)))
        end = min((pg + 2) * Pw, W)
        bits[i, pg * Pw : end] = rng.integers(-(1 << 31), 1 << 31, size=end - pg * Pw, dtype=np.int64)
    bits[:5] = 0
    rows = T.compress_band_rows(torch.from_numpy(bits), Pw).numpy()
    assert np.array_equal(rows, np.asarray(E.compress_band_rows(jnp.asarray(bits), Pw)))
    assert np.array_equal(T.expand_band_rows_np(rows, Pw, W), bits)
    assert np.array_equal(T.popcount32_rows(torch.from_numpy(bits)).numpy(),
                          np.asarray(E._popcount32_rows(jnp.asarray(bits))))


@pytest.mark.parametrize("packed16", [False, True])
@pytest.mark.parametrize("hdr1", [False, True])
@pytest.mark.parametrize("cap", [10, 3])
def test_pack_outputs_idlist_matches_reference(fam, packed16, hdr1, cap):
    """Word for word on a real step's outputs (emit cap applied as the
    engine applies it), and the host inverse round-trips the ids."""
    seqs, _, index, _, tables = fam
    _, p = _params(index, Config(score_percent=0.5), "unstranded")
    c1, l1, _ = read_batch(seqs, 64, 100, seed=5)
    out = T.align_step(tables, p, torch.from_numpy(c1), torch.from_numpy(l1))
    rows = T.compress_band_rows(out["bits"], 16)
    out["pass_"] = out["pass_"] & (T.popcount32_rows(rows[:, 1:]) <= cap)
    assert out["pass_"].any()
    flat = T.pack_outputs_idlist({**out, "_band": rows}, cap, 16, packed16=packed16, hdr1=hdr1)
    ref_out = {k: jnp.asarray(v.numpy()) for k, v in out.items()}
    want = np.asarray(E.pack_outputs_idlist(ref_out, cap, 16, packed16=packed16, hdr1=hdr1))
    assert flat.dtype == torch.int32 and np.array_equal(flat.numpy(), want)
    got = T.unpack_outputs_idlist(flat.numpy(), 64, cap, 60, packed16, hdr1)
    ref = E.unpack_outputs_idlist(want, 64, cap, 60, packed16, hdr1)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    bits = T.ids_to_bits_np(got["ids"], index.bitset_words)
    assert np.array_equal(bits, np.where(got["pass_"][:, None] == 1, out["bits"].numpy()[:60], 0))


def _per_read(resolved):
    """(features, keep, inverse) of a class resolver -> each read's
    (kept, feature string)."""
    feats, keep, inverse = resolved
    if isinstance(feats, tuple):  # the native resolver's (pool, offsets)
        pool, offs = feats
        feats = [bytes(pool[offs[i] : offs[i + 1]]).decode() for i in range(len(offs) - 1)]
    return [(bool(keep[j]), feats[j] if keep[j] else "") for j in inverse]


@pytest.mark.parametrize("cap, discard", [(10, False), (1, False), (10, True)])
def test_band_and_id_resolvers_match_reference(fam, cap, discard):
    """The emission thread's band-row and feature-id resolvers equal the
    reference's on the same rows, and give each read what the dense
    resolver gives it."""
    from nimble_tpu.align import pipeline as RP
    from nimble_tpu_torch.align import pipeline as TP

    seqs, _, index, _, tables = fam
    _, p = _params(index, Config(score_percent=0.5), "unstranded")
    c1, l1, _ = read_batch(seqs, 96, 100, seed=21)
    out = T.align_step(tables, p, torch.from_numpy(c1), torch.from_numpy(l1))
    bits = out["bits"].numpy()
    rows = T.compress_band_rows(out["bits"], 16)
    flat = T.pack_outputs_idlist({**out, "_band": rows}, cap, 16)
    ids = T.unpack_outputs_idlist(flat.numpy(), 96, cap, 96)["ids"]
    fields = dict(group_on=False, discard_multiple_matches=discard, discard_multi_hits=0,
                  max_hits_to_report=cap)
    emit, ref_emit = TP.EmitConfig(**fields), RP.EmitConfig(**fields)
    dense = _per_read(TP.resolve_features_compact(index, bits, emit))
    band = _per_read(TP.resolve_features_band(index, rows.numpy(), 16, emit))
    assert band == _per_read(RP.resolve_features_band(index, rows.numpy(), 16, ref_emit))
    assert band == dense
    by_ids = _per_read(TP.resolve_features_ids(index, ids, emit))
    assert by_ids == _per_read(RP.resolve_features_ids(index, ids, ref_emit))
    small = T.popcount32_rows(out["bits"]).numpy() <= cap  # the ids hold the whole class
    assert [r for r, s in zip(by_ids, small) if s] == [r for r, s in zip(dense, small) if s]
    assert sum(k for k, _ in band) > 10 and any(r[0] for r, s in zip(by_ids, small) if s)


def test_emit_cap_matches_reference_engine(fam):
    """The idlist wire of the engine equals the reference engine's scanned
    dispatch (test_wide_paths.py:406's construction) on every key it ships:
    pass_ cleared for classes over max_hits_to_report, the same ids."""
    from nimble_tpu.io.packing import pack_batch

    seqs, _, index, _, _ = fam
    cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
    c1, l1, _ = read_batch(seqs, 96, 100, seed=78)
    l1[:4] = 100  # the short-read repair is the pipeline's
    pb = pack_batch({"r1_codes": c1, "r1_lens": l1}, 100)
    ref = E.AlignEngine(index, cfg, max_len=100, chunk_size=64, scan_chunks=2, compact_out=True)
    assert ref._idlist_wire is not None
    want = ref.collect_async(ref.align_packed_async(pb))
    port = T.AlignEngine(index, cfg, CPU, max_len=100, chunk_size=64)
    assert port.wire == "idlist" and port.emit_cap == ref.emit_cap == 10
    assert port.idlist == ref._idlist_wire
    got = port.collect_async(port.align_packed_async(pb))
    for k in ("ids", "score", "r1_fwd", "r2_fwd", "pass_"):
        assert np.array_equal(got[k], want[k]), k
    uncapped = T.align_step(port.tables, port.params, torch.from_numpy(c1), torch.from_numpy(l1))
    over = uncapped["pass_"].numpy() & (got["pass_"] == 0)
    assert over.any(), "the workload must exercise the cap"


@pytest.mark.parametrize("max_len, hdr1", [(511, True), (512, False)])
def test_idlist_header_fits_the_score(fam, max_len, hdr1):
    """hdr1's 10-bit score holds 2 max_len only up to 1023: the engine picks
    the same idlist format as the reference's on each side of the bound."""
    _, _, index, _, _ = fam
    ref = E.AlignEngine(index, Config(), max_len=max_len, chunk_size=64, scan_chunks=2, compact_out=True)
    port = T.AlignEngine(index, Config(), CPU, max_len=max_len, chunk_size=64)
    assert port.idlist == ref._idlist_wire and port.idlist[3] == hdr1


def test_band_wire_matches_reference_bits(fam):
    """With the cap off (group_on set), the engine ships band rows that
    expand to the reference engine's dense bits; paired intersect_level = 1
    keeps the full format."""
    seqs, _, index, _, _ = fam
    c1, l1, src = read_batch(seqs, 80, 100, seed=11)
    c2, l2, _ = read_batch(seqs, 80, 100, seed=12, src=src)
    for cfg, paired, wire in ((Config(group_on="fam"), False, "band"),
                              (Config(intersect_level=1), True, "full")):
        args = (c1, l1, c2, l2) if paired else (c1, l1)
        ref = E.AlignEngine(index, cfg, max_len=100, chunk_size=32, paired=paired)
        port = T.AlignEngine(index, cfg, CPU, max_len=100, chunk_size=32, paired=paired)
        assert port.wire == wire
        want = ref.align_batch(*args)
        got = port.align_batch(*args)
        if wire == "band":
            assert got["band_meta"] == (16, 75)
            got["bits"] = T.expand_band_rows_np(got.pop("band_rows"), 16, 75)
        for k in OUT_KEYS:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("max_len, paired", [(100, False), (112, False), (112, True)])
def test_auto_chunk_size_wide_banded_branch(fam, max_len, paired):
    _, _, index, _, _ = fam
    eng = T.AlignEngine(index, Config(), torch.device("cpu"), chunk_size=None, max_len=max_len, paired=paired)
    assert eng.band_pw == 16
    cuda = T.auto_chunk_size(index, max_len, paired, torch.device("cuda"), band_words=32)
    g, k = index.pair_g, index.k
    PP = max_len - (k + g - 1) + 1
    Q = (PP + g - 1) // g + 1
    per_read = (Q * (5 * 4 + 3 * 33) + 10 * PP) * 4 * (2 if paired else 1)
    assert cuda == 1 << int(np.log2((1 << 30) // per_read))
    assert eng.chunk_size == min(cuda, T.CPU_CHUNK_MAX)


# --- what stays refused ---------------------------------------------------


def _groupcls_index():
    """test_wide_paths.py:31's library: a backbone and 1,112 variants of
    it, whose classes span the whole feature space, so banding fails and
    the reference takes groupcls."""
    rng = np.random.default_rng(19)
    backbone = rng.integers(0, 4, size=600).astype(np.int8)
    seqs = [backbone]
    for i in range(12):
        s = backbone.copy()
        s[10 + 20 * i] = (s[10 + 20 * i] + 1) % 4
        seqs.append(s)
    for i in range(1100):
        s = backbone.copy()
        s[rng.integers(320, 600, size=4)] = rng.integers(0, 4, size=4)
        seqs.append(s)
    return build_index(make_data(seqs), Config(), k=K_LEN)


def test_wide_paths_the_reference_takes_elsewhere_are_refused(fam, monkeypatch):
    """groupcls (banding infeasible), monocls (--probe mono, i.e. no group
    entries, or NIMBLE_TPU_NO_GROUP_PROBE=1) raise at engine build, naming
    the ROADMAP item."""
    _, data, _, _, _ = fam
    gcls = _groupcls_index()
    assert "groupcls_bucket" in E._device_tables(gcls)
    with pytest.raises(NotImplementedError, match="groupcls.*Queue 1 item 10"):
        T.AlignEngine(gcls, Config(), CPU)
    mono = build_index(data, Config(), k=K_LEN, group_g=0)
    assert "mcls_bucket" in E._device_tables(mono)
    with pytest.raises(NotImplementedError, match="monocls.*Queue 1 item 10"):
        T.AlignEngine(mono, Config(), CPU)
    _, _, index, _, _ = fam
    monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    with pytest.raises(NotImplementedError, match="monocls.*Queue 1 item 10"):
        T.AlignEngine(index, Config(), CPU)
