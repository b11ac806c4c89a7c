"""The port's wide banded group path ("gband", W > 16 bitset words) against
the reference, exactly: the class bands and gband tables element for element
(robust outlier banding, the 5-plane probe rows of g = 7, the blocked
pre-AND), the shared `.gband` sidecar in both directions, the band
intersection's plain version against `_band_tree` + `_expand_band` and
`band_tree_expand_pallas` in interpret mode, `align_step` on every output
key, the idlist wire word for word and the engine's emit cap. Libraries the
reference sends to its other wide paths get those paths (held in full in
tests/test_torch_wide.py). Everything compared is integer except one float32
compare, which both sides make in float32."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.align.kernels import band_tree_expand_pallas
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import KmerIndex
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import kernels as K
from nimble_tpu_torch.align import tables as TT
from nimble_tpu_torch.index.builder import KmerIndex as PortKmerIndex
from tests.test_torch_host_parity import _assert_same_index, build_both

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
    index, port_index = build_both(data, Config(), k=K_LEN)
    assert index.bitset_words == 75 and index.has_pairs
    ref_np = {k: np.asarray(v) for k, v in E._device_tables(index).items()}
    assert "gband_bucket" in ref_np
    return seqs, data, index, ref_np, TT.tables_from_reference(ref_np, CPU), port_index


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
    return build_both(make_data(seqs), Config(), k=K_LEN)


@pytest.mark.parametrize("case", ["family", "outlier", "g7", "blocked"])
def test_gband_tables_equal_reference(fam, monkeypatch, case):
    """The port's builders equal the reference's on the family library, on
    the robust (outlier) path, with g = 7 (the 5-plane probe rows) and with
    the pre-AND forced into many tiny blocks."""
    _, data, index, _, _, port_index = fam
    if case == "outlier":
        index, port_index = _outlier_index()
        Pw, _, ok = TT.build_class_bands_robust(port_index)
        assert TT.build_class_bands(port_index) is None and not ok.all()
    elif case == "g7":
        index, port_index = build_both(data, Config(), k=K_LEN, group_g=7)
    elif case == "blocked":
        index, port_index = build_both(data, Config(), k=K_LEN)  # no cached reference build
        block = 1 << 15  # 256 rows of 2 Pw = 32 words: hundreds of blocks
        assert index.pair_hi.shape[0] > 100 * block // (32 * 4)
        monkeypatch.setattr(TT, "GBAND_PREAND_BLOCK_BYTES", block)
        monkeypatch.setattr(E, "GBAND_PREAND_BLOCK_BYTES", block)
    for port_fn, ref_fn in ((TT.build_class_bands, E._build_class_bands),
                            (TT.build_class_bands_robust, E._build_class_bands_robust)):
        got, want = port_fn(port_index), ref_fn(index)
        assert (got is None) == (want is None)
        for g, w in zip(got or (), want or ()):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    got = TT.build_groupband_tables(port_index)
    ref = E._build_groupband_tables(index)
    _assert_tables_equal(got, ref)
    assert ("gband_packedrow" in got) == (case != "g7")
    if case == "family":  # a non-empty stash, so its comparison is not vacuous
        assert (got["gband_stash_hi"] != -1).sum() > 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_gband_sidecar_loads_in_both_packages(fam, tmp_path, monkeypatch, writer):
    """An index and its sidecar written by either package load in the other
    (same file, fingerprint and keys): the index equal to both builds, the
    tables equal to a fresh build; a stale or torn sidecar is rebuilt."""
    _, _, index, _, _, port_index = fam
    fresh = TT.build_groupband_tables(port_index)
    path = str(tmp_path / "lib.json.idx.npz")
    copy.copy(index if writer == "reference" else port_index).save(path)  # save() records the path
    for loaded in (KmerIndex.load(path), PortKmerIndex.load(path)):
        _assert_same_index(loaded, index)
        _assert_same_index(loaded, port_index)
    if writer == "reference":
        E._build_groupband_tables(KmerIndex.load(path))
    else:
        TT.groupband_tables(PortKmerIndex.load(path))
    side = TT.gband_sidecar_path(PortKmerIndex.load(path))
    assert side == path + ".gband.single.dense.npz"

    def no_build(*a, **kw):
        raise AssertionError("rebuilt although the sidecar is fresh")

    with monkeypatch.context() as m:
        m.setattr(TT, "build_groupband_tables", no_build)
        m.setattr(E, "_single_hash_placement", no_build)
        _assert_tables_equal(TT.groupband_tables(PortKmerIndex.load(path)), fresh)
        _assert_tables_equal(
            {k: np.asarray(v) for k, v in E._build_groupband_tables(KmerIndex.load(path)).items()}, fresh)
    with np.load(side) as z:
        stale = {k: z[k] for k in z.files}
    stale["__fp"] = stale["__fp"] + 1
    np.savez(side, **stale)
    _assert_tables_equal(TT.groupband_tables(PortKmerIndex.load(path)), fresh)
    with open(side, "r+b") as f:  # a torn write: unreadable, rebuilt
        f.truncate(f.seek(0, 2) // 2)
    _assert_tables_equal(TT.groupband_tables(PortKmerIndex.load(path)), fresh)


def test_device_tables_ship_only_the_gband_step(fam, tmp_path, monkeypatch):
    """The gband keys the step reads, the table re-laid as its page vector
    and band rows (`relayout_gband`, the run log's `gband_relayout` stage),
    the reference's arrays otherwise; their build (`tables.host`) and copy
    (`tables.copy`) stages before it."""
    from nimble_tpu_torch import observability

    _, _, _, ref_np, tables, index = fam
    log = observability.RunLog(str(tmp_path / "run.jsonl"))
    monkeypatch.setattr(observability, "_GLOBAL", log)
    dev = TT.device_tables(index, CPU)
    log.close()
    assert set(dev) == (set(TT.GBAND_KEYS) - {"gband_table"}) | {"gband_page", "gband_band", "gband_words"}
    assert TT.table_words(dev) == TT.table_words(tables) == 75
    for k in set(TT.GBAND_KEYS) - {"gband_table"}:
        assert torch.equal(dev[k], tables[k]) and np.array_equal(dev[k].numpy(), ref_np[k]), k
    table = ref_np["gband_table"]
    assert dev["gband_band"].shape == (table.shape[0], 2 * 16) and dev["gband_band"].is_contiguous()
    assert np.array_equal(dev["gband_page"].numpy(), table[:, 0])
    assert np.array_equal(dev["gband_band"].numpy(), table[:, 1:])
    assert torch.equal(tables["gband_band"], dev["gband_band"])
    events = [json.loads(ln) for ln in (tmp_path / "run.jsonl").read_text().splitlines()]
    # besides the stage, only where the host tables came from (the
    # `gband_sidecar` event, once per index)
    assert {e["event"] for e in events} - {"stage_start", "stage_end"} <= {"gband_sidecar"}
    events = [e for e in events if e["event"] in ("stage_start", "stage_end")]
    assert [(e["event"], e["stage"]) for e in events] == [
        (kind, stage) for stage in ("tables.host", "tables.copy", "gband_relayout")
        for kind in ("stage_start", "stage_end")]
    assert events[4]["bytes"] == table.nbytes and events[5]["wall_s"] >= 0
    assert events[3]["bytes"] == sum(ref_np[k].nbytes for k in TT.GBAND_KEYS)


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
    got = K.band_tree_expand(*TT.relayout_gband(table), idx, torch.from_numpy(has), W)
    assert got.dtype == torch.int32 and got.shape == (page.shape[0], W)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(K.band_tree_expand_reference(*TT.relayout_gband(table), idx, torch.from_numpy(has), W), got)
    assert not want[:3].any() and want[3:].any()


def sequential_fold(page, band, has, W: int, Pw: int):
    """Positions folded one after another into one accumulator (not a
    halving tree), then expanded, as the first CUDA kernel computed it."""
    B, Q1 = page.shape
    acc_p = torch.zeros(B, dtype=torch.int32)
    acc_b = torch.zeros((B, 2 * Pw), dtype=torch.int32)
    acc_h = torch.zeros(B, dtype=torch.bool)
    for q in range(Q1):
        acc_p, acc_b, acc_h = K.band_combine(acc_p, acc_b, acc_h, page[:, q], band[:, q], has[:, q], Pw)
    return K.expand_band(acc_p, acc_b, acc_h, W, Pw)


def two_pass(page, band, has, W: int, Pw: int):
    """The CUDA kernel's algorithm (csrc/band_tree_expand.cu) in numpy, read
    by read: the page pass (any contribution, the highest page P, the
    lowest m), the empty and gap decisions, the band pass (the AND of the
    full bands when m == P, else of the half rows that meet at page P), and
    the W words written by an unsigned offset compare against the frame."""
    page, band, has = page.numpy(), band.numpy(), has.numpy()
    n_pages = -(-W // Pw)
    out = np.zeros((page.shape[0], W), dtype=np.int32)
    for r in range(page.shape[0]):
        h = np.flatnonzero(has[r])
        if h.size == 0:
            continue
        P, m = page[r, h].max(), page[r, h].min()
        if not (0 <= P < n_pages and m >= P - 1):
            continue  # outside the output, or a gap of 2: empty
        f0 = P * Pw
        nf = min(2 * Pw if m == P else Pw, W - f0)
        frame = np.full(nf, -1, dtype=np.int32)
        for q in h:  # a row one page below P gives its upper half
            frame &= band[r, q, np.arange(nf) + (Pw if page[r, q] < P else 0)]
        off = (np.arange(W) - f0).astype(np.uint32)
        inside = off < nf
        out[r, inside] = frame[off[inside]]
    return torch.from_numpy(out)


def _adversarial(W: int, Pw: int, Q1: int, seed: int):
    """Pages one, two and more apart, zero bands at differing pages (an
    empty intersection keeps a page that later positions meet), all-miss
    reads, single contributions and bands on the last, partial page. Then,
    with dense bands: pages {P - 1, P} with the P - 1 rows first and last,
    a gap of 2 only at the last contributing position, one contribution at
    page 0 and one at the last page, and rows 88-91 and 92-95 each at one
    page (the test's clamped indices join them there)."""
    rng = np.random.default_rng(seed)
    n_pages = -(-W // Pw)
    B = 96
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
    # dense bands (15/16 of the bits set), so that the edges' ANDs keep bits
    band[32:] = np.bitwise_or.reduce(
        rng.integers(-(1 << 31), 1 << 31, size=(4, B - 32, Q1, 2 * Pw), dtype=np.int64), axis=0)
    has[32:72] = True
    top = rng.integers(1, n_pages, size=(16, 1))
    low = np.arange(Q1) < max(Q1 // 2, 1)
    page[32:48] = top - np.where(np.arange(16)[:, None] < 8, low, low[::-1])  # P - 1 first, then last
    page[48:56] = rng.integers(0, n_pages - 2, size=(8, 1))
    page[48:56, -1] += 2  # a gap of 2 only at the last contributing position
    page[56:72] = 0
    has[56:72] = False
    has[56:72, rng.integers(0, Q1, size=16)] = True  # one contribution ...
    page[64:72] = n_pages - 1  # ... at page 0, then at the last page
    page[88:92] = page[88, 0]
    page[92:96] = page[92, 0]
    return page, band, has


@pytest.mark.parametrize("model", [sequential_fold, two_pass], ids=["sequential_fold", "two_pass"])
@pytest.mark.parametrize("W, Pw, Q1, seed", [(625, 32, 14, 1), (100, 16, 7, 2), (70, 8, 5, 3),
                                            (75, 16, 40, 4), (77, 24, 9, 5), (625, 32, 1, 6),
                                            (625, 32, 40, 7), (625, 24, 16, 8)])
def test_sequential_fold_matches_the_tree(model, W, Pw, Q1, seed):
    """Any pairing order gives the same bits (kernels.py:329-333): a
    sequential fold, and the kernel's closed form from the highest and
    lowest page, equal _band_tree + _expand_band. Through the table, some
    positions of rows 88-95 contribute at indices -1 and n_rows + 7, which
    the gather clamps to the first and last row."""
    page, band, has = _adversarial(W, Pw, Q1, seed)
    table, idx = _as_table(page, band, seed)
    # a first and a last row at the page of rows 88-91 and 92-95
    ends = [torch.from_numpy(np.concatenate([page[r, :1], band[r, 0]]))[None] for r in (88, 92)]
    table = torch.cat([ends[0], table, ends[1]])
    idx += 1
    n_rows = table.shape[0]
    clamped = np.zeros(has.shape, dtype=bool)
    clamped[88:96, 1::3] = True
    rows = np.nonzero(clamped)[0]
    idx[torch.from_numpy(clamped)] = torch.from_numpy(np.where(rows < 92, -1, n_rows + 7).astype(np.int32))
    has[clamped] = True
    gathered = table[idx.long().clamp(0, n_rows - 1)].numpy()
    page, band = gathered[..., 0], gathered[..., 1:]
    pg, bd, hs = E._band_tree(jnp.asarray(page), jnp.asarray(band), jnp.asarray(has), Pw)
    want = np.asarray(E._expand_band(pg, bd, hs, W, Pw))
    got = model(torch.from_numpy(page), torch.from_numpy(band), torch.from_numpy(has), W, Pw)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(K.band_tree_expand(*TT.relayout_gband(table), idx, torch.from_numpy(has), W).numpy(), want)
    assert want.any() and not want[:4].any()
    if Q1 > 1:  # the edges keep bits: {P - 1, P} in both orders, and a clamped read
        assert want[32:40].any() and want[40:48].any() and want[88:96].any()
        assert not want[48:56].any()  # the late gap of 2 empties the read
    assert want[56:64].any() and want[64:72].any()  # single contributions at page 0 and the last page


def _bte_args():
    page, band, has = _band_case(100, 16, 7, B=5)
    table, idx = _as_table(page, band)
    return [*TT.relayout_gband(table), idx, torch.from_numpy(has), 100]


def _replace(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda a: _replace(a, 1, a[1][:, :24].contiguous()), "multiple of 8"),
        (lambda a: _replace(a, 4, 40), "3 \\* Pw <= W"),
        (lambda a: _replace(a, 1, a[1][:, :-1].contiguous()), "bands of 31 words"),
        (lambda a: _replace(a, 1, a[1].to(torch.int64)), "gband_band must be"),
        (lambda a: _replace(a, 0, a[0][:-1].contiguous()), "gband_page must be"),
        (lambda a: _replace(a, 2, a[2].to(torch.int64)), "idx_sel must be"),
        (lambda a: _replace(a, 3, a[3].to(torch.uint8)), "has_sel must be"),
        (lambda a: _replace(a, 2, torch.zeros((5, 14), dtype=torch.int32)[:, ::2]), "contiguous"),
    ],
    ids=["Pw", "W", "table-width", "table-dtype", "page-shape", "idx-dtype", "has-dtype", "strided"],
)
def test_band_tree_expand_rejects_bad_arguments(mutate, err):
    with pytest.raises(ValueError, match=err):
        K.band_tree_expand(*mutate(_bte_args()))


# --- the align step -----------------------------------------------------


def _params(index, port_index, config, strand):
    ref = dataclasses.replace(
        E.AlignParams.from_config(config, index, strand), group_g=index.pair_g, window_kernel=False)
    port = dataclasses.replace(T.AlignParams.from_config(config, port_index, strand), group_g=port_index.pair_g)
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
    seqs, _, index, ref_np, tables, port_index = fam
    config = Config(intersect_level=level, require_valid_pair=rvp, score_percent=0.5)
    p_ref, p_port = _params(index, port_index, config, strand)
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
    seqs, _, index, ref_np, tables, port_index = fam
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
    p_ref, p_port = _params(index, port_index, Config(), "unstranded")
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
    seqs, _, index, _, tables, port_index = fam
    _, p = _params(index, port_index, Config(score_percent=0.5), "unstranded")
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

    seqs, _, index, _, tables, port_index = fam
    _, p = _params(index, port_index, Config(score_percent=0.5), "unstranded")
    c1, l1, _ = read_batch(seqs, 96, 100, seed=21)
    out = T.align_step(tables, p, torch.from_numpy(c1), torch.from_numpy(l1))
    bits = out["bits"].numpy()
    rows = T.compress_band_rows(out["bits"], 16)
    flat = T.pack_outputs_idlist({**out, "_band": rows}, cap, 16)
    ids = T.unpack_outputs_idlist(flat.numpy(), 96, cap, 96)["ids"]
    fields = dict(group_on=False, discard_multiple_matches=discard, discard_multi_hits=0,
                  max_hits_to_report=cap)
    emit, ref_emit = TP.EmitConfig(**fields), RP.EmitConfig(**fields)
    dense = _per_read(TP.resolve_features_compact(port_index, bits, emit))
    band = _per_read(TP.resolve_features_band(port_index, rows.numpy(), 16, emit))
    assert band == _per_read(RP.resolve_features_band(index, rows.numpy(), 16, ref_emit))
    assert band == dense
    by_ids = _per_read(TP.resolve_features_ids(port_index, ids, emit))
    assert by_ids == _per_read(RP.resolve_features_ids(index, ids, ref_emit))
    small = T.popcount32_rows(out["bits"]).numpy() <= cap  # the ids hold the whole class
    assert [r for r, s in zip(by_ids, small) if s] == [r for r, s in zip(dense, small) if s]
    assert sum(k for k, _ in band) > 10 and any(r[0] for r, s in zip(by_ids, small) if s)


def test_emit_cap_matches_reference_engine(fam):
    """The idlist wire of the engine equals the reference engine's scanned
    dispatch (test_wide_paths.py:406's construction) on every key it ships:
    pass_ cleared for classes over max_hits_to_report, the same ids."""
    from nimble_tpu.io.packing import pack_batch

    seqs, _, index, _, _, port_index = fam
    cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
    c1, l1, _ = read_batch(seqs, 96, 100, seed=78)
    l1[:4] = 100  # the short-read repair is the pipeline's
    pb = pack_batch({"r1_codes": c1, "r1_lens": l1}, 100)
    ref = E.AlignEngine(index, cfg, max_len=100, chunk_size=64, scan_chunks=2, compact_out=True)
    assert ref._idlist_wire is not None
    want = ref.collect_async(ref.align_packed_async(pb))
    port = T.AlignEngine(port_index, cfg, CPU, max_len=100, chunk_size=64)
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
    _, _, index, _, _, port_index = fam
    ref = E.AlignEngine(index, Config(), max_len=max_len, chunk_size=64, scan_chunks=2, compact_out=True)
    port = T.AlignEngine(port_index, Config(), CPU, max_len=max_len, chunk_size=64)
    assert port.idlist == ref._idlist_wire and port.idlist[3] == hdr1


def test_band_wire_matches_reference_bits(fam):
    """With the cap off (group_on set), the engine ships band rows that
    expand to the reference engine's dense bits; paired intersect_level = 1
    keeps the full format."""
    seqs, _, index, _, _, port_index = fam
    c1, l1, src = read_batch(seqs, 80, 100, seed=11)
    c2, l2, _ = read_batch(seqs, 80, 100, seed=12, src=src)
    for cfg, paired, wire in ((Config(group_on="fam"), False, "band"),
                              (Config(intersect_level=1), True, "full")):
        args = (c1, l1, c2, l2) if paired else (c1, l1)
        ref = E.AlignEngine(index, cfg, max_len=100, chunk_size=32, paired=paired)
        port = T.AlignEngine(port_index, cfg, CPU, max_len=100, chunk_size=32, paired=paired)
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
    _, _, _, _, _, index = fam
    eng = T.AlignEngine(index, Config(), torch.device("cpu"), chunk_size=None, max_len=max_len, paired=paired)
    assert eng.band_pw == 16
    cuda = T.auto_chunk_size(index, max_len, paired, torch.device("cuda"), band_words=32)
    g, k = index.pair_g, index.k
    PP = max_len - (k + g - 1) + 1
    Q = (PP + g - 1) // g + 1
    per_read = (Q * (5 * 4 + 3 * 33) + 10 * PP) * 4 * (2 if paired else 1)
    assert cuda == 1 << int(np.log2((1 << 30) // per_read))
    assert eng.chunk_size == min(cuda, T.CPU_CHUNK_MAX)


# --- the other wide paths -----------------------------------------------


def groupcls_seqs():
    """test_wide_paths.py:31's library: a backbone and 1,112 variants of
    it, whose classes span the whole feature space (W = 35), so banding
    fails and the reference takes groupcls; a backbone read crosses more
    than RUN_BLOCK classes."""
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
    return seqs


def _groupcls_index():
    return build_both(make_data(groupcls_seqs()), Config(), k=K_LEN)


def _same_tables(port, ref_np):
    """The port's device tables equal the reference's `_device_tables`
    output as tables_from_reference carries it."""
    want = TT.tables_from_reference(ref_np, CPU)
    assert set(port) == set(want)
    for k, v in want.items():
        assert (port[k] == v) if isinstance(v, int) else torch.equal(port[k], v), k


def test_wide_paths_the_reference_takes_elsewhere_are_refused(fam, monkeypatch):
    """The libraries the reference sends past gband get its path and its
    tables: groupcls where banding is infeasible; monocls, with the class
    bands, under --probe mono (no group entries) and under
    NIMBLE_TPU_NO_GROUP_PROBE=1."""
    _, data, _, _, _, _ = fam
    gcls, port_gcls = _groupcls_index()
    ref_np = {k: np.asarray(v) for k, v in E._device_tables(gcls).items()}
    assert "groupcls_bucket" in ref_np
    eng = T.AlignEngine(port_gcls, Config(), CPU)
    assert eng.params.group_g == gcls.pair_g and "groupcls_bucket" in eng.tables
    _same_tables(eng.tables, ref_np)
    mono, port_mono = build_both(data, Config(), k=K_LEN, group_g=0)
    ref_np = {k: np.asarray(v) for k, v in E._device_tables(mono).items()}
    assert "mcls_bucket" in ref_np and "class_bandrow" in ref_np
    eng = T.AlignEngine(port_mono, Config(), CPU)
    assert eng.params.group_g == 0 and "class_band" in eng.tables
    _same_tables(eng.tables, ref_np)
    _, _, index, _, _, port_index = fam
    monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    eng = T.AlignEngine(port_index, Config(), CPU)
    assert eng.params.group_g == 0
    _same_tables(eng.tables, {k: np.asarray(v) for k, v in E._device_tables(index, group_ok=False).items()})
