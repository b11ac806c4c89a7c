"""The gband path's four table layouts against the reference, exactly:
single-hash or two-choice placement (NIMBLE_TPU_GBAND_PLACEMENT=two) x dense
or indirect rows (NIMBLE_TPU_GBAND_INDIRECT=1), on tests/test_torch_gband.py's
family library (W = 75, g = 6, packed rows; g = 7 for the 5-plane rows).

* The tables of each layout, array for array and in the reference's key
  order, from the port's builder and from `groupband_tables` under the
  environment.
* A layout derived from another layout's sidecar or from the tables already
  on the index object (only the placement runs) equals the from-scratch
  build.
* Each layout's sidecar, under the reference's file name, written by either
  package loads in the other, and both packages write the same members.
* `align_step` on each layout, single-end and paired, with reads whose probe
  keys lie in the stash.
* The path choice under a NIMBLE_TPU_MONO_MAX_BYTES that single-hash
  placement overflows and two-choice placement fits (a subprocess: the cap
  is read at import).
* One CLI TSV of both packages under two-choice placement, and a meshed
  engine on the indirect two-choice layout."""
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config
from nimble_tpu.index.builder import KmerIndex
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import kernels as K
from nimble_tpu_torch.align import tables as TT
from nimble_tpu_torch.align.engine import AlignEngine, expand_band_rows_np
from nimble_tpu_torch.index.builder import KmerIndex as PortKmerIndex
from nimble_tpu_torch.index.builder import build_index as port_build_index
from nimble_tpu_torch.parallel import mesh as PM
from tests.test_torch_gband import K_LEN, OUT_KEYS, family_seqs, make_data, read_batch
from tests.test_torch_gband_cli import _decode, _noisy
from tests.test_torch_host_parity import build_both

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (two_choice, indirect) -> the sidecar's tag
MODES = {(False, False): "single.dense", (True, False): "two.dense", (False, True): "single", (True, True): "two"}
MODE_IDS = list(MODES.values())


def mode_env(mode) -> dict:
    return {"NIMBLE_TPU_GBAND_PLACEMENT": "two" if mode[0] else "single",
            "NIMBLE_TPU_GBAND_INDIRECT": "1" if mode[1] else "0"}


def set_mode(monkeypatch, mode) -> None:
    for k, v in mode_env(mode).items():
        monkeypatch.setenv(k, v)


def fresh(index):
    """A copy of an index without the gband tables either package keeps on it."""
    index = copy.copy(index)
    for attr in ("_gband_cache", "_torch_gband"):
        index.__dict__.pop(attr, None)
    return index


@pytest.fixture(scope="module")
def lay():
    """(seqs, reference index, port index, {mode: the reference's
    `_device_tables` under that layout, as numpy})."""
    seqs = family_seqs()
    index, port_index = build_both(make_data(seqs), Config(), k=K_LEN)
    assert index.bitset_words == 75 and index.pair_g == 6
    ref = {}
    with pytest.MonkeyPatch.context() as m:
        for mode in MODES:
            set_mode(m, mode)
            ref[mode] = {k: np.asarray(v) for k, v in E._device_tables(index).items()}
    return seqs, index, port_index, ref


def gband_part(tables):
    """The gband arrays of a `_device_tables` output, in its order."""
    return {k: v for k, v in tables.items() if k.startswith("gband_")}


def assert_same(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def members(path):
    """A sidecar's members, name and bytes, in file order (the zip
    timestamps left out)."""
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i)) for i in z.infolist()]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_layout_tables_equal_reference(lay, monkeypatch, mode):
    """Every array and marker: the bucket rows (nb2 rows, or the occupied
    buckets' after an empty row 0), `gband_ptr8`, the band table, the stash
    planes, `gband_single` only under single-hash placement."""
    _, _, port_index, ref = lay
    want = gband_part(ref[mode])
    set_mode(monkeypatch, mode)
    assert TT.gband_mode() == mode
    built = fresh(port_index)
    assert_same(TT.groupband_tables(built), want)
    assert built.gband_sidecar["source"] == "built"
    two_choice, indirect = mode
    assert ("gband_single" in want) != two_choice and ("gband_ptr8" in want) == indirect
    assert "gband_packedrow" in want and (want["gband_stash_hi"] != -1).sum() > 0
    dense = gband_part(ref[(two_choice, False)])
    if indirect:  # the occupied buckets' rows, reached through the pointers
        ptr = want["gband_ptr8"].reshape(-1)
        assert ptr.shape[0] == dense["gband_bucket"].shape[0]
        assert want["gband_bucket"].shape[0] == (ptr > 0).sum() + 1 and not (want["gband_bucket"][0, :4] != -1).any()
        assert np.array_equal(want["gband_bucket"][ptr], dense["gband_bucket"])
    if two_choice:  # denser than single-hash placement
        assert dense["gband_bucket"].shape[0] * 4 <= ref[(False, False)]["gband_bucket"].shape[0]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_derived_layout_equals_a_fresh_build(lay, tmp_path, monkeypatch, mode):
    """From each other layout's sidecar (alone beside the index), only the
    placement runs, and the tables and the sidecar written are the
    from-scratch build's; then the next layout comes from the tables held
    in memory."""
    _, index, port_index, ref = lay
    want = gband_part(ref[mode])
    path = str(tmp_path / "lib.json.idx.npz")
    fresh(port_index).save(path)

    def no_build(*a, **kw):
        raise AssertionError("built from scratch although another layout is at hand")

    monkeypatch.setattr(TT, "build_groupband_tables", no_build)
    set_mode(monkeypatch, mode)
    side = TT.gband_sidecar_path(PortKmerIndex.load(path))
    for source in MODES:
        if source == mode:
            continue
        src = TT.gband_sidecar_path(PortKmerIndex.load(path), source)
        np.savez(src, __fp=TT.gband_fingerprint(port_index), **gband_part(ref[source]))
        loaded = PortKmerIndex.load(path)
        assert_same(TT.groupband_tables(loaded), want)
        assert loaded.gband_sidecar["source"] == "derived" and loaded.gband_sidecar["derived_from"] == src
        scratch = str(tmp_path / "scratch.npz")
        np.savez(scratch, __fp=TT.gband_fingerprint(port_index), **want)
        assert members(side) == members(scratch)
        os.remove(src)
        os.remove(side)
    nxt = next(m for m in MODES if m != mode)
    set_mode(monkeypatch, nxt)
    assert_same(TT.groupband_tables(loaded), gband_part(ref[nxt]))
    assert loaded.gband_sidecar["derived_from"] == "memory"


def test_derived_layout_from_five_plane_rows(monkeypatch):
    """g = 7: the 5-plane probe rows (idx_s, idx_d and the mask word each a
    plane) give back the from-scratch payload, and a layout laid out from
    it equals the from-scratch build (whose default layout
    tests/test_torch_gband.py holds against the reference at g = 7)."""
    from nimble_tpu_torch.config import Config as PortConfig
    from nimble_tpu_torch.config import Data as PortData

    data = make_data(family_seqs())
    port_index = port_build_index(PortData(headers=list(data.headers), columns=[list(c) for c in data.columns]),
                                  PortConfig(), k=K_LEN, group_g=7)
    base = TT.build_groupband_tables(port_index, (False, False))
    assert "gband_packedrow" not in base and base["gband_bucket"].shape[1] == 20
    payload = TT.gband_payload_of(base, port_index)
    want = TT.gband_payload(port_index, TT.build_class_bands_robust(port_index))
    assert len(payload) == len(want) and all(np.array_equal(a, b) for a, b in zip(payload, want))
    mode = (True, True)
    got = TT.gband_layout(port_index, payload, TT._gband_placement(port_index, mode[0]), mode)
    assert_same(got, TT.build_groupband_tables(port_index, mode))
    assert TT.gband_payload_of(got, port_index) is not None
    # a table that lacks an entry gives no payload (the build runs instead)
    lost = {**base, "gband_stash_hi": np.full_like(base["gband_stash_hi"], -1)}
    assert TT.gband_payload_of(lost, port_index) is None


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_sidecar_loads_in_both_packages(lay, tmp_path, monkeypatch, mode):
    """Each package's sidecar of the layout, under the reference's file
    name, loads in the other without a build, and the two files hold the
    same members byte for byte."""
    _, index, port_index, ref = lay
    want = gband_part(ref[mode])
    set_mode(monkeypatch, mode)
    sides = {}
    fresh(index).save(str(tmp_path / "lib.json.idx.npz"))
    for writer, ix in (("reference", index), ("port", port_index)):
        path = str(tmp_path / writer / "lib.json.idx.npz")
        os.makedirs(os.path.dirname(path))
        shutil.copy(tmp_path / "lib.json.idx.npz", path)  # an index file loads in both packages
        ix = fresh(ix)  # keeps the class bands the fixture computed
        ix._cache_path = path
        if writer == "reference":
            E._build_groupband_tables(ix)
        else:
            TT.groupband_tables(ix)
        sides[writer] = path + f".gband.{MODES[mode]}.npz"
        assert os.path.exists(sides[writer]) and TT.gband_sidecar_path(PortKmerIndex.load(path)) == sides[writer]

    def no_build(*a, **kw):
        raise AssertionError("rebuilt although the sidecar is fresh")

    with monkeypatch.context() as m:
        for fn in ("_single_hash_placement", "_two_choice_placement"):
            m.setattr(E, fn, no_build)
        for fn in ("build_groupband_tables", "_gband_placement"):
            m.setattr(TT, fn, no_build)
        port_ix = PortKmerIndex.load(os.path.dirname(sides["reference"]) + "/lib.json.idx.npz")
        assert_same(TT.groupband_tables(port_ix), want)
        assert port_ix.gband_sidecar["source"] == "loaded"
        got = E._build_groupband_tables(KmerIndex.load(os.path.dirname(sides["port"]) + "/lib.json.idx.npz"))
        assert_same({k: np.asarray(v) for k, v in got.items()}, want)
    assert members(sides["reference"]) == members(sides["port"])


def stash_reads(seqs, tables, kg: int, L: int, n: int, seed: int):
    """Reads of the library whose first grid probe or tail probe is a
    stashed (k+g-1)-mer, half of them reverse-complemented."""
    lib = torch.from_numpy(np.stack(seqs))
    # the keys do not depend on the bucket count
    c_hi, c_lo, *_ = K.kmer_keys(lib, torch.full((lib.shape[0],), lib.shape[1], dtype=torch.int32), kg, 2)
    key = lambda h, l: (np.asarray(h).astype(np.int64) << 32) | (np.asarray(l).astype(np.int64) & 0xFFFFFFFF)
    stashed = key(tables["gband_stash_hi"], tables["gband_stash_lo"])[tables["gband_stash_hi"] != -1]
    allele, pos = np.nonzero(np.isin(key(c_hi, c_lo), stashed))
    pick = np.random.default_rng(seed).choice(allele.size, size=min(n, allele.size), replace=False)
    codes = np.empty((pick.size, L), dtype=np.int8)
    for i, j in enumerate(pick):
        s, p = seqs[allele[j]], int(pos[j])
        st = p if p + L <= s.shape[0] else p + kg - L
        codes[i] = s[st : st + L]
    codes[1::2] = seqmod.revcomp_codes(codes[1::2])
    return codes, np.full(pick.size, L, dtype=np.int32)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_align_step_matches_reference(lay, monkeypatch, mode):
    """The step on each layout, single-end and paired (intersect_level 1),
    equals the reference's on every output key, and the port's own tables
    for the layout (device_tables) equal the reference's: 48 library reads
    (some shorter than k+g-1, N bases, half reverse-complemented) and 8-16
    reads through the stash, whose answer the stash decides."""
    seqs, index, port_index, ref = lay
    ref_np = ref[mode]
    set_mode(monkeypatch, mode)
    tables = TT.tables_from_reference(ref_np, CPU)
    own = TT.device_tables(port_index, CPU)
    assert set(own) == set(tables) and all(
        torch.equal(own[k], v) if isinstance(v, torch.Tensor) else own[k] == v for k, v in tables.items())
    assert ("gband_two" in tables) == mode[0] and ("gband_ptr8" in tables) == mode[1]
    L = 100
    c1, l1, src = read_batch(seqs, 48, L, seed=1)
    sc, sl = stash_reads(seqs, ref_np, K_LEN + index.pair_g - 1, L, 16, seed=4)
    assert sc.shape[0] >= 8
    src2 = np.where(np.arange(48) % 2 == 0, src, np.random.default_rng(9).integers(0, len(seqs), 48))
    c2, l2, _ = read_batch(seqs, 48, L, seed=2, src=src2)
    args = [np.concatenate([c1, sc]), np.concatenate([l1, sl]), np.concatenate([c2, sc[::-1]]),
            np.concatenate([l2, sl])]
    config = Config(intersect_level=1, score_percent=0.5)
    p_ref = dataclasses.replace(E.AlignParams.from_config(config, index, "unstranded"), group_g=index.pair_g,
                                window_kernel=False)
    p_port = dataclasses.replace(T.AlignParams.from_config(config, port_index, "unstranded"),
                                 group_g=port_index.pair_g)
    ref_t = {k: jnp.asarray(v) for k, v in ref_np.items()}
    # one program for both steps: one compile
    wants = jax.jit(lambda t, *a: (E.align_step(t, p_ref, *a[:2]), E.align_step(t, p_ref, *a)))(
        ref_t, *[jnp.asarray(a) for a in args])
    for n_args, want in zip((2, 4), wants):
        step = lambda t: T.align_step(t, p_port, *[torch.from_numpy(a) for a in args[:n_args]])
        got = step(tables)
        for k in OUT_KEYS:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype)), (n_args, k)
        assert 0 < got["pass_"].sum() < args[0].shape[0] and got["pass_"][48:].all()
        without = step({**tables, "gband_stash_hi": torch.full_like(tables["gband_stash_hi"], -1)})
        assert not torch.equal(without["score"][48:], got["score"][48:])


PATH_CHOICE = r"""
import json, os, sys
import numpy as np, torch
from nimble_tpu.align import engine as E
from nimble_tpu.index.builder import KmerIndex
from nimble_tpu_torch.align import tables as TT
from nimble_tpu_torch.align.engine import AlignEngine
from nimble_tpu_torch.index.builder import KmerIndex as PortKmerIndex

name = lambda keys: next(n for k, n in AlignEngine.PATHS if k in keys)
out = {"caps": [E.MONO_MAX_BYTES, TT.MONO_MAX_BYTES]}
for placement in ("single", "two"):
    os.environ["NIMBLE_TPU_GBAND_PLACEMENT"] = placement
    ref = E._device_tables(KmerIndex.load(sys.argv[1]))
    port = TT.device_tables(PortKmerIndex.load(sys.argv[1]), torch.device("cpu"))
    out[placement] = [name(ref), name(port)]
print(json.dumps(out))
"""


def test_path_choice_under_a_tight_byte_cap(lay, tmp_path):
    """A cap below single-hash placement's smallest gband table: the
    reference falls back from gband under single-hash placement and takes
    it under two-choice placement, which has no byte check; the port takes
    the same path in both."""
    _, index, _, ref = lay
    n = index.pair_hi.shape[0]
    single_bytes = (1 << (int(np.ceil(np.log2(n))) + 1)) * 4 * 4 * 4
    cap = single_bytes - 1
    assert ref[(True, False)]["gband_bucket"].nbytes <= cap  # two-choice placement would fit anyway
    path = str(tmp_path / "lib.json.idx.npz")
    fresh(index).save(path)
    env = {**os.environ, "NIMBLE_TPU_MONO_MAX_BYTES": str(cap), "NIMBLE_TPU_GBAND_INDIRECT": "0",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run([sys.executable, "-c", PATH_CHOICE, path], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["caps"] == [cap, cap]
    assert out["two"] == ["gband", "gband"]
    assert out["single"][0] != "gband" and out["single"][1] == out["single"][0]


def test_cli_tsv_under_two_choice_placement(tmp_path, monkeypatch, capsys):
    """`align` of both packages on the family library under
    NIMBLE_TPU_GBAND_PLACEMENT=two (and the indirect rows): the same TSV
    bytes, and each writes the layout's sidecar under the reference's
    name; then the port's `index --warm` under the dense two-choice
    layout names that layout's sidecar."""
    seqs = family_seqs()
    n = len(seqs)
    cols = [["fam"] * n, [f"f{i:04d}" for i in range(n)], [str(len(s)) for s in seqs], [_decode(s) for s in seqs]]
    lib = [Config().to_dict(), {"headers": ["reference_genome", "sequence_name", "nt_length", "sequence"],
                                "columns": cols}]
    rng = np.random.default_rng(7)
    recs = []
    for i in range(200):
        s = seqs[rng.integers(0, n)]
        L = 100 if i % 10 else int(rng.integers(18, 40))
        st = int(rng.integers(0, len(s) - L + 1))
        r = _noisy(rng, s[st : st + L], 0.01)
        if i % 2:
            r = seqmod.revcomp_codes(r[None, :])[0]
        recs.append((f"s{i}", _decode(r), "I" * L))
    monkeypatch.setenv("NIMBLE_TPU_GBAND_PLACEMENT", "two")
    monkeypatch.setenv("NIMBLE_TPU_GBAND_INDIRECT", "1")
    tsv = {}
    for tag, cli, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        (d / "lib.json").write_text(json.dumps(lib))
        write_fastq(str(d / "reads.fastq"), recs)
        assert cli(["align", "--reference", str(d / "lib.json"), "--output", str(d / "out.tsv"),
                    "--input", str(d / "reads.fastq"), *extra]) == 0, tag
        tsv[tag] = (d / "out.tsv").read_bytes()
        assert [f.name for f in d.glob("*.gband.*")] == ["lib.json.idx.npz.gband.two.npz"], tag
    assert tsv["ref"].count(b"\n") > 60
    assert tsv["port"] == tsv["ref"]
    # `index --warm` names the sidecar of its layout: the dense two-choice
    # one, derived from the indirect layout's that align wrote
    monkeypatch.setenv("NIMBLE_TPU_GBAND_INDIRECT", "0")
    capsys.readouterr()
    assert port_cli(["index", "--reference", str(tmp_path / "port" / "lib.json"), "--warm", "100",
                     "--device", "cpu"]) == 0
    side = tmp_path / "port" / "lib.json.idx.npz.gband.two.dense.npz"
    assert f"gband sidecar: {side} (derived in " in capsys.readouterr().out and side.exists()


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_meshed_engine_on_the_indirect_two_choice_layout(lay, monkeypatch, grid):
    """A grid of CPU shards on the indirect two-choice layout equals the
    unmeshed engine: on a data split every shard's gband tables carry the
    pointer rows and the two-choice marker on its device; a feature split
    takes monocls in both packages, as it does on every layout."""
    seqs, _, port_index, _ = lay
    set_mode(monkeypatch, (True, True))
    cfg = Config(max_hits_to_report=0)
    codes, lens, _ = read_batch(seqs, 96, 100, 5)
    n_data, n_feature = grid
    eng = AlignEngine(port_index, cfg, CPU, chunk_size=64, max_len=100,
                      mesh=PM.make_mesh(n_data, n_feature, [CPU] * 8))
    alone = AlignEngine(port_index, cfg, CPU, chunk_size=64, max_len=100,
                        group_probe=None if n_feature == 1 else False)
    assert eng.path == alone.path == ("gband" if n_feature == 1 else "monocls (class bands)")
    if n_feature == 1:
        assert len(eng.shards) == n_data
        for dev, tables in eng.shards:
            assert tables["gband_ptr8"].device == dev and tables["gband_two"] is True
    got, want = eng.align_batch(codes, lens), alone.align_batch(codes, lens)
    W = port_index.bitset_words
    for out in (got, want):
        if "band_rows" in out:
            out["bits"] = expand_band_rows_np(out.pop("band_rows"), *out.pop("band_meta"))
    assert np.array_equal(got["bits"][:, :W], want["bits"]) and not got["bits"][:, W:].any()
    for k in ("score", "pass_"):
        assert np.array_equal(got[k], want[k]), k
    assert want["pass_"].sum() > 32
