"""`align --mesh` of the port (parallel/mesh.py, AlignEngine(mesh=),
StackedEngine(mesh=)) on the CPU, against the reference's mesh on the
8-device virtual CPU mesh that tests/conftest.py forces, exactly.

* The spec parser against the reference's, its errors, and the CLI's device
  rule (cuda: the visible cards; cpu: the shards an explicit data axis
  names, else one data row).
* AlignEngine(mesh=) on (8, 1), (4, 2) and (2, 4) grids of CPU shards, on
  tests/test_sharding.py's narrow library (group under the data split,
  monocls at W = 2 under the feature split), on the family library (W = 75:
  gband, and monocls with the class bands) and on the groupcls library
  (W = 35: groupcls, and monocls over split class_bits), single-end and
  paired: score, pass_ and the full bits, padding words included, equal
  the reference's mesh engine, and bits[:, :W] the port's unmeshed engine
  on the same path.
* StackedEngine(mesh=) on tests/test_mesh_cli.py's workload; a feature
  split is NotStackable.
* The CLI on tests/test_mesh_cli.py's workspace: the TSV bytes of the
  port's unmeshed run and of the reference CLI's `--mesh` run, two
  libraries with and without the stack, `--probe mono` under a feature
  split, the run log's `mesh` event, and the refusal of a grid larger than
  the visible cards.
* plan_index_placement against the reference, shard_tables' one copy per
  distinct device.
"""
import json
import os

import numpy as np
import pytest
import torch

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align.engine import AlignEngine as RefEngine
from nimble_tpu.align.stacked import StackedEngine as RefStacked
from nimble_tpu.config import Config
from nimble_tpu.parallel import mesh as RM
from nimble_tpu_torch import observability
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align.engine import AlignEngine, expand_band_rows_np, ids_to_bits_np
from nimble_tpu_torch.align.stacked import NotStackable, StackedEngine
from nimble_tpu_torch.parallel import mesh as PM
from tests.test_mesh_cli import workspace  # noqa: F401  (the fixture)
from tests.test_torch_gband import family_seqs, groupcls_seqs, make_data, read_batch
from tests.test_torch_host_parity import build_both

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
GRIDS = [(8, 1), (4, 2), (2, 4)]
CHUNK = 64


def narrow_data():
    """tests/test_sharding.py:15's library (40 variants of a 500 bp
    backbone, W = 2) as a Data."""
    from nimble_tpu.config import Data

    rng = np.random.default_rng(3)
    backbone = "".join("ACGT"[i] for i in rng.integers(0, 4, size=500))
    data = Data()
    for i in range(40):
        s = list(backbone)
        for pos in rng.integers(0, 500, size=10):
            s[pos] = "ACGT"[rng.integers(0, 4)]
        for col, v in zip(data.columns, ("lib", f"f{i}", "500", "".join(s))):
            col.append(v)
    return data


@pytest.fixture(scope="module")
def libs():
    """name -> (reference index, port index, config, (r1 codes, lens), (r2
    codes, lens)). The wide libraries' config has no emit cap, so the
    port's gband engine ships band rows that expand to the reference's
    dense bits."""
    from tests.test_sharding import build_workload

    out = {}
    _, cfg, codes, lens = build_workload()
    ref, port = build_both(narrow_data(), cfg, k=21)
    # mate 2: the same fragments, reverse-complemented
    out["narrow"] = (ref, port, cfg, (codes, lens), (seqmod.revcomp_codes(codes), lens))
    for name, seqs in (("family", family_seqs()), ("groupcls", groupcls_seqs())):
        cfg = Config(max_hits_to_report=0)
        ref, port = build_both(make_data(seqs), cfg, k=21)
        out[name] = (ref, port, cfg, read_batch(seqs, 96, 100, 5)[:2], read_batch(seqs, 96, 100, 6)[:2])
    assert [out[n][1].bitset_words for n in out] == [2, 75, 35]
    return out


def dense(out: dict, W: int) -> dict:
    """Any wire's outputs with dense `bits`."""
    if "band_rows" in out:
        Pw, Wm = out.pop("band_meta")
        out["bits"] = expand_band_rows_np(out.pop("band_rows"), Pw, Wm)
    if "ids" in out:
        out["bits"] = ids_to_bits_np(out.pop("ids"), W)
    return out


def test_parse_mesh_spec_matches_the_reference():
    for spec in ("data=4,feature=2", "data=8", "feature=2", "8", "auto", "DATA=2,feature=4"):
        want, got = RM.parse_mesh_spec(spec), PM.parse_mesh_spec(spec, CPU8)
        assert (got.n_data, got.n_feature) == (want.n_data, want.n_feature), spec
        assert got.devices == CPU8[: got.n_data * got.n_feature]
    assert RM.parse_mesh_spec("") is None and PM.parse_mesh_spec("", CPU8) is None
    for bad in ("rows=2", "data=x"):
        with pytest.raises(ValueError):
            RM.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            PM.parse_mesh_spec(bad, CPU8)
    with pytest.raises(ValueError, match="needs 16 devices, and 8 are visible"):
        PM.parse_mesh_spec("data=8,feature=2", CPU8)
    plan = PM.make_mesh(2, 2, [CPU, torch.device("meta")] * 2)
    assert [plan.lead(d) for d in range(2)] == [CPU, CPU] and plan.grid[1][1] == torch.device("meta")


def test_cli_device_rule(monkeypatch):
    """cpu: an explicit data axis takes exactly N*M CPU shards, 'auto' or a
    data axis left out one data row; cuda: the visible cards, refused
    beyond them (two cards monkeypatched in)."""
    for spec, axes in (("data=3,feature=2", (3, 2)), ("5", (5, 1)), ("auto", (1, 1)), ("feature=2", (1, 2))):
        plan = PM.align_mesh(spec, CPU)
        assert (plan.n_data, plan.n_feature) == axes and plan.devices == [CPU] * (axes[0] * axes[1])
    assert PM.align_mesh("", CPU) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert PM.align_mesh("auto", torch.device("cuda")).devices == cards
    plan = PM.align_mesh("feature=2", torch.device("cuda"))
    assert (plan.n_data, plan.n_feature) == (1, 2) and plan.devices == cards
    with pytest.raises(ValueError, match="needs 4 devices, and 2 are visible"):
        PM.align_mesh("data=4", torch.device("cuda"))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("lib", ["narrow", "family", "groupcls"])
def test_meshed_engine_matches_the_reference(libs, lib, paired, grid):
    ref_ix, port_ix, cfg, m1, m2 = libs[lib]
    args = [*m1, *m2] if paired else list(m1)
    L = m1[0].shape[1]
    n_data, n_feature = grid
    ref = RefEngine(ref_ix, cfg, chunk_size=CHUNK, max_len=L, paired=paired, mesh=RM.make_mesh(n_data, n_feature))
    want = ref.align_batch(*args)
    eng = AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=L, paired=paired,
                      mesh=PM.make_mesh(n_data, n_feature, CPU8))
    W = port_ix.bitset_words
    got = dense(eng.align_batch(*args), W)
    W_pad = -(-W // n_feature) * n_feature
    assert got["bits"].shape == (m1[0].shape[0], W_pad) and eng.chunk_size % n_data == 0
    for k in ("score", "pass_", "bits"):
        assert np.array_equal(np.asarray(want[k]).astype(np.int64), got[k].astype(np.int64)), k
    assert got["pass_"].sum() > m1[0].shape[0] // 3
    # the port's unmeshed engine on the same path: the group probe off
    # where the feature split takes the separate class table
    alone = AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=L, paired=paired,
                        group_probe=None if n_feature == 1 else False)
    base = dense(alone.align_batch(*args), W)
    assert np.array_equal(base["bits"], got["bits"][:, :W]) and not got["bits"][:, W:].any()
    assert np.array_equal(base["score"], got["score"]) and np.array_equal(base["pass_"], got["pass_"])
    path = {"narrow": "group", "family": "gband", "groupcls": "groupcls"}[lib] if n_feature == 1 else (
        "monocls (class bands)" if lib == "family" else "monocls")
    assert eng.path == path


def test_meshed_gband_idlist_wire(libs):
    """The gband idlist wire (the default emit cap) unpacks each shard with
    its own valid rows: a batch that ends inside the third of eight shards
    gives the unmeshed engine's outputs."""
    _, port_ix, _, (codes, lens), _ = libs["family"]
    cfg = Config()
    n = 2 * CHUNK + 20
    codes, lens = np.concatenate([codes, codes])[:n], np.concatenate([lens, lens])[:n]
    eng = AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=100, mesh=PM.make_mesh(8, 1, CPU8))
    assert eng.wire == "idlist"
    got, want = eng.align_batch(codes, lens), AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=100).align_batch(codes, lens)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert got["ids"].shape[0] == n


def test_intersect_class_slices_take_either_branch():
    """A slice of at most 32 words takes the gather branch of
    intersect_class_bits, a wide slice the runs loop; both equal the whole
    intersection on their words."""
    from nimble_tpu_torch.align.engine import intersect_class_bits, intersect_class_slices

    rng = np.random.default_rng(5)
    cb = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(50, 70), dtype=np.int64).astype(np.int32))
    ids = torch.from_numpy(rng.integers(-1, 50, size=(16, 40)).astype(np.int32))
    ids[3] = -1
    whole = intersect_class_bits(ids, ids >= 0, cb)
    for M in (2, 3):
        padded = PM.pad_axis(cb, 1, M)
        w = padded.shape[1] // M
        got = intersect_class_slices(ids, [padded[:, f * w:(f + 1) * w].contiguous() for f in range(M)])
        assert torch.equal(got[:, :70], whole) and not got[:, 70:].any()


def stacked_workload():
    """tests/test_mesh_cli.py:124's two libraries and 64 reads."""
    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Data

    from tests.test_mesh_cli import rand_seq

    def mk(n, seed):
        r = np.random.default_rng(seed)
        backbone = rand_seq(r, 400)
        data = Data()
        for i in range(n):
            s = list(backbone)
            for pos in r.integers(0, 400, size=12):
                s[pos] = "ACGT"[r.integers(0, 4)]
            for col, v in zip(data.columns, ("lib", f"f{seed}_{i}", "400", "".join(s))):
                col.append(v)
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        return (*build_both(data, cfg, k=21), cfg, data)

    (r1, p1, c1, d1), (r2, p2, c2, d2) = mk(20, 101), mk(12, 202)
    rng = np.random.default_rng(3)
    reads = []
    for i in range(64):
        src = (d1 if i % 2 else d2).sequences[i % 12]
        start = int(rng.integers(0, 300))
        reads.append(src[start : start + 80])
    codes, lens = seqmod.encode_batch(reads, 80)
    return [r1, r2], [p1, p2], [c1, c2], codes, lens


def test_stacked_engine_mesh_matches_the_reference():
    refs, ports, cfgs, codes, lens = stacked_workload()
    ref = RefStacked(refs, cfgs, chunk_size=64, max_len=80, mesh=RM.make_mesh(n_data=8, n_feature=1))
    want = ref.collect_async(ref.align_batch_async(codes, lens))
    eng = StackedEngine(ports, cfgs, CPU, chunk_size=64, max_len=80, mesh=PM.make_mesh(8, 1, CPU8))
    got = eng.collect_async(eng.align_batch_async(codes, lens))
    alone = StackedEngine(ports, cfgs, CPU, chunk_size=64, max_len=80)
    base = alone.collect_async(alone.align_batch_async(codes, lens))
    assert eng.path == "stacked-group" and len(eng.shards) == 8
    for w, g, b in zip(want, got, base):
        for key in ("score", "pass_", "bits"):
            assert np.array_equal(np.asarray(w[key]).astype(np.int64), g[key].astype(np.int64)), key
            assert np.array_equal(b[key], g[key]), key
    with pytest.raises(NotStackable, match="data axis only"):
        StackedEngine(ports, cfgs, CPU, mesh=PM.make_mesh(4, 2, CPU8))


def test_plan_index_placement_matches_the_reference(libs, monkeypatch):
    """tests/test_sharding.py:74's two budgets give the reference's plan;
    no budget takes the device's memory (a card monkeypatched in), or the
    reference's 12 GiB on the CPU."""
    ref_ix, port_ix = libs["narrow"][:2]
    tiny = int((ref_ix.table_hi.nbytes * 4 + ref_ix.class_bits.nbytes / 2) / 0.6) + 1024
    for budget in (16 << 30, tiny):
        want = RM.plan_index_placement(ref_ix, hbm_bytes_per_chip=budget, n_chips=8)
        assert PM.plan_index_placement(port_ix, hbm_bytes_per_chip=budget, n_chips=8) == want
    assert PM.plan_index_placement(port_ix, hbm_bytes_per_chip=tiny, n_chips=8)["feature_shards"] >= 2
    assert PM.plan_index_placement(port_ix, n_chips=8, device=CPU) == RM.plan_index_placement(ref_ix, n_chips=8)

    class Props:
        total_memory = tiny

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    got = PM.plan_index_placement(port_ix, n_chips=8, device=torch.device("cuda", 0))
    assert got == RM.plan_index_placement(ref_ix, hbm_bytes_per_chip=tiny, n_chips=8)


def test_shard_tables_keep_one_copy_per_device(libs):
    """A grid that names one device four times holds one copy of every
    table; the feature split's slices together hold the padded class
    bitsets once, column f on column f's devices."""
    port_ix = libs["groupcls"][1]
    cfg = libs["groupcls"][2]
    one = AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=100, group_probe=False)
    eng = AlignEngine(port_ix, cfg, CPU, chunk_size=CHUNK, max_len=100, mesh=PM.make_mesh(2, 2, [CPU] * 4))
    assert len(eng.shards) == 2 and eng.tables is eng.shards[0][1]
    a, b = eng.shards[0][1], eng.shards[1][1]
    assert all(a[k] is b[k] for k in a if isinstance(a[k], torch.Tensor))
    assert all(x is y for x, y in zip(a["class_slices"], b["class_slices"]))
    cb = one.tables["class_bits"]
    assert "class_bits" not in a and a["class_words"] == 36 == sum(s.shape[1] for s in a["class_slices"])
    assert torch.equal(torch.cat(a["class_slices"], 1)[:, :35], cb)
    assert eng.table_bytes == one.table_bytes + cb.shape[0] * 4  # one padding word per class
    assert eng.shard_table_bytes == [eng.table_bytes] * 2
    # a grid whose second column is another device (meta: shapes only)
    meta = torch.device("meta")
    tables = {"bucket": torch.zeros(4, 8, dtype=torch.int32), "class_bits": torch.arange(15, dtype=torch.int32).reshape(3, 5)}
    rows = PM.shard_tables(tables, PM.make_mesh(2, 2, [CPU, meta, CPU, meta]))
    assert rows[1]["bucket"] is rows[0]["bucket"] and rows[1]["class_words"] == 6
    assert [s.device for s in rows[1]["class_slices"]] == [CPU, meta]
    assert rows[0]["class_slices"][1] is rows[1]["class_slices"][1] and rows[1]["class_slices"][1].shape == (3, 3)
    assert torch.equal(rows[0]["class_slices"][0], torch.tensor([[0, 1, 2], [5, 6, 7], [10, 11, 12]], dtype=torch.int32))
    a = np.arange(15, dtype=np.int32).reshape(3, 5)
    assert np.array_equal(PM.pad_axis(a, 1, 4, fill=-1), RM.pad_axis(a, 1, 4, fill=-1))
    assert PM.pad_axis(a, 0, 3) is a and torch.equal(PM.pad_axis(torch.from_numpy(a), 1, 4, fill=-1),
                                                     torch.from_numpy(RM.pad_axis(a, 1, 4, fill=-1)))
    banded = PM.shard_tables({"class_band": torch.zeros(3, 16, dtype=torch.int32), "class_words": 5},
                             PM.make_mesh(1, 2, [CPU] * 2))
    assert banded[0]["class_words"] == 6 and "class_slices" not in banded[0]


def _cli_args(ws, out, *extra):
    return ["align", "--reference", ws["library"], "--output", str(out), "--input", ws["fastq"],
            "--chunk-size", "32", *extra]


@pytest.mark.parametrize("mesh", ["data=8", "data=4,feature=2"])
def test_cli_mesh_matches_unmeshed_and_the_reference(workspace, mesh, tmp_path, monkeypatch):  # noqa: F811
    base, meshed, ref = tmp_path / "base.tsv", tmp_path / "mesh.tsv", tmp_path / "ref.tsv"
    assert port_cli([*_cli_args(workspace, base), "--device", "cpu"]) == 0
    log = tmp_path / "runlog.jsonl"
    monkeypatch.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
    try:
        assert port_cli([*_cli_args(workspace, meshed, "--mesh", mesh), "--device", "cpu"]) == 0
    finally:
        observability._GLOBAL.close()
        monkeypatch.setattr(observability, "_GLOBAL", None)
    assert ref_cli(_cli_args(workspace, ref, "--mesh", mesh)) == 0
    assert meshed.read_bytes() == base.read_bytes() == ref.read_bytes()
    assert base.read_text().count("\n") == 61
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    m = next(e for e in events if e.get("event") == "mesh")
    n_data, n_feature = (8, 1) if mesh == "data=8" else (4, 2)
    assert (m["n_data"], m["n_feature"], m["devices"]) == (n_data, n_feature, ["cpu"] * (n_data * n_feature))
    eng = next(e for e in events if e.get("event") == "engine")
    assert eng["mesh"] == [n_data, n_feature] and len(eng["shard_table_bytes"]) == n_data
    assert eng["path"] == ("group" if n_feature == 1 else "monocls")


@pytest.mark.parametrize("stack", ["", "1"], ids=["per-library", "stacked"])
def test_cli_mesh_two_libraries(workspace, stack, tmp_path, monkeypatch):  # noqa: F811
    """Two libraries under --mesh data=8, one engine each or stacked
    (NIMBLE_TPU_STACK=1): each library's TSV is the unmeshed run's and the
    reference CLI's."""
    monkeypatch.setenv("NIMBLE_TPU_STACK", stack)
    ref = f"{workspace['library']},{workspace['other_lib']}"
    runs = {}
    for tag, extra in (("base", []), ("mesh", ["--mesh", "data=8"])):
        args = ["align", "--reference", ref, "--output", str(tmp_path / f"{tag}.tsv"), "--input", workspace["fastq"],
                "--chunk-size", "32", *extra]
        assert port_cli([*args, "--device", "cpu"]) == 0
    args = ["align", "--reference", ref, "--output", str(tmp_path / "ref.tsv"), "--input", workspace["fastq"],
            "--chunk-size", "32", "--mesh", "data=8"]
    assert ref_cli(args) == 0
    for suffix, rows in (("library", 60), ("other", 0)):  # the reads come from the first library
        runs = [(tmp_path / f"{tag}.{suffix}.tsv").read_bytes() for tag in ("base", "mesh", "ref")]
        assert runs[0] == runs[1] == runs[2] and runs[0].count(b"\n") == 1 + rows


def test_cli_probe_mono_under_a_feature_split(workspace, tmp_path):  # noqa: F811
    base, meshed, ref = tmp_path / "base.tsv", tmp_path / "mesh.tsv", tmp_path / "ref.tsv"
    assert port_cli([*_cli_args(workspace, base, "--probe", "mono"), "--device", "cpu"]) == 0
    assert port_cli([*_cli_args(workspace, meshed, "--probe", "mono", "--mesh", "data=2,feature=2"),
                     "--device", "cpu"]) == 0
    assert ref_cli(_cli_args(workspace, ref, "--probe", "mono", "--mesh", "data=2,feature=2")) == 0
    assert meshed.read_bytes() == base.read_bytes() == ref.read_bytes()


def test_cli_refuses_a_grid_beyond_the_cards(workspace, tmp_path, capsys, monkeypatch):  # noqa: F811
    """On cuda (one card monkeypatched in) `--mesh data=2` exits 1 naming
    both counts, before any file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "out.tsv"
    assert port_cli(_cli_args(workspace, out, "--mesh", "data=2")) == 1
    assert "needs 2 devices, and 1 is visible: ['cuda:0']" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
