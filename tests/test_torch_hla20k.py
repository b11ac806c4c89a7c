"""The `hla20k` configuration (benchmark/configs/hla20k.json: the full HLA
class I library, 20,000 alleles over three paralogous genes) cut to 700
alleles at its 31 : 37 : 32 split, on 1,200-base genes (W = 22): the
library is still too wide for the narrow paths and its classes span too
many pages for the gband bands and the strict class bands, so the group
probe takes groupcls and the per-k-mer probe (`--probe mono`, the
`hla20k-kmer` configuration) monocls over `class_bits`, as the full
library does on the card. The port's `align --device cpu` under each
probe against the benchmark's plain reference (`benchmark/reference/`):
single-end gz FASTQ reads, and 10x pairs in a tagged BAM through `report`,
with 0 lines differing; the run log's stages of the tables (the groupcls
table placed on the engine's device after the copy of its entries, the
monocls table's build inside `tables.host`) and its wire."""
from __future__ import annotations

import contextlib
import io
import json
import shutil

import pytest
import torch

from benchmark import bgzf, check, gen, spec
from benchmark.reference import align as ref
from benchmark.reference import report as ref_report
from nimble_tpu_torch import observability as obs
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import tables as T
from nimble_tpu_torch.align.pipeline import make_runner
from tests.test_torch_host_parity import native_in_both
from tests.test_torch_observability import check_table_stages_and_wire

CUT = (217, 259, 224)  # 700 alleles at 31 : 37 : 32
LENGTH = 1200
READS, PAIRS = 2500, 1500
PROBES = ("group", "mono")
PATH = {"group": "groupcls", "mono": "monocls"}  # the engine path each probe takes on the cut
# one copy of the library a probe: each index persists beside its library
LIB = {"group": "lib.json", "mono": "lib-mono.json"}


def traffic(name: str, n: int) -> dict:
    """The benchmark's traffic mix `name` cut to n reads (or pairs), half
    of them from the library, so that a small job has rows to compare."""
    t = json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())
    return dict(t, reads=n, on_library_share=0.5, cells=40)


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The cut library's JSON, its generated alleles and configuration."""
    native_in_both()
    root = tmp_path_factory.mktemp("torch_hla20k")
    cfg = json.loads((spec.HERE / "configs" / "hla20k.json").read_text())
    lib = cfg["library"]
    lib["length"] = LENGTH
    lib["loci"] = [dict(x, alleles=n) for x, n in zip(lib["loci"], CUT)]
    gen.write_library(root / "lib.json", cfg)
    shutil.copyfile(root / "lib.json", root / LIB["mono"])
    return root, gen.library_alleles(lib), cfg


def port(root, name: str, args) -> list:
    """The port's CLI with a run log of its own -> the log's events."""
    log = root / f"{name}.jsonl"
    old = obs._GLOBAL
    obs._GLOBAL = obs.RunLog(str(log))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_cli(args) == 0
    finally:
        obs._GLOBAL.close()
        obs._GLOBAL = old
    return [json.loads(ln) for ln in log.read_text().splitlines()]


@pytest.fixture(scope="module")
def reads(cut):
    """A sample's single-end reads and their gz FASTQ."""
    root, lib, _ = cut
    r1 = gen.sample_single(gen.rng_of(2**33 + 7), lib, READS, traffic("bulk-se", READS))["r1"]
    gen.write_fastq_gz(root / "r.fastq.gz", r1)
    return r1


@pytest.fixture(scope="module")
def single(cut, reads):
    """probe -> (reads, TSV text, run-log events) of one single-end align
    of the sample's gz FASTQ under that probe, each made once."""
    root = cut[0]
    made = {}

    def run(probe):
        if probe not in made:
            out = root / f"single-{probe}.tsv"
            events = port(root, f"single-{probe}", ["align", "--reference", str(root / LIB[probe]), "--output",
                                                    str(out), "--input", str(root / "r.fastq.gz"), "-c", "2",
                                                    "--device", "cpu", "--probe", probe])
            made[probe] = reads, out.read_text(), events
        return made[probe]

    return run


@pytest.fixture(scope="module")
def ref_index(cut):
    """The plain reference's index of the cut (its group keys serve the
    group probe; the per-k-mer probe reads its k-mers alone)."""
    root, _, cfg = cut
    return ref.Index(str(root / "lib.json"), cfg["k"], cfg["g"], "cpu")


@pytest.mark.parametrize("probe", PROBES)
def test_single_end_takes_its_path_and_equals_the_reference(single, ref_index, probe):
    reads, tsv, events = single(probe)
    assert [e["path"] for e in events if e["event"] == "engine"] == [PATH[probe]]
    assert ref_index.W == 22
    rows = ref.tsv_rows(ref_index, probe, reads, block=1024)
    assert 400 < len(rows) < READS
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), tsv) == 0


def test_the_group_and_per_k_mer_contracts_differ_on_the_cut(reads, ref_index):
    """The reference's rows under the group probe and under the per-k-mer
    probe differ on many lines, so `hla20k-bulk-se` and
    `hla20k-kmer-bulk-se` measure two contracts."""
    group, mono = (check.TSV_HEADER + "".join(ref.tsv_rows(ref_index, p, reads, block=1024)) for p in PROBES)
    assert check.lines_differing(group, mono) > READS // 20


def _stage_end(events, stage):
    return next(e for e in events if e["event"] == "stage_end" and e["stage"] == stage)


@pytest.mark.parametrize("probe", PROBES)
def test_single_end_stages_the_class_id_tables_and_counts_the_wire(cut, single, probe):
    _, _, events = single(probe)
    check_table_stages_and_wire(events, READS, 22)
    copy, host = _stage_end(events, "tables.copy"), _stage_end(events, "tables.host")
    # the index's class_bits beside the groupcls entries (two key words and
    # 2g class ids each; the bucket is built on the engine's device) or
    # beside the monocls table, built on the host
    index = _index(cut, probe)
    if probe == "group":
        tables = index.pair_hi.shape[0] * (2 + 2 * index.pair_g) * 4
    else:
        tables = sum(a.nbytes for a in T.build_monocls_tables(index).values())
    assert copy["bytes"] == host["bytes"] == tables + index.class_bits.nbytes > 22 * 4 * 1000


def test_per_k_mer_stages_the_monocls_build_inside_the_host_tables(cut, single):
    """One `tables.monocls` stage inside `tables.host`, with the build's
    `keys` (every occupied entry of the index), `buckets`, `stash` and the
    table's `bytes`; no `tables.place`."""
    _, _, events = single("mono")
    kinds = [(e["event"], e.get("stage")) for e in events]
    ends = [i for i, k in enumerate(kinds) if k == ("stage_end", "tables.monocls")]
    assert len(ends) == 1 and ("stage_start", "tables.place") not in kinds
    assert kinds.index(("stage_start", "tables.host")) < kinds.index(("stage_start", "tables.monocls"))
    assert ends[0] < kinds.index(("stage_end", "tables.host"))
    index = _index(cut, "mono")
    info = {}
    tables = T.build_monocls_tables(index, info)
    got = events[ends[0]]
    assert {k: got[k] for k in ("keys", "buckets", "stash", "bytes")} == info
    occupied = int(((index.table_vsame >= 0) | (index.table_vdiff >= 0)).sum()
                   + ((index.stash_vsame >= 0) | (index.stash_vdiff >= 0)).sum())
    assert info["keys"] == occupied > 0 and info["buckets"] == tables["mcls_bucket"].shape[0]
    assert tables["mcls_stash_hi"].shape[0] == max(1, info["stash"])
    assert info["bytes"] == sum(a.nbytes for a in tables.values()) == _stage_end(events, "tables.host")["bytes"] \
        - index.class_bits.nbytes
    assert 0 <= got["wall_s"] <= _stage_end(events, "tables.host")["wall_s"]


def test_single_end_places_the_groupcls_table_after_its_copy(cut, single):
    """One `tables.place` stage inside `engine_build`, after `tables.copy`,
    with the bucket's and the stash's bytes and the build's counts."""
    _, _, events = single("group")
    kinds = [(e["event"], e.get("stage")) for e in events]
    places = [i for i, k in enumerate(kinds) if k == ("stage_end", "tables.place")]
    assert len(places) == 1
    assert kinds.index(("stage_end", "tables.copy")) < kinds.index(("stage_start", "tables.place"))
    assert kinds.index(("stage_start", "engine_build")) < places[0] < kinds.index(("stage_end", "engine_build"))
    index = _index(cut, "group")
    place = events[places[0]]
    tables, info = T.build_groupcls_tables({k: torch.from_numpy(v) for k, v in T.groupcls_entries(index).items()})
    assert place["bytes"] == sum(t.numel() * 4 for t in tables.values()) > _stage_end(events, "tables.copy")["bytes"]
    assert {k: place[k] for k in ("entries", "buckets", "rounds", "stash", "bytes")} == info
    assert place["entries"] == index.pair_hi.shape[0] and place["buckets"] == tables["groupcls_bucket"].shape[0]


@pytest.mark.parametrize("probe", PROBES)
def test_tenx_pairs_and_report_equal_the_reference(cut, ref_index, probe):
    root, lib, _ = cut
    t = traffic("10x-pairs", PAIRS)
    p = gen.sample_tenx(gen.rng_of(2**31 + 5), lib, PAIRS, t)
    bgzf.tagged_pairs_bam(root / f"p-{probe}.bam", p["cb"], p["umi"], p["r1"], p["r2"])
    out, counts = root / f"pairs-{probe}.tsv", root / f"pairs-{probe}.counts.tsv"
    events = port(root, f"pairs-{probe}", ["align", "--reference", str(root / LIB[probe]), "--output", str(out),
                                           "--input", str(root / f"p-{probe}.bam"), "-c", "2", "--device", "cpu",
                                           "--probe", probe])
    assert [e["path"] for e in events if e["event"] == "engine"] == [PATH[probe]]
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["report", "-i", str(out), "-o", str(counts)]) == 0
    tags = [(c.tobytes().decode(), u.tobytes().decode()) for c, u in zip(p["cb"], p["umi"])]
    rows = ref.tsv_rows(ref_index, probe, p["r1"], p["r2"], tags, block=1024)
    assert 300 < len(rows) <= PAIRS
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), out.read_text()) == 0
    want = ref_report.counts(rows, t["report_threshold"])
    assert want and check.lines_differing(want, counts.read_text()) == 0


def _index(cut, probe="group"):
    """The cut's index under `probe`, as `align` loads it."""
    return make_runner(str(cut[0] / LIB[probe]), str(cut[0] / "unused.tsv"), 0 if probe == "mono" else None).index


def test_the_cut_refuses_gband_so_the_group_probe_takes_groupcls(cut, single):
    """The classes of three paralogous genes span more pages than the
    robust banding allows: no gband tables, and the groupcls table places."""
    index = _index(cut)
    assert index.bitset_words == 22 and index.has_pairs
    assert T.build_class_bands_robust(index) is None
    assert T.groupband_tables(index) is None
    entries = {k: torch.from_numpy(v) for k, v in T.groupcls_entries(index).items()}
    assert T.build_groupcls_tables(entries)[0] is not None


def test_the_per_k_mer_index_has_no_group_entries_so_monocls_takes_class_bits(cut):
    """`index --probe mono` keeps no group entries; the strict class bands
    are refused, so the monocls table places and ships with `class_bits`."""
    root = cut[0]
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["index", "--reference", str(root / LIB["mono"]), "--probe", "mono"]) == 0
    index = _index(cut, "mono")
    assert index.bitset_words == 22 and not index.has_pairs
    assert T.build_class_bands(index) is None
    arrays, _ = T._host_tables(index)
    assert set(arrays) == set(T.MCLS_KEYS) | {"class_bits"}
