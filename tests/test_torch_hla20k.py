"""The `hla20k` configuration (benchmark/configs/hla20k.json: the full HLA
class I library, 20,000 alleles over three paralogous genes) cut to 700
alleles at its 31 : 37 : 32 split, on 1,200-base genes (W = 22): the
library is still too wide for the narrow paths and its classes span too
many pages for the gband bands, so the group probe takes groupcls, as the
full library does on the card. The port's `align --device cpu --probe
group` against the benchmark's plain reference (`benchmark/reference/`):
single-end gz FASTQ reads, and 10x pairs in a tagged BAM through `report`,
with 0 lines differing; the run log's stages of the tables (the groupcls
table placed on the engine's device after the copy of its entries) and its
wire."""
from __future__ import annotations

import contextlib
import io
import json

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
def single(cut):
    """One single-end align of a sample's gz FASTQ -> (reads, TSV text,
    run-log events)."""
    root, lib, _ = cut
    reads = gen.sample_single(gen.rng_of(2**33 + 7), lib, READS, traffic("bulk-se", READS))["r1"]
    gen.write_fastq_gz(root / "r.fastq.gz", reads)
    events = port(root, "single", ["align", "--reference", str(root / "lib.json"), "--output",
                                   str(root / "single.tsv"), "--input", str(root / "r.fastq.gz"), "-c", "2",
                                   "--device", "cpu", "--probe", "group"])
    return reads, (root / "single.tsv").read_text(), events


def test_single_end_takes_groupcls_and_equals_the_reference(cut, single):
    root, _, cfg = cut
    reads, tsv, events = single
    assert [e["path"] for e in events if e["event"] == "engine"] == ["groupcls"]
    ix = ref.Index(str(root / "lib.json"), cfg["k"], cfg["g"], "cpu")
    assert ix.W == 22
    rows = ref.tsv_rows(ix, "group", reads, block=1024)
    assert 400 < len(rows) < READS
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), tsv) == 0


def _stage_end(events, stage):
    return next(e for e in events if e["event"] == "stage_end" and e["stage"] == stage)


def test_single_end_stages_the_class_id_tables_and_counts_the_wire(cut, single):
    _, _, events = single
    check_table_stages_and_wire(events, READS, 22)
    copy, host = _stage_end(events, "tables.copy"), _stage_end(events, "tables.host")
    # the groupcls entries (two key words and 2g class ids each) and the
    # index's class_bits; the bucket is built on the engine's device
    index = _index(cut)
    entries = index.pair_hi.shape[0] * (2 + 2 * index.pair_g) * 4
    assert copy["bytes"] == host["bytes"] == entries + index.class_bits.nbytes > 22 * 4 * 1000


def test_single_end_places_the_groupcls_table_after_its_copy(cut, single):
    """One `tables.place` stage inside `engine_build`, after `tables.copy`,
    with the bucket's and the stash's bytes and the build's counts."""
    _, _, events = single
    kinds = [(e["event"], e.get("stage")) for e in events]
    places = [i for i, k in enumerate(kinds) if k == ("stage_end", "tables.place")]
    assert len(places) == 1
    assert kinds.index(("stage_end", "tables.copy")) < kinds.index(("stage_start", "tables.place"))
    assert kinds.index(("stage_start", "engine_build")) < places[0] < kinds.index(("stage_end", "engine_build"))
    index = _index(cut)
    place = events[places[0]]
    tables, info = T.build_groupcls_tables({k: torch.from_numpy(v) for k, v in T.groupcls_entries(index).items()})
    assert place["bytes"] == sum(t.numel() * 4 for t in tables.values()) > _stage_end(events, "tables.copy")["bytes"]
    assert {k: place[k] for k in ("entries", "buckets", "rounds", "stash", "bytes")} == info
    assert place["entries"] == index.pair_hi.shape[0] and place["buckets"] == tables["groupcls_bucket"].shape[0]


def test_tenx_pairs_and_report_equal_the_reference(cut):
    root, lib, cfg = cut
    t = traffic("10x-pairs", PAIRS)
    p = gen.sample_tenx(gen.rng_of(2**31 + 5), lib, PAIRS, t)
    bgzf.tagged_pairs_bam(root / "p.bam", p["cb"], p["umi"], p["r1"], p["r2"])
    out, counts = root / "pairs.tsv", root / "pairs.counts.tsv"
    events = port(root, "pairs", ["align", "--reference", str(root / "lib.json"), "--output", str(out),
                                  "--input", str(root / "p.bam"), "-c", "2", "--device", "cpu", "--probe", "group"])
    assert [e["path"] for e in events if e["event"] == "engine"] == ["groupcls"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["report", "-i", str(out), "-o", str(counts)]) == 0
    ix = ref.Index(str(root / "lib.json"), cfg["k"], cfg["g"], "cpu")
    tags = [(c.tobytes().decode(), u.tobytes().decode()) for c, u in zip(p["cb"], p["umi"])]
    rows = ref.tsv_rows(ix, "group", p["r1"], p["r2"], tags, block=1024)
    assert 300 < len(rows) <= PAIRS
    assert check.lines_differing(check.TSV_HEADER + "".join(rows), out.read_text()) == 0
    want = ref_report.counts(rows, t["report_threshold"])
    assert want and check.lines_differing(want, counts.read_text()) == 0


def _index(cut):
    """The cut's index, as `align` loads it."""
    return make_runner(str(cut[0] / "lib.json"), str(cut[0] / "unused.tsv")).index


def test_the_cut_refuses_gband_so_the_group_probe_takes_groupcls(cut, single):
    """The classes of three paralogous genes span more pages than the
    robust banding allows: no gband tables, and the groupcls table places."""
    index = _index(cut)
    assert index.bitset_words == 22 and index.has_pairs
    assert T.build_class_bands_robust(index) is None
    assert T.groupband_tables(index) is None
    entries = {k: torch.from_numpy(v) for k, v in T.groupcls_entries(index).items()}
    assert T.build_groupcls_tables(entries)[0] is not None
