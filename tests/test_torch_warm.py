"""`index --warm` and the NIMBLE_TPU_PROFILE trace in the port, on the CPU.

On a fresh copy of each library, `python -m nimble_tpu_torch index --warm
--device cpu` builds and saves the index and builds the engine the first
`align` would build (the same path and chunk, the run log's `engine`
event), writing the gband sidecar where the path has one. The `align` after
it loads the index and the sidecar and builds neither (the run log's
`index` and `gband_sidecar` events), and its TSV is the reference CLI's
bytes (the goldens, or the reference's `align` on the same inputs), on the
group, mono, gband, groupcls, monocls and wide two-choice paths. The warm
index and sidecar of a wide library hold the arrays of the reference's
`index --warm`. `--warm` on cuda without a card raises before any work. A
profiled `align` writes a torch.profiler trace and the same TSV; an
unprofiled one starts no profiler."""
import glob
import json
import shutil

import numpy as np
import pytest
import torch

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch import observability
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import tables as TT
from tests.test_torch_gband import family_seqs, groupcls_seqs
from tests.test_torch_gband_cli import _noisy
from tests.test_torch_host_parity import GOLD, native_in_both

# case -> (library, index --warm flags, align inputs, align flags, placement
# cap or None, the engine's path, the golden TSV or None for the reference
# CLI's align)
CASES = {
    "group-paired": ("lib_base.json", ["--paired"], ["r1.fastq", "r2.fastq"], [], None, "group",
                     "golden_base.tsv"),
    "group-strand": ("lib_base.json", ["--strand_filter", "fiveprime"], ["r1.fastq"],
                     ["--strand_filter", "fiveprime"], None, "group", "golden_strand_fiveprime.tsv"),
    "mono-chunk": ("lib_base.json", ["--probe", "mono", "--paired", "--chunk-size", "64"],
                   ["r1.fastq", "r2.fastq"], ["--probe", "mono", "--chunk-size", "64"], None, "mono",
                   "golden_probe_mono.tsv"),
    "gband": ("lib_wide.json", [], ["wide.fastq"], [], None, "gband", None),
    "groupcls": ("lib_gcls.json", [], ["gcls.fastq"], [], None, "groupcls", None),
    "monocls": ("lib_gcls.json", ["--probe", "mono"], ["gcls.fastq"], ["--probe", "mono"], None, "monocls", None),
    "two-choice": ("lib_gcls.json", ["--probe", "mono"], ["gcls.fastq"], ["--probe", "mono"], 1 << 16,
                   "two-choice", None),
}


def _library(path, seqs, family: str):
    cols = [[family] * len(seqs), [f"{family}{i:04d}" for i in range(len(seqs))],
            [str(len(s)) for s in seqs], [seqmod.decode(s) for s in seqs]]
    path.write_text(json.dumps([Config().to_dict(), {
        "headers": ["reference_genome", "sequence_name", "nt_length", "sequence"], "columns": cols}]))


def _reads(path, seqs, n: int, seed: int):
    """n single-end 100 bp reads, 1% substitutions, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        s = seqs[rng.integers(0, len(seqs))]
        st = int(rng.integers(0, len(s) - 100 + 1))
        r = _noisy(rng, s[st : st + 100], 0.01)
        if i % 2:
            r = seqmod.revcomp_codes(r[None, :])[0]
        recs.append((f"r{i}", seqmod.decode(r), "I" * 100))
    write_fastq(str(path), recs)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The goldens' base library and reads; the gband family library (8 x
    300 alleles, W = 75) and the groupcls library (W = 35), 160 reads each."""
    native_in_both()
    root = tmp_path_factory.mktemp("torch_warm")
    for f in ("lib_base.json", "r1.fastq", "r2.fastq"):
        shutil.copy(GOLD / f, root / f)
    fam, gcls = family_seqs(), groupcls_seqs()
    _library(root / "lib_wide.json", fam, "fam")
    _library(root / "lib_gcls.json", gcls, "bb")
    _reads(root / "wide.fastq", fam, 160, 5)
    _reads(root / "gcls.fastq", gcls, 160, 6)
    return root


def logged(tmp_path, name, argv):
    """The port's CLI with a run log of its own; returns (exit code, the
    log's events)."""
    log = tmp_path / f"{name}.jsonl"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
        try:
            rc = port_cli(argv)
        finally:
            observability._GLOBAL.close()
    return rc, [json.loads(ln) for ln in log.read_text().splitlines()]


def fresh_copy(inputs, d, lib):
    """A directory holding a copy of the library and no index of it."""
    d.mkdir()
    shutil.copy(inputs / lib, d / lib)
    return d / lib


@pytest.mark.parametrize("case", list(CASES))
def test_warm_then_align_builds_nothing(inputs, tmp_path, monkeypatch, case):
    lib, warm_flags, reads, align_flags, cap, path, golden = CASES[case]
    if cap is not None:  # NIMBLE_TPU_MONO_MAX_BYTES, as both packages read it at import
        monkeypatch.setattr(E, "MONO_MAX_BYTES", cap)
        monkeypatch.setattr(TT, "MONO_MAX_BYTES", cap)
    reads = [str(inputs / r) for r in reads]
    plib = fresh_copy(inputs, tmp_path / "port", lib)
    rc, warm = logged(tmp_path, "warm", ["index", "--reference", str(plib), "--warm", "100", *warm_flags,
                                         "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "port" / f"{lib}.idx.npz").exists()
    out = tmp_path / "port.tsv"
    rc, run = logged(tmp_path, "align", ["align", "--reference", str(plib), "--output", str(out),
                                         "--input", *reads, *align_flags, "--device", "cpu"])
    assert rc == 0
    # warm built the engine the first align builds; the align built nothing
    engines = [{k: e[k] for k in ("path", "chunk_size", "wire")} for e in warm + run if e["event"] == "engine"]
    assert len(engines) == 2 and engines[0] == engines[1] and engines[0]["path"] == path
    assert [e["source"] for e in run if e["event"] == "index"] == ["loaded"]
    sides = [e for e in warm + run if e["event"] == "gband_sidecar"]
    if path == "gband":
        assert [(e["source"], e["written"]) for e in sides] == [("built", True), ("loaded", False)]
    else:
        assert sides == []
    stages = [e["stage"] for e in warm if e["event"] == "stage_end"]
    assert {"engine_build", "warm_step"} <= set(stages) and "warm_kernels" not in stages  # no kernels on the CPU
    if golden is None:
        rlib = fresh_copy(inputs, tmp_path / "ref", lib)
        want = tmp_path / "ref.tsv"
        assert ref_cli(["align", "--reference", str(rlib), "--output", str(want), "--input", *reads,
                        *align_flags]) == 0
        want = want.read_bytes()
    else:
        want = (GOLD / golden).read_bytes()
    assert out.read_bytes() == want and want.count(b"\n") > 10


def test_warm_index_and_sidecar_equal_the_references(inputs, tmp_path, capsys):
    """The port's `index --warm --device cpu` and the reference's `index
    --warm` on the same wide library write the same index and gband sidecar
    arrays, and the port prints what it built."""
    files = {}
    for tag, cli, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
        lib = fresh_copy(inputs, tmp_path / tag, "lib_wide.json")
        assert cli(["index", "--reference", str(lib), "--warm", *extra]) == 0
        files[tag] = [f"{lib}.idx.npz", f"{lib}.idx.npz.gband.single.dense.npz"]
    printed = capsys.readouterr().out
    assert "Warmed the gband engine on cpu for reads of 100 (max_len 112" in printed
    assert "kernel library: none on the CPU" in printed
    assert f"gband sidecar: {files['port'][1]} (built in" in printed and "warm step:" in printed
    for ref, port in zip(files["ref"], files["port"]):
        with np.load(ref, allow_pickle=True) as a, np.load(port, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files) and len(a.files) > 5
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_warm_on_cuda_without_a_card_raises(inputs, tmp_path, monkeypatch):
    """`--warm` means the card unless `--device cpu` is given; without one
    it raises before the index is built, naming `--device cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib = fresh_copy(inputs, tmp_path / "port", "lib_base.json")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["index", "--reference", str(lib), "--warm"])
    assert not (tmp_path / "port" / "lib_base.json.idx.npz").exists()


def _align(inputs, tmp_path, name):
    out = tmp_path / f"{name}.tsv"
    assert port_cli(["align", "--reference", str(inputs / "lib_base.json"), "--output", str(out), "--input",
                     str(inputs / "r1.fastq"), str(inputs / "r2.fastq"), "--device", "cpu"]) == 0
    return out.read_bytes()


def test_profile_writes_a_trace_and_the_same_tsv(inputs, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("NIMBLE_TPU_PROFILE", raising=False)
    plain = _align(inputs, tmp_path, "plain")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("NIMBLE_TPU_PROFILE", str(trace_dir))
    assert _align(inputs, tmp_path, "profiled") == plain == (GOLD / "golden_base.tsv").read_bytes()
    assert f"Profiler trace written to {trace_dir}" in capsys.readouterr().err
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)  # the step's torch ops, on the host


def test_profile_unset_starts_no_profiler(inputs, tmp_path, monkeypatch, capsys):
    import torch.profiler

    def refuse(*a, **kw):
        raise AssertionError("a profiler was started without NIMBLE_TPU_PROFILE")

    monkeypatch.delenv("NIMBLE_TPU_PROFILE", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    assert _align(inputs, tmp_path, "unset") == (GOLD / "golden_base.tsv").read_bytes()
    assert "Profiler trace" not in capsys.readouterr().err
