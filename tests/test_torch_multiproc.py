"""Multi-process `align` worlds of the port (`--device cpu`), after
tests/test_multiproc_align.py: processes under NIMBLE_TPU_NUM_PROCS /
NIMBLE_TPU_PROC_ID each align the spans they own into a shard, and process
0 merges the shards; the merged TSV must be byte-identical to one process's
run and to the reference's, with no shard or sidecar file left.

Process 0 runs in this process and the others in processes of their own,
all at once. Also: the decode-sharded world (-c 2) parses at most 0.7 of
the reads in each process; a killed shard resumes; a three-process world
on BAM pairs; processes that disagree on the span are refused instead of
merged wrongly. The coordinated world (JAX_COORDINATOR_ADDRESS) is
tests/test_torch_coordinator.py's.
"""
import os
import re

import pytest

from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu_torch.__main__ import main as port_cli
from tests.test_torch_resume import SPAN, port_in_process, run_proc, ws  # noqa: F401  (ws: the fixture)

N_READS = 4000


def world_env(pid: int, n: int, **extra):
    return {"NIMBLE_TPU_NUM_PROCS": str(n), "NIMBLE_TPU_PROC_ID": str(pid), **extra}


def run_world(args, n, capsys, monkeypatch, env=None, others=None):
    """Processes 1..n-1 in subprocesses (args `others` when given), process
    0 here, all started together; returns (rc 0, output 0, [(rc, output)]
    of the others)."""
    procs = [run_proc([*(others or args), "--device", "cpu"], world_env(p, n, **(env or {})), wait=False)
             for p in range(1, n)]
    for k, v in world_env(0, n, **(env or {})).items():
        monkeypatch.setenv(k, v)
    try:
        rc0, out0, _ = port_in_process(args, capsys, monkeypatch)
    finally:
        for k in world_env(0, n, **(env or {})):
            monkeypatch.delenv(k)
    rest = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        rest.append((p.returncode, out.decode()))
    return rc0, out0, rest


def leftovers(d):
    return sorted(f for f in os.listdir(d) if ".shard" in f or f.endswith(".progress.json"))


@pytest.fixture(scope="module")
def singles(ws, tmp_path_factory):  # noqa: F811
    """One process's TSV of the reads and of the BAM pairs, each equal to
    the reference's single run."""
    d = tmp_path_factory.mktemp("singles")
    got = {}
    for name, inp in (("reads", "reads.fastq"), ("pairs", "pairs.bam")):
        args = ["align", "--reference", str(ws / "library.json"), "--input", str(ws / inp),
                "--chunk-size", str(SPAN)]
        assert port_cli([*args, "--output", str(d / f"{name}.port.tsv"), "--device", "cpu"]) == 0
        assert ref_cli([*args, "--output", str(d / f"{name}.ref.tsv")]) == 0
        got[name] = (d / f"{name}.port.tsv").read_bytes()
        assert got[name] == (d / f"{name}.ref.tsv").read_bytes(), name
        assert got[name].count(b"\n") > 1000
    return got


def _args(ws, inp, out, *extra):  # noqa: F811
    return ["align", "--reference", str(ws / "library.json"), "--input", str(ws / inp), "--output", str(out),
            "--chunk-size", str(SPAN), *extra]


def test_two_process_world_equals_a_single_run(ws, singles, tmp_path, capsys, monkeypatch):  # noqa: F811
    rc0, out0, [(rc1, out1)] = run_world(_args(ws, "reads.fastq", tmp_path / "merged.tsv"), 2, capsys, monkeypatch)
    assert rc1 == 0, out1
    assert rc0 == 0
    assert f"Aligned {N_READS} read(-pair)s" in out0
    assert (tmp_path / "merged.tsv").read_bytes() == singles["reads"]
    assert leftovers(tmp_path) == []


def test_decode_sharded_world(ws, singles, tmp_path, capsys, monkeypatch):  # noqa: F811
    """With -c 2 each process parses only the reader batches that touch its
    own spans (ThreadedFastqReader.set_skip). Reader batches of half a span
    lie inside one span each, so they can be skipped."""
    from nimble_tpu_torch.io import native

    assert native.available()
    rc0, out0, [(rc1, out1)] = run_world(_args(ws, "reads.fastq", tmp_path / "merged.tsv", "-c", "2"), 2,
                                         capsys, monkeypatch, env={"NIMBLE_TPU_READER_BATCH": str(SPAN // 2)})
    assert rc0 == 0 and rc1 == 0, out1
    for out in (out0, out1):
        m = re.search(r"Decode shard: parsed (\d+) skipped (\d+)", out)
        assert m, out
        parsed, skipped = int(m.group(1)), int(m.group(2))
        assert parsed + skipped == N_READS
        assert parsed <= 0.7 * N_READS, f"parsed {parsed} of {N_READS}"
    assert (tmp_path / "merged.tsv").read_bytes() == singles["reads"]
    assert leftovers(tmp_path) == []


def test_killed_shard_resumes(ws, singles, tmp_path, capsys, monkeypatch):  # noqa: F811
    """Process 1 runs to its end; process 0 is killed after 2 of its spans
    (its shard's sidecar survives), then resumed: it truncates its shard,
    goes on and merges to the single run's bytes."""
    args = _args(ws, "reads.fastq", tmp_path / "merged.tsv")
    rc1, out1 = run_proc([*args, "--device", "cpu"], world_env(1, 2))
    assert rc1 == 0, out1
    rc, out = run_proc([*args, "--device", "cpu"], world_env(0, 2, KILL_AFTER_EMITS="3"))
    assert rc == 9, out
    assert (tmp_path / "merged.tsv.shard0.progress.json").exists()
    assert not (tmp_path / "merged.tsv").exists()
    for k, v in world_env(0, 2).items():
        monkeypatch.setenv(k, v)
    rc0, out0, _ = port_in_process([*args, "--resume"], capsys, monkeypatch)
    assert rc0 == 0
    # process 0 owns spans 0, 2, 4, ...: killed within its third, so its
    # checkpoint sits after span 2
    assert f"Resuming from read {3 * SPAN}" in out0
    assert f"Aligned {N_READS} read(-pair)s" in out0
    assert (tmp_path / "merged.tsv").read_bytes() == singles["reads"]
    assert leftovers(tmp_path) == []


def test_three_process_world_on_bam_pairs(ws, singles, tmp_path, capsys, monkeypatch):  # noqa: F811
    """The BAM reader has no set_skip: ownership alone shards the work."""
    rc0, out0, rest = run_world(_args(ws, "pairs.bam", tmp_path / "merged.tsv"), 3, capsys, monkeypatch)
    assert [rc for rc, _ in rest] == [0, 0], rest
    assert rc0 == 0
    assert (tmp_path / "merged.tsv").read_bytes() == singles["pairs"]
    assert leftovers(tmp_path) == []


def test_world_with_different_spans_is_refused(ws, tmp_path, capsys, monkeypatch):  # noqa: F811
    """Process 1 runs with another --chunk-size, so its span indices mean
    other reads: process 0 exits nonzero, names both spans and writes no
    merged file."""
    args = _args(ws, "reads.fastq", tmp_path / "merged.tsv")
    other = [*args[:-1], str(SPAN // 2)]
    rc0, err, [(rc1, out1)] = run_world(args, 2, capsys, monkeypatch, others=other)
    assert rc1 == 0, out1
    assert rc0 == 1
    assert f"{{0: {SPAN}, 1: {SPAN // 2}}}" in err
    assert not (tmp_path / "merged.tsv").exists()
