"""`align --resume` of the port (`--device cpu`), held to one uninterrupted
run of the same command and to the reference.

* tests/test_observability.py:58's resume: a crafted sidecar and a garbage
  tail resume to the full bytes, the sidecar goes on success, a legacy
  `batches_done` sidecar and a sidecar of another span are refused (rc 1).
* A hard kill (the `emit_out` wrapper of tests/test_multiproc_align.py:170:
  os._exit(9) right after the n-th span's rows, before its checkpoint) in a
  process of its own, then `--resume`, on single-end FASTQ, tagged BAM
  pairs, two libraries with one engine each (on the group path and under
  `--probe mono`), `--probe mono`, gband and groupcls: each gives the
  uninterrupted run's bytes and takes the named path.
* Across packages: the reference killed at the same emit count writes a
  sidecar with the same keys (the port adds `span`) and the same cursor and
  bytes as the port's, and the port's `--resume` of the reference's partial
  output gives the reference's full TSV.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.config import Config
from nimble_tpu.io.fasta import write_fasta
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch import observability
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align.pipeline import append_path_string
from tests.test_torch_gband import family_seqs, groupcls_seqs
from tests.test_torch_host_parity import native_in_both

REPO = pathlib.Path(__file__).resolve().parents[1]
SPAN = 256  # --chunk-size: the span of every run here

# the port's CLI in a process of its own, where jax and the JAX package
# cannot be imported. KILL_AFTER_EMITS=n ends it with os._exit(9) right
# after the n-th LibraryRunner.emit_out: the span's rows are written (maybe
# not flushed), its checkpoint is not, and nothing is cleaned up
PORT_RUNNER = """
import os, sys
sys.modules["jax"] = None
sys.modules["nimble_tpu"] = None
import nimble_tpu_torch.align.pipeline as P
kill = int(os.environ.get("KILL_AFTER_EMITS", "0") or 0)
if kill:
    emit_out = P.LibraryRunner.emit_out
    calls = [0]
    def wrapped(self, out, batch):
        n = emit_out(self, out, batch)
        calls[0] += 1
        if calls[0] >= kill:
            os._exit(9)
        return n
    P.LibraryRunner.emit_out = wrapped
from nimble_tpu_torch.__main__ import main
sys.exit(main(sys.argv[1:]))
"""

# the same kill around the reference's CLI, on JAX's CPU backend
REF_RUNNER = """
import jax, os, sys
jax.config.update("jax_platforms", "cpu")
import nimble_tpu.align.pipeline as P
kill = int(os.environ["KILL_AFTER_EMITS"])
emit_out = P.LibraryRunner.emit_out
calls = [0]
def wrapped(self, out, batch):
    n = emit_out(self, out, batch)
    calls[0] += 1
    if calls[0] >= kill:
        os._exit(9)
    return n
P.LibraryRunner.emit_out = wrapped
from nimble_tpu.__main__ import main
sys.exit(main(sys.argv[1:]))
"""


def run_proc(args, env=None, wait=True, runner=PORT_RUNNER):
    """The CLI in a subprocess with `env` over os.environ; returns (rc,
    output) or, with wait=False, the Popen."""
    full = {**os.environ, "PYTHONPATH": str(REPO), **(env or {})}
    p = subprocess.Popen([sys.executable, "-c", runner, *args], env=full, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if not wait:
        return p
    out, _ = p.communicate(timeout=600)
    return p.returncode, out.decode()


def port_in_process(args, capsys, monkeypatch, log=None):
    """The port's CLI in this process on the CPU; returns (rc, its stdout
    then its stderr, the run log's events when `log` is given)."""
    capsys.readouterr()
    if log is not None:
        monkeypatch.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
    try:
        rc = port_cli([*args, "--device", "cpu"])
    finally:
        if log is not None:
            observability._GLOBAL.close()
            monkeypatch.setattr(observability, "_GLOBAL", None)
    events = [json.loads(ln) for ln in log.read_text().splitlines()] if log is not None else None
    captured = capsys.readouterr()
    return rc, captured.out + captured.err, events


def outputs(out: str, reference: str):
    libs = reference.split(",")
    if len(libs) == 1:
        return [out]
    return [append_path_string(out, "." + os.path.splitext(os.path.basename(lib))[0]) for lib in libs]


def read_all(paths):
    return [open(p, "rb").read() for p in paths]


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _reads_from(seqs, n, seed, ln=100, short_every=0):
    """n reads of ln bases (every short_every-th cut to 20-39), a third
    reverse-complemented, drawn from string sequences."""
    rng = np.random.default_rng(seed)
    recs = []
    for r in range(n):
        s = seqs[r % len(seqs)]
        m = int(rng.integers(20, 40)) if short_every and r % short_every == 0 else ln
        pos = int(rng.integers(0, len(s) - m))
        read = s[pos : pos + m]
        if r % 3 == 0:
            read = read[::-1].translate(str.maketrans("ACGT", "TGCA"))
        recs.append((f"r{r}", read, "I" * m))
    return recs


def _write_lib(root, name, seqs, names):
    data = {"headers": ["reference_genome", "sequence_name", "nt_length", "sequence"],
            "columns": [["g"] * len(seqs), names, [str(len(s)) for s in seqs], seqs]}
    (root / name).write_text(json.dumps([Config().to_dict(), data]))
    return str(root / name)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """tests/test_multiproc_align.py's workspace: 8 alleles of an 800 bp
    backbone and 4,000 single-end 100 bp reads (16 spans of 256), plus a
    second library of 8 other alleles, 2,000 tagged BAM pairs from both,
    the family library (8 x 300 alleles, W = 75: gband) and the groupcls
    library (W = 35) with 1,024 reads each (some shorter than k+g-1)."""
    native_in_both()
    root = tmp_path_factory.mktemp("torch_resume")
    rng = np.random.default_rng(23)
    backbone = rand_seq(rng, 800)
    alleles = []
    for i in range(8):
        s = list(backbone)
        s[60 + i * 90 : 60 + i * 90 + 45] = list(rand_seq(rng, 45))
        alleles.append((f"al{i}", "".join(s)))
    write_fasta(str(root / "lib.fasta"), alleles)
    assert port_cli(["generate", "--file", str(root / "lib.fasta"), "--output_path", str(root / "library.json")]) == 0
    backbone2 = rand_seq(rng, 700)
    others = [backbone2[: 50 + 70 * i] + rand_seq(rng, 30) + backbone2[80 + 70 * i :] for i in range(8)]
    _write_lib(root, "library2.json", others, [f"b{i}" for i in range(8)])
    write_fastq(str(root / "reads.fastq"), _reads_from([s for _, s in alleles] + others, 4000, 3))

    from nimble_tpu.barcode import fastq_to_bam_with_barcodes

    cbs = ["AAAACCCCGGGGTTTT", "CCCCAAAATTTTGGGG"]
    src = [s for _, s in alleles] + others
    b1, r2 = [], []
    for i in range(2000):
        s = src[i % len(src)]
        st = int(rng.integers(0, len(s) - 250))
        frag = s[st : st + 250]
        bar = cbs[i % 2] + rand_seq(rng, 12)
        b1.append((f"p{i}/1", bar + frag[:72], "I" * 100))
        r2.append((f"p{i}/2", frag[-100:][::-1].translate(str.maketrans("ACGT", "TGCA")), "I" * 100))
    write_fastq(str(root / "b1.fastq"), b1)
    write_fastq(str(root / "b2.fastq"), r2)
    (root / "whitelist.txt").write_text("\n".join(cbs) + "\n")
    fastq_to_bam_with_barcodes(str(root / "b1.fastq"), str(root / "b2.fastq"), str(root / "whitelist.txt"),
                               str(root / "pairs.bam"))

    for name, seqs in (("wide", family_seqs()), ("gcls", groupcls_seqs())):
        txt = [seqmod.decode(s) for s in seqs]
        _write_lib(root, f"lib_{name}.json", txt, [f"f{i:04d}" for i in range(len(txt))])
        write_fastq(str(root / f"{name}.fastq"), _reads_from(txt, 1024, 7, short_every=13))
    return root


# case -> (libraries, inputs, flags, env, emits before the kill, the engine path)
KILL_CASES = {
    "fastq": ("library.json", ["reads.fastq"], [], {}, 6, "group"),
    "bam-pairs": ("library.json", ["pairs.bam"], [], {}, 4, "group"),
    "two-libraries": ("library.json,library2.json", ["reads.fastq"], [], {}, 9, "group"),
    "two-libraries-probe-mono": ("library.json,library2.json", ["reads.fastq"], ["--probe", "mono"], {}, 9,
                                 "mono"),
    "probe-mono": ("library.json", ["reads.fastq"], ["--probe", "mono"], {}, 5, "mono"),
    "gband": ("lib_wide.json", ["wide.fastq"], [], {}, 2, "gband"),
    "groupcls": ("lib_gcls.json", ["gcls.fastq"], [], {}, 2, "groupcls"),
}


@pytest.mark.parametrize("case", list(KILL_CASES))
def test_kill_then_resume_gives_the_uninterrupted_bytes(ws, case, tmp_path, capsys, monkeypatch):
    libs, inputs, flags, env, kill, path = KILL_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = ",".join(str(ws / lib) for lib in libs.split(","))
    base = ["align", "--reference", ref, "--input", *[str(ws / i) for i in inputs], "--chunk-size", str(SPAN),
            *flags]
    full = str(tmp_path / "full.tsv")
    rc, _, events = port_in_process([*base, "--output", full], capsys, monkeypatch, tmp_path / "full.jsonl")
    assert rc == 0
    assert [e["path"] for e in events if e["event"] == "engine"] == [path] * len(libs.split(","))
    want = read_all(outputs(full, ref))
    assert all(w.count(b"\n") > 20 for w in want)  # not vacuous: reads map

    out = str(tmp_path / "out.tsv")
    rc, log = run_proc([*base, "--output", out, "--device", "cpu"], {**env, "KILL_AFTER_EMITS": str(kill)})
    assert rc == 9, log
    sidecar = out + ".progress.json"
    prog = json.load(open(sidecar))
    n_libs = len(libs.split(","))
    # the kill landed after the kill-th emit, before its span's checkpoint
    assert prog["reads_done"] == SPAN * ((kill - 1) // n_libs) > 0
    assert prog["span"] == SPAN
    assert all(open(p, "rb").read()[: prog["bytes_written"][p]] == w[: prog["bytes_written"][p]]
               for p, w in zip(outputs(out, ref), want))

    rc, stdout, events = port_in_process([*base, "--output", out, "--resume"], capsys, monkeypatch,
                                         tmp_path / "resume.jsonl")
    assert rc == 0
    n = int(re.search(r"Resuming from read (\d+)", stdout).group(1))
    assert n == prog["reads_done"] and n % SPAN == 0
    assert [e["path"] for e in events if e["event"] == "engine"][:1] == [path]
    assert read_all(outputs(out, ref)) == want
    assert not os.path.exists(sidecar)


def test_crafted_sidecar_resume_and_refusals(ws, tmp_path, capsys, monkeypatch):
    """tests/test_observability.py:58: a sidecar claiming 48 reads done
    and a garbage tail resume to the full bytes; the sidecar is removed on
    success; a legacy (batch-cursor) sidecar is refused with rc 1, and so is
    one written with another span, naming both spans."""
    rng = np.random.default_rng(3)
    seq = rand_seq(rng, 500)
    write_fasta(str(tmp_path / "lib.fasta"), [("feat1", seq)])
    lib = str(tmp_path / "lib.json")
    assert port_cli(["generate", "--file", str(tmp_path / "lib.fasta"), "--output_path", lib]) == 0
    write_fastq(str(tmp_path / "reads.fastq"), [(f"r{i}", seq[i % 400 : i % 400 + 80], "I" * 80) for i in range(100)])
    out = str(tmp_path / "out.tsv")
    base = ["align", "--reference", lib, "--input", str(tmp_path / "reads.fastq"), "--output", out,
            "--chunk-size", "16"]
    assert port_in_process(base, capsys, monkeypatch)[0] == 0
    full = open(out).read()
    assert not os.path.exists(out + ".progress.json")

    # every read aligns here, so rows == reads; +1 line for the header
    byte_off = len("\n".join(full.split("\n")[: 48 + 1]).encode()) + 1
    with open(out + ".progress.json", "w") as f:
        json.dump({"reads_done": 48, "rows_written": {out: 48}, "bytes_written": {out: byte_off}}, f)
    with open(out, "a") as f:
        f.write("GARBAGE\tROW\n")
    rc, stdout, _ = port_in_process([*base, "--resume"], capsys, monkeypatch)
    assert rc == 0 and "Resuming from read 48" in stdout
    assert open(out).read() == full
    assert not os.path.exists(out + ".progress.json")

    with open(out + ".progress.json", "w") as f:
        json.dump({"batches_done": 3, "rows_written": {out: 48}}, f)
    assert port_in_process([*base, "--resume"], capsys, monkeypatch)[0] == 1

    with open(out + ".progress.json", "w") as f:
        json.dump({"reads_done": 48, "rows_written": {out: 48}, "bytes_written": {out: byte_off}, "span": 32}, f)
    rc, err, _ = port_in_process([*base, "--resume"], capsys, monkeypatch)
    assert rc == 1
    assert "span of 32 reads" in err and "span is 16" in err
    assert os.path.exists(out + ".progress.json")  # kept for a resume with the right span


def test_resume_across_packages(ws, tmp_path, capsys, monkeypatch):
    """The reference (JAX on the CPU) and the port, each killed after the
    same emit count, leave sidecars with the reference's keys (the port adds
    `span`) and the same cursor, rows and bytes; the port's --resume of the
    reference's partial output gives the reference's full TSV."""
    args = ["align", "--reference", str(ws / "library.json"), "--input", str(ws / "reads.fastq"),
            "--chunk-size", str(SPAN)]
    full = str(tmp_path / "ref_full.tsv")
    assert ref_cli([*args, "--output", full]) == 0
    sidecars = {}
    for tag, runner, extra in (("ref", REF_RUNNER, []), ("port", PORT_RUNNER, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        rc, log = run_proc([*args, "--output", str(d / "out.tsv"), *extra],
                           {"KILL_AFTER_EMITS": "7", "JAX_PLATFORMS": "cpu"}, runner=runner)
        assert rc == 9, log
        sidecars[tag] = json.load(open(d / "out.tsv.progress.json"))
    ref_prog, port_prog = sidecars["ref"], sidecars["port"]
    assert set(port_prog) == set(ref_prog) | {"span"}
    assert port_prog["reads_done"] == ref_prog["reads_done"] == 6 * SPAN
    assert list(port_prog["rows_written"].values()) == list(ref_prog["rows_written"].values())
    assert list(port_prog["bytes_written"].values()) == list(ref_prog["bytes_written"].values())

    out = str(tmp_path / "ref" / "out.tsv")
    rc, stdout, _ = port_in_process([*args, "--output", out, "--resume"], capsys, monkeypatch)
    assert rc == 0 and f"Resuming from read {6 * SPAN}" in stdout
    assert open(out, "rb").read() == open(full, "rb").read()
    assert not os.path.exists(out + ".progress.json")
