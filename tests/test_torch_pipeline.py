"""The port's `align` pipeline against the reference's, differentially:
the same inputs through `python -m nimble_tpu align` (JAX on the CPU) and
`python -m nimble_tpu_torch align --device cpu` must give byte-identical
TSVs across the input paths the slice covers — gz FASTQ single-end and
paired, the threaded reader, tagged BAM, --trim, --strand_filter, several
libraries, and the auto read-width rebuild."""
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.__main__ import main as port_cli

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    for script, n in (("make_bench_fastq.py", 3000), ("make_paired_bench.py", 1500)):
        subprocess.run([sys.executable, str(REPO / "scripts" / script), str(root), str(n)],
                       check=True, capture_output=True, cwd=REPO)
    shutil.copy(GOLD / "lib_base.json", root / "lib_base.json")
    bam = root / "tagged.bam"
    assert ref_cli(["fastq-to-bam", "--r1-fastq", str(root / "paired_r1_1500.fastq.gz"),
                    "--r2-fastq", str(root / "paired_r2_1500.fastq.gz"),
                    "--map", str(root / "whitelist.txt"), "--output", str(bam)]) == 0
    return root


def _both(ws, name, args):
    """Run the reference and the port on the same args; return their outputs."""
    ref_out = ws / f"{name}.ref.tsv"
    port_out = ws / f"{name}.port.tsv"
    assert ref_cli(["align", "--output", str(ref_out), *args]) == 0
    assert port_cli(["align", "--output", str(port_out), *args, "--device", "cpu"]) == 0
    return ref_out, port_out


CASES = {
    "se-gz": ["--input", "reads_3000.fastq.gz"],
    "se-threaded": ["--input", "reads_3000.fastq.gz", "-c", "3"],
    "se-trim": ["--input", "reads_3000.fastq.gz", "--trim", "60:0.5"],
    "pe-gz": ["--input", "paired_r1_1500.fastq.gz", "paired_r2_1500.fastq.gz"],
    "bam": ["--input", "tagged.bam"],
    "bam-threeprime": ["--input", "tagged.bam", "--strand_filter", "threeprime"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_matches_reference(ws, case):
    args = ["--reference", str(ws / "hla100.json")]
    for a in CASES[case]:
        args.append(str(ws / a) if (ws / a).exists() else a)
    ref_out, port_out = _both(ws, case, args)
    ref = ref_out.read_bytes()
    assert ref.count(b"\n") > 100  # not vacuous
    assert port_out.read_bytes() == ref


def test_several_libraries_match_reference(ws, monkeypatch):
    """Comma-separated libraries: one engine and one output file each, as
    the reference writes them with stacking off."""
    monkeypatch.setenv("NIMBLE_TPU_NO_STACK", "1")
    config, data = json.loads((ws / "hla100.json").read_text())
    config.update(score_percent=0.8, intersect_level=1)
    (ws / "hla100_strict.json").write_text(json.dumps([config, data]))
    libs = f"{ws / 'hla100.json'},{ws / 'hla100_strict.json'},{ws / 'lib_base.json'}"
    _both(ws, "multi", ["--reference", libs, "--input", str(ws / "tagged.bam")])
    outs = {}
    for lib in ("hla100", "hla100_strict", "lib_base"):
        # the library name goes before the whole extension: multi.<lib>.ref.tsv
        outs[lib] = (ws / f"multi.{lib}.ref.tsv").read_bytes()
        assert (ws / f"multi.{lib}.port.tsv").read_bytes() == outs[lib], lib
    # the two HLA libraries hit and differ; lib_base shares no k-mers with them
    assert outs["hla100"].count(b"\n") > 100 and outs["hla100"] != outs["hla100_strict"]
    assert outs["lib_base"].count(b"\n") == 1


def test_read_width_rebuild_matches_reference(ws):
    """Reads longer than the first batch's width rebuild the engine wider
    mid-run; small reader batches make the rebuild happen."""
    from nimble_tpu.align.pipeline import align_files as ref_align
    from nimble_tpu_torch.align.pipeline import align_files as port_align
    import torch

    rng = np.random.default_rng(3)
    recs = []
    with open(ws / "hla100.json") as f:
        lib = f.read()
    seqs = [s for s in lib.split('"') if len(s) == 3000 and set(s) <= set("ACGT")]
    for i, n in enumerate([40] * 16 + [150] * 16 + [90] * 8):
        s = seqs[rng.integers(0, len(seqs))]
        st = int(rng.integers(0, len(s) - n))
        recs.append((f"r{i}", s[st : st + n], "I" * n))
    fq = ws / "grow.fastq"
    write_fastq(str(fq), recs)
    ref_out, port_out = ws / "grow.ref.tsv", ws / "grow.port.tsv"
    assert ref_align(str(ws / "hla100.json"), str(ref_out), [str(fq)], batch_records=8) == 0
    assert port_align(str(ws / "hla100.json"), str(port_out), [str(fq)], torch.device("cpu"),
                      batch_records=8) == 0
    assert ref_out.read_bytes().count(b"\n") > 20
    assert port_out.read_bytes() == ref_out.read_bytes()
