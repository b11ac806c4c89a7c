"""The port's `align` on wide libraries (the gband path) against the
reference's, differentially: the same inputs through `python -m nimble_tpu
align` (JAX on the CPU, full-format wire) and `python -m nimble_tpu_torch
align --device cpu` (idlist or band-row wire) must give byte-identical TSVs,
for single-end FASTQ, a paired tagged BAM, group_on, intersect_level = 1,
max_hits_to_report = 1 and discard_multiple_matches, with reads shorter than
k+g-1 among them. Also: NIMBLE_TPU_NO_GROUP_PROBE=1 takes both packages
off the group probe, and `--probe mono` takes both onto monocls."""
import json
import pathlib
import shutil

import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.barcode import fastq_to_bam_with_barcodes
from nimble_tpu.config import Config
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.__main__ import main as port_cli
from tests.test_torch_gband import family_seqs

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"

# library file -> Config fields over the defaults
LIBS = {
    "lib_wide.json": {},
    "lib_wide_group_on.json": {"group_on": "lineage"},
    "lib_wide_intersect1.json": {"intersect_level": 1},
    "lib_wide_max_hits_1.json": {"max_hits_to_report": 1},
    "lib_wide_discard_multiple.json": {"discard_multiple_matches": True},
}


def _decode(codes: np.ndarray) -> str:
    return seqmod.decode(codes)


def _noisy(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    codes = codes.copy()
    err = rng.random(codes.shape[0]) < rate
    codes[err] = rng.integers(0, 4, size=int(err.sum()))
    return codes


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The family library (8 x 300 alleles, W = 75) under each Config of
    LIBS, with a `lineage` column of 40 groups; 300 single-end reads (some
    shorter than k+g-1 = 26, some with N); 200 pairs from one fragment of
    one allele, as two FASTQs and as a tagged BAM."""
    root = tmp_path_factory.mktemp("torch_gband_cli")
    seqs = family_seqs()
    n = len(seqs)
    cols = [["fam"] * n, [f"f{i:04d}" for i in range(n)], [str(len(s)) for s in seqs],
            [_decode(s) for s in seqs], [f"lin{i // 60}" for i in range(n)]]
    data = {"headers": ["reference_genome", "sequence_name", "nt_length", "sequence", "lineage"],
            "columns": cols}
    for name, fields in LIBS.items():
        config = Config(**fields).to_dict()
        (root / name).write_text(json.dumps([config, data]))

    rng = np.random.default_rng(5)
    recs = []
    for i in range(300):
        s = seqs[rng.integers(0, n)]
        L = 100 if i % 10 else int(rng.integers(18, 40))
        st = int(rng.integers(0, len(s) - L + 1))
        r = _noisy(rng, s[st : st + L], 0.01)
        if i % 2:
            r = seqmod.revcomp_codes(r[None, :])[0]
        txt = _decode(r)
        if i % 17 == 0:
            txt = txt[:40] + "N" + txt[41:]
        recs.append((f"s{i}", txt, "I" * len(txt)))
    write_fastq(str(root / "single.fastq"), recs)

    r1, r2, b1 = [], [], []
    cbs = ["AAAACCCCGGGGTTTT", "CCCCAAAATTTTGGGG", "GGGGTTTTAAAACCCC"]
    for i in range(200):
        s = seqs[rng.integers(0, n)]
        st = int(rng.integers(0, len(s) - 250 + 1))
        frag = _noisy(rng, s[st : st + 250], 0.01)
        m1 = _decode(frag[:100])
        m2 = _decode(seqmod.revcomp_codes(frag[None, -100:])[0])
        r1.append((f"p{i}/1", m1, "I" * 100))
        r2.append((f"p{i}/2", m2, "I" * 100))
        bar = cbs[i % 3] + _decode(rng.integers(0, 4, size=12).astype(np.int8))
        b1.append((f"p{i}/1", bar + m1[:72], "I" * 100))
    write_fastq(str(root / "r1.fastq"), r1)
    write_fastq(str(root / "r2.fastq"), r2)
    write_fastq(str(root / "b1.fastq"), b1)
    (root / "whitelist.txt").write_text("\n".join(cbs) + "\n")
    fastq_to_bam_with_barcodes(str(root / "b1.fastq"), str(root / "r2.fastq"),
                               str(root / "whitelist.txt"), str(root / "pairs.bam"))
    return root


def _both(ws, name, lib, inputs, flags=()):
    """The reference's and the port's align on the same arguments; returns
    their TSV bytes."""
    outs = []
    for cli, tag, extra in ((ref_cli, "ref", []), (port_cli, "port", ["--device", "cpu"])):
        out = ws / f"{name}.{tag}.tsv"
        rc = cli(["align", "--reference", str(ws / lib), "--output", str(out),
                  "--input", *[str(ws / i) for i in inputs], *flags, *extra])
        assert rc == 0, tag
        outs.append(out.read_bytes())
    return outs


@pytest.mark.parametrize(
    "lib, inputs",
    [
        ("lib_wide.json", ["single.fastq"]),
        ("lib_wide.json", ["pairs.bam"]),
        ("lib_wide_group_on.json", ["single.fastq"]),
        ("lib_wide_intersect1.json", ["r1.fastq", "r2.fastq"]),
        ("lib_wide_max_hits_1.json", ["single.fastq"]),
        ("lib_wide_discard_multiple.json", ["r1.fastq", "r2.fastq"]),
    ],
    ids=["single-fastq", "paired-bam", "group-on", "intersect1-pairs", "max-hits-1", "discard-multiple-pairs"],
)
def test_wide_library_matches_reference(ws, lib, inputs):
    ref, port = _both(ws, lib + "." + inputs[0], lib, inputs)
    assert ref.count(b"\n") > 20  # not vacuous: reads map
    assert port == ref


def test_wide_library_rows_cover_the_wires(ws):
    """The cases above reach all three wires and the short-read repair."""
    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import make_runner

    import torch

    wires = {}
    for lib, paired in (("lib_wide.json", False), ("lib_wide_group_on.json", False),
                        ("lib_wide_intersect1.json", True)):
        r = make_runner(str(ws / lib), "unused.tsv")
        wires[lib] = AlignEngine(r.index, r.config, torch.device("cpu"), max_len=112, paired=paired).wire
    assert wires == {"lib_wide.json": "idlist", "lib_wide_group_on.json": "band",
                     "lib_wide_intersect1.json": "full"}
    lens = [len(l) for l in (ws / "single.fastq").read_text().splitlines()[1::4]]
    assert min(lens) < 26  # reads under k+g-1 reach the host repair


def test_no_group_probe_env_matches_reference(ws, monkeypatch):
    """NIMBLE_TPU_NO_GROUP_PROBE=1 takes the reference off the group probe
    (engine.py:2746), and the port with it: on a narrow golden library with
    noisy reads (1-3% substitutions), where the group and mono probes give
    different TSVs, both CLIs give the same bytes. On the wide library it
    means the reference's monocls path (banded), and the port's."""
    shutil.copy(GOLD / "lib_base.json", ws / "lib_base.json")
    _, data = json.loads((GOLD / "lib_base.json").read_text())
    seqs = [seqmod.encode(s) for s in data["columns"][3]]
    rng = np.random.default_rng(8)
    recs = []
    for i in range(300):
        s = seqs[rng.integers(0, len(seqs))]
        st = int(rng.integers(0, len(s) - 100 + 1))
        r = _noisy(rng, s[st : st + 100], (0.01, 0.02, 0.03)[i % 3])
        recs.append((f"n{i}", _decode(r), "I" * 100))
    write_fastq(str(ws / "noisy.fastq"), recs)
    group_ref, group_port = _both(ws, "noisy-group", "lib_base.json", ["noisy.fastq"])
    assert group_port == group_ref
    monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    ref, port = _both(ws, "noisy-no-group", "lib_base.json", ["noisy.fastq"])
    assert ref != group_ref  # the variable changes the reference's output here
    assert port == ref

    ref, port = _both(ws, "wide-no-group", "lib_wide.json", ["single.fastq"])
    assert ref.count(b"\n") > 20 and port == ref


def test_probe_mono_on_wide_library_is_refused(ws):
    """`--probe mono` on the wide library: the reference's banded monocls
    path, byte for byte."""
    ref, port = _both(ws, "wide-probe-mono", "lib_wide.json", ["single.fastq"], ["--probe", "mono"])
    assert ref.count(b"\n") > 20 and port == ref
