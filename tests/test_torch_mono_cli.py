"""The port's `align --probe mono` against the reference's, differentially:
the same inputs through `python -m nimble_tpu align` (JAX on the CPU) and
`python -m nimble_tpu_torch align --device cpu` must give byte-identical
TSVs, for every library of tests/goldens/ under `--probe mono`, for a
300-feature library (W = 10 words, past the group path's W <= 8) and for a
`kmer_stride = 2` library; and the short-read repair of the group path is
never run for a mono engine."""
import json
import pathlib
import shutil

import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.__main__ import main as port_cli

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"
GOLDEN_LIBS = sorted(p.name for p in GOLD.glob("lib_*.json"))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The golden workload, plus a W = 10 library with reads drawn from it
    and a kmer_stride = 2 copy of lib_base.json. Index sidecars land here,
    so the reference's run builds the mono index and the port's reuses it."""
    root = tmp_path_factory.mktemp("torch_mono_cli")
    for name in GOLDEN_LIBS + ["r1.fastq", "r2.fastq"]:
        shutil.copy(GOLD / name, root / name)

    config, data = json.loads((GOLD / "lib_base.json").read_text())
    (root / "lib_stride2.json").write_text(json.dumps([dict(config, kmer_stride=2), data]))

    rng = np.random.default_rng(21)
    backbone = rng.integers(0, 4, size=240).astype(np.int8)
    seqs = []
    for i in range(300):
        s = backbone.copy()
        pos = rng.integers(0, s.shape[0], size=10)
        s[pos] = rng.integers(0, 4, size=10)
        seqs.append(seqmod.decode(s))
    cols = [["w10"] * 300, [f"allele{i}" for i in range(300)], ["240"] * 300, seqs, [""] * 300]
    (root / "lib_w10.json").write_text(json.dumps([config, {"headers": data["headers"], "columns": cols}]))
    recs = []
    for i in range(400):
        s = seqs[rng.integers(0, 300)]
        st = int(rng.integers(0, 240 - 100))
        r = s[st : st + 100]
        if rng.random() < 0.5:
            r = seqmod.decode(seqmod.revcomp_codes(seqmod.encode(r)[None, :])[0])
        recs.append((f"w{i}", r, "I" * 100))
    write_fastq(str(root / "w10.fastq"), recs)
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


@pytest.mark.parametrize("lib", GOLDEN_LIBS)
def test_golden_library_under_probe_mono_matches_reference(ws, lib):
    ref, port = _both(ws, lib, lib, ["r1.fastq", "r2.fastq"], ["--probe", "mono"])
    assert port == ref


@pytest.mark.parametrize(
    "lib, inputs, flags",
    [
        ("lib_w10.json", ["w10.fastq"], []),
        ("lib_w10.json", ["w10.fastq"], ["--probe", "mono"]),
        ("lib_stride2.json", ["r1.fastq", "r2.fastq"], []),
    ],
    ids=["w10", "w10-probe-mono", "stride2"],
)
def test_mono_path_library_matches_reference(ws, lib, inputs, flags):
    """Libraries that the group path cannot take reach the mono path on the
    default --probe, as in the reference."""
    ref, port = _both(ws, lib + "".join(flags), lib, inputs, flags)
    assert ref.count(b"\n") > 10  # not vacuous: reads map
    assert port == ref


def _short_reads(ws):
    """The golden R1 reads with every third cut to 15 bases: under k-1 = 20,
    where a mono engine without the guard would call the repair, and under
    k+g-1 = 26, where the group path repairs."""
    lines = (ws / "r1.fastq").read_text().splitlines()
    recs = []
    for i in range(0, len(lines), 4):
        s, q = lines[i + 1], lines[i + 3]
        if (i // 4) % 3 == 0:
            s, q = s[:15], q[:15]
        recs.append((lines[i][1:], s, q))
    write_fastq(str(ws / "short.fastq"), recs)
    return "short.fastq"


def test_mono_engine_skips_short_read_repair(ws, monkeypatch):
    """The host repair of reads shorter than k+g-1 belongs to the group path
    (group_g >= 2); a mono engine (group_g = 0) already probes every
    k-window, so patch_short_reads is never called, and the output equals
    the reference's."""
    from nimble_tpu_torch.align import host_probe

    fq = _short_reads(ws)
    calls = []
    real = host_probe.patch_short_reads

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(host_probe, "patch_short_reads", counting)
    ref, port = _both(ws, "short-group", "lib_base.json", [fq])
    assert port == ref and calls  # the group path repairs the short reads

    def refuse(*a, **kw):
        raise AssertionError("patch_short_reads ran on a mono engine")

    monkeypatch.setattr(host_probe, "patch_short_reads", refuse)
    ref, port = _both(ws, "short-mono", "lib_base.json", [fq], ["--probe", "mono"])
    assert port == ref
    assert ref.count(b"\n") > 3
