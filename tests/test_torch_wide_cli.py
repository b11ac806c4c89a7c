"""The port's `align` on the other wide paths against the reference's,
differentially: the same inputs through `python -m nimble_tpu align` (JAX on
the CPU) and `python -m nimble_tpu_torch align --device cpu` must give
byte-identical TSVs on groupcls (single-end FASTQ with reads shorter than
k+g-1, and a paired tagged BAM), unbanded monocls (`--probe mono`, and
NIMBLE_TPU_NO_GROUP_PROBE=1 on the group index) and the wide two-choice
fallback (monocls placement over the cap). The banded monocls path's CLI
cases are in tests/test_torch_gband_cli.py."""
import json

import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.barcode import fastq_to_bam_with_barcodes
from nimble_tpu.config import Config
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.align import tables as TT
from tests.test_torch_gband import groupcls_seqs
from tests.test_torch_gband_cli import _both, _decode, _noisy


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The groupcls library (a backbone and 1,112 variants, W = 35) as
    `lib_gcls.json`; 240 single-end reads (some shorter than k+g-1 = 26,
    some with N, half reverse-complemented) and 160 pairs from one fragment
    of one allele as a tagged BAM."""
    root = tmp_path_factory.mktemp("torch_wide_cli")
    seqs = groupcls_seqs()
    n = len(seqs)
    cols = [["bb"] * n, [f"v{i:04d}" for i in range(n)], [str(len(s)) for s in seqs], [_decode(s) for s in seqs]]
    data = {"headers": ["reference_genome", "sequence_name", "nt_length", "sequence"], "columns": cols}
    (root / "lib_gcls.json").write_text(json.dumps([Config().to_dict(), data]))

    rng = np.random.default_rng(6)
    recs = []
    for i in range(240):
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

    b1, r2 = [], []
    cbs = ["AAAACCCCGGGGTTTT", "CCCCAAAATTTTGGGG"]
    for i in range(160):
        s = seqs[rng.integers(0, n)]
        st = int(rng.integers(0, len(s) - 250 + 1))
        frag = _noisy(rng, s[st : st + 250], 0.01)
        bar = cbs[i % 2] + _decode(rng.integers(0, 4, size=12).astype(np.int8))
        b1.append((f"p{i}/1", bar + _decode(frag[:72]), "I" * 100))
        r2.append((f"p{i}/2", _decode(seqmod.revcomp_codes(frag[None, -100:])[0]), "I" * 100))
    write_fastq(str(root / "b1.fastq"), b1)
    write_fastq(str(root / "r2.fastq"), r2)
    (root / "whitelist.txt").write_text("\n".join(cbs) + "\n")
    fastq_to_bam_with_barcodes(str(root / "b1.fastq"), str(root / "r2.fastq"),
                               str(root / "whitelist.txt"), str(root / "pairs.bam"))
    return root


def _engine_path(ws, flags, paired=False):
    """The wide tables the port's engine takes for the library under these
    align flags."""
    import torch

    from nimble_tpu_torch.align.engine import AlignEngine
    from nimble_tpu_torch.align.pipeline import make_runner

    r = make_runner(str(ws / "lib_gcls.json"), "unused.tsv", 0 if "mono" in flags else None)
    eng = AlignEngine(r.index, r.config, torch.device("cpu"), max_len=112, paired=paired)
    return {k for k in ("groupcls_bucket", "mcls_bucket", "stash_vsame", "class_band") if k in eng.tables}


@pytest.mark.parametrize(
    "inputs, flags, env, path",
    [
        (["single.fastq"], [], {}, {"groupcls_bucket"}),
        (["pairs.bam"], [], {}, {"groupcls_bucket"}),
        (["single.fastq"], ["--probe", "mono"], {}, {"mcls_bucket"}),
        (["single.fastq"], [], {"NIMBLE_TPU_NO_GROUP_PROBE": "1"}, {"mcls_bucket"}),
        (["single.fastq"], ["--probe", "mono"], {"cap": 1 << 16}, {"stash_vsame"}),
    ],
    ids=["groupcls-single", "groupcls-paired-bam", "probe-mono", "no-group-probe", "two-choice"],
)
def test_wide_paths_match_reference_cli(ws, monkeypatch, inputs, flags, env, path):
    for k, v in env.items():
        if k == "cap":  # NIMBLE_TPU_MONO_MAX_BYTES, as both packages read it at import
            monkeypatch.setattr(E, "MONO_MAX_BYTES", v)
            monkeypatch.setattr(TT, "MONO_MAX_BYTES", v)
        else:
            monkeypatch.setenv(k, v)
    assert _engine_path(ws, flags, paired=inputs[0].endswith(".bam")) == path
    ref, port = _both(ws, "-".join([inputs[0], *flags, *env]), "lib_gcls.json", inputs, flags)
    assert ref.count(b"\n") > 20  # not vacuous: reads map
    assert port == ref
