"""The 18 align goldens, byte-identical through the port's CLI
(`python -m nimble_tpu_torch align --device cpu`): the 15 group-path cases
and the 3 that pin the mono path (`probe_mono` under `--probe mono`;
`mismatch1` and `mismatch2`, whose indexes have no group entries). Mirrors
tests/test_goldens.py; `legacy_filters` is shared host code."""
import pathlib
import shutil

import pytest
import torch

from nimble_tpu_torch.__main__ import main as cli

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"

FLAG_CASES = {
    "probe_mono": ["--probe", "mono"],
    "strand_fiveprime": ["--strand_filter", "fiveprime"],
}
SINGLE_END_CASES = {"strand_fiveprime"}


def golden_cases():
    return sorted(
        p.stem[len("golden_"):]
        for p in GOLD.glob("golden_*.tsv")
        if p.stem != "golden_legacy_filters"
    )


@pytest.fixture(scope="module")
def staging(tmp_path_factory):
    """Copy the committed workload into tmp so index sidecars never land in
    the repo tree."""
    root = tmp_path_factory.mktemp("torch_goldens")
    for p in GOLD.glob("*.json"):
        shutil.copy(p, root / p.name)
    for p in ("r1.fastq", "r2.fastq"):
        shutil.copy(GOLD / p, root / p)
    return root


def test_fifteen_group_cases():
    """15 group-path cases plus the 3 mono-path ones."""
    cases = golden_cases()
    assert len(cases) == 18
    assert {"probe_mono", "mismatch1", "mismatch2"} <= set(cases)


def _check_golden(case, staging):
    lib_name = f"lib_{case}.json" if (GOLD / f"lib_{case}.json").exists() else "lib_base.json"
    out = staging / f"out_{case}.tsv"
    inputs = [str(staging / "r1.fastq")]
    if case not in SINGLE_END_CASES:
        inputs.append(str(staging / "r2.fastq"))
    rc = cli(["align", "--reference", str(staging / lib_name), "--output", str(out),
              "--input", *inputs, *FLAG_CASES.get(case, []), "--device", "cpu"])
    assert rc == 0
    assert out.read_bytes() == (GOLD / f"golden_{case}.tsv").read_bytes(), (
        f"port output for {case!r} differs from tests/goldens/golden_{case}.tsv"
    )


@pytest.mark.parametrize("case", golden_cases())
def test_golden_on_cpu(case, staging):
    _check_golden(case, staging)


@pytest.mark.parametrize("case", ["base", "group_on_lineage", "strand_fiveprime"])
def test_golden_without_native_io(case, staging, monkeypatch):
    """Without the native host library (a failed build), the python readers
    and emission fallback give the same bytes."""
    from nimble_tpu.io import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "_load", lambda: None)
    _check_golden(case, staging)


@pytest.mark.parametrize(
    "args",
    [["align", "--mesh", "data=2"], ["align", "--resume"]],
    ids=["mesh", "resume"],
)
def test_align_refuses_unported_options(args, staging, capsys):
    """No align option is refused any more: `--mesh data=2` runs on two CPU
    shards and `--resume` with no progress sidecar runs from the start, and
    each writes the golden bytes."""
    out = staging / f"refused_{args[1].lstrip('-')}.tsv"
    rc = cli([args[0], "--reference", str(staging / "lib_base.json"),
              "--output", str(out),
              "--input", str(staging / "r1.fastq"), str(staging / "r2.fastq"), *args[1:],
              "--device", "cpu"])
    assert rc == 0
    assert "ROADMAP" not in capsys.readouterr().err
    assert out.read_bytes() == (GOLD / "golden_base.tsv").read_bytes()


def tagged_tsv(path):
    """golden_base.tsv (an align TSV as the port writes it) with CB/UB
    grafted on, so that reads share UMIs (4 cells, 7 UMIs), as in
    tests/test_mesh_cli.py's report test."""
    lines = (GOLD / "golden_base.tsv").read_text().strip().split("\n")
    header = lines[0].split("\t")
    icb, iub = header.index("r1_CB"), header.index("r1_UB")
    rows = []
    for i, line in enumerate(lines[1:]):
        parts = line.split("\t")
        parts[icb], parts[iub] = f"CELL{i % 4}", f"UMI{i % 7}"
        rows.append("\t".join(parts))
    path.write_text("\n".join([lines[0]] + rows) + "\n")
    return str(path)


@pytest.mark.parametrize("case", ["report-device"])
def test_unported_subcommand_options_exit_nonzero(case, tmp_path):
    """Every subcommand option of the reference is ported (`align --mesh`
    too: test_align_refuses_unported_options). `report
    --device cpu` gives the bytes of the reference CLI's `report --device`
    and of the host report on a tagged TSV with shared UMIs;
    `--distributed N` and `index --warm` are tested in
    tests/test_torch_dist.py and tests/test_torch_warm.py."""
    from nimble_tpu.__main__ import main as ref_cli

    tagged = tagged_tsv(tmp_path / "tagged.tsv")
    outs = {k: tmp_path / f"{k}.tsv" for k in ("host", "dev", "ref")}
    assert cli(["report", "-i", tagged, "-o", str(outs["host"])]) == 0
    assert cli(["report", "-i", tagged, "-o", str(outs["dev"]), "--device", "cpu"]) == 0
    assert ref_cli(["report", "-i", tagged, "-o", str(outs["ref"]), "--device"]) == 0
    host = outs["host"].read_bytes()
    assert host and outs["dev"].read_bytes() == outs["ref"].read_bytes() == host


def test_report_device_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """Bare `report --device` means the card, as the reference's flag means
    its accelerator; with no card it raises, naming `--device cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "nocard.tsv"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["report", "-i", tagged_tsv(tmp_path / "tagged.tsv"), "-o", str(out), "--device"])
    assert not out.exists()


def test_align_on_cuda_without_a_card_raises(staging, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["align", "--reference", str(staging / "lib_base.json"),
             "--output", str(staging / "nocard.tsv"), "--input", str(staging / "r1.fastq")])


def test_report_host_engine_on_port_output(staging, tmp_path):
    """`report` dispatches to the shared host engine and reads what the
    port's align wrote (bulk reads carry no CB/UB tags, so the count matrix
    is empty, as with the reference)."""
    out = tmp_path / "aligned.tsv"
    assert cli(["align", "--reference", str(staging / "lib_base.json"), "--output", str(out),
                "--input", str(staging / "r1.fastq"), str(staging / "r2.fastq"),
                "--device", "cpu"]) == 0
    counts = tmp_path / "counts.tsv"
    assert cli(["report", "-i", str(out), "-o", str(counts)]) == 0
    assert counts.exists()
