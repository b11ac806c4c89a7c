"""The port never imports jax: its CLI runs with jax made unimportable, and
no module under nimble_tpu_torch/ imports jax or a jax-importing part of
nimble_tpu."""
import ast
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"
FORBIDDEN = ("jax", "nimble_tpu.align", "nimble_tpu.parallel", "nimble_tpu.quant.device")

SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
from nimble_tpu_torch.__main__ import main
rc = main(sys.argv[1:])
loaded = sorted(m for m, v in sys.modules.items() if (m == "jax" or m.startswith("jax.")) and v is not None)
loaded += sorted(m for m in sys.modules if m.startswith("nimble_tpu.align") or m.startswith("nimble_tpu.parallel"))
print("LOADED", loaded)
sys.exit(rc)
"""


def _align_without_jax(tmp_path, flags, golden):
    shutil.copy(GOLD / "lib_base.json", tmp_path)
    out = tmp_path / "out.tsv"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "align", "--reference", str(tmp_path / "lib_base.json"),
         "--output", str(out), "--input", str(GOLD / "r1.fastq"), str(GOLD / "r2.fastq"),
         *flags, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert out.read_bytes() == (GOLD / golden).read_bytes()


def test_align_cli_runs_without_jax(tmp_path):
    _align_without_jax(tmp_path, [], "golden_base.tsv")


def test_align_probe_mono_runs_without_jax(tmp_path):
    """The mono path (tables, mono_probe, engine) imports no jax either."""
    _align_without_jax(tmp_path, ["--probe", "mono"], "golden_probe_mono.tsv")


def test_wide_align_runs_without_jax(tmp_path):
    """The gband path (band tables, sidecar, band_tree_expand, idlist wire)
    imports no jax either, and its TSV equals the reference's."""
    import json

    from nimble_tpu import seq as seqmod
    from nimble_tpu.__main__ import main as ref_cli
    from nimble_tpu.config import Config
    from nimble_tpu.io.fastq import write_fastq
    from tests.test_torch_gband import family_seqs

    seqs = family_seqs()
    cols = [["fam"] * len(seqs), [f"f{i:04d}" for i in range(len(seqs))],
            [str(len(s)) for s in seqs], [seqmod.decode(s) for s in seqs]]
    lib = tmp_path / "wide.json"
    lib.write_text(json.dumps([Config().to_dict(), {
        "headers": ["reference_genome", "sequence_name", "nt_length", "sequence"], "columns": cols}]))
    recs = [(f"r{i}", seqmod.decode(seqs[i * 7][50:150]), "I" * 100) for i in range(300)]
    write_fastq(str(tmp_path / "reads.fastq"), recs)
    want = tmp_path / "ref.tsv"
    assert ref_cli(["align", "--reference", str(lib), "--output", str(want),
                    "--input", str(tmp_path / "reads.fastq")]) == 0
    out = tmp_path / "out.tsv"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "align", "--reference", str(lib), "--output", str(out),
         "--input", str(tmp_path / "reads.fastq"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert out.read_bytes() == want.read_bytes() and want.read_bytes().count(b"\n") > 100


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_jax():
    files = sorted((REPO / "nimble_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 10
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imports(f)
        if any(m == x or m.startswith(x + ".") for x in FORBIDDEN)
    ]
    assert bad == []
