"""The port never imports jax nor the JAX package: its CLI runs with both
made unimportable, and no module under nimble_tpu_torch/ (nor chip_smoke.py)
imports jax or any part of nimble_tpu, not even one without jax in it."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"
FORBIDDEN = ("jax", "nimble_tpu")

SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["nimble_tpu"] = None  # and so does any import of the JAX package
from nimble_tpu_torch.__main__ import main
rc = main(sys.argv[1:])
loaded = sorted(m for m, v in sys.modules.items() if (m == "jax" or m.startswith("jax.")) and v is not None)
loaded += sorted(m for m, v in sys.modules.items() if (m == "nimble_tpu" or m.startswith("nimble_tpu.")) and v is not None)
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


def test_stacked_align_runs_without_jax(tmp_path):
    """Several libraries through the stacked engine (align/stacked.py, opted
    in by NIMBLE_TPU_STACK=1) import no jax either; each library's TSV is
    the one it gets alone."""
    from nimble_tpu_torch.align import stacked

    assert stacked.StackedEngine.compatible  # the module imports on its own
    libs = []
    for name in ("liba", "libb"):
        shutil.copy(GOLD / "lib_base.json", tmp_path / f"{name}.json")
        libs.append(str(tmp_path / f"{name}.json"))
    out = tmp_path / "out.tsv"
    log = tmp_path / "runlog.jsonl"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "align", "--reference", ",".join(libs),
         "--output", str(out), "--input", str(GOLD / "r1.fastq"), str(GOLD / "r2.fastq"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "NIMBLE_TPU_RUNLOG": str(log), "NIMBLE_TPU_STACK": "1"},
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert '"path": "stacked-group"' in log.read_text()
    for name in ("liba", "libb"):
        assert (tmp_path / f"out.{name}.tsv").read_bytes() == (GOLD / "golden_base.tsv").read_bytes()


def _wide_without_jax(tmp_path, seqs, flags, start: int = 50):
    """The port's CLI on a wide library, with jax and the JAX package
    unimportable, against the reference's TSV on the same reads (100 bp
    from `start` of every seventh allele)."""
    import json

    from nimble_tpu import seq as seqmod
    from nimble_tpu.__main__ import main as ref_cli
    from nimble_tpu.config import Config
    from nimble_tpu.io.fastq import write_fastq

    cols = [["fam"] * len(seqs), [f"f{i:04d}" for i in range(len(seqs))],
            [str(len(s)) for s in seqs], [seqmod.decode(s) for s in seqs]]
    lib = tmp_path / "wide.json"
    lib.write_text(json.dumps([Config().to_dict(), {
        "headers": ["reference_genome", "sequence_name", "nt_length", "sequence"], "columns": cols}]))
    recs = [(f"r{i}", seqmod.decode(seqs[(i * 7) % len(seqs)][start : start + 100]), "I" * 100) for i in range(300)]
    write_fastq(str(tmp_path / "reads.fastq"), recs)
    want = tmp_path / "ref.tsv"
    assert ref_cli(["align", "--reference", str(lib), "--output", str(want),
                    "--input", str(tmp_path / "reads.fastq"), *flags]) == 0
    out = tmp_path / "out.tsv"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "align", "--reference", str(lib), "--output", str(out),
         "--input", str(tmp_path / "reads.fastq"), *flags, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert out.read_bytes() == want.read_bytes() and want.read_bytes().count(b"\n") > 100


def test_wide_align_runs_without_jax(tmp_path):
    """The gband path (band tables, sidecar, band_tree_expand, idlist wire)
    imports no jax either, and its TSV equals the reference's."""
    from tests.test_torch_gband import family_seqs

    _wide_without_jax(tmp_path, family_seqs(), [])


def test_wide_probe_mono_runs_without_jax(tmp_path):
    """The unbanded monocls path (class-id tables, the runs-compacted
    class-bits intersection) imports no jax either, and its TSV equals the
    reference's."""
    from tests.test_torch_gband import groupcls_seqs

    _wide_without_jax(tmp_path, groupcls_seqs(), ["--probe", "mono"], start=480)


def test_report_device_cpu_runs_without_jax(tmp_path):
    """`report --device cpu` (quant/device.py) imports no jax either, and
    its counts equal the port's host report."""
    from tests.test_torch_goldens import tagged_tsv

    from nimble_tpu_torch.__main__ import main as port_cli

    tagged = tagged_tsv(tmp_path / "tagged.tsv")
    out, host = tmp_path / "dev.tsv", tmp_path / "host.tsv"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "report", "-i", tagged, "-o", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert port_cli(["report", "-i", tagged, "-o", str(host)]) == 0
    assert out.read_bytes() == host.read_bytes() and out.stat().st_size > 0


def test_index_warm_runs_without_jax(tmp_path):
    """`index --warm --device cpu` (the engine and its warm span) imports no
    jax either, and the `align` after it writes the golden bytes."""
    shutil.copy(GOLD / "lib_base.json", tmp_path)
    lib = str(tmp_path / "lib_base.json")
    res = subprocess.run([sys.executable, "-c", SCRIPT, "index", "--reference", lib, "--warm", "--paired",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout and "Warmed the group engine on cpu" in res.stdout
    _align_without_jax(tmp_path, [], "golden_base.tsv")


def test_report_distributed_cpu_runs_without_jax(tmp_path):
    """`report --distributed 2 --device cpu` (parallel/dist.py) imports no
    jax either, and its counts equal the port's host report."""
    from tests.test_torch_goldens import tagged_tsv

    from nimble_tpu_torch.__main__ import main as port_cli

    tagged = tagged_tsv(tmp_path / "tagged.tsv")
    out, host = tmp_path / "dist.tsv", tmp_path / "host.tsv"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, "report", "-i", tagged, "-o", str(out), "--distributed", "2",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert port_cli(["report", "-i", tagged, "-o", str(host)]) == 0
    assert out.read_bytes() == host.read_bytes() and out.stat().st_size > 0


def test_align_mesh_runs_without_jax(tmp_path):
    """`align --probe mono --mesh data=2,feature=2` (parallel/mesh.py, the
    meshed engine's shards and feature slices, monocls over split class
    bits) imports no jax either, and writes the per-k-mer golden's bytes."""
    _align_without_jax(tmp_path, ["--probe", "mono", "--mesh", "data=2,feature=2"], "golden_probe_mono.tsv")


def test_coordinated_align_runs_without_jax(tmp_path):
    """A coordinated world of two (JAX_COORDINATOR_ADDRESS over a gloo
    group, parallel/dist.py:init_distributed) imports no jax either, and
    its merged TSV is the golden bytes."""
    from tests.test_torch_coordinator import LIMIT_S, free_port

    shutil.copy(GOLD / "lib_base.json", tmp_path)
    out = tmp_path / "out.tsv"
    port = free_port()
    args = ["align", "--reference", str(tmp_path / "lib_base.json"), "--output", str(out),
            "--input", str(GOLD / "r1.fastq"), str(GOLD / "r2.fastq"), "--chunk-size", "16", "--device", "cpu"]
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, *args], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                                   "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)})
             for pid in range(2)]
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=LIMIT_S)
            assert p.returncode == 0, stderr[-3000:]
            assert "LOADED []" in stdout
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert out.read_bytes() == (GOLD / "golden_base.tsv").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["lib_base.json", "lib_base.json.idx.npz", "out.tsv"]


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
