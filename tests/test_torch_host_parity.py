"""The port's own host modules (config, seq, io/*, index/builder, library,
barcode, quant, report, legacy, bench_data) against the reference's.

* The port's CLI, in a process where jax and nimble_tpu cannot be imported,
  runs generate -> fastq-to-bam -> index -> align -> report (host, with a
  summary, and --stream) -> plot on small 10x inputs, and the legacy bulk
  report; every output is byte-identical to the reference CLI's on the same
  inputs (the index file member by member: its zip headers carry the time
  it was written).
* Index files written by either package load in the other with equal
  arrays and an equal cache key (gband sidecars: tests/test_torch_gband.py).
* The port's workload generator writes the records of the repo's bench
  scripts.
"""
import dataclasses
import gzip
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.config import Config
from nimble_tpu.index.builder import KmerIndex as RefKmerIndex
from nimble_tpu.index.builder import build_index, index_cache_key, index_cache_path
from nimble_tpu.io.fasta import write_fasta
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch.index.builder import KmerIndex as PortKmerIndex
from nimble_tpu_torch.index.builder import build_index as port_build_index
from nimble_tpu_torch.index.builder import index_cache_key as port_cache_key

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"

# runs the port's CLI (and the legacy bulk report) on a JSON list of
# argument lists, with jax and the JAX package unimportable
PORT = """
import json, sys
sys.modules["jax"] = None
sys.modules["nimble_tpu"] = None
from nimble_tpu_torch.__main__ import main
for argv in json.loads(sys.argv[1]):
    if argv[0] == "legacy":
        from nimble_tpu_torch.legacy import bulk_report, parse_filter_config
        methods, values = parse_filter_config(argv[1])
        bulk_report(methods, values, argv[2], argv[3])
        continue
    rc = main(argv)
    if rc:
        sys.exit(rc)
loaded = sorted(m for m, v in sys.modules.items()
                if m.split(".")[0] in ("jax", "nimble_tpu") and v is not None)
print("LOADED", loaded)
"""


def run_port(cwd, commands):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", PORT, json.dumps(commands)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout


def _rand(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def write_inputs(d: pathlib.Path):
    """A 6-allele library (FASTA + a metadata CSV with a lineage column) and
    120 10x read pairs from it: 3 cells, several UMIs, 1% substitutions,
    a few reads of another sequence."""
    rng = np.random.default_rng(21)
    backbone = _rand(rng, 900)
    alleles = {}
    for i in range(6):
        s = list(backbone)
        s[100 + i * 120 : 140 + i * 120] = list(_rand(rng, 40))
        alleles[f"A*0{i}"] = "".join(s)
    write_fasta(str(d / "mini_hla.fasta"), list(alleles.items()))
    with open(d / "mini_hla.csv", "w") as f:
        f.write("name,sequence,lineage\n")
        for i, nm in enumerate(alleles):
            f.write(f"{nm},,L{i % 3}\n")
    cells = ["ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA", "GATTACAGATTACAGA"]
    names = sorted(alleles)
    r1, r2 = [], []
    for i in range(120):
        src = alleles[names[i % 6]] if i % 17 else _rand(rng, 900)
        st = int(rng.integers(0, 900 - 300))
        cdna = list(src[st : st + 90])
        mate = list(seqmod.revcomp(src[st + 150 : st + 250]))
        for read in (cdna, mate):
            for j in np.flatnonzero(rng.random(len(read)) < 0.01):
                read[j] = "ACGT"[rng.integers(0, 4)]
        cb, umi = cells[i % 3], _rand(rng, 12) if i % 4 else "A" * 12
        r1.append((f"read{i}/1", cb + umi + "".join(cdna), "I" * (28 + len(cdna))))
        r2.append((f"read{i}/2", "".join(mate), "I" * len(mate)))
    write_fastq(str(d / "r1.fastq.gz"), r1)
    write_fastq(str(d / "r2.fastq.gz"), r2)
    (d / "whitelist.txt").write_text("\n".join(cells) + "\n")


def commands(device_flag):
    return [
        ["generate", "--file", "mini_hla.fasta", "--opt-file", "mini_hla.csv", "--output_path", "lib.json"],
        ["fastq-to-bam", "--r1-fastq", "r1.fastq.gz", "--r2-fastq", "r2.fastq.gz", "--map", "whitelist.txt",
         "--output", "tagged.bam"],
        ["index", "--reference", "lib.json"],
        ["index", "--reference", "lib.json", "--probe", "mono", "--output", "mono.idx.npz"],
        ["align", "--reference", "lib.json", "--output", "out.tsv", "--input", "tagged.bam", *device_flag],
        ["report", "-i", "out.tsv", "-o", "counts.tsv", "-s", "nimble_features"],
        ["report", "-i", "out.tsv", "-o", "counts_stream.tsv", "--stream"],
        ["plot", "--input_file", "out.tsv", "--output_file", "report.html"],
        ["legacy", str(GOLD / "lib_filters_minct.json"), str(GOLD / "golden_base.tsv"), "legacy.tsv"],
    ]


OUTPUTS = ("lib.json", "tagged.bam", "out.tsv", "counts.tsv", "summarize.counts.tsv",
           "counts_stream.tsv", "report.html", "legacy.tsv")


def native_in_both(wait_s: float = 60.0) -> bool:
    """Make the native host library (native/) present, and loaded in both
    packages' loaders or in neither. Returns whether it is loaded.

    The reference's loader runs `make -C native` in place when the library
    is absent, and some of the reference's test modules call it as they are
    collected; under xdist every worker does that at once, and a worker
    that loads the file while another worker's linker is writing it fails
    and keeps the python fallbacks for the rest of its life. Its index
    builder is then numpy's, whose table sizes and class numbering differ
    from the native builder's that the port loads later. So: build the
    library if it is absent (atomically, native_build), then let a loader
    that failed load again, until both hold it or `wait_s` has passed."""
    from nimble_tpu.io import native as ref_native
    from nimble_tpu_torch.io import native as port_native
    from nimble_tpu_torch.native_build import build_native

    built, how = build_native()
    deadline = time.monotonic() + wait_s
    while True:
        for loader in (ref_native, port_native):
            if loader._LIB is None:
                loader._LIB_TRIED = False
        loaded = (ref_native.available(), port_native.available())
        if loaded == (built, built) or time.monotonic() > deadline:
            break
        time.sleep(0.5)  # another process may still be writing the file in place
    assert loaded == (built, built), f"native library: {how}; loaded (reference, port) = {loaded}"
    return built


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    native_in_both()
    src = tmp_path_factory.mktemp("inputs")
    write_inputs(src)
    ref, port = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    for d in (ref, port):
        for f in src.iterdir():
            shutil.copy(f, d)
    cwd = os.getcwd()
    os.chdir(ref)
    try:
        for argv in commands([]):
            if argv[0] == "legacy":
                from nimble_tpu.legacy import bulk_report, parse_filter_config

                bulk_report(*parse_filter_config(argv[1]), argv[2], argv[3])
            else:
                assert ref_cli(argv) == 0, argv
    finally:
        os.chdir(cwd)
    run_port(port, commands(["--device", "cpu"]))
    return ref, port


@pytest.mark.parametrize("name", OUTPUTS)
def test_cli_outputs_are_byte_identical(both_runs, name):
    ref, port = both_runs
    want = (ref / name).read_bytes()
    assert (port / name).read_bytes() == want
    assert len(want) > 0


def test_cli_outputs_are_not_vacuous(both_runs):
    ref, _ = both_runs
    lib = json.loads((ref / "lib.json").read_text())
    assert "lineage" in lib[1]["headers"] and len(lib[1]["columns"][0]) == 6
    assert (ref / "out.tsv").read_text().count("\n") > 60
    assert (ref / "counts.tsv").read_text().count("\n") >= 3
    assert (ref / "counts_stream.tsv").read_bytes() == (ref / "counts.tsv").read_bytes()
    assert "Report for Feature" in (ref / "report.html").read_text()
    assert (ref / "legacy.tsv").read_bytes() == (GOLD / "golden_legacy_filters.tsv").read_bytes()


@pytest.mark.parametrize("name", ["lib.json.idx.npz", "mono.idx.npz"])
def test_cli_index_files_hold_identical_members(both_runs, name):
    ref, port = both_runs
    with zipfile.ZipFile(ref / name) as a, zipfile.ZipFile(port / name) as b:
        assert a.namelist() == b.namelist() and "cache_key.npy" in a.namelist()
        for member in a.namelist():
            assert a.read(member) == b.read(member), member


def build_both(data, config, **kw):
    """The reference's index and the port's of one library, each built by
    its own package's builder (the port's from its own Config and Data), with
    the native library loaded in both or in neither, asserted equal. Port
    code takes the second, reference code the first."""
    from nimble_tpu_torch.config import Config as PortConfig
    from nimble_tpu_torch.config import Data as PortData

    native_in_both()  # else the two packages may build with different builders
    ref = build_index(data, config, **kw)
    port = port_build_index(PortData(headers=list(data.headers), columns=[list(c) for c in data.columns]),
                            PortConfig(**dataclasses.asdict(config)), **kw)
    assert isinstance(port, PortKmerIndex)
    _assert_same_index(ref, port)
    return ref, port


def _index_fields(index):
    return {f.name: getattr(index, f.name) for f in dataclasses.fields(index)}


def _assert_same_index(a, b):
    fa, fb = _index_fields(a), _index_fields(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == fb[k].dtype and np.array_equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_index_files_load_in_both_packages(tmp_path, writer):
    """An index file written by either package loads in the other with the
    same arrays, and both packages give the library the same cache key."""
    shutil.copy(GOLD / "lib_base.json", tmp_path / "lib.json")
    lib = str(tmp_path / "lib.json")
    from nimble_tpu.config import load_library as ref_load
    from nimble_tpu_torch.config import load_library as port_load

    key = index_cache_key(lib, None, None)
    assert port_cache_key(lib, None, None) == key
    config, data = ref_load(lib)
    ref_index = build_index(data, config)
    port_config, port_data = port_load(lib)
    port_index = port_build_index(port_data, port_config)
    _assert_same_index(ref_index, port_index)
    path = index_cache_path(lib)
    (ref_index if writer == "reference" else port_index).save(path, cache_key=key)
    for cls in (RefKmerIndex, PortKmerIndex):
        _assert_same_index(cls.load(path), ref_index)
    with np.load(path) as z:
        assert str(z["cache_key"]) == key


def _script(name, *args):
    subprocess.run([sys.executable, str(REPO / "scripts" / name), *map(str, args)], cwd=REPO,
                   check=True, capture_output=True, timeout=600)


def test_bench_generator_writes_the_bench_scripts_records(tmp_path):
    """nimble_tpu_torch.bench_data == scripts/make_bench_fastq.py and
    scripts/make_paired_bench.py: the same library JSON, whitelist and
    (decompressed) FASTQ records, across more than one generator chunk."""
    from nimble_tpu_torch import bench_data

    ref, port = tmp_path / "ref", tmp_path / "port"
    n_reads, n_pairs = (1 << 17) + 5, (1 << 16) + 3
    _script("make_bench_fastq.py", ref, n_reads)
    _script("make_paired_bench.py", ref, n_pairs)
    lib, fq = bench_data.write_single(port, n_reads)
    r1, r2, wl = bench_data.write_paired(port, n_pairs)
    assert pathlib.Path(lib).read_bytes() == (ref / "hla100.json").read_bytes()
    assert pathlib.Path(wl).read_bytes() == (ref / "whitelist.txt").read_bytes()
    for got, want in ((fq, f"reads_{n_reads}.fastq.gz"), (r1, f"paired_r1_{n_pairs}.fastq.gz"),
                      (r2, f"paired_r2_{n_pairs}.fastq.gz")):
        with gzip.open(got) as a, gzip.open(ref / want) as b:
            assert a.read() == b.read(), want


def test_wide_generator_writes_the_bigindex_library(tmp_path):
    """nimble_tpu_torch.bench_data.write_wide: the 20k-allele library of
    scripts/bigindex.py:build_library (the same seed and draws), and gz
    FASTQs of the asked numbers of 100 bp reads and pairs."""
    from nimble_tpu_torch import bench_data

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import bigindex
    finally:
        sys.path.remove(str(REPO / "scripts"))
    want, _ = bigindex.build_library()
    lib, fq, r1, r2 = bench_data.write_wide(tmp_path, 5, 3)
    with open(lib) as f:
        _config, data = json.load(f)
    assert data["columns"] == want.columns and data["headers"] == list(want.headers)
    for path, n in ((fq, 5), (r1, 3), (r2, 3)):
        with gzip.open(path, "rt") as f:
            lines = f.read().splitlines()
        assert len(lines) == 4 * n and all(len(s) == bench_data.READ_LEN and set(s) <= set("ACGT")
                                           for s in lines[1::4]), path


def test_wide_generator_cuts_and_interleaves_families(tmp_path):
    """bench_data.wide_library's first F families are the 20k library's
    first F x 1,000 records (its draws come first); `interleaved` writes
    the same records allele-major (feature a * F + f)."""
    from nimble_tpu_torch import bench_data

    F, A = 3, bench_data.WIDE_ALLELES
    lib, fam = bench_data.wide_library(tmp_path, F)
    ilib, inter = bench_data.wide_library(tmp_path, F, interleaved=True)
    assert lib.endswith("wide3.json") and ilib.endswith("wide3_interleaved.json")
    cols = [json.load(open(p))[1]["columns"] for p in (lib, ilib)]
    order = np.arange(F * A).reshape(F, A).T.reshape(-1)  # allele-major
    assert np.array_equal(inter, fam[order])
    for c in range(4):
        assert cols[1][c] == [cols[0][c][i] for i in order]
    assert cols[0][1][A] == "F01*0000" and cols[1][1][1] == "F01*0000"
    big_lib, big = bench_data.wide_library(tmp_path)
    assert np.array_equal(big[: F * A], fam)
    assert json.load(open(big_lib))[1]["columns"][3][: F * A] == cols[0][3]
