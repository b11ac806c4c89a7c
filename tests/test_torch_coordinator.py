"""The coordinated `align` world of the port (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID over a torch.distributed gloo group,
parallel/dist.py:init_distributed), on the CPU.

Two processes of `python -m nimble_tpu_torch align --device cpu` rendezvous
at 127.0.0.1:<a free port>, each aligns the spans it owns, and process 0
merges the shards: the merged TSV is the one-process TSV, with and without
`--mesh data=2` in each process, and no shard file remains. One process
under an address with JAX_NUM_PROCESSES=1 is the plain run; the process
group is gone when align returns, on error too; without an address
init_distributed makes no group. Every subprocess has its own time limit,
so a rendezvous that hangs fails its test instead of cutting the suite.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.parallel.dist import init_distributed
from tests.test_mesh_cli import workspace  # noqa: F401  (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 180
SPAN = "8"  # --chunk-size: 60 reads make 8 spans


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def coordinated(args, n: int, port: int):
    """`python -m nimble_tpu_torch` with args in n processes of one
    coordinated world, started together; returns [(rc, output)]."""
    procs = []
    for pid in range(n):
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(pid)}
        procs.append(subprocess.Popen([sys.executable, "-m", "nimble_tpu_torch", *args], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LIMIT_S)
            outs.append((p.returncode, out.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _args(ws, out, *extra):
    return ["align", "--reference", ws["library"], "--input", ws["fastq"], "--output", str(out),
            "--chunk-size", SPAN, *extra, "--device", "cpu"]


@pytest.fixture(scope="module")
def single(workspace, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("single") / "single.tsv"
    assert port_cli(_args(workspace, out)) == 0
    assert out.read_text().count("\n") == 61
    return out.read_bytes()


@pytest.mark.parametrize("mesh", [[], ["--mesh", "data=2"]], ids=["plain", "mesh-data2"])
def test_two_process_coordinated_world_equals_one_process(workspace, single, mesh, tmp_path):  # noqa: F811
    outs = coordinated(_args(workspace, tmp_path / "merged.tsv", *mesh), 2, free_port())
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    # process 1 owns spans 1, 3, 5 and 7 (8 + 8 + 8 + 4 reads); process 0
    # reports the merged total
    assert "Aligned 28 read(-pair)s" in outs[1][1] and "Aligned 60 read(-pair)s" in outs[0][1]
    assert (tmp_path / "merged.tsv").read_bytes() == single
    assert sorted(os.listdir(tmp_path)) == ["merged.tsv"]


def test_one_process_under_a_coordinator_is_the_plain_run(workspace, single, tmp_path):  # noqa: F811
    [(rc, out)] = coordinated(_args(workspace, tmp_path / "one.tsv"), 1, free_port())
    assert rc == 0, out[-3000:]
    assert (tmp_path / "one.tsv").read_bytes() == single
    assert sorted(os.listdir(tmp_path)) == ["one.tsv"]


def test_the_group_is_destroyed_when_align_ends(workspace, single, tmp_path, monkeypatch):  # noqa: F811
    """In this process: a coordinated world of one joins a group, and align
    destroys it when it returns, after a run and after a failed one."""
    joined = []
    real = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: (joined.append((a, kw)), real(*a, **kw))[1])
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    assert port_cli(_args(workspace, tmp_path / "ok.tsv")) == 0
    assert not dist.is_initialized()
    assert (tmp_path / "ok.tsv").read_bytes() == single
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    bad = [a if a != workspace["fastq"] else str(tmp_path / "missing.fastq") for a in _args(workspace, tmp_path / "x.tsv")]
    assert port_cli(bad) == 1
    assert not dist.is_initialized()
    assert [(a, kw["world_size"], kw["rank"], kw["timeout"].total_seconds()) for a, kw in joined] == [
        (("gloo",), 1, 0, 300.0)] * 2


def test_init_distributed_without_an_address(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()
