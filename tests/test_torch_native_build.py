"""The port's CLI builds the shared native host library itself
(nimble_tpu_torch/native_build.py): it tries the environment's CXX, then the
system compilers through the Makefile's `CXX ?=` override, moves the library
into place only when a build succeeds, and says on stderr when none can."""
import os
import stat

import pytest

from nimble_tpu_torch import native_build
from nimble_tpu_torch.__main__ import _ensure_native

MAKEFILE = "CXX ?= false\n\nall:\n\t$(CXX) libnimble_native.so\n"


def _compiler(tmp_path, name: str, works: bool) -> str:
    """A stand-in compiler: writes its argument, or fails as a compiler
    without OpenMP's spec file does."""
    path = tmp_path / name
    body = 'echo built > "$1"' if works else "echo \"error: cannot read spec file 'libgomp.spec'\" >&2; exit 1"
    path.write_text(f"#!/bin/sh\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def native_dir(tmp_path, monkeypatch):
    d = tmp_path / "native"
    d.mkdir()
    (d / "Makefile").write_text(MAKEFILE)
    (d / "nimble_native.cpp").write_text("// stand-in source\n")
    monkeypatch.delenv("CXX", raising=False)  # the environment's try runs the Makefile's `false`
    return d


def test_tries_the_compilers_in_order(tmp_path, native_dir):
    bad = _compiler(tmp_path, "bad-cxx", works=False)
    good = _compiler(tmp_path, "good-cxx", works=True)
    ok, how = native_build.build_native(str(native_dir), (None, bad, good))
    assert ok and how == f"built with CXX={good} after 2 failed tries"
    assert (native_dir / native_build.LIB_NAME).read_text() == "built\n"
    assert sorted(os.listdir(native_dir)) == ["Makefile", native_build.LIB_NAME, "nimble_native.cpp"]
    # present: nothing is built again
    assert native_build.build_native(str(native_dir), (bad,)) == (True, "library already present")


def test_cli_says_so_when_no_compiler_works(tmp_path, native_dir, monkeypatch, capsys):
    bad = _compiler(tmp_path, "bad-cxx", works=False)
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(native_build, "COMPILERS", (None, bad))
    _ensure_native()
    err = capsys.readouterr().err
    assert "native host library is unavailable" in err
    assert "CXX=g++ (environment)" in err and f"CXX={bad}: error: cannot read spec file" in err
    assert not (native_dir / native_build.LIB_NAME).exists()
    assert sorted(os.listdir(native_dir)) == ["Makefile", "nimble_native.cpp"]


def test_loader_builds_through_native_build(tmp_path, native_dir, monkeypatch):
    """The port's loader builds an absent library with build_native, in a
    private copy of native/ moved into place whole, never with `make` in
    place: a process that loads it meanwhile finds no file or a whole one."""
    from nimble_tpu_torch.io import native as port_native

    where = tmp_path / "built_in"
    cxx = tmp_path / "record-cxx"
    cxx.write_text(f'#!/bin/sh\npwd > "{where}"\necho built > "$1"\n')
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native_build, "COMPILERS", (str(cxx),))
    monkeypatch.setattr(port_native, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(port_native, "_SO_PATH", str(native_dir / native_build.LIB_NAME))
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_LIB_TRIED", False)
    assert port_native._load() is None  # the stand-in library is no ELF file
    assert (native_dir / native_build.LIB_NAME).read_text() == "built\n"
    built_in = where.read_text().strip()
    assert os.path.dirname(built_in) == str(native_dir) and os.path.basename(built_in).startswith(".build-")
    assert sorted(os.listdir(native_dir)) == ["Makefile", native_build.LIB_NAME, "nimble_native.cpp"]


def test_native_in_both_reloads_a_loader_that_failed(monkeypatch):
    """A loader that failed once (as one does that reads the library while
    another process's linker writes it) loads again once the library is
    whole, so both packages build indexes with the same builder."""
    from nimble_tpu.io import native as ref_native
    from nimble_tpu_torch.io import native as port_native
    from tests.test_torch_host_parity import native_in_both

    assert native_in_both()
    for loader in (ref_native, port_native):
        monkeypatch.setattr(loader, "_LIB", None)
        monkeypatch.setattr(loader, "_LIB_TRIED", True)
    assert not ref_native.available() and not port_native.available()
    assert native_in_both()
    assert ref_native.available() and port_native.available()
