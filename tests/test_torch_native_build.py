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
