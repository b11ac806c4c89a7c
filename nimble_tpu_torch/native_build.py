"""Build the repo's native host library (native/libnimble_native.so) before
its loader (nimble_tpu_torch/io/native.py) first looks for it.

The loader runs `make -C native` with the environment's CXX, which may name a
compiler that cannot build it (one without OpenMP's spec file); it then falls
back to the python readers and emission: the output is the same, the run is
~16x slower. Here the environment's CXX is tried first, then the system
compilers through the Makefile's `CXX ?=` override. Each try builds in a
private copy of native/ and moves the library into place atomically, so
processes that start together never load a half-written file.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence, Tuple

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_NAME = "libnimble_native.so"
# None: the environment's CXX (the Makefile's default when it is unset)
COMPILERS: Tuple[Optional[str], ...] = (None, "g++", "/usr/bin/g++", "c++")


def build_native(native_dir: Optional[str] = None,
                 compilers: Optional[Sequence[Optional[str]]] = None) -> Tuple[bool, str]:
    """Make sure `native_dir/libnimble_native.so` (default NATIVE_DIR)
    exists, building it with the first of `compilers` (default COMPILERS)
    that can. Returns (ok, what happened)."""
    native_dir = NATIVE_DIR if native_dir is None else native_dir
    compilers = COMPILERS if compilers is None else compilers
    lib = os.path.join(native_dir, LIB_NAME)
    if os.path.exists(lib):
        return True, "library already present"
    failures = []
    for cxx in compilers:
        label = f"CXX={cxx}" if cxx else f"CXX={os.environ.get('CXX', 'g++')} (environment)"
        with tempfile.TemporaryDirectory(dir=native_dir, prefix=".build-") as tmp:
            for f in os.listdir(native_dir):
                src = os.path.join(native_dir, f)
                if os.path.isfile(src) and f != LIB_NAME:
                    shutil.copy(src, tmp)
            cmd = ["make", "-C", tmp] + ([f"CXX={cxx}"] if cxx else [])
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                failures.append(f"{label}: {e}")
                continue
            built = os.path.join(tmp, LIB_NAME)
            if res.returncode == 0 and os.path.exists(built):
                os.replace(built, lib)
                tail = f" after {len(failures)} failed tries" if failures else ""
                return True, f"built with {label}{tail}"
            lines = (res.stderr or res.stdout).strip().splitlines()
            err = [ln for ln in lines if "error" in ln.lower()][:1] or lines[-1:]
            failures.append(f"{label}: {' '.join(err)}")
    return False, "`make -C native` failed: " + " | ".join(failures)
