"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole, so nimble_tpu_torch passes), and the reference imports
nothing of the program either."""
from __future__ import annotations

import ast
import pathlib

import pytest

from benchmark import run

HERE = pathlib.Path(run.__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = {"jax", "jaxlib", "flax", "nimble_tpu"}
    if path.parent.name == "reference":
        bad.add("nimble_tpu_torch")
    assert not top_level_imports(path) & bad


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nimble_tpu_torch_extra", types.ModuleType("nimble_tpu_torch_extra"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == ["jaxlib"]
