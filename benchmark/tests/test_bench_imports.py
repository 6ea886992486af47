"""Nothing the benchmark runs loads JAX or the JAX package: no module under
benchmark/ imports a top-level name jax, jaxlib, flax or red_gym_tpu
(compared whole: red_gym_tpu_torch is another name), and the reference
imports nothing of the program."""

import ast
import os

from conftest import BENCH

from harness import result

FORBIDDEN = {"jax", "jaxlib", "flax", "red_gym_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(folder):
    for d, _, files in os.walk(folder):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert "red_gym_tpu_torch" not in set(imported_tops(path)), path


def test_the_runtime_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "red_gym_tpu_torch_fake", types.ModuleType("x"))
    assert all(n.split(".")[0] in FORBIDDEN for n in result.forbidden_modules())
    monkeypatch.setitem(sys.modules, "red_gym_tpu.env", types.ModuleType("y"))
    assert "red_gym_tpu.env" in result.forbidden_modules()
    assert "red_gym_tpu_torch_fake" not in result.forbidden_modules()
