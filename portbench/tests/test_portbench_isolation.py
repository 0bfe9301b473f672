"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
import os

import pytest

from portbench.harness import cell

JAX = {"jax", "jaxlib", "flax", "panoptic_forecasting_tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(cell.BENCH, sub)):
        if "_cache" in dirpath:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax(path):
    assert not JAX & set(imports(path)), path


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_is_plain(path):
    assert not {"panoptic_forecasting_tpu_torch", "portbench"} & set(imports(path)), path


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "panoptic_forecasting_tpu_torch_x", types.ModuleType("x"))
    assert "panoptic_forecasting_tpu_torch_x" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in cell.forbidden_modules()
