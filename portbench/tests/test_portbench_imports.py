"""Nothing under portbench/ imports JAX or the JAX package, lazy imports
included, compared by whole top-level name; the reference imports nothing
of the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "pyfft_tpu"}


def top_names(path: Path) -> set:
    """Top-level names of every import in the module, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_names(path) & FORBIDDEN


def closure(module: str) -> set:
    """The benchmark's modules that ``module`` imports, itself included,
    followed through their own imports."""
    seen, todo = set(), [module]
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        tree = ast.parse((HERE / f"{m}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "portbench":
                todo += [a.name for a in node.names]
            elif (isinstance(node, ast.ImportFrom) and node.module
                  and node.module.startswith("portbench.")):
                todo.append(node.module.split(".")[1])
    return seen


@pytest.mark.parametrize("module", ["reference", "work", "check"])
def test_yardstick_imports_nothing_of_the_program(module):
    """The reference, the work arithmetic and the comparison: neither they
    nor the benchmark's modules they import name the program."""
    mods = closure(module)
    assert "system" not in mods and "harness" not in mods
    for m in mods:
        assert "pyfft_tpu_torch" not in top_names(HERE / f"{m}.py"), m


def test_the_walk_sees_lazy_and_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    import jax.numpy as jnp\n"
                 "from pyfft_tpu_torch import Plan\n"
                 "import importlib\nimportlib.import_module('pyfft_tpu.plan')\n")
    names = top_names(f)
    assert {"jax", "pyfft_tpu", "pyfft_tpu_torch"} <= names
    assert "pyfft_tpu_torch" not in FORBIDDEN and "pyfft_tpu" in FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    from portbench import harness
    monkeypatch.setitem(sys.modules, "pyfft_tpu_torch_fake", object())
    assert "pyfft_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in harness.forbidden_modules()
