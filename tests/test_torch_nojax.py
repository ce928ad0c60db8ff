"""The torch port never imports jax: neither the package nor anything it
imports.  The test process itself has jax loaded (conftest.py), so the
import is checked in a fresh interpreter."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "pyfft_tpu_torch"


@pytest.mark.parametrize("module", [
    "pyfft_tpu_torch",
    "pyfft_tpu_torch.ops.local",
    "pyfft_tpu_torch.ops.build",
    "pyfft_tpu_torch.utils.profiling",
])
def test_import_leaves_jax_out(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'pyfft_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_sources():
    """No module of the package names jax or the JAX package in an import
    statement, lazily or not."""
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "pyfft_tpu"), (f, name)
