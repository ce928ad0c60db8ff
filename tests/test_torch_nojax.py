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
    "pyfft_tpu_torch.ops.fourstep",
    "pyfft_tpu_torch.ops.fused2d",
    "pyfft_tpu_torch.ops.fp64",
    "pyfft_tpu_torch.ops.interleave",
    "pyfft_tpu_torch.ops.int8",
    "pyfft_tpu_torch.real",
    "pyfft_tpu_torch.ops.build",
    "pyfft_tpu_torch.utils.profiling",
    "pyfft_tpu_torch.parallel",
    "pyfft_tpu_torch.parallel.dist",
    "pyfft_tpu_torch.utils.cache",
    "pyfft_tpu_torch.utils.tune",
    "pyfft_tpu_torch.utils",
    "pyfft_tpu_torch.cpu",
    "pyfft_tpu_torch.cuda",
])
def test_import_leaves_jax_out(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'pyfft_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_offroute_entry_points_leave_jax_out():
    """The entry points of the kernels no Plan route takes (K4, K6, K9)
    run on CPU tensors in a fresh interpreter without loading jax."""
    code = ("import sys, torch\n"
            "from pyfft_tpu_torch.ops import fused2d, local\n"
            "z = torch.zeros(2, 128, 256)\n"
            "assert local.fft_rows_swap(z, z, -1)[0].shape == (2, 256, 128)\n"
            "local.fft_axis(z, z, -1, axis=1, ctile=2, tw_n=128 * 256)\n"
            "fused2d.fft2_fused_tiled(z, z, -1, postscale=0.5)\n"
            "local.fft_rows_swap_plain(z, z, +1)\n"
            "fused2d.fft2_tiled_plain(z, z, +1)\n"
            "assert fused2d.supported_2d_tiled(z)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'pyfft_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_int8_entry_points_leave_jax_out():
    """precision="int8" runs on CPU tensors in a fresh interpreter without
    loading jax: rows and columns, and the other hosts (K4, K8, K9 and the
    fold)."""
    code = ("import sys, torch\n"
            "from pyfft_tpu_torch.ops import fused2d, int8, local\n"
            "z = torch.ones(2, 256, 128)\n"
            "local.fft_axis(z, z, -1, precision='int8')\n"
            "local.fft_axis(z, z, +1, axis=1, precision='int8', tw_n=256*128)\n"
            "local.fft_rows_plain(z, z, -1, precision='int8')\n"
            "local.fft_cols_plain(z, z, -1, precision='int8')\n"
            "assert int8.w_tables(64, -1, z.device).dtype == torch.int8\n"
            "local.fft_rows_swap(z, z, -1, precision='int8', lanes=64)\n"
            "fused2d.fft2_fused(z, z, -1, precision='int8')\n"
            "fused2d.fft2_fused_tiled(z, z, +1, precision='int8')\n"
            "f = torch.ones(1, 256, 8, 128)\n"
            "assert local.supported_fold(f, 1)\n"
            "local.fft_axis_fold(f, f, -1, axis=1, precision='int8')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'pyfft_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_sources():
    """No module of the package, nor chip_smoke.py, nor the gloo ranks of
    test_torch_dist.py, names jax or the JAX package in an import
    statement, lazily or not."""
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                             ROOT / "tests" /
                                             "torch_dist_ranks.py"]
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


def test_slice_h_entry_points_leave_jax_out(tmp_path):
    """The autotune record's readers, ``autotune``'s refusal without a
    card, ``trace`` and the chunk sweep run on the CPU in a fresh
    interpreter without loading jax."""
    code = ("import sys, json, os, torch\n"
            "import pyfft_tpu_torch as pt\n"
            "from pyfft_tpu_torch import plan as planmod\n"
            "from pyfft_tpu_torch.utils import profiling, tune\n"
            f"os.environ['PYFFT_TPU_TORCH_TUNE_FILE'] = "
            f"{str(tmp_path / 'tuned.json')!r}\n"
            "tune.reload_tuned()\n"
            "assert tune.load_tuned() == {}\n"
            "try:\n"
            "    pt.autotune([4096])\n"
            "    raise AssertionError('autotune ran without a card')\n"
            "except RuntimeError:\n"
            "    pass\n"
            "planmod._HBM_CHUNK_BUDGET = 16384 * 4 * 6\n"
            "p = pt.Plan((16384,), device='cpu')\n"
            f"with profiling.trace({str(tmp_path / 'trace')!r}):\n"
            "    y = p.execute(torch.ones(4, 16384, dtype=torch.complex64))\n"
            "assert float(y[3, 0].real) == 16384.0\n"
            "assert planmod._il1d_route(4096) == planmod.IL1D_ROUTE\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'pyfft_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
