"""The port's library cache and warm-up (``pyfft_tpu_torch.utils.cache``)
and its Plan shims (``pyfft_tpu_torch.cpu``, ``pyfft_tpu_torch.cuda``),
against the JAX package's ``utils/cache.py``, ``cpu.py`` and ``tpu.py``.

JAX's ``warmup`` is not called here: it turns on JAX's persistent cache
for the whole process.  Its count is its loops' (``cache.py:77-92``): one
executable a shape, dtype, batch and direction.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import pyfft_tpu.cpu as jax_cpu
import pyfft_tpu_torch
from helpers import TOL, rand_complex, rel_err
from pyfft_tpu_torch import cpu, cuda
from pyfft_tpu_torch.ops import build
from pyfft_tpu_torch.plan import Plan
from pyfft_tpu_torch.utils import cache

JAX_TOL = {np.complex64: 1e-6, np.complex128: 1e-11}


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The cache not yet enabled, no environment switch set; the build
    directory and the flag restored after the test."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.delenv("PYFFT_TPU_TORCH_NO_CACHE", raising=False)
    monkeypatch.delenv("PYFFT_TPU_TORCH_CACHE_DIR", raising=False)
    return tmp_path


def test_enable_compile_cache_moves_the_build_dir(fresh):
    want = fresh / "libs"
    assert cache.enable_compile_cache(str(want)) == str(want)
    assert build.BUILD_DIR == want and want.is_dir()
    assert build.library_path("local_rows").parent == want
    # idempotent: a second call keeps the directory in use
    assert cache.enable_compile_cache(str(fresh / "other")) == str(want)
    assert cache.enable_compile_cache() == str(want)
    assert build.BUILD_DIR == want and not (fresh / "other").exists()


def test_enable_compile_cache_restored(fresh):
    """The fixture put back the checkout's directory after the test
    above."""
    assert build.BUILD_DIR == build._build_dir(
        Path(build.__file__).resolve().parents[1])


def test_enable_compile_cache_env_dir(fresh, monkeypatch):
    monkeypatch.setenv("PYFFT_TPU_TORCH_CACHE_DIR", str(fresh / "env"))
    assert cache.enable_compile_cache() == str(fresh / "env")
    assert build.library_path("fused2d").parent == fresh / "env"


def test_enable_compile_cache_default_dir(fresh, monkeypatch):
    """No path and no variable: the directory ops/build.py chose."""
    monkeypatch.setattr(build, "BUILD_DIR", fresh / "chosen")
    assert cache.enable_compile_cache(aggressive=True) == str(fresh /
                                                               "chosen")
    assert (fresh / "chosen").is_dir()


def test_enable_compile_cache_opt_out(fresh, monkeypatch):
    before = build.BUILD_DIR
    monkeypatch.setenv("PYFFT_TPU_TORCH_NO_CACHE", "1")
    assert cache.enable_compile_cache(str(fresh / "x")) is None
    assert build.BUILD_DIR == before and not (fresh / "x").exists()


@pytest.mark.parametrize("shapes,dtypes,batches,inverse_too", [
    ([64], ("complex64",), (1,), True),
    ([64, (16, 32)], ("complex64", "complex128"), (1, 3), True),
    ([(8, 16, 32), 128], ("complex128",), (1,), False),
    ([(256,)], ("complex64",), (2, 4, 1), False),
])
def test_warmup_count(fresh, monkeypatch, shapes, dtypes, batches,
                      inverse_too):
    """The count JAX's loops give: shapes x dtypes x batches x
    directions; each executes its plan in both forms on zeros."""
    monkeypatch.setattr(build, "BUILD_DIR", fresh / "w")
    runs = []
    execute = Plan.execute

    def counted(self, *a, **kw):
        runs.append((self.shape, self.dtype, a[0].shape, kw["inverse"]))
        return execute(self, *a, **kw)
    monkeypatch.setattr(Plan, "execute", counted)
    got = cache.warmup(shapes, dtypes, batches, inverse_too, device="cpu")
    want = len(shapes) * len(dtypes) * len(batches) * (1 + inverse_too)
    assert got == want and len(runs) == 2 * want
    assert (fresh / "w").is_dir()       # the cache was enabled first
    assert sum(r[3] for r in runs) == (want if inverse_too else 0)


def test_root_exports():
    assert pyfft_tpu_torch.enable_compile_cache is cache.enable_compile_cache
    assert pyfft_tpu_torch.warmup is cache.warmup
    assert {"enable_compile_cache", "warmup"} <= set(pyfft_tpu_torch.__all__)


def test_cpu_plan_pins():
    p = cpu.Plan((64,))
    assert p._force_xla and p.device == torch.device("cpu")
    assert p.dtype == np.complex64
    # force_xla is pinned, device only defaulted (JAX's cpu.py:19)
    p = cpu.Plan((64,), np.complex128, force_xla=False, device="cuda")
    assert p._force_xla and p.device.type == "cuda"
    assert p.dtype == np.complex128
    assert {a.executor for a in p._exec_plan.passes} == {"plain"}


def test_cuda_plan_pins():
    p = cuda.Plan((64,))
    assert not p._force_xla and p.device.type == "cuda"
    assert p.dtype == np.complex64
    assert [a.executor for a in p._exec_plan.passes] == ["local"]
    # both only defaulted (JAX's tpu.py:19)
    p = cuda.Plan((64,), force_xla=True, device="cpu")
    assert p._force_xla and p.device == torch.device("cpu")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape,batch", [((256,), 4), ((32, 64), 2),
                                         ((8, 16, 32), 1), ((16384,), 2)])
def test_cpu_plan_matches_jax(shape, batch, dtype):
    x = rand_complex((batch, *shape), dtype, seed=len(shape) + batch)
    axes = tuple(range(1, x.ndim))
    for inverse in (False, True):
        got = cpu.Plan(shape, dtype).execute(x, inverse=inverse).numpy()
        want = np.asarray(jax_cpu.Plan(shape, dtype).execute(
            x, inverse=inverse))
        ref = (np.fft.ifftn if inverse else np.fft.fftn)(
            x.astype(np.complex128), axes=axes)
        assert rel_err(got, want) < JAX_TOL[dtype]
        assert rel_err(got, ref) < TOL[dtype]
