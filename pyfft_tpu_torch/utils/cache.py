"""Where the CUDA libraries are cached, and plan warm-up.

Counterpart of ``pyfft_tpu/utils/cache.py``.  The JAX package turns on
JAX's persistent compilation cache, so that each kernel compiles once a
machine.  Here every kernel is a ``csrc/*.cu`` source that ``ops/build.py``
compiles with ``nvcc`` at first use into a shared library named by the
hash of its source, which later processes load again: the cache is always
on, and these functions choose its directory and fill it.

* ``enable_compile_cache(path)`` sets the directory the libraries build
  into (``build.BUILD_DIR``; by default ``build/pyfft_tpu_torch`` in a
  checkout, ``~/.cache/pyfft_tpu_torch/build`` otherwise).  Opt out with
  ``PYFFT_TPU_TORCH_NO_CACHE=1``; ``PYFFT_TPU_TORCH_CACHE_DIR`` names the
  directory where no ``path`` is given.
* ``warmup(shapes, ...)`` executes a plan of each shape once, both
  directions, on zeros, so that every library its kernels need is built
  and loaded, and their tables made, before the first real call.  On a
  mesh of several cards, call it on every rank before the first
  collective: a rank that runs ``nvcc`` inside its first transform holds
  every other rank waiting in ``all_to_all``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from pyfft_tpu_torch.ops import build
from pyfft_tpu_torch.plan import Plan

__all__ = ["enable_compile_cache", "warmup"]

_enabled = False


def enable_compile_cache(path: str | None = None,
                         aggressive: bool = False) -> str | None:
    """Set and create the directory the CUDA libraries build into
    (idempotent: once set, later calls return it unchanged).

    Returns the directory in use, or None where the user opted out with
    ``PYFFT_TPU_TORCH_NO_CACHE`` (the libraries then build into
    ``build.BUILD_DIR`` as it stands).  ``path`` defaults to
    ``PYFFT_TPU_TORCH_CACHE_DIR``, else the directory ``ops/build.py``
    chose.  ``aggressive`` is the JAX signature's and changes nothing:
    every library is cached, whatever its build time.
    """
    global _enabled
    if _enabled:
        return str(build.BUILD_DIR)
    if os.environ.get("PYFFT_TPU_TORCH_NO_CACHE"):
        return None
    path = path or os.environ.get("PYFFT_TPU_TORCH_CACHE_DIR")
    if path:
        build.BUILD_DIR = Path(path)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _enabled = True
    return str(build.BUILD_DIR)


def warmup(shapes, dtypes=("complex64",), batches=(1,),
           inverse_too: bool = True, device="cuda") -> int:
    """Build and load what plans of the given shapes run on ``device``.

    ``shapes``: ints or tuples, as ``Plan`` takes them; ``dtypes``:
    complex64 and/or complex128; ``batches``: leading batch sizes (a
    library does not depend on the batch, so one is enough).  Each (shape,
    dtype, batch, direction) executes its plan once on zeros, in the
    planar form and in the complex form (whose route may run other
    kernels).  Returns the count of those executions, the number of
    executables JAX's ``warmup`` compiles for the same arguments.
    """
    enable_compile_cache()
    count = 0
    for shape in shapes:
        if isinstance(shape, int):
            shape = (shape,)
        for dt in dtypes:
            plan = Plan(shape, dtype=np.dtype(dt), device=device)
            for b in batches:
                lead = (b,) if b and b > 1 else ()
                for inv in ((False, True) if inverse_too else (False,)):
                    z = torch.zeros(lead + tuple(shape), dtype=plan._complex,
                                    device=device)
                    r = torch.zeros(z.shape, dtype=plan._real, device=device)
                    plan.execute(r, r, inverse=inv)
                    plan.execute(z, inverse=inv)
                    count += 1
    return count
