"""Build the package's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/pyfft_tpu_torch/`` in a checkout of the repository (the directory
that holds ``pyproject.toml`` beside the package), and to
``~/.cache/pyfft_tpu_torch/build`` for an installed package, whose
site-packages may not be writable.  They are named by a hash of the
source together with every ``csrc/*.cuh`` header and the flags, so an
edited ``.cu`` or shared header rebuilds and an unchanged one is reused.
Each kernel has its own lock, so several kernels can build at once from
threads; ``load(name, csrc)`` builds another checkout's source beside
this one's (``probes/ab_parent.py``).  Each build-or-load adds its
seconds to ``load_s.<name>`` in the registry of ``utils/profiling``.

The executors reach the libraries through two helpers: ``entry`` types one
C entry point (every binder of ``ops/local.py``, ``fused2d.py`` and
``interleave.py``), and ``query`` calls a shape query, which fills an
array of ``int`` or ``long long`` and returns whether the design takes
the shape.

Nothing here runs at import time: the host may have no ``nvcc`` and no
GPU, and the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from pyfft_tpu_torch.utils.profiling import COUNTS

__all__ = ["load", "entry", "query", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir(package: Path) -> Path:
    """Where the libraries of the package at ``package`` (the
    ``pyfft_tpu_torch`` directory) go: ``build/pyfft_tpu_torch`` in the
    checkout that holds it, else the user's cache."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "pyfft_tpu_torch"
    return Path.home() / ".cache" / "pyfft_tpu_torch" / "build"


BUILD_DIR = _build_dir(Path(__file__).resolve().parents[1])
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[tuple, ctypes.CDLL] = {}
_LOCKS: dict[tuple, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built on this host")


def library_path(name: str, csrc: Path | None = None) -> Path:
    """Where ``<csrc>/<name>.cu`` builds to (``csrc`` this package's
    ``csrc/`` by default): named by the hash of the source, every header in
    ``csrc`` (by name and content) and the flags."""
    csrc = csrc or CSRC
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str, csrc: Path | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc>/<name>.cu`` (``csrc`` this
    package's ``csrc/`` by default, another checkout's for a comparison);
    cached per process and source directory."""
    csrc = csrc or CSRC
    key = (name, str(csrc))
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LOADED.get(key)
        if lib is not None:
            return lib
        start = time.perf_counter()
        path = library_path(name, csrc)
        if not path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}."
                                 f"{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(csrc / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(rc {res.returncode}):\n{res.stderr}")
            # atomic: concurrent builders each write their own temp file
            os.replace(tmp, path)
        lib = _LOADED[key] = ctypes.CDLL(str(path))
        with _LOCKS_LOCK:
            COUNTS[f"load_s.{name}"] += time.perf_counter() - start
        return lib


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built and
    loaded by ``load`` at first use), typed with ``argtypes`` and
    ``restype``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


# What a shape query that returns a status (``status=True``) returns where
# another design takes the shape (csrc/local_cols.cu
# pyfft_local_cols_xshape).
NOT_TAKEN = -1000


def query(name: str, symbol: str, keys, *args, argtypes=None,
          out=ctypes.c_int, status: bool = False) -> dict | None:
    """The shape query ``symbol`` of ``csrc/<name>.cu`` on ``args``
    (``int``s unless ``argtypes`` says otherwise) and an array of
    ``len(keys)`` ``out``: ``{key: value}``, or None where the design does
    not take the shape.  The query returns a positive count, 0 where the
    design does not take the shape or minus a cudaError_t; with ``status``
    it returns 0, NOT_TAKEN or a cudaError_t.  Raises on a cudaError_t."""
    argtypes = argtypes or [ctypes.c_int] * len(args)
    fn = entry(name, symbol, [*argtypes, ctypes.POINTER(out)])
    values = (out * len(keys))()
    got = fn(*args, values)
    if status:
        taken, err = got == 0, 0 if got in (0, NOT_TAKEN) else got
    else:
        taken, err = got > 0, -got if got < 0 else 0
    if err:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    return dict(zip(keys, values)) if taken else None
