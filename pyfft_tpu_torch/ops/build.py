"""Build the package's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/pyfft_tpu_torch/`` beside the package, named by a hash of the
source, so an edited ``.cu`` rebuilds and an unchanged one is reused.

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
from pathlib import Path

__all__ = ["load", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyfft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by the source's hash."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(rc {res.returncode}):\n{res.stderr}")
            # atomic: concurrent builders each write their own temp file
            os.replace(tmp, path)
        lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib
