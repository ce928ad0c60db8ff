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
this one's (``probes/ab_parent.py``).  ``load(name, defines=...)`` builds
the source with macro definitions ahead of it (the kernels' shape tables,
each under ``#ifndef``, as ``utils/tune.py`` sets them from its record);
they are written to a header that ``nvcc`` includes first, since ``-D``
splits its value at commas, and they take part in the library's hash, so
no definitions give the same library as before.  Each build-or-load adds
its seconds to ``load_s.<name>`` in the registry of ``utils/profiling``.

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

__all__ = ["load", "BUILD_DIR", "NVCC_FLAGS"]

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


def _header(defines) -> str:
    """The header of ``#define`` lines for ``defines``, each
    ``"NAME=value"`` or ``"NAME(args)=value"`` as ``-D`` would take it."""
    lines = []
    for d in defines:
        macro, _, value = d.partition("=")
        lines.append(f"#define {macro} {value}".rstrip())
    return "".join(line + "\n" for line in lines)


def library_path(name: str, csrc: Path | None = None,
                 defines: tuple[str, ...] = ()) -> Path:
    """Where ``<csrc>/<name>.cu`` builds to (``csrc`` this package's
    ``csrc/`` by default): named by the hash of the source, every header in
    ``csrc`` (by name and content), the flags and any ``defines``."""
    csrc = csrc or CSRC
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(b"\0defines\0" + _header(defines).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str, csrc: Path | None = None,
         defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc>/<name>.cu`` (``csrc`` this
    package's ``csrc/`` by default, another checkout's for a comparison),
    with ``defines`` (``"NAME(X)=value"`` strings) ahead of the source;
    cached per process, source directory and definitions."""
    csrc = csrc or CSRC
    defines = tuple(defines)
    key = (name, str(csrc), defines)
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LOADED.get(key)
        if lib is not None:
            return lib
        start = time.perf_counter()
        path = library_path(name, csrc, defines)
        if not path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}."
                                 f"{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
            pre = tmp.with_suffix(".h")
            if defines:
                pre.write_text(_header(defines))
                cmd += ["-include", str(pre)]
            cmd.append(str(csrc / f"{name}.cu"))
            res = subprocess.run(cmd, capture_output=True, text=True)
            pre.unlink(missing_ok=True)
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
