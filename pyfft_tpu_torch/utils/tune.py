"""Autotuner: time candidates on the card and keep the winners.

Counterpart of ``pyfft_tpu/utils/tune.py`` (``tuned_path``, ``load_tuned``,
``autotune``).  The record is a JSON file of this package's own
(``PYFFT_TPU_TORCH_TUNE_FILE``, by default
``~/.cache/pyfft_tpu_torch/tuned.json``) whose ``"device"`` names the card
it was measured on (``torch.cuda.get_device_name``): a record of another
card, or on a host with no card, is ignored.  Each entry is validated by
its reader against the port's own constraints, and one that fails them is
ignored, as the JAX package ignores a foreign split:

* ``split:{n}`` (n1, n2): ``ops/fourstep.choose_split``, both factors in
  [MIN_TRAIL, max_local];
* ``split3:{n}`` (n1, m1, m2): ``ops/fourstep.choose_split3``;
* ``dsplit:{n}`` (n1, n2): ``ops/fp64.choose_split_df64`` (complex128,
  factors up to MAX_LOCAL_N_DF64);
* ``il1d:{n}`` ([route]): ``plan._il1d_route``, the complex form's route
  of a complex64 1D plan of one local pass;
* ``row:{n}`` (rows a slot, slots): the row ring of K1 and K2
  (``PYFFT_ROWS_RING``, ``csrc/local_rows.cu``);
* ``col:{n}``: K5's persistent ring, (columns, slots) at n = 16 to 256
  (``PYFFT_COLS_PRING``), or its cluster tile, (cluster, columns, blocks
  an SM) from n = 1024 (``PYFFT_XCOLS_F32``, ``csrc/local_cols.cu``).

The last two set compile-time tables: ``defines`` gives each table with
the record's entries merged in, and ``ops/local.py`` builds its row and
column libraries with them.  Without such an entry it gives none, so the
libraries keep the source's tables and their names.  An entry changes the
parameters of a length its table holds, never the set of lengths.  The
JAX package's row and column factor chains are not tuned: they drive only
the plain versions here, which keep JAX's chains to match the reference.

    import pyfft_tpu_torch
    pyfft_tpu_torch.autotune([4096], kinds=("row", "il1d"))   # once a card
    # plans built afterwards read the record
"""

from __future__ import annotations

import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from pyfft_tpu_torch.planner import (MAX_LOCAL_N, MAX_LOCAL_N_DF64,
                                     MIN_LOCAL_N, MIN_TRAIL)
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["autotune", "tuned_path", "load_tuned", "reload_tuned", "tuned",
           "tuned_split", "defines", "table_candidates", "prebuild",
           "device_name"]

_DEFAULT = os.path.join(os.path.expanduser("~"), ".cache", "pyfft_tpu_torch",
                        "tuned.json")

# The tables each library's kinds set: (kind, macro) by source.
_MACROS = {"local_rows": (("row", "PYFFT_ROWS_RING"),),
           "local_cols": (("col", "PYFFT_COLS_PRING"),
                          ("col", "PYFFT_XCOLS_F32"))}
# Shared memory a block may take, and the column sources' largest box side.
_SMEM = 227 * 1024
_BOX = 256


def tuned_path() -> str:
    return os.environ.get("PYFFT_TPU_TORCH_TUNE_FILE", _DEFAULT)


def load_tuned() -> dict:
    """The record as the file holds it, or {} where it is missing or
    malformed."""
    try:
        with open(tuned_path()) as f:
            record = json.load(f)
    except (OSError, ValueError):
        return {}
    return record if isinstance(record, dict) else {}


def device_name() -> str | None:
    """The current card's name, None on a host with no card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


# The record as it applies here (None: not read yet).
_TUNED: dict | None = None


def _record() -> dict:
    global _TUNED
    if _TUNED is None:
        record = load_tuned()
        card = device_name() if record else None
        _TUNED = record if card and record.get("device") == card else {}
    return _TUNED


def _use(record: dict | None) -> None:
    """Make ``record`` the one that applies (None: read the file again at
    next use) and drop every library entry point and shape taken under the
    old one."""
    global _TUNED
    _TUNED = record
    from pyfft_tpu_torch.ops import local
    local.clear_library_caches()


def reload_tuned() -> None:
    """Read the record again at next use (``pallas_local.reload_tuned``),
    and rebuild or reload the row and column libraries it sets."""
    _use(None)


def tuned(kind: str, n: int) -> tuple | None:
    """The record's ``{kind}:{n}`` entry, unvalidated, or None."""
    v = _record().get(f"{kind}:{n}")
    return tuple(v) if isinstance(v, list) and v else None


def _ints(v) -> bool:
    return all(isinstance(f, int) and not isinstance(f, bool) for f in v)


def tuned_split(kind: str, n: int, parts: int,
                max_local: int) -> tuple[int, ...] | None:
    """A measured ``split``/``split3``/``dsplit`` of n from the record, or
    None where there is none or it fails the caller's constraints (``parts``
    power-of-two factors in [MIN_TRAIL, max_local] whose product is n)."""
    v = tuned(kind, n)
    if (not v or len(v) != parts or not _ints(v) or math.prod(v) != n
            or any(not is_power_of_two(f) or not MIN_TRAIL <= f <= max_local
                   for f in v)):
        return None
    return v


# ------------------------------------------------------ the kernels' tables


def source_table(name: str, macro: str) -> list[tuple[int, ...]]:
    """The entries ``X(log2 n, ...)`` of ``#define macro(X)`` in
    ``csrc/<name>.cu``."""
    from pyfft_tpu_torch.ops import build
    src = (build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf"#define {macro}\(X\)((?:\s*\\?\s*X\([\d, ]+\))+)", src)
    if m is None:
        raise ValueError(f"{macro} is not in {name}.cu")
    return [tuple(int(v) for v in t.split(","))
            for t in re.findall(r"X\(([\d, ]+)\)", m.group(1))]


def _fits(macro: str, log2n: int, params: tuple) -> bool:
    """Whether a table entry satisfies its kernel's static assertions
    (``RowRing``, ``PRing``, ``XCols`` and ``XTile``) in whole warps, on
    complex64 (8 bytes a value)."""
    if len(params) != (3 if macro == "PYFFT_XCOLS_F32" else 2):
        return False
    if not _ints(params) or min(params) < 1:
        return False
    n = 1 << log2n
    if macro == "PYFFT_ROWS_RING":
        rpb, s = params
        p = rpb * n
        nt = p // min(n, 16)
        raw = max(p, rpb * (n + n // 16))
        smem = s * (-(-raw * 8 // 128) * 128) + 128
        box = n < 512
        return (s >= 2 and smem <= _SMEM and 32 <= nt <= 1024
                and nt % 32 == 0 and p % nt == 0
                and (not box or (n <= _BOX and rpb <= _BOX))
                and (box or p * 8 < 1 << 20))
    if macro == "PYFFT_COLS_PRING":
        c, s = params
        p = n * c
        nt = p // 16
        return (s >= 2 and s * p * 8 + 128 <= _SMEM and 32 <= nt <= 1024
                and nt % 32 == 0 and n % min(n, _BOX) == 0 and c % 4 == 0
                and c <= _BOX and p * 8 < 1 << 20)
    g, c, _ = params
    if g not in (1, 2, 4, 8, 16) or n % g or 128 % c:
        return False
    m = n // g                                  # rows a block
    nt = min(m * c // 8, 512)
    pairs = (m // g) * c
    return (nt >= 32 and (m * c) % nt == 0 and pairs % nt == 0
            and pairs >= nt and m * c * 8 <= _SMEM
            and (m + 1) * c * 8 <= _SMEM)


def _table(kind: str, n: int):
    """(source, macro, entry) of the table that holds length n for ``kind``
    (``row`` or ``col``), or None."""
    if not is_power_of_two(n):
        return None
    for name, macros in _MACROS.items():
        for k, macro in macros:
            if k != kind:
                continue
            for entry in source_table(name, macro):
                if entry[0] == ilog2(n):
                    return name, macro, entry
    return None


def table_candidates(kind: str, n: int) -> list[tuple[int, ...]]:
    """The parameters ``autotune`` times for ``row:{n}`` or ``col:{n}``:
    the source's entry first, then rows or columns a slot halved and
    doubled and the other of 2 or 3 slots (the cluster tile: 16 or 32
    columns, 1 or 2 blocks an SM), each kept where it fits a block's
    shared memory and its kernel's other constraints; [] where no table
    holds n."""
    found = _table(kind, n)
    if found is None:
        return []
    _, macro, entry = found
    log2n, params = entry[0], tuple(entry[1:])
    if macro == "PYFFT_XCOLS_F32":
        g = params[0]
        cands = [params] + [(g, c, b) for c in (16, 32) for b in (1, 2)]
    else:
        a, s = params
        cands = [params, (a // 2, s), (a * 2, s), (a, 2 if s == 3 else 3)]
    out = []
    for c in cands:
        if c not in out and _fits(macro, log2n, c):
            out.append(c)
    return out


def _defines(name: str, record: dict) -> tuple[str, ...]:
    out = []
    for kind, macro in _MACROS.get(name, ()):
        table = source_table(name, macro)
        merged = []
        for entry in table:
            v = record.get(f"{kind}:{1 << entry[0]}")
            v = tuple(v) if isinstance(v, list) else None
            ok = v is not None and _fits(macro, entry[0], v)
            merged.append((entry[0], *v) if ok else entry)
        if merged != table:
            out.append(f"{macro}(X)=" + " ".join(
                "X(" + ", ".join(map(str, e)) + ")" for e in merged))
    return tuple(out)


def defines(name: str) -> tuple[str, ...]:
    """The macro definitions ``csrc/<name>.cu`` builds with
    (``ops/build.load``): each table of its that the record changes, whole,
    as ``"MACRO(X)=X(...) ..."``; () where the record changes none."""
    return _defines(name, _record())


# ------------------------------------------------------ the split candidates


def _split_candidates(n: int, max_local: int | None = None):
    """Valid (n1, n2) four-step decompositions of n, balanced first."""
    max_local = max_local or MAX_LOCAL_N
    p = n.bit_length() - 1
    out = []
    for p1 in range(1, p):
        n1, n2 = 1 << p1, 1 << (p - p1)
        if MIN_TRAIL <= n1 <= max_local and MIN_TRAIL <= n2 <= max_local:
            out.append((n1, n2))
    out.sort(key=lambda s: abs(s[0].bit_length() - s[1].bit_length()))
    return out


def _split3_candidates(n: int, max_local: int | None = None):
    """Valid (n1, m1, m2) six-step decompositions of n, balanced first,
    under choose_split3's constraints (every factor in [MIN_TRAIL,
    max_local])."""
    max_local = max_local or MAX_LOCAL_N
    lo = ilog2(MIN_TRAIL)
    p = n.bit_length() - 1
    out = []
    for p1 in range(lo, p):
        n1 = 1 << p1
        if n1 > max_local:
            break
        for q1 in range(lo, p - p1):
            m1, m2 = 1 << q1, (n // n1) >> q1
            if m1 > max_local or m2 > max_local or m2 < MIN_TRAIL:
                continue
            out.append((n1, m1, m2))
    out.sort(key=lambda s: max(s) - min(s))
    return out


def _candidate_builds(ns, kinds) -> list:
    """(kind, n, candidates, [(library, defines) a candidate]) of each
    ``row``/``col`` table entry that ``autotune(ns, kinds)`` times."""
    out = []
    for n in ns:
        for kind in ("row", "col"):
            if kind not in kinds or n > MAX_LOCAL_N:
                continue
            cands = table_candidates(kind, n)
            lib = "local_rows" if kind == "row" else "local_cols"
            if cands:
                out.append((kind, n, cands,
                            [(lib, _defines(lib, {f"{kind}:{n}": list(c)}))
                             for c in cands]))
    return out


def prebuild(ns, kinds=("row", "col")):
    """Start building, in threads, all at once, the libraries of the table
    candidates ``autotune(ns, kinds)`` would time, and return a function
    that waits for them and raises if one failed.  ``autotune`` calls it
    itself; a caller that starts it earlier has the builds run beside
    other work."""
    from pyfft_tpu_torch.ops import build
    keys = list(dict.fromkeys(k for *_, libs in _candidate_builds(ns, kinds)
                              for k in libs))
    pool = ThreadPoolExecutor(max_workers=max(1, len(keys)))
    futures = [pool.submit(build.load, lib, defines=d) for lib, d in keys]
    pool.shutdown(wait=False)

    def wait() -> None:
        for f in futures:
            f.result()

    return wait


# ------------------------------------------------------------------ autotune


def autotune(ns, kinds=("row", "col"), volume: int = 1 << 24,
             trials: int = 4, verbose: bool = True) -> dict:
    """Time the candidates of each (kind, n) on the card and write the
    winners to the record (``tuned_path``); returns the whole record.

    Kinds (see the module docstring): ``split`` for n above MAX_LOCAL_N,
    ``split3`` above MAX_LOCAL_N**2, ``dsplit`` above MAX_LOCAL_N_DF64
    (complex128), each timed through its executor with the split forced;
    ``il1d`` for n up to MAX_LOCAL_N, each of the complex form's
    single-pass routes on its own body (K2; K13, K1 and K14; K1 on the
    stride-2 planes); ``row`` and ``col``, the kernels' shape tables at the
    lengths they hold, each candidate a build of its own (all of them
    built at once, in threads, while the splits are timed).  About
    ``volume`` points a call; a candidate's time is the best of ``trials``
    runs of ``time_queued_ms`` (device time with the host ahead).

    Raises without a CUDA device, and where a candidate fails to build or
    to launch: the candidates come from the port's own constraints.  A
    record of another card is replaced, not merged.  Plans built before
    keep their split (it is fixed when a plan is built, as in the JAX
    package, and ``api``'s plan cache keeps them); the complex form's
    route and the kernels' tables apply from the next call on.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("autotune times the card: it needs a CUDA device")
    from pyfft_tpu_torch import plan as planmod
    from pyfft_tpu_torch.ops import fourstep, fp64, interleave, local
    from pyfft_tpu_torch.utils.profiling import time_queued_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    card = device_name()
    record = load_tuned()
    if record.get("device") != card:
        record = {"device": card}

    def planes(shape, seed, dtype=torch.float32):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev, dtype=dtype)
                     for _ in range(2))

    def measure(label, cands, make):
        best = None
        for c in cands:
            fn = make(c)
            ms = min(time_queued_ms(fn)[0] for _ in range(trials))
            if verbose:
                print(f"  {label} {c}: {ms:.4f} ms", flush=True)
            if best is None or ms < best[0]:
                best = (ms, c)
        if verbose and best is not None:
            print(f"  {label}: {best[1]} wins ({best[0]:.4f} ms)", flush=True)
        return best

    ns = [int(n) for n in ns]
    tables = _candidate_builds(ns, kinds)
    built = prebuild(ns, kinds)
    try:
        for n in ns:
            if "split" in kinds and n > MAX_LOCAL_N:
                re_, im_ = planes((max(1, volume // n), n), 2)
                yr, yi = torch.empty_like(re_), torch.empty_like(im_)
                best = measure(
                    f"split n={n}", _split_candidates(n),
                    lambda s: (lambda: fourstep.fft_axis_large(
                        re_, im_, -1, axis=-1, split=s, out=(yr, yi))))
                if best is not None:
                    record[f"split:{n}"] = list(best[1])
            if "split3" in kinds and n > MAX_LOCAL_N * MAX_LOCAL_N:
                re_, im_ = planes((max(1, volume // n), n), 4)
                yr, yi = torch.empty_like(re_), torch.empty_like(im_)
                best = measure(
                    f"split3 n={n}", _split3_candidates(n),
                    lambda s: (lambda: fourstep.fft_axis_huge(
                        re_, im_, -1, axis=-1, split3=s, out=(yr, yi))))
                if best is not None:
                    record[f"split3:{n}"] = list(best[1])
            if "dsplit" in kinds and n > MAX_LOCAL_N_DF64:
                re_, im_ = planes((max(1, volume // n), n), 3, torch.float64)
                yr, yi = torch.empty_like(re_), torch.empty_like(im_)
                best = measure(
                    f"dsplit n={n}",
                    _split_candidates(n, MAX_LOCAL_N_DF64),
                    lambda s: (lambda: fp64.fft_axis_large_df64(
                        re_, im_, -1, axis=-1, split=s, out=(yr, yi))))
                if best is not None:
                    record[f"dsplit:{n}"] = list(best[1])
            if "il1d" in kinds and MIN_LOCAL_N <= n <= MAX_LOCAL_N:
                x = torch.complex(*planes((max(256, volume // n), n), 5))
                y = torch.empty_like(x)
                xf, yf = x.view(torch.float32), y.view(torch.float32)
                xv, yv = torch.view_as_real(x), torch.view_as_real(y)

                def fused():
                    local.fft_rows_interleaved(xf, -1, out=yf)

                def stream():
                    r, i = interleave.deinterleave(xf)
                    local.fft_axis(r, i, -1, axis=-1, out=(r, i))
                    interleave.interleave(r, i, out=yf)

                def planes_route():
                    local.fft_axis(xv[..., 0], xv[..., 1], -1, axis=-1,
                                   out=(yv[..., 0], yv[..., 1]))

                bodies = {"fused": fused, "stream": stream,
                          "planes": planes_route}
                routes = [r for r in planmod._ROUTES if r != "stream"
                          or interleave.supported((2 * n,), torch.float32)]
                best = measure(f"il1d n={n}", routes, bodies.get)
                if best is not None:
                    record[f"il1d:{n}"] = [best[1]]
            # let this length's data go before the next one's
            re_ = im_ = yr = yi = x = y = xf = yf = xv = yv = None
        built()
        for kind, n, cands, _ in tables:
            if kind == "row":
                re_, im_ = planes((max(256, volume // n), n), 0)
                axis = -1
            else:
                re_, im_ = planes((1, n, max(256, volume // n)), 1)
                axis = -2
            yr, yi = torch.empty_like(re_), torch.empty_like(im_)

            def table(c, kind=kind, n=n, axis=axis):
                _use({"device": card, f"{kind}:{n}": list(c)})
                return lambda: local.fft_axis(re_, im_, -1, axis=axis,
                                              out=(yr, yi))

            best = measure(f"{kind} n={n}", cands, table)
            record[f"{kind}:{n}"] = list(best[1])
        path = tuned_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    finally:
        built()
        reload_tuned()
    return record
