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
  of a complex64 1D plan of one local pass.

The kernels take their shape tables from their sources, one build of each
library a process (``ops/build.py``); ``probes/float_split.py`` times
table variants from patched copies of the sources.  The JAX package's
``row`` and ``col`` kinds tune its Pallas factor chains, which drive only
the plain versions here (they keep JAX's chains to match the reference):
here those kinds time nothing, and a record's ``row:{n}`` or ``col:{n}``
entry is ignored.

    import pyfft_tpu_torch
    pyfft_tpu_torch.autotune([1 << 22], kinds=("split",))   # once a card
    # plans built afterwards read the record
"""

from __future__ import annotations

import json
import math
import os

import torch

from pyfft_tpu_torch.planner import (MAX_LOCAL_N, MAX_LOCAL_N_DF64,
                                     MIN_LOCAL_N, MIN_TRAIL)
from pyfft_tpu_torch.utils.radix import ilog2, is_power_of_two

__all__ = ["autotune", "tuned_path", "load_tuned", "reload_tuned", "tuned",
           "tuned_split", "device_name"]

_DEFAULT = os.path.join(os.path.expanduser("~"), ".cache", "pyfft_tpu_torch",
                        "tuned.json")


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


def reload_tuned() -> None:
    """Read the record again at next use (``pallas_local.reload_tuned``)."""
    global _TUNED
    _TUNED = None


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
    stride-2 planes).  ``row`` and ``col`` (the JAX package's default) time
    nothing: the kernels take their tables from their sources.  About
    ``volume`` points a call; a candidate's time is the best of ``trials``
    runs of ``time_queued_ms`` (device time with the host ahead).

    Raises without a CUDA device, and where a candidate fails to launch:
    the candidates come from the port's own constraints.  A record of
    another card is replaced, not merged.  Plans built before keep their
    split (it is fixed when a plan is built, as in the JAX package, and
    ``api``'s plan cache keeps them); the complex form's route applies
    from the next call on.
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
    path = tuned_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    reload_tuned()
    return record
