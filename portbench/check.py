"""Whether the timed calls' answers are right: the comparison with the
plain reference.

The window keeps the outputs of a few of its steps, drawn from the seed
(``sample``), with what each of their calls was given.  Once it has
closed, each kept call is judged by its configuration's form
(``forms/<form>.py``, its ``rel_err``):

* ``fwd_rel_err``: a forward call's output against the reference's
  transform of what the call was given;
* ``inv_rel_err``: an inverse call's output against the reference's
  inverse transform (1/N) of what it was given.

Each is the largest over the kept calls and is held against the
configuration's ``limits``.  For the DFT of a complex value (``dft``,
``dft_rel_err``) and of a real one (``rdft``, ``rdft_rel_err``) the error
is max |got - ref| / max |ref| over the whole output (the repo's error
measure), in float64: over the half spectrum of a real forward call, over
the real signal of its inverse.  The reference runs in blocks of
transforms so that it fits beside what the run still holds.
"""

from __future__ import annotations

import math
import random

import torch

from portbench import reference

BLOCK_POINTS = 1 << 26


def sample(seed: int, count: int, within: int) -> list:
    """``count`` distinct step indices in [0, within), drawn from
    ``seed``."""
    return sorted(random.Random(seed).sample(range(within), count))


def _blocks(config: dict, t: torch.Tensor):
    """``t`` (the batch's leading dims, then one transform's dims) as
    slices of as many transforms as ``BLOCK_POINTS`` points of the
    configuration's shape make: the same rows whatever the last axis's
    length (a half spectrum's or a signal's)."""
    ndim = len(config["shape"])
    rows = t.reshape(-1, *t.shape[t.ndim - ndim:])
    per = max(1, BLOCK_POINTS // math.prod(config["shape"]))
    for b in range(0, rows.shape[0], per):
        yield rows[b:b + per]


def _scale(config: dict, inverse: bool) -> float:
    scale = 1.0
    if inverse:
        for s in config["shape"]:
            scale /= s
    return scale


def dft(config: dict, re, im, inverse: bool, precision: str = "float64"):
    """The reference's transform of (re, im) planes over the
    configuration's axes (1/N on the inverse), in ``precision``."""
    return reference.dft(re, im, len(config["shape"]), inverse=inverse,
                         scale=_scale(config, inverse), precision=precision)


def rdft(config: dict, planes: tuple, inverse: bool,
         precision: str = "float64") -> tuple:
    """The reference's real-input transform over the configuration's axes,
    in ``precision``: a real signal's (x,) to its half spectrum's (re, im)
    forward, back (1/N) on the inverse."""
    ndim = len(config["shape"])
    if inverse:
        return (reference.irdft(*planes, ndim, config["shape"][-1],
                                scale=_scale(config, True),
                                precision=precision),)
    return reference.rdft(planes[0], ndim, precision=precision)


def _norm(planes: tuple) -> torch.Tensor:
    """|value| of (re, im) planes, or of one real plane."""
    return torch.hypot(*planes) if len(planes) == 2 else planes[0].abs()


def _rel_err(config: dict, got: tuple, src: tuple, transform) -> float:
    """max |got - transform(src)| / max |transform(src)|, block by block,
    ``transform`` taking and returning planes in float64; NaN reads as
    inf."""
    num = den = 0.0
    for blocks in zip(*(_blocks(config, t) for t in (*got, *src))):
        g, ref = blocks[:len(got)], transform(*blocks[len(got):])
        den = max(den, _norm(ref).max().item())
        gap = _norm(tuple(a.double() - r for a, r in zip(g, ref))).max()
        gap = gap.item()
        num = max(num, gap if gap == gap else float("inf"))
        del ref
    return num / den if den else num


def dft_rel_err(config: dict, got: tuple, src: tuple, inverse: bool) -> float:
    """max |got - dft(src)| / max |dft(src)|, ``got`` and ``src`` (re, im)
    planes, the DFT by the reference in float64; NaN reads as inf."""
    ndim = len(config["shape"])
    scale = _scale(config, inverse)
    return _rel_err(config, got, src, lambda re, im: reference.dft(
        re, im, ndim, inverse=inverse, scale=scale))


def rdft_rel_err(config: dict, got: tuple, src: tuple,
                 inverse: bool) -> float:
    """max |got - rdft(src)| / max |rdft(src)| over the half spectrum
    forward and over the real signal inverse, ``got`` and ``src`` planes
    ((re, im) of a half spectrum, (x,) of a signal), the reference in
    float64.  NaN reads as inf, and so does a call whose answer, or what
    it was given, is not of the form its direction takes (the number of
    planes, their shape)."""
    n = config["shape"][-1]
    signal, half = (1, n), (2, n // 2 + 1)
    given, due = (half, signal) if inverse else (signal, half)
    lead = tuple(src[0].shape[:-1])

    def of_form(planes, form):
        count, last = form
        return len(planes) == count and all(
            tuple(t.shape) == (*lead, last) for t in planes)

    if not (of_form(src, given) and of_form(got, due)):
        return float("inf")
    return _rel_err(config, got, src,
                    lambda *planes: rdft(config, planes, inverse))


def judge(form, config: dict, kept: dict) -> dict:
    """The largest ``fwd_rel_err`` and ``inv_rel_err`` over the kept calls
    ({step: [(given, inverse, output), ...]}), each with its limit; a
    direction with no kept call is not reported, and no kept call at all
    reads inf."""
    worst: dict = {}
    for step in sorted(kept):
        for src, inverse, out in kept[step]:
            name = "inv_rel_err" if inverse else "fwd_rel_err"
            worst[name] = max(worst.get(name, 0.0),
                              form.rel_err(config, out, src, inverse))
    if not worst:
        worst = {"fwd_rel_err": float("inf")}
    return {k: {"value": worst[k], "limit": config["limits"][k]}
            for k in sorted(worst)}


def passed(checks: dict) -> list:
    """Names of the numbers within their limits (NaN is not)."""
    return [k for k, c in checks.items() if c["value"] <= c["limit"]]
