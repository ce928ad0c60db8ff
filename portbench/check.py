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
``dft_rel_err``) the error is max |got - ref| / max |ref| over the whole
output (the repo's error measure), in float64, and the reference runs in
blocks of transforms so that it fits beside what the run still holds.
"""

from __future__ import annotations

import random

import torch

from portbench import reference

BLOCK_POINTS = 1 << 26


def sample(seed: int, count: int, within: int) -> list:
    """``count`` distinct step indices in [0, within), drawn from
    ``seed``."""
    return sorted(random.Random(seed).sample(range(within), count))


def _blocks(config: dict, t: torch.Tensor):
    """``t`` (the batch's leading dims, then the shape) as (rows, *shape)
    slices of about ``BLOCK_POINTS`` points."""
    shape = tuple(config["shape"])
    rows = t.reshape(-1, *shape)
    n = rows.shape[0]
    per = max(1, BLOCK_POINTS // rows[0].numel())
    for b in range(0, n, per):
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


def dft_rel_err(config: dict, got: tuple, src: tuple, inverse: bool) -> float:
    """max |got - dft(src)| / max |dft(src)|, ``got`` and ``src`` (re, im)
    planes, the DFT by the reference in float64; NaN reads as inf."""
    ndim = len(config["shape"])
    scale = _scale(config, inverse)
    num = den = 0.0
    for gr_b, gi_b, sr_b, si_b in zip(*(_blocks(config, t)
                                        for t in (*got, *src))):
        rr, ri = reference.dft(sr_b, si_b, ndim, inverse=inverse,
                               scale=scale)
        den = max(den, torch.hypot(rr, ri).max().item())
        gap = torch.hypot(gr_b.double() - rr, gi_b.double() - ri).max().item()
        num = max(num, gap if gap == gap else float("inf"))
        del rr, ri
    return num / den if den else num


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
