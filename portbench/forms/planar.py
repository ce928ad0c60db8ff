"""Form ``planar``: split complex, a (re, im) pair of real planes in and
out, ``execute(re, im)``."""

from __future__ import annotations

import torch

from portbench import check, system


def make_inputs(config: dict, count: int, seed: int, device) -> list:
    """Standard normal real and imaginary planes, in one call."""
    _, real = system.DTYPES[config["dtype"]]
    buf = torch.randn((count, 2, *system.dims(config)),
                      generator=system.generator(seed, device), dtype=real,
                      device=device)
    return [(buf[i, 0], buf[i, 1]) for i in range(count)]


def planes(config: dict, t) -> tuple:
    return t


def rel_err(config: dict, got, src, inverse: bool) -> float:
    return check.dft_rel_err(config, got, src, inverse)


def reference_call(config: dict, x, inverse: bool, precision: str):
    re, im = check.dft(config, *x, inverse, precision)
    _, real = system.DTYPES[config["dtype"]]
    return re.to(real), im.to(real)


class Port(system.PlanPort):
    def args(self, x) -> tuple:
        return x

    def describe(self) -> str:
        text = repr(self.plan)
        chunk = getattr(self.plan, "_chunk", None)
        if chunk is not None and self.config["batch"] > 1:
            try:
                per = chunk(self.config["batch"], self.plan.device)
                text += f" chunks={self.config['batch'] // per}"
            except (TypeError, RuntimeError) as e:
                text += f" chunks=? ({e})"
        return text
