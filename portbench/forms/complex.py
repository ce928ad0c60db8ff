"""Form ``complex``: one complex tensor in and out, ``execute(x)``
(pyfft's interleaved complex)."""

from __future__ import annotations

import torch

from portbench import check, system


def make_inputs(config: dict, count: int, seed: int, device) -> list:
    """Standard normal real and imaginary parts, in one call."""
    _, real = system.DTYPES[config["dtype"]]
    buf = torch.randn((count, *system.dims(config), 2),
                      generator=system.generator(seed, device), dtype=real,
                      device=device)
    return [torch.view_as_complex(buf[i]) for i in range(count)]


def planes(config: dict, t) -> tuple:
    return t.real, t.imag


def rel_err(config: dict, got, src, inverse: bool) -> float:
    return check.dft_rel_err(config, planes(config, got),
                             planes(config, src), inverse)


def reference_call(config: dict, x, inverse: bool, precision: str):
    re, im = check.dft(config, *planes(config, x), inverse, precision)
    cplx, real = system.DTYPES[config["dtype"]]
    return torch.complex(re.to(real), im.to(real)).to(cplx)


class Port(system.PlanPort):
    def describe(self) -> str:
        text = repr(self.plan)
        try:
            text += f" route={self.plan.il_route()}"
        except (AttributeError, ValueError) as e:
            text += f" route=? ({e})"
        return text
