"""The system under test and its stand-ins.

A configuration's ``form`` names ``forms/<form>.py``, which holds what
depends on how the data is stored and how the program is entered:

* ``make_inputs(config, count, seed, device)``: ``count`` distinct
  inputs, drawn on ``device`` from ``seed``;
* ``Port(config, device)``: the program, called as ``port(x, inverse,
  wait)`` exactly as a user calls it, with ``describe()``;
* ``planes(config, value)``: the real planes of a value (views): (re,
  im) of a complex value, the value itself of a real one;
* ``rel_err(config, got, src, inverse)``: the comparison of one call's
  output with the reference's transform of what it was given;
* ``reference_call(config, x, inverse, precision)``: the reference's
  answer to one call, in the form, computed in ``precision``.

``Control`` is the plain reference put in the program's place, computed
one precision below the configuration's; ``Faulty`` breaks the port's
answers on purpose.  The last two serve the checks of the comparison
(``calibrate.py`` and the tests), never a benchmark run.
"""

from __future__ import annotations

import torch

from portbench import registry, work

# A configuration's dtype: (the complex dtype of its values or, for real
# input, of its half spectrum (``work.SPECTRUM``); the real dtype of its
# planes).
DTYPES = {"complex64": (torch.complex64, torch.float32),
          "complex128": (torch.complex128, torch.float64)}
DTYPES.update({r: DTYPES[c] for r, c in work.SPECTRUM.items()})
# The nearest precision below each configuration's: the control's.
CONTROL = {"complex64": "tf32", "complex128": "float32",
           "float32": "tf32", "float64": "float32"}


def dims(config: dict) -> tuple:
    """One input's dimensions: the batch (none for a batch of one), then
    the transform's shape."""
    lead = () if config["batch"] == 1 else (config["batch"],)
    return (*lead, *config["shape"])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    return g


def form(config: dict):
    return registry.form(config["form"])


def port(config: dict, device):
    """The program, as the configuration's form enters it."""
    return form(config).Port(config, device)


class PlanPort:
    """``pyfft_tpu_torch.Plan(shape, dtype)`` on ``device``; a form says
    how a value is handed to ``execute`` (``args``)."""

    def __init__(self, config: dict, device):
        from pyfft_tpu_torch import Plan
        self.config = config
        self.plan = Plan(tuple(config["shape"]), DTYPES[config["dtype"]][0],
                         device=device)

    def args(self, x) -> tuple:
        return (x,)

    def __call__(self, x, inverse: bool, wait: bool | None):
        """One ``execute``; ``wait`` None leaves the plan's default."""
        kw = {} if wait is None else {"wait_for_finish": wait}
        if inverse:
            kw["inverse"] = True
        return self.plan.execute(*self.args(x), **kw)

    def describe(self) -> str:
        return repr(self.plan)


class Control:
    """The reference in the program's place, computed in ``precision``
    (by default the configuration's ``CONTROL``), its answers returned in
    the program's form and dtype."""

    def __init__(self, config: dict, device, precision: str | None = None):
        self.config, self.form = config, form(config)
        self.precision = precision or CONTROL[config["dtype"]]

    def __call__(self, x, inverse: bool, wait: bool | None):
        return self.form.reference_call(self.config, x, inverse,
                                        self.precision)

    def describe(self) -> str:
        return f"control: the reference in {self.precision}"


class Faulty:
    """The port with one fault planted where its answers are made:

    * ``unchanged``: each call returns its input as it came;
    * ``half``: the second half of the batch (of the leading axis of a
      single transform) is left untransformed: each output plane keeps
      the input's plane there, or zeros where the two differ in shape (a
      real transform's);
    * ``altered``: one answer of each call is changed (1 added to one
      point's real part).
    """

    FAULTS = ("unchanged", "half", "altered")

    def __init__(self, config: dict, device, fault: str):
        if fault not in self.FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.port = port(config, device)
        self.config, self.fault, self.form = config, fault, form(config)

    def __call__(self, x, inverse: bool, wait: bool | None):
        if self.fault == "unchanged":
            return x
        y = self.port(x, inverse, wait)
        out = self.form.planes(self.config, y)
        if self.fault == "half":
            src = self.form.planes(self.config, x)
            for k, o in enumerate(out):
                h = o.shape[0] // 2
                if k < len(src) and src[k].shape == o.shape:
                    o[h:] = src[k][h:]
                else:
                    o[h:] = 0
        else:
            out[0][tuple(d // 3 for d in out[0].shape)] += 1.0
        return y

    def describe(self) -> str:
        return f"the port with the fault {self.fault!r}"
