"""What every traffic generator shares, and the interface it keeps.

A generator is ``generators/<name>.py``, named by a mix file's
``generator``; the mix file holds its parameters, and a cell may set them
anew.  It exposes

    drive(system, inputs, mix, dev, seconds, keep=None, tracer=None,
          min_steps=0) -> Window

    buffers(inputs) -> tuple

``drive`` issues calls to ``system(x, inverse, wait)`` on ``inputs`` until
``seconds`` have passed, every step in ``keep`` ({step: (buffer, ...)})
has been issued and its outputs copied into those buffers (made by
``buffers`` before the window, and replaced by ``fit`` where an output
has another form), ``min_steps``
steps have been issued and the tracer's slice is done; then synchronises
the device.  The window runs from before its first dispatch to the end
of that synchronise.  Around each step it calls ``tracer.before(step)``
and wraps the step, its calls and its own waits in ``tracer.span(name)``
(names in ``devtrace.py``).  It holds no outputs but those it keeps, and
records each kept step's calls in ``Window.kept`` as (what the call was
given, whether it was an inverse call, the buffer holding its output):
the check compares each with the reference's transform of what it was
given.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

# a mix's ``wait``: what ``execute`` is given as ``wait_for_finish``
WAITS = {"default": None, "none": False}


@dataclass
class Window:
    steps: int = 0
    calls: int = 0
    seconds: float = 0.0
    call_s: list = field(default_factory=list)      # untraced calls only
    wait_s: float = 0.0                             # in the loop's waits
    kept: dict = field(default_factory=dict)        # step: [(x, inv, out)]


def no_span(name):
    return contextlib.nullcontext()


def like(x):
    """An empty buffer of a value's form: a tensor or a tuple of them."""
    if isinstance(x, tuple):
        return tuple(torch.empty_like(t) for t in x)
    return torch.empty_like(x)


def form_of(x):
    """A value's form: the shape and dtype of a tensor, or of each of a
    tuple's."""
    if isinstance(x, tuple):
        return tuple(form_of(t) for t in x)
    return x.shape, x.dtype


def fit(bufs: tuple, outs) -> tuple:
    """A kept step's buffers for its outputs ``outs``: each of ``bufs``
    that has its output's form, else an empty one like the output (a real
    input's transform changes the form)."""
    return tuple(b if form_of(b) == form_of(o) else like(o)
                 for b, o in zip(bufs, outs))


def copy_into(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)
