"""A kernel launch resolved once, and the tape that records launches.

Every launch site of the kernels (``fused2d._prepare``,
``local._prepare_rows``, ``_prepare_rows_il``, ``_prepare_rows_swap``,
``_prepare_cols``, ``interleave._prepare``) is split in two.  *Prepare*
makes the site's checks and resolutions (shapes, strides, overlap, the
library's typed C entry, the tables, the ``dims`` array) and returns a
``Launch``; ``run`` reads the device's current stream and calls the entry.
A ``Launch`` holds no tensor of the call: the operands' data pointers are
plain ints at the argument indices ``ptrs``, so that a ``Plan``'s call
record (``plan.py``) can put another call's pointers there and call the
same entry again.

While a tape records (``recording``), ``run`` adds each launch to the
tape's open pass (``mark``); ``untracked`` notes device work that is no
launch (a plain pass, a copy, a multiply), after which the tape's launches
no longer stand for the whole call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from pyfft_tpu_torch.utils.profiling import COUNTS, span

__all__ = ["Launch", "run", "recording", "mark", "untracked", "RAN_RING",
           "RAN_X", "RAN_XRING"]

# What a C entry returns where a redesign ran and not the first design
# (the sources' constants): a persistent ring (csrc/local_rows.cu
# local_rows_ring_kernel: K1, K2 and K11; csrc/local_cols.cu
# local_cols_pring_kernel, K5's column ring, and local_cols_xring_kernel,
# K12's cluster ring; csrc/fused2d.cu fused2d_ring_kernel, K8's plane
# ring), the cluster tile (local_cols_x_kernel: K5 in float, K12 in
# double), and K5's persistent cluster ring (local_cols_xring_kernel in
# float, on the complex form's pairs).
RAN_RING = -1
RAN_X = -2
RAN_XRING = -3

_LOCAL = threading.local()


class Launch(NamedTuple):
    """One C entry call: ``fn(*args, stream)`` inside the span ``span``
    (``pyfft.entry.<kernel>``).  ``keys`` maps the entry's return to the
    registry key it counts (``launch.<kernel>.<design>``); any other return
    raises ``RuntimeError("<error> launch failed: cudaError <return>")``.
    ``ptrs`` are the indices of ``args`` that hold the operands' data
    pointers; ``keep`` holds the tensors whose pointers ``args`` holds
    besides: the tables, and a copy of an input that the tensor maps could
    not read where it lay (``local._box_operands``)."""

    fn: object
    args: tuple
    ptrs: tuple
    span: str
    keys: dict
    error: str
    keep: tuple = ()

    def __call__(self, stream, args=None) -> None:
        """Call the entry on ``stream`` with ``args`` (default: the
        prepared ones), count its key or raise."""
        err = span(self.span, self.fn,
                   *(self.args if args is None else args), stream)
        key = self.keys.get(err)
        if key is None:
            raise RuntimeError(f"{self.error} launch failed: cudaError {err}")
        COUNTS[key] += 1


def run(launch: Launch | None, device: torch.device) -> None:
    """The generic launch: ``launch`` on ``device``'s current stream, added
    to the open tape's pass if one records; nothing where ``launch`` is
    None (nothing to launch)."""
    if launch is None:
        return
    with torch.cuda.device(device):
        launch(torch.cuda.current_stream(device).cuda_stream)
    tape = getattr(_LOCAL, "tape", None)
    if tape is not None:
        if tape.passes:
            tape.passes[-1][1].append(launch)
        else:
            tape.whole = False


class Tape:
    """The launches of one call, by pass: ``passes`` is a list of (span
    name, launches); ``whole`` is False once the call did device work that
    is no launch, or launched outside a pass."""

    def __init__(self):
        self.passes = []
        self.whole = True


@contextlib.contextmanager
def recording():
    """Record this thread's launches on a new ``Tape`` for the block."""
    tape = Tape()
    _LOCAL.tape = tape
    try:
        yield tape
    finally:
        _LOCAL.tape = None


def mark(name: str) -> None:
    """Open the pass ``name`` on the tape, if one records."""
    tape = getattr(_LOCAL, "tape", None)
    if tape is not None:
        tape.passes.append((name, []))


def untracked() -> None:
    """Note device work that is no launch on the tape, if one records."""
    tape = getattr(_LOCAL, "tape", None)
    if tape is not None:
        tape.whole = False
