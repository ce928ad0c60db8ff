"""CPU backend entry point: ``from pyfft_tpu_torch.cpu import Plan``.

Counterpart of ``pyfft_tpu/cpu.py``: a ``Plan`` pinned to the plain torch
chain (``force_xla``, the JAX package's name), on the host unless
``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np

from pyfft_tpu_torch.plan import Plan as _Plan

__all__ = ["Plan"]


class Plan(_Plan):
    def __init__(self, shape, dtype=None, **kwargs):
        kwargs["force_xla"] = True
        kwargs.setdefault("device", "cpu")
        super().__init__(shape, dtype if dtype is not None else np.complex64,
                         **kwargs)
