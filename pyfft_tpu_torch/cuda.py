"""CUDA backend entry point: ``from pyfft_tpu_torch.cuda import Plan``.

Counterpart of ``pyfft_tpu/tpu.py``: a ``Plan`` with the hand-written
kernels enabled (``force_xla`` False unless given), on the CUDA device
unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np

from pyfft_tpu_torch.plan import Plan as _Plan

__all__ = ["Plan"]


class Plan(_Plan):
    def __init__(self, shape, dtype=None, **kwargs):
        kwargs.setdefault("force_xla", False)
        kwargs.setdefault("device", "cuda")
        super().__init__(shape, dtype if dtype is not None else np.complex64,
                         **kwargs)
