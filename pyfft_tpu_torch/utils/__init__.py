"""Radix math, device timing and tracing, the autotune record, and the
library cache (counterpart of ``pyfft_tpu/utils``)."""

from pyfft_tpu_torch.utils.radix import (
    balanced_split,
    fourstep_split,
    ilog2,
    is_power_of_two,
    radix_decompose,
)

__all__ = [
    "balanced_split",
    "fourstep_split",
    "ilog2",
    "is_power_of_two",
    "radix_decompose",
]
