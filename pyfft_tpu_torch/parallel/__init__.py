"""Distributed FFTs over a ``torch.distributed`` device mesh
(``dist.py``)."""

from pyfft_tpu_torch.parallel.dist import (
    dist_fft_1d, make_dist_fft, make_dist_fft2, make_dist_fft3)

__all__ = ["dist_fft_1d", "make_dist_fft", "make_dist_fft2",
           "make_dist_fft3"]
