"""pyfft_tpu_torch: batched power-of-two complex FFTs in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``pyfft_tpu`` (its reference, which this
package never imports): the same ``Plan(shape).execute(data)`` surface and
functional API.  On a CUDA tensor the contiguous last axis runs through
the row kernel ``ops/csrc/local_rows.cu``; the other passes run a plain
torch matmul chain until their kernels are ported (see ROADMAP.md).
"""

VERSION = (0, 1, 0)
__version__ = ".".join(map(str, VERSION))

from pyfft_tpu_torch.plan import Plan  # noqa: E402
from pyfft_tpu_torch.api import (fft, ifft, fft2, ifft2, fftn,  # noqa: E402
                                 ifftn, fftshift, ifftshift, fftfreq,
                                 rfftfreq, get_plan)

__all__ = ["Plan", "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq", "get_plan",
           "VERSION", "__version__"]
