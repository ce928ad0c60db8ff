"""pyfft_tpu_torch: batched power-of-two complex FFTs in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``pyfft_tpu`` (its reference, which this
package never imports): the same ``Plan(shape).execute(data)`` surface and
functional API.  On a CUDA tensor the last two complex64 axes of a plane
of up to 2^18 points (both multiples of 128) run through the fused 2D
kernel ``ops/csrc/fused2d.cu``; an axis of up to 8192 points through the
row kernel ``ops/csrc/local_rows.cu`` (the last axis) or the column
kernel ``ops/csrc/local_cols.cu`` (another axis), and a longer axis
through two or three column-kernel passes (``ops/fourstep.py``).
Complex128 takes the same row and column kernels in native FP64, on axes
of up to 4096 points and their four-step and six-step products
(``ops/fp64.py``).  The other passes (short axes or trails, a long axis
other than the last in complex128) run a plain torch matmul chain (see
ROADMAP.md).  Interleaved complex64 storage takes the interleaved row
kernel or the de/interleave kernels where ``plan.py``'s routes say so, and the real transforms (``real.py``: ``rfft`` and its family) run
their inner complex FFT on the real input's interleaved view.
"""

VERSION = (0, 1, 0)
__version__ = ".".join(map(str, VERSION))

from pyfft_tpu_torch.plan import Plan  # noqa: E402
from pyfft_tpu_torch.api import (fft, ifft, fft2, ifft2, fftn,  # noqa: E402
                                 ifftn, fftshift, ifftshift, fftfreq,
                                 rfftfreq, get_plan)
from pyfft_tpu_torch.real import (rfft, irfft, rfft2,  # noqa: E402
                                  irfft2, rfftn, irfftn, rfft_planar,
                                  irfft_planar, rfftn_planar, irfftn_planar)
from pyfft_tpu_torch.utils.cache import (enable_compile_cache,  # noqa: E402
                                         warmup)
from pyfft_tpu_torch.utils.tune import autotune  # noqa: E402

__all__ = ["Plan", "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "rfft_planar", "irfft_planar", "rfftn_planar", "irfftn_planar",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq", "get_plan",
           "enable_compile_cache", "warmup", "autotune", "VERSION",
           "__version__"]
