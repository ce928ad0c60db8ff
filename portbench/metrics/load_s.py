"""Seconds the run's process spent loading the program's kernel
libraries, ``nvcc``'s builds included: the sum of the ``load_s.<library>``
seconds in the program's registry (``pyfft_tpu_torch.utils.profiling``,
read where the run imported it; never imported here).  None where the
program keeps no such registry or loaded no library."""

import sys


def value(run):
    module = sys.modules.get("pyfft_tpu_torch.utils.profiling")
    counts = getattr(module, "counts", None)
    if counts is None:
        return None
    seconds = [v for k, v in counts().items() if k.startswith("load_s.")]
    return sum(seconds) if seconds else None
