"""The share of the complex64 column kernel's launches that ran its
persistent cluster ring on the complex form's pairs: ``launch.K5.xring``
/ (``launch.K5.xring`` + ``launch.K5.x`` + ``launch.K5.pring`` +
``launch.K5.first``) in the program's registry
(``pyfft_tpu_torch.utils.profiling``, read where the run imported it;
never imported here), over the whole run.  Reads
``k5_xring_share.<cell>``.  None where the program keeps no such registry
or counted no ``launch.K5.*`` key (a program without the ring counts
``launch.K5.x`` alone: 0.0)."""

import sys

KEYS = ("xring", "x", "pring", "first")


def value(run):
    module = sys.modules.get("pyfft_tpu_torch.utils.profiling")
    counts = getattr(module, "counts", None)
    if counts is None:
        return None
    got = counts()
    launches = [got.get(f"launch.K5.{k}", 0) for k in KEYS]
    return launches[0] / sum(launches) if sum(launches) else None
