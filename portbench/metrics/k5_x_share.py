"""The share of the complex64 column kernel's launches that ran its
cluster tile: ``launch.K5.x`` / (``launch.K5.x`` + ``launch.K5.pring`` +
``launch.K5.first``) in the program's registry
(``pyfft_tpu_torch.utils.profiling``, read where the run imported it;
never imported here), over the whole run.  Reads ``k5_x_share.<cell>``.
None where the program keeps no such registry or counted no
``launch.K5.*`` key."""

import sys

KEYS = ("x", "pring", "first")


def value(run):
    module = sys.modules.get("pyfft_tpu_torch.utils.profiling")
    counts = getattr(module, "counts", None)
    if counts is None:
        return None
    got = counts()
    launches = [got.get(f"launch.K5.{k}", 0) for k in KEYS]
    return launches[0] / sum(launches) if sum(launches) else None
