"""The share of the complex128 column kernel's launches that ran its
persistent cluster ring: ``launch.K12.ring`` / (``launch.K12.ring`` +
``launch.K12.x`` + ``launch.K12.first``) in the program's registry
(``pyfft_tpu_torch.utils.profiling``, read where the run imported it;
never imported here), over the whole run.  Reads ``k12_ring_share.<cell>``.
None where the program keeps no such registry or counted no
``launch.K12.*`` key (a program without the ring counts ``launch.K12.x``
alone: 0.0)."""

import sys

KEYS = ("ring", "x", "first")


def value(run):
    module = sys.modules.get("pyfft_tpu_torch.utils.profiling")
    counts = getattr(module, "counts", None)
    if counts is None:
        return None
    got = counts()
    launches = [got.get(f"launch.K12.{k}", 0) for k in KEYS]
    return launches[0] / sum(launches) if sum(launches) else None
