"""The share of the card's ``Plan.execute`` calls that replayed a call
record: ``record.hit`` / (``record.hit`` + ``record.miss`` +
``record.generic``) in the program's registry
(``pyfft_tpu_torch.utils.profiling``, read where the run imported it;
never imported here), over the whole run.  Reads
``record_hit_share.<cell>``.  None where the program keeps no such
registry or counted no ``record.*`` key."""

import sys


def value(run):
    module = sys.modules.get("pyfft_tpu_torch.utils.profiling")
    counts = getattr(module, "counts", None)
    if counts is None:
        return None
    got = counts()
    calls = [got.get(f"record.{k}", 0) for k in ("hit", "miss", "generic")]
    return calls[0] / sum(calls) if sum(calls) else None
