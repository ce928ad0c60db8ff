"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), in GiB: the benchmark's inputs,
the calls' outputs and workspaces, and the outputs it keeps to check."""


def value(run):
    return run.peak_bytes / 2**30
