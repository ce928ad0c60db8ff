"""Readings that the comparison's limits are set from, on the card.

    python3 portbench/calibrate.py --workload c64_3d_256.stream \\
        --seeds 12 --control-seeds 3 --seconds 1

Runs the cell in one process at its own size and load: the port on
``--seeds`` seeds, then the control (``system.Control``: the reference in
the program's place, one precision below the configuration's) on
``--control-seeds`` others, each a short window of ``--seconds`` that
issues at least the steps the check keeps.  Prints one JSON line a run
and then, for each number compared, the lower reading (the largest the
port gave), the upper one (the smallest the control gave) and the limit
the configuration holds.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as entry  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    entry.isolate()
    import torch
    from portbench import harness, registry, system

    cell, config, mix = registry.resolve(args.workload)
    if not torch.cuda.is_available():
        entry.fail("needs a CUDA card")
    readings = {"port": {}, "control": {}}
    seeds = [args.first_seed + 7919 * k
             for k in range(args.seeds + args.control_seeds)]
    for k, seed in enumerate(seeds):
        side = "port" if k < args.seeds else "control"
        sut = (system.port(config, "cuda:0") if side == "port"
               else system.Control(config, "cuda:0"))
        t0 = time.monotonic()
        r = harness.run(args.workload, cell, config, mix, seed=seed,
                        seconds=args.seconds, traced=False, device="cuda:0",
                        metrics=[], started=t0, clock=time.monotonic,
                        system=sut, log=lambda s: None)
        del sut
        print(json.dumps({"side": side, "seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "s": time.monotonic() - t0}), flush=True)
        for name, c in r["checks"].items():
            readings[side].setdefault(name, []).append(c["value"])
    for name, lows in readings["port"].items():
        ups = readings["control"].get(name, [])
        print(json.dumps({"number": name, "lower": max(lows),
                          "upper": min(ups) if ups else None,
                          "limit": config["limits"][name],
                          "port": lows, "control": ups}), flush=True)


if __name__ == "__main__":
    main()
