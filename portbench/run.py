"""Run one cell of the port's benchmark on the card it is started on.

    python3 portbench/run.py --workload c64_3d_256.stream --seed 7 \\
        --seconds 10 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error.  Exits non-zero,
printing no result, where there is no card, where the program is not in
this checkout, or where JAX or the JAX package got loaded.

Before the program is imported, the autotune record is pointed at a path
under ``TMPDIR`` that holds none, and the kernel caches at fixed paths
inside the checkout: ``build/pyfft_tpu_torch/``, where the program builds
its kernels, and ``build/portbench/`` for the toolchains' own caches.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"


def isolate() -> None:
    """The run's environment, before torch or the program is imported."""
    tune = Path(tempfile.gettempdir()) / "portbench" / "no-tune-record.json"
    tune.unlink(missing_ok=True)
    os.environ["PYFFT_TPU_TORCH_TUNE_FILE"] = str(tune)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    # one process with few threads: no CPU thread pool beside the host path
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    # the checkout, not this script's folder, heads the import path
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(2)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return res.stdout.strip() or f"unknown (rc {res.returncode})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    isolate()
    import torch
    from portbench import harness, registry
    torch.set_num_threads(1)

    cell, config, mix = registry.resolve(args.workload)
    chips = registry.benchmark()
    chips = next((w["chips"] for w in chips["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        fail(f"{args.workload} is no workload of BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import pyfft_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    if ROOT not in Path(pyfft_tpu_torch.__file__).resolve().parents:
        fail(f"pyfft_tpu_torch comes from {pyfft_tpu_torch.__file__}, "
             f"not from this checkout ({ROOT})")

    metrics = registry.metrics_for(args.workload, bool(args.trace))
    result = harness.run(args.workload, cell, config, mix, seed=args.seed,
                         seconds=args.seconds, traced=bool(args.trace),
                         device="cuda:0", metrics=metrics, started=STARTED,
                         clock=time.monotonic)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"loaded modules it must not: {bad}")
    dev = result["device"]
    dev.update(platform="gpu", kind=torch.cuda.get_device_name(0),
               power_limit=power_limit())
    result["device"] = {k: dev[k] for k in
                        ("platform", "kind", "count", "memory_peak_bytes",
                         "busy_s", "window_s", "power_limit") if k in dev}
    result["checks"] = result.pop("checks")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
