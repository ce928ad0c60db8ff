"""The row kernel at config 2 timed two ways, on one CUDA card: by CUDA
events around each call (``time_ms``, what ``probes/ab_parent.py`` and
``chip_smoke.py`` phase 5 read) and with the host ahead of the device
(``time_queued_ms``: the device's time alone, and the host's time a call).

    python3 probes/rows_queued.py

Four rounds of K1 on planar planes, K1 on the complex form's stride-2
planes and K2 on interleaved pairs, 4096 x 4096 each.  Where a wrapper's
host time a call nears the kernel's device time, the events read the host
and spread from round to round while the queued device time does not.
Prints the card's name and power limit first and one JSON object of every
number last.  Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyfft_tpu_torch.ops import local  # noqa: E402
from pyfft_tpu_torch.utils.profiling import time_ms, time_queued_ms  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (4096, 4096)

    def planes():
        return (torch.randn(shape, generator=g, device="cuda"),
                torch.randn(shape, generator=g, device="cuda"))

    re, im = planes()
    out = (torch.empty_like(re), torch.empty_like(im))
    v = torch.view_as_real(torch.complex(*planes()))
    w = torch.view_as_real(torch.empty(shape, device="cuda",
                                       dtype=torch.complex64))
    vi = torch.view_as_real(torch.complex(*planes())).flatten(-2)
    vo = torch.empty_like(vi)
    runs = {
        "K1 planar": lambda: local.fft_axis(re, im, -1, out=out),
        "K1 stride-2 planes": lambda: local.fft_axis(
            v[..., 0], v[..., 1], -1, out=(w[..., 0], w[..., 1])),
        "K2 pairs": lambda: local.fft_rows_interleaved(vi, -1, out=vo),
    }
    rows = {k: [] for k in runs}
    for rnd in range(4):
        for name, run in runs.items():
            events = time_ms(run)
            device, host = time_queued_ms(run, calls=50)
            rows[name].append({"events_ms": events, "device_ms": device,
                               "host_ms": host})
            print(f"round {rnd} {name}: events {events:.4f} ms, queued "
                  f"device {device:.4f} ms, host {host:.4f} ms a call",
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "rounds": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
