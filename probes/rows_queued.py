"""The row kernel at config 2, the column kernel and the complex128 row
kernel at their routed passes, and the plans that run them, timed two
ways, on one CUDA card: by CUDA events around each call (``time_ms``, what
``probes/ab_parent.py`` and ``chip_smoke.py`` phases 5, 9 and 13 read) and
with the host ahead of the device (``time_queued_ms``: the device's time
alone, and the host's time a call).

    python3 probes/rows_queued.py

Four rounds of K1 on planar planes, K1 on the complex form's stride-2
planes and K2 on interleaved pairs, 4096 x 4096 each; K5 on config 4's z
pass (1 x 256 x 65536, planar and stride-2 planes) and config 3's column
pass (16 x 1024 x 1024); K11 on the complex128 2D row pass (16384 x 1024,
planar and stride-2 planes); ``Plan.execute`` (complex form, no sync) of
configs 4, 3 and 6+ and of complex128 1024^2 x 16.  Where a wrapper's
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

from pyfft_tpu_torch import Plan  # noqa: E402
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

    def data(shape, dtype=torch.complex64):
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        return torch.complex(
            torch.randn(shape, generator=g, device="cuda", dtype=real),
            torch.randn(shape, generator=g, device="cuda", dtype=real))

    def kernel(shape, axis, complex_form, dtype=torch.complex64):
        x = data(shape, dtype)
        if complex_form:
            xv = torch.view_as_real(x)
            ov = torch.view_as_real(torch.empty_like(x))
            return lambda: local.fft_axis(xv[..., 0], xv[..., 1], -1,
                                          axis=axis,
                                          out=(ov[..., 0], ov[..., 1]))
        r, i = x.real.contiguous(), x.imag.contiguous()
        o = (torch.empty_like(r), torch.empty_like(i))
        return lambda: local.fft_axis(r, i, -1, axis=axis, out=o)

    def plan(shape, batch=1, dtype=torch.complex64):
        p = Plan(shape, dtype, device="cuda")
        x = data(((batch,) if batch > 1 else ()) + shape, dtype)
        return lambda: p.execute(x, wait_for_finish=False)

    c128 = torch.complex128
    runs.update({
        "K5 config 4 z pass planar": kernel((1, 256, 65536), 1, False),
        "K5 config 4 z pass stride-2 planes": kernel((1, 256, 65536), 1,
                                                     True),
        "K5 config 3 column pass planar": kernel((16, 1024, 1024), 1,
                                                 False),
        "K11 c128 row pass planar": kernel((16384, 1024), -1, False, c128),
        "K11 c128 row pass stride-2 planes": kernel((16384, 1024), -1, True,
                                                    c128),
        "Plan.execute config 4": plan((256, 256, 256)),
        "Plan.execute config 3": plan((1024, 1024), 16),
        "Plan.execute config 6+": plan((1 << 22,), 8),
        "Plan.execute c128 1024^2 x 16": plan((1024, 1024), 16, c128),
    })
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
