"""Smoke run of pyfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the package's main path, the batched 1D complex64 FFT with N = 4096
and batch 4096, through ``Plan`` and ``fft``/``ifft`` on the card, in five
phases, one or more lines each:

  1. device: requires CUDA (there is no CPU path) and prints the card's
     name and power limit as nvidia-smi reports them;
  2. build: compiles the row kernel from this checkout's sources;
  3. kernel: the row kernel against its plain torch version and numpy.fft
     for every n from 8 to 8192, 1 and 130 rows, forward and inverse with
     a postscale, planar, stride-2 and in-place operands;
  4. main path: the 4096 x 4096 transform through Plan.execute (complex
     and planar forms, inverse round trip) and fft/ifft, against
     numpy.fft, with the kernel's launch count read around the run;
  5. timings by CUDA events (median of 20 after warm-up): kernel, plain
     version, the card's copy bandwidth and the kernel's share of the
     single-pass roofline derived from it, and cuFFT for context; before
     timing, the kernel is held against its plain version at this shape,
     planar and complex form.

Any failure raises and the script exits non-zero.  The line before the
last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 2e-6          # complex64 gate, max error over peak magnitude
N, BATCH = 4096, 4096


def rel_err(got, ref) -> float:
    got = np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(name: str, err: float, tol: float = TOL) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


def to_np(re, im=None):
    if im is None:
        return re.cpu().numpy()
    return re.cpu().numpy() + 1j * im.cpu().numpy()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


def phase_build():
    import pyfft_tpu_torch
    from pyfft_tpu_torch.ops import build
    here = Path(__file__).resolve().parent
    if Path(pyfft_tpu_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError("pyfft_tpu_torch was not imported from this "
                           "checkout")
    t0 = time.perf_counter()
    build.load("local_rows")
    print(f"phase 2 build: local_rows.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{build.library_path('local_rows')}")


def phase_kernel():
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(1)
    for n in (1 << p for p in range(3, 14)):        # every kernel size
        worst_plain = worst_np = 0.0
        cases = 0
        for rows in (1, 130):
            x = (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            for sign, post in ((-1, 0.5), (+1, 1.0 / n)):
                ref = (np.fft.fft(x.astype(np.complex128)) if sign < 0
                       else np.fft.ifft(x.astype(np.complex128)) * n) * post
                xc = torch.from_numpy(x).cuda()
                plain = to_np(*local.fft_rows_plain(
                    xc.real.contiguous(), xc.imag.contiguous(), sign, post))
                for mode in ("planar", "stride2", "inplace"):
                    if mode == "planar":
                        re, im = xc.real.contiguous(), xc.imag.contiguous()
                        out = None
                    else:
                        v = torch.view_as_real(xc.clone())
                        re, im = v[..., 0], v[..., 1]
                        out = (re, im) if mode == "inplace" else None
                    rr, ii = local.fft_axis(re, im, sign, postscale=post,
                                            out=out)
                    torch.cuda.synchronize()
                    if mode == "inplace" and rr.data_ptr() != re.data_ptr():
                        raise AssertionError("in-place launch wrote elsewhere")
                    got = to_np(rr, ii)
                    e_plain, e_np = rel_err(got, plain), rel_err(got, ref)
                    tag = f"n={n} rows={rows} sign={sign} {mode}"
                    check(f"kernel vs plain {tag}", e_plain)
                    check(f"kernel vs numpy {tag}", e_np)
                    worst_plain = max(worst_plain, e_plain)
                    worst_np = max(worst_np, e_np)
                    cases += 1
        print(f"phase 3 kernel n={n}: {cases} cases, max rel err vs plain "
              f"{worst_plain:.3e}, vs numpy {worst_np:.3e} (gate {TOL:.0e})")


def phase_main_path():
    import pyfft_tpu_torch
    from pyfft_tpu_torch.ops import local
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((BATCH, N))
         + 1j * rng.standard_normal((BATCH, N))).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128))
    xt = torch.from_numpy(x).cuda()
    re, im = xt.real.contiguous(), xt.imag.contiguous()
    torch.cuda.synchronize()

    plan = pyfft_tpu_torch.Plan((N,), device="cuda")
    kinds = [p.executor for p in plan._exec_plan.passes]
    if kinds != ["local"]:
        raise AssertionError(f"config 2 plan is {plan!r}, not one local pass")

    local.LAUNCHES = 0
    y = plan.execute(xt)
    rr, ii = plan.execute(re, im)
    back = plan.execute(y, inverse=True)
    yf = pyfft_tpu_torch.fft(xt)
    yb = pyfft_tpu_torch.ifft(yf)
    torch.cuda.synchronize()
    launches = local.LAUNCHES

    errs = {"complex": rel_err(to_np(y), ref),
            "planar": rel_err(to_np(rr, ii), ref),
            "roundtrip": rel_err(to_np(back), x),
            "fft": rel_err(to_np(yf), ref),
            "ifft(fft)": rel_err(to_np(yb), x)}
    for k, e in errs.items():
        check(f"config 2 {k}", e)
    if launches != 5:
        raise AssertionError(f"the main path made {launches} kernel "
                             f"launches, expected 5")
    print(f"phase 4 main path: {plan!r}, kernel launches {launches}, "
          + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
          + f" (gate {TOL:.0e})")
    return xt, re, im, launches


def phase_timings(xt, re, im):
    from pyfft_tpu_torch.ops import local
    from pyfft_tpu_torch.utils.profiling import (copy_bandwidth_gbs,
                                                 effective_gflops, time_ms)
    out = (torch.empty_like(re), torch.empty_like(im))
    xv = torch.view_as_real(xt)
    yv = torch.view_as_real(torch.empty_like(xt))

    def kernel():
        local.fft_axis(re, im, -1, out=out)

    def kernel_complex():
        local.fft_axis(xv[..., 0], xv[..., 1], -1,
                       out=(yv[..., 0], yv[..., 1]))

    def plain():
        local.fft_rows_plain(re, im, -1)

    def cufft():
        torch.fft.fft(xt)

    # Gate the kernel against its plain version at the main path's shape
    # (4096 rows of 4096), in both operand layouts, before timing it.
    kernel()
    kernel_complex()
    pr, pi = local.fft_rows_plain(re, im, -1)
    torch.cuda.synchronize()
    plain_np = to_np(pr, pi)
    max_abs = float(torch.maximum((out[0] - pr).abs().max(),
                                  (out[1] - pi).abs().max()))
    err = rel_err(to_np(*out), plain_np)
    err_complex = rel_err(to_np(yv[..., 0], yv[..., 1]), plain_np)
    check("config 2 kernel vs plain, planar", err)
    check("config 2 kernel vs plain, complex form", err_complex)
    ms = time_ms(kernel)
    ms_complex = time_ms(kernel_complex)
    plain_ms = time_ms(plain)
    cufft_ms = time_ms(cufft)
    bw = copy_bandwidth_gbs(256)
    moved = 2 * BATCH * N * 8                 # one read and one write
    roof_ms = moved / (bw * 1e9) * 1e3
    gf = effective_gflops(N, BATCH, ms * 1e-3)
    print(f"phase 5 timings: kernel planar {ms:.4f} ms = {gf:.1f} GFLOP/s, "
          f"kernel complex form {ms_complex:.4f} ms = "
          f"{effective_gflops(N, BATCH, ms_complex * 1e-3):.1f} GFLOP/s, "
          f"plain torch {plain_ms:.4f} ms, "
          f"copy bandwidth {bw:.1f} GB/s -> single-pass roofline "
          f"{roof_ms:.4f} ms, kernel at {roof_ms / ms:.3f} of it; "
          f"library cuFFT (torch.fft.fft, context only) {cufft_ms:.4f} ms; "
          f"kernel vs plain max abs err {max_abs:.3e}, max rel err "
          f"{err:.3e} planar, {err_complex:.3e} complex form "
          f"(gate {TOL:.0e})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs,
            "max_rel_err": max(err, err_complex)}


def main() -> int:
    phase_device()
    phase_build()
    phase_kernel()
    xt, re, im, launches = phase_main_path()
    t = phase_timings(xt, re, im)
    print(json.dumps({"kernels": [{
        "name": "local_rows",
        "route": "cuda",
        "source": "pyfft_tpu_torch/ops/csrc/local_rows.cu",
        "replaces": "pyfft_tpu/ops/pallas_local.py:743",
        "launches": launches,
        "max_abs_err": t["max_abs_err"],
        "max_rel_err": t["max_rel_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
