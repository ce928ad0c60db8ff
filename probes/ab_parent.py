"""Time the kernels of changed sources against another checkout's build of
the same sources, in one process on one CUDA card.

    python3 probes/ab_parent.py OTHER_CHECKOUT

OTHER_CHECKOUT is an unpacked copy of another commit (``git archive`` of
the parent, say).  Its ``local_rows.cu``, ``local_cols.cu``, ``fused2d.cu``
and ``fused2d_tiled.cu`` are built beside this checkout's, and the same
wrappers run each build in turn: the row kernel K1 at config 2, its
interleaved policy K2 at config 2i, K1 with the int8 stage (K1+K10) at
config 2, the column kernel K5 at config 6+'s two passes and config 4's z
pass, its complex128 instantiation K12 at config 5's two passes, the
digit-swapped row pass K4
at variant B's pass 2, the fused 2D kernel K8 at config 4 and the tiled
one K9 at config 3.  Each is timed by CUDA events (``time_ms``) in four
turns, other, this, this, other, so that a drift of the card favours
neither; prints a line per kernel and, as its last line, a JSON record
with the ratio this / other of the turns' means.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pyfft_tpu_torch.ops import build, fused2d, local  # noqa: E402
from pyfft_tpu_torch.utils.profiling import time_ms  # noqa: E402


def load_other(csrc: Path, name: str):
    """Build and load ``csrc/<name>.cu`` of the other checkout (its library
    is named by its own sources, so it sits beside this checkout's)."""
    saved = build.CSRC
    build.CSRC = csrc
    try:
        build._LOADED.pop(name, None)
        return build.load(name)
    finally:
        build.CSRC = saved
        build._LOADED.pop(name, None)


def bind(lib, binder, *args):
    """The typed entry points ``binder`` makes, taken from ``lib``."""
    saved = build.load
    build.load = lambda name: lib
    try:
        return binder(*args)
    finally:
        build.load = saved


def bind_2d(lib, name: str):
    """(launch, None, cluster) of a 2D kernel's library: the float entry
    points only, which every version of it has."""
    fn = getattr(lib, f"pyfft_{name}")
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cluster = getattr(lib, f"pyfft_{name}_cluster")
    cluster.argtypes = [ctypes.c_int, ctypes.c_int]
    cluster.restype = ctypes.c_int
    return fn, None, cluster


def main(other: Path) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    csrc = other / "pyfft_tpu_torch" / "ops" / "csrc"
    dtypes = (torch.float32, torch.float64)
    other_cols = load_other(csrc, "local_cols")
    cols = {"this": {d: local._cols_lib(d) for d in dtypes},
            "other": {d: bind(other_cols, local._cols_lib.__wrapped__, d)
                      for d in dtypes}}
    other_rows = load_other(csrc, "local_rows")
    row_fns = {"this": local._rows_fn(torch.float32),
               "other": bind(other_rows, local._rows_fn.__wrapped__,
                             torch.float32)}
    row_il = {"this": local._rows_il_fn(),
              "other": bind(other_rows, local._rows_il_fn.__wrapped__)}
    row_i8 = {"this": local._rows_i8_fn(),
              "other": bind(other_rows, local._rows_i8_fn.__wrapped__)}
    swap = {"this": local._rows_swap_fn(),
            "other": bind(other_cols, local._rows_swap_fn.__wrapped__)}
    f2d = {"this": bind_2d(build.load("fused2d"), "fused2d"),
           "other": bind_2d(load_other(csrc, "fused2d"), "fused2d")}
    tiled = {"this": bind_2d(build.load("fused2d_tiled"), "fused2d_tiled"),
             "other": bind_2d(load_other(csrc, "fused2d_tiled"),
                              "fused2d_tiled")}
    saved = (local._cols_lib, local._rows_fn, local._rows_swap_fn,
             fused2d._lib, fused2d._tiled_lib, local._rows_il_fn,
             local._rows_i8_fn)

    def use(which):
        local._cols_lib = lambda d: cols[which][d]
        local._rows_fn = lambda d: row_fns[which]
        local._rows_swap_fn = lambda: swap[which]
        fused2d._lib = lambda: f2d[which]
        fused2d._tiled_lib = lambda: tiled[which]
        local._rows_il_fn = lambda: row_il[which]
        local._rows_i8_fn = lambda: row_i8[which]

    def planes(shape, real):
        g = torch.Generator(device="cuda").manual_seed(5)
        return (torch.randn(shape, generator=g, device="cuda", dtype=real),
                torch.randn(shape, generator=g, device="cuda", dtype=real))

    cases = []
    for name, shape, real, kw in (
            ("K5 config 6+ pass 1 (full + swap_store)", (8, 2048, 2048),
             torch.float32, dict(tw_n=1 << 22, swap_store=True)),
            ("K5 config 6+ pass 2 (plain store)", (8, 2048, 2048),
             torch.float32, {}),
            ("K5 config 4 z pass", (1, 256, 65536), torch.float32, {}),
            ("K12 config 5 pass 1 (full + swap_store)", (64, 2048, 2048),
             torch.float64, dict(tw_n=1 << 22, swap_store=True)),
            ("K12 config 5 pass 2 (plain store)", (64, 2048, 2048),
             torch.float64, {})):
        re, im = planes(shape, real)
        L, n, T = shape
        oshape = (L, T, n) if kw.get("swap_store") else shape
        out = (torch.empty(oshape, device="cuda", dtype=real),
               torch.empty(oshape, device="cuda", dtype=real))
        cases.append((name, lambda re=re, im=im, out=out, kw=kw:
                      local.fft_axis(re, im, -1, axis=1, out=out, **kw),
                      (re, im, out)))
    re, im = planes((256, 256, 256), torch.float32)
    out = (torch.empty_like(re), torch.empty_like(im))
    cases.append(("K8 config 4 (256^3)", lambda re=re, im=im, out=out:
                  fused2d.fft2_fused(re, im, -1, out=out), (re, im, out)))
    re, im = planes((4096, 4096), torch.float32)
    out = (torch.empty_like(re), torch.empty_like(im))
    cases.append(("K1 config 2 (4096 x 4096)", lambda re=re, im=im, out=out:
                  local.fft_axis(re, im, -1, out=out), (re, im, out)))
    cases.append(("K1+K10 config 2 (4096 x 4096, int8)",
                  lambda re=re, im=im, out=out: local.fft_axis(
                      re, im, -1, precision="int8", out=out), (re, im, out)))
    v = torch.view_as_real(torch.complex(re, im)).flatten(-2)
    vout = torch.empty_like(v)
    cases.append(("K2 config 2i (4096 x 4096 interleaved)",
                  lambda v=v, vout=vout: local.fft_rows_interleaved(
                      v, -1, out=vout), (v, vout)))
    re, im = planes((8, 2048, 2048), torch.float32)
    out = (torch.empty_like(re), torch.empty_like(im))
    cases.append(("K4 variant B pass 2 (8, 2048, 2048)",
                  lambda re=re, im=im, out=out: local.fft_rows_swap(
                      re, im, -1, out=out),
                  (re, im, out)))
    re, im = planes((16, 1024, 1024), torch.float32)
    out = (torch.empty_like(re), torch.empty_like(im))
    cases.append(("K9 config 3 (16 x 1024^2)",
                  lambda re=re, im=im, out=out: fused2d.fft2_fused_tiled(
                      re, im, -1, out=out),
                  (re, im, out)))

    rows = {}
    try:
        for name, run, _ in cases:
            turns = []
            for which in ("other", "this", "this", "other"):
                use(which)
                turns.append((which, time_ms(run)))
            mean = {w: sum(t for x, t in turns if x == w) / 2
                    for w in ("this", "other")}
            ratio = mean["this"] / mean["other"]
            rows[name] = {"turns": turns, "ratio": ratio}
            print(f"{name}: " + " / ".join(f"{w} {t:.4f}" for w, t in turns)
                  + f" ms; this / other {ratio:.4f} "
                  + ("(within 3 %)" if abs(ratio - 1) <= 0.03
                     else "(NOT within 3 %)"))
    finally:
        (local._cols_lib, local._rows_fn, local._rows_swap_fn, fused2d._lib,
         fused2d._tiled_lib, local._rows_il_fn, local._rows_i8_fn) = saved
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve()))
