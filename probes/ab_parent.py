"""Time the kernels of changed sources against another checkout's build of
the same sources, in one process on one CUDA card, and compare their
outputs.

    python3 probes/ab_parent.py OTHER_CHECKOUT

OTHER_CHECKOUT is an unpacked copy of another commit (``git archive`` of
the parent, say).  Its ``local_rows.cu``, ``local_cols.cu``, ``fused2d.cu``
and ``fused2d_tiled.cu`` are built beside this checkout's, all eight at
once, and the same wrappers run each build in turn:

* the float kernels: the row kernel K1 at config 2 (planar and on the
  complex form's stride-2 planes) and at 2^24 points with rows of 8, 16,
  32, 64, 512, 1024 (config 3's row pass) and 8192, its interleaved form K2 at config
  2i and at 2048 x 8192, the complex128 row kernel K11 at the complex128
  2D path's row pass (16384 x 1024), planar and on the complex form's
  stride-2 planes, the column kernel K5 at config 6+'s two passes, config
  4's z pass (planar and stride-2 planes), config 3's column pass (planar
  and stride-2 planes) and every pass of the mid route (16384 x 1024 x 2)
  and of the huge route (2^27) and at 2^24 points with n = 8 to 512 (one
  plane), K11 at 2^24 points with n = 2048 and 4096 too, the complex128
  column kernel K12 at config 5's two
  passes (planar and on the complex form's stride-2 planes) and at the
  complex128 2D path's column pass (16 x 1024 x 1024), the digit-swapped
  row pass K4 at variant B's pass 2 and at its 2^25 points with rows of
  1024 and 4096, the multi-tile column pass K6 at config 4's z pass (c =
  1, 2, 8) and at variant B's pass 1 (`full` twiddle, c = 8), the fused
  2D kernel K8 at config 4 and at 2^24 points of each of its 15 plane
  shapes, planar and on the complex form's stride-2 planes, and the tiled
  one K9 at config 3 and at 16 planes of each of its 28 plane shapes;
* the int8 kernels (the stage K10, precision="int8"): K1+K10 at config 2
  and at 2048 x 8192 (f = 128), K2+K10 at config 2i and at 2048 x 8192
  interleaved, K5+K10 at config 3's column pass, K4+K10 at variant B's
  pass 2, K8+K10 at config 4 and at 16 x 512 x 512 (f = 128: W's slabs
  streamed, two cut runs a thread), K9+K10 at config 3 and at 16 x 512 x
  512 (f = 128).

Each is timed by CUDA events (``time_ms``) in four turns, other, this,
this, other, so that a drift of the card favours neither; then each build
runs once more on the same inputs and the largest |this - other| of the
outputs is printed beside the times.  The outputs are gated: K8 + K10's
(``K8+K10`` cases) must be bit-equal to the other build's, and every
kernel's within 2e-6 of the other build's largest |output| (the port's
complex64 gate); the script exits 1 if a case misses its gate.  The last
line is a JSON record with the card, the ratio this / other of the turns'
means and that difference for every kernel.  A checkout older than the K4 + K10 entry
(``pyfft_local_rows_swap_i8``) runs K4 + K10 through its column entry,
which takes the same arguments; one older than K4 + K10's ``group``
argument takes it without (the block's rows are its group at lanes =
128).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pyfft_tpu_torch.ops import build, fused2d, local  # noqa: E402
from pyfft_tpu_torch.utils.profiling import time_ms  # noqa: E402

SOURCES = ("local_rows", "local_cols", "fused2d", "fused2d_tiled")
# the largest |this - other| a kernel's outputs may show, over the other
# build's largest |output| (K8 + K10's: none)
GATE = 2e-6
# K8's plane shapes: (ny, nx), powers of two from 128 to 2048, 2^18 points
# at most
FUSED_SHAPES = [(1 << a, 1 << b) for a in range(7, 12) for b in range(7, 12)
                if a + b <= 18]
# K9's plane shapes: (ny, nx), powers of two from 128 to 8192, 2^20 points
# at most
TILED_SHAPES = [(1 << a, 1 << b) for a in range(7, 14) for b in range(7, 14)
                if a + b <= 20]
DTYPES = (torch.float32, torch.float64)


def load_all(other: Path) -> dict:
    """{"this": {source: CDLL}, "other": {...}}: every source of both
    checkouts built at once, one nvcc each (the other checkout's libraries
    are named by its own sources, so they sit beside this one's)."""
    libs = {"this": {}, "other": {}}
    errors = []

    def one(which, name):
        try:
            libs[which][name] = build.load(
                name, other if which == "other" else None)
        except Exception as e:          # reported below, after the joins
            errors.append(f"{which} {name}: {e}")

    threads = [threading.Thread(target=one, args=(w, n))
               for w in libs for n in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return libs


def bind(lib, binder, *args):
    """The typed entry points ``binder`` makes, taken from ``lib``."""
    saved = build.load
    build.load = lambda name, *args, **kw: lib
    try:
        return binder(*args)
    finally:
        build.load = saved


def without_group(fn):
    """A K4 + K10 entry point from before its ``group`` argument, called
    as the current one: the group (the block's rows where lanes = 128, all
    the older entry took) is dropped."""
    def call(*args):
        return fn(*args[:-2], args[-1])
    return call


def bindings(libs: dict, csrc: Path | None = None) -> dict:
    """Every entry point the timed wrappers look up, by the name of the
    lookup function in ``local`` or ``fused2d``, bound to ``libs``, built
    from the sources in ``csrc`` (this checkout's by default)."""
    rows, cols = libs["local_rows"], libs["local_cols"]
    src = ((csrc or build.CSRC) / "local_cols.cu").read_text()
    if not hasattr(cols, "pyfft_local_rows_swap_i8"):
        swap_i8 = lambda: without_group(local._cols_i8_lib.__wrapped__()[0])
    elif "int swap_store, int group," not in src:
        def swap_i8():
            fn = cols.pyfft_local_rows_swap_i8
            fn.argtypes = ([ctypes.c_void_p] * 8
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            return without_group(fn)
    else:
        swap_i8 = local._rows_swap_i8_fn.__wrapped__
    return {
        "_cols_lib": {d: bind(cols, local._cols_lib.__wrapped__, d)
                      for d in DTYPES},
        "_rows_fn": {d: bind(rows, local._rows_fn.__wrapped__, d)
                     for d in DTYPES},
        "_rows_il_fn": bind(rows, local._rows_il_fn.__wrapped__),
        "_rows_i8_fn": bind(rows, local._rows_i8_fn.__wrapped__),
        "_rows_il_i8_fn": bind(rows, local._rows_il_i8_fn.__wrapped__),
        "_cols_i8_lib": bind(cols, local._cols_i8_lib.__wrapped__),
        "_rows_swap_fn": bind(cols, local._rows_swap_fn.__wrapped__),
        "_ctile_fn": bind(cols, local._ctile_fn.__wrapped__),
        "_rows_swap_i8_fn": bind(cols, swap_i8),
        "_lib": bind(libs["fused2d"], fused2d._lib.__wrapped__),
        "_tiled_lib": bind(libs["fused2d_tiled"],
                           fused2d._tiled_lib.__wrapped__),
    }


def cases() -> list:
    """(name, run): ``run()`` launches one kernel and returns its output
    tensors, on inputs made once from a seed."""
    g = torch.Generator(device="cuda").manual_seed(5)

    def planes(shape, real=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda", dtype=real),
                torch.randn(shape, generator=g, device="cuda", dtype=real))

    def empty(shape, real=torch.float32):
        return (torch.empty(shape, device="cuda", dtype=real),
                torch.empty(shape, device="cuda", dtype=real))

    def oshape(shape, kw):
        return local._col_out_shape(shape, 1, kw.get("swap_store", False),
                                    kw.get("swap_mid", 0))

    def cols(shape, real=torch.float32, **kw):
        re, im = planes(shape, real)
        o = empty(oshape(shape, kw), real)
        return lambda: local.fft_axis(re, im, -1, axis=1, out=o, **kw)

    def cols_complex(shape, real=torch.float64, **kw):   # stride-2 planes
        v = torch.view_as_real(torch.complex(*planes(shape, real)))
        w = torch.view_as_real(torch.empty(
            oshape(shape, kw), device="cuda",
            dtype=torch.complex128 if real == torch.float64
            else torch.complex64))
        return lambda: local.fft_axis(v[..., 0], v[..., 1], -1, axis=1,
                                      out=(w[..., 0], w[..., 1]), **kw)

    def rows(shape, precision, real=torch.float32):
        re, im = planes(shape, real)
        o = empty(shape, real)
        return lambda: local.fft_axis(re, im, -1, out=o, precision=precision)

    def rows_complex(shape, real=torch.float32):        # stride-2 planes
        v = torch.view_as_real(torch.complex(*planes(shape, real)))
        w = torch.view_as_real(torch.empty(
            shape, device="cuda", dtype=torch.complex128
            if real == torch.float64 else torch.complex64))
        return lambda: local.fft_axis(v[..., 0], v[..., 1], -1,
                                      out=(w[..., 0], w[..., 1]))

    def rows_il(shape, precision):
        v = torch.view_as_real(torch.complex(*planes(shape))).flatten(-2)
        vo = torch.empty_like(v)
        return lambda: (local.fft_rows_interleaved(v, -1, out=vo,
                                                   precision=precision),)

    def swap(precision, n=2048):
        re, im = planes((8, (1 << 22) // n, n))
        o = empty((8, n, (1 << 22) // n))
        return lambda: local.fft_rows_swap(re, im, -1, out=o,
                                           precision=precision)

    def ctile(shape, c, **kw):
        re, im = planes(shape)
        o = empty(shape)
        return lambda: local.fft_axis(re, im, -1, axis=1, ctile=c, out=o,
                                      **kw)

    def fused(fn, shape, precision):
        re, im = planes(shape)
        o = empty(shape)
        return lambda: fn(re, im, -1, out=o, precision=precision)

    def fused_complex(shape):                          # stride-2 planes
        v = torch.view_as_real(torch.complex(*planes(shape)))
        w = torch.view_as_real(torch.empty(shape, device="cuda",
                                           dtype=torch.complex64))
        return lambda: fused2d.fft2_fused(v[..., 0], v[..., 1], -1,
                                          out=(w[..., 0], w[..., 1]))

    full = dict(tw_n=1 << 22, swap_store=True)
    f64 = torch.float64
    return [
        ("K5 config 6+ pass 1 (full + swap_store)",
         cols((8, 2048, 2048), **full)),
        ("K5 config 6+ pass 2 (plain store)", cols((8, 2048, 2048))),
        ("K5 config 4 z pass", cols((1, 256, 65536))),
        ("K5 config 4 z pass stride-2 planes (complex form)",
         cols_complex((1, 256, 65536), torch.float32)),
        ("K5 config 3 column pass (16, 1024, 1024)",
         cols((16, 1024, 1024))),
        ("K5 config 3 column pass stride-2 planes (complex form)",
         cols_complex((16, 1024, 1024), torch.float32)),
        ("K5 mid pass 1 (2, 128, 131072; strided + swap_mid)",
         cols((2, 128, 131072), tw_n=128 * 128, tw_mode="strided",
              tw_period=1024, swap_mid=1024)),
        ("K5 mid pass 2 (2, 128, 131072; plain store)",
         cols((2, 128, 131072))),
        ("K5 huge pass 1 (1, 512, 262144; factored + swap_store)",
         cols((1, 512, 262144), tw_n=1 << 27, tw_mode="factored",
              swap_store=True)),
        ("K5 huge pass 2 (1, 512, 262144; strided + swap_mid)",
         cols((1, 512, 262144), tw_n=1 << 18, tw_mode="strided",
              tw_period=512, swap_mid=512)),
        ("K5 huge pass 3 (1, 512, 262144; plain store)",
         cols((1, 512, 262144))),
        *[(f"K5 (1, {n}, {(1 << 24) // n})", cols((1, n, (1 << 24) // n)))
          for n in (8, 16, 32, 64, 128, 256, 512)],
        ("K12 config 5 pass 1 (full + swap_store)",
         cols((64, 2048, 2048), f64, **full)),
        ("K12 config 5 pass 2 (plain store)", cols((64, 2048, 2048), f64)),
        ("K12 config 5 pass 1 complex form (full + swap_store)",
         cols_complex((64, 2048, 2048), **full)),
        ("K12 config 5 pass 2 complex form (plain store)",
         cols_complex((64, 2048, 2048))),
        ("K12 c128 2D column pass (16, 1024, 1024)",
         cols((16, 1024, 1024), f64)),
        ("K8 config 4 (256^3)",
         fused(fused2d.fft2_fused, (256, 256, 256), "highest")),
        ("K9 config 3 (16 x 1024^2)",
         fused(fused2d.fft2_fused_tiled, (16, 1024, 1024), "highest")),
        ("K9 16 x 512^2",
         fused(fused2d.fft2_fused_tiled, (16, 512, 512), "highest")),
        ("K1 config 2 (4096 x 4096)", rows((4096, 4096), "highest")),
        ("K1 config 2 stride-2 planes (complex form)",
         rows_complex((4096, 4096))),
        ("K2 config 2i (4096 x 4096 interleaved)",
         rows_il((4096, 4096), "highest")),
        ("K2 2048 x 8192 interleaved", rows_il((2048, 8192), "highest")),
        *[(f"K1 ({(1 << 24) // n}, {n})",
           rows(((1 << 24) // n, n), "highest"))
          for n in (8, 16, 32, 64, 512, 1024, 8192)],
        ("K11 c128 2D row pass (16384, 1024)",
         rows((16384, 1024), "highest", f64)),
        ("K11 c128 2D row pass complex form (16384, 1024)",
         rows_complex((16384, 1024), f64)),
        ("K11 (8192, 2048)", rows((8192, 2048), "highest", f64)),
        ("K11 (4096, 4096)", rows((4096, 4096), "highest", f64)),
        ("K4 variant B pass 2 (8, 2048, 2048)", swap("highest")),
        ("K4 (8, 4096, 1024)", swap("highest", 1024)),
        ("K4 (8, 1024, 4096)", swap("highest", 4096)),
        ("K6 config 4 z pass (1, 256, 65536) c=8",
         ctile((1, 256, 65536), 8)),
        ("K6 config 4 z pass (1, 256, 65536) c=2",
         ctile((1, 256, 65536), 2)),
        ("K6 config 4 z pass (1, 256, 65536) c=1",
         ctile((1, 256, 65536), 1)),
        ("K6 variant B pass 1 (8, 2048, 2048; full twiddle) c=8",
         ctile((8, 2048, 2048), 8, tw_n=1 << 22)),
        ("K1+K10 config 2 (4096 x 4096, int8)", rows((4096, 4096), "int8")),
        ("K1+K10 2048 x 8192 (int8, f=128)", rows((2048, 8192), "int8")),
        ("K2+K10 config 2i (4096 x 4096 interleaved, int8)",
         rows_il((4096, 4096), "int8")),
        ("K2+K10 2048 x 8192 interleaved (int8, f=128)",
         rows_il((2048, 8192), "int8")),
        ("K5+K10 config 3 column pass (16, 1024, 1024; int8)",
         cols((16, 1024, 1024), precision="int8")),
        ("K4+K10 variant B pass 2 (8, 2048, 2048; int8, f=128)",
         swap("int8")),
        ("K8+K10 config 4 (256^3, int8)",
         fused(fused2d.fft2_fused, (256, 256, 256), "int8")),
        ("K9+K10 config 3 (16 x 1024^2, int8)",
         fused(fused2d.fft2_fused_tiled, (16, 1024, 1024), "int8")),
        ("K8+K10 16 x 512^2 (int8, f=128)",
         fused(fused2d.fft2_fused, (16, 512, 512), "int8")),
        ("K9+K10 16 x 512^2 (int8, f=128)",
         fused(fused2d.fft2_fused_tiled, (16, 512, 512), "int8")),
    ] + [case for ny, nx in FUSED_SHAPES for case in (
        (f"K8 {(1 << 24) // (ny * nx)} x {ny}x{nx}",
         fused(fused2d.fft2_fused, ((1 << 24) // (ny * nx), ny, nx),
               "highest")),
        (f"K8 {(1 << 24) // (ny * nx)} x {ny}x{nx} stride-2 planes",
         fused_complex(((1 << 24) // (ny * nx), ny, nx))))] + [
        (f"K9 16 x {ny}x{nx}",
          fused(fused2d.fft2_fused_tiled, (16, ny, nx), "highest"))
         for ny, nx in TILED_SHAPES if (ny, nx) not in ((1024, 1024),
                                                        (512, 512))]


def main(other: Path) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    csrc = other / "pyfft_tpu_torch" / "ops" / "csrc"
    libs = load_all(csrc)
    bound = {"this": bindings(libs["this"]),
             "other": bindings(libs["other"], csrc)}
    saved = {k: getattr(fused2d if k in ("_lib", "_tiled_lib") else local, k)
             for k in bound["this"]}

    def use(which):
        for k, v in bound[which].items():
            mod = fused2d if k in ("_lib", "_tiled_lib") else local
            if k in ("_cols_lib", "_rows_fn"):
                setattr(mod, k, lambda d, v=v: v[d])
            else:
                setattr(mod, k, lambda v=v: v)

    def outputs(run):
        got = run()
        torch.cuda.synchronize()
        return [t.clone() for t in got]

    rows, missed = {}, []
    try:
        for name, run in cases():
            turns = []
            for which in ("other", "this", "this", "other"):
                use(which)
                turns.append((which, time_ms(run)))
            use("other")
            want = outputs(run)
            use("this")
            got = outputs(run)
            diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
            peak = max(float(b.abs().max()) for b in want)
            gate = 0.0 if name.startswith("K8+K10") else GATE * peak
            if not diff <= gate:
                missed.append(f"{name}: max |this - other| {diff:.3e} "
                              f"above its gate {gate:.3e}")
            mean = {w: sum(t for x, t in turns if x == w) / 2
                    for w in ("this", "other")}
            ratio = mean["this"] / mean["other"]
            rows[name] = {"turns": turns, "ratio": ratio,
                          "max_abs_diff": diff}
            print(f"{name}: " + " / ".join(f"{w} {t:.4f}" for w, t in turns)
                  + f" ms; this / other {ratio:.4f}; max |this - other| "
                  f"{diff:.3e}")
            torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            setattr(fused2d if k in ("_lib", "_tiled_lib") else local, k, v)
    for line in missed:
        print(f"gate missed: {line}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "ab": rows, "gates_missed": len(missed)}))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve()))
