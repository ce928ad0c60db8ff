"""Where the time of the complex128 cluster column kernel (K12 from n =
1024) and of the tiled 2D kernel (K9) goes: pieces removed and shape knobs
changed, one build each, on one CUDA card.

    python3 probes/float_split.py

Builds, from copies of this checkout's ``csrc/`` patched in a temporary
directory (the checkout is not touched), ``local_cols.cu`` (K12) and
``fused2d_tiled.cu`` (K9) in these variants, one nvcc each, eight at a
time:

  full      the sources as they are (with ``-Xptxas -v``: the new
            kernels' registers and spills are printed)
  notw      no twiddle multiplies (the chains', the exchange's w_n^(b*k')
            and K12's table in the store pass)
  copy      nor the DFTs' arithmetic, nor K12's chain, and every exchange
            reads its own block's buffer instead of DSMEM: K12 is its
            loads, one shared-memory pass and its stores; K9 keeps its
            stages' shared-memory shuffles
  g4        K12's first design, (G, C) = (2, 16), (4, 16), (8, 16) at n =
            1024, 2048, 4096 on every layout, 128 KB blocks, one an SM
  m1        K12's (G, C) with registers for one block an SM
  s2c16     K12 on stride-2 planes with the planar table (C = 16)
  r8        K9's chains on radix 8 (a shared-memory round trip more)
  twd0      K9's chains reading every twiddle of a butterfly (fifteen
            at radix 16)
  pad0      K9's phase 1 without chain_index's padding
  nohint    K9 without its L2 policies (evict_normal)
  p5, p7,   K9's planes in flight fixed at 5, 7 (the clusters the card
  p16       holds) or 16 (a grid of one cluster a plane)
  pct50     K9's planes cap at half the L2 (3 planes of 2^20 points)
  run32     K9's phase 2 in runs of 32 floats (128 bytes), y split over
            groups of 2 to 8 blocks from ny = 512

and times each by CUDA events (``time_ms``, the full variant first and
last) on its kernel's shapes: K12 at config 5's two passes (2^22 x 64
complex128, split 2048 x 2048: pass 1 the full twiddle and the swapped
store, pass 2 the plain store), planar and on the complex form's stride-2
planes, and the complex128 2D column pass (16 x 1024 x 1024); K9 at config
3 (16 x 1024 x 1024) and 16 x 512 x 512.  Every patch asserts that its
text is in the sources, so an edited kernel fails here instead of timing
the wrong thing.  The last line is a JSON record with the card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

import ab_parent  # noqa: E402
from pyfft_tpu_torch.ops import build, fused2d, local  # noqa: E402
from pyfft_tpu_torch.utils.profiling import time_ms  # noqa: E402

K12, K9 = "local_cols", "fused2d_tiled"

XCOLS = ("#define PYFFT_XCOLS_F64(X) X(10, 4, 16, 2) X(11, 8, 16, 2) "
         "X(12, 8, 16, 1)")
XCOLS_S2 = ("#define PYFFT_XCOLS_F64_S2(X) X(10, 2, 8, 2) X(11, 4, 8, 2) "
            "X(12, 8, 8, 2)")

# K9's constant chain options (fused2d_tiled.cu's ShapeF)
KNOBS = "static constexpr bool PAD = true, TWD = true, R16 = true;"

# (file, text, replacement) steps, by name
STEPS = {
    "notw": [
        ("cluster_cols.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("cluster_cols.cuh",
         "    for (int b = 1; b < G; ++b) u[i][b] = cmul(u[i][b], "
         "__ldg(&tw[b * kp]));\n", ""),
        ("chain.cuh", "    if (NS > 1) {", "    if (NS < 0) {"),
        ("local_cols.cu",
         "    double2 w = __ldg(&io.ta[k * io.ak + q * io.aq]);",
         "    double2 w = make_double2(1.0, 0.0);")],
    "noarith": [
        ("cluster_cols.cuh", "    dft<R>(v[b], s);\n", ""),
        ("cluster_cols.cuh", "    dft<G>(u[i], s);\n", ""),
        ("chain.cuh", "    dft<R>(v[b], s);\n", "")],
    "copy": [
        ("local_cols.cu", "  xt_chain<X, SWAP>(sm, tw, s);\n", ""),
        ("cluster_cols.cuh",
         "    const V* src = cluster.map_shared_rank(sm, g0 + b);",
         "    const V* src = sm;")],
    "g4": [("local_cols.cu", XCOLS, "#define PYFFT_XCOLS_F64(X) "
            "X(10, 2, 16, 1) X(11, 4, 16, 1) X(12, 8, 16, 1)"),
           ("local_cols.cu", XCOLS_S2, "#define PYFFT_XCOLS_F64_S2(X) "
            "X(10, 2, 16, 1) X(11, 4, 16, 1) X(12, 8, 16, 1)")],
    "m1": [("local_cols.cu", XCOLS, "#define PYFFT_XCOLS_F64(X) "
            "X(10, 4, 16, 1) X(11, 8, 16, 1) X(12, 8, 16, 1)")],
    "s2c16": [("local_cols.cu", XCOLS_S2, "#define PYFFT_XCOLS_F64_S2(X) "
               "X(10, 4, 16, 2) X(11, 8, 16, 2) X(12, 8, 16, 1)")],
    "nohint": [
        ("fused2d_tiled.cu", "createpolicy.fractional.L2::evict_first.b64",
         "createpolicy.fractional.L2::evict_normal.b64"),
        ("fused2d_tiled.cu", "createpolicy.fractional.L2::evict_last.b64",
         "createpolicy.fractional.L2::evict_normal.b64")],
    "r8": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("R16 = true",
                                                     "R16 = false"))],
    "twd0": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("TWD = true",
                                                       "TWD = false"))],
    "pad0": [("fused2d_tiled.cu", KNOBS, KNOBS.replace("PAD = true",
                                                       "PAD = false"))],
    "pct50": [("fused2d_tiled.cu", "(long long)l2 / (8LL",
               "(long long)l2 / 2 / (8LL")],
    "run32": [("fused2d_tiled.cu", "constexpr int RUN = 8;",
               "constexpr int RUN = 32;")],
}

# name -> (sources built, steps taken in order, -D macros)
VARIANTS = {
    "full": ((K12, K9), [], {}),
    "notw": ((K12, K9), ["notw"], {}),
    "copy": ((K12, K9), ["notw", "noarith", "copy"], {}),
    "g4": ((K12,), ["g4"], {}),
    "m1": ((K12,), ["m1"], {}),
    "s2c16": ((K12,), ["s2c16"], {}),
    "r8": ((K9,), ["r8"], {}),
    "twd0": ((K9,), ["twd0"], {}),
    "pad0": ((K9,), ["pad0"], {}),
    "nohint": ((K9,), ["nohint"], {}),
    "p5": ((K9,), [], {"PYFFT_TILED_PLANES": 5}),
    "p7": ((K9,), [], {"PYFFT_TILED_PLANES": 7}),
    "p16": ((K9,), [], {"PYFFT_TILED_PLANES": 16}),
    "pct50": ((K9,), ["pct50"], {}),
    "run32": ((K9,), ["run32"], {}),
}


def patched(variant: str, tmp: Path) -> Path:
    """A copy of csrc/ with the variant's steps applied."""
    d = tmp / variant
    shutil.copytree(build.CSRC, d)
    for step in VARIANTS[variant][1]:
        for name, text, new in STEPS[step]:
            f = d / name
            src = f.read_text()
            if src.count(text) != 1:
                raise RuntimeError(f"{variant}: the patch text is not in "
                                   f"{name} once: {text!r}")
            f.write_text(src.replace(text, new))
    return d


def compile_all(tmp: Path) -> dict:
    """{(variant, source): CDLL}, eight nvcc at a time; the full variant's
    ptxas report kept as (variant, source, "log")."""
    out, errors = {}, {}
    slots = threading.Semaphore(8)

    def one(v, name, d):
        with slots:
            flags = [*build.NVCC_FLAGS] + (["-Xptxas", "-v"] if v == "full"
                                           else [])
            flags += [f"-D{k}={x}" for k, x in VARIANTS[v][2].items()]
            lib = d / f"lib{name}.so"
            res = subprocess.run([build._nvcc(), *flags, "-o", str(lib),
                                  str(d / f"{name}.cu")],
                                 capture_output=True, text=True)
            if res.returncode:
                errors[(v, name)] = res.stderr[-3000:]
                return
            out[(v, name)] = ctypes.CDLL(str(lib))
            out[(v, name, "log")] = res.stderr

    dirs = {v: patched(v, tmp) for v in VARIANTS}
    threads = [threading.Thread(target=one, args=(v, n, dirs[v]))
               for v, (names, _, _) in VARIANTS.items() for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"nvcc failed: {errors}")
    return out


# a kernel's mangled name -> its name <template arguments>
KERNEL = re.compile(r"(local_cols_x_kernel|fused2d_tiled_kernel)I(\w+?)E"
                    r"(?:EEv|Ev)")


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) of each new kernel in a
    ptxas -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        k = KERNEL.search(name or "")
        if k:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append([f"{k.group(1)}<{k.group(2)}>", int(m.group(1)),
                             spill])
                name = None
    return rows


def cases() -> list:
    """(kernel source, name, run): ``run()`` launches one kernel, on
    inputs made once from a seed."""
    g = torch.Generator(device="cuda").manual_seed(7)
    f64 = torch.float64

    def planes(shape, real):
        return (torch.randn(shape, generator=g, device="cuda", dtype=real),
                torch.randn(shape, generator=g, device="cuda", dtype=real))

    def cols(shape, form, **kw):
        L, n, T = shape
        oshape = (L, T, n) if kw.get("swap_store") else shape
        if form == "planar":
            re, im = planes(shape, f64)
            o = (torch.empty(oshape, device="cuda", dtype=f64),
                 torch.empty(oshape, device="cuda", dtype=f64))
        else:
            v = torch.view_as_real(torch.complex(*planes(shape, f64)))
            re, im = v[..., 0], v[..., 1]
            w = torch.view_as_real(torch.empty(oshape, device="cuda",
                                               dtype=torch.complex128))
            o = (w[..., 0], w[..., 1])
        return lambda: local.fft_axis(re, im, -1, axis=1, out=o, **kw)

    def tiled(shape):
        re, im = planes(shape, torch.float32)
        o = (torch.empty_like(re), torch.empty_like(im))
        return lambda: fused2d.fft2_fused_tiled(re, im, -1, out=o)

    full = dict(tw_n=1 << 22, swap_store=True)
    five = (64, 2048, 2048)
    return [
        (K12, "K12 config 5 pass 1 planar", cols(five, "planar", **full)),
        (K12, "K12 config 5 pass 2 planar", cols(five, "planar")),
        (K12, "K12 config 5 pass 1 complex", cols(five, "complex", **full)),
        (K12, "K12 config 5 pass 2 complex", cols(five, "complex")),
        (K12, "K12 c128 2D column pass (16, 1024, 1024)",
         cols((16, 1024, 1024), "planar")),
        (K9, "K9 config 3 (16 x 1024^2)", tiled((16, 1024, 1024))),
        (K9, "K9 16 x 512^2", tiled((16, 512, 512))),
    ]


COLS_BINDER = local._cols_lib.__wrapped__   # before any use() replaces it


def use(lib, name: str) -> None:
    """Route the wrappers of source ``name`` to ``lib``."""
    if name == K12:
        typed = {d: ab_parent.bind(lib, COLS_BINDER, d)
                 for d in ab_parent.DTYPES}
        local._cols_lib = lambda d: typed[d]
    else:
        typed = fused2d._typed(lib, K9)
        fused2d._tiled_lib = lambda: typed


def shape_line(lib) -> str:
    """K9's shape at config 3 as the variant builds it."""
    fn = lib.pyfft_fused2d_tiled_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(fused2d.TILED_SHAPE_KEYS))()
    if fn(10, 10, out):
        return "shape query failed"
    return ", ".join(f"{k} {v}" for k, v in zip(fused2d.TILED_SHAPE_KEYS,
                                                out))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    saved = (local._cols_lib, fused2d._tiled_lib)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        for name in (K12, K9):
            for kern, regs, spill in ptxas_report(libs[("full", name,
                                                        "log")]):
                print(f"ptxas {kern}: {regs} registers, {spill} bytes "
                      "spilled")
        for v, (names, _, _) in VARIANTS.items():
            if K9 in names:
                print(f"K9 {v} at config 3: {shape_line(libs[(v, K9)])}")
        try:
            for src, name, run in cases():
                order = [v for v, (names, _, _) in VARIANTS.items()
                         if src in names] + ["full"]
                t = {}
                for v in order:
                    use(libs[(v, src)], src)
                    t.setdefault(v, []).append(time_ms(run))
                ms = {v: sum(x) / len(x) for v, x in t.items()}
                result[name] = ms
                print(f"{name}: " + ", ".join(f"{v} {x:.4f}"
                                              for v, x in ms.items())
                      + " ms", flush=True)
                torch.cuda.empty_cache()
        finally:
            local._cols_lib, fused2d._tiled_lib = saved
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "split": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
