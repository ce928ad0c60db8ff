"""Where the time of the int8 kernels goes: each piece of K10's wgmma
stage removed in turn, on one CUDA card.

    python3 probes/int8_split.py

Builds, from copies of this checkout's ``csrc/`` patched in a temporary
directory (the checkout is not touched), ``local_rows.cu``,
``local_cols.cu``, ``fused2d.cu`` and ``fused2d_tiled.cu`` in six variants,
one nvcc each, eight at a time:

  full    the sources as they are (built with ``-Xptxas -v``: the int8
          kernels' registers, spills and serialised wgmma are printed)
  noput   the products, but no stores of the stage's outputs
  noprod  no wgmma either (the outputs are zeros)
  nocut   nor the cut of x into channels
  now     nor W's copy into shared memory and the waits on it
  occ     as now, with the shared memory of the float host alone (the
          blocks an SM the W buffers cost)

and times each on the int8 shapes of probes/ab_parent.py: K1+K10 at
config 2 and at 2048 x 8192, K2+K10 at config 2i, K5+K10 at config 3's
column pass, K4+K10 at variant B's pass 2, K8+K10 at config 4 and at 16 x
512 x 512 and K9+K10 at config 3 and at 16 x 512 x 512, by CUDA events
(``time_ms``), the full kernel first and last.  In K8+K10 without stores
the gather reads x's channels: the time is still the kernel's work.  The difference between neighbouring variants is
the time of the piece removed.  Every patch asserts that its text is in
the sources, so an edited stage fails here instead of timing the wrong
thing.  The last line is a JSON record with the card.
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

VARIANTS = ("full", "noput", "noprod", "nocut", "now", "occ")
SOURCES = ("local_rows", "local_cols", "fused2d", "fused2d_tiled")
CASES = ("K1+K10 config 2", "K1+K10 2048", "K2+K10 config 2i",
         "K5+K10", "K4+K10", "K8+K10", "K9+K10")
FUSED_SMEM = ("static constexpr int SMEM = HOST + cmax(PlanX::W_BYTES, "
              "PlanY::W_BYTES);")

# (file, text, replacement), cumulative: a variant takes its own patches
# and every earlier one's but noput's
PATCHES = {
    "noput": [("int8_stage.cuh", "      map.put2(n0 + 8 * j + 2 * t4, k,",
               "      if (acc[0] == 1234.5f)\n"
               "      map.put2(n0 + 8 * j + 2 * t4, k,")],
    "noprod": [("int8_stage.cuh", "wgmma_s8<NCH>(d, desc(",
                "if (m == 99999) wgmma_s8<NCH>(d, desc(")],
    "nocut": [("int8_stage.cuh",
               "*reinterpret_cast<uint4*>(xs + c * K2 * Q + off) =",
               "if (m == 99999)\n"
               "*reinterpret_cast<uint4*>(xs + c * K2 * Q + off) =")],
    "now": [("int8_stage.cuh",
             "int bytes, uint64_t* bar) {\n",
             "int bytes, uint64_t* bar) {\n  return;\n"),
            ("int8_stage.cuh",
             "void mbar_wait(uint64_t* bar, int parity) {\n",
             "void mbar_wait(uint64_t* bar, int parity) {\n  return;\n")],
    "occ": [("local_rows.cu",
             "static constexpr int SMEM = DATA + (TC ? Plan::W_BYTES : 0);",
             "static constexpr int SMEM = DATA;"),
            ("local_cols.cu",
             "static constexpr int SMEM = TC ? HOST + Plan::W_BYTES : "
             "DATA + Y;",
             "static constexpr int SMEM = TC ? HOST : DATA + Y;"),
            ("fused2d.cu", FUSED_SMEM, "static constexpr int SMEM = HOST;"),
            ("fused2d_tiled.cu", FUSED_SMEM,
             "static constexpr int SMEM = HOST;")],
}


def patched(variant: str, tmp: Path) -> Path:
    """A copy of csrc/ with the variant's patches applied."""
    d = tmp / variant
    shutil.copytree(build.CSRC, d)
    chain = {"full": [], "noput": ["noput"], "noprod": ["noprod"],
             "nocut": ["noprod", "nocut"],
             "now": ["noprod", "nocut", "now"],
             "occ": ["noprod", "nocut", "now", "occ"]}[variant]
    for step in chain:
        for name, text, new in PATCHES[step]:
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
    dirs = {v: patched(v, tmp) for v in VARIANTS}
    out, errors = {}, {}
    slots = threading.Semaphore(8)

    def one(v, name):
        with slots:
            build_one(v, name)

    def build_one(v, name):
        flags = [*build.NVCC_FLAGS] + (["-Xptxas", "-v"] if v == "full"
                                       else [])
        lib = dirs[v] / f"lib{name}.so"
        res = subprocess.run([build._nvcc(), *flags, "-o", str(lib),
                              str(dirs[v] / f"{name}.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            errors[(v, name)] = res.stderr[-3000:]
            return
        out[(v, name)] = ctypes.CDLL(str(lib))
        out[(v, name, "log")] = res.stderr

    threads = [threading.Thread(target=one, args=(v, n))
               for v in VARIANTS for n in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"nvcc failed: {errors}")
    return out


# an int8 kernel's mangled name -> local_<rows|cols>_i8_kernel or
# fused2d[_tiled]_i8_kernel <its template arguments>
KERNEL = re.compile(r"((?:local_(?:rows|cols)|fused2d(?:_tiled)?)_i8_kernel)"
                    r"I(\w+?)E(?:EEv|Ev)")


def short(mangled: str) -> str:
    m = KERNEL.search(mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, serialised) of each int8
    kernel in a ptxas -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "_i8_kernel" in name:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append([short(name), int(m.group(1)), spill, False])
                name = None
    serial = {short(m.group(1)) for m in
              re.finditer(r"serialized .* function '(\S+)'", log)}
    for r in rows:
        r[3] = r[0] in serial
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        for name in SOURCES:
            for kern, regs, spill, serial in ptxas_report(
                    libs[("full", name, "log")]):
                print(f"ptxas {kern}: {regs} registers, {spill} bytes "
                      f"spilled" + (", wgmma serialised" if serial else ""))
        bound = {v: ab_parent.bindings({n: libs[(v, n)] for n in SOURCES})
                 for v in VARIANTS}
        saved = {k: getattr(fused2d if k in ("_lib", "_tiled_lib") else local,
                            k) for k in bound["full"]}

        def use(v):
            for k, val in bound[v].items():
                mod = fused2d if k in ("_lib", "_tiled_lib") else local
                if k == "_cols_lib":
                    setattr(mod, k, lambda d, val=val: val[d])
                elif k == "_rows_fn":
                    setattr(mod, k, lambda d, val=val: val)
                else:
                    setattr(mod, k, lambda val=val: val)

        result = {}
        try:
            for name, run in ab_parent.cases():
                if not name.startswith(CASES):
                    continue
                t = {}
                for v in ("full",) + VARIANTS[1:] + ("full",):
                    use(v)
                    t.setdefault(v, []).append(time_ms(run))
                ms = {v: sum(x) / len(x) for v, x in t.items()}
                steps = {f"{a} - {b}": ms[a] - ms[b]
                         for a, b in zip(VARIANTS, VARIANTS[1:])}
                result[name] = {"ms": ms, "steps": steps}
                print(f"{name}: " + ", ".join(f"{v} {x:.4f}"
                                              for v, x in ms.items())
                      + " ms; " + ", ".join(f"{k} {x:.4f}"
                                            for k, x in steps.items()),
                      flush=True)
                torch.cuda.empty_cache()
        finally:
            for k, v in saved.items():
                setattr(fused2d if k in ("_lib", "_tiled_lib") else local, k,
                        v)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "split": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
