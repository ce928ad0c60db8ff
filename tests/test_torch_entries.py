"""Every C entry point of the kernel libraries against its binder, on the
CPU: each ``extern "C"`` declaration of ``csrc/*.cu`` is typed by a binder
of ``ops/local.py``, ``fused2d.py`` or ``interleave.py`` (through
``build.entry``, or ``build.query`` for a shape query) with as many
arguments as it declares, each of its kind (pointer, ``int``, ``long
long``, ``long long*``, ``int*``, ``float`` or ``double``), returning
``int``.  A count or a kind that is off would pass the wrong bytes to the
card, which the plain versions the CPU runs cannot show.  ``build.load``
is replaced by fake libraries that record how each symbol is typed.
"""

import contextlib
import ctypes
import re

import pytest
import torch

from pyfft_tpu_torch.ops import build, fused2d, interleave, local

F32, F64 = torch.float32, torch.float64

# The C parameter types the sources use, by ctypes type.
KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "long long": ctypes.c_longlong, "float": ctypes.c_float,
         "double": ctypes.c_double,
         "long long*": ctypes.POINTER(ctypes.c_longlong),
         "int*": ctypes.POINTER(ctypes.c_int)}


def declarations() -> dict:
    """{symbol: (source, [ctypes type of each parameter])} of every
    ``extern "C" int`` function of ``csrc/*.cu``."""
    out = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        src = path.read_text()
        assert src.count('extern "C"') == len(re.findall(
            r'extern "C" int \w+\(', src)), path.name
        for symbol, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = []
            for p in params.split(","):
                p = p.replace("const ", "").strip()
                kind = re.fullmatch(r"(.*?)\s*\w+", p).group(1)
                types.append(KINDS[kind.replace(" *", "*")])
            out[symbol] = (path.stem, types)
    return out


DECLARED = declarations()

# The binder call that types each symbol; a shape query's binder is the
# query itself (the fake entries return 0: the design takes nothing, or
# for the status queries every value 0).
BINDERS = {
    "pyfft_local_rows": lambda: local._rows_fn.__wrapped__(F32),
    "pyfft_local_rows_f64": lambda: local._rows_fn.__wrapped__(F64),
    "pyfft_local_rows_i8": local._rows_i8_fn.__wrapped__,
    "pyfft_local_rows_i8_stage": local._rows_i8_stage_fn.__wrapped__,
    "pyfft_local_rows_il": local._rows_il_fn.__wrapped__,
    "pyfft_local_rows_il_i8": local._rows_il_i8_fn.__wrapped__,
    "pyfft_local_rows_ring_shape":
        lambda: local.rows_ring_shape.__wrapped__(4096),
    "pyfft_local_rows_ring_shape_f64":
        lambda: local.rows_ring_shape.__wrapped__(4096, F64),
    "pyfft_local_cols": lambda: local._cols_lib.__wrapped__(F32),
    "pyfft_local_cols_width": lambda: local._cols_lib.__wrapped__(F32),
    "pyfft_local_cols_f64": lambda: local._cols_lib.__wrapped__(F64),
    "pyfft_local_cols_width_f64": lambda: local._cols_lib.__wrapped__(F64),
    "pyfft_local_cols_i8": local._cols_i8_lib.__wrapped__,
    "pyfft_local_cols_width_i8": local._cols_i8_lib.__wrapped__,
    "pyfft_local_cols_ctile": local._ctile_fn.__wrapped__,
    "pyfft_local_rows_swap": local._rows_swap_fn.__wrapped__,
    "pyfft_local_rows_swap_i8": local._rows_swap_i8_fn.__wrapped__,
    "pyfft_local_rows_swap_shape": lambda: local.swap_tile.__wrapped__(1024),
    "pyfft_local_cols_ring_shape": lambda: local.ring_shape.__wrapped__(1024),
    "pyfft_local_cols_pring_shape":
        lambda: local.col_ring_shape.__wrapped__(256),
    "pyfft_local_cols_xring_shape_f64":
        lambda: local.col_xring_shape_f64.__wrapped__(2048),
    "pyfft_local_cols_xring_shape":
        lambda: local.col_xring_shape.__wrapped__(1024),
    "pyfft_local_cols_xtile": lambda: local._col_xtile.__wrapped__(10, 1, F32),
    "pyfft_local_cols_xtile_f64":
        lambda: local._col_xtile.__wrapped__(10, 1, F64),
    "pyfft_local_cols_xshape": lambda: local.col_xshape(1024),
    "pyfft_local_cols_xshape_f64": lambda: local.col_xshape_f64(1024),
    "pyfft_fused2d": fused2d._lib.__wrapped__,
    "pyfft_fused2d_i8": fused2d._lib.__wrapped__,
    "pyfft_fused2d_cluster": fused2d._lib.__wrapped__,
    "pyfft_fused2d_clusters": fused2d._clusters_fn.__wrapped__,
    "pyfft_fused2d_ring_shape": lambda: fused2d.ring_shape(128, 128),
    "pyfft_fused2d_i8_stage": lambda: fused2d._i8_stage_fn.__wrapped__(),
    "pyfft_fused2d_i8_clusters": fused2d._i8_clusters_fn.__wrapped__,
    "pyfft_fused2d_tiled": fused2d._tiled_lib.__wrapped__,
    "pyfft_fused2d_tiled_i8": fused2d._tiled_lib.__wrapped__,
    "pyfft_fused2d_tiled_cluster": fused2d._tiled_lib.__wrapped__,
    "pyfft_fused2d_tiled_shape": lambda: fused2d.tiled_shape(128, 128),
    "pyfft_fused2d_tiled_i8_stage":
        lambda: fused2d._i8_stage_fn.__wrapped__(True),
    "pyfft_deinterleave":
        lambda: interleave._fn.__wrapped__("pyfft_deinterleave"),
    "pyfft_interleave": lambda: interleave._fn.__wrapped__("pyfft_interleave"),
}


class FakeEntry:
    """A C entry point that keeps the types it is given and returns 0."""

    argtypes = restype = None

    def __call__(self, *args):
        return 0


class FakeLibrary:
    """A library whose every symbol is a ``FakeEntry``, made once."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, symbol):
        if symbol.startswith("__"):
            raise AttributeError(symbol)
        return self.entries.setdefault(symbol, FakeEntry())


def test_every_declaration_has_a_binder():
    assert len(DECLARED) == 40
    assert set(BINDERS) == set(DECLARED)


@pytest.mark.parametrize("symbol", sorted(DECLARED))
def test_entries_match_their_c_declarations(monkeypatch, symbol):
    """The binder of ``symbol`` types it from its own source with the
    declaration's parameters, kind by kind, and an ``int`` return."""
    libs = {}
    monkeypatch.setattr(build, "load", lambda name, *a, **kw:
                        libs.setdefault(name, FakeLibrary()))
    with contextlib.suppress(ValueError):     # K6's shape of no length
        BINDERS[symbol]()
    source, params = DECLARED[symbol]
    assert symbol in libs[source].entries, (symbol, sorted(libs))
    fn = libs[source].entries[symbol]
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params)
    assert list(fn.argtypes) == params
