"""The ``Plan`` facade, the package's public API.

Counterpart of ``pyfft_tpu/plan.py`` (``Plan``), with the same constructor
keywords and call forms:

    plan = Plan((4096,), device="cuda")      # schedule once
    y    = plan.execute(x)                   # complex tensor -> complex
    r, i = plan.execute(re, im)              # planar (split) form
    back = plan.execute(y, inverse=True)     # 1/N folded into the last pass

A CUDA tensor's ``fused2d`` pass runs the Hopper fused 2D kernel over the
last two axes (``ops/fused2d.py``), its ``local`` pass the row kernel
(last axis) or column kernel (another axis), and its ``fourstep`` and
``huge`` passes two or three column-kernel passes (``ops/fourstep.py``); a
CPU tensor's run the kernels' plain torch versions.  A complex128 plan
runs the same executors on float64 planes, where the row and column
kernels compute in native FP64 (``ops/fp64.py``): that replaces the JAX
package's ``run_df64`` and its double-float quads, whose only reason was
a TPU without FP64.  The JAX package's fold-store column kernel has no
route of its own: on row-major memory its native-layout store is the
column kernel's plain store.  The kernel path allocates its output and,
in a four-step pass, one or two temporaries of the data's size.

A batch whose passes would hold more than the chunk budget
(``_hbm_chunk_budget``: a quarter of the card's memory, or the module
override ``_HBM_CHUNK_BUDGET``) runs in chunks of whole transforms, one
after another, each writing its slice of the output: the counterpart of
the JAX package's HBM chunk sweep (``run_planar``), with the budget from
``torch.cuda.mem_get_info`` and a liveness fudge of the port's own
(``Plan._fudge``).  The planar form and the "stream" and "planes" routes
take it; "fused", one kernel with no temporaries, does not, as in JAX.

The complex form of a complex64 plan takes one of three routes, the
counterpart of the JAX package's interleaved ("view") routes and of its
``_il1d_route``:

* ``"fused"`` (a 1D plan of one ``local`` pass only): the interleaved row
  kernel K2 on the (..., 2n) float32 view of ``x``, written into ``y``'s;
* ``"stream"``: K13 splits ``x`` into two planes, the planar passes run
  on them in place, K14 interleaves them into ``y``; taken only where
  ``ops/interleave.supported`` holds, as in JAX;
* ``"planes"``: every pass on the two stride-2 planes of
  ``torch.view_as_real`` (the JAX package's "complex" split).

The route comes from ``_il1d_route(n)`` for the single-pass case (the
autotune record's ``il1d:{n}``, as in JAX, else the constant
``IL1D_ROUTE``) and from ``IL_MULTI_ROUTE`` for every other complex64
plan; the constants hold the winners ``chip_smoke.py`` measured on an
H100 (PERF.md), and all three are read at call time.  No measured n disagreed with the others, so the single-pass route
is one value, not a table by n.  Complex128 and ``force_xla`` plans take
``"planes"``.

``execute`` marks its host time in spans (``utils/profiling.span``), seen
only while a torch profiler records: ``pyfft.execute`` around the whole
call, ``pyfft.pass.<executor>`` around each step that runs kernels (an
axis pass by its executor; the "fused" route's K2 call as
``pyfft.pass.fused``, the "stream" route's K13 and K14 calls as
``pyfft.pass.deinterleave`` and ``pyfft.pass.interleave``) and
``pyfft.wait`` around the closing synchronise; the kernels' C calls inside
are ``pyfft.entry.<kernel>``.

On the card a call is replayed from a call record where it can be
(``Plan._recorded``).  The record's key is the form (the complex form's
route, or "planar"), the direction, ``donate``, the output scale, the
chunk budget's override and, for each tensor given and returned, its
shape, strides, dtype, card, address modulo 16 and where it overlaps
another.  Each kernel library has one build a process (``ops/build``),
so a record outlives ``reload_tuned()``: a plan's split is fixed when it
is built, and the route is part of the key.  The first call with a key
runs the generic path, whose launch sites prepare each launch (every
check and lookup) and record it; the record is kept where every data
pointer of every launch lies in the call's input or output and the call
did no other device work: the "planes" and "fused" routes and planar
``local`` and ``fused2d`` chains.
Otherwise the key runs the generic path from then on: a "fourstep" or
"huge" temporary, the "stream" route's planes, a batch the chunk sweep
splits, a ``plain`` pass.  A later call with the key calls the recorded C
entries with its own data pointers, under the same spans, with the same
counts and errors.  Still done on every call: the input's
canonicalisation, the output's allocation, the route (so the constants
and the autotune record's ``il1d:{n}`` apply at once) and the card's
current stream.  A plan keeps ``_RECORDS_PER_PLAN`` keys, the oldest
dropped first; a record holds no tensor of a call.  The planar form
allocates its output planes before the first pass where every pass
writes its output directly (``local``, ``fused2d``).

The JAX package's host-view path (``_canonicalize_host``, ``_view_kernel_ok``) has
no counterpart: it exists for a TPU without complex dtypes, and the port
keeps complex tensors on the card.
"""

from __future__ import annotations

import math
import threading
from typing import Any

import numpy as np
import torch

from pyfft_tpu_torch.ops import fourstep, fused2d, interleave, launch, local
from pyfft_tpu_torch.planner import AxisPass, ExecPlan, build_plan
from pyfft_tpu_torch.reference import fft_planar
from pyfft_tpu_torch.utils import tune
from pyfft_tpu_torch.utils.profiling import COUNTS, span

__all__ = ["Plan", "IL1D_ROUTE", "IL_MULTI_ROUTE"]

_ROUTES = ("fused", "stream", "planes")
# The complex form's route of a complex64 1D plan of one local pass, and of
# every other complex64 plan ("stream" or "planes").  The winners of
# chip_smoke.py phase 15 on an H100 80GB HBM3 at 700 W (PERF.md section
# 5): "fused", since K2 makes one round trip where "stream" makes three,
# and reads whole float2 pairs where "planes" reads two stride-2 planes;
# "planes" at configs 3, 4 and 6+, whose column kernels take the stride-2
# planes at full speed.
IL1D_ROUTE = "fused"
IL_MULTI_ROUTE = "planes"

# Per-chunk budget of the batch sweep (``Plan._run``), in bytes: a chunk's
# rows times the bytes its passes hold live a row must fit it.  None: a
# quarter of the card's memory (``_hbm_chunk_budget``); a module override
# so that tests can sweep small shapes, on the CPU too.
_HBM_CHUNK_BUDGET: int | None = None
_HBM_BUDGET_CACHE: dict = {}

# Planes of the data's size a pass holds live beyond the input and output
# planes, by executor: a four-step's one temporary (``fourstep`` writes
# pass 1's swapped store into it), the six-step's two (pass 2 reads one
# and writes the other), the plain chain's four einsum products and its
# two result planes.  ``local`` and ``fused2d`` write the output directly.
_LIVE_PLANES = {"local": 0, "fused2d": 0, "fourstep": 2, "huge": 4,
                "plain": 6}

# The span of an axis pass, by executor.
_PASS_SPANS = {e: f"pyfft.pass.{e}" for e in _LIVE_PLANES}

# Call records a plan keeps (``Plan._recorded``), the oldest dropped first,
# and the mark of a key whose calls take the generic path.
_RECORDS_PER_PLAN = 8
_GENERIC = "generic"


def _pass(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the pass ``name``: its span, opened on
    the tape too where one records (``ops/launch``)."""
    launch.mark(name)
    return span(name, fn, *args, **kwargs)


def _layout(ops) -> tuple:
    """The operands' part of a call record's key: each one's shape,
    strides, dtype, card and address modulo 16, and, where its bytes meet
    an earlier operand's, that one's index and their distance in bytes
    (None where they meet none).  The operands are contiguous."""
    out, spans = [], []
    for t in ops:
        a = t.data_ptr()
        b = a + t.numel() * t.element_size()
        meets = next(((j, a - s) for j, (s, e) in enumerate(spans)
                      if a < e and s < b), None)
        spans.append((a, b))
        out.append((t.shape, t.stride(), t.dtype, t.get_device(), a % 16,
                    meets))
    return tuple(out)


def _record(tape, ops):
    """The call record of a recorded call: per pass, its span's name and
    its launches, each with its slots, (argument index, operand index,
    byte offset from that operand's ``data_ptr()``), one a data pointer;
    None where the call launched nothing, did other device work
    (``tape.whole``) or wrote where none of ``ops`` lies (a temporary, a
    copy, an output the generic path allocates)."""
    if not tape.whole or not any(la for _, la in tape.passes):
        return None
    spans = [(t.data_ptr(), t.numel() * t.element_size()) for t in ops]
    passes = []
    for name, launches in tape.passes:
        rows = []
        for la in launches:
            slots = []
            for i in la.ptrs:
                p = la.args[i]
                k = next((k for k, (a, n) in enumerate(spans)
                          if a <= p < a + n), None)
                if k is None:
                    return None
                slots.append((i, k, p - spans[k][0]))
            rows.append((la, tuple(slots)))
        passes.append((name, tuple(rows)))
    return tuple(passes)


def _replay_pass(launches, bases, stream) -> None:
    """A recorded pass's launches with the call's operand addresses
    ``bases`` in their slots."""
    for la, slots in launches:
        args = list(la.args)
        for i, k, off in slots:
            args[i] = bases[k] + off
        la(stream, args)


def _hbm_chunk_budget(device: torch.device) -> int | None:
    """The sweep's budget for a plan on ``device``: the module override,
    else on a card a quarter of its memory (``mem_get_info``'s total, the
    JAX package's ``bytes_limit // 4``), cached per card; None on the CPU,
    which is swept only under the override."""
    if _HBM_CHUNK_BUDGET is not None:
        return _HBM_CHUNK_BUDGET
    if device.type != "cuda":
        return None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _HBM_BUDGET_CACHE:
        _HBM_BUDGET_CACHE[index] = torch.cuda.mem_get_info(index)[1] // 4
    return _HBM_BUDGET_CACHE[index]


def _il1d_route(n: int) -> str:
    """The complex form's route of a complex64 1D plan of one local pass:
    the autotune record's ``il1d:{n}`` (``utils/tune``) where it names one
    of the three routes, else ``IL1D_ROUTE``."""
    v = tune.tuned("il1d", n)
    if v and v[0] in _ROUTES:
        return v[0]
    return IL1D_ROUTE


_TORCH_DTYPE = {np.dtype(np.complex64): torch.complex64,
                np.dtype(np.complex128): torch.complex128,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
_NP_DTYPE = {v: k for k, v in _TORCH_DTYPE.items()}


def np_dtype(dtype) -> np.dtype:
    """A numpy dtype from a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_DTYPE:
            raise ValueError(f"dtype must be complex64 or complex128, "
                             f"got {dtype}")
        return _NP_DTYPE[dtype]
    return np.dtype(dtype)


class Plan:
    """Batched power-of-two complex FFT plan for 1D/2D/3D transforms.

    Parameters (as in the JAX package):
      shape: int or tuple of 1-3 ints, each a power of two.
      dtype: numpy.complex64 (default) or numpy.complex128 (torch dtypes
        are accepted too).
      normalize: inverse transform scales by 1/(x*y*z) (default True).
      scale: extra user scale folded into both directions' output.
      fast_math: True (default) = the plain version runs the calibrated
        chains (``row_factors``); False = the all-butterfly chains of
        ``precise_factors``, which, as in the JAX package, exist only up to
        n = 2048 and silently keep the default chain above it.  The CUDA
        kernels run butterflies only, so ``fast_math`` changes nothing on
        the kernel path.
      wait_for_finish: default sync behaviour of execute(); if None it is
        inferred: async when a stream/queue was supplied, sync otherwise.
        The sync is ``torch.cuda.synchronize``.
      context/stream/queue: accepted for API familiarity; they only set the
        async default.
      force_xla: schedule every pass on the plain torch chain (the name is
        the JAX package's).
      donate: write the result into the input's memory (in place) where
        the input is already a tensor of the plan's dtype and device.
      device: where the plan runs (default "cuda").  Numpy input is moved
        there; a tensor on another device raises.
    """

    def __init__(self, shape, dtype=np.complex64, *, normalize: bool = True,
                 scale: float = 1.0, fast_math: bool = True,
                 wait_for_finish: bool | None = None,
                 context: Any = None, stream: Any = None, queue: Any = None,
                 force_xla: bool = False, donate: bool = False,
                 device="cuda"):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        self.shape = tuple(int(s) for s in shape)
        self._exec_plan: ExecPlan = build_plan(self.shape, np_dtype(dtype),
                                               kernels=not force_xla)
        self.dtype = self._exec_plan.dtype
        self._complex = _TORCH_DTYPE[self.dtype]
        self._real = (torch.float32 if self.dtype == np.complex64
                      else torch.float64)
        self.normalize = bool(normalize)
        self.scale = float(scale)
        self.fast_math = bool(fast_math)
        if wait_for_finish is None:
            wait_for_finish = stream is None and queue is None
        self.wait_for_finish = bool(wait_for_finish)
        self._force_xla = bool(force_xla)
        self.donate = bool(donate)
        self.device = torch.device(device)
        # every pass writes its output directly: the planar form's output
        # planes are allocated once, before the first pass
        self._direct = all(_LIVE_PLANES[p.executor] == 0
                           for p in self._exec_plan.passes)
        self._records: dict = {}
        self._records_lock = threading.Lock()

    # ------------------------------------------------------------- executors

    def _run_axis_pass(self, re, im, p: AxisPass, sign: int, ndim: int,
                       postscale: float, out):
        """Dispatch one axis pass to its executor.

        Returns (re, im, scaled): ``scaled`` reports whether the executor
        folded ``postscale`` into its write (free in the row kernel; a
        separate multiply would cost another device-memory round trip).
        """
        axis = re.ndim - ndim + p.axis
        if p.executor == "fused2d":
            fy = fx = None
            if not self.fast_math:
                fy, fx = (local.precise_factors(n) for n in p.split)
            rr, ii = fused2d.fft2_fused(re, im, sign, postscale=postscale,
                                        factors_y=fy, factors_x=fx, out=out)
            return rr, ii, True
        if p.executor == "local":
            factors = (None if self.fast_math
                       else local.precise_factors(p.n))
            rr, ii = local.fft_axis(re, im, sign, axis=axis,
                                    postscale=postscale, factors=factors,
                                    out=out)
            return rr, ii, True
        kw = dict(axis=axis, postscale=postscale, fast_math=self.fast_math,
                  out=out)
        if p.executor == "fourstep":
            if axis == re.ndim - 1:
                rr, ii = fourstep.fft_axis_large(re, im, sign, split=p.split,
                                                 **kw)
            else:
                rr, ii = fourstep.fft_axis_mid(re, im, sign, split=p.split,
                                               **kw)
            return rr, ii, True
        if p.executor == "huge":
            rr, ii = fourstep.fft_axis_huge(re, im, sign, split3=p.split,
                                            **kw)
            return rr, ii, True
        launch.untracked()
        rr, ii = fft_planar(re, im, sign, axis=axis)
        return rr, ii, False

    def _norm(self, inverse: bool) -> float:
        """The output scale: 1/N on a normalized inverse, times ``scale``."""
        norm = 1.0
        if inverse and self.normalize:
            norm /= self._exec_plan.total_n
        return norm * self.scale

    def _fudge(self) -> int:
        """Planes of the data's size one execution holds live a row: the
        input and output planes and the most any pass adds
        (``_LIVE_PLANES``)."""
        return 4 + max(_LIVE_PLANES[p.executor]
                       for p in self._exec_plan.passes)

    def _chunk(self, batch: int, device: torch.device) -> int:
        """Transforms a chunk of the sweep takes: the largest divisor of
        ``batch`` whose rows fit the budget (at least 1), or ``batch``
        where the whole batch fits or there is no budget."""
        budget = _hbm_chunk_budget(device)
        per_row = self._exec_plan.total_n * self._real.itemsize
        cost = per_row * self._fudge()
        if budget is None or batch <= 1 or batch * cost <= budget:
            return batch
        chunk = max(1, budget // cost)
        while batch % chunk:
            chunk -= 1
        return chunk

    def _run(self, re, im, inverse: bool, out):
        """All passes over planar (batch..., *shape) planes, in chunks of
        whole transforms where the batch exceeds the budget
        (``_chunk``)."""
        ndim = len(self.shape)
        lead = re.shape[:re.ndim - ndim]
        batch = math.prod(lead)
        chunk = self._chunk(batch, re.device)
        if chunk == batch:
            return self._run_once(re, im, inverse, out)
        launch.untracked()
        if out is None:
            out = (torch.empty_like(re), torch.empty_like(im))
        flat = (batch,) + self.shape
        rr, ii = re.view(flat), im.view(flat)
        orr, oii = out[0].view(flat), out[1].view(flat)
        for b in range(0, batch, chunk):
            c = slice(b, b + chunk)
            self._run_once(rr[c], ii[c], inverse, (orr[c], oii[c]))
        return out

    def _run_once(self, re, im, inverse: bool, out):
        """All passes over planar (batch..., *shape) planes.  With ``out``
        the result lands in those planes (the kernel writes there
        directly); without, in new ones."""
        ndim = len(self.shape)
        sign = +1 if inverse else -1
        scale_left = self._norm(inverse)
        passes = self._exec_plan.passes
        for idx, p in enumerate(passes):
            is_final = idx == len(passes) - 1
            post = scale_left if is_final else 1.0
            re, im, scaled = _pass(_PASS_SPANS[p.executor],
                                   self._run_axis_pass, re, im, p, sign,
                                   ndim, post, out)
            # Only the final pass is handed the real scale; a non-final
            # pass reporting scaled=True merely folded postscale=1.0, so
            # clearing scale_left there would drop the 1/N normalization
            # (and user scale) on every multi-pass plan.
            if scaled and is_final:
                scale_left = 1.0
        if scale_left != 1.0:
            launch.untracked()
            re, im = re * scale_left, im * scale_left
        if out is None:
            return re, im
        if re is not out[0]:
            launch.untracked()
            out[0].copy_(re)
            out[1].copy_(im)
        return out

    # ------------------------------------------------------------ data prep

    def _canonicalize(self, data, batch, planar: bool):
        """User data -> a contiguous (batch?, *shape) tensor of the plan's
        dtype on the plan's device; returns (tensor, original shape)."""
        want = self._real if planar else self._complex
        if isinstance(data, torch.Tensor):
            dev = data.device
            if dev.type != self.device.type or (
                    self.device.index is not None
                    and dev.index != self.device.index):
                raise ValueError(f"input is on {dev} but the plan runs on "
                                 f"{self.device}; move it first")
            x = data
        else:
            x = torch.as_tensor(np.ascontiguousarray(data),
                                device=self.device)
        if x.dtype != want:
            x = x.to(want)
        orig_shape = tuple(x.shape)
        ndim = len(self.shape)
        if not (x.ndim >= ndim and orig_shape[-ndim:] == self.shape):
            # flat buffer + batch, reference-style: execute(buf, batch=k)
            b = int(batch) if batch else 1
            if x.numel() != b * math.prod(self.shape):
                raise ValueError(
                    f"data of shape {orig_shape} does not match transform "
                    f"shape {self.shape} with batch={b}")
            x = x.reshape((b,) + self.shape if b > 1 else self.shape)
        return x.contiguous(), orig_shape

    def il_route(self) -> str:
        """The complex form's route: "fused", "stream" or "planes" (see the
        module docstring), from ``_il1d_route`` and ``IL_MULTI_ROUTE`` as
        they stand now."""
        if self._complex != torch.complex64 or self._force_xla:
            return "planes"
        passes = self._exec_plan.passes
        single = len(passes) == 1 and passes[0].executor == "local"
        route = _il1d_route(self.shape[-1]) if single else IL_MULTI_ROUTE
        if route not in (_ROUTES if single else _ROUTES[1:]):
            raise ValueError(f"no interleaved route {route!r} for {self!r}")
        if route == "stream" and not interleave.supported(
                (2 * self.shape[-1],), torch.float32):
            return "planes"
        return route

    def _run_complex(self, x, y, inverse: bool, route: str) -> None:
        """The complex form: the transform of contiguous complex ``x``
        written into ``y`` (which may be ``x``) by ``route``."""
        if route == "planes":
            xv, yv = torch.view_as_real(x), torch.view_as_real(y)
            self._run(xv[..., 0], xv[..., 1], inverse,
                      (yv[..., 0], yv[..., 1]))
            return
        xf, yf = x.view(self._real), y.view(self._real)   # (..., 2n) views
        if route == "fused":
            # the chain only picks the CPU plain version's stages
            factors = (None if self.fast_math or x.is_cuda
                       else local.precise_factors(self.shape[-1]))
            _pass("pyfft.pass.fused", local.fft_rows_interleaved, xf,
                  +1 if inverse else -1, postscale=self._norm(inverse),
                  factors=factors, out=yf)
            return
        re, im = _pass("pyfft.pass.deinterleave", interleave.deinterleave,
                       xf)
        re, im = self._run(re, im, inverse, (re, im))
        _pass("pyfft.pass.interleave", interleave.interleave, re, im, out=yf)

    # ---------------------------------------------------------- call record

    def _recorded(self, form: str, inverse: bool, ops: tuple, run, *args):
        """``run(*args)``, the generic path of a call whose input and
        output tensors are ``ops``, and its result; or the replay of its
        call record, and None.

        On the card the call's key (``form``, the direction, ``donate``,
        the output scale, the chunk budget's override and the operands'
        ``_layout``) picks its record.
        A miss runs the generic path on a tape and keeps what the tape
        recorded where every launch's data pointers lie in ``ops``, else
        marks the key generic; a hit calls the recorded launches with the
        pointers of this call's ``ops``, under the same spans, on the
        device's current stream."""
        if not ops[0].is_cuda:
            return run(*args)
        key = (form, inverse, self.donate, self._norm(inverse),
               _HBM_CHUNK_BUDGET, _layout(ops))
        rec = self._records.get(key)
        if rec is None:
            COUNTS["record.miss"] += 1
            with launch.recording() as tape:
                got = run(*args)
            rec = _record(tape, ops)
            with self._records_lock:
                if len(self._records) >= _RECORDS_PER_PLAN:
                    del self._records[next(iter(self._records))]
                self._records[key] = _GENERIC if rec is None else rec
            return got
        if rec is _GENERIC:
            COUNTS["record.generic"] += 1
            return run(*args)
        COUNTS["record.hit"] += 1
        bases = [t.data_ptr() for t in ops]
        device = ops[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for name, launches in rec:
                span(name, _replay_pass, launches, bases, stream)
        return None

    # -------------------------------------------------------------- execute

    def execute(self, data, data_imag=None, *, inverse: bool = False,
                batch: int | None = None, wait_for_finish: bool | None = None):
        """Run the transform.

        Complex form: ``execute(x)`` with complex ``x`` -> complex tensor,
        by the route ``il_route()`` names.
        Split form: ``execute(re, im)`` -> ``(re, im)`` (dispatch by arity).
        ``batch=k`` accepts a flat buffer holding k contiguous transforms.
        """
        return span("pyfft.execute", self._execute, data, data_imag,
                    inverse, batch, wait_for_finish)

    def _execute(self, data, data_imag, inverse, batch, wait_for_finish):
        if data_imag is not None:
            re, re_shape = self._canonicalize(data, batch, planar=True)
            im, _ = self._canonicalize(data_imag, batch, planar=True)
            if re.shape != im.shape:
                raise ValueError("real/imag planes must have the same shape")
            if self.donate:
                out = (re, im)
            elif self._direct:
                out = (torch.empty_like(re), torch.empty_like(im))
            else:
                out = None
            # a replay writes ``out``; without one the generic path
            # allocates the output, which no record can hold
            rr, ii = self._recorded("planar", inverse, (re, im) + (out or ()),
                                    self._run, re, im, inverse, out) or out
            out = (rr.reshape(re_shape), ii.reshape(re_shape))
        else:
            x, x_shape = self._canonicalize(data, batch, planar=False)
            y = x if self.donate else torch.empty_like(x)
            route = self.il_route()
            self._recorded(route, inverse, (x, y), self._run_complex, x, y,
                           inverse, route)
            out = y.reshape(x_shape)
        wait = (self.wait_for_finish if wait_for_finish is None
                else wait_for_finish)
        if wait and self.device.type == "cuda":
            span("pyfft.wait", torch.cuda.synchronize, self.device)
        return out

    # ------------------------------------------------------------- niceties

    def __repr__(self):
        passes = self._exec_plan.passes
        kinds = ",".join(p.executor for p in passes)
        splits = ",".join("x".join(map(str, p.split)) for p in passes
                          if p.executor in ("fourstep", "huge"))
        return (f"Plan(shape={self.shape}, dtype={self.dtype.name}, "
                f"device={self.device}, passes=[{kinds}]"
                + (f", splits=[{splits}]" if splits else "") + ")")
