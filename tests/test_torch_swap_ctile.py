"""The redesigned K4 and K6 on the CPU: numpy models of what the digit-swapped
row kernel from n = 512 (a row tile split over a cluster in decimation in
frequency) and the multi-tile column kernel (a ring of runs, a cluster of
blocks a step from n = 1024) compute, index by index, and of how K6's
blocks walk their steps.

The shapes are read from the sources (csrc/local_cols.cu ``PYFFT_SWAP_X``,
``PYFFT_RING_X``, ``RING_SLOTS``, ``SWAP_THREADS``), and so is K6's walk
(its runs a block, the ring's first fills, refills, slots and barrier
parities), so the models test what the kernels are built with.  The K4 model follows the kernel's steps: block b's
box (rows r, every j1, its j2 range), its thread pairs, the G-point DFT and
the twiddle w_n^(j2*k1), the chunks of its own buffer (r XOR j2's low
bits), block k1's pulls through DSMEM, the M-point DFT over j2 and the
store of X[k1 + G*k2]; it must agree with numpy.fft (1e-11) and with JAX's
``_fft_rows_swap(..., interpret=True)`` (1e-6) and write every output
once.  The K6 models check the walk (every (l, t) of every step once, no
slot filled again before its stores, each wait on its run's fill) and, with the wrapper's own `full`
table and strides, the cluster tile's function against numpy.  The CUDA
kernels themselves run on the card (chip_smoke.py phases 17 and 18,
probes/ab_parent.py, probes/float_split.py).
"""

import re

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import local

from test_torch_cluster_cols import (CSRC, TOL64, c_eval, col_reference,
                                     macro_cases, tile_model)

torch.set_num_threads(2)

PARITY = 1e-6
SMEM = 227 * 1024               # shared memory a block may take (H100)
SM_SMEM = 228 * 1024            # an SM's, with 1 KB a block reserved
BOX = 256                       # the most rows a tensor copy's box takes

COLS_SRC = (CSRC / "local_cols.cu").read_text()


def cols_text(pattern: str) -> tuple:
    """The groups of ``pattern``'s one match in local_cols.cu."""
    m = re.findall(pattern, COLS_SRC)
    assert len(m) == 1, f"{pattern!r} not in local_cols.cu once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


SWAP_X = macro_cases("local_cols.cu", "PYFFT_SWAP_X")
RING_X = macro_cases("local_cols.cu", "PYFFT_RING_X")
SLOTS = int(cols_text(r"\nconstexpr int RING_SLOTS = (\d+);")[0])
SWAP_THREADS, SWAP_BLOCKS = map(int, cols_text(
    r"\nconstexpr int SWAP_THREADS = (\d+), SWAP_BLOCKS = (\d+);"))


def col_width(n: int) -> int:
    """ColShape's C for complex64 (csrc/local_cols.cu): 64 KB a block while
    that allows up to 128 columns, else a 32-byte sector's columns within
    128 KB."""
    wide = min(128, 64 * 1024 // (n * 8))
    deep = min(8, 128 * 1024 // (n * 8))
    return max(wide, deep)


def ring_shapes(n: int) -> list:
    """The (G, C) K6 may take at length n: the cluster table's, and whole
    runs of ColShape's C columns up to n = 1024 (at n = 1024 the grid
    chooses between the two)."""
    table = [(G, C) for log2n, G, C in RING_X if 1 << log2n == n]
    runs = [(1, col_width(n))] if n <= 1024 else []
    assert table or runs, f"K6 takes no length {n}"
    return table + runs


def ring_threads(n: int, G: int, C: int) -> int:
    M = n // G
    return min(M * C // 8, M // G * C, 512)


# ------------------------------------------------------------ the tables


def test_swap_table_rules():
    """K4's cluster tile from n = 512 to 8192: a cluster of 2 to 16 blocks,
    one box of at most 256 j2 a plane, output runs of 32 rows (128 bytes a
    plane) where SWAP_BLOCKS 64 KB blocks an SM allow it, else 16
    (64 bytes), the threads each taking whole (j2, row) pairs and whole
    butterflies of every stage."""
    assert [c[0] for c in SWAP_X] == [9, 10, 11, 12, 13]
    nt, per = SWAP_THREADS, SWAP_BLOCKS
    for log2n, G, R in SWAP_X:
        n = 1 << log2n
        M = n // G
        MG = M // G
        smem = M * R * 8 + 128
        assert G in (2, 4, 8, 16) and MG <= BOX
        assert R in (16, 32) and 128 % R == 0
        assert per * (smem + 1024) <= SM_SMEM
        assert R == 32 or per * (M * 32 * 8 + 128 + 1024) > SM_SMEM
        assert MG * R % nt == 0 and M * R // 8 >= nt
        assert (M // G) * R % nt == 0


def test_ring_table_rules():
    """K6: a cluster tile at every n from 1024 (runs of ColShape's C
    columns cannot keep S slots of 16-byte rows beyond), runs of at least
    64 bytes a row, S slots within a block's shared memory, threads that
    tile the chain and the exchange."""
    assert [c[0] for c in RING_X] == [10, 11, 12, 13]
    assert SLOTS >= 2
    for log2n in range(3, 14):
        n = 1 << log2n
        for G, C in ring_shapes(n):
            M = n // G
            nt = ring_threads(n, G, C)
            assert G in (1, 2, 4, 8, 16) and 128 % C == 0 and C % 4 == 0
            assert SLOTS * M * C * 8 + 128 <= SMEM
            assert M * C % nt == 0 and (M // G * C) % nt == 0
            assert M % min(M, BOX) == 0
            if G > 1:
                assert C * 4 >= 64


# ------------------------------------------------------------------- K4


def k4_model(x, sign, post, G, R):
    """local_rows_swap_x_kernel on (L, T, n) complex128 rows: returns the
    (L, n, T) output and the count of writes to each element."""
    L, T, n = x.shape
    M, MG = n // G, n // G // G
    nt = SWAP_THREADS
    tw = np.exp(sign * 2j * np.pi * np.arange(n) / n)
    wg = np.exp(sign * 2j * np.pi * np.outer(np.arange(G), np.arange(G)) / G)
    wm = np.exp(sign * 2j * np.pi * np.outer(np.arange(M), np.arange(M)) / M)
    out = np.full((L, n, T), np.nan, complex)
    writes = np.zeros((L, n, T), np.int64)
    pairs = np.arange(MG * R)
    assert len(pairs) % nt == 0
    jl, r = pairs % MG, pairs // MG
    for tile in range(-(-T // R) * L):
        l, r0 = tile % L, (tile // L) * R
        bufs = []
        for b in range(G):
            # the box: (r, j1, jl) = x[l, r0 + r, j1*M + b*MG + jl], zeros
            # past T
            box = np.zeros((R, G, MG), complex)
            rows = min(R, T - r0)
            box[:rows] = x[l, r0:r0 + rows].reshape(rows, G, M)[
                :, :, b * MG:(b + 1) * MG]
            v = box.reshape(-1)[(r[:, None] * G + np.arange(G)) * MG
                                + jl[:, None]]                  # (pairs, j1)
            y = v @ wg                                           # y[k1]
            y = y * tw[((b * MG + jl)[:, None] * np.arange(G)) % n]
            buf = np.full(M * R, np.nan, complex)
            for k1 in range(G):
                buf[(k1 * MG + jl) * R + (r ^ (jl & (R - 1)))] = y[:, k1]
            bufs.append(buf)
        for rank in range(G):
            e = np.arange(M * R)
            b, w = e // (MG * R), e % (MG * R)
            u = np.stack(bufs)[b, rank * MG * R + w]
            jj, rr = w // R, (w % R) ^ ((w // R) & (R - 1))
            z = np.full(M * R, np.nan, complex)
            z[(b * MG + jj) * R + rr] = u
            assert not np.isnan(z).any(), "every (j2, r) pulled once"
            Z = wm @ z.reshape(M, R)                             # (k2, r)
            for k2 in range(M):
                rows = np.arange(R)
                keep = r0 + rows < T
                out[l, rank + G * k2, r0 + rows[keep]] = Z[k2, keep] * post
                np.add.at(writes, (l, rank + G * k2, r0 + rows[keep]), 1)
    return out, writes


@pytest.mark.parametrize("sign,post", [(-1, 1.0), (1, 0.25)])
@pytest.mark.parametrize("log2n,G,R", SWAP_X)
def test_k4_cluster_model_matches_numpy_and_jax(log2n, G, R, sign, post):
    """The DIF tile at every shape of the table, on 40 rows (a whole tile
    and a ragged one past T), against numpy and JAX's K4."""
    n = 1 << log2n
    rng = np.random.default_rng(log2n + 3 * sign)
    x = (rng.standard_normal((1, 40, n))
         + 1j * rng.standard_normal((1, 40, n))).astype(np.complex64)
    got, writes = k4_model(x.astype(np.complex128), sign, post, G, R)
    X = (np.fft.fft(x.astype(np.complex128)) if sign < 0
         else np.fft.ifft(x.astype(np.complex128)) * n)
    want = (X * post).transpose(0, 2, 1)
    assert (writes == 1).all()
    assert np.abs(got - want).max() / np.abs(want).max() < TOL64
    jr, ji = jax_local._fft_rows_swap(
        np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag),
        sign=sign, postscale=post, interpret=True, lanes=8)
    jgot = np.asarray(jr) + 1j * np.asarray(ji)
    assert np.abs(got - jgot).max() / np.abs(jgot).max() < PARITY


def box_planes(kind):
    """(L, m, f) float32 planes of each layout the box rule sees, seeded."""
    g = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    if kind == "planar":
        return rand(2, 64, 256), rand(2, 64, 256)
    if kind == "pairs":
        v = torch.view_as_real(torch.complex(rand(2, 64, 256),
                                             rand(2, 64, 256)))
        return v[..., 0], v[..., 1]
    if kind == "offset":                # 4 bytes off 16-byte alignment
        flat = rand(2 * 64 * 256 + 1)
        return flat[1:].view(2, 64, 256), rand(2, 64, 256)
    if kind == "columns":               # the f axis strided
        return rand(2, 256, 64).mT, rand(2, 256, 64).mT
    if kind == "pairs swapped":         # im before re
        v = torch.view_as_real(torch.complex(rand(2, 64, 256),
                                             rand(2, 64, 256)))
        return v[..., 1], v[..., 0]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,ok", [
    ("planar", True), ("pairs", True), ("offset", False),
    ("columns", False), ("pairs swapped", False)])
def test_box_operands_rule(kind, ok):
    """K4 from n = 512 and K6 copy boxes of planar planes or of the
    complex form's pairs, 16-byte aligned, where they lie; planes of any
    other layout (an offset view, strided columns, im before re) are read
    from one contiguous copy each, which the box rule takes and which holds
    the same values, so every layout the kernels took before still runs."""
    re, im = box_planes(kind)
    assert local._boxable(re, im) == ok
    r3, i3 = local._box_operands(re, im)
    if ok:
        assert r3 is re and i3 is im
        return
    assert r3.is_contiguous() and i3.is_contiguous()
    assert r3.data_ptr() != re.data_ptr() and local._boxable(r3, i3)
    assert torch.equal(r3, re) and torch.equal(i3, im)


# ------------------------------------------------------------------- K6


# K6's walk as local_cols_ring_kernel states it: a step's blocks (g), a
# block's first run, its stride and its count, the start column of its run
# i, the ring's first fills, its refill at the top of iteration i, and the
# slot and barrier parity each wait takes
RING_WALK = dict(zip(("g", "first", "every", "count"), cols_text(
    r"const int g = ([^;]+);\n[^\n]*\n[^\n]*\n[^\n]*\n[^\n]*\n"
    r"  const long long base = [^;]+;\n  const int runs = [^;]+;\n"
    r"  const int first = ([^,]+), every = ([^;]+);\n"
    r"  const int count = ([^;]+);")))
RING_WALK["run"] = cols_text(
    r"const int t0 = static_cast<int>\(base \+ \(long long\)\(([^)]+)\) "
    r"\* C\);")[0]
RING_WALK["issue_slot"] = cols_text(r"uint64_t\* bar = &bars\[([^\]]+)\];")[0]
RING_WALK["initial"] = cols_text(
    r"for \(int j = 0; ([^;]+); \+\+j\) issue\(j\);")[0]
RING_WALK["refill"], RING_WALK["refill_run"] = cols_text(
    r"if \(threadIdx\.x == 0 && ([^)]+)\) issue\(([^)]+)\);")
RING_WALK["wait_slot"], RING_WALK["parity"] = cols_text(
    r"mbar_wait\(&bars\[([^\]]+)\], ([^;]+)\);")


def ring_eval(key: str, **env) -> int:
    """RING_WALK[key] evaluated in Python (``&&`` read as ``and``)."""
    return c_eval(RING_WALK[key].replace("&&", " and "), S=SLOTS, **env)


def test_k6_ring_loop_order():
    """The refill of a slot comes before the wait of the iteration, and a
    block is done with its slot (the store pass's barrier, or the
    exchange's cluster barrier) after that wait and before the next
    iteration: the order ring_walk models."""
    body = COLS_SRC[COLS_SRC.index("  for (int i = 0; i < count; ++i) {"):]
    body = body[:body.index("\n// The blocks of a K6 step")]
    marks = [body.index(m) for m in (
        "issue(" + RING_WALK["refill_run"] + ")", "mbar_wait(",
        "xt_exchange<X>(", "__syncthreads();            // the store pass")]
    assert marks[0] < marks[1] < min(marks[2:])


def ring_walk(L, T, c, n, group, G, C):
    """Every block's program order of K6 over (L, n, T) at c tiles a step,
    (G, C) its shape, evaluated from the kernel's own expressions
    (RING_WALK): [(block, [(event, run, slot, (l, t0), rows, parity)])],
    events "issue", "wait" and "free" (past the barrier after its
    stores)."""
    g = ring_eval("g", G=G, group=group)
    span = 128 * c
    steps = T // span * L
    runs = span // C
    blocks = []
    for blk in range(steps * g):
        rank, step = blk % g, blk // g
        l, base = step % L, (step // L) * span
        env = dict(G=G, g=g, rank=rank, runs=runs)
        env.update(first=ring_eval("first", **env))
        env.update(every=ring_eval("every", **env))
        count = ring_eval("count", **env)
        rows = [rank + G * j for j in range(n // G)] if G > 1 else list(
            range(n))

        def issue(i):
            t0 = base + ring_eval("run", i=i, **env) * C
            return ("issue", i, ring_eval("issue_slot", i=i), (l, t0), rows,
                    None)

        ev = []
        j = 0
        while ring_eval("initial", j=j, count=count):
            ev.append(issue(j))
            j += 1
        for i in range(count):
            if ring_eval("refill", i=i, count=count):
                ev.append(issue(ring_eval("refill_run", i=i)))
            slot = ring_eval("wait_slot", i=i)
            t0 = base + ring_eval("run", i=i, **env) * C
            ev.append(("wait", i, slot, (l, t0), rows,
                       ring_eval("parity", i=i)))
            ev.append(("free", i, slot, (l, t0), rows, None))
        blocks.append((blk, ev))
    return blocks


@pytest.mark.parametrize("log2n", range(3, 14))
@pytest.mark.parametrize("c", [1, 2, 8])
def test_k6_ring_walk_visits_every_column_once(log2n, c):
    """Every (l, row, t) of every step is loaded by exactly one block's run
    (across the ring's slots and the step's blocks or cluster ranks), a
    slot is filled again only after the run it held is freed, and each
    wait is on the fill of its own run, at that fill's barrier parity."""
    n = 1 << log2n
    L, T = 2, 128 * 8
    for G, C, group in [(G, C, group) for G, C in ring_shapes(n)
                        for group in ([1] if G > 1 else [1, 2, 4, 32])]:
        blocks = ring_walk(L, T, c, n, group, G, C)
        seen = np.zeros((L, n, T), np.int64)
        for blk, ev in blocks:
            held = {}                 # slot -> run it holds, until freed
            fills = {}                # slot -> fills so far
            for kind, run, slot, (l, t0), rows, parity in ev:
                assert 0 <= slot < SLOTS
                if kind == "issue":
                    assert slot not in held, "a slot filled before it is free"
                    held[slot] = run
                    fills[slot] = fills.get(slot, 0) + 1
                    seen[l, np.array(rows)[:, None],
                         t0 + np.arange(C)[None, :]] += 1
                elif kind == "wait":
                    assert held.get(slot) == run, "a wait on another run"
                    assert parity == (fills[slot] - 1) & 1, "a wrong phase"
                else:
                    assert held.pop(slot) == run
            assert not held
        assert (seen == 1).all(), f"group {group}"


def k6_model(x, sign, post, tw_n, c, G, C):
    """local_cols_ring_kernel of shape (G, C) on (L, n, T) complex128
    planes, the wrapper's `full` table and strides
    (``_kernel_col_tables``): returns the output and the count of writes
    to each element."""
    L, n, T = x.shape
    M = n // G
    out = np.full(x.shape, np.nan, complex)
    writes = np.zeros(x.shape, np.int64)
    ta = ak = aq = None
    if tw_n:
        ta, _, ak, aq, _, _, _ = local._kernel_col_tables(
            n, T, tw_n, "full", 0, sign, False, torch.device("cpu"),
            torch.float64)
        ta = ta.reshape(-1, 2).numpy()
        ta = ta[:, 0] + 1j * ta[:, 1]
    tw = np.exp(sign * 2j * np.pi * np.arange(n) / n)
    span = 128 * c
    for step in range(T // span * L):
        l, base = step % L, (step // L) * span
        for t0 in range(base, base + span, C):
            t = t0 + np.arange(C)
            if G == 1:
                Y = np.fft.fft(x[l][:, t], axis=0) if sign < 0 else \
                    np.fft.ifft(x[l][:, t], axis=0) * n
                k = np.arange(n)[:, None]
                if tw_n:
                    Y = Y * ta[k * ak + t[None, :] * aq]
                out[l][:, t] = Y * post
                np.add.at(writes, (l, slice(None), t), 1)
                continue
            outs = tile_model(lambda cc, j: x[l, j, t0 + cc], G, C, n, sign,
                              tw)
            for cc, kp, y in outs:
                tc = t0 + cc
                w = ta[kp * ak + tc * aq] if tw_n else 1
                for k2 in range(G):
                    v = y[k2]
                    if tw_n:
                        v = v * (w * ta[M * k2 * ak + tc * aq] if k2 else w)
                    out[l, kp + M * k2, tc] = v * post
                    np.add.at(writes, (l, kp + M * k2, tc), 1)
    return out, writes


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("log2n", [5, 8, 10, 11, 12, 13])
def test_k6_model_matches_numpy(log2n, sign):
    """K6's function (plain and `full` twiddle, c = 2) at runs and at every
    cluster tile of the table (both at n = 1024), against numpy, every
    output written once."""
    n = 1 << log2n
    L, T, c = (1, 256, 2) if n >= 4096 else (2, 256, 2)
    rng = np.random.default_rng(log2n * 7 + sign)
    x = rng.standard_normal((L, n, T)) + 1j * rng.standard_normal((L, n, T))
    post = 0.5 if sign < 0 else 1.0 / n
    for (G, C), tw_n in [(shape, tw_n) for shape in ring_shapes(n)
                         for tw_n in (0, n * T)]:
        got, writes = k6_model(x, sign, post, tw_n, c, G, C)
        want = col_reference(x, sign, post, dict(tw_n=tw_n) if tw_n else {})
        assert (writes == 1).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < TOL64, (G, C, tw_n, err)
