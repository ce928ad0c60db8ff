"""The row ring on the CPU: numpy models of what the complex64 row kernel
behind K1 and K2 (csrc/local_rows.cu ``local_rows_ring_kernel``, a
persistent grid walking row blocks through a ring of slots fed by bulk
copies) computes, index by index, and of how its blocks walk the rows.

The shapes are read from the sources (``PYFFT_ROWS_RING``, the chain
options ``RING_PAD``, ``RING_TWD``, ``RING_R16``), and so is the walk (a
block's row blocks, the ring's first fills, refills, slots and barrier
parities), so the models test what the kernel is built with.  The chain
model follows chain.cuh's stages over the slot's rows: the radices (radix
16 where it takes a stage fewer than radix 8, after a radix-2, 4 or 8
head), each stage's reads and writes in chain_index's padded layout (every
slot index written once a stage, inside the slot), the twiddles a
butterfly forms from its few table reads (TWD), short rows read (up to
n = 16) and stored (up to 64) in passes along the rows, and the stores
(every output once); at every n from 8 to 8192 it must agree with numpy.fft
(2e-6) and with JAX's ``fft_axis`` and ``_fft_rows_interleaved`` in
interpret mode (1e-6), both directions, with a postscale.  The CUDA
kernel itself runs on the card (chip_smoke.py phases 3 and 14,
probes/ab_parent.py, probes/float_split.py).
"""

import contextlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.ops.launch import Launch
from pyfft_tpu_torch.utils import profiling

from test_torch_cluster_cols import CSRC, c_eval, macro_cases

torch.set_num_threads(2)

TOL = 2e-6
TOL64 = 1e-11
PARITY = 1e-6
SMEM = 227 * 1024               # shared memory a block may take (H100)
SM_SMEM = 228 * 1024            # an SM's, with 1 KB a block reserved
BOX = 256                       # the most rows or points a box takes
SMS = 132                       # an H100's SMs

ROWS_SRC = (CSRC / "local_rows.cu").read_text()


def rows_text(pattern: str) -> tuple:
    """The groups of ``pattern``'s one match in local_rows.cu."""
    m = re.findall(pattern, ROWS_SRC)
    assert len(m) == 1, f"{pattern!r} not in local_rows.cu once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


RING = {log2n: (rpb, slots) for log2n, rpb, slots in
        macro_cases("local_rows.cu", "PYFFT_ROWS_RING")}
# K11's table: the same ring on double planes
RING_F64 = {log2n: (rpb, slots) for log2n, rpb, slots in
            macro_cases("local_rows.cu", "PYFFT_ROWS_RING_F64")}
PAD, TWD, R16 = (v == "true" for v in rows_text(
    r"\nconstexpr bool RING_PAD = (\w+), RING_TWD = (\w+), "
    r"RING_R16 = (\w+);"))
R16_F64 = rows_text(r"\nconstexpr bool RING_R16_F64 = (\w+);")[0] == "true"


def rpb_of(log2n: int) -> int:
    """The table's rows a slot, or a slot of 4096 points where the length
    runs the first design (the model holds the ring to every length)."""
    return RING[log2n][0] if log2n in RING else min(256, max(1, 4096 >> log2n))


def shape(log2n: int, rpb: int, slots: int, vb: int = 8) -> dict:
    """RowRing's constants (csrc/local_rows.cu) at (log2 n, RPB, S), for
    values of ``vb`` bytes (8 complex64, 16 complex128)."""
    n = 1 << log2n
    p = rpb * n
    nt = p // min(n, 16)
    raw = max(p, rpb * (n + n // 16))
    slot = (raw * vb + 127) // 128 * 128 // vb
    smem = slots * slot * vb + 128
    return dict(n=n, rpb=rpb, slots=slots, p=p, nt=nt, box=n < 512,
                pass_in=n <= 16, pass_out=n <= 64, slot=slot, smem=smem,
                per=min(SM_SMEM // (smem + 1024), 2048 // nt),
                r16=(R16 if vb == 8 else R16_F64)
                and (log2n + 3) // 4 < (log2n + 2) // 3)


def test_shape_constants_are_the_sources():
    """The model's constants are RowRing's own expressions."""
    for text in (
            "static constexpr int NT = P / (N < 16 ? N : 16);",
            "static constexpr bool BOX = N < 512;",
            "static constexpr bool PASS_IN = N <= 16, PASS_OUT = N <= 64;",
            "static constexpr int VB = (int)sizeof(V);",
            "static constexpr bool R16 = (VB == 8 ? RING_R16 : RING_R16_F64) "
            "&&\n" + " " * 30 + "(LOGN + 3) / 4 < (LOGN + 2) / 3;",
            "static constexpr int RAW = P > RPB * (N + N / 16) ? P : "
            "RPB * (N + N / 16);",
            "static constexpr int SLOT = (RAW * VB + 127) / 128 * 128 / VB;",
            "static constexpr int SMEM = S * SLOT * VB + 128;",
            "static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);"):
        assert text in ROWS_SRC, text


# ------------------------------------------------------------ the table


def test_ring_table_rules():
    """The ring up to n = 64 and from 1024 (the first design keeps 128 to
    512, where it was as fast or faster on the card), two slots at n = 8192
    and three elsewhere; every slot within a block's
    shared memory, at least two slots, threads that take 16 points a
    stage (8 at n = 8) and tile the slot exactly, one tensor-map box of at
    most 256 x 256 a plane below n = 512, one bulk copy a row from 512
    within an mbarrier's byte count, at least one block an SM."""
    assert sorted(RING) == [3, 4, 5, 6, 10, 11, 12, 13]
    assert [RING[k][1] for k in sorted(RING)] == [3] * 7 + [2]
    assert PAD and TWD and R16
    for log2n, (rpb, slots) in RING.items():
        s = shape(log2n, rpb, slots)
        n, p, nt = s["n"], s["p"], s["nt"]
        assert slots >= 2 and s["smem"] <= SMEM and s["per"] >= 1
        assert p in (2048, 4096, 8192) and p == rpb * n
        assert nt * min(n, 16) == p and nt <= 1024 and nt % 32 == 0
        if s["box"]:
            assert n <= BOX and rpb <= BOX and (n * 4) % 16 == 0
        else:
            assert rpb * n * 8 < 1 << 20 and (n * 4) % 16 == 0
        assert s["slot"] * 8 % 128 == 0 and s["slot"] >= p
    # the table's blocks an SM at n = 4096: two blocks of 104576 bytes
    assert shape(12, *RING[12])["smem"] == 104576
    assert shape(12, *RING[12])["per"] == 2
    assert shape(13, *RING[13])["per"] == 1


@pytest.mark.parametrize("log2n", range(3, 14))
def test_every_stage_tiles_the_threads(log2n):
    """Each stage of the chain gives every thread whole butterflies (the
    chain's static assertion) at the slot of every length."""
    s = shape(log2n, rpb_of(log2n), 3)
    for r in radices(log2n, s["r16"]):
        assert (s["n"] // r) * s["rpb"] % s["nt"] == 0


# ------------------------------------------------------------ the chain


def radices(log2n: int, r16: bool) -> list:
    """chain.cuh's radices: a radix-2, 4 (or 8) head where log2 n is not a
    multiple of 3 (4), then radix 8 (16)."""
    rb = 4 if r16 else 3
    rem = log2n % rb
    return ([1 << rem] if rem else []) + [1 << rb] * (log2n // rb)


def chain_index(n: int, c, k, pad: bool):
    """chain.cuh's chain_index with ROWS: c*(n + n/16) + k + k/16 padded."""
    return c * (n + n // 16) + k + k // 16 if pad else c * n + k


def butterfly_twiddles(tw: np.ndarray, e: np.ndarray, radix: int,
                       twd: bool, cdt=np.complex64) -> np.ndarray:
    """(B, R) twiddles w^r of each butterfly, w^r at tw[r*e], formed as
    the stage forms them: TWD reads w^1, w^2, w^3, w^4, w^8 at radix 16
    and multiplies the others out; at radix 4 and 8 it reads w^1, w^2
    (w^4, w^7) and multiplies out w^3 (w^5, w^6); else every one read."""
    read = {r: tw[r * e] for r in range(radix)}
    w = dict(read)
    if twd and radix == 16:
        w = {r: read[r] for r in (0, 1, 2, 3, 4, 8)}
        w[5], w[6], w[7] = w[1] * w[4], w[2] * w[4], w[3] * w[4]
        for r in range(9, 16):
            w[r] = w[r - 8] * w[8]
    elif twd and radix >= 4:
        w = {0: read[0], 1: read[1], 2: read[2], 3: read[1] * read[2]}
        if radix == 8:
            w[4], w[7] = read[4], read[7]
            w[5], w[6] = w[1] * w[4], w[2] * w[4]
    return np.stack([w[r] for r in range(radix)], axis=1).astype(cdt)


def chain_model(x: np.ndarray, sign: int, post: float, log2n: int,
                rpb: int, slots: int = 3) -> np.ndarray:
    """local_rows_ring_kernel's function over the (rows, n) rows x
    (complex64, or complex128 for K11's instantiation), slot by slot: the
    slot's raw rows, the chain in its padded layout (for short rows with
    the passes along the rows before and after it), the stores times
    ``post``.  Asserts that every stage writes each slot index once and
    inside the slot, and that every output is stored once."""
    cdt = x.dtype
    s = shape(log2n, rpb, slots, cdt.itemsize)
    n, p, slot = s["n"], s["p"], s["slot"]
    tw = (np.exp(sign * 2j * np.pi * np.arange(n) / n)).astype(cdt)
    rows = x.shape[0]
    out = np.zeros((rows, n), cdt)
    stored = np.zeros((rows, n), np.int64)
    rads = radices(log2n, s["r16"])
    for row0 in range(0, rows, rpb):
        raw = np.zeros((rpb, n), cdt)                 # rows past the end: 0
        raw[:min(rpb, rows - row0)] = x[row0:row0 + rpb]
        buf = np.full(slot, np.nan, cdt)

        def put(c, k, v):
            c, k, v = c.ravel(), k.ravel(), v.ravel()
            keep = row0 + c < rows
            out[row0 + c[keep], k[keep]] = v[keep] * cdt.type(post).real
            np.add.at(stored, (row0 + c[keep], k[keep]), 1)

        if s["pass_in"]:               # the pass along the rows, in
            e = np.arange(p)
            buf[chain_index(n, e // n, e % n, PAD)] = raw.ravel()
        ns = 1
        for i, radix in enumerate(rads):
            first = i == 0 and not s["pass_in"]
            last = i == len(rads) - 1 and not s["pass_out"]
            nr = n // radix
            q = np.arange(rpb * nr)
            c, j = q // nr, q % nr
            kin = j[:, None] + np.arange(radix)[None, :] * nr
            v = (raw[c[:, None], kin] if first
                 else buf[chain_index(n, c[:, None], kin, PAD)])
            if ns > 1:
                e = (j % ns) * (n // (ns * radix))
                v = v * butterfly_twiddles(tw, e, radix, TWD, cdt)
            r_ = np.arange(radix)
            dft = np.exp(sign * 2j * np.pi * np.outer(r_, r_) / radix)
            v = (v @ dft.astype(cdt)).astype(cdt)
            base = (j // ns) * ns * radix + j % ns
            kout = base[:, None] + r_[None, :] * ns
            if last:
                put(np.broadcast_to(c[:, None], kout.shape), kout, v)
            else:
                idx = chain_index(n, c[:, None], kout, PAD).ravel()
                assert len(np.unique(idx)) == idx.size, "a slot index twice"
                assert idx.max() < slot, "a write past the slot"
                buf = np.full(slot, np.nan, cdt)
                buf[idx] = v.ravel()
            ns *= radix
        if s["pass_out"]:              # the pass along the rows, out
            e = np.arange(p)
            put(e // n, e % n, buf[chain_index(n, e // n, e % n, PAD)])
    assert (stored == 1).all(), "an output stored twice or never"
    return out


def rand_rows(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, n))
            + 1j * rng.standard_normal((rows, n))).astype(np.complex64)


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("sign,post", [(-1, 0.5), (1, 0.25)])
@pytest.mark.parametrize("log2n", range(3, 14))
def test_chain_model_matches_numpy_and_jax(log2n, sign, post):
    """The model at every n, a ragged last slot (rows = RPB + 3, or 3 rows
    from n = 4096), against numpy.fft and JAX's planar fft_axis and
    interleaved _fft_rows_interleaved in interpret mode."""
    n = 1 << log2n
    rpb = rpb_of(log2n)
    rows = rpb + 3 if rpb > 1 else 3
    x = rand_rows(rows, n, seed=log2n * 2 + (sign > 0))
    got = chain_model(x, sign, post, log2n, rpb)
    x128 = x.astype(np.complex128)
    ref = (np.fft.fft(x128) if sign < 0 else np.fft.ifft(x128) * n) * post
    assert rel(got, ref) < TOL
    jr, ji = jax_local.fft_axis(np.ascontiguousarray(x.real),
                                np.ascontiguousarray(x.imag), sign, axis=-1,
                                postscale=post, interpret=True)
    assert rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < PARITY
    v = np.ascontiguousarray(x).view(np.float32)
    jv = jax_local._fft_rows_interleaved(jnp.asarray(v), n=n, sign=sign,
                                         postscale=post, interpret=True)
    jgot = np.ascontiguousarray(np.asarray(jv)).view(np.complex64)
    assert rel(got, jgot) < PARITY


# ------------------------------------------------------------- the walk

# the walk as local_rows_ring_kernel states it: a block's first row block,
# its stride and count, the start row of row block i, the ring's first
# fills, its refill at the top of iteration i, and the slot and barrier
# parity each wait takes; the grid, one wave at most
WALK = dict(zip(("first", "every"), rows_text(
    r"const long long first = ([^,]+), every = ([^;]+);")))
WALK["count"] = rows_text(
    r"const int count =\s+first < blocks \? static_cast<int>\(([^;]+)\)\s+"
    r": 0;")[0]
WALK["row0"] = rows_text(
    r"uint64_t\* bar = &bars\[i % S\];\n[^\n]*\n"
    r"    const long long row0 = ([^;]+);")[0]
WALK["issue_slot"] = rows_text(r"uint64_t\* bar = &bars\[([^\]]+)\];")[0]
WALK["initial"] = rows_text(
    r"for \(int j = 0; ([^;]+); \+\+j\) issue\(j\);")[0]
WALK["refill"], WALK["refill_run"] = rows_text(
    r"if \(threadIdx\.x == 0 && (i && [^)]+)\) issue\(([^)]+)\);")
WALK["wait_slot"], WALK["parity"] = rows_text(
    r"mbar_wait\(&bars\[([^\]]+)\], ([^;]+)\);")
WALK["grid"] = rows_text(
    r"const long long grid = ([^;]+);")[0]


def walk_eval(key: str, **env) -> int:
    """WALK[key] evaluated in Python (``&&`` read as ``and``)."""
    expr = WALK[key].replace("&&", " and ").replace("RPB", "rpb")
    return c_eval(expr, **env)


def test_ring_loop_order():
    """In each iteration the refill of the slot freed by the last one
    comes first, then the wait on this one's fill, then the load pass, the
    chain and the store pass, whose last barrier after their reads of the
    slot (the last stage's, or the one after the store pass along the
    rows) frees it."""
    body = ROWS_SRC[ROWS_SRC.index("  for (int i = 0; i < count; ++i) {"):]
    body = body[:body.index("\n// The card's SMs and the blocks")]
    marks = [body.index(m) for m in (
        "issue(" + WALK["refill_run"] + ")", "mbar_wait(",
        "if constexpr (K::PASS_IN) {",
        "chain<NT, LOGN, RPB, true, 0, 1, !K::PASS_IN, !K::PASS_OUT,",
        "if constexpr (K::PASS_OUT) {",
        "      __syncthreads();\n    }\n  }\n}\n")]
    assert marks == sorted(marks)
    # the chain's first stage reads the slot it writes: the barrier there
    assert "bool SYNC0 = false" in (CSRC / "chain.cuh").read_text()
    assert "if (!FIRST || SYNC0) __syncthreads();" in (
        CSRC / "chain.cuh").read_text()


def ring_walk(rows: int, rpb: int, slots: int, per: int):
    """Every block's program order over ``rows`` rows, from the kernel's own
    expressions: [(block, [(event, i, slot, rows of the row block,
    parity)])], events "issue", "wait" and "free"."""
    blocks = (rows + rpb - 1) // rpb
    wave = SMS * per
    grid = c_eval(WALK["grid"], blocks=blocks, wave=wave)
    out = []
    for bx in range(grid):
        env = dict(bx=bx, gx=grid, S=slots, rpb=rpb, blocks=blocks)
        first, every = walk_eval("first", **env), walk_eval("every", **env)
        env.update(first=first, every=every)
        count = walk_eval("count", **env) if first < blocks else 0

        def block_rows(i):
            row0 = walk_eval("row0", i=i, **env)
            return list(range(row0, min(row0 + rpb, rows)))

        ev = []
        j = 0
        while walk_eval("initial", j=j, count=count, **env):
            ev.append(("issue", j, walk_eval("issue_slot", i=j, **env),
                       block_rows(j), None))
            j += 1
        for i in range(count):
            if walk_eval("refill", i=i, count=count, **env):
                r = walk_eval("refill_run", i=i, **env)
                ev.append(("issue", r, walk_eval("issue_slot", i=r, **env),
                           block_rows(r), None))
            slot = walk_eval("wait_slot", i=i, **env)
            ev.append(("wait", i, slot, block_rows(i),
                       walk_eval("parity", i=i, **env)))
            ev.append(("free", i, slot, block_rows(i), None))
        out.append((bx, ev))
    return grid, out


@pytest.mark.parametrize("log2n", sorted(RING))
@pytest.mark.parametrize("case", ["ragged waves", "under a wave", "one row",
                                  "many waves"])
def test_ring_walk_visits_every_row_once(log2n, case):
    """Every row is copied by exactly one block's fill (across its slots
    and the grid), a slot is filled again only after the row block it held
    is freed, and each wait is on the fill of its own row block at that
    fill's barrier parity: for 3 x grid x RPB + 1 rows (every block walks
    three row blocks, one a fourth that ends ragged), fewer row blocks than
    the grid, one row, and nine waves."""
    rpb, slots = RING[log2n]
    per = shape(log2n, rpb, slots)["per"]
    grid = SMS * per
    rows = {"ragged waves": 3 * grid * rpb + 1,
            "under a wave": (grid // 2) * rpb - 1,
            "one row": 1, "many waves": 9 * grid * rpb}[case]
    got_grid, blocks = ring_walk(rows, rpb, slots, per)
    assert got_grid == min((rows + rpb - 1) // rpb, grid)
    seen = np.zeros(rows, np.int64)
    for bx, ev in blocks:
        held, fills = {}, {}
        for kind, i, slot, rws, parity in ev:
            assert 0 <= slot < slots
            if kind == "issue":
                assert slot not in held, "a slot filled before it is free"
                held[slot] = i
                fills[slot] = fills.get(slot, 0) + 1
                seen[rws] += 1
            elif kind == "wait":
                assert held.get(slot) == i, "a wait on another row block"
                assert parity == (fills[slot] - 1) & 1, "a wrong phase"
            else:
                assert held.pop(slot) == i
        assert not held
    assert (seen == 1).all()


def test_fills_count_their_bytes():
    """Each fill expects the bytes its copies bring: below n = 512 the
    boxes of the whole slot (rows past the end come as zeros and count),
    from 512 one copy a row of each plane (or of pairs) for the rows that
    exist, N*8 bytes a row either way."""
    assert "mbar_expect(bar, P * (int)sizeof(float2));" in ROWS_SRC
    assert "mbar_expect(bar, nr * N * (int)sizeof(V));" in ROWS_SRC
    for copy in ("bulk_copy(dst + 2 * r * N, io.in + o, N * (int)sizeof(V), "
                 "bar);",
                 "bulk_copy(dst + r * N, io.in + o, N * (int)sizeof(Real), "
                 "bar);",
                 "bulk_copy(dst + P + r * N, io.in_im + o, "
                 "N * (int)sizeof(Real),\n                    bar);",
                 "tma_load_2d(dst, &map_re, 0, static_cast<int>(row0), bar);",
                 "if (!pin) tma_load_2d(dst + P, &map_im, 0, "
                 "static_cast<int>(row0), bar);"):
        assert copy in ROWS_SRC, copy


# ------------------------------------------------------ the operand rule


def ring_planes(kind, dtype=torch.float32):
    """(rows, n) planes of ``dtype`` of each layout the rule sees, seeded."""
    g = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    if kind == "planar":
        return rand(64, 256), rand(64, 256)
    if kind == "pairs":
        v = torch.view_as_real(torch.complex(rand(64, 256), rand(64, 256)))
        return v[..., 0], v[..., 1]
    if kind == "offset":                # one real off 16-byte alignment
        flat = rand(64 * 256 + 1)
        return flat[1:].view(64, 256), rand(64, 256)
    if kind == "rows 4 bytes apart":    # a row stride of 257 reals
        return rand(64, 257)[:, :256], rand(64, 257)[:, :256]
    if kind == "pairs swapped":         # im before re
        v = torch.view_as_real(torch.complex(rand(64, 256), rand(64, 256)))
        return v[..., 1], v[..., 0]
    raise AssertionError(kind)


# The rule, as the C entries apply it: K1's planes become the ring's
# operands through ring_planes (pairs where the imaginary plane is one float
# after the real one at element stride 2), K2's pairs directly (in_pairs 1,
# the row stride in floats); ring_rows_operands then decides.
OPERANDS = rows_text(
    r"inline bool ring_rows_operands\(const RingIo<Real>& io\) \{\n"
    r"  const uintptr_t a = reinterpret_cast<uintptr_t>\(io\.in\);\n"
    r"  const uintptr_t b = reinterpret_cast<uintptr_t>\(io\.in_im\);\n"
    r"  return ([^;]+);\n\}")[0]
IN_PAIRS = rows_text(r"\n  const bool in_pairs = ([^;]+);\n")[0]
K2_RING = ("  const RingIo<float> ring{static_cast<const float*>(in), nullptr,"
           "\n                           static_cast<float*>(out), nullptr, "
           "rows, 1, 1, 2,\n                           2LL * in_rs, 2LL * "
           "out_rs, 2, postscale};")
DISPATCH = ("  if (ring.rows > 0 && ring_rows_rpb<Real>(log2n) &&\n"
            "      ring_rows_operands(ring)) {")


def c_bool(expr: str, real_bytes: int = 4, **env) -> bool:
    """A boolean C expression of the source in Python: ``||`` and ``&&``,
    the operand fields ``io.x`` from ``env``, ``sizeof(Real)`` the planes'
    ``real_bytes``."""
    py = (expr.replace("||", " or ").replace("&&", " and ")
          .replace("io.", "").replace("(long long)sizeof(Real)",
                                      str(real_bytes)))
    return bool(eval(f"({py})", {"__builtins__": {}}, env))


def ring_takes(re, im) -> bool:
    """Whether the C rule sends K1's (K11's on float64) planes (``im``
    given; pointers in bytes, strides in reals) or K2's pairs (``im``
    None, ``re`` the float view of the pairs) to the ring."""
    assert K2_RING in ROWS_SRC and DISPATCH in ROWS_SRC
    rb = re.element_size()
    if im is None:
        pairs, b, es = 1, 0, 2
    else:
        pairs = c_bool(IN_PAIRS, in_es=re.stride(1),
                       in_re=re.data_ptr() // rb, in_im=im.data_ptr() // rb)
        b, es = im.data_ptr(), re.stride(1)
    return c_bool(OPERANDS, real_bytes=rb, a=re.data_ptr(), b=b,
                  in_pairs=pairs, in_es=es, rows=re.shape[0],
                  in_rs=re.stride(0))


@pytest.mark.parametrize("kind,ok", [
    ("planar", True), ("pairs", True), ("offset", False),
    ("rows 4 bytes apart", False), ("pairs swapped", False)])
def test_ring_operands_rule(kind, ok):
    """K1's planes go to the ring where its bulk copies read them as they
    lie (planar, or the complex form's pairs; 16-byte aligned; rows 16
    bytes apart); any other layout (an offset view, rows padded by one
    float, im before re) runs the first design, which reads any strides:
    no copy is taken and nothing falls back to the plain version."""
    re, im = ring_planes(kind)
    assert ring_takes(re, im) == ok
    assert ring_takes(re[:1], im[:1]) == (kind not in (
        "offset", "pairs swapped"))


@pytest.mark.parametrize("pad,lead,ok", [(0, 0, True), (4, 0, True),
                                         (2, 0, False), (0, 2, False)])
def test_ring_operands_rule_pairs(pad, lead, ok):
    """K2's pairs: dense and rows padded by 16 bytes go to the ring; rows
    padded by 8 bytes and a view 8 bytes off 16-byte alignment (both of
    which K2 takes) run the first design."""
    buf = torch.zeros(32 * (512 + pad) + lead)
    v = buf[lead:].view(32, 512 + pad)[:, :512]
    assert ring_takes(v, None) == ok


# ------------------------------------------------- the launches counted


def test_ran_ring_is_the_sources():
    """The wrapper's RAN_RING is what the C entries return where the ring
    ran, and only the ring's launch path returns it."""
    assert local.RAN_RING == int(rows_text(
        r"\nconstexpr int RAN_RING = (-?\d+);")[0])
    assert ROWS_SRC.count("RAN_RING :") == 1
    assert ("return e == cudaSuccess ? RAN_RING : (int)e;"
            in ROWS_SRC)


@pytest.mark.parametrize("err,ring", [(local.RAN_RING, 1), (0, 0)])
def test_ring_launches_counted(monkeypatch, err, ring):
    """``launch.K1.ring`` counts a K1 launch whose C entry returned
    RAN_RING (the ring ran), and only that; ``total("launch.K1")`` counts
    it either way.  The
    launch itself is replaced here (no card), the wrapper is K1's own."""
    called = []

    def entry(*args):
        called.append(args)
        return err

    monkeypatch.setattr(local, "_rows_fn", lambda dtype: entry)
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    re, im = ring_planes("planar")
    local._launch_rows(re, im, re.clone(), im.clone(), -1, 1.0)
    assert len(called) == 1
    assert (profiling.total("launch.K1"),
            profiling.total("launch.K1.ring")) == (1, ring)


@pytest.mark.parametrize("name,err,ring", [
    ("local_rows", 7, True), ("local_rows_il", 700, True),
    ("local_rows_f64", local.RAN_RING, False),
    ("local_rows_il_i8", local.RAN_RING, False)])
def test_failed_launch_raises(monkeypatch, name, err, ring):
    """A failed launch raises and counts nothing; RAN_RING from an entry
    whose launch maps no ring (the int8 kernels) is a failure too."""
    profiling.reset()
    keys = {0: "launch.K1.first"}
    if ring:
        keys[local.RAN_RING] = "launch.K1.ring"
    entry = Launch(lambda *args: err, (), (), "pyfft.entry.K1", keys, name)
    with pytest.raises(RuntimeError, match=f"{name} launch failed"):
        entry(0)
    assert profiling.counts() == {}


# ------------------------------------------- K11: the ring on double planes

F64_ENTRY = ("  return rows_ring<double, false>(log2n, ring_planes(old), "
             "old, tw, sign,\n                                  stream);")


# K11's ring at the lengths it may take: its table's, and the shapes of
# the probe patch that puts n = 1024 and 2048 on it too (k11ring of
# probes/float_split.py; the first design was as fast or faster there)
F64_SHAPES = {10: (2, 3), 11: (1, 3), **RING_F64}


def test_ring_f64_table_rules():
    """K11's ring at n = 4096 (bulk copies only: a tensor map has no
    16-byte element for pairs of doubles; 1024 and 2048 run the first
    design with TWD), one row a slot in two slots, and at the probe
    patch's 1024 and 2048 (2048 points a slot, three slots); every slot
    within a block's shared memory, threads that take 16 points a stage
    and tile the slot, one bulk copy a row within an mbarrier's byte
    count, at least one block an SM; radix 16 in double (a round trip
    fewer at each length)."""
    assert sorted(RING_F64) == [12]
    assert R16_F64 and F64_ENTRY in ROWS_SRC
    assert "constexpr bool OLD_TWD_F64 = true;" in ROWS_SRC
    for log2n, (rpb, slots) in F64_SHAPES.items():
        s = shape(log2n, rpb, slots, 16)
        n, p, nt = s["n"], s["p"], s["nt"]
        assert not s["box"] and not s["pass_in"] and not s["pass_out"]
        assert slots >= 2 and s["smem"] <= SMEM and s["per"] >= 1
        assert nt * 16 == p and nt <= 1024 and nt % 32 == 0
        assert p * 16 < 1 << 20 and (n * 8) % 16 == 0
        assert s["slot"] * 16 % 128 == 0 and s["slot"] >= p
        assert s["r16"]
        for r in radices(log2n, s["r16"]):
            assert (n // r) * rpb % nt == 0
    # one block of 256 threads an SM at n = 4096; two of 128 at 1024
    assert shape(12, *RING_F64[12], 16)["per"] == 1
    assert shape(12, *RING_F64[12], 16)["nt"] == 256
    assert shape(10, *F64_SHAPES[10], 16)["per"] == 2


@pytest.fixture
def static_jax_tables(tmp_path, monkeypatch):
    """Point the JAX package's autotune record at an empty file."""
    path = tmp_path / "tuned.json"
    path.write_text("{}")
    monkeypatch.setenv("PYFFT_TPU_TUNE_FILE", str(path))
    jax_local.reload_tuned()
    yield
    jax_local._TUNED = None


@pytest.mark.parametrize("sign,post", [(-1, 0.5), (1, 0.3)])
@pytest.mark.parametrize("log2n", [10, 11, 12])
def test_ring_f64_chain_matches_numpy_and_jax(log2n, sign, post,
                                              static_jax_tables):
    """K11's ring in FP64 (radix 16 after a radix-4 or 8 head, padded
    rows, TWD's twiddle products in double) on a ragged last slot (RPB + 1
    rows), against numpy.fft and JAX's double-float row kernel
    (``pallas_df64.fft_axis_df64``, interpret mode) at 1e-11."""
    from pyfft_tpu.ops import df64 as jax_df64
    from pyfft_tpu.ops import pallas_df64
    n = 1 << log2n
    rpb, slots = F64_SHAPES[log2n]
    rows = rpb + 1
    rng = np.random.default_rng(log2n * 3 + (sign > 0))
    x = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    got = chain_model(x, sign, post, log2n, rpb, slots)
    ref = (np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n) * post
    assert rel(got, ref) < TOL64
    quad = []
    for plane in (x.real, x.imag):
        hi, lo = jax_df64.split_f64(np.ascontiguousarray(plane))
        quad += [jnp.asarray(hi), jnp.asarray(lo)]
    rh, rl, ih, il = (np.asarray(q) for q in pallas_df64.fft_axis_df64(
        tuple(quad), sign, axis=-1, postscale=post, interpret=True))
    jgot = (jax_df64.combine_f64(rh, rl) + 1j * jax_df64.combine_f64(ih, il))
    assert rel(got, jgot) < TOL64


@pytest.mark.parametrize("log2n", sorted(RING_F64))
@pytest.mark.parametrize("case", ["ragged waves", "under a wave", "one row"])
def test_ring_f64_walk_visits_every_row_once(log2n, case):
    """K11's walk (the kernel's own expressions at its table's shapes):
    every row copied once, no slot filled before it is freed, each wait at
    its fill's parity."""
    rpb, slots = RING_F64[log2n]
    per = shape(log2n, rpb, slots, 16)["per"]
    grid = SMS * per
    rows = {"ragged waves": 3 * grid * rpb + 1,
            "under a wave": (grid // 2) * rpb - 1, "one row": 1}[case]
    _, blocks = ring_walk(rows, rpb, slots, per)
    seen = np.zeros(rows, np.int64)
    for bx, ev in blocks:
        held, fills = {}, {}
        for kind, i, slot, rws, parity in ev:
            if kind == "issue":
                assert slot not in held
                held[slot] = i
                fills[slot] = fills.get(slot, 0) + 1
                seen[rws] += 1
            elif kind == "wait":
                assert held.get(slot) == i
                assert parity == (fills[slot] - 1) & 1
            else:
                assert held.pop(slot) == i
    assert (seen == 1).all()


@pytest.mark.parametrize("kind,ok", [
    ("planar", True), ("pairs", True), ("offset", False),
    ("rows 4 bytes apart", False), ("pairs swapped", False)])
def test_ring_f64_operands_rule(kind, ok):
    """K11's double planes go to the ring where its bulk copies read them
    as they lie (planar, or the complex form's pairs of doubles; 16-byte
    aligned; rows 16 bytes apart: an even row stride in doubles); a view
    one double off alignment, rows one double longer or im before re run
    the first design."""
    re, im = ring_planes(kind, torch.float64)
    assert ring_takes(re, im) == ok


@pytest.mark.parametrize("log2n,ring", [(12, True), (11, False),
                                        (10, False), (9, False), (3, False)])
def test_ring_f64_dispatch_rule(log2n, ring):
    """K11 runs the ring at the lengths of its table (n = 4096) and the
    first design at every other (the ring's rpb lookup by the planes'
    type)."""
    assert (log2n in RING_F64) == ring
    assert ("template <typename Real>\nint ring_rows_rpb(int log2n) {"
            in ROWS_SRC)
    assert ("  if constexpr (sizeof(Real) == sizeof(float)) {\n"
            "    PYFFT_ROWS_RING(PYFFT_RING_RPB)\n  } else {\n"
            "    PYFFT_ROWS_RING_F64(PYFFT_RING_RPB)\n  }") in ROWS_SRC


@pytest.mark.parametrize("err,ring", [(local.RAN_RING, 1), (0, 0)])
def test_ring_f64_launches_counted(monkeypatch, err, ring):
    """``launch.K11.ring`` counts a K11 launch whose C entry returned
    RAN_RING, ``total("launch.K11")`` every K11 launch; K1's counts
    stay."""
    monkeypatch.setattr(local, "_rows_fn", lambda dtype: lambda *a: err)
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    re, im = ring_planes("planar", torch.float64)
    local._launch_rows(re, im, re.clone(), im.clone(), -1, 1.0)
    assert (profiling.total("launch.K11"),
            profiling.total("launch.K11.ring")) == (1, ring)
    assert profiling.total("launch.K1") == 0


def test_ring_f64_failed_launch_raises(monkeypatch):
    """A failed K11 launch raises and counts nothing."""
    monkeypatch.setattr(local, "_rows_fn", lambda dtype: lambda *a: 700)
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    re, im = ring_planes("planar", torch.float64)
    with pytest.raises(RuntimeError, match="local_rows launch failed"):
        local._launch_rows(re, im, re.clone(), im.clone(), -1, 1.0)
    assert profiling.counts() == {}


@pytest.mark.parametrize("log2n", [6, 10, 11])
def test_first_design_twd_f64(log2n):
    """K11's first design forms w^3, w^5 and w^6 of a radix-8 butterfly
    from its reads of w^1, w^2 and w^4 (OLD_TWD_F64; K1's float stages
    read all seven): at every butterfly of every stage the products agree
    with the table's own entries to double's roundoff."""
    text = ROWS_SRC[ROWS_SRC.index("      if constexpr (OLD_TWD_F64 && "
                                   "sizeof(Real) == sizeof(double) &&"):]
    text = text[:text.index("      } else {")]
    for term in ("v[b][3] = cmul(v[b][3], cmul(w1, w2));",
                 "v[b][5] = cmul(v[b][5], cmul(w1, w4));",
                 "v[b][6] = cmul(v[b][6], cmul(w2, w4));",
                 "v[b][7] = cmul(v[b][7], __ldg(&tw[7 * e]));"):
        assert term in text, term
    n = 1 << log2n
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    ns = 1 << (log2n % 3 or 3)            # after the first stage
    while ns < n:
        j = np.arange(n // 8)
        e = (j % ns) * (n // (ns * 8))
        got = butterfly_twiddles(tw, e, 8, True, np.complex128)
        want = tw[np.arange(8)[None, :] * e[:, None]]
        assert np.abs(got - want).max() < 1e-14
        ns *= 8
