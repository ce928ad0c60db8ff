"""K5's redesigns on the CPU: numpy models of what the complex64 column
pass computes on the card from n = 16 to 256 (csrc/local_cols.cu
``local_cols_pring_kernel``, a persistent grid walking every (l, run of C
columns) tile through a ring of slots fed by tensor-map boxes) and from
n = 1024 (``local_cols_x_kernel`` in float, the cluster tile of
csrc/cluster_cols.cuh), index by index, and of how the ring's blocks walk
the tiles.

The shapes are read from the sources (``PYFFT_COLS_PRING``, ``PRing``'s
constants, ``PYFFT_XCOLS_F32`` and ``_S2``), and so is the walk (a block's
tiles, the grid cut to whole rounds, the ring's first fills, refills,
slots and barrier parities), so the models test what the kernels are built
with.  The ring's chain model follows chain.cuh's stages over a slot's
[k][c] layout (radix 16 where it takes a stage fewer than radix 8, TWD's
twiddle products, every slot index written once a stage), its last stage's
`full` twiddle, postscale and plain store (every output once), against
numpy.fft (2e-6) and JAX's column kernel in interpret mode (1e-6).  The
cluster tile's model (tests/test_torch_cluster_cols.py's) runs the float
tables in every twiddle and store mode.  The dispatch between the designs,
the launch counts and a failed launch are held on the wrapper with its C
entry replaced.  The CUDA kernels run on the card (chip_smoke.py phases 6,
8, 9, probes/ab_parent.py, probes/float_split.py).
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.utils import profiling

from test_torch_cluster_cols import (CSRC, c_eval, col_modes, col_reference,
                                     k12_model, macro_cases)
from test_torch_rows_ring import butterfly_twiddles, c_bool, radices
from test_torch_swap_ctile import col_width

torch.set_num_threads(2)

TOL = 2e-6
PARITY = 1e-6
SMEM = 227 * 1024               # shared memory a block may take (H100)
SM_SMEM = 228 * 1024            # an SM's, with 1 KB a block reserved
BOX = 256                       # the most rows a tensor copy's box takes
SMS = 132                       # an H100's SMs

COLS_SRC = (CSRC / "local_cols.cu").read_text()
# the ring's kernel, from its barriers' declaration to its end
PRING_SRC = COLS_SRC[COLS_SRC.index("  __shared__ uint64_t full[S];"):
                     COLS_SRC.index("// The card's SMs and the blocks of the "
                                    "persistent ring")]


def cols_text(pattern: str, src: str = COLS_SRC) -> tuple:
    """The groups of ``pattern``'s one match in ``src`` (local_cols.cu)."""
    m = re.findall(pattern, src)
    assert len(m) == 1, f"{pattern!r} not in local_cols.cu once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


PRING = {log2n: (C, S) for log2n, C, S in
         macro_cases("local_cols.cu", "PYFFT_COLS_PRING")}
XCOLS_F32 = macro_cases("local_cols.cu", "PYFFT_XCOLS_F32")
XCOLS_F32_S2 = {c[0]: c for c in macro_cases("local_cols.cu",
                                             "PYFFT_XCOLS_F32_S2")}
R16, TWD = (v == "true" for v in cols_text(
    r"\nconstexpr bool PRING_R16 = (\w+), PRING_TWD = (\w+);"))
RAN = dict(zip(("ring", "x", "xring"), map(int, cols_text(
    r"\nconstexpr int RAN_RING = (-?\d+), RAN_X = (-?\d+), "
    r"RAN_XRING = (-?\d+);"))))
# the lengths of K5's persistent cluster ring on the complex form's pairs
XRING_F32 = {c[0] for c in macro_cases("local_cols.cu",
                                       "PYFFT_XRING_F32_S2")}


def pring_shape(log2n: int, C: int, S: int) -> dict:
    """PRing's constants (csrc/local_cols.cu) at (log2 n, C, S)."""
    n = 1 << log2n
    p = n * C
    nt = p // 16
    smem = S * p * 8 + 128
    return dict(n=n, C=C, S=S, p=p, nt=nt, mb=min(n, BOX), smem=smem,
                per=min(SM_SMEM // (smem + 1024), 2048 // nt),
                r16=R16 and (log2n + 3) // 4 < (log2n + 2) // 3)


def test_pring_constants_are_the_sources():
    """The model's constants are PRing's own expressions."""
    for text in (
            "static constexpr int N = 1 << LOGN, C = C_, S = S_, P = N * C;",
            "static constexpr int NT = P / 16;",
            "static constexpr int MB = N < BOX ? N : BOX;",
            "static constexpr bool R16 = PRING_R16 && (LOGN + 3) / 4 < "
            "(LOGN + 2) / 3;",
            "static constexpr int SLOT = P * (int)sizeof(float2);",
            "static constexpr int SMEM = S * SLOT + 128;",
            "static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);",
            "static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM : "
            "2048 / NT;"):
        assert text in COLS_SRC, text
    assert int(cols_text(r"\nconstexpr int BOX = (\d+);")[0]) == BOX


# ------------------------------------------------------------ the tables


def test_pring_table_rules():
    """The ring takes every n from 16 to 256 (8 and 512 run the first
    design, as fast or faster there on the card) with the first design's C
    (ColShape: the wrapper's width and the tiles agree), three slots, a
    slot of 16 to 64 KB, whole warps taking 16 points a stage, the box's
    row whole 16-byte units (C % 4) of at most 256 columns, one box of at
    most 256 rows a plane, an mbarrier's byte count, every block within its shared memory
    and at least one an SM; radix 16 at n = 16, 128 and 256 (a stage
    fewer), TWD on."""
    assert sorted(PRING) == list(range(4, 9))
    assert tuple(1 << k for k in sorted(PRING)) == local.COL_RING_LENGTHS
    assert R16 and TWD
    for log2n, (C, S) in PRING.items():
        s = pring_shape(log2n, C, S)
        assert C == col_width(s["n"]) and S == 3
        assert 16 * 1024 <= s["p"] * 8 <= 64 * 1024
        assert s["smem"] <= SMEM and s["per"] >= 1
        assert 32 <= s["nt"] <= 1024 and s["nt"] % 32 == 0
        assert C % 4 == 0 and C <= BOX and s["n"] % s["mb"] == 0
        assert s["p"] * 8 < 1 << 20
        for r in radices(log2n, s["r16"]):
            assert (s["n"] // r) * C % s["nt"] == 0
    assert [k for k in PRING if pring_shape(k, *PRING[k])["r16"]] == [4, 7, 8]
    # config 4's z pass: one block of 512 threads an SM, 192 KB of ring
    s = pring_shape(8, *PRING[8])
    assert (s["C"], s["nt"], s["per"], s["smem"]) == (32, 512, 1, 196736)


def xtile_shape(log2n: int, G: int, C: int, B: int) -> dict:
    """XCols<float, ...> and its XTile's constants at a table's entry."""
    n = 1 << log2n
    M = n // G
    nt = min(M * C // 8, 512)
    return dict(M=M, nt=nt, KR=M // G, P=M * C, E=M * C // nt,
                pairs=(M // G) * C // nt, swap=(M + 1) * C * 8, B=B)


@pytest.mark.parametrize("table", ["planar", "stride2"])
def test_xcols_f32_table_rules(table):
    """K5's cluster tile takes n = 1024 to 8192: 128-byte runs of each
    plane (32 floats planar, 16 pairs on the stride-2 planes; 64 bytes at
    n = 8192 planar, where 16 blocks, the largest cluster, hold 512 rows
    each), G-point exchanges of radix 2 to 16, threads that tile the block
    and the exchange (XTile's static assertions), every block's swapped
    buffer within its shared memory and two blocks an SM (its launch
    bounds)."""
    rows = XCOLS_F32 if table == "planar" else list(XCOLS_F32_S2.values())
    assert [r[0] for r in rows] == [10, 11, 12, 13]
    span = 4 if table == "planar" else 8
    for log2n, G, C, B in rows:
        x = xtile_shape(log2n, G, C, B)
        assert G in (2, 4, 8, 16) and 128 % C == 0
        assert C * span == 128 or (log2n, C) == (13, 16)
        assert x["E"] * x["nt"] == x["P"] and x["pairs"] >= 1
        assert x["pairs"] * x["nt"] == x["KR"] * C and x["P"] // 8 >= x["nt"]
        assert x["swap"] <= SMEM and B * (x["swap"] + 1024) <= SM_SMEM
        assert B == 2


# ------------------------------------------------------------- the walk

# the walk as local_cols_pring_kernel states it: a block's first tile, its
# stride and its count, the tile of iteration i, its (l, t0), the ring's
# first fills, its refill at the top of iteration i, the slot and barrier
# parity each wait takes; the grid, whole rounds of at most one wave
WALK = dict(zip(("first", "every"), cols_text(
    r"const long long first = ([^,]+), every = ([^;]+);", PRING_SRC)))
WALK["count"] = cols_text(
    r"const int count =\s+first < tiles \? static_cast<int>\(([^;]+)\)\s+"
    r": 0;", PRING_SRC)[0]
WALK["tile"] = cols_text(
    r"const auto fill = \[&\]\(int i\) \{\n"
    r"    const long long tile = ([^;]+);", PRING_SRC)[0]
WALK["l"], WALK["t0"] = cols_text(
    r"const long long l = ([^,]+), t0 = ([^;]+);", PRING_SRC)
WALK["issue_slot"] = cols_text(r"uint64_t\* bar = &full\[([^\]]+)\];",
                               PRING_SRC)[0]
WALK["initial"] = cols_text(
    r"for \(int j = 0; ([^;]+); \+\+j\) fill\(j\);", PRING_SRC)[0]
WALK["refill"], WALK["refill_run"] = cols_text(
    r"if \(threadIdx\.x == 0 && (i && [^)]+)\) fill\(([^)]+)\);", PRING_SRC)
WALK["wait_slot"], WALK["parity"] = cols_text(
    r"mbar_wait\(&full\[([^\]]+)\], ([^;]+)\);", PRING_SRC)
WALK["rounds"] = cols_text(r"const long long rounds = ([^;]+);")[0]


def walk_eval(key: str, **env) -> int:
    """WALK[key] evaluated in Python (``&&`` read as ``and``, ``io.`` the
    operands' fields)."""
    expr = WALK[key].replace("&&", " and ").replace("io.", "")
    return c_eval(expr, **env)


def test_pring_grid_is_whole_rounds():
    """The grid is the fewest blocks that take the rounds one wave needs:
    (tiles + rounds - 1) / rounds with rounds = ceil(tiles / wave)."""
    assert "const long long grid = (tiles + rounds - 1) / rounds;" in COLS_SRC
    assert WALK["rounds"] == "(tiles + wave - 1) / wave"
    # config 4's z pass: 2048 tiles of 32 columns, one wave of 132 blocks:
    # 16 rounds on 128 blocks, none idle at the end
    rounds = walk_eval("rounds", tiles=2048, wave=132)
    assert (rounds, -(-2048 // rounds)) == (16, 128)


def test_pring_loop_order():
    """In each iteration the refill of the slot freed by the last one
    comes first, then the wait on this one's fill, then the chain, whose
    last stage's barrier after its reads of the slot frees it; its first
    stage reads the slot it writes (SYNC0)."""
    body = PRING_SRC[PRING_SRC.index("  for (int i = 0; i < count; ++i) {"):]
    marks = [body.index(m) for m in (
        "fill(" + WALK["refill_run"] + ")", "mbar_wait(",
        "chain<NT, LOGN, C, false, 0, 1, true, true, false, PRING_TWD, "
        "K::R16,\n          true>(sm, fresh(tw), s, load, store);")]
    assert marks == sorted(marks)
    chain_src = (CSRC / "chain.cuh").read_text()
    assert "if (!FIRST || SYNC0) __syncthreads();" in chain_src


def pring_walk(L: int, T: int, C: int, S: int, per: int):
    """Every block's program order over (L, n, T), from the kernel's own
    expressions: [(block, [(event, i, slot, (l, t0), parity)])]."""
    tiles = -(-T // C) * L
    wave = SMS * per
    rounds = walk_eval("rounds", tiles=tiles, wave=wave)
    grid = (tiles + rounds - 1) // rounds
    out = []
    for bx in range(grid):
        env = dict(S=S, C=C, L=L, tiles=tiles)
        # first = blockIdx.x, every = gridDim.x
        assert (WALK["first"], WALK["every"]) == ("blockIdx.x", "gridDim.x")
        first, every = bx, grid
        env.update(first=first, every=every)
        count = walk_eval("count", **env) if first < tiles else 0

        def where(i):
            tile = walk_eval("tile", i=i, **env)
            return (walk_eval("l", tile=tile, **env),
                    walk_eval("t0", tile=tile, **env))

        ev = []
        j = 0
        while walk_eval("initial", j=j, count=count, **env):
            ev.append(("issue", j, walk_eval("issue_slot", i=j, **env),
                       where(j), None))
            j += 1
        for i in range(count):
            if walk_eval("refill", i=i, count=count, **env):
                r = walk_eval("refill_run", i=i, **env)
                ev.append(("issue", r, walk_eval("issue_slot", i=r, **env),
                           where(r), None))
            slot = walk_eval("wait_slot", i=i, **env)
            ev.append(("wait", i, slot, where(i),
                       walk_eval("parity", i=i, **env)))
            ev.append(("free", i, slot, where(i), None))
        out.append((bx, ev))
    return grid, out


@pytest.mark.parametrize("log2n", sorted(PRING))
@pytest.mark.parametrize("case", ["ragged waves", "under a wave", "one tile",
                                  "many waves"])
def test_pring_walk_visits_every_tile_once(log2n, case):
    """Every (l, t0) tile is filled by exactly one block (across its slots
    and the grid), a slot is filled again only after the tile it held is
    freed, each wait is on its own tile's fill at that fill's parity, and
    no two blocks' counts differ by more than one: for 3 waves and a
    ragged column (L = 3, T past whole tiles), under a wave, one tile, and
    nine waves."""
    C, S = PRING[log2n]
    per = pring_shape(log2n, C, S)["per"]
    wave = SMS * per
    L, T = {"ragged waves": (3, (wave * C) + 5),
            "under a wave": (1, (wave // 2) * C - 3),
            "one tile": (1, 3),
            "many waves": (2, 9 * wave * C // 2)}[case]
    tiles = -(-T // C) * L
    grid, blocks = pring_walk(L, T, C, S, per)
    assert grid <= min(tiles, wave)
    seen = {}
    counts = []
    for bx, ev in blocks:
        held, fills = {}, {}
        counts.append(sum(1 for e in ev if e[0] == "wait"))
        for kind, i, slot, tile, parity in ev:
            assert 0 <= slot < S
            if kind == "issue":
                assert slot not in held, "a slot filled before it is free"
                held[slot] = i
                fills[slot] = fills.get(slot, 0) + 1
                seen[tile] = seen.get(tile, 0) + 1
            elif kind == "wait":
                assert held.get(slot) == i, "a wait on another tile"
                assert parity == (fills[slot] - 1) & 1, "a wrong phase"
            else:
                assert held.pop(slot) == i
        assert not held
    want = {(l, t0) for l in range(L) for t0 in range(0, T, C)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert max(counts) - min(counts) <= 1


def test_pring_fills_count_their_bytes():
    """Each fill expects a whole slot (rows past T come as zeros and
    count) and copies it as n/MB boxes a plane (or of pairs) at (t0, 0, h,
    l) of the 4D map {T, MB, n/MB, L}."""
    for text in ("mbar_expect(bar, P * (int)sizeof(float2));",
                 "tma_load_4d(dst + (split ? part * P + h * MB * C : "
                 "2 * h * MB * C),\n                    part ? &map_im : "
                 "&map_re, t0, 0, h, l, bar);"):
        assert text in PRING_SRC, text
    for text in ("const cuuint32_t box[4] = {(cuuint32_t)C, "
                 "(cuuint32_t)K::MB, 1, 1};",
                 "const cuuint64_t dims[4] = {(cuuint64_t)io.T, "
                 "(cuuint64_t)K::MB,\n                              "
                 "(cuuint64_t)(K::N / K::MB), (cuuint64_t)io.L};"):
        assert text in COLS_SRC, text


# ------------------------------------------------------------ the chain


def pring_model(x: np.ndarray, sign: int, post: float, log2n: int,
                tw_n: int = 0) -> np.ndarray:
    """local_cols_pring_kernel's function on (L, n, T) complex64 columns,
    tile by tile: the slot's raw planes, chain.cuh's stages over the
    slot's [k][c] layout (threads q along c: c = q % C, j = q / C), the
    last stage's `full` twiddle (the wrapper's table) and postscale, the
    plain store.  Asserts that every stage writes each slot index once and
    inside the slot, and that every output is stored once."""
    C, S = PRING[log2n]
    s = pring_shape(log2n, C, S)
    n, p = s["n"], s["p"]
    L, _, T = x.shape
    tw = np.exp(sign * 2j * np.pi * np.arange(n) / n).astype(np.complex64)
    ta = ak = aq = None
    if tw_n:
        ta, _, ak, aq, adiv, _, _ = local._kernel_col_tables(
            n, T, tw_n, "full", 0, sign, False, torch.device("cpu"))
        assert adiv == 1
        ta = ta.reshape(-1, 2).numpy()
        ta = (ta[:, 0] + 1j * ta[:, 1]).astype(np.complex64)
    out = np.full(x.shape, np.nan, np.complex64)
    stored = np.zeros(x.shape, np.int64)
    rads = radices(log2n, s["r16"])
    for tile in range(-(-T // C) * L):
        l, t0 = tile % L, (tile // L) * C
        raw = np.zeros((n, C), np.complex64)          # columns past T: 0
        w = min(C, T - t0)
        raw[:, :w] = x[l, :, t0:t0 + w]
        buf = raw.ravel()                              # [k][c]
        ns = 1
        for i, radix in enumerate(rads):
            last = i == len(rads) - 1
            nr = n // radix
            q = np.arange(nr * C)
            c, j = q % C, q // C
            kin = j[:, None] + np.arange(radix)[None, :] * nr
            v = buf[kin * C + c[:, None]]
            if ns > 1:
                e = (j % ns) * (n // (ns * radix))
                v = v * butterfly_twiddles(tw, e, radix, TWD)
            r_ = np.arange(radix)
            dft = np.exp(sign * 2j * np.pi * np.outer(r_, r_) / radix)
            v = (v @ dft.astype(np.complex64)).astype(np.complex64)
            base = (j // ns) * ns * radix + j % ns
            kout = base[:, None] + r_[None, :] * ns
            cc = np.broadcast_to(c[:, None], kout.shape)
            if last:
                t = t0 + cc
                keep = t < T
                k, t, v = kout[keep], t[keep], v[keep]
                if tw_n:
                    v = v * ta[k * ak + t * aq]
                out[l, k, t] = v * np.float32(post)
                np.add.at(stored, (l, k, t), 1)
            else:
                idx = (kout * C + cc).ravel()
                assert len(np.unique(idx)) == idx.size, "a slot index twice"
                assert idx.max() < p, "a write past the slot"
                buf = np.full(p, np.nan, np.complex64)
                buf[idx] = v.ravel()
            ns *= radix
    assert (stored == 1).all(), "an output stored twice or never"
    return out


@pytest.mark.parametrize("tw", [False, True])
@pytest.mark.parametrize("sign,post", [(-1, 0.5), (1, 0.25)])
@pytest.mark.parametrize("log2n", sorted(PRING))
def test_pring_chain_matches_numpy_and_jax(log2n, sign, post, tw):
    """The ring's function at every n it takes, plain and `full` twiddle,
    on L = 2 planes of 130 columns (a ragged last tile at every C), against
    numpy.fft and JAX's column kernel (``pallas_local.fft_axis``, axis 1,
    interpret mode)."""
    n = 1 << log2n
    L, T = 2, 130
    rng = np.random.default_rng(log2n * 4 + (sign > 0) * 2 + tw)
    x = (rng.standard_normal((L, n, T))
         + 1j * rng.standard_normal((L, n, T))).astype(np.complex64)
    kw = dict(tw_n=n * T) if tw else {}
    got = pring_model(x, sign, post, log2n, n * T if tw else 0)
    want = col_reference(x.astype(np.complex128), sign, post, kw)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL
    jr, ji = jax_local.fft_axis(np.ascontiguousarray(x.real),
                                np.ascontiguousarray(x.imag), sign, axis=1,
                                postscale=post, interpret=True, **kw)
    jgot = np.asarray(jr) + 1j * np.asarray(ji)
    assert np.abs(got - jgot).max() / np.abs(jgot).max() < PARITY


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("mode", range(6))
@pytest.mark.parametrize("log2n,table", [(k, t) for k in (10, 11, 12, 13)
                                         for t in ("planar", "strided")])
def test_xcols_f32_model_matches_numpy(log2n, table, mode, sign):
    """The cluster tile at K5's float tables (planar, and the stride-2
    planes' table), in every twiddle and store mode, on the wrapper's
    operands and tables (the K12 model of tests/test_torch_cluster_cols.py,
    index by index, on planar planes), against numpy: every output written
    once."""
    n = 1 << log2n
    name, T, kw, layout = col_modes(n)[mode]
    row = (dict((r[0], r) for r in XCOLS_F32)[log2n] if table == "planar"
           else XCOLS_F32_S2[log2n])
    _, G, C, _ = row
    L = 1 if n >= 4096 else 2
    rng = np.random.default_rng(log2n * 10 + mode)
    x = rng.standard_normal((L, n, T)) + 1j * rng.standard_normal((L, n, T))
    xt = torch.from_numpy(x)
    post = 0.5 if sign < 0 else 1.0 / n
    oshape = local._col_out_shape((L, n, T), 1, kw.get("swap_store", False),
                                  kw.get("swap_mid", 0))
    re_, im_ = xt.real.contiguous(), xt.imag.contiguous()
    out = (torch.full(oshape, np.nan, dtype=torch.float64),
           torch.full(oshape, np.nan, dtype=torch.float64))
    writes, o = k12_model(re_, im_, *out, sign, post, G, C, kw)
    got = out[0].numpy() + 1j * out[1].numpy()
    want = col_reference(x, sign, post, kw)
    assert np.abs(got - want).max() / np.abs(want).max() < TOL, name
    assert (writes[writes != 0] == 1).all() and writes.sum() == got.size


# --------------------------------------------------------- the dispatch

PRING_TAKES = cols_text(
    r"inline bool pring_takes\(const Cols<float>& io, int swap_store\) \{\n"
    r"  return ([^;]+);\n\}")[0]
RING_OPERANDS = cols_text(
    r"inline bool ring_operands\(const Cols<float>& io\) \{\n"
    r"  const uintptr_t a = reinterpret_cast<uintptr_t>\(io\.in_re\);\n"
    r"  const uintptr_t b = reinterpret_cast<uintptr_t>\(io\.in_im\);\n"
    r"  const bool planar = ([^;]+);\n  const bool pairs = ([^;]+);\n"
    r"  return ([^;]+);\n\}")


def c_dispatch(r3, i3, dims, swap_store: bool) -> bool:
    """pring_takes, evaluated on the wrapper's operands and dims as the C
    entry receives them (pointers in bytes, strides in floats)."""
    (L, T, in_ls, in_ns, in_ts, out_ls, out_ns, out_as, out_bs, P, ak, aq,
     adiv, bk, bq, mode) = dims
    env = dict(a=r3.data_ptr(), b=i3.data_ptr(), in_ts=in_ts, in_ns=in_ns,
               in_ls=in_ls, L=L, in_re=r3.data_ptr() // 4,
               in_im=i3.data_ptr() // 4)
    env["planar"] = c_bool(RING_OPERANDS[0], **env)
    env["pairs"] = c_bool(RING_OPERANDS[1].replace("sizeof(float)", "4"),
                          **env)
    ops = c_bool(RING_OPERANDS[2], **env)
    expr = (PRING_TAKES.replace("ring_operands(io)", str(ops))
            .replace("!swap_store", str(not swap_store))
            .replace("TW_NONE", "0").replace("TW_TABLE", "1"))
    return c_bool(expr, P=P, T=T, tw_mode=mode, adiv=adiv)


def dispatch_planes(layout: str, n: int, T: int):
    """(3, n, T) float32 planes of a layout the rule sees."""
    g = torch.Generator().manual_seed(n + T)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    if layout == "planar":
        return rand(3, n, T), rand(3, n, T)
    if layout == "stride2":
        v = torch.view_as_real(torch.complex(rand(3, n, T), rand(3, n, T)))
        return v[..., 0], v[..., 1]
    if layout == "offset":              # 4 bytes off 16-byte alignment
        flat = rand(3 * n * T + 1)
        return flat[1:].view(3, n, T), rand(3, n, T)
    raise AssertionError(layout)


MODES = {"plain": {}, "full": dict(tw_n=1),
         "full swap": dict(tw_n=1, swap_store=True),
         "strided mid": dict(tw_n=1, tw_mode="strided", tw_period=128,
                             swap_mid=128),
         "factored swap": dict(tw_n=1, tw_mode="factored", swap_store=True),
         "mid = trail": dict(swap_mid=256)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", ["planar", "stride2", "offset"])
@pytest.mark.parametrize("n", [8, 16, 256, 512, 1024])
def test_design_rule(n, layout, mode, monkeypatch):
    """Which design each pass runs: the C rule (pring_takes on the
    wrapper's operands, after the cluster table) against ``col_design``:
    from n = 1024 the cluster tile in every mode and layout but where K5's
    persistent cluster ring takes the pass (its table's n on the complex
    form's stride-2 planes, pring_takes' modes); from 16 to 256 the
    ring on planar or stride-2 planes with a plain store (a mid swap as
    long as the trail is a plain store) and no twiddle or the `full` one;
    every other pass the first design (no copy, no fallback)."""
    monkeypatch.setattr(local, "_col_xtile", lambda log2n, ts, dtype: (
        (4, 32) if log2n >= 10 else None))
    T = 256
    kw = dict(MODES[mode])
    if kw.get("tw_n"):
        kw["tw_n"] = n * T
    re_, im_ = dispatch_planes(layout, n, T)
    oshape = local._col_out_shape((3, n, T), 1, kw.get("swap_store", False),
                                  kw.get("swap_mid", 0))
    r3, i3, o, dims, ta, tb = local._col_operands(
        re_, im_, torch.empty(oshape), torch.empty(oshape), -1, axis=1,
        tw_n=kw.get("tw_n", 0), tw_mode=kw.get("tw_mode", "full"),
        tw_period=kw.get("tw_period", 0),
        swap_store=kw.get("swap_store", False), swap_mid=kw.get("swap_mid", 0))
    # the entry launches the ring where pring_takes and its table has n
    takes = c_dispatch(r3, i3, dims, kw.get("swap_store", False))
    want = ("xring" if n.bit_length() - 1 in XRING_F32 and dims[4] == 2
            and takes else "x" if n >= 1024 else
            "ring" if n.bit_length() - 1 in PRING and takes else "first")
    got = local.col_design(n, torch.float32, boxable=local._boxable(r3, i3),
                           in_ts=dims[4], tw_mode=kw.get("tw_mode", "full"),
                           tw_n=kw.get("tw_n", 0),
                           swap_store=kw.get("swap_store", False),
                           swap_mid=kw.get("swap_mid", 0), T=T)
    assert got == want
    expect_ring = (16 <= n <= 256 and layout != "offset"
                   and mode in ("plain", "full", "mid = trail"))
    assert (want == "ring") == expect_ring
    assert (want == "xring") == (n == 1024 and layout == "stride2" and mode
                                 in ("plain", "full", "mid = trail"))
    # complex128 never runs the ring
    assert local.col_design(n, torch.float64, boxable=True, in_ts=1,
                            T=T) == ("x" if n >= 1024 else "first")


def test_dispatch_order_in_the_source():
    """The complex64 column entry tries the cluster table (planar, then
    stride-2 by the t stride), then the ring where pring_takes, and
    returns RAN_X and RAN_RING from those launches only; the complex128
    entry (K12) returns RAN_X from its cluster table through the same
    macro; the codes are the wrapper's."""
    assert (RAN["ring"], RAN["x"], RAN["xring"]) == (
        local.RAN_RING, local.RAN_X, local.RAN_XRING)
    f64 = COLS_SRC[COLS_SRC.index("    // K12: the cluster tile from n = "
                                  "1024"):]
    assert f64.index("PYFFT_XCOLS_F64_S2(PYFFT_XCOL)") < f64.index(
        "PYFFT_XCOLS_F64(PYFFT_XCOL)")
    body = COLS_SRC[COLS_SRC.index("    // K5: the cluster tile from n = "
                                   "1024 (RAN_X)"):]
    marks = [body.index(m) for m in (
        "PYFFT_XCOLS_F32_S2(PYFFT_XCOL)", "PYFFT_XCOLS_F32(PYFFT_XCOL)",
        "if (pring_takes(io, swap_store)) {", "PYFFT_COLS_PRING(PYFFT_PRING)",
        "return swap_store ? (int)dispatch<Real, MAXLOG, true>")]
    assert marks == sorted(marks)
    assert COLS_SRC.count("return e == 0 ? RAN_X : e;") == 1
    assert COLS_SRC.count("return e == cudaSuccess ? RAN_RING : (int)e;") == 1


# ------------------------------------------------------ the launches


def fake_launch(monkeypatch, err: int):
    """Replace the column entry (returning ``err``) and the card's calls,
    and zero the counts; returns the list of the entry's calls."""
    called = []

    def entry(*args):
        called.append(args)
        return err

    monkeypatch.setattr(local, "_cols_lib",
                        lambda d: (entry, lambda log2n: 32))
    monkeypatch.setattr(local, "_col_xtile", lambda *a: None)
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(local, "_kernel_twiddles",
                        lambda *a: torch.zeros(2))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    return called


@pytest.mark.parametrize("err,ring,x", [(-1, 1, 0), (-2, 0, 1), (0, 0, 0)])
def test_design_launches_counted(monkeypatch, err, ring, x):
    """``launch.K5.pring`` and ``launch.K5.x`` count the K5 launches whose
    C entry returned RAN_RING and RAN_X, ``launch.K5.first`` the others;
    ``total("launch.K5")`` counts every one."""
    called = fake_launch(monkeypatch, err)
    re_, im_ = dispatch_planes("planar", 256, 128)
    local._launch_cols(re_, im_, re_.clone(), im_.clone(), -1, axis=1,
                       postscale=1.0, tw_n=0, tw_mode="full", tw_period=0,
                       swap_store=False, swap_mid=0)
    assert len(called) == 1
    assert (profiling.total("launch.K5"), profiling.total("launch.K5.pring"),
            profiling.total("launch.K5.x")) == (1, ring, x)
    assert profiling.total("launch.K5.first") == 1 - ring - x


@pytest.mark.parametrize("err,dtype", [(700, torch.float32),
                                       (1, torch.float32),
                                       (-3, torch.float64),
                                       (700, torch.float64)])
def test_failed_launch_raises(monkeypatch, err, dtype):
    """A failed launch raises and counts nothing; a code no complex128
    design returns (-3, K5's RAN_XRING) from the complex128 entry is a
    failure too (RAN_RING is K12's cluster ring there,
    tests/test_torch_cols_xring_f64.py)."""
    fake_launch(monkeypatch, err)
    re_, im_ = (t.to(dtype) for t in dispatch_planes("planar", 256, 128))
    with pytest.raises(RuntimeError, match="local_cols launch failed"):
        local._launch_cols(re_, im_, re_.clone(), im_.clone(), -1, axis=1,
                           postscale=1.0, tw_n=0, tw_mode="full",
                           tw_period=0, swap_store=False, swap_mid=0)
    assert profiling.counts() == {}


@pytest.mark.parametrize("err,x", [(-2, 1), (0, 0)])
def test_k12_design_launches_counted(monkeypatch, err, x):
    """``launch.K12.x`` counts the K12 launches whose C entry returned
    RAN_X (the cluster tile), ``launch.K12.first`` the others; K5's counts
    stay."""
    called = fake_launch(monkeypatch, err)
    re_, im_ = (t.to(torch.float64)
                for t in dispatch_planes("planar", 256, 128))
    local._launch_cols(re_, im_, re_.clone(), im_.clone(), -1, axis=1,
                       postscale=1.0, tw_n=0, tw_mode="full", tw_period=0,
                       swap_store=False, swap_mid=0)
    assert len(called) == 1
    assert (profiling.total("launch.K12"),
            profiling.total("launch.K12.x")) == (1, x)
    assert profiling.total("launch.K5") == 0
