"""K8's plane ring on the CPU: numpy models of what the fused 2D kernel
computes on the card (csrc/fused2d.cu ``fused2d_ring_kernel``: a
persistent grid of clusters walking the planes, each block's share of the
next plane copied into a ring of slots by a tensor-map box, chain.cuh's
padded radix-16 chain along x, the exchange as one bulk copy a run into
the owning block's slot, the chain along y there), index by index, and of
how its clusters walk the planes.

The shapes are read from the source (``PYFFT_FUSED2D_RING``, the
``RING2_*`` constants, ``Ring2``'s expressions), and so are the walk (a
cluster's first plane, its stride and count, the ring's first fills, its
refill, the slot and barrier parity each wait takes, the grid), the
exchange's index map (``put``, the copies' source and destination) and the
dispatch rule (``ring2_operands``), so the models test what the kernel is
built with.  The chain model follows chain.cuh's stages (radix 16 where it
takes a stage fewer than radix 8, TWD's twiddle products, PAD's padded
rows, every buffer index written once a stage, every output once) against
numpy.fft (2e-6) and JAX's ``fft2_fused`` in interpret mode (1e-6), at the
nine shapes of the ring and, in the first design's options (radix 8,
unpadded rows, the gather), at the six it leaves to that design.  The
launch counts and a failed launch are held on the wrapper with its C entry
replaced.  The CUDA kernel runs on the card (chip_smoke.py phases 7, 9 and
22, probes/ab_parent.py, probes/float_split.py K8).
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import fused2d, local
from pyfft_tpu_torch.utils import profiling

from test_torch_cluster_cols import CSRC, c_eval, macro_cases
from test_torch_rows_ring import butterfly_twiddles, c_bool, radices

torch.set_num_threads(2)

TOL = 2e-6
PARITY = 1e-6
SMEM = 227 * 1024               # shared memory a block may take (H100)
SM_SMEM = 228 * 1024            # an SM's, with 1 KB a block reserved

SRC = (CSRC / "fused2d.cu").read_text()
# the ring's kernel, from its declaration to the operand rule after it
RING_SRC = SRC[SRC.index("    fused2d_ring_kernel(Planes2D io,"):
               SRC.index("// Whether the ring's tensor maps read the input")]
FIRST_SRC = SRC[SRC.index("    fused2d_kernel(Planes2D io,"):
                SRC.index("K8: the plane ring")]


def src_text(pattern: str, src: str = SRC) -> tuple:
    """The groups of ``pattern``'s one match in ``src`` (fused2d.cu)."""
    m = re.findall(pattern, src)
    assert len(m) == 1, f"{pattern!r} not in fused2d.cu once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


RING = [tuple(c) for c in macro_cases("fused2d.cu", "PYFFT_FUSED2D_RING")]
CASES = [tuple(c) for c in macro_cases("fused2d.cu", "PYFFT_FUSED2D_CASES")]
SHARE = int(src_text(r"\nconstexpr int RING2_SHARE = (\d+);")[0])
SLOTS = int(src_text(r"\nconstexpr int RING2_SLOTS = (\d+);")[0])
THREAD_POINTS = int(src_text(
    r"\nconstexpr int RING2_THREAD_POINTS = (\d+);")[0])
PAD, TWD, R16 = (v == "true" for v in src_text(
    r"\nconstexpr bool RING2_PAD = (\w+), RING2_TWD = (\w+), "
    r"RING2_R16 = (\w+);"))
BOX = int(src_text(r"\nconstexpr int RING2_BOX = (\d+);")[0])
RAN_RING = int(src_text(r"\nconstexpr int RAN_RING = (-?\d+);")[0])
NT_FIRST = int(src_text(r"\nconstexpr int NT = (\d+);")[0])


def ring_shape(ly: int, lx: int) -> dict:
    """Ring2's constants (csrc/fused2d.cu) at (log2 ny, log2 nx)."""
    ny, nx = 1 << ly, 1 << lx
    pb = max(ny * nx // 16, SHARE)
    g = ny * nx // pb
    nt = pb // THREAD_POINTS
    r16 = R16 and THREAD_POINTS == 16
    padded = (ny // g) * (nx + nx // 16) if PAD else pb
    slot = (max(padded, pb) * 8 + 127) // 128 * 128 // 8
    smem = (SLOTS * slot + pb) * 8 + 128
    return dict(ny=ny, nx=nx, pb=pb, g=g, rb=ny // g, cb=nx // g, nt=nt,
                bx=min(nx, BOX), slot=slot, smem=smem,
                per=min(SM_SMEM // (smem + 1024), 2048 // nt),
                r16x=r16 and (lx + 3) // 4 < (lx + 2) // 3,
                r16y=r16 and (ly + 3) // 4 < (ly + 2) // 3)


def first_shape(ly: int, lx: int) -> dict:
    """Shape2's constants (the first design) at (log2 ny, log2 nx)."""
    ny, nx = 1 << ly, 1 << lx
    g = min(ny * nx // 8192, 16)
    return dict(ny=ny, nx=nx, g=g, rb=ny // g, cb=nx // g,
                pb=ny * nx // g, nt=NT_FIRST)


def test_ring_constants_are_the_sources():
    """The model's constants are Ring2's own expressions."""
    for text in (
            "static constexpr int NY = 1 << LY, NX = 1 << LX, SLOTS = "
            "RING2_SLOTS;",
            "static constexpr int PB = NY * NX / 16 > RING2_SHARE ? NY * NX "
            "/ 16\n                                                       : "
            "RING2_SHARE;",
            "static constexpr int G = NY * NX / PB;",
            "static constexpr int RB = NY / G, CB = NX / G;",
            "static constexpr int NT = PB / RING2_THREAD_POINTS;",
            "static constexpr int BX = NX < RING2_BOX ? NX : RING2_BOX;",
            "static constexpr bool R16 = RING2_R16 && RING2_THREAD_POINTS == "
            "16;",
            "static constexpr bool R16X = R16 && (LX + 3) / 4 < (LX + 2) / 3;",
            "static constexpr bool R16Y = R16 && (LY + 3) / 4 < (LY + 2) / 3;",
            "static constexpr int PADDED = RING2_PAD ? RB * (NX + NX / 16) : "
            "PB;",
            "static constexpr int SLOT = ((PADDED > PB ? PADDED : PB) * 8 + "
            "127) / 128 *\n                              128 / 8;",
            "static constexpr int SMEM = (SLOTS * SLOT + PB) * 8 + 128;",
            "static constexpr int PER_SMEM = 228 * 1024 / (SMEM + 1024);",
            "static constexpr int PER = PER_SMEM < 2048 / NT ? PER_SMEM : "
            "2048 / NT;"):
        assert text in SRC, text
    assert "__launch_bounds__(Ring2<LY, LX>::NT, Ring2<LY, LX>::PER)" in SRC


# ------------------------------------------------------------ the tables


def test_ring_table_rules():
    """The ring takes every plane of at most 2^17 points but 256 x 512
    (nine of the fifteen shapes: the first design ran 256 x 512 faster on
    the H100; 2^18 points would need shares of 16384 points, and two such
    slots do not fit a block); shares of 4096 points where a cluster of at
    most 16 blocks covers the plane (256 threads, two blocks an SM), 8192
    at 2^17 points (512 threads, one); every block within its shared
    memory; one box of at most 256 rows and 256 runs a plane; an mbarrier's
    byte count; runs of 16-byte units for the exchange's copies; whole
    butterflies a thread at every stage of both chains; radix 16 on every
    axis but 512 (where radix 8 takes as few stages)."""
    assert RING == [c for c in CASES if sum(c) <= 17 and c != (8, 9)]
    assert tuple((1 << a, 1 << b) for a, b in RING) == fused2d.RING_SHAPES
    assert (SHARE, SLOTS, THREAD_POINTS, BOX) == (4096, 2, 16, 256)
    assert PAD and TWD and R16
    for ly, lx in RING:
        s = ring_shape(ly, lx)
        assert 2 <= s["g"] <= 16 and s["nt"] % 32 == 0
        assert s["pb"] == (4096 if ly + lx <= 16 else 8192)
        assert s["per"] == (2 if s["pb"] == 4096 else 1)
        assert s["smem"] <= SMEM
        assert s["rb"] <= BOX and s["nx"] // s["bx"] <= BOX
        assert s["bx"] * 4 % 16 == 0 and s["pb"] * 8 < 1 << 20
        assert s["rb"] * s["cb"] * 8 % 16 == 0
        for log2n, c, r16 in ((lx, s["rb"], s["r16x"]),
                              (ly, s["cb"], s["r16y"])):
            assert r16 == (log2n != 9)
            rads = radices(log2n, r16)
            assert len(rads) >= 2            # ChainPlan: a head and a last
            for r in rads:
                assert ((1 << log2n) // r) * c % s["nt"] == 0
                assert ((1 << log2n) // r) * c // s["nt"] * r * s["nt"] == \
                    (1 << log2n) * c
    # 2^18 points: two slots of 16384-point shares do not fit
    for ly, lx in CASES:
        if ly + lx == 18:
            ny, nx = 1 << ly, 1 << lx
            assert 2 * (ny // 16) * (nx + nx // 16) * 8 > SMEM
    # config 4's planes: 16 blocks of 16 rows and 16 columns
    s = ring_shape(8, 8)
    assert (s["g"], s["rb"], s["cb"], s["nt"], s["smem"]) == \
        (16, 16, 16, 256, 102528)


# ------------------------------------------------------------- the walk

# the walk as fused2d_ring_kernel states it: a cluster's first plane, its
# stride and count, the plane of fill i, the ring's first fills, the refill
# at the end of iteration i, the slot and parity each wait takes, the
# exchange's parity; the grid, the clusters the card holds at most
WALK = dict(zip(("first", "every"), src_text(
    r"const long long first = ([^,]+), every = ([^;]+);", RING_SRC)))
WALK["count"] = src_text(
    r"const int count =\s+first < io\.L \? static_cast<int>\(([^;]+)\)\s+"
    r": 0;", RING_SRC)[0]
WALK["issue_slot"] = src_text(r"uint64_t\* bar = &bars\[([^\]]+)\];",
                              RING_SRC)[0]
WALK["plane"] = src_text(
    r"const int l = static_cast<int>\(([^;]+)\);", RING_SRC)[0]
WALK["initial"] = src_text(
    r"for \(int j = 0; ([^;]+); \+\+j\) issue\(j\);", RING_SRC)[0]
WALK["refill"], WALK["refill_plane"] = src_text(
    r"if \(threadIdx\.x == 0 && ([^)]+)\) issue\(([^)]+)\);\n  \}",
    RING_SRC)
WALK["wait_slot"], WALK["parity"] = src_text(
    r"mbar_wait\(&bars\[([^\]]+)\], ([^;]+)\);", RING_SRC)
WALK["landed_parity"] = src_text(r"mbar_wait\(&landed, ([^;]+)\);",
                                 RING_SRC)[0]
WALK["clusters"], WALK["grid"] = src_text(
    r"const long long clusters = ([^;]+);\n"
    r"  return launch_cluster<K::NT>\(fused2d_ring_kernel<LY, LX, PIN, POUT>,"
    r"\n\s+(\w+), K::G,")


def walk_eval(key: str, **env) -> int:
    """WALK[key] evaluated in Python (``&&`` read as ``and``, ``io.L`` as
    L, ``K::G`` as G, ``SLOTS`` as S)."""
    expr = (WALK[key].replace("&&", " and ").replace("K::G", "G")
            .replace("SLOTS", "S").replace("(long long)", ""))
    return c_eval(expr, **env)


def test_ring_loop_order():
    """Each iteration waits for its slot, runs the row chain whose last
    stage waits at the cluster barrier before it writes `sent`, copies the
    runs out, waits for the runs in, runs the column chain and only then
    refills its slot (the slot's last reader is the column chain: the
    copies into it have landed and its last stage has read it)."""
    order = ["mbar_wait(&bars[i % SLOTS]", "rows_head<", "all_read);",
             "bulk_to_block(", "mbar_wait(&landed", "chain<NT, LY, CB",
             "issue(i + SLOTS)"]
    at = [RING_SRC.index(t) for t in order]
    assert at == sorted(at)
    assert RING_SRC.count("cluster_arrive_relaxed();") == 1
    assert WALK["grid"] == "clusters"


def ring_walk(L: int, held: int):
    """The ring's walk over L planes with `held` clusters, as its
    expressions state it: (per cluster: the planes in order, the fills
    issued as (before iteration, slot, plane), the waits as (slot,
    parity)).  Asserts the fills' slot and plane and each wait's parity
    against the fills that slot has had."""
    S = SLOTS
    clusters = walk_eval("clusters", L=L, held=held)
    assert clusters == min(L, held)
    G = 16
    gx = clusters * G
    walks = []
    for q in range(clusters):
        bx = q * G + 3                       # any block of the cluster
        first = walk_eval("first", bx=bx, gx=gx, G=G)
        every = walk_eval("every", bx=bx, gx=gx, G=G)
        count = (walk_eval("count", first=first, every=every, L=L)
                 if first < L else 0)
        fills, filled, waits = [], {}, []

        def issue(i, when):
            slot = walk_eval("issue_slot", i=i, S=S)
            plane = walk_eval("plane", first=first, i=i, every=every)
            fills.append((when, slot, plane))
            filled.setdefault(slot, []).append(i)

        j = 0
        while walk_eval("initial", j=j, S=S, count=count):
            issue(j, 0)
            j += 1
        planes = []
        for i in range(count):
            slot = walk_eval("wait_slot", i=i, S=S)
            parity = walk_eval("parity", i=i, S=S)
            # the wait is on this plane's fill: the slot's fill number
            # (filled[slot].index(i)) has that parity
            assert filled[slot].index(i) % 2 == parity
            assert walk_eval("landed_parity", i=i) == i % 2
            waits.append((slot, parity))
            planes.append(first + i * every)
            if walk_eval("refill", i=i, S=S, count=count):
                nxt = walk_eval("refill_plane", i=i, S=S)
                # refilled only after the last reader of this slot's plane
                assert walk_eval("issue_slot", i=nxt, S=S) == slot
                issue(nxt, i + 1)
        walks.append((planes, fills, waits))
    return walks


@pytest.mark.parametrize("L,held", [(256, 14), (3 * 14 + 5, 14), (5, 14),
                                    (1, 14), (10 * 21 + 1, 21), (2, 66)])
def test_ring_walk_takes_every_plane_once(L, held):
    """Every plane of a ragged, an under-a-wave, a one-plane and a
    many-wave L is taken by exactly one cluster, each cluster's in
    increasing order; every fill is of a plane that cluster takes, in its
    own slot, once; no fill comes before the iteration that frees its slot
    (the plane SLOTS before it done); each wait at its fill's parity."""
    walks = ring_walk(L, held)
    taken = [p for planes, _, _ in walks for p in planes]
    assert sorted(taken) == list(range(L))
    for planes, fills, waits in walks:
        assert planes == sorted(planes)
        assert sorted(p for _, _, p in fills) == planes
        for when, slot, plane in fills:
            i = planes.index(plane)
            assert slot == i % SLOTS
            assert when == max(0, i - SLOTS + 1)


def test_fills_count_their_bytes():
    """A fill expects the share's bytes: PB values of 8 bytes, one box of
    each plane (4 bytes a float) or one of the pairs (8 bytes)."""
    assert "    mbar_expect(bar, PB * (int)sizeof(float2));" in RING_SRC
    assert ("    tma_load_4d(dst, &map_re, 0, 0, rank * RB, l, bar);\n"
            "    if (!PIN) tma_load_4d(dst + PB, &map_im, 0, 0, rank * RB, l, "
            "bar);") in RING_SRC
    for ly, lx in RING:
        s = ring_shape(ly, lx)
        box = s["bx"] * (s["nx"] // s["bx"]) * s["rb"]
        assert box == s["pb"]
        assert 2 * box * 4 == s["pb"] * 8 == box * 8


# ------------------------------------------------------- the exchange

PUT = src_text(r"sent\[([^\]]+)\] = v;", RING_SRC)[0]
COPY_DST, COPY_SRC, COPY_BYTES = src_text(
    r"bulk_to_block\(([^,]+), ([^,]+),\s+([^,]+), &landed, o\);", RING_SRC)
LOAD_PLANAR = src_text(r"else return make_float2\(f\[([^\]]+)\], "
                       r"f\[([^\]]+)\]\);", RING_SRC)
STORE_AT = src_text(r"const long long o = ([^;]+);\n"
                    r"      const float2 y = make_float2", RING_SRC)[0]


def c_vec(expr: str, **env):
    """An integer C expression of the source on numpy arrays (``/`` integer
    division)."""
    return eval(expr.replace("/", "//"), {"__builtins__": {}}, env)


def exchange_map(ly: int, lx: int):
    """Where each (y, x) of a plane lands: (owner block, index in its
    slot) as (ny, nx) arrays, through the last row stage's ``put`` into
    `sent` and the copies out of it, as the source states them.  Asserts
    that `put` writes every index of `sent` once and that every slot index
    is written once."""
    s = ring_shape(ly, lx)
    RB, CB, G = s["rb"], s["cb"], s["g"]
    assert COPY_BYTES == "RB * CB * (int)sizeof(float2)"
    c, k = np.meshgrid(np.arange(RB), np.arange(s["nx"]), indexing="ij")
    sent = c_vec(PUT, k=k, c=c, CB=CB, RB=RB)           # (RB, nx)
    assert np.array_equal(np.sort(sent.ravel()), np.arange(s["pb"]))
    run = RB * CB
    owner = np.zeros((s["ny"], s["nx"]), np.int64)
    idx = np.zeros((s["ny"], s["nx"]), np.int64)
    for rank in range(G):
        o = sent // run                      # the copy that carries it
        src0 = c_vec(COPY_SRC.replace("sent + ", ""), o=o, RB=RB, CB=CB)
        dst0 = c_vec(COPY_DST.replace("sm + ", ""), rank=rank, RB=RB, CB=CB)
        rows = slice(rank * RB, (rank + 1) * RB)
        owner[rows] = o
        idx[rows] = dst0 + (sent - src0)
    flat = owner * s["pb"] + idx
    assert len(np.unique(flat)) == flat.size, "a slot index written twice"
    assert idx.min() >= 0 and idx.max() < s["pb"]
    return owner, idx, s


@pytest.mark.parametrize("ly,lx", RING)
def test_exchange_reaches_each_columns_owner_once(ly, lx):
    """Every (y, x) of a plane reaches the block that owns column x
    (x // CB) exactly once, at [y][x % CB] of its slot: the column chain's
    [k][c] layout (chain.cuh, ROWS false: k*C + c)."""
    owner, idx, s = exchange_map(ly, lx)
    y, x = np.meshgrid(np.arange(s["ny"]), np.arange(s["nx"]),
                       indexing="ij")
    assert np.array_equal(owner, x // s["cb"])
    assert np.array_equal(idx, y * s["cb"] + x % s["cb"])


# ----------------------------------------------------------- the chains


def index(n: int, C: int, c, k, rows: bool, pad: bool):
    """chain.cuh's chain_index: ROWS c*N + k (PAD: one value after every
    16), else k*C + c."""
    if not rows:
        return k * C + c
    return c * (n + n // 16) + k + k // 16 if pad else c * n + k


def chain_model(get, put, n: int, C: int, nt: int, sign: int, rows: bool,
                pad: bool, twd: bool, r16: bool):
    """chain.cuh's chain over C transforms of n points: the first
    stage reads get(c, k) (the caller's data or the buffer), the last hands
    its outputs to put(c, k, v), every stage in between writes the buffer
    `buf`, each index once and inside it.  Threads q = t + b*nt, c and j as
    the stage computes them."""
    cdt = np.complex64
    tw = np.exp(sign * 2j * np.pi * np.arange(n) / n).astype(cdt)
    rads = radices(int(np.log2(n)), r16)
    size = C * (n + n // 16) if (rows and pad) else C * n
    buf = None
    ns = 1
    for i, r in enumerate(rads):
        nr = n // r
        B = nr * C // nt
        assert B * r * nt == n * C
        q = np.arange(B * nt)
        c = q // nr if rows else q % C
        j = q % nr if rows else q // C
        kin = j[:, None] + np.arange(r)[None, :] * nr
        cc = np.broadcast_to(c[:, None], kin.shape)
        v = (get(cc, kin) if i == 0
             else buf[index(n, C, cc, kin, rows, pad)]).astype(cdt)
        if ns > 1:
            e = (j % ns) * (n // (ns * r))
            v = v * butterfly_twiddles(tw, e, r, twd, cdt)
        rr = np.arange(r)
        dft = np.exp(sign * 2j * np.pi * np.outer(rr, rr) / r).astype(cdt)
        v = (v @ dft).astype(cdt)
        base = (j // ns) * ns * r + j % ns
        kout = base[:, None] + rr[None, :] * ns
        if i == len(rads) - 1:
            put(cc, kout, v)
        else:
            idx = index(n, C, cc, kout, rows, pad).ravel()
            assert len(np.unique(idx)) == idx.size, "an index written twice"
            assert idx.max() < size, "a write past the buffer"
            buf = np.full(size, np.nan, cdt)
            buf[idx] = v.ravel()
        ns *= r


def plane_model(x: np.ndarray, sign: int, post: float, ly: int, lx: int,
                design: str) -> np.ndarray:
    """One (ny, nx) complex64 plane through K8's design: "ring" (the row
    chain padded, TWD, radix 16 by R16X; the runs put by owner and copied
    into the owners' slots; the column chain TWD, radix 16 by R16Y) or
    "first" (the first design: radix 8 rows unpadded, the column chain's
    first stage gathering its inputs from the blocks that hold the rows).
    Asserts every output stored once."""
    ny, nx = x.shape
    out = np.zeros((ny, nx), np.complex64)
    stored = np.zeros((ny, nx), np.int64)
    if design == "ring":
        s = ring_shape(ly, lx)
        owner, idx, _ = exchange_map(ly, lx)
        rowbuf = np.zeros_like(x)
        for rank in range(s["g"]):           # phase 1, block by block
            share = x[rank * s["rb"]:(rank + 1) * s["rb"]]
            res = np.zeros_like(share)

            def put(c, k, v, res=res):
                res[c, k] = v

            chain_model(lambda c, k, sh=share: sh[c, k], put, nx, s["rb"],
                        s["nt"], sign, True, PAD, TWD, s["r16x"])
            rowbuf[rank * s["rb"]:(rank + 1) * s["rb"]] = res
        slots = np.full((s["g"], s["pb"]), np.nan, np.complex64)
        slots[owner, idx] = rowbuf
        for o in range(s["g"]):              # phase 2, block by block
            def store(c, k, v, o=o):
                cols = o * s["cb"] + c
                out[k, cols] = v * np.float32(post)
                np.add.at(stored, (k, cols), 1)

            slot = slots[o]
            chain_model(lambda c, k, sl=slot: sl[k * s["cb"] + c], store, ny,
                        s["cb"], s["nt"], sign, False, False, TWD,
                        s["r16y"])
    else:
        s = first_shape(ly, lx)
        rowbuf = np.zeros_like(x)
        for rank in range(s["g"]):
            share = x[rank * s["rb"]:(rank + 1) * s["rb"]]

            def put(c, k, v, rank=rank):
                rowbuf[rank * s["rb"] + c, k] = v

            chain_model(lambda c, k, sh=share: sh[c, k], put, nx, s["rb"],
                        s["nt"], sign, True, False, False, False)
        for rank in range(s["g"]):
            # the gather stage: (k, c) read from the block holding row k
            def store(c, k, v, rank=rank):
                cols = rank * s["cb"] + c
                out[k, cols] = v * np.float32(post)
                np.add.at(stored, (k, cols), 1)

            def gathered(c, k, rank=rank):
                return rowbuf[k, rank * s["cb"] + c]

            chain_model(gathered, store, ny, s["cb"], s["nt"], sign, False,
                        False, False, False)
    assert (stored == 1).all(), "an output stored twice or never"
    return out


def test_first_design_is_the_sources():
    """The first design's options, as the model takes them: radix 8 rows
    without padding or TWD, the gather stage of the column chain's first
    radix, then radix 8 (chain.cuh's defaults)."""
    assert ("  chain<NT, LX, RB, true, 0, 1, true, false>(sm, twx, s, "
            "load_row,\n                                            "
            "none_store);") in FIRST_SRC
    assert ("  column_gather_stage<LY, LX, RY>(cluster, sm, rank, s);\n"
            "  chain<NT, LY, CB, false, 1, RY, false, true>(sm, twy, s, "
            "none_load,\n                                              "
            "store_col);") in FIRST_SRC
    assert ("constexpr int RY = (LY % 3) ? (1 << (LY % 3)) : 8;   "
            "// first radix along y") in FIRST_SRC


def test_ring_chain_options_are_the_sources():
    """The ring's chains as the model runs them: rows from the slot
    (ROWS, PAD, TWD, R16X, stage 0 reading the raw rows), the last stage
    handing its outputs to `put`; columns in the slot's [k][c] layout
    (ROWS false, TWD, R16Y), storing along x with the postscale."""
    assert ("    rows_head<NT, LX, RB, K::R16X>(sm, fresh(twx), s, load);\n"
            "    stage<NT, NX, RB, true, PX::R_LAST, PX::NS_LAST, false, "
            "true, RING2_PAD,\n          RING2_TWD>(sm, fresh(twx), s, load, "
            "put, all_read);") in RING_SRC
    assert ("    chain<NT, LY, CB, false, 0, 1, false, true, false, RING2_TWD, "
            "K::R16Y>(\n        sm, fresh(twy), s, none_load, store);"
            ) in RING_SRC
    assert ("stage<NT_, 1 << LOGN, C, true, R, NS, STAGE == 0, false, "
            "RING2_PAD,\n          RING2_TWD, STAGE == 0>(sm, tw, s, load, "
            "none);") in SRC
    assert LOAD_PLANAR == ("c * NX + k", "PB + c * NX + k")
    assert STORE_AT == "k * io.out_ys + (rank * CB + c) * io.out_xs"


ALL_SHAPES = [(ly, lx) for ly, lx in CASES]


@pytest.mark.parametrize("sign,post", [(-1, 0.5), (1, 0.25)])
@pytest.mark.parametrize("ly,lx", ALL_SHAPES)
def test_chain_model_matches_numpy_and_jax(ly, lx, sign, post):
    """K8's function at each of its fifteen shapes, by the design its table
    gives it (the ring at nine, the first design at 256 x 512 and the five
    of 2^18 points), against numpy.fft and JAX's fft2_fused in interpret
    mode."""
    ny, nx = 1 << ly, 1 << lx
    rng = np.random.default_rng(ly * 16 + lx + (sign > 0))
    x = (rng.standard_normal((ny, nx))
         + 1j * rng.standard_normal((ny, nx))).astype(np.complex64)
    design = "ring" if (ly, lx) in RING else "first"
    got = plane_model(x, sign, post, ly, lx, design)
    x128 = x.astype(np.complex128)
    ref = (np.fft.fft2(x128) if sign < 0
           else np.fft.ifft2(x128) * (ny * nx)) * post
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert rel < TOL
    jr, ji = jax_local.fft2_fused(np.ascontiguousarray(x.real)[None],
                                  np.ascontiguousarray(x.imag)[None], sign,
                                  postscale=post, interpret=True)
    jgot = (np.asarray(jr) + 1j * np.asarray(ji))[0]
    assert float(np.abs(got - jgot).max() / np.abs(jgot).max()) < PARITY


# ------------------------------------------------------- the dispatch

OPERANDS = src_text(
    r"  const bool planar = ([^;]+);\n  pairs = ([^;]+);\n  return ([^;]+);",
    SRC)
DISPATCH = ("  if (ring2_takes(ly, lx) && ring2_operands(io, pairs)) {")


def c_takes(re_t: torch.Tensor, im_t: torch.Tensor) -> bool:
    """The C rule (ring2_takes and ring2_operands) on (L, ny, nx) planes:
    pointers in bytes, strides in floats."""
    assert DISPATCH in SRC
    ly = int(np.log2(re_t.shape[-2]))
    lx = int(np.log2(re_t.shape[-1]))
    ls, ys, xs = re_t.stride()
    a, b = re_t.data_ptr(), im_t.data_ptr()
    env = dict(a=a, b=b, in_xs=xs, in_ys=ys, in_ls=ls, L=re_t.shape[0])
    planar = c_bool(OPERANDS[0].replace("io.L", "L"), **env)
    pairs = c_bool(OPERANDS[1].replace("io.in_im == io.in_re + 1",
                                       "b == a + 4"), **env)
    ok = c_bool(OPERANDS[2].replace("io.L", "L"),
                planar=planar, pairs=pairs, **env)
    return (ly, lx) in RING and ok


def layouts(ny: int, nx: int, L: int = 3):
    """(name, re, im) of the layouts the wrapper takes."""
    x = torch.zeros((L, ny, nx), dtype=torch.complex64)
    v = torch.view_as_real(x)
    buf = torch.zeros(2, L * ny * nx + 1)
    pad = torch.zeros(2, L, ny, nx + 2)
    odd = torch.zeros(2, L, ny, nx + 4)
    return [
        ("planar", x.real.contiguous(), x.imag.contiguous()),
        ("stride-2 pairs", v[..., 0], v[..., 1]),
        ("offset by a float", buf[0, 1:].view(L, ny, nx),
         buf[1, 1:].view(L, ny, nx)),
        ("rows 8 bytes apart", pad[0, ..., :nx], pad[1, ..., :nx]),
        ("rows 16 bytes apart", odd[0, ..., :nx], odd[1, ..., :nx]),
        ("pairs swapped", v[..., 1], v[..., 0]),
    ]


@pytest.mark.parametrize("ly,lx", CASES)
def test_design_rule_is_the_sources(ly, lx):
    """fused2d.design names the design the C entry runs: the ring at the
    table's shapes on planes its tensor maps read (planar or pairs,
    16-byte aligned, rows and planes 16 bytes apart), else the first
    design, which reads any strides (no copy is taken, nothing falls back
    to the plain version)."""
    ny, nx = 1 << ly, 1 << lx
    for name, re_t, im_t in layouts(ny, nx):
        want = "ring" if c_takes(re_t, im_t) else "first"
        assert fused2d.design(re_t, im_t) == want, name
        if (ly, lx) in RING:
            assert want == ("ring" if name in (
                "planar", "stride-2 pairs", "rows 16 bytes apart")
                else "first"), name


# the ring's store layout: the (re, im) pair store's rule and the
# instantiations the dispatch picks, in order, as (condition, PIN, POUT)
POUT_RULE = src_text(r"  const bool pout = ([^;]+);")[0]
STORE_DISPATCH = re.findall(
    r"  (?:if \((\w+)\) )?return launch_ring<LY, LX, (\w+), (\w+)>"
    r"\(io, twy, twx, s, stream\);", SRC)


def ring_instance(pairs: bool, out: dict) -> tuple:
    """(PIN, POUT) of the ring's kernel the dispatch launches on an input
    of pairs (or planes) and an output with ``out``'s fields (``o`` its
    real plane's byte address, ``out_re``/``out_im`` in floats)."""
    pout = c_bool(POUT_RULE, pairs=pairs, **out)
    env = {"pairs": pairs, "pout": pout}
    for cond, pin, po in STORE_DISPATCH:
        if cond == "" or env[cond]:
            return pin == "true", po == "true"
    raise AssertionError("no instance")


@pytest.mark.parametrize("name,pairs,want", [
    ("planes in, planes out", False, (False, False)),
    ("planes in, pairs out", False, (False, False)),
    ("pairs in, pairs out", True, (True, True)),
    ("pairs in, planes out", True, (True, False)),
    ("pairs in, pairs out 4 bytes off", True, (True, False)),
    ("pairs in, pairs out rows odd", True, (True, False)),
    ("pairs in, pairs out one plane", True, (True, True)),
])
def test_pair_store_rule(name, pairs, want):
    """The ring stores a point as one 8-byte (re, im) pair only where the
    input is pairs and the output is too, 8-byte aligned at every point
    (the pair store gained 3 % at config 4's stride-2 planes: PERF.md
    section 6, probes/float_split.py k8pout0); every other output is two
    float stores, a planar input's included (no kernel takes planes in and
    pairs out)."""
    base = 1 << 20                       # bytes, 16-byte aligned
    out = {"out_xs": 2, "out_re": base // 4, "out_im": base // 4 + 1,
           "o": base, "out_ys": 2 * 256, "out_ls": 2 * 256 * 256, "L": 3}
    if "planes out" in name:
        out.update(out_xs=1, out_im=base // 4 + 3 * 256 * 256,
                   out_ys=256, out_ls=256 * 256)
    if "4 bytes off" in name:
        out.update(o=base + 4, out_re=base // 4 + 1, out_im=base // 4 + 2)
    if "rows odd" in name:
        out.update(out_ys=2 * 256 + 1)
    if "one plane" in name:
        out.update(L=1, out_ls=1)
    assert len(STORE_DISPATCH) == 3 and STORE_DISPATCH[-1][0] == ""
    assert ring_instance(pairs, out) == want
    instances = {(pin, po) for _, pin, po in STORE_DISPATCH}
    assert ("false", "true") not in instances


# ------------------------------------------------- the launches counted


def test_ran_ring_is_the_sources():
    """The wrapper's RAN_RING is what the C entry returns where the ring
    ran, and only the ring's launch path returns it."""
    assert fused2d.RAN_RING == RAN_RING
    assert SRC.count("RAN_RING :") == 1
    assert "    return e == cudaSuccess ? RAN_RING : (int)e;" in SRC
    assert ("  return dispatch_design(log2ny, log2nx, io, "
            "static_cast<const float2*>(twy),") in SRC


def stub_entry(monkeypatch, err):
    """fused2d's K8 entry replaced by one returning `err`, the device checks
    and the stream lookup stubbed (no card); returns the calls list."""
    called = []

    def entry(*args):
        called.append(args)
        return err

    monkeypatch.setattr(fused2d, "_lib", lambda: (entry, entry,
                                                  lambda ly, lx: 16))
    monkeypatch.setattr(fused2d, "_check_devices", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    return called


@pytest.mark.parametrize("err,ring", [(RAN_RING, 1), (0, 0)])
def test_ring_launches_counted(monkeypatch, err, ring):
    """``launch.K8.ring`` counts a K8 launch whose C entry returned
    RAN_RING (the ring ran), and only that; ``total("launch.K8")`` counts
    it either way."""
    called = stub_entry(monkeypatch, err)
    re_t = torch.zeros(2, 256, 256)
    im_t = torch.zeros(2, 256, 256)
    fused2d._launch(re_t, im_t, re_t.clone(), im_t.clone(), -1, 1.0)
    assert len(called) == 1
    assert (profiling.total("launch.K8"),
            profiling.total("launch.K8.ring")) == (1, ring)


@pytest.mark.parametrize("err,int8", [(7, False), (700, False),
                                      (RAN_RING, True), (9, True)])
def test_failed_launch_raises(monkeypatch, err, int8):
    """A failed launch raises and counts nothing; RAN_RING from the int8
    entry (K8+K10 has no ring) is a failure too."""
    stub_entry(monkeypatch, err)
    monkeypatch.setattr(fused2d, "w_tables",
                        lambda f, sign, device: torch.zeros(1))
    re_t = torch.zeros(1, 128, 128)
    im_t = torch.zeros(1, 128, 128)
    name = "fused2d_i8" if int8 else "fused2d"
    with pytest.raises(RuntimeError, match=f"{name} launch failed"):
        fused2d._launch(re_t, im_t, re_t.clone(), im_t.clone(), -1, 1.0,
                        int8=int8)
    assert profiling.counts() == {}


def test_tiled_entry_has_no_ring(monkeypatch):
    """K9 shares the wrapper's launch path: RAN_RING from its entry
    raises."""
    called = []

    def entry(*args):
        called.append(args)
        return RAN_RING

    monkeypatch.setattr(fused2d, "_tiled_lib",
                        lambda: (entry, entry, lambda ly, lx: 16))
    monkeypatch.setattr(fused2d, "_check_devices", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    re_t = torch.zeros(1, 1024, 1024)
    with pytest.raises(RuntimeError, match="fused2d_tiled launch failed"):
        fused2d._launch_tiled(re_t, re_t.clone(), re_t.clone(),
                              re_t.clone(), -1, 1.0)
    assert len(called) == 1 and profiling.counts() == {}
