"""K12's persistent cluster ring on the CPU (csrc/local_cols.cu
``local_cols_xring_kernel``): the complex128 column pass at the lengths of
``PYFFT_XRING_F64`` on planar planes a tensor map reads, a persistent grid
of clusters walking every (l, run of C columns) tile through a ring of
slots fed by tensor-map boxes; and K5's instance of the same kernel, the
complex64 column pass at the lengths of ``PYFFT_XRING_F32_S2`` on the
complex form's (re, im) pairs (``IL``: one box of 8-byte pairs a tile,
8-byte values), each case below parametrised over both instances
(``INSTANCES``).  The float instance's function is modelled on complex128
storage in its pairs layout (the index logic in elements; its precision is
the card's to show).

Read from the source, as tests/test_torch_swap_ctile.py reads K6's: the
table, the ring's constants (``XRing``), the walk (a cluster's first
tile, its stride and count, the tile of iteration i, the ring's first
fills, its refill at the top of iteration i, the slot and barrier parity
of each wait), the grid (whole rounds of the clusters the card holds), the
boxes a fill copies and the operand rule (``xring_operands``).  The models
built on them: every tile filled once and stored once over config 5's
64 x 128 tiles and ragged counts for a range of clusters held; no slot
filled before the cluster barrier that frees it; each wait on its own
fill at that fill's parity.  The ring's function: the tiles in its order,
loaded through each block's slot as the boxes lay it out, the x tile's
chain and exchange (tests/test_torch_cluster_cols.py's model), the
twiddles w(k') and w(M) read per pair and stepped w(k') * w(M)^k2, the
chain's and the exchange's twiddles from each block's shared-memory table
(xt_fill_table, its readers' offsets; every entry one value of the
kernel's table, its warps' reads broadcasts or free of bank conflicts, its
room within B blocks an SM), both stores, against numpy (1e-11) and, on
the same (G, C), the x tile's model (1e-14).  The
dispatch rule (``local.col_design`` against the C rule on the wrapper's
operands: K12's ring on planar float64 planes, K5's on the complex form's
pairs with K5's persistent ring's modes) and the launch counts
(``launch.K12.ring`` from the entry's RAN_RING, ``launch.K5.xring`` from
RAN_XRING; every other K12 and K5 pass counting the keys it did).  The
CUDA kernel runs on the card (chip_smoke.py phases 6, 8 and 11-13,
probes/ab_parent.py, probes/float_split.py K12 and K5).
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from pyfft_tpu_torch.ops import local
from pyfft_tpu_torch.utils import profiling

from test_torch_cluster_cols import (CSRC, c_eval, col_reference, k12_model,
                                     macro_cases, storage)
from test_torch_cols_ring import c_dispatch
from test_torch_rows_ring import c_bool

torch.set_num_threads(2)

TOL64 = 1e-11
SMEM = 227 * 1024               # shared memory a block may take (H100)
SM_SMEM = 228 * 1024            # an SM's, with 1 KB a block reserved
BOX = 256                       # the most rows a tensor copy's box takes

COLS_SRC = (CSRC / "local_cols.cu").read_text()
# the ring's kernel, from its declaration to the query of its clusters
XRING_SRC = COLS_SRC[COLS_SRC.index("    local_cols_xring_kernel(Cols<Real> "
                                    "io,"):
                     COLS_SRC.index("// The clusters of the ring the card "
                                    "holds at once")]
LAUNCH_SRC = COLS_SRC[COLS_SRC.index("cudaError_t launch_xring("):]
LAUNCH_SRC = LAUNCH_SRC[:LAUNCH_SRC.index("\n}\n")]
XRING = macro_cases("local_cols.cu", "PYFFT_XRING_F64")
XCOLS = {c[0]: c for c in macro_cases("local_cols.cu", "PYFFT_XCOLS_F64")}
XRING_F32 = macro_cases("local_cols.cu", "PYFFT_XRING_F32_S2")
# the kernel's two instances: K12's on planar double planes (both stores),
# K5's on the complex form's float pairs (IL; the plain store): their
# table, the x tile's table beside it, the wrapper's lengths, the bytes of
# a complex value and the stores instantiated (kmajor: the swapped one)
INSTANCES = {
    "f64": dict(dtype=torch.float64, table=XRING, xcols=XCOLS, vb=16,
                il=False, lengths=local.COL_XRING_F64_LENGTHS,
                kmajor=(False, True)),
    "f32": dict(dtype=torch.float32, table=XRING_F32,
                xcols={c[0]: c for c in macro_cases("local_cols.cu",
                                                     "PYFFT_XCOLS_F32_S2")},
                vb=8, il=True, lengths=local.COL_XRING_F32_S2_LENGTHS,
                kmajor=(False,))}
# (instance, table row) of every ring the sources instantiate
TABLES = [(name, row) for name, k in INSTANCES.items() for row in k["table"]]
TABLE_IDS = [f"{name}-{row}" for name, row in TABLES]


def src_text(pattern: str, src: str = XRING_SRC) -> tuple:
    """The groups of ``pattern``'s one match in ``src``."""
    m = re.findall(pattern, src)
    assert len(m) == 1, f"{pattern!r} not in the source once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


# ------------------------------------------------- the table, the shape

RING_SRC = (CSRC / "ring_cols.cuh").read_text()
# where value k' = o*KR + kl of column c lies in a chunked buffer, and the
# values of a chunk, as ring_cols.cuh states them
CHUNK_INDEX = src_text(
    r"__device__ __forceinline__ int xt_chunk_index\(int o, int kl, int c\) "
    r"\{\n  constexpr int C = X::C_, KR = X::KR;\n  return ([^;]+);",
    RING_SRC)[0]
CHUNK = src_text(r"constexpr int xt_chunk\(\) \{\n  return ([^;]+);",
                 RING_SRC)[0]


def chunk_index(o, kl, c, C: int, KR: int, kmajor: bool):
    """xt_chunk_index evaluated (numpy arrays allowed)."""
    km, plain = (v.strip() for v in CHUNK_INDEX.split("?")[1].split(":"))
    return eval(km if kmajor else plain, {"__builtins__": {}},
                dict(o=o, kl=kl, c=c, C=C, KR=KR))


def chunk(C: int, KR: int, kmajor: bool) -> int:
    """xt_chunk evaluated."""
    expr = CHUNK.replace("X::C_", "C").replace("X::KR", "KR")
    return c_eval(expr.replace("KMAJOR", str(int(kmajor))), C=C, KR=KR)


# the ring's twiddle table as ring_cols.cuh states it: its layout
# (xt_first_radix, xt_table_stage, xt_table_exchange, xt_table), the
# exponent xt_fill_table reads for each entry, and the offsets its readers
# take (xt_stage_ring, xt_receive_chunks)
LAYOUT = {name: src_text(
    rf"constexpr int {name}\({arg}\) \{{\n  return ([^;]+);", RING_SRC)[0]
    for name, arg in (("xt_first_radix", ""), ("xt_table_stage", "int ns"),
                      ("xt_table_exchange", ""), ("xt_table", ""))}
FILL_SRC = RING_SRC[RING_SRC.index("__device__ __forceinline__ void "
                                   "xt_fill_table("):]
FILL_SRC = FILL_SRC[:FILL_SRC.index("\n}\n")]
TABLE_X = re.findall(r"\n      x = ([^;]+);", FILL_SRC)
READ_AT = {
    "stage": src_text(
        r"const V\* w = tab \+ ([^;]+);\n#pragma unroll\n    for \(int r = "
        r"1; r < R; \+\+r\) y\[b\]\[r\] = cmul\(y\[b\]\[r\], w\[r - 1\]\);",
        RING_SRC)[0],
    "exchange": src_text(
        r"const V\* w = tab \+ ([^;]+);\n#pragma unroll\n    for \(int b = "
        r"1; b < G; \+\+b\) u\[b\] = cmul\(u\[b\], w\[b - 1\]\);",
        RING_SRC)[0]}


def ring_expr(expr: str, **env):
    """An expression of ring_cols.cuh's table evaluated in Python (numpy
    arrays allowed): X's constants and the layout's functions from
    ``env`` and ``table_layout``, ``/`` integer division, ``a ? b : c``."""
    py = expr
    for c, name in (("xt_first_radix<X>()", "R0"),
                    ("xt_table_stage<X>", "stage"),
                    ("xt_table_exchange<X>()", "EX"), ("X::REM", "REM"),
                    ("X::M", "M"), ("X::KR", "KR"), ("X::G_", "G"),
                    ("X::N", "N")):
        py = py.replace(c, name)
    py = py.replace("/", "//").replace("<<", " << ")
    m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", py)
    if m:
        py = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    return eval(py, {"__builtins__": {}}, env)


def table_layout(G: int, M: int) -> dict:
    """The table's layout for a block of M rows in a cluster of G:
    the first radix R0, the NS of each radix-8 stage after it
    (``stages``), ``stage(ns)`` (where the stage after ns points starts),
    EX (where the exchange's start) and T (its values)."""
    env = dict(M=M, G=G, KR=M // G, N=G * M, REM=(M.bit_length() - 1) % 3)
    env["R0"] = ring_expr(LAYOUT["xt_first_radix"], **env)
    env["stage"] = lambda ns: ring_expr(LAYOUT["xt_table_stage"], ns=ns,
                                        **env)
    env["EX"] = ring_expr(LAYOUT["xt_table_exchange"], **env)
    env["T"] = ring_expr(LAYOUT["xt_table"], **env)
    env["stages"] = [ns for ns in (env["R0"] * 8 ** i for i in range(M))
                     if ns < M]
    return env


def ring_table(tw: np.ndarray, G: int, M: int, rank: int) -> np.ndarray:
    """Cluster block ``rank``'s table as xt_fill_table fills it from the
    kernel's table ``tw`` of N = G*M entries: entry e of a stage read at
    the exponent of the stage it falls in, else the exchange's; every
    entry written once."""
    for text in ("for (int e = threadIdx.x; e < xt_table<X>(); "
                 "e += X::NT_) {", "if (e < EX) {",
                 "while (xt_table_stage<X>(8 * ns) <= e) ns *= 8;",
                 "const int i = e - xt_table_stage<X>(ns);",
                 "const int i = e - EX;", "tab[e] = __ldg(&tw[x % N]);"):
        assert text in FILL_SRC, text
    assert len(TABLE_X) == 2
    k = table_layout(G, M)
    N = G * M
    tab = np.full(k["T"], np.nan, complex)
    for e in range(k["T"]):
        if e < k["EX"]:
            ns = k["R0"]
            while k["stage"](8 * ns) <= e:
                ns *= 8
            i = e - k["stage"](ns)
            x = ring_expr(TABLE_X[0], i=i, ns=ns, N=N)
        else:
            i = e - k["EX"]
            x = ring_expr(TABLE_X[1], i=i, rank=rank, KR=M // G, G=G)
        tab[e] = tw[x % N]
    return tab


def stage_at(G: int, M: int, NS: int, j, R: int = 8):
    """Where xt_stage_ring's butterfly j of the stage after NS points
    reads its w^1 (w^r at r - 1 on)."""
    k = table_layout(G, M)
    return ring_expr(READ_AT["stage"], NS=NS, j=np.asarray(j), R=R, **k)


def exchange_at(G: int, M: int, kl):
    """Where xt_receive_chunks' pair kl reads its w^(1*k') (w^(b*k') at
    b - 1 on)."""
    k = table_layout(G, M)
    return ring_expr(READ_AT["exchange"], kl=np.asarray(kl), **k)



def xring_shape(log2n: int, G: int, C: int, S: int, B: int = 1,
                vb: int = 16) -> dict:
    """XRing's constants (csrc/local_cols.cu) at (log2 n, G, C, S, B) for
    complex values of ``vb`` bytes (16 double, 8 float): a slot holds the
    tile as copied, its [k][c] values and its outputs by owner (the
    swapped store's padded chunks); the receive buffer is one slot more,
    then the twiddle table (``table`` values of ``vb`` bytes)."""
    n = 1 << log2n
    M = n // G
    KR = M // G
    nt = min(M * C // 8, KR * C, 512)
    slot = (max(M * C, G * chunk(C, KR, True)) * vb + 127) // 128 * 128
    table = table_layout(G, M)["T"]
    smem = (S + 1) * slot + table * vb + 128
    return dict(M=M, MB=min(M, BOX), NT=nt, P=M * C, KR=KR, slot=slot,
                table=table, smem=smem, B=B, vb=vb)


def test_xring_constants_are_the_sources():
    """The model's XRing is the source's: threads, the slot (the swapped
    store's padded buffer in whole 128-byte units), shared memory and the
    blocks an SM of its launch bounds."""
    for text in (
            "static constexpr int NT = cmin(cmin(M * C / 8, M / G * C), 512);",
            "static constexpr int VB = (int)sizeof(V);",
            "static constexpr int SLOT =\n      (cmax(X::P, X::G_ * "
            "xt_chunk<X, true>()) * VB + 127) / 128 * 128;",
            "static constexpr int SMEM =\n      (S + 1) * SLOT + "
            "xt_table<X>() * VB + 128;",
            "static constexpr int MB = M < BOX ? M : BOX;"):
        assert text in COLS_SRC, text
    assert "__global__ void __launch_bounds__(NT, B)\n    " \
        "local_cols_xring_kernel(" in COLS_SRC
    assert "constexpr int BOX = 256;" in COLS_SRC


@pytest.mark.parametrize("inst", sorted(INSTANCES))
def test_xring_table_rules(inst):
    """The ring's lengths are the wrapper's (``COL_XRING_F64_LENGTHS``,
    ``COL_XRING_F32_S2_LENGTHS``) and lengths the x tile takes too on the
    same planes (it runs every pass the ring cannot read); each shape a
    power-of-two cluster of at most 16 blocks, runs of at least 128 bytes
    (of each plane, or of the pairs) that stay inside 128 columns, one
    butterfly of every stage and one (k', c) pair of the exchange a
    thread, a slot that holds the tile as copied and the swapped store's
    padded buffer, and a ring that fits a block's shared memory with room
    for the B blocks an SM its launch bounds promise."""
    spec = INSTANCES[inst]
    vb = spec["vb"]
    assert tuple(1 << c[0] for c in spec["table"]) == spec["lengths"]
    for log2n, G, C, S, B in spec["table"]:
        k = xring_shape(log2n, G, C, S, B, vb)
        assert log2n in spec["xcols"]
        assert G in (2, 4, 8, 16) and C * 8 >= 128 and 128 % C == 0
        assert S >= 1 and k["M"] % k["MB"] == 0
        assert k["P"] % k["NT"] == 0 and k["P"] // 8 >= k["NT"]
        assert k["KR"] * C % k["NT"] == 0 and k["KR"] * C >= k["NT"]
        assert k["slot"] >= k["P"] * vb and k["slot"] % 128 == 0
        assert k["slot"] >= G * chunk(C, k["KR"], True) * vb
        assert G * chunk(C, k["KR"], True) * vb < 1 << 20
        assert k["smem"] <= SMEM and B >= 1 and B * k["NT"] <= 2048
        assert B * (k["smem"] + 1024) <= SM_SMEM
        assert k["P"] * vb < 1 << 20          # an mbarrier's byte count


# ------------------------------------------------------------- the walk

# the walk as local_cols_xring_kernel states it: a cluster's first tile,
# its stride and count, the tile of iteration i and its (l, t0), the ring's
# first fills, its refill at the top of iteration i, the slot and barrier
# parity of each wait; the grid, whole rounds of the clusters held
WALK = dict(zip(("first", "every"), src_text(
    r"const long long first = ([^,]+), every = ([^;]+);")))
WALK["count"] = src_text(
    r"const int count =\s+first < tiles \? static_cast<int>\(([^;]+)\)\s+"
    r": 0;")[0]
TILES = set(re.findall(r"const long long tile = ([^;]+);", XRING_SRC))
assert len(TILES) == 1, TILES
WALK["tile"] = TILES.pop()
WALK["l"], WALK["t0"] = src_text(
    r"const long long l = ([^,]+), t0 = ([^;]+);")
WALK["fill_l"] = src_text(r"const int l = static_cast<int>\(([^;]+)\);")[0]
WALK["fill_t0"] = src_text(r"const int t0 = static_cast<int>\(([^;]+)\);")[0]
WALK["fill_slot"] = src_text(r"uint64_t\* bar = &filled\[([^\]]+)\];")[0]
WALK["initial"] = src_text(
    r"for \(int j = 0; ([^;]+); \+\+j\) fill\(j\);")[0]
WALK["refill"], WALK["refill_tile"] = src_text(
    r"if \(threadIdx\.x == 0 && ([^)]+)\) fill\(([^)]+)\);")
WALK["wait_slot"], WALK["parity"] = src_text(
    r"mbar_wait\(&filled\[([^\]]+)\], ([^;]+)\);")
WALK["each"] = src_text(r"const long long each = ([^;]+);", LAUNCH_SRC)[0]
WALK["clusters"] = src_text(r"const long long clusters = ([^;]+);",
                            LAUNCH_SRC)[0]


def walk_eval(key: str, **env) -> int:
    """WALK[key] evaluated in Python (``&&`` read as ``and``, ``io.`` the
    operands' fields)."""
    expr = WALK[key].replace("&&", " and ").replace("io.", "")
    return c_eval(expr, **env)


def grid(tiles: int, held: int) -> int:
    """The ring's clusters over ``tiles`` tiles with ``held`` clusters on
    the card at once (launch_xring)."""
    each = walk_eval("each", tiles=tiles, held=held)
    return walk_eval("clusters", tiles=tiles, each=each)


def xring_walk(L: int, T: int, C: int, S: int, G: int, held: int):
    """Every cluster's program order over (L, n, T), from the kernel's own
    expressions (every block of a cluster walks the same tiles, each its
    own rows): [(cluster, [(event, i, slot, (l, t0), parity)])], events
    "fill", "wait" (the tile's chain: tile 0's before the loop, tile i +
    1's in iteration i) and "free" (past tile i's receive barrier, where
    the slot's refill follows)."""
    tiles = -(-T // C) * L
    clusters = grid(tiles, held)
    out = []
    for cl in range(clusters):
        ranks = []
        for rank in range(G):
            env = dict(S=S, C=C, L=L, G=G, tiles=tiles, bx=cl * G + rank,
                       gx=clusters * G)
            env.update(first=walk_eval("first", **env))
            env.update(every=walk_eval("every", **env))
            ranks.append((env["first"], env["every"]))
        assert len(set(ranks)) == 1, "the blocks of a cluster walk apart"
        count = (walk_eval("count", **env) if env["first"] < tiles else 0)

        def where(i, fill=False):
            tile = walk_eval("tile", i=i, **env)
            if fill:
                return (walk_eval("fill_l", tile=tile, **env),
                        walk_eval("fill_t0", tile=tile, **env))
            return (walk_eval("l", tile=tile, **env),
                    walk_eval("t0", tile=tile, **env))

        def wait(i):
            return ("wait", i, walk_eval("wait_slot", i=i, **env), where(i),
                    walk_eval("parity", i=i, **env))

        ev = []
        j = 0
        while walk_eval("initial", j=j, count=count, **env):
            ev.append(("fill", j, walk_eval("fill_slot", i=j, **env),
                       where(j, True), None))
            j += 1
        ev.append(wait(0))              # tile 0's chain, before the loop
        for i in range(count):
            if i + 1 < count:           # the next tile's chain
                ev.append(wait(i + 1))
            ev.append(("free", i, walk_eval("wait_slot", i=i, **env),
                       where(i), None))
            if walk_eval("refill", i=i, count=count, **env):
                r = walk_eval("refill_tile", i=i, **env)
                ev.append(("fill", r, walk_eval("fill_slot", i=r, **env),
                           where(r, True), None))
        out.append((cl, ev))
    return clusters, out


WALK_CASES = {"config 5": (64, 2048), "ragged": (3, 16 * 37 + 5),
              "one tile": (1, 5), "under a round": (7, 16 * 9)}


@pytest.mark.parametrize("table", TABLES, ids=TABLE_IDS)
@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("held", [1, 3, 7, 16, 33])
def test_xring_walk_visits_every_tile_once(case, held, table):
    """Every (l, t-run) tile is filled by exactly one cluster and stored
    where it was filled, a slot is filled again only after the tile it held
    is freed (the exchange's second cluster barrier), each wait is on its own
    tile's fill at that fill's parity, the clusters are at most those held
    and no two clusters' counts differ by more than one: config 5's 64 x
    128 tiles, a ragged trail over three l, one tile and fewer tiles than
    a round, over a range of clusters held, for each ring the sources
    instantiate."""
    log2n, G, C, S, _ = table[1]
    L, T = WALK_CASES[case]
    tiles = -(-T // C) * L
    clusters, walks = xring_walk(L, T, C, S, G, held)
    assert clusters <= min(held, tiles)
    seen, counts = {}, []
    for cl, ev in walks:
        held_slots, fills = {}, {}
        counts.append(sum(1 for e in ev if e[0] == "wait"))
        for kind, i, slot, tile, parity in ev:
            assert 0 <= slot < S
            if kind == "fill":
                assert slot not in held_slots, "a slot filled while held"
                held_slots[slot] = (i, tile)
                fills[slot] = fills.get(slot, 0) + 1
                seen[tile] = seen.get(tile, 0) + 1
            elif kind == "wait":
                assert held_slots.get(slot) == (i, tile), "another tile"
                assert parity == (fills[slot] - 1) & 1, "a wrong phase"
            else:
                assert held_slots.pop(slot) == (i, tile)
        assert not held_slots
    want = {(l, t0) for l in range(L) for t0 in range(0, T, C)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert max(counts) - min(counts) <= 1


def test_xring_loop_order():
    """Tile 0's chain and the send of its chunks come before the loop; in
    iteration i the next tile's chain (its fill's wait first) runs while
    tile i's chunks fly, then tile i's receive (the wait for the chunks
    into this block, the pairs read and stored, a relaxed cluster
    barrier), and only past it the refill of tile i's slot with the tile S
    on and the send of tile i + 1's chunks; a send is the proxy fence, the
    receive barrier's expected bytes and the copies; the chain's last stage
    writes by owner between two block barriers; every block's receive
    barrier is set up, and its twiddle table filled once, before the
    cluster barrier that precedes any chain or copied chunk; a fill
    orders the block's earlier accesses before its copies and expects a
    whole slot."""
    loop = XRING_SRC.index("  for (int i = 0; i < count; ++i) {")
    head, body = XRING_SRC[:loop], XRING_SRC[loop:]
    assert head.index("chain(0);") < head.index(
        "xt_send_chunks<X, SWAP>(slots, recv, &landed, rank);")
    chain = XRING_SRC[XRING_SRC.index("const auto chain = [&](int i) {"):]
    chain = chain[:chain.index("  };")]
    assert chain.index("mbar_wait(") < chain.index(
        "xt_chain_from_chunks<X, SWAP>(")
    marks = [body.index(m) for m in (
        "chain(i + 1);", "xt_receive_chunks<X, SWAP>(recv, &landed, i & 1,",
        "fill(" + WALK["refill_tile"] + ")",
        "xt_send_chunks<X, SWAP>(slots + ((i + 1) % S)")]
    assert marks == sorted(marks)
    send = RING_SRC[RING_SRC.index("__device__ __forceinline__ void "
                                   "xt_send_chunks("):]
    send = send[:send.index("\n}\n")]
    marks = [send.index(m) for m in (
        "fence_async_smem();", "mbar_expect(landed, G * CH * (int)sizeof(V));",
        "bulk_to_block(recv + rank * CH, sm + o * CH, CH * (int)sizeof(V),")]
    assert marks == sorted(marks)
    recv = RING_SRC[RING_SRC.index("__device__ __forceinline__ void "
                                   "xt_receive_chunks("):]
    recv = recv[:recv.index("\n}\n")]
    marks = [recv.index(m) for m in (
        "mbar_wait(landed, phase);", "u[b] = recv[xt_chunk_index",
        "put(c, kp, u, i);", "cluster_arrive_relaxed();",
        "cluster_wait();")]
    assert marks == sorted(marks)
    last = RING_SRC[RING_SRC.index("__device__ __forceinline__ void "
                                   "xt_stage_ring("):]
    last = last[:last.index("\n}\n")]
    assert last.index("dft<R>(y[b], s);") < last.index("__syncthreads();") \
        < last.index("sm[LAST ? xt_chunk_index<X, KMAJOR>(k / KR, k % KR, c) "
                     ": k * C + c]") < last.rindex("__syncthreads();")
    assert XRING_SRC.index("mbar_init(&landed);") < XRING_SRC.index(
        "xt_fill_table<X>(tab, tw, rank);") < XRING_SRC.index(
        "cluster_arrive();                 // every block's barriers") \
        < XRING_SRC.index("chain(0);")
    assert XRING_SRC.count("xt_fill_table<") == 1
    fill = XRING_SRC[XRING_SRC.index("const auto fill = [&](int i) {"):]
    fill = fill[:fill.index("  };")]
    assert fill.index("fence_async_smem();") < fill.index("mbar_expect(")
    assert fill.index("mbar_expect(") < fill.index("tma_load_4d(")


@pytest.mark.parametrize("kmajor", [False, True])
def test_xring_chunks_partition_the_buffers(kmajor):
    """The chunked layout (xt_chunk_index, xt_chunk): a block's outputs by
    owner fill disjoint chunks of CH values, chunk o holding exactly the k'
    of owner o, inside the slot; the receive buffer takes one chunk from
    each block; each pair of the exchange reads, from sender b, the value
    it sent for (k' = rank*KR + kl, c)."""
    for inst, (log2n, G, C, S, B) in TABLES:
        k = xring_shape(log2n, G, C, S, B, INSTANCES[inst]["vb"])
        M, KR = k["M"], k["KR"]
        CH = chunk(C, KR, kmajor)
        kk, cc = np.meshgrid(np.arange(M), np.arange(C), indexing="ij")
        idx = chunk_index(kk // KR, kk % KR, cc, C, KR, kmajor)
        assert len(np.unique(idx)) == idx.size          # no two collide
        assert idx.max() < G * CH <= k["slot"] // k["vb"]
        assert (idx // CH == kk // KR).all()           # chunk o, owner o
        # a value's place inside its chunk is the same whichever chunk:
        # sender b's chunk o lands at b*CH in owner o's receive buffer, and
        # pair p of the owner reads (k', c) of sender b at
        # xt_chunk_index(b, kl, c), where b sent it
        p = np.arange(KR * C)
        c = p // KR if kmajor else p % C
        kl = p % KR if kmajor else p // C
        local = chunk_index(0, kl, c, C, KR, kmajor)
        assert len(np.unique(local)) == local.size and local.max() < CH
        for o in range(G):
            assert (chunk_index(o, kl, c, C, KR, kmajor) == o * CH
                    + local).all()


# ------------------------------------------------------------- the boxes

FILL = src_text(
    r"tma_load_4d\(dst \+ ([^,]+),\s+part \? &map_im : &map_re, ([^,]+),"
    r"\s*([^,]+), ([^,]+), ([^,]+), bar\);")
MAP = src_text(
    r"const cuuint64_t dims\[4\] = \{([^}]+)\};\n"
    r"  const cuuint64_t strides\[3\] = \{\s*([^}]+)\};\n"
    r"  const cuuint32_t box\[4\] = \{([^}]+)\};\n"
    r"  return tensor_map_4d\(map, base, true, dims, strides, box\);",
    COLS_SRC[COLS_SRC.index("cudaError_t xring_map("):])


def fill_model(flats, T, l, t0, rank, G, C, S, log2n, in_ls, in_ns,
               il=False):
    """One block's fill of a slot, box by box as the tensor maps lay it
    out (dims {T, G, M, L}, strides in bytes, boxes {C, 1, MB, 1} of
    8-byte elements; zeros past T): ``flats`` the flat storage of the two
    planes from their first element, or (``il``) of the pairs, a t a pair
    of reals; the slot's reals and the count of writes to each."""
    k = xring_shape(log2n, G, C, S)
    P, M, MB = k["P"], k["M"], k["MB"]
    assert [v.strip() for v in MAP[0].split(",")] == [
        "(cuuint64_t)io.T", "(cuuint64_t)G", "(cuuint64_t)K::M",
        "(cuuint64_t)io.L"]
    assert " ".join(MAP[1].split()) == (
        "row, row * G, io.L > 1 ? (cuuint64_t)io.in_ls * E : row * "
        "(1 << LOGN)")
    assert MAP[2].split(", ") == ["(cuuint32_t)C", "1", "(cuuint32_t)K::MB",
                                  "1"]
    assert (FILL[0], FILL[1:]) == ("(IL ? 2 : 1) * (part * P + h * MB * C)",
                                   ("t0", "rank", "h * MB", "l"))
    assert "for (int part = 0; part < (IL ? 1 : 2); ++part)" in XRING_SRC
    ew = 2 if il else 1                 # reals a box element holds
    slot = np.zeros(2 * P)
    writes = np.zeros(2 * P, np.int64)
    jj = np.arange(MB)[:, None]
    t = t0 + np.arange(C)[None, :]
    for part in range(1 if il else 2):
        flat = flats[part]
        for h in range(M // MB):
            dst = ew * (part * P + h * MB * C)
            # box {C, 1, MB, 1} at (t0, rank, h*MB, l): row j = rank +
            # G*j' at byte offset t*8 + rank*row + j'*row*G + l*ls
            j = rank + G * (h * MB + jj)
            for e in range(ew):
                v = flat[l * in_ls + j * in_ns + np.minimum(t, T - 1) * ew
                         + e]
                at = slice(dst + e, dst + ew * MB * C, ew)
                slot[at] = np.where(t < T, v, 0.0).reshape(-1)
                writes[at] += 1
    return slot, writes


@pytest.mark.parametrize("table", TABLES, ids=TABLE_IDS)
def test_xring_fill_covers_the_slot(table):
    """A fill's boxes write every real of the slot once, in the [j'][c]
    layout the chain's first stage reads (f[k*C + c], f[P + k*C + c] of
    the two planes; on the pairs sm[k*C + c]): rows rank + G*j' of the
    tile's C columns, zeros past T; the barrier expects those bytes."""
    assert "mbar_expect(bar, P * (int)sizeof(V));" in XRING_SRC
    assert ("return Complex<Real>::make(f[k * C + c], f[P + k * C + c]);"
            in XRING_SRC)
    assert "      if constexpr (IL)\n        return sm[k * C + c];" \
        in XRING_SRC
    inst, (log2n, G, C, S, _) = table
    il = INSTANCES[inst]["il"]
    n = 1 << log2n
    rng = np.random.default_rng(3)
    L, T = 2, 3 * C - 5
    planes = [rng.standard_normal((L, n, T)) for _ in range(2)]
    # the pairs: (L, n, T, 2), the real and imaginary planes interleaved
    flats = ([np.stack(planes, -1).reshape(-1)] if il
             else [p.reshape(-1) for p in planes])
    ew = 2 if il else 1
    M = n // G
    for l, t0, rank in ((0, 0, 0), (1, 2 * C, G - 1)):
        slot, writes = fill_model(flats, T, l, t0, rank, G, C, S, log2n,
                                  n * T * ew, T * ew, il)
        assert (writes == 1).all()
        P = M * C
        t = t0 + np.arange(C)
        keep = t < T
        for part in range(2):
            got = (slot.reshape(M, C, 2)[..., part] if il
                   else slot[part * P:(part + 1) * P].reshape(M, C))
            want = np.zeros((M, C))
            want[:, keep] = planes[part][l][rank::G][:, t[keep]]
            assert np.array_equal(got, want)


# ---------------------------------------------------------- the function


def stockham_ring(buf: np.ndarray, tab: np.ndarray, G: int, sign: int):
    """The ring's M-point chain on the [k][c] buffer (M, C): the first
    stage (radix 2 or 4 where log2 M is not a multiple of 3, no
    twiddles), then radix 8 with its twiddles read from the block's table
    ``tab`` where xt_stage_ring reads them; natural order out."""
    M = buf.shape[0]
    logm = M.bit_length() - 1
    radices = ([1 << (logm % 3)] if logm % 3 else []) + [8] * (logm // 3)
    ns = 1
    for R in radices:
        nr = M // R
        j = np.arange(nr)
        v = np.stack([buf[j + r * nr] for r in range(R)])       # (R, nr, C)
        if ns > 1:
            at = stage_at(G, M, ns, j, R)
            for r in range(1, R):
                v[r] *= tab[at + r - 1][:, None]
        f = np.exp(sign * 2j * np.pi * np.outer(np.arange(R),
                                                np.arange(R)) / R)
        y = np.tensordot(f, v, axes=(1, 0))
        base = (j // ns) * ns * R + j % ns
        out = np.empty_like(buf)
        for r in range(R):
            out[base + r * ns] = y[r]
        buf, ns = out, ns * R
    return buf


def chunk_tile(load, G: int, C: int, N: int, sign: int, tabs,
               kmajor: bool):
    """The G blocks of one tile through the ring's chunked exchange: each
    block's chain of its rows b + G*j' (loaded through its slot), its
    outputs written by owner at xt_chunk_index, each owner's chunk copied
    into the owner's receive buffer at the sender's place, and each pair's
    G values read there, twiddled by w_N^(b*k') from the owner's table
    (``tabs`` by rank) and transformed; [(c, k', y)] by rank, as
    tests/test_torch_cluster_cols.py's exchange gives."""
    M = N // G
    KR = M // G
    CH = chunk(C, KR, kmajor)
    e = np.arange(M * C)
    kk, cc = np.meshgrid(np.arange(M), np.arange(C), indexing="ij")
    sent = []
    for b in range(G):
        y = stockham_ring(load(e % C, b + G * (e // C)).reshape(M, C),
                          tabs[b], G, sign)
        buf = np.full(G * CH, np.nan, complex)
        buf[chunk_index(kk // KR, kk % KR, cc, C, KR, kmajor)] = y
        sent.append(buf)
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(G), np.arange(G)) / G)
    out = []
    for r in range(G):
        recv = np.concatenate([sent[b][r * CH:(r + 1) * CH]
                               for b in range(G)])
        p = np.arange(KR * C)
        c = p // KR if kmajor else p % C
        kl = p % KR if kmajor else p // C
        kp = r * KR + kl
        u = np.stack([recv[chunk_index(b, kl, c, C, KR, kmajor)]
                      for b in range(G)])
        assert not np.isnan(u).any()
        at = exchange_at(G, M, kl)
        for b in range(1, G):
            u[b] = u[b] * tabs[r][at + b - 1]
        out.append((c, kp, w @ u))
    return out


def xring_model(re, im, out_re, out_im, sign, post, G, C, S, held, kw,
                il=False):
    """local_cols_xring_kernel on the wrapper's operands (``il``: the
    complex form's pairs, as K5's instance reads them): the clusters'
    tiles in the walk's order, each block's rows through its slot as the
    boxes lay them out, the ring's chain, the chunked exchange, the twiddles
    w(k') and w(M) of each pair read before the chain, the stores from
    registers; returns the count of writes to each element of the output
    storage."""
    r3, i3, o, dims, ta, tb = local._col_operands(
        re, im, out_re, out_im, sign, axis=1, tw_n=kw.get("tw_n", 0),
        tw_mode=kw.get("tw_mode", "full"), tw_period=kw.get("tw_period", 0),
        swap_store=kw.get("swap_store", False),
        swap_mid=kw.get("swap_mid", 0))
    (L, T, in_ls, in_ns, in_ts, out_ls, out_ns, out_as, out_bs, P, ak, aq,
     adiv, bk, bq, mode) = dims
    if il:
        assert in_ts == 2 and i3.data_ptr() == r3.data_ptr() + 8
        flats = [storage(r3)[r3.storage_offset():]]
    else:
        assert in_ts == 1 and r3.is_contiguous() and i3.is_contiguous()
        flats = [r3.numpy().reshape(-1).copy(), i3.numpy().reshape(-1).copy()]
    n = r3.shape[1]
    log2n = n.bit_length() - 1
    M = n // G
    swap = kw.get("swap_store", False)
    tw = local._kernel_twiddles(n, sign, torch.device("cpu"),
                                torch.float64).numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    pairs = [None if t is None else (lambda a: a[:, 0] + 1j * a[:, 1])(
        t.reshape(-1, 2).numpy()) for t in (ta, tb)]
    dst = [(storage(x), x.storage_offset()) for x in o]
    writes = np.zeros(dst[0][0].shape, np.int64)
    tabs = [ring_table(tw, G, M, rank) for rank in range(G)]
    _, walks = xring_walk(L, T, C, S, G, held)
    for _, ev in walks:
        for kind, i, slot_i, (l, t0), _ in ev:
            if kind != "wait":
                continue
            slots = [fill_model(flats, T, l, t0, b, G, C, S, log2n, in_ls,
                                in_ns, il)[0] for b in range(G)]

            def load(c, j):
                s = slots[int(np.ravel(j)[0]) % G]     # one block's rows
                k = j // G
                if il:
                    return s[2 * (k * C + c)] + 1j * s[2 * (k * C + c) + 1]
                return s[k * C + c] + 1j * s[M * C + k * C + c]

            outs = chunk_tile(load, G, C, n, sign, tabs, swap)
            a0, b0 = t0 // P, t0 - (t0 // P) * P
            q0 = t0 // adiv if adiv > 1 else 0
            r0 = t0 & 127
            for c, kp, y in outs:
                t = t0 + c
                keep = t < T
                c, kp, t, y = c[keep], kp[keep], t[keep], y[:, keep]
                at = (q0 if adiv > 1 else t) * aq
                if mode:
                    wk = pairs[0][kp * ak + at]
                    wm = pairs[0][M * ak + at]
                    if mode == 2:
                        bt = (r0 + c) * bq
                        wk = wk * pairs[1][kp * bk + bt]
                        wm = wm * pairs[1][M * bk + bt]
                w = wk if mode else 1
                for k2 in range(G):
                    v = y[k2] * w
                    if mode:
                        w = w * wm
                    k = kp + M * k2
                    off = (l * out_ls + k * out_ns + a0 * out_as
                           + (b0 + c) * out_bs)
                    for (arr, base), part in zip(dst, (v.real, v.imag)):
                        arr[base + off] = part * post
                    np.add.at(writes, dst[0][1] + off, 1)
    return writes, o


def ring_modes(n):
    """(name, trail, kwargs): both stores with no twiddle and the `full`
    one, the mid route's strided twiddle with the mid swap and the huge
    route's factored one with the swapped store; ragged trails where the
    mode allows.  K5's instance takes the plain store with no twiddle or
    the `full` one (F32_MODES)."""
    return [("plain", 40, {}),
            ("full plain", 40, dict(tw_n=n * 40)),
            ("swap", 40, dict(swap_store=True)),
            ("full swap", 40, dict(tw_n=n * 40, swap_store=True)),
            ("strided swap_mid", 256,
             dict(tw_n=n * 2, tw_mode="strided", tw_period=128,
                  swap_mid=128)),
            ("factored swap", 128,
             dict(tw_n=n * 128, tw_mode="factored", swap_store=True)),
            ("plain inplace", 40, {})]


# the modes K5's instance takes (ring_modes' indices: plain, full plain,
# plain inplace)
F32_MODES = (0, 1, 6)
MODEL_CASES = [(name, row, mode) for name, row in TABLES
               for mode in (F32_MODES if INSTANCES[name]["il"] else range(7))]


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize(
    "table,mode", [((name, row), mode) for name, row, mode in MODEL_CASES],
    ids=[f"{name}-{row}-{mode}" for name, row, mode in MODEL_CASES])
def test_xring_model_matches_numpy(table, mode, sign):
    """The ring's function at each length of its table, its chain's and
    exchange's twiddles from each block's table: numpy within 1e-11,
    every output element written once and nothing else in its storage,
    and the cluster tile's model on the same operands and (G, C) within
    1e-14; K5's instance on the complex form's pairs, in and out of
    place (modelled in complex128)."""
    inst, (log2n, G, C, S, _) = table
    il = INSTANCES[inst]["il"]
    n = 1 << log2n
    name, T, kw = ring_modes(n)[mode]
    L = 2
    rng = np.random.default_rng(log2n * 10 + mode)
    x = rng.standard_normal((L, n, T)) + 1j * rng.standard_normal((L, n, T))
    xt = torch.from_numpy(x)
    post = 0.5 if sign < 0 else 1.0 / n
    oshape = local._col_out_shape((L, n, T), 1, kw.get("swap_store", False),
                                  kw.get("swap_mid", 0))

    def fresh():
        if il:                  # the complex form's stride-2 planes
            v = torch.view_as_real(torch.full(oshape, np.nan + 0j,
                                              dtype=torch.complex128))
            return v[..., 0], v[..., 1]
        return (torch.full(oshape, np.nan, dtype=torch.float64),
                torch.full(oshape, np.nan, dtype=torch.float64))

    if il:
        v = torch.view_as_real(xt.clone())
        re, im = v[..., 0], v[..., 1]
    else:
        re, im = xt.real.contiguous(), xt.imag.contiguous()
    out = (re, im) if name == "plain inplace" else fresh()
    held = 5
    writes, o = xring_model(re, im, *out, sign, post, G, C, S, held, kw, il)
    got = out[0].numpy() + 1j * out[1].numpy()
    want = col_reference(x, sign, post, kw)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL64, f"{name}: {err:.3e}"
    flat = torch.zeros(writes.shape, dtype=torch.int64)
    mask = torch.zeros_like(flat, dtype=torch.bool)
    mask.as_strided(o[0].shape, o[0].stride(),
                    o[0].storage_offset()).fill_(True)
    w = torch.from_numpy(writes)
    assert (w[mask] == 1).all() and (w[~mask] == 0).all(), name
    if name == "plain inplace":
        return
    # the cluster tile's model on the same operands and (G, C): the same
    # function, its twiddles read from the kernel's table every tile
    xo = fresh()
    k12_model(re, im, *xo, sign, post, G, C, kw)
    xg = xo[0].numpy() + 1j * xo[1].numpy()
    assert np.abs(got - xg).max() / np.abs(xg).max() < 1e-14, name



@pytest.mark.parametrize("part", ["stages", "exchange"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("table", TABLES, ids=TABLE_IDS)
def test_xring_twiddle_table_entries(table, sign, part):
    """Every entry of every block's table is one value of the kernel's
    table, tw[(r*e) mod N], where its readers look for w^(r*e): the radix-8
    stage after NS points reads w_N^(jj*r*N/(8*NS)) for jj = j % NS and 0 <
    r < 8, the exchange w_N^(b*k') for k' = rank*KR + kl and 0 < b < G, at
    every rank, both signs; the readers' places cover the table once."""
    inst, (log2n, G, C, S, _) = table
    n = 1 << log2n
    M, KR = n // G, n // G // G
    tw = local._kernel_twiddles(n, sign, torch.device("cpu"),
                                INSTANCES[inst]["dtype"]).numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    k = table_layout(G, M)
    stages = k["stages"]
    assert stages and stages[-1] * 8 == M
    for rank in range(G):
        tab = ring_table(tw, G, M, rank)
        seen = np.zeros(k["T"], np.int64)
        for ns in stages:
            j = np.arange(ns)
            at = stage_at(G, M, ns, j)
            for r in range(1, 8):
                np.add.at(seen, at + r - 1, 1)
                if part == "stages":
                    assert np.array_equal(tab[at + r - 1],
                                          tw[(j * r * (n // (8 * ns))) % n])
        kl = np.arange(KR)
        at = exchange_at(G, M, kl)
        for b in range(1, G):
            np.add.at(seen, at + b - 1, 1)
            if part == "exchange":
                assert np.array_equal(tab[at + b - 1],
                                      tw[(b * (rank * KR + kl)) % n])
        assert (seen == 1).all()


BANK_CASES = [((name, row), kmajor) for name, row in TABLES
              for kmajor in INSTANCES[name]["kmajor"]]


@pytest.mark.parametrize(
    "table,kmajor", BANK_CASES,
    ids=[f"{t[0]}-{t[1]}-{k}" for t, k in BANK_CASES])
def test_xring_twiddle_table_banks(table, kmajor):
    """A warp's reads of the table: each quarter warp of 16-byte loads
    (eight threads; half warps of K5's 8-byte ones, sixteen) reads one
    entry (a broadcast) or as many entries on distinct slots of a
    128-byte row, in every stage after the first and in the exchange of
    each store the instance has, for every value of the loops (b, r) of a
    thread."""
    inst, (log2n, G, C, S, B) = table
    vb = INSTANCES[inst]["vb"]
    k = xring_shape(log2n, G, C, S, B, vb)
    M, KR, NT = k["M"], k["KR"], k["NT"]
    stages = table_layout(G, M)["stages"]
    reads = []                  # the entries of each load, by thread
    for bb in range(M // 8 * C // NT):
        q = np.arange(NT) + bb * NT
        j = q // C
        reads += [stage_at(G, M, ns, j) for ns in stages]
    for i in range(KR * C // NT):
        p = np.arange(NT) + i * NT
        kl = p % KR if kmajor else p // C
        reads.append(exchange_at(G, M, kl))
    group = 128 // vb                   # threads a shared-memory phase
    for at in reads:
        for quarter in at.reshape(-1, group):
            one = len(set(quarter)) == 1
            assert one or len(set(quarter % group)) == group, quarter


@pytest.mark.parametrize("table", TABLES, ids=TABLE_IDS)
def test_xring_twiddle_table_fits(table):
    """The table lies after the receive buffer, inside the block's
    dynamic shared memory less its 128 bytes of alignment, and with it the
    ring still fits B blocks an SM (K12 at (11, 16, 16, 2, 2): 246 values,
    3936 bytes; 2 x (110720 + 3936 + 1024) = 231360 <= 233472 bytes; K5
    at (10, 4, 16, 4, 1): 444 values of 8 bytes, 3552 bytes; 166400 +
    3552 + 128 + 1024 = 171104)."""
    inst, (log2n, G, C, S, B) = table
    vb = INSTANCES[inst]["vb"]
    k = xring_shape(log2n, G, C, S, B, vb)
    assert "  V* tab = recv + SV;" in XRING_SRC
    assert "  V* recv = slots + S * SV;" in XRING_SRC
    assert "  constexpr int SV = K::SLOT / K::VB;" in XRING_SRC
    end = (S + 1) * k["slot"] + k["table"] * vb
    assert end + 128 == k["smem"] <= SMEM
    assert B * (k["smem"] + 1024) <= SM_SMEM
    if (inst, (log2n, G, C, S, B)) == ("f64", (11, 16, 16, 2, 2)):
        assert (k["table"], k["slot"], k["smem"]) == (246, 36864, 114656)
        assert B * (k["smem"] + 1024) == 231360
    if (inst, (log2n, G, C, S, B)) == ("f32", (10, 4, 16, 4, 1)):
        assert (k["table"], k["slot"], k["smem"]) == (444, 33280, 170080)
        assert B * (k["smem"] + 1024) == 171104


# --------------------------------------------------------- the dispatch

XRING_OPERANDS = src_text(
    r"inline bool xring_operands\(const Cols<double>& io\) \{\n"
    r"  const uintptr_t a = reinterpret_cast<uintptr_t>\(io\.in_re\);\n"
    r"  const uintptr_t b = reinterpret_cast<uintptr_t>\(io\.in_im\);\n"
    r"  return ([^;]+);\n\}", COLS_SRC)[0]


XRING_TAKES = src_text(
    r"inline bool xring_takes\(const Cols<float>& io, int swap_store\) \{\n"
    r"  return ([^;]+);\n\}", COLS_SRC)[0]


def c_xring_takes(r3, i3, dims, log2n: int) -> bool:
    """The C entry's rule for K12's ring: xring_operands on the wrapper's
    operands (pointers in bytes, strides in doubles) and the table."""
    L, T, in_ls, in_ns, in_ts = dims[:5]
    ops = c_bool(XRING_OPERANDS, a=r3.data_ptr(), b=i3.data_ptr(),
                 in_ts=in_ts, in_ns=in_ns, in_ls=in_ls, L=L)
    return ops and log2n in {c[0] for c in XRING}


def c_xring_f32_takes(r3, i3, dims, log2n: int, swap_store: bool) -> bool:
    """The C entry's rule for K5's ring: xring_takes (K5's persistent
    ring's rule, pring_takes, on the pairs) on the wrapper's operands and
    the table."""
    pring = c_dispatch(r3, i3, dims, swap_store)
    expr = XRING_TAKES.replace("pring_takes(io, swap_store)", str(pring))
    return (c_bool(expr, in_ts=dims[4])
            and log2n in {c[0] for c in XRING_F32})


def layout_planes(layout: str, n: int, T: int, dtype):
    """(3, n, T) planes of ``dtype`` in a layout the rule sees."""
    g = torch.Generator().manual_seed(n + T)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    if layout == "planar":
        return rand(3, n, T), rand(3, n, T)
    if layout == "stride2":            # the complex form's planes
        v = torch.view_as_real(torch.complex(rand(3, n, T), rand(3, n, T)))
        return v[..., 0], v[..., 1]
    if layout == "offset":             # one element off 16-byte alignment
        flat = rand(3 * n * T + 1)
        return flat[1:].view(3, n, T), rand(3, n, T)
    if layout == "odd rows":           # an n stride of odd elements
        return rand(3, n, T + 1)[..., :T], rand(3, n, T + 1)[..., :T]
    raise AssertionError(layout)


MODES = {"plain": {}, "full swap": dict(tw_n=1, swap_store=True),
         "strided mid": dict(tw_n=1, tw_mode="strided", tw_period=128,
                             swap_mid=128),
         "factored swap": dict(tw_n=1, tw_mode="factored", swap_store=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", ["planar", "stride2", "offset",
                                    "odd rows"])
@pytest.mark.parametrize("n", [1024, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_xring_design_rule(dtype, n, layout, mode, monkeypatch):
    """Which design each pass runs: the C rule (xring_operands, and
    xring_takes on float planes, on the wrapper's operands and the table)
    against ``col_design``: K12's ring on planar float64 planes its tensor
    maps read at its table's lengths in every twiddle and store mode; K5's
    ring on the complex form's float pairs at its table's lengths with a
    plain store; the other layouts, unboxable views, other lengths and
    modes the cluster tile, as before."""
    monkeypatch.setattr(local, "_col_xtile", lambda log2n, ts, dt: (
        (8, 16) if log2n >= 10 else None))
    T = 256
    kw = dict(MODES[mode])
    if kw.get("tw_n"):
        kw["tw_n"] = n * T
    re_, im_ = layout_planes(layout, n, T, dtype)
    oshape = local._col_out_shape((3, n, T), 1, kw.get("swap_store", False),
                                  kw.get("swap_mid", 0))
    r3, i3, o, dims, ta, tb = local._col_operands(
        re_, im_, torch.empty(oshape, dtype=dtype),
        torch.empty(oshape, dtype=dtype), -1, axis=1,
        tw_n=kw.get("tw_n", 0), tw_mode=kw.get("tw_mode", "full"),
        tw_period=kw.get("tw_period", 0),
        swap_store=kw.get("swap_store", False), swap_mid=kw.get("swap_mid", 0))
    log2n = n.bit_length() - 1
    swap = kw.get("swap_store", False)
    want = ("ring" if dtype == torch.float64
            and c_xring_takes(r3, i3, dims, log2n) else
            "xring" if dtype == torch.float32
            and c_xring_f32_takes(r3, i3, dims, log2n, swap) else "x")
    got = local.col_design(n, dtype, boxable=local._boxable(r3, i3),
                           in_ts=dims[4], tw_mode=kw.get("tw_mode", "full"),
                           tw_n=kw.get("tw_n", 0),
                           swap_store=kw.get("swap_store", False),
                           swap_mid=kw.get("swap_mid", 0), T=T)
    assert got == want
    expect = (dtype == torch.float64 and n in local.COL_XRING_F64_LENGTHS
              and layout == "planar")
    assert (want == "ring") == expect
    expect = (dtype == torch.float32 and n in local.COL_XRING_F32_S2_LENGTHS
              and layout == "stride2" and mode == "plain")
    assert (want == "xring") == expect


def test_xring_dispatch_in_the_source():
    """The complex128 entry tries the ring first, where xring_operands
    holds and its table has n, returning RAN_RING from its launch only,
    then the x tile's two tables as before; the complex64 entry tries K5's
    ring first, where xring_takes holds and its table has n (its plain
    store on the pairs, IL), returning RAN_XRING from its launch only,
    then the x tile's tables and the persistent ring as before."""
    f64 = COLS_SRC[COLS_SRC.index("  if constexpr (sizeof(Real) == "
                                  "sizeof(double)) {\n    // K12's "
                                  "persistent cluster ring"):]
    marks = [f64.index(m) for m in (
        "if (xring_operands(io)) {", "PYFFT_XRING_F64(PYFFT_XRING)",
        "PYFFT_XCOLS_F64_S2(PYFFT_XCOL)", "PYFFT_XCOLS_F64(PYFFT_XCOL)",
        "    // K5: the persistent cluster ring",
        "if (xring_takes(io, swap_store)) {",
        "PYFFT_XRING_F32_S2(PYFFT_XRING)",
        "    // K5: the cluster tile from n = 1024")]
    assert marks == sorted(marks)
    assert COLS_SRC.count("? launch_xring<Real, LN, G, C, S, B, true, false>") \
        == 1
    assert COLS_SRC.count(": launch_xring<Real, LN, G, C, S, B, false, "
                          "false>;") == 1
    assert COLS_SRC.count("launch_xring<Real, LN, G, C, S, B, false, "
                          "true>(io, t, s, st);") == 1
    assert COLS_SRC.count("    return RAN_RING;") == 1
    assert COLS_SRC.count("    return e == cudaSuccess ? RAN_XRING : "
                          "(int)e;") == 1
    assert COLS_SRC.count("xring_operands(io)") == 1
    assert COLS_SRC.count("xring_takes(io, swap_store)") == 1


# ------------------------------------------------------ the launches


def fake_launch(monkeypatch, err: int):
    """Replace the column entry (returning ``err``) and the card's calls,
    and zero the counts; returns the list of the entry's calls."""
    called = []

    def entry(*args):
        called.append(args)
        return err

    monkeypatch.setattr(local, "_cols_lib",
                        lambda d: (entry, lambda log2n: 16))
    monkeypatch.setattr(local, "_col_xtile", lambda *a: (8, 16))
    monkeypatch.setattr(local, "_check_planes", lambda *a: None)
    monkeypatch.setattr(local, "_kernel_twiddles",
                        lambda *a: torch.zeros(2))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    profiling.reset()
    return called


@pytest.mark.parametrize("dtype,err,key", [
    (torch.float64, -1, "launch.K12.ring"),
    (torch.float64, -2, "launch.K12.x"),
    (torch.float64, 0, "launch.K12.first"),
    (torch.float32, -2, "launch.K5.x"),
    (torch.float32, -1, "launch.K5.pring"),
    (torch.float32, -3, "launch.K5.xring"),
    (torch.float32, 0, "launch.K5.first")])
def test_xring_launches_counted(monkeypatch, dtype, err, key):
    """``launch.K12.ring`` counts the K12 launches whose C entry returned
    RAN_RING, ``launch.K5.xring`` the K5 launches whose entry returned
    RAN_XRING; the x tile's and the first design's launches and K5's
    persistent ring count the keys they counted before; the pass's one
    launch counts under exactly one key."""
    called = fake_launch(monkeypatch, err)
    g = torch.Generator().manual_seed(1)
    re_, im_ = (torch.randn(2, 2048, 128, generator=g, dtype=dtype)
                for _ in range(2))
    local._launch_cols(re_, im_, re_.clone(), im_.clone(), -1, axis=1,
                       postscale=1.0, tw_n=0, tw_mode="full", tw_period=0,
                       swap_store=False, swap_mid=0)
    assert len(called) == 1
    assert profiling.counts() == {key: 1}
    assert local._K12_KEYS[local.RAN_RING] == "launch.K12.ring"
    assert local._K5_KEYS[local.RAN_XRING] == "launch.K5.xring"
    assert local.RAN_XRING not in local._K12_KEYS


def test_xring_shape_query_names():
    """``col_xring_shape_f64`` and ``col_xring_shape`` read the seven
    values the C queries write, in their order: K12's table with its
    swapped store's clusters held, K5's with its plain store's (its one
    instance, on the pairs)."""
    start = COLS_SRC.index("// K12's persistent cluster ring at log2n "
                           "(PYFFT_XRING_F64)")
    query = COLS_SRC[start:COLS_SRC.index("#undef PYFFT_XRING", start)]
    assert "const int v[7] = {G, C, S, B, K::NT, K::SMEM, held};" in query
    assert "xring_held<Real, LN, G, C, S, B, !IL, IL>(held);" in query
    for name, real, il, table in (
            ("pyfft_local_cols_xring_shape_f64", "double", "false",
             "PYFFT_XRING_F64"),
            ("pyfft_local_cols_xring_shape", "float", "true",
             "PYFFT_XRING_F32_S2")):
        body = query[query.index(f'extern "C" int {name}(int log2n, '
                                 'int* out) {'):]
        body = body[:body.index("\n}\n")]
        assert f"  using Real = {real};\n  constexpr bool IL = {il};\n" \
            f"  {table}(PYFFT_XRING)\n  return 0;" in body
    assert local.COL_XRING_KEYS == ("cluster", "columns", "slots",
                                    "blocks_an_sm", "threads", "smem_bytes",
                                    "clusters_held")
