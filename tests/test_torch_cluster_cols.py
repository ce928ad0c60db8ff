"""The cluster column tile on the CPU: numpy models of what the complex128
cluster column kernel (K12 from n = 1024, csrc/local_cols.cu) and phase 2
of the tiled 2D kernel (K9, csrc/fused2d_tiled.cu) compute, index by index,
and of K9's persistent walk over the planes.

The shapes are read from the sources (``PYFFT_XCOLS_F64``, K9's knobs and
``PYFFT_TILED_CASES``), so the models test what the kernels are built
with.  The K12 model takes its operands, strides and twiddle tables from
the wrapper (``local._col_operands``), reads and writes the planes'
storage at the kernel's flat offsets, and follows the kernel's steps
(cluster_cols.cuh): rows b + G*j' per block, the M-point Stockham chain
with its twiddles from the n-entry table, w_n^(b*k'), each block's k'
range, the G-point DFTs, each store's output offset.  It must agree with
numpy.fft within 1e-11 and write every output element exactly once.  The
CUDA kernels themselves run on the card (chip_smoke.py phases 11-13 and
17-18, probes/ab_parent.py, probes/float_split.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfft_tpu_torch.ops import local

torch.set_num_threads(2)

CSRC = Path(local.__file__).parent / "csrc"
TOL64 = 1e-11
H100_L2 = 50 * 2 ** 20          # cudaDevAttrL2CacheSize of an H100


def macro_cases(name: str, macro: str) -> list:
    """The tuples of an X-macro table ``#define MACRO(X) X(a, b, ...) ...``
    in csrc/<name>."""
    src = (CSRC / name).read_text()
    m = re.search(rf"#define {macro}\(X\)((?:\s*\\?\s*X\([\d, ]+\))+)", src)
    assert m, f"{macro} not in {name}"
    return [tuple(int(v) for v in t.split(","))
            for t in re.findall(r"X\(([\d, ]+)\)", m.group(1))]


def macro_value(name: str, macro: str) -> int:
    """The default of ``#define MACRO value`` in csrc/<name>."""
    m = re.search(rf"#define {macro} (\d+)\n", (CSRC / name).read_text())
    assert m, f"{macro} not in {name}"
    return int(m.group(1))


XCOLS = macro_cases("local_cols.cu", "PYFFT_XCOLS_F64")
XCOLS_S2 = {c[0]: c for c in macro_cases("local_cols.cu",
                                         "PYFFT_XCOLS_F64_S2")}


# --------------------------------------------- the tile (cluster_cols.cuh)


def stockham(buf: np.ndarray, tw: np.ndarray, N: int, sign: int):
    """xt_chain on the [k][c] buffer (M, C): radix 2 or 4 first where
    log2 M is not a multiple of 3, then radix 8, each stage's twiddles
    tw[jj*r*(N/(NS*R))] from the N-entry table; natural order out."""
    M = buf.shape[0]
    logm = M.bit_length() - 1
    radices = ([1 << (logm % 3)] if logm % 3 else []) + [8] * (logm // 3)
    ns = 1
    for R in radices:
        nr = M // R
        j = np.arange(nr)
        v = np.stack([buf[j + r * nr] for r in range(R)])       # (R, nr, C)
        if ns > 1:
            for r in range(1, R):
                v[r] *= tw[(j % ns) * r * (N // (ns * R))][:, None]
        w = np.exp(sign * 2j * np.pi * np.outer(np.arange(R),
                                                np.arange(R)) / R)
        y = np.tensordot(w, v, axes=(1, 0))                     # y[k]
        base = (j // ns) * ns * R + j % ns
        out = np.empty_like(buf)
        for r in range(R):
            out[base + r * ns] = y[r]
        buf, ns = out, ns * R
    return buf


def exchange(bufs: list, tw: np.ndarray, sign: int, rank: int,
             kmajor: bool = False):
    """xt_exchange for block ``rank`` of a group whose chains left
    ``bufs`` (G flat buffers: [k][c], or with ``kmajor`` [c][k] padded to
    M + 1 a column): (c, k', y) of the pairs p = thread + i*NT of the
    block's k' range, read at the kernel's index, y[k2] = X[k' + M*k2]
    (shape (G, pairs))."""
    G = len(bufs)
    M, KR, C = bufs[0][1], bufs[0][1] // G, bufs[0][2]
    p = np.arange(KR * C)
    if kmajor:
        c, kl = p // KR, p % KR
        idx = c * (M + 1) + rank * KR + kl
    else:
        c, kl = p % C, p // C
        idx = rank * KR * C + p
    kp = rank * KR + kl
    u = np.stack([b[0][idx] for b in bufs])
    u = u * tw[np.arange(G)[:, None] * kp[None, :]]
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(G),
                                            np.arange(G)) / G)
    return c, kp, w @ u                                        # (k2, p)


def tile_model(load, G: int, C: int, N: int, sign: int, tw: np.ndarray,
               kmajor: bool = False):
    """The G blocks of one tile: every block's loads (rows b + G*j'), its
    chain (its last stage into the [c][k] layout with ``kmajor``), then
    every block's exchange; [(c, k', y)] by rank."""
    M = N // G
    e = np.arange(M * C)
    bufs = []
    for b in range(G):
        y = stockham(load(e % C, b + G * (e // C)).reshape(M, C), tw, N,
                     sign)
        if kmajor:
            flat = np.zeros((C, M + 1), complex)
            flat[:, :M] = y.T
            y = flat
        bufs.append((y.reshape(-1), M, C))
    return [exchange(bufs, tw, sign, r, kmajor) for r in range(G)]


def storage(t: torch.Tensor) -> np.ndarray:
    """The whole storage of a float64 CPU tensor as a flat numpy array
    that shares its memory."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy()


# ------------------------------------------------------- K12, n >= 1024


def k12_model(re, im, out_re, out_im, sign, post, G, C, kw):
    """local_cols_x_kernel on the wrapper's operands, reading and writing
    the planes' storage at the kernel's offsets; returns the count of
    writes to each element of the output storage."""
    r3, i3, o, dims, ta, tb = local._col_operands(
        re, im, out_re, out_im, sign, axis=1, tw_n=kw.get("tw_n", 0),
        tw_mode=kw.get("tw_mode", "full"), tw_period=kw.get("tw_period", 0),
        swap_store=kw.get("swap_store", False),
        swap_mid=kw.get("swap_mid", 0))
    (L, T, in_ls, in_ns, in_ts, out_ls, out_ns, out_as, out_bs, P, ak, aq,
     adiv, bk, bq, mode) = dims
    n = r3.shape[1]
    swap = kw.get("swap_store", False)
    tw = local._kernel_twiddles(n, sign, torch.device("cpu"),
                                torch.float64).numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    pairs = [None if t is None else (lambda a: a[:, 0] + 1j * a[:, 1])(
        t.reshape(-1, 2).numpy()) for t in (ta, tb)]
    src = [(storage(x), x.storage_offset()) for x in (r3, i3)]
    dst = [(storage(x), x.storage_offset()) for x in o]
    writes = np.zeros(dst[0][0].shape, np.int64)
    for tile in range(-(-T // C) * L):
        l, t0 = tile % L, (tile // L) * C

        def load(c, j):
            t = t0 + c
            ok = t < T
            off = np.where(ok, l * in_ls + j * in_ns + t * in_ts, 0)
            v = src[0][0][src[0][1] + off] + 1j * src[1][0][src[1][1] + off]
            return np.where(ok, v, 0)

        outs = tile_model(load, G, C, n, sign, tw, kmajor=swap)
        a0, b0 = t0 // P, t0 - (t0 // P) * P
        q0 = t0 // adiv if adiv > 1 else 0
        r0 = t0 & 127
        M = n // G
        for c, kp, y in outs:
            t = t0 + c
            keep = t < T
            c, kp, t, y = c[keep], kp[keep], t[keep], y[:, keep]

            def twiddle(k):
                q = q0 if adiv > 1 else t
                w = pairs[0][k * ak + q * aq]
                if mode == 2:
                    w = w * pairs[1][k * bk + (r0 + c) * bq]
                return w

            # w(k' + M*k2) = w(k') * w(M)^k2, as the kernel steps it
            w = twiddle(kp) if mode else 1
            step = twiddle(np.full_like(kp, M)) if mode else 1
            for k2 in range(G):
                v = y[k2] * w
                w = w * step
                k = kp + M * k2
                off = (l * out_ls + k * out_ns + a0 * out_as
                       + (b0 + c) * out_bs)
                for (arr, base), part in zip(dst, (v.real, v.imag)):
                    arr[base + off] = part * post
                np.add.at(writes, dst[0][1] + off, 1)
    return writes, o


def col_reference(x, sign, post, kw):
    """numpy: the DFT along axis 1 of (L, n, T), the mode's twiddle,
    postscale and store."""
    L, n, T = x.shape
    X = (np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * n)
    k = np.arange(n)[:, None]
    t = np.arange(T)[None, :]
    tw_n = kw.get("tw_n", 0)
    if tw_n:
        g = t // kw["tw_period"] if kw.get("tw_mode") == "strided" else t
        X = X * np.exp(sign * 2j * np.pi * ((k * g) % tw_n) / tw_n)
    X = X * post
    if kw.get("swap_store"):
        return X.transpose(0, 2, 1)
    if kw.get("swap_mid"):
        P = kw["swap_mid"]
        return X.reshape(L, n, T // P, P).transpose(0, 2, 1, 3)
    return X


def col_modes(n):
    """(name, trail, kwargs, layout): every twiddle and store mode the
    complex128 column pass takes; the plain ones at a ragged trail."""
    return [
        ("plain planar", 40, {}, "planar"),
        ("plain stride2", 40, {}, "stride2"),
        ("plain inplace", 40, {}, "inplace"),
        ("full swap_store", 40, dict(tw_n=n * 40, swap_store=True),
         "stride2"),
        ("strided swap_mid", 256,
         dict(tw_n=n * 2, tw_mode="strided", tw_period=128, swap_mid=128),
         "planar"),
        ("factored swap_store", 128,
         dict(tw_n=n * 128, tw_mode="factored", swap_store=True), "planar"),
    ]


def test_xcols_table_covers_1024_to_4096():
    """The cluster kernel takes n = 1024, 2048 and 4096 (a table for
    planar data and one for the complex form's stride-2 planes), each tile
    at least 64-byte runs of a row, a cluster of at most 8 blocks
    (portable), and the blocks an SM its launch bounds promise fit the
    SM's shared memory with the swapped store's padding."""
    assert [c[0] for c in XCOLS] == [10, 11, 12]
    assert sorted(XCOLS_S2) == [10, 11, 12]
    for (log2n, G, C, B), span in [(c, 8) for c in XCOLS] + [
            (c, 16) for c in XCOLS_S2.values()]:
        M = (1 << log2n) // G
        # span: the bytes a tile's column takes of a row, planar or the
        # complex form's interleaved pairs
        assert G in (2, 4, 8) and C * span >= 64 and 128 % C == 0
        assert B >= 1 and B * ((M + 1) * C * 16 + 1024) <= 228 * 1024
        nt = min(512, M * C // 8)
        assert M * C % nt == 0 and (M // G) * C % nt == 0


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("mode", range(6))
@pytest.mark.parametrize("log2n,G,C,B", XCOLS)
def test_k12_cluster_model_matches_numpy(log2n, G, C, B, mode, sign):
    n = 1 << log2n
    name, T, kw, layout = col_modes(n)[mode]
    L = 2
    rng = np.random.default_rng(log2n * 10 + mode)
    x = rng.standard_normal((L, n, T)) + 1j * rng.standard_normal((L, n, T))
    xt = torch.from_numpy(x)
    post = 0.5 if sign < 0 else 1.0 / n
    oshape = local._col_out_shape((L, n, T), 1, kw.get("swap_store", False),
                                  kw.get("swap_mid", 0))
    if layout == "planar":
        re, im = xt.real.contiguous(), xt.imag.contiguous()
        out = (torch.full(oshape, np.nan, dtype=torch.float64),
               torch.full(oshape, np.nan, dtype=torch.float64))
    else:
        v = torch.view_as_real(xt.clone())
        re, im = v[..., 0], v[..., 1]
        if layout == "inplace":
            out = (re, im)
        else:
            w = torch.view_as_real(torch.full(oshape, np.nan,
                                              dtype=torch.complex128))
            out = (w[..., 0], w[..., 1])
    if layout != "planar":      # t stride 2: the kernel's second table
        _, G, C, _ = XCOLS_S2[log2n]
    writes, o = k12_model(re, im, *out, sign, post, G, C, kw)
    got = out[0].numpy() + 1j * out[1].numpy()
    want = col_reference(x, sign, post, kw)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL64, f"{name}: {err:.3e}"
    # every output element written once, nothing else in its storage
    flat = torch.zeros(writes.shape, dtype=torch.int64)
    mask = torch.zeros_like(flat, dtype=torch.bool)
    mask.as_strided(o[0].shape, o[0].stride(),
                    o[0].storage_offset()).fill_(True)
    w = torch.from_numpy(writes)
    assert (w[mask] == 1).all() and (w[~mask] == 0).all(), name


# ----------------------------------------------------------------- K9


TILED_SRC = (CSRC / "fused2d_tiled.cu").read_text()
TILED = macro_cases("fused2d_tiled.cu", "PYFFT_TILED_CASES")


def tiled_text(pattern: str) -> tuple:
    """The groups of ``pattern``'s one match in fused2d_tiled.cu."""
    m = re.findall(pattern, TILED_SRC)
    assert len(m) == 1, f"{pattern!r} not in fused2d_tiled.cu once"
    return m[0] if isinstance(m[0], tuple) else (m[0],)


KNOBS = {k: macro_value("fused2d_tiled.cu", f"PYFFT_TILED_{k}")
         for k in ("CHUNK", "GMAX", "PLANES")}
KNOBS["RUN"] = int(tiled_text(r"\nconstexpr int RUN = (\d+);")[0])
KNOBS.update(zip(("PAD", "TWD", "R16"), (v == "true" for v in tiled_text(
    r"static constexpr bool PAD = (\w+), TWD = (\w+), R16 = (\w+);"))))
NT = int(tiled_text(r"constexpr int NT = (\d+);")[0])

# K9's walk over the planes as the source states it: the clusters of the
# grid, a cluster's first plane and its step (fused2d_tiled_kernel), the
# clusters launched (launch) and the planes cap (planes_cap)
WALK = dict(zip(("clusters", "first", "step"), tiled_text(
    r"const long long clusters = ([^;]+);\n\n.*\n"
    r"  for \(long long l = ([^;]+); l < io\.L; l \+= ([^)]+)\) \{")))
WALK["grid"] = tiled_text(
    r"launch_cluster<NT>\(fused2d_tiled_kernel<LY, LX>,\s+([^,]+), S::G,")[0]
WALK["cap"] = tiled_text(
    r"const long long cap = ([^;]+);\n  return cap > 1 \? cap : 1;")[0]


def c_eval(expr: str, **env) -> int:
    """An integer C expression of the source evaluated in Python: the C
    names ``blockIdx.x``, ``gridDim.x``, ``S::G``, ``io.L``, ``cap``, ``l2``,
    ``ly`` and ``lx`` taken from ``env`` (under the names bx, gx, G, L,
    cap, l2, ly, lx), ``/`` integer division, ``a ? b : c``."""
    names = {"blockIdx.x": "bx", "gridDim.x": "gx", "S::G": "G",
             "io.L": "L"}
    py = expr.replace("(long long)", "").replace("LL", "")
    for c, name in names.items():
        py = py.replace(c, name)
    py = py.replace("/", "//")
    m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", py)
    if m:
        py = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    return int(eval(py, {"__builtins__": {}}, env))


def shape_f(ly: int, lx: int, k=KNOBS) -> dict:
    """ShapeF<LY, LX> of fused2d_tiled.cu on the knobs ``k``."""
    ny, nx = 1 << ly, 1 << lx
    chunk, gmax = max(k["CHUNK"], nx), k["GMAX"]
    G = min(ny * nx // chunk, gmax)
    rb, cb = ny // G, nx // G
    rc, cc = min(rb, chunk // nx), min(cb, chunk // ny)
    g2w = ny * k["RUN"] // chunk
    g2 = 1 if g2w <= 1 else min(g2w, G, 8)
    cw = cc if g2 == 1 else g2 * chunk // ny
    return dict(ny=ny, nx=nx, G=G, RB=rb, CB=cb, RC=rc, CC=cc, G2=g2, CW=cw,
                CG=nx // (G // g2), M2=ny // g2)


def planes_cap(ly: int, lx: int, l2: int = H100_L2, k=KNOBS) -> int:
    """planes_cap of fused2d_tiled.cu: PYFFT_TILED_PLANES, or its
    expression of the L2's bytes (over a plane's 8 bytes a point), at
    least 1."""
    if k["PLANES"] > 0:
        return k["PLANES"]
    return max(1, c_eval(WALK["cap"], l2=l2, ly=ly, lx=lx))


def test_tiled_knobs_default_to_the_int8_kernels_frame():
    """The knobs' defaults keep K9's chunk and cluster cap (the int8
    kernel's ShapeT, 8192 points and 16 blocks, 512 threads), phase 2's
    run at least 8 floats (32 bytes), a planes cap from the L2, and the
    chains' measured options (padded rows, fewer twiddle reads, radix
    16)."""
    assert (KNOBS["CHUNK"], KNOBS["GMAX"], NT) == (8192, 16, 512)
    assert KNOBS["RUN"] >= 8 and KNOBS["PLANES"] == 0
    assert all(KNOBS[k] for k in ("PAD", "TWD", "R16"))
    assert len(TILED) == 28


@pytest.mark.parametrize("ly,lx", TILED)
def test_tiled_shape_asserts_and_runs(ly, lx):
    """ShapeF's static_asserts hold at every plane shape, and phase 2
    reads and writes runs of at least the knob's floats where the y split
    (at most 8 blocks) reaches them, never fewer than 8 (32 bytes, the
    parent's run at ny = 1024, where it took 1 float at ny = 8192)."""
    s = shape_f(ly, lx)
    assert s["G"] >= 1 and s["RB"] % s["RC"] == 0
    assert s["RC"] * s["nx"] == KNOBS["CHUNK"]
    if s["G2"] == 1:
        assert s["CB"] % s["CC"] == 0
        assert 8 * NT <= s["CC"] * s["ny"] <= KNOBS["CHUNK"]
    else:
        assert s["G"] % s["G2"] == 0 and s["CG"] % s["CW"] == 0
        assert s["M2"] * s["CW"] == KNOBS["CHUNK"]
        m2, g2 = s["M2"], s["G2"]
        assert (m2 // g2) * s["CW"] % NT == 0 and m2 * s["CW"] // 8 >= NT
    reach = min(KNOBS["RUN"], 8 * KNOBS["CHUNK"] // s["ny"])
    assert s["CW"] >= min(reach, s["CB"]) and s["CW"] >= 8


@pytest.mark.parametrize("L", [1, 3, 16, 17])
def test_tiled_walk_visits_every_plane_once_under_the_cap(L):
    """The persistent grid as the source launches and walks it (WALK):
    every block of a cluster takes the same planes, every plane is taken
    by one cluster once, the clusters share the planes evenly, and the
    planes in flight (one a cluster) times a plane's bytes fit the L2."""
    for ly, lx in TILED:
        G = shape_f(ly, lx)["G"]
        grid = c_eval(WALK["grid"], L=L, cap=planes_cap(ly, lx))
        gx = grid * G
        clusters = c_eval(WALK["clusters"], gx=gx, G=G)
        seen = []
        rounds = 0
        for cid in range(grid):
            walks = set()
            for bx in range(cid * G, (cid + 1) * G):
                mine, pl = [], c_eval(WALK["first"], bx=bx, G=G)
                while pl < L and len(mine) <= L:
                    mine.append(pl)
                    pl += c_eval(WALK["step"], clusters=clusters)
                walks.add(tuple(mine))
            assert len(walks) == 1, (ly, lx, cid)
            seen += mine
            rounds = max(rounds, len(mine))
        assert sorted(seen) == list(range(L)), (ly, lx)
        assert rounds == -(-L // grid)
        plane = 8 << (ly + lx)
        assert grid * plane <= max(H100_L2, plane)


@pytest.mark.parametrize("ly,lx,run", [(9, 7, 32), (10, 7, 32),
                                       (11, 7, 8), (12, 7, 8), (13, 7, 8),
                                       (11, 9, 8), (10, 8, 32)])
def test_tiled_phase2_groups_compute_the_column_dft(ly, lx, run):
    """K9's phase 2 where it splits y over groups (G2 > 1; at the default
    run and at 32 floats): each group of G2 blocks takes its CG columns in
    tiles of CW, the tile model above on them; the plane's column DFT,
    every element once."""
    s = shape_f(ly, lx, {**KNOBS, "RUN": run})
    assert s["G2"] > 1
    rng = np.random.default_rng(ly * 16 + lx)
    plane = rng.standard_normal((s["ny"], s["nx"])) \
        + 1j * rng.standard_normal((s["ny"], s["nx"]))
    tw = np.exp(-2j * np.pi * np.arange(s["ny"]) / s["ny"])
    out = np.full_like(plane, np.nan)
    writes = np.zeros(plane.shape, np.int64)
    for grp in range(s["G"] // s["G2"]):
        for c0 in range(grp * s["CG"], (grp + 1) * s["CG"], s["CW"]):
            outs = tile_model(lambda c, j: plane[j, c0 + c], s["G2"], s["CW"],
                              s["ny"], -1, tw)
            for c, kp, y in outs:
                for k2 in range(s["G2"]):
                    k = kp + s["M2"] * k2
                    out[k, c0 + c] = y[k2]
                    np.add.at(writes, (k, c0 + c), 1)
    want = np.fft.fft(plane, axis=0)
    assert np.abs(out - want).max() / np.abs(want).max() < TOL64
    assert (writes == 1).all()


def test_tiled_phase2_group_ranks_are_the_clusters():
    """Every block of a cluster belongs to one phase-2 group (ranks g0 ..
    g0 + G2 - 1, g0 = (rank / G2) * G2), and the groups' column ranges
    tile the plane's columns."""
    for ly, lx in TILED:
        s = shape_f(ly, lx)
        if s["G2"] == 1:
            spans = [(r * s["CB"], (r + 1) * s["CB"]) for r in range(s["G"])]
        else:
            spans = [(g * s["CG"], (g + 1) * s["CG"])
                     for g in range(s["G"] // s["G2"])]
        cols = [c for a, b in spans for c in range(a, b)]
        assert sorted(cols) == list(range(s["nx"])), (ly, lx)
