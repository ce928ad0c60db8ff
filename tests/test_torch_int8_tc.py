"""K10's stage on wgmma (``int8_stage_tc`` in csrc/int8_stage.cuh) on the
CPU: the shared-memory image of W that the kernels copy, a numpy model of
the order in which the wgmma stage computes, and the row kernels' choice
of stage.

The model reads W from the image and x from its channels laid out as the
B operand, byte by byte through the same offsets the kernel uses, and sums
slab by slab (64 output rows), shift group by shift group, k32 step by k32
step in int64, checking every group's sum below 2^24 (so its conversion to
float is exact), then recombines the groups in float32 in ascending shift.
It must equal the plain torch stage (``int8.int8_stage``) and the JAX
package's ``_int8_stage`` bit for bit: integer sums do not depend on the
order of the products.  The CUDA kernels themselves run on the card
(chip_smoke.py phases 19-21, probes/ab_parent.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.ops import pallas_local as jax_local
from pyfft_tpu_torch.ops import int8, local

torch.set_num_threads(2)

CSRC = Path(local.__file__).parent / "csrc"


def unpack_image(img: np.ndarray, f: int) -> np.ndarray:
    """The (3, 2f, 2f) channels back from ``int8.w_image``'s bytes, each
    element read at the offset the kernel's descriptors address: stacked
    row R (part R // f of output k = R % f) is row r = 16*(k % 32 // 8) +
    8*part + k % 8 of slab k // 32, the rows the stage's epilogue reads
    back as (real, imaginary) pairs."""
    k2 = 2 * f
    c, R, k = np.meshgrid(np.arange(3), np.arange(k2), np.arange(k2),
                          indexing="ij")
    part, kout = R // f, R % f
    t, r = kout // 32, 16 * (kout % 32 // 8) + 8 * part + kout % 8
    off = (t * 3 * 64 * k2 + c * 64 * k2 + (r // 8) * 8 * k2
           + (k // 16) * 128 + (r % 8) * 16 + k % 16)
    return img[off]


def test_w_rows_pair_the_parts():
    """Slab rows r and r + 8 of each 16 are the two parts of one output."""
    for f in (32, 64, 128):
        rows = int8.w_rows(f)
        assert sorted(rows) == list(range(2 * f))
        for i in range(0, 2 * f, 16):
            re, im = rows[i:i + 8], rows[i + 8:i + 16]
            assert (re < f).all() and np.array_equal(im, re + f)


@pytest.mark.parametrize("f", [32, 64, 128])
@pytest.mark.parametrize("sign", [-1, 1])
def test_w_image_unpacks_to_the_channels(f, sign):
    img = int8.w_image(f, sign)
    want = np.stack(int8.stacked_channels(f, sign))
    assert img.dtype == np.int8 and img.shape == (3 * 4 * f * f,)
    assert np.array_equal(unpack_image(img, f), want)
    # one slab: the 3 channels of 64 output rows, 48 KB at f = 128
    slab = 3 * int8.SLAB_ROWS * 2 * f
    assert img.size % slab == 0 and img.size // slab == 2 * f // 64
    if f == 128:
        assert slab == 48 * 1024


@pytest.mark.parametrize("f", [16, 32, 64, 128])
def test_w_tables_hold_channels_then_image(f):
    """The kernels' table: the mma.sync stage's (3, 2f, 2f) channels, then
    (f >= 32) the image, 16-byte aligned, at csrc's w_image_offset."""
    t = int8.w_tables(f, -1, torch.device("cpu")).numpy()
    chans = np.stack(int8.stacked_channels(f, -1)).reshape(-1)
    off = 12 * f * f
    assert off % 16 == 0 and np.array_equal(t[:off], chans)
    if f >= 32:
        assert np.array_equal(t[off:], int8.w_image(f, -1))
    else:
        assert t.size == off
    src = (CSRC / "int8_stage.cuh").read_text()
    assert "return 12 * f * f;" in src


def exp2(e: int) -> np.float32:
    return np.float32(2.0 ** e)


RND = np.float32(1.5 * 2 ** 23)


def cut(x: np.ndarray, inv: np.float32) -> np.ndarray:
    """The kernel's rounding of one channel: t = clamp(x*inv + RND,
    RND - 127, RND + 127) in float32; t - RND is the channel, t's low byte
    its int8."""
    t = (x.astype(np.float32) * inv + RND).astype(np.float32)
    return np.minimum(np.maximum(t, RND - 127), RND + 127)


def test_cut_rounds_as_rint_and_clip():
    """t - RND equals clip(rint(y), -127, 127) (round half even) for every
    y, and t's low byte is that value's int8: ties, the clamp's edge, the
    reach of the magic number and beyond."""
    base = [0.0, 0.25, 0.5, 1.5, 2.5, 126.5, 127.49, 127.5, 128.0, 1e3,
            2.0 ** 21 + 0.5, 2.0 ** 22 - 0.5, 2.0 ** 22, 2.0 ** 22 + 1,
            2.0 ** 23 + 1, 2.0 ** 30, 3e38, np.inf]
    y = np.array(base + [-b for b in base], np.float32)
    y = np.concatenate([y, np.random.RandomState(1).uniform(
        -300, 300, 4096).astype(np.float32)])
    t = cut(y, np.float32(1))
    want = np.clip(np.rint(y), -127, 127)
    assert np.array_equal(t - RND, want)
    got = t.view(np.uint32).astype(np.uint8).view(np.int8)
    assert np.array_equal(got, want.astype(np.int8))


def b_offset(q, kk, f: int, Q: int) -> np.ndarray:
    """Byte of column q, stacked row kk in one x channel (B, K-major core
    matrices): csrc's (q/8)*SBO + (kk/16)*128 + (q%8)*16 + kk%16."""
    return (q // 8) * 8 * 2 * f + (kk // 16) * 128 + (q % 8) * 16 + kk % 16


def cut_runs(xs: np.ndarray, f: int, m: int, nt: int) -> np.ndarray:
    """x's 4 channels in B's byte layout as the kernel writes them: run u
    (elements r0..r0+15 of column q = u % Q, r0 = 16*(u // Q)) is cut by
    thread u % nt in its pass u // nt (two runs a thread where the block
    has more runs than threads, K8's 2^18-point planes), both halves of
    it at store_run's offsets (q/8)*SBO + ((part*f + r0)/16)*128 +
    (q%8)*16 + i.  Every byte is written once."""
    k2, Q = xs.shape
    runs = Q * f // 16
    assert runs <= 2 * nt, "at most two runs a thread"
    chans = np.zeros((4, k2 * Q), np.int8)
    written = np.zeros(k2 * Q, np.int64)
    for u in range(runs):
        assert u % nt < nt and u // nt < 2
        q, r0 = u % Q, (u // Q) * 16
        for part in range(2):
            x = xs[part * f + r0:part * f + r0 + 16, q].astype(np.float32)
            off = ((q // 8) * 8 * k2 + ((part * f + r0) // 16) * 128
                   + (q % 8) * 16 + np.arange(16))
            for c in range(4):
                t = cut(x, exp2(7 * (c + 1) - m))
                x = (x - (t - RND) * exp2(m - 7 * (c + 1))).astype(np.float32)
                chans[c, off] = t.view(np.uint32).astype(np.uint8).view(
                    np.int8)
            written[off] += 1
    assert (written == 1).all()
    return chans


def tc_model(xr: np.ndarray, xi: np.ndarray, f: int, sign: int,
             nt: int = 512):
    """The wgmma stage's arithmetic on one alignment group: (f, Q) float32
    planes (column q along axis 1) -> the f-point DFT's (f, Q) planes, the
    cut run by run over ``nt`` threads."""
    Q = xr.shape[1]
    k2 = 2 * f
    amax = np.float32(max(np.abs(xr).max(), np.abs(xi).max()))
    m = int(np.clip(((amax.view(np.int32) >> 23) & 0xFF) - 126, -40, 120))
    # 2. the cut, every step in float32, into B's byte layout
    xs = np.concatenate([xr, xi], axis=0)                 # (2f, Q)
    kk, q = np.meshgrid(np.arange(k2), np.arange(Q), indexing="ij")
    off = b_offset(q, kk, f, Q)
    chans = cut_runs(xs, f, m, nt)
    img = int8.w_image(f, sign)
    W = unpack_image(img, f).astype(np.int64)             # (3, 2f, 2f)
    X = chans[:, off].astype(np.int64)                    # (4, 2f, Q)
    # 3. slab by slab (its rows int8.w_rows), shift group by shift group,
    # k32 step by k32 step
    acc = np.zeros((k2, Q), np.float32)
    order = int8.w_rows(f)
    for sl in range(k2 // 64):
        rows = order[sl * 64:sl * 64 + 64]
        for s in range(2, 6):
            d = np.zeros((64, Q), np.int64)
            for wi in range(3):
                xc = s - 2 - wi
                if not 0 <= xc <= 3:
                    continue
                for kt in range(k2 // 32):
                    ks = slice(kt * 32, kt * 32 + 32)
                    d += W[wi, rows, ks] @ X[xc, ks]
            assert np.abs(d).max() < 2 ** 24
            t = d.astype(np.float32) * exp2(m - 7 * s)
            acc[rows] = t if s == 2 else (acc[rows] + t).astype(np.float32)
    return acc[:f], acc[f:]


@pytest.mark.parametrize("f,Q", [(32, 128), (64, 16), (64, 128), (128, 16),
                                 (128, 64), (128, 128), (32, 256)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_tc_order_bit_equal_to_plain_and_jax(f, Q, sign):
    rng = np.random.RandomState(f + Q)
    xr = rng.standard_normal((f, Q)).astype(np.float32)
    xi = (rng.standard_normal((f, Q)) * 3.0).astype(np.float32)
    xr[:, :4] *= np.float32(2.0 ** -12)       # small columns beside large
    mr, mi = tc_model(xr, xi, f, sign)
    tr, ti = int8.int8_stage(torch.from_numpy(xr), torch.from_numpy(xi), f,
                             0, int8.stacked_channels(f, sign))
    assert np.array_equal(mr, tr.numpy()) and np.array_equal(mi, ti.numpy())
    wch = jax_local.needed_tables(f, sign, precision="int8")[("wi8", f)]
    jr, ji = jax_local._int8_stage(jnp.asarray(xr), jnp.asarray(xi), f, 0,
                                   tuple(jnp.asarray(w) for w in wch))
    assert np.array_equal(mr, np.asarray(jr))
    assert np.array_equal(mi, np.asarray(ji))


def i8_pairs():
    """(log2 n, log2 f) of every int8 row kernel: PYFFT_I8_CHAINS, and
    (11, 7), which the row source adds for K2 + K10."""
    src = (CSRC / "int8_stage.cuh").read_text()
    body = src.split("#define PYFFT_I8_CHAINS(X)")[1].split("\n\n")[0]
    pairs = [tuple(map(int, t))
             for t in re.findall(r"X\((\d+), (\d+)\)", body)]
    return pairs + [(11, 7)]


# The stage each int8 row kernel runs: wgmma where the block has 128
# threads (n >= 1024) and f >= 32, else mma.sync.
ROW_STAGES = {(4, 4): "mma", (5, 5): "mma", (6, 6): "mma", (7, 7): "mma",
              (8, 6): "mma", (8, 5): "mma", (9, 7): "mma", (10, 6): "wgmma",
              (11, 6): "wgmma", (11, 7): "wgmma", (12, 6): "wgmma",
              (13, 7): "wgmma"}


@pytest.mark.parametrize("pair", sorted(ROW_STAGES))
def test_rows_i8_stage_pinned(pair):
    assert sorted(i8_pairs()) == sorted(ROW_STAGES)
    ln, lf = pair
    assert local.rows_i8_stage(1 << ln, 1 << lf) == ROW_STAGES[pair]


def test_row_stage_entry_covers_every_pair():
    """pyfft_local_rows_i8_stage reports RowI8::TC for every pair the row
    kernels dispatch (chip_smoke.py phase 19 holds it against
    rows_i8_stage on the card)."""
    src = (CSRC / "local_rows.cu").read_text()
    body = src.split("int pyfft_local_rows_i8_stage(")[1].split("\n}\n")[0]
    assert "PYFFT_I8_CHAINS(PYFFT_I8_STAGE)" in body
    assert "PYFFT_I8_STAGE(11, 7)" in body


def fused_i8_cases(tiled: bool):
    """(log2 ny, log2 fy, log2 nx, log2 fx) of every K8 + K10 (or K9 +
    K10) instance: the source's PYFFT_FUSED2D_I8_CASES (or
    PYFFT_TILED_I8_CASES)."""
    name, macro = (("fused2d_tiled.cu", "PYFFT_TILED_I8_CASES") if tiled
                   else ("fused2d.cu", "PYFFT_FUSED2D_I8_CASES"))
    src = (CSRC / name).read_text()
    body = src.split(f"#define {macro}(X)")[1].split("\n\n")[0]
    return [tuple(map(int, t))
            for t in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]


@pytest.mark.parametrize("tiled", [False, True])
def test_fused_i8_cases_take_the_chains_factor(tiled):
    """Each instance's f is the matrix factor of the chain the wrapper
    hands it (default_factors for K8, col_factors for K9): 15 and 28."""
    cases = fused_i8_cases(tiled)
    assert len(cases) == (28 if tiled else 15)
    chain = local.col_factors if tiled else local.default_factors
    for ly, lfy, lx, lfx in cases:
        assert local.matrix_factor(chain(1 << ly)) == 1 << lfy
        assert local.matrix_factor(chain(1 << lx)) == 1 << lfx


@pytest.mark.parametrize("case", fused_i8_cases(False))
def test_fused2d_i8_stage_pinned(case):
    from pyfft_tpu_torch.ops import fused2d
    assert fused2d.i8_stage(1 << case[0], 1 << case[2]) == "wgmma"


@pytest.mark.parametrize("case", fused_i8_cases(True))
def test_fused2d_tiled_i8_stage_pinned(case):
    from pyfft_tpu_torch.ops import fused2d
    assert fused2d.i8_stage(1 << case[0], 1 << case[2], tiled=True) == "wgmma"


@pytest.mark.parametrize("name,macro", [
    ("fused2d", "PYFFT_FUSED2D_I8_CASES"),
    ("fused2d_tiled", "PYFFT_TILED_I8_CASES")])
def test_fused_stage_entries_cover_every_case(name, macro):
    """pyfft_fused2d_i8_stage and pyfft_fused2d_tiled_i8_stage report
    I8Plan::TC for every instance (chip_smoke.py phase 20 holds them
    against fused2d.i8_stage on the card), and both kernels call the
    wgmma stage alone."""
    src = (CSRC / f"{name}.cu").read_text()
    body = src.split(f'extern "C" int pyfft_{name}_i8_stage(')[1]
    body = body.split("\n}\n")[0]
    assert f"{macro}(PYFFT_CASE)" in body and "::TC ? 1 : 0" in body
    kernel = src.split(f"{name}_i8_kernel(")[1].split("\n}\n")[0]
    assert kernel.count("int8_stage_tc<") == 2
    assert "int8_stage<" not in kernel


def test_in_place_path_is_gone():
    """No host uses int8_stage's old IN_PLACE form."""
    for path in CSRC.glob("*.cu*"):
        assert "IN_PLACE" not in path.read_text(), path.name
