"""The port's distributed FFT (``pyfft_tpu_torch.parallel.dist``) against
the JAX package's (``pyfft_tpu.parallel.dist``) and numpy.

Four gloo ranks, spawned once for the module (``tests/torch_dist_ranks.py``,
which imports no jax), run every case on the meshes (2, 2), (1, 4) and
(4, 1) and save their output blocks; the test process reassembles them by
mesh coordinate and runs the JAX side on conftest's virtual CPU devices,
on a ``Mesh`` of the same shape.  No process group is started in the test
process: what needs no collective (validation, the local factor's
dispatch, the device check) runs here on a one-rank stand-in mesh, its
exchange a copy.  Gates: 1e-6 of the peak against JAX (1e-11 complex128),
``helpers.TOL`` against numpy.
"""

from __future__ import annotations

import collections
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_ranks as R
from helpers import TOL, rand_complex, rel_err
from pyfft_tpu.ops.df64 import split_f64
from pyfft_tpu.parallel import dist as jdist
from pyfft_tpu_torch.ops import fp64, fused2d, local
from pyfft_tpu_torch.parallel import dist as pdist

JAX_TOL = {np.complex64: 1e-6, np.complex128: 1e-11}


class Ranks:
    """R.WORLD gloo ranks, spawned when the module's first test starts, that
    rendezvous through a file store under ``root``; ``outputs()`` waits for
    them (120 s at most) and returns every rank's saved outputs."""

    def __init__(self, root):
        self.root, self.t0, self.saved = root, time.monotonic(), None
        self.ctx = torch.multiprocessing.start_processes(
            R.run, args=(R.WORLD, str(root)), nprocs=R.WORLD, join=False,
            start_method="spawn")

    def outputs(self) -> list:
        if self.saved is None:
            while not self.ctx.join(timeout=5):
                if time.monotonic() - self.t0 > 120:
                    raise TimeoutError("the gloo ranks did not end in 120 s")
            self.saved = [dict(np.load(self.root / f"rank{r}.npz"))
                          for r in range(R.WORLD)]
        return self.saved

    def close(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The ranks run while the tests that need none (the JAX model, the
    one-rank tests) run here."""
    r = Ranks(tmp_path_factory.mktemp("dist_ranks"))
    try:
        yield r
    finally:
        r.close()


def _assemble(ranks, key: str, mesh_shape, shape) -> np.ndarray:
    """The global array of the blocks saved under ``key``, placed by each
    rank's mesh coordinate (axis 0 over dp, axis 1 over sp)."""
    dp, sp = mesh_shape
    out = np.zeros(shape, np.complex128)
    b, d = shape[0] // dp, shape[1] // sp
    for res in ranks:
        i, j = res[f"coord {dp}x{sp}"]
        out[i * b:(i + 1) * b, j * d:(j + 1) * d] = res[key]
    return out


def _jax_mesh(dp: int, sp: int) -> Mesh:
    devs = np.array(jax.devices()[: dp * sp]).reshape(dp, sp)
    return Mesh(devs, ("dp", "sp"))


def tiled_all_to_all(blocks, split: int, concat: int):
    """A numpy model of JAX's tiled all_to_all over the ranks holding
    ``blocks``: rank r receives chunk r of every block along ``split``,
    concatenated along ``concat`` in the order of the senders."""
    s = len(blocks)
    return [np.concatenate([np.split(b, s, axis=split)[r] for b in blocks],
                           axis=concat) for r in range(s)]


# ------------------------------------------------------------ the exchange


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", range(len(R.EXCHANGES)))
def test_exchange_model_is_jax_all_to_all(k, s):
    """The model is JAX's tiled all_to_all, on rank-distinct blocks."""
    split, concat, _ = R.EXCHANGES[k]
    blocks = [R.exchange_input(r, k, s) for r in range(s)]
    mesh = Mesh(np.array(jax.devices()[:s]), ("sp",))

    def body(x):
        return jax.lax.all_to_all(x, "sp", split_axis=split % x.ndim,
                                  concat_axis=concat % x.ndim, tiled=True)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("sp"),
                               out_specs=P("sp")))
    got = np.asarray(fn(jnp.asarray(np.concatenate(blocks, axis=0))))
    want = tiled_all_to_all(blocks, split, concat)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=0))


# ------------------------------------------- one rank, no collective needed


class SoloMesh:
    """A stand-in for a (dp, sp) DeviceMesh on the host, this process at
    coordinate (0, 0): enough for validation, and, at (1, 1), with
    ``solo`` below, for the transforms (an exchange over one rank is a
    copy)."""

    device_type = "cpu"
    mesh_dim_names = ("dp", "sp")

    def __init__(self, dp: int = 1, sp: int = 1):
        self.shape = (dp, sp)

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


@pytest.fixture
def solo(monkeypatch):
    """``all_to_all_single`` over a group of one rank: a copy."""
    monkeypatch.setattr(torch.distributed, "all_to_all_single",
                        lambda out, inp, group=None: out.copy_(inp))


@pytest.mark.parametrize("make,arg,sp", [
    (pdist.make_dist_fft, 24, 1),            # not a power of two
    (pdist.make_dist_fft, 8, 4),             # 8 < 4 * 4
    (pdist.make_dist_fft, 32, 8),            # 32 < 8 * 8
    (pdist.make_dist_fft_df64, 24, 1),
    (pdist.make_dist_fft_df64, 8, 4),
    (pdist.make_dist_fft_df64, 1 << 14, 2),  # n/S = 8192 > K11's 4096
    (pdist.make_dist_fft_df64, 16, 4),       # n/S = 4 < 8
    (pdist.make_dist_fft2, (64, 96), 1),     # not powers of two
    (pdist.make_dist_fft2, (4, 128), 8),     # ny not divisible by S
    (pdist.make_dist_fft2, (128, 4), 8),     # nx not divisible by S
    (pdist.make_dist_fft3, (16, 24, 64), 1),
    (pdist.make_dist_fft3, (4, 16, 64), 8),  # nz not divisible by S
    (pdist.make_dist_fft3, (64, 16, 4), 8),  # nx not divisible by S
])
def test_make_dist_validates(make, arg, sp):
    with pytest.raises(ValueError):
        make(SoloMesh(1, sp), arg)


def test_mesh_needs_both_dimensions():
    with pytest.raises(ValueError, match="no dimension"):
        pdist.make_dist_fft(SoloMesh(), 64, seq_axis="seq")
    with pytest.raises(ValueError, match="no dimension"):
        pdist.make_dist_fft2(SoloMesh(), (64, 64), batch_axis="batch")


def test_blocks_on_another_device_raise(solo):
    """A block on a device other than the mesh's raises; it is never moved
    (the "meta" device stands for any other)."""
    z = torch.zeros(2, 64, device="meta")
    fn = pdist.make_dist_fft(SoloMesh(), 64)
    with pytest.raises(ValueError, match="move it first"):
        fn(z, z)
    with pytest.raises(ValueError, match="move them first"):
        pdist.dist_fft_1d(z, z, SoloMesh())
    z3 = torch.zeros(1, 4, 128, 128, device="meta")
    with pytest.raises(ValueError, match="move it first"):
        pdist.make_dist_fft3(SoloMesh(), (4, 128, 128))(z3, z3)


def test_blocks_of_another_shape_raise(solo):
    z = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="block"):
        pdist.make_dist_fft(SoloMesh(), 64)(z, z)
    with pytest.raises(ValueError, match="float64"):
        pdist.make_dist_fft_df64(SoloMesh(), 32)(z, z)
    with pytest.raises(ValueError, match="divide"):
        pdist.dist_fft_1d(np.zeros((3, 64), np.float32),
                          np.zeros((3, 64), np.float32), SoloMesh(2, 1))


def _counting(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)


@pytest.fixture
def calls(monkeypatch, solo):
    """Calls of each local-factor executor dist.py may take."""
    c = collections.Counter()
    for module, name in ((local, "fft_axis"), (fused2d, "fft2_fused"),
                         (fp64, "fft_axis_df64"), (pdist, "fft_planar")):
        _counting(monkeypatch, c, module, name)
    return c


def _planes(shape, dtype=np.complex64, seed=0):
    x = rand_complex(shape, dtype, seed=seed)
    return x, torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())


@pytest.mark.parametrize("n", [8, 512, 8192, 16384])
def test_dispatch_1d(calls, n):
    """The local factor is ``local.fft_axis`` exactly where
    ``local.supported`` holds, else the plain chain."""
    x, re, im = _planes((2, n))
    rr, ii = pdist.make_dist_fft(SoloMesh(), n)(re, im)
    kernel = local.supported(re, 1)
    assert calls == ({"fft_axis": 1} if kernel else {"fft_planar": 1})
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(rr.numpy() + 1j * ii.numpy(), ref) < TOL[np.complex64]


@pytest.mark.parametrize("shape", [(64, 128), (64, 16), (16384, 128)])
def test_dispatch_2d(calls, shape):
    """Rows and columns each take ``local.fft_axis`` exactly where
    ``local.supported`` holds on their block."""
    x, re, im = _planes((2, *shape))
    rr, ii = pdist.make_dist_fft2(SoloMesh(), shape)(re, im)
    kernels = local.supported(re, 2) + local.supported(re, 1)
    assert calls["fft_axis"] == kernels
    assert calls["fft_planar"] == 2 - kernels
    ref = np.fft.fftn(x.astype(np.complex128), axes=(1, 2))
    assert rel_err(rr.numpy() + 1j * ii.numpy(), ref) < TOL[np.complex64]


@pytest.mark.parametrize("shape", [(8, 128, 128), (32, 16, 64),
                                   (4, 128, 128), (16, 128, 256)])
def test_dispatch_3d(calls, shape):
    """The planes take ``fused2d.fft2_fused`` exactly where
    ``supported_2d`` holds (else the plain chain on both axes); the z axis
    ``local.fft_axis`` exactly where ``local.supported`` holds."""
    x, re, im = _planes((1, *shape))
    rr, ii = pdist.make_dist_fft3(SoloMesh(), shape)(re, im)
    fused, z = fused2d.supported_2d(re), local.supported(re, 1)
    assert calls["fft2_fused"] == fused
    assert calls["fft_axis"] == z
    assert calls["fft_planar"] == 2 * (not fused) + (not z)
    ref = np.fft.fftn(x.astype(np.complex128), axes=(1, 2, 3))
    assert rel_err(rr.numpy() + 1j * ii.numpy(), ref) < TOL[np.complex64]


@pytest.mark.parametrize("n", [8, 1024, 4096])
def test_dispatch_df64(calls, n):
    """The complex128 local factor is ``fp64.fft_axis_df64`` (K11)."""
    x, re, im = _planes((2, n), np.complex128)
    rr, ii = pdist.make_dist_fft_df64(SoloMesh(), n, sign=+1,
                                      normalize=True)(re, im)
    assert calls == {"fft_axis_df64": 1, "fft_axis": 1}
    ref = np.fft.ifft(x, axis=-1)
    assert rel_err(rr.numpy() + 1j * ii.numpy(), ref) < TOL[np.complex128]


def test_one_rank_is_the_local_factor(solo):
    """At S = 1 the twiddle tile is all ones and the S-point DFT the
    identity: the distributed transform equals the local factor's, bit
    for bit (the chip run expects the same of the kernels)."""
    x, re, im = _planes((4, 256), seed=3)
    rr, ii = pdist.make_dist_fft(SoloMesh(), 256)(re, im)
    wr, wi = local.fft_axis(re, im, -1)
    assert torch.equal(rr, wr) and torch.equal(ii, wi)


# ----------------------------------------------------- the gloo ranks


@pytest.mark.parametrize("mesh_shape", R.EXCHANGE_MESHES)
@pytest.mark.parametrize("k", range(len(R.EXCHANGES)))
def test_exchange_matches_model(ranks, k, mesh_shape):
    """``dist.exchange`` over the sp group of each dp row gives every rank
    what the model gives it, bit for bit: a chunk from the wrong rank or a
    wrong order would keep the shapes."""
    dp, sp = mesh_shape
    split, concat, _ = R.EXCHANGES[k]
    for i in range(dp):
        row = [i * sp + j for j in range(sp)]      # row-major, sp minor
        want = tiled_all_to_all([R.exchange_input(r, k, sp) for r in row],
                                split, concat)
        for j, r in enumerate(row):
            np.testing.assert_array_equal(
                ranks.outputs()[r][f"exchange {dp}x{sp} {k}"], want[j])


@pytest.mark.parametrize("mesh_shape", R.MESHES)
def test_rank_order_is_row_major(ranks, mesh_shape):
    """Rank r sits at (r // sp, r % sp), as JAX's devices in its Mesh."""
    dp, sp = mesh_shape
    for r, res in enumerate(ranks.outputs()):
        assert tuple(res[f"coord {dp}x{sp}"]) == (r // sp, r % sp)


@functools.lru_cache(maxsize=None)
def _jax_outputs(i: int) -> dict:
    """JAX's forward and inverse (or round trip) of CASES[i] on a mesh of
    the same shape, as global complex128 arrays."""
    _, kind, (dp, sp), shape, _ = R.CASES[i]
    mesh = _jax_mesh(dp, sp)
    x = R.case_input(i)
    spec = NamedSharding(mesh, P("dp", "sp", *(None,) * (len(shape) - 2)))
    if kind == "df64":
        n = shape[-1]
        quad = tuple(jax.device_put(p.astype(np.float32), spec)
                     for p in (*split_f64(x.real), *split_f64(x.imag)))

        def join(q):
            q = [np.asarray(p, np.float64) for p in q]
            return q[0] + q[1] + 1j * (q[2] + q[3])

        fwd = jdist.make_dist_fft_df64(mesh, n)
        inv = jdist.make_dist_fft_df64(mesh, n, sign=+1, normalize=True)
        return {"fwd": join(fwd(*quad)), "inv": join(inv(*quad))}
    re = jax.device_put(x.real.astype(np.float32), spec)
    im = jax.device_put(x.imag.astype(np.float32), spec)
    if kind in ("1d", "rt"):
        n = shape[-1]
        fwd = jdist.dist_fft_1d(np.real(x).copy(), np.imag(x).copy(), mesh)
        inv_fn = jdist.make_dist_fft(mesh, n, sign=+1, normalize=True)
        inv = inv_fn(*fwd) if kind == "rt" else inv_fn(re, im)
    else:
        make = jdist.make_dist_fft2 if kind == "2d" else jdist.make_dist_fft3
        fwd = make(mesh, shape[1:])(re, im)
        inv = make(mesh, shape[1:], sign=+1, normalize=True)(re, im)
    return {w: np.asarray(a[0], np.float64) + 1j * np.asarray(a[1],
                                                             np.float64)
            for w, a in (("fwd", fwd), ("inv", inv))}


def _numpy(i: int, what: str) -> np.ndarray:
    _, kind, _, shape, _ = R.CASES[i]
    x = R.case_input(i).astype(np.complex128)
    axes = tuple(range(1, len(shape)))
    if what == "fwd":
        return np.fft.fftn(x, axes=axes)
    return x if kind == "rt" else np.fft.ifftn(x, axes=axes)


@pytest.mark.parametrize("what", ["fwd", "inv"])
@pytest.mark.parametrize("i", range(len(R.CASES)),
                         ids=[c[0].replace(" ", "-") for c in R.CASES])
def test_dist_parity(ranks, i, what):
    """Every case on its mesh: the port's blocks, reassembled, against
    numpy and against JAX's transform on a mesh of the same shape."""
    name, _, mesh_shape, shape, dtype = R.CASES[i]
    want = _jax_outputs(i)[what]
    got = _assemble(ranks.outputs(), f"{name}|{what}", mesh_shape, shape)
    assert rel_err(got, _numpy(i, what)) < TOL[dtype]
    assert rel_err(got, want) < JAX_TOL[dtype]


