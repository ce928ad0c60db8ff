"""The ranks of ``tests/test_torch_dist.py``: four gloo processes on the
host, spawned once, each a rank of the meshes (2, 2), (1, 4) and (4, 1).

This module imports torch, numpy and the port only, never jax, so that a
rank loads torch alone; the test process imports it too, for the cases
and their inputs.  ``run`` is each rank's entry point: it builds the three
meshes, runs every case on its mesh and saves this rank's output blocks
(and its mesh coordinates) to ``rank<r>.npz``.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from helpers import rand_complex
from pyfft_tpu_torch.parallel import dist as pdist

WORLD = 4
MESHES = ((2, 2), (1, 4), (4, 1))

# (case, kind, mesh, global shape, dtype): kind "1d", "2d", "3d" or
# "df64" runs the forward and the normalized inverse of the input; "rt"
# the inverse of the forward.  The sharded axis is axis 1 in every kind.
CASES = (
    [(f"fft1d {dp}x{sp}", "1d", (dp, sp), (8, 512), np.complex64)
     for dp, sp in MESHES]
    + [("roundtrip", "rt", (2, 2), (4, 1024), np.complex64),
       ("fft2", "2d", (2, 2), (4, 64, 128), np.complex64),
       # (16, 64) planes: supported_2d fails, the plain chain runs
       ("fft3 plain", "3d", (2, 2), (2, 32, 16, 64), np.complex64),
       # (128, 128) planes: fused2d.fft2_fused (K8's plain version) runs on
       # each rank's (1, 4, 128, 128) block
       ("fft3 fused", "3d", (2, 2), (2, 8, 128, 128), np.complex64),
       # n/S = 16384: the local factor is the plain chain in both packages
       ("long1d", "1d", (1, 4), (2, 1 << 16), np.complex64),
       ("df64", "df64", (2, 2), (4, 1024), np.complex128)])

# The (split, concat) pairs dist.py exchanges by, each with a block shape
# of S ranks: 1D steps 1 and 4/6, the 2D pair, the 3D pair.
EXCHANGES = ((-1, -2, lambda s: (2, 1, 4 * s)),
             (-2, -1, lambda s: (2, s, 4)),
             (-1, -2, lambda s: (2, 3, 4 * s)),
             (-2, -1, lambda s: (2, 4 * s, 3)),
             (-1, -3, lambda s: (2, 3, 2, 4 * s)),
             (-3, -1, lambda s: (2, 4 * s, 2, 3)))
EXCHANGE_MESHES = ((2, 2), (1, 4))


def case_input(i: int) -> np.ndarray:
    """The global input of CASES[i], made from its index."""
    _, _, _, shape, dtype = CASES[i]
    return rand_complex(shape, dtype, seed=40 + i)


def exchange_input(rank: int, k: int, s: int) -> np.ndarray:
    """The block rank ``rank`` exchanges in EXCHANGES[k] over S = s ranks:
    distinct on every rank."""
    shape = EXCHANGES[k][2](s)
    rng = np.random.RandomState(1000 + 10 * rank + k)
    return rng.standard_normal(shape).astype(np.float32)


def block(x: np.ndarray, coord, mesh_shape) -> np.ndarray:
    """The block of ``x`` at mesh coordinate (i, j): axis 0 over dp, axis 1
    over sp."""
    (i, j), (dp, sp) = coord, mesh_shape
    b, d = x.shape[0] // dp, x.shape[1] // sp
    return np.ascontiguousarray(x[i * b:(i + 1) * b, j * d:(j + 1) * d])


def _planes(z: np.ndarray):
    return (torch.from_numpy(np.ascontiguousarray(z.real)),
            torch.from_numpy(np.ascontiguousarray(z.imag)))


def _case(i: int, mesh, coord, out: dict) -> None:
    name, kind, mesh_shape, shape, _ = CASES[i]
    x = case_input(i)
    re, im = _planes(block(x, coord, mesh_shape))
    if kind in ("1d", "rt"):
        n = shape[-1]
        # the one-shot entry point takes the whole planes, as numpy
        fwd = pdist.dist_fft_1d(np.ascontiguousarray(x.real),
                                np.ascontiguousarray(x.imag), mesh)
        inv_fn = pdist.make_dist_fft(mesh, n, sign=+1, normalize=True)
        inv = inv_fn(*fwd) if kind == "rt" else inv_fn(re, im)
    else:
        make = {"2d": pdist.make_dist_fft2, "3d": pdist.make_dist_fft3,
                "df64": pdist.make_dist_fft_df64}[kind]
        arg = shape[-1] if kind == "df64" else shape[1:]
        fwd = make(mesh, arg)(re, im)
        inv = make(mesh, arg, sign=+1, normalize=True)(re, im)
    for what, (r, m) in (("fwd", fwd), ("inv", inv)):
        out[f"{name}|{what}"] = r.numpy() + 1j * m.numpy()


def run(rank: int, world: int, root: str) -> None:
    """One rank: join the gloo group through a file store under ``root``,
    run every case, save ``rank<r>.npz``."""
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(root) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {m: init_device_mesh("cpu", m, mesh_dim_names=("dp", "sp"))
                  for m in MESHES}
        out = {}
        for m, mesh in meshes.items():
            out[f"coord {m[0]}x{m[1]}"] = np.array(mesh.get_coordinate())
        for m in EXCHANGE_MESHES:
            mesh, s = meshes[m], m[1]
            for k, (split, concat, _) in enumerate(EXCHANGES):
                x = torch.from_numpy(exchange_input(rank, k, s))
                out[f"exchange {m[0]}x{m[1]} {k}"] = pdist.exchange(
                    x, split, concat, s, mesh.get_group("sp")).numpy()
        for i, case in enumerate(CASES):
            mesh = meshes[case[2]]
            _case(i, mesh, tuple(mesh.get_coordinate()), out)
        np.savez(Path(root) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
