"""Config 3's plan, a batched 2D complex64 transform, on the complex form
(one ``torch.complex64`` tensor, pyfft's interleaved complex) against the
benchmark's plain reference (``portbench/reference.py``, a float64 DFT by
matrix products that imports nothing of the port), at small sizes on the
CPU; and the routing the benchmark cell ``c64_2d_1024_b16.stream`` guards
at the published size: the "planes" route of two ``local`` passes, the
column pass on K5's cluster tile for stride-2 planes."""

import pytest
import torch

from portbench import reference
from pyfft_tpu_torch import Plan, planner

from test_torch_cluster_cols import macro_cases

torch.set_num_threads(2)

# The project's complex64 gate against a float64 DFT (tests/helpers.py TOL,
# after pyfft's test/test_errors.py): float32 rounding over log2 N stages
# of a 2D transform leaves about 1e-7 of the peak; the configuration's
# limits in the benchmark are the same.
TOL = 2e-6


def rel_err(got: torch.Tensor, re: torch.Tensor, im: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, ``ref`` the (re, im) planes."""
    ref = torch.complex(re, im)
    return ((got.to(torch.complex128) - ref).abs().max()
            / ref.abs().max()).item()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dims", [(3, 64, 128), (2, 32, 256)])
def test_2d_complex_plan_matches_reference(dims, inverse):
    """Seeded standard normal batches, forward and inverse (1/N, Plan's
    default), within the gate of the float64 reference; both shapes take
    config 3's plan, two ``local`` passes on the "planes" route."""
    g = torch.Generator().manual_seed(2**31 + 3 + dims[1])
    x = torch.complex(torch.randn(dims, generator=g),
                      torch.randn(dims, generator=g))
    plan = Plan(dims[1:], device="cpu")
    assert plan.il_route() == "planes"
    assert [p.executor for p in plan._exec_plan.passes] == ["local", "local"]
    got = plan.execute(x, inverse=inverse)
    assert got.shape == x.shape and got.dtype == torch.complex64
    n = dims[1] * dims[2]
    re, im = reference.dft(x.real, x.imag, 2, inverse=inverse,
                           scale=1 / n if inverse else 1.0)
    assert rel_err(got, re, im) < TOL


def test_config3_routing():
    """At (1024, 1024) complex64 with the kernels' routing on: no
    ``fused2d`` (2^20 points exceeds MAX_FUSED2D_ELEMS), so a ``local``
    pass along the rows and one along the columns (trail 1024), on the
    complex form's "planes" route; the complex64 cluster tile's table for
    planes whose t stride is not 1 (the stride-2 planes) takes n = 1024."""
    assert 1024 * 1024 > planner.MAX_FUSED2D_ELEMS
    ep = planner.build_plan((1024, 1024), "complex64", kernels=True)
    assert [(p.axis, p.n, p.executor) for p in ep.passes] == [
        (1, 1024, "local"), (0, 1024, "local")]
    assert Plan((1024, 1024), device="cpu").il_route() == "planes"
    assert 10 in {row[0] for row in macro_cases("local_cols.cu",
                                                "PYFFT_XCOLS_F32_S2")}
