"""The benchmark's frozen roofline counts equal the port's ``chip_smoke.py``
functions on a few shapes (the harness itself never imports
``chip_smoke.py``; this test pins the copy to it)."""

import pytest
import torch

from wavebench import roofline


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def test_peaks_and_counts(smoke):
    assert roofline.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == smoke.FP32_OPS_PER_S
    assert roofline.FP64_OPS_PER_S == smoke.FP64_OPS_PER_S
    assert roofline.RHS_OPS == smoke.RHS_OPS
    for m in ("bosh3", "tsit5"):
        for a in (True, False):
            for comps in (3, 5):
                assert roofline.k1_substep_ops(m, a, comps) == \
                    smoke.k1_substep_ops(m, a, comps)
    for B in (1, 2, 3):
        assert roofline.gridded_wind_ops(B) == smoke.gridded_wind_ops(B)
    for nb, ops, real in ((1e8, 1e9, 4), (1e6, 1e12, 4), (1e8, 1e12, 8)):
        assert roofline.bound(nb, ops, real) == smoke.bound(nb, ops, real)


@pytest.mark.parametrize("shape,method,n_wf,proj", [
    ((64, 48), "bosh3", 0, False), ((40, 30), "tsit5", 7, True),
    ((50, 50), "bosh3", 2, False)])
def test_k1_bound_from_totals(smoke, shape, method, n_wf, proj):
    g = torch.Generator().manual_seed(1)
    live = torch.rand(shape, generator=g) < 0.8
    iters = torch.randint(1, 6, shape, generator=g)
    n = live.numel()
    want = smoke.k1_bound(n, method, True, live, iters, n_wf=n_wf,
                          proj=proj)
    got = roofline.k1_bound(n, method, True, float(live.sum()),
                            float(iters[live].sum()), n_wf=n_wf, proj=proj)
    assert got["bound_by"] == want["bound_by"]
    assert got["bound_ms"] == pytest.approx(want["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("halo,n_wf", [(((0, 3), (0, 3)), 0), (3, 7),
                                       (3, 0), (((1, 3), (0, 2)), 2)])
def test_deposit_and_remesh_bounds(smoke, halo, n_wf):
    n = 1536 * 1536
    for remesh in (False, True):
        assert roofline.deposit_bound(n, n, halo, remesh=remesh,
                                      n_wf=n_wf) == \
            smoke.deposit_bound(n, n, halo, remesh=remesh, n_wf=n_wf)
    assert roofline.remesh_bound(n, n_wf=n_wf) == smoke.remesh_bound(
        n, n_wf=n_wf)


def test_step_work_bounds_the_kernels():
    """The step's necessary work is less than K1's and K6's bounds
    together (it counts each value once), and bytes-bound at these
    shapes."""
    n = 1536 * 1536
    w = roofline.step_work(n, "bosh3", 0.95 * n, 1.1 * n)
    k1 = roofline.k1_bound(n, "bosh3", True, 0.95 * n, 1.1 * n)
    k6 = roofline.deposit_bound(n, n, ((0, 3), (0, 3)), remesh=True)
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] < k1["bound_ms"] + k6["bound_ms"]
