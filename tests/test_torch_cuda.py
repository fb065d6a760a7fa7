"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions on a
card.  Marked ``cuda``: without a CUDA device every test here skips.  On a
machine with a card (and no JAX) run them with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-5 (fixed-substep advance, Hairer estimate, deposit):
the kernels and the plain versions run the same float32 operations with the
same CUDA math functions; the deposit sums in another order.  The adaptive
advance is held by share of lanes (see its test).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(dev, n=64, seed=0):
    from picles_torch import cartesian_box
    from picles_torch.core import fetch_relations as FR

    rng = np.random.default_rng(seed)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    ws = FR.get_initial_windsea(torch.full((n, n), 10.0, device=dev),
                                torch.full((n, n), 10.0, device=dev), 600.0)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    comps = (ws.lne + f(rng.normal(0, 0.05, (n, n))),
             ws.cg_bar_x * f(rng.uniform(0.95, 1.05, (n, n))),
             ws.cg_bar_y * f(rng.uniform(0.95, 1.05, (n, n))),
             f(rng.uniform(-0.3, 0.3, (n, n))),
             f(rng.uniform(-0.3, 0.3, (n, n))))
    active = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
    return tuple(c.contiguous() for c in comps), active, grid


def _consts():
    from picles_torch import ODEParameters
    from picles_torch.ops.rhs import make_rhs_consts

    params, cid, _ = ODEParameters.create()
    return make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_advance_kernel_matches_plain_fixed_substep(dev, method):
    from picles_torch import TermFlags, time_cosine_winds
    from picles_torch.ops.advance_cuda import advance_cuda
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    comps, active, g = _state(dev)
    winds = time_cosine_winds(10.0, 5.0, 6 * 3600.0)
    cfg = SolverConfig(method=method, adaptive=False)
    t = torch.full_like(comps[0], 1200.0)
    dt = torch.full_like(t, 37.5)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    before = advance_cuda.launches
    k = advance_cuda(winds, _consts(), TermFlags(), cfg, 600.0, comps, t, dt,
                     active, g.x, g.y, proj)
    assert advance_cuda.launches == before + 1
    p = integrate_to(make_rhs(winds.u, winds.v, _consts(), TermFlags()),
                     torch.stack(comps, -1), t, t + 600.0, dt,
                     RHSParams(g.x, g.y, g.proj, g.pc), active, cfg)
    for i in range(5):
        torch.testing.assert_close(k[i], p.z[..., i], rtol=1e-5, atol=1e-6)
    assert torch.equal(k.naccept, p.naccept) and torch.equal(k.failed,
                                                             p.failed)


def _share_close(a, b, rtol, atol=0.0):
    return float(torch.isclose(a.double(), b.double(), rtol=rtol, atol=atol,
                               equal_nan=True).float().mean())


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_advance_kernel_matches_plain_adaptive(dev, method):
    """Adaptive mode: the error controller turns last-ulp differences into
    other substep paths on a few lanes, and the step-size proposal ``dt`` of
    a lane whose last substep was shortened to land on ``t_end`` is rounding
    noise.  So: at least 99% of the lanes agree to rtol 5e-3 in every
    component; at least 95% of the active lanes take as many substeps; the
    mean of log(dt_kernel / dt_plain) over them is within 1e-2 of 0
    (rounding has no sign, a wrong controller constant has); ``failed`` and
    the end time agree on every lane."""
    from picles_torch import TermFlags, constant_winds
    from picles_torch.ops.advance_cuda import advance_cuda
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    comps, active, g = _state(dev, n=128, seed=3)
    winds = constant_winds(10.0, 10.0)
    cfg = SolverConfig(method=method, adaptive=True, dtmin=1e-4,
                       force_dtmin=True)
    t = torch.full_like(comps[0], 1200.0)
    rng = np.random.default_rng(4)
    dt = torch.as_tensor(rng.uniform(10.0, 120.0, t.shape).astype(np.float32),
                         device=dev)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    k = advance_cuda(winds, _consts(), TermFlags(), cfg, 600.0, comps, t, dt,
                     active, g.x, g.y, proj)
    p = integrate_to(make_rhs(winds.u, winds.v, _consts(), TermFlags()),
                     torch.stack(comps, -1), t, t + 600.0, dt,
                     RHSParams(g.x, g.y, g.proj, g.pc), active, cfg)
    assert torch.equal(k.failed, p.failed)
    torch.testing.assert_close(k.t, p.t, rtol=1e-6, atol=0.0)
    for i in range(5):
        assert _share_close(k[i], p.z[..., i], 5e-3, 1e-4) >= 0.99, i
    a = active & ~p.failed
    assert float((k.naccept[a] == p.naccept[a]).float().mean()) >= 0.95
    bias = float(torch.log(k.dt[a].double() / p.dt[a].double()).mean())
    assert abs(bias) <= 1e-2, bias
    assert int(p.naccept.max()) > 1   # the controller did adapt


def test_auto_dt_kernel_matches_plain(dev):
    from picles_torch import TermFlags, constant_winds
    from picles_torch.ops.advance_cuda import auto_dt_cuda
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.tsit5 import auto_dt

    comps, _, g = _state(dev, seed=1)
    winds = constant_winds(10.0, 10.0)
    t = torch.full_like(comps[0], 600.0)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    k = auto_dt_cuda(winds, _consts(), TermFlags(), t, comps, g.x, g.y, proj)
    p = auto_dt(make_rhs(winds.u, winds.v, _consts(), TermFlags()), t,
                torch.stack(comps, -1), RHSParams(g.x, g.y, g.proj, g.pc))
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("periodic", [True, False])
def test_gather_kernel_matches_plain_and_repeats(dev, periodic):
    from picles_torch import Boundary, GridStats
    from picles_torch.ops.pic import scatter_dense
    from picles_torch.ops.pic_cuda import pic_gather

    rng = np.random.default_rng(2)
    n = 96
    b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC
    stats = GridStats(nx=n, ny=n + 5, bx=b, by=b)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    xr, yr = (f(rng.uniform(-1.3, 3.3, (n, n + 5))) for _ in range(2))
    chans = tuple(f(rng.uniform(0, 1, (n, n + 5))) for _ in range(3))
    act = torch.as_tensor(rng.uniform(size=(n, n + 5)) < 0.9, device=dev)
    halo = ((1, 3), (1, 3))
    (o, st), (o2, _) = (pic_gather(xr, yr, chans, act, stats, halo)
                        for _ in range(2))
    S, st_p = scatter_dense(xr, yr, torch.stack(chans, -1), act, stats, halo)
    for c in range(3):
        torch.testing.assert_close(o[c], S[..., c], rtol=1e-5, atol=1e-6)
        assert torch.equal(o[c], o2[c])
    assert int(st.clamped) == int(st_p.clamped) > 0
    with pytest.raises(NotImplementedError, match="tripolar"):
        pic_gather(xr, yr, chans, act,
                   GridStats(nx=n, ny=n + 5, bx=Boundary.PERIODIC,
                             by=Boundary.TRIPOLAR_NORTH), halo)
