"""The CUDA kernels K1-K6 against their plain PyTorch versions on a card,
K1, K2, K3, K4 and K6 bit for bit against their ``_simple`` baselines (the
kernels they replaced; K3's followed by PyTorch's clamp and select), a
fused Simulation resumed from a checkpoint, the sharded step on a (1, 1)
NCCL mesh (on a tripolar grid too), the spherical and tripolar grids:
K1/K3 with per-node projection planes (bit for bit the scalars on a
Cartesian box) and K2/K6 with the tripolar seam; and the 1D model (plain
PyTorch) on the card against the CPU, its deposit deterministic.  Marked
``cuda``: without a CUDA device every test
here skips but the one that checks the refusal of CPU tensors.  On a
machine with a card (and no JAX) run them with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-5 (fixed-substep advance, Hairer estimate, deposits):
the kernels and the plain versions run the same float32 operations with the
same CUDA math functions; the deposit sums in another order.  The adaptive
advance is held by share of lanes (see its test).  The remesh (K5, K6):
bits, flags, dt and positions exact, reseeded values within rtol 4e-7.
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


def _winds(name, n):
    from picles_torch import (constant_winds, half_domain_winds,
                              time_cosine_winds)

    return {"constant": constant_winds(10.0, 10.0),
            "half_domain": half_domain_winds(10.0, 5.0, 1e3 * (n - 1),
                                             background=2.0),
            "time_cosine": time_cosine_winds(10.0, 5.0, 6 * 3600.0)}[name]


def _reset_inputs(dev, n, seed):
    """A half-reset mask (whole warps of 32 unreset lanes along y among
    single lanes) and the remesh's dt over [1e-3, 900] s."""
    rng = np.random.default_rng(seed)
    reset = rng.uniform(size=(n, n)) < 0.5
    reset[::3, :32] = False
    dt = rng.uniform(1e-3, 900.0, (n, n)).astype(np.float32)
    return (torch.as_tensor(reset, device=dev),
            torch.as_tensor(dt, device=dev))


@pytest.mark.parametrize("wind", ["constant", "half_domain", "time_cosine"])
def test_auto_dt_kernel_matches_plain(dev, wind):
    """K3, the dt reset, against auto_dt_reset on a half-reset mask: the
    unreset lanes keep their dt, the estimate within rtol 1e-5."""
    from picles_torch import TermFlags
    from picles_torch.ops.advance_cuda import auto_dt_cuda, auto_dt_reset
    from picles_torch.ops.rhs import RHSParams, make_rhs

    comps, _, g = _state(dev, seed=1)
    winds = _winds(wind, 64)
    reset, dt = _reset_inputs(dev, 64, 2)
    t = torch.full_like(comps[0], 600.0)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    before = auto_dt_cuda.launches
    k = auto_dt_cuda(winds, _consts(), TermFlags(), t, comps, g.x, g.y, proj,
                     reset, dt, 1e-4, 600.0)
    assert auto_dt_cuda.launches == before + 1
    p = auto_dt_reset(make_rhs(winds.u, winds.v, _consts(), TermFlags()), t,
                      torch.stack(comps, -1),
                      RHSParams(g.x, g.y, g.proj, g.pc), reset, dt, 1e-4,
                      600.0)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0.0)
    assert torch.equal(k[~reset], dt[~reset])


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
    # the tripolar north seam on the same inputs: the fold in the kernel
    tri = GridStats(nx=n, ny=n + 5, bx=Boundary.PERIODIC,
                    by=Boundary.TRIPOLAR_NORTH)
    (o, st), (o2, _) = (pic_gather(xr, yr, chans, act, tri, halo)
                        for _ in range(2))
    S, st_p = scatter_dense(xr, yr, torch.stack(chans, -1), act, tri, halo)
    for c in range(3):
        torch.testing.assert_close(o[c], S[..., c], rtol=1e-5, atol=1e-6)
        assert torch.equal(o[c], o2[c])
    assert int(st.clamped) == int(st_p.clamped) > 0
    with pytest.raises(ValueError, match="no tripolar seam"):
        pic_gather(xr, yr, chans, act, tri, halo, simple=True)


def _remesh_case(dev, n, boundary_type, adaptive, seed=0):
    """A non-periodic box with half-domain winds and a perturbed node state:
    gather, reseed and off all fire.  Returns (model, node, core)."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              cartesian_box, half_domain_winds)
    from picles_torch.ops.transforms import particle_to_node

    comps, _, _ = _state(dev, n=n, seed=seed)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n, device=dev)
    m = WaveGrowth2D(grid, half_domain_winds(10.0, 5.0, 1e3 * (n - 1)),
                     ODESettings(timestep=600.0, dt=37.5, adaptive=adaptive,
                                 solver="bosh3"),
                     config=WaveGrowth2DConfig(periodic_boundary=False,
                                               boundary_type=boundary_type,
                                               dt_reset_mode="carry",
                                               remesh_mode="pallas"))
    rng = np.random.default_rng(seed + 1)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    low = f(np.where(rng.uniform(size=(n, n)) < 0.3,
                     rng.uniform(0, 1e-4, (n, n)), 1.0))
    node = tuple((c * low).contiguous()
                 for c in particle_to_node(*comps[:3]))
    dt = f(np.exp(rng.uniform(np.log(1e-6), np.log(3000.0), (n, n))))
    on = torch.as_tensor(rng.uniform(size=(n, n)) < 0.8, device=dev)
    core = (*comps, dt, on, m.active_mask.contiguous(),
            m.boundary_mask.contiguous(), grid.x, grid.y,
            torch.tensor(1800.0, device=dev))
    return m, node, core


def _assert_remesh(k, p, rtol):
    for f in ("branch", "on", "dt", "px", "py"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    for f in ("lne", "cgx", "cgy"):
        torch.testing.assert_close(getattr(k, f), getattr(p, f), rtol=rtol,
                                   atol=0.0)


@pytest.mark.parametrize("boundary_type", ["same", "wind_sea", "mininmal"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_remesh_kernel_matches_plain(dev, boundary_type, adaptive):
    """K5 against remesh_core: bits, on, dt and positions equal; the
    gathered and reseeded values within 4e-7 (a few ulps of powf/logf)."""
    from picles_torch.ops.remesh import remesh_core
    from picles_torch.ops.remesh_cuda import remesh_cuda

    m, node, core = _remesh_case(dev, 96, boundary_type, adaptive)
    before = remesh_cuda.launches
    k = remesh_cuda(m.remesh_params, node, *core)
    assert remesh_cuda.launches == before + 1
    p = remesh_core(m.remesh_params, node, *core)
    _assert_remesh(k, p, 4e-7)
    for bit in (1, 2, 4):
        assert int(((k.branch & bit) != 0).sum()) > 0, bit


def test_fused_kernel_matches_gather_then_remesh(dev):
    """K6 against K2 + K5 on the same inputs: every output bitwise equal;
    against scatter_dense + remesh_core: node planes within K2's tolerance
    and the bits equal; two runs of K6 bitwise equal."""
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.pic import scatter_dense
    from picles_torch.ops.pic_cuda import pic_gather, pic_gather_remesh
    from picles_torch.ops.remesh import remesh_core
    from picles_torch.ops.remesh_cuda import remesh_cuda

    m, _, core = _remesh_case(dev, 96, "wind_sea", True, seed=5)
    lne, cgx, cgy, px, py = core[:5]
    chans = TR.particle_to_node(lne, cgx, cgy)
    sact = (core[6] & core[7]).contiguous()
    stats, halo = m.grid.stats, ((1, 3), (0, 2))
    node, rm, st = pic_gather_remesh(px, py, chans, sact, stats, halo,
                                     m.remesh_params, *core)
    node2, rm2, _ = pic_gather_remesh(px, py, chans, sact, stats, halo,
                                      m.remesh_params, *core)
    k2, st2 = pic_gather(px, py, chans, sact, stats, halo)
    k5 = remesh_cuda(m.remesh_params, k2, *core)
    for a, b, c in zip(node, k2, node2):
        assert torch.equal(a, b) and torch.equal(a, c)
    for f in rm._fields:
        assert torch.equal(getattr(rm, f), getattr(k5, f)), f
        assert torch.equal(getattr(rm, f), getattr(rm2, f)), f
    assert int(st.clamped) == int(st2.clamped)
    S, _ = scatter_dense(px, py, torch.stack(chans, -1), sact, stats, halo)
    for c in range(3):
        torch.testing.assert_close(node[c], S[..., c], rtol=1e-5,
                                   atol=1e-6 * float(S[..., c].abs().max()))
    p = remesh_core(m.remesh_params, tuple(S[..., c] for c in range(3)),
                    *core)
    assert torch.equal(rm.branch, p.branch) and torch.equal(rm.on, p.on)


def test_fused_simulation_resumes_bitwise(dev, tmp_path):
    """The flagship's fused configuration at 64^2 through Simulation, which
    replays the captured step: K6 is called by the host only in the
    capture's warm-up and capture, the day equals the eager steps bit for
    bit, and a mid-run checkpoint resumes to a bitwise-equal end state."""
    from picles_torch import (ODESettings, Simulation, WaveGrowth2D,
                              WaveGrowth2DConfig, cartesian_box,
                              constant_winds)
    from picles_torch.models.drivers import WARMUP_STEPS
    from picles_torch.ops.pic_cuda import pic_gather_remesh
    
    n = 64
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0),
                         ODESettings(timestep=600.0, dt=1e-3, solver="bosh3"),
                         config=WaveGrowth2DConfig(dt_reset_mode="carry",
                                                   remesh_mode="fused",
                                                   halo=((0, 3), (0, 3))))
    assert model.graphed
    before = pic_gather_remesh.launches
    full = Simulation.create(model, stop_time=10 * 600.0)
    full.run()
    assert pic_gather_remesh.launches == before + WARMUP_STEPS + 1
    ms = model.init_state()
    for _ in range(11):
        ms = model.step(ms)
    assert pic_gather_remesh.launches == before + WARMUP_STEPS + 12
    _assert_bitwise(full.state.leaves(), ms.leaves())
    leg = Simulation.create(model, stop_time=5 * 600.0)
    leg.run()
    ck = leg.checkpoint(str(tmp_path / "ck"))
    rest = Simulation.create(model, stop_time=10 * 600.0)
    rest.pickup(ck)
    rest.run()
    for a, b in zip(full.state.leaves(), rest.state.leaves()):
        assert torch.equal(a, b)
    assert int(full.state.metrics.n_failed) == 0


@pytest.mark.parametrize("halo", [3, ((0, 3), (0, 3)), ((1, 3), (0, 2))])
def test_padded_gather_kernel_matches_plain_and_repeats(dev, halo):
    """K4 against scatter_accumulate_padded, displacements over the whole
    halo and past it: within 1e-6 of the scale, two launches bitwise
    equal, the clamped count exact."""
    from picles_torch.ops.pic import normalize_halo, scatter_accumulate_padded
    from picles_torch.ops.pic_cuda import pic_gather_padded

    rng = np.random.default_rng(6)
    n = 96
    (xl, xh), (yl, yh) = normalize_halo(halo)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    xr = f(rng.uniform(-xl - 0.3, xh + 0.3, (n, n + 5)))
    yr = f(rng.uniform(-yl - 0.3, yh + 0.3, (n, n + 5)))
    chans = tuple(f(rng.uniform(0, 1, (n, n + 5))) for _ in range(3))
    act = torch.as_tensor(rng.uniform(size=(n, n + 5)) < 0.9, device=dev)
    before = pic_gather_padded.launches
    (o, st), (o2, _) = (pic_gather_padded(xr, yr, chans, act, halo)
                        for _ in range(2))
    assert pic_gather_padded.launches == before + 2
    P, st_p = scatter_accumulate_padded(xr, yr, torch.stack(chans, -1), act,
                                        halo)
    assert o.shape == (3, n + xl + xh, n + 5 + yl + yh)
    for c in range(3):
        torch.testing.assert_close(o[c], P[..., c], rtol=1e-5,
                                   atol=1e-6 * float(P[..., c].abs().max()))
        assert torch.equal(o[c], o2[c])
    assert int(st.clamped) == int(st_p.clamped) > 0


def test_padded_gather_refuses_cpu_tensors():
    """The K4 wrapper launches or raises: CPU tensors are refused."""
    from picles_torch.ops.pic_cuda import pic_gather_padded

    z = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        pic_gather_padded(z, z, (z, z, z), torch.ones((8, 8), dtype=torch.bool),
                          3)


def test_sharded_step_nccl_one_rank_matches_single_device(dev):
    """The flagship's configuration at 64^2 through ShardedWaveGrowth2D on a
    (1, 1) mesh over NCCL (K1 -> K4 -> self-wrap fold -> K5) against the
    single-device step (K2 in place of K4 and the fold): rtol 2e-3, the
    sharded step's bound (tests/test_sharded.py:50-56), counters equal."""
    import socket

    import torch.distributed as dist

    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              cartesian_box, constant_winds)
    from picles_torch.ops.pic_cuda import pic_gather_padded
    from picles_torch.parallel.sharded import (ShardedWaveGrowth2D,
                                               init_distributed, make_mesh)

    n = 64
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0),
                         ODESettings(timestep=600.0, dt=1e-3, solver="bosh3"),
                         config=WaveGrowth2DConfig(dt_reset_mode="carry",
                                                   remesh_mode="pallas",
                                                   halo=((0, 3), (0, 3))))
    ref = model.step_n_quiet(model.init_state(), 3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, "nccl", port, timeout_s=60.0)
    try:
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        assert sh.transport == "nccl, device tensors"
        assert model.graphed and not sh.graphed   # the sharded step is eager
        before = pic_gather_padded.launches
        ms = sh.step_n_quiet(sh.init_state(), 3)
        assert pic_gather_padded.launches == before + 3
        torch.testing.assert_close(ms.state, ref.state, rtol=2e-3,
                                   atol=1e-10)
        got, want = ms.metrics.as_dict(), ref.metrics.as_dict()
        for k in ("n_active", "n_gather", "n_failed", "n_clamped"):
            assert got[k] == want[k], k
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the redesigned kernels against their `_simple` baselines, bit for bit
# ---------------------------------------------------------------------------

def _bits(t):
    t = t.contiguous()
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t.view(torch.int32) if t.element_size() == 4 else t


def _assert_bitwise(new, simple):
    for i, (a, b) in enumerate(zip(new, simple)):
        assert torch.equal(_bits(a), _bits(b)), i


def _deposit_inputs(dev, nx, ny, halo, seed):
    from picles_torch.ops.pic import normalize_halo

    (xl, xh), (yl, yh) = normalize_halo(halo)
    rng = np.random.default_rng(seed)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    xr = f(rng.uniform(-xl - 0.3, xh + 0.3, (nx, ny)))
    yr = f(rng.uniform(-yl - 0.3, yh + 0.3, (nx, ny)))
    ch = [f(rng.normal(0, 1, (nx, ny))) for _ in range(3)]
    ch[0][nx // 2, ny // 3] = float("inf")   # reaches its whole window
    ch[2][1, ny - 2] = float("nan")
    act = torch.as_tensor(rng.uniform(size=(nx, ny)) < 0.8, device=dev)
    return xr, yr, tuple(c.contiguous() for c in ch), act


@pytest.mark.parametrize("halo,periodic", [(((0, 3), (0, 3)), True),
                                           (3, True), (((1, 2), (2, 1)), False),
                                           (9, False)])
def test_tiled_deposits_equal_simple_bitwise(dev, halo, periodic):
    """K2 (twice: repeatable) and K4 on a ragged 45 x 70 grid against the
    one-thread-per-node kernels; halo 9 is wider than a tile."""
    from picles_torch import Boundary, GridStats
    from picles_torch.ops.pic_cuda import pic_gather, pic_gather_padded

    nx, ny = 45, 70
    b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC
    stats = GridStats(nx=nx, ny=ny, bx=b, by=b)
    xr, yr, ch, act = _deposit_inputs(dev, nx, ny, halo, seed=7)
    o, st = pic_gather(xr, yr, ch, act, stats, halo)
    o2, _ = pic_gather(xr, yr, ch, act, stats, halo)
    s, st_s = pic_gather(xr, yr, ch, act, stats, halo, simple=True)
    _assert_bitwise(o, s)
    _assert_bitwise(o, o2)
    assert int(st.clamped) == int(st_s.clamped)
    po, _ = pic_gather_padded(xr, yr, ch, act, halo)
    ps, _ = pic_gather_padded(xr, yr, ch, act, halo, simple=True)
    _assert_bitwise((po,), (ps,))


def test_fused_tiled_equals_simple_bitwise(dev):
    """K6 on a ragged-tile 45^2 remesh case, three halos: node planes and
    every remesh output equal to the one-thread-per-node kernel's."""
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.pic_cuda import pic_gather_remesh

    m, _, core = _remesh_case(dev, 45, "wind_sea", True, seed=8)
    chans = TR.particle_to_node(*core[:3])
    sact = (core[6] & core[7]).contiguous()
    for halo in (((0, 3), (0, 3)), 3, ((1, 3), (0, 2))):
        nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact,
                                      m.grid.stats, halo, m.remesh_params,
                                      *core)
        nds, rms, _ = pic_gather_remesh(core[3], core[4], chans, sact,
                                        m.grid.stats, halo, m.remesh_params,
                                        *core, simple=True)
        _assert_bitwise((*nd, *rm), (*nds, *rms))


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_advance_equals_simple_bitwise(dev, method, adaptive):
    """K1 (the compiled tableaux, one particle per thread) on a ragged
    45 x 37 perturbed state against the previous kernel, for
    a wind constant in t and the time-cosine family, at t0 = 1200 s and
    2^19 s."""
    from picles_torch import TermFlags, constant_winds, time_cosine_winds
    from picles_torch.ops.advance_cuda import advance_cuda
    from picles_torch.ops.tsit5 import SolverConfig

    comps, active, g = _state(dev, n=45, seed=9)
    comps = tuple(c[:, :37].contiguous() for c in comps)
    active = active[:, :37].contiguous()
    xn, yn = g.x[:, :37].contiguous(), g.y[:, :37].contiguous()
    rng = np.random.default_rng(10)
    dt = torch.as_tensor(rng.uniform(10.0, 120.0, (45, 37)).astype(np.float32),
                         device=dev)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    cfg = SolverConfig(method=method, adaptive=adaptive)
    for winds in (constant_winds(10.0, 10.0),
                  time_cosine_winds(10.0, 5.0, 6 * 3600.0)):
        for t0 in (1200.0, 2.0 ** 19):
            t = torch.full_like(dt, t0)
            args = (winds, _consts(), TermFlags(), cfg, 600.0, comps, t, dt,
                    active, xn, yn, proj)
            want = advance_cuda(*args, simple=True)
            _assert_bitwise(advance_cuda(*args), want)


@pytest.mark.parametrize("wind,flags", [
    ("constant", "all"), ("half_domain", "all"), ("time_cosine", "all"),
    ("constant", "no direction"), ("time_cosine", "no input or peak shift")])
def test_auto_dt_equals_simple_bitwise(dev, wind, flags):
    """K3 (the fused reset, the wind's kind and the default flags compiled
    in; another flag set runs the generic instance) on a ragged 45 x 37
    state with a half-reset mask and NaN and +-Inf in lne and dt, on reset
    and unreset lanes, against the previous kernel followed by PyTorch's
    clamp and select, for both estimate orders and at t0 = 2^19 s."""
    from picles_torch import TermFlags
    from picles_torch.ops.advance_cuda import auto_dt_cuda

    comps, _, g = _state(dev, n=45, seed=13)
    comps = [c[:, :37].clone() for c in comps]
    reset, dt = _reset_inputs(dev, 45, 14)
    reset, dt = reset[:, :37].contiguous(), dt[:, :37].clone()
    for (i, j), v, r in (((4, 5), float("nan"), True),
                         ((7, 11), float("inf"), True),
                         ((8, 11), -float("inf"), False)):
        comps[0][i, j], reset[i, j] = v, r
    for (i, j), v, r in (((1, 1), float("nan"), True),
                         ((2, 2), float("inf"), False),
                         ((4, 4), -float("inf"), False)):
        dt[i, j], reset[i, j] = v, r
    xn, yn = g.x[:, :37].contiguous(), g.y[:, :37].contiguous()
    tf = {"all": TermFlags(), "no direction": TermFlags(direction=False),
          "no input or peak shift": TermFlags(input=False,
                                              peak_shift=False)}[flags]
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    for order in (3.0, 5.0):
        for t0 in (1800.0, 2.0 ** 19):
            t = torch.full_like(dt, t0)
            args = (_winds(wind, 45), _consts(), tf, t, tuple(comps), xn, yn,
                    proj, reset, dt, 1e-4, 600.0)
            want = auto_dt_cuda(*args, order=order, simple=True)
            got = auto_dt_cuda(*args, order=order)
            _assert_bitwise((got,), (want,))
            assert bool(torch.isnan(got[4, 5]) & torch.isnan(got[7, 11]))
            assert bool(torch.isinf(got[2, 2]) & torch.isinf(got[4, 4]))


def test_deposit_over_48kb_of_shared_memory(dev):
    """Halo 5 stages 56 KB a block, above the default 48 KB: the kernel sets
    the limit, the launch's cudaGetLastError is success (the wrapper raises
    on any other), nothing fails on the stream, and the result equals the
    baseline.  Halo 40 exceeds the 64 KB budget: strips of one dy and chunks
    of rows, equal too."""
    from picles_torch import Boundary, GridStats
    from picles_torch.ops.pic_cuda import pic_gather

    stats = GridStats(nx=40, ny=40, bx=Boundary.NONPERIODIC,
                      by=Boundary.NONPERIODIC)
    for halo, seed in ((5, 11), (40, 12)):
        xr, yr, ch, act = _deposit_inputs(dev, 40, 40, halo, seed=seed)
        o, _ = pic_gather(xr, yr, ch, act, stats, halo)
        torch.cuda.synchronize()
        _assert_bitwise(o, pic_gather(xr, yr, ch, act, stats, halo,
                                      simple=True)[0])


# ---------------------------------------------------------------------------
# gridded winds: the kernels' gridded instances
# ---------------------------------------------------------------------------

def _gridded(dev, n, cadence, t0, const=False):
    """A gridded record over the n^2 box (a 900 s or 400 s cadence, so the
    window [t0, t0 + 600] straddles frames; or constant (10, 10) m/s at 4
    grid spacings, whose interpolant is exact) and its kernel wind, planes
    of the window and the plain version's wind."""
    from picles_torch.forcing.winds import (GriddedWinds2D, Winds2D,
                                            gridded_kernel, pwl_winds)

    rng = np.random.default_rng(7)
    L = 2e3 * (n - 1)
    if const:
        u = np.full((30, n // 4 + 1, n // 4 + 1), 10.0, np.float32)
        v, dx = u.copy(), 8e3
    else:
        base = rng.uniform(6.0, 14.0, (60, 1, 1))
        u = (base + rng.standard_normal((60, 10, 10))).astype(np.float32)
        v = (0.5 * base + rng.standard_normal((60, 10, 10))).astype(np.float32)
        dx = L / 9
    gw = GriddedWinds2D(u_data=torch.as_tensor(u, device=dev),
                        v_data=torch.as_tensor(v, device=dev), x0=0.0, dx=dx,
                        y0=0.0, dy=dx, t0=0.0, dt=cadence, mode="wrap")
    B = gw.n_breakpoints(600.0)
    xx = torch.arange(n, device=dev, dtype=torch.float32) * 2e3
    X, Y = torch.meshgrid(xx, xx, indexing="ij")
    wf = gw.pallas_pwl_fields(X, Y, torch.tensor(t0, device=dev), 600.0)
    return Winds2D(u=gw.u, v=gw.v, kernel=gridded_kernel(B)), wf, \
        pwl_winds(wf)


@pytest.mark.parametrize("cadence", [900.0, 400.0, 200.0])
def test_gridded_kernels_match_plain(dev, cadence):
    """The gridded instances of K1 (fixed-substep at rtol 1e-5, adaptive by
    share of lanes as above), K3 (rtol 1e-5), K5 and K6 (as their analytic
    instances) against their plain versions over the same planes; B = 1, 2
    and 3 (the breakpoints past the kernels' register cache, ``GRID_REG_B``
    in rhs.cuh, are read through the planes at each evaluation).  Planes
    that are not views of one tensor are refused."""
    from picles_torch import TermFlags
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.advance_cuda import (advance_cuda, auto_dt_cuda,
                                               auto_dt_reset)
    from picles_torch.ops.pic_cuda import pic_gather, pic_gather_remesh
    from picles_torch.ops.remesh import remesh_core
    from picles_torch.ops.remesh_cuda import remesh_cuda
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    # B = 3 over [1500, 2100] s: over [500, 1100] s one ulp of a_u alone
    # moves more than 10% of the plain version's adaptive tsit5 lanes past
    # rtol 5e-3, over [1500, 2100] s under 1% (test_torch_gridded_winds.py
    # test_card_b3_window_is_not_a_knife_edge, on the CPU)
    n, t0 = 64, {900.0: 600.0, 400.0: 500.0, 200.0: 1500.0}[cadence]
    kw, wf, pw = _gridded(dev, n, cadence, t0)
    assert len(wf) == 4 + 3 * {900.0: 1, 400.0: 2, 200.0: 3}[cadence]
    comps, active, g = _state(dev, n=n, seed=3)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    aux = RHSParams(g.x, g.y, g.proj, g.pc)
    rhs = make_rhs(pw.u, pw.v, _consts(), TermFlags())
    t = torch.full_like(comps[0], t0)
    for method in ("bosh3", "tsit5"):
        for adaptive in (False, True):
            cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                               force_dtmin=True)
            dt = torch.full_like(t, 37.5 if not adaptive else 60.0)
            k = advance_cuda(kw, _consts(), TermFlags(), cfg, 600.0, comps, t,
                             dt, active, g.x, g.y, proj, wind_fields=wf)
            p = integrate_to(rhs, torch.stack(comps, -1), t, t + 600.0, dt,
                             aux, active, cfg)
            assert torch.equal(k.failed, p.failed)
            if adaptive:
                for i in range(5):
                    assert _share_close(k[i], p.z[..., i], 5e-3, 1e-4) >= 0.99
            else:
                for i in range(5):
                    torch.testing.assert_close(k[i], p.z[..., i], rtol=1e-5,
                                               atol=1e-6)
                assert torch.equal(k.naccept, p.naccept)
    reset, dt = _reset_inputs(dev, n, 2)
    k = auto_dt_cuda(kw, _consts(), TermFlags(), t, comps, g.x, g.y, proj,
                     reset, dt, 1e-4, 600.0, wind_fields=wf)
    p = auto_dt_reset(rhs, t, torch.stack(comps, -1), aux, reset, dt, 1e-4,
                      600.0)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0.0)
    nodir = TermFlags(direction=False)   # the generic gridded instance
    k = auto_dt_cuda(kw, _consts(), nodir, t, comps, g.x, g.y, proj, reset,
                     dt, 1e-4, 600.0, wind_fields=wf)
    p = auto_dt_reset(make_rhs(pw.u, pw.v, _consts(), nodir), t,
                      torch.stack(comps, -1), aux, reset, dt, 1e-4, 600.0)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0.0)
    m, node, core = _remesh_case(dev, n, "wind_sea", True, seed=5)
    core = core[:-1] + (torch.tensor(t0, device=dev),)
    rp = m.remesh_params._replace(winds=kw)
    k5 = remesh_cuda(rp, node, *core, wind_fields=wf)
    _assert_remesh(k5, remesh_core(rp._replace(winds=pw), node, *core), 4e-7)
    lne, cgx, cgy, px, py = core[:5]
    chans = TR.particle_to_node(lne, cgx, cgy)
    sact = (core[6] & core[7]).contiguous()
    halo = ((1, 3), (0, 2))
    nd, rm, _ = pic_gather_remesh(px, py, chans, sact, m.grid.stats, halo, rp,
                                  *core, wind_fields=wf)
    k2, _ = pic_gather(px, py, chans, sact, m.grid.stats, halo)
    k5 = remesh_cuda(rp, k2, *core, wind_fields=wf)
    for a, b in zip(nd, k2):
        assert torch.equal(a, b)
    for f in rm._fields:
        assert torch.equal(getattr(rm, f), getattr(k5, f)), f
    with pytest.raises(ValueError, match="no _simple baseline"):
        advance_cuda(kw, _consts(), TermFlags(), SolverConfig(), 600.0, comps,
                     t, dt, active, g.x, g.y, proj, wind_fields=wf,
                     simple=True)
    spaced = torch.zeros((2 * len(wf),) + tuple(t.shape), device=dev)
    spaced[::2] = torch.stack(wf)   # each plane contiguous, two apart
    with pytest.raises(ValueError, match="views of one"):
        advance_cuda(kw, _consts(), TermFlags(), SolverConfig(), 600.0, comps,
                     t, dt, active, g.x, g.y, proj,
                     wind_fields=spaced[::2].unbind(0))


def test_gridded_constant_record_equals_constant_wind_bitwise(dev):
    """A record constant at (10, 10) m/s in space and time has zero slopes,
    so its planes give u = 10 + t 0 = 10 exactly: K1, K3, K5 and K6's
    gridded instances equal their constant-wind instances bit for bit."""
    from picles_torch import TermFlags, constant_winds
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_cuda
    from picles_torch.ops.pic_cuda import pic_gather_remesh
    from picles_torch.ops.remesh_cuda import remesh_cuda
    from picles_torch.ops.tsit5 import SolverConfig

    n, t0 = 64, 1200.0
    kw, wf, _ = _gridded(dev, n, 900.0, t0, const=True)
    cw = constant_winds(10.0, 10.0)
    comps, active, g = _state(dev, n=n, seed=3)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    t = torch.full_like(comps[0], t0)
    for method in ("bosh3", "tsit5"):
        for adaptive in (False, True):
            cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                               force_dtmin=True)
            dt = torch.full_like(t, 60.0)
            a = advance_cuda(kw, _consts(), TermFlags(), cfg, 600.0, comps, t,
                             dt, active, g.x, g.y, proj, wind_fields=wf)
            b = advance_cuda(cw, _consts(), TermFlags(), cfg, 600.0, comps, t,
                             dt, active, g.x, g.y, proj)
            _assert_bitwise(a, b)
    reset, dt = _reset_inputs(dev, n, 2)
    _assert_bitwise(
        (auto_dt_cuda(kw, _consts(), TermFlags(), t, comps, g.x, g.y, proj,
                      reset, dt, 1e-4, 600.0, wind_fields=wf),),
        (auto_dt_cuda(cw, _consts(), TermFlags(), t, comps, g.x, g.y, proj,
                      reset, dt, 1e-4, 600.0),))
    m, node, core = _remesh_case(dev, n, "wind_sea", True, seed=5)
    rk, rc = m.remesh_params._replace(winds=kw), \
        m.remesh_params._replace(winds=cw)
    _assert_bitwise(remesh_cuda(rk, node, *core, wind_fields=wf),
                    remesh_cuda(rc, node, *core))
    chans = TR.particle_to_node(*core[:3])
    sact = (core[6] & core[7]).contiguous()
    a = pic_gather_remesh(core[3], core[4], chans, sact, m.grid.stats, 3, rk,
                          *core, wind_fields=wf)
    b = pic_gather_remesh(core[3], core[4], chans, sact, m.grid.stats, 3, rc,
                          *core)
    _assert_bitwise((*a[0], *a[1]), (*b[0], *b[1]))


# ---------------------------------------------------------------------------
# spherical and tripolar grids: projection planes in K1/K3, the seam in K2/K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halo", [((0, 3), (0, 3)), 3, ((2, 3), (1, 3))])
def test_tripolar_seam_deposits(dev, halo):
    """K2 on a tripolar grid (the window widened to max(lo, hi)) against
    scatter_dense's fold, displacements over the halo and past it: within
    rtol 1e-5 and 1e-6 of the channel's scale, two launches bitwise equal,
    the clamped count exact; K6 on the same grid equal to K2 + K5 bit for
    bit."""
    from picles_torch import Boundary, GridStats
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.pic import scatter_dense
    from picles_torch.ops.pic_cuda import pic_gather, pic_gather_remesh
    from picles_torch.ops.remesh_cuda import remesh_cuda

    nx, ny = 90, 61
    tri = GridStats(nx=nx, ny=ny, bx=Boundary.PERIODIC,
                    by=Boundary.TRIPOLAR_NORTH)
    xr, yr, ch, act = _deposit_inputs(dev, nx, ny, halo, seed=21)
    ch = tuple(torch.nan_to_num(c, nan=0.5, posinf=2.0) for c in ch)
    (o, st), (o2, _) = (pic_gather(xr, yr, ch, act, tri, halo)
                        for _ in range(2))
    S, st_p = scatter_dense(xr, yr, torch.stack(ch, -1), act, tri, halo)
    for c in range(3):
        torch.testing.assert_close(o[c], S[..., c], rtol=1e-5,
                                   atol=1e-6 * float(S[..., c].abs().max()))
    _assert_bitwise(o, o2)
    assert int(st.clamped) == int(st_p.clamped) > 0

    m, _, core = _remesh_case(dev, 64, "wind_sea", True, seed=22)
    tri64 = GridStats(nx=64, ny=64, bx=Boundary.PERIODIC,
                      by=Boundary.TRIPOLAR_NORTH)
    chans = TR.particle_to_node(*core[:3])
    sact = (core[6] & core[7]).contiguous()
    nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, tri64, halo,
                                  m.remesh_params, *core)
    k2, _ = pic_gather(core[3], core[4], chans, sact, tri64, halo)
    _assert_bitwise((*nd, *rm),
                    (*k2, *remesh_cuda(m.remesh_params, k2, *core)))


def _rotated_box(dev, n, angle):
    from picles_torch import cartesian_grid_2d

    return cartesian_grid_2d(0.0, 2e3 * (n - 1), n, 0.0, 2e3 * (n - 1), n,
                             angle=angle, periodic_boundary=(True, True),
                             device=dev)


@pytest.mark.parametrize("angle", [0.0, 30.0])
@pytest.mark.parametrize("flags", ["all", "no direction or peak shift"])
def test_projection_planes_equal_scalars_bitwise(dev, angle, flags):
    """A Cartesian box's projection given as per-node planes
    (``node_projection``) equals the same projection given as the 5 uniform
    scalars, bit for bit: K1 (bosh3 and tsit5, adaptive and fixed-substep)
    and K3, for a constant and a gridded wind; the box rotated by 30
    degrees has off-diagonal m01/m10, and the generic term flags run K3's
    generic instances."""
    from picles_torch import TermFlags, constant_winds
    from picles_torch.ops.advance_cuda import (advance_cuda, auto_dt_cuda,
                                               node_projection,
                                               uniform_projection)
    from picles_torch.ops.tsit5 import SolverConfig

    n, t0 = 64, 1200.0
    g = _rotated_box(dev, n, angle)
    scalars = uniform_projection(g.proj, g.pc)
    assert (scalars[1] != 0.0) == (angle != 0.0)
    planes = node_projection(g.proj, g.pc)
    tf = TermFlags() if flags == "all" else TermFlags(direction=False,
                                                      peak_shift=False)
    comps, active, _ = _state(dev, n=n, seed=3)
    t = torch.full_like(comps[0], t0)
    kw, wf, _ = _gridded(dev, n, 900.0, t0)
    before = advance_cuda.launches
    for winds, fields in ((constant_winds(10.0, 10.0), ()), (kw, wf)):
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cfg = SolverConfig(method=method, adaptive=adaptive,
                                   dtmin=1e-4, force_dtmin=True)
                dt = torch.full_like(t, 60.0)
                a, b = (advance_cuda(winds, _consts(), tf, cfg, 600.0, comps,
                                     t, dt, active, g.x, g.y, p,
                                     wind_fields=fields)
                        for p in (planes, scalars))
                _assert_bitwise(a, b)
        reset, dt = _reset_inputs(dev, n, 2)
        a, b = (auto_dt_cuda(winds, _consts(), tf, t, comps, g.x, g.y, p,
                             reset, dt, 1e-4, 600.0, wind_fields=fields)
                for p in (planes, scalars))
        _assert_bitwise((a,), (b,))
    assert advance_cuda.launches == before + 16
    with pytest.raises(ValueError, match="no _simple baseline"):
        advance_cuda(constant_winds(10.0, 10.0), _consts(), tf,
                     SolverConfig(), 600.0, comps, t, dt, active, g.x, g.y,
                     planes, simple=True)
    with pytest.raises(ValueError, match="one contiguous float32"):
        advance_cuda(constant_winds(10.0, 10.0), _consts(), tf,
                     SolverConfig(), 600.0, comps, t, dt, active, g.x, g.y,
                     planes[:, :, :32])


def _curved_grid(dev, kind, n=64):
    from picles_torch import spherical_grid_2d, synthetic_tripolar_grid

    if kind == "spherical":
        return spherical_grid_2d(0.0, 120.0, n, -60.0, 70.0, n,
                                 periodic_boundary=(True, False), device=dev)
    return synthetic_tripolar_grid(k=2, nx_super=2 * n, ny_super=2 * n,
                                   device=dev)


@pytest.mark.parametrize("kind", ["spherical", "tripolar"])
def test_projection_planes_match_plain(dev, kind):
    """K1 and K3 with a spherical or tripolar grid's per-node planes against
    their plain versions over the grid's ``proj`` and ``pc``: fixed
    substeps within rtol 1e-5, adaptive by share of lanes as above, K3
    within rtol 1e-5."""
    from picles_torch import TermFlags, constant_winds
    from picles_torch.ops.advance_cuda import (advance_cuda, auto_dt_cuda,
                                               auto_dt_reset, node_projection,
                                               uniform_projection)
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    n = 64
    g = _curved_grid(dev, kind, n)
    assert uniform_projection(g.proj, g.pc) is None
    planes = node_projection(g.proj, g.pc)
    comps, active, _ = _state(dev, n=n, seed=5)
    winds = constant_winds(10.0, 10.0)
    rhs = make_rhs(winds.u, winds.v, _consts(), TermFlags())
    aux = RHSParams(g.x, g.y, g.proj, g.pc)
    t = torch.full_like(comps[0], 1800.0)
    for method in ("bosh3", "tsit5"):
        for adaptive in (False, True):
            cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                               force_dtmin=True)
            dt = torch.full_like(t, 37.5 if not adaptive else 60.0)
            k = advance_cuda(winds, _consts(), TermFlags(), cfg, 600.0, comps,
                             t, dt, active, g.x, g.y, planes)
            p = integrate_to(rhs, torch.stack(comps, -1), t, t + 600.0, dt,
                             aux, active, cfg)
            assert torch.equal(k.failed, p.failed)
            for i in range(5):
                if adaptive:
                    assert _share_close(k[i], p.z[..., i], 5e-3, 1e-4) >= 0.99
                else:
                    torch.testing.assert_close(k[i], p.z[..., i], rtol=1e-5,
                                               atol=1e-6)
    reset, dt = _reset_inputs(dev, n, 6)
    k = auto_dt_cuda(winds, _consts(), TermFlags(), t, comps, g.x, g.y,
                     planes, reset, dt, 1e-4, 600.0)
    p = auto_dt_reset(rhs, t, torch.stack(comps, -1), aux, reset, dt, 1e-4,
                      600.0)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("kind", ["spherical", "tripolar"])
def test_curved_grid_model_on_card_matches_cpu(dev, kind):
    """WaveGrowth2D on a spherical (open in y) or tripolar grid: the kernel
    modes on the card (K1 with the planes, K2 with the seam, K3) against the
    plain versions on the CPU, 3 steps at abstol 1e-7 / reltol 1e-6, within
    5e-3 and 1e-6 of the state's scale, counters equal (the most substeps a
    lane took within 2); K1, K2 and K3 each launched once a step."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              constant_winds)
    from picles_torch.core import fetch_relations as FR
    from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_cuda
    from picles_torch.ops.pic_cuda import pic_gather

    ws = FR.MinimalWindsea(10.0, 10.0, 600.0)
    sett = ODESettings(log_energy_minimum=float(ws.lne), timestep=600.0,
                       dt=1e-3, dtmin=1e-4, force_dtmin=True, abstol=1e-7,
                       reltol=1e-6)
    cfg = WaveGrowth2DConfig(periodic_boundary=kind == "tripolar")

    def model(d):
        return WaveGrowth2D(_curved_grid(d, kind, 48),
                            constant_winds(8.0, 8.0), sett, config=cfg)

    mg, mc = model(dev), model("cpu")
    assert mg.resolved_config().scatter_mode == "dense_cuda"
    sg, sc = mg.init_state(), mc.init_state()
    before = (advance_cuda.launches, pic_gather.launches, auto_dt_cuda.launches)
    for _ in range(3):
        sg, sc = mg.step(sg), mc.step(sc)
    assert (advance_cuda.launches, pic_gather.launches,
            auto_dt_cuda.launches) == tuple(b + 3 for b in before)
    S = sc.state
    torch.testing.assert_close(sg.state.cpu(), S, rtol=5e-3,
                               atol=1e-6 * float(S.abs().max()))
    got, want = sg.metrics.as_dict(), sc.metrics.as_dict()
    assert abs(got.pop("substeps_max") - want.pop("substeps_max")) <= 2
    assert got == want and got["n_failed"] == 0


# ---------------------------------------------------------------------------
# the compiled drivers: a captured step replayed against the eager step
# ---------------------------------------------------------------------------

def _driven_model(dev, path, n=64):
    """The flagship (bosh3, carried dt, halo ((0,3),(0,3))) with each remesh
    ("xla", "pallas" with K5, "fused" with K6), the default configuration
    (tsit5, Hairer reset with K3, halo 3) and "xla-halo5" (the flagship at
    halo 5: K2 stages 56 KB a block, so its launch sets the kernel's shared
    memory limit inside the capture too) at n^2."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              cartesian_box, constant_winds)
    from picles_torch.core import fetch_relations as FR

    ws = FR.MinimalWindsea(10.0, 10.0, 600.0)
    sett = ODESettings(log_energy_minimum=float(ws.lne), timestep=600.0,
                       dt=1e-3, dtmin=1e-4, force_dtmin=True,
                       solver="tsit5" if path == "default" else "bosh3")
    cfg = WaveGrowth2DConfig(periodic_boundary=True)
    if path != "default":
        remesh, _, halo = path.partition("-halo")
        cfg = WaveGrowth2DConfig(periodic_boundary=True,
                                 dt_reset_mode="carry",
                                 halo=int(halo) if halo else ((0, 3), (0, 3)),
                                 remesh_mode=remesh)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett, config=cfg)


@pytest.mark.parametrize("path", ["xla", "pallas", "fused", "default",
                                  "xla-halo5"])
def test_graphed_drivers_equal_eager_steps_bitwise(dev, path):
    """One capture serves every driver: step_n_quiet over 1, 3 and 8 steps,
    step_n's stack row by row, a ragged step_n_buffered chunk (5 of 8 rows,
    the rest zero) and step_jit, each bit for bit the eager steps from the
    same state, every leaf (counters included); step_jit's results alias
    none of the capture's tensors, and applying it twice leaves the first
    result intact."""
    model = _driven_model(dev, path)
    assert model.graphed
    ms = model.step(model.init_state())
    eager = [ms]
    for _ in range(8):
        eager.append(model.step(eager[-1]))
    for n in (1, 3, 8):
        _assert_bitwise(model.step_n_quiet(ms, n).leaves(), eager[n].leaves())
    g = model._graph
    fin, stack = model.step_n(ms, 3)
    _assert_bitwise(fin.leaves(), eager[3].leaves())
    _assert_bitwise(stack, [e.state for e in eager[1:4]])
    fin, buf = model.step_n_buffered(ms, 5, 8)
    _assert_bitwise(fin.leaves(), eager[5].leaves())
    _assert_bitwise(buf[:5], [e.state for e in eager[1:6]])
    assert buf.shape[0] == 8 and not buf[5:].any()
    f = model.step_jit()
    s1 = f(ms)
    kept = s1.clone()
    s2 = f(s1)
    _assert_bitwise(s1.leaves(), kept.leaves())
    _assert_bitwise(s2.leaves(), eager[2].leaves())
    held = {t.data_ptr() for t in g.state.leaves() + g.out.leaves()}
    assert not held & {t.data_ptr() for t in s1.leaves() + s2.leaves()}
    assert model._graph is g   # captured once
    model.release_graph()
    assert model._graph is None


def test_graphed_simulation_run_chunks_equal_eager(dev):
    """Simulation.run with a CashStore in chunks of 3 over 8 steps (a
    ragged last chunk) and without a store: every frame and the end state
    bit for bit the eager steps."""
    from picles_torch import Simulation
    
    model = _driven_model(dev, "fused")
    ms = model.init_state()
    frames = [ms.state]
    for _ in range(8):
        ms = model.step(ms)
        frames.append(ms.state)
    sim = Simulation.create(model, stop_time=7 * 600.0)
    sim.run(cash_store=True, chunk_size=3)
    got = torch.as_tensor(sim.store.as_array())
    assert got.shape[0] == 9 and got.dtype == torch.float32
    _assert_bitwise([got[i] for i in range(9)], [f.cpu() for f in frames])
    quiet = Simulation.create(model, stop_time=7 * 600.0)
    quiet.run()
    _assert_bitwise(quiet.state.leaves(), ms.leaves())


def test_kernels_on_a_grid_past_the_tpu_vmem_limits(dev):
    """A 64 x 6000 grid, wider than the JAX package's kernels take in VMEM:
    K1 (adaptive) against integrate_to by its share rules and bit for bit
    its _simple baseline; K2 bit for bit its _simple baseline and within
    rtol 1e-5 of scatter_dense; K5 bit for bit remesh_core (values,
    branch bits, flags, dt and positions); K6 bit for bit K2 + K5 and its
    _simple baseline."""
    from picles_torch import (Boundary, GridStats, ODESettings, TermFlags,
                              WaveGrowth2D, WaveGrowth2DConfig, cartesian_box,
                              constant_winds, half_domain_winds)
    from picles_torch.core import fetch_relations as FR
    from picles_torch.ops.advance_cuda import advance_cuda
    from picles_torch.ops.pic import scatter_dense
    from picles_torch.ops.pic_cuda import pic_gather, pic_gather_remesh
    from picles_torch.ops.remesh import remesh_core
    from picles_torch.ops.remesh_cuda import remesh_cuda
    from picles_torch.ops.rhs import RHSParams, make_rhs
    from picles_torch.ops.transforms import particle_to_node
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    nx, ny = 64, 6000
    rng = np.random.default_rng(31)

    def f(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    grid = cartesian_box(2e3 * (nx - 1), nx, 2e3 * (ny - 1), ny,
                         periodic_boundary=(True, True), device=dev)
    ws = FR.get_initial_windsea(torch.full((nx, ny), 10.0, device=dev),
                                torch.full((nx, ny), 10.0, device=dev), 600.0)
    comps = tuple(c.contiguous() for c in (
        ws.lne + f(rng.normal(0, 0.05, (nx, ny))),
        ws.cg_bar_x * f(rng.uniform(0.95, 1.05, (nx, ny))),
        ws.cg_bar_y * f(rng.uniform(0.95, 1.05, (nx, ny))),
        f(rng.uniform(-0.3, 0.3, (nx, ny))),
        f(rng.uniform(-0.3, 0.3, (nx, ny)))))
    active = torch.as_tensor(rng.uniform(size=(nx, ny)) < 0.9, device=dev)
    winds = constant_winds(10.0, 10.0)
    cfg = SolverConfig(method="bosh3", adaptive=True, dtmin=1e-4,
                       force_dtmin=True)
    t = torch.full_like(comps[0], 1200.0)
    dt = f(rng.uniform(10.0, 120.0, (nx, ny)))
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    args = (winds, _consts(), TermFlags(), cfg, 600.0, comps, t, dt, active,
            grid.x, grid.y, proj)
    k = advance_cuda(*args)
    _assert_bitwise(k, advance_cuda(*args, simple=True))
    p = integrate_to(make_rhs(winds.u, winds.v, _consts(), TermFlags()),
                     torch.stack(comps, -1), t, t + 600.0, dt,
                     RHSParams(grid.x, grid.y, grid.proj, grid.pc), active,
                     cfg)
    assert torch.equal(k.failed, p.failed)
    for i in range(5):
        assert _share_close(k[i], p.z[..., i], 5e-3, 1e-4) >= 0.99, i
    a = active & ~p.failed
    assert float((k.naccept[a] == p.naccept[a]).float().mean()) >= 0.95

    for halo, periodic in ((((0, 3), (0, 3)), True), (3, False)):
        b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC
        stats = GridStats(nx=nx, ny=ny, bx=b, by=b)
        xr, yr, ch, act = _deposit_inputs(dev, nx, ny, halo, seed=32)
        ch = tuple(torch.nan_to_num(c, nan=0.0, posinf=0.0) for c in ch)
        o, _ = pic_gather(xr, yr, ch, act, stats, halo)
        _assert_bitwise(o, pic_gather(xr, yr, ch, act, stats, halo,
                                      simple=True)[0])
        S, _ = scatter_dense(xr, yr, torch.stack(ch, -1), act, stats, halo)
        for c in range(3):
            torch.testing.assert_close(o[c], S[..., c], rtol=1e-5,
                                       atol=1e-6 * float(S[..., c].abs().max()))

    m = WaveGrowth2D(cartesian_box(2e3 * (nx - 1), nx, 2e3 * (ny - 1), ny,
                                   device=dev),
                     half_domain_winds(10.0, 5.0, 1e3 * (nx - 1)),
                     ODESettings(timestep=600.0, dt=37.5, solver="bosh3"),
                     config=WaveGrowth2DConfig(periodic_boundary=False,
                                               dt_reset_mode="carry",
                                               remesh_mode="pallas"))
    low = f(np.where(rng.uniform(size=(nx, ny)) < 0.3,
                     rng.uniform(0, 1e-4, (nx, ny)), 1.0))
    node = tuple((c * low).contiguous() for c in particle_to_node(*comps[:3]))
    core = (*comps, f(np.exp(rng.uniform(np.log(1e-6), np.log(3000.0),
                                         (nx, ny)))),
            torch.as_tensor(rng.uniform(size=(nx, ny)) < 0.8, device=dev),
            m.active_mask.contiguous(), m.boundary_mask.contiguous(),
            m.grid.x, m.grid.y, torch.tensor(1800.0, device=dev))
    k5 = remesh_cuda(m.remesh_params, node, *core)
    _assert_bitwise(k5, remesh_core(m.remesh_params, node, *core))
    for bit in (1, 2, 4):
        assert int(((k5.branch & bit) != 0).sum()) > 0, bit
    chans = particle_to_node(*comps[:3])
    sact = (core[6] & core[7]).contiguous()
    halo = ((1, 3), (0, 2))
    nd, rm, _ = pic_gather_remesh(comps[3], comps[4], chans, sact,
                                  m.grid.stats, halo, m.remesh_params, *core)
    nds, rms, _ = pic_gather_remesh(comps[3], comps[4], chans, sact,
                                    m.grid.stats, halo, m.remesh_params,
                                    *core, simple=True)
    _assert_bitwise((*nd, *rm), (*nds, *rms))
    k2, _ = pic_gather(comps[3], comps[4], chans, sact, m.grid.stats, halo)
    _assert_bitwise((*nd, *rm),
                    (*k2, *remesh_cuda(m.remesh_params, k2, *core)))


# ---------------------------------------------------------------------------
# layers: one launch of each kernel for every layer
# ---------------------------------------------------------------------------

def test_layered_kernels_equal_single_layer_launches_bitwise(dev):
    """Each kernel launched once over 3 layers at 64^2 equals its three
    single-layer launches bit for bit, in every instance (constant,
    time-cosine and gridded winds of B = 1 and 3, projection planes,
    periodic, open and tripolar deposits, the padded one, the remesh alone
    and fused), and its plain version over the layered inputs
    (``chip_smoke.layer_kernel_checks``, which its phase "layer-kernels"
    runs at 256^2)."""
    err = _chip_smoke().layer_kernel_checks(dev, n=64, L=3)
    assert set(err) == {"K1", "K2", "K3", "K4", "K5", "K6"}


def _chip_smoke():
    """The repo root's ``chip_smoke`` module (its checks and seeds)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("path", ["xla", "pallas", "fused", "default"])
def test_layered_step_equals_single_layer_steps_bitwise(dev, path):
    """Three swell systems at 64^2: each layer of 3 layered steps (each
    kernel launched once a step) bit for bit 3 steps of the single-layer
    model seeded alike, and the graphed drivers' replays bit for bit the
    eager layered steps."""
    import dataclasses

    from picles_torch import WaveGrowth2D
    from picles_torch.models.wave_growth_2d import layer_of
    from picles_torch.ops.advance_cuda import advance_cuda

    one = _driven_model(dev, path)
    model = WaveGrowth2D(one.grid, one.winds, one.settings,
                         config=dataclasses.replace(one.config, layers=3))
    d = _chip_smoke().swell_defaults(3)
    lay = model.as_layered(d)
    assert lay.graphed
    ms0 = lay.init_state()
    eager = [ms0]
    before = advance_cuda.launches
    for _ in range(3):
        eager.append(lay.step(eager[-1]))
    assert advance_cuda.launches == before + 3
    for k in range(3):
        s = one.init_state(defaults=d[k])
        for _ in range(3):
            s = one.step(s)
        _assert_bitwise(layer_of(eager[-1], k).leaves(), s.leaves())
    for n in (1, 3):
        _assert_bitwise(lay.step_n_quiet(ms0, n).leaves(), eager[n].leaves())
    assert eager[-1].metrics.n_failed.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# the sharded step on a tripolar grid, and the 1D model, on the card
# ---------------------------------------------------------------------------


def _scaled_tripolar_model(dev, **cfg):
    """The scaled synthetic tripolar grid of tests/_torch_sharded_worker.py
    (32 x 24 nodes, metrics over 100, land on the top row) on ``dev``
    under a northward wind, halo 3, the carried dt and the K5 remesh, at
    abstol 1e-7 / reltol 1e-6."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              constant_winds, mom6_grid_from_supergrid)
    from picles_torch.grids.tripolar import synthetic_tripolar_supergrid

    X, Y, dx, dy, area, ang = synthetic_tripolar_supergrid()
    s = 1.0 / 100.0
    mask = np.ones((32, 24), dtype=bool)
    mask[[5, 6, 20], -1] = False
    grid = mom6_grid_from_supergrid(X, Y, dx * s, dy * s, area * s * s, ang,
                                    k=2, device=dev, mask=mask)
    kw = dict(dt_reset_mode="carry", remesh_mode="pallas", halo=3)
    kw.update(cfg)
    return WaveGrowth2D(grid, constant_winds(2.0, 10.0),
                        ODESettings(timestep=600.0, dt=1e-3, abstol=1e-7,
                                    reltol=1e-6),
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  **kw))


def test_sharded_tripolar_nccl_one_rank_matches_single_device(dev):
    """The scaled tripolar grid through ShardedWaveGrowth2D on a (1, 1)
    NCCL mesh (K1 with projection planes -> K4 -> the self-wrap and seam
    folds -> K5), 4 steps: within rtol 2e-3 of the single-device step, the
    counters equal; with the plain deposit on both sides, bit for bit."""
    import socket

    import torch.distributed as dist

    from picles_torch.ops.pic_cuda import pic_gather_padded
    from picles_torch.parallel.sharded import (ShardedWaveGrowth2D,
                                               init_distributed, make_mesh)

    model = _scaled_tripolar_model(dev)
    assert model.uniform_proj is None
    ref = model.step_n_quiet(model.init_state(), 4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, "nccl", port, timeout_s=60.0)
    try:
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        before = pic_gather_padded.launches
        ms = sh.step_n_quiet(sh.init_state(), 4)
        assert pic_gather_padded.launches == before + 4
        torch.testing.assert_close(ms.state, ref.state, rtol=2e-3,
                                   atol=1e-10)
        got, want = ms.metrics.as_dict(), ref.metrics.as_dict()
        for k in ("n_active", "n_gather", "n_failed", "n_clamped"):
            assert got[k] == want[k], k
        plain = _scaled_tripolar_model(dev, scatter_mode="dense")
        shp = ShardedWaveGrowth2D(plain, make_mesh((1, 1)))
        a, b = shp.init_state(), plain.init_state()
        for _ in range(4):
            a, b = shp.step(a), plain.step(b)
        _assert_bitwise(a.leaves(), b.leaves())
    finally:
        dist.destroy_process_group()


def _b01_model(device, **tols):
    from picles_torch import (ODESettings, WaveGrowth1D, WaveGrowth1DConfig,
                              constant_winds_1d, one_d_grid)

    return WaveGrowth1D(one_d_grid(0.0, 500e3, 31, device=device),
                        constant_winds_1d(10.0),
                        ODESettings(timestep=600.0, dt=1e-3, **tols),
                        config=WaveGrowth1DConfig(periodic_boundary=False))


def test_model_1d_on_card_matches_cpu_and_repeats(dev):
    """The B01 grid at abstol 1e-7 / reltol 1e-6, 12 steps on the card:
    within 1e-4 of the CPU run's scale, ``on`` and the counters equal (the
    most substeps of a lane within 2), and a second card run bit for bit
    the first (the deposit sums without atomics)."""
    tols = dict(abstol=1e-7, reltol=1e-6)
    mg, mc = _b01_model(dev, **tols), _b01_model("cpu", **tols)
    assert not mg.graphed
    a, _ = mg.step_n(mg.init_state(), 12)
    b, _ = mc.step_n(mc.init_state(), 12)
    scale = float(b.state.abs().max())
    torch.testing.assert_close(a.state.cpu(), b.state, rtol=0,
                               atol=1e-4 * scale)
    assert torch.equal(a.particles.on.cpu(), b.particles.on)
    ga, gb = a.metrics.as_dict(), b.metrics.as_dict()
    assert abs(ga.pop("substeps_max") - gb.pop("substeps_max")) <= 2
    assert ga == gb
    again, _ = mg.step_n(mg.init_state(), 12)
    _assert_bitwise(again.leaves(), a.leaves())


@pytest.mark.parametrize("periodic", [True, False])
def test_deposit_1d_on_card_is_deterministic(dev, periodic):
    """The sign-merge deposit of 2^16 random lanes over 512 nodes on the
    card: two runs bit for bit, within 1e-6 of the CPU's per-node scale."""
    from picles_torch.ops.pic import scatter_1d_merge

    rng = np.random.default_rng(3)
    n, nx, dx = 2 ** 16, 512, 1000.0
    x = rng.uniform(-50e3, 560e3, n).astype(np.float32)
    ch = np.stack([rng.uniform(0.1, 1.0, n),
                   np.where(rng.random(n) < 0.5, -1.0, 1.0)
                   * rng.uniform(0.01, 0.1, n), np.zeros(n)],
                  axis=-1).astype(np.float32)
    act = rng.random(n) > 0.1
    args = [torch.as_tensor(a) for a in (x, ch, act)]
    cpu = scatter_1d_merge(*args, 0.0, dx, nx, periodic)
    g1 = scatter_1d_merge(*(a.to(dev) for a in args), 0.0, dx, nx, periodic)
    g2 = scatter_1d_merge(*(a.to(dev) for a in args), 0.0, dx, nx, periodic)
    assert torch.equal(g1, g2)
    torch.testing.assert_close(g1.cpu(), cpu, rtol=0,
                               atol=1e-6 * float(cpu.abs().max()))
