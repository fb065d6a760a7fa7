"""The CUDA kernels K1-K6 against their plain PyTorch versions on a card,
K1, K2, K3, K4 and K6 bit for bit against their ``_simple`` baselines (the
kernels they replaced; K3's followed by PyTorch's clamp and select), a
fused Simulation resumed from a checkpoint, the sharded step on a (1, 1)
NCCL mesh (on a tripolar grid too), the spherical and tripolar grids:
K1/K3 with per-node projection planes (bit for bit the scalars on a
Cartesian box) and K2/K6 with the tripolar seam; kernel K7 (the 1D
advance) against its plain version, the graphed 1D model against its
eager K7 steps and against the CPU, its deposit deterministic; the (1, 1)
NCCL sharded step graphed against its eager steps; and a
steady wind callable (the node kind of K1, K3, K5 and K6) bit for bit the
constant winds and a constant record; a callable that reads its time (the
traced kind: its emitted function, and K1, K3, K5 and K6 each against its
plain version; the pulse on a tripolar grid bit for bit the constant
winds); K7's traced kind (a 1D callable that reads its time: its emitted
function, K7 against its plain version, the graphed 1D step) and K7 bit
for bit its ``_simple`` baseline in every kind; float64 (K1-K6's double
instances; the traced kind's double instances of K1, K3, K5 and K6 and
K7's in every kind against their float64 plain versions, the emitted
double functions, the graphed float64 1D model, the card against the
CPU; ``time_cosine_winds`` dividing as IEEE division, and a float64
steady callable's node planes kept in float64); the port's recorder on a
graphed member-day under a profiler (its replays and marks of the card's
timeline, no device operation added).  Marked
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
    from picles_torch.models.drivers import WARMUP_STEPS
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
        assert model.graphed and sh.graphed   # replays a graph over NCCL
        before = pic_gather_padded.launches
        ms = sh.step_n_quiet(sh.init_state(), 3)
        # the warm-up steps and the capture call K4; replays do not
        assert pic_gather_padded.launches == before + WARMUP_STEPS + 1
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


def _profiled_day(model, member, steps, logdir):
    """One member-day of ``steps`` steps through ``Simulation.run`` under
    ``profile_trace``; (final state, the trace's device events)."""
    from picles_torch import Simulation
    from picles_torch.utils import diagnostics as diag

    sim = Simulation(model=model, dt=600.0, stop_time=(steps - 0.5) * 600.0,
                     state=member, initialized=True)
    with diag.profile_trace(logdir) as prof:
        sim.run()
    cuda = torch.autograd.DeviceType.CUDA
    return sim.state, [e for e in prof.events()
                       if e.device_type == cuda and "spin_kernel" not in
                       e.name]


def test_profiled_graphed_day_records_replays_and_adds_no_device_op(
        dev, monkeypatch, tmp_path):
    """The port's recorder on a graphed member-day of 12 steps at 64^2:
    the capture records ``drivers.capture`` with ``drivers.warmup`` inside;
    under a profiler the day records 12 ``drivers.replay`` spans and five
    marks of the card's timeline (before the copy in, before the first
    replay, after it, after the last, after the clone out), in order on
    the card; its final state is bit for bit an untraced day's;
    the profiler's device operations are the same in number with the run
    tier on and with its predicate replaced to off (12 K1 launches each),
    and none carries a span's name."""
    from picles_torch import Simulation
    from picles_torch.utils import diagnostics as diag

    tr = diag.Tracer()
    monkeypatch.setattr(diag, "_TRACER", tr)
    model = _driven_model(dev, "fused")
    member = model.init_state()
    steps = 12
    plain = Simulation(model=model, dt=600.0,
                       stop_time=(steps - 0.5) * 600.0, state=member,
                       initialized=True)
    plain.run()
    cap, warm = tr.once
    assert (cap.name, warm.name) == ("drivers.capture", "drivers.warmup")
    assert warm.parent == cap.id and not tr.runs
    assert cap.start_ns < warm.start_ns < warm.end_ns < cap.end_ns
    assert tr.counts == {"drivers.captures": 1, "drivers.replays": steps}
    on, dev_on = _profiled_day(model, member, steps, str(tmp_path / "on"))
    _assert_bitwise(on.leaves(), plain.state.leaves())
    (run,) = tr.runs
    assert run.profiled
    replays = [s for s in run.spans if s.name == "drivers.replay"]
    assert [s.step for s in replays] == list(range(steps))
    assert len({id(e) for _, _, e in run.marks}) == len(run.marks) == 5
    marks = tr.snapshot()["runs"][0]["device"]
    assert [(p["name"], p["step"]) for p in marks] == [
        ("drivers.copy_in", None), ("drivers.replay", 0),
        ("drivers.replay", 1), ("drivers.replay", steps),
        ("drivers.done", None)]
    for p, q in zip(marks, marks[1:]):
        assert p["ms"] < q["ms"]
    monkeypatch.setattr(diag, "tracing", lambda: False)
    off, dev_off = _profiled_day(model, member, steps, str(tmp_path / "off"))
    _assert_bitwise(off.leaves(), plain.state.leaves())
    assert len(tr.runs) == 1
    k1 = [sum("advance_kernel<" in e.name for e in d)
          for d in (dev_on, dev_off)]
    assert k1 == [steps, steps]
    assert len(dev_on) == len(dev_off)
    names = {s.name for s in run.spans}
    assert not any(e.name in names for e in dev_on)
    assert tr.counts["drivers.replays"] == 3 * steps


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

    from picles_torch.models.drivers import WARMUP_STEPS
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
        assert sh.graphed
        before = pic_gather_padded.launches
        ms = sh.step_n_quiet(sh.init_state(), 4)
        assert pic_gather_padded.launches == before + WARMUP_STEPS + 1
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


def _b01_model(device, nx=31, **tols):
    from picles_torch import (ODESettings, WaveGrowth1D, WaveGrowth1DConfig,
                              constant_winds_1d, one_d_grid)

    return WaveGrowth1D(one_d_grid(0.0, 500e3, nx, device=device),
                        constant_winds_1d(10.0),
                        ODESettings(timestep=600.0, dt=1e-3, **tols),
                        config=WaveGrowth1DConfig(periodic_boundary=False))


def test_model_1d_on_card_matches_cpu_and_repeats(dev):
    """The B01 grid at abstol 1e-7 / reltol 1e-6, 12 steps on the card
    (kernel K7, graphed) against the CPU (the plain advance, eager): within
    1e-4 of the CPU run's scale, ``on`` and the counters equal (the most
    substeps of a lane within 2), and a second card run bit for bit the
    first (the deposit sums without atomics)."""
    tols = dict(abstol=1e-7, reltol=1e-6)
    mg, mc = _b01_model(dev, **tols), _b01_model("cpu", **tols)
    assert mg.graphed and mg.advance_mode == "cuda"
    assert not mc.graphed and mc.advance_mode == "torch"
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


def test_model_1d_on_card_runs_the_plain_advance_only_when_asked(dev):
    """On the card a wind callable that reads its time runs on K7's traced
    kind, graphed, without being asked (6 graphed steps bit for bit 6
    eager ones, K7 traced once an eager step); a callable the tracer
    refuses (``float(t)``) raises, naming ``advance_mode="torch"``; a
    float64 config runs on K7's double instances, graphed (the callable
    traced in float64); with ``advance_mode="torch"`` the plain advance
    runs eagerly
    (``graphed`` false, K7 never launched), 6 steps within 1e-4 of the CPU
    run's scale at abstol 1e-7 / reltol 1e-6, ``on`` equal."""
    from picles_torch import (ODESettings, WaveGrowth1D, WaveGrowth1DConfig,
                              WindKind, Winds1D, one_d_grid)
    from picles_torch.ops.advance_cuda import advance_1d

    def timed(x, t):
        return torch.full_like(x, 10.0) + 0.0 * t

    def host(x, t):
        return torch.full_like(x, 10.0 + float(t))

    sett = ODESettings(timestep=600.0, dt=1e-3, abstol=1e-7, reltol=1e-6)
    grid = one_d_grid(0.0, 500e3, 31, device=dev)
    open_ = WaveGrowth1DConfig(periodic_boundary=False)
    k7 = WaveGrowth1D(grid, Winds1D(u=timed), sett, config=open_)
    assert (k7.advance_mode, k7.graphed) == ("cuda", True)
    assert k7._traced.kind == WindKind.TRACED
    before = (advance_1d.launches, advance_1d.traced_launches)
    eager = k7.init_state()
    for _ in range(6):
        eager = k7.step(eager)
    assert (advance_1d.launches, advance_1d.traced_launches) == \
        (before[0], before[1] + 6)
    _assert_bitwise(k7.step_n_quiet(k7.init_state(), 6).leaves(),
                    eager.leaves())
    with pytest.raises(NotImplementedError, match='advance_mode="torch"'):
        WaveGrowth1D(grid, Winds1D(u=host), sett, config=open_)
    f64 = WaveGrowth1D(one_d_grid(0.0, 500e3, 31, device=dev,
                                  dtype=torch.float64), Winds1D(u=timed),
                       sett, config=WaveGrowth1DConfig(
                           periodic_boundary=False, dtype=torch.float64))
    assert (f64.advance_mode, f64.graphed) == ("cuda", True)
    assert f64._traced.traced.dtype == torch.float64
    before = advance_1d.traced_f64_launches
    f64.step(f64.init_state())
    assert advance_1d.traced_f64_launches == before + 1
    mg = WaveGrowth1D(grid, Winds1D(u=timed), sett, config=open_,
                      advance_mode="torch")
    mc = WaveGrowth1D(one_d_grid(0.0, 500e3, 31, device="cpu"),
                      Winds1D(u=timed), sett, config=open_)
    assert (mg.advance_mode, mg.graphed) == ("torch", False)
    before = (advance_1d.launches, advance_1d.traced_launches)
    a = mg.step_n_quiet(mg.init_state(), 6)
    b = mc.step_n_quiet(mc.init_state(), 6)
    assert (advance_1d.launches, advance_1d.traced_launches) == before
    torch.testing.assert_close(a.state.cpu(), b.state, rtol=0,
                               atol=1e-4 * float(b.state.abs().max()))
    assert torch.equal(a.particles.on.cpu(), b.particles.on)


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


# ---------------------------------------------------------------------------
# K7, the 1D advance, and the graphed 1D step
# ---------------------------------------------------------------------------

def _k7_inputs(dev, nx=1024, steps=12):
    """The B01 configuration on ``nx`` nodes after ``steps`` plain steps on
    the CPU (young seas up the fetch, older ones down it), its particles,
    active lanes and node x on the card."""
    m = _b01_model("cpu", nx=nx)
    ms = m.step_n_quiet(m.init_state(), steps)
    P = ms.particles
    adv = P.on & ~m.boundary_mask
    return m, [a.to(dev).contiguous() for a in (P.z, P.t, P.dt, adv,
                                                 m.grid.x)]


def _storm(x, t):
    """The moving storm (``slopped_blob``) over B01's 500 km."""
    from picles_torch.forcing.winds import slopped_blob

    return slopped_blob(x, t, 15.0, 10.0, 6 * 3600.0, 80e3, 7200.0,
                        x0=100e3)


def _k7_wind(kind, dev, x):
    """K7's wind and its plain version's callable: a node plane (a smooth
    profile), a record that varies in x and t (30 half-hourly frames), or
    the storm traced (K7's traced kind, a library of its own)."""
    from picles_torch import GriddedWinds1D, Winds1D
    from picles_torch.forcing.winds import traced_kernel_1d

    if kind == "traced":
        w = Winds1D(u=_storm)
        return traced_kernel_1d(w, dev), w
    if kind == "node":
        plane = (7.0 + 3.0 * torch.sin(x / 80e3)).to(torch.float32)
        return plane.contiguous(), Winds1D(u=lambda xx, t: plane)
    rng = np.random.default_rng(9)
    rec = GriddedWinds1D(u_data=torch.as_tensor(
        rng.uniform(6.0, 12.0, (23, 30)).astype(np.float32), device=dev),
        x0=-10e3, dx=25e3, t0=0.0, dt=1800.0)
    return rec, rec.as_winds()


def _k7_pair(dev, method, kind, adaptive, fixed_dt=20.0):
    from picles_torch import TermFlags
    from picles_torch.ops.advance_cuda import advance_1d
    from picles_torch.ops.rhs import particle_equations_1d
    from picles_torch.ops.tsit5 import SolverConfig, integrate_to

    m, (z, t, dt, adv, x) = _k7_inputs(dev)
    wind, winds = _k7_wind(kind, dev, x)
    cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                       force_dtmin=True)
    if not adaptive:
        dt = torch.full_like(dt, fixed_dt)
    before = advance_1d.launches + advance_1d.traced_launches
    k = advance_1d(wind, m.consts, TermFlags(), cfg, 600.0, z, t, dt, adv, x)
    assert advance_1d.launches + advance_1d.traced_launches == before + 1
    s = advance_1d(wind, m.consts, TermFlags(), cfg, 600.0, z, t, dt, adv, x,
                   simple=True)
    assert advance_1d.launches + advance_1d.traced_launches == before + 1
    _assert_bitwise(k, s)
    rhs = particle_equations_1d(winds.u, gamma=m.constants.gamma,
                                params=m.params, constants=m.constants)
    p = integrate_to(rhs, z, t, t + 600.0, dt, x, adv, cfg)
    return k, p, adv


@pytest.mark.parametrize("kind", ["node", "gridded", "traced"])
@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_advance_1d_kernel_matches_plain_fixed_substep(dev, method, kind):
    """Bit for bit its ``_simple`` baseline; fixed substeps of 20 s: lne and cg_x within 5e-6 abs, x (absolute,
    in meters: an ulp at 500 km is 0.03 m) within rtol 1e-6; t, dt, failed
    and naccept equal.  (At 37.5 s an ulp grew to 4e-4 on the youngest
    lane under the record's wind, on the card and in a host build of K7
    against the CPU's plain version alike: the plain version parts from
    itself as far under a one-ulp change of its input; chip_smoke.py
    ``k7_witness``.)"""
    k, p, _ = _k7_pair(dev, method, kind, adaptive=False)
    torch.testing.assert_close(k.z[:, :2], p.z[:, :2], rtol=0, atol=5e-6)
    torch.testing.assert_close(k.z[:, 2], p.z[:, 2], rtol=1e-6, atol=0)
    for a, b in ((k.t, p.t), (k.dt, p.dt), (k.failed, p.failed),
                 (k.naccept, p.naccept)):
        assert torch.equal(a, b)
    assert int(k.naccept.max()) == 30


@pytest.mark.parametrize("kind", ["node", "gridded", "traced"])
@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_advance_1d_kernel_matches_plain_adaptive(dev, method, kind):
    """Bit for bit its ``_simple`` baseline; adaptive, as K1 is held
    (``test_advance_kernel_matches_plain_adaptive``): under 1% of the lanes
    beyond rtol 5e-3 in any component; at least 95%
    of the active lanes take as many substeps; the mean of log(dt_kernel /
    dt_plain) within 1e-2 of 0; ``failed`` and the end time equal."""
    k, p, adv = _k7_pair(dev, method, kind, adaptive=True)
    assert torch.equal(k.failed, p.failed)
    torch.testing.assert_close(k.t, p.t, rtol=1e-6, atol=0.0)
    for c in range(3):
        assert _share_close(k.z[:, c], p.z[:, c], 5e-3, 1e-4) >= 0.99, c
    a = adv & ~p.failed
    assert float((k.naccept[a] == p.naccept[a]).float().mean()) >= 0.95
    bias = float(torch.log(k.dt[a].double() / p.dt[a].double()).mean())
    assert abs(bias) <= 1e-2, bias
    assert int(p.naccept.max()) > 1


def test_traced_probe_1d_matches_the_callable(dev):
    """Each emitted ``traced_wind_1d`` alone (``picles_traced_probe_1d``)
    bit for bit its callable run by torch on the card (the storm and the
    1D pulse), at the switch times too (``chip_smoke.py``
    ``traced_probe_1d_check``)."""
    cs = _chip_smoke()
    winds = cs.traced_1d_callables()
    kerns, _ = cs.traced_1d_build(dev, winds)
    ops = cs.traced_probe_1d_check(dev, winds, kerns, 1 << 16)
    assert all(v > 0 for v in ops.values())


def test_advance_1d_refuses_cpu_tensors():
    from picles_torch import TermFlags
    from picles_torch.ops.advance_cuda import advance_1d
    from picles_torch.ops.rhs import make_rhs_consts
    from picles_torch.ops.tsit5 import SolverConfig

    n = 8
    z = torch.zeros((n, 3))
    v = torch.zeros(n)
    with pytest.raises(ValueError, match="not a CUDA device"):
        advance_1d(v, make_rhs_consts(), TermFlags(), SolverConfig(), 600.0,
                   z, v, v, torch.ones(n, dtype=torch.bool), v)


@pytest.mark.parametrize("kind", ["node", "gridded", "traced"])
def test_graphed_1d_step_equals_eager_k7_steps_bitwise(dev, kind):
    """The B01 model on the card (K7, graphed; the traced kind under the
    storm, a callable the model traces itself): step_n_quiet, step_n's
    rows, a ragged step_n_buffered chunk and step_jit twice, bit for bit
    the eager K7 steps over 12 steps."""
    from picles_torch import (ODESettings, WaveGrowth1D, WaveGrowth1DConfig,
                              Winds1D, constant_winds_1d, one_d_grid)

    grid = one_d_grid(0.0, 500e3, 31, device=dev)
    winds = (constant_winds_1d(10.0) if kind == "node"
             else Winds1D(u=_storm) if kind == "traced"
             else _k7_wind("gridded", dev, grid.x)[0])
    m = WaveGrowth1D(grid, winds, ODESettings(timestep=600.0, dt=1e-3),
                     config=WaveGrowth1DConfig(periodic_boundary=False))
    assert m.graphed and m.advance_mode == "cuda"
    ms = m.init_state()
    eager = [ms]
    for _ in range(12):
        eager.append(m.step(eager[-1]))
    _assert_bitwise(m.step_n_quiet(ms, 12).leaves(), eager[-1].leaves())
    fin, stack = m.step_n(ms, 12)
    _assert_bitwise(fin.leaves(), eager[-1].leaves())
    _assert_bitwise(list(stack), [e.state for e in eager[1:]])
    fin, buf = m.step_n_buffered(ms, 5, 8)
    _assert_bitwise(list(buf[:5]), [e.state for e in eager[1:6]])
    assert not bool(buf[5:].any())
    f = m.step_jit()
    s1 = f(ms)
    kept = s1.clone()
    s2 = f(s1)
    _assert_bitwise(s1.leaves(), kept.leaves())
    _assert_bitwise(s2.leaves(), eager[2].leaves())
    assert int(eager[-1].metrics.n_failed) == 0


@pytest.mark.parametrize("path", ["pallas", "default"])
def test_sharded_nccl_graphed_step_equals_eager_steps_bitwise(dev, path):
    """The (1, 1) NCCL sharded step at 64^2 graphed (the flagship's
    "pallas" remesh: K1, K4, the fold, K5, the counters' all-reduces; the
    default configuration with K3): step_n_quiet, step_n's rows and
    step_jit bit for bit its eager steps over 5 steps."""
    import socket

    import torch.distributed as dist

    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              cartesian_box, constant_winds)
    from picles_torch.parallel.sharded import (ShardedWaveGrowth2D,
                                               init_distributed, make_mesh)

    n = 64
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    if path == "pallas":
        sett = ODESettings(timestep=600.0, dt=1e-3, solver="bosh3")
        cfg = WaveGrowth2DConfig(dt_reset_mode="carry", remesh_mode="pallas",
                                 halo=((0, 3), (0, 3)))
    else:
        sett = ODESettings(timestep=600.0, dt=1e-3)
        cfg = WaveGrowth2DConfig(periodic_boundary=True)
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett, config=cfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, "nccl", port, timeout_s=60.0)
    try:
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        assert sh.graphed
        ms = sh.init_state()
        eager = [ms]
        for _ in range(5):
            eager.append(sh.step(eager[-1]))
        _assert_bitwise(sh.step_n_quiet(ms, 5).leaves(), eager[-1].leaves())
        fin, stack = sh.step_n(ms, 5)
        _assert_bitwise(fin.leaves(), eager[-1].leaves())
        _assert_bitwise(list(stack), [e.state for e in eager[1:]])
        s2 = sh.step_jit()(sh.step_jit()(ms))
        _assert_bitwise(s2.leaves(), eager[2].leaves())
        assert int(eager[-1].metrics.n_failed) == 0
        sh.release_graph()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# a steady callable as the wind: the node kind of K1, K3, K5 and K6
# ---------------------------------------------------------------------------


def test_node_kind_equals_constant_winds_and_constant_record_bitwise(dev):
    """(10, 10) m/s everywhere given as its two node planes (the node kind,
    the planes of a steady callable): K1 (both methods, both modes), K3,
    K5 and K6 equal their constant-wind instances, and their gridded
    instances over a constant record, bit for bit."""
    from picles_torch import TermFlags, constant_winds, node_plane_winds
    from picles_torch.ops import transforms as TR
    from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_cuda
    from picles_torch.ops.pic_cuda import pic_gather_remesh
    from picles_torch.ops.remesh_cuda import remesh_cuda
    from picles_torch.ops.tsit5 import SolverConfig

    n, t0 = 64, 1200.0
    kw, wf, _ = _gridded(dev, n, 900.0, t0, const=True)
    cw = constant_winds(10.0, 10.0)
    node = torch.full((2, n, n), 10.0, device=dev)
    nw, nf = node_plane_winds(*node), node.unbind(0)
    winds = ((nw, nf), (cw, ()), (kw, wf))
    comps, active, g = _state(dev, n=n, seed=3)
    proj = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)
    t = torch.full_like(comps[0], t0)
    before = advance_cuda.launches
    for method in ("bosh3", "tsit5"):
        for adaptive in (False, True):
            cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                               force_dtmin=True)
            dt = torch.full_like(t, 60.0)
            a, b, c = (advance_cuda(w, _consts(), TermFlags(), cfg, 600.0,
                                    comps, t, dt, active, g.x, g.y, proj,
                                    wind_fields=f) for w, f in winds)
            _assert_bitwise(a, b)
            _assert_bitwise(a, c)
    assert advance_cuda.launches == before + 12
    reset, dt = _reset_inputs(dev, n, 2)
    a, b, c = (auto_dt_cuda(w, _consts(), TermFlags(), t, comps, g.x, g.y,
                            proj, reset, dt, 1e-4, 600.0, wind_fields=f)
               for w, f in winds)
    _assert_bitwise((a,), (b,))
    _assert_bitwise((a,), (c,))
    m, nodes, core = _remesh_case(dev, n, "wind_sea", True, seed=5)
    rk = [m.remesh_params._replace(winds=w) for w, _ in winds]
    a, b, c = (remesh_cuda(r, nodes, *core, wind_fields=f)
               for r, (_, f) in zip(rk, winds))
    _assert_bitwise(a, b)
    _assert_bitwise(a, c)
    chans = TR.particle_to_node(*core[:3])
    sact = (core[6] & core[7]).contiguous()
    a, b, c = (pic_gather_remesh(core[3], core[4], chans, sact, m.grid.stats,
                                 3, r, *core, wind_fields=f)
               for r, (_, f) in zip(rk, winds))
    _assert_bitwise((*a[0], *a[1]), (*b[0], *b[1]))
    _assert_bitwise((*a[0], *a[1]), (*c[0], *c[1]))


def test_node_kind_steps_like_constant_winds_and_the_jets_record(dev):
    """``chip_smoke.node_step_checks`` at 64^2 and on a 64 x 32 tripolar
    grid with its continent: a steady constant callable steps bit for bit
    like ``constant_winds`` under the four configurations, and the global
    demo's two jets bit for bit like a two-frame record of their planes
    (the gridded instances) under the three jet paths."""
    cs = _chip_smoke()
    launches = cs.node_step_checks(dev, 64, cs.tripolar_grid(dev, 128, 64))
    assert all(launches[k] > 0 for k in ("K1", "K3", "K5", "K6")), launches


def test_time_dependent_callable_raises_on_the_kernel_modes(dev):
    """A callable that reads its time runs on the kernel modes as the
    traced kind (K1, K2, K3 launched, graphed replays bit for bit the eager
    steps); one the tracer cannot lower (``float(t)``) is refused; the
    plain advance still takes the first."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              WindKind, Winds2D, cartesian_box)
    from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_cuda

    cs = _chip_smoke()
    g = cartesian_box(2e3 * 15, 16, 2e3 * 15, 16, device=dev)
    w = Winds2D(u=lambda x, y, t: torch.where(t > 3600.0, 0.0, 10.0) + 0 * x,
                v=lambda x, y, t: torch.zeros_like(x))
    m = WaveGrowth2D(g, w, ODESettings())
    assert m.winds.kernel.kind == WindKind.TRACED and m.graphed
    cs.reset_counters()
    eager = cs.eager_steps(m, m.init_state(), 8)
    assert advance_cuda.traced_launches == auto_dt_cuda.traced_launches == 8
    cs.assert_state_bitwise("traced graphed", m.step_n_quiet(
        m.init_state(), 8), eager)
    assert bool(torch.isfinite(eager.state).all())
    host = Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0 + float(t)),
                   v=lambda x, y, t: torch.zeros_like(x))
    with pytest.raises(NotImplementedError, match="_local_scalar_dense"):
        WaveGrowth2D(g, host, ODESettings())
    p = WaveGrowth2D(g, w, ODESettings(),
                     config=WaveGrowth2DConfig(advance_mode="torch"))
    assert p.winds.kernel is None and not p.graphed
    ms = p.step(p.init_state())
    assert bool(torch.isfinite(ms.state).all())


@pytest.mark.parametrize("path", ["production", "default"])
def test_traced_pulse_on_a_tripolar_grid_equals_constant_winds(dev, path):
    """The pulse (the traced kind) on a 64 x 32 tripolar grid with the
    continent (per-node projection planes, the seam fold), DT 1200 s: the
    steps before its stop bit for bit ``constant_winds(12, 0)``'s, eager
    and graphed (``chip_smoke.py`` ``pulse_tripolar_check`` at 1440 x
    720)."""
    from picles_torch import WindKind, constant_winds

    cs = _chip_smoke()
    grid = cs.tripolar_grid(dev, 128, 64)
    n = cs.PULSE_TRI_ANCHOR_STEPS
    mp = cs.tripolar_model(grid, cs.pulse_winds(), path)
    mc = cs.tripolar_model(grid, constant_winds(12.0, 0.0), path)
    assert mp.winds.kernel.kind == WindKind.TRACED and mp.graphed
    assert mp.uniform_proj is None
    a = cs.eager_steps(mp, mp.init_state(), n)
    cs.assert_state_bitwise("tripolar pulse", a,
                            cs.eager_steps(mc, mc.init_state(), n))
    cs.assert_state_bitwise("tripolar pulse graphed",
                            mp.step_n_quiet(mp.init_state(), n), a)
    assert int(a.metrics.n_failed) == 0


def _traced(dev):
    cs = _chip_smoke()
    winds = cs.traced_callables()
    kerns, _ = cs.traced_build(dev, winds)
    return cs, winds, kerns


def test_traced_probe_matches_the_callable(dev):
    """The emitted function alone (``picles_traced_probe``) bit for bit the
    callables run by torch on the card, at the switch times too."""
    cs, winds, kerns = _traced(dev)
    ops = cs.traced_probe_check(dev, winds, kerns, 1 << 16)
    assert all(v > 0 for v in ops.values())


@pytest.mark.parametrize("kid", ["K1", "K3", "K5", "K6"])
def test_traced_kernel_matches_plain(dev, kid):
    """Each traced kernel at 64^2 against its plain version, and example
    02's jet traced bit for bit its node kind (``traced_kernel_checks``)."""
    cs, winds, kerns = _traced(dev)
    results = {f"{k} traced": {} for k in ("K1", "K3", "K5", "K6")}
    errs = cs.traced_kernel_checks(dev, 64, winds, kerns, results, {},
                                   only=(kid,))
    assert errs[kid] < 1e-3, errs


def test_scatter_dense_cuda_is_pic_gather_bitwise(dev):
    """``pic.scatter(mode="dense_cuda")`` (and JAX's name for it,
    "dense_pallas") deposits through K2: bit for bit ``pic_gather`` on the
    same inputs at 64^2 (halo 3, open and periodic axes), and within the
    deposit's rtol 1e-5 of ``mode="dense"``; K2's counter ticks once a
    call."""
    from picles_torch.grids.base import Boundary, GridStats
    from picles_torch.ops import pic
    from picles_torch.ops.pic_cuda import pic_gather

    n = 64
    xr, yr, chans, act = _deposit_inputs(dev, n, n, 3, 31)
    charge = torch.stack(chans, dim=-1)
    for bx, by in ((Boundary.PERIODIC, Boundary.PERIODIC),
                   (Boundary.NONPERIODIC, Boundary.PERIODIC)):
        st = GridStats(nx=n, ny=n, bx=bx, by=by)
        ref, rst = pic_gather(xr, yr, chans, act, st, 3)
        for mode in ("dense_cuda", "dense_pallas"):
            before = pic_gather.launches
            S, sst = pic.scatter(xr, yr, charge, act, st, 3, mode=mode)
            assert pic_gather.launches == before + 1
            assert torch.equal(_bits(S), _bits(torch.stack(ref, dim=-1)))
            assert int(sst.clamped) == int(rst.clamped)
        P, _ = pic.scatter(xr, yr, charge, act, st, 3, mode="dense")
        for c in range(3):   # the inputs hold an inf and a NaN
            fin = P[..., c][P[..., c].isfinite()]
            torch.testing.assert_close(S[..., c], P[..., c], rtol=1e-5,
                                       atol=1e-6 * float(fin.abs().max()),
                                       equal_nan=True)


def test_scatter_dense_cuda_refuses_cpu_tensors():
    """``scatter(mode="dense_cuda")`` launches K2 or raises: on CPU tensors
    it raises, and never deposits with the plain version."""
    from picles_torch.grids.base import Boundary, GridStats
    from picles_torch.ops import pic

    z = torch.zeros((8, 8))
    st = GridStats(nx=8, ny=8, bx=Boundary.PERIODIC, by=Boundary.PERIODIC)
    with pytest.raises(ValueError, match="not a CUDA device"):
        pic.scatter(z, z, torch.zeros((8, 8, 3)),
                    torch.ones((8, 8), dtype=torch.bool), st, 3,
                    mode="dense_cuda")


def test_record_trajectories_sub_dt_through_k1(dev):
    """``record_trajectories`` on the graphed flagship at 64^2 in
    fixed-substep mode with K = 4: each step's 4 sub-windows are 4 launches
    of K1 (DT / 4 each), their states within rtol 1e-5 of the plain
    ``integrate_to`` over the same windows (atol 5e-6, K1's fixed-substep
    agreement; clocks at rtol 1e-6); the per-step history (the
    graph's replays, each row a copy) bit for bit ``step_n``'s states."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              cartesian_box, constant_winds)
    from picles_torch.core import fetch_relations as FR
    from picles_torch.ops.advance_cuda import advance_cuda
    from picles_torch.ops.tsit5 import integrate_to
    from picles_torch.utils.particle_tools import (particle_z,
                                                   record_trajectories)

    n = 64
    ws = FR.MinimalWindsea(10.0, 10.0, 600.0)
    sett = ODESettings(log_energy_minimum=float(ws.lne), timestep=600.0,
                       saving_step=150.0, dt=30.0, dtmin=1e-4,
                       force_dtmin=True, adaptive=False, solver="bosh3")
    cfg = WaveGrowth2DConfig(periodic_boundary=True, dt_reset_mode="carry",
                             halo=((0, 3), (0, 3)), remesh_mode="fused")
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev)
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett, config=cfg)
    assert model.graphed
    ms = model.init_state()
    ref, states = model.step_n(ms, 3)
    before = advance_cuda.launches
    final, h = record_trajectories(model, ms, 3)
    assert advance_cuda.launches - before == 3 * 4   # the replays count 0
    assert torch.equal(_bits(h["state"]), _bits(states))
    _assert_bitwise(final.leaves(), ref.leaves())
    assert h["z_fine"].shape == (12, n, n, 5)

    # the first step's windows against the plain integrator
    P = ms.particles
    z, t, dt = particle_z(P), P.t, P.dt
    active = P.on & model.active_mask
    for k in range(4):
        r = integrate_to(model.rhs, z, t, t + 150.0, dt, model.aux, active,
                         model.solver)
        z, t, dt = r.z, r.t, r.dt
        torch.testing.assert_close(h["z_fine"][k], z, rtol=1e-5,
                                   atol=5e-6)
        torch.testing.assert_close(h["t_fine"][k], t, rtol=1e-6, atol=0)


def test_record_trajectories_1d_sub_dt_through_k7(dev):
    """``record_trajectories`` on the graphed B01 model in fixed-substep
    mode (20 s) with K = 4: each step's 4 sub-windows are 4 launches of K7
    (DT / 4 each), the first step's windows within 5e-6 abs of the plain
    ``integrate_to`` over the same windows in lne and cg_x (K7's
    fixed-substep agreement; x at rtol 1e-6, clocks at rtol 1e-6); the
    per-step history bit for bit ``step_n``'s states."""
    from picles_torch import (ODESettings, WaveGrowth1D, WaveGrowth1DConfig,
                              constant_winds_1d, one_d_grid)
    from picles_torch.ops.advance_cuda import advance_1d
    from picles_torch.ops.tsit5 import integrate_to
    from picles_torch.utils.particle_tools import record_trajectories

    m = WaveGrowth1D(one_d_grid(0.0, 500e3, 31, device=dev),
                     constant_winds_1d(10.0),
                     ODESettings(timestep=600.0, saving_step=150.0, dt=20.0,
                                 adaptive=False),
                     config=WaveGrowth1DConfig(periodic_boundary=False))
    assert m.graphed and m.advance_mode == "cuda"
    ms = m.step_n_quiet(m.init_state(), 6)
    ref, states = m.step_n(ms, 3)
    before = advance_1d.launches
    final, h = record_trajectories(m, ms, 3)
    assert advance_1d.launches - before == 3 * 4   # the replays count 0
    assert torch.equal(_bits(h["state"]), _bits(states))
    _assert_bitwise(final.leaves(), ref.leaves())
    assert h["z_fine"].shape == (12, 31, 3)

    P = ms.particles
    z, t, dt = P.z, P.t, P.dt
    active = P.on & ~m.boundary_mask
    for k in range(4):
        r = integrate_to(m.rhs, z, t, t + 150.0, dt, m.grid.x, active,
                         m.solver)
        z, t, dt = r.z, r.t, r.dt
        torch.testing.assert_close(h["z_fine"][k][:, :2], z[:, :2], rtol=0,
                                   atol=5e-6)
        torch.testing.assert_close(h["z_fine"][k][:, 2], z[:, 2], rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(h["t_fine"][k], t, rtol=1e-6, atol=0)


def test_step_timer_synchronizes_the_card(dev, monkeypatch):
    """``StepTimer.measure(sync_on=...)`` waits for the card of a CUDA
    tensor (``torch.cuda.synchronize`` on its device) before the clock
    stops; a queued kernel is done when the block's time is taken."""
    from picles_torch.utils.diagnostics import StepTimer

    seen = []
    orig = torch.cuda.synchronize

    def spy(device=None):
        seen.append(device)
        return orig(device)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    x = torch.ones((2048, 2048), device=dev)
    timer = StepTimer()
    with timer.measure(sync_on=x):
        torch.cuda._sleep(50_000_000)
        y = x @ x
    assert seen == [x.device]
    done = torch.cuda.Event()
    done.record()
    assert done.query() and float(y[0, 0]) == 2048.0
    assert timer.summary()["n"] == 1


# ---------------------------------------------------------------------------
# float64: the double instances of K1-K6
# ---------------------------------------------------------------------------


def test_float64_kernels_match_plain(dev):
    """``chip_smoke.f64_kernel_checks`` at 64^2: each double instance
    against its float64 plain version on the card, every branch: K1 in
    fixed substeps within 1e-12 of each component's scale and adaptive by
    share of lanes, K3 within 1e-12, under constant, half-domain and
    time-cosine winds, a steady callable's node planes and a gridded
    record, with per-node projection planes and over two layers; K2, K4
    and K6's node planes within 1e-13 and bit for bit across two launches,
    across the tripolar seam too; K5 and K6's remesh with every branch
    firing, bits, flags, dt and positions exact."""
    cs = _chip_smoke()
    err = cs.f64_kernel_checks(dev, 64)
    assert err["K1"] <= 1e-12 and err["K3"] <= 1e-12, err
    assert max(err["K2"], err["K4"], err["K6"]) <= 1e-13, err


def test_float64_model_graphed_on_card_matches_cpu(dev):
    """A float64 fused flagship and a float64 default model ("auto" modes:
    the double instances, graphed) at 64^2, three graphed steps against the
    same models on the CPU within 1e-10 of the state's scale, every counter
    equal (``chip_smoke.f64_card_vs_cpu``); their eager steps launch only
    the double instances, and replay bit for bit."""
    import picles_torch.ops.advance_cuda as AC

    cs = _chip_smoke()
    out = cs.f64_card_vs_cpu(dev, 64)
    assert all(v["err"] <= 1e-10 for v in out.values()), out
    m = cs.f64_main_models(64, dev)["default"]
    cs.reset_counters()
    cs.reset_f64_counters()
    eager = cs.eager_steps(m, m.init_state(), 3)
    assert AC.advance_cuda.f64_launches == AC.auto_dt_cuda.f64_launches == 3
    assert not any(cs.all_counters().values())
    cs.assert_state_bitwise("float64 graphed", m.step_n_quiet(
        m.init_state(), 3), eager)


def test_float64_traced_wind_refused_on_card(dev):
    """On a card a float64 model whose wind callable reads its time runs
    on the traced kind's double instances, graphed ("auto" modes, no
    construction error; a callable whose dtypes depend on the rank of t
    is still refused, naming the plain modes): the pulse, fused and
    default, at 64^2, three graphed steps within 1e-10 of the CPU's plain
    run, every counter equal (``chip_smoke.f64_winds_card_vs_cpu``); with
    the plain modes it runs too, eagerly."""
    from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                              Winds2D, cartesian_box)

    cs = _chip_smoke()
    out = cs.f64_winds_card_vs_cpu(dev, 64, names=("pulse fused",
                                                   "pulse default"))
    assert len(out) == 2 and all(v["err"] <= 1e-10 for v in out.values())
    g = cartesian_box(2e3 * 15, 16, 2e3 * 15, 16, device=dev,
                      dtype=torch.float64, periodic_boundary=(True, True))
    c64 = torch.tensor(2.0, dtype=torch.float64)
    w = Winds2D(u=lambda x, y, t: x + t.float() * c64,
                v=lambda x, y, t: torch.zeros_like(x))
    with pytest.raises(NotImplementedError, match='advance_mode="torch"'):
        WaveGrowth2D(g, w, ODESettings(),
                     config=WaveGrowth2DConfig(dtype=torch.float64))
    p = WaveGrowth2D(g, w, ODESettings(), config=WaveGrowth2DConfig(
        dtype=torch.float64, advance_mode="torch", scatter_mode="dense"))
    ms = p.step(p.init_state())
    assert ms.state.dtype == torch.float64 and not p.graphed
    assert bool(torch.isfinite(ms.state).all())


def test_ptx_checks_of_both_instances(dev):
    """The float instances' PTX holds no float64 line but the cosf argument
    reduction; the double instances' no narrowing to float32 but in the
    time-cosine amplitude's own function (needs nvcc)."""
    from picles_torch.ops import cuda_build

    assert cuda_build.unexpected_double_ops() == []
    narrowing = cuda_build.narrowing_summary()
    assert narrowing["other"] == [] and narrowing["amplitude"] > 0


# ---------------------------------------------------------------------------
# float64 under every wind: the traced kind's double instances of K1, K3,
# K5 and K6, K7's double instances, the two faults' repairs
# ---------------------------------------------------------------------------


def test_time_cosine_sampler_divides_as_the_kernels(dev):
    """``time_cosine_winds``' amplitude on 2^20 float32 times bit for bit
    cos(2 pi t / p) with the period divided as IEEE division (a 0-dim
    tensor on the card, as the JAX package and the kernels'
    ``cosine_amplitude`` divide), where ATen's division by a host scalar
    parts by an ulp in some lanes (``chip_smoke.time_cosine_division_check``)."""
    cs = _chip_smoke()
    out = cs.time_cosine_division_check(dev, 1 << 20)
    assert out["reciprocal_parts"] > 0


def test_float64_node_planes_card_matches_cpu(dev):
    """A float64 model under a steady callable written in float64
    arithmetic (the global jet's U0 cos(lat) on a float64 spherical grid:
    the node kind, its planes in float64; the fused configuration), three
    graphed steps within 1e-10 of the CPU's plain run, every counter equal;
    planes rounded to float32 part by some 1e-7."""
    cs = _chip_smoke()
    out = cs.f64_winds_card_vs_cpu(dev, 64, names=("jet node planes",))
    assert out["jet node planes"]["err"] <= 1e-10, out


def _f64_traced(dev):
    cs = _chip_smoke()
    winds = cs.f64_traced_callables()
    traced = cs.f64_traced_kernels(dev, winds)
    cs.f64_traced_build(*traced)
    return cs, winds, traced[0], traced[1]


def test_traced_f64_probe_matches_the_callable(dev):
    """Each emitted double function alone bit for bit its callable on the
    card (the pulse, ``slopped_blob``, the time-cosine, the 1D storm;
    ``every_op_winds`` within an ulp), the libraries' narrowing to float32
    only in their out-of-line functions."""
    cs, winds, kerns, storm = _f64_traced(dev)
    out = cs.f64_traced_probe_check(dev, winds, kerns, storm, 1 << 16)
    assert all(out[k]["differing"] == 0 for k in ("pulse", "slopped_blob",
                                                  "time_cosine", "storm 1D"))


@pytest.mark.parametrize("kid", ["K1", "K3", "K5", "K6"])
def test_traced_f64_kernel_matches_plain(dev, kid):
    """Each traced double instance at 256^2 on the float64 pulse's states
    against its float64 plain version (``f64_traced_kernel_checks``, under
    the pulse, ``slopped_blob`` and the time-cosine): K1 fixed substeps
    within 1e-12 of the scale and adaptive by share of lanes, K3 within
    1e-15, K5 bit for bit, K6 bit for bit K2 + K5."""
    cs, winds, kerns, _ = _f64_traced(dev)
    results = {k: {} for k in cs.F64_TRACED_REPLACES}
    errs = cs.f64_traced_kernel_checks(
        dev, 256, winds, kerns, results, only=(kid,),
        wind_names=("pulse", "slopped_blob", "time_cosine"))
    assert errs[kid] <= (1e-15 if kid == "K3" else 1e-12), errs


def test_advance_1d_f64_matches_plain(dev):
    """K7's double instances against their float64 plain versions
    (``f64_k7_checks``): node, gridded and traced kinds on B01's float64
    state, bosh3 and tsit5, fixed substeps within 1e-12 of the scale and
    adaptive by share of lanes; the 2^14-lane probe adaptive."""
    cs, _, _, storm = _f64_traced(dev)
    results = {"K7 f64": {}, "K7 traced f64": {}}
    cs.f64_k7_checks(dev, storm, results, probe_lanes=1 << 14,
                     b01_steps=12)
    assert results["K7 f64"]["max_abs_err"] <= 1e-12
    assert results["K7 traced f64"]["max_abs_err"] <= 1e-12


def test_graphed_float64_1d_day_equals_eager_steps(dev):
    """The float64 B01 model and the float64 storm on K7's double
    instances: 12 graphed steps bit for bit 12 eager steps, K7 f64 (traced
    f64) once an eager step; against the CPU within 1e-10
    (``f64_winds_card_vs_cpu``, 31 nodes, 6 steps: node and gridded kinds
    adaptive, the storm in fixed substeps)."""
    import picles_torch.ops.advance_cuda as AC

    cs = _chip_smoke()
    for make, counter in ((lambda: cs.b01_model(dev, dtype=torch.float64),
                           "f64_launches"),
                          (lambda: cs.b01_storm_model(
                              dev, dtype=torch.float64),
                           "traced_f64_launches")):
        m = make()
        assert m.graphed and m.advance_mode == "cuda"
        before = getattr(AC.advance_1d, counter)
        eager = cs.eager_steps(m, m.init_state(), 12)
        assert getattr(AC.advance_1d, counter) == before + 12
        cs.assert_state_bitwise("float64 1D graphed", m.step_n_quiet(
            m.init_state(), 12), eager)
    out = cs.f64_winds_card_vs_cpu(dev, names=("1D node", "1D gridded",
                                               "1D traced"))
    assert all(out[k]["err"] <= 1e-10 for k in ("1D node", "1D gridded",
                                                "1D traced")), out
