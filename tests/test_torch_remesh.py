"""The remesh: the port's plain version ``remesh.remesh_core`` (what kernels
K5 and K6 compute) and the model's ``remesh_mode="pallas" | "fused"`` tails
on CPU tensors, against the JAX package on the CPU (its Pallas kernels in
interpret mode), from the same numpy-seeded inputs.

Tolerances: the branch bits, ``on``, ``dt`` and the positions are exact;
the gathered and reseeded values (lne, cgx, cgy) agree to rtol 4e-7, a few
float32 ulps (the windsea raises to float exponents, and PyTorch and XLA
round ``pow`` differently in the last place).  Whole model steps: rtol 1e-5
in fixed-substep mode with every counter equal; the JAX suite's own bound
between remesh backends, rtol 1e-2, under the adaptive solver, whose error
controller turns ulps into other substep paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.base import Boundary as JB
from picles_tpu.grids.base import GridStats as JStats
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.ops import remesh_pallas as jrm
from picles_tpu.ops import transforms as jtr
from picles_tpu.ops.pic_pallas import scatter_remesh_fused

import picles_torch as pt
from picles_torch import convert
from picles_torch.grids.base import Boundary as TB
from picles_torch.grids.base import GridStats as TStats
from picles_torch.ops import pic as tpic
from picles_torch.ops import remesh as trm
from picles_torch.ops.remesh_cuda import remesh_cuda

torch.set_num_threads(1)

DT = 600.0
RTOL_SEED = 4e-7
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped", "substeps_max")
FIXED = (-11.0, 1e-3, 0.0)
BFIXED = (-9.5, 0.35, 0.35)


def _inputs(n, seed):
    """Node and particle planes in which gather, reseed and off all fire:
    a third of the nodes below the minimal state, half-domain winds, a
    non-periodic ring of boundary nodes, dt spread over [1e-6, 3000] s."""
    rng = np.random.default_rng(seed)
    ws = jfr.get_initial_windsea(np.full((n, n), 10.0, np.float32),
                                 np.full((n, n), 5.0, np.float32), DT)
    lne = np.asarray(ws.lne) + rng.normal(0, 0.3, (n, n))
    cgx = np.asarray(ws.cg_bar_x) * rng.uniform(0.5, 1.5, (n, n))
    cgy = np.asarray(ws.cg_bar_y) * rng.uniform(0.5, 1.5, (n, n))
    lne, cgx, cgy = (a.astype(np.float32) for a in (lne, cgx, cgy))
    e, mx, my = (np.asarray(a) for a in jtr.particle_to_node(lne, cgx, cgy))
    low = np.where(rng.uniform(size=(n, n)) < 0.3,
                   rng.uniform(0, 1e-4, (n, n)), 1.0).astype(np.float32)
    x, y = np.meshgrid(np.arange(n) * 2e3, np.arange(n) * 2e3, indexing="ij")
    ring = np.zeros((n, n), bool)
    ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
    return dict(
        node=tuple((a * low).astype(np.float32) for a in (e, mx, my)),
        lne=lne, cgx=cgx, cgy=cgy,
        px=rng.uniform(-0.4, 0.4, (n, n)).astype(np.float32),
        py=rng.uniform(-0.4, 0.4, (n, n)).astype(np.float32),
        dt=np.exp(rng.uniform(np.log(1e-6), np.log(3000.0), (n, n))
                  ).astype(np.float32),
        on=rng.uniform(size=(n, n)) < 0.8,
        active=~ring, boundary=ring,
        x=x.astype(np.float32), y=y.astype(np.float32),
        split=1e3 * (n - 1))


def _minimal():
    ms = np.asarray(jfr.MinimalState(2.0, 2.0, DT), np.float32)
    return float(ms[0]), float(ms[1])


def _params(split, defaults, bdefaults, source, clip):
    me, mm2 = _minimal()
    return trm.RemeshParams(
        winds=pt.half_domain_winds(10.0, 5.0, x_split=split),
        defaults=defaults, bdefaults=bdefaults, boundary_source=source,
        timestep=DT, minimal_e=me, minimal_m2=mm2, wind_min_squared=4.0,
        dtmin=1e-4, clip_dt=clip)


def _torch_planes(c):
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in c.items()
         if k not in ("node", "split")}
    node = tuple(torch.as_tensor(a) for a in c["node"])
    return node, (t["lne"], t["cgx"], t["cgy"], t["px"], t["py"], t["dt"],
                  t["on"], t["active"], t["boundary"], t["x"], t["y"])


def _assert_remesh_equal(t, j, what=""):
    """``t`` a RemeshResult of the port, ``j`` the JAX outputs (lne, cgx,
    cgy, px, py, dt, on, branch)."""
    jl, jx, jy, jpx, jpy, jdt, jon, jbr = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(t.branch.numpy(), jbr, err_msg=what)
    np.testing.assert_array_equal(t.on.numpy(), jon != 0, err_msg=what)
    np.testing.assert_array_equal(t.dt.numpy(), jdt, err_msg=what)
    np.testing.assert_array_equal(t.px.numpy(), jpx, err_msg=what)
    np.testing.assert_array_equal(t.py.numpy(), jpy, err_msg=what)
    for a, b, nm in ((t.lne, jl, "lne"), (t.cgx, jx, "cgx"),
                     (t.cgy, jy, "cgy")):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL_SEED, atol=0,
                                   err_msg=f"{what} {nm}")
    assert t.branch.dtype == torch.int32 and t.on.dtype == torch.bool


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("defaults,bdefaults,source", [
    (None, "same", False),        # boundary_type "same", windsea seeding
    (None, None, True),           # boundary_type "wind_sea"
    (FIXED, "same", False),       # ode_init_type "mininmal"
    (FIXED, None, True),          # fixed interior, windsea boundary inflow
    (None, BFIXED, True),         # boundary_type "mininmal"
])
def test_remesh_core_matches_jax(defaults, bdefaults, source, clip):
    n = 20
    c = _inputs(n, seed=len(str(bdefaults)) + 3 * source)
    node, core = _torch_planes(c)
    clock = torch.tensor(1800.0)
    t = trm.remesh_core(_params(c["split"], defaults, bdefaults, source,
                                clip), node, *core, clock)
    jwd = jw.half_domain_winds(10.0, 5.0, x_split=c["split"])
    me, mm2 = _minimal()
    j = jrm.remesh_core(
        jwd.u, jwd.v, defaults, bdefaults, source, DT, me, mm2, 4.0, 1e-4,
        *(jnp.asarray(a) for a in c["node"]),
        *(jnp.asarray(c[k]) for k in ("lne", "cgx", "cgy", "px", "py", "dt",
                                      "on", "active", "boundary", "x", "y")),
        jnp.float32(1800.0), (), clip_dt=clip)
    _assert_remesh_equal(t, j)
    br = t.branch.numpy()
    # every branch fired, and the bits are exclusive
    for bit in (trm.GATHER_BIT, trm.RESEED_BIT, trm.OFF_BIT):
        assert ((br & bit) != 0).sum() > 0, bit
    assert np.isin(br, (0, 1, 2, 4)).all()
    if not clip:
        np.testing.assert_array_equal(t.dt.numpy(), c["dt"])


def test_remesh_pallas_interpret_matches_plain():
    """The JAX K5 kernel, interpreted, against the plain version that the
    port's "pallas" tail runs on CPU tensors (and K5's wrapper refuses)."""
    n = 16
    c = _inputs(n, seed=11)
    node, core = _torch_planes(c)
    p = _params(c["split"], None, None, True, True)
    t = trm.remesh_core(p, node, *core, torch.tensor(600.0))
    jwd = jw.half_domain_winds(10.0, 5.0, x_split=c["split"])
    me, mm2 = _minimal()
    j = jrm.remesh_pallas(
        jwd.u, jwd.v, None, DT, me, mm2, 4.0, 1e-4,
        tuple(jnp.asarray(a) for a in c["node"]),
        *(jnp.asarray(c[k]) for k in ("lne", "cgx", "cgy", "px", "py", "dt",
                                      "on", "active", "boundary", "x", "y")),
        jnp.float32(600.0), interpret=True, boundary_defaults=None,
        boundary_source=True)
    _assert_remesh_equal(t, j)
    with pytest.raises(ValueError, match="not a CUDA device"):
        remesh_cuda(p, node, *core, torch.tensor(600.0))


def test_scatter_remesh_fused_interpret_matches_plain():
    """The JAX K6 kernel, interpreted, against the port's "fused" tail on
    CPU tensors: ``scatter_dense`` then ``remesh_core``.  Node planes at the
    deposit tests' tolerance (the two sum in other orders), the remesh
    outputs as above."""
    n = 16
    c = _inputs(n, seed=12)
    node, core = _torch_planes(c)
    rng = np.random.default_rng(5)
    xr = rng.uniform(-0.9, 2.9, (n, n)).astype(np.float32)
    yr = rng.uniform(-0.2, 1.9, (n, n)).astype(np.float32)
    sact = c["on"] & c["active"]
    halo = ((1, 3), (0, 2))
    chans = tuple(np.asarray(a) for a in c["node"])
    js = JStats(nx=n, ny=n, bx=JB.NONPERIODIC, by=JB.NONPERIODIC)
    ts = TStats(nx=n, ny=n, bx=TB.NONPERIODIC, by=TB.NONPERIODIC)
    jwd = jw.half_domain_winds(10.0, 5.0, x_split=c["split"])
    me, mm2 = _minimal()
    planes = [c[k] for k in ("lne", "cgx", "cgy")] + [xr, yr] + \
        [c[k] for k in ("dt", "on", "active", "boundary", "x", "y")]
    jnode, jrem, jst = scatter_remesh_fused(
        jwd.u, jwd.v, FIXED, "same", False, DT, me, mm2, 4.0, 1e-4,
        jnp.asarray(xr), jnp.asarray(yr),
        tuple(jnp.asarray(a) for a in chans), jnp.asarray(sact),
        *(jnp.asarray(a) for a in planes), jnp.float32(1200.0), js, halo,
        interpret=True)
    tx, ty = torch.as_tensor(xr), torch.as_tensor(yr)
    S, tst = tpic.scatter_dense(tx, ty, torch.stack(node, -1),
                                torch.as_tensor(sact), ts, halo)
    tnode = tuple(S[..., i] for i in range(3))
    for a, b in zip(tnode, jnode):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    assert int(tst.clamped) == int(jst.clamped) > 0
    core = (core[0], core[1], core[2], tx, ty) + core[5:]
    t = trm.remesh_core(_params(c["split"], FIXED, "same", False, True),
                        tnode, *core, torch.tensor(1200.0))
    _assert_remesh_equal(t, jrem)


# ---------------------------------------------------------------------------
# the model's remesh tails against the JAX model with the same mode
# ---------------------------------------------------------------------------

def _settings(adaptive=True, dt=1e-3):
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=dt,
                     dtmin=1e-4, force_dtmin=True, adaptive=adaptive)


def _port(jm, winds):
    g = jm.grid
    grid = convert.grid_from_numpy(
        {f: np.asarray(getattr(g, f)) for f in convert.GRID_FIELDS}, g.stats,
        device="cpu")
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    # the JAX model's interpreted kernels are the port's plain versions on
    # the CPU: "auto" modes, under the same remesh mode
    cfg = dataclasses.replace(convert.config_from_jax(jm.config),
                              advance_mode="auto", scatter_mode="auto")
    return pt.WaveGrowth2D(grid, winds, sett, ode_params=params,
                           constants=cid, config=cfg)


def _state_of(jms):
    P = jms.particles
    return convert.state_from_numpy(
        np.asarray(jms.state),
        {k: np.asarray(getattr(P, k)) for k in convert.PARTICLE_FIELDS},
        np.asarray(jms.time), np.asarray(jms.iteration), device="cpu")


def _jmodel(grid, winds, sett, remesh, **cfg):
    scatter = "dense_pallas" if remesh == "fused" else "dense"
    return JModel(grid, winds, sett, config=JConfig(
        advance_mode="xla", scatter_mode=scatter, dt_reset_mode="carry",
        remesh_mode=remesh, pallas_interpret=True, **cfg))


def _assert_counters(tms, jms, step, names=COUNTERS):
    got = tms.metrics.as_dict()
    for k in names:
        assert got[k] == int(getattr(jms.metrics, k)), f"{k} at step {step}"


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_model_half_domain_matches_jax(remesh):
    """The JAX suite's half-domain family (periodic 12^2, calm half held
    off): the port's tail on CPU tensors against the JAX model's kernel in
    interpret mode, 4 steps."""
    winds = (jw.half_domain_winds(10.0, 5.0, x_split=50e3),
             pt.half_domain_winds(10.0, 5.0, x_split=50e3))
    jm = _jmodel(j_box(100e3, 12, 100e3, 12, periodic_boundary=(True, True)),
                 winds[0], _settings(), remesh, periodic_boundary=True)
    tm = _port(jm, winds[1])
    assert tm.resolved_config().remesh_mode == remesh
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = _state_of(jms)
    for k in range(4):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
        assert int((~tms.particles.on).sum()) > 0
        np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                                   rtol=1e-2, atol=1e-8, err_msg=f"step {k}")
        _assert_counters(tms, jms, k, ("n_gather", "n_reseed", "n_off",
                                       "n_active", "n_failed", "n_clamped"))


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_model_nonperiodic_fixed_substep_matches_jax(remesh):
    """The JAX suite's non-periodic family (24 x 16, halo ((1,3),(0,2)),
    winds (0, 10)) with the open-boundary windsea inflow, in fixed-substep
    mode so the branch logic is held tightly: rtol 1e-5, every counter
    equal, ``on`` equal, 3 steps."""
    jm = _jmodel(j_box(100e3, 24, 100e3, 16), jw.constant_winds(0.0, 10.0),
                 _settings(adaptive=False, dt=37.5), remesh,
                 periodic_boundary=False, boundary_type="wind_sea",
                 halo=((1, 3), (0, 2)))
    tm = _port(jm, pt.constant_winds(0.0, 10.0))
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = _state_of(jms)
    for k in range(3):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                                   rtol=1e-5, atol=1e-10, err_msg=f"step {k}")
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
        _assert_counters(tms, jms, k)
    assert int(tms.metrics.n_reseed) > 0


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_model_fixed_substep_carries_dt_unclipped(remesh):
    """adaptive=False: the kernel tails carry a fixed sub-step configured
    outside [dtmin, DT] (here 2 DT) untouched, as the JAX tails do."""
    jm = _jmodel(j_box(100e3, 8, 100e3, 8, periodic_boundary=(True, True)),
                 jw.constant_winds(10.0, 5.0),
                 _settings(adaptive=False, dt=2 * DT), remesh,
                 periodic_boundary=True)
    tm = _port(jm, pt.constant_winds(10.0, 5.0))
    assert tm.remesh_params.clip_dt is False
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = _state_of(jms)
    for _ in range(2):
        jms, tms = jstep(jms), tm.step(tms)
    np.testing.assert_array_equal(tms.particles.dt.numpy(),
                                  np.full((8, 8), 2 * DT, np.float32))
    np.testing.assert_array_equal(tms.particles.dt.numpy(),
                                  np.asarray(jms.particles.dt))
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=2e-6, atol=1e-9)


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_kernel_tails_equal_xla_tail_on_cpu(remesh):
    """On CPU tensors all three remesh modes run the same plain version:
    bitwise equal states and counters over 3 steps (the JAX package shows
    the same in interpret mode, tests/test_advance_pallas.py:499-542)."""
    grid = pt.cartesian_box(100e3, 12, 100e3, 12, device="cpu")
    sett = pt.ODESettings(timestep=DT, dt=1e-3, dtmin=1e-4, solver="bosh3")
    mk = lambda rm: pt.WaveGrowth2D(  # noqa: E731
        grid, pt.half_domain_winds(10.0, 5.0, x_split=50e3), sett,
        config=pt.WaveGrowth2DConfig(periodic_boundary=False,
                                     boundary_type="mininmal",
                                     dt_reset_mode="carry", remesh_mode=rm))
    mx, mk_ = mk("xla"), mk(remesh)
    a, b = mx.init_state(), mk_.init_state()
    for _ in range(3):
        a, b = mx.step(a), mk_.step(b)
    assert torch.equal(a.state, b.state)
    for f in convert.PARTICLE_FIELDS:
        assert torch.equal(getattr(a.particles, f), getattr(b.particles, f))
    assert a.metrics.as_dict() == b.metrics.as_dict()


def _cpu_model(**cfg):
    return pt.WaveGrowth2D(
        pt.cartesian_box(100e3, 8, 100e3, 8, periodic_boundary=(True, True),
                         device="cpu"),
        pt.constant_winds(10.0, 5.0), pt.ODESettings(),
        config=pt.WaveGrowth2DConfig(**cfg))


def test_remesh_config_errors():
    """Where the JAX package raises: a kernel remesh with the Hairer dt
    reset, the fused tail without the gather deposit, an unknown mode."""
    with pytest.raises(ValueError, match='dt_reset_mode="carry"'):
        _cpu_model(remesh_mode="pallas", dt_reset_mode="auto")
    with pytest.raises(ValueError, match="gather deposit"):
        _cpu_model(remesh_mode="fused", scatter_mode="dense",
                   dt_reset_mode="carry")
    with pytest.raises(ValueError, match="CUDA kernel"):
        _cpu_model(remesh_mode="fused", scatter_mode="dense_cuda",
                   dt_reset_mode="carry")
    with pytest.raises(ValueError, match="remesh_mode must be one of"):
        _cpu_model(remesh_mode="triton", dt_reset_mode="carry")


def test_kernel_remesh_refuses_winds_outside_the_kernel_set(monkeypatch):
    """On a CUDA device (faked here) a kernel remesh mode with winds that
    carry no kernel descriptor raises, naming the winds the kernels take
    (gridded records among them)."""
    monkeypatch.setattr(pt.Grid2D, "device", property(
        lambda self: torch.device("cuda", 0)))
    plain = pt.Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0),
                       v=lambda x, y, t: torch.full_like(x, 5.0))
    with pytest.raises(NotImplementedError, match="and a GriddedWinds2D"):
        pt.WaveGrowth2D(
            pt.cartesian_box(100e3, 8, 100e3, 8, device="cpu"), plain,
            pt.ODESettings(),
            config=pt.WaveGrowth2DConfig(periodic_boundary=False,
                                         advance_mode="torch",
                                         scatter_mode="dense",
                                         dt_reset_mode="carry",
                                         remesh_mode="pallas"))
