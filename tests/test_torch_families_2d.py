"""The 2D slice's remaining JAX test families, mirrored: each runs the JAX
package's model and the port's (plain versions, CPU) from the identical
state carried across by ``picles_torch.convert``, small sizes.

Tolerances, as the largest difference over the JAX state's largest value,
with what was measured on the CPU:

- the land wall (tests/test_land_mask_2d.py:74): 20 steps of the
  propagation-only blob within 1e-5 (3.3e-6), counters and ``on`` equal
  every step, and the JAX test's own absorption checks on the port;
- the wind pulse and re-light (tests/test_growing_decaying_winds.py:29,
  :60): counters and ``on`` equal every step at the JAX test's settings
  (but ``substeps_max``, within 1: ``counters_near``).
  There the adaptive tsit5 controller turns last-ulp differences into
  another substep path on one lane at step 1 (the states part by 2.4e-2,
  1.4e-3 by step 30, and a float64 run puts the port the nearer), so the
  states are held at solver tolerance: the same pulse at abstol 1e-7 /
  reltol 1e-6 within 1e-4 (3.0e-5).  The re-light within 1e-5;
- the T04 direction sweep (tests/test_t04_sweep.py:39-77): the 18
  configurations 8 steps, counters and ``on`` equal, within 5e-4 (3.4e-5),
  and the JAX test's invariants on the port.  JAX compiles the step once
  for each periodicity, the wind direction an argument (``_t04_jax``);
- the rotated grid (tests/test_model_2d.py:363): 6 steps within 1e-5,
  counters equal, and the JAX test's -tan(45 deg) drift on the port;
- the float64 full-step oracle's five Cartesian cases
  (tests/test_full_step_oracle.py:384): the port against the oracle at the
  JAX test's rtol 1e-4 / atol 1e-9 with the on/off pattern equal, and
  against the JAX step within 1e-5, counters as the pulse's.
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picles_torch as pt
import test_full_step_oracle as tfo
import test_growing_decaying_winds as tgd
import test_land_mask_2d as tlm
from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.state import Particles2D as JParticles
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from test_torch_model_2d import assert_counters_equal, port_of, state_of

torch.set_num_threads(1)

DT = 600.0


def gap(tms, jms) -> float:
    """The largest state difference over the JAX state's largest value."""
    S, J = tms.state.numpy(), np.asarray(jms.state)
    return float(np.abs(S - J).max() / max(np.abs(J).max(), 1e-30))


def same_on(tms, jms) -> bool:
    return np.array_equal(tms.particles.on.numpy(),
                          np.asarray(jms.particles.on))


def counters_near(tms, jms, step):
    """Every counter equal but ``substeps_max``, the most substeps a lane
    took, within 1: the controller's path on the slowest lane."""
    got = tms.metrics.as_dict()
    want = {k: int(getattr(jms.metrics, k)) for k in got}
    smax = got.pop("substeps_max"), want.pop("substeps_max")
    assert got == want and abs(smax[0] - smax[1]) <= 1, \
        f"step {step}: {got} {smax[0]} vs {want} {smax[1]}"


def step_both(jm, tm, jms, steps: int, tol: float):
    """``steps`` steps of both from the JAX state ``jms``: every step within
    ``tol`` of the JAX scale, counters and ``on`` equal.  Returns the last
    (port, JAX) states."""
    jstep = jax.jit(jm.step)
    tms = state_of(jms)
    for k in range(steps):
        jms, tms = jstep(jms), tm.step(tms)
        assert gap(tms, jms) <= tol, f"step {k}: {gap(tms, jms):.3e}"
        assert_counters_equal(tms, jms, k)
        assert same_on(tms, jms), f"on differs at step {k}"
    return tms, jms


# -- the land wall ------------------------------------------------------------

def test_land_wall_absorbs_blob_like_jax():
    mask = np.ones((tlm.NX, tlm.NY), bool)
    mask[30:34, :] = False
    jm = tlm._model(mask)
    tm = port_of(jm, pt.constant_winds(0.0, 0.0))
    tms, _ = step_both(jm, tm, tlm._plant_blob(jm), 20, 1e-5)
    land = tm.grid.mask == 0
    assert not bool((tms.particles.on & land).any())
    assert int(tms.metrics.n_failed) == 0
    # the JAX test's absorption: the first step's deposit is the blob's
    # reference energy; after 19 more the wall holds nearly all of it and
    # nothing passed it
    e0 = float(tm.step(state_of(tlm._plant_blob(jm))).state[..., 0].sum())
    assert e0 > 0
    assert float(tms.state[..., 0].sum()) < 0.05 * e0
    assert float(tms.state[34:, :, 0].sum()) < 1e-6 * max(e0, 1.0)


# -- growing and decaying winds ----------------------------------------------

def _pulse(U=12.0, t_on=0.0, t_off=2 * 3600.0):
    """tests/test_growing_decaying_winds.py's pulse in torch: U from t_on
    to t_off, then calm."""
    def u(x, y, t):
        t = torch.as_tensor(t)
        return torch.where((t >= t_on) & (t < t_off), U, 0.0) + 0.0 * x

    return pt.Winds2D(u=u, v=lambda x, y, t: torch.zeros_like(x))


def _gd_settings(**tols):
    ws = jfr.MinimalWindsea(12.0, 0.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True, **tols)


@pytest.mark.parametrize("tols", [{}, dict(abstol=1e-7, reltol=1e-6)],
                         ids=["jax-test-settings", "solver-tolerance"])
def test_wind_pulse_on_off_like_jax(tols):
    """6 steps of wind then 24 of calm.  At the JAX test's settings the
    counters and ``on`` are held every step and the JAX test's checks run
    on the port; the states are held at solver tolerance."""
    jm = JModel(j_box(100e3, 17, 100e3, 17, periodic_boundary=(True, True)),
                tgd._pulse_winds(), _gd_settings(**tols),
                config=JConfig(periodic_boundary=True))
    tm = port_of(jm, _pulse())
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = state_of(jms)
    e_peak = None
    for k in range(30):
        jms, tms = jstep(jms), tm.step(tms)
        counters_near(tms, jms, k)
        assert same_on(tms, jms), f"on differs at step {k}"
        if tols:
            assert gap(tms, jms) <= 1e-4, f"step {k}: {gap(tms, jms):.3e}"
        if k == 5:
            e_peak = float(tms.state[..., 0].mean())
            assert e_peak > 0 and bool(tms.particles.on.all())
    assert float(tms.state[..., 0].mean()) < e_peak
    assert int(tms.metrics.n_failed) == 0
    assert bool(torch.isfinite(tms.state).all())


def test_wind_returns_relights_like_jax():
    """Calm seeding, the wind on from 1 h: the particles re-light in the
    advance; 12 steps within 1e-5, counters and ``on`` equal."""
    def ju(x, y, t):
        return jnp.where(jnp.asarray(t) >= 3600.0, 12.0, 0.0) + \
            0.0 * jnp.asarray(x)

    def tu(x, y, t):
        return torch.where(torch.as_tensor(t) >= 3600.0, 12.0, 0.0) + 0.0 * x

    jm = JModel(j_box(100e3, 13, 100e3, 13, periodic_boundary=(True, True)),
                jw.Winds2D(u=ju, v=lambda x, y, t: jnp.zeros_like(
                    jnp.asarray(x))), _gd_settings(),
                config=JConfig(periodic_boundary=True))
    tm = port_of(jm, pt.Winds2D(u=tu, v=lambda x, y, t: torch.zeros_like(x)))
    seed = tm.init_state()
    assert not bool(seed.particles.on.any())
    tms, _ = step_both(jm, tm, jm.init_state(), 12, 1e-5)
    assert bool(tms.particles.on.any()) and float(tms.state[..., 0].max()) > 0


# -- the T04 direction sweep --------------------------------------------------

WINDS = [-10.0, 0.0, 10.0]
T04_STEPS = 8


def _t04_settings():
    # MinimalWindsea is a 1 m/s wind's whatever the direction, so the nine
    # directions share one log_energy_minimum
    ws = jfr.MinimalWindsea(2.0, 2.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True)


_T04 = {}


def _t04_jax(periodic: bool):
    """The JAX model of tests/test_t04_sweep.py:_run on a 17^2 box with
    ``constant_winds``' samplers reading (U, V) from an argument, and its
    ``step_n`` (``scan`` over ``step``) compiled once for the nine
    directions: returns (model, wind holder, compiled run)."""
    if periodic not in _T04:
        uv = {}
        winds = jw.Winds2D(
            u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32),
                                            uv["uv"][0]),
            v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32),
                                            uv["uv"][1]))
        jm = JModel(j_box(100e3, 17, 100e3, 17,
                          periodic_boundary=(periodic, periodic)),
                    winds, _t04_settings(),
                    config=JConfig(periodic_boundary=periodic))

        @jax.jit
        def run(wind, ms):
            uv["uv"] = wind
            return jax.lax.scan(lambda c, _: (jm.step(c), None), ms, None,
                                length=T04_STEPS)[0]

        _T04[periodic] = (jm, uv, run)
    return _T04[periodic]


@pytest.mark.parametrize("U,V", list(itertools.product(WINDS, WINDS)))
@pytest.mark.parametrize("periodic", [True, False])
def test_t04_direction_sweep_like_jax(U, V, periodic):
    jm, uv, run = _t04_jax(periodic)
    uv["uv"] = jnp.array([U, V], jnp.float32)
    j0 = jm.init_state()
    jms = run(uv["uv"], j0)
    tm = port_of(jm, pt.constant_winds(U, V))
    tms = state_of(j0)
    for _ in range(T04_STEPS):
        tms = tm.step(tms)
    assert gap(tms, jms) <= 5e-4, gap(tms, jms)
    assert_counters_equal(tms, jms, T04_STEPS)
    assert same_on(tms, jms)
    # the JAX test's invariants, on the port
    S = tms.state.numpy()
    assert np.isfinite(S).all() and int(tms.metrics.n_failed) == 0
    if U == 0 and V == 0:
        assert not bool(tms.particles.on.any())
        np.testing.assert_allclose(S[..., 0], 0.0, atol=1e-12)
    else:
        assert S[2:-2, 2:-2, 0].max() > 0
        if U:
            assert np.sign(S[2:-2, 2:-2, 1].mean()) == np.sign(U)
        if V:
            assert np.sign(S[2:-2, 2:-2, 2].mean()) == np.sign(V)


# -- the rotated grid ---------------------------------------------------------

def test_rotated_grid_diagonal_propagation_like_jax():
    """A propagation-only x-swell blob on a 45 deg box: 6 steps within 1e-5,
    counters equal, and on the port the blob's centre moves +i and -j in
    the ratio -tan(45 deg) within 5%."""
    from picles_tpu.ops.rhs import TermFlags as JFlags

    ws = jfr.MinimalWindsea(1.0, 1.0, DT)
    sett = JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 3600.0, dt=1.0, dtmin=1e-2,
                     force_dtmin=True)
    flags = JFlags(input=False, dissipation=False, peak_shift=False,
                   direction=False)
    minimal = np.array([1e-12, 1e-20])
    jm = JModel(j_box(100e3, 32, 100e3, 32, angle=45.0,
                      periodic_boundary=(True, True)),
                jw.constant_winds(0.0, 0.0), sett, flags=flags,
                minimal_state=minimal,
                config=JConfig(periodic_boundary=True, halo=3))
    tm = port_of(jm, pt.constant_winds(0.0, 0.0), minimal_state=minimal)
    ms = jm.init_state()
    on = np.zeros((32, 32), bool)
    on[8:12, 8:12] = True
    z = np.zeros((32, 32, 5), np.float32)
    z[..., 0] = math.log(0.1)
    z[..., 1] = 8.0
    jms = dataclasses.replace(ms, particles=JParticles.from_z(
        jnp.asarray(z), ms.particles.t, ms.particles.dt, jnp.asarray(on)))
    jstep = jax.jit(jm.step)
    tms = state_of(jms)
    ii, jj = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    com = []
    for k in range(6):
        jms, tms = jstep(jms), tm.step(tms)
        assert gap(tms, jms) <= 1e-5, f"step {k}: {gap(tms, jms):.3e}"
        assert_counters_equal(tms, jms, k)
        e = tms.state[..., 0].numpy()
        com.append(((ii * e).sum() / e.sum(), (jj * e).sum() / e.sum()))
    di, dj = com[-1][0] - com[0][0], com[-1][1] - com[0][1]
    assert di > 0.3 and dj < -0.3
    np.testing.assert_allclose(dj / di, -1.0, rtol=0.05)
    assert int(tms.metrics.n_failed) == 0


# -- the float64 full-step oracle ---------------------------------------------

def _oracle_winds(cfg):
    """(oracle samplers, JAX winds, port winds) of an oracle case, as
    tests/test_full_step_oracle.py:391-431 builds them."""
    U, V = cfg["U"], cfg["V"]
    if cfg.get("half"):
        xsplit = 50e3
        return ((lambda x, y, t: U if x < xsplit else 0.0,
                 lambda x, y, t: 0.0),
                jw.Winds2D(
                    u=lambda x, y, t: jnp.where(jnp.asarray(x) < xsplit, U,
                                                0.0),
                    v=lambda x, y, t: jnp.zeros_like(jnp.asarray(
                        x, jnp.float32))),
                pt.half_domain_winds(U, 0.0, xsplit))
    if cfg.get("timecos"):
        period = cfg["timecos"]
        return ((lambda x, y, t: U * math.cos(2.0 * math.pi * t / period),
                 lambda x, y, t: 0.0),
                jw.time_cosine_winds(U, 0.0, period=period),
                pt.time_cosine_winds(U, 0.0, period))
    return ((lambda x, y, t: U, lambda x, y, t: V),
            jw.constant_winds(U, V), pt.constant_winds(U, V))


@pytest.mark.parametrize("case", sorted(tfo.CASES))
def test_full_step_matches_f64_oracle_like_jax(case):
    cfg = tfo.CASES[case]
    nx = ny = 6
    (u_o, v_o), jwinds, twinds = _oracle_winds(cfg)
    ocean = np.ones((nx, ny), bool)
    if cfg["land"]:
        ocean[2, 2] = False
    orc = tfo.Oracle(nx, ny, 100e3, 100e3, cfg["periodic"], u_o, v_o, DT)
    z, on, _, mask, active = orc.seed(ocean)
    states, t = [], 0.0
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())
    jm, jstep = tfo._framework(nx, ny, 100e3, 100e3, cfg["periodic"], jwinds,
                               ocean=ocean if cfg["land"] else None)
    tm = port_of(jm, twinds)
    np.testing.assert_array_equal(tm.grid.mask.numpy(), mask)
    jms = jm.init_state()
    tms = state_of(jms)
    for k in range(3):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_allclose(tms.state.numpy(), states[k], rtol=1e-4,
                                   atol=1e-9, err_msg=f"{case} step {k + 1}")
        assert gap(tms, jms) <= 1e-5, f"step {k + 1}: {gap(tms, jms):.3e}"
        counters_near(tms, jms, k)
    np.testing.assert_array_equal(tms.particles.on.numpy(), on)
