"""The port's 1D growth model (``picles_torch/models/wave_growth_1d.py``) and
its ops against ``picles_tpu``'s, on the CPU.

The 1D model has no kernel in either package: these tests hold the port's
plain PyTorch path.  The first part mirrors the JAX package's 1D tests one
for one (``tests/test_model_1d_b01.py``, ``tests/test_full_step_oracle_1d.py``,
``tests/test_simulation_1d.py``) on the port, with their tolerances; the
second holds the port against JAX on the same inputs.

Tolerances:
- the B01 asserts (Dulov convergence, the collapse across wind speeds, the
  fetch profile, homogeneity, wind-sign symmetry, DT and resolution
  invariance) as the JAX tests state them; the float64 oracle at its rtol
  1e-4 / atol 1e-9 with ``on`` exactly equal;
- port against JAX step by step at abstol 1e-7 / reltol 1e-6 (the solver
  tolerances of the gridded and oracle tests): the node state within 1e-4
  of its scale (2.5e-5 measured on the B01 grid, 12 steps), ``on`` and
  every counter equal but ``substeps_max``, within 2 (the most accepted
  substeps of any lane: on the periodic oracle configuration the port
  takes 15 and 11 where JAX takes 13 and 13 at steps 2 and 4, with the
  states within 4.6e-6; from the same input state the two integrators take
  the same substeps on every lane, so the last-ulp differences of the
  states carried in decide it, not the controller);
- the deposit alone within 2e-6 of the scale (another summation order:
  ``pic.segment_sum``'s scan against JAX's ``S.at[g].add`` in lane order);
- the seeded state within 2e-6 (the libraries' pow and exp part in the
  last ulp); the RHS and the transforms within 1e-6; the gridded 1D wind
  within 1e-6; checkpoints bit for bit.
"""

import math
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as JFR
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jwinds
from picles_tpu.models.wave_growth_1d import ParticleDefaults1D as JDefaults
from picles_tpu.models.wave_growth_1d import WaveGrowth1D as JModel
from picles_tpu.models.wave_growth_1d import WaveGrowth1DConfig as JConfig
from picles_tpu.models.wave_growth_1d import one_d_grid as j_grid
from picles_tpu.ops import pic as jpic
from picles_tpu.ops import rhs as jrhs
from picles_tpu.ops import transforms as jtr
from picles_tpu.simulation import checkpoint as jck
from picles_tpu.simulation.simulation import Simulation as JSimulation

import picles_torch as pt
from picles_torch import convert
from picles_torch.core import fetch_relations as FR
from picles_torch.ops import pic as tpic
from picles_torch.ops import transforms as ttr

from test_full_step_oracle_1d import Oracle1D

torch.set_num_threads(1)

G = 9.81
DT = 600.0
TIGHT = dict(abstol=1e-7, reltol=1e-6)
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped")


def _sett_kw(U10=10.0, DT=DT, **tols):
    ws = FR.MinimalWindsea_1d(U10, DT)
    return dict(log_energy_minimum=float(ws.lne), saving_step=DT,
                timestep=DT, total_time=2 * 24 * 3600.0, dt=1e-3,
                dtmin=1e-4, force_dtmin=True, **tols)


def _model(U10=10.0, DT=DT, nx=31, Lx=500e3, periodic=False, winds=None,
           **tols):
    """tests/test_model_1d_b01.py's ``_model`` on the port."""
    grid = pt.one_d_grid(0.0, Lx, nx, periodic=periodic, device="cpu")
    return pt.WaveGrowth1D(grid, winds or pt.constant_winds_1d(U10),
                           pt.ODESettings(**_sett_kw(U10, DT, **tols)),
                           config=pt.WaveGrowth1DConfig(
                               periodic_boundary=periodic))


def _jmodel(U10=10.0, DT=DT, nx=31, Lx=500e3, periodic=False, winds=None,
            **tols):
    """The same model in the JAX package, with the same settings."""
    return JModel(j_grid(0.0, Lx, nx, periodic=periodic),
                  winds or jwinds.constant_winds_1d(U10),
                  JSettings(**_sett_kw(U10, DT, **tols)),
                  config=JConfig(periodic_boundary=periodic))


def _dulov_energy(t, U10):
    """The analytic duration-limited JONSWAP energy through the Dulov
    tau -> fetch map (float64)."""
    tau = G * t / U10
    Xt = (tau / (FR.DULOV_A * FR.DULOV_XI_0X)) ** (1.0 / (1.0 - FR.DULOV_Q_X))
    fm = 3.5 * (G / U10) * Xt ** (-0.33)
    aj = 0.033 * (fm * U10 / G) ** 0.67
    return 0.31 * G ** 2 * aj * (fm * 2 * math.pi) ** (-4)


def _jmetrics(ms) -> dict:
    return {k: int(getattr(ms.metrics, k)) for k in COUNTERS + ("substeps_max",)}


# ---------------------------------------------------------------------------
# tests/test_model_1d_b01.py on the port
# ---------------------------------------------------------------------------


def test_seeding_1d():
    model = _model()
    ms = model.init_state()
    ws = FR.get_initial_windsea_1d(10.0, 600.0)
    assert bool(ms.particles.on[5])
    np.testing.assert_allclose(float(ms.state[5, 0]), float(ws.E), rtol=1e-5)
    np.testing.assert_allclose(float(ms.state[5, 1]),
                               float(ws.E) / (2 * float(ws.cg_bar_x)),
                               rtol=1e-5)


def test_boundary_nodes_stay_off_nonperiodic():
    model = _model(periodic=False)
    ms = model.init_state()
    for _ in range(4):
        ms = model.step(ms)
    assert float(ms.state[0, 0]) == 0.0
    assert not bool(ms.particles.on[0])
    assert not bool(ms.particles.on[-1])


def _b01_ratios(model, steps=72, node=15, every=24, U10=10.0):
    """The centre node's energy over the Dulov curve every ``every`` steps,
    and the final state."""
    ms = model.init_state()
    step = model.step if isinstance(model, pt.WaveGrowth1D) \
        else jax.jit(model.step)
    ratios = []
    for k in range(1, steps + 1):
        ms = step(ms)
        if k % every == 0:
            ratios.append(float(ms.state[node, 0]) / _dulov_energy(k * DT,
                                                                   U10))
    return ratios, ms


def _assert_dulov(ratios, ms):
    assert all(r1 > r2 for r1, r2 in zip(ratios, ratios[1:]))   # converging
    assert 0.7 < ratios[-1] < 1.6
    assert int(ms.metrics.n_failed) == 0


def test_b01_duration_limited_growth_converges_to_dulov():
    """The centre node's energy approaches the duration-limited curve from
    above and lands within ~60% after 12 h, on both packages."""
    ratios, ms = _b01_ratios(_model())
    _assert_dulov(ratios, ms)
    jratios, jms = _b01_ratios(_jmodel())
    _assert_dulov(jratios, jms)
    np.testing.assert_allclose(ratios, jratios, rtol=2e-2)


def _collapse(make):
    etils = []
    for U10 in (5.0, 10.0, 20.0):
        n = int(round(30000.0 * U10 / G / DT))
        model = make(U10=U10, nx=21, Lx=1000e3 * (U10 / 10.0) ** 2)
        ms, _ = model.step_n(model.init_state(), n)
        etils.append(float(ms.state[10, 0]) * G ** 2 / U10 ** 4)
    return np.array(etils)


def test_b01_nondimensional_collapse_across_wind_speeds():
    """E g^2 / U^4 at equal g t / U collapses across U10 (within 25% of the
    mean), on both packages."""
    for etils in (_collapse(_model), _collapse(_jmodel)):
        assert np.all(np.abs(etils / etils.mean() - 1.0) < 0.25), etils


def _fetch_profile(make):
    model = make(U10=10.0, nx=31, Lx=500e3)
    ms, _ = model.step_n(model.init_state(), 72)   # 12 h
    e = np.asarray(ms.state[:, 0])
    up = e[1:10]
    assert np.all(np.diff(up) > -1e-6)
    assert e[10] > e[2]
    return e


def test_b01_fetch_profile_monotone():
    """Energy grows with fetch from the upwind boundary, on both
    packages."""
    e = _fetch_profile(_model)
    je = _fetch_profile(_jmodel)
    np.testing.assert_allclose(e, je, rtol=2e-2, atol=1e-9)


def test_periodic_1d_homogeneous():
    model = _model(U10=10.0, nx=21, periodic=True)
    ms, _ = model.step_n(model.init_state(), 12)
    e = ms.state[:, 0].numpy()
    assert e.std() / e.mean() < 1e-3


def test_negative_wind_symmetric():
    """U10 -> -U10 mirrors the momentum sign and keeps the energy."""
    mp = _model(U10=10.0, nx=21, periodic=True)
    mn = _model(U10=-10.0, nx=21, periodic=True)
    sp, _ = mp.step_n(mp.init_state(), 6)
    sn, _ = mn.step_n(mn.init_state(), 6)
    np.testing.assert_allclose(sp.state[:, 0].numpy(), sn.state[:, 0].numpy(),
                               rtol=1e-3)
    np.testing.assert_allclose(sp.state[:, 1].numpy(),
                               -sn.state[:, 1].numpy(), rtol=1e-3)


def test_fixed_defaults_1d():
    d = pt.ParticleDefaults1D(lne=math.log(1e-4), cg_x=2.0)
    model = _model()
    model2 = pt.WaveGrowth1D(model.grid, model.winds, model.settings,
                             config=pt.WaveGrowth1DConfig(
                                 periodic_boundary=False, ode_init_type=d))
    ms = model2.init_state()
    np.testing.assert_allclose(float(ms.particles.z[4, 0]), d.lne, rtol=1e-6)
    assert bool(ms.particles.on.all())


def test_b01_growth_invariant_to_DT():
    """E(12 h) at the centre agrees within 5% across DT = 5, 10, 30 min."""
    energies = []
    for dt_ in (300.0, 600.0, 1800.0):
        model = _model(U10=10.0, DT=dt_, nx=31)
        ms, _ = model.step_n(model.init_state(), int(round(12 * 3600.0 / dt_)))
        energies.append(float(ms.state[15, 0]))
    m = np.mean(energies)
    assert np.all(np.abs(np.array(energies) / m - 1.0) < 0.05), energies


def test_b01_growth_invariant_to_resolution():
    """E(12 h) at the centre agrees within 2% across 21, 51 and 101 nodes."""
    energies = []
    for nx in (21, 51, 101):
        model = _model(U10=10.0, nx=nx, Lx=500e3)
        ms, _ = model.step_n(model.init_state(), 72)
        energies.append(float(ms.state[nx // 2, 0]))
    m = np.mean(energies)
    assert np.all(np.abs(np.array(energies) / m - 1.0) < 0.02), energies


# ---------------------------------------------------------------------------
# tests/test_full_step_oracle_1d.py on the port
# ---------------------------------------------------------------------------


def _oracle_run(nx, periodic, u_o, u_t, steps):
    """The float64 oracle and the port over ``steps`` steps at the
    oracle's tolerances (abstol 1e-7, reltol 1e-6)."""
    Lx, U = 200e3, 10.0
    orc = Oracle1D(nx, Lx, periodic, u_o, DT)
    z, on = orc.seed()
    t = 0.0
    states = []
    for _ in range(steps):
        z, on, S = orc.step(z, on, t)
        t += DT
        states.append(S.copy())
    kw = _sett_kw(U, DT, **TIGHT)
    kw["total_time"] = 6 * 24 * 3600.0
    model = pt.WaveGrowth1D(pt.one_d_grid(0.0, Lx, nx, periodic=periodic,
                                          device="cpu"),
                            pt.Winds1D(u=u_t), pt.ODESettings(**kw),
                            config=pt.WaveGrowth1DConfig(
                                periodic_boundary=periodic))
    ms = model.init_state()
    for k in range(steps):
        ms = model.step(ms)
        np.testing.assert_allclose(ms.state[:, :2].numpy(), states[k],
                                   rtol=1e-4, atol=1e-9,
                                   err_msg=f"periodic={periodic} step {k + 1}")
    np.testing.assert_array_equal(ms.particles.on.numpy(), on)
    return states


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["nonperiodic", "periodic"])
def test_full_step_1d_matches_f64_oracle(periodic):
    _oracle_run(8, periodic, lambda x, t: 10.0,
                lambda x, t: torch.full_like(x, 10.0, dtype=torch.float32), 3)


def test_full_step_1d_merge_rule_opposing_winds():
    """Converging half-domain winds: both momentum signs meet mid-domain and
    the sign-merge rule decides each node, against the oracle."""
    xsplit = 100e3
    states = _oracle_run(
        9, False, lambda x, t: 10.0 if x < xsplit else -10.0,
        lambda x, t: torch.where(x < xsplit, 10.0, -10.0).to(torch.float32),
        4)
    assert (states[-1][:, 1] > 0).any() and (states[-1][:, 1] < 0).any()


# ---------------------------------------------------------------------------
# tests/test_simulation_1d.py on the port
# ---------------------------------------------------------------------------


def _sim(stop=3000.0):
    model = _model(nx=21, Lx=200e3)
    return pt.Simulation.create(model, stop_time=stop)


def _jsim(stop=3000.0):
    return JSimulation.create(_jmodel(nx=21, Lx=200e3), stop_time=stop)


def test_1d_cash_store_run():
    sim = _sim()
    sim.run(cash_store=True)
    arr = sim.store.as_array()
    assert arr.shape == (7, 21, 3)   # the initial state and 6 steps
    assert arr[-1, 1:-1, 0].max() > arr[0, 1:-1, 0].max()
    jsim = _jsim()
    jsim.run(cash_store=True)
    ref = jsim.store.as_array()
    np.testing.assert_allclose(arr, ref, rtol=2e-2, atol=1e-9)


def test_1d_hdf5_store(tmp_path):
    """The store ``[time, x, state]`` with the wind ``u [t, x]`` beside it,
    in the JAX package's layout."""
    sim = _sim(stop=1800.0)
    sim.initialize()
    sim.init_state_store(str(tmp_path))
    sim.run(store=True)
    x = sim.model.grid.x.numpy()
    t = np.arange(sim.n_steps() + 1) * sim.dt
    U = np.full((len(t), len(x)), 10.0)
    sim.store.add_forcing(dict(u=U), dict(time=t, x=x))
    sim.store.close()

    jsim = _jsim(stop=1800.0)
    jsim.initialize()
    jsim.init_state_store(str(tmp_path / "jax"))
    jsim.run(store=True)
    jsim.store.add_forcing(dict(u=U), dict(time=t, x=x))
    jsim.store.close()
    with h5py.File(os.path.join(str(tmp_path), "state.h5")) as f, \
            h5py.File(os.path.join(str(tmp_path / "jax"), "state.h5")) as g:
        assert f["waves/data"].shape == (5, 21, 3)
        assert list(f["waves"].attrs["dims"]) == ["time", "x", "state"]
        assert "forcing/u" in f
        assert f["forcing/u"].shape == (5, 21)
        for k in ("time", "x", "state", "var_names"):
            np.testing.assert_array_equal(f[f"waves/{k}"][()],
                                          g[f"waves/{k}"][()])
        assert list(f["forcing"].attrs["dims"]) == \
            list(g["forcing"].attrs["dims"])
        np.testing.assert_allclose(f["waves/data"][()], g["waves/data"][()],
                                   rtol=2e-2, atol=1e-9)


def test_1d_checkpoint_resume(tmp_path):
    """A run checkpointed, picked up by a longer run and continued; the
    resumed run is the uninterrupted one bit for bit."""
    sim = _sim()
    sim.run()
    p = sim.checkpoint(str(tmp_path / "ck1d"))
    sim2 = _sim(stop=6000.0)
    sim2.pickup(p)
    assert sim2.state.particles.z.device.type == "cpu"
    sim2.run()
    assert float(sim2.state.time) > float(sim.state.time)
    assert np.all(np.isfinite(sim2.state.state.numpy()))
    full = _sim(stop=6000.0)
    full.run()
    for a, b in zip(sim2.state.leaves(), full.state.leaves()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the port against JAX
# ---------------------------------------------------------------------------


def _compare_steps(tm, jm, steps, rtol=1e-4):
    """Both models from their own seeds, step by step: the node state within
    ``rtol`` of its scale, ``on`` and the counters equal (``substeps_max``
    within 2); returns the per-step gaps."""
    ts, js = tm.init_state(), jm.init_state()
    np.testing.assert_allclose(ts.state.numpy(), np.asarray(js.state),
                               rtol=2e-6, atol=1e-12)
    step = jax.jit(jm.step)
    gaps = []
    for k in range(steps):
        ts, js = tm.step(ts), step(js)
        a, b = ts.state.numpy(), np.asarray(js.state)
        gaps.append(float(np.abs(a - b).max() / np.abs(b).max()))
        assert gaps[-1] <= rtol, (k + 1, gaps)
        np.testing.assert_array_equal(ts.particles.on.numpy(),
                                      np.asarray(js.particles.on))
        tmet, jmet = ts.metrics.as_dict(), _jmetrics(js)
        for c in COUNTERS:
            assert tmet[c] == jmet[c], (k + 1, c, tmet[c], jmet[c])
        assert abs(tmet["substeps_max"] - jmet["substeps_max"]) <= 2
    return gaps


def test_step_matches_jax_on_b01_grid():
    """The B01 grid (31 nodes over 500 km, open ends) at abstol 1e-7 /
    reltol 1e-6, 12 steps: within 1e-4 (2.5e-5 measured)."""
    _compare_steps(_model(**TIGHT), _jmodel(**TIGHT), 12)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["nonperiodic", "periodic"])
def test_step_matches_jax_on_oracle_config(periodic):
    """The oracle's configuration (8 nodes over 200 km, constant 10 m/s) at
    its tolerances, 12 steps."""
    kw = dict(nx=8, Lx=200e3, periodic=periodic, **TIGHT)
    _compare_steps(_model(**kw), _jmodel(**kw), 12)


def test_step_matches_jax_opposing_winds():
    """Converging half-domain winds (the merge rule at work), 12 steps."""
    xs = 100e3
    kw = dict(nx=9, Lx=200e3, **TIGHT)
    tm = _model(winds=pt.Winds1D(
        u=lambda x, t: torch.where(x < xs, 10.0, -10.0).to(torch.float32)),
        **kw)
    jm = _jmodel(winds=jwinds.Winds1D(
        u=lambda x, t: jnp.where(jnp.asarray(x) < xs, 10.0,
                                 -10.0).astype(jnp.float32)), **kw)
    _compare_steps(tm, jm, 12)


def test_b01_tolerances_gap_to_jax():
    """At B01's own tolerances (abstol 1e-4, reltol 1e-3) the controller
    starts every reseeded lane from dt0 = 1e-3 s on a young sea, and the
    libraries' last-ulp differences take other substep paths: the per-step
    gap to JAX on the B01 grid, measured over 12 steps, is 1.5e-5, 1.3e-3,
    9.4e-3, 2.9e-3, 4.1e-4, 1.2e-4, then 3.2e-5 to 6.5e-5 of the state's
    scale (the 2D wind pulse parts by 2.4e-2 at step 1 for the same
    reason).  So the outcomes B01 asserts are held on both packages (the
    Dulov, collapse and fetch-profile tests above), and here the counters
    equal while the gap closes again."""
    tm, jm = _model(), _jmodel()
    ts, js = tm.init_state(), jm.init_state()
    step = jax.jit(jm.step)
    for k in range(12):
        ts, js = tm.step(ts), step(js)
        tmet, jmet = ts.metrics.as_dict(), _jmetrics(js)
        for c in ("n_active", "n_failed", "n_gather", "n_reseed", "n_off"):
            assert tmet[c] == jmet[c], (k + 1, c)
    a, b = ts.state.numpy(), np.asarray(js.state)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-3


def _deposit_inputs(seed, n, nx, opposing):
    rng = np.random.default_rng(seed)
    Lx = 200e3
    x = rng.uniform(-0.2 * Lx, 1.2 * Lx, n).astype(np.float32)
    e = rng.uniform(0.1, 1.0, n).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0) if opposing \
        else np.ones(n)
    m = (sign * rng.uniform(0.01, 0.1, n)).astype(np.float32)
    ch = np.stack([e, m, np.zeros_like(e)], axis=-1)
    act = rng.random(n) > 0.1
    return x, ch, act, 0.0, Lx / (nx - 1)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
@pytest.mark.parametrize("kind", ["add", "merge"])
def test_deposit_1d_matches_jax(kind, periodic):
    """``scatter_1d_add`` / ``scatter_1d_merge`` of opposing momenta, with
    positions past both ends, against JAX's within 2e-6 of the scale; two
    runs bit for bit."""
    nx = 17
    x, ch, act, xmin, dx = _deposit_inputs(7, 200, nx, opposing=True)
    tf = getattr(tpic, f"scatter_1d_{kind}")
    jf = getattr(jpic, f"scatter_1d_{kind}")
    T = tf(torch.as_tensor(x), torch.as_tensor(ch), torch.as_tensor(act),
           xmin, dx, nx, periodic)
    J = np.asarray(jf(jnp.asarray(x), jnp.asarray(ch), jnp.asarray(act),
                      xmin, dx, nx, periodic))
    assert T.shape == (nx, 3)
    np.testing.assert_allclose(T.numpy(), J, rtol=0,
                               atol=2e-6 * np.abs(J).max())
    T2 = tf(torch.as_tensor(x), torch.as_tensor(ch), torch.as_tensor(act),
            xmin, dx, nx, periodic)
    assert torch.equal(T, T2)
    if kind == "merge":   # both signs win somewhere
        assert (J[:, 1] > 0).any() and (J[:, 1] < 0).any()


def test_segment_sum_against_float64():
    """``segment_sum`` of many rows a key against a float64 sum: within
    1e-6 of each key's absolute sum, keys with no row zero."""
    rng = np.random.default_rng(11)
    n, M = 50, 20000
    keys = rng.integers(0, n - 5, M)
    vals = rng.normal(size=(M, 2)).astype(np.float32)
    S = tpic.segment_sum(torch.as_tensor(keys), torch.as_tensor(vals), n)
    ref = np.zeros((n, 2))
    mag = np.zeros((n, 2))
    np.add.at(ref, keys, vals.astype(np.float64))
    np.add.at(mag, keys, np.abs(vals).astype(np.float64))
    assert np.all(np.abs(S.numpy() - ref) <= 1e-6 * mag)
    assert np.all(S.numpy()[n - 5:] == 0)


def test_rhs_1d_matches_jax():
    """``particle_equations_1d`` on random young and old seas, both wind
    signs, every term flag set: within 1e-6 of each component's scale."""
    rng = np.random.default_rng(5)
    n = 64
    z = np.stack([rng.uniform(-12.0, 0.0, n),
                  rng.uniform(-8.0, 8.0, n),
                  rng.uniform(0.0, 1e5, n)], axis=-1).astype(np.float32)
    xs = rng.uniform(0.0, 1e5, n).astype(np.float32)

    def ju(x, t):
        return jnp.where(jnp.asarray(x) < 5e4, 12.0, -7.0).astype(jnp.float32)

    def tu(x, t):
        return torch.where(x < 5e4, 12.0, -7.0).to(torch.float32)

    for flags in ({}, dict(input=False), dict(dissipation=False),
                  dict(peak_shift=False), dict(propagation=False)):
        J = np.asarray(jrhs.particle_equations_1d(
            ju, flags=jrhs.TermFlags(**flags))(0.0, jnp.asarray(z),
                                               jnp.asarray(xs)))
        T = pt.particle_equations_1d(tu, flags=pt.TermFlags(**flags))(
            0.0, torch.as_tensor(z), torch.as_tensor(xs)).numpy()
        scale = np.abs(J).max(axis=0)
        np.testing.assert_allclose(T, J, rtol=0, atol=1e-6 * scale.max(),
                                   err_msg=str(flags))


def test_transforms_and_fetch_relations_1d():
    """The 1D transforms (the tiny floors included) and the 1D windsea
    relations against JAX."""
    rng = np.random.default_rng(2)
    lne = rng.uniform(-12, 0, 40).astype(np.float32)
    cg = np.concatenate([rng.uniform(-9, 9, 38), [0.0, -0.0]]).astype(
        np.float32)
    for a, b in zip(ttr.particle_to_node_1d(torch.as_tensor(lne),
                                            torch.as_tensor(cg)),
                    jtr.particle_to_node_1d(jnp.asarray(lne),
                                            jnp.asarray(cg))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    e = np.concatenate([rng.uniform(0, 1, 38), [0.0, 1e-3]]).astype(np.float32)
    m = np.concatenate([rng.uniform(-1, 1, 38), [0.5, 0.0]]).astype(np.float32)
    for a, b in zip(ttr.node_to_particle_1d(torch.as_tensor(e),
                                            torch.as_tensor(m)),
                    jtr.node_to_particle_1d(jnp.asarray(e), jnp.asarray(m))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    u = np.array([-20.0, -3.0, -0.5, 0.0, 0.5, 3.0, 20.0], np.float32)
    for f in ("E", "lne", "cg_bar_x", "cg_bar_y", "m_x", "m_y"):
        np.testing.assert_allclose(
            getattr(FR.get_initial_windsea_1d(torch.as_tensor(u), DT),
                    f).numpy(),
            np.asarray(getattr(JFR.get_initial_windsea_1d(u, DT), f)),
            rtol=2e-6, err_msg=f)
        np.testing.assert_allclose(
            getattr(FR.MinimalWindsea_1d(torch.as_tensor(u), DT), f).numpy(),
            np.asarray(getattr(JFR.MinimalWindsea_1d(u, DT), f)),
            rtol=2e-6, err_msg=f)


def test_gridded_winds_1d_edge_modes_match_jax():
    """``GriddedWinds1D`` under the three mode pairs of
    tests/test_gridded_winds.py:254-283 (wrap/clamp, wrap/wrap,
    nearest/wrap): that test's asserts on the port, and the interpolant at
    points in and beyond the record against JAX's, the interval [n - 1, n)
    of a wrapped axis too."""
    rng = np.random.default_rng(13)
    nxw, ntw = 6, 4
    u = rng.uniform(5.0, 10.0, (nxw, ntw)).astype(np.float32)
    kw = dict(x0=0.0, dx=10e3, t0=0.0, dt=600.0)
    tu = torch.as_tensor(u)
    gw = pt.GriddedWinds1D(u_data=tu, **kw)
    np.testing.assert_allclose(float(gw.u(nxw * 10e3, 0.0)), u[0, 0],
                               rtol=1e-6)
    for t_late in (1800.0, 3600.0, 86400.0):
        np.testing.assert_allclose(float(gw.u(20e3, t_late)), u[2, -1],
                                   rtol=1e-6)
    gw_wrap = pt.GriddedWinds1D(u_data=tu, mode_t="wrap", **kw)
    np.testing.assert_allclose(float(gw_wrap.u(20e3, ntw * 600.0)), u[2, 0],
                               rtol=1e-6)
    gw_cl = pt.GriddedWinds1D(u_data=tu, mode="nearest", mode_t="wrap", **kw)
    np.testing.assert_allclose(float(gw_cl.u(-5e3, 600.0)), u[0, 1],
                               rtol=1e-6)

    x = rng.uniform(-30e3, 90e3, 200).astype(np.float32)
    t = rng.uniform(-900.0, 4000.0, 200).astype(np.float32)
    x[:10] = rng.uniform(50e3, 60e3, 10)   # the wrapped interval [n-1, n)
    for mode, mode_t in (("wrap", "clamp"), ("wrap", "wrap"),
                         ("nearest", "wrap")):
        jg = jwinds.GriddedWinds1D(u_data=jnp.asarray(u), mode=mode,
                                   mode_t=mode_t, **kw)
        tg = convert.gridded1d_from_jax(jg, device="cpu")
        assert (tg.mode, tg.mode_t) == (mode, mode_t)
        np.testing.assert_allclose(
            tg.u(torch.as_tensor(x), torch.as_tensor(t)).numpy(),
            np.asarray(jg.u(jnp.asarray(x), jnp.asarray(t))), rtol=1e-6,
            err_msg=f"{mode}/{mode_t}")


def test_gridded_model_and_blob_match_jax():
    """A model forced by ``idealized_wind_grid_1d`` of ``slopped_blob`` (the
    reference's moving blob), periodic, against JAX's at the tight
    tolerances, 6 steps; the blob itself within 1e-6."""
    Lx, T = 500e3, 6 * 3600.0
    blob = dict(U10=15.0, V=10.0, T=T, x_scale=80e3, t_scale=2 * 3600.0,
                x0=100e3)
    xs = np.linspace(0.0, Lx, 11).astype(np.float32)
    np.testing.assert_allclose(
        pt.forcing.winds.slopped_blob(torch.as_tensor(xs), 1800.0,
                                      **blob).numpy(),
        np.asarray(jwinds.slopped_blob(jnp.asarray(xs), 1800.0, **blob)),
        rtol=1e-6)

    def u(x, t):
        return float(np.asarray(jwinds.slopped_blob(x, t, **blob)))

    jg = jwinds.idealized_wind_grid_1d(u, Lx, T, 25e3, 1200.0)
    tg = pt.forcing.winds.idealized_wind_grid_1d(u, Lx, T, 25e3, 1200.0,
                                                 device="cpu")
    np.testing.assert_array_equal(tg.u_data.numpy(), np.asarray(jg.u_data))
    kw = dict(nx=21, Lx=Lx, periodic=True, **TIGHT)
    _compare_steps(_model(winds=tg, **kw), _jmodel(winds=jg.as_winds(), **kw),
                   6)


def test_checkpoint_written_by_jax_resumes_in_port(tmp_path):
    """An npz checkpoint of JAX's 1D state read by the port: every leaf
    bit for bit, then a step of each within the tight tolerances' bound."""
    jm = _jmodel(**TIGHT)
    js = jax.jit(jm.step)(jm.init_state())
    p = jck.save_checkpoint(str(tmp_path / "j1d"), js)
    ts = pt.load_checkpoint(p, device="cpu")
    assert isinstance(ts, pt.ModelState1D)
    for a, b in zip(ts.leaves(), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts = _model(**TIGHT).step(ts)
    js = jax.jit(jm.step)(js)
    np.testing.assert_allclose(ts.state.numpy(), np.asarray(js.state),
                               rtol=0, atol=1e-4 * np.abs(js.state).max())


def test_checkpoint_written_by_port_resumes_in_jax(tmp_path):
    """The port's 1D checkpoint read by ``picles_tpu``: the kind, the leaf
    count and every leaf bit for bit; ``convert`` carries the state both
    ways too."""
    tm = _model(**TIGHT)
    ts = tm.step(tm.init_state())
    p = pt.save_checkpoint(str(tmp_path / "t1d"), ts)
    with np.load(p) as f:
        assert b'"ModelState1D"' in bytes(f["__meta__"].item())
    js = jck.load_checkpoint(p)
    assert type(js).__name__ == "ModelState1D"
    for a, b in zip(ts.leaves(), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d = convert.state1d_to_numpy(ts)
    back = convert.state1d_from_numpy(
        d["state"], d, d["time"], d["iteration"], device="cpu",
        metrics=d["metrics"])
    for a, b in zip(back.leaves(), ts.leaves()):
        assert torch.equal(a, b)


def test_convert_1d_grid_and_config():
    jg = j_grid(-10e3, 290e3, 13, periodic=True)
    tg = convert.grid1d_from_numpy(np.asarray(jg.x), jg.stats, device="cpu")
    assert tg.stats == pt.one_d_grid(-10e3, 290e3, 13, True,
                                     device="cpu").stats
    np.testing.assert_array_equal(tg.x.numpy(), np.asarray(jg.x))
    for cfg in (JConfig(), JConfig(periodic_boundary=False, merge_rule=False,
                                   ode_init_type=JDefaults(-5.0, 1.5),
                                   boundary_type="wind_sea")):
        tc = convert.config1d_from_jax(cfg)
        assert tc.periodic_boundary == cfg.periodic_boundary
        assert tc.merge_rule == cfg.merge_rule
        assert tc.boundary_type == cfg.boundary_type
        assert tc.dtype == torch.float32
    assert tc.ode_init_type == pt.ParticleDefaults1D(-5.0, 1.5, 0.0)


def test_init_modes_and_refusals_match_jax():
    """The "mininmal" seed (every node on), the add deposit, and the
    validation of ``ode_init_type``/``boundary_type``, as in JAX."""
    for cfg in (dict(ode_init_type="mininmal"), dict(merge_rule=False),
                dict(boundary_type="wind_sea")):
        kw = dict(periodic_boundary=False, **cfg)
        tm = pt.WaveGrowth1D(pt.one_d_grid(0.0, 200e3, 9, device="cpu"),
                             pt.constant_winds_1d(10.0),
                             pt.ODESettings(**_sett_kw(**TIGHT)),
                             config=pt.WaveGrowth1DConfig(**kw))
        jm = JModel(j_grid(0.0, 200e3, 9), jwinds.constant_winds_1d(10.0),
                    JSettings(**_sett_kw(**TIGHT)), config=JConfig(**kw))
        _compare_steps(tm, jm, 3)
    for bad in (dict(ode_init_type="minimal"), dict(boundary_type="open")):
        with pytest.raises(ValueError):
            pt.WaveGrowth1D(pt.one_d_grid(0.0, 200e3, 9, device="cpu"),
                            pt.constant_winds_1d(10.0),
                            pt.ODESettings(**_sett_kw()),
                            config=pt.WaveGrowth1DConfig(**bad))
        with pytest.raises(ValueError):
            JModel(j_grid(0.0, 200e3, 9), jwinds.constant_winds_1d(10.0),
                   JSettings(**_sett_kw()), config=JConfig(**bad))
