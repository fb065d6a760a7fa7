"""The port's particle tools (``picles_torch/utils/particle_tools.py``)
against the JAX package's (``picles_tpu/utils/particle_tools.py``), on the
CPU: ``record_trajectories`` on 2D, gridded, layered and 1D models, with
and without sub-DT saving, and the DataFrame converters.

Tolerances: the histories of a fixed-substep model at rtol 1e-5 and 1e-6
of each component's scale (tests/test_torch_rhs_tsit5.py's bound for the
same float32 operations: the libraries' transcendentals differ in the last
ulp); of an adaptive model at the JAX suite's cross-backend bound rtol
5e-3 (the controller may turn an ulp into another substep path,
tests/test_torch_model_2d.py); of the gridded record at the tight solver
tolerances of tests/test_torch_gridded_winds.py, rtol 2e-4 (that file's
oracle-case bound); clocks, ``on`` flags and iteration masks exactly; a
layered history against its layers' single-layer histories at rtol 2e-3
(tests/test_torch_layers.py's CPU bound: ``torch.pow`` and ``torch.atan2``
evaluate a tensor's tail with scalar libm), bit for bit with per-layer
winds (one model a layer), and the port's history bit for bit its own
``step_n``.  DataFrames:
columns and dtypes equal, values at the history's tolerance.
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_1d import WaveGrowth1D as JModel1D
from picles_tpu.models.wave_growth_1d import WaveGrowth1DConfig as JConfig1D
from picles_tpu.models.wave_growth_1d import one_d_grid as j_grid1d
from picles_tpu.models.wave_growth_2d import LayeredWaveGrowth2D as JLayered
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.ops.tsit5 import integrate_to as j_integrate_to
from picles_tpu.utils import particle_tools as JPT

import picles_torch as pt
from picles_torch import convert
from picles_torch.ops.tsit5 import integrate_to as t_integrate_to
from picles_torch.utils import particle_tools as TPT
from test_torch_gridded_winds import _pair
from test_torch_gridded_winds import _port as gridded_port
from test_torch_gridded_winds import _settings as gridded_settings
from test_torch_model_2d import port_of

torch.set_num_threads(1)

DT = 600.0


def _sett(**kw):
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    base = dict(log_energy_minimum=float(ws.lne), saving_step=DT,
                timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3, dtmin=1e-4,
                force_dtmin=True)
    base.update(kw)
    return JSettings(**base)


def _fixed_sett():
    """tests/test_utils_and_checkpoint.py:211's sub-DT settings: fixed 30 s
    substeps, a 150 s saving step (K = 4)."""
    return _sett(saving_step=150.0, dt=30.0, adaptive=False)


def _pair_2d(n, sett, u=10.0, v=10.0, **cfg):
    jm = JModel(j_box(100e3, n, 100e3, n, periodic_boundary=(True, True)),
                jw.constant_winds(u, v), sett,
                config=JConfig(periodic_boundary=True, **cfg))
    return jm, port_of(jm, pt.constant_winds(u, v))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_fixed(got, want, what):
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape)
    scale = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    bad = np.abs(g - w) > 1e-5 * np.abs(w) + 1e-6 * scale
    assert not bad.any(), (what, int(bad.sum()), np.abs(g - w).max())


def _hist_pair(jm, tm, n, **kw):
    jfinal, jh = JPT.record_trajectories(jm, jm.init_state(), n, **kw)
    tfinal, th = TPT.record_trajectories(tm, tm.init_state(), n, **kw)
    assert set(th) == set(jh)
    return jfinal, jh, tfinal, th


def test_record_trajectories_sub_dt_matches_jax():
    """tests/test_utils_and_checkpoint.py:203: fixed substeps, K = 4; the
    port's histories (per step and per window) against JAX's, and that
    test's own checks on the port's."""
    jm, tm = _pair_2d(9, _fixed_sett())
    jfinal, jh, tfinal, th = _hist_pair(jm, tm, 3)
    K = 4
    assert th["z_fine"].shape == (3 * K, 9, 9, 5)
    assert th["t_fine"].shape == (3 * K, 9, 9)
    for k in ("z", "z_fine", "state"):
        _close_fixed(th[k], jh[k], k)
    for k in ("t", "t_fine", "on"):
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]), k)
    _close_fixed(tfinal.state, jfinal.state, "final state")
    tf = th["t_fine"].numpy()[:, 4, 4]
    np.testing.assert_allclose(tf, 150.0 * np.arange(1, 3 * K + 1),
                               rtol=1e-6)
    lne_fine = th["z_fine"].numpy()[:, 4, 4, 0]
    assert np.all(np.diff(lne_fine[:K]) > 0)
    ms = tm.init_state()
    P = ms.particles
    res = t_integrate_to(tm.rhs, TPT.particle_z(P), P.t, P.t + DT, P.dt,
                         tm.aux, P.on & tm.active_mask, tm.solver)
    np.testing.assert_allclose(lne_fine[K - 1], res.z.numpy()[4, 4, 0],
                               rtol=1e-6)


def test_record_trajectories_adaptive_matches_jax():
    """The default adaptive model (tests/test_utils_and_checkpoint.py:103,
    15^2, 4 steps; K = 1): histories at rtol 5e-3, ``on`` and clocks
    exactly, and that test's DataFrame checks on the port's history."""
    jm, tm = _pair_2d(15, _sett())
    jfinal, jh, tfinal, th = _hist_pair(jm, tm, 4)
    assert "z_fine" not in th and th["z"].shape == (4, 15, 15, 5)
    for k in ("z", "state"):
        np.testing.assert_allclose(_np(th[k]), np.asarray(jh[k]), rtol=5e-3,
                                   atol=1e-9, err_msg=k)
    for k in ("t", "on"):
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]), k)
    df = TPT.particle_to_dataframe(th["z"], th["t"], (7, 7))
    assert list(df.columns[:6]) == ["time", "lne", "cgx", "cgy", "x", "y"]
    assert len(df) == 4 and (df["E"] > 0).all()
    assert df["time"].is_monotonic_increasing


def test_record_trajectories_equals_step_n():
    """Each row of the history is the state after that step: the final
    state and the stacked node states equal ``step_n``'s bit for bit (on
    the card the same holds of the graph's replays, tests/test_torch_cuda.py
    and chip_smoke.py)."""
    _, tm = _pair_2d(9, _sett())
    ms = tm.init_state()
    final, h = TPT.record_trajectories(tm, ms, 3)
    ref, states = tm.step_n(ms, 3)
    assert torch.equal(h["state"], states)
    for a, b in zip(final.leaves(), ref.leaves()):
        assert torch.equal(a, b)
    assert torch.equal(h["z"][-1], TPT.particle_z(ref.particles))


def test_record_trajectories_gridded_matches_jax():
    """A gridded record (tests/test_full_step_oracle.py:711's: 900 s
    cadence, so windows cross a frame) with a 200 s saving step (K = 3,
    the sub-windows of the plain path sampling the interpolant in each):
    the port's histories against JAX's at rtol 2e-4."""
    nxw = nyw = 5
    rng = np.random.default_rng(23)
    u = (9.0 + 1.5 * rng.standard_normal((8, nxw, nyw))).astype(np.float32)
    v = (4.0 + rng.standard_normal((8, nxw, nyw))).astype(np.float32)
    jg, tg = _pair(u, v, x0=0.0, dx=100e3 / 4, y0=0.0, dy=100e3 / 4, t0=0.0,
                   dt=900.0)
    grid = j_box(100e3, 6, 100e3, 6, periodic_boundary=(True, True))
    jm = JModel(grid, jg.as_winds(), gridded_settings(saving_step=200.0),
                config=JConfig(periodic_boundary=True))
    tm = gridded_port(jm, tg)
    assert tm.gridded_winds is not None
    jfinal, jh, tfinal, th = _hist_pair(jm, tm, 3)
    assert th["z_fine"].shape == (9, 6, 6, 5)
    for k in ("z", "z_fine", "state"):
        np.testing.assert_allclose(_np(th[k]), np.asarray(jh[k]), rtol=2e-4,
                                   atol=1e-9, err_msg=k)
    for k in ("t", "t_fine", "on"):
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]), k)
    np.testing.assert_allclose(th["t_fine"].numpy()[:3, 2, 2],
                               [200.0, 400.0, 600.0])


def _pair_1d(sett):
    jm = JModel1D(j_grid1d(0.0, 200e3, 11, periodic=False),
                  jw.constant_winds_1d(10.0), sett,
                  config=JConfig1D(periodic_boundary=False))
    g = jm.grid
    grid = convert.grid1d_from_numpy(np.asarray(g.x), g.stats, device="cpu")
    tset, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    tm = pt.WaveGrowth1D(grid, pt.constant_winds_1d(10.0), tset,
                         ode_params=params, constants=cid,
                         config=convert.config1d_from_jax(jm.config))
    return jm, tm


def test_record_trajectories_1d_matches_jax():
    """tests/test_utils_and_checkpoint.py:281: the 1D model's sub-DT
    histories (K = 4) advance its step's lanes only (boundary lanes held),
    against JAX's at rtol 5e-3 (adaptive)."""
    ws = jfr.MinimalWindsea_1d(10.0, DT)
    jm, tm = _pair_1d(_sett(log_energy_minimum=float(ws.lne),
                            saving_step=150.0, total_time=6 * 3600.0))
    jfinal, jh, tfinal, th = _hist_pair(jm, tm, 2)
    zf = th["z_fine"].numpy()
    assert zf.shape == (8, 11, 3)
    z0 = tm.init_state().particles.z.numpy()
    for k in range(4):
        np.testing.assert_array_equal(zf[k, 0], z0[0])
    assert not np.allclose(zf[0, 5], z0[5])
    for k in ("z", "z_fine", "state"):
        np.testing.assert_allclose(_np(th[k]), np.asarray(jh[k]), rtol=5e-3,
                                   atol=1e-9, err_msg=k)
    for k in ("t", "t_fine", "on"):
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]), k)
    df = TPT.particle_to_dataframe(th["z_fine"], th["t_fine"], (5,))
    jdf = JPT.particle_to_dataframe(jh["z_fine"], jh["t_fine"], (5,))
    assert list(df.columns) == list(jdf.columns) == [
        "time", "lne", "cgx", "x", "E", "mx", "mask"]


def _swell(L):
    return [pt.ParticleDefaults2D(-6.0 + 0.5 * i, 1.0 + 0.3 * i, -0.2 * i)
            for i in range(L)]


def test_record_trajectories_layered():
    """A layered model (three swell systems, fixed substeps, K = 4) through
    ``LayeredWaveGrowth2D``: its histories against JAX's layered driver at
    K = 1 (JAX's sub-window advance reads the model's RHS, which its
    layered driver has not); at K = 4 each layer's rows against the same
    layer run as a single-layer model at rtol 2e-3, and the per-layer-winds
    driver's rows bit for bit each layer model's own."""
    L = 3
    sett = _fixed_sett()
    jm, tm = _pair_2d(8, sett, layers=L)
    defaults = _swell(L)
    jdefaults = [jw_defaults(d) for d in defaults]
    jlay = JLayered(jm, per_layer_defaults=jdefaults)
    tlay = tm.as_layered(per_layer_defaults=defaults)
    _, jh = JPT.record_trajectories(jlay, jlay.init_state(), 2,
                                    saving_step=DT)
    _, th = TPT.record_trajectories(tlay, tlay.init_state(), 2,
                                    saving_step=DT)
    for k in ("z", "state"):
        _close_fixed(th[k], jh[k], f"layered {k}")
    np.testing.assert_array_equal(th["on"].numpy(), np.asarray(jh["on"]))

    _, th4 = TPT.record_trajectories(tlay, tlay.init_state(), 2)
    assert th4["z_fine"].shape == (8, L, 8, 8, 5)
    single = dataclasses.replace(sett)
    for i, d in enumerate(defaults):
        _, one = _pair_2d(8, single, ode_init_type=jw_defaults(d))
        _, h1 = TPT.record_trajectories(one, one.init_state(), 2)
        for k in ("z", "z_fine", "t_fine", "state"):
            np.testing.assert_allclose(th4[k][:, i].numpy(), h1[k].numpy(),
                                       rtol=2e-3, atol=1e-9,
                                       err_msg=f"layer {i} {k}")
    winds = [pt.constant_winds(10.0, 10.0), pt.constant_winds(6.0, -3.0),
             pt.constant_winds(0.5, 12.0)]
    per = tm.as_layered(per_layer_defaults=defaults, per_layer_winds=winds)
    _, hp = TPT.record_trajectories(per, per.init_state(), 2)
    for i, w in enumerate(winds):
        m = tm.with_winds(w)
        s = m.init_state(defaults=defaults[i])
        _, h1 = TPT.record_trajectories(m, s, 2)
        for k in ("z", "z_fine", "t_fine", "state"):
            assert torch.equal(hp[k][:, i], h1[k]), (i, k)


def jw_defaults(d):
    """The JAX package's particle defaults of the port's."""
    from picles_tpu.models.wave_growth_2d import ParticleDefaults2D

    return ParticleDefaults2D(d.lne, d.cg_x, d.cg_y, d.x, d.y)


def test_record_trajectories_refuses_other_models():
    with pytest.raises(TypeError, match="no sub-window advance"):
        TPT.record_trajectories(_Stub(), None, 1, saving_step=300.0)


class _Stub:
    settings = pt.ODESettings()
    graphed = False


# ---------------------------------------------------------------------------
# DataFrames
# ---------------------------------------------------------------------------

def test_dataframes_match_jax():
    """The converters on the same histories: columns, dtypes, values."""
    jm, tm = _pair_2d(9, _fixed_sett())
    jfinal, jh, tfinal, th = _hist_pair(jm, tm, 2)
    cells = [(1, 2), (4, 4), (8, 0)]
    for df, jdf in zip(TPT.particles_to_dataframes(th["z_fine"], th["t_fine"],
                                                   cells),
                       JPT.particles_to_dataframes(jh["z_fine"], jh["t_fine"],
                                                   cells)):
        assert list(df.columns) == list(jdf.columns)
        assert list(df.dtypes) == list(jdf.dtypes)
        np.testing.assert_array_equal(df["mask"], jdf["mask"])
        np.testing.assert_array_equal(df["time"], jdf["time"])
        for c in ("lne", "cgx", "cgy", "x", "y", "E", "mx", "my"):
            np.testing.assert_allclose(df[c], jdf[c], rtol=1e-5, atol=1e-9,
                                       err_msg=c)
    sdf, jsdf = (TPT.state_to_dataframe(th["state"][-1], tm.grid),
                 JPT.state_to_dataframe(jh["state"][-1], jm.grid))
    assert list(sdf.columns) == list(jsdf.columns) == ["x", "y", "e", "m_x",
                                                       "m_y"]
    np.testing.assert_array_equal(sdf[["x", "y"]], jsdf[["x", "y"]])
    np.testing.assert_allclose(sdf[["e", "m_x", "m_y"]],
                               jsdf[["e", "m_x", "m_y"]], rtol=1e-5,
                               atol=1e-12)
    assert TPT.metrics_to_dict(tfinal) == JPT.metrics_to_dict(jfinal)
    assert isinstance(sdf, pd.DataFrame)


def test_iteration_mask():
    t = np.array([0.0, 1.0, 2.0, 0.5, 1.5, 0.2])
    np.testing.assert_array_equal(TPT.create_iteration_mask(t),
                                  [1, 1, 1, 2, 2, 3])
    np.testing.assert_array_equal(TPT.create_iteration_mask(t),
                                  JPT.create_iteration_mask(t))


def test_metrics_to_dict_sums_layers():
    _, tm = _pair_2d(8, _fixed_sett(), layers=2)
    ms = tm.step_layers(tm.init_state_layers())
    d = TPT.metrics_to_dict(ms)
    assert d["n_active"] == 2 * 64 and all(isinstance(v, int)
                                           for v in d.values())
