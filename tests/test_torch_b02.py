"""The B02 regression on the port: tests/test_b02_resolution_convergence.py
(stored runs under the same NetCDF wind forcing at resolutions scaled by
sqrt(2), and a DT refinement) through ``picles_torch``'s ``Simulation.run``
with its HDF5 store, on the CPU, with that test's assertions; and the
port's final Hs field at nx = 16 against the JAX package's.

The wind file, the non-periodic box, the resolutions (11, 16, 23), the 4 h
at DT 600 s and 300 s and the bounds are the JAX test's.  Port against JAX:
both at the gridded tests' solver tolerances, abstol 1e-7 and reltol 1e-6
(tests/test_torch_gridded_winds.py: at the default ones the young seas of a
record leave the error controller at the edge of accepting), the Hs fields
held at rtol 1e-4 with an atol of 1e-6 of the field's largest value
(2.5e-6 measured; the whole-model bound of tests/test_torch_gridded_winds.py
is rtol 1e-3 on E after 8 steps, and Hs = 4 sqrt(E) halves E's relative
error).  Measured on the CPU: successive RMS differences 0.0172 and
0.0123 (the JAX test's note: about 0.017 and 0.012), DT refinement 0.0121
(about 0.013).
"""

import math
import os

import h5py
import numpy as np
import pytest
import torch
from scipy.interpolate import RegularGridInterpolator

from picles_tpu.core import fetch_relations as JFR
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing.winds import load_gridded_winds_2d as j_load
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.simulation.simulation import Simulation as JSimulation

import picles_torch as pt
from picles_torch.core import fetch_relations as TFR

torch.set_num_threads(1)

L = 200e3
DT = 600.0
T = 4 * 3600.0
TIGHT = dict(abstol=1e-7, reltol=1e-6)


@pytest.fixture(scope="module")
def wind_file(tmp_path_factory):
    """The JAX test's synthetic ERA5-shaped wind file: a Gaussian blob
    moving +x, written with h5py."""
    nt, nyw, nxw = 9, 12, 12
    ts = np.linspace(0, 2 * T, nt)
    xs = np.linspace(0, L, nxw)
    ys = np.linspace(0, L, nyw)
    Tg, Yg, Xg = np.meshgrid(ts, ys, xs, indexing="ij")
    x0 = 0.25 * L + 6.0 * Tg
    u = 2.0 + 10.0 * np.exp(-(((Xg - x0) / (0.3 * L)) ** 2
                              + ((Yg - 0.5 * L) / (0.4 * L)) ** 2))
    v = 0.3 * u
    path = str(tmp_path_factory.mktemp("b02") / "winds.nc")
    with h5py.File(path, "w") as f:
        f["u10"], f["v10"] = u.astype(np.float32), v.astype(np.float32)
        f["longitude"], f["latitude"], f["time"] = xs, ys, ts
    return path


def _final_hs(store_dir, nx):
    with h5py.File(os.path.join(store_dir, "state.h5")) as f:
        data = f["waves/data"][:]
    assert np.all(np.isfinite(data))
    e_final = data[-1, ..., 0]
    return np.linspace(0, L, nx), 4.0 * np.sqrt(np.maximum(e_final, 0.0))


def _run_stored(wind_path, store_dir, nx, dt=DT, **tols):
    """One stored run of the port at resolution nx (the JAX test's
    ``_run_stored``): the HDF5 store's final frame as Hs, read back from
    the file."""
    gw = pt.load_gridded_winds_2d(wind_path, device="cpu")
    ws = TFR.MinimalWindsea(10.0, 10.0, dt)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=dt,
                          timestep=dt, total_time=T, dt=1e-3, dtmin=1e-4,
                          force_dtmin=True, **tols)
    grid = pt.cartesian_box(L, nx, L, nx, periodic_boundary=(False, False),
                            device="cpu")
    m = pt.WaveGrowth2D(grid, gw, sett,
                        config=pt.WaveGrowth2DConfig(periodic_boundary=False))
    assert m.resolved_config().advance_mode == "torch"
    sim = pt.Simulation.create(m, stop_time=T)
    sim.initialize()
    os.makedirs(store_dir, exist_ok=True)
    sim.init_state_store(store_dir)
    sim.run(store=True)
    sim.store.close()
    assert int(sim.state.metrics.n_failed) == 0
    return _final_hs(store_dir, nx)


def _run_stored_jax(wind_path, store_dir, nx, dt=DT, **tols):
    gw = j_load(wind_path)
    ws = JFR.MinimalWindsea(10.0, 10.0, dt)
    sett = JSettings(log_energy_minimum=float(ws.lne), saving_step=dt,
                     timestep=dt, total_time=T, dt=1e-3, dtmin=1e-4,
                     force_dtmin=True, **tols)
    grid = j_box(L, nx, L, nx, periodic_boundary=(False, False))
    m = JModel(grid, gw, sett, config=JConfig(periodic_boundary=False))
    sim = JSimulation.create(m, stop_time=T)
    sim.initialize()
    os.makedirs(store_dir, exist_ok=True)
    sim.init_state_store(store_dir)
    sim.run(store=True)
    sim.store.close()
    return _final_hs(store_dir, nx)


def test_b02_resolution_convergence(wind_file, tmp_path):
    """The final nondimensional Hs field converges across sqrt(2)
    refinements: the successive RMS differences shrink and the finest pair
    agrees within 3%."""
    sizes = [int(math.ceil(11 * math.sqrt(2) ** k)) for k in range(3)]
    assert sizes == [11, 16, 23]
    fields = {nx: _run_stored(wind_file, str(tmp_path / f"r{nx}"), nx)
              for nx in sizes}
    probe = np.linspace(0.15 * L, 0.85 * L, 25)
    PX, PY = np.meshgrid(probe, probe, indexing="ij")
    pts = np.stack([PX.ravel(), PY.ravel()], -1)
    hs_p = {nx: RegularGridInterpolator((ax, ax), hs)(pts)
            for nx, (ax, hs) in fields.items()}
    norm = np.abs(hs_p[sizes[-1]]).max()
    assert norm > 0.5
    errs = [float(np.sqrt(np.mean((hs_p[a] - hs_p[b]) ** 2)) / norm)
            for a, b in zip(sizes[:-1], sizes[1:])]
    assert errs[1] < errs[0], errs
    assert errs[-1] < 0.03, errs


def test_b02_dt_refinement_converges(wind_file, tmp_path):
    """Halving DT at nx = 16 changes the final field by under 4%."""
    nx = 16
    _, hs_dt = _run_stored(wind_file, str(tmp_path / "dt0"), nx, dt=DT)
    _, hs_dt2 = _run_stored(wind_file, str(tmp_path / "dt1"), nx, dt=DT / 2)
    norm = np.abs(hs_dt).max()
    err = float(np.sqrt(np.mean((hs_dt - hs_dt2) ** 2)) / norm)
    assert err < 0.04, err


def test_b02_hs_field_matches_jax(wind_file, tmp_path):
    """The port's final Hs field at nx = 16 against the JAX package's, both
    stored through their own ``Simulation.run`` and HDF5 store, at the
    gridded tests' solver tolerances."""
    ax, hs = _run_stored(wind_file, str(tmp_path / "port"), 16, **TIGHT)
    jax_ax, jhs = _run_stored_jax(wind_file, str(tmp_path / "jax"), 16,
                                  **TIGHT)
    np.testing.assert_array_equal(ax, jax_ax)
    assert jhs.max() > 0.5
    np.testing.assert_allclose(hs, jhs, rtol=1e-4, atol=1e-6 * jhs.max())
