"""Spherical and tripolar grids: the PyTorch port (plain versions on the CPU)
against the JAX package, from numpy inputs made from a seed.

- Grid leaves (``x, y, dx_m, dy_m, area, angle, mask, proj, pc``) of
  ``spherical_grid_2d``, ``synthetic_tripolar_grid`` and ``load_mom6_grid``
  (a NetCDF-3 supergrid written here with scipy) equal JAX's bit for bit:
  both build in float64 numpy and round once.
- Mirrors of ``tests/test_spherical.py`` (metrics, the pc clamp, the great
  circle, the aqua blob), ``tests/test_tripolar.py`` (stride, distances,
  seam mirror, masks, rotation, the forced model, gridded realistic-like
  winds, the seam crossing) and ``tests/test_advance_pallas.py:250`` (the
  per-node spherical advance, JAX's Pallas kernel in interpret mode): each
  model test steps the port and JAX from the identical state and holds the
  state within the stated tolerance, the counters and ``on`` equal.

Tolerances: propagation-only runs (every source term off) at rtol 1e-5 of
the state's largest value, the forced runs at solver tolerances abstol 1e-7
/ reltol 1e-6 within 1e-4 of it (the adaptive controller turns last-ulp
differences of the two libraries into other substep paths at the default
tolerances, ROADMAP queue 3); the single great-circle particle at rtol 1e-6
(abstol and reltol 1e-8).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids import spherical as jsph
from picles_tpu.grids import tripolar as jtri
from picles_tpu.models.state import Particles2D as JParticles
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.ops.rhs import RHSParams as JRHSParams
from picles_tpu.ops.rhs import TermFlags as JFlags
from picles_tpu.ops.rhs import particle_equations as j_equations
from picles_tpu.ops.tsit5 import SolverConfig as JSolver
from picles_tpu.ops.tsit5 import integrate_to as j_integrate_to

import picles_torch as pt
from picles_torch import convert
from picles_torch.grids import spherical as tsph
from picles_torch.grids import tripolar as ttri
from picles_torch.ops.rhs import RHSParams, particle_equations
from picles_torch.ops.tsit5 import SolverConfig, integrate_to
from test_torch_model_2d import COUNTERS, state_of

torch.set_num_threads(1)

PROPAGATION_ONLY = dict(input=False, dissipation=False, peak_shift=False,
                        direction=False)


def assert_grids_equal(jg, tg):
    """Every leaf bit for bit, dtypes and shapes included; the stats
    equal."""
    for f in convert.GRID_FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f
    for f in dataclasses.fields(tg.stats):
        assert getattr(jg.stats, f.name) == getattr(tg.stats, f.name), f.name


def port_model(jm, tgrid, winds, **kw):
    """The port's model of a JAX model over the port's own grid: the same
    settings, parameters, term flags and config."""
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    return pt.WaveGrowth2D(tgrid, winds, sett, ode_params=params,
                           constants=cid,
                           flags=convert.flags_from_jax(jm.flags),
                           config=convert.config_from_jax(jm.config), **kw)


def step_both(jm, tm, jms, steps, gap, jstep=None, smax_slack=0):
    """``steps`` steps of each from the same state: the largest difference
    within ``gap`` of the state's largest value, counters and ``on`` equal
    after every step (the most substeps a lane took within
    ``smax_slack``); returns the last (JAX, port) states."""
    jstep = jstep or jax.jit(jm.step)
    tms = state_of(jms)
    for k in range(steps):
        jms, tms = jstep(jms), tm.step(tms)
        S, J = tms.state.numpy(), np.asarray(jms.state)
        assert np.isfinite(S).all(), f"step {k}"
        err = float(np.abs(S - J).max() / max(np.abs(J).max(), 1e-30))
        assert err <= gap, f"step {k}: {err:.3e} of the state's scale"
        got = tms.metrics.as_dict()
        for c in COUNTERS:
            slack = smax_slack if c == "substeps_max" else 0
            assert abs(got[c] - int(getattr(jms.metrics, c))) <= slack, \
                f"{c} at step {k}"
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
    return jms, tms


def plant(ms, on, z):
    """A JAX state with the particles replaced by ``z [nx, ny, 5]`` and
    ``on``."""
    return dataclasses.replace(
        ms, particles=JParticles.from_z(jnp.asarray(z, jnp.float32),
                                        ms.particles.t, ms.particles.dt,
                                        jnp.asarray(on)))


# ---------------------------------------------------------------------------
# grid leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["spherical", "spherical_periodic_x",
                                  "tripolar", "tripolar_k4"])
def test_grid_leaves_equal_jax_bitwise(kind):
    if kind.startswith("spherical"):
        per = (kind.endswith("x"), False)
        jg = jsph.spherical_grid_2d(0.0, 60.0, 31, -60.0, 60.0, 21,
                                    periodic_boundary=per)
        tg = pt.spherical_grid_2d(0.0, 60.0, 31, -60.0, 60.0, 21,
                                  periodic_boundary=per, device="cpu")
    else:
        k = 4 if kind.endswith("k4") else 2
        jg = jtri.synthetic_tripolar_grid(k=k)
        tg = pt.synthetic_tripolar_grid(k=k, device="cpu")
    assert_grids_equal(jg, tg)
    assert tg.stats.kind == kind.split("_")[0]


def test_load_mom6_grid_netcdf3_equals_jax(tmp_path):
    """A NetCDF-3 ``ocean_hgrid``-style supergrid ([ny, nx] variables) and
    a mask file, written with scipy, read by both packages' loaders."""
    from scipy.io import netcdf_file

    arrs = dict(zip(("x", "y", "dx", "dy", "area", "angle_dx"),
                    jtri.synthetic_tripolar_supergrid(48, 36)))
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(24, 18)) < 0.9).astype(np.float64)
    path, mpath = str(tmp_path / "hgrid.nc"), str(tmp_path / "mask.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("ny", 36)
        f.createDimension("nx", 48)
        for name, a in arrs.items():
            f.createVariable(name, "f8", ("ny", "nx"))[:] = a.T
    with netcdf_file(mpath, "w") as f:
        f.createDimension("ny", 18)
        f.createDimension("nx", 24)
        f.createVariable("mask", "f8", ("ny", "nx"))[:] = mask.T
    for mf in (None, mpath):
        jg = jtri.load_mom6_grid(path, k=2, mask_file=mf)
        tg = pt.load_mom6_grid(path, k=2, mask_file=mf, device="cpu")
        assert_grids_equal(jg, tg)
    # with the mask file, its land is the grid's (a land node beside ocean
    # is a land boundary, 2)
    assert np.array_equal(tg.mask.numpy() == 1, mask == 1)
    assert (mask == 0).any()


# ---------------------------------------------------------------------------
# tests/test_spherical.py
# ---------------------------------------------------------------------------

def test_metric_arrays():
    g = pt.spherical_grid_2d(0.0, 10.0, 11, 0.0, 60.0, 7, device="cpu")
    dxm, dym = g.dx_m.numpy(), g.dy_m.numpy()
    assert np.isclose(dxm[5, -1] / dxm[5, 0], math.cos(math.radians(60.0)),
                      rtol=1e-3)
    assert np.isclose(dym[3, 3], tsph.EARTH_RADIUS * math.radians(10.0),
                      rtol=1e-3)
    X, Y = np.meshgrid(np.linspace(0, 10, 11), np.linspace(0, 60, 7),
                       indexing="ij")
    for f in ("cal_dx_degree", "cal_dy_degree", "cal_dy_meters"):
        a = X if f == "cal_dx_degree" else Y
        assert np.array_equal(getattr(tsph, f)(a), getattr(jsph, f)(a)), f
    assert np.array_equal(tsph.cal_dx_meters(X, Y), jsph.cal_dx_meters(X, Y))


def test_propagation_correction_coef_clamped():
    lat = np.array([0.0, 45.0, -45.0, 89.9, -89.99])
    c = tsph.propagation_correction_coef(lat)
    assert np.array_equal(c, jsph.propagation_correction_coef(lat))
    assert c[0] == 0.0 and c[1] > 0
    assert np.isclose(c[1], math.tan(math.radians(45)) / 6.3710e6)
    assert np.isclose(c[2], -c[1])
    assert np.isclose(c[3], 60.0 / 6.3710e6) and np.isclose(c[4], -c[3])


def test_great_circle_conserves_speed_and_curves_equatorward():
    """An eastward group velocity at 45N (propagation only): |cg| conserved,
    cg_y turns negative; the port's integrate_to within rtol 1e-6 of
    JAX's."""
    lat = 45.0
    pc = float(tsph.propagation_correction_coef(np.array([lat]))[0])
    dxm = tsph.EARTH_RADIUS * math.cos(math.radians(lat)) * math.pi / 180.0
    dym = tsph.EARTH_RADIUS * math.pi / 180.0
    M = np.array([[[1.0 / dxm, 0.0], [0.0, 1.0 / dym]]])
    z0 = np.array([[math.log(1e-3), 10.0, 0.0, 0.0, 0.0]])
    T = 6 * 3600.0

    jr = j_integrate_to(
        j_equations(lambda x, y, t: jnp.zeros_like(jnp.asarray(x)),
                    lambda x, y, t: jnp.zeros_like(jnp.asarray(x)),
                    flags=JFlags(**PROPAGATION_ONLY)),
        jnp.asarray(z0, jnp.float32), jnp.zeros(1), jnp.full((1,), T),
        jnp.full((1,), 1.0),
        JRHSParams(x=jnp.zeros(1), y=jnp.full((1,), lat),
                   M=jnp.asarray(M, jnp.float32), pc=jnp.full((1,), pc)),
        jnp.array([True]), JSolver(abstol=1e-8, reltol=1e-8))
    f32 = torch.float32
    tr = integrate_to(
        particle_equations(lambda x, y, t: torch.zeros_like(x),
                           lambda x, y, t: torch.zeros_like(x),
                           flags=pt.TermFlags(**PROPAGATION_ONLY)),
        torch.tensor(z0, dtype=f32), torch.zeros(1), torch.full((1,), T),
        torch.full((1,), 1.0),
        RHSParams(x=torch.zeros(1), y=torch.full((1,), lat),
                  M=torch.tensor(M, dtype=f32), pc=torch.full((1,), pc)),
        torch.tensor([True]), SolverConfig(abstol=1e-8, reltol=1e-8))
    z = tr.z[0].numpy()
    np.testing.assert_allclose(z, np.asarray(jr.z[0]), rtol=1e-6, atol=1e-9)
    assert abs(math.hypot(z[1], z[2]) / 10.0 - 1) < 1e-3
    assert z[2] < -0.1
    assert np.isclose(z[3], 10.0 * T / dxm, rtol=0.05)


def _swell_settings(DT):
    ws = jfr.MinimalWindsea(1.0, 1.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=10 * 24 * 3600.0, dt=1.0,
                     dtmin=1e-2, force_dtmin=True)


def test_sphere_aqua_blob_advection():
    """The propagation-only blob on an aqua planet (periodic in x, open in
    y, the model non-periodic): 6 steps of the port within 1e-5 of JAX's
    state scale, counters and ``on`` equal; the blob drifts east at the
    rate of JAX's test and keeps its energy."""
    DT = 1800.0
    per = (True, False)
    jg = jsph.spherical_grid_2d(0.0, 90.0, 46, 0.0, 40.0, 21,
                                periodic_boundary=per)
    tg = pt.spherical_grid_2d(0.0, 90.0, 46, 0.0, 40.0, 21,
                              periodic_boundary=per, device="cpu")
    jm = JModel(jg, jw.constant_winds(0.0, 0.0), _swell_settings(DT),
                flags=JFlags(**PROPAGATION_ONLY),
                config=JConfig(periodic_boundary=False, halo=4))
    with pytest.warns(UserWarning, match="non-periodic axis"):
        pt.WaveGrowth2D(tg, pt.constant_winds(0.0, 0.0),
                        convert.settings_from_values(jm.settings)[0],
                        config=pt.WaveGrowth2DConfig(periodic_boundary=True))
    tm = port_model(jm, tg, pt.constant_winds(0.0, 0.0))
    nx, ny = jg.stats.nx, jg.stats.ny
    on = np.zeros((nx, ny), bool)
    on[8:13, 8:13] = True
    z = np.zeros((nx, ny, 5))
    z[..., 0], z[..., 1] = math.log(0.1), 10.0
    jms = plant(jm.init_state(), on, z)
    j1, t1 = step_both(jm, tm, jms, 1, 1e-5)
    e1 = t1.state[..., 0].numpy()
    _, t6 = step_both(jm, tm, j1, 5, 1e-5)
    e2 = t6.state[..., 0].numpy()
    com = [(np.arange(nx)[:, None] * e).sum() / e.sum() for e in (e1, e2)]
    assert e2.sum() > 0.85 * e1.sum()
    lat = float(tg.y[0, 10])
    dxm = tsph.EARTH_RADIUS * math.cos(math.radians(lat)) * math.radians(2.0)
    assert np.isclose(com[1] - com[0], 10.0 * DT * 5 / dxm, rtol=0.25)
    assert int(t6.metrics.n_failed) == 0


def test_per_node_spherical_advance_matches_jax_pallas():
    """``tests/test_advance_pallas.py:250``: the propagation-only blob on a
    sphere, where the projection and pc are per-node planes.  JAX's Pallas
    advance (interpret mode) and the port's plain step, 2 steps, within
    1e-5 of the state's scale; the CUDA path's planes
    (``WaveGrowth2D.projection``) are the grid's own values."""
    DT = 1800.0
    per = (True, False)
    jg = jsph.spherical_grid_2d(0.0, 60.0, 16, 10.0, 50.0, 12,
                                periodic_boundary=per)
    tg = pt.spherical_grid_2d(0.0, 60.0, 16, 10.0, 50.0, 12,
                              periodic_boundary=per, device="cpu")
    jm = JModel(jg, jw.constant_winds(0.0, 0.0), _swell_settings(DT),
                flags=JFlags(**PROPAGATION_ONLY),
                config=JConfig(periodic_boundary=False, halo=4,
                               advance_mode="pallas", pallas_interpret=True))
    assert jm.uniform_proj is None
    jx = dataclasses.replace(jm.config, advance_mode="xla")
    tm = port_model(JModel(jg, jw.constant_winds(0.0, 0.0), jm.settings,
                           flags=jm.flags, config=jx),
                    tg, pt.constant_winds(0.0, 0.0))
    assert tm.uniform_proj is None
    planes = tm.projection(tg)
    assert planes.shape == (5, 16, 12) and planes.is_contiguous()
    assert torch.equal(planes[1], tg.proj[..., 0, 1])
    assert torch.equal(planes[4], tg.pc)
    assert tm.projection(tg) is planes   # kept for the grid
    on = np.zeros((16, 12), bool)
    on[5:9, 4:8] = True
    z = np.zeros((16, 12, 5))
    z[..., 0], z[..., 1] = math.log(0.1), 10.0
    step_both(jm, tm, plant(jm.init_state(), on, z), 2, 1e-5,
              jstep=jm.step)


# ---------------------------------------------------------------------------
# tests/test_tripolar.py
# ---------------------------------------------------------------------------

def test_extract_grid_points_and_distances_equal_jax():
    X, Y, dx, dy, area, ang = ttri.synthetic_tripolar_supergrid(64, 48)
    J = jtri.synthetic_tripolar_supergrid(64, 48)
    for a, b in zip((X, Y, dx, dy, area, ang), J):
        assert np.array_equal(a, b)
    for k in (2, 4, 8):
        G, GJ = (m.extract_grid_points(X, Y, ang, k) for m in (ttri, jtri))
        assert G["t_lon"].shape == (64 // k, 48 // k)
        assert G["t_lon"][0, 0] == X[k // 2, k // 2]
        for key in ("t_lon", "t_lat", "u_lon", "v_lat", "q_lon", "angle"):
            assert np.array_equal(G[key], GJ[key]), key
        GA, GAJ = (m.calculate_distances(area, dx, dy, k, k // 2)
                   for m in (ttri, jtri))
        for key in GAJ:
            assert np.array_equal(GA[key], GAJ[key]), (k, key)
    GA = ttri.calculate_distances(area[:32, :24], dx[:32, :24], dy[:32, :24],
                                  2, 1)
    np.testing.assert_allclose(GA["tarea"][0, 0], area[0:2, 0:2].sum())
    np.testing.assert_allclose(GA["tarea"].sum(), area[:32, :24].sum(),
                               rtol=1e-12)
    mask = np.ones((32, 24))
    G = ttri.extract_grid_points(X, Y, ang, 4, mask=mask)
    assert G["mask"].shape == (16, 12) and G["mask"].all()
    with pytest.raises(ValueError, match="k must be"):
        ttri.extract_grid_points(X, Y, ang, 3, mask=mask)


def test_seam_mirror_masks_and_rotation():
    X, Y, dx, dy, area, ang = ttri.synthetic_tripolar_supergrid(32, 24)
    assert np.allclose(dy[:, -1], dy[::-1, -4])
    g = pt.synthetic_tripolar_grid(k=2, device="cpu")
    m = g.mask.numpy()
    assert g.stats.bx == pt.Boundary.PERIODIC
    assert g.stats.by == pt.Boundary.TRIPOLAR_NORTH
    assert (m[:, -1] == 0).sum() + (m[:, -1] == 2).sum() > 0
    assert np.all(m[:, 0] != 1) and (m == 1).sum() > 0.5 * m.size
    P, a = g.proj.numpy(), g.angle.numpy()
    i, j = 8, int(np.argmax(np.abs(a).max(axis=0)))
    dxm, dym = float(g.dx_m[i, j]), float(g.dy_m[i, j])
    np.testing.assert_allclose(P[i, j, 0, 0], math.cos(a[i, j]) / dxm,
                               rtol=1e-5)
    np.testing.assert_allclose(P[i, j, 0, 1], math.sin(a[i, j]) / dym,
                               rtol=1e-5)
    np.testing.assert_allclose(P[i, j, 1, 0], -math.sin(a[i, j]) / dxm,
                               rtol=1e-5)
    # the pole masks as JAX's, on another radius
    t = ttri.extract_grid_points(X, Y, ang, 2)
    d = ttri.calculate_distances(area, dx, dy, 2, 1)["dyCv"]
    assert np.array_equal(
        ttri.tripolar_mask_pols(np.ones((16, 12)), t["t_lon"], t["t_lat"], d,
                                7.0),
        jtri.tripolar_mask_pols(np.ones((16, 12)), t["t_lon"], t["t_lat"], d,
                                7.0))


def _forced_settings(DT):
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True, abstol=1e-7, reltol=1e-6)


def test_model_runs_on_tripolar_grid():
    """Forced growth (8, 8) m/s on the synthetic tripolar grid, the default
    config (tsit5, the Hairer reset, halo 3): 6 steps within 1e-4 of JAX's
    state scale at solver tolerances, counters and ``on`` equal; finite, no
    failures, land stays off and empty."""
    jg = jtri.synthetic_tripolar_grid(k=2)
    tg = pt.synthetic_tripolar_grid(k=2, device="cpu")
    jm = JModel(jg, jw.constant_winds(8.0, 8.0), _forced_settings(600.0),
                config=JConfig(periodic_boundary=True, halo=3))
    tm = port_model(jm, tg, pt.constant_winds(8.0, 8.0))
    _, tms = step_both(jm, tm, jm.init_state(), 6, 1e-4)
    e = tms.state[..., 0].numpy()
    land = tg.mask.numpy() == 0
    assert int(tms.metrics.n_failed) == 0
    assert not tms.particles.on.numpy()[land].any() and (e[land] == 0).all()
    assert e[tg.mask.numpy() == 1].max() > 0


def realistic_like_record():
    """tests/test_tripolar.py:116-127's zonal jet at 40N with a time wobble
    and a meridional part, on a coarse lon/lat/time grid (float32)."""
    nt, nxa, nya = 5, 19, 13
    lon = np.linspace(0, 360, nxa)
    lat = np.linspace(-80, 90, nya)
    t = np.linspace(0, 12 * 3600.0, nt)
    T, LO, LA = np.meshgrid(t, lon, lat, indexing="ij")
    u = 12.0 * np.exp(-((LA - 40) / 20.0) ** 2) * (1 + 0.2 * np.sin(T / 4e4))
    v = 3.0 * np.sin(np.radians(LO)) * np.exp(-((LA - 40) / 25.0) ** 2)
    return dict(u_data=u.astype(np.float32), v_data=v.astype(np.float32),
                x0=0.0, dx=float(lon[1] - lon[0]), y0=float(lat[0]),
                dy=float(lat[1] - lat[0]), t0=0.0, dt=float(t[1] - t[0]))


def test_tripolar_gridded_realistic_like_winds():
    """The T03_PIC_tripolar_realistic analog: the stored jet over the masked
    tripolar grid, DT = 1200 s, 6 steps within 1e-4 of JAX's state scale at
    solver tolerances, counters and ``on`` equal (the most substeps a lane
    took within 1: the two interpolants part by an ulp of wind); the energy
    sits in the jet band."""
    rec = realistic_like_record()
    gw = jw.GriddedWinds2D(**{k: jnp.asarray(v) if k.endswith("data") else v
                              for k, v in rec.items()})
    jg = jtri.synthetic_tripolar_grid(k=2)
    tg = pt.synthetic_tripolar_grid(k=2, device="cpu")
    jm = JModel(jg, gw.as_winds(), _forced_settings(1200.0),
                config=JConfig(periodic_boundary=True, halo=3))
    tm = port_model(jm, tg, convert.gridded_from_jax(gw, device="cpu"))
    _, tms = step_both(jm, tm, jm.init_state(), 6, 1e-4, smax_slack=1)
    e, mask, lat = tms.state[..., 0].numpy(), tg.mask.numpy(), tg.y.numpy()
    jet = (lat > 20) & (lat < 55) & (mask == 1)
    calm = (lat < -40) & (mask == 1)
    assert e[jet].mean() > 10 * max(e[calm].mean(), 1e-12)
    assert int(tms.metrics.n_failed) == 0


def test_seam_crossing_in_model():
    """A northward swell particle at the top ocean node of column nx/4
    crosses the seam and reappears at the mirrored x (the
    T03_PIC_tripolar_seam_remap analog): 10 propagation-only steps within
    1e-5 of JAX's state scale, counters and ``on`` equal."""
    jg = jtri.synthetic_tripolar_grid(k=2)
    tg = pt.synthetic_tripolar_grid(k=2, device="cpu")
    nx, ny = tg.nx, tg.ny
    minimal = np.array([1e-12, 1e-20])
    jm = JModel(jg, jw.constant_winds(0.0, 0.0), _swell_settings(1800.0),
                flags=JFlags(**PROPAGATION_ONLY), minimal_state=minimal,
                config=JConfig(periodic_boundary=True, halo=3))
    tm = port_model(jm, tg, pt.constant_winds(0.0, 0.0),
                    minimal_state=minimal)
    mask = tg.mask.numpy()
    i0 = nx // 4
    j0 = int(np.where(mask[i0] == 1)[0][-1])
    on = np.zeros((nx, ny), bool)
    on[i0, j0] = True
    z = np.zeros((nx, ny, 5))
    z[..., 0] = math.log(0.1)
    z[i0, j0, 2] = 8.0
    j1, t1 = step_both(jm, tm, plant(jm.init_state(), on, z), 1, 1e-5)
    total = float(t1.state[..., 0].sum())
    _, tms = step_both(jm, tm, j1, 9, 1e-5)
    e = tms.state[..., 0].numpy()
    assert np.isfinite(e).all() and e.sum() > 0.3 * total
    mirror_i = (nx - 2 - i0) % nx
    assert e[max(0, mirror_i - 4):mirror_i + 5, j0 - 4:].sum() > 0


# ---------------------------------------------------------------------------
# the kernel modes' inputs on curved grids (the kernels run on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["spherical", "tripolar"])
def test_kernel_modes_take_curved_grids(monkeypatch, kind):
    """With the modes resolved to the kernels (as on a card) a spherical or
    tripolar grid builds: the deposit resolves to the gather kernel (K2,
    with the seam on a tripolar grid), and the projection the step hands
    K1 and K3 is the grid's per-node planes, stacked once and kept; the
    kernel wrappers refuse CPU tensors rather than fall back."""
    from picles_torch.models import wave_growth_2d as twg
    from picles_torch.ops.pic_cuda import pic_gather

    def cuda_modes(cfg, device):
        return dataclasses.replace(cfg, advance_mode="cuda",
                                   scatter_mode="dense_cuda")

    monkeypatch.setattr(twg, "resolve_modes", cuda_modes)
    g = (pt.spherical_grid_2d(0.0, 60.0, 16, 10.0, 50.0, 12,
                              periodic_boundary=(True, False), device="cpu")
         if kind == "spherical" else
         pt.synthetic_tripolar_grid(k=2, device="cpu"))
    m = pt.WaveGrowth2D(g, pt.constant_winds(10.0, 5.0), pt.ODESettings(),
                        config=pt.WaveGrowth2DConfig(
                            periodic_boundary=kind == "tripolar"))
    assert m.resolved_config().scatter_mode == "dense_cuda"
    assert m.uniform_proj is None
    planes = m.projection(g)
    want = np.stack([g.proj.numpy()[..., 0, 0], g.proj.numpy()[..., 0, 1],
                     g.proj.numpy()[..., 1, 0], g.proj.numpy()[..., 1, 1],
                     g.pc.numpy()])
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    assert np.array_equal(planes.numpy(), want)
    assert m.projection(g) is planes
    if kind == "tripolar":
        assert np.any(want[1] != 0) and np.any(want[2] != 0)
    z = torch.zeros((g.nx, g.ny))
    with pytest.raises(ValueError, match="not a CUDA device"):
        pic_gather(z, z, (z, z, z), torch.ones_like(z, dtype=torch.bool),
                   g.stats, 3)
