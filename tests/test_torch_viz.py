"""The port's plotting (``picles_torch/viz/plotting.py``) against
``tests/test_viz.py`` and the JAX package's module: both get the same numpy
state (JAX's steps) over their own grids (bit for bit equal leaves), and
the pictures they write are compared pixel for pixel (PNG through
matplotlib's reader, every GIF frame through pillow): the Agg backend draws
the same pixels from the same values.  The port's functions also take the
port's tensors directly."""

import os

import jax
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.grids.tripolar import synthetic_tripolar_grid as j_tripolar
from picles_tpu.models.wave_growth_1d import WaveGrowth1D as J1D
from picles_tpu.models.wave_growth_1d import WaveGrowth1DConfig as J1DConfig
from picles_tpu.models.wave_growth_1d import one_d_grid as j_one_d_grid
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.viz import plotting as JV

import picles_torch as pt
from picles_torch.viz import plotting as TV

torch.set_num_threads(1)
matplotlib.use("Agg")


def _sett(DT=600.0):
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True)


def _png(path):
    return matplotlib.image.imread(path)


def _gif(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")) for f in
                ImageSequence.Iterator(im)]


def _assert_same_gif(a, b):
    fa, fb = _gif(a), _gif(b)
    assert len(fa) == len(fb) > 1
    for x, y in zip(fa, fb):
        assert np.array_equal(x, y)


def _box_states(winds, n=15, steps=4):
    grid = j_box(100e3, n, 100e3, n, periodic_boundary=(True, True))
    model = JModel(grid, winds, _sett(),
                   config=JConfig(periodic_boundary=True))
    ms, states = model.step_n(model.init_state(), steps)
    tgrid = pt.cartesian_box(100e3, n, 100e3, n,
                             periodic_boundary=(True, True), device="cpu")
    return grid, tgrid, np.asarray(ms.state), np.asarray(states)


def test_plot_results_1d(tmp_path):
    grid = j_one_d_grid(0.0, 200e3, 21)
    model = J1D(grid, jw.constant_winds_1d(10.0), _sett(),
                config=J1DConfig(periodic_boundary=False))
    ms, states = model.step_n(model.init_state(), 5)
    states = np.asarray(states)
    x = np.asarray(grid.x)
    tx = pt.one_d_grid(0.0, 200e3, 21, device="cpu").x
    assert np.array_equal(tx.numpy(), x)
    times = np.arange(1, 6) * 600.0
    pj, pp = str(tmp_path / "oned_jax.png"), str(tmp_path / "oned.png")
    JV.plot_results_1d(states, x, times, u_func=lambda x, t: 10.0, path=pj)
    TV.plot_results_1d(torch.tensor(states), tx, times,
                       u_func=lambda x, t: 10.0, path=pp)
    assert os.path.getsize(pp) > 1000
    assert np.array_equal(_png(pp), _png(pj))


def test_plot_state_2d_and_movie(tmp_path):
    import matplotlib.pyplot as plt

    grid, tgrid, last, states = _box_states(jw.constant_winds(10.0, 10.0))
    pngs = []
    for V, g, s in ((JV, grid, last), (TV, tgrid, torch.tensor(last))):
        ax = V.plot_state_2d(g, s, title="E")
        assert ax is not None
        pngs.append(str(tmp_path / f"state_{V.__name__.split('.')[0]}.png"))
        ax.figure.savefig(pngs[-1], dpi=60)
        plt.close("all")
    assert np.array_equal(_png(pngs[0]), _png(pngs[1]))
    pj, pp = str(tmp_path / "movie_jax.gif"), str(tmp_path / "movie.gif")
    JV.movie_2d(grid, states, pj, times=np.arange(1, 5) * 600.0)
    TV.movie_2d(tgrid, torch.tensor(states), pp,
                times=np.arange(1, 5) * 600.0)
    assert os.path.getsize(pp) > 1000
    _assert_same_gif(pp, pj)


def test_double_globe_with_seam(tmp_path):
    grid = j_tripolar(k=2)
    tgrid = pt.synthetic_tripolar_grid(k=2, device="cpu")
    state = np.ones((tgrid.nx, tgrid.ny, 3), np.float32) * 0.01
    pj, pp = str(tmp_path / "globe_jax.png"), str(tmp_path / "globe.png")
    JV.plot_state_double_globe(grid, state, path=pj, show_seam=True)
    TV.plot_state_double_globe(tgrid, torch.as_tensor(state), path=pp,
                               show_seam=True)
    assert os.path.getsize(pp) > 1000
    assert np.array_equal(_png(pp), _png(pj))


def test_movie_dashboard_multi_panel(tmp_path):
    """movie_2d with winds renders the reference's multi-panel dashboard
    (movie_2D.jl:63-98): wind heatmap + quiver arrows, Hs, m_x/m_y and
    c_x/c_y panels with the DT/dx/CFL header, the winds sampled through the
    port's samplers; every frame equals the JAX module's."""
    import matplotlib.pyplot as plt

    grid, tgrid, _, states = _box_states(jw.half_domain_winds(10.0, 5.0,
                                                              60e3))
    winds = pt.half_domain_winds(10.0, 5.0, 60e3)
    made = {"quiver": 0, "pcolormesh": 0}
    orig_quiver = plt.Axes.quiver
    orig_pcm = plt.Axes.pcolormesh

    def spy_quiver(self, *a, **k):
        made["quiver"] += 1
        return orig_quiver(self, *a, **k)

    def spy_pcm(self, *a, **k):
        made["pcolormesh"] += 1
        return orig_pcm(self, *a, **k)

    plt.Axes.quiver = spy_quiver
    plt.Axes.pcolormesh = spy_pcm
    try:
        p = str(tmp_path / "dashboard.gif")
        TV.movie_2d(tgrid, torch.tensor(states), p, winds=winds,
                    times=np.arange(1, 5) * 600.0, dt=600.0,
                    name_string="dashboard smoke")
    finally:
        plt.Axes.quiver = orig_quiver
        plt.Axes.pcolormesh = orig_pcm
    assert os.path.getsize(p) > 1000
    assert made["pcolormesh"] >= 6
    assert made["quiver"] == 1
    pj = str(tmp_path / "dashboard_jax.gif")
    JV.movie_2d(grid, states, pj, winds=jw.half_domain_winds(10.0, 5.0, 60e3),
                times=np.arange(1, 5) * 600.0, dt=600.0,
                name_string="dashboard smoke")
    _assert_same_gif(p, pj)
    p1 = str(tmp_path / "single.gif")
    TV.movie_2d(tgrid, states, p1, times=np.arange(1, 5) * 600.0)
    assert os.path.getsize(p) > os.path.getsize(p1)


def test_movie_dashboard_dt_drives_wind_sample_times(tmp_path):
    """With ``dt`` given and no explicit ``times``, the dashboard samples
    the port's samplers at t = frame_index * dt (a float64 time plane on the
    CPU), never at t = frame index."""
    _, tgrid, _, states = _box_states(jw.constant_winds(10.0, 5.0), n=9,
                                      steps=3)
    seen = []

    def u(x, y, t):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
        seen.append(float(t.max()))
        return torch.full_like(x, 10.0)

    def v(x, y, t):
        return torch.zeros_like(x)

    p = str(tmp_path / "dt_movie.gif")
    TV.movie_2d(tgrid, states, p, winds=pt.Winds2D(u=u, v=v), dt=600.0)
    assert os.path.getsize(p) > 1000
    nt = states.shape[0]
    assert max(seen) == (nt - 1) * 600.0
    assert 1.0 not in seen and float(nt - 1) not in seen


@pytest.mark.parametrize("name", ["significant_wave_height"])
def test_significant_wave_height_takes_tensors(name):
    e = np.array([[-1.0, 0.0], [0.25, 4.0]], np.float32)
    got = getattr(TV, name)(torch.as_tensor(e))
    assert np.array_equal(got, getattr(JV, name)(e))
