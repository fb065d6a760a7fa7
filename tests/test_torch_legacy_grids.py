"""The port's legacy ParticleMesh grid API (``picles_torch/grids/legacy.py``)
against ``tests/test_legacy_grids.py`` and the JAX package's classes, and
the reference's top-level names on ``picles_torch``.

The metadata and node vectors are numpy in both packages and equal exactly;
``to_grid2d`` builds the port's ``cartesian_box`` on the device it is given,
bit for bit the JAX grid's leaves."""

import dataclasses

import numpy as np
import pytest
import torch

import picles_tpu
from picles_tpu.grids import legacy as jl

import picles_torch as pt
from picles_torch.grids import legacy as tl

torch.set_num_threads(1)


def _sett(DT=600.0):
    ws = pt.FetchRelations.MinimalWindsea(10.0, 10.0, DT)
    return pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                          dtmin=1e-4, force_dtmin=True)


def test_twod_grid_fields_match_reference_semantics():
    g = tl.TwoDGrid(0.0, 100e3, 11, 0.0, 50e3, 6)   # 6-arg form
    assert (g.Nx, g.Ny, g.Ndx, g.Ndy) == (11, 6, 10, 5)
    assert g.dx == 10e3 and g.dy == 10e3
    assert g.dimx == 100e3 and g.dimy == 50e3
    g2 = tl.TwoDGrid(100e3, 11, 50e3, 6)            # 4-arg convenience form
    assert g2 == g
    j = jl.TwoDGrid(0.0, 100e3, 11, 0.0, 50e3, 6)
    assert dataclasses.asdict(g) == dataclasses.asdict(j)

    gn = tl.TwoDGridNotes(g)
    np.testing.assert_allclose(gn.x, np.linspace(0, 100e3, 11))
    np.testing.assert_allclose(gn.y, np.linspace(0, 50e3, 6))
    jn = jl.TwoDGridNotes(j)
    assert np.array_equal(gn.x, jn.x) and np.array_equal(gn.y, jn.y)

    mesh = tl.TwoDGridMesh(g, skip=2)
    assert mesh.x.shape == (6, 3)
    np.testing.assert_allclose(mesh.x[:, 0], gn.x[::2])
    np.testing.assert_allclose(mesh.y[0, :], gn.y[::2])
    assert mesh.tuples.shape == (6, 3, 2)
    assert np.array_equal(mesh.tuples, jl.TwoDGridMesh(j, skip=2).tuples)


def test_oned_grid_notes():
    g = tl.OneDGrid(0.0, 200e3, 21)
    assert g.Ndx == 20 and g.dx == 10e3
    gn = tl.OneDGridNotes(g)
    np.testing.assert_allclose(gn.x, np.linspace(0, 200e3, 21))
    jn = jl.OneDGridNotes(jl.OneDGrid(0.0, 200e3, 21))
    assert vars(gn).keys() == vars(jn).keys()
    assert np.array_equal(gn.x, jn.x)


@pytest.mark.parametrize("origin", [(0.0, 0.0), (-50e3, 20e3)])
def test_to_grid2d_leaves_equal_jax(origin):
    """``to_grid2d`` on the CPU: every leaf bit for bit the JAX grid's."""
    x0, y0 = origin
    args = (x0, x0 + 100e3, 13, y0, y0 + 100e3, 13)
    tg = tl.TwoDGrid(*args).to_grid2d(device="cpu")
    jg = jl.TwoDGrid(*args).to_grid2d()
    assert (tg.stats.nx, tg.stats.ny) == (jg.stats.nx, jg.stats.ny)
    assert (tg.stats.dx, tg.stats.dy) == (jg.stats.dx, jg.stats.dy)
    for f in dataclasses.fields(tg):
        if f.name == "stats":
            continue
        a, b = getattr(tg, f.name), np.asarray(getattr(jg, f.name))
        assert np.array_equal(a.numpy(), b), f.name


def test_legacy_grid_drops_into_model():
    """TwoDGrid(...).to_grid2d() is a drop-in WaveGrowth2D grid and matches
    a cartesian_box-built model bitwise."""
    legacy = tl.TwoDGrid(100e3, 13, 100e3, 13).to_grid2d(device="cpu")
    modern = pt.cartesian_box(100e3, 13, 100e3, 13,
                              periodic_boundary=(True, True), device="cpu")
    winds = pt.constant_winds(10.0, 10.0)
    cfg = pt.WaveGrowth2DConfig(periodic_boundary=True)
    ma = pt.WaveGrowth2D(legacy, winds, _sett(), config=cfg)
    mb = pt.WaveGrowth2D(modern, winds, _sett(), config=cfg)
    sa, sb = ma.init_state(), mb.init_state()
    for _ in range(3):
        sa = ma.step(sa)
        sb = mb.step(sb)
    assert torch.equal(sa.state, sb.state)


def test_legacy_grid_nonzero_origin_translates():
    """xmin/ymin offsets relabel coordinates; constant-wind physics is
    translation-invariant, so fields match the origin-anchored twin."""
    off = tl.TwoDGrid(-50e3, 50e3, 13, 20e3, 120e3, 13).to_grid2d(
        device="cpu")
    assert float(off.x[0, 0]) == -50e3
    assert float(off.y[0, 0]) == 20e3
    base = tl.TwoDGrid(100e3, 13, 100e3, 13).to_grid2d(device="cpu")
    winds = pt.constant_winds(10.0, 10.0)
    cfg = pt.WaveGrowth2DConfig(periodic_boundary=True)
    ma = pt.WaveGrowth2D(off, winds, _sett(), config=cfg)
    mb = pt.WaveGrowth2D(base, winds, _sett(), config=cfg)
    sa, sb = ma.init_state(), mb.init_state()
    for _ in range(2):
        sa = ma.step(sa)
        sb = mb.step(sb)
    np.testing.assert_allclose(sa.state.numpy(), sb.state.numpy(), rtol=1e-6)


def test_legacy_grids_reject_degenerate_node_counts():
    """Nx/Ny < 2 is a clear ValueError, not a ZeroDivisionError from the
    dx = dim/(N-1) spacing computation."""
    with pytest.raises(ValueError, match="Nx, Ny >= 2"):
        tl.TwoDGrid(100e3, 1, 100e3, 4)
    with pytest.raises(ValueError, match="Nx, Ny >= 2"):
        tl.TwoDGrid(0.0, 100e3, 5, 0.0, 100e3, 1)
    with pytest.raises(ValueError, match="Nx >= 2"):
        tl.OneDGrid(0.0, 1e3, 1)


def test_every_top_level_name_of_the_reference_is_in_the_port():
    """Every public top-level name of ``picles_tpu`` is one of
    ``picles_torch`` (the reference's quick start and examples address them
    as ``pt.<name>``); the port's legacy classes are its own."""
    names = [n for n in dir(picles_tpu) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(pt, n)]
    assert not missing, missing
    assert set(pt.__all__) <= set(dir(pt))
    assert pt.TwoDGrid is tl.TwoDGrid and pt.OneDGridNotes is tl.OneDGridNotes
    assert pt.FetchRelations.MinimalWindsea is not None
    assert pt.ShardedWaveGrowth2D.__module__ == "picles_torch.parallel.sharded"
    assert callable(pt.make_mesh) and callable(pt.particle_equations)
    assert dataclasses.asdict(pt.ScgConstants()) == dataclasses.asdict(
        picles_tpu.ScgConstants())
