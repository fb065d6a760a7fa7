"""Gridded (NetCDF) winds in the port: ``picles_torch/forcing/winds.py``
``GriddedWinds2D`` and ``load_gridded_winds_2d``, the kernels' per-step
planes and samplers, the plain versions of the gridded kernel instances
(K1, K3, K5, K6) and the model as a whole, against the JAX package on the
CPU from the same numpy-seeded inputs (its Pallas kernels in interpret
mode).

Tolerances:
- the interpolant: rtol/atol 1e-6 (the port follows ``map_coordinates``'
  operations; XLA's fused loop rounds an ulp otherwise);
- the per-window planes: within 1e-6 of each plane's scale; the port's
  samplers over its planes against its interpolant through the window at
  1e-5, as ``tests/test_advance_pallas.py:163`` holds JAX's (atol 2e-4
  five days in, where float32 cancels in the planes as in JAX's);
- the kernels' plain versions against JAX's kernels on the same planes:
  rtol 1e-5 in fixed-substep mode and for the Hairer estimate, rtol 5e-3 in
  adaptive mode (``tests/test_torch_advance.py``); the remesh's bits, ``on``,
  dt and positions exactly and its values at rtol 2e-6 and atol 2e-6 of
  each plane's scale, where the analytic winds' remesh tests hold rtol
  4e-7: XLA contracts the sampler's ``a + t s`` into one fused multiply-add
  in the jitted kernel (eager JAX equals the port bit for bit), an ulp of
  the wind's largest term, which the windsea's powers carry to 9.1e-7
  relative and a reseed's cg, proportional to a calm node's small u, as
  an absolute error;
- whole models (the port's advance_mode "torch" against JAX's "xla"), at
  the float64-oracle test's solver tolerances (``_settings``): rtol 1e-3 on
  the states (4.3e-4 measured over 8 steps) and 2e-4 for the oracle case
  itself, the JAX test's own bound (7.1e-5 measured); every counter and
  ``on`` equal but ``substeps_max``, the most substeps a lane took, which
  may be 2 apart (measured).
"""

import dataclasses
import sys

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
from picles_tpu.ops import rhs as jrhs
from picles_tpu.ops import tsit5 as jts
from picles_tpu.ops.advance_pallas import advance_pallas, auto_dt_pallas
from picles_tpu.ops.pic_pallas import scatter_remesh_fused
from picles_tpu.simulation.store import StateStore as JStore

import picles_torch as pt
from picles_torch import convert
from picles_torch.forcing import winds as tw
from picles_torch.grids.base import Boundary as TB
from picles_torch.grids.base import GridStats as TStats
from picles_torch.models import wave_growth_2d as twg
from picles_torch.ops import pic as tpic
from picles_torch.ops import remesh as trm
from picles_torch.ops import rhs as trhs
from picles_torch.ops import tsit5 as tts
from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_reset
from picles_torch.simulation.store import StateStore as TStore
from test_torch_advance import _case
from test_torch_remesh import _inputs

torch.set_num_threads(1)

DT = 600.0
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped", "substeps_max")
PROJ = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)


def _pair(u, v, **kw):
    """The same record in both packages."""
    nodes = {k: kw.pop(k) for k in ("x_nodes", "y_nodes", "t_nodes")
             if k in kw}
    jg = jw.GriddedWinds2D(u_data=jnp.asarray(u), v_data=jnp.asarray(v),
                           **{k: jnp.asarray(a, jnp.float32)
                              for k, a in nodes.items()}, **kw)
    tg = tw.GriddedWinds2D(u_data=torch.as_tensor(u), v_data=torch.as_tensor(v),
                           **{k: torch.as_tensor(np.asarray(a, np.float32))
                              for k, a in nodes.items()}, **kw)
    return jg, tg


def _record(seed, nt=10, nxw=8, nyw=8, **kw):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((nt, nxw, nyw)).astype(np.float32) * 3 + 8
    v = rng.standard_normal((nt, nxw, nyw)).astype(np.float32) * 2 + 3
    return _pair(u, v, **kw)


def _tables():
    t_nodes = np.array([0.0, 500.0, 1700.0, 2400.0, 4400.0, 5000.0])
    y_nodes = 50e3 * (1 + np.sin(np.linspace(-np.pi / 2, np.pi / 2, 8)))
    y_nodes[0], y_nodes[-1] = 0.0, 100e3
    x_nodes = np.array([0.0, 10e3, 25e3, 30e3, 55e3, 70e3, 85e3, 100e3])
    return dict(x_nodes=x_nodes, y_nodes=y_nodes, t_nodes=t_nodes)


# ---------------------------------------------------------------------------
# the interpolant, the breakpoints and the per-window planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("mode,mode_t", [("nearest", "clamp"),
                                         ("wrap", "clamp"),
                                         ("nearest", "wrap"),
                                         ("wrap", "wrap")])
def test_interpolant_matches_jax(mode, mode_t, tables):
    """u/v at random points inside and outside the record (space and
    time), uniform axes and node tables (tests/test_gridded_winds.py:34,
    :69, :136)."""
    kw = dict(x0=0.0, dx=100e3 / 7, y0=0.0, dy=100e3 / 7, t0=0.0, dt=600.0,
              mode=mode, mode_t=mode_t)
    if tables:
        kw.update(_tables())
    nt = 6 if tables else 10
    jg, tg = _record(3, nt=nt, **kw)
    rng = np.random.default_rng(4)
    x, y = (rng.uniform(-40e3, 150e3, (12, 9)).astype(np.float32)
            for _ in range(2))
    t = rng.uniform(-2000.0, 9000.0, (12, 9)).astype(np.float32)
    for name in ("u", "v"):
        j = np.asarray(getattr(jg, name)(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(t)))
        p = getattr(tg, name)(torch.as_tensor(x), torch.as_tensor(y),
                              torch.as_tensor(t))
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # uv shares the corners of u and v
    pu, pv = tg.uv(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(t))
    assert torch.equal(pu, tg.u(torch.as_tensor(x), torch.as_tensor(y),
                                torch.as_tensor(t)))
    # scalars, as the JAX tests pass them
    np.testing.assert_allclose(float(tg.u(20e3, 50e3, 100.0)),
                               float(jg.u(20e3, 50e3, 100.0)), rtol=1e-6)


def test_n_breakpoints_match_jax():
    jg, tg = _record(5, dt=400.0, x0=0.0, dx=1e4, y0=0.0, dy=1e4, t0=0.0)
    for DT_ in (300.0, 400.0, 600.0, 900.0, 1200.0):
        assert tg.n_breakpoints(DT_) == jg.n_breakpoints(DT_)
    # a node table, capped at the record length (test_gridded_winds.py:315)
    for t_nodes in ([0.0, 1.0, 3600.0, 7200.0], [1000.0, 1400.0, 2600.0,
                                                 3000.0, 4200.0]):
        jg, tg = _record(5, nt=len(t_nodes), x0=0.0, dx=1e4, y0=0.0,
                         dy=1e4, t0=0.0, dt=1.0, t_nodes=np.array(t_nodes))
        for DT_ in (300.0, 900.0):
            assert tg.n_breakpoints(DT_) == jg.n_breakpoints(DT_)
    assert tg.n_breakpoints(900.0) == 3
    jg, tg = _record(5, nt=4, x0=0.0, dx=1e4, y0=0.0, dy=1e4, t0=0.0,
                     dt=1.0, t_nodes=np.array([0.0, 1.0, 3600.0, 7200.0]))
    assert tg.n_breakpoints(900.0) == 4


PLANE_CASES = [
    # (t0, dtw, DT), tests/test_advance_pallas.py:156-162
    (1200.0, 1200.0, 600.0),
    (900.0, 1200.0, 600.0),
    (700.0, 1200.0, 600.0),
    (500.0, 400.0, 600.0),
    (10300.0, 1200.0, 600.0),
    # five days in: the float32 clock's cancellation in a = u0 - t_f0 s
    (4.3e5, 3600.0, 600.0),
]


def _window_points():
    x = np.linspace(0, 70e3, 8, dtype=np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return xx, yy


def _assert_planes(jf, tf):
    assert len(jf) == len(tf)
    for k, (a, b) in enumerate(zip(jf, tf)):
        a = np.broadcast_to(np.asarray(a), b.shape)
        scale = max(float(np.abs(a).max()), 1e-30)
        assert b.dtype == torch.float32
        err = float(np.abs(b.numpy() - a).max())
        assert err <= 1e-6 * scale, (k, err, scale)


@pytest.mark.parametrize("t0,dtw,DT_", PLANE_CASES)
def test_pwl_planes_match_jax(t0, dtw, DT_):
    jg, tg = _record(1, nt=200 if t0 > 1e5 else 10, x0=0.0, dx=10e3,
                     y0=0.0, dy=10e3, t0=0.0, dt=dtw)
    xx, yy = _window_points()
    B = tg.n_breakpoints(DT_)
    jf = jg.pallas_pwl_fields(jnp.asarray(xx), jnp.asarray(yy), t0, DT_)
    tf = tg.pallas_pwl_fields(torch.as_tensor(xx), torch.as_tensor(yy),
                              torch.tensor(t0), DT_)
    assert len(tf) == 4 + 3 * B
    _assert_planes(jf, tf)
    # the corners a stepping model keeps give the same planes, bit for bit
    kept = tg.pallas_pwl_fields(torch.as_tensor(xx), torch.as_tensor(yy),
                                torch.tensor(t0), DT_,
                                corners=tg.corners(torch.as_tensor(xx),
                                                   torch.as_tensor(yy)))
    assert all(torch.equal(a, b) for a, b in zip(kept, tf))
    # one contiguous block, in the layout the kernels read
    assert all(p.data_ptr() == tf[0].data_ptr() + k * tf[0].numel() * 4
               for k, p in enumerate(tf))
    # the samplers over the planes reproduce the interpolant in the window
    u_k, v_k = tw.gridded_samplers(B)
    X, Y = torch.as_tensor(xx), torch.as_tensor(yy)
    # five days in, a = u0 - t_f0 s and t s (about 120 m/s, whose float32
    # ulp is 7.6e-6) cancel: the JAX package's numerics, kept; up to 1.1e-4
    # apart (measured), so an absolute 2e-4 there
    atol = 1e-5 if t0 < 1e5 else 2e-4
    for frac in np.linspace(0.0, 1.0, 13):
        tq = torch.full_like(X, t0 + frac * DT_)
        u, v = tg.uv(X, Y, tq)
        np.testing.assert_allclose(u_k(X, Y, tq, *tf).numpy(), u.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=f"u {frac}")
        np.testing.assert_allclose(v_k(X, Y, tq, *tf).numpy(), v.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=f"v {frac}")


def test_pwl_planes_node_table_match_jax():
    """An irregular time axis (tests/test_gridded_winds.py:181): windows
    before, straddling and past the record."""
    t_nodes = np.array([1000.0, 1400.0, 2600.0, 3000.0, 4200.0])
    jg, tg = _record(5, nt=5, nxw=5, nyw=5, x0=0.0, dx=25e3, y0=0.0,
                     dy=25e3, t0=0.0, dt=1.0, t_nodes=t_nodes)
    X, Y = np.meshgrid(np.arange(5) * 25e3, np.arange(5) * 25e3,
                       indexing="ij")
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    B = tg.n_breakpoints(900.0)
    u_k, v_k = tw.gridded_samplers(B)
    for t0 in (0.0, 400.0, 1200.0, 2400.0, 3900.0, 5000.0):
        jf = jg.pallas_pwl_fields(jnp.asarray(X), jnp.asarray(Y), t0, 900.0)
        tf = tg.pallas_pwl_fields(torch.as_tensor(X), torch.as_tensor(Y),
                                  torch.tensor(t0), 900.0)
        _assert_planes(jf, tf)
        for frac in np.linspace(0.0, 1.0, 13):
            tq = torch.full(X.shape, t0 + frac * 900.0)
            u, v = tg.uv(torch.as_tensor(X), torch.as_tensor(Y), tq)
            np.testing.assert_allclose(
                u_k(None, None, tq, *tf).numpy(), u.numpy(), rtol=2e-5,
                atol=2e-4, err_msg=f"u t0={t0} {frac}")
            np.testing.assert_allclose(
                v_k(None, None, tq, *tf).numpy(), v.numpy(), rtol=2e-5,
                atol=2e-4, err_msg=f"v t0={t0} {frac}")


def test_pwl_planes_refuse_wrapped_node_table():
    _, tg = _record(5, nt=5, nxw=5, nyw=5, x0=0.0, dx=25e3, y0=0.0,
                    dy=25e3, t0=0.0, dt=1.0, mode_t="wrap",
                    t_nodes=np.array([0.0, 400.0, 1600.0, 2000.0, 3000.0]))
    with pytest.raises(ValueError, match="mode_t='wrap'"):
        tg.pallas_pwl_fields(torch.zeros(2, 2), torch.zeros(2, 2),
                             torch.tensor(0.0), 600.0)


# ---------------------------------------------------------------------------
# the plain versions of the gridded kernel instances, against JAX's kernels
# ---------------------------------------------------------------------------

def _straddle_record(cadence, seed=7, lx=14e3, ly=30e3, mode="wrap"):
    """Winds varying sharply between frames at ``cadence`` (the JAX
    straddle test's record, tests/test_advance_pallas.py:193), its 10^2
    nodes over ``lx`` x ``ly``."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(6.0, 14.0, (30, 1, 1))
    u = (base + rng.standard_normal((30, 10, 10))).astype(np.float32)
    v = (0.5 * base + rng.standard_normal((30, 10, 10))).astype(np.float32)
    return _pair(u, v, x0=0.0, dx=lx / 9, y0=0.0, dy=ly / 9, t0=0.0,
                 dt=cadence, mode=mode)


def _window(cadence, t0, x, y):
    """JAX's planes of the window and both packages' views of them."""
    jg, _ = _straddle_record(cadence)
    B = jg.n_breakpoints(DT)
    jf = jg.pallas_pwl_fields(jnp.asarray(x), jnp.asarray(y), t0, DT)
    jf = tuple(jnp.broadcast_to(f, x.shape) for f in jf)
    tf = tuple(torch.as_tensor(np.array(f)) for f in jf)
    return B, jf, tf


@pytest.mark.parametrize("cadence,t0", [(900.0, 600.0), (400.0, 500.0)])
@pytest.mark.parametrize("method,adaptive", [("bosh3", False),
                                             ("tsit5", False),
                                             ("bosh3", True),
                                             ("tsit5", True)])
def test_k1_plain_matches_pallas_interpret(method, adaptive, cadence, t0):
    """K1's gridded instance, plain version (``integrate_to`` over
    ``pwl_winds``), against JAX's ``advance_pallas`` with the same
    ``wind_fields``."""
    comps, active, x, y, jc, tc, _, _ = _case(0, "constant")
    B, jf, tf = _window(cadence, t0, x, y)
    u_k, v_k = jw.gridded_pallas_samplers(B)
    tt = np.full(x.shape, t0, np.float32)
    dt = np.full(x.shape, 37.5 if not adaptive else 1e-3, np.float32)
    j = advance_pallas(u_k, v_k, jc, jrhs.TermFlags(),
                       jts.SolverConfig(method=method, adaptive=adaptive), DT,
                       tuple(jnp.asarray(c) for c in comps), jnp.asarray(tt),
                       jnp.asarray(dt), jnp.asarray(active), jnp.asarray(x),
                       jnp.asarray(y), PROJ, jnp.zeros(x.shape),
                       wind_fields=jf, interpret=True)
    pw = tw.pwl_winds(tf)
    t0_t = torch.as_tensor(tt)
    m00, m01, m10, m11, pc = PROJ
    aux = trhs.RHSParams(x=torch.as_tensor(x), y=torch.as_tensor(y),
                         M=torch.tensor([[m00, m01], [m10, m11]]),
                         pc=torch.tensor(pc))
    p = tts.integrate_to(trhs.make_rhs(pw.u, pw.v, tc, trhs.TermFlags()),
                         torch.stack([torch.as_tensor(c) for c in comps], -1),
                         t0_t, t0_t + DT, torch.as_tensor(dt), aux,
                         torch.as_tensor(active),
                         tts.SolverConfig(method=method, adaptive=adaptive))
    rtol, atol = (5e-3, 1e-4) if adaptive else (1e-5, 1e-6)
    for i, name in enumerate(("lne", "cgx", "cgy", "x", "y")):
        np.testing.assert_allclose(p.z[..., i].numpy(),
                                   np.asarray(getattr(j, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))
    np.testing.assert_array_equal(p.failed.numpy(), np.asarray(j.failed))
    if not adaptive:
        np.testing.assert_array_equal(p.naccept.numpy(),
                                      np.asarray(j.naccept))


@pytest.mark.parametrize("cadence,t0", [(900.0, 600.0), (400.0, 500.0)])
def test_k3_plain_matches_pallas_interpret(cadence, t0):
    """K3's gridded instance, plain version (``auto_dt_reset`` over
    ``pwl_winds``), against JAX's ``auto_dt_pallas`` with the same
    ``wind_fields``, clamped and selected as the JAX step does."""
    comps, _, x, y, jc, tc, _, _ = _case(1, "constant")
    B, jf, tf = _window(cadence, t0, x, y)
    u_k, v_k = jw.gridded_pallas_samplers(B)
    tt = np.full(x.shape, t0 + 37.0, np.float32)
    rng = np.random.default_rng(9)
    reset = rng.uniform(size=x.shape) < 0.5
    dt = rng.uniform(1e-3, 900.0, x.shape).astype(np.float32)
    j_est = auto_dt_pallas(u_k, v_k, jc, jrhs.TermFlags(), jnp.asarray(tt),
                           tuple(jnp.asarray(c) for c in comps),
                           jnp.asarray(x), jnp.asarray(y), PROJ,
                           jnp.zeros(x.shape), order=5.0, wind_fields=jf,
                           interpret=True)
    j = np.asarray(jnp.where(jnp.asarray(reset), jnp.clip(j_est, 1e-4, DT),
                             jnp.asarray(dt)))
    pw = tw.pwl_winds(tf)
    m00, m01, m10, m11, pc = PROJ
    aux = trhs.RHSParams(x=torch.as_tensor(x), y=torch.as_tensor(y),
                         M=torch.tensor([[m00, m01], [m10, m11]]),
                         pc=torch.tensor(pc))
    p = auto_dt_reset(trhs.make_rhs(pw.u, pw.v, tc, trhs.TermFlags()),
                      torch.as_tensor(tt),
                      torch.stack([torch.as_tensor(c) for c in comps], -1),
                      aux, torch.as_tensor(reset), torch.as_tensor(dt), 1e-4,
                      DT, order=5.0).numpy()
    np.testing.assert_array_equal(p[~reset], dt[~reset])
    np.testing.assert_allclose(p, j, rtol=1e-5)


@pytest.mark.parametrize("t0,knife_edge", [(1500.0, False), (500.0, True)])
def test_card_b3_window_is_not_a_knife_edge(t0, knife_edge):
    """The card test ``test_gridded_kernels_match_plain`` holds adaptive K1
    to its plain version by share of lanes (99% within rtol 5e-3), which
    only a window where rounding does not decide the controller's path can
    meet.  Its B = 3 window, [1500, 2100] s: one ulp more in one plane
    (a_u) moves under 1% of the plain version's adaptive tsit5 lanes past
    that rtol; over [500, 1100] s of the same record it moves more than
    10% (so no kernel could pass there)."""
    from test_torch_cuda import _consts, _gridded, _share_close, _state

    dev = torch.device("cpu")
    _, wf, _ = _gridded(dev, 64, 200.0, t0)
    assert len(wf) == 4 + 3 * 3
    comps, active, g = _state(dev, n=64, seed=3)
    aux = trhs.RHSParams(g.x, g.y, g.proj, g.pc)
    t = torch.full_like(comps[0], t0)
    cfg = tts.SolverConfig(method="tsit5", adaptive=True, dtmin=1e-4,
                           force_dtmin=True)
    nudged = list(wf)
    nudged[0] = torch.nextafter(wf[0], torch.full_like(wf[0], np.inf))
    z = []
    for planes in (wf, nudged):
        pw = tw.pwl_winds(planes)
        z.append(tts.integrate_to(
            trhs.make_rhs(pw.u, pw.v, _consts(), trhs.TermFlags()),
            torch.stack(comps, -1), t, t + DT, torch.full_like(t, 60.0), aux,
            active, cfg).z)
    share = min(_share_close(z[0][..., i], z[1][..., i], 5e-3, 1e-4)
                for i in range(5))
    assert (share < 0.9) if knife_edge else (share >= 0.99), share


def _calm_record(n):
    """Winds below sqrt(2) m/s over part of the grid, so the remesh
    reseeds some nodes and switches others off."""
    rng = np.random.default_rng(31)
    u = rng.uniform(-1.5, 12.0, (12, 6, 6)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (12, 6, 6)).astype(np.float32)
    u[:, :2, :] = 0.3
    return _pair(u, v, x0=0.0, dx=2e3 * (n - 1) / 5, y0=0.0,
                 dy=2e3 * (n - 1) / 5, t0=0.0, dt=900.0)


def _minimal():
    ms = np.asarray(jfr.MinimalState(2.0, 2.0, DT), np.float32)
    return float(ms[0]), float(ms[1])


_CORE = ("lne", "cgx", "cgy", "px", "py", "dt", "on", "active", "boundary",
         "x", "y")


def _remesh_params(winds, clip=True):
    me, mm2 = _minimal()
    return trm.RemeshParams(winds=winds, defaults=None, bdefaults=None,
                            boundary_source=True, timestep=DT, minimal_e=me,
                            minimal_m2=mm2, wind_min_squared=2.0, dtmin=1e-4,
                            clip_dt=clip)


def _assert_remesh(t, j):
    jl, jx, jy, jpx, jpy, jdt, jon, jbr = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(t.branch.numpy(), jbr)
    np.testing.assert_array_equal(t.on.numpy(), jon != 0)
    np.testing.assert_array_equal(t.dt.numpy(), jdt)
    np.testing.assert_array_equal(t.px.numpy(), jpx)
    np.testing.assert_array_equal(t.py.numpy(), jpy)
    for a, b in ((t.lne, jl), (t.cgx, jx), (t.cgy, jy)):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-6,
                                   atol=2e-6 * np.abs(b).max())
    for bit in (trm.GATHER_BIT, trm.RESEED_BIT, trm.OFF_BIT):
        assert ((t.branch.numpy() & bit) != 0).sum() > 0, bit


def test_k5_plain_matches_pallas_interpret():
    """K5's gridded instance, plain version (``remesh_core`` with
    ``pwl_winds`` at the clock), against JAX's ``remesh_pallas`` with the
    same ``wind_fields``; gather, reseed and off all fire."""
    n, clock = 16, 1200.0
    c = _inputs(n, 11)
    jg, _ = _calm_record(n)
    B = jg.n_breakpoints(DT)
    jf = tuple(jnp.broadcast_to(f, (n, n)) for f in jg.pallas_pwl_fields(
        jnp.asarray(c["x"]), jnp.asarray(c["y"]), clock, DT))
    tf = tuple(torch.as_tensor(np.array(f)) for f in jf)
    u_k, v_k = jw.gridded_pallas_samplers(B)
    me, mm2 = _minimal()
    j = jrm.remesh_pallas(
        u_k, v_k, None, DT, me, mm2, 2.0, 1e-4,
        tuple(jnp.asarray(a) for a in c["node"]),
        *(jnp.asarray(c[k]) for k in _CORE), jnp.float32(clock),
        wind_fields=jf, interpret=True, boundary_defaults=None,
        boundary_source=True)
    t = trm.remesh_core(_remesh_params(tw.pwl_winds(tf)),
                        tuple(torch.as_tensor(a) for a in c["node"]),
                        *(torch.as_tensor(c[k]) for k in _CORE),
                        torch.tensor(clock))
    _assert_remesh(t, j)


def test_k6_plain_matches_fused_interpret():
    """K6's gridded instance: JAX's ``scatter_remesh_fused`` with
    ``wind_fields`` against ``scatter_dense`` then ``remesh_core`` over
    ``pwl_winds``."""
    n, clock = 16, 600.0
    c = _inputs(n, 12)
    jg, _ = _calm_record(n)
    B = jg.n_breakpoints(DT)
    jf = tuple(jnp.broadcast_to(f, (n, n)) for f in jg.pallas_pwl_fields(
        jnp.asarray(c["x"]), jnp.asarray(c["y"]), clock, DT))
    tf = tuple(torch.as_tensor(np.array(f)) for f in jf)
    rng = np.random.default_rng(5)
    xr = rng.uniform(-0.9, 2.9, (n, n)).astype(np.float32)
    yr = rng.uniform(-0.2, 1.9, (n, n)).astype(np.float32)
    sact = c["on"] & c["active"]
    halo = ((1, 3), (0, 2))
    u_k, v_k = jw.gridded_pallas_samplers(B)
    me, mm2 = _minimal()
    planes = [c[k] for k in ("lne", "cgx", "cgy")] + [xr, yr] + \
        [c[k] for k in ("dt", "on", "active", "boundary", "x", "y")]
    js = JStats(nx=n, ny=n, bx=JB.NONPERIODIC, by=JB.NONPERIODIC)
    jnode, jrem, _ = scatter_remesh_fused(
        u_k, v_k, None, None, True, DT, me, mm2, 2.0, 1e-4,
        jnp.asarray(xr), jnp.asarray(yr),
        tuple(jnp.asarray(a) for a in c["node"]), jnp.asarray(sact),
        *(jnp.asarray(a) for a in planes), jnp.float32(clock), js, halo,
        wind_fields=jf, interpret=True)
    ts = TStats(nx=n, ny=n, bx=TB.NONPERIODIC, by=TB.NONPERIODIC)
    tx, ty = torch.as_tensor(xr), torch.as_tensor(yr)
    S, _ = tpic.scatter_dense(tx, ty, torch.stack(
        [torch.as_tensor(a) for a in c["node"]], -1), torch.as_tensor(sact),
        ts, halo)
    node = tuple(S[..., i] for i in range(3))
    for a, b in zip(node, jnode):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    # the branch table on the kernel's own node sums (the two deposits sum
    # in other orders, which the gather's quotients would carry further)
    core = [torch.as_tensor(a) for a in planes]
    t = trm.remesh_core(_remesh_params(tw.pwl_winds(tf)),
                        tuple(torch.as_tensor(np.array(a)) for a in jnode),
                        *core, torch.tensor(clock))
    _assert_remesh(t, jrem)


# ---------------------------------------------------------------------------
# the slice as a whole: the JAX model against the port's
# ---------------------------------------------------------------------------

def _settings(**kw):
    """The JAX gridded tests' settings, with the float64-oracle test's tight
    solver tolerances (tests/test_full_step_oracle.py:760) unless given:
    at the default abstol 1e-4 and reltol 1e-3 the young seas of these
    records leave the error controller at the edge of accepting, and the
    JAX model jitted and run eagerly (no fused multiply-adds) already
    differ by up to 12% on some lanes after one step (measured on the blob
    record)."""
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    base = dict(log_energy_minimum=float(ws.lne), saving_step=DT,
                timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                dtmin=1e-4, force_dtmin=True, abstol=1e-7, reltol=1e-6)
    base.update(kw)
    return JSettings(**base)


def _port(jm, winds):
    g = jm.grid
    grid = convert.grid_from_numpy(
        {f: np.asarray(getattr(g, f)) for f in convert.GRID_FIELDS}, g.stats,
        device="cpu")
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    return pt.WaveGrowth2D(grid, winds, sett, ode_params=params,
                           constants=cid, flags=convert.flags_from_jax(jm.flags),
                           config=convert.config_from_jax(jm.config))


def _run_both(jm, tm, steps, rtol, check=None):
    jstep = jax.jit(jm.step)
    jms, tms = jm.init_state(), tm.init_state()
    # seeding at 1e-5: jitted, XLA divides a coordinate by a record spacing
    # as a product with its reciprocal, an ulp of index (the port and eager
    # JAX agree bit for bit), up to 3 ulps of wind
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-5, atol=1e-12, err_msg="seeding")
    np.testing.assert_array_equal(tms.particles.on.numpy(),
                                  np.asarray(jms.particles.on))
    for k in range(steps):
        jms, tms = jstep(jms), tm.step(tms)
        J = np.asarray(jms.state)
        np.testing.assert_allclose(tms.state.numpy(), J, rtol=rtol,
                                   atol=1e-9, err_msg=f"step {k + 1}")
        got = tms.metrics.as_dict()
        for c in COUNTERS[:-1]:
            assert got[c] == int(getattr(jms.metrics, c)), f"{c} at {k + 1}"
        # the most substeps any lane took: one lane's controller may take
        # another path (measured: at most 2 apart)
        assert abs(got["substeps_max"] - int(jms.metrics.substeps_max)) <= 2
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
        if check is not None:
            check(k, tms, J)
    return jms, tms


def _blob_record():
    """tests/test_gridded_winds.py:17: a blob moving in +x."""
    nt, nx, ny = 8, 11, 11
    t = np.linspace(0, 4 * 3600.0, nt)
    x = np.linspace(0, 100e3, nx)
    y = np.linspace(0, 100e3, ny)
    T, X, Y = np.meshgrid(t, x, y, indexing="ij")
    x0 = 20e3 + 8.0 * T
    u = (12.0 * np.exp(-(((X - x0) / 25e3) ** 2 + ((Y - 50e3) / 30e3) ** 2))
         ).astype(np.float32)
    return _pair(u, np.zeros_like(u), x0=0.0, dx=float(x[1] - x[0]), y0=0.0,
                 dy=float(y[1] - y[0]), t0=0.0, dt=float(t[1] - t[0]))


@pytest.mark.parametrize("as_winds", [False, True])
def test_blob_model_matches_jax(as_winds):
    """tests/test_gridded_winds.py:44: the blob over a non-periodic 21^2
    box, 8 steps; passed as the record or as its ``as_winds()``."""
    jg, tg = _blob_record()
    grid = j_box(100e3, 21, 100e3, 21, periodic_boundary=(False, False))
    jm = JModel(grid, jg.as_winds(), _settings(),
                config=JConfig(periodic_boundary=False))
    tm = _port(jm, tg.as_winds() if as_winds else tg)
    assert tm.gridded_winds is not None and tm._wind_B == jm._wind_B
    assert tm.resolved_config().advance_mode == "torch"
    _, tms = _run_both(jm, tm, 8, 1e-3)
    assert int(tms.metrics.n_failed) == 0
    assert tms.state[8:16, 8:13, 0].max() > 0


def test_straddle_model_matches_jax():
    """tests/test_advance_pallas.py:193: a 900 s cadence against DT = 600 s,
    so every other window crosses a frame."""
    jg, tg = _straddle_record(900.0, lx=100e3, ly=100e3, mode="nearest")
    grid = j_box(100e3, 12, 100e3, 12, periodic_boundary=(True, True))
    jm = JModel(grid, jg.as_winds(), _settings(),
                config=JConfig(periodic_boundary=True, advance_mode="xla"))
    tm = _port(jm, tg)
    assert tm._wind_B == 1
    _run_both(jm, tm, 4, 1e-3)


def test_oracle_case_matches_jax():
    """The float64-oracle case of tests/test_full_step_oracle.py:711
    (900 s cadence, tight solver tolerances, a 6^2 periodic box): the port
    against the JAX model at that test's bound, rtol 2e-4."""
    nxw = nyw = 5
    rng = np.random.default_rng(23)
    u = (9.0 + 1.5 * rng.standard_normal((8, nxw, nyw))).astype(np.float32)
    v = (4.0 + rng.standard_normal((8, nxw, nyw))).astype(np.float32)
    jg, tg = _pair(u, v, x0=0.0, dx=100e3 / 4, y0=0.0, dy=100e3 / 4, t0=0.0,
                   dt=900.0)
    grid = j_box(100e3, 6, 100e3, 6, periodic_boundary=(True, True))
    jm = JModel(grid, jg.as_winds(), _settings(),
                config=JConfig(periodic_boundary=True))
    _run_both(jm, _port(jm, tg.as_winds()), 3, 2e-4)


def test_relight_model_matches_jax():
    """Off particles re-lit in the advance: a calm patch (0.3 m/s) in the
    first frame of a 900 s record and 10 m/s winds from the second on, so
    the patch seeds off and its wind at t + DT (two thirds of the way to
    the second frame) re-lights it; the port's model against JAX's, every
    counter equal at each step."""
    rng = np.random.default_rng(19)
    u = (10.0 + rng.standard_normal((12, 6, 6))).astype(np.float32)
    v = (3.0 + rng.standard_normal((12, 6, 6))).astype(np.float32)
    u[0, :3], v[0, :3] = 0.3, 0.2
    jg, tg = _pair(u, v, x0=0.0, dx=100e3 / 5, y0=0.0, dy=100e3 / 5, t0=0.0,
                   dt=900.0)
    grid = j_box(100e3, 12, 100e3, 12, periodic_boundary=(True, True))
    jm = JModel(grid, jg.as_winds(), _settings(),
                config=JConfig(periodic_boundary=True))
    tm = _port(jm, tg)
    assert not tm.init_state().particles.on.all()
    relit = []
    _run_both(jm, tm, 4, 1e-3,
              check=lambda k, tms, J: relit.append(int(tms.metrics.n_relight)))
    assert relit[0] > 0 and sum(relit) == relit[0], relit


def test_model_keeps_corners_per_grid():
    """The model computes the record's corners of its nodes once and the
    planes from them equal the planes computed afresh, bit for bit; a
    different grid (a sharded step's block) gets its own."""
    _, tg = _blob_record()
    grid = pt.cartesian_box(100e3, 10, 100e3, 10,
                            periodic_boundary=(True, True), device="cpu")
    m = pt.WaveGrowth2D(grid, tg, pt.ODESettings())
    clock = torch.tensor(1500.0)
    a = m.wind_fields(grid, clock)
    kept = m._corners[1]
    b = m.wind_fields(grid, clock + 600.0)
    assert m._corners[1] is kept
    for got, t in ((a, clock), (b, clock + 600.0)):
        fresh = tg.pallas_pwl_fields(grid.x, grid.y, t, 600.0)
        assert all(torch.equal(p, q) for p, q in zip(got, fresh))
    block = pt.cartesian_box(50e3, 5, 100e3, 10, device="cpu")
    m.wind_fields(block, clock)
    assert m._corners[0] is block


def test_short_record_matches_extended():
    """tests/test_gridded_winds.py:97 on the port: a record shorter than the
    run clamps its last frame, as a record extended by repeating it."""
    rng = np.random.default_rng(11)
    u = rng.uniform(8.0, 12.0, (3, 6, 6)).astype(np.float32)
    v = rng.uniform(2.0, 4.0, (3, 6, 6)).astype(np.float32)
    kw = dict(x0=0.0, dx=100e3 / 5, y0=0.0, dy=100e3 / 5, t0=0.0, dt=2 * DT)
    grid = pt.cartesian_box(100e3, 12, 100e3, 12,
                            periodic_boundary=(True, True), device="cpu")
    sett, _, _ = convert.settings_from_values(_settings())

    def run(uu, vv):
        m = pt.WaveGrowth2D(grid, tw.GriddedWinds2D(
            u_data=torch.as_tensor(uu), v_data=torch.as_tensor(vv), **kw),
            sett)
        return m.step_n_quiet(m.init_state(), 8).state.numpy()

    ext = (np.concatenate([a, np.repeat(a[-1:], 6, axis=0)]) for a in (u, v))
    np.testing.assert_allclose(run(u, v), run(*ext), rtol=1e-3)


def test_convert_gridded_from_jax():
    jg, _ = _record(2, x0=1.0, dx=2.0, y0=3.0, dy=4.0, t0=5.0, dt=6.0,
                    mode="wrap", mode_t="wrap", **_tables())
    tg = convert.gridded_from_jax(jg, device="cpu")
    for k in ("x0", "dx", "y0", "dy", "t0", "dt", "mode", "mode_t"):
        assert getattr(tg, k) == getattr(jg, k), k
    for k in ("u_data", "v_data", "x_nodes", "y_nodes", "t_nodes"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)))
    # the device is named by the caller, as every constructor takes it
    with pytest.raises(TypeError):
        convert.gridded_from_jax(jg)


# ---------------------------------------------------------------------------
# the loader, the store and the refusals
# ---------------------------------------------------------------------------

def _write(path, fmt, names, axes, u, v):
    """A wind file with the given variable names: NetCDF-4 (h5py) or
    NetCDF-3 (scipy), the axes as given."""
    xn, yn, tn, un, vn = names
    xs, ys, ts = axes
    if fmt == "nc4":
        import h5py
        with h5py.File(path, "w") as f:
            f[un], f[vn] = u, v
            f[xn], f[yn], f[tn] = xs, ys, ts
        return
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as f:
        f.createDimension(tn, len(ts))
        f.createDimension(yn, len(ys))
        f.createDimension(xn, len(xs))
        for nm, ax in ((xn, xs), (yn, ys), (tn, ts)):
            f.createVariable(nm, "f8", (nm,))[:] = ax
        for nm, a in ((un, u), (vn, v)):
            f.createVariable(nm, "f4", (tn, yn, xn))[:] = a


LOADER_CASES = [
    # (names, axes kind, loader kwargs)
    (("longitude", "latitude", "time", "u10", "v10"), "uniform", {}),
    (("lon", "lat", "time", "U10N", "V10N"), "era5",
     dict(u_name="U10N", v_name="V10N", x_name="lon", y_name="lat",
          time_scale=3600.0, relative_time=True)),
    (("longitude", "latitude", "time", "u10", "v10"), "gaussian", {}),
]


@pytest.mark.parametrize("fmt", ["nc4", "nc3"])
@pytest.mark.parametrize("names,kind,kw", LOADER_CASES)
def test_loader_matches_jax(tmp_path, fmt, names, kind, kw):
    """Port and JAX loaders on the same file (tests/test_utils_and_
    checkpoint.py:168, :252, tests/test_gridded_winds.py:284, :361):
    NetCDF-4 and NetCDF-3, ERA5 names with hours since an epoch and a
    north-to-south latitude, a gaussian (node-table) latitude."""
    from picles_tpu.forcing.winds import load_gridded_winds_2d as j_load

    rng = np.random.default_rng(17)
    nt, ny_, nx_ = 4, 7, 5
    xs = np.linspace(0.0, 40e3, nx_)
    ys = np.linspace(0.0, 60e3, ny_)
    ts = np.arange(nt) * 3600.0
    if kind == "era5":
        ys, ts = ys[::-1].copy(), 1_000_000.0 + np.arange(nt) * 1.0
    elif kind == "gaussian":
        ys = 50e3 * (1 + np.sin(np.linspace(-np.pi / 2, np.pi / 2, ny_)))
    u = rng.uniform(5.0, 15.0, (nt, ny_, nx_)).astype(np.float32)
    v = rng.uniform(-4.0, 4.0, (nt, ny_, nx_)).astype(np.float32)
    path = str(tmp_path / f"winds_{fmt}.nc")
    _write(path, fmt, names, (xs, ys, ts), u, v)
    jg, tg = j_load(path, **kw), pt.load_gridded_winds_2d(
        path, device="cpu", **kw)
    for k in ("x0", "dx", "y0", "dy", "t0", "dt", "mode", "mode_t"):
        assert getattr(tg, k) == getattr(jg, k), k
    for k in ("u_data", "v_data", "x_nodes", "y_nodes", "t_nodes"):
        a, b = getattr(tg, k), getattr(jg, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert (tg.y_nodes is not None) == (kind == "gaussian")
    if kind == "era5":
        assert tg.dt == 3600.0 and tg.t0 == 0.0 and tg.dy > 0
        np.testing.assert_allclose(float(tg.u(xs[2], ys[4], 3600.0)),
                                   u[1, 4, 2], rtol=1e-6)


def test_loader_without_h5py_reads_netcdf3(tmp_path, monkeypatch):
    """Where h5py is not installed (the card's machine), the NetCDF-3 file
    loads through scipy."""
    names = ("lon", "lat", "time", "U10N", "V10N")
    rng = np.random.default_rng(3)
    u = rng.uniform(5.0, 15.0, (3, 4, 5)).astype(np.float32)
    path = str(tmp_path / "era5.nc")
    _write(path, "nc3", names, (np.linspace(0, 4e4, 5),
                                np.linspace(3e4, 0, 4), np.arange(3.0)),
           u, -u)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    gw = pt.load_gridded_winds_2d(path, u_name="U10N", v_name="V10N",
                                  x_name="lon", y_name="lat",
                                  time_scale=3600.0, relative_time=True,
                                  device="cpu")
    np.testing.assert_array_equal(gw.u_data.numpy(),
                                  np.transpose(u, (0, 2, 1))[:, :, ::-1])
    assert gw.dt == 3600.0 and gw.dy == 1e4


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_loader_defaults_to_the_card(tmp_path):
    """Without ``device`` the loader asks for the CUDA device, as
    ``load_checkpoint`` does, and raises where there is none, naming the
    CPU's way out."""
    path = str(tmp_path / "era5.nc")
    u = np.ones((3, 4, 5), np.float32)
    _write(path, "nc3", ("lon", "lat", "time", "U10N", "V10N"),
           (np.linspace(0, 4e4, 5), np.linspace(0, 3e4, 4), np.arange(3.0)),
           u, u)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.load_gridded_winds_2d(path, u_name="U10N", v_name="V10N",
                                 x_name="lon", y_name="lat")


def test_store_add_forcing_matches_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(8)
    coords = dict(time=np.arange(2.0), x=np.arange(4.0), y=np.arange(3.0),
                  state=["e", "m_x", "m_y"])
    fcoords = dict(time=np.arange(2.0), x=np.arange(4.0), y=np.arange(3.0))
    u = rng.standard_normal((2, 4, 3)).astype(np.float32)
    forcing = dict(u10=u, v10=-u, missing=None)
    for store, name, f in ((JStore, "j", forcing),
                           (TStore, "t", dict(forcing, u10=torch.as_tensor(u)))):
        s = store(str(tmp_path), coords, name=name)
        s.add_forcing(f, fcoords)
        s.add_forcing(dict(u10=2 * u), fcoords)   # written once
        s.close()
    with h5py.File(tmp_path / "j.h5") as a, h5py.File(tmp_path / "t.h5") as b:
        ga, gb = a["forcing"], b["forcing"]
        assert sorted(ga) == sorted(gb) == ["time", "u10", "v10", "x", "y"]
        assert list(ga.attrs["dims"]) == list(gb.attrs["dims"])
        for k in ga:
            assert ga[k].dtype == gb[k].dtype == np.float64
            np.testing.assert_array_equal(ga[k][...], gb[k][...])


def test_cuda_modes_refuse_cpu_tensors_with_gridded_winds():
    _, tg = _blob_record()
    grid = pt.cartesian_box(100e3, 8, 100e3, 8, periodic_boundary=(True, True),
                            device="cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        pt.WaveGrowth2D(grid, tg, pt.ODESettings(),
                        config=pt.WaveGrowth2DConfig(advance_mode="cuda"))
    comps = tuple(torch.zeros(8, 8) for _ in range(5))
    m = pt.WaveGrowth2D(grid, tg, pt.ODESettings())
    wf = m.wind_fields(grid, torch.tensor(0.0))
    with pytest.raises(ValueError, match="not a CUDA device"):
        advance_cuda(m.winds, m.consts, m.flags, m.solver, DT, comps,
                     torch.zeros(8, 8), torch.ones(8, 8),
                     torch.ones(8, 8, dtype=torch.bool), grid.x, grid.y,
                     m.uniform_proj, wind_fields=wf)


def test_kernel_path_refuses_wrapped_node_table(monkeypatch):
    """mode_t="wrap" with a t_nodes table has no planes: the step on the
    kernel path raises before any launch (as on a card)."""
    def cuda_modes(cfg, device):
        return dataclasses.replace(cfg, advance_mode="cuda",
                                   scatter_mode="dense_cuda")

    monkeypatch.setattr(twg, "resolve_modes", cuda_modes)
    _, tg = _record(5, nt=5, nxw=5, nyw=5, x0=0.0, dx=25e3, y0=0.0,
                    dy=25e3, t0=0.0, dt=1.0, mode_t="wrap",
                    t_nodes=np.array([0.0, 400.0, 1600.0, 2000.0, 3000.0]))
    grid = pt.cartesian_box(100e3, 8, 100e3, 8, periodic_boundary=(True, True),
                            device="cpu")
    m = pt.WaveGrowth2D(grid, tg, pt.ODESettings())
    assert m.resolved_config().advance_mode == "cuda"
    with pytest.raises(ValueError, match="mode_t='wrap'"):
        m.step(m.init_state())
