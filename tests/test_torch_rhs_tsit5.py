"""PyTorch port vs the JAX package: the particle RHS and the embedded-RK
integrator (the plain versions of kernels K1 and K3), on the CPU.

Inputs are windsea seeds of a (10, 10) m/s wind with a numpy-seeded
perturbation.  Tolerances: rtol 1e-5 where both run the same float32
operations (RHS, Hairer estimate, fixed-substep integration: the last-ulp
differences of the two libraries' transcendentals stay at that level);
rtol 5e-3 in adaptive mode, where the error controller may turn an ulp into
a different accept/reject sequence."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from picles_tpu.core.constants import ODEParameters as JOP
from picles_tpu.core import fetch_relations as jfr
from picles_tpu.forcing import winds as jw
from picles_tpu.ops import rhs as jrhs
from picles_tpu.ops import tsit5 as jts

from picles_torch.core.constants import ODEParameters as TOP
from picles_torch.forcing import winds as tw
from picles_torch.ops import rhs as trhs
from picles_torch.ops import tsit5 as tts

torch.set_num_threads(1)

DT = 600.0
NX, NY = 8, 16
PROJ = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)


def _state(seed=0, noise=0.05):
    """(z [NX, NY, 5], x, y) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    ws = jfr.get_initial_windsea(np.full((NX, NY), 10.0),
                                 np.full((NX, NY), 10.0), DT)
    z = np.stack([np.asarray(ws.lne) + rng.normal(0, noise, (NX, NY)),
                  np.asarray(ws.cg_bar_x) * rng.uniform(1 - noise, 1 + noise,
                                                        (NX, NY)),
                  np.asarray(ws.cg_bar_y) * rng.uniform(1 - noise, 1 + noise,
                                                        (NX, NY)),
                  rng.uniform(-0.3, 0.3, (NX, NY)),
                  rng.uniform(-0.3, 0.3, (NX, NY))], axis=-1)
    x, y = np.meshgrid(np.arange(NX) * 2e3, np.arange(NY) * 2e3,
                       indexing="ij")
    return z.astype(np.float32), x.astype(np.float32), y.astype(np.float32)


def _consts():
    jp, jid, _ = JOP.create()
    tp, tid, _ = TOP.create()
    return (jrhs.make_rhs_consts(gamma=jid.gamma, constants=jid, params=jp),
            trhs.make_rhs_consts(gamma=tid.gamma, constants=tid, params=tp))


def _aux(x, y):
    M = np.broadcast_to(np.array([[PROJ[0], PROJ[1]], [PROJ[2], PROJ[3]]],
                                 np.float32), x.shape + (2, 2))
    pc = np.zeros_like(x)
    return (jrhs.RHSParams(x=jnp.asarray(x), y=jnp.asarray(y),
                           M=jnp.asarray(M), pc=jnp.asarray(pc)),
            trhs.RHSParams(x=torch.as_tensor(x), y=torch.as_tensor(y),
                           M=torch.as_tensor(np.ascontiguousarray(M)),
                           pc=torch.as_tensor(pc)))


def _winds(kind):
    if kind == "constant":
        return jw.constant_winds(10.0, 10.0), tw.constant_winds(10.0, 10.0)
    return (jw.time_cosine_winds(10.0, 5.0, 6 * 3600.0),
            tw.time_cosine_winds(10.0, 5.0, 6 * 3600.0))


def _rhs_pair(kind, flags=(True,) * 5):
    jwd, twd = _winds(kind)
    jp, jid, _ = JOP.create()
    tp, tid, _ = TOP.create()
    return (jrhs.particle_equations(jwd.u, jwd.v, gamma=jid.gamma, params=jp,
                                    constants=jid,
                                    flags=jrhs.TermFlags(*flags)),
            trhs.particle_equations(twd.u, twd.v, gamma=tid.gamma, params=tp,
                                    constants=tid,
                                    flags=trhs.TermFlags(*flags)))


def test_rhs_consts_match():
    jc, tc = _consts()
    assert tuple(jc) == tuple(tc)


@pytest.mark.parametrize("flags", [(True,) * 5,
                                   (True, False, True, False, True),
                                   (False, True, False, True, False)])
def test_rhs_core_2d_matches_jax(flags):
    rng = np.random.default_rng(1)
    shape = (6, 9)
    lne, cgx, cgy = (rng.uniform(-6, 0, shape), rng.uniform(-4, 4, shape),
                     rng.uniform(-4, 4, shape))
    u, v = rng.uniform(-15, 15, shape), rng.uniform(-15, 15, shape)
    cgx[0, :2] = cgy[0, :2] = 0.0       # |c| = 0: clamps and safe branches
    u[1, 0] = v[1, 0] = 0.0
    m = rng.uniform(-1e-3, 1e-3, (4,) + shape)
    pc = rng.uniform(-1e-7, 1e-7, shape)
    arrs = [a.astype(np.float32) for a in (lne, cgx, cgy, u, v, *m, pc)]
    jc, tc = _consts()
    j = jrhs.rhs_core_2d(*(jnp.asarray(a) for a in arrs), jc,
                         jrhs.TermFlags(*flags))
    t = trhs.rhs_core_2d(*(torch.as_tensor(a) for a in arrs), tc,
                         trhs.TermFlags(*flags))
    # rtol 1e-5; atol 1e-5 of the component's scale, because dcg_x and
    # dcg_y are differences of nearly equal terms (cancellation)
    for k, (a, b) in enumerate(zip(t, j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"component {k}")


@pytest.mark.parametrize("kind", ["constant", "time_cosine"])
def test_particle_equations_match(kind):
    z, x, y = _state(2)
    jaux, taux = _aux(x, y)
    jr, tr = _rhs_pair(kind)
    t = np.full((NX, NY), 1800.0, np.float32)
    j = np.asarray(jr(jnp.asarray(t), jnp.asarray(z), jaux))
    # rtol 1e-5, atol 1e-5 of each component's scale (cancellation in dcg)
    p = tr(torch.as_tensor(t), torch.as_tensor(z), taux).numpy()
    for k in range(5):
        np.testing.assert_allclose(p[..., k], j[..., k], rtol=1e-5,
                                   atol=1e-5 * np.abs(j[..., k]).max(),
                                   err_msg=f"component {k}")


@pytest.mark.parametrize("order", [3.0, 5.0])
@pytest.mark.parametrize("kind", ["constant", "time_cosine"])
def test_auto_dt_matches_jax(kind, order):
    z, x, y = _state(3)
    jaux, taux = _aux(x, y)
    jr, tr = _rhs_pair(kind)
    t = np.full((NX, NY), 3600.0, np.float32)
    j = jts.auto_dt(jr, jnp.asarray(t), jnp.asarray(z), jaux, order=order)
    p = tts.auto_dt(tr, torch.as_tensor(t), torch.as_tensor(z), taux,
                    order=order)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5)


def _integrate(kind, method, adaptive, t0v=0.0, dt0=None, seed=4):
    z, x, y = _state(seed)
    jaux, taux = _aux(x, y)
    jr, tr = _rhs_pair(kind)
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=(NX, NY)) < 0.9
    t0 = np.full((NX, NY), t0v, np.float32)
    dt = (np.full((NX, NY), dt0, np.float32) if dt0 is not None
          else rng.uniform(10.0, 120.0, (NX, NY)).astype(np.float32))
    jcfg = jts.SolverConfig(method=method, adaptive=adaptive)
    tcfg = tts.SolverConfig(method=method, adaptive=adaptive)
    j = jts.integrate_to(jr, jnp.asarray(z), jnp.asarray(t0),
                         jnp.asarray(t0 + DT), jnp.asarray(dt), jaux,
                         jnp.asarray(active), jcfg)
    p = tts.integrate_to(tr, torch.as_tensor(z), torch.as_tensor(t0),
                         torch.as_tensor(t0 + DT), torch.as_tensor(dt), taux,
                         torch.as_tensor(active), tcfg)
    return j, p


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
@pytest.mark.parametrize("kind", ["constant", "time_cosine"])
def test_integrate_to_fixed_substep_matches_jax(kind, method):
    j, p = _integrate(kind, method, adaptive=False, dt0=37.5)
    np.testing.assert_allclose(p.z.numpy(), np.asarray(j.z), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))
    np.testing.assert_array_equal(p.dt.numpy(), np.asarray(j.dt))
    np.testing.assert_array_equal(p.naccept.numpy(), np.asarray(j.naccept))
    np.testing.assert_array_equal(p.failed.numpy(), np.asarray(j.failed))


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
@pytest.mark.parametrize("kind", ["constant", "time_cosine"])
def test_integrate_to_adaptive_matches_jax(kind, method):
    j, p = _integrate(kind, method, adaptive=True, dt0=1e-3)
    np.testing.assert_allclose(p.z.numpy(), np.asarray(j.z), rtol=5e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(p.failed.numpy(), np.asarray(j.failed))
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_integrate_to_large_time_floor_matches_jax(method):
    """At t = 2^19 s, ulp(t) = 0.0625 s >> dtmin: forced-dtmin steps must use
    the spacing-aware floor or the clock freezes (tests/test_tsit5.py)."""
    t0v = 524288.0

    def wig_j(t, z, aux):
        return jnp.cos(t - t0v)[..., None] * jnp.ones_like(z)

    def wig_t(t, z, aux):
        return torch.cos(t - t0v)[..., None] * torch.ones_like(z)

    kw = dict(abstol=1e-13, reltol=1e-13, dtmin=1e-4, force_dtmin=True,
              method=method)
    z0 = np.zeros((2, 2), np.float32)
    t0 = np.full(2, t0v, np.float32)
    dt0 = np.full(2, 1e-3, np.float32)
    j = jts.integrate_to(wig_j, jnp.asarray(z0), jnp.asarray(t0),
                         jnp.asarray(t0 + 60.0), jnp.asarray(dt0), None,
                         jnp.array([True, True]), jts.SolverConfig(**kw))
    p = tts.integrate_to(wig_t, torch.as_tensor(z0), torch.as_tensor(t0),
                         torch.as_tensor(t0 + 60.0), torch.as_tensor(dt0),
                         None, torch.tensor([True, True]),
                         tts.SolverConfig(**kw))
    assert not p.failed.any()
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))
    np.testing.assert_array_equal(p.naccept.numpy(), np.asarray(j.naccept))
    assert 100 < int(p.naccept[0]) < 2000
    np.testing.assert_allclose(p.z.numpy(), np.asarray(j.z), rtol=1e-5,
                               atol=1e-6)


def test_tableaux_and_controller_constants_match():
    for name in ("tsit5", "bosh3"):
        assert tuple(jts.METHODS[name]) == tuple(tts.METHODS[name])
    assert (jts._SAFETY, jts._QMIN, jts._QMAX) == \
        (tts._SAFETY, tts._QMIN, tts._QMAX)
    assert set(jts.SolverConfig.__dataclass_fields__) == \
        set(tts.SolverConfig.__dataclass_fields__)
