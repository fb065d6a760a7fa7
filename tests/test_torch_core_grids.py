"""PyTorch port vs the JAX package: constants, fetch relations, winds, grids,
masks and the particle/node transforms (CPU, small inputs from a numpy
seed).  Tolerances are stated in each assert: exact where both compute the
same float32 operations on the same inputs, rtol 1e-6 where the
transcendentals of the two libraries may differ in the last ulp."""

import dataclasses

import numpy as np
import pytest
import torch

from picles_tpu.core import constants as jc
from picles_tpu.core import fetch_relations as jfr
from picles_tpu.forcing import winds as jw
from picles_tpu.grids import cartesian as jcart
from picles_tpu.grids import mask as jmask
from picles_tpu.ops import transforms as jtr

from picles_torch.core import constants as tc
from picles_torch.core import fetch_relations as tfr
from picles_torch.forcing import winds as tw
from picles_torch.grids import cartesian as tcart
from picles_torch.grids import mask as tmask
from picles_torch.ops import transforms as ttr

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_constants_match_exactly():
    jp, jid, jscg = jc.ODEParameters.create()
    tp, tid, tscg = tc.ODEParameters.create()
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert dataclasses.asdict(jid) == dataclasses.asdict(tid)
    assert dataclasses.asdict(jscg) == dataclasses.asdict(tscg)
    for q in (-0.25, -0.3):
        assert jc.magic_fractions(q) == tc.magic_fractions(q)
    p, q, n = tc.magic_fractions()
    assert jc.e_T_func(0.88, p, q, n) == tc.e_T_func(0.88, p, q, n)
    assert (dataclasses.asdict(jc.ODESettings(solver="bosh3"))
            == dataclasses.asdict(tc.ODESettings(solver="bosh3")))


def test_ode_settings_validates_against_port_methods():
    with pytest.raises(ValueError, match="unknown solver"):
        tc.ODESettings(solver="rk4")


@pytest.mark.parametrize("fn", ["get_initial_windsea", "MinimalWindsea"])
def test_windsea_matches_jax_float32(fn):
    rng = np.random.default_rng(0)
    u = rng.uniform(-15, 15, (6, 7)).astype(np.float64)
    v = rng.uniform(-15, 15, (6, 7)).astype(np.float64)
    u[0, :3] = 0.0          # zero winds: the 0.1 m/s floor / unit sign
    v[0, :2] = 0.0
    v[1, 4] = 0.0
    ja = getattr(jfr, fn)(u, v, 600.0)
    ta = getattr(tfr, fn)(u, v, 600.0)   # float64 input -> float32, as JAX
    for name in ja._fields:
        t_val = getattr(ta, name)
        assert t_val.dtype == torch.float32, name
        np.testing.assert_allclose(t_val.numpy(), _np(getattr(ja, name)),
                                   rtol=1e-6, err_msg=name)


def test_windsea_scalar_and_minimal_state():
    # rtol 2e-6 for MinimalState: E passes through four pows (one of them
    # ^-4) and m^2 squares the momentum, so one-ulp pow differences between
    # the libraries reach ~1.2e-6 there
    for fn, rtol in (("MinimalParticle", 1e-6), ("MinimalState", 2e-6)):
        j = _np(getattr(jfr, fn)(2.0, 2.0, 600.0))
        t = getattr(tfr, fn)(2.0, 2.0, 600.0)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol, err_msg=fn)
    ws_j, ws_t = jfr.MinimalWindsea(10.0, 10.0, 600.0), \
        tfr.MinimalWindsea(10.0, 10.0, 600.0)
    np.testing.assert_allclose(float(ws_t.lne), float(ws_j.lne), rtol=1e-6)
    assert ws_t.lne.shape == ()


@pytest.mark.parametrize("kind", ["constant", "half_domain", "time_cosine",
                                  "time_cosine_off"])
def test_analytic_winds_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 100e3, (5, 6)).astype(np.float32)
    y = rng.uniform(0, 100e3, (5, 6)).astype(np.float32)
    t = rng.uniform(0, 40000.0, (5, 6)).astype(np.float32)
    args = {"constant": ("constant_winds", (10.0, -4.0), {}),
            "half_domain": ("half_domain_winds", (10.0, 5.0, 50e3), {}),
            "time_cosine": ("time_cosine_winds", (10.0, 5.0, 6 * 3600.0), {}),
            "time_cosine_off": ("time_cosine_winds", (10.0, 5.0, 6 * 3600.0),
                                {"t_off": 20000.0})}[kind]
    jwind = getattr(jw, args[0])(*args[1], **args[2])
    twind = getattr(tw, args[0])(*args[1], **args[2])
    assert twind.kernel is not None
    ju, jv = jwind(x, y, t)
    tu, tv = twind(_t(x), _t(y), _t(t))
    np.testing.assert_allclose(tu.numpy(), np.broadcast_to(_np(ju), x.shape),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.broadcast_to(_np(jv), x.shape),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("periodic,angle", [((True, True), 0.0),
                                            ((False, False), 0.0),
                                            ((True, False), 30.0)])
def test_cartesian_box_fields_and_masks_exact(periodic, angle):
    jg = jcart.cartesian_box(100e3, 9, 60e3, 7, angle=angle,
                             periodic_boundary=periodic)
    tg = tcart.cartesian_box(100e3, 9, 60e3, 7, angle=angle,
                             periodic_boundary=periodic, device="cpu")
    for f in ("x", "y", "dx_m", "dy_m", "area", "angle", "mask", "proj",
              "pc"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      _np(getattr(jg, f)), err_msg=f)
    assert tg.x.dtype == torch.float32 and tg.mask.dtype == torch.int32
    for field in dataclasses.fields(jg.stats):
        jv, tv = getattr(jg.stats, field.name), getattr(tg.stats, field.name)
        assert (int(jv) == int(tv)) if field.name in ("bx", "by") \
            else jv == tv, field.name
    for pb in (True, False):
        np.testing.assert_array_equal(tg.ocean_point_mask(pb).numpy(),
                                      _np(jg.ocean_point_mask(pb)))
        np.testing.assert_array_equal(tg.boundary_point_mask(pb).numpy(),
                                      _np(jg.boundary_point_mask(pb)))


def test_mask_utilities_match():
    rng = np.random.default_rng(2)
    m = rng.uniform(size=(10, 12)) < 0.8
    np.testing.assert_array_equal(tmask.interior_boundary(m),
                                  jmask.interior_boundary(m))
    from picles_tpu.grids.base import Boundary as JB
    from picles_torch.grids.base import Boundary as TB
    for jb, tb in ((JB.PERIODIC, TB.PERIODIC),
                   (JB.NONPERIODIC, TB.NONPERIODIC)):
        np.testing.assert_array_equal(tmask.make_boundaries(m, tb, tb),
                                      jmask.make_boundaries(m, jb, jb))
    xx, yy = np.meshgrid(np.arange(10.0), np.arange(12.0), indexing="ij")
    np.testing.assert_array_equal(
        tmask.mask_circle(m, xx, yy, (4, 5), 2.5),
        jmask.mask_circle(m, xx, yy, (4, 5), 2.5))


def test_particle_node_transforms_match():
    rng = np.random.default_rng(3)
    lne = rng.uniform(-8, 0, (6, 5)).astype(np.float32)
    cgx = rng.uniform(-3, 3, (6, 5)).astype(np.float32)
    cgy = rng.uniform(-3, 3, (6, 5)).astype(np.float32)
    cgx[0, 0] = cgy[0, 0] = 0.0         # the tiny-floor branch
    j = jtr.particle_to_node(lne, cgx, cgy)
    t = ttr.particle_to_node(_t(lne), _t(cgx), _t(cgy))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
    e, mx, my = (np.array(v) for v in j)
    e[1, 1] = 0.0
    j2 = jtr.node_to_particle(e, mx, my)
    t2 = ttr.node_to_particle(_t(e), _t(mx), _t(my))
    for a, b in zip(t2, j2):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
