"""The port's remaining helpers against the JAX package's, on the CPU, from
the same numpy-seeded inputs: the RHS term helpers and the ray tracer
(``ops/rhs.py``), ``tsit5_step`` and ``_error_norm`` (``ops/tsit5.py``),
``halo_max``, ``merge_2d_angle`` and the ``scatter`` dispatcher
(``ops/pic.py``), ``group_velocity_from_state`` (``ops/transforms.py``),
``init_standard`` (``utils/cli.py``), ``one_d_grid`` as
``models/wave_growth_1d.py`` exports it, and the diagnostics ``max_cgx``,
``max_cgy``, ``StepTimer`` and ``profile_trace`` (``utils/diagnostics.py``).

Tolerances: float32 helpers at rtol 1e-6 of each value, with an atol of
1e-6 of the output's largest value where a helper cancels (``sin2_a_min_b``
and ``S_dir``, whose difference of two products loses the leading digits,
and ``Delta_beta``'s 1 - 1.25 sech^2 near sech^2 = 0.8: 1.8e-7 measured);
the helpers composed as the 2D RHS against the port's ``rhs_core_2d`` at
rtol 1e-6 of each tendency's scale in float32 and elementwise in float64
(they are the same algebra: the wave-age clamp on alpha against alpha^2,
max(|c|, 1e-4)^2 against max(c^2, 1e-8), the sin form from squared
norms); a Tsit5 step bit for bit over an arithmetic-only RHS, and over the
particle RHS at ``tests/test_torch_rhs_tsit5.py``'s rtol 1e-5 (the RHS's
transcendentals differ in the last ulp between the libraries); the deposit at ``tests/test_torch_pic.py``'s tolerance; exact
where both packages do the same float operations (merge rule, halo,
grids, parameters).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import (IDConstants, e_T_func,
                                       magic_fractions)
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing.winds import constant_winds as j_winds
from picles_tpu.grids.base import Boundary as JB
from picles_tpu.grids.base import GridStats as JStats
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models import wave_growth_1d as jw1
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.ops import pic as jpic
from picles_tpu.ops import rhs as jrhs
from picles_tpu.ops import transforms as jtr
from picles_tpu.ops import tsit5 as jts
from picles_tpu.utils import cli as jcli
from picles_tpu.utils import diagnostics as jdiag

import picles_torch as pt
from picles_torch import convert
from picles_torch.grids.base import Boundary as TB
from picles_torch.grids.base import GridStats as TStats
from picles_torch.models import wave_growth_1d as tw1
from picles_torch.ops import pic as tpic
from picles_torch.ops import rhs as trhs
from picles_torch.ops import transforms as ttr
from picles_torch.ops import tsit5 as tts
from picles_torch.utils import cli as tcli
from picles_torch.utils import diagnostics as tdiag

torch.set_num_threads(1)

RTOL = 1e-6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rtol=RTOL, scale_atol=0.0):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", rtol, scale_atol)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    atol = scale_atol * float(np.abs(w).max()) if scale_atol else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _consts():
    p, q, n = magic_fractions(-0.25)
    cid = IDConstants.create(r_g=0.85)
    e_T = e_T_func(cid.gamma, p, q, n, c_beta=cid.c_beta, c_D=cid.c_D,
                   c_e=cid.c_e, c_alpha=cid.c_alpha)
    return p, n, e_T, cid


def _planes(seed, n=512):
    """Seeded float32 winds, group velocities (some 0) and log energies
    over the model's range: young and old seas, calm and strong winds."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    u, v = f(-25.0, 25.0), f(-25.0, 25.0)
    cx, cy = f(-12.0, 12.0), f(-12.0, 12.0)
    u[:3], v[:3] = 0.0, 0.0
    cx[3:6], cy[3:6] = 0.0, 0.0
    cx[6], cy[6] = 1e-5, -2e-5
    return dict(u=u, v=v, cx=cx, cy=cy, lne=f(-14.0, 1.5),
                alpha=f(0.0, 3.0), H=f(0.0, 1.0), c=f(0.0, 15.0),
                k=f(1e-3, 5.0), D=f(-0.25, 1.0))


def _helper_args(name, d, p, n, e_T, cid):
    return {
        "speed": (d["cx"], d["cy"]),
        "alpha_p": (d["u"], d["v"], d["cx"], d["cy"]),
        "alpha_func": (np.abs(d["u"]), np.abs(d["cx"])),
        "sin2_a_min_b": (d["u"], d["v"], d["cx"], d["cy"]),
        "H_beta": (d["alpha"], p),
        "Delta_beta": (d["alpha"],),
        "c_g_conversions": (d["c"], 0.85, 9.81),
        "I_tilde": (d["alpha"], d["H"], cid.C_e),
        "D_tilde_lne": (d["lne"], d["k"], e_T, n),
        "S_cg": (d["lne"], d["D"], d["k"], -1.41),
        "S_dir": (d["u"], d["v"], d["cx"], d["cy"], 1.81e-5, d["H"]),
    }[name]


HELPERS = ("speed", "alpha_p", "alpha_func", "sin2_a_min_b", "H_beta",
           "Delta_beta", "c_g_conversions", "I_tilde", "D_tilde_lne", "S_cg",
           "S_dir")
CANCELLING = ("sin2_a_min_b", "S_dir", "Delta_beta")


@pytest.mark.parametrize("name", HELPERS)
def test_rhs_helper_matches_jax(name):
    p, n, e_T, cid = _consts()
    args = _helper_args(name, _planes(HELPERS.index(name)), p, n, e_T, cid)
    want = getattr(jrhs, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args))
    got = getattr(trhs, name)(*(torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args))
    _close(got, want, name,
           scale_atol=RTOL if name in CANCELLING else 0.0)


def _composed_2d(d, M, pc, c, T):
    """The 2D tendencies from the helpers, composed as the JAX package's
    ``rhs_core_2d`` composes its terms (``T``: the module, port or JAX)."""
    lne, cg_x, cg_y, u, v = d["lne"], d["cx"], d["cy"], d["u"], d["v"]
    _, k_p, omega_p = T.c_g_conversions(T.speed(cg_x, cg_y), c.r_g, c.g)
    c_gp_x, c_gp_y = cg_x / c.r_g, cg_y / c.r_g
    alpha = T.alpha_func(T.speed(u, v), T.speed(c_gp_x, c_gp_y))
    a_p = T.alpha_p(u, v, c_gp_x, c_gp_y)
    H_p = T.H_beta(a_p, c.p)
    Delta_p = T.Delta_beta(a_p)
    I_t = T.I_tilde(alpha, H_p, c.C_e)
    D_t = T.D_tilde_lne(lne, k_p, c.e_T, c.n)
    S_cg_t = T.S_cg(lne, Delta_p, k_p, c.C_alpha)
    S_dir_t = T.S_dir(u, v, c_gp_x, c_gp_y, c.C_varphi, H_p)
    S_sphere_t = pc * cg_x
    dlne = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t)
    dcg_x = (-cg_x * omega_p * c.r_g * S_cg_t + cg_y * S_dir_t
             + cg_y * S_sphere_t)
    dcg_y = (-cg_y * omega_p * c.r_g * S_cg_t - cg_x * S_dir_t
             - cg_x * S_sphere_t)
    return (dlne, dcg_x, dcg_y, M[0] * cg_x + M[1] * cg_y,
            M[2] * cg_x + M[3] * cg_y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_helpers_compose_to_rhs_core_2d(dtype):
    """The helpers, composed as the 2D RHS's terms, give the port's fused
    ``rhs_core_2d`` (and JAX's composition gives JAX's, in float32):
    within 1e-6 of each tendency's scale in float32, elementwise in
    float64 (a small C_e so that the input term is not lost beside the
    dissipation)."""
    d = {k: torch.from_numpy(a).to(dtype) for k, a in _planes(99).items()}
    M = (1 / 2e3, 1e-4, -2e-4, 1 / 3e3)
    pc = torch.full_like(d["u"], 3e-7)
    c = trhs.make_rhs_consts()
    c = c._replace(C_e=2.35e-3)
    got = _composed_2d(d, M, pc, c, trhs)
    want = trhs.rhs_core_2d(d["lne"], d["cx"], d["cy"], d["u"], d["v"],
                            *M, pc, c)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype
        if dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=1e-12
                                       * float(w.abs().max()))
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=RTOL
                                       * float(w.abs().max()))
    if dtype == torch.float32:
        jd = {k: jnp.asarray(a.numpy()) for k, a in d.items()}
        jc = jrhs.RHSConsts(*c)
        jgot = _composed_2d(jd, M, jnp.asarray(pc.numpy()), jc, jrhs)
        jwant = jrhs.rhs_core_2d(jd["lne"], jd["cx"], jd["cy"], jd["u"],
                                 jd["v"], *M, jnp.asarray(pc.numpy()), jc)
        for g, w in zip(jgot, jwant):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                       atol=RTOL * float(np.abs(w).max()))


def test_particle_rays_matches_jax():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((7, 3)).astype(np.float32)
    want = jrhs.particle_rays()(0.0, jnp.asarray(z), None)
    got = trhs.particle_rays()(0.0, torch.from_numpy(z), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy()[:, :2] == 0) and \
        np.array_equal(got.numpy()[:, 2], z[:, 1])


# ---------------------------------------------------------------------------
# tsit5_step and _error_norm
# ---------------------------------------------------------------------------

def _particle_rhs_pair():
    jr = jrhs.particle_equations(lambda x, y, t: jnp.full_like(x, 9.0),
                                 lambda x, y, t: jnp.full_like(x, -4.0))
    tr = trhs.particle_equations(lambda x, y, t: torch.full_like(x, 9.0),
                                 lambda x, y, t: torch.full_like(x, -4.0))
    return jr, tr


def _logistic(t, z, aux):
    """An arithmetic-only nonlinear RHS (no transcendental, so both
    libraries round each stage alike): logistic growth in z[..., 0] and a
    rotation of z[..., 1:]."""
    a, b, c = z[..., 0], z[..., 1], z[..., 2]
    return (a * (1.0 - a) * 0.3, -0.7 * c + 0.1 * a * b, 0.7 * b - 0.2 * c)


def _jlogistic(t, z, aux):
    return jnp.stack(_logistic(t, z, aux), axis=-1)


def _tlogistic(t, z, aux):
    return torch.stack(_logistic(t, z, aux), dim=-1)


def test_tsit5_step_matches_jax_bitwise():
    """One Tsit5 step of an arithmetic-only RHS from seeded states and
    substeps, with and without a carried FSAL stage: the same float
    operations in the same order, so the new state, the error estimate
    and the FSAL stage equal JAX's bit for bit."""
    rng = np.random.default_rng(22)
    z = rng.uniform(-1.0, 1.5, (200, 3)).astype(np.float32)
    t = rng.uniform(0.0, 10.0, 200).astype(np.float32)
    dt = rng.uniform(0.01, 0.8, 200).astype(np.float32)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    for k1 in (False, True):
        kj = _jlogistic(0.0, zj, None) if k1 else None
        kt = _tlogistic(0.0, zt, None) if k1 else None
        out_j = jts.tsit5_step(_jlogistic, jnp.asarray(t), zj,
                               jnp.asarray(dt), None, k1=kj)
        out_t = tts.tsit5_step(_tlogistic, torch.from_numpy(t), zt,
                               torch.from_numpy(dt), None, k1=kt)
        for g, w in zip(out_t, out_j):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tsit5_step_of_the_particle_rhs_matches_jax():
    """One Tsit5 step of the particle RHS from seeded windseas (the seeds
    of 5-15 m/s winds over 10 min to 2 h) and substeps of 0.5-5 s.  The
    two libraries' exp, pow and tanh differ in the last ulp (the RHS by up
    to 5.5e-7 of its scale, measured), so the new state is held at
    tests/test_torch_rhs_tsit5.py's bound for the same float32 operations,
    rtol 1e-5 and 1e-6 of each component's scale.  The young sea is stiff:
    the RHS at the new state moves by 4.5e-5 of its scale for the state's
    1.5e-6, and the error estimate (nearly cancelling stages) by 1e-3 of
    its own; so the FSAL stage is held to be the port's RHS at the port's
    new state, bit for bit, and the error estimate by the controller's use
    of it: its scaled norm within rtol 1e-3 and 1e-5 of the accept
    threshold 1 (4.6e-4 measured on a lane at 0.36) and the same accept
    decision on every lane."""
    rng = np.random.default_rng(21)
    n = 64
    ws = jfr.get_initial_windsea(rng.uniform(5.0, 15.0, n),
                                 rng.uniform(-8.0, 8.0, n),
                                 rng.uniform(600.0, 7200.0, n))
    z = np.stack([np.asarray(ws.lne), np.asarray(ws.cg_bar_x),
                  np.asarray(ws.cg_bar_y), np.zeros(n), np.zeros(n)],
                 -1).astype(np.float32)
    t = rng.uniform(0.0, 600.0, n).astype(np.float32)
    dt = rng.uniform(0.5, 5.0, n).astype(np.float32)
    x = np.zeros(n, np.float32)
    M = np.tile(np.eye(2, dtype=np.float32) / 2e3, (n, 1, 1))
    jaux = jrhs.RHSParams(x=jnp.asarray(x), y=jnp.asarray(x),
                          M=jnp.asarray(M), pc=jnp.asarray(x))
    taux = trhs.RHSParams(x=torch.from_numpy(x), y=torch.from_numpy(x),
                          M=torch.from_numpy(M), pc=torch.from_numpy(x))
    jr, tr = _particle_rhs_pair()
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    tj, tt = jnp.asarray(t), torch.from_numpy(t)
    dj, dtt = jnp.asarray(dt), torch.from_numpy(dt)
    for k1 in (False, True):
        kj = jr(tj, zj, jaux) if k1 else None
        kt = tr(tt, zt, taux) if k1 else None
        jz, jerr, jk = jts.tsit5_step(jr, tj, zj, dj, jaux, k1=kj)
        gz, gerr, gk = tts.tsit5_step(tr, tt, zt, dtt, taux, k1=kt)
        w = np.asarray(jz)
        assert np.isfinite(w).all()
        assert np.abs(gz.numpy() - w).max() > 0    # the ulps do show
        d = np.abs(gz.numpy() - w)
        assert np.all(d <= 1e-5 * np.abs(w) + 1e-6 * np.abs(w).max(axis=0))
        assert torch.equal(gk, tr(tt + dtt, gz, taux))
        jn = np.asarray(jts._error_norm(jerr, zj, jz, 1e-4, 1e-3))
        tn = tts._error_norm(gerr, zt, gz, 1e-4, 1e-3).numpy()
        np.testing.assert_allclose(tn, jn, rtol=1e-3, atol=1e-5)
        assert np.array_equal(tn <= 1.0, jn <= 1.0)


def test_error_norm_matches_jax():
    rng = np.random.default_rng(4)
    err, z0, z1 = (rng.standard_normal((40, 5)).astype(np.float32)
                   for _ in range(3))
    want = jts._error_norm(jnp.asarray(err), jnp.asarray(z0), jnp.asarray(z1),
                           1e-4, 1e-3)
    got = tts._error_norm(*(torch.from_numpy(a) for a in (err, z0, z1)),
                          1e-4, 1e-3)
    _close(got, want, "_error_norm")


# ---------------------------------------------------------------------------
# the deposit's helpers and dispatcher
# ---------------------------------------------------------------------------

def test_halo_max_matches_jax():
    for h in (3, (1, 2), ((0, 3), (1, 2)), ((4, 1), (0, 0))):
        assert tpic.halo_max(h) == jpic.halo_max(h)
    assert tpic.halo_max(((0, 3), (1, 2))) == 3


def test_merge_2d_angle_rules():
    """``tests/test_pic.py``'s merge rule cases on the port."""
    g = torch.tensor([1.0, 0.5, 0.0])
    c = torch.tensor([2.0, 0.4, 0.1])
    torch.testing.assert_close(tpic.merge_2d_angle(g, c), g + c)
    z = torch.zeros(3)
    c2 = torch.tensor([2.0, -0.4, 0.1])
    torch.testing.assert_close(tpic.merge_2d_angle(z, c2), c2)
    g3, c3 = torch.tensor([3.0, 0.5, 0.0]), torch.tensor([1.0, -0.5, 0.0])
    assert torch.equal(tpic.merge_2d_angle(g3, c3), g3)
    assert torch.equal(tpic.merge_2d_angle(c3, g3), g3)
    out = tpic.merge_2d_angle(torch.stack([g, g3]), torch.stack([c, c3]))
    torch.testing.assert_close(out[0], g + c)
    assert torch.equal(out[1], g3)


def test_merge_2d_angle_matches_jax():
    """Seeded node states and charges, both orientations, empty nodes:
    the same float operations, bit for bit."""
    rng = np.random.default_rng(13)
    g = rng.standard_normal((3, 50, 3)).astype(np.float32)
    c = rng.standard_normal((3, 50, 3)).astype(np.float32)
    g[..., 0], c[..., 0] = np.abs(g[..., 0]), np.abs(c[..., 0])
    g[0, :5, 1:] = 0.0
    c[1, :5, 1:] = 0.0
    want = jpic.merge_2d_angle(jnp.asarray(g), jnp.asarray(c))
    got = tpic.merge_2d_angle(torch.from_numpy(g), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _deposit_inputs(nx, ny, seed, lo=-0.8, hi=2.7):
    rng = np.random.default_rng(seed)
    xr = rng.uniform(lo, hi, (nx, ny)).astype(np.float32)
    yr = rng.uniform(lo, hi, (nx, ny)).astype(np.float32)
    ch = rng.uniform(0, 1, (nx, ny, 3)).astype(np.float32)
    act = rng.uniform(0, 1, (nx, ny)) > 0.3
    return xr, yr, ch, act


@pytest.mark.parametrize("by", ["PERIODIC", "NONPERIODIC", "TRIPOLAR_NORTH"])
@pytest.mark.parametrize("mode", ["dense", "xla"])
def test_scatter_matches_jax(mode, by):
    """``scatter`` on stacked charges, the port's modes against JAX's
    (tests/test_pic.py:238-268): asymmetric halo ((1, 3), (1, 3)), every
    y boundary, at tests/test_torch_pic.py's tolerance, clamp counts
    equal."""
    nx, ny = 12, 10
    xr, yr, ch, act = _deposit_inputs(nx, ny, 7)
    halo = ((1, 3), (1, 3))
    js = JStats(nx=nx, ny=ny, bx=JB.PERIODIC, by=JB[by])
    ts = TStats(nx=nx, ny=ny, bx=TB.PERIODIC, by=TB[by])
    S1, st1 = jpic.scatter(*(jnp.asarray(a) for a in (xr, yr, ch, act)), js,
                           halo, mode=mode)
    S2, st2 = tpic.scatter(*(torch.from_numpy(a) for a in (xr, yr, ch, act)),
                           ts, halo, mode=mode)
    w = np.asarray(S1)
    assert S2.shape == (nx, ny, 3)
    np.testing.assert_allclose(S2.numpy(), w, rtol=1e-5,
                               atol=1e-6 * np.abs(w).max())
    assert int(st2.clamped) == int(st1.clamped)


def test_scatter_dense_equals_scatter_channels():
    """The dispatcher's dense deposit of a stacked charge is the channel
    deposit's, bit for bit; its modes run the same code."""
    nx, ny = 9, 11
    xr, yr, ch, act = (torch.from_numpy(a)
                       for a in _deposit_inputs(nx, ny, 3))
    st = TStats(nx=nx, ny=ny, bx=TB.NONPERIODIC, by=TB.PERIODIC)
    S, s1 = tpic.scatter(xr, yr, ch, act, st, 3)
    planes, s2 = tpic.scatter_channels(xr, yr, tuple(ch.unbind(-1)), act, st,
                                       3)
    assert torch.equal(S, torch.stack(planes, -1))
    assert int(s1.clamped) == int(s2.clamped)


@pytest.mark.parametrize("mode", ["dense_cuda", "dense_pallas"])
def test_scatter_kernel_mode_refuses_cpu_tensors(mode):
    """"dense_cuda" (and JAX's name for it, "dense_pallas") is kernel K2:
    on CPU tensors it raises and never deposits with the plain version."""
    nx, ny = 8, 8
    xr, yr, ch, act = (torch.from_numpy(a)
                       for a in _deposit_inputs(nx, ny, 2))
    st = TStats(nx=nx, ny=ny, bx=TB.PERIODIC, by=TB.PERIODIC)
    with pytest.raises(ValueError, match="CUDA"):
        tpic.scatter(xr, yr, ch, act, st, 3, mode=mode)
    with pytest.raises(ValueError, match="unknown scatter mode"):
        tpic.scatter(xr, yr, ch, act, st, 3, mode="pallas")


# ---------------------------------------------------------------------------
# transforms, the CLI's initialization, the 1D grid, diagnostics
# ---------------------------------------------------------------------------

def test_group_velocity_from_state_matches_jax():
    rng = np.random.default_rng(8)
    s = rng.standard_normal((6, 7, 3)).astype(np.float32)
    s[..., 0] = np.abs(s[..., 0])
    s[0, 0] = 0.0
    want = jtr.group_velocity_from_state(jnp.asarray(s))
    got = ttr.group_velocity_from_state(torch.from_numpy(s))
    _close(got, want, "group velocity")


@pytest.mark.parametrize("u,v,DT,r_g0", [(10.0, 0.0, 600.0, 0.85),
                                         (3.0, -7.5, 1200.0, 0.9)])
def test_init_standard_matches_jax(u, v, DT, r_g0):
    """The particle defaults, parameters, windsea and constants of the
    JAX package's ``init_standard``, with its DT/2 windsea and its
    ``C_varphi = c_beta``."""
    jps, jpars, jws, jcid = jcli.init_standard(u, v, DT, r_g0)
    ps, pars, ws, cid = tcli.init_standard(u, v, DT, r_g0, device="cpu")
    np.testing.assert_allclose(dataclasses.astuple(ps),
                               dataclasses.astuple(jps), rtol=RTOL)
    assert dataclasses.asdict(pars) == dataclasses.asdict(jpars)
    assert dataclasses.asdict(cid) == dataclasses.asdict(jcid)
    assert pars.C_varphi == cid.c_beta
    for k in jws._fields:
        _close(getattr(ws, k), getattr(jws, k), k)
    assert ws.lne.device.type == "cpu"
    half = tcli.init_standard(u, v, DT, r_g0, device="cpu")[2]
    assert torch.equal(half.lne, pt.FetchRelations.get_initial_windsea(
        u, v, DT / 2).lne)


def test_one_d_grid_in_the_1d_model_module():
    """The 1D model's module exports the grid constructor, as JAX's
    defines it there: same nodes and statistics."""
    jg = jw1.one_d_grid(0.0, 500e3, 31, periodic=True)
    tg = tw1.one_d_grid(0.0, 500e3, 31, periodic=True, device="cpu")
    assert tw1.one_d_grid is pt.one_d_grid
    np.testing.assert_array_equal(tg.x.numpy(), np.asarray(jg.x))
    assert dataclasses.asdict(tg.stats) == {
        k: (int(v) if k in ("bx", "by") else v)
        for k, v in dataclasses.asdict(jg.stats).items()}


def _state_pair():
    DT = 600.0
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    sett = JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 3600.0, dt=1e-3, dtmin=1e-4,
                     force_dtmin=True)
    jm = JModel(j_box(100e3, 9, 100e3, 9, periodic_boundary=(True, True)),
                j_winds(10.0, -6.0), sett)
    jms = jax.jit(jm.step)(jm.init_state())
    leaves = {k: np.asarray(getattr(jms.particles, k))
              for k in convert.PARTICLE_FIELDS}
    tms = convert.state_from_numpy(np.asarray(jms.state), leaves,
                                   np.asarray(jms.time),
                                   np.asarray(jms.iteration), device="cpu")
    return jms, tms


def test_max_cg_diagnostics_match_jax():
    jms, tms = _state_pair()
    for name in ("max_cgx", "max_cgy", "max_energy", "mean_of_state"):
        assert getattr(tdiag, name)(tms) == pytest.approx(
            getattr(jdiag, name)(jms), rel=1e-6)


def test_step_timer(monkeypatch):
    """``tests/test_utils_and_checkpoint.py::test_step_timer`` on the port;
    on CPU tensors ``measure`` waits for no card."""
    def refuse(*a, **k):
        raise AssertionError("synchronized a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    model = pt.WaveGrowth2D(
        pt.cartesian_box(100e3, 9, 100e3, 9, periodic_boundary=(True, True),
                         device="cpu"),
        pt.constant_winds(10.0, 10.0), pt.ODESettings(dt=1e-3, dtmin=1e-4))
    ms = model.init_state()
    timer = tdiag.StepTimer()
    for _ in range(3):
        with timer.measure(sync_on=ms.state):
            ms = model.step(ms)
    with timer.measure(sync_on=ms):
        pass
    s = timer.summary()
    assert s["n"] == 4 and s["mean_s"] > 0
    jt = jdiag.StepTimer()
    with jt.measure():
        pass
    assert set(s) == set(jt.summary())
    assert tdiag.StepTimer().summary() == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``profile_trace(logdir)`` writes one Chrome trace of the block into
    ``logdir``, naming the block's operations."""
    logdir = str(tmp_path / "trace")
    with tdiag.profile_trace(logdir) as prof:
        torch.linalg.norm(torch.ones(64, 64))
    assert prof is not None
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, files[0])) as f:
        trace = json.load(f)
    assert any("linalg" in e.get("name", "") for e in trace["traceEvents"])
    default = tdiag.profile_trace.__wrapped__.__defaults__[0]
    assert os.path.basename(default) == "picles_torch_trace"
