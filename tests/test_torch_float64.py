"""The port's float64 against the JAX package's float64 (x64 on, scoped to
each test with ``jax.enable_x64``), on the CPU.

A float64 JAX model runs with x64 on, where ``jnp.result_type(float)`` is
float64: the fetch relations, the seeding and the remesh's windsea compute
in float64 there.  The port's twins take the model's dtype
(``core/fetch_relations.py``: float64 where a tensor input is float64 or
``dtype=torch.float64`` is passed; ``ops/remesh.py`` ``winds_at`` and
``seed_values`` in the model's dtype).

Tolerances: the fetch relations and the seeded states rtol 1e-13 (the two
libraries' float64 pow and log part in the last ulp); the model's steps
rtol 1e-12, each package from its own initial state, counters equal; the
port's plain versions of the kernel paths against JAX's Pallas kernels in
float64 in interpret mode the same.  The tableaux' float64 literals are
METHODS' values exactly.  The float64 kernels on the card are
``tests/test_torch_cuda.py``'s (marker ``cuda``).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as JFR
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_1d import WaveGrowth1D as JModel1D
from picles_tpu.models.wave_growth_1d import WaveGrowth1DConfig as JConfig1D
from picles_tpu.models.wave_growth_1d import one_d_grid as j_grid_1d
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig

import picles_torch as pt
from picles_torch.core import fetch_relations as FR
from picles_torch.grids.base import Grid2D
from picles_torch.models import wave_growth_2d as twg
from picles_torch.ops import cuda_build as CB
from picles_torch.ops.tsit5 import METHODS

torch.set_num_threads(1)

F64 = torch.float64
DT = 600.0
WINDS = [(10.0, 5.0), (3.0, 1.0), (7.3, -2.2)]
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped", "substeps_max")
PLANES = ("lne", "cgx", "cgy", "px", "py", "t", "dt")


def _winds_arrays():
    """The three winds of the issue's measurement and 64 more from a seed,
    as float64 numpy arrays (u, v)."""
    rng = np.random.default_rng(16)
    u = np.concatenate([[w[0] for w in WINDS], rng.uniform(-20, 20, 64)])
    v = np.concatenate([[w[1] for w in WINDS], rng.uniform(-20, 20, 64)])
    return u, v


def _close(got, want, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.float64, (what, got.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# the fetch relations
# ---------------------------------------------------------------------------

FETCH_2D = ("get_initial_windsea", "MinimalWindsea")


@pytest.mark.parametrize("name", FETCH_2D)
def test_windsea_float64_matches_jax(name):
    """Every field of the windsea and of the minimal windsea on float64
    tensors against JAX's with x64 on, rtol 1e-13 (float32 on the parent:
    about 1e-7 apart)."""
    u, v = _winds_arrays()
    with jax.enable_x64(True):
        j = getattr(JFR, name)(jnp.asarray(u), jnp.asarray(v), DT)
        t = getattr(FR, name)(torch.from_numpy(u), torch.from_numpy(v), DT)
        for f in t._fields:
            _close(getattr(t, f), getattr(j, f), 1e-13, f"{name} {f}")


@pytest.mark.parametrize("name", ("MinimalParticle", "MinimalState"))
def test_minimal_particle_and_state_float64_match_jax(name):
    """MinimalParticle and MinimalState of Python scalars with
    ``dtype=torch.float64`` (JAX's weak types take the x64 default) and of
    float64 tensors, rtol 1e-13."""
    u, v = _winds_arrays()
    with jax.enable_x64(True):
        for uu, vv in WINDS + [(2.0, 2.0), (2.0, 0.0)]:
            j = getattr(JFR, name)(uu, vv, DT)
            t = getattr(FR, name)(uu, vv, DT, dtype=F64)
            _close(t, j, 1e-13, f"{name}({uu}, {vv})")
        j = getattr(JFR, name)(jnp.asarray(u), jnp.asarray(v), DT)
        t = getattr(FR, name)(torch.from_numpy(u), torch.from_numpy(v), DT)
        _close(t, j, 1e-13, f"{name} arrays")


@pytest.mark.parametrize("name", ("get_initial_windsea_1d",
                                  "MinimalWindsea_1d"))
def test_windsea_1d_float64_matches_jax(name):
    """The 1D windsea of signed float64 winds (and of 0, whose minimal sea
    takes the + sign), rtol 1e-13."""
    u = np.concatenate([_winds_arrays()[0], [0.0]])
    with jax.enable_x64(True):
        j = getattr(JFR, name)(jnp.asarray(u), DT)
        t = getattr(FR, name)(torch.from_numpy(u), DT)
        for f in t._fields:
            _close(getattr(t, f), getattr(j, f), 1e-13, f"{name} {f}")


def test_fetch_relations_keep_float32_without_float64_input():
    """Without a float64 input or ``dtype`` the relations stay float32, bit
    for bit what a float32 input gives; ``dtype`` overrides the inputs'."""
    u, v = _winds_arrays()
    a = FR.get_initial_windsea(torch.from_numpy(u).float(),
                               torch.from_numpy(v).float(), DT)
    b = FR.get_initial_windsea(u.astype(np.float32), v.astype(np.float32),
                               DT)
    assert a.lne.dtype == torch.float32
    assert torch.equal(a.lne, b.lne) and torch.equal(a.cg_bar_x, b.cg_bar_x)
    assert FR.MinimalState(2.0, 2.0, DT).dtype == torch.float32
    assert FR.MinimalState(2.0, 2.0, DT, dtype=F64).dtype == F64
    w = FR.get_initial_windsea(torch.from_numpy(u), torch.from_numpy(v), DT,
                               dtype=torch.float32)
    assert w.lne.dtype == torch.float32
    assert torch.equal(w.lne, a.lne)


# ---------------------------------------------------------------------------
# the models' seeding and steps
# ---------------------------------------------------------------------------

def _jsettings(adaptive, sub, DT=DT, **tols):
    ws = JFR.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=sub,
                     dtmin=1e-4, force_dtmin=True, adaptive=adaptive, **tols)


def _settings(adaptive, sub, DT=DT, **tols):
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 24 * 3600.0, dt=sub,
                          dtmin=1e-4, force_dtmin=True, adaptive=adaptive,
                          **tols)


def _pair(n=(32, 24), adaptive=False, sub=60.0, jcfg=None, tcfg=None,
          half=True, L=100e3):
    """A float64 JAX model and its port twin on an n box (L a side,
    periodic): half-domain (10, 5) m/s winds split at L / 2 (or constant
    ones), the grid built in float64 by each package."""
    jcfg = dict(jcfg or {})
    tcfg = dict(tcfg or {})
    jwinds = (jw.half_domain_winds(10.0, 5.0, x_split=L / 2) if half
              else jw.constant_winds(10.0, 5.0))
    twinds = (pt.half_domain_winds(10.0, 5.0, x_split=L / 2) if half
              else pt.constant_winds(10.0, 5.0))
    jm = JModel(j_box(L, n[0], L, n[1], dtype=jnp.float64,
                      periodic_boundary=(True, True)),
                jwinds, _jsettings(adaptive, sub),
                config=JConfig(periodic_boundary=True, dtype=jnp.float64,
                               **jcfg))
    tm = pt.WaveGrowth2D(pt.cartesian_box(L, n[0], L, n[1],
                                          device="cpu", dtype=F64,
                                          periodic_boundary=(True, True)),
                         twinds, _settings(adaptive, sub),
                         config=pt.WaveGrowth2DConfig(periodic_boundary=True,
                                                      dtype=F64, **tcfg))
    return jm, tm


def _check_state(tms, jms, rtol, what):
    """Node state within rtol of its scale, every particle plane within
    rtol of its own scale, ``on`` and the counters equal."""
    def scale_close(got, want, name):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float64, name
        scale = max(float(np.max(np.abs(want))), 1e-300)
        err = float(np.max(np.abs(got - want))) / scale
        assert err <= rtol, f"{what} {name}: {err:.3g} of the scale"

    scale_close(tms.state, jms.state, "state")
    for k in PLANES:
        scale_close(getattr(tms.particles, k), getattr(jms.particles, k), k)
    assert np.array_equal(tms.particles.on.numpy(),
                          np.asarray(jms.particles.on)), what
    got = tms.metrics.as_dict()
    for k in COUNTERS:
        assert got[k] == int(getattr(jms.metrics, k)), f"{what} {k}"


def test_init_state_2d_float64_matches_jax():
    """The float64 seeding of the 32 x 24 half-domain model (the sharded
    tests' model), 2D, rtol 1e-13 of each plane (the parent seeded in
    float32: 2.6e-7 apart in lne)."""
    with jax.enable_x64(True):
        jm, tm = _pair()
        jms, tms = jm.init_state(), tm.init_state()
        assert tms.state.dtype == F64
        _check_state(tms, jms, 1e-13, "init")
        _close(tm.minimal_state, jm.minimal_state, 1e-13, "minimal_state")
        _close(tm.minimal_particle, jm.minimal_particle, 1e-13,
               "minimal_particle")


def test_init_state_1d_float64_matches_jax():
    """The 1D model's float64 seeding (a node wind that changes sign and
    is calm in a band, so both the windsea and the minimal particle seed
    lanes), rtol 1e-13."""
    def u_j(x, t):
        return 8.0 * jnp.cos(x / 90e3) + 0.0 * t

    def u_t(x, t):
        return 8.0 * torch.cos(x / 90e3) + 0.0 * t

    sett = dict(log_energy_minimum=float(FR.MinimalWindsea_1d(10.0, DT).lne),
                saving_step=DT, timestep=DT, total_time=DT * 4, dt=1e-3,
                dtmin=1e-4, force_dtmin=True)
    with jax.enable_x64(True):
        jm = JModel1D(j_grid_1d(0.0, 500e3, 31, periodic=False,
                                dtype=jnp.float64),
                      jw.Winds1D(u=u_j), JSettings(**sett),
                      config=JConfig1D(periodic_boundary=False,
                                       dtype=jnp.float64))
        tm = pt.WaveGrowth1D(pt.one_d_grid(0.0, 500e3, 31, periodic=False,
                                           device="cpu", dtype=F64),
                             pt.Winds1D(u=u_t), pt.ODESettings(**sett),
                             config=pt.WaveGrowth1DConfig(
                                 periodic_boundary=False, dtype=F64))
        jms, tms = jm.init_state(), tm.init_state()
        assert 0 < int(tms.particles.on.sum()) < 31
        _close(tms.state, jms.state, 1e-13, "state")
        _close(tms.particles.z, jms.particles.z, 1e-13, "z")
        assert np.array_equal(tms.particles.on.numpy(),
                              np.asarray(jms.particles.on))
        _close(tm.minimal_state, jm.minimal_state, 1e-13, "minimal_state")


def test_half_domain_model_float64_own_initial_state():
    """The 32 x 24 half-domain model, each package from its own initial
    state, three fixed 60 s substep steps: rtol 1e-12 of each plane's
    scale, counters equal (the parent: 6.3e-6)."""
    with jax.enable_x64(True):
        jm, tm = _pair()
        jms, tms = jm.init_state(), tm.init_state()
        jstep = jax.jit(jm.step)
        for k in range(3):
            jms, tms = jstep(jms), tm.step(tms)
            _check_state(tms, jms, 1e-12, f"step {k}")
        assert 0 < int(tms.metrics.n_active) < 32 * 24


# the kernel paths: JAX's Pallas kernels in interpret mode and the port's
# plain versions of the same kernels (the port's CPU runs them for the
# kernel modes), with the solver and winds of each path's test: K1-K2-K3
# adaptive under constant winds, the Hairer reset replacing every remeshed
# lane's dt, two steps (a third parts by 1.4e-12: the young seas grow the
# two libraries' last-ulp differences); K5 and K6 with the dt carried
# (dt_reset_mode="carry") under half-domain winds on a 3 km box, where
# particles cross cells and the calm half sends empty nodes downwind into
# the windy one (the reseed branch), in fixed substeps, two steps: an
# adaptive carried dt is the controller's, which turns those differences in
# the stages into 5e-11 of dt through the error estimate's cancellation
KERNEL_PATHS = {
    "K1-K2-K3": (dict(advance_mode="pallas", scatter_mode="dense_pallas",
                      pallas_interpret=True),
                 dict(advance_mode="torch", scatter_mode="dense"),
                 dict(adaptive=True, sub=1e-3, half=False), 2),
    "K5": (dict(remesh_mode="pallas", dt_reset_mode="carry",
                pallas_interpret=True),
           dict(remesh_mode="pallas", dt_reset_mode="carry"),
           dict(adaptive=False, sub=60.0, half=True, L=3e3), 2),
    "K6": (dict(remesh_mode="fused", scatter_mode="dense_pallas",
                dt_reset_mode="carry", pallas_interpret=True),
           dict(remesh_mode="fused", dt_reset_mode="carry"),
           dict(adaptive=False, sub=60.0, half=True, L=3e3), 2),
}


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_kernel_paths_float64_match_jax_pallas_interpret(path):
    """The port's float64 plain versions of the kernel paths against JAX's
    Pallas kernels in float64, interpret mode, each from its own initial
    state on a 12 x 12 box (the solver, winds and steps of
    ``KERNEL_PATHS``): rtol 1e-12 of each plane's scale, counters equal."""
    jcfg, tcfg, kw, steps = KERNEL_PATHS[path]
    with jax.enable_x64(True):
        jm, tm = _pair(n=(12, 12), jcfg=jcfg, tcfg=tcfg, **kw)
        jms, tms = jm.init_state(), tm.init_state()
        _check_state(tms, jms, 1e-13, "init")
        jstep = jax.jit(jm.step)
        reseeds = 0
        for k in range(steps):
            jms, tms = jstep(jms), tm.step(tms)
            _check_state(tms, jms, 1e-12, f"{path} step {k}")
            reseeds += int(tms.metrics.n_reseed)
        assert int(tms.metrics.n_gather) > 0
        assert reseeds > 0 or path == "K1-K2-K3"


# ---------------------------------------------------------------------------
# the modes on a card, the refusal, the build's float64 pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remesh", ["xla", "pallas", "fused"])
def test_resolve_modes_float64_on_cuda_names_the_kernels(remesh):
    """On a CUDA device a float64 config resolves "auto" to the kernels as
    float32 does (K1, K2, K3; "pallas" and "fused" keep their names: K5,
    K6); another dtype is refused."""
    cfg = pt.WaveGrowth2DConfig(dtype=F64, remesh_mode=remesh,
                                dt_reset_mode="auto" if remesh == "xla"
                                else "carry")
    out = twg.resolve_modes(cfg, torch.device("cuda"))
    assert (out.advance_mode, out.scatter_mode) == ("cuda", "dense_cuda")
    assert out.remesh_mode == remesh and out.dtype == F64
    cpu = twg.resolve_modes(cfg, torch.device("cpu"))
    assert (cpu.advance_mode, cpu.scatter_mode) == ("torch", "dense")
    with pytest.raises(ValueError, match="dtype"):
        twg.resolve_modes(pt.WaveGrowth2DConfig(dtype=torch.float16),
                          torch.device("cuda"))


def _card_grid(monkeypatch, dtype):
    """A float64 (or ``dtype``) box on the CPU whose ``device`` reads as a
    card, so that the model resolves its modes as on a card: construction
    checks run before anything reaches a device."""
    grid = pt.cartesian_box(100e3, 8, 100e3, 8, device="cpu", dtype=dtype,
                            periodic_boundary=(True, True))
    monkeypatch.setattr(Grid2D, "device", property(
        lambda self: torch.device("cuda")))
    return grid


def test_float64_traced_wind_refused_at_construction(monkeypatch):
    """A float64 model whose wind callable reads its time is built on a
    card as the traced kind in float64 (its graph traced on float64
    placeholders, the double instances' library), graphed, as a steady
    callable is built as the node kind with float64 node planes; a
    callable whose dtypes depend on the rank of t is still refused there,
    with a NotImplementedError naming the plain modes."""
    grid = _card_grid(monkeypatch, F64)
    pulse = pt.Winds2D(u=lambda x, y, t: 10.0 + 0.0 * x + t / 3600.0,
                       v=lambda x, y, t: 5.0 + 0.0 * y)
    cfg = pt.WaveGrowth2DConfig(dtype=F64)
    m = pt.WaveGrowth2D(grid, pulse, _settings(True, 1e-3), config=cfg)
    assert m.resolved_config().advance_mode == "cuda" and m.graphed
    assert m.winds.kernel.kind == pt.WindKind.TRACED
    assert m.winds.kernel.traced.dtype == F64
    assert "double x, double y, double t" in m.winds.kernel.traced.source
    c64 = torch.tensor(2.0, dtype=F64)
    ranked = pt.Winds2D(u=lambda x, y, t: x + (t.float() * c64),
                        v=lambda x, y, t: 5.0 + 0.0 * y)
    with pytest.raises(NotImplementedError) as e:
        pt.WaveGrowth2D(grid, ranked, _settings(True, 1e-3), config=cfg)
    assert "rank of t" in str(e.value)
    assert 'advance_mode="torch"' in str(e.value)
    steady = pt.Winds2D(u=lambda x, y, t: 10.0 + 0.0 * x,
                        v=lambda x, y, t: 5.0 + 0.0 * y)
    m = pt.WaveGrowth2D(grid, steady, _settings(True, 1e-3), config=cfg)
    assert m.resolved_config().advance_mode == "cuda" and m.graphed
    assert m.winds.kernel.kind == pt.WindKind.NODE
    assert m.node_planes(grid).dtype == F64


def test_float64_kernels_refuse_a_float32_grid(monkeypatch):
    """The float64 kernels read the node x and the projection in float64:
    a float64 model on a float32 grid is refused at construction on a card,
    naming the grid's dtype and the plain modes."""
    grid = _card_grid(monkeypatch, torch.float32)
    with pytest.raises(ValueError, match="grid's planes") as e:
        pt.WaveGrowth2D(grid, pt.constant_winds(10.0, 5.0),
                        _settings(True, 1e-3),
                        config=pt.WaveGrowth2DConfig(dtype=F64))
    assert 'advance_mode="torch"' in str(e.value)


def _header_functions(text, ty, sfx):
    """struct name -> {"c", "a" (flattened), "b", "bt"} of the generated
    header's ``ty`` functions named with ``sfx``, each the exact value of
    its literal."""
    out = {}
    num = r"-?0x[0-9a-f.]+p[+-]\d+" + ("f" if ty == "float" else "")
    for st, body in re.findall(r"struct (\w+) \{(.*?)\n\};", text, re.S):
        for fn, val in re.findall(
                rf"{ty} (c|a|b|bt){sfx}\(.*?constexpr {ty} v[^=]*= "
                r"(\{.*?\});", body, re.S):
            out.setdefault(st, {})[fn] = [
                float.fromhex(t.rstrip("f")) for t in re.findall(num, val)]
    return out


@pytest.mark.parametrize("name", sorted(METHODS))
def test_tableaux_float64_literals_are_methods_exactly(name):
    """The header's float64 tableaux (``c64`` ... ``bt64``, the double
    instances') are METHODS' values exactly, and its float32 ones
    float32(x): each literal rounded once to its type."""
    m = METHODS[name]
    text = CB.tableaux_header()
    st = CB.K1_METHODS[name]
    d = _header_functions(text, "double", "64")[st]
    f = _header_functions(text, "float", "")[st]
    a = [v for row in m.a for v in row]
    for k, want in (("c", list(m.c)), ("a", a), ("b", list(m.b)),
                    ("bt", list(m.bt))):
        got_d = [v for v in d[k] if v != 0.0]
        assert got_d == [v for v in want if v != 0.0], k
        got_f = [v for v in f[k] if v != 0.0]
        assert got_f == [float(np.float32(v)) for v in want if v != 0.0], k


def test_narrowing_report_reads_functions_by_name():
    """``narrowing_summary``'s rule on a PTX text: a float64 -> float32
    conversion counts inside ``F64_NARROWING_FUNC``, as libdevice's double
    tanh exponent estimate (the product by log2(e) in float32 next), or
    else as a fault, by the function it sits in; a widening is none."""
    ptx = "\n".join([
        ".func  (.param .b32 func_retval0) _ZN6piclesL20"
        "cosine_amplitude_f64Effd(",
        "{", "\tcvt.rn.f32.f64 \t%f1, %fd1;", "}",
        ".visible .entry _ZN6picles3f6414advance_kernelIdNS_5Bosh3ELb1ELb0EEEv(",
        "{", "\tcvt.rn.f64.f32 \t%fd2, %f2;", "\tcvt.rz.f32.f64 %f3, %fd3;",
        "\tcvt.rn.f32.f64 \t%f38, %fd738;",
        "\tmul.rn.f32 \t%f39, %f38, 0f3FB8AA3B;", "}"])
    assert CB.narrowing_report(ptx) == (1, 1, ["cvt.rz.f32.f64 %f3, %fd3;"])
    assert CB.source_hash(CB.F64) != CB.source_hash()
    assert CB._library_parts(CB.F64) == (CB.F64_SOURCES, CB.F64_FLAGS,
                                         CB.F64_LIB_NAME)


def test_float64_wind_params_keep_the_samplers_float32_values():
    """The wind's packed floats: U10, V10, the background, 2 pi and the
    period are the samplers' float32 values in either instance; the switch
    position and the cut-off are the Python values (compared in the lanes'
    dtype)."""
    from picles_torch.ops.advance_cuda import wind_params

    w = pt.half_domain_winds(7.3, -2.2, x_split=50e3 + 0.1,
                             background=0.3).kernel
    f, i = wind_params(w)
    assert f[0] == float(np.float32(7.3)) and f[1] == float(np.float32(-2.2))
    assert f[2] == 50e3 + 0.1 and f[3] == float(np.float32(0.3))
    assert f[4] == float(np.float32(2.0 * math.pi))
    c = pt.time_cosine_winds(10.0, 5.0, period=7.0 * 3600,
                             t_off=3600.0 + 1e-6).kernel
    f, _ = wind_params(c)
    assert f[5] == float(np.float32(7.0 * 3600)) and f[6] == 3600.0 + 1e-6
