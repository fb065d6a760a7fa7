"""The port's float64 winds against the JAX package's with x64 on (scoped to
each test with ``jax.enable_x64``), on the CPU: the winds that the card runs
on its kernels in float64 (a wind callable that reads its time, traced in
float64; a steady callable's float64 node planes; the 1D model under each
wind kind).

- The traced evaluator: a callable traced on float64 placeholders
  (``trace_winds(..., dtype=torch.float64)``) evaluated by its plain
  version against JAX's float64 closure on the lanes' float64 arrays: the
  pulse of ``tests/test_growing_decaying_winds.py``, ``slopped_blob`` and a
  callable that mixes float32 and float64, rtol 1e-13.
- The float64 pulse model, 3 steps, the port's plain path against JAX's
  (its plain step, and its fused Pallas kernels in interpret mode against
  the port's fused path's plain versions), rtol 1e-12 of each plane's
  scale, counters equal.
- The float64 1D model under node, gridded and traced winds (each the
  plain version the card's K7 is held to: the node plane, the record
  indexed in float64, the traced graph's evaluator) against JAX's 1D loop,
  rtol 1e-12, counters equal, ``substeps_max`` within 2.
- The steady callable's float64 node planes: bit for bit the callable's
  float64 values, within 1e-15 of JAX's closure at the same nodes.
- The tracer's float64 rules: a value whose dtype depends on the rank of
  t is refused; a float32 trace still refuses float64 values; the emitted
  double text (exact double literals, no float literal in a double
  operation, a narrowing call for each conversion to float32, float32
  ``sinf``/``cosf`` out of line), built for the host with ``g++`` where
  there is one; a float32 callable's text is the float32 emitter's.

The double instances on the card are ``tests/test_torch_cuda.py``'s
(marker ``cuda``).
"""

import contextlib
import ctypes
import shutil
import subprocess

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
import test_growing_decaying_winds as tgd
from picles_torch import convert
from picles_torch.core import fetch_relations as FR
from picles_torch.forcing import wind_trace as wt
from picles_torch.forcing.winds import (slopped_blob, steady_node_plane_1d,
                                        steady_node_planes, traced_kernel_1d)

torch.set_num_threads(1)

F64 = torch.float64
DT = 600.0
BLOB = dict(U10=15.0, V=10.0, T=6 * 3600.0, x_scale=80e3, t_scale=7200.0)
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped")
PLANES = ("lne", "cgx", "cgy", "px", "py", "t", "dt")


def t_pulse(U=12.0, t_on=0.0, t_off=2 * 3600.0):
    """The pulse of tests/test_growing_decaying_winds.py in torch."""
    def u(x, y, t):
        t = torch.as_tensor(t)
        return torch.where((t >= t_on) & (t < t_off), U, 0.0) + 0.0 * x

    return pt.Winds2D(u=u, v=lambda x, y, t: torch.zeros_like(x))


def t_mixed_u(x, y, t):
    """float32 arithmetic on float32(t), widened into a float64 sum (IEEE
    operations only: XLA's float32 sqrt on the CPU is not PyTorch's)."""
    return 10.0 + (t.float() / 3600.0 - 2.5) * 1.3 + 1e-5 * x


def j_mixed_u(x, y, t):
    return (10.0 + (jnp.asarray(t, jnp.float32) / 3600.0 - 2.5) * 1.3
            + 1e-5 * x)


def t_blob_v(x, y, t):
    return 0.1 * y * torch.cos(t / 3600.0)


def j_blob_v(x, y, t):
    return 0.1 * y * jnp.cos(t / 3600.0)


CLOSURES = {
    "pulse": (tuple(t_pulse()[:2]), tuple(tgd._pulse_winds()[:2])),
    "slopped_blob": ((lambda x, y, t: slopped_blob(x, t, **BLOB), t_blob_v),
                     (lambda x, y, t: jw.slopped_blob(x, t, **BLOB),
                      j_blob_v)),
    "mixed float32 and float64": ((t_mixed_u, t_blob_v),
                                  (j_mixed_u, j_blob_v)),
}


def _lanes(n=4096, seed=17):
    """float64 node coordinates and per-lane times (the pulse's switch
    times and their float64 neighbours among them; 0's are +-1e-300, not
    subnormal: XLA's CPU flushes subnormals to zero)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1e5, 6e5, n)
    y = rng.uniform(-80.0, 80.0, n)
    t = rng.uniform(0.0, 2e4, n)
    sw = np.array([0.0, 3600.0, 7200.0, 9000.0])
    lo, hi = np.nextafter(sw, -1e9), np.nextafter(sw, 1e9)
    lo[0], hi[0] = -1e-300, 1e-300
    near = np.concatenate([sw, lo, hi])
    t[:near.size] = near
    return x, y, t


@pytest.mark.parametrize("name", list(CLOSURES))
def test_traced_evaluator_float64_matches_jax_closure(name):
    """The float64 trace's plain version (``TracedWind.evaluate``) bit for
    bit the callable, in its own dtypes, and within 1e-13 of JAX's float64
    closure at the same float64 lanes, each cast to float64 as the kernels
    cast it."""
    (tu, tv), (ju, jv) = CLOSURES[name]
    tr = wt.trace_winds(tu, tv, dtype=F64)
    assert tr.dtype == F64
    x, y, t = _lanes()
    tx, ty, tt = (torch.from_numpy(a) for a in (x, y, t))
    got = tr.evaluate(tx, ty, tt)
    for g, f in zip(got, (tu, tv)):
        want = torch.broadcast_to(torch.as_tensor(f(tx, ty, tt)), g.shape)
        assert g.dtype == want.dtype
        assert torch.equal(g, want), name
    with jax.enable_x64(True):
        jx, jy, jt = (jnp.asarray(a) for a in (x, y, t))
        for g, f in zip(got, (ju, jv)):
            want = np.broadcast_to(np.asarray(
                jnp.asarray(f(jx, jy, jt), jnp.float64)), g.shape)
            np.testing.assert_allclose(g.to(F64).numpy(), want, rtol=1e-13,
                                       atol=1e-13 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the float64 pulse model
# ---------------------------------------------------------------------------

def _sett(cls, FRm, adaptive=False, sub=60.0):
    ws = FRm.MinimalWindsea(12.0, 0.0, DT)
    return cls(log_energy_minimum=float(ws.lne), saving_step=DT, timestep=DT,
               total_time=6 * 24 * 3600.0, dt=sub, dtmin=1e-4,
               force_dtmin=True, adaptive=adaptive)


def _check_state(tms, jms, rtol, what, smax_slack=0):
    """Node state and every particle plane within rtol of its scale, ``on``
    and the counters equal (``substeps_max`` within ``smax_slack``)."""
    def scale_close(got, want, name):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float64, name
        scale = max(float(np.max(np.abs(want))), 1e-300)
        err = float(np.max(np.abs(got - want))) / scale
        assert err <= rtol, f"{what} {name}: {err:.3g} of the scale"

    scale_close(tms.state, jms.state, "state")
    for k in PLANES:
        if hasattr(tms.particles, k):
            scale_close(getattr(tms.particles, k), getattr(jms.particles, k),
                        k)
    if hasattr(tms.particles, "z"):
        scale_close(tms.particles.z, jms.particles.z, "z")
    assert np.array_equal(tms.particles.on.numpy(),
                          np.asarray(jms.particles.on)), what
    got = tms.metrics.as_dict()
    for k in COUNTERS:
        assert got[k] == int(getattr(jms.metrics, k)), f"{what} {k}"
    smax = abs(got["substeps_max"] - int(jms.metrics.substeps_max))
    assert smax <= smax_slack, f"{what} substeps_max {smax}"


PULSE_PATHS = {
    "plain": ({}, {}),
    "fused": (dict(remesh_mode="fused", scatter_mode="dense_pallas",
                   advance_mode="pallas", dt_reset_mode="carry",
                   pallas_interpret=True),
              dict(remesh_mode="fused", dt_reset_mode="carry")),
}


@pytest.mark.parametrize("path", sorted(PULSE_PATHS))
def test_pulse_model_float64_matches_jax(path):
    """The float64 pulse (12 m/s for 2 h, then calm) on a 12 x 12 box in
    fixed 60 s substeps, each package from its own initial state, 3
    steps: the port's plain path (with the fused path's modes, the plain
    versions of K1, K6) against JAX's (its plain step; its Pallas kernels
    with the closure inlined, interpret mode), rtol 1e-12 of each plane's
    scale, counters equal."""
    jcfg, tcfg = PULSE_PATHS[path]
    L, n = 100e3, 12
    with jax.enable_x64(True):
        jm = JModel(j_box(L, n, L, n, dtype=jnp.float64,
                          periodic_boundary=(True, True)),
                    tgd._pulse_winds(), _sett(JSettings, JFR),
                    config=JConfig(periodic_boundary=True, dtype=jnp.float64,
                                   **jcfg))
        tm = pt.WaveGrowth2D(pt.cartesian_box(L, n, L, n, device="cpu",
                                              dtype=F64,
                                              periodic_boundary=(True, True)),
                             t_pulse(), _sett(pt.ODESettings, FR),
                             config=pt.WaveGrowth2DConfig(
                                 periodic_boundary=True, dtype=F64, **tcfg))
        jms, tms = jm.init_state(), tm.init_state()
        _check_state(tms, jms, 1e-13, "init")
        jstep = jax.jit(jm.step)
        for k in range(3):
            jms, tms = jstep(jms), tm.step(tms)
            _check_state(tms, jms, 1e-12, f"{path} step {k}")
        assert int(tms.metrics.n_active) > 0


# ---------------------------------------------------------------------------
# the float64 1D model under each wind kind
# ---------------------------------------------------------------------------

def _steady_1d_t(x, t):
    return 8.0 + 4.0 * torch.cos(x / 7e4) + 0.0 * x


def _steady_1d_j(x, t):
    return 8.0 + 4.0 * jnp.cos(x / 7e4) + 0.0 * x


def _record():
    rng = np.random.default_rng(23)
    return dict(u_data=rng.uniform(2.0, 18.0, (41, 13)).astype(np.float32),
                x0=0.0, dx=12.5e3, t0=0.0, dt=3600.0)


def _models_1d(kind, nx=31):
    """JAX's float64 1D model and the port's on the CPU, the port's wind
    the plain version that K7's instance of ``kind`` is held to on the
    card."""
    sett = dict(log_energy_minimum=float(FR.MinimalWindsea_1d(10.0, DT).lne),
                saving_step=DT, timestep=DT, total_time=DT * 8, dt=20.0,
                dtmin=1e-4, force_dtmin=True, adaptive=False)
    grid = pt.one_d_grid(0.0, 500e3, nx, periodic=True, device="cpu",
                         dtype=F64)
    if kind == "node":
        jwind = jw.Winds1D(u=_steady_1d_j)
        plane = steady_node_plane_1d(pt.Winds1D(u=_steady_1d_t), grid.x, F64)
        assert plane.dtype == F64
        twind = pt.Winds1D(u=lambda x, t: plane)
    elif kind == "gridded":
        r = _record()
        jwind = jw.GriddedWinds1D(u_data=jnp.asarray(r["u_data"]),
                                  **{k: v for k, v in r.items()
                                     if k != "u_data"})
        twind = convert.gridded1d_from_jax(jwind, device="cpu")
    else:
        jwind = jw.Winds1D(u=lambda x, t: jw.slopped_blob(x, t, **BLOB))
        traced = traced_kernel_1d(
            pt.Winds1D(u=lambda x, t: slopped_blob(x, t, **BLOB)),
            dtype=F64).traced
        assert traced.dtype == F64
        twind = traced.winds()
    jm = JModel1D(j_grid_1d(0.0, 500e3, nx, periodic=True, dtype=jnp.float64),
                  jwind, JSettings(**sett),
                  config=JConfig1D(periodic_boundary=True, dtype=jnp.float64))
    tm = pt.WaveGrowth1D(grid, twind, pt.ODESettings(**sett),
                         config=pt.WaveGrowth1DConfig(periodic_boundary=True,
                                                      dtype=F64))
    return jm, tm


# JAX's compiled 1D loop against its own eager loop (``jax.disable_jit``)
# under the record: XLA's fused loop body rounds differently, and one lane
# whose wind and state sit near the RHS's clamps carries that to 1.8e-9
# of its lne after two steps (the port stays within 1e-14 of the eager
# loop); the record is held to the eager loop, two steps (an eager step
# takes about 5 s)
STEPS_1D = {"node": 6, "gridded": 2, "traced": 6}


@pytest.mark.parametrize("kind", ["node", "gridded", "traced"])
def test_model_1d_float64_matches_jax_under_each_wind(kind):
    """The float64 1D model in fixed 20 s substeps (the tight check: an
    adaptive controller turns the two libraries' last-ulp differences of
    exp and pow into other step sequences) from each package's own
    initial state, ``STEPS_1D`` steps against JAX's loop (the record's
    eager): rtol 1e-12 of each plane's scale, counters equal,
    ``substeps_max`` within 2 (as the float32 1D holds it)."""
    with jax.enable_x64(True):
        jm, tm = _models_1d(kind)
        jms, tms = jm.init_state(), tm.init_state()
        _check_state(tms, jms, 1e-13, f"{kind} init")
        if kind == "gridded":
            ctx, jstep = jax.disable_jit(), jm.step
        else:
            ctx, jstep = contextlib.nullcontext(), jax.jit(jm.step)
        with ctx:
            for k in range(STEPS_1D[kind]):
                jms, tms = jstep(jms), tm.step(tms)
                _check_state(tms, jms, 1e-12, f"{kind} step {k}",
                             smax_slack=2)
        assert int(tms.metrics.n_active) > 0


def test_gridded_1d_indexes_float64_coordinates_as_jax():
    """The record under float64 coordinates: indexed and weighed in
    float64, the sum rounded to the record's float32, as JAX's
    ``map_coordinates`` returns it, bit for bit JAX's values (and not the
    float32-indexed ones)."""
    r = _record()
    x, _, t = _lanes(2048, seed=5)
    with jax.enable_x64(True):
        jg = jw.GriddedWinds1D(u_data=jnp.asarray(r["u_data"]),
                               **{k: v for k, v in r.items()
                                  if k != "u_data"})
        want = np.asarray(jg.u(jnp.asarray(x), jnp.asarray(t)))
    tg = convert.gridded1d_from_jax(jg, device="cpu")
    got = tg.u(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = tg.u(torch.from_numpy(x).float(), torch.from_numpy(t).float())
    assert not torch.equal(f32, got)


# ---------------------------------------------------------------------------
# the steady callable's float64 node planes
# ---------------------------------------------------------------------------

def _jet_t(x, y, t):
    """The global jet's form: U0 cos(lat) in float64 arithmetic on a
    float64 grid (y in degrees)."""
    return 20.0 * torch.cos(torch.deg2rad(y)) + 0.0 * x


def _jet_j(x, y, t):
    return 20.0 * jnp.cos(jnp.deg2rad(y)) + 0.0 * x


def test_node_planes_float64_keep_the_callables_float64_values():
    """A float64 model's node planes (``steady_node_planes`` with the
    model's dtype, ``WaveGrowth2D.node_planes``): bit for bit the
    callable's float64 values at the float64 nodes, within 1e-15 of JAX's
    closure there; a float32 model keeps float32 planes."""
    grid = pt.spherical_grid_2d(0.0, 350.0, 36, -70.0, 70.0, 29,
                                periodic_boundary=(True, False),
                                device="cpu", dtype=F64)
    steady = pt.Winds2D(u=_jet_t, v=lambda x, y, t: 3.0 + 0.0 * y)
    planes = steady_node_planes(steady, grid.x, grid.y, F64)
    assert planes.dtype == F64 and planes.is_contiguous()
    want = _jet_t(grid.x, grid.y, None)
    assert torch.equal(planes[0], want)
    assert torch.equal(planes[1], torch.full_like(want, 3.0))
    with jax.enable_x64(True):
        j = np.asarray(_jet_j(jnp.asarray(grid.x.numpy()),
                              jnp.asarray(grid.y.numpy()), None))
    np.testing.assert_allclose(planes[0].numpy(), j, rtol=1e-15, atol=1e-15)
    f32 = steady_node_planes(steady, grid.x, grid.y)
    assert f32.dtype == torch.float32
    assert float((f32[0].double() - want).abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the tracer's float64 rules and the emitted double text
# ---------------------------------------------------------------------------

_C64 = torch.tensor(2.0, dtype=F64)


def test_trace_refuses_a_dtype_that_depends_on_the_rank_of_t():
    """torch promotes a float32 [n] tensor with a float64 0-dim one to
    float32, a 0-dim float32 one to float64: the float64 trace takes t at
    the lanes' rank and 0-dim and refuses a graph whose dtypes part; a
    float32 trace still refuses any float64 value; a callable whose
    dtypes do not depend on the rank traces."""
    ranked = (lambda x, y, t: x + t.float() * _C64,
              lambda x, y, t: 0.0 * y)
    with pytest.raises(NotImplementedError) as e:
        wt.trace_winds(*ranked, dtype=F64)
    assert "rank of t" in str(e.value)
    assert 'advance_mode="torch"' in str(e.value)
    with pytest.raises(NotImplementedError, match="rank of t"):
        wt.trace_winds_1d(lambda x, t: x + t.float() * _C64, dtype=F64)
    with pytest.raises(NotImplementedError, match="float64 value in a "
                                                  "float32 trace"):
        wt.trace_winds(lambda x, y, t: x * _C64, ranked[1])
    tr = wt.trace_winds(lambda x, y, t: x + t.float().double() * _C64,
                        ranked[1], dtype=F64)
    assert [o.dtype for o in tr.ops if o.name == "cast"] == [torch.float32,
                                                              F64]


def test_emitted_double_text():
    """The float64 pulse and time-cosine sampler emitted in double: the
    signature, exact double literals (the pulse's switch time 7200 as
    0x1.c2p+12), no float literal in a double operation, each conversion
    to float32 a ``traced_f32_narrow`` call, float32 cosf out of line
    (``traced_f32_cos``); the same callables' float32 text is the
    float32 emitter's (the pulse's digest that of the float32 trace)."""
    p64 = wt.trace_winds(*t_pulse()[:2], dtype=F64)
    src = p64.source
    assert ("__device__ __forceinline__ void traced_wind(double x, double y, "
            "double t, double& u, double& v) {") in src
    assert "t < 0x1.c200000000000p+12;" in src
    assert p64.narrowings == 0 and "traced_f32_" not in src
    for ln in src.splitlines():
        if ln.startswith("  const double"):
            assert not any(tok.endswith("f") and tok.startswith("0x")
                           for tok in ln.replace(";", " ").split()), ln
    p32 = wt.trace_winds(*t_pulse()[:2])
    assert p32.digest == "864644145a01ffdc"
    assert p32.digest != p64.digest
    c = pt.time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)
    c64 = wt.trace_winds(c.u, c.v, dtype=F64)
    casts = sum(op.name == "cast" and op.dtype == torch.float32
                for op in c64.ops)
    assert casts == 2 and c64.narrowings == casts
    assert "static __device__ __noinline__ float traced_f32_narrow(double" \
        in c64.source
    assert "traced_f32_cos(" in c64.source and " cosf(s" not in c64.source
    # the period divided by a 0-dim tensor: a division, not a product
    assert " / 0x1.5180000000000p+14f;" in c64.source
    b64 = wt.trace_winds_1d(lambda x, t: slopped_blob(x, t, **BLOB),
                            dtype=F64)
    assert "double traced_wind_1d(double x, double t)" in b64.source
    assert " exp(" in b64.source and "expf" not in b64.source


def _host_probe(tmp_path, source: str):
    """The emitted double function built for the host (CUDA qualifiers
    defined away), one call a point through ctypes."""
    (tmp_path / "traced_wind.cuh").write_text(source)
    (tmp_path / "probe.cpp").write_text(
        '#include "traced_wind.cuh"\n'
        'extern "C" void probe(const double* x, const double* y, '
        'const double* t, double* u, double* v, long n) {\n'
        '  for (long i = 0; i < n; ++i)\n'
        '    picles::traced_wind(x[i], y[i], t[i], u[i], v[i]);\n}\n')
    lib = tmp_path / "probe.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-D__device__=", "-D__forceinline__=inline",
                    "-D__noinline__=", "-shared", "-fPIC", "-o", str(lib),
                    str(tmp_path / "probe.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib)).probe


@pytest.mark.parametrize("name", list(CLOSURES))
def test_emitted_double_function_built_for_the_host(tmp_path, name):
    """The emitted double function compiled by ``g++`` agrees with the
    callable: bit for bit where the graph holds only IEEE operations and
    no division, else within 8 ulps of the scale (float32 ulps where the
    graph computes in float32) where glibc's exp and cos stand beside
    PyTorch's and a division by a host scalar is its reciprocal's
    product."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tu, tv), _ = CLOSURES[name]
    tr = wt.trace_winds(tu, tv, dtype=F64)
    probe = _host_probe(tmp_path, tr.source)
    x, y, t = (torch.from_numpy(a) for a in _lanes())
    n = x.numel()
    uo, vo = torch.empty(n, dtype=F64), torch.empty(n, dtype=F64)
    vp = ctypes.c_void_p
    probe(vp(x.data_ptr()), vp(y.data_ptr()), vp(t.data_ptr()),
          vp(uo.data_ptr()), vp(vo.data_ptr()), ctypes.c_long(n))
    exact = all(op.name not in ("div", "exp", "log", "cos", "sin", "tanh")
                for op in tr.ops)
    # float32 operations of the graph part by float32 ulps (a division by
    # a host scalar is the reciprocal's product in the emitted text)
    eps = np.finfo(np.float32 if any(op.dtype == torch.float32
                                     for op in tr.ops) else np.float64).eps
    for got, f in ((uo, tu), (vo, tv)):
        want = torch.broadcast_to(torch.as_tensor(f(x, y, t)).to(F64),
                                  got.shape)
        if exact:
            assert torch.equal(got, want), name
        else:
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 8 * eps * scale, \
                f"{name}: {err:.3e} of a scale {scale:.3e}"
