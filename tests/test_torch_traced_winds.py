"""Wind callables that read their time: the traced kind of the kernels (CPU).

- The tracer (``forcing/wind_trace.py``) takes the growing/decaying winds
  of ``tests/test_growing_decaying_winds.py`` (the pulse and the returning
  wind), ``time_cosine_winds`` stripped of its descriptor, example 02's jet,
  a moving Gaussian blob and ``chip_smoke.every_op_winds`` (every operation
  it lowers, NaN operands of minimum, maximum and clamp); its plain
  evaluator equals each callable bit for bit on 4096 seeded points and at
  the switch times.
- It refuses what the kernels cannot compile (a value read on the host, an
  indexed captured tensor, a reduction, float64), naming the operation and
  ``advance_mode="torch"``.
- The emitted device function is deterministic, and built for the host with
  ``g++`` it equals the callable bit for bit where only comparisons,
  selects, sums and products enter, and within a stated bound where the
  emitter divides by a host scalar as ATen's CUDA kernel does (a product
  with the float32 reciprocal) or glibc's libm differs from PyTorch's.
- With the modes resolved to the kernels (as on a card) the model gives the
  pulse the traced kind, a steady callable the node kind, and a descriptor
  its own kind.
- The pulse (17 x 17) and the returning wind (13 x 13), periodic boxes, DT
  600 s, at solver tolerances abstol 1e-7 / reltol 1e-6: the port's plain
  step over the traced wind's plain version against JAX's step with its
  Pallas kernels in interpret mode (remesh "pallas" and "fused"), within
  1e-4 of the state's largest value, every counter equal through the
  on/off cycle but the most substeps a lane took, within 3 (``SMAX_SLACK``),
  no guard fired.
- The pulse on a small synthetic tripolar grid (32 x 16, its per-node
  projection planes and the seam fold), DT 1200 s, the fused remesh: the
  port's plain step over the traced wind's plain version against JAX's
  interpret-mode Pallas step through the wind's stop, 8 steps at the same
  tolerances.
- The pulse on a 128 x 16 tripolar grid with land under the seam, at a DT
  under a polar cell a step and at one that crosses two: energy reaches
  land beyond one cell of the ocean only in the second, on the same nodes
  in JAX's step and the port's.
- A (1, 1) gloo sharded step with the pulse equals the single-device step
  bit for bit.
"""

import ctypes
import dataclasses
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids import tripolar as jtri
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig

import picles_torch as pt
import test_growing_decaying_winds as tgd
from picles_torch import convert
from picles_torch.forcing import wind_trace as wt
from picles_torch.forcing import winds as tw
from picles_torch.forcing.winds import slopped_blob
from picles_torch.grids import tripolar as ttri
from picles_torch.models import wave_growth_2d as twg
from picles_torch.parallel import sharded as tsh
from test_torch_model_2d import COUNTERS, state_of

torch.set_num_threads(1)

DT = 600.0
GAP = 1e-4
GUARDS = ("n_failed", "n_nan_reset", "n_inf_reset", "n_emax_clamp")
# the most substeps a lane took, port against JAX's Pallas step: at reltol
# 1e-6 the controller turns last-ulp differences of the libraries' exp and
# tanh into other substep paths of the slowest lane.  On the pulse's box
# JAX's own plain and Pallas advances part by up to 2 (steps 9, 13-17 of
# the carried dt); the port's parts from the Pallas step by 3 (step 1, the
# first carried dt after 26 substeps from dt = 1e-3, and steps 16-17)
SMAX_SLACK = 3
SWITCH_TIMES = (0.0, 3600.0, 7200.0, 9000.0)


def pulse_winds(U=12.0, t_on=0.0, t_off=2 * 3600.0):
    """tests/test_growing_decaying_winds.py's pulse in torch."""
    def u(x, y, t):
        t = torch.as_tensor(t)
        return torch.where((t >= t_on) & (t < t_off), U, 0.0) + 0.0 * x

    return pt.Winds2D(u=u, v=lambda x, y, t: torch.zeros_like(x))


def returning_u(x, y, t):
    """tests/test_growing_decaying_winds.py's returning wind: calm until
    1 h, then 12 m/s."""
    return torch.where(torch.as_tensor(t) >= 3600.0, 12.0, 0.0) + 0.0 * x


def calm(x, y, t):
    return torch.zeros_like(x)


def jet(x, y, t):
    """Example 02's zonal jet (steady: the model gives it the node kind;
    the tracer takes it all the same)."""
    return 12.0 * torch.exp(-(((y - 40.0) / 20.0) ** 2))


_COSINE = pt.time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)

CALLABLES = {
    "pulse": tuple(pulse_winds()[:2]),
    "returning": (returning_u, calm),
    "time_cosine stripped": (_COSINE.u, _COSINE.v),
    "example 02 jet": (jet, calm),
    "moving blob": (lambda x, y, t: slopped_blob(x, t, 10.0, 5.0, 86400.0,
                                                 1e5, 3e4),
                    lambda x, y, t: 0.1 * y * torch.cos(t / 3600.0)),
}


def _every_op():
    """``chip_smoke.every_op_winds``'s samplers (the repo root's module)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.every_op_u, chip_smoke.every_op_v


CALLABLES["every op"] = _every_op()


def _bits(a):
    return a.contiguous().view(torch.int32)


def _points(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1e5, 6e5, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-80.0, 80.0, n).astype(np.float32))
    t = rng.uniform(0.0, 2e4, n).astype(np.float32)
    # each switch time and its float32 neighbours
    sw = np.array(SWITCH_TIMES, np.float32)
    near = np.concatenate([sw, np.nextafter(sw, np.float32(-1e9)),
                           np.nextafter(sw, np.float32(1e9))])
    t[:near.size] = near
    return x, y, torch.as_tensor(t)


@pytest.mark.parametrize("name", list(CALLABLES))
def test_evaluator_equals_the_callable_bitwise(name):
    u, v = CALLABLES[name]
    tr = wt.trace_winds(u, v)
    x, y, t = _points()
    for tt in (t, *(torch.tensor(s) for s in SWITCH_TIMES)):
        got = tr.evaluate(x, y, tt)
        for g, f in zip(got, (u, v)):
            want = torch.broadcast_to(torch.as_tensor(f(x, y, tt)), g.shape)
            assert g.dtype == torch.float32
            assert torch.equal(_bits(g), _bits(want)), name
    pw = tr.winds()
    assert torch.equal(_bits(pw.u(x, y, t)), _bits(u(x, y, t)))


_TAB = torch.arange(24.0)

REFUSED = {
    "float(t)": (lambda x, y, t: torch.full_like(x, 10.0 + float(t)),
                 "_local_scalar_dense"),
    "t.item()": (lambda x, y, t: torch.full_like(x, 10.0 * t.item()),
                 "_local_scalar_dense"),
    "if t > 3600": (lambda x, y, t: torch.full_like(x, 12.0) if t > 3600.0
                    else torch.zeros_like(x), "_local_scalar_dense"),
    # an hourly table indexed by the hour: a record in disguise
    "indexed captured tensor": (
        lambda x, y, t: 0.0 * x + _TAB[torch.clamp(
            (t / 3600.0).to(torch.int64), 0, 23)], "_local_scalar_dense"),
    "vector-indexed captured tensor": (
        lambda x, y, t: _TAB[torch.clamp(
            (x * 0.0 + t / 3600.0).to(torch.int64), 0, 23)], "int64"),
    "sliced captured tensor": (lambda x, y, t: 0.0 * x + _TAB[:4] * t,
                               "get_attr"),
    ".sum()": (lambda x, y, t: 0.0 * x + (x * t).sum(), "aten.sum"),
    "float64": (lambda x, y, t: (x.double() * t).float(), "float64"),
    # ATen fills NaN where the emitted fmaxf would pass the value
    "clamp with a NaN bound": (
        lambda x, y, t: torch.clamp(x * t, min=float("nan"), max=1.0),
        "NaN bound"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_tracer_refuses_what_the_kernels_cannot_compile(name):
    u, what = REFUSED[name]
    with pytest.raises(NotImplementedError) as e:
        wt.trace_winds(u, calm)
    msg = str(e.value)
    assert "aten op" in msg and what in msg, msg
    assert 'advance_mode="torch"' in msg, msg


def test_emitted_text_is_deterministic_and_keyed_by_constants():
    a = wt.trace_winds(*CALLABLES["pulse"])
    b = wt.trace_winds(*tuple(pulse_winds()[:2]))
    assert a.source == b.source and a.digest == b.digest
    assert "__device__ __forceinline__ void traced_wind" in a.source
    c = wt.trace_winds(*tuple(pulse_winds(U=10.0)[:2]))
    d = wt.trace_winds(*tuple(pulse_winds(t_off=7800.0)[:2]))
    assert len({a.digest, c.digest, d.digest}) == 3
    # a division by a Python number is a product with its float32
    # reciprocal, pow(x, 2) a product
    jt = wt.trace_winds(jet, calm).source
    assert "/ 0x" not in jt and "powf" not in jt and "expf(" in jt
    inv = float(np.float32(1.0) / np.float32(20.0))
    assert f"* {float.hex(inv)}f" in jt


# bound of the host build against PyTorch's CPU kernels where they differ,
# in float32 ulps of the wind's scale (its largest |value|): the reciprocal
# product against a true division (one rounding more) and glibc's
# expf/cosf against PyTorch's (an ulp of their argument or value); the
# moving blob chains two of each through squares and products, and parts
# by 4 ulps of its scale
HOST_ULPS = 8


def _host_probe(tmp_path, source: str):
    """The emitted function built for the host (``__device__`` defined
    away), one call a point through ctypes."""
    (tmp_path / "traced_wind.cuh").write_text(source)
    (tmp_path / "probe.cpp").write_text(
        '#include "traced_wind.cuh"\n'
        'extern "C" void probe(const float* x, const float* y, '
        'const float* t, float* u, float* v, long n) {\n'
        '  for (long i = 0; i < n; ++i)\n'
        '    picles::traced_wind(x[i], y[i], t[i], u[i], v[i]);\n}\n')
    lib = tmp_path / "probe.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-D__device__=", "-D__forceinline__=inline", "-shared",
                    "-fPIC", "-o", str(lib), str(tmp_path / "probe.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib)).probe


@pytest.mark.parametrize("name", list(CALLABLES))
def test_emitted_function_built_for_the_host(tmp_path, name):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    u, v = CALLABLES[name]
    tr = wt.trace_winds(u, v)
    probe = _host_probe(tmp_path, tr.source)
    x, y, t = _points()
    n = x.numel()
    uo, vo = torch.empty(n), torch.empty(n)
    vp = ctypes.c_void_p
    probe(vp(x.data_ptr()), vp(y.data_ptr()), vp(t.data_ptr()),
          vp(uo.data_ptr()), vp(vo.data_ptr()), ctypes.c_long(n))
    for got, f in ((uo, u), (vo, v)):
        want = torch.broadcast_to(f(x, y, t), got.shape)
        exact = all(op.name not in ("div", "exp", "log", "cos", "sin",
                                    "tanh") and
                    not (op.name == "pow" and op.param[0] not in (0, 1, 2, 3))
                    for op in tr.ops)
        if exact:
            assert torch.equal(got, want), name
        else:
            # NaN where the callable gives NaN (glibc's and PyTorch's NaN
            # may differ in sign), the rest within the bound
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan) and not nan.all(), name
            scale = float(want[~nan].abs().max())
            err = float((got - want)[~nan].abs().max())
            assert err <= HOST_ULPS * np.finfo(np.float32).eps * scale, \
                f"{name}: {err:.3e} of a scale {scale:.3e}"


def _cuda_modes(monkeypatch):
    monkeypatch.setattr(twg, "resolve_modes", lambda cfg, device:
                        dataclasses.replace(cfg, advance_mode="cuda",
                                            scatter_mode="dense_cuda"))


def _grid():
    return pt.cartesian_box(100e3, 9, 100e3, 9,
                            periodic_boundary=(True, True), device="cpu")


def test_model_gives_each_wind_its_kind(monkeypatch):
    """Modes resolved to the kernels: the pulse and the returning wind are
    traced, a steady callable is the node kind, the descriptors keep their
    kinds, and a callable the tracer cannot lower raises."""
    _cuda_modes(monkeypatch)
    cfg = pt.WaveGrowth2DConfig(periodic_boundary=True)
    kinds = {
        "pulse": (pulse_winds(), pt.WindKind.TRACED),
        "returning": (pt.Winds2D(u=returning_u, v=calm), pt.WindKind.TRACED),
        "cosine stripped": (pt.Winds2D(u=_COSINE.u, v=_COSINE.v),
                            pt.WindKind.TRACED),
        "steady": (pt.Winds2D(u=jet, v=calm), pt.WindKind.NODE),
        "constant": (pt.constant_winds(3.0, 4.0), pt.WindKind.CONSTANT),
        "cosine": (_COSINE, pt.WindKind.TIME_COSINE),
    }
    for name, (w, kind) in kinds.items():
        m = pt.WaveGrowth2D(_grid(), w, pt.ODESettings(), config=cfg)
        assert m.winds.kernel.kind == kind, name
        assert m.remesh_params.winds.kernel.kind == kind, name
        assert m.wind_fields(m.grid, torch.zeros(())) == () or \
            kind == pt.WindKind.NODE
    traced = pt.WaveGrowth2D(_grid(), pulse_winds(), pt.ODESettings(),
                             config=cfg).winds.kernel
    again = pt.WaveGrowth2D(_grid(), pulse_winds(), pt.ODESettings(),
                            config=cfg).winds.kernel
    assert traced.traced.digest == again.traced.digest
    with pytest.raises(NotImplementedError, match="_local_scalar_dense"):
        pt.WaveGrowth2D(_grid(), pt.Winds2D(
            u=REFUSED["float(t)"][0], v=calm), pt.ODESettings(), config=cfg)


def test_wrappers_refuse_cpu_tensors_and_planes_for_a_traced_wind():
    """The kernel wrappers take the traced kind on a card only, with the
    node y as its one plane and no `_simple` baseline."""
    from picles_torch.ops.advance_cuda import n_wind_fields, wind_planes

    w = tw.traced_kernel(pulse_winds())
    assert w.kind == pt.WindKind.TRACED and n_wind_fields(w) == 1
    g = _grid()
    with pytest.raises(ValueError, match="not a CUDA device"):
        wind_planes(w, (), g.x, yn=g.y)
    with pytest.raises(ValueError, match="no wind planes"):
        wind_planes(w, (g.y,), g.x, yn=g.y)
    with pytest.raises(ValueError, match="_simple"):
        wind_planes(w, (), g.x, simple=True, yn=g.y)


# -- the growing/decaying-wind configurations against JAX's Pallas step -------

def _settings(DT=DT):
    ws = jfr.MinimalWindsea(12.0, 0.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True, abstol=1e-7, reltol=1e-6)


def _pair(n, j_winds, t_winds, remesh, grids=None, DT=DT, halo=None):
    """JAX's model with its Pallas kernels in interpret mode, and the port's
    plain step over the traced wind's plain version: on n x n periodic
    boxes, or on ``grids`` (JAX's and the port's)."""
    jg, tg = grids or (
        j_box(100e3, n, 100e3, n, periodic_boundary=(True, True)),
        pt.cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True),
                         device="cpu"))
    extra = {} if halo is None else dict(halo=halo)
    jm = JModel(jg, j_winds, _settings(DT),
                config=JConfig(periodic_boundary=True, advance_mode="pallas",
                               scatter_mode="dense_pallas",
                               dt_reset_mode="carry", remesh_mode=remesh,
                               pallas_interpret=True, **extra))
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    traced = tw.traced_kernel(t_winds).traced
    tm = pt.WaveGrowth2D(tg, traced.winds(), sett, ode_params=params,
                         constants=cid, config=pt.WaveGrowth2DConfig(
                             periodic_boundary=True, dt_reset_mode="carry",
                             remesh_mode=remesh, **extra))
    assert tm.resolved_config().advance_mode == "torch"
    return jm, tm


def _step_both(jm, tm, steps, peak_step=0):
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = tm.init_state()
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-6, atol=1e-12)
    tms = state_of(jms)
    sums = {c: 0 for c in COUNTERS}
    peak = None
    for k in range(steps):
        jms, tms = jstep(jms), tm.step(tms)
        S, J = tms.state.numpy(), np.asarray(jms.state)
        assert np.isfinite(S).all(), f"step {k}"
        err = float(np.abs(S - J).max() / max(np.abs(J).max(), 1e-30))
        assert err <= GAP, f"step {k}: {err:.3e} of the state's scale"
        got = tms.metrics.as_dict()
        for c in COUNTERS:
            slack = SMAX_SLACK if c == "substeps_max" else 0
            assert abs(int(got[c]) - int(getattr(jms.metrics, c))) <= slack, \
                f"{c} at step {k}: {got[c]} vs {getattr(jms.metrics, c)}"
            sums[c] += int(got[c])
        for c in GUARDS:
            assert int(got[c]) == 0, f"{c} fired at step {k}"
        assert np.array_equal(tms.particles.on.numpy(),
                              np.asarray(jms.particles.on)), f"on at step {k}"
        if k == peak_step:
            peak = float(tms.state[..., 0].mean())
    return tms, sums, peak, jms


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_pulse_matches_jax_pallas_kernels(remesh):
    """The pulse, 2 h of wind then 2 h of calm: 24 steps; the waves
    dissipate once the wind stops (no node switches off in 2 h)."""
    jm, tm = _pair(17, tgd._pulse_winds(), pulse_winds(), remesh)
    tms, sums, peak, _ = _step_both(jm, tm, 24, peak_step=11)
    assert sums["n_gather"] > 0
    assert float(tms.state[..., 0].mean()) < peak


def test_returning_wind_matches_jax_pallas_kernels():
    """Calm seeding, the wind on from 1 h: the remesh reseeds the calm
    nodes from the returning wind at the clock, 12 steps."""
    def ju(x, y, t):
        return jnp.where(jnp.asarray(t) >= 3600.0, 12.0, 0.0) + \
            0.0 * jnp.asarray(x)

    jwinds = jw.Winds2D(u=ju, v=lambda x, y, t: jnp.zeros_like(
        jnp.asarray(x)))
    jm, tm = _pair(13, jwinds, pt.Winds2D(u=returning_u, v=calm), "pallas")
    assert not bool(tm.init_state().particles.on.any())
    tms, sums, _, _ = _step_both(jm, tm, 12)
    assert sums["n_reseed"] > 0 and bool(tms.particles.on.any())


def test_pulse_on_a_tripolar_grid_matches_jax_pallas_kernels():
    """The pulse on the synthetic tripolar grid (32 x 16: per-node
    projection planes, the pole masks, the seam fold in the deposit), DT
    1200 s, halo 3, the fused remesh: 8 steps through the wind's stop at
    7200 s, each within 1e-4 of JAX's state scale, ``on`` and the counters
    equal but the most substeps a lane took (``SMAX_SLACK``), no guard
    fired, and land stays off."""
    grids = (jtri.synthetic_tripolar_grid(k=2, nx_super=64, ny_super=32),
             pt.synthetic_tripolar_grid(k=2, nx_super=64, ny_super=32,
                                        device="cpu"))
    jm, tm = _pair(0, tgd._pulse_winds(), pulse_winds(), "fused",
                   grids=grids, DT=1200.0, halo=3)
    assert tm.uniform_proj is None
    tms, sums, _, _ = _step_both(jm, tm, 8)
    land = grids[1].mask.numpy() == 0
    assert sums["n_gather"] > 0 and not tms.particles.on.numpy()[land].any()



def _cell_reach(active, cells):
    """The nodes within ``cells`` cells (8-neighbourhood, x periodic, the
    top row's seam mirror above it) of the ``active`` nodes."""
    nx, ny = active.shape
    reach = active
    for _ in range(cells):
        ext = np.concatenate([reach, reach[(nx - 2 - np.arange(nx)) % nx,
                                           -1:]], axis=1)
        grown = np.zeros_like(ext)
        for dx in (-1, 0, 1):
            sh = np.roll(ext, dx, axis=0)
            grown |= sh
            grown[:, 1:] |= sh[:, :-1]
            grown[:, :-1] |= sh[:, 1:]
        reach = grown[:, :ny]
    return reach


@pytest.mark.parametrize("DT", [1200.0, 3600.0])
def test_pulse_crossing_polar_cells_matches_jax_on_land(DT):
    """Energy on land beyond one cell of the ocean is a CFL property that
    JAX's step shares.  The synthetic tripolar grid at 128 x 16 (its top
    row's cells 5.5 km wide) with a land patch four rows deep under the
    seam (columns 40-86, mirror-symmetric), the pulse, halo 3, the fused
    remesh, 4 steps: at DT 1200 s the swell crosses under a cell a step and
    no land node beyond one cell of an active node holds energy; at DT 3600
    s it crosses about two of the top row's cells, and JAX's
    interpret-mode Pallas step and the port's both put energy on the same
    land nodes beyond one cell, all within the halo's reach of the nodes
    whose cells a step crosses, the states within 1e-4 of JAX's scale."""
    nx, ny = 128, 16
    m = np.ones((nx, ny), dtype=np.int32)
    m[40:87, ny - 4:] = 0
    grids = (jtri.mom6_grid_from_supergrid(
                 *jtri.synthetic_tripolar_supergrid(2 * nx, 2 * ny), 2,
                 mask=m),
             pt.mom6_grid_from_supergrid(
                 *ttri.synthetic_tripolar_supergrid(2 * nx, 2 * ny), 2,
                 device="cpu", mask=m))
    jm, tm = _pair(0, tgd._pulse_winds(), pulse_winds(), "fused",
                   grids=grids, DT=DT, halo=3)
    tms, _, _, jms = _step_both(jm, tm, 4)
    g = grids[1]
    land = g.mask.numpy() == 0
    active = tm.active_mask.numpy()
    P = tms.particles
    v = float(torch.hypot(P.cgx, P.cgy)[P.on & tm.active_mask].max())
    crossing = active & (np.minimum(g.dx_m.numpy(), g.dy_m.numpy()) < v * DT)
    beyond = land & ~_cell_reach(active, 1)
    far_t = beyond & (tms.state.numpy()[..., 0] != 0)
    far_j = beyond & (np.asarray(jms.state)[..., 0] != 0)
    assert np.array_equal(far_t, far_j)
    assert not tms.particles.on.numpy()[land].any()
    if DT == 1200.0:
        assert not crossing.any() and not far_t.any()
    else:
        assert crossing.any() and far_t.any()
        assert not (far_t & ~_cell_reach(crossing, 3)).any()

# -- the sharded step ---------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_one_rank_pulse_equals_single_device():
    """The pulse on a (1, 1) gloo mesh in this process: 14 sharded steps
    equal 14 single-device steps bit for bit through the wind's stop."""
    tsh.init_distributed(0, 1, "gloo", _free_port(), timeout_s=60.0)
    try:
        sett = convert.settings_from_values(_settings())[0]
        m = pt.WaveGrowth2D(
            pt.cartesian_box(100e3, 12, 100e3, 12,
                             periodic_boundary=(True, True), device="cpu"),
            pulse_winds(), sett,
            config=pt.WaveGrowth2DConfig(periodic_boundary=True,
                                         dt_reset_mode="carry",
                                         remesh_mode="pallas"))
        sh = pt.ShardedWaveGrowth2D(m, tsh.make_mesh((1, 1)))
        ms, single = sh.init_state(), m.init_state()
        for _ in range(14):
            ms, single = sh.step(ms), m.step(single)
        for a, b in zip(ms.leaves(), single.leaves()):
            assert torch.equal(a, b)
        assert int(ms.metrics.n_gather) > 0 and int(ms.metrics.n_failed) == 0
    finally:
        dist.destroy_process_group()
