"""1D wind callables that read their time: the traced kind of K7 (CPU).

- The 1D tracer (``forcing/wind_trace.py`` ``trace_winds_1d``, the lowering
  and emitter of the 2D tracer) takes the moving Gaussian storm
  ``slopped_blob`` (the Julia source's ``WindEmulator.jl:50-52``), the 1D
  pulse (12 m/s until 7200 s, then calm: the 1D form of
  ``tests/test_growing_decaying_winds.py:16-26``) and the returning wind
  (calm until 1 h, then 12 m/s); its plain evaluator equals each callable
  bit for bit on 4096 seeded points and at the switch times.
- It refuses what K7 cannot compile (a value read on the host: ``float(t)``,
  ``t.item()``, a Python branch on ``t``; float64; an indexed captured
  tensor), naming the operation and ``advance_mode="torch"``.
- The emitted ``traced_wind_1d(x, t)`` is deterministic and keyed by its
  constants, hex floats throughout; built for the host with ``g++`` it
  equals the callable bit for bit where only comparisons, selects, sums and
  products enter, and within a stated bound where glibc's ``expf`` differs
  from PyTorch's.
- The rule: the traced kind resolves to K7 on a card and to the plain loop
  on the CPU; the wrapper refuses CPU tensors for it, a 2D traced
  descriptor, and each traced library the other's source.
- The 1D step under ``slopped_blob``: JAX's ``WaveGrowth1D`` against the
  port's on the CPU (the port over the traced wind's plain version), from
  the same numpy-seeded state, 10 steps on 48 nodes, open and periodic, at
  abstol 1e-7 / reltol 1e-6: within 1e-4 of the state's scale, ``on`` and
  the counters equal, ``substeps_max`` within 2 (the 1D model's tolerance,
  tests/test_torch_model_1d.py).
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.forcing import winds as jwinds

import picles_torch as pt
from picles_torch import convert
from picles_torch.forcing import wind_trace as wt
from picles_torch.forcing.winds import (WindKind, slopped_blob,
                                        traced_kernel, traced_kernel_1d)
from picles_torch.models.wave_growth_1d import resolve_advance_1d
from picles_torch.ops import cuda_build
from picles_torch.ops.advance_cuda import advance_1d
from picles_torch.ops.rhs import TermFlags, make_rhs_consts
from picles_torch.ops.tsit5 import SolverConfig
from test_torch_model_1d import COUNTERS, TIGHT, _jmetrics, _jmodel, _model

torch.set_num_threads(1)

DT = 600.0
GAP = 1e-4
SWITCH_TIMES = (0.0, 3600.0, 7200.0)
# the storm of the step tests: 15 m/s at its peak (t = T / 2 = 1 h),
# passing at 15 m/s from 100 km, 80 km wide, over 1 h either side
BLOB = dict(U10=15.0, V=15.0, T=2 * 3600.0, x_scale=80e3, t_scale=3600.0,
            x0=100e3)


def blob(x, t):
    return slopped_blob(x, t, **BLOB)


def jblob(x, t):
    return jwinds.slopped_blob(x, t, **BLOB)


def pulse_1d(x, t, U=12.0, t_on=0.0, t_off=2 * 3600.0):
    """tests/test_growing_decaying_winds.py's pulse in 1D."""
    t = torch.as_tensor(t)
    return torch.where((t >= t_on) & (t < t_off), U, 0.0) + 0.0 * x


def returning_1d(x, t):
    return torch.where(torch.as_tensor(t) >= 3600.0, 12.0, 0.0) + 0.0 * x


CALLABLES = {
    "slopped_blob": blob,
    "slopped_blob, the demo's storm": lambda x, t: slopped_blob(
        x, t, 15.0, 10.0, 6 * 3600.0, 80e3, 7200.0),
    "pulse": pulse_1d,
    "returning": returning_1d,
}


def _bits(a):
    return a.contiguous().view(torch.int32)


def _points(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1e5, 6e5, n).astype(np.float32))
    t = rng.uniform(0.0, 2e4, n).astype(np.float32)
    sw = np.array(SWITCH_TIMES, np.float32)
    near = np.concatenate([sw, np.nextafter(sw, np.float32(-1e9)),
                           np.nextafter(sw, np.float32(1e9))])
    t[:near.size] = near
    return x, torch.as_tensor(t)


@pytest.mark.parametrize("name", list(CALLABLES))
def test_evaluator_equals_the_callable_bitwise(name):
    u = CALLABLES[name]
    tr = wt.trace_winds_1d(u)
    assert tr.one_d and len(tr.outputs) == 1
    x, t = _points()
    for tt in (t, *(torch.tensor(s) for s in SWITCH_TIMES)):
        got, = tr.evaluate(x, tt)
        want = torch.broadcast_to(torch.as_tensor(u(x, tt)), got.shape)
        assert got.dtype == torch.float32
        assert torch.equal(_bits(got), _bits(want)), name
    w = tr.winds()
    assert isinstance(w, pt.Winds1D)
    assert torch.equal(_bits(w.u(x, t)), _bits(u(x, t)))


_TAB = torch.arange(24.0)

REFUSED = {
    "float(t)": (lambda x, t: torch.full_like(x, 10.0 + float(t)),
                 "_local_scalar_dense"),
    "t.item()": (lambda x, t: torch.full_like(x, 10.0 * t.item()),
                 "_local_scalar_dense"),
    "if t > 3600": (lambda x, t: torch.full_like(x, 12.0) if t > 3600.0
                    else torch.zeros_like(x), "_local_scalar_dense"),
    "float64": (lambda x, t: (x.double() * t).float(), "float64"),
    # an hourly table indexed by the hour: a record in disguise
    "indexed captured tensor": (
        lambda x, t: 0.0 * x + _TAB[torch.clamp(
            (t / 3600.0).to(torch.int64), 0, 23)], "_local_scalar_dense"),
    "vector-indexed captured tensor": (
        lambda x, t: _TAB[torch.clamp(
            (x * 0.0 + t / 3600.0).to(torch.int64), 0, 23)], "int64"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_tracer_refuses_what_k7_cannot_compile(name):
    u, what = REFUSED[name]
    with pytest.raises(NotImplementedError) as e:
        wt.trace_winds_1d(u)
    msg = str(e.value)
    assert "aten op" in msg and what in msg, msg
    assert 'advance_mode="torch"' in msg and "u(x, t)" in msg, msg
    with pytest.raises(NotImplementedError, match=what):
        traced_kernel_1d(pt.Winds1D(u=u))


def test_emitted_text_is_deterministic_and_keyed_by_constants():
    a = wt.trace_winds_1d(blob)
    b = wt.trace_winds_1d(lambda x, t: slopped_blob(x, t, **BLOB))
    assert a.source == b.source and a.digest == b.digest
    assert "__device__ __forceinline__ float traced_wind_1d(float x, " \
           "float t)" in a.source
    assert "void traced_wind(" not in a.source
    c = wt.trace_winds_1d(lambda x, t: slopped_blob(
        x, t, **dict(BLOB, U10=12.0)))
    d = wt.trace_winds_1d(lambda x, t: pulse_1d(x, t, t_off=7800.0))
    e = wt.trace_winds_1d(pulse_1d)
    assert len({a.digest, c.digest, d.digest, e.digest}) == 4
    # literals are exact hex floats; the storm's divisions by a 0-dim
    # tensor (winds.py `_div`) stay divisions, its Python-scalar products
    # products
    for lit in re.findall(r"0x[0-9a-f.]+p[+-]\d+f", a.source):
        assert np.isfinite(float.fromhex(lit[:-1]))
    assert " / 0x" in a.source and "expf(" in a.source
    # the 2D tracer's text of the same storm names the 2D function, so the
    # two libraries never share a build directory
    two_d = wt.trace_winds(lambda x, y, t: blob(x, t),
                           lambda x, y, t: torch.zeros_like(x))
    assert cuda_build.source_hash(a) != cuda_build.source_hash(two_d)
    assert cuda_build._library_parts(a) == (
        cuda_build.TRACED_1D_SOURCES, cuda_build.TRACED_1D_FLAGS,
        cuda_build.TRACED_1D_LIB_NAME)


# glibc's expf against PyTorch's (an ulp of each of the storm's two
# exponentials, through its product and sum), in float32 ulps of the
# wind's scale (its largest |value|)
HOST_ULPS = 8


@pytest.mark.parametrize("name", list(CALLABLES))
def test_emitted_function_built_for_the_host(tmp_path, name):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    u = CALLABLES[name]
    tr = wt.trace_winds_1d(u)
    (tmp_path / "traced_wind.cuh").write_text(tr.source)
    (tmp_path / "probe.cpp").write_text(
        '#include "traced_wind.cuh"\n'
        'extern "C" void probe(const float* x, const float* t, float* u, '
        'long n) {\n'
        '  for (long i = 0; i < n; ++i)\n'
        '    u[i] = picles::traced_wind_1d(x[i], t[i]);\n}\n')
    lib = tmp_path / "probe.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-D__device__=", "-D__forceinline__=inline", "-shared",
                    "-fPIC", "-o", str(lib), str(tmp_path / "probe.cpp")],
                   check=True, capture_output=True)
    probe = ctypes.CDLL(str(lib)).probe
    x, t = _points()
    n = x.numel()
    got = torch.empty(n)
    vp = ctypes.c_void_p
    probe(vp(x.data_ptr()), vp(t.data_ptr()), vp(got.data_ptr()),
          ctypes.c_long(n))
    want = torch.broadcast_to(u(x, t), got.shape)
    if all(op.name not in ("div", "exp") for op in tr.ops):
        assert torch.equal(got, want), name
    else:
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= HOST_ULPS * np.finfo(np.float32).eps * scale, \
            f"{name}: {err:.3e} of a scale {scale:.3e}"


def test_resolution_gives_the_traced_kind_k7_on_a_card_only():
    """The traced kind resolves to K7 on a CUDA device (auto and cuda), in
    float32 and in float64 (K7's double instances, the callable traced in
    float64), to the plain loop on the CPU and with
    ``advance_mode="torch"``; another dtype raises on a card, naming
    ``advance_mode="torch"``; on the CPU the model neither probes nor
    traces, and steps the callable itself."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    f32 = torch.float32
    kind = traced_kernel_1d(pt.Winds1D(u=blob)).kind
    assert kind == WindKind.TRACED
    assert traced_kernel_1d(pt.Winds1D(u=blob),
                            dtype=torch.float64).traced.dtype == torch.float64
    for mode in ("auto", "cuda"):
        assert resolve_advance_1d(cuda, f32, kind, mode) == "cuda"
        assert resolve_advance_1d(cuda, torch.float64, kind, mode) == "cuda"
        with pytest.raises(ValueError, match='advance_mode="torch"'):
            resolve_advance_1d(cuda, torch.float16, kind, mode)
    assert resolve_advance_1d(cuda, f32, kind, "torch") == "torch"
    assert resolve_advance_1d(cpu, f32, kind) == "torch"
    m = _model(winds=pt.Winds1D(u=blob))
    assert m.advance_mode == "torch" and not m.graphed
    assert m._traced is None and m._node_plane is None
    assert m.graph_keep() == (None, None, None, None)


def test_wrapper_refuses_cpu_tensors_and_other_descriptors():
    """K7's wrapper takes the traced kind on a card only; a 2D traced
    descriptor is refused, and each traced library refuses the other's
    source before it builds anything."""
    n = 8
    z, v = torch.zeros((n, 3)), torch.zeros(n)
    on = torch.ones(n, dtype=torch.bool)
    consts, cfg = make_rhs_consts(), SolverConfig()
    w1 = traced_kernel_1d(pt.Winds1D(u=blob))
    with pytest.raises(ValueError, match="not a CUDA device"):
        advance_1d(w1, consts, TermFlags(), cfg, DT, z, v, v, on, v)
    with pytest.raises(ValueError, match="not a CUDA device"):
        advance_1d(w1, consts, TermFlags(), cfg, DT, z, v, v, on, v,
                   simple=True)
    w2 = traced_kernel(pt.Winds2D(u=lambda x, y, t: blob(x, t),
                                  v=lambda x, y, t: torch.zeros_like(x)))
    with pytest.raises(ValueError, match="traced 1D wind"):
        advance_1d(w2, consts, TermFlags(), cfg, DT, z, v, v, on, v)
    with pytest.raises(ValueError, match="1D wind"):
        cuda_build.traced_library_1d(w2.traced)
    with pytest.raises(ValueError, match="2D wind"):
        cuda_build.traced_library(w1.traced)


# -- the 1D step under slopped_blob against JAX's ---------------------------

def _seeded_pair(periodic, seed=11, nx=48):
    """JAX's model and the port's (over the traced storm's plain version)
    and one numpy-seeded state for both: the JAX seed state with lne moved
    by N(0, 0.05) and cg_x scaled by U(0.97, 1.03) on the lanes that are
    on, and a random dt of the first substep."""
    kw = dict(nx=nx, Lx=500e3, periodic=periodic, **TIGHT)
    traced = traced_kernel_1d(pt.Winds1D(u=blob)).traced
    tm = _model(winds=traced.winds(), **kw)
    jm = _jmodel(winds=jwinds.Winds1D(u=jblob), **kw)
    js = jm.init_state()
    rng = np.random.default_rng(seed)
    on = np.asarray(js.particles.on)
    z = np.array(js.particles.z, dtype=np.float32)
    z[:, 0] += np.where(on, rng.normal(0.0, 0.05, nx), 0.0).astype(
        np.float32)
    z[:, 1] *= np.where(on, rng.uniform(0.97, 1.03, nx), 1.0).astype(
        np.float32)
    dt = rng.uniform(1e-3, 30.0, nx).astype(np.float32)
    js = dataclasses.replace(js, particles=dataclasses.replace(
        js.particles, z=jnp.asarray(z), dt=jnp.asarray(dt)))
    ts = convert.state1d_from_numpy(
        np.asarray(js.state), dict(z=z, t=np.asarray(js.particles.t), dt=dt,
                                   on=on),
        np.asarray(js.time), np.asarray(js.iteration), device="cpu")
    return tm, jm, ts, js


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["open", "periodic"])
def test_step_under_the_storm_matches_jax(periodic):
    """10 steps (the storm rises, peaks at 1 h and passes): the node state
    within 1e-4 of its scale each step, ``on`` and the counters equal,
    ``substeps_max`` within 2; the storm drives real growth (every step
    advances lanes and some re-light or reseed as it passes)."""
    tm, jm, ts, js = _seeded_pair(periodic)
    np.testing.assert_array_equal(ts.particles.z.numpy(),
                                  np.asarray(js.particles.z))
    step = jax.jit(jm.step)
    seen = {c: 0 for c in COUNTERS}
    for k in range(10):
        ts, js = tm.step(ts), step(js)
        a, b = ts.state.numpy(), np.asarray(js.state)
        assert np.isfinite(a).all(), k
        gap = float(np.abs(a - b).max() / np.abs(b).max())
        assert gap <= GAP, (k + 1, gap)
        np.testing.assert_array_equal(ts.particles.on.numpy(),
                                      np.asarray(js.particles.on))
        tmet, jmet = ts.metrics.as_dict(), _jmetrics(js)
        for c in COUNTERS:
            assert tmet[c] == jmet[c], (k + 1, c, tmet[c], jmet[c])
            seen[c] += tmet[c]
        assert abs(tmet["substeps_max"] - jmet["substeps_max"]) <= 2
        assert tmet["n_active"] > 0 and tmet["n_failed"] == 0
    assert seen["n_gather"] > 0
    assert seen["n_relight"] + seen["n_reseed"] > 0, seen
