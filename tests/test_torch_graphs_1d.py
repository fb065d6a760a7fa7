"""The 1D model's graphed path (kernel K7 and the capture of its step) on
the CPU.

On the card the 1D model's advance is kernel K7 (``advance_cuda.advance_1d``)
and its drivers replay a CUDA graph of the step, where the wind is one K7
reads: a steady callable's node plane, or a ``GriddedWinds1D`` record.
Here, where no kernel runs, the tests hold what the card's path rests on:

- the winds K7 reads equal ``picles_tpu``'s bit for bit: the node plane of
  ``constant_winds_1d`` and of a steady closure is JAX's ``u(x_node, t)``,
  and the model keeps the record it is given, its samples JAX's;
- the rule (``resolve_advance_1d``) for a CUDA device, computed without one:
  K7 for float32 and a node, gridded or traced wind (a callable that reads
  its time is traced); float64 raises there unless the caller asks for
  ``advance_mode="torch"`` (then the plain loop); the plain loop on the
  CPU;
- no transfer between host and device in the step outside the advance
  (``HostTraffic``, tests/test_torch_graphs.py), with the advance swapped
  for its precomputed result, nor in the sign-merge deposit;
- on the CPU ``graphed`` is false and the drivers loop.

The step and the drivers against JAX's are in
tests/test_torch_drivers_1d.py.  K7 against its plain version, and the
graphed 1D step against the eager one, run on the card (tests/test_torch_cuda.py, marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.forcing import winds as jwinds

import picles_torch as pt
from picles_torch import convert
from picles_torch.forcing.winds import (WindKind, steady_node_plane_1d,
                                        traced_kernel_1d)
from picles_torch.models.wave_growth_1d import resolve_advance_1d
from picles_torch.ops import pic as tpic
from test_torch_graphs import HostTraffic
from test_torch_model_1d import _model

torch.set_num_threads(1)

XS = 100e3


def _steady(x, t):
    """A steady closure of the port: opposing winds over a smooth profile."""
    return torch.where(x < XS, 7.0 + 3.0 * torch.sin(x / 80e3),
                       -9.0).to(torch.float32)


def _jsteady(x, t):
    x = jnp.asarray(x)
    return jnp.where(x < XS, 7.0 + 3.0 * jnp.sin(x / 80e3),
                     -9.0).astype(jnp.float32)


def _record():
    """A 1D record over 500 km and 3 h that varies in x and t."""
    rng = np.random.default_rng(21)
    u = rng.uniform(6.0, 12.0, (23, 7)).astype(np.float32)
    return dict(u_data=u, x0=-10e3, dx=25e3, t0=0.0, dt=1800.0)


def _plane_winds(plane):
    """The plain version of the node kind: the node plane whatever the
    time (sampled at the nodes the plane belongs to)."""
    return pt.Winds1D(u=lambda x, t: plane)


@pytest.mark.parametrize("kind", ["constant", "closure"])
def test_node_plane_equals_jax_winds_bitwise(kind):
    grid = pt.one_d_grid(0.0, 500e3, 31, periodic=False, device="cpu")
    tw, jw = ((pt.constant_winds_1d(10.0), jwinds.constant_winds_1d(10.0))
              if kind == "constant" else
              (pt.Winds1D(u=_steady), jwinds.Winds1D(u=_jsteady)))
    plane = steady_node_plane_1d(tw, grid.x)
    assert plane.dtype == torch.float32 and plane.is_contiguous()
    assert tuple(plane.shape) == (31,)
    xj = jnp.asarray(grid.x.numpy())
    for t in (0.0, 600.0, 86400.0):
        want = np.broadcast_to(np.asarray(jw.u(xj, jnp.float32(t)),
                                          dtype=np.float32), (31,))
        np.testing.assert_array_equal(plane.numpy().view(np.int32),
                                      want.view(np.int32))


def test_model_keeps_the_record_and_its_samples_equal_jax():
    r = _record()
    jg = jwinds.GriddedWinds1D(u_data=jnp.asarray(r["u_data"]),
                               **{k: v for k, v in r.items() if k != "u_data"})
    tg = convert.gridded1d_from_jax(jg, device="cpu")
    for given in (tg, tg.as_winds()):
        m = _model(winds=given)
        assert m.gridded_winds is not None
        kept = m.gridded_winds
        assert (kept.x0, kept.dx, kept.t0, kept.dt, kept.mode, kept.mode_t) \
            == (jg.x0, jg.dx, jg.t0, jg.dt, jg.mode, jg.mode_t)
        np.testing.assert_array_equal(kept.u_data.numpy().view(np.int32),
                                      np.asarray(jg.u_data).view(np.int32))
        assert m.advance_mode == "torch" and not m.graphed


def test_resolution_rule_for_a_card():
    """The rule for a CUDA device, from the probe's result on the CPU: K7
    where it runs, a callable that reads its time as the traced kind (the
    model traces it: ``traced_kernel_1d``), in float32 and in float64 (K7's
    double instances); another dtype raises and names the way out, which
    then resolves to the plain advance; the CPU's advance is the plain
    one."""
    x = torch.linspace(0.0, 500e3, 31)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    f32, f64 = torch.float32, torch.float64

    def kind(w):
        if steady_node_plane_1d(w, x) is not None:
            return WindKind.NODE
        return traced_kernel_1d(w).kind

    moving = pt.Winds1D(u=lambda x, t: 10.0 + 0.0 * torch.as_tensor(t) * x)
    blob = pt.Winds1D(u=lambda x, t: pt.forcing.winds.slopped_blob(
        x, t, 15.0, 10.0, 6 * 3600.0, 80e3, 7200.0))
    assert kind(pt.constant_winds_1d(10.0)) == WindKind.NODE
    assert kind(pt.Winds1D(u=_steady)) == WindKind.NODE
    assert kind(moving) == WindKind.TRACED and kind(blob) == WindKind.TRACED
    for mode in ("auto", "cuda"):
        for wk in (WindKind.NODE, WindKind.GRIDDED, kind(moving)):
            assert resolve_advance_1d(cuda, f32, wk, mode) == "cuda"
        for wk in (WindKind.NODE, WindKind.GRIDDED, WindKind.TRACED):
            assert resolve_advance_1d(cuda, f64, wk, mode) == "cuda"
            with pytest.raises(ValueError, match='advance_mode="torch"'):
                resolve_advance_1d(cuda, torch.float16, wk, mode)
        with pytest.raises(ValueError, match="node, gridded or traced"):
            resolve_advance_1d(cuda, f64, None, mode)
    for dtype, wk in ((f32, kind(moving)), (f64, WindKind.NODE),
                      (f64, WindKind.GRIDDED), (f32, WindKind.NODE),
                      (f64, WindKind.TRACED)):
        assert resolve_advance_1d(cuda, dtype, wk, "torch") == "torch"
        assert resolve_advance_1d(cpu, dtype, wk) == "torch"
        assert resolve_advance_1d(cpu, dtype, wk, "torch") == "torch"
    with pytest.raises(ValueError, match="names kernel K7"):
        resolve_advance_1d(cpu, f32, WindKind.NODE, "cuda")
    with pytest.raises(ValueError, match="advance_mode must be one of"):
        resolve_advance_1d(cuda, f32, WindKind.NODE, "pallas")
    assert resolve_advance_1d("cuda", f32, WindKind.NODE) == "cuda"


def test_cpu_model_takes_the_advance_mode_keyword():
    """On the CPU "auto" and "torch" run the plain advance, bit for bit one
    another; "cuda" raises, as the 2D model's kernel modes do there."""
    def model(**kw):
        m = _model()
        return pt.WaveGrowth1D(m.grid, m.winds, m.settings, config=m.config,
                               **kw)

    a, b = model(advance_mode="torch"), model()
    assert (a.advance_mode, b.advance_mode) == ("torch", "torch")
    assert not a.graphed and not b.graphed
    sa, sb = a.step_n_quiet(a.init_state(), 2), b.step_n_quiet(
        b.init_state(), 2)
    for u, v in zip(sa.leaves(), sb.leaves()):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="names kernel K7"):
        model(advance_mode="cuda")


@pytest.mark.parametrize("wind", ["constant", "closure", "record"])
@pytest.mark.parametrize("periodic", [False, True],
                         ids=["open", "periodic"])
def test_step_outside_the_advance_makes_no_host_transfer(wind, periodic):
    """Two steps (the first from the seed), the advance of the second
    swapped for its own result computed beforehand: no transfer between
    host and device in the guards, the deposit, the remesh, the plain
    Hairer reset and the counters."""
    if wind == "record":
        r = _record()
        winds = pt.GriddedWinds1D(u_data=torch.as_tensor(r.pop("u_data")),
                                  **r)
    else:
        winds = (pt.constant_winds_1d(10.0) if wind == "constant"
                 else pt.Winds1D(u=_steady))
    m = _model(winds=winds, periodic=periodic, nx=21)
    ms = m.step(m.init_state())
    adv = ms.particles.on & ~m.boundary_mask
    P = ms.particles
    res = m.advance(P.z, P.t, P.dt, adv, m._DT)
    m.advance = lambda *args: res
    with HostTraffic() as seen:
        out = m.step(ms)
    assert seen.seen == [], seen.seen
    assert int(out.iteration) == 2 and int(out.metrics.n_failed) == 0
    assert int(out.metrics.n_active) == int(adv.sum()) > 0


@pytest.mark.parametrize("periodic", [True, False])
def test_sign_merge_deposit_makes_no_host_transfer(periodic):
    rng = np.random.default_rng(7)
    n, nx, dx = 300, 40, 1000.0
    x = torch.as_tensor(rng.uniform(-5e3, 45e3, n).astype(np.float32))
    ch = torch.as_tensor(np.stack([
        rng.uniform(0.1, 1.0, n), rng.uniform(-0.1, 0.1, n), np.zeros(n)],
        -1).astype(np.float32))
    act = torch.as_tensor(rng.random(n) < 0.9)
    keys = torch.as_tensor(rng.integers(0, nx, n))
    with HostTraffic() as seen:
        S = tpic.scatter_1d_merge(x, ch, act, 0.0, dx, nx, periodic)
        T = tpic.segment_sum(keys, ch, nx)
    assert seen.seen == [], seen.seen
    assert tuple(S.shape) == (nx, 3) and tuple(T.shape) == (nx, 3)


def test_capture_rule_is_off_on_the_cpu():
    m = _model()
    assert m.advance_mode == "torch" and m.graphed is False
    with pytest.raises(AttributeError):
        m.graphed = True
    with pytest.raises(AttributeError):
        m.advance_mode = "cuda"
    ms = m.init_state()
    a = m.step_n_quiet(ms, 2)
    assert m._graph is None
    b = m.step(m.step(ms))
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
