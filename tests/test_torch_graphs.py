"""The compiled drivers (``picles_torch/models/drivers.py``) on the CPU.

The drivers replay a CUDA graph of the step on the card; a graph holds only
device work, so the step must never read the device back nor copy a host
value to it.  ``HostTraffic`` runs the step on the CPU under a
``TorchDispatchMode`` and records every such transfer: a scalar read
(``aten._local_scalar_dense``, ``aten.item``), a tensor made from host data
(``aten.lift_fresh``: on the card a copy to the device) and a copy of a
tensor to the host (``Tensor.cpu``/``numpy``/``tolist``/``to("cpu")``).  It
excepts only the plain advance's loop test (``tsit5.integrate_to``) and the
plain dt reset (``advance_cuda.auto_dt_reset``), which the graphed path
never runs: there kernels K1 and K3 stand in for them.

On the CPU the capture rule is off (``graphed`` false), and the drivers'
loops equal the JAX package's jitted drivers on a small box (the
fixed-substep configuration, rtol 1e-5 as tests/test_torch_model_2d.py
holds it, counters equal).  The graphed drivers against the eager step
are in tests/test_torch_cuda.py (marker ``cuda``).
"""

import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import picles_torch as pt
from picles_torch.ops import advance_cuda, tsit5
from test_torch_model_2d import (_fixed_substep_models, assert_counters_equal,
                                 state_of)

torch.set_num_threads(1)

aten = torch.ops.aten
READS = {aten._local_scalar_dense.default, aten.item.default,
         aten.lift_fresh.default}
EXCEPT = {tsit5.integrate_to.__code__, advance_cuda.auto_dt_reset.__code__}


def _excepted() -> bool:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code in EXCEPT:
            return True
        f = f.f_back
    return False


class HostTraffic(TorchDispatchMode):
    """Records the transfers between host and device a region makes (see
    the module docstring) as (what, innermost picles_torch frame)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def record(self, what: str) -> None:
        if _excepted():
            return
        f = sys._getframe(1)
        while f is not None and "picles_torch" not in f.f_code.co_filename:
            f = f.f_back
        where = (f"{f.f_code.co_filename.split('picles_torch')[-1]}:"
                 f"{f.f_lineno} {f.f_code.co_name}" if f else "?")
        self.seen.append((what, where))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in READS:
            self.record(str(func))
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        self._patched = {}
        for name in ("cpu", "numpy", "tolist"):
            self._patch(name, lambda *a, _n=name, **k: self.record(_n))

        def to(t, *a, **k):
            dev = k.get("device", a[0] if a else None)
            if isinstance(dev, (str, torch.device)) and \
                    torch.device(dev).type == "cpu":
                self.record("to(cpu)")

        self._patch("to", to)
        return super().__enter__()

    def _patch(self, name, hook):
        orig = getattr(torch.Tensor, name)
        self._patched[name] = orig

        def wrapped(t, *a, **k):
            hook(t, *a, **k)
            return orig(t, *a, **k)

        setattr(torch.Tensor, name, wrapped)

    def __exit__(self, *exc):
        for name, orig in self._patched.items():
            setattr(torch.Tensor, name, orig)
        return super().__exit__(*exc)


def _record(n: int, cadence: float = 900.0):
    """A small gridded record over the n^2 box of ``_model``: a wind that
    turns in time and varies in x and y, hourly frames over 3 h."""
    rng = np.random.default_rng(3)
    u = 8.0 + rng.uniform(-2.0, 2.0, (4, n + 2, n + 2))
    v = 6.0 + rng.uniform(-2.0, 2.0, (4, n + 2, n + 2))
    return pt.GriddedWinds2D(
        u_data=torch.as_tensor(u.astype(np.float32)),
        v_data=torch.as_tensor(v.astype(np.float32)), x0=0.0, dx=2e3, y0=0.0,
        dy=2e3, t0=0.0, dt=cadence)


def _model(path: str, n: int = 16):
    """The configurations the card graphs, at n^2 on the CPU: the flagship
    (bosh3, carried dt, halo ((0,3),(0,3))) with each remesh, the default
    (tsit5, Hairer reset, halo 3) and the gridded fused configuration."""
    ws = pt.core.fetch_relations.MinimalWindsea(10.0, 10.0, 600.0)
    solver = "tsit5" if path == "default" else "bosh3"
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=600.0,
                          timestep=600.0, dt=1e-3, dtmin=1e-4,
                          force_dtmin=True, solver=solver)
    grid = pt.cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                            periodic_boundary=(True, True), device="cpu")
    if path == "default":
        cfg = pt.WaveGrowth2DConfig(periodic_boundary=True)
    else:
        remesh = {"gridded": "fused"}.get(path, path)
        cfg = pt.WaveGrowth2DConfig(
            periodic_boundary=True, dt_reset_mode="carry",
            halo=3 if path == "gridded" else ((0, 3), (0, 3)),
            remesh_mode=remesh)
    winds = _record(n) if path == "gridded" else pt.constant_winds(10.0, 10.0)
    return pt.WaveGrowth2D(grid, winds, sett, config=cfg)


PATHS = ["xla", "pallas", "fused", "default", "gridded"]


@pytest.mark.parametrize("path", PATHS)
def test_step_makes_no_host_transfer(path):
    """Two steps from the seed (the first fills the model's caches, as the
    warm-up before a capture does): no transfer between host and device but
    the plain advance's loop test and the plain dt reset; for the gridded
    wind also the per-step planes the kernels read (``wind_fields``), which
    only the card's step forms."""
    model = _model(path)
    ms = model.step(model.init_state())
    with HostTraffic() as seen:
        ms = model.step(ms)
        if model.gridded_winds is not None:
            planes = model.wind_fields(model.grid, ms.time)
            assert len(planes) == 4 + 3 * model._wind_B
    assert seen.seen == [], seen.seen
    assert int(ms.iteration) == 2 and int(ms.metrics.n_failed) == 0


def test_guard_sees_host_transfers():
    """The guard records each kind of transfer it looks for, and excepts
    the plain advance."""
    x = torch.ones(3)
    with HostTraffic() as seen:
        float(x.sum())
        torch.as_tensor(600.0, dtype=torch.float32)
        x.cpu()
        x.to("cpu")
        x.numpy()
        x.tolist()
    assert [w for w, _ in seen.seen] == [
        "aten._local_scalar_dense.default", "aten.lift_fresh.default", "cpu",
        "to(cpu)", "numpy", "tolist"]
    model = _model("xla")
    with HostTraffic() as seen:
        model.step(model.init_state())
    assert seen.seen == []


@pytest.mark.parametrize("path", PATHS)
def test_capture_rule_is_off_on_the_cpu(path):
    model = _model(path)
    assert model.resolved_config().advance_mode == "torch"
    assert model.graphed is False
    with pytest.raises(AttributeError):
        model.graphed = True
    ms = model.init_state()
    a = model.step_n_quiet(ms, 2)
    assert model._graph is None
    b = model.step(model.step(ms))
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)


def test_drivers_match_jax_jitted_drivers():
    """step_jit, step_n, step_n_buffered (a ragged chunk) and step_n_quiet
    against the JAX package's compiled drivers from the same state."""
    jm, tm = _fixed_substep_models()
    jms = jm.init_state()
    tms = state_of(jms)

    def close(t, j, what):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-10, err_msg=what)

    jf, tf = jm.step_jit(), tm.step_jit()
    j1, t1 = jf(jms), tf(tms)
    kept = t1.clone()
    j2, t2 = jf(j1), tf(t1)
    close(t2.state, j2.state, "step_jit twice")
    assert_counters_equal(t2, j2, 2)
    for a, b in zip(t1.leaves(), kept.leaves()):
        assert torch.equal(a, b)   # the first result is intact

    jfin, jstack = jm.step_n(jms, 3)
    tfin, tstack = tm.step_n(tms, 3)
    assert tuple(tstack.shape) == tuple(jstack.shape) == (3, 12, 12, 3)
    close(tstack, jstack, "step_n stack")
    close(tfin.state, jfin.state, "step_n final")
    assert_counters_equal(tfin, jfin, 3)

    jfin, jbuf = jm.step_n_buffered(jms, 2, 4)
    tfin, tbuf = tm.step_n_buffered(tms, 2, 4)
    close(tbuf, jbuf, "step_n_buffered buffer")
    assert not tbuf[2:].any()
    assert int(tfin.iteration) == int(jfin.iteration) == 2

    jq, tq = jm.step_n_quiet(jms, 3), tm.step_n_quiet(tms, 3)
    close(tq.state, jq.state, "step_n_quiet")
    for f in ("lne", "cgx", "cgy", "px", "py", "t", "dt"):
        close(getattr(tq.particles, f), getattr(jq.particles, f), f)
    assert_counters_equal(tq, jq, 3)
    np.testing.assert_array_equal(tq.particles.on.numpy(),
                                  np.asarray(jq.particles.on))


def test_state_clone_and_copy():
    """``clone`` gives each leaf its own tensor (the seed's counters share
    one); ``copy_`` writes into the target's tensors in place."""
    model = _model("xla", n=8)
    s0 = model.init_state()
    c = s0.clone()
    assert len({id(t) for t in c.leaves()}) == len(c.leaves()) == 22
    s1 = model.step(s0)
    ptrs = [t.data_ptr() for t in c.leaves()]
    c.copy_(s1)
    assert [t.data_ptr() for t in c.leaves()] == ptrs
    for a, b in zip(c.leaves(), s1.leaves()):
        assert torch.equal(a, b)
    assert int(s0.iteration) == 0 and int(c.metrics.n_active) > 0
