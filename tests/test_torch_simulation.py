"""The port's run loop (``Simulation``), stores, checkpoints, diagnostics and
CLI against the JAX package's, on the CPU at 15^2 and 16^2.

Tolerances: the port against JAX, over whole runs of the default model
(tsit5, Hairer dt reset), at the JAX suite's cross-backend bound rtol 5e-3
(the adaptive controller turns the two libraries' last-ulp differences into
other substep paths on a few lanes, see tests/test_torch_model_2d.py);
the port against itself (chunking, resume, stores) bit for bit; file
layouts, coordinates and checkpoint leaves exactly; the seeded initial
frame at rtol 2e-6 (the two libraries' exp and pow differ in the last
ulp); diagnostics of one state at rtol 1e-5 (float32 means summed in
another order), counters exactly.
"""

import dataclasses
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing.winds import constant_winds as j_winds
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.simulation import checkpoint as jck
from picles_tpu.simulation.simulation import Simulation as JSimulation
from picles_tpu.utils import diagnostics as jdiag

import picles_torch as pt
from picles_torch import convert
from picles_torch.simulation import checkpoint as tck
from picles_torch.utils import diagnostics as tdiag

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 600.0
RTOL = 5e-3


def _sett():
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True)


def _jsim(stop_time=3600.0, n=15):
    grid = j_box(100e3, n, 100e3, n, periodic_boundary=(True, True))
    return JSimulation.create(JModel(grid, j_winds(10.0, 10.0), _sett()),
                              stop_time=stop_time)


def _sim(stop_time=3600.0, n=15):
    grid = pt.cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True),
                            device="cpu")
    sett, _, _ = convert.settings_from_values(_sett())
    return pt.Simulation.create(
        pt.WaveGrowth2D(grid, pt.constant_winds(10.0, 10.0), sett),
        stop_time=stop_time)


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=1e-9, err_msg=what)


def test_run_step_count_and_cash_store_match_jax():
    sim, jsim = _sim(stop_time=3600.0), _jsim(stop_time=3600.0)
    assert sim.n_steps() == jsim.n_steps() == 7
    sim.run(cash_store=True)
    jsim.run(cash_store=True)
    assert len(sim.store.store) == len(jsim.store.store) == 8
    assert float(sim.state.time) == float(jsim.state.time) == 7 * 600.0
    assert int(sim.state.iteration) == 7
    a, j = sim.store.as_array(), jsim.store.as_array()
    assert a.shape == j.shape == (8, 15, 15, 3) and a.dtype == np.float32
    np.testing.assert_allclose(a[0], j[0], rtol=2e-6, atol=0)
    _close(a, j, "cash store")
    assert a[-1, ..., 0].mean() > a[0, ..., 0].mean()
    out = pt.convert_store_to_tuple(sim.store)
    assert out["data"].shape[0] == 8


def test_chunked_and_storeless_runs_equal_stored_bitwise():
    s1 = _sim(stop_time=2400.0)
    s1.run(cash_store=True)
    s2 = _sim(stop_time=2400.0)
    s2.initialize()
    s2.store = pt.CashStore()
    s2.store.push(s2.state.state)
    done, remaining = 0, s2.n_steps()
    while done < remaining:
        n = min(2, remaining - done)
        s2.state, states = s2.model.step_n(s2.state, n)
        for i in range(n):
            s2.store.push(states[i])
        done += n
    np.testing.assert_array_equal(s1.store.as_array(), s2.store.as_array())
    s3 = _sim(stop_time=2400.0)
    s3.run()
    assert torch.equal(s3.state.state, s1.state.state)
    assert float(s3.state.time) == float(s1.state.time)
    assert s3.run_wall_time > 0


def test_wall_time_limit_stops_storeless_and_stored_runs():
    sim = _sim(stop_time=600.0 * 400)
    sim.wall_time_limit = 0.0
    sim.run(chunk_size=2)
    assert int(sim.state.iteration) == 2
    assert float(sim.state.time) == 2 * 600.0
    sim = _sim(stop_time=24 * 3600.0)
    sim.wall_time_limit = 1e-9
    sim.run(cash_store=True)
    n_stored = len(sim.store.store)
    assert sim.n_steps() == 145
    assert 2 <= n_stored <= 65
    assert np.all(np.isfinite(sim.store.as_array()))
    assert int(sim.state.iteration) == n_stored - 1


def test_stored_run_goes_through_bounded_buffered_chunks():
    sim = _sim(stop_time=24 * 3600.0, n=6)
    dispatched, capacities = [], []
    inner = sim.model.step_n_buffered

    def spy(state, n, capacity):
        dispatched.append(n)
        capacities.append(capacity)
        return inner(state, n, capacity)

    sim.model.step_n_buffered = spy
    sim.run(cash_store=True)
    assert max(dispatched) <= 64 and sum(dispatched) == 145
    assert set(capacities) == {64}
    assert len(sim.store.store) == 146
    assert int(sim.state.iteration) == 145


def test_callbacks_run_per_chunk_and_nan_checker_halts():
    sim = _sim(stop_time=3600.0)
    calls = []
    sim.callbacks["count"] = lambda s: calls.append(float(s.state.time))
    sim.run(chunk_size=2)
    assert len(calls) == 4 and calls == sorted(calls)
    sim2 = _sim(stop_time=3600.0)
    n2 = []
    sim2.callbacks["count"] = lambda s: n2.append(1)
    sim2.run()
    assert len(n2) >= 1
    sim3 = _sim(stop_time=3600.0)

    def poison_then_check(s):
        state = s.state.state.clone()
        state[0, 0, 0] = float("nan")
        s.state = dataclasses.replace(s.state, state=state)
        tdiag.check_nans(s.state)

    sim3.callbacks["nan_check"] = poison_then_check
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        sim3.run(chunk_size=2)
    assert int(sim3.state.iteration) == 2


def test_reset_clears_cash_store():
    sim = _sim(stop_time=1200.0)
    sim.run(cash_store=True)
    n_rows = len(sim.store.store)
    sim.reset()
    assert float(sim.state.time) == 0.0 and len(sim.store.store) == 0
    sim.run(cash_store=True)
    assert len(sim.store.store) == n_rows


def test_hdf5_store_matches_jax_file_field_by_field(tmp_path):
    sim, jsim = _sim(stop_time=1800.0), _jsim(stop_time=1800.0)
    for s, d in ((sim, "torch"), (jsim, "jax")):
        s.initialize()
        s.init_state_store(str(tmp_path / d))
        s.run(store=True)
        s.store.close()
    with h5py.File(tmp_path / "torch" / "state.h5") as f, \
            h5py.File(tmp_path / "jax" / "state.h5") as g:
        assert set(f) == set(g) == {"waves"}
        a, b = f["waves"], g["waves"]
        assert set(a) == set(b)
        assert set(a.attrs) == set(b.attrs)
        assert list(a.attrs["dims"]) == list(b.attrs["dims"]) == \
            ["time", "x", "y", "state"]
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k != "data":
                np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
        assert a["data"].shape == (5, 15, 15, 3)
        np.testing.assert_allclose(a["data"][0], b["data"][0], rtol=2e-6,
                                   atol=0)
        _close(a["data"][()], b["data"][()], "stored history")


def test_store_rows_time_aligned_after_pickup(tmp_path):
    ref = _sim(stop_time=3600.0)
    ref.initialize()
    ref.init_state_store(str(tmp_path / "ref"))
    ref.run(store=True)
    ref.store.close()
    leg1 = _sim(stop_time=3600.0)
    leg1.initialize()
    leg1.init_state_store(str(tmp_path / "resumed"))
    leg1.stop_time = 1200.0
    leg1.run(store=True)
    k = int(leg1.state.iteration)
    ckpt = leg1.checkpoint(str(tmp_path / "ck.npz"))
    leg1.store.close()
    leg2 = _sim(stop_time=3600.0)
    leg2.pickup(ckpt)
    leg2.init_state_store(str(tmp_path / "resumed"), replace=False)
    leg2.run(store=True)
    leg2.store.close()
    with h5py.File(tmp_path / "ref" / "state.h5") as f:
        full = f["waves/data"][()]
    with h5py.File(tmp_path / "resumed" / "state.h5") as f:
        resumed = f["waves/data"][()]
    assert resumed.shape == full.shape and k < full.shape[0] - 1
    np.testing.assert_array_equal(resumed, full)


def test_cash_store_continuation_repeats_boundary_frame_like_jax():
    """A second run() into a kept CashStore pushes the boundary frame again
    (the JAX loop aligns the cursor of a StateStore only); the port keeps
    that behaviour so the two packages' histories compare row for row."""
    rows = []
    for sim in (_sim(stop_time=1200.0), _jsim(stop_time=1200.0)):
        sim.run(cash_store=True)
        sim.stop_time = 2400.0
        sim.run(store=True)
        rows.append(len(sim.store.store))
    assert rows[0] == rows[1] == 4 + 1 + 2


def _jax_leaves(ms):
    return [np.asarray(x) for x in jax.tree.leaves(ms)]


def test_checkpoints_interchange_with_jax(tmp_path):
    """A JAX-written npz resumes in the port to the JAX resumed state, and a
    port-written one loads in JAX leaf for leaf, as does a port-written
    orbax directory (tests/test_torch_orbax.py holds both directions)."""
    jm = _jsim().model
    jstep = jax.jit(jm.step)
    jms = jstep(jstep(jm.init_state()))
    jpath = jck.save_checkpoint(str(tmp_path / "jax_ck"), jms)
    sim = _sim(stop_time=3600.0)
    sim.pickup(jpath)
    for a, b in zip(sim.state.leaves(), _jax_leaves(jms)):
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    tms = sim.model.step_n_quiet(sim.state, 2)
    jms4 = jstep(jstep(jms))
    _close(tms.state.numpy(), jms4.state, "resumed in the port")
    assert float(tms.time) == float(jms4.time) == 4 * DT

    ppath = tck.save_checkpoint(str(tmp_path / "torch_ck"), tms)
    back = jck.load_checkpoint(ppath)
    for a, b in zip(tms.leaves(), _jax_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), b)
    again = tck.load_checkpoint(ppath, device="cpu")
    for a, b in zip(tms.leaves(), again.leaves()):
        assert torch.equal(a, b)
    opath = tck.save_checkpoint(str(tmp_path / "o"), tms, backend="orbax")
    for a, b in zip(tms.leaves(), _jax_leaves(jck.load_checkpoint(opath))):
        np.testing.assert_array_equal(a.numpy(), b)


def test_load_checkpoint_asks_for_the_card_by_default(tmp_path, monkeypatch):
    """``load_checkpoint`` loads onto the CUDA device unless the caller names
    another: on a machine without one it raises, naming ``device='cpu'``,
    and does not load onto the CPU in its place."""
    sim = _sim(stop_time=600.0)
    sim.run()
    ck = tck.save_checkpoint(str(tmp_path / "ck"), sim.state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        tck.load_checkpoint(ck)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.load_checkpoint(ck, device="cuda:0")
    back = tck.load_checkpoint(ck, device="cpu")
    assert torch.equal(back.state, sim.state.state)


def test_simulation_pickup_resumes_bitwise(tmp_path):
    full = _sim(stop_time=3600.0)
    full.run()
    leg = _sim(stop_time=1800.0)
    leg.run()
    ck = leg.checkpoint(str(tmp_path / "state_ck"))
    assert ck.endswith(".npz")
    rest = _sim(stop_time=3600.0)
    rest.pickup(ck)
    assert float(rest.state.time) == float(leg.state.time)
    rest.run()
    assert torch.equal(rest.state.state, full.state.state)
    assert torch.equal(rest.state.particles.dt, full.state.particles.dt)
    assert rest.state.metrics.as_dict() == full.state.metrics.as_dict()


def test_fused_simulation_resumes_bitwise(tmp_path):
    """The flagship's remesh mode (fused, carried dt) through the run loop:
    checkpoint midway, a fresh Simulation picks up, bitwise the same end."""
    grid = pt.cartesian_box(2e3 * 15, 16, 2e3 * 15, 16,
                            periodic_boundary=(True, True), device="cpu")
    sett, _, _ = convert.settings_from_values(_sett())
    sett = dataclasses.replace(sett, solver="bosh3")
    model = pt.WaveGrowth2D(grid, pt.constant_winds(10.0, 10.0), sett,
                            config=pt.WaveGrowth2DConfig(
                                dt_reset_mode="carry", remesh_mode="fused",
                                halo=((0, 3), (0, 3))))
    a = pt.Simulation.create(model, stop_time=4 * DT)
    a.run()
    b = pt.Simulation.create(model, stop_time=2 * DT)
    b.run()
    ck = b.checkpoint(str(tmp_path / "fused"))
    c = pt.Simulation.create(model, stop_time=4 * DT)
    c.pickup(ck)
    c.run()
    for x, y in zip(a.state.leaves(), c.state.leaves()):
        assert torch.equal(x, y)
    assert int(c.state.metrics.n_failed) == 0


def test_diagnostics_match_jax():
    jm = _jsim().model
    jms = jax.jit(jm.step)(jm.init_state())
    P = jms.particles
    tms = convert.state_from_numpy(
        np.asarray(jms.state),
        {k: np.asarray(getattr(P, k)) for k in convert.PARTICLE_FIELDS},
        np.asarray(jms.time), np.asarray(jms.iteration), device="cpu")
    tms = dataclasses.replace(tms, metrics=pt.StepMetrics(
        *(torch.tensor(np.asarray(x)) for x in jms.metrics)))
    got, want = tdiag.step_summary(tms), jdiag.step_summary(jms)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], int):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert tdiag.mean_of_state(tms) > 0 and tdiag.max_energy(tms) > 0
    tdiag.check_nans(tms)
    bad = dataclasses.replace(tms, state=tms.state.clone())
    bad.state[1, 2, 0] = float("inf")
    with pytest.raises(FloatingPointError):
        jdiag.check_nans(dataclasses.replace(jms, state=jnp.asarray(
            bad.state.numpy())))
    with pytest.raises(FloatingPointError):
        tdiag.check_nans(bad)


def test_cli_writes_the_jax_cli_store(tmp_path):
    """``python -m picles_torch --device cpu`` against ``python -m
    picles_tpu`` with the same flags: the same store, the port's on the
    device it names."""
    flags = ["--Nx", "16", "--T", "0.5"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    outs = {}
    for pkg, own in (("picles_torch", ["--device", "cpu"]),
                     ("picles_tpu", [])):
        d = str(tmp_path / pkg)
        r = subprocess.run([sys.executable, "-m", pkg, *flags, *own,
                            "--ID", d],
                           cwd=str(tmp_path), env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs[pkg] = r.stdout
        assert "wrote" in r.stdout
    assert "device: cpu" in outs["picles_torch"]
    with h5py.File(tmp_path / "picles_torch" / "state.h5") as f, \
            h5py.File(tmp_path / "picles_tpu" / "state.h5") as g:
        a, b = f["waves"], g["waves"]
        assert set(a) == set(b)
        for k in a:
            if k != "data":
                np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
        assert a["data"].shape == b["data"].shape == (5, 16, 16, 3)
        _close(a["data"][()], b["data"][()], "CLI store")


def test_cli_refuses_to_run_without_a_cuda_device(tmp_path):
    """Without ``--device cpu`` the port's CLI asks for a CUDA device: on a
    machine with none it exits non-zero, names the missing device and writes
    no store."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    d = tmp_path / "run"
    r = subprocess.run([sys.executable, "-m", "picles_torch", "--Nx", "16",
                        "--T", "0.5", "--ID", str(d)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "wrote" not in r.stdout
    assert not d.exists() and list(tmp_path.iterdir()) == []
