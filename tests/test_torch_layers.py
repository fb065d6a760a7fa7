"""Layers on the port (``WaveGrowth2D`` with ``config.layers > 1``,
``step_layers``, ``LayeredWaveGrowth2D``) against the JAX package on the
CPU, mirroring ``tests/test_layers.py`` and
``tests/test_utils_and_checkpoint.py`` ``test_layers_vmap``.

Layers are the reference's fourth State dimension: several wave systems on
one grid, one clock.  JAX ``vmap``s the step over them; the port steps the
``[L, nx, ny]`` planes at once, the grid planes broadcasting.

Tolerances:
- port against JAX: the cross-backend bound of tests/test_torch_model_2d.py
  (rtol 5e-3, atol 1e-9 on the node state and 1e-6 on the particle planes:
  the adaptive controller turns last-ulp differences of the two libraries
  into other substep paths), every counter of every layer exactly; the
  seeding rtol 1e-6; the JAX run with its Pallas kernels in interpret mode
  (``test_layers_pallas_kernels_vmap``) at rtol 5e-3, as that file holds it
  against its XLA step;
- the layered step against L single-layer steps of the port, and copies of
  one layer against each other: rtol 2e-3 (the port-vs-port bound of
  tests/test_torch_sharded.py, for the same cause), every counter but
  ``substeps_max`` exactly.  On the CPU ``torch.pow`` of a tensor by a
  float exponent (the controller's step factor, the Hairer estimate) and
  ``torch.atan2`` (the windsea's direction) evaluate a tensor's last
  elements, the tail past their vector loop, with scalar libm and the
  others vectorised, an ulp apart on some lanes; where the tail falls
  depends on the tensor's length, so a layer of an ``[L, nx, ny]`` tensor
  and the same ``[nx, ny]`` plane alone can part by an ulp, which the
  adaptive controller amplifies (7.3e-6 measured).  The plain deposit and
  remesh are bit for bit a layer.  On the card the kernels step every
  layer in one launch and the layered step equals the single-layer steps
  bit for bit (``chip_smoke.py`` phase "layers",
  tests/test_torch_cuda.py);
- checkpoints both ways, and a resumed run, bit for bit.
"""

import dataclasses
import os

import h5py
import jax
import numpy as np
import pytest
import torch

import test_layers as tl
from picles_tpu.forcing.winds import constant_winds as j_constant
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.simulation import checkpoint as jck
from picles_tpu.simulation.simulation import Simulation as JSimulation

import picles_torch as pt
from picles_torch import convert
from picles_torch.models.wave_growth_2d import layer_of, stack_layers
from picles_torch.ops import pic, remesh
from picles_torch.parallel.sharded import Mesh, ShardedWaveGrowth2D
from test_torch_graphs import HostTraffic
from test_torch_graphs import _model as graph_model
from test_torch_model_2d import COUNTERS, port_of, state_of

torch.set_num_threads(1)

RTOL, ATOL, PATOL = 5e-3, 1e-9, 1e-6
PLANES = ("lne", "cgx", "cgy", "px", "py")


def defaults_of(jd):
    """The port's ParticleDefaults2D of JAX's."""
    return [pt.ParticleDefaults2D(d.lne, d.cg_x, d.cg_y) for d in jd]


def jax_model(L, n=12, sett=None, **cfg):
    """tests/test_layers.py's ``_model`` (n^2 periodic box, (10, 5) m/s),
    with other settings or config entries."""
    jm = tl._model(L, n)
    if cfg or sett:
        jm = JModel(jm.grid, j_constant(10.0, 5.0),
                    dataclasses.replace(jm.settings, **(sett or {})),
                    config=dataclasses.replace(jm.config, **cfg))
    return jm


def models(L, n=12, sett=None, **cfg):
    """``jax_model`` and the port's twin."""
    jm = jax_model(L, n, sett, **cfg)
    return jm, port_of(jm, pt.constant_winds(10.0, 5.0))


def assert_like_jax(tms, jms, what):
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=RTOL, atol=ATOL, err_msg=f"{what} state")
    for k in PLANES:
        np.testing.assert_allclose(getattr(tms.particles, k).numpy(),
                                   np.asarray(getattr(jms.particles, k)),
                                   rtol=RTOL, atol=PATOL,
                                   err_msg=f"{what} {k}")
    got = tms.metrics.as_dict()
    for k in COUNTERS:
        assert got[k] == np.asarray(getattr(jms.metrics, k)).tolist(), \
            (what, k)
    assert float(tms.time) == float(jms.time)


def assert_leaves_equal(a, b, what):
    for i, (x, y) in enumerate(zip(a.leaves(), b.leaves())):
        assert x.shape == y.shape and torch.equal(x, y), (what, i)


def assert_layers_close(got, want, what):
    """Two single-layer states of the port within the module's port-vs-port
    bound, counters but ``substeps_max`` equal."""
    np.testing.assert_allclose(got.state.numpy(), want.state.numpy(),
                               rtol=2e-3, atol=ATOL, err_msg=what)
    for f in PLANES:
        np.testing.assert_allclose(getattr(got.particles, f).numpy(),
                                   getattr(want.particles, f).numpy(),
                                   rtol=2e-3, atol=PATOL, err_msg=f"{what} {f}")
    a, b = got.metrics.as_dict(), want.metrics.as_dict()
    del a["substeps_max"], b["substeps_max"]
    assert a == b, what


def test_layered_step_matches_jax():
    """T06's analog at L = 4 with distinct swell seeds: the port's seeding
    and three layered steps against JAX's ``step_layers``, every counter of
    every layer equal; the layers differ from each other."""
    L = 4
    jm, tm = models(L)
    jd = tl._swell_defaults(L)
    jms = jm.init_state_layers(jd)
    seeded = tm.init_state_layers(defaults_of(jd))
    assert tuple(seeded.state.shape) == (L, 12, 12, 3)
    assert tuple(seeded.metrics.n_active.shape) == (L,)
    np.testing.assert_allclose(seeded.state.numpy(), np.asarray(jms.state),
                               rtol=1e-6, atol=1e-12)
    tms = state_of(jms)
    step = jax.jit(jm.step_layers)
    for k in range(3):
        jms, tms = step(jms), tm.step_layers(tms)
        assert_like_jax(tms, jms, f"step {k + 1}")
    S = tms.state.numpy()
    for k in range(1, L):
        assert not np.allclose(S[0], S[k], rtol=1e-3)


def test_layered_carry_matches_jax_pallas_kernels():
    """``test_layers_pallas_kernels_vmap``'s configuration (carried dt,
    16^2, L = 2): JAX's vmapped Pallas advance and deposit (interpret mode)
    against the port's layered step with each remesh of the port (the
    kernel modes run their plain versions on the CPU)."""
    jm = jax_model(2, n=16, advance_mode="pallas",
                   scatter_mode="dense_pallas", pallas_interpret=True,
                   dt_reset_mode="carry")
    jms = jm.init_state_layers(tl._swell_defaults(2))
    jout = jax.jit(jm.step_layers)(jms)
    for remesh_mode in ("xla", "pallas", "fused"):
        _, tm = models(2, n=16, dt_reset_mode="carry",
                       remesh_mode=remesh_mode)
        tout = tm.step_layers(state_of(jms))
        assert_like_jax(tout, jout, remesh_mode)


def test_identical_layers_evolve_identically():
    """``test_layers_vmap``: without per-layer seeds every layer is a copy,
    and copies stay equal (rtol 2e-3, see the module docstring); the
    counters are [L]."""
    L = 3
    jm, tm = models(L, n=15)
    jms = jm.init_state_layers()
    tms = tm.init_state_layers()
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-6, atol=1e-12)
    tms = state_of(jms)
    for _ in range(2):
        jms, tms = jax.jit(jm.step_layers)(jms), tm.step_layers(tms)
    for k in range(1, L):
        assert_layers_close(layer_of(tms, k), layer_of(tms, 0), f"layer {k}")
    assert tuple(tms.metrics.n_active.shape) == (L,)
    assert_like_jax(tms, jms, "identical layers")


# the configurations the layered kernels run on the card, their plain
# versions here
LAYER_CONFIGS = {
    "carry-xla": dict(dt_reset_mode="carry"),
    "carry-pallas": dict(dt_reset_mode="carry", remesh_mode="pallas"),
    "carry-fused": dict(dt_reset_mode="carry", remesh_mode="fused"),
    "default": {},
}


@pytest.mark.parametrize("name", list(LAYER_CONFIGS))
def test_layered_step_equals_single_layer_steps(name):
    """Layer k of three layered steps against three steps of the
    single-layer model seeded with layer k's defaults (the module's
    port-vs-port bound)."""
    cfg = LAYER_CONFIGS[name]
    L = 3
    _, tm = models(L, **cfg)
    _, t1 = models(1, **cfg)
    d = defaults_of(tl._swell_defaults(L))
    ms = tm.init_state_layers(d)
    singles = [t1.init_state(defaults=dk) for dk in d]
    for _ in range(3):
        ms = tm.step_layers(ms)
        singles = [t1.step(s) for s in singles]
    for k, s in enumerate(singles):
        assert_layers_close(layer_of(ms, k), s, f"{name} layer {k}")


UV = [(10.0, 5.0), (6.0, 0.0), (0.0, 12.0)]
# the solver's tolerances of chip_smoke.py's card-vs-CPU checks, under
# which the controller's paths no longer part the packages
TIGHT = dict(abstol=1e-7, reltol=1e-6)


@pytest.mark.parametrize("sett", [None, TIGHT], ids=["default", "tight"])
def test_per_layer_winds(sett):
    """``as_layered(per_layer_winds=...)``: each layer under its own wind
    (``test_layers_per_layer_winds``' three); every layer is its own
    single-layer model's run bit for bit.  Against JAX's adapter with the
    solver's tolerances tightened (``TIGHT``): rtol 1e-4 (3.5e-6 measured
    after 3 steps), every counter but ``substeps_max`` (one substep apart
    on a layer) equal.  With the default tolerances the run is held to the
    port's own models only: the (0, 12) m/s layer's young sea takes 14
    accepted and 5 rejected substeps in step 1 in the port against JAX's
    13 and 3 (every lane alike, the single-layer models too) and departs
    by 1.2% in lne, the controller's amplification of last-ulp differences
    that tests/test_torch_model_2d.py describes."""
    L = 3
    jm, tm = models(L, sett=sett)
    jlay = jm.as_layered(per_layer_winds=[j_constant(*w) for w in UV])
    tlay = tm.as_layered(per_layer_winds=[pt.constant_winds(*w) for w in UV])
    assert isinstance(tlay, pt.LayeredWaveGrowth2D) and not tlay.graphed
    jms, tms = jlay.init_state(), tlay.init_state()
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-6, atol=1e-12)
    tms = state_of(jms)
    singles = [layer_of(tms, k) for k in range(L)]
    for k in range(3):
        jms, tms = jax.jit(jlay.step)(jms), tlay.step(tms)
        singles = [m.step(s) for m, s in zip(tlay.layer_models, singles)]
        if sett is TIGHT:
            np.testing.assert_allclose(tms.state.numpy(),
                                       np.asarray(jms.state), rtol=1e-4,
                                       atol=1e-10, err_msg=f"step {k + 1}")
            for f in COUNTERS[:-1]:
                assert getattr(tms.metrics, f).tolist() == np.asarray(
                    getattr(jms.metrics, f)).tolist(), f
    for k, s in enumerate(singles):
        assert_leaves_equal(layer_of(tms, k), s, f"layer {k}")
    e = tms.state[..., 0].numpy()
    assert not np.allclose(e[0], e[1]) and not np.allclose(e[1], e[2])
    _, single = models(1, sett=sett)
    ss = single.init_state()
    for _ in range(3):
        ss = single.step(ss)
    assert_leaves_equal(layer_of(tms, 0), ss, "layer 0 as the base model")
    assert tlay.fields(tms)["State"] is tms.state


def test_layered_store_matches_jax(tmp_path):
    """A layered run through ``Simulation`` stores [time, layer, x, y,
    state] in the JAX package's HDF5 layout, row for row JAX's."""
    L = 4
    jm, tm = models(L)
    jd = tl._swell_defaults(L)
    rows = {}
    for tag, lay, Sim in (("jax", jm.as_layered(jd), JSimulation),
                          ("port", tm.as_layered(defaults_of(jd)),
                           pt.Simulation)):
        sim = Sim.create(lay, stop_time=1800.0)
        sim.initialize()
        sim.init_state_store(str(tmp_path / tag))
        sim.run(store=True)
        sim.store.close()
        with h5py.File(os.path.join(str(tmp_path / tag), "state.h5")) as f:
            grp = f["waves"]
            assert grp["data"].shape == (5, L, 12, 12, 3)
            assert list(grp.attrs["dims"]) == ["time", "layer", "x", "y",
                                               "state"]
            rows[tag] = (grp["data"][:], grp["layer"][:])
    np.testing.assert_array_equal(rows["port"][1], rows["jax"][1])
    for r in range(5):
        np.testing.assert_allclose(rows["port"][0][r], rows["jax"][0][r],
                                   rtol=RTOL, atol=ATOL, err_msg=f"row {r}")
    data = rows["port"][0]
    assert np.all(np.isfinite(data))
    assert not np.allclose(data[-1, 0], data[-1, 1], rtol=1e-3)


def test_layered_storeless_run_and_cash_store():
    """The storeless driver runs a layered model as JAX's does; a CashStore
    keeps [L, x, y, state] frames, the last one the final state."""
    L = 3
    jm, tm = models(L)
    jd = tl._swell_defaults(L)
    jsim = JSimulation.create(jm.as_layered(jd), stop_time=1800.0)
    jsim.run()
    sim = pt.Simulation.create(tm.as_layered(defaults_of(jd)),
                               stop_time=1800.0)
    sim.run()
    assert tuple(sim.state.state.shape) == (L, 12, 12, 3)
    assert float(sim.state.time) == 4 * 600.0
    assert_like_jax(sim.state, jsim.state, "storeless")
    cash = pt.Simulation.create(tm.as_layered(defaults_of(jd)),
                                stop_time=1800.0)
    cash.run(cash_store=True)
    frames = cash.store.as_array()
    assert frames.shape == (5, L, 12, 12, 3)
    np.testing.assert_array_equal(frames[-1], sim.state.state.numpy())


def test_layered_checkpoint_both_ways(tmp_path):
    """A layered checkpoint written by either package loads in the other
    bit for bit, counters [L] included, and the port's run resumed from it
    equals the uninterrupted run bit for bit."""
    L = 3
    jm, tm = models(L)
    jd = tl._swell_defaults(L)
    jsim = JSimulation.create(jm.as_layered(jd), stop_time=1200.0)
    jsim.run()
    jpath = jsim.checkpoint(str(tmp_path / "jax_ck"))
    got = pt.load_checkpoint(jpath, device="cpu")
    want = convert.state_to_numpy(got)
    assert got.state.shape == (L, 12, 12, 3)
    np.testing.assert_array_equal(want["state"], np.asarray(jsim.state.state))
    for k in convert.PARTICLE_FIELDS:
        np.testing.assert_array_equal(
            want[k], np.asarray(getattr(jsim.state.particles, k)))
    for k in COUNTERS:
        assert want["metrics"][k] == np.asarray(
            getattr(jsim.state.metrics, k)).tolist()

    lay = tm.as_layered(defaults_of(jd))
    sim = pt.Simulation.create(lay, stop_time=1200.0)
    sim.run()
    path = sim.checkpoint(str(tmp_path / "port_ck"))
    back = jck.load_checkpoint(path)
    for a, b in zip(sim.state.leaves(), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rest = pt.Simulation.create(lay, stop_time=2400.0)
    rest.pickup(path)
    rest.run()
    full = pt.Simulation.create(lay, stop_time=2400.0)
    full.run()
    assert_leaves_equal(rest.state, full.state, "resumed")
    assert int(rest.state.iteration) == 5


def test_refusals():
    """``with_winds`` cannot rebuild a model with a custom ``rhs``; a
    custom ``rhs`` runs on the plain advance only; the sharded step takes
    the model, not the adapter; per-layer lists must have L entries; a
    layered step wants a layered state."""
    from picles_torch.ops.rhs import particle_equations

    _, tm = models(2)
    custom = particle_equations(lambda x, y, t: torch.full_like(x, 7.0),
                                lambda x, y, t: torch.zeros_like(x))
    m = pt.WaveGrowth2D(tm.grid, pt.constant_winds(10.0, 5.0), tm.settings,
                        rhs=custom, config=tm.config)
    with pytest.raises(ValueError, match="custom `rhs`"):
        m.as_layered(per_layer_winds=[pt.constant_winds(1.0, 0.0)] * 2)
    with pytest.raises(ValueError, match="plain advance only"):
        pt.WaveGrowth2D(tm.grid, pt.constant_winds(10.0, 5.0), tm.settings,
                        rhs=custom, config=pt.WaveGrowth2DConfig(
                            advance_mode="cuda", layers=2))
    assert not pt.WaveGrowth2D(tm.grid, pt.constant_winds(10.0, 5.0),
                               tm.settings, rhs=custom,
                               config=tm.config).graphed
    with pytest.raises(TypeError, match="pass its `.model`"):
        ShardedWaveGrowth2D(tm.as_layered(), Mesh((1, 1)))
    with pytest.raises(ValueError, match="need 2 per-layer winds"):
        tm.as_layered(per_layer_winds=[pt.constant_winds(1.0, 0.0)])
    with pytest.raises(ValueError, match="need 2 per-layer defaults"):
        tm.init_state_layers([None])
    with pytest.raises(ValueError, match="layered state"):
        tm.step_layers(tm.init_state())


def test_custom_rhs_runs_like_jax():
    """The ``rhs=`` override (``test_with_winds_rejects_custom_rhs``'s
    right-hand side, a steady 7 m/s wind) steps like JAX's model built with
    it, layered."""
    from picles_tpu.ops.rhs import particle_equations as j_eq

    from picles_torch.ops.rhs import particle_equations

    jm0, tm0 = models(2)
    jm = JModel(jm0.grid, j_constant(10.0, 5.0), jm0.settings,
                rhs=j_eq(lambda x, y, t: 7.0, lambda x, y, t: 0.0),
                config=jm0.config)
    tm = pt.WaveGrowth2D(
        tm0.grid, pt.constant_winds(10.0, 5.0), tm0.settings,
        rhs=particle_equations(lambda x, y, t: torch.full_like(x, 7.0),
                               lambda x, y, t: torch.zeros_like(x)),
        config=tm0.config)
    jms = jm.init_state_layers(tl._swell_defaults(2))
    tms = state_of(jms)
    for k in range(2):
        jms, tms = jax.jit(jm.step_layers)(jms), tm.step_layers(tms)
        assert_like_jax(tms, jms, f"custom rhs step {k + 1}")


@pytest.mark.parametrize("path", ["xla", "pallas", "fused", "default",
                                  "gridded"])
def test_layered_step_makes_no_host_transfer(path):
    """The layered step, as the single-layer one
    (tests/test_torch_graphs.py), reads nothing back and copies no host
    value to the device (the plain advance's loop test and dt reset
    excepted), so the drivers capture it on the card."""
    import dataclasses

    base = graph_model(path, n=12)
    model = pt.WaveGrowth2D(
        base.grid, base.gridded_winds or base.winds, base.settings,
        config=dataclasses.replace(base.config, layers=3))
    ms = model.step_layers(model.init_state_layers(
        [None, pt.ParticleDefaults2D(-6.0, 3.0, 1.0), "model"]))
    with HostTraffic() as seen:
        ms = model.step_layers(ms)
    assert seen.seen == [], seen.seen
    assert ms.metrics.n_failed.tolist() == [0, 0, 0]


def test_convert_round_trips_layered_state():
    """``state_to_numpy`` and ``state_from_numpy`` carry the leading [L]
    axis and the [L] counters."""
    _, tm = models(2)
    ms = tm.step_layers(tm.init_state_layers(
        defaults_of(tl._swell_defaults(2))))
    d = convert.state_to_numpy(ms)
    assert d["state"].shape == (2, 12, 12, 3)
    assert len(d["metrics"]["n_gather"]) == 2
    back = convert.state_from_numpy(
        d["state"], d, d["time"], d["iteration"], device="cpu",
        metrics=d["metrics"])
    assert_leaves_equal(back, ms, "round trip")
    zero = convert.state_from_numpy(d["state"], d, d["time"], d["iteration"],
                                    device="cpu")
    assert zero.metrics.n_gather.tolist() == [0, 0]
    assert_leaves_equal(stack_layers([layer_of(ms, 0), layer_of(ms, 1)]), ms,
                        "stack of slices")


@pytest.mark.parametrize("boundary,halo", [
    ("periodic", ((0, 3), (0, 3))), ("nonperiodic", 3),
    ("tripolar", ((2, 3), (1, 3)))])
def test_plain_layered_deposit_and_remesh_per_layer(boundary, halo):
    """The plain versions of K2, K4, K5 (and so K6) on [L, nx, ny] planes
    equal their single-layer results layer by layer, bit for bit; the
    clamped count is one a layer; the oracle loops over the layers."""
    rng = np.random.default_rng(7)
    L, nx, ny = 3, 10, 12
    (xl, xh), (yl, yh) = pic.normalize_halo(halo)
    B = pt.Boundary
    stats = pt.GridStats(nx=nx, ny=ny, bx=B.PERIODIC
                         if boundary != "nonperiodic" else B.NONPERIODIC,
                         by={"periodic": B.PERIODIC,
                             "nonperiodic": B.NONPERIODIC,
                             "tripolar": B.TRIPOLAR_NORTH}[boundary])
    xr = torch.as_tensor(rng.uniform(-xl - 0.3, xh + 0.3, (L, nx, ny)),
                         dtype=torch.float32)
    yr = torch.as_tensor(rng.uniform(-yl - 0.3, yh + 0.3, (L, nx, ny)),
                         dtype=torch.float32)
    ch = torch.as_tensor(rng.uniform(0.1, 1.0, (L, nx, ny, 3)),
                         dtype=torch.float32)
    act = torch.as_tensor(rng.random((L, nx, ny)) > 0.1)
    S, st = pic.scatter_dense(xr, yr, ch, act, stats, halo)
    P, pst = pic.scatter_accumulate_padded(xr, yr, ch, act, halo)
    X, xst = pic.scatter_xla(xr, yr, ch, act, stats)
    assert st.clamped.shape == (L,) and int(st.clamped.sum()) > 0
    for k in range(L):
        Sk, sk = pic.scatter_dense(xr[k], yr[k], ch[k], act[k], stats, halo)
        Pk, _ = pic.scatter_accumulate_padded(xr[k], yr[k], ch[k], act[k],
                                              halo)
        Xk, _ = pic.scatter_xla(xr[k], yr[k], ch[k], act[k], stats)
        assert torch.equal(S[k], Sk) and torch.equal(P[k], Pk)
        assert torch.equal(X[k], Xk)
        assert int(st.clamped[k]) == int(sk.clamped) == int(pst.clamped[k])

    _, tm = models(L, n=nx)
    params = tm.remesh_params._replace(defaults=(-5.0, 2.0, 1.0))
    node = tuple(S[..., c] for c in range(3))
    grid_planes = (torch.as_tensor(rng.random((nx, ny)) > 0.2),
                   torch.as_tensor(rng.random((nx, ny)) > 0.8))
    dt = torch.as_tensor(rng.uniform(0.0, 900.0, (L, nx, ny)),
                         dtype=torch.float32)
    parts = [xr, yr, ch[..., 0], ch[..., 1], ch[..., 2], dt, act]
    xn = torch.linspace(0.0, 1e5, nx)[:, None].expand(nx, ny).contiguous()
    clock = torch.zeros(())
    for p in (tm.remesh_params, params):
        rm = remesh.remesh_core(p, node, *parts, *grid_planes, xn, xn, clock)
        for k in range(L):
            rk = remesh.remesh_core(p, tuple(n[k] for n in node),
                                    *(q[k] for q in parts), *grid_planes, xn,
                                    xn, clock)
            for a, b in zip(rm, rk):
                assert torch.equal(a[k], b)
