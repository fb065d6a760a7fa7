"""The port's sharded step (``picles_torch/parallel/sharded.py``) against
``picles_tpu``'s on the CPU.

The port's ranks are 8 gloo processes (``tests/_torch_sharded_worker.py``),
spawned once for the module, which run every multi-rank case and leave
their gathered results for this process; JAX runs here on its 8 virtual CPU
devices (``tests/conftest.py``), on the same numpy-seeded inputs.  The
world-size-1 cases run in this process on a one-rank gloo group.

Tolerances:
- the collective deposit against JAX's global ``scatter_dense`` and JAX's
  ``_scatter_sharded`` under ``shard_map``: rtol/atol 2e-6
  (tests/test_sharded.py:218), float32 sums in another order;
- the adaptive step against the port's single-device step: rtol 2e-3
  (tests/test_sharded.py:50-56; blocks of another shape may round the
  vectorised transcendentals differently in the last ulp, and the error
  controller amplifies that; 1.2e-7 measured); against JAX's sharded step:
  rtol 5e-3, the port-vs-JAX bound of tests/test_torch_simulation.py,
  because the port's single-device step already departs from JAX's by up
  to 2.1e-3 on these configurations (and JAX's sharded step from JAX's
  single-device one by 8.8e-4): other substep paths on some lanes, not the
  exchange; n_active, n_gather, n_failed exactly;
- fixed substeps (no controller): the port's sharded step against its
  single-device step to the deposit's summation order (a contribution that
  crosses a block edge is added after the exchange): rtol 1e-5 in float32
  (1.4e-6 measured), 1e-13 in float64 (1.1e-15 measured); against JAX's
  sharded step rtol 5e-5 in float32 (1.4e-5 measured: young-sea growth
  amplifies ulps) and 2e-5 in float64 (6.3e-6 measured: the port evaluates
  the winds in float32 whatever the model's dtype, so its float64 is no
  twin of JAX's);
- the spherical grid (per-node projection planes, the open-y drop) with
  fixed substeps: the port's single-device step at rtol 2e-6 / atol 1e-9
  (tests/test_sharded.py:415), JAX's sharded step at rtol 5e-5;
- the synthetic tripolar grid (metrics scaled by 1/100, land on the top
  row, the seam fold spread over the top row of blocks): fixed substeps at
  rtol 1e-5 against the port's single-device step and 5e-5 against JAX's
  sharded step (1.3e-6 of the state's scale measured against the
  single-device step: the deposit sums a block edge's terms in another
  order); the adaptive controller at abstol 1e-7 / reltol 1e-6 at rtol
  2e-3 and 5e-3 (1.7e-6 measured; at the default reltol 1e-3 the
  controller turns those last-ulp differences into other substep paths,
  1.3e-2 of the scale and 2.0e-2 element by element over 4 steps);
- the world-size-1 step equals the single-device step bit for bit: the
  self-wrap adds the slabs in ``fold_padded_x/y``'s order;
- checkpoints and the resumed run bit for bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import PartitionSpec as P

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing.winds import constant_winds as j_constant
from picles_tpu.forcing.winds import half_domain_winds as j_half
from picles_tpu.grids.base import Boundary as JB
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.ops import pic as jpic
from picles_tpu.ops.pic_pallas import scatter_padded_channels_pallas
from picles_tpu.parallel.sharded import ShardedWaveGrowth2D as JSharded
from picles_tpu.parallel.sharded import make_mesh as j_mesh
from picles_tpu.simulation import checkpoint as jck
from picles_tpu.simulation.simulation import Simulation as JSimulation

import picles_torch as pt
from picles_torch.ops import pic as tpic
from picles_torch.ops.pic_cuda import pic_gather_padded
from picles_torch.parallel import sharded as tsh

import _torch_sharded_worker as W

torch.set_num_threads(1)

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_sharded_worker.py")
WORLD = 8
METRICS = ("n_active", "n_gather", "n_failed")
PLANES = ("lne", "cgx", "cgy", "px", "py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker's cases once on 8 gloo ranks; returns (out dir,
    return codes, the ranks' output)."""
    out = tmp_path_factory.mktemp("torch_sharded")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(r), str(WORLD), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out, [p.returncode for p in procs], logs


def _result(ranks, name):
    out, codes, logs = ranks
    path = out / f"{name}.npz"
    if not path.exists():
        errs = "".join(e.read_text() for e in out.glob("*.err"))
        tails = "".join(f"--- rank {r} (rc {c})\n{so[-1500:]}{se[-3000:]}"
                        for r, (c, (so, se)) in enumerate(zip(codes, logs)))
        pytest.fail(f"the ranks left no result for {name}:\n{errs}\n{tails}")
    return np.load(path)


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process."""
    tsh.init_distributed(0, 1, "gloo", _free_port(), timeout_s=60.0)
    yield tsh.make_mesh((1, 1))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX twins of the worker's models
# ---------------------------------------------------------------------------


def _jsettings(adaptive=True, sub=1e-3, **tols):
    ws = jfr.MinimalWindsea(10.0, 10.0, W.DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=W.DT,
                     timestep=W.DT, total_time=6 * 24 * 3600.0, dt=sub,
                     dtmin=1e-4, force_dtmin=True, adaptive=adaptive, **tols)


def _jmodel(periodic=True, halo=3, sett=None, dtype=jnp.float32,
            tripolar=False, winds=None):
    grid = j_box(100e3, W.NX, 100e3, W.NY, dtype=dtype,
                 periodic_boundary=(periodic, periodic))
    if tripolar:
        grid = dataclasses.replace(grid, stats=dataclasses.replace(
            grid.stats, bx=JB.PERIODIC, by=JB.TRIPOLAR_NORTH))
    return JModel(grid, winds or j_constant(10.0, 5.0), sett or _jsettings(),
                  config=JConfig(periodic_boundary=periodic, halo=halo,
                                 dtype=dtype))


def _jax_sharded(jm, mesh, n=3):
    sh = JSharded(jm, j_mesh(shape=mesh))
    ms = sh.shard_state(jm.init_state())
    for _ in range(n):
        ms = sh.step(ms)
    return ms


def _steps(m, n=3):
    ms = m.init_state()
    for _ in range(n):
        ms = m.step(ms)
    return ms


def _check(got, want, rtol, atol=1e-10, patol=1e-6, what=""):
    """The gathered result ``got`` (the worker's npz) against a JAX or port
    state ``want``: node state (``atol``) and particle planes (``patol``),
    and the counters."""
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.testing.assert_allclose(got["state"], arr(want.state), rtol=rtol,
                               atol=atol, err_msg=f"{what} state")
    for k in PLANES:
        np.testing.assert_allclose(got[f"p_{k}"],
                                   arr(getattr(want.particles, k)),
                                   rtol=rtol, atol=patol,
                                   err_msg=f"{what} {k}")
    for k in METRICS:
        assert np.asarray(got[f"m_{k}"]).tolist() == \
            np.asarray(getattr(want.metrics, k)).tolist(), (what, k)


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", [3, ((0, 3), (0, 3)), ((1, 3), (0, 2))])
def test_padded_accumulate_matches_jax_kernel(halo):
    """K4's plain version (``pic.scatter_accumulate_padded``) against the
    TPU kernel's launcher ``scatter_padded_channels_pallas`` in interpret
    mode (rtol 1e-5, atol 1e-6 of the scale: another summation order) and
    JAX's ``scatter_accumulate_padded`` (the same sums, bit for bit); the K4
    wrapper refuses CPU tensors."""
    rng = np.random.default_rng(3)
    nx, ny = 12, 10
    (xl, xh), (yl, yh) = tpic.normalize_halo(halo)
    xr = rng.uniform(-xl - 0.4, xh + 0.4, (nx, ny)).astype(np.float32)
    yr = rng.uniform(-yl - 0.4, yh + 0.4, (nx, ny)).astype(np.float32)
    ch = rng.uniform(0.1, 1.0, (nx, ny, 3)).astype(np.float32)
    act = rng.random((nx, ny)) > 0.1
    T, tst = tpic.scatter_accumulate_padded(
        *(torch.as_tensor(a) for a in (xr, yr, ch, act)), halo)
    assert T.shape == (nx + xl + xh, ny + yl + yh, 3)
    J, jst = jpic.scatter_accumulate_padded(
        *(jnp.asarray(a) for a in (xr, yr, ch, act)), halo)
    np.testing.assert_array_equal(T.numpy(), np.asarray(J))
    K, kst = scatter_padded_channels_pallas(
        jnp.asarray(xr), jnp.asarray(yr),
        tuple(jnp.asarray(ch[..., c]) for c in range(3)), jnp.asarray(act),
        halo, interpret=True)
    for c in range(3):
        np.testing.assert_allclose(T[..., c].numpy(), np.asarray(K[c]),
                                   rtol=1e-5,
                                   atol=1e-6 * float(T[..., c].abs().max()))
    assert int(tst.clamped) == int(jst.clamped) == int(kst.clamped) > 0
    with pytest.raises(ValueError, match="not a CUDA device"):
        pic_gather_padded(torch.as_tensor(xr), torch.as_tensor(yr),
                          tuple(torch.as_tensor(ch[..., c]).contiguous()
                                for c in range(3)), torch.as_tensor(act),
                          halo)


# ---------------------------------------------------------------------------
# the collective deposit in isolation, 4 x 2 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(W.DEPOSIT_CASES)),
                         ids=[f"{b}-{h}" for b, h in W.DEPOSIT_CASES])
def test_collective_deposit_matches_jax(ranks, case):
    boundary, halo = W.DEPOSIT_CASES[case]
    r = _result(ranks, f"deposit_{case}")
    jm = _jmodel(periodic=boundary == "periodic", halo=halo,
                 tripolar=boundary == "tripolar")
    mesh = j_mesh(shape=(4, 2))
    jsh = JSharded(jm, mesh)
    ins = [jnp.asarray(r[k]) for k in ("xr", "yr", "ch", "act")]
    S_ref, _ = jpic.scatter_dense(*ins, jm.grid.stats, halo)

    def local(xr, yr, ch, act):
        return jsh._scatter_sharded(xr, yr, ch, act)[0]

    f = shard_map(local, mesh=mesh,
                  in_specs=(P("x", "y"), P("x", "y"), P("x", "y", None),
                            P("x", "y")),
                  out_specs=P("x", "y", None), check_vma=False)
    S_sh = jax.jit(f)(*ins)
    for what, ref in (("scatter_dense", S_ref), ("JAX sharded", S_sh)):
        np.testing.assert_allclose(r["S"], np.asarray(ref), rtol=2e-6,
                                   atol=2e-6, err_msg=what)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,periodic", W.STEP_CASES,
                         ids=[f"{m[0]}x{m[1]}-{'periodic' if p else 'open'}"
                              for m, p in W.STEP_CASES])
def test_sharded_step_matches_jax_and_single_device(ranks, mesh, periodic):
    r = _result(ranks, f"step_{mesh[0]}x{mesh[1]}_"
                       f"{'periodic' if periodic else 'open'}")
    _check(r, _jax_sharded(_jmodel(periodic=periodic), mesh), 5e-3,
           what="JAX sharded")
    _check(r, _steps(W.model(periodic=periodic)), 2e-3, what="port")


@pytest.mark.parametrize("mesh", W.ASYM_MESHES)
def test_sharded_asymmetric_halo(ranks, mesh):
    """Asymmetric halo bounds: the low and high slabs differ in width."""
    r = _result(ranks, f"asym_{mesh[0]}x{mesh[1]}")
    halo = ((1, 3), (0, 2))
    jms = _jax_sharded(_jmodel(halo=halo), mesh)
    _check(r, jms, 5e-3, what="JAX sharded")
    _check(r, _steps(W.model(halo=halo)), 2e-3, what="port")
    assert int(r["m_n_clamped"]) == int(jms.metrics.n_clamped)


def test_tripolar_seam_step_fixed_substep(ranks):
    """The full step with the north seam swapped in, across 4 x 2 blocks
    with an ((0,3),(0,3)) halo, fixed substeps, against the port's
    single-device step and JAX's sharded step."""
    r = _result(ranks, "tripolar_fixed")
    kw = dict(halo=((0, 3), (0, 3)), tripolar=True)
    _check(r, _steps(W.model(sett=W.settings(False, 60.0), **kw)), 1e-5,
           what="port")
    _check(r, _jax_sharded(_jmodel(sett=_jsettings(False, 60.0), **kw),
                           (4, 2)), 5e-5, what="JAX sharded")
    assert int(r["m_n_nan_reset"]) == 0 and int(r["m_n_gather"]) > 0


def test_fixed_substep_float64(ranks):
    """Fixed substeps in float64 over half-domain winds (so the blocks'
    states differ): the port's single-device step to rtol 1e-13, where an
    exchange fault would stand out by nine orders; JAX's sharded float64
    step to rtol 2e-5."""
    r = _result(ranks, "fixed_f64")
    assert r["state"].dtype == np.float64
    single = _steps(W.model(sett=W.settings(False, 60.0), dtype=torch.float64,
                            winds=pt.half_domain_winds(10.0, 5.0, 50e3)))
    _check(r, single, 1e-13, atol=1e-16, patol=1e-16, what="port float64")
    with jax.enable_x64(True):
        jms = _jax_sharded(_jmodel(sett=_jsettings(False, 60.0),
                                   dtype=jnp.float64,
                                   winds=j_half(10.0, 5.0, 50e3)), (4, 2))
        _check(r, jms, 2e-5, what="JAX sharded float64")
    # the calm half of the domain holds no active particles
    assert int(r["m_n_nan_reset"]) == 0
    assert 0 < int(r["m_n_active"]) < W.NX * W.NY


def test_world_size_one_equals_single_device(one_rank):
    """A (1, 1) mesh: the self-wrap folds in place of any message, bit for
    bit the single-device step; the counters through the all-reduce."""
    m = W.model(halo=((0, 3), (0, 3)))
    sh = tsh.ShardedWaveGrowth2D(m, one_rank)
    assert sh.transport == "gloo, staged through host memory"
    ms = sh.init_state()
    for _ in range(3):
        ms = sh.step(ms)
    single = _steps(m)
    for a, b in zip(ms.leaves(), single.leaves()):
        assert torch.equal(a, b)
    jref = _steps(_jmodel(halo=((0, 3), (0, 3))))
    np.testing.assert_allclose(ms.state.numpy(), np.asarray(jref.state),
                               rtol=5e-3, atol=1e-10)


def test_sharded_model_refusals(one_rank):
    with pytest.raises(ValueError, match="not divisible"):
        tsh.ShardedWaveGrowth2D(W.model(), tsh.Mesh((3, 1)))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tsh.make_mesh((2, 1))
    small = pt.WaveGrowth2D(
        pt.cartesian_box(1e3, 2, 1e3, 2, device="cpu",
                         periodic_boundary=(True, True)),
        pt.constant_winds(10.0, 5.0), W.settings())
    with pytest.raises(ValueError, match="wider than"):
        tsh.ShardedWaveGrowth2D(small, one_rank)
    fused = pt.WaveGrowth2D(
        pt.cartesian_box(100e3, 8, 100e3, 8, device="cpu",
                         periodic_boundary=(True, True)),
        pt.constant_winds(10.0, 5.0), W.settings(),
        config=pt.WaveGrowth2DConfig(dt_reset_mode="carry",
                                     remesh_mode="fused"))
    sh = tsh.ShardedWaveGrowth2D(fused, one_rank)
    with pytest.raises(ValueError, match="single-device only"):
        sh.step(sh.init_state())


def _jax_storm(remesh="xla"):
    """The worker's storm record and gridded model in the JAX package."""
    from picles_tpu.forcing.winds import GriddedWinds2D as JGridded

    u, v, kw = W.storm_record()
    jg = JGridded(u_data=jnp.asarray(u), v_data=jnp.asarray(v), **kw)
    return JModel(j_box(100e3, W.NX, 100e3, W.NY,
                        periodic_boundary=(True, True)),
                  jg.as_winds(), _jsettings(**W.GRIDDED_TOLS),
                  config=JConfig(periodic_boundary=True, halo=3,
                                 dt_reset_mode="carry", remesh_mode=remesh))


@pytest.mark.parametrize("remesh", W.GRIDDED_REMESH)
def test_sharded_gridded_winds(ranks, remesh):
    """A gridded record whose storm crosses the block edges, turning, over
    a (4, 2) mesh (carried dt, halo 3, the gridded tests' solver
    tolerances), under the "pallas" remesh (K5's plain version on the CPU)
    and the "xla" one: the port's single-device step at rtol 2e-3 and JAX's
    sharded step (its "xla" remesh, the same branch table) at rtol 5e-3,
    the file's bounds."""
    r = _result(ranks, f"gridded_{remesh}")
    _check(r, _steps(W.gridded_model(remesh)), 2e-3, what="port")
    _check(r, _jax_sharded(_jax_storm(), (4, 2)), 5e-3, what="JAX sharded")
    assert int(r["m_n_gather"]) > 0 and int(r["m_n_failed"]) == 0


def test_sharded_layered(ranks):
    """``tests/test_layers.py``'s layered sharded case (L = 3 swell systems,
    16^2, mesh (4, 2), two steps): the port's single-device ``step_layers``
    at rtol 2e-3 and JAX's layered sharded step at rtol 5e-3, the counters
    of every layer equal."""
    import test_layers as tl

    r = _result(ranks, "layered")
    assert r["state"].shape == (W.LAYERS, W.LAYERED_N, W.LAYERED_N, 3)
    m = W.layered_model()
    ms = m.init_state_layers(W.swell_defaults(W.LAYERS))
    for _ in range(2):
        ms = m.step_layers(ms)
    _check(r, ms, 2e-3, what="port")
    jm = tl._model(W.LAYERS, n=W.LAYERED_N)
    jsh = JSharded(jm, j_mesh(shape=(4, 2)))
    jms = jsh.shard_state(jm.init_state_layers(
        tl._swell_defaults(W.LAYERS)))
    for _ in range(2):
        jms = jsh.step(jms)
    _check(r, jms, 5e-3, what="JAX sharded")


def test_world_size_one_layered_equals_single_device(one_rank):
    """A layered (1, 1) mesh: bit for bit the single-device layered step,
    the [L] counters through the all-reduces."""
    m = W.layered_model()
    sh = tsh.ShardedWaveGrowth2D(m, one_rank)
    assert sh.layers == W.LAYERS
    ms0 = m.init_state_layers(W.swell_defaults(W.LAYERS))
    ms, single = sh.shard_state(ms0), ms0
    for _ in range(2):
        ms, single = sh.step(ms), m.step_layers(single)
    for a, b in zip(ms.leaves(), single.leaves()):
        assert torch.equal(a, b)
    assert tuple(ms.metrics.n_gather.shape) == (W.LAYERS,)
    whole = sh.gather_state(ms)
    assert torch.equal(whole.state, single.state)


@pytest.mark.parametrize("remesh", W.GRIDDED_REMESH)
def test_world_size_one_gridded_equals_single_device(one_rank, remesh):
    """The gridded storm on a (1, 1) mesh: the block-local wind planes and
    the self-wrap folds bit for bit the single-device step, its counters
    too (the plain deposit on both sides, one sum order)."""
    m = W.gridded_model(remesh)
    sh = tsh.ShardedWaveGrowth2D(m, one_rank)
    ms, single = sh.init_state(), m.init_state()
    for _ in range(3):
        ms, single = sh.step(ms), m.step(single)
    for a, b in zip(ms.leaves(), single.leaves()):
        assert torch.equal(a, b)
    assert int(ms.metrics.n_gather) > 0


# ---------------------------------------------------------------------------
# spherical and tripolar grids
# ---------------------------------------------------------------------------


def _jax_sphere():
    """The worker's spherical model in the JAX package."""
    from picles_tpu.grids.spherical import spherical_grid_2d as j_sphere

    grid = j_sphere(0.0, 40.0, W.NX, 30.0, 60.0, W.NY,
                    periodic_boundary=(True, False))
    return JModel(grid, j_constant(10.0, 5.0), _jsettings(False, 60.0),
                  config=JConfig(periodic_boundary=False))


def _jax_tripolar(halo, sett):
    """The worker's scaled tripolar model in the JAX package, from the same
    supergrid arrays and mask."""
    from picles_tpu.grids.tripolar import mom6_grid_from_supergrid as j_mom6

    grid = j_mom6(*W.tripolar_supergrid(), 2, mask=W.tripolar_mask())
    return JModel(grid, j_constant(2.0, 10.0), sett,
                  config=JConfig(periodic_boundary=True, halo=halo))


def test_sharded_spherical_fixed_substep(ranks):
    """tests/test_sharded.py:393-419 on the port: per-node projection
    planes cut per block, the open-y drop, fixed substeps, mesh (4, 2), 3
    steps."""
    r = _result(ranks, "sphere_fixed")
    single = W.spherical_model()
    assert single.uniform_proj is None   # per-node planes
    _check(r, _steps(single), 2e-6, atol=1e-9, what="port")
    _check(r, _jax_sharded(_jax_sphere(), (4, 2)), 5e-5, what="JAX sharded")
    assert int(r["m_n_gather"]) > 0


@pytest.mark.parametrize("tag", list(W.TRI_HALOS))
def test_sharded_tripolar_grid_fixed_substep(ranks, tag):
    """The scaled synthetic tripolar grid over a (4, 2) mesh, fixed
    substeps (20 s), 4 steps: per-block projection planes, the seam fold
    spread over the top row of blocks (a gather along x), land on the top
    row; the port's single-device step at rtol 1e-5 and JAX's sharded step
    at rtol 5e-5, no lane reseeded by a guard, the land nodes off the
    active set.  Halo 3 clamps no displacement; the (0, 3) x halo clamps
    the westward lanes of the rotated rows (10) as JAX's does."""
    r = _result(ranks, f"tripolar_grid_{tag}")
    halo = W.TRI_HALOS[tag]
    single = W.tripolar_model(halo, W.settings(False, W.TRI_SUB))
    assert single.grid.stats.by == pt.Boundary.TRIPOLAR_NORTH
    _check(r, _steps(single, W.TRI_STEPS), 1e-5, what="port")
    jms = _jax_sharded(_jax_tripolar(halo, _jsettings(False, W.TRI_SUB)),
                       (4, 2), W.TRI_STEPS)
    _check(r, jms, 5e-5, what="JAX sharded")
    for k in ("n_failed", "n_nan_reset", "n_inf_reset"):
        assert int(r[f"m_{k}"]) == 0, k
    assert int(r["m_n_clamped"]) == int(jms.metrics.n_clamped)
    if tag == "h3":
        assert int(r["m_n_clamped"]) == 0
    land = list(W.TRI_LAND_X)
    assert not single.active_mask[land, -1].any()
    assert int(r["m_n_active"]) == int(single.active_mask.sum())


def test_tripolar_seam_fold_moves_energy(ranks):
    """The witness that the seam cases test the fold: the same run with the
    fold left out holds other energy on the top row."""
    r = _result(ranks, "tripolar_grid_h03")
    nf = _result(ranks, "tripolar_grid_nofold")
    top, top_nf = r["state"][:, -1, 0], nf["state"][:, -1, 0]
    assert np.abs(top - top_nf).max() > 0.1 * np.abs(top).max()
    # below the rows the fold and its effects reach, nothing changes
    np.testing.assert_array_equal(r["state"][:, :W.NY - 4 * W.TRI_STEPS],
                                  nf["state"][:, :W.NY - 4 * W.TRI_STEPS])


def test_sharded_tripolar_grid_adaptive(ranks):
    """The scaled tripolar grid under the adaptive controller at abstol
    1e-7 / reltol 1e-6, 4 steps: the port's single-device step at rtol 2e-3
    and JAX's sharded step at rtol 5e-3, the counters equal."""
    r = _result(ranks, "tripolar_adaptive")
    halo = W.TRI_HALOS["h03"]
    _check(r, _steps(W.tripolar_model(halo, W.settings(**W.GRIDDED_TOLS)),
                     W.TRI_STEPS), 2e-3, what="port")
    jms = _jax_sharded(_jax_tripolar(halo, _jsettings(**W.GRIDDED_TOLS)),
                       (4, 2), W.TRI_STEPS)
    _check(r, jms, 5e-3, what="JAX sharded")
    assert int(r["m_n_failed"]) == 0 and int(r["m_n_nan_reset"]) == 0
    # westward lanes of the rotated rows meet the (0, 3) x halo's floor
    assert int(r["m_n_clamped"]) == int(jms.metrics.n_clamped)


def test_world_size_one_tripolar_equals_single_device(one_rank):
    """The scaled tripolar grid on a (1, 1) mesh (the seam fold on the one
    block's own top halo): bit for bit the single-device step, adaptive."""
    m = W.tripolar_model(W.TRI_HALOS["h03"], W.settings(**W.GRIDDED_TOLS))
    sh = tsh.ShardedWaveGrowth2D(m, one_rank)
    ms, single = sh.init_state(), m.init_state()
    for _ in range(W.TRI_STEPS):
        ms, single = sh.step(ms), m.step(single)
    for a, b in zip(ms.leaves(), single.leaves()):
        assert torch.equal(a, b)
    assert int(ms.metrics.n_gather) > 0


def test_ring_perm_matches_jax():
    from picles_tpu.parallel.sharded import _ring_perm as j_perm

    for n in (1, 2, 4):
        for wrap in (True, False):
            for rev in (True, False):
                assert tsh._ring_perm(n, wrap, rev) == j_perm(n, wrap, rev)


# ---------------------------------------------------------------------------
# Simulation.run over the sharded model
# ---------------------------------------------------------------------------


def test_simulation_cash_store_matches_single_device(ranks):
    """Rank 0's CashStore of a sharded run, frame by frame, against the
    single-device runs of the port and of JAX (rtol 5e-3: four adaptive
    steps, tests/test_sharded.py:444)."""
    r = _result(ranks, "simulation")
    sim = pt.Simulation.create(W.model(), stop_time=1800.0)
    sim.run(cash_store=True)
    jsim = JSimulation.create(_jmodel(), stop_time=1800.0)
    jsim.run(cash_store=True)
    assert r["frames"].shape == (5, W.NX, W.NY, 3)
    for what, ref in (("port", sim.store.as_array()),
                      ("JAX", jsim.store.as_array())):
        assert ref.shape == r["frames"].shape
        np.testing.assert_allclose(r["frames"], ref, rtol=5e-3, atol=1e-10,
                                   err_msg=what)
    np.testing.assert_array_equal(r["frames"][-1], r["quiet_state"])


def test_sharded_checkpoint_loads_everywhere_and_resumes(ranks):
    """The sharded checkpoint is the single-device file: it loads in the
    port and in JAX's ``load_checkpoint`` to the gathered state bit for
    bit, and the sharded run resumed from it equals the uninterrupted one
    bit for bit; a single-device port run resumes from it too."""
    r = _result(ranks, "simulation")
    ck = str(r["ck"])
    got = pt.load_checkpoint(ck, device="cpu")
    np.testing.assert_array_equal(got.state.numpy(), r["quiet_state"])
    for k in pt.convert.PARTICLE_FIELDS:
        np.testing.assert_array_equal(getattr(got.particles, k).numpy(),
                                      r[f"quiet_p_{k}"])
    assert int(got.iteration) == 4 and float(got.time) == 2400.0
    jgot = jck.load_checkpoint(ck)
    np.testing.assert_array_equal(np.asarray(jgot.state), r["quiet_state"])
    np.testing.assert_array_equal(np.asarray(jgot.particles.lne),
                                  r["quiet_p_lne"])
    for k in r.files:
        if k.startswith("resumed_"):
            np.testing.assert_array_equal(r[k], r["full_" + k[8:]], k)
    assert int(r["resumed_iteration"]) == 7
    single = pt.Simulation.create(W.model(), stop_time=3600.0)
    single.pickup(ck)
    single.run()
    np.testing.assert_allclose(single.state.state.numpy(), r["resumed_state"],
                               rtol=2e-3, atol=1e-10)
