"""A wind given as a steady callable: the node kind of the kernels (CPU).

- The probe (``forcing.winds.steady_node_planes``) calls ``u`` and ``v``
  once with a 0-dim probe time under a ``TorchFunctionMode``: a callable in
  which the time enters no torch operation is steady, and its values at the
  nodes are the kernels' two node planes; any use of the time (arithmetic,
  comparisons, ``torch.where``, ``float(t)``, ``t.item()``) marks it as
  time-dependent.
- ``node_plane_winds`` (the kernels' plain version) equals the callable bit
  for bit at the nodes, and a plain step over it equals the plain step over
  the callable bit for bit.
- Example 02's configuration (the 32 x 24 synthetic tripolar grid, the
  zonal jet at 40N, DT = 1200 s, the carried dt): the port's plain step
  against JAX's step with its Pallas kernels in interpret mode (advance,
  dense deposit, the remesh "pallas" or "fused"), at solver tolerances
  abstol 1e-7 / reltol 1e-6, within 1e-4 of the state's largest value
  (the adaptive controller turns last-ulp differences of the two libraries'
  exp into other substep paths, ROADMAP queue 3), every counter equal (the
  most substeps a lane took within 1), and no guard fired: no NaN or Inf
  reset, no energy clamp, no failed lane.
- The sharded step on a (1, 1) mesh (a gloo group of one rank in this
  process) forms its block's node planes and equals the single-device step
  bit for bit; per-layer jets (``LayeredWaveGrowth2D``) each form their own
  planes and step like JAX's per-layer models.
"""

import dataclasses
import socket

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
from picles_tpu.models.wave_growth_2d import LayeredWaveGrowth2D as JLayered
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig

import picles_torch as pt
from picles_torch import convert
from picles_torch.forcing import winds as tw
from picles_torch.models import wave_growth_2d as twg
from picles_torch.parallel import sharded as tsh
from test_torch_model_2d import COUNTERS, state_of

torch.set_num_threads(1)

DT = 1200.0
TOLS = dict(abstol=1e-7, reltol=1e-6)
GAP = 1e-4
GUARDS = ("n_failed", "n_nan_reset", "n_inf_reset", "n_emax_clamp")


def t_jet(x, y, t):
    """Example 02's zonal jet (the port's form)."""
    return 12.0 * torch.exp(-(((y - 40.0) / 20.0) ** 2))


def t_calm(x, y, t):
    return torch.zeros_like(x)


def j_jet(x, y, t):
    """Example 02's zonal jet (the JAX example's form)."""
    return 12.0 * jnp.exp(-(((jnp.asarray(y) - 40.0) / 20.0) ** 2))


def j_calm(x, y, t):
    return jnp.zeros_like(jnp.asarray(x))


def t_south_jet(x, y, t):
    return 9.0 * torch.exp(-(((y + 45.0) / 15.0) ** 2))


def j_south_jet(x, y, t):
    return 9.0 * jnp.exp(-(((jnp.asarray(y) + 45.0) / 15.0) ** 2))


def _nodes(n=(6, 5)):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 360, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-80, 80, n).astype(np.float32))
    return x, y


STEADY = {
    "y-only jet": (t_jet, t_calm),
    "constant lambda": (lambda x, y, t: torch.full_like(x, 10.0),
                        lambda x, y, t: torch.full_like(x, 5.0)),
    "x and y": (lambda x, y, t: 3.0 * torch.sin(torch.deg2rad(x)) + 0.1 * y,
                lambda x, y, t: torch.cos(torch.deg2rad(y)) * x / 36.0),
    "python float": (lambda x, y, t: 7.0, t_calm),
}


@pytest.mark.parametrize("name", list(STEADY))
def test_probe_takes_steady_callables(name):
    u, v = STEADY[name]
    x, y = _nodes()
    planes = tw.steady_node_planes(pt.Winds2D(u=u, v=v), x, y)
    assert planes is not None
    assert planes.shape == (2, 6, 5) and planes.dtype == torch.float32
    assert planes.is_contiguous()
    t = torch.full_like(x, 5400.0)
    for p, f in zip(planes, (u, v)):
        assert torch.equal(p, torch.broadcast_to(
            torch.as_tensor(f(x, y, t), dtype=torch.float32), x.shape))


def _growing_decaying_u(x, y, t):
    """tests/test_growing_decaying_winds.py:74's callable: calm until 1 h,
    then 12 m/s."""
    return torch.where(torch.as_tensor(t) >= 3600.0, 12.0, 0.0) + 0.0 * x


_COSINE = pt.time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)
TIMED = {
    "time_cosine stripped": (_COSINE.u, _COSINE.v),
    "where(t > t_off)": (lambda x, y, t: torch.where(t > 1800.0, 0.0, 10.0)
                         + 0.0 * x, t_calm),
    "float(t)": (lambda x, y, t: torch.full_like(x, 10.0 + float(t)), t_calm),
    "t.item()": (lambda x, y, t: torch.full_like(x, 10.0 * t.item()),
                 t_calm),
    "0 * t": (lambda x, y, t: 0.0 * t + torch.full_like(x, 10.0), t_calm),
    "t.cpu()": (lambda x, y, t: x * 0.0 + t.cpu(), t_calm),
    "growing/decaying": (_growing_decaying_u, t_calm),
    "v reads t": (t_jet, lambda x, y, t: torch.full_like(x, 1.0) * (t < 60)),
}


@pytest.mark.parametrize("name", list(TIMED))
def test_probe_refuses_time_dependent_callables(name):
    u, v = TIMED[name]
    x, y = _nodes()
    assert tw.steady_node_planes(pt.Winds2D(u=u, v=v), x, y) is None


def test_node_plane_winds_equal_the_callable_bitwise():
    """At the nodes ``node_plane_winds`` returns the callable's values bit
    for bit at any time, as the kernels' plain versions need; its
    descriptor is the node kind."""
    g = pt.synthetic_tripolar_grid(k=2, device="cpu")
    w = pt.Winds2D(u=t_jet, v=t_calm)
    planes = tw.steady_node_planes(w, g.x, g.y)
    nw = pt.node_plane_winds(*planes)
    assert nw.kernel.kind == pt.WindKind.NODE
    for t in (0.0, 1200.0, 86400.0):
        tt = torch.full_like(g.x, t)
        assert torch.equal(nw.u(g.x, g.y, tt), w.u(g.x, g.y, tt))
        assert torch.equal(nw.v(g.x, g.y, tt), w.v(g.x, g.y, tt))


def _settings():
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                     dtmin=1e-4, force_dtmin=True, **TOLS)


def _port(jm, grid, winds, **cfg):
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    return pt.WaveGrowth2D(grid, winds, sett, ode_params=params,
                           constants=cid, config=pt.WaveGrowth2DConfig(
                               periodic_boundary=True, **cfg))


def _step_both(jstep, tstep, jms, tms, steps, smax_slack=1):
    for k in range(steps):
        jms, tms = jstep(jms), tstep(tms)
        S, J = tms.state.numpy(), np.asarray(jms.state)
        assert np.isfinite(S).all(), f"step {k}"
        err = float(np.abs(S - J).max() / np.abs(J).max())
        assert err <= GAP, f"step {k}: {err:.3e} of the state's scale"
        got = tms.metrics.as_dict()
        for c in COUNTERS:
            slack = smax_slack if c == "substeps_max" else 0
            assert np.all(np.abs(np.asarray(got[c]) - np.asarray(
                getattr(jms.metrics, c))) <= slack), f"{c} at step {k}"
        for c in GUARDS:
            assert np.all(np.asarray(got[c]) == 0), f"{c} fired at step {k}"
        assert int(np.sum(got["n_gather"])) > 0
    return jms, tms


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_example_02_jet_matches_jax_pallas_kernels(remesh):
    """Example 02's tripolar jet, 3 steps: JAX's Pallas advance, deposit and
    remesh (interpret mode) against the port's plain step (the kernel remesh
    modes run their plain versions on CPU tensors)."""
    jg = jtri.synthetic_tripolar_grid(k=2)
    tg = pt.synthetic_tripolar_grid(k=2, device="cpu")
    assert (tg.nx, tg.ny) == (32, 24)
    jm = JModel(jg, jw.Winds2D(u=j_jet, v=j_calm), _settings(),
                config=JConfig(periodic_boundary=True, advance_mode="pallas",
                               scatter_mode="dense_pallas",
                               dt_reset_mode="carry", remesh_mode=remesh,
                               pallas_interpret=True))
    tm = _port(jm, tg, pt.Winds2D(u=t_jet, v=t_calm), dt_reset_mode="carry",
               remesh_mode=remesh)
    assert tm.resolved_config().advance_mode == "torch"
    jms = jm.init_state()
    tms = tm.init_state()
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-6, atol=1e-12)
    _, tms = _step_both(jax.jit(jm.step), tm.step, jms, state_of(jms), 3)
    e = tms.state[..., 0].numpy()
    lat, mask = tg.y.numpy(), tg.mask.numpy()
    assert (e[mask == 0] == 0).all()
    jet = (lat > 25) & (lat < 55) & (mask == 1)
    calm = (lat < -20) & (mask == 1)
    assert e[jet].mean() > 10 * max(e[calm].mean(), 1e-12)


def test_plain_step_over_node_planes_equals_the_callable_bitwise():
    """The kernels' plain version of the node kind: 3 plain steps over
    ``node_plane_winds`` of the jet's planes equal 3 over the callable."""
    g = pt.synthetic_tripolar_grid(k=2, device="cpu")
    sett = convert.settings_from_values(_settings())[0]
    cfg = pt.WaveGrowth2DConfig(periodic_boundary=True)
    a = pt.WaveGrowth2D(g, pt.Winds2D(u=t_jet, v=t_calm), sett, config=cfg)
    planes = a.node_planes(g)
    b = pt.WaveGrowth2D(g, pt.node_plane_winds(*planes), sett, config=cfg)
    sa, sb = a.init_state(), b.init_state()
    for _ in range(3):
        sa, sb = a.step(sa), b.step(sb)
    for x, y in zip(sa.leaves(), sb.leaves()):
        assert torch.equal(x, y)


def test_model_forms_node_planes_once_per_grid(monkeypatch):
    """With the modes resolved to the kernels (as on a card) the model
    probes the jet at construction: the node kind, the planes kept for its
    grid (in ``graph_keep``) and formed anew for another grid (a sharded
    block), the same object on a second call."""
    monkeypatch.setattr(twg, "resolve_modes", lambda cfg, device:
                        dataclasses.replace(cfg, advance_mode="cuda",
                                            scatter_mode="dense_cuda"))
    g = pt.synthetic_tripolar_grid(k=2, device="cpu")
    m = pt.WaveGrowth2D(g, pt.Winds2D(u=t_jet, v=t_calm), pt.ODESettings(),
                        config=pt.WaveGrowth2DConfig(periodic_boundary=True))
    assert m.winds.kernel.kind == pt.WindKind.NODE
    assert m.remesh_params.winds.kernel.kind == pt.WindKind.NODE
    planes = m.node_planes(g)
    assert planes.shape == (2, 32, 24) and planes.is_contiguous()
    assert torch.equal(planes[0], t_jet(g.x, g.y, None))
    assert any(c is not None and c[1] is planes for c in m.graph_keep())
    u, v = m.wind_fields(g, torch.zeros(()))
    assert u.data_ptr() == planes.data_ptr()
    block = tsh.slice_grid(g, slice(16, 32), slice(0, 12))
    bp = m.node_planes(block)
    assert torch.equal(bp, planes[:, 16:32, 0:12])
    assert m.node_planes(block) is bp
    # a callable that reads its time is traced; an indexed captured table
    # (a record in disguise) is refused
    timed = pt.WaveGrowth2D(g, pt.Winds2D(u=_growing_decaying_u, v=t_calm),
                            pt.ODESettings(),
                            config=pt.WaveGrowth2DConfig(
                                periodic_boundary=True))
    assert timed.winds.kernel.kind == pt.WindKind.TRACED
    table = torch.arange(24.0)
    with pytest.raises(NotImplementedError, match="aten op"):
        pt.WaveGrowth2D(g, pt.Winds2D(
            u=lambda x, y, t: 0.0 * x + table[(t / 3600.0).to(torch.int64)],
            v=t_calm), pt.ODESettings(),
            config=pt.WaveGrowth2DConfig(periodic_boundary=True))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process."""
    tsh.init_distributed(0, 1, "gloo", _free_port(), timeout_s=60.0)
    yield tsh.make_mesh((1, 1))
    dist.destroy_process_group()


def test_sharded_one_rank_jet_equals_single_device(one_rank):
    """The jet on a (1, 1) mesh, the plain deposit on both sides: the
    block's node planes are the grid's, and 3 sharded steps equal 3
    single-device steps bit for bit (the self-wrap and seam folds in place
    of any message)."""
    g = pt.synthetic_tripolar_grid(k=2, device="cpu")
    sett = convert.settings_from_values(_settings())[0]
    m = pt.WaveGrowth2D(g, pt.Winds2D(u=t_jet, v=t_calm), sett,
                        config=pt.WaveGrowth2DConfig(periodic_boundary=True,
                                                     dt_reset_mode="carry",
                                                     remesh_mode="pallas"))
    sh = pt.ShardedWaveGrowth2D(m, one_rank)
    assert torch.equal(m.node_planes(sh.local_grid), m.node_planes(g))
    ms, single = sh.init_state(), m.init_state()
    for _ in range(3):
        ms, single = sh.step(ms), m.step(single)
    for a, b in zip(ms.leaves(), single.leaves()):
        assert torch.equal(a, b)
    assert int(ms.metrics.n_gather) > 0 and int(ms.metrics.n_failed) == 0


def test_per_layer_jets_match_jax():
    """Two layers on the tripolar grid (the carried dt), each forced by its
    own jet (the north and the south jet of the global demo): each layer
    model keeps its own node planes, and 2 layered steps agree with JAX's
    per-layer models within 1e-4 of the state's scale, counters equal but
    the most substeps a lane took (within 2: the south jet's exp parts by
    an ulp between the libraries, and the first step from dt = 1e-3 takes
    64 substeps), no guard fired."""
    jg = jtri.synthetic_tripolar_grid(k=2)
    tg = pt.synthetic_tripolar_grid(k=2, device="cpu")
    jm = JModel(jg, jw.Winds2D(u=j_jet, v=j_calm), _settings(),
                config=JConfig(periodic_boundary=True, layers=2,
                               dt_reset_mode="carry"))
    jl = JLayered(jm, per_layer_winds=[jw.Winds2D(u=j_jet, v=j_calm),
                                       jw.Winds2D(u=j_south_jet, v=j_calm)])
    tm = _port(jm, tg, pt.Winds2D(u=t_jet, v=t_calm), layers=2,
               dt_reset_mode="carry")
    tl = pt.LayeredWaveGrowth2D(tm, per_layer_winds=[
        pt.Winds2D(u=t_jet, v=t_calm), pt.Winds2D(u=t_south_jet, v=t_calm)])
    north, south = (lm.node_planes(tg) for lm in tl.layer_models)
    assert not torch.equal(north, south)
    assert torch.equal(south[0], t_south_jet(tg.x, tg.y, None))
    jms = jl.init_state()
    tms = tl.init_state()
    # the seeds' windsea of the two libraries' exp of the jets, an ulp apart
    np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                               rtol=1e-5, atol=1e-12)
    _step_both(jax.jit(jl.step), tl.step, jms, state_of(jms), 2,
               smax_slack=2)
