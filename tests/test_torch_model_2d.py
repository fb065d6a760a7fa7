"""The WaveGrowth2D step as a whole: the PyTorch port (plain versions on the
CPU) against the JAX package, from the identical state carried across by
``picles_torch.convert``.

Tolerances: on the golden configuration rtol 1e-3 per step on every lane
whose substep path (accepted and rejected substeps) is the JAX package's in
that step and the step before, and the cross-backend bound 5e-3 on the
lanes where it is not (adaptive solver: the error controller turns
last-ulp differences of the two libraries into other substep paths;
measured on the CPU, after step 1 the states differ by at most 3.8e-6 in
lne, and in step 2 the 31 lanes of row 0 and column 0 reject another
number of substeps than JAX does and depart by up to 1.8e-3 at steps 2-3,
back within 5e-5 from step 5); the golden values themselves at the JAX
suite's cross-backend bound; rtol 1e-5 in fixed-substep mode; counters
exactly equal."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_golden_regression as tgr
from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.ops.rhs import RHSParams as JRHSParams
from picles_tpu.ops.tsit5 import integrate_to as j_integrate_to

import picles_torch as pt
from picles_torch import convert
from picles_torch.models import wave_growth_2d as twg
from picles_torch.ops.tsit5 import integrate_to as t_integrate_to

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("n_active", "n_failed", "n_nan_reset", "n_inf_reset",
            "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
            "n_clamped", "substeps_max")


def port_of(jm, winds, **kw):
    """The port's model of a JAX model: same grid, parameters, term flags
    and config (the grid in the config's dtype); ``kw`` goes to
    ``WaveGrowth2D`` (``minimal_state`` and the like)."""
    g = jm.grid
    cfg = convert.config_from_jax(jm.config)
    grid = convert.grid_from_numpy(
        {f: np.asarray(getattr(g, f)) for f in convert.GRID_FIELDS}, g.stats,
        device="cpu", dtype=cfg.dtype)
    sett, params, cid = convert.settings_from_values(jm.settings, jm.params,
                                                     jm.constants)
    tm = pt.WaveGrowth2D(grid, winds, sett, ode_params=params, constants=cid,
                         flags=convert.flags_from_jax(jm.flags), config=cfg,
                         **kw)
    return tm


def state_of(jms, dtype=torch.float32):
    P = jms.particles
    return convert.state_from_numpy(
        np.asarray(jms.state),
        {k: np.asarray(getattr(P, k)) for k in convert.PARTICLE_FIELDS},
        np.asarray(jms.time), np.asarray(jms.iteration), device="cpu",
        dtype=dtype)


def assert_counters_equal(tms, jms, step):
    got = tms.metrics.as_dict()
    for k in COUNTERS:
        assert got[k] == int(getattr(jms.metrics, k)), f"{k} at step {step}"


def substep_paths_differ(jm, jms, tm, tms):
    """Lanes whose next advance takes another number of accepted or rejected
    substeps in the port than in the JAX package, each side on its own
    state."""
    P, Q = jms.particles, tms.particles
    g, DT = jm.grid, jm.settings.timestep
    jr = j_integrate_to(
        jm.rhs, jax.numpy.stack([P.lne, P.cgx, P.cgy, P.px, P.py], -1), P.t,
        P.t + DT, P.dt, JRHSParams(x=g.x, y=g.y, M=g.proj, pc=g.pc),
        P.on & jm.active_mask, jm.solver)
    tr = t_integrate_to(
        tm.rhs, torch.stack([Q.lne, Q.cgx, Q.cgy, Q.px, Q.py], -1), Q.t,
        Q.t + DT, Q.dt, tm.aux, Q.on & tm.active_mask, tm.solver)
    return ((tr.naccept.numpy() != np.asarray(jr.naccept))
            | (tr.nreject.numpy() != np.asarray(jr.nreject)))


def test_golden_config_steps_like_jax(monkeypatch):
    jm = tgr._model()
    tm = port_of(jm, pt.constant_winds(10.0, 10.0))
    assert tm.resolved_config().advance_mode == "torch"
    assert tm.resolved_config().scatter_mode == "dense"
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = state_of(jms)
    # the port's own seeding matches the JAX seeding
    np.testing.assert_allclose(tm.init_state().state.numpy(),
                               np.asarray(jms.state), rtol=1e-6, atol=1e-12)
    # the cross-backend bound of the JAX suite's tolerance policy
    monkeypatch.setattr(tgr, "GOLDEN_BACKEND", "another backend")
    rtol_golden = tgr._rtols({})
    assert rtol_golden == 5e-3
    n = jms.state.shape[0]
    differ_before = np.zeros((n, n), dtype=bool)
    exempted = 0
    for k in range(1, max(tgr.GOLDEN) + 1):
        differ = substep_paths_differ(jm, jms, tm, tms)
        jms, tms = jstep(jms), tm.step(tms)
        # a lane that took another path departs in this step and the next
        exempt = differ | differ_before
        differ_before = differ
        exempted = max(exempted, int(exempt.sum()))
        if k in (1, 3, 6):
            same = ~exempt
            S, J = tms.state.numpy(), np.asarray(jms.state)
            np.testing.assert_allclose(S[same], J[same], rtol=1e-3, atol=1e-9,
                                       err_msg=f"step {k}")
            np.testing.assert_allclose(S, J, rtol=rtol_golden, atol=1e-9,
                                       err_msg=f"step {k}, every lane")
            np.testing.assert_allclose(S[..., 0].sum(), J[..., 0].sum(),
                                       rtol=1e-3, err_msg=f"sum E at {k}")
            for f in ("lne", "cgx", "cgy"):
                a = getattr(tms.particles, f).numpy()
                b = np.asarray(getattr(jms.particles, f))
                np.testing.assert_allclose(a[same], b[same], rtol=1e-3,
                                           atol=1e-6, err_msg=f"{f} at {k}")
                np.testing.assert_allclose(a, b, rtol=rtol_golden, atol=1e-6,
                                           err_msg=f"{f} at {k}, every lane")
            assert_counters_equal(tms, jms, k)
        if k in tgr.GOLDEN:
            e, mx, my, sumE = tgr.GOLDEN[k]
            S = tms.state.numpy()
            np.testing.assert_allclose(S[8, 8], (e, mx, my), rtol=rtol_golden)
            np.testing.assert_allclose(S[..., 0].sum(), sumE,
                                       rtol=rtol_golden)
    # at most one row and one column of lanes ever leave the JAX path
    assert exempted <= 2 * n - 1, exempted
    assert int(tms.iteration) == max(tgr.GOLDEN)
    np.testing.assert_allclose(float(tms.time), float(jms.time))


def _fixed_substep_models(n=12):
    DT = 600.0
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    sett = JSettings(log_energy_minimum=float(ws.lne), timestep=DT,
                     dt=37.5, dtmin=1e-4, adaptive=False)
    jm = JModel(j_box(100e3, n, 100e3, n, periodic_boundary=(True, True)),
                jw.time_cosine_winds(10.0, 5.0, 6 * 3600.0), sett,
                config=JConfig(periodic_boundary=True))
    return jm, port_of(jm, pt.time_cosine_winds(10.0, 5.0, 6 * 3600.0))


def test_fixed_substep_run_matches_tightly():
    jm, tm = _fixed_substep_models()
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = state_of(jms)
    for k in range(3):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                                   rtol=1e-5, atol=1e-10, err_msg=f"step {k}")
        assert_counters_equal(tms, jms, k)
    # fixed-substep mode carries the configured sub-step unclipped
    np.testing.assert_array_equal(tms.particles.dt.numpy(),
                                  np.asarray(jms.particles.dt))


def test_flagship_config_matches_at_32():
    """bench.py's production configuration (bosh3, carried dt, directional
    halo) at 32^2, plain XLA/PyTorch paths on both sides."""
    import bench

    jm = bench.build(32, 32, advance_mode="xla")
    assert jm.config.scatter_mode == "dense"
    tm = port_of(jm, pt.constant_winds(10.0, 10.0))
    assert tm.config.halo == ((0, 3), (0, 3))
    assert tm.config.dt_reset_mode == "carry"
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = state_of(jms)
    for k in range(3):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                                   rtol=1e-3, atol=1e-9, err_msg=f"step {k}")
        assert_counters_equal(tms, jms, k)
    assert int(tms.metrics.n_clamped) == 0 and int(tms.metrics.n_failed) == 0


def test_step_is_bitwise_deterministic_and_drivers_agree():
    jm = tgr._model()
    tm = port_of(jm, pt.constant_winds(10.0, 10.0))
    a, b = tm.init_state(), tm.init_state()
    for _ in range(3):
        a, b = tm.step(a), tm.step(b)
    assert torch.equal(a.state, b.state)
    assert torch.equal(a.particles.lne, b.particles.lne)
    c, stack = tm.step_n(tm.init_state(), 3)
    assert torch.equal(c.state, a.state) and stack.shape == (3, 16, 16, 3)
    assert torch.equal(stack[-1], a.state)
    d, buf = tm.step_n_buffered(tm.init_state(), 2, 4)
    assert torch.equal(buf[1], stack[1]) and not buf[2:].any()
    assert torch.equal(tm.step_n_quiet(tm.init_state(), 3).state, a.state)


def _cpu_grid(n=8):
    return pt.cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True),
                            device="cpu")


@pytest.mark.parametrize("modes", [dict(advance_mode="cuda"),
                                   dict(scatter_mode="dense_cuda")])
def test_cuda_mode_on_cpu_tensors_raises(modes):
    with pytest.raises(ValueError, match="CUDA kernel"):
        pt.WaveGrowth2D(_cpu_grid(), pt.constant_winds(10.0, 5.0),
                        pt.ODESettings(), config=pt.WaveGrowth2DConfig(**modes))


@pytest.mark.parametrize("remesh", ["pallas", "fused"])
def test_unported_remesh_modes_raise(remesh):
    """The kernel remesh modes carry the dt (no Hairer reset), as in the
    JAX package: with the default dt_reset_mode="auto" they raise."""
    with pytest.raises(ValueError, match='dt_reset_mode="carry"'):
        pt.WaveGrowth2D(_cpu_grid(), pt.constant_winds(10.0, 5.0),
                        pt.ODESettings(),
                        config=pt.WaveGrowth2DConfig(remesh_mode=remesh))


def test_wind_outside_kernel_contract_raises_under_cuda(monkeypatch):
    """Modes resolved to the kernels (as on a card): a sampler without a
    kernel descriptor that reads its time becomes the traced kind, and one
    the tracer cannot lower is refused, never sent to the plain path; a
    steady one becomes the node kind, its node planes the sampler's
    values."""
    def cuda_modes(cfg, device):
        return dataclasses.replace(cfg, advance_mode="cuda",
                                   scatter_mode="dense_cuda")

    monkeypatch.setattr(twg, "resolve_modes", cuda_modes)
    timed = pt.Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0) + 0.0 * t,
                       v=lambda x, y, t: torch.full_like(x, 5.0))
    m = pt.WaveGrowth2D(_cpu_grid(), timed, pt.ODESettings())
    assert m.winds.kernel.kind == pt.WindKind.TRACED
    assert m.wind_fields(m.grid, torch.zeros(())) == ()
    host = pt.Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0 + t.item()),
                      v=lambda x, y, t: torch.full_like(x, 5.0))
    with pytest.raises(NotImplementedError, match='advance_mode="torch"'):
        pt.WaveGrowth2D(_cpu_grid(), host, pt.ODESettings())
    steady = pt.Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0),
                        v=lambda x, y, t: torch.full_like(x, 5.0))
    m = pt.WaveGrowth2D(_cpu_grid(), steady, pt.ODESettings())
    assert m.winds.kernel.kind == pt.WindKind.NODE
    u, v = m.wind_fields(m.grid, torch.zeros(()))
    assert torch.equal(u, torch.full_like(m.grid.x, 10.0))
    assert torch.equal(v, torch.full_like(m.grid.x, 5.0))
    m = pt.WaveGrowth2D(_cpu_grid(), pt.constant_winds(10.0, 5.0),
                        pt.ODESettings())
    assert m.resolved_config().advance_mode == "cuda"


def test_explicit_plain_modes_and_auto_resolution():
    cfg = pt.WaveGrowth2DConfig()
    assert twg.resolve_modes(cfg, "cpu").advance_mode == "torch"
    assert twg.resolve_modes(cfg, "cuda").advance_mode == "cuda"
    assert twg.resolve_modes(cfg, "cuda").scatter_mode == "dense_cuda"
    explicit = pt.WaveGrowth2DConfig(advance_mode="torch", scatter_mode="xla")
    assert twg.resolve_modes(explicit, "cuda") == explicit
    with pytest.raises(ValueError, match="advance_mode"):
        twg.resolve_modes(pt.WaveGrowth2DConfig(advance_mode="xla"), "cpu")


def test_convert_round_trip_and_config_mapping():
    jm = tgr._model()
    jms = jm.init_state()
    tms = state_of(jms)
    back = convert.state_to_numpy(tms)
    np.testing.assert_array_equal(back["state"], np.asarray(jms.state))
    for k in convert.PARTICLE_FIELDS:
        np.testing.assert_array_equal(back[k],
                                      np.asarray(getattr(jms.particles, k)))
    assert back["metrics"]["n_gather"] == 0
    cfg = convert.config_from_jax(JConfig(advance_mode="pallas",
                                          scatter_mode="dense_pallas",
                                          halo=((0, 3), (0, 3))))
    assert (cfg.advance_mode, cfg.scatter_mode) == ("cuda", "dense_cuda")
    assert convert.config_from_jax(JConfig(advance_mode="xla",
                                           scatter_mode="xla")).advance_mode \
        == "torch"


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with JAX made
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import picles_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    picles_torch.__path__, 'picles_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'picles_tpu'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18


@pytest.mark.parametrize("cfg", [dict(boundary_type="wind_sea"),
                                 dict(boundary_type="mininmal"),
                                 dict(ode_init_type="mininmal")])
def test_boundary_inflow_and_init_modes_match(cfg):
    """The torch remesh tail's open-boundary inflow and fixed-default seeding
    on a non-periodic box with half-domain winds (reseed and off branches
    fire; the fixed sub-step is unstable from the 'mininmal' seed, so the
    NaN guard resets fire too).  Fixed-substep mode keeps the controller
    out, so the branch logic is held at rtol 1e-5 with every counter
    equal."""
    DT = 600.0
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    sett = JSettings(log_energy_minimum=float(ws.lne), timestep=DT, dt=37.5,
                     dtmin=1e-4, adaptive=False)
    jm = JModel(j_box(100e3, 12, 100e3, 12),
                jw.half_domain_winds(10.0, 5.0, x_split=50e3), sett,
                config=JConfig(periodic_boundary=False, **cfg))
    tm = port_of(jm, pt.half_domain_winds(10.0, 5.0, x_split=50e3))
    jstep = jax.jit(jm.step)
    jms = jm.init_state()
    tms = state_of(jms)
    np.testing.assert_allclose(tm.init_state().state.numpy(),
                               np.asarray(jms.state), rtol=1e-6, atol=1e-12)
    for k in range(3):
        jms, tms = jstep(jms), tm.step(tms)
        np.testing.assert_allclose(tms.state.numpy(), np.asarray(jms.state),
                                   rtol=1e-5, atol=1e-10, err_msg=f"step {k}")
        assert_counters_equal(tms, jms, k)
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
    m = tms.metrics.as_dict()
    assert m["n_reseed"] + m["n_off"] + m["n_nan_reset"] > 0   # not all gather


def test_term_flags_carry_over_on_propagation_only_blob():
    """The propagation-only swell blob of tests/test_land_mask_2d.py:74
    (every source term off, a land wall): ``port_of`` carries the JAX
    model's term flags, so 8 steps agree within 1e-5 (3.3e-6 measured; with
    every term on, the port drifted to 5.4e-5), as the largest difference
    over the state's largest value; counters and ``on`` equal."""
    import test_land_mask_2d as tlm

    mask = np.ones((tlm.NX, tlm.NY), bool)
    mask[30:34, :] = False
    jm = tlm._model(mask)
    tm = port_of(jm, pt.constant_winds(0.0, 0.0))
    assert tm.flags == pt.TermFlags(input=False, dissipation=False,
                                    peak_shift=False, direction=False)
    jms = tlm._plant_blob(jm)
    tms = state_of(jms)
    jstep = jax.jit(jm.step)
    for k in range(8):
        jms, tms = jstep(jms), tm.step(tms)
        S, J = tms.state.numpy(), np.asarray(jms.state)
        gap = float(np.abs(S - J).max() / np.abs(J).max())
        assert gap <= 1e-5, f"step {k}: {gap:.3e} of the state's scale"
        assert_counters_equal(tms, jms, k)
        np.testing.assert_array_equal(tms.particles.on.numpy(),
                                      np.asarray(jms.particles.on))
    assert int(tms.metrics.n_active) > 0


def test_flags_from_jax_takes_attributes_or_mapping():
    from picles_tpu.ops.rhs import TermFlags as JFlags

    f = JFlags(input=False, direction=False)
    assert convert.flags_from_jax(f) == pt.TermFlags(input=False,
                                                     direction=False)
    assert convert.flags_from_jax(dict(propagation=False, input=True,
                                       dissipation=True, peak_shift=False,
                                       direction=True)) == pt.TermFlags(
        propagation=False, peak_shift=False)


def test_config_from_jax_maps_float64_and_refuses_other_dtypes():
    import jax.numpy as jnp

    assert convert.config_from_jax(JConfig()).dtype == torch.float32
    cfg = convert.config_from_jax(JConfig(dtype=jnp.float64))
    assert cfg.dtype == torch.float64
    assert dataclasses.replace(cfg, dtype=torch.float32) == \
        convert.config_from_jax(JConfig())
    with pytest.raises(ValueError, match="float32 and float64"):
        convert.config_from_jax(JConfig(dtype=jnp.float16))


def test_float64_model_matches_jax_float64():
    """A float64 JAX model (x64 scoped to this test, as
    tests/test_torch_sharded.py:309) and the port's model built from it
    through ``config_from_jax``: fixed 60 s substeps over half-domain
    winds, 3 steps from JAX's initial state, rtol 1e-12 (1.6e-13 measured:
    the two libraries' float64 pow, exp and log in the last ulp; the port's
    fetch relations, seeding and remesh compute in the model's dtype, as
    JAX's do with x64 on), counters equal."""
    import jax.numpy as jnp

    ws = jfr.MinimalWindsea(10.0, 10.0, 600.0)
    sett = JSettings(log_energy_minimum=float(ws.lne), timestep=600.0,
                     dt=60.0, dtmin=1e-4, adaptive=False)
    with jax.enable_x64(True):
        jm = JModel(j_box(100e3, 12, 100e3, 12,
                          periodic_boundary=(True, True)),
                    jw.half_domain_winds(10.0, 5.0, x_split=50e3), sett,
                    config=JConfig(periodic_boundary=True,
                                   dtype=jnp.float64))
        tm = port_of(jm, pt.half_domain_winds(10.0, 5.0, x_split=50e3))
        assert tm.config.dtype == torch.float64
        jms = jm.init_state()
        assert np.asarray(jms.state).dtype == np.float64
        tms = state_of(jms, torch.float64)
        jstep = jax.jit(jm.step)
        for k in range(3):
            jms, tms = jstep(jms), tm.step(tms)
            assert tms.state.dtype == torch.float64
            np.testing.assert_allclose(tms.state.numpy(),
                                       np.asarray(jms.state), rtol=1e-12,
                                       atol=1e-16, err_msg=f"step {k}")
            assert_counters_equal(tms, jms, k)
    assert 0 < int(tms.metrics.n_active) < 144
