"""Where the 2D step runs its glue in the epilogues of K1 and K6 (the fused
path, ``models/wave_growth_2d.py`` ``fused_glue``) and where in PyTorch
(``_step_glue``), and the layout of the counters both kernels fill.

The fused path runs on a card only (``tests/test_torch_cuda.py`` holds it
to the PyTorch glue there); here, on the CPU: the path's choice from the
resolved modes, the wind's kind and the sharded deposit; every CPU step
taking the PyTorch glue; the counters' row read as
``StepMetrics`` in its order (``[L]`` layered), its slots the kernels'
(``csrc/remesh.cuh``); the epilogue's launch counters in the recorder;
the wrappers refusing the epilogue where it does not run.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from picles_torch import (ODESettings, WaveGrowth2D, WaveGrowth2DConfig,
                          WindKind, cartesian_box, constant_winds)
from picles_torch.models import wave_growth_2d as W2
from picles_torch.models.state import StepMetrics
from picles_torch.ops.advance_cuda import N_COUNTERS

FUSED = WaveGrowth2DConfig(advance_mode="cuda", scatter_mode="dense_cuda",
                           remesh_mode="fused", dt_reset_mode="carry")
KINDS = [WindKind.CONSTANT, WindKind.HALF_DOMAIN, WindKind.TIME_COSINE,
         WindKind.NODE, WindKind.TRACED]


def _sharded_deposit(*args):
    raise AssertionError("not called")


@pytest.mark.parametrize("kind", KINDS)
def test_fused_glue_engages_for_every_kind_but_gridded(kind):
    """K1 and K6 under a wind other than gridded: the fused path, whatever
    the kind."""
    assert W2.fused_glue(FUSED, kind)
    assert W2.fused_glue(FUSED, kind, None)


@pytest.mark.parametrize("why,modes,kind,scatter", [
    ("a gridded wind", FUSED, WindKind.GRIDDED, None),
    ("the sharded deposit", FUSED, WindKind.CONSTANT, _sharded_deposit),
    ("the plain advance", dataclasses.replace(FUSED, advance_mode="torch"),
     WindKind.CONSTANT, None),
    ("K5", dataclasses.replace(FUSED, remesh_mode="pallas"),
     WindKind.CONSTANT, None),
    ("the PyTorch remesh", dataclasses.replace(FUSED, remesh_mode="xla"),
     WindKind.NODE, None),
])
def test_fused_glue_leaves_out(why, modes, kind, scatter):
    """A gridded wind, the sharded step's deposit, the plain advance and
    the K5 and PyTorch remeshes keep the PyTorch glue (the CPU resolves
    every mode to a plain version: ``test_cpu_step_takes_the_torch_glue``)."""
    assert not W2.fused_glue(modes, kind, scatter), why


def _box(n=12, **cfg):
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device="cpu")
    kw = dict(periodic_boundary=True, dt_reset_mode="carry")
    kw.update(cfg)
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0),
                        ODESettings(timestep=600.0, dt=60.0, solver="bosh3"),
                        config=WaveGrowth2DConfig(**kw))


@pytest.mark.parametrize("remesh", ["fused", "pallas", "xla"])
@pytest.mark.parametrize("layers", [1, 2])
def test_cpu_step_takes_the_torch_glue(monkeypatch, remesh, layers):
    """Every step on the CPU runs ``_step_glue``, the fused remesh's plain
    version included, and its counters keep their layout: int32, 0-dim
    (``[L]`` layered), in ``StepMetrics`` order."""
    m = _box(remesh_mode=remesh, layers=layers)
    calls = []
    glue = WaveGrowth2D._step_glue

    def spy(self, *a, **k):
        calls.append(1)
        return glue(self, *a, **k)

    def fused(self, *a, **k):
        raise AssertionError("the fused path ran on the CPU")

    monkeypatch.setattr(WaveGrowth2D, "_step_glue", spy)
    monkeypatch.setattr(WaveGrowth2D, "_step_fused", fused)
    ms = m.init_state_layers() if layers > 1 else m.init_state()
    out = m.step_layers(ms) if layers > 1 else m.step(ms)
    assert calls == [1]
    shape = (layers,) if layers > 1 else ()
    for f in dataclasses.fields(StepMetrics):
        v = getattr(out.metrics, f.name)
        assert v.dtype == torch.int32 and tuple(v.shape) == shape, f.name
    assert int(out.metrics.n_active.sum()) == layers * 12 * 12


@pytest.mark.parametrize("layers", [None, 1, 3])
def test_counter_rows_read_as_step_metrics(layers):
    """The counters' row (``[N_COUNTERS]``, ``[L, N_COUNTERS]`` layered)
    reads as the ten counts in ``StepMetrics`` order, then
    ``substeps_max``; a reduction hook gets the counts and the max."""
    rows = () if layers is None else (layers,)
    buf = torch.arange(N_COUNTERS, dtype=torch.int32).repeat(
        *rows, 1).contiguous()
    if layers is not None:
        buf += 100 * torch.arange(layers, dtype=torch.int32)[:, None]
    m = W2.counter_metrics(buf)
    names = [f.name for f in dataclasses.fields(StepMetrics)]
    assert len(names) == N_COUNTERS
    for c, name in enumerate(names):
        v = getattr(m, name)
        assert tuple(v.shape) == rows and v.dtype == torch.int32
        assert torch.equal(v, buf[..., c]), name
    seen = []

    def reduce(counts, smax):
        seen.append((tuple(counts.shape), tuple(smax.shape)))
        return counts * 2, smax + 1

    r = W2.counter_metrics(buf, reduce)
    assert seen == [(rows + (N_COUNTERS - 1,), rows)]
    assert torch.equal(r.n_off, 2 * buf[..., 8])
    assert torch.equal(r.substeps_max, buf[..., 10] + 1)


def test_counter_slots_are_the_kernels():
    """``csrc/remesh.cuh``'s slots name ``StepMetrics``' fields in order,
    and ``N_COUNTERS`` is theirs."""
    src = (Path(W2.__file__).resolve().parents[1] / "csrc"
           / "remesh.cuh").read_text()
    body = re.search(r"enum : int \{\s*(C_ACTIVE[^}]*)\}", src).group(1)
    slots = [s.strip().split("=")[0].strip() for s in body.split(",")]
    assert slots[-1] == "N_COUNTERS" and len(slots) - 1 == N_COUNTERS
    names = [f.name for f in dataclasses.fields(StepMetrics)]
    want = ["C_" + n.upper().removeprefix("N_") for n in names]
    assert slots[:-1] == want


def test_epilogue_launch_counters_are_in_the_recorder():
    """``advance_cuda.epilogue_launches`` and
    ``pic_gather_remesh.epilogue_launches`` are launch counters the
    recorder's snapshot shows."""
    from picles_torch.utils import diagnostics

    counts = diagnostics.launch_counts()
    snap = diagnostics.tracer().snapshot()["counters"]
    for name in ("advance_cuda.epilogue_launches",
                 "pic_gather_remesh.epilogue_launches"):
        assert isinstance(counts[name], int) and name in snap


def test_epilogue_refused_where_it_does_not_run():
    """K1 takes ``active`` or ``guards``, one of them; the epilogue's
    wrappers refuse CPU tensors, as every kernel wrapper does."""
    from picles_torch.ops.advance_cuda import Guards, advance_cuda
    from picles_torch.ops.pic_cuda import pic_gather_remesh

    m = _box(remesh_mode="fused")
    ms = m.init_state()
    P = ms.particles
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    g = m.grid
    counters = torch.zeros(N_COUNTERS, dtype=torch.int32)
    guards = Guards(P.on, m.active_mask, m.boundary_mask, m.remesh_params,
                    m.settings.log_energy_maximum, m.modes.halo, counters)
    args = (m.winds, m.consts, m.flags, m.solver, 600.0, comps, P.t, P.dt)
    with pytest.raises(ValueError, match="or `guards`"):
        advance_cuda(*args, P.on, g.x, g.y, m.uniform_proj, guards=guards)
    with pytest.raises(ValueError, match="or `guards`"):
        advance_cuda(*args, None, g.x, g.y, m.uniform_proj)
    with pytest.raises(ValueError, match="not a CUDA device"):
        advance_cuda(*args, None, g.x, g.y, m.uniform_proj, guards=guards)
    chans = (P.lne, P.cgx, P.cgy)
    with pytest.raises(ValueError, match="not a CUDA device"):
        pic_gather_remesh(P.px, P.py, chans, P.on, g.stats, m.modes.halo,
                          m.remesh_params, *comps, P.dt, P.on,
                          m.active_mask, m.boundary_mask, g.x, g.y, ms.time,
                          counters=counters)


@pytest.mark.parametrize("layered,counters", [
    (False, torch.zeros((N_COUNTERS,), dtype=torch.int64)),
    (False, torch.zeros((N_COUNTERS + 1,), dtype=torch.int32)),
    (False, torch.zeros((2, N_COUNTERS), dtype=torch.int32)),
    (True, torch.zeros((N_COUNTERS,), dtype=torch.int32)),
    (True, torch.zeros((N_COUNTERS, 2), dtype=torch.int32).t()),
])
def test_counters_refused_unless_the_steps_row(layered, counters):
    """The epilogues' counters are one contiguous int32 row of
    ``N_COUNTERS`` (``[L, N_COUNTERS]`` layered) on the lanes' device;
    another dtype, length, rank or layout raises, naming the shape."""
    from picles_torch.ops.advance_cuda import check_counters

    with pytest.raises(ValueError, match="contiguous int32"):
        check_counters(counters, layered, 2, counters.device)
    rows = (2, N_COUNTERS) if layered else (N_COUNTERS,)
    check_counters(torch.zeros(rows, dtype=torch.int32), layered, 2,
                   counters.device)
