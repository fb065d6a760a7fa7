#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: the WaveGrowth2D step and
``Simulation.run`` over the flagship configuration.

    python3 chip_smoke.py [--out results.json] [--profile profile.json]

Builds the CUDA kernels of ``picles_torch/csrc/`` (nvcc, sm_90a, one
process per source), checks each against its plain PyTorch version on the
card, and drives three main paths, each with the launch counters set to 0
just before and read just after:

1. the flagship configuration (1536^2, bosh3, carried dt, halo
   ((0,3),(0,3))) and the default one (tsit5, Hairer dt reset) through
   ``WaveGrowth2D`` (kernels K1, K2, K3);
2. the flagship through ``Simulation`` under the three remesh backends
   ("xla", "pallas" with K5, "fused" with K6), then the production run: a
   storeless day (145 steps) of the fused flagship, checkpointed at step 72
   and resumed bit for bit, and a stored day at 256^2;
3. the "pallas" flagship through ``ShardedWaveGrowth2D`` on a (1, 1) mesh
   over NCCL (K1, K4, the self-wrap fold, K5), and in the same process
   group the global tripolar configuration (phase "sharded-tripolar":
   1440 x 720, K1 with projection and wind planes, K4, the self-wrap and
   seam folds, K5 or K3).  Then four ranks of this
   script on the same card over gloo (a 2 x 2 mesh) hold the collective
   deposit against the global K2 deposit, the sharded step against the
   single-device one, a sharded ``Simulation.run`` with a store and a
   checkpoint resume, and the tripolar configuration at 360 x 180 with the
   seam across two top blocks;
4. the gridded configuration: an ERA5-shaped wind record written by this
   script as a NetCDF-3 file and read back through the port's
   ``load_gridded_winds_2d``, at 1536^2 with a symmetric halo 3: a
   storeless day of the fused configuration through ``Simulation.run``
   (K1 and K6's gridded instances), checkpointed at step 72 and resumed
   bit for bit, then the default configuration (K1, K2, K3) and the
   "pallas" remesh (K1, K2, K5).  The gridded instances are held against
   their plain versions over the same per-step planes at 256^2 (phase
   "gridded-kernels"), a constant record bit for bit against the
   constant-wind instances at 1536^2 ("gridded-anchor"), and timed on the
   gridded states beside their bounds;
5. the global tripolar configuration: a quarter-degree synthetic tripolar
   grid (1440 x 720) with pole masks and a continent, DT = 1200 s, forced
   by a gridded jet record: a storeless day (72 steps) of the fused
   configuration through ``Simulation.run`` (K1 with per-node projection
   planes, K6 with the tripolar seam), checkpointed at step 36 and resumed
   bit for bit, then the default configuration (K1, K2, K3) and the
   "pallas" remesh (K1, K2, K5), 4 steps each.  The new branches are held
   against their plain versions at 256^2 on spherical and tripolar grids
   (phase "K1 proj"/"K3 proj"; a Cartesian box, plain and rotated, given
   as planes bit for bit the scalars, "proj-anchor") and at the main
   path's shape ("K2 tripolar"; "K6 tripolar" bit for bit K2 + K5), and
   the 1 degree grid (360 x 180) runs on the card against the CPU.

6. the compiled drivers (phase "graphs"): the flagship under the three
   remesh backends, the default configuration, the gridded fused and
   default configurations at 1536^2 and the tripolar fused one at 1440 x
   720 through ``step_n_quiet``, ``step_n``, ``step_n_buffered`` and
   ``step_jit``, which replay a CUDA graph of the step, bit for bit the
   eager steps, timed against them in turns, with the capture's time and
   memory and a trace of its replays;
7. the CLI's path (phase "cli"): ``python -m picles_torch``'s model and
   Simulation, built by its ``build_simulation`` at 1536^2 (tsit5, Hairer
   dt reset: K1, K2, K3) and run with a store as its ``main`` runs them,
   a CashStore in place of the HDF5 file;
8. layers (phase "layers"): the flagship box at 1536^2 (halo 3: swell
   travels every way) with 10 swell systems (tests/test_layers.py's seeds)
   through ``LayeredWaveGrowth2D``
   under the three remesh backends and the default configuration, each
   kernel launched once a step for every layer (its second launch
   dimension), each layer bit for bit its own single-layer model's steps,
   the replays bit for bit the eager steps; per-layer winds (one model a
   layer, the gridded record among them); a layered day through
   ``Simulation.run`` resumed from a checkpoint, and a stored one; the
   layered (1, 1) NCCL step in phase "sharded-1x1" (batched K4).  Phase
   "layer-kernels" holds each batched kernel bit for bit against its
   single-layer launches in every instance (winds, gridded planes,
   projection planes, the tripolar seam, the padded deposit) at 256^2, and
   the kernels' timing holds and times them at full width against their
   ten single launches.

9. the 1D growth model (phase "1d"; no kernel in either package, plain
   PyTorch on the card): two model days of the B01 configurations through
   ``Simulation.run`` (onto the Dulov curve, the collapse across wind
   speeds), a checkpoint resumed bit for bit, the card against the CPU,
   and the deterministic sign-merge deposit on 2^20 lanes.

``Simulation.run`` replays the graph too, so paths 2, 4, 5 and 7 run
through it.  A replay launches the kernels without their wrappers, whose
launch counters tick only when the host calls them: the eager paths count
with the counters, and each graphed run counts its launches by name in a
``torch.profiler`` trace of its own ``Simulation.run`` (``traced_run``),
the counters set to 0 just before (the host calls no kernel there).  Each
graphed day is run again eagerly, counted and held bit for bit against it.
Phase "wide-grid" runs K1, K2, K5 and K6 on a 64 x 6000 grid, wider than
the JAX package's kernels take in VMEM.

It matches a small run on the card against the same model on the CPU, and
times the kernels and the step beside their plain versions.  K1-K4 and K6
are also held bit for bit against their ``_simple`` baselines (the
one-thread-per-particle/node kernels they replaced, compiled beside them;
K3's followed by PyTorch's clamp and select, which it fuses) on every state
these phases use, and timed in turns with them (baseline, new, new,
baseline).  A kernel's time is its own device time from a
``torch.profiler`` trace (``kernel_ms``), without the wrapper's other device
work; each kernel's bound is computed from this run's inputs (``bound``).
``--profile`` adds a trace of the step's time at full size for each
configuration, eager and graphed (step times, host enqueue time, device
busy time and idle share, device time by kernel).  ``--probe JSON`` runs only the measurements
behind the kernels' design (ptxas, SASS counts, substep sweeps, K1's lane
divergence, K3 in turns with its baseline).

Every phase asserts; any failure exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.  Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from picles_torch import (Boundary, GridStats, ODEParameters, ODESettings,
                          Simulation, TermFlags, WaveGrowth1D,
                          WaveGrowth1DConfig, WaveGrowth2D,
                          WaveGrowth2DConfig, cartesian_box,
                          cartesian_grid_2d, constant_winds,
                          constant_winds_1d, half_domain_winds,
                          load_gridded_winds_2d, one_d_grid,
                          spherical_grid_2d, synthetic_tripolar_grid,
                          time_cosine_winds)
from picles_torch.__main__ import build_simulation
from picles_torch.__main__ import parser as cli_parser
from picles_torch.core import fetch_relations as FR
from picles_torch.models import wave_growth_2d as W2D
from picles_torch.models.drivers import WARMUP_STEPS
from picles_torch.ops import cuda_build
from picles_torch.ops import transforms as TR
from picles_torch.forcing.winds import (GriddedWinds2D, WindKind, Winds2D,
                                        gridded_kernel, pwl_winds)
from picles_torch.grids.mask import make_boundaries
from picles_torch.ops.advance_cuda import (advance_cuda, auto_dt_cuda,
                                           auto_dt_reset, kernel_wind,
                                           node_projection,
                                           uniform_projection)
from picles_torch.ops.pic import (normalize_halo, scatter_1d_add,
                                  scatter_1d_merge, scatter_accumulate_padded,
                                  scatter_dense)
from picles_torch.ops.pic_cuda import (pic_gather, pic_gather_padded,
                                       pic_gather_remesh)
from picles_torch.ops.remesh import remesh_core
from picles_torch.ops.remesh_cuda import remesh_cuda
from picles_torch.ops.rhs import RHSParams, make_rhs, make_rhs_consts
from picles_torch.ops.tsit5 import METHODS, SolverConfig, integrate_to
from picles_torch.parallel.sharded import (ShardedWaveGrowth2D,
                                           init_distributed, make_mesh)
from picles_torch.simulation.store import CashStore

FLAG_N = 1536
DT = 600.0
# the remesh kernels' gathered and reseeded values against the plain
# version: a few float32 ulps (powf/logf of the windsea, the order of the
# reciprocals); their bits, flags, dt and positions are held exactly
REMESH_RTOL = 4e-7
# one day of model time: 145 steps of 600 s
DAY = 24 * 3600.0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_abs(a, b) -> float:
    d = (a.double() - b.double()).abs()
    d = torch.where((torch.isnan(a) & torch.isnan(b)) | (a == b), 0.0, d)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def assert_close(what: str, a, b, rtol: float, atol: float) -> float:
    """torch.allclose with NaN == NaN; returns the max absolute error."""
    assert a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}"
    ok = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    err = max_abs(a, b)
    if not bool(ok.all()):
        i = int((~ok).reshape(-1).nonzero()[0])
        raise AssertionError(
            f"{what}: {int((~ok).sum())} of {ok.numel()} differ beyond "
            f"rtol={rtol} atol={atol}; first at {i}: "
            f"{float(a.reshape(-1)[i])} vs {float(b.reshape(-1)[i])}; "
            f"max abs err {err:.3e}")
    return err


def assert_adaptive(what: str, k, p, rtol: float = 5e-3, atol: float = 1e-4,
                    min_share: float = 0.99, loose: float = 0.1,
                    loose_atol: float = 1e-3) -> float:
    """Adaptive-mode check.  The error controller turns last-ulp differences
    into different accept/reject sequences, and on a few lanes of a
    perturbed state such sequences end more than ``rtol`` apart (the float32
    plain version and a float64 run of it do too: up to 4% in lne, measured
    on the CPU).  So: at least ``min_share`` of the lanes agree to ``rtol``,
    and every lane to ``loose`` (``loose_atol`` for values near zero, such
    as positions in cells).  Returns the max abs error."""
    near = torch.isclose(k, p, rtol=rtol, atol=atol, equal_nan=True)
    share = float(near.float().mean())
    ok = torch.isclose(k, p, rtol=loose, atol=loose_atol, equal_nan=True)
    if share < min_share or not bool(ok.all()):
        raise AssertionError(
            f"{what}: {share:.4%} of lanes within rtol {rtol} (need "
            f"{min_share:.0%}), {int((~ok).sum())} beyond rtol {loose}; "
            f"max abs err {max_abs(k, p):.3e}")
    return max_abs(k, p)


def assert_controller(what: str, k, p, active, min_share: float = 0.95,
                      max_bias: float = 1e-2) -> str:
    """Adaptive-mode rule for the error controller's outputs, the accepted
    substep count ``naccept`` and the step-size proposal ``dt``.  A lane
    whose last substep was shortened to land on ``t_end`` has an error
    estimate at float32 rounding, so its proposal is rounding noise (for
    tsit5 only about half the lanes agree to 5e-3, measured on the card), and
    a few lanes take another substep path.  Rounding has no sign, a wrong
    controller has: at least ``min_share`` of the active lanes take as many
    substeps, and the mean of log(dt_kernel / dt_plain) over them is within
    ``max_bias`` of 0.  On the card the kernel keeps 96.0-99.997% of the
    lanes on the plain version's count with |bias| <= 9.3e-4; a host build
    of the kernel with the safety factor 0.85 for 0.9 (count share 72-83%),
    the growth clip 8 for 10 (bias -3.8e-2 to -5.4e-2) or the reject-branch
    floor 0.3 for 0.2 (tsit5 count share 36-54%) fails.  Returns a summary
    for the log."""
    a = active & ~p.failed
    share = float((k.naccept[a] == p.naccept[a]).double().mean())
    bias = float(torch.log(k.dt[a].double() / p.dt[a].double()).mean())
    if share < min_share or not abs(bias) <= max_bias:
        raise AssertionError(
            f"{what}: naccept equal on {share:.4%} of active lanes (need "
            f"{min_share:.0%}), mean log dt ratio {bias:+.3e} (bound "
            f"{max_bias:g})")
    return (f"naccept equal on {share:.4%}, mean log dt ratio {bias:+.3e}, "
            f"max |naccept diff| {int((k.naccept - p.naccept).abs().max())}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call.  The calls queue behind a spin of the device
    (about 0.1 s), so the host's Python work between launches (a wrapper
    takes longer to call than K5 takes to run) is not timed as idle
    device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the kernels' names in a profiler trace: the new kernels and their
# `_simple` baselines; K3's baseline is three device ops, the previous
# kernel and PyTorch's clamp and select, which the new kernel replaces
KERNEL_KEYS = {"K1": "advance_kernel<", "K1 simple": "advance_simple_kernel<",
               "K2": "pic_gather_tiled_kernel<",
               "K2 simple": "pic_gather_simple_kernel(",
               "K3": "auto_dt_kernel<",
               "K3 simple": ("auto_dt_simple_kernel(", "clamp", "where"),
               "K3 simple only": "auto_dt_simple_kernel(",
               "K4": "pic_gather_tiled_kernel<",
               "K4 simple": "pic_gather_padded_simple_kernel(",
               "K5": "remesh_kernel(",
               "K6": "pic_gather_remesh_tiled_kernel<",
               "K6 simple": "pic_gather_remesh_simple_kernel("}


# kernel id -> [launches a trace held, launches timed] of each timing whose
# traces all missed launches (``kernel_ms``); the kernels line carries it
SHORT_TRACES: dict = {}


def kernel_ms(fn, key: str, reps: int, tries: int = 5,
              per_call: int = 1, row: str = "") -> float:
    """Mean device time of one call of ``fn`` in the kernel named by ``key``
    (KERNEL_KEYS; a tuple names every device op of a call, whose means are
    summed; ``per_call``: launches of each a call, summed) over ``reps``
    calls, from a torch.profiler trace after one
    warm-up call: the kernel alone, without the wrapper's other device work
    (the deposit wrappers' clamped count) or the host's.  A trace may miss
    launches (seen on the H100: one a session once a process has run many
    profiler sessions, and now and then most of a session's): a short trace
    is taken again, up to ``tries`` times.  If every one is short, the means
    are over the launches the fullest one holds, which must hold half of
    each op's, and it is logged and recorded in SHORT_TRACES under ``row``
    (by default the kernel's id)."""
    from torch.profiler import ProfilerActivity, profile

    names = KERNEL_KEYS[key]
    names = (names,) if isinstance(names, str) else names
    want = reps * len(names) * per_call
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(nm in e.name for nm in names)]
        assert len(ev) <= want, f"{key}: {len(ev)} of {want} launches"
        best = ev if len(ev) > len(best) else best
        if len(ev) == want:
            break
        log("kernel-time", f"{key}: the trace holds {len(ev)} of {want} "
                           f"launches")
    else:
        SHORT_TRACES.setdefault(row or key.split()[0], []).append(
            [len(best), want])
    ms = 0.0
    for nm in names:
        us = [e.time_range.elapsed_us() for e in best if nm in e.name]
        assert 2 * len(us) >= reps * per_call, \
            f"{key}: {len(us)} of {reps * per_call} {nm!r} launches in the " \
            f"fullest trace"
        ms += sum(us) / len(us) * per_call / 1e3
    return ms


def turns_ms(key: str, simple_fn, new_fn, reps: int):
    """(simple ms, new ms) of kernel ``key`` (``kernel_ms``), each timed twice
    in turns, simple, new, new, simple, and the two runs averaged."""
    s1 = kernel_ms(simple_fn, key + " simple", reps)
    n1 = kernel_ms(new_fn, key, reps)
    n2 = kernel_ms(new_fn, key, reps)
    s2 = kernel_ms(simple_fn, key + " simple", reps)
    return (s1 + s2) / 2, (n1 + n2) / 2


# The least time the card could take for a kernel's work (NVIDIA H100 SXM
# peak rates at its 700 W limit): each input
# byte read once and each output byte written once at 3.35 TB/s, or the
# float operations at 67 TFLOP/s (float32 outside the tensor cores, a
# transcendental or a division counted as one operation), whichever is
# longer.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations of one RHS evaluation (rhs.cuh, every term on): 12
# divisions, 6 transcendentals and square roots, about 84 products, sums,
# selects and clamps
RHS_OPS = 102


def bound(nbytes: float, ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel's bytes and operations."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def k1_substep_ops(method: str, adaptive: bool) -> int:
    """Float operations of one K1 substep outside the RHS: the stage and
    solution sums (dt*a once, then a product and a sum per component), the
    stage times, and for the adaptive controller the error sums, the scaled
    norm (8 operations a component), the square root and the step-size
    update (with powf)."""
    m = METHODS[method]
    nz_a = sum(1 for row in m.a for x in row if x != 0.0)
    nz_b = sum(1 for x in m.b if x != 0.0)
    ops = 11 * nz_a + 2 * len(m.c) + 11 * nz_b + 13
    if adaptive:
        ops += 10 * sum(1 for x in m.bt if x != 0.0) + 5 + 40 + 2 + 15
    return ops


def gridded_wind_ops(B: int) -> int:
    """Float operations of one evaluation of the gridded samplers: a + t s
    for u and v (4), then per breakpoint t - b and its max once, a product
    and a sum for each of u and v (6)."""
    return 4 + 6 * B


def k1_bound(n: int, method: str, adaptive: bool, live, iters,
             n_wf: int = 0, proj: bool = False, layers: int = 1) -> dict:
    """K1's bound on this run's inputs: 33 bytes in and 33 out a particle,
    a gridded wind's ``n_wf`` planes in (4 bytes each) and, with per-node
    projection planes (``proj``), 5 more (20 bytes); per live particle one
    RHS evaluation to start, then per substep tried (accepted or rejected)
    S evaluations (each with the gridded samplers) and the substep's own
    operations.  With ``layers`` the ``n`` particles are that many layers of
    one grid, whose node x and node planes are read once a node."""
    S = len(METHODS[method].b)
    it = float(iters[live].double().sum())
    rhs = RHS_OPS + (gridded_wind_ops((n_wf - 4) // 3) if n_wf else 0)
    ops = (float(live.sum()) + S * it) * rhs \
        + it * k1_substep_ops(method, adaptive)
    node = 4.0 + 4.0 * n_wf + 20.0 * proj
    return bound((62.0 + node / layers) * n, ops)


def deposit_bound(n_src: int, n_out: int, halo, remesh: bool = False,
                  n_wf: int = 0, layers: int = 1) -> dict:
    """K2/K4/K6 on this run's shapes: per source 5 float planes and the mask
    (21 bytes) and about 13 operations (clamps, floors, weights, c * m); per
    output node 3 floats (12 bytes) and 11 operations a window cell; K6 adds
    the remesh's 60 bytes a node in and out (lne, cgx, cgy, px, py, dt, the
    three masks and x in; six planes, `on` and the branch bits out) and
    about 60 operations; with a gridded wind's ``n_wf`` planes, 4 bytes
    each in place of the node x, and the samplers' operations.  With
    ``layers`` the sources and outputs are that many layers of one grid,
    whose masks and node x (or wind planes) the remesh reads once a
    node."""
    (xl, xh), (yl, yh) = normalize_halo(halo)
    cells = (xl + xh + 1) * (yl + yh + 1)
    wind = (4.0 * n_wf - 4.0) if n_wf else 0.0
    node = 6.0 + wind   # active, boundary and x (or the wind planes)
    nbytes = 21.0 * n_src + 12.0 * n_out + (
        (54.0 + node / layers) * n_out if remesh else 0.0)
    ops = 13.0 * n_src + 11.0 * cells * n_out + (60.0 * n_out if remesh
                                                 else 0.0)
    if remesh and n_wf:
        ops += gridded_wind_ops((n_wf - 4) // 3) * n_out
    return bound(nbytes, ops)


def remesh_bound(n: int, n_wf: int = 0, layers: int = 1) -> dict:
    """K5: 72 bytes a node (43 in, 29 out) and about 60 operations; a
    gridded wind's ``n_wf`` planes in place of the node x, and the
    samplers' operations.  With ``layers`` the ``n`` nodes are that many
    layers of one grid, whose masks and node x (or wind planes) are read
    once a node."""
    wind = (4.0 * n_wf - 4.0) if n_wf else 0.0
    ops = 60.0 + (gridded_wind_ops((n_wf - 4) // 3) if n_wf else 0)
    node = 6.0 + wind   # active, boundary and x (or the wind planes)
    return bound((66.0 + node / layers) * n, ops * n)


def k3_bound(reset: torch.Tensor, wind, proj: bool = False,
             layers: int = 1) -> dict:
    """K3 on this run's inputs: per lane the mask (1 byte) in and dt out (4);
    per reset lane the 5 components (20 bytes), the node x where an
    analytic wind reads it, t where the wind varies in t, a gridded wind's
    4 + 3B planes (4 bytes each) and per-node projection planes (``proj``,
    20 bytes), 2 RHS evaluations (with the gridded samplers), the norms,
    h0, h1 and the clamp (about 62 operations); per lane that is not reset
    its dt (4 bytes) and no operation.  With ``layers`` the lanes are that
    many layers of one grid, whose node x and node planes are read once a
    node."""
    n, r = reset.numel(), int(reset.sum())
    gridded = wind.kind == WindKind.GRIDDED
    n_wf = 4 + 3 * wind.n_break if gridded else 0
    node = 4.0 * (wind.kind in (WindKind.HALF_DOMAIN, WindKind.TIME_COSINE)) \
        + 4.0 * n_wf + 20.0 * proj
    per_reset = 20.0 + 4.0 * (wind.kind in (WindKind.TIME_COSINE,
                                            WindKind.GRIDDED)) \
        + node / layers
    rhs = RHS_OPS + (gridded_wind_ops(wind.n_break) if gridded else 0)
    return bound(5.0 * n + per_reset * r + 4.0 * (n - r),
                 (2 * rhs + 62.0) * r)


def half_reset_mask(shape, device, seed: int) -> torch.Tensor:
    """About half the lanes reset (numpy seed): each warp of K3's launch
    (32 lanes in a row along y) unreset as a whole, reset as a whole, or
    mixed lane by lane, a third each."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    kind = np.repeat(rng.integers(0, 3, -(-n // 32)), 32)[:n]
    lane = rng.uniform(size=n) < 0.5
    m = np.where(kind == 2, lane, kind == 1).reshape(shape)
    return torch.as_tensor(m, device=device)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (NaN payloads included), for bitwise comparisons."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else \
        t.view(torch.int32)


def assert_bitwise(what: str, new, simple) -> None:
    """Every tensor of ``new`` equal to ``simple``'s bit for bit."""
    for i, (a, b) in enumerate(zip(new, simple)):
        if not torch.equal(bits(a), bits(b)):
            d = int((bits(a) != bits(b)).sum())
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"_simple baseline on {d} of {a.numel()}")


def settings(solver: str, **tols):
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True, solver=solver, **tols)


def flagship_model(n: int, device, solver="bosh3", dt_reset_mode="carry",
                   halo=((0, 3), (0, 3)), periodic=True, winds=None,
                   tols=None, **modes):
    """bench.py's production configuration on the port: 2 km spacing,
    periodic box, constant (10, 10) m/s winds (or ``winds``), directional
    halo."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(periodic, periodic),
                         device=device)
    cfg = WaveGrowth2DConfig(periodic_boundary=periodic,
                             dt_reset_mode=dt_reset_mode, halo=halo, **modes)
    return WaveGrowth2D(grid, winds or constant_winds(10.0, 10.0),
                        settings(solver, **(tols or {})), config=cfg)


def default_model(n: int, device, winds=None, tols=None, **modes):
    """The package default (tsit5, Hairer dt reset, halo 3) on the same
    box."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=device)
    return WaveGrowth2D(grid, winds or constant_winds(10.0, 10.0),
                        settings("tsit5", **(tols or {})),
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  **modes))


def gridded_model(n: int, device, winds, path: str, tols=None):
    """The gridded configuration (``winds`` a GriddedWinds2D) on the same
    box: "production" the flagship with the fused remesh (K1, K6),
    "pallas" with K5 (K1, K2, K5), both bosh3 with the carried dt;
    "default" tsit5 with the Hairer reset (K1, K2, K3).  The halo is a
    symmetric 3: gridded winds turn, and the flagship's directional halo
    would clamp.  ``tols``: other solver tolerances (abstol, reltol)."""
    if path == "default":
        return default_model(n, device, winds=winds, tols=tols)
    return flagship_model(n, device, halo=3, winds=winds, tols=tols,
                          remesh_mode="fused" if path == "production"
                          else "pallas")


def perturbed_state(n: int, device, seed: int, ny: int = 0, grid=None):
    """Windsea seeds of (10, 10) m/s winds plus a numpy-seeded perturbation
    on an n x n grid (n x ny with ``ny``; ``grid``, of that shape, in place
    of the periodic 2 km box); returns (comps, dt, active, grid)."""
    rng = np.random.default_rng(seed)
    ny = ny or n
    if grid is None:
        grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (ny - 1), ny,
                             periodic_boundary=(True, True), device=device)
    ws = FR.get_initial_windsea(torch.full((n, ny), 10.0, device=device),
                                torch.full((n, ny), 10.0, device=device), DT)

    def noise(fn, *a):
        return torch.as_tensor(fn(*a, (n, ny)).astype(np.float32),
                               device=device)

    lne = (ws.lne + noise(rng.normal, 0.0, 0.05)).contiguous()
    cgx = (ws.cg_bar_x * noise(rng.uniform, 0.95, 1.05)).contiguous()
    cgy = (ws.cg_bar_y * noise(rng.uniform, 0.95, 1.05)).contiguous()
    px = noise(rng.uniform, -0.3, 0.3)
    py = noise(rng.uniform, -0.3, 0.3)
    dt = noise(rng.uniform, 10.0, 120.0)
    active = torch.as_tensor(rng.uniform(size=(n, ny)) < 0.95, device=device)
    return (lne, cgx, cgy, px, py), dt, active, grid


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | count "
                  f"{torch.cuda.device_count()}")
    return name, smi


def phase_build():
    res = cuda_build.build()
    cuda_build.library()
    lines = res.log.splitlines()
    regs = sorted({ln.split(":", 1)[1].strip() for ln in lines
                   if "registers" in ln})
    n_double = sum("double precision" in ln for ln in lines)
    bad = cuda_build.unexpected_double_ops()
    log("build", f"{res.seconds:.1f} s ({res.path.parent.name}); ptxas: "
                 f"{' | '.join(regs)}; float64 PTX lines: {n_double} "
                 f"warned, all in the cosf argument reduction")
    assert not bad, f"float64 in the kernels' own code: {bad[:5]}"
    return res


def phase_k1(dev, results):
    """K1 against integrate_to on the card, and bit for bit against its
    _simple baseline."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    comps, dt0, active, grid = perturbed_state(256, dev, seed=0)
    proj = (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
            float(grid.proj[0, 0, 1, 1]), 0.0)
    k1_err = 0.0
    cases = []
    for wname, winds in (("constant", constant_winds(10.0, 10.0)),
                         ("time-cosine",
                          time_cosine_winds(10.0, 5.0, period=6 * 3600.0))):
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cases.append((wname, winds, method, adaptive, 0.0))
    cases.append(("constant", constant_winds(10.0, 10.0), "bosh3", True,
                  2.0 ** 19))
    cases.append(("constant", constant_winds(10.0, 10.0), "tsit5", False,
                  2.0 ** 19))
    for wname, winds, method, adaptive, t0v in cases:
        cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                           force_dtmin=True)
        t = torch.full_like(comps[0], t0v)
        dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
        err, nfail = check_k1(f"K1 {wname} {method} "
                              f"{'adaptive' if adaptive else 'fixed'} "
                              f"t0={t0v:g}", winds, consts, flags, cfg, comps,
                              t, dt, active, grid, proj)
        if not adaptive:
            k1_err = max(k1_err, err)
        if t0v > 0:
            assert nfail == 0, f"K1 {wname} {method}: lanes failed at t = " \
                               f"2^19 s"

    results["K1"]["max_abs_err"] = k1_err


def check_k1(tag, winds, consts, flags, cfg, comps, t, dt, active, grid,
             proj):
    """K1 on these inputs bit for bit its _simple baseline and against
    integrate_to: fixed substeps within rtol 1e-5 with dt, failed and
    naccept equal; adaptive by share of lanes (``assert_adaptive``,
    ``assert_controller``), failed equal.  Returns (max abs err, failed
    lanes)."""
    args = (winds, consts, flags, cfg, DT, comps, t, dt, active, grid.x,
            grid.y, proj)
    k = advance_cuda(*args)
    assert_bitwise(tag, k, advance_cuda(*args, simple=True))
    rhs = make_rhs(winds.u, winds.v, consts, flags)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    p = integrate_to(rhs, torch.stack(comps, dim=-1), t, t + DT, dt, aux,
                     active, cfg)
    torch.cuda.synchronize()
    names = ("lne", "cgx", "cgy", "x", "y")
    extra = ""
    if cfg.adaptive:
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        errs = [assert_adaptive(f"{tag} {nm}", kz, p.z[..., i])
                for i, (nm, kz) in enumerate(zip(names, k[:5]))]
        assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
        extra = "; " + assert_controller(tag, k, p, active)
    else:
        errs = [assert_close(f"{tag} {nm}", kz, p.z[..., i], 1e-5, 1e-6)
                for i, (nm, kz) in enumerate(zip(names, k[:5]))]
        errs.append(assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0))
        assert torch.equal(k.dt, p.dt), f"{tag}: dt not carried as given"
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        assert torch.equal(k.naccept, p.naccept), f"{tag}: naccept differs"
    nfail = int(k.failed.sum())
    log("K1", f"{tag}: max abs err {max(errs):.3e}, substeps max "
              f"{int(k.naccept.max())}/{int(p.naccept.max())}, "
              f"failed {nfail}{extra}; bitwise equal to _simple")
    return max(errs), nfail


def phase_k3(dev, results):
    """K3, the dt reset, bit for bit against its ``_simple`` baseline
    followed by PyTorch's clamp and select, and within rtol 1e-5 of
    ``auto_dt_reset``, the unreset lanes keeping their dt bit for bit: on
    the perturbed 256^2 state for the three wind families at both estimate
    orders (bosh3's exponent 1/4, tsit5's 1/6), every lane reset and about
    half, at t = 1800 s and 2^19 s; on the same state with NaN and +-Inf in
    lne and dt on reset and unreset lanes; two other flag sets (the generic
    instance); and on a 64 x 6000 grid, wider than the JAX package's
    auto-dt kernel takes."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    n = 256
    families = (("constant", constant_winds(10.0, 10.0)),
                ("half-domain", half_domain_winds(10.0, 5.0, 1e3 * (n - 1),
                                                  background=2.0)),
                ("time-cosine",
                 time_cosine_winds(10.0, 5.0, period=6 * 3600.0)))
    comps, dt0, _, grid = perturbed_state(n, dev, seed=0)
    half = half_reset_mask((n, n), dev, seed=20)
    every = torch.ones_like(half)
    # NaN and +-Inf in lne and dt, on reset and unreset lanes
    rng = np.random.default_rng(21)
    idx = torch.as_tensor(rng.choice(n * n, 64, replace=False), device=dev)
    vals = torch.tensor([float("nan"), float("inf"), -float("inf"),
                         float("nan")] * 16, device=dev)
    lne_bad, dt_bad = comps[0].clone(), dt0.clone()
    lne_bad.view(-1)[idx[:32]] = vals[:32]
    dt_bad.view(-1)[idx[32:]] = vals[32:]
    for part in (idx[:32], idx[32:]):
        on = half.view(-1)[part]
        assert bool(on.any()) and bool((~on).any())
    bad = ((lne_bad, *comps[1:]), dt_bad)

    cases = []   # (tag, winds, flags, (comps, dt), grid, reset, t0, order)
    for wname, winds in families:
        for order in (3.0, 5.0):
            cases += [(f"{wname} order {order:g} all reset", winds,
                       TermFlags(), (comps, dt0), grid, every, 1800.0, order),
                      (f"{wname} order {order:g} half reset", winds,
                       TermFlags(), (comps, dt0), grid, half, 1800.0, order),
                      (f"{wname} order {order:g} half reset t0=2^19", winds,
                       TermFlags(), (comps, dt0), grid, half, 2.0 ** 19,
                       order),
                      (f"{wname} order {order:g} NaN/Inf lanes", winds,
                       TermFlags(), bad, grid, half, 1800.0, order)]
    cases += [("constant, no direction term (generic)", families[0][1],
               TermFlags(direction=False), (comps, dt0), grid, half, 1800.0,
               5.0),
              ("time-cosine, no input or peak-shift term (generic)",
               families[2][1], TermFlags(input=False, peak_shift=False),
               (comps, dt0), grid, half, 1800.0, 5.0)]
    wc, wdt, _, wgrid = perturbed_state(64, dev, seed=23, ny=6000)
    for tag, reset in (("all reset", torch.ones_like(wdt, dtype=torch.bool)),
                       ("half reset", half_reset_mask((64, 6000), dev, 24))):
        cases.append((f"64 x 6000 constant {tag}", families[0][1],
                      TermFlags(), (wc, wdt), wgrid, reset, 1800.0, 5.0))

    k3_err = 0.0
    for tag, winds, flags, (cs, dt), g, reset, t0, order in cases:
        proj = (float(g.proj[0, 0, 0, 0]), 0.0, 0.0,
                float(g.proj[0, 0, 1, 1]), 0.0)
        t = torch.full_like(dt, t0)

        def k3(simple):
            return auto_dt_cuda(winds, consts, flags, t, cs, g.x, g.y, proj,
                                reset, dt, 1e-4, DT, order=order,
                                simple=simple)
        k = k3(False)
        assert_bitwise(f"K3 {tag}", (k,), (k3(True),))
        assert torch.equal(bits(k[~reset]), bits(dt[~reset])), \
            f"K3 {tag}: an unreset lane lost its dt"
        p = auto_dt_reset(make_rhs(winds.u, winds.v, consts, flags), t,
                          torch.stack(cs, dim=-1),
                          RHSParams(x=g.x, y=g.y, M=g.proj, pc=g.pc), reset,
                          dt, 1e-4, DT, order=order)
        err = assert_close(f"K3 {tag}", k, p, 1e-5, 0.0)
        k3_err = max(k3_err, err)
        log("K3", f"{tag}: {int(reset.sum())} of {reset.numel()} reset, "
                  f"{int(torch.isnan(k).sum())} NaN; bitwise equal to _simple "
                  f"+ clamp + where; max abs err {err:.3e} against the plain "
                  f"version")
    results["K3"]["max_abs_err"] = k3_err


def phase_k2(dev, results):
    """K2 against scatter_dense and bit for bit against its _simple baseline
    at 1536^2, both timed in turns at the flagship's halo and at halo 3."""
    rng = np.random.default_rng(1)
    n = FLAG_N
    k2_err = 0.0
    cases = [(True, ((0, 3), (0, 3)), (-0.2, 3.2)),
             (True, 3, (-3.2, 3.2)),
             (False, ((1, 2), (2, 1)), (-2.2, 2.2))]
    for periodic, halo, (lo, hi) in cases:
        b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC
        stats = GridStats(nx=n, ny=n, bx=b, by=b)

        def plane(fn, *a):
            return torch.as_tensor(fn(*a, (n, n)).astype(np.float32),
                                   device=dev)

        xr, yr = plane(rng.uniform, lo, hi), plane(rng.uniform, lo, hi)
        chans = (plane(rng.uniform, 0.0, 1.0), plane(rng.normal, 0.0, 0.1),
                 plane(rng.normal, 0.0, 0.1))
        act = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
        k2_err = max(k2_err, check_k2(
            f"K2 {'periodic' if periodic else 'open'} halo {halo}", xr, yr,
            chans, act, stats, halo))
        if periodic:
            simple_ms, ms = turns_ms(
                "K2", lambda: pic_gather(xr, yr, chans, act, stats, halo,
                                         simple=True),
                lambda: pic_gather(xr, yr, chans, act, stats, halo), 20)
            plain_ms = cuda_time_ms(
                lambda: scatter_dense(xr, yr, torch.stack(chans, dim=-1), act,
                                      stats, halo), 5)
            b = deposit_bound(n * n, n * n, halo)
            pre = "" if halo == ((0, 3), (0, 3)) else "halo3_"
            results["K2"].update({pre + "ms": ms, pre + "simple_ms": simple_ms,
                                  pre + "plain_ms": plain_ms,
                                  pre + "bound_ms": b["bound_ms"],
                                  pre + "bound_by": b["bound_by"]})
            log("kernel-time", f"K2 halo {halo}: {ms:.4f} ms, _simple "
                               f"{simple_ms:.4f} ms (in turns), plain "
                               f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} "
                               f"ms ({b['bound_by']})")
    results["K2"]["max_abs_err"] = k2_err


def check_k2(tag, xr, yr, chans, act, stats, halo) -> float:
    """K2 on these inputs bit for bit its _simple baseline and itself (two
    runs), within rtol 1e-5 of scatter_dense with the clamped count equal,
    and on a periodic grid conserving E.  Returns the max abs error."""
    (o, st) = pic_gather(xr, yr, chans, act, stats, halo)
    (o2, st2) = pic_gather(xr, yr, chans, act, stats, halo)
    S, st_p = scatter_dense(xr, yr, torch.stack(chans, dim=-1), act, stats,
                            halo)
    torch.cuda.synchronize()
    assert_bitwise(tag, o, pic_gather(xr, yr, chans, act, stats, halo,
                                      simple=True)[0])
    err = 0.0
    for c in range(3):
        scale = float(S[..., c].abs().max())
        err = max(err, assert_close(f"{tag} ch{c}", o[c], S[..., c], 1e-5,
                                    1e-6 * scale))
        assert torch.equal(o[c], o2[c]), f"{tag}: two runs differ"
    assert int(st.clamped) == int(st_p.clamped), \
        f"{tag}: clamped {int(st.clamped)} vs {int(st_p.clamped)}"
    if stats.bx == Boundary.PERIODIC and stats.by == Boundary.PERIODIC:
        src = float((chans[0].double() * act).sum())
        dep = float(o[0].double().sum())
        assert abs(dep - src) <= 1e-5 * abs(src), \
            f"{tag}: E not conserved ({dep} vs {src})"
    log("K2", f"{tag}: max abs err {err:.3e}, clamped {int(st.clamped)}, "
              f"bitwise repeatable, bitwise equal to _simple")
    return err


KERNEL_FNS = {"K1": advance_cuda, "K2": pic_gather, "K3": auto_dt_cuda,
              "K4": pic_gather_padded, "K5": remesh_cuda,
              "K6": pic_gather_remesh}


def counters():
    return {k: fn.launches for k, fn in KERNEL_FNS.items()}


def reset_counters():
    for fn in KERNEL_FNS.values():
        fn.launches = 0


def eager_steps(model, ms, n: int):
    """``n`` eager steps, ``model.step`` in a loop: the host launches every
    kernel through its wrapper, whose launch counter ticks once a step (a
    replayed graph runs the kernels without the wrappers)."""
    for _ in range(n):
        ms = model.step(ms)
    return ms


def drive(model, ms, n: int, eager: bool):
    """``n`` steps: eager, or through ``step_n_quiet`` (a replayed CUDA
    graph where the model is graphed)."""
    return eager_steps(model, ms, n) if eager else model.step_n_quiet(ms, n)


def time_steps(model, ms, n_steps: int, eager: bool = False):
    """Run ``n_steps`` steps (``drive``); returns (state, device ms per
    step)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ms = drive(model, ms, n_steps, eager)
    end.record()
    torch.cuda.synchronize()
    return ms, start.elapsed_time(end) / n_steps


def assert_state_bitwise(tag: str, got, want) -> None:
    """Every leaf of two model states equal bit for bit (NaN payloads
    included), counters too."""
    for i, (a, b) in enumerate(zip(got.leaves(), want.leaves())):
        same = torch.equal(bits(a), bits(b)) if a.is_floating_point() \
            else torch.equal(a, b)
        assert same, f"{tag}: leaf {i} differs"


def check_state(tag: str, ms, **expect):
    assert bool(torch.isfinite(ms.state).all()), f"{tag}: state not finite"
    m = ms.metrics.as_dict()
    for k, v in expect.items():
        assert m[k] == v, f"{tag}: {k} = {m[k]}, expected {v}"
    return m


def phase_main_path(dev, results, timing):
    """Flagship then default config through WaveGrowth2D, counters reset
    just before and read just after: eager steps (``model.step`` in a
    loop), so that every step's launches are counted."""
    n = FLAG_N
    flag = flagship_model(n, dev)
    default = default_model(n, dev)
    assert flag.resolved_config().advance_mode == "cuda"
    assert flag.resolved_config().scatter_mode == "dense_cuda"
    assert flag.graphed and default.graphed
    s_flag, s_def = flag.init_state(), default.init_state()

    reset_counters()
    s_flag = eager_steps(flag, s_flag, 4)
    m = check_state("flagship spin-up", s_flag, n_failed=0, n_clamped=0)
    c0 = counters()
    assert c0["K1"] == 4 and c0["K2"] == 4 and c0["K3"] == 0, c0
    steps = 20
    s_flag, ms_step = time_steps(flag, s_flag, steps, eager=True)
    m = check_state("flagship", s_flag, n_failed=0, n_clamped=0)
    c1 = counters()
    assert c1["K1"] - c0["K1"] == steps and c1["K2"] - c0["K2"] == steps, c1
    timing["flagship_ms_per_step"] = ms_step
    timing["flagship_pushes_per_s"] = n * n / (ms_step / 1e3)
    log("flagship", f"{n}^2 bosh3 carry: {ms_step:.3f} ms/step eager, "
                    f"{n * n / (ms_step / 1e3):.4e} pushes/s; metrics {m}")

    d_steps = 3
    s_def, ms_def = time_steps(default, s_def, d_steps, eager=True)
    m = check_state("default", s_def, n_failed=0)
    c2 = counters()
    assert c2["K1"] - c1["K1"] == d_steps and c2["K2"] - c1["K2"] == d_steps
    assert c2["K3"] - c1["K3"] == d_steps, \
        f"the default config launched K3 {c2['K3'] - c1['K3']} times in " \
        f"{d_steps} steps"
    timing["default_ms_per_step"] = ms_def
    timing["default_pushes_per_s"] = n * n / (ms_def / 1e3)
    log("default", f"{n}^2 tsit5 auto-dt: {ms_def:.3f} ms/step eager (first "
                   f"{d_steps} steps from seed), {n * n / (ms_def / 1e3):.4e} "
                   f"pushes/s; metrics {m}")
    for k in ("K1", "K2", "K3"):
        results[k]["launches"] = c2[k]
        assert c2[k] > 0, f"{k} was not launched on the main path"
    log("counters", f"main path launches {c2}")

    # the same 3 steps with K3's _simple baseline and PyTorch's clamp and
    # select in the step: every leaf of the state equal, bit for bit
    orig = W2D.auto_dt_cuda
    W2D.auto_dt_cuda = functools.partial(orig, simple=True)
    try:
        s_simple = eager_steps(default, default.init_state(), d_steps)
    finally:
        W2D.auto_dt_cuda = orig
    assert_state_bitwise("default config, 3 steps, against the step with "
                         "K3's _simple + clamp + where", s_def, s_simple)
    log("default", f"{d_steps} steps bitwise equal (dt and every other "
                   f"leaf) to the step with K3's _simple + clamp + where")
    return flag, s_flag, default, s_def


def phase_k3_times(default, s_def, results):
    """K3 at the main path's shape (FLAG_N^2) on the default configuration's
    state, every lane reset (the steady state: every lane gathers) and
    about half (whole warps unreset among mixed ones): bit for bit against
    its _simple baseline + PyTorch's clamp and select, within rtol 1e-5 of
    the plain version, and timed in turns with the baseline.  It runs right
    after the main path, before the profiler has run many sessions."""
    Q, sett, n = s_def.particles, default.settings, FLAG_N * FLAG_N
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    dg = default.grid

    def k3(reset, simple=False):
        return auto_dt_cuda(default.winds, default.consts, default.flags,
                            Q.t, qc, dg.x, dg.y, default.uniform_proj, reset,
                            Q.dt, sett.dtmin, DT, abstol=sett.abstol,
                            reltol=sett.reltol, order=default._rk_order,
                            simple=simple)

    def k3_plain(reset):
        return auto_dt_reset(default.rhs, Q.t, torch.stack(qc, dim=-1),
                             default.aux, reset, Q.dt, sett.dtmin, DT,
                             abstol=sett.abstol, reltol=sett.reltol,
                             order=default._rk_order)

    for pre, reset in (("", torch.ones_like(Q.on)),
                       ("half_reset_", half_reset_mask(Q.t.shape, Q.t.device,
                                                       seed=22))):
        tag = f"K3 {FLAG_N}^2 default state, {int(reset.sum())} of {n} reset"
        k = k3(reset)
        assert_bitwise(tag, (k,), (k3(reset, True),))
        err = assert_close(tag, k, k3_plain(reset), 1e-5, 0.0)
        results["K3"]["max_abs_err"] = max(results["K3"]["max_abs_err"], err)
        simple_ms, ms = turns_ms("K3", lambda: k3(reset, True),
                                 lambda: k3(reset), 20)
        b = k3_bound(reset, kernel_wind(default.winds))
        results["K3"].update({pre + "ms": ms, pre + "simple_ms": simple_ms,
                              pre + "plain_ms": cuda_time_ms(
                                  lambda: k3_plain(reset), 5),
                              pre + "bound_ms": b["bound_ms"],
                              pre + "bound_by": b["bound_by"]})
        log("K3", f"{tag}: bitwise equal to _simple + clamp + where, max abs "
                  f"err {err:.3e} against the plain version; {ms:.4f} ms, "
                  f"_simple + tail {simple_ms:.4f} ms (in turns), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")


def phase_card_vs_cpu():
    """64^2: kernels on the card against the plain versions on the CPU."""
    for name, mk in (("flagship", flagship_model), ("default", default_model)):
        mg, mc = mk(64, "cuda"), mk(64, "cpu")
        assert mc.resolved_config().advance_mode == "torch"
        sg, sc = mg.init_state(), mc.init_state()
        for _ in range(3):
            sg, sc = mg.step(sg), mc.step(sc)
        S = sc.state
        err = assert_close(f"card vs CPU {name}", sg.state.cpu(), S, 5e-3,
                           1e-6 * float(S.abs().max()))
        assert_close(f"card vs CPU {name} dt", sg.particles.dt.cpu(),
                     sc.particles.dt, 5e-3, 0.0)
        mg_, mc_ = sg.metrics.as_dict(), sc.metrics.as_dict()
        assert mg_ == mc_, f"card vs CPU {name}: counters {mg_} vs {mc_}"
        log("card-vs-cpu", f"{name} 64^2, 3 steps: max abs err {err:.3e}")


def phase_kernel_times(flag, s_flag, default, s_def, results):
    """K1 at the main path's shape (FLAG_N^2) on its own states: held
    against its plain version, bit for bit against its _simple baseline
    (both methods, adaptive and fixed-substep, at the state's clock and at
    t0 = 2^19 s), then timed beside them; K2 at halo 3 on the default
    configuration's deposit against its _simple baseline."""
    P = s_flag.particles
    adv = P.on & flag.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    g = flag.grid

    def k1():
        return advance_cuda(flag.winds, flag.consts, flag.flags, flag.solver,
                            DT, comps, P.t, P.dt, adv, g.x, g.y,
                            flag.uniform_proj)

    def k1_plain():
        return integrate_to(flag.rhs, torch.stack(comps, dim=-1), P.t,
                            P.t + DT, P.dt, flag.aux, adv, flag.solver)

    k, p = k1(), k1_plain()
    # the main path's own state, one substep per lane: every lane on the
    # plain version's path, and its outputs to float32 rounding
    assert torch.equal(k.failed, p.failed), "K1 main-path state: failed differs"
    assert torch.equal(k.naccept, p.naccept), \
        "K1 main-path state: naccept differs"
    err = max(assert_close(f"K1 flagship state {nm}", kz, p.z[..., i], 1e-5,
                           1e-6)
              for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                               k[:5])))
    # the proposal dt = 600 s * 0.9 * enorm^(-1/3), unclipped here; enorm is
    # a sum of stage derivatives that cancel, so last-ulp differences in them
    # move it by ~5e-4 and dt by ~1.6e-4 (measured on the card); a safety
    # factor or exponent off by a few percent moves dt by as much
    err_dt = assert_close("K1 flagship state dt", k.dt, p.dt, 1e-3, 0.0)
    assert_close("K1 flagship state t", k.t, p.t, 1e-6, 0.0)
    log("K1", f"{FLAG_N}^2 flagship state (bosh3 adaptive): max abs err "
              f"{err:.3e}, dt {err_dt:.3e} (dt {float(p.dt.min()):.2f}-"
              f"{float(p.dt.max()):.2f} s), naccept equal on every lane "
              f"({int(p.naccept.min())}-{int(p.naccept.max())})")
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)
    n = FLAG_N * FLAG_N
    simple_ms, ms = turns_ms(
        "K1", lambda: advance_cuda(flag.winds, flag.consts, flag.flags,
                                   flag.solver, DT, comps, P.t, P.dt, adv,
                                   g.x, g.y, flag.uniform_proj, simple=True),
        k1, 10)
    results["K1"].update(ms=ms, simple_ms=simple_ms,
                         plain_ms=cuda_time_ms(k1_plain, 2),
                         **k1_bound(n, flag.solver.method, True, adv,
                                    p.naccept + p.nreject))

    for tag, model, st in (("flagship", flag, s_flag), ("default", default,
                                                        s_def)):
        Q = st.particles
        qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
        q_adv = Q.on & model.active_mask
        for method in ("bosh3", "tsit5"):
            for adaptive in (True, False):
                cfg = dataclasses.replace(model.solver, method=method,
                                          adaptive=adaptive)
                for t in (Q.t, torch.full_like(Q.t, 2.0 ** 19)):
                    k, ks = (advance_cuda(model.winds, model.consts,
                                          model.flags, cfg, DT, qc, t, Q.dt,
                                          q_adv, model.grid.x, model.grid.y,
                                          model.uniform_proj, simple=simple)
                             for simple in (False, True))
                    assert_bitwise(f"K1 {tag} state {method} adaptive="
                                   f"{adaptive} t0={float(t.max()):g}", k, ks)
    log("K1", f"{FLAG_N}^2 flagship and default states: bosh3 and tsit5, "
              f"adaptive and fixed-substep, at the state's clock and at "
              f"t0 = 2^19 s: bitwise equal to _simple")

    Q = s_def.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)

    # K1 on the default config's state (tsit5, several substeps per lane).
    # Its last substep is shortened to land on t_end, so the proposal dt is
    # rounding noise on this uniform state (the config replaces it by K3's
    # estimate on every reset lane): the substep counts and the components
    # are held, dt is not
    q_adv = Q.on & default.active_mask
    k = advance_cuda(default.winds, default.consts, default.flags,
                     default.solver, DT, qc, Q.t, Q.dt, q_adv, g.x, g.y,
                     default.uniform_proj)
    p = integrate_to(default.rhs, torch.stack(qc, dim=-1), Q.t, Q.t + DT,
                     Q.dt, default.aux, q_adv, default.solver)
    assert torch.equal(k.failed, p.failed), "K1 default state: failed differs"
    errs = [assert_adaptive(f"K1 default state {nm}", kz, p.z[..., i])
            for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                             k[:5]))]
    share = float((k.naccept == p.naccept).double().mean())
    assert share >= 0.95, f"K1 default state: naccept equal on {share:.4%}"

    def k1d(simple):
        return advance_cuda(default.winds, default.consts, default.flags,
                            default.solver, DT, qc, Q.t, Q.dt, q_adv, g.x,
                            g.y, default.uniform_proj, simple=simple)

    simple_ms, ms = turns_ms("K1", lambda: k1d(True), lambda: k1d(False), 5)
    b = k1_bound(n, default.solver.method, True, q_adv,
                 p.naccept + p.nreject)
    results["K1"].update(default_ms=ms, default_simple_ms=simple_ms,
                         default_plain_ms=cuda_time_ms(
                             lambda: integrate_to(
                                 default.rhs, torch.stack(qc, dim=-1), Q.t,
                                 Q.t + DT, Q.dt, default.aux, q_adv,
                                 default.solver), 2),
                         default_bound_ms=b["bound_ms"],
                         default_bound_by=b["bound_by"])
    log("kernel-time", f"K1 default state ({default.solver.method}, "
                       f"{float((p.naccept + p.nreject)[q_adv].double().mean()):.2f} "
                       f"substeps tried a lane): {ms:.4f} ms, _simple "
                       f"{simple_ms:.4f} ms (in turns), plain "
                       f"{results['K1']['default_plain_ms']:.4f} ms, bound "
                       f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    log("K1", f"{FLAG_N}^2 default state (tsit5 adaptive): max abs err "
              f"{max(errs):.3e}; naccept equal on {share:.4%} "
              f"({int(p.naccept.min())}-{int(p.naccept.max())}); dt max abs "
              f"err {max_abs(k.dt, p.dt):.3e}")

    core, chans, sact = flagship_deposit_inputs(default, s_def)
    halo, stats = default.config.halo, default.grid.stats
    node, _ = pic_gather(core[3], core[4], chans, sact, stats, halo)
    assert_bitwise(f"K2 default deposit halo {halo}", node,
                   pic_gather(core[3], core[4], chans, sact, stats, halo,
                              simple=True)[0])
    log("K2", f"{FLAG_N}^2 default configuration's deposit, halo {halo}: "
              f"bitwise equal to _simple")
    for k in ("K1", "K3"):
        r = results[k]
        log("kernel-time", f"{k}: {r['ms']:.4f} ms, _simple "
                           f"{r['simple_ms']:.4f} ms (in turns), plain "
                           f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                           f"ms ({r['bound_by']})")


def phase_twin_timing(timing, steps: int):
    """The flagship with the plain versions on the card."""
    n = FLAG_N
    m = flagship_model(n, "cuda", advance_mode="torch", scatter_mode="dense")
    ms = m.step_n_quiet(m.init_state(), 4)
    ms, ms_step = time_steps(m, ms, steps)
    check_state("flagship twin", ms, n_failed=0, n_clamped=0)
    timing["flagship_plain_ms_per_step"] = ms_step
    timing["flagship_plain_steps"] = steps
    log("twin-timing", f"{n}^2 flagship, advance torch + scatter dense: "
                       f"{ms_step:.3f} ms/step over {steps} steps, "
                       f"{n * n / (ms_step / 1e3):.4e} pushes/s; kernels "
                       f"{timing['flagship_ms_per_step']:.3f} ms/step")


def remesh_case(dev, n: int, boundary_type: str, adaptive: bool, seed: int,
                ny: int = 0):
    """A non-periodic n^2 box (n x ny with ``ny``) with half-domain winds
    and a perturbed node state (a third of the nodes below the minimal
    state, dt spread over [1e-6, 3000] s): gather, reseed and off all fire.
    Returns (model, node planes, the remesh's particle planes, masks,
    coordinates and clock)."""
    ny = ny or n
    comps, _, _, _ = perturbed_state(n, dev, seed, ny=ny)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (ny - 1), ny, device=dev)
    sett = ODESettings(log_energy_minimum=settings("bosh3").log_energy_minimum,
                       timestep=DT, dt=37.5, dtmin=1e-4, adaptive=adaptive,
                       solver="bosh3")
    m = WaveGrowth2D(grid, half_domain_winds(10.0, 5.0, 1e3 * (n - 1)), sett,
                     config=WaveGrowth2DConfig(periodic_boundary=False,
                                               boundary_type=boundary_type,
                                               dt_reset_mode="carry",
                                               remesh_mode="pallas"))
    rng = np.random.default_rng(seed + 1)

    def plane(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    low = plane(np.where(rng.uniform(size=(n, ny)) < 0.3,
                         rng.uniform(0, 1e-4, (n, ny)), 1.0))
    node = tuple((c * low).contiguous()
                 for c in TR.particle_to_node(*comps[:3]))
    dt = plane(np.exp(rng.uniform(np.log(1e-6), np.log(3000.0), (n, ny))))
    on = torch.as_tensor(rng.uniform(size=(n, ny)) < 0.8, device=dev)
    core = (*comps, dt, on, m.active_mask.contiguous(),
            m.boundary_mask.contiguous(), grid.x, grid.y,
            torch.tensor(1800.0, device=dev))
    return m, node, core


def assert_remesh(tag: str, k, p) -> float:
    """A kernel's RemeshResult against the plain version's: bits, flags, dt
    and positions equal, the values within REMESH_RTOL; returns the max
    abs error of the values."""
    for f in ("branch", "on", "dt", "px", "py"):
        a, b = getattr(k, f), getattr(p, f)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {f} differs on "
                                 f"{int((a != b).sum())} lanes")
    return max(assert_close(f"{tag} {f}", getattr(k, f), getattr(p, f),
                            REMESH_RTOL, 0.0) for f in ("lne", "cgx", "cgy"))


def branch_counts(br) -> str:
    return " ".join(f"{nm} {int(((br & bit) != 0).sum())}"
                    for nm, bit in (("gather", 1), ("reseed", 2), ("off", 4)))


def phase_k5_k6(dev, results):
    """K5 against remesh_core and K6 against K2 + K5 and against
    scatter_dense + remesh_core, at 256^2 where every branch fires."""
    k5_err = k6_err = 0.0
    seed = 10
    for bt in ("same", "wind_sea", "mininmal"):
        for adaptive in (True, False):
            seed += 1
            m, node, core = remesh_case(dev, 256, bt, adaptive, seed)
            e5, e6 = check_k5_k6(f"{bt} clip_dt={m.remesh_params.clip_dt}",
                                 m, node, core)
            k5_err, k6_err = max(k5_err, e5), max(k6_err, e6)
    results["K5"]["max_abs_err"] = k5_err
    results["K6"]["max_abs_err"] = k6_err


def check_k5_k6(tag: str, m, node, core, bitwise: bool = False):
    """K5 against remesh_core (``assert_remesh``, every branch firing;
    ``bitwise``: its values bit for bit too) and
    K6 bit for bit K2 + K5, its _simple baseline and itself (two runs), its
    node planes within rtol 1e-5 of scatter_dense and its branch bits and
    ``on`` those of remesh_core over them.  Returns the two max abs
    errors."""
    k = remesh_cuda(m.remesh_params, node, *core)
    p = remesh_core(m.remesh_params, node, *core)
    torch.cuda.synchronize()
    k5_err = assert_remesh(f"K5 {tag}", k, p)
    same = all(torch.equal(getattr(k, f), getattr(p, f))
               for f in ("lne", "cgx", "cgy"))
    assert same or not bitwise, f"K5 {tag}: values differ from remesh_core"
    for bit in (1, 2, 4):
        assert int(((k.branch & bit) != 0).sum()) > 0, (tag, bit)
    log("K5", f"{tag}: {branch_counts(k.branch)}; values max abs err "
              f"{k5_err:.3e}{' (bitwise equal)' if same else ''}")

    lne, cgx, cgy, px, py = core[:5]
    chans = TR.particle_to_node(lne, cgx, cgy)
    sact = (core[6] & core[7]).contiguous()
    stats, halo = m.grid.stats, ((1, 3), (0, 2))
    nd, rm, st = pic_gather_remesh(px, py, chans, sact, stats, halo,
                                   m.remesh_params, *core)
    nd2, rm2, _ = pic_gather_remesh(px, py, chans, sact, stats, halo,
                                    m.remesh_params, *core)
    nds, rms, _ = pic_gather_remesh(px, py, chans, sact, stats, halo,
                                    m.remesh_params, *core, simple=True)
    k2, st2 = pic_gather(px, py, chans, sact, stats, halo)
    k5 = remesh_cuda(m.remesh_params, k2, *core)
    S, st_p = scatter_dense(px, py, torch.stack(chans, -1), sact, stats,
                            halo)
    plain = remesh_core(m.remesh_params, tuple(S[..., c] for c in range(3)),
                        *core)
    torch.cuda.synchronize()
    tag = f"K6 {tag}"
    assert_bitwise(tag, (*nd, *rm), (*nds, *rms))
    for a, b, c in zip(nd, k2, nd2):
        assert torch.equal(a, b), f"{tag}: node plane != K2's"
        assert torch.equal(a, c), f"{tag}: two runs differ"
    for f in rm._fields:
        assert torch.equal(getattr(rm, f), getattr(k5, f)), \
            f"{tag}: {f} != K2 + K5"
        assert torch.equal(getattr(rm, f), getattr(rm2, f)), \
            f"{tag}: two runs differ in {f}"
    assert int(st.clamped) == int(st2.clamped) == int(st_p.clamped)
    k6_err = max(assert_close(f"{tag} node ch{c}", nd[c], S[..., c], 1e-5,
                              1e-6 * float(S[..., c].abs().max()))
                 for c in range(3))
    assert torch.equal(rm.branch, plain.branch), f"{tag}: bits"
    assert torch.equal(rm.on, plain.on), f"{tag}: on"
    log("K6", f"{tag}: equal to K2 + K5 bitwise and to _simple bitwise, two "
              f"runs bitwise equal; node planes vs plain max abs err "
              f"{k6_err:.3e}, bits equal; {branch_counts(rm.branch)}")
    return k5_err, k6_err


def phase_wide_grid(dev, results):
    """K1, K2, K5 and K6 on a 64 x 6000 grid, wider than the JAX package's
    kernels take in VMEM (K3 runs there in phase "K3"): K1 bit for bit its
    _simple baseline and against integrate_to (adaptive bosh3 by its share
    rules, fixed-substep tsit5 within rtol 1e-5); K2 bit for bit its
    _simple baseline, within rtol 1e-5 of scatter_dense (the flagship's
    halo, periodic; halo 3, open); K5 bit for bit remesh_core and K6 bit
    for bit K2 + K5 and its _simple baseline (``check_k5_k6``)."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    nx, ny = 64, 6000
    comps, dt0, active, grid = perturbed_state(nx, dev, seed=40, ny=ny)
    proj = (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
            float(grid.proj[0, 0, 1, 1]), 0.0)
    t = torch.full_like(dt0, 1800.0)
    for method, adaptive in (("bosh3", True), ("tsit5", False)):
        cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                           force_dtmin=True)
        dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
        err, _ = check_k1(f"K1 {nx} x {ny} {method} "
                          f"{'adaptive' if adaptive else 'fixed'}",
                          constant_winds(10.0, 10.0), consts, TermFlags(),
                          cfg, comps, t, dt, active, grid, proj)
        if not adaptive:
            results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"],
                                               err)
    rng = np.random.default_rng(41)
    for periodic, halo, (lo, hi) in ((True, ((0, 3), (0, 3)), (-0.2, 3.2)),
                                     (False, 3, (-3.2, 3.2))):
        b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC

        def plane(fn, *a):
            return torch.as_tensor(fn(*a, (nx, ny)).astype(np.float32),
                                   device=dev)

        chans = (plane(rng.uniform, 0.0, 1.0), plane(rng.normal, 0.0, 0.1),
                 plane(rng.normal, 0.0, 0.1))
        err = check_k2(f"K2 {nx} x {ny} halo {halo}",
                       plane(rng.uniform, lo, hi), plane(rng.uniform, lo, hi),
                       chans, torch.as_tensor(rng.uniform(size=(nx, ny)) < 0.9,
                                              device=dev),
                       GridStats(nx=nx, ny=ny, bx=b, by=b), halo)
        results["K2"]["max_abs_err"] = max(results["K2"]["max_abs_err"], err)
    m, node, core = remesh_case(dev, nx, "wind_sea", True, 42, ny=ny)
    e5, e6 = check_k5_k6(f"{nx} x {ny}", m, node, core, bitwise=True)
    for k, e in (("K5", e5), ("K6", e6)):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], e)


def flagship_deposit_inputs(flag, s_flag):
    """The inputs of the flagship's deposit and remesh at FLAG_N^2: one
    advance (K1) of the main path's state, as a step makes them."""
    P = s_flag.particles
    adv = P.on & flag.active_mask
    g = flag.grid
    res = advance_cuda(flag.winds, flag.consts, flag.flags, flag.solver,
                       float(flag.settings.timestep),
                       (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, P.dt, adv,
                       g.x, g.y, flag.projection(g),
                       wind_fields=flag.wind_fields(g, s_flag.time))
    core = (res.lne, res.cgx, res.cgy, res.x, res.y, res.dt, P.on,
            flag.active_mask, flag.boundary_mask, g.x, g.y, s_flag.time)
    chans = TR.particle_to_node(res.lne, res.cgx, res.cgy)
    return core, chans, adv


def phase_remesh_kernel_times(flag, s_flag, results):
    """K5 and K6 on the flagship's own deposit at FLAG_N^2: held against
    their plain versions, then timed beside them."""
    core, chans, sact = flagship_deposit_inputs(flag, s_flag)
    g, halo, p = flag.grid, flag.config.halo, flag.remesh_params
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    k = remesh_cuda(p, node, *core)
    pl = remesh_core(p, node, *core)
    err = assert_remesh("K5 flagship", k, pl)
    results["K5"]["max_abs_err"] = max(results["K5"]["max_abs_err"], err)
    nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, p, *core)
    for a, b in zip(nd, node):
        assert torch.equal(a, b), "K6 flagship: node planes != K2's"
    for f in rm._fields:
        assert torch.equal(getattr(rm, f), getattr(k, f)), \
            f"K6 flagship: {f} != K2 + K5"
    S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                         g.stats, halo)
    err6 = max(assert_close(f"K6 flagship node ch{c}", nd[c], S[..., c], 1e-5,
                            1e-6 * float(S[..., c].abs().max()))
               for c in range(3))
    results["K6"]["max_abs_err"] = max(results["K6"]["max_abs_err"], err6)
    log("K5", f"{FLAG_N}^2 flagship deposit: {branch_counts(k.branch)}; "
              f"values max abs err {err:.3e}")
    log("K6", f"{FLAG_N}^2 flagship: equal to K2 + K5 bitwise; node planes "
              f"vs plain max abs err {err6:.3e}")
    node_s, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo,
                           simple=True)
    assert_bitwise("K2 flagship deposit", node, node_s)

    def plain_fused():
        Sp, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                              g.stats, halo)
        return remesh_core(p, tuple(Sp[..., c] for c in range(3)), *core)

    def k6(simple):
        nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                      halo, p, *core, simple=simple)
        return (*nd, *rm)

    assert_bitwise("K6 flagship", k6(False), k6(True))
    n = FLAG_N * FLAG_N
    results["K5"].update(
        ms=kernel_ms(lambda: remesh_cuda(p, node, *core), "K5", 20),
        simple_ms=None,
        plain_ms=cuda_time_ms(lambda: remesh_core(p, node, *core), 5),
        **remesh_bound(n))
    simple_ms, ms = turns_ms("K6", lambda: k6(True), lambda: k6(False), 20)
    results["K6"].update(ms=ms, simple_ms=simple_ms,
                         plain_ms=cuda_time_ms(plain_fused, 5),
                         **deposit_bound(n, n, halo, remesh=True))
    for kk in ("K5", "K6"):
        r = results[kk]
        log("kernel-time", f"{kk}: {r['ms']:.4f} ms"
                           + ("" if r["simple_ms"] is None else
                              f", _simple {r['simple_ms']:.4f} ms (in turns)")
                           + f", plain {r['plain_ms']:.4f} ms, bound "
                             f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# The graphed configurations at full width, with the kernel rows (of the
# kernels line) their replays run
GRAPH_CONFIGS = {"flagship xla": ("K1", "K2"),
                 "flagship pallas": ("K1", "K2", "K5"),
                 "flagship fused": ("K1", "K6"),
                 "default": ("K1", "K2", "K3"),
                 "gridded fused": ("K1 gridded", "K6 gridded"),
                 "gridded default": ("K1 gridded", "K2", "K3 gridded"),
                 "tripolar fused": ("K1 proj", "K6 tripolar")}
GRAPH_STEPS = 8       # steps held bit for bit against the eager steps
TURNS = (7, 10)       # in-turns timing: 7 turns of 10 steps each way


def graph_model(name: str, dev, gw):
    """The model of a GRAPH_CONFIGS entry (``gw``: the gridded record)."""
    n = FLAG_N
    if name.startswith("flagship"):
        return flagship_model(n, dev, remesh_mode=name.split()[1])
    if name == "default":
        return default_model(n, dev)
    if name.startswith("gridded"):
        return gridded_model(n, dev, gw, "production" if name.endswith(
            "fused") else "default")
    return tripolar_model(tripolar_grid(dev, *TRI_SUPER),
                          tripolar_record(dev), "production")


def phase_graphs(dev, gw, results, timing):
    """The compiled drivers at full width (1536^2; the tripolar grid 1440 x
    720), for each configuration of GRAPH_CONFIGS: 2 eager steps from the
    seed, then from that state ``step_n_quiet`` over GRAPH_STEPS steps,
    ``step_n``'s stack row by row, a ragged ``step_n_buffered`` chunk (5
    of 8 rows, the rest zero) and ``step_jit`` twice, each bit for bit the
    eager steps, every leaf (counters included), all from one capture;
    ``step_jit``'s results alias none of the capture's tensors and the
    first is intact after the second.  Measured: warm-up and capture time,
    the memory the capture holds, peak memory graphed against eager, the
    in-graph state copy (timed eagerly), ms/step graphed and eager in
    turns (CUDA events), host enqueue a step, and a ``torch.profiler``
    trace of 5 bare replays (device ops, busy time, idle share; each
    kernel of the configuration under its name once a replay, counted into
    its row's ``graph_launches``).  Each capture is freed (and
    ``torch.cuda.empty_cache()``) before the next configuration."""
    out = {}
    for name, rows in GRAPH_CONFIGS.items():
        model = graph_model(name, dev, gw)
        assert model.graphed, name
        ms = eager_steps(model, model.init_state(), 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        eager_steps(model, ms, GRAPH_STEPS)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - m0
        eager = [ms]
        for _ in range(GRAPH_STEPS):
            eager.append(model.step(eager[-1]))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        g = model._capture(ms)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        # the input and output states stay allocated; the graph's private
        # pool (its intermediates) stays reserved
        held = torch.cuda.memory_allocated() - m0
        pool = torch.cuda.memory_reserved() - r0
        capture_peak = torch.cuda.max_memory_allocated() - m0

        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        for n in (1, 3, GRAPH_STEPS):
            assert_state_bitwise(f"graphs {name}: step_n_quiet({n})",
                                 model.step_n_quiet(ms, n), eager[n])
        torch.cuda.synchronize()
        replay_peak = torch.cuda.max_memory_allocated() - m0
        fin, stack = model.step_n(ms, GRAPH_STEPS)
        assert_state_bitwise(f"graphs {name}: step_n", fin, eager[-1])
        assert_bitwise(f"graphs {name}: step_n's stack", stack,
                       [e.state for e in eager[1:]])
        fin, buf = model.step_n_buffered(ms, 5, 8)
        assert_state_bitwise(f"graphs {name}: step_n_buffered", fin,
                             eager[5])
        assert_bitwise(f"graphs {name}: the buffer's rows", buf[:5],
                       [e.state for e in eager[1:6]])
        assert buf.shape[0] == 8 and not bool(buf[5:].any()), name
        f = model.step_jit()
        s1 = f(ms)
        kept = s1.clone()
        s2 = f(s1)
        assert_state_bitwise(f"graphs {name}: step_jit's first result "
                             f"after the second call", s1, kept)
        assert_state_bitwise(f"graphs {name}: step_jit twice", s2, eager[2])
        bufs = {t.data_ptr() for t in g.state.leaves()
                + g.out.leaves()}
        assert not bufs & {t.data_ptr() for t in s1.leaves()
                           + s2.leaves()}, f"{name}: step_jit aliases"
        assert model._graph is g, f"{name}: captured more than once"
        del stack, buf, s1, s2, kept, fin, eager

        copy_ms = cuda_time_ms(lambda: g.state.copy_(g.out), 10)
        turns = {"eager": [], "graphed": []}
        s = ms
        for rep in range(TURNS[0]):
            for who in (("eager", "graphed") if rep % 2 == 0 else
                        ("graphed", "eager")):
                s, t = time_steps(model, s, TURNS[1], eager=who == "eager")
                turns[who].append(t)
        check_state(f"graphs {name}", s, n_failed=0)
        enq = {who: host_enqueue_ms(lambda: drive(model, s, TURNS[1],
                                                  who == "eager"),
                                    TURNS[1])[0]
               for who in ("eager", "graphed")}
        g.state.copy_(s)
        keys = {row: KERNEL_KEYS[row.split()[0]] for row in rows}

        def replays():
            for _ in range(5):
                g.graph.replay()

        stats, got = trace_window(replays, 5, {k: 5 for k in keys.values()})
        for row, key in keys.items():
            results[row]["graph_launches"] = \
                results[row].get("graph_launches", 0) + got[key]
        med = {k: float(np.median(v)) for k, v in turns.items()}
        out[name] = dict(
            ms_per_step=turns, median=med, host_enqueue_ms_per_step=enq,
            capture_s=capture_s, capture_held_bytes=held,
            capture_reserved_bytes=pool,
            capture_peak_bytes=capture_peak, replay_peak_bytes=replay_peak,
            eager_peak_bytes=eager_peak, state_copy_ms=copy_ms,
            replay_trace=stats)
        log("graphs", f"{name}: {GRAPH_STEPS} replays bitwise equal to the "
                      f"eager steps (step_n_quiet 1/3/{GRAPH_STEPS}, step_n "
                      f"rows, step_n_buffered 5 of 8, step_jit twice, no "
                      f"alias); warm-up + capture {capture_s:.3f} s")
        log("graphs", f"{name}: ms/step median graphed {med['graphed']:.4f} "
                      f"eager {med['eager']:.4f} ({TURNS[0]} x {TURNS[1]} "
                      f"steps in turns); host enqueue a step graphed "
                      f"{enq['graphed']:.4f} eager {enq['eager']:.4f} ms; "
                      f"state copy {copy_ms:.4f} ms")
        log("graphs", f"{name}: replay trace: device busy "
                      f"{stats['device_busy_ms_per_step']:.4f} ms/step, idle "
                      f"share {stats['idle_share']:.4f}, "
                      f"{stats['device_ops_per_step']:.1f} device ops a "
                      f"replay, kernels by name {got}; memory: the capture "
                      f"holds {held / 2**20:.1f} MiB allocated (its input "
                      f"and output states); warm-up and capture reserved "
                      f"{pool / 2**20:.1f} MiB more (the graph's pool among "
                      f"them; peak {capture_peak / 2**20:.1f} MiB while "
                      f"made), replays peak {replay_peak / 2**20:.1f} MiB, "
                      f"eager steps peak {eager_peak / 2**20:.1f} MiB")
        model.release_graph()
        del model, g, ms, s
        torch.cuda.empty_cache()
    timing["graphs"] = out


def run_sim(sim, steps: int) -> float:
    """``sim.run()`` up to ``steps`` steps in all; returns its wall ms per
    step (``run`` waits for the device at its end)."""
    done = int(sim.state.iteration) if sim.initialized else 0
    sim.stop_time = (steps - 1) * DT
    t0 = time.perf_counter()
    sim.run()
    return (time.perf_counter() - t0) * 1e3 / (steps - done)


def traced_run(model, stop_time: float, want: dict, state=None, **run_kw):
    """``Simulation.run(**run_kw)`` of a fresh Simulation of ``model`` to
    ``stop_time``, from ``state`` (else the seed), under a
    ``torch.profiler`` trace (``trace_window``, which takes the run again if
    a trace lost launches), the launch counters set to 0 just before and
    read just after.  A replayed graph launches its kernels without their
    wrappers, so the trace counts them by name; the model's capture exists
    already, so the host calls none.  ``want``: kernel id -> the launches
    the run makes.  Returns (the Simulation, the trace's counts by kernel
    id, the trace's stats)."""
    box = []

    def run():
        sim = Simulation.create(model, stop_time=stop_time)
        if state is not None:
            sim.state, sim.initialized = state, True
        sim.run(**run_kw)
        box.append(sim)

    start = 0 if state is None else int(state.iteration)
    steps = Simulation.create(model, stop_time=stop_time).n_steps() - start
    reset_counters()
    stats, got = trace_window(run, steps,
                              {KERNEL_KEYS[k]: v for k, v in want.items()})
    host = counters()
    assert not any(host.values()), f"the host called kernels in replays: {host}"
    return box[-1], {k: got[KERNEL_KEYS[k]] for k in want}, stats


def phase_remesh_backends(dev, results, timing):
    """This slice's main path, part 1: the flagship at FLAG_N^2 through
    Simulation under the three remesh backends, counters reset just before
    and read just after.  3 steps: "pallas" and "fused" within rtol 1e-5 of
    "xla" with the counters equal; 20 more: n_failed = n_clamped = 0.
    ``Simulation.run`` replays one capture a model, so the host called each
    kernel only in its warm-up and capture; then 3 more steps of each
    through Simulation.run, traced, with each kernel counted by name
    (``traced_run``), bit for bit 3 eager steps, also counted."""
    n = FLAG_N
    sims = {rm: Simulation.create(flagship_model(n, dev, remesh_mode=rm),
                                  stop_time=0.0)
            for rm in ("xla", "pallas", "fused")}
    reset_counters()
    for rm, sim in sims.items():
        assert sim.model.graphed, rm
        run_sim(sim, 3)
    ref = sims["xla"].state
    for rm in ("pallas", "fused"):
        st = sims[rm].state
        err = assert_close(f"flagship {rm} vs xla, 3 steps", st.state,
                           ref.state, 1e-5, 1e-9)
        mr, mx = st.metrics.as_dict(), ref.metrics.as_dict()
        assert mr == mx, f"flagship {rm} vs xla: counters {mr} vs {mx}"
        log("backends", f"{rm} vs xla after 3 steps: max abs err {err:.3e}, "
                        f"counters equal {mr}")
    for rm, sim in sims.items():
        ms_step = run_sim(sim, 23)
        m = check_state(f"flagship {rm}", sim.state, n_failed=0, n_clamped=0)
        timing[f"flagship_{rm}_ms_per_step"] = ms_step
        timing[f"flagship_{rm}_pushes_per_s"] = n * n / (ms_step / 1e3)
        log("backends", f"{n}^2 flagship remesh_mode={rm}: {ms_step:.3f} "
                        f"ms/step over 20 steps (Simulation.run, graphed, "
                        f"wall), {n * n / (ms_step / 1e3):.4e} pushes/s; "
                        f"metrics {m}")
    per = WARMUP_STEPS + 1
    c = counters()
    assert c == {"K1": 3 * per, "K2": 2 * per, "K3": 0, "K4": 0, "K5": per,
                 "K6": per}, c
    log("counters", f"remesh backends through Simulation.run: the host's "
                    f"calls {c} (warm-up and capture, once a model)")
    kernels = {"xla": ("K1", "K2"), "pallas": ("K1", "K2", "K5"),
               "fused": ("K1", "K6")}
    for rm, sim in sims.items():
        want = {k: 3 if k in kernels[rm] else 0
                for k in ("K1", "K2", "K3", "K5", "K6")}
        traced, got, _ = traced_run(sim.model, 25 * DT, want, state=sim.state)
        assert got == want, (rm, got)
        reset_counters()
        ms = eager_steps(sim.model, sim.state, 3)
        c = counters()
        assert c == dict(want, K4=0), (rm, c)
        assert_state_bitwise(f"flagship {rm}, 3 eager steps against 3 "
                             f"replays of Simulation.run", ms, traced.state)
        if rm == "pallas":
            results["K5"]["launches"] = got["K5"]
        log("counters", f"remesh backend {rm}, 3 more steps of "
                        f"Simulation.run: launches by trace {got}; bitwise "
                        f"equal to 3 eager steps, launches {c}")


def run_day_resumed(model, tag: str, steps: int = 145, at: int = 72):
    """A storeless day of ``model`` (a fused configuration: K1 and K6,
    ``steps`` steps of its DT) through Simulation.run, which replays the
    model's captured step; the same day checkpointed at step ``at`` and
    resumed by a fresh Simulation, bitwise equal at the end; the day again
    through Simulation.run under a trace, which counts its launches
    (``traced_run``: K1 = K6 = ``steps``, no other kernel), bitwise equal;
    then the day eagerly (``eager_day``), the witness that the replays are
    the step.  The counters are set to 0 at the start.  Returns a dict: the
    full run, its wall s and peak bytes, the checkpoint's bytes and save
    and load s, the counters after the three untraced runs (the host's
    calls in the one warm-up and capture), the traced day's launches and
    stats, and the eager day's counter sums and launches."""
    dt = float(model.settings.timestep)
    assert model.graphed, tag
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full = Simulation.create(model, stop_time=(steps - 1) * dt)
    t0 = time.perf_counter()
    full.run()
    wall = time.perf_counter() - t0
    assert int(full.state.iteration) == full.n_steps() == steps
    peak = torch.cuda.max_memory_allocated()
    leg = Simulation.create(model, stop_time=(at - 1) * dt)
    leg.run()
    assert int(leg.state.iteration) == at
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)   # git-ignored
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        t1 = time.perf_counter()
        path = leg.checkpoint(os.path.join(tmp, f"day_step{at}"))
        t_save = time.perf_counter() - t1
        size = os.path.getsize(path)
        rest = Simulation.create(model, stop_time=(steps - 1) * dt)
        t2 = time.perf_counter()
        rest.pickup(path)
        t_load = time.perf_counter() - t2
    rest.run()
    assert_state_bitwise(f"{tag}: resumed run", rest.state, full.state)
    graphed = counters()
    want = {"K1": steps, "K2": 0, "K3": 0, "K5": 0, "K6": steps}
    traced, launches, stats = traced_run(model, (steps - 1) * dt, want)
    assert launches == want, f"{tag}: launches by trace {launches}"
    assert_state_bitwise(f"{tag}: traced run", traced.state, full.state)
    log("trace", f"{tag} through Simulation.run: launches by trace "
                 f"{launches}; device busy "
                 f"{stats['device_busy_ms_per_step']:.4f} ms/step, idle "
                 f"share {stats['idle_share']:.4f}, "
                 f"{stats['device_ops_per_step']:.1f} device ops a step")
    day, eager = eager_day(model, full.state, steps)
    return dict(full=full, wall=wall, peak=peak, size=size, t_save=t_save,
                t_load=t_load, graphed_counts=graphed, day=day,
                launches=launches, trace=stats, eager_launches=eager)


def eager_day(model, want, steps: int):
    """The day again from the seed, ``model.step`` by step, the counters
    set to 0 just before and read just after, every counter summed over its
    steps (and a layered state's layers) on the device; its last state must
    equal ``want`` (the day ``Simulation.run`` replayed) bit for bit.
    Returns (the counters summed, substeps_max left out; the launches)."""
    ms = model.init_state()
    names = [f.name for f in dataclasses.fields(ms.metrics)]
    total = torch.zeros(len(names), dtype=torch.int64, device=ms.state.device)
    reset_counters()
    for _ in range(steps):
        ms = model.step(ms)
        total += torch.stack([getattr(ms.metrics, k).to(torch.int64).sum()
                              for k in names])
    launches = counters()
    assert_state_bitwise("the eager day against Simulation.run's", ms, want)
    day = dict(zip(names, total.tolist()))
    del day["substeps_max"]   # a sum of maxima means nothing
    return day, launches


def phase_production(dev, results, timing):
    """This slice's main path, part 2: the production run.  A storeless day
    of the fused flagship at FLAG_N^2 through Simulation.run; the same day
    checkpointed at step 72 and resumed by a fresh Simulation, bitwise equal
    at the end; a day with a CashStore at 256^2 whose last frame equals the
    storeless run's final state."""
    n = FLAG_N
    model = flagship_model(n, dev, remesh_mode="fused")
    r = run_day_resumed(model, "production day")
    full, wall, peak = r["full"], r["wall"], r["peak"]
    size, t_save, t_load = r["size"], r["t_save"], r["t_load"]
    steps = full.n_steps()
    m = check_state("production day", full.state, n_failed=0, n_clamped=0)
    g, c, e = r["graphed_counts"], r["launches"], r["eager_launches"]
    assert g["K1"] == g["K6"] == WARMUP_STEPS + 1, g
    assert e["K6"] == 145 and e["K1"] == e["K6"], e
    assert e["K2"] == 0 and e["K5"] == 0, e
    results["K6"]["launches"] = c["K6"]
    log("counters", f"production day through Simulation.run: the host's "
                    f"calls {g}; launches by trace {c}; the day again "
                    f"eagerly, bitwise equal: launches {e}")
    timing.update(production_day_trace=r["trace"])
    timing.update(production_wall_s=wall, production_steps=steps,
                  production_steps_per_s=steps / wall,
                  production_peak_bytes=peak,
                  checkpoint_bytes=size, checkpoint_save_s=t_save,
                  checkpoint_load_s=t_load)
    log("production", f"{n}^2 fused flagship, 1 day storeless (graphed): "
                      f"{steps} steps in {wall:.3f} s wall ({steps / wall:.2f} steps/s, "
                      f"{n * n * steps / wall:.4e} pushes/s), peak "
                      f"max_memory_allocated {peak / 2**30:.3f} GiB; "
                      f"metrics {m}")
    log("production", f"checkpoint at step 72: {size / 2**20:.1f} MiB npz, "
                      f"saved in {t_save:.2f} s, loaded in {t_load:.2f} s; "
                      f"resumed to step 145 bitwise equal (all "
                      f"{len(full.state.leaves())} leaves)")

    small = 256
    quiet = Simulation.create(flagship_model(small, dev, remesh_mode="fused"),
                              stop_time=DAY)
    quiet.run()
    stored = Simulation.create(flagship_model(small, dev,
                                              remesh_mode="fused"),
                               stop_time=DAY)
    t3 = time.perf_counter()
    stored.run(cash_store=True)
    t_stored = time.perf_counter() - t3
    frames = stored.store.as_array()
    assert frames.shape == (146, small, small, 3), frames.shape
    assert np.array_equal(frames[-1], quiet.state.state.cpu().numpy()), \
        "the stored day's last frame differs from the storeless run"
    assert np.isfinite(frames).all()
    timing["stored_256_wall_s"] = t_stored
    log("production", f"{small}^2 fused flagship, 1 day with a CashStore: "
                      f"{frames.shape[0]} frames in {t_stored:.3f} s; last "
                      f"frame equals the storeless run bitwise")


# the CLI's experiment at full width: FLAG_N nodes a side at 2 km, 12 hours
# of 10-minute steps (73 steps: a chunk of 64 and a ragged one of 9)
CLI_ARGV = ["--Nx", str(FLAG_N), "--Lx", str(2.0 * (FLAG_N - 1)), "--T",
            "12", "--DT", "10"]


def phase_cli(dev, results, timing):
    """The CLI's path (``python -m picles_torch``): its model and
    Simulation built by its own ``build_simulation`` from CLI_ARGV (tsit5
    with the Hairer dt reset, K1, K2 and K3, in the CLI's non-periodic box)
    and run as ``main`` runs them, ``run(store=True)``: every step through
    ``step_n_buffered`` in chunks of 64, each chunk pushed to the store.  A
    CashStore takes the place of the HDF5 store (its h5py is not on every
    card machine).  The model is graphed; the host called each kernel only
    in the one warm-up and capture; the run again under a trace counts its
    launches (``traced_run``: K1 = K2 = K3 = the steps) and stores the same
    frames bit for bit; every frame is bit for bit the state of as many
    eager steps, and the last state every leaf of the eager one."""
    args = cli_parser().parse_args(CLI_ARGV)
    sim = build_simulation(args)
    model = sim.model
    assert model.graphed and model.resolved_config().advance_mode == "cuda"
    steps = sim.n_steps()
    n = model.grid.nx
    reset_counters()
    sim.store = CashStore()
    t0 = time.perf_counter()
    sim.run(store=True)
    wall = time.perf_counter() - t0
    host = counters()
    assert host["K1"] == host["K2"] == host["K3"] == WARMUP_STEPS + 1, host
    frames = sim.store.as_array()
    assert frames.shape == (steps + 1, n, n, 3), frames.shape
    want = {"K1": steps, "K2": steps, "K3": steps, "K5": 0, "K6": 0}
    again, launches, stats = traced_run(model, sim.stop_time, want,
                                        cash_store=True)
    assert launches == want, f"CLI run: launches by trace {launches}"
    assert np.array_equal(again.store.as_array().view(np.uint32),
                          frames.view(np.uint32)), "the traced run's frames"
    del again
    reset_counters()
    ms = model.init_state()
    for i in range(steps + 1):
        if i:
            ms = model.step(ms)
        got = torch.from_numpy(frames[i]).to(dev)
        assert torch.equal(bits(got), bits(ms.state)), \
            f"CLI run: frame {i} differs from {i} eager steps"
    eager = counters()
    assert eager["K1"] == eager["K2"] == eager["K3"] == steps, eager
    assert_state_bitwise("CLI run against the eager steps", sim.state, ms)
    m = check_state("CLI run", sim.state, n_failed=0)
    for k in ("K1", "K2", "K3"):
        results[k]["launches"] += launches[k]
    timing.update(cli_wall_s=wall, cli_steps=steps, cli_trace=stats)
    log("cli", f"{' '.join(CLI_ARGV)}: {steps} steps through the graphed "
               f"step_n_buffered (chunks of 64) into a CashStore in "
               f"{wall:.3f} s wall (capture included); the host's calls "
               f"{host}; the run again, traced: launches {launches}, device "
               f"busy {stats['device_busy_ms_per_step']:.4f} ms/step, idle "
               f"share {stats['idle_share']:.4f}, frames bitwise equal")
    log("cli", f"all {steps + 1} frames bitwise the eager steps' states "
               f"(launches {eager}), the last state every leaf; metrics {m}")


def k4_pair(tag, xr, yr, chans, act, halo):
    """K4 twice and its plain version on the same inputs: bitwise
    repeatable, within 1e-6 of each channel's scale; returns the max abs
    error relative to that scale."""
    out, st = pic_gather_padded(xr, yr, chans, act, halo)
    out2, _ = pic_gather_padded(xr, yr, chans, act, halo)
    P, st_p = scatter_accumulate_padded(xr, yr, torch.stack(chans, dim=-1),
                                        act, halo)
    torch.cuda.synchronize()
    assert_bitwise(tag, (out,), (pic_gather_padded(xr, yr, chans, act, halo,
                                                   simple=True)[0],))
    assert out.shape == P.permute(2, 0, 1).shape, (out.shape, P.shape)
    err = 0.0
    for c in range(3):
        scale = float(P[..., c].abs().max())
        e = assert_close(f"{tag} ch{c}", out[c], P[..., c], 1e-5, 1e-6 * scale)
        assert e <= 1e-6 * scale, f"{tag} ch{c}: max abs err {e} > 1e-6 x {scale}"
        assert torch.equal(out[c], out2[c]), f"{tag}: two runs differ"
        err = max(err, e / scale)
    assert int(st.clamped) == int(st_p.clamped), \
        f"{tag}: clamped {int(st.clamped)} vs {int(st_p.clamped)}"
    log("K4", f"{tag}: max abs err {err:.3e} of the scale, clamped "
              f"{int(st.clamped)}, bitwise repeatable, bitwise equal to "
              f"_simple")
    return err


def phase_k4(dev, flag, s_flag, results):
    """K4 against scatter_accumulate_padded: the flagship's own deposit at
    FLAG_N^2 (timed beside the plain version), then at 256^2 with random
    displacements over the whole halo (and past it, so some clamp)."""
    core, chans, sact = flagship_deposit_inputs(flag, s_flag)
    halo = flag.config.halo
    err = k4_pair(f"{FLAG_N}^2 flagship deposit halo {halo}", core[3],
                  core[4], chans, sact, halo)
    rng = np.random.default_rng(4)
    n = 256

    def plane(fn, *a):
        return torch.as_tensor(fn(*a, (n, n)).astype(np.float32), device=dev)

    for h in (3, ((0, 3), (0, 3)), ((1, 3), (0, 2))):
        (xl, xh), (yl, yh) = normalize_halo(h)
        xr = plane(rng.uniform, -xl - 0.2, xh + 0.2)
        yr = plane(rng.uniform, -yl - 0.2, yh + 0.2)
        ch = (plane(rng.uniform, 0.0, 1.0), plane(rng.normal, 0.0, 0.1),
              plane(rng.normal, 0.0, 0.1))
        act = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
        err = max(err, k4_pair(f"256^2 halo {h}", xr, yr, ch, act, h))
    results["K4"]["max_abs_err"] = err
    simple_ms, ms = turns_ms(
        "K4", lambda: pic_gather_padded(core[3], core[4], chans, sact, halo,
                                        simple=True),
        lambda: pic_gather_padded(core[3], core[4], chans, sact, halo), 20)
    (xl, xh), (yl, yh) = normalize_halo(halo)
    b = deposit_bound(FLAG_N * FLAG_N, (FLAG_N + xl + xh) * (FLAG_N + yl + yh),
                      halo)
    results["K4"].update(ms=ms, simple_ms=simple_ms, **b, plain_ms=cuda_time_ms(
        lambda: scatter_accumulate_padded(core[3], core[4],
                                          torch.stack(chans, dim=-1), sact,
                                          halo), 5))
    log("kernel-time", f"K4: {ms:.4f} ms, _simple {simple_ms:.4f} ms (in "
                       f"turns), plain {results['K4']['plain_ms']:.4f} ms, "
                       f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def assert_states(tag: str, got, want, rtol: float = 2e-3) -> float:
    """A sharded run's gathered state against the single-device one: node
    state and particle planes at ``rtol`` (the adaptive controller's
    envelope, tests/test_sharded.py:50-56), n_active, n_gather, n_failed
    equal; returns the node state's max abs error."""
    err = assert_close(f"{tag} state", got.state, want.state, rtol, 1e-10)
    for k in ("lne", "cgx", "cgy", "px", "py"):
        assert_close(f"{tag} {k}", getattr(got.particles, k),
                     getattr(want.particles, k), rtol, 1e-6)
    mg, mw = got.metrics.as_dict(), want.metrics.as_dict()
    for k in ("n_active", "n_gather", "n_failed"):
        assert mg[k] == mw[k], f"{tag}: {k} {mg[k]} vs {mw[k]}"
    return err


def phase_sharded_1x1(dev, gw, results, timing):
    """This slice's main path: the flagship at FLAG_N^2 through
    ShardedWaveGrowth2D on a (1, 1) mesh, NCCL at world size 1, with the
    K5 remesh (K1 -> K4 -> self-wrap fold -> K5), counters reset just
    before and read just after.  3 steps against the single-device step
    (K2 in place of K4 and the fold), then 20 steps; then, out of the
    counted run, both steps in turns, 10 steps at a time, 8 times each
    (the step is host-bound, so one run of each is noise)."""
    n = FLAG_N
    model = flagship_model(n, dev, remesh_mode="pallas")
    ref = model.step_n_quiet(model.init_state(), 3)
    init_distributed(0, 1, "nccl", free_port())
    try:
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        assert model.graphed and not sh.graphed   # the sharded step is eager
        log("sharded-1x1", f"transport: {sh.transport}")
        reset_counters()
        ms = sh.step_n_quiet(sh.init_state(), 3)
        err = assert_states("sharded 1x1 vs single device, 3 steps", ms, ref)
        ms = sh.step_n_quiet(ms, 20)
        m = check_state("sharded 1x1", ms, n_failed=0, n_clamped=0)
        c = counters()
        assert c["K1"] == c["K4"] == c["K5"] == 23, c
        assert c["K2"] == 0 and c["K6"] == 0, c
        runs = {"sharded": [], "single": []}
        for rep in range(8):
            for who in (("sharded", "single") if rep % 2 == 0 else
                        ("single", "sharded")):
                if who == "single":
                    ref, t = time_steps(model, ref, 10, eager=True)
                else:
                    ms, t = time_steps(sh, ms, 10)
                runs[who].append(t)
        del ms, ref
        results["K4"]["launches"] = c["K4"]
        phase_sharded_layers(dev, gw, results, timing)
        phase_sharded_tripolar(dev, results, timing)
    finally:
        dist.destroy_process_group()
    ms_step, single = (float(np.median(runs[k])) for k in ("sharded", "single"))
    timing["sharded_1x1_ms_per_step"] = ms_step
    timing["sharded_1x1_pushes_per_s"] = n * n / (ms_step / 1e3)
    timing["single_pallas_ms_per_step"] = single
    timing["sharded_1x1_turns"] = runs
    log("sharded-1x1", f"3 steps vs single device: max abs err {err:.3e}, "
                       f"counters equal; metrics {m}")
    log("sharded-1x1", f"{n}^2: {ms_step:.3f} ms/step, "
                       f"{n * n / (ms_step / 1e3):.4e} pushes/s; the "
                       f"single-device pallas step (eager) in turns "
                       f"{single:.3f} ms/step (medians of 8 x 10 steps each, "
                       f"CUDA events)")
    log("counters", f"sharded 1x1 path launches {c}")


SHARDED_RANKS = 4


def phase_sharded_2x2(timing):
    """Four ranks on the one card over gloo (this script again, with
    ``--sharded-rank``): each rank runs ``sharded_rank``; a rank that fails
    or outlives the time limit fails the phase."""
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)   # git-ignored
    out = tempfile.mkdtemp(dir=cuda_build.BUILD_ROOT)
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(SHARDED_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
         "--port", str(port), "--rank-dir", out],
        stdout=f, stderr=subprocess.STDOUT) for r, f in enumerate(logs)]
    deadline = time.monotonic() + 400
    try:
        # a rank that fails leaves the others waiting in a collective:
        # stop them at once
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if r == 0 or p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                for ln in f.read().splitlines():
                    print(f"  rank {r}| {ln}", flush=True)
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"sharded 2x2: ranks failed (rank, code): {bad}"
    with open(os.path.join(out, "rank0.json")) as f:
        timing.update(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    log("sharded-2x2", f"4 ranks passed in {time.perf_counter() - t0:.1f} s "
                       f"wall, processes included")


def wall_ms(fn, reps: int) -> float:
    """Host wall ms of ``fn()`` (which ends in a collective, so the ranks
    move together), synchronised before and after, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_rank(rank: int, port: int, out: str) -> int:
    """One of the four gloo ranks of phase "sharded-2x2", on the one card:
    (a) the collective deposit (K4, exchange, folds) against the global K2
    deposit at FLAG_N^2 for periodic, open and asymmetric halos, and K4
    alone beside it (the gloo staging cost); (b) 3 sharded flagship steps
    against the single-device step, then timed steps; (c) at 256^2 a
    Simulation.run of 6 steps with a CashStore against the single-device
    run frame by frame (7 frames), and a checkpoint at step 3 resumed bitwise equal
    to the uninterrupted sharded run; (d) the tripolar configuration at 360
    x 180 ("pallas" and "default", the solver tolerances
    ``SHARDED_TRI_TOLS``), 4 steps against the single-device step, the
    seam folded across the two top blocks.  Rank 0 holds the references
    and writes the numbers to ``out/rank0.json``."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rank, SHARDED_RANKS, "gloo", port, timeout_s=120.0)
    mesh = make_mesh((2, 2))
    root = rank == 0
    res = {}
    n = FLAG_N

    # (a) the collective deposit in isolation
    rng = np.random.default_rng(5)
    for i, (periodic, halo) in enumerate(((True, ((0, 3), (0, 3))),
                                          (False, 3),
                                          (True, ((1, 3), (0, 2))))):
        sh = ShardedWaveGrowth2D(flagship_model(n, dev, halo=halo,
                                                periodic=periodic), mesh)
        if root and periodic and halo == ((0, 3), (0, 3)):
            log("sharded-2x2", f"transport: {sh.transport}")
        (xl, xh), (yl, yh) = normalize_halo(halo)
        glob = [rng.uniform(-xl - 0.2, xh + 0.2, (n, n)),
                rng.uniform(-yl - 0.2, yh + 0.2, (n, n)),
                rng.uniform(0.0, 1.0, (n, n)), rng.normal(0.0, 0.1, (n, n)),
                rng.normal(0.0, 0.1, (n, n))]
        glob = [torch.as_tensor(a.astype(np.float32), device=dev)
                for a in glob]
        gact = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
        sx, sy = sh._slices
        xr, yr, *ch = (a[sx, sy].contiguous() for a in glob)
        act = gact[sx, sy].contiguous()
        planes, _ = sh._scatter_sharded(xr, yr, tuple(ch), act)
        S = sh.gather_blocks(torch.stack(planes, dim=-1))
        tag = f"2x2 deposit {'periodic' if periodic else 'open'} halo {halo}"
        if root:
            K, _ = pic_gather(glob[0], glob[1], tuple(glob[2:]), gact,
                              sh.grid.stats, halo)
            err = max(assert_close(f"{tag} ch{c}", S[..., c], K[c], 2e-6,
                                   2e-6) for c in range(3))
            log("sharded-2x2", f"{tag} vs global K2 at {n}^2: max abs err "
                               f"{err:.3e}")
            res[f"deposit_{i}_max_abs_err"] = err
        if periodic and halo == ((0, 3), (0, 3)):
            dep = wall_ms(lambda: sh._scatter_sharded(xr, yr, tuple(ch),
                                                      act), 10)
            loc = wall_ms(lambda: (sh.accumulate_padded(xr, yr, tuple(ch),
                                                        act),
                                   sh.barrier()), 10)
            res.update(deposit_exchange_ms=dep, deposit_local_ms=loc)
            if root:
                log("sharded-2x2", f"{tag}: K4 + exchange + folds "
                                   f"{dep:.3f} ms, K4 alone (+ barrier) "
                                   f"{loc:.3f} ms per call (rank 0 wall)")

    # (b) the sharded flagship step
    model = flagship_model(n, dev, remesh_mode="pallas")
    sh = ShardedWaveGrowth2D(model, mesh)
    ms = sh.step_n_quiet(sh.init_state(), 3)
    whole = sh.gather_state(ms)
    if root:
        ref = model.step_n_quiet(model.init_state(), 3)
        err = assert_states("sharded 2x2 vs single device, 3 steps", whole,
                            ref)
        log("sharded-2x2", f"flagship {n}^2, 3 steps vs single device: max "
                           f"abs err {err:.3e}, counters equal")
        del ref
    del whole
    steps = 10
    step_ms = wall_ms(lambda: sh.step_n_quiet(ms, steps), 1) / steps
    m = check_state("sharded 2x2", sh.step(ms), n_failed=0, n_clamped=0)
    res.update(sharded_2x2_ms_per_step=step_ms,
               sharded_2x2_pushes_per_s=n * n / (step_ms / 1e3))
    if root:
        log("sharded-2x2", f"flagship {n}^2 on 4 ranks sharing the card: "
                           f"{step_ms:.3f} ms/step over {steps} steps "
                           f"(rank 0 wall), {n * n / (step_ms / 1e3):.4e} "
                           f"pushes/s; metrics {m}")

    # (c) Simulation.run: CashStore, checkpoint, resume
    small = 256
    sh = ShardedWaveGrowth2D(flagship_model(small, dev, remesh_mode="pallas"),
                             mesh)
    stored = Simulation.create(sh, stop_time=5 * DT)
    stored.run(cash_store=True)
    full = Simulation.create(sh, stop_time=5 * DT)
    full.run()
    leg = Simulation.create(sh, stop_time=2 * DT)
    leg.run()
    ck = leg.checkpoint(os.path.join(out, "step3"))
    rest = Simulation.create(sh, stop_time=5 * DT)
    rest.pickup(ck)
    rest.run()
    a, b = sh.gather_state(full.state), sh.gather_state(rest.state)
    if root:
        frames = stored.store.as_array()
        single = Simulation.create(flagship_model(small, dev,
                                                  remesh_mode="pallas"),
                                   stop_time=5 * DT)
        single.run(cash_store=True)
        want = single.store.as_array()
        assert frames.shape == want.shape == (7, small, small, 3), \
            (frames.shape, want.shape)
        for i in range(frames.shape[0]):
            assert_close(f"2x2 Simulation frame {i}", torch.as_tensor(
                frames[i]), torch.as_tensor(want[i]), 2e-3, 1e-10)
        for i, (x, y) in enumerate(zip(a.leaves(), b.leaves())):
            assert torch.equal(x, y), f"resumed 2x2 run differs in leaf {i}"
        log("sharded-2x2", f"{small}^2 Simulation.run, 6 steps: CashStore "
                           f"frames match the single-device run; resumed "
                           f"from the step-3 checkpoint bitwise equal (all "
                           f"{len(a.leaves())} leaves)")
    del a, b, stored, full, leg, rest

    # (d) the tripolar configuration at 1 degree (360 x 180): the seam
    # fold all-gathers the top halo across the two top blocks
    tgrid = tripolar_grid(dev, 720, 360)
    tgw = tripolar_record(dev)
    for path in SHARDED_TRI_PATHS:
        tm = tripolar_model(tgrid, tgw, path, tols=SHARDED_TRI_TOLS)
        tsh = ShardedWaveGrowth2D(tm, mesh)
        assert tsh._seam_group is not None
        t0 = time.perf_counter()
        ms = eager_steps(tsh, tsh.init_state(), 4)
        whole = tsh.gather_state(ms)
        wall = time.perf_counter() - t0
        if root:
            ref = eager_steps(tm, tm.init_state(), 4)
            err = assert_states(f"2x2 tripolar {path} vs single device, 4 "
                                f"steps", whole, ref)
            m = check_tripolar(f"2x2 tripolar {path}", tm, whole)
            res[f"tripolar_{path}_max_abs_err"] = err
            res[f"tripolar_{path}_4_steps_wall_s"] = wall
            log("sharded-2x2", f"tripolar {path} {tgrid.nx} x {tgrid.ny} on "
                               f"a (2, 2) mesh, the seam across two top "
                               f"blocks: 4 steps vs single device max abs "
                               f"err {err:.3e}, counters equal; metrics "
                               f"{m}; {wall:.2f} s wall with the gather")
    if root:
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    return 0


def trace_window(run, steps: int, want: dict, attempts: int = 3):
    """A ``torch.profiler`` trace of ``run()`` (``steps`` steps): device
    busy time (the union of the device ops), idle share of the traced
    window, device ops and time by name per step.  ``want`` maps
    KERNEL_KEYS names to the launches a complete trace holds; a trace
    missing any (late in a process a trace can lose device events) is
    taken again, up to ``attempts`` times.  Returns (stats, the kernels'
    counts)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {k: sum(k in e.name for e in dev) for k in want}
        if got == want:
            break
        log("trace", f"trace {attempt} holds {got} of {want} launches "
                     f"({len(dev)} device ops); taken again")
    assert got == want, \
        f"no complete trace in {attempts} attempts: {got} of {want}"
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in dev:
        d, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (d + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    stats = dict(trace_attempts=attempt, profiled_steps=steps,
                 device_window_us=window, device_busy_us=busy,
                 device_busy_ms_per_step=busy / 1e3 / steps,
                 idle_share=1.0 - busy / window,
                 device_ops_per_step=len(dev) / steps,
                 by_kernel_us_per_step={k: d / steps for k, (d, _) in top})
    return stats, got


def host_enqueue_ms(run, steps: int) -> tuple:
    """(host ms a step to enqueue ``run()``'s ``steps`` steps, host wall ms
    a step until the device is done)."""
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    run()
    h1 = time.perf_counter()
    torch.cuda.synchronize()
    h2 = time.perf_counter()
    return (h1 - h0) * 1e3 / steps, (h2 - h0) * 1e3 / steps


def profile_config(tag: str, model, reps: int, eager: bool,
                   steps: int = 10, prof_steps: int = 5) -> dict:
    """Step times of one configuration over ``reps`` x ``steps`` steps (CUDA
    events), the host's enqueue time against the wall, and, for kernel
    configurations, a ``torch.profiler`` trace of ``prof_steps`` steps
    (``trace_window``, K1 once a step): device time by kernel, the device's
    busy time and idle share in the traced window, and device ops per step.
    The steps are eager (``model.step`` in a loop) or go through
    ``step_n_quiet``, which replays the captured step of a graphed model
    (``drive``)."""
    ms = drive(model, model.init_state(), 4, eager)
    per_rep = []
    for _ in range(reps):
        ms, t = time_steps(model, ms, steps, eager)
        per_rep.append(t)
    out = dict(ms_per_step=per_rep, median=float(np.median(per_rep)),
               metrics=ms.metrics.as_dict())
    out["host_enqueue_ms_per_step"], out["host_wall_ms_per_step"] = \
        host_enqueue_ms(lambda: drive(model, ms, steps, eager), steps)
    log("profile", f"{tag}: ms/step per rep {[f'{t:.4f}' for t in per_rep]}, "
                   f"median {out['median']:.4f}; host enqueue "
                   f"{out['host_enqueue_ms_per_step']:.4f}, wall "
                   f"{out['host_wall_ms_per_step']:.4f} ms/step")
    if model.resolved_config().advance_mode != "cuda":
        return out
    stats, _ = trace_window(lambda: drive(model, ms, prof_steps, eager),
                            prof_steps, {KERNEL_KEYS["K1"]: prof_steps})
    out.update(stats)
    log("profile", f"{tag}: device busy "
                   f"{stats['device_busy_ms_per_step']:.4f} ms/step, idle "
                   f"share {stats['idle_share']:.4f} of the traced window, "
                   f"{stats['device_ops_per_step']:.1f} device ops per step")
    for k, d in stats["by_kernel_us_per_step"].items():
        log("profile", f"    {d:9.2f} us/step  {k[:90]}")
    return out


def phase_profile(path: str, gw) -> None:
    """The step's time split at FLAG_N^2: the configurations with the
    kernels (traced), each eager and, in the column "<name>_graphed",
    through the drivers' replayed CUDA graph; the flagship under each
    kernel remesh backend, the gridded production configuration (record
    ``gw``), the tripolar production configuration (1440 x 720), both
    configurations with the plain versions on the card, and the pallas
    flagship through ShardedWaveGrowth2D on a (1, 1) NCCL mesh.  Each
    capture is freed before the next configuration."""
    n = FLAG_N
    configs = {
        "flagship": lambda: flagship_model(n, "cuda"),
        "flagship_pallas": lambda: flagship_model(n, "cuda",
                                                  remesh_mode="pallas"),
        "flagship_fused": lambda: flagship_model(n, "cuda",
                                                 remesh_mode="fused"),
        "default": lambda: default_model(n, "cuda"),
        "gridded": lambda: gridded_model(n, "cuda", gw, "production"),
        "tripolar": lambda: tripolar_model(
            tripolar_grid("cuda", *TRI_SUPER), tripolar_record("cuda"),
            "production"),
        "flagship_plain": lambda: flagship_model(
            n, "cuda", advance_mode="torch", scatter_mode="dense"),
        "default_plain": lambda: default_model(
            n, "cuda", advance_mode="torch", scatter_mode="dense")}
    res = {}
    for key, make in configs.items():
        model = make()
        tag = key.replace("_", " ")
        reps = 3 if key.endswith("plain") else 7
        res[key] = profile_config(tag, model, reps, eager=True)
        if model.graphed:
            res[key + "_graphed"] = profile_config(tag + " graphed", model,
                                                   reps, eager=False)
        del model
        torch.cuda.empty_cache()
    init_distributed(0, 1, "nccl", free_port())
    try:
        res["sharded_1x1_pallas"] = profile_config(
            "sharded 1x1 pallas", ShardedWaveGrowth2D(
                flagship_model(n, "cuda", remesh_mode="pallas"),
                make_mesh((1, 1))), 7, eager=True)
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def sass_loop_count(sass: str, fn_substr: str) -> dict:
    """Static SASS instructions of each function whose name holds
    ``fn_substr`` (``cuobjdump -sass`` output): all, those of its outermost
    loop (the span of the farthest backward branch), and those of that loop
    outside the blocks that a forward branch skips and that hold a loop of
    their own (the time-cosine wind's cosf argument reduction, which the
    constant and half-domain winds never enter)."""
    import re
    out = {}
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    for fsrc in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fsrc.split("\n", 1)[0].strip()
        if fn_substr not in name:
            continue
        code = [(int(m.group(1), 16), m.group(2).strip())
                for m in ins_re.finditer(fsrc)
                if not m.group(2).strip().startswith("NOP")]
        branches = []
        for a, op in code:
            m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", op)
            if m:
                branches.append((a, int(m.group(1), 16)))
        back = [(t, a) for a, t in branches if t < a]
        if not back:
            out[name] = dict(instructions=len(code))
            continue
        lo, hi = max(back, key=lambda ta: ta[1] - ta[0])
        skipped = [(a + 16, t) for a, t in branches
                   if lo <= a < t <= hi
                   and any(a < bt < ba < t for bt, ba in back)]
        inner = [a for a, _ in code if lo <= a <= hi]
        outside = [a for a in inner
                   if not any(s <= a < e for s, e in skipped)]
        out[name] = dict(instructions=len(code), loop_instructions=len(inner),
                         loop_without_inner_loop_blocks=len(outside))
    return out


def sass_path_count(sass: str, fn_substr: str) -> dict:
    """Static SASS instructions of each function whose name holds
    ``fn_substr`` (``cuobjdump -sass`` output) and has no loop of its own:
    all; those of the body, up to the branch to itself that closes it (the
    out-of-line subroutines after it, the IEEE division's slow path, run
    only for operands out of its fast range); and those of the body outside
    the blocks that a forward branch skips and that hold a loop (cosf's
    large-argument reduction, and in a kernel that tests the wind's kind at
    run time, the whole time-cosine sampler).  The last is the count of a
    lane of a wind constant in t on the fast paths, an upper bound of what
    it issues (both sides of a short forward branch are counted).  Where
    the estimate samples the time-cosine wind and one forward branch skips
    it all (the fused kernel's reset test), the loop hides the whole
    estimate: ``probe_k3`` takes the count of the other instances only."""
    import re
    out = {}
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    for fsrc in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fsrc.split("\n", 1)[0].strip()
        if fn_substr not in name:
            continue
        code = [(int(m.group(1), 16), m.group(2).strip())
                for m in ins_re.finditer(fsrc)
                if not m.group(2).strip().startswith("NOP")]
        branches = []
        for a, op in code:
            m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", op)
            if m:
                branches.append((a, int(m.group(1), 16)))
        end = min([a for a, t in branches if t == a] or [code[-1][0] + 16])
        body = [a for a, _ in code if a < end]
        back = [(t, a) for a, t in branches if t < a < end]
        skipped = [(a + 16, t) for a, t in branches
                   if a < t <= end and any(a < bt < ba < t for bt, ba in back)]
        path = [a for a in body if not any(s0 <= a < e for s0, e in skipped)]
        out[name] = dict(instructions=len(code), body=len(body),
                         path=len(path))
    return out


def smi_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


def probe_k3(default, sass: dict) -> dict:
    """K3 on the default configuration's state after 3 steps at FLAG_N^2,
    every lane reset and about half, bit for bit against its _simple
    baseline + PyTorch's clamp and select and timed in turns with it; and
    each instance's SASS path count turned into the time a lane's
    instructions take to issue: count x warps / (132 SMs x 4 schedulers x
    the SM clock)."""
    st = default.step_n_quiet(default.init_state(), 3)
    Q, sett, g = st.particles, default.settings, default.grid
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    clocks = smi_clocks()
    mhz = float(clocks.split(",")[1].split()[0])
    warps = Q.t.numel() / 32
    # the baseline (the wind's kind a run-time test) and the instances of a
    # wind constant in t: constant (kind 0) and half-domain (kind 1)
    lanes = [k for k in sass if "auto_dt_simple" in k
             or any(f"auto_dt_kernelILi{kind}ELi" in k for kind in (0, 1))]
    out = {"clocks": clocks,
           "issue_ms": {k: sass[k]["path"] * warps / (132 * 4 * mhz * 1e6)
                        * 1e3 for k in lanes}}
    for k, v in out["issue_ms"].items():
        log("probe", f"K3 {k[:60]}: SASS path x {warps:.0f} warps at "
                     f"{mhz:g} MHz = {v:.4f} ms")
    for tag, reset in (("all reset", torch.ones_like(Q.on)),
                       ("half reset", half_reset_mask(Q.t.shape, Q.t.device,
                                                      seed=22))):
        def k3(simple):
            return auto_dt_cuda(default.winds, default.consts, default.flags,
                                Q.t, qc, g.x, g.y, default.uniform_proj,
                                reset, Q.dt, sett.dtmin, DT,
                                abstol=sett.abstol, reltol=sett.reltol,
                                order=default._rk_order, simple=simple)
        assert_bitwise(f"K3 probe {tag}", (k3(False),), (k3(True),))
        s_ms, n_ms = turns_ms("K3", lambda: k3(True), lambda: k3(False), 20)
        out[tag] = dict(simple_ms=s_ms, ms=n_ms,
                        simple_kernel_ms=kernel_ms(
                            lambda: k3(True), "K3 simple only", 20),
                        clocks=smi_clocks())
        log("probe", f"K3 {tag}: _simple + tail {s_ms:.4f} ms (the kernel "
                     f"alone {out[tag]['simple_kernel_ms']:.4f}), new "
                     f"{n_ms:.4f} ms (bitwise equal)")
    return out


def phase_probe(path: str) -> None:
    """The measurements a kernel redesign rests on, each new kernel beside
    its ``_simple`` baseline (in turns, and held to it bit for bit): ptxas
    registers; the SASS of K1's substep loop and of K3's instances, and K3
    on the default state (``probe_k3``); K1 in fixed-substep mode on
    the default and flagship seed states at 1, 2, 5 and 10 substeps (per-lane
    fixed cost and cost per substep) and adaptive from the seed; K1's lane
    divergence on the perturbed 256^2 state and its time on the perturbed
    state at FLAG_N^2; K4 and K6 on the flagship's deposit.  Writes
    everything to ``path`` (and the SASS beside it)."""
    res = {"device": phase_device()}
    b = phase_build()
    res["ptxas"] = b.log
    for ln in b.log.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            print("  ptxas|", ln.strip(), flush=True)
    cuobj = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", str(b.path)], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(os.path.splitext(path)[0] + "_sass.txt", "w") as f:
        f.write(sass)
    res["sass"] = {**sass_loop_count(sass, "advance_kernel"),
                   **sass_loop_count(sass, "advance_simple_kernel"),
                   **sass_path_count(sass, "auto_dt_kernel"),
                   **sass_path_count(sass, "auto_dt_simple_kernel")}
    for k, v in res["sass"].items():
        log("probe", f"SASS {k[:60]}: {v}")
    dev = torch.device("cuda", 0)
    n = FLAG_N
    default = default_model(n, dev)
    flag = flagship_model(n, dev)
    res["k3"] = probe_k3(default, res["sass"])
    k1 = {}

    def k1_cases(tag, setup, cfg, comps, t, dt, adv, reps):
        winds, consts, flags, gx, gy, proj = setup

        def fn(simple):
            return advance_cuda(winds, consts, flags, cfg, DT, comps, t, dt,
                                adv, gx, gy, proj, simple=simple)
        ref = fn(True)
        assert_bitwise(f"K1 {tag}", fn(False), ref)
        s_ms, n_ms = turns_ms("K1", lambda: fn(True), lambda: fn(False), reps)
        out = dict(simple_ms=s_ms, ms=n_ms)
        log("probe", f"K1 {tag}: simple {s_ms:.4f} ms, new {n_ms:.4f} ms "
                     f"(bitwise equal)")
        w = ref.naccept.reshape(-1, 32).double()
        mean = w.mean(dim=1)
        keep = mean > 0
        out["divergence"] = float((w.max(dim=1).values[keep]
                                   / mean[keep]).mean())
        out["naccept"] = [int(ref.naccept.min()), int(ref.naccept.max())]
        out["clocks"] = smi_clocks()
        k1[tag] = out
        log("probe", f"K1 {tag}: naccept {out['naccept']}, lane divergence "
                     f"(mean over warps of max/mean naccept) "
                     f"{out['divergence']:.4f}")
        return ref

    for tag, model in (("default", default), ("flagship", flag)):
        P = model.init_state().particles
        comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
        adv = P.on & model.active_mask
        setup = (model.winds, model.consts, model.flags, model.grid.x,
                 model.grid.y, model.uniform_proj)
        for method in ("tsit5", "bosh3"):
            for nsub in (1, 2, 5, 10):
                cfg = SolverConfig(method=method, adaptive=False)
                r = k1_cases(f"{tag} {method} fixed {nsub}", setup, cfg,
                             comps, P.t, torch.full_like(P.t, DT / nsub),
                             adv, 10)
                assert int(r.naccept.max()) == nsub
        k1_cases(f"{tag} {model.solver.method} adaptive from seed", setup,
                 model.solver, comps, P.t, P.dt, adv, 5)

    # phase_k1's perturbed state, at 256^2 and at FLAG_N^2, where lanes
    # of a warp take different substep counts
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    for size in (256, n):
        comps, dt0, active, grid = perturbed_state(size, dev, seed=0)
        setup = (constant_winds(10.0, 10.0), consts, TermFlags(), grid.x,
                 grid.y, (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
                          float(grid.proj[0, 0, 1, 1]), 0.0))
        for method in ("tsit5", "bosh3"):
            cfg = SolverConfig(method=method, adaptive=True, dtmin=1e-4,
                               force_dtmin=True)
            k1_cases(f"perturbed {size}^2 {method} adaptive", setup, cfg,
                     comps, torch.zeros_like(comps[0]), dt0, active, 5)
    res["k1"] = k1

    # K4 and K6 on the flagship's deposit
    s_flag = flag.init_state()
    core, chans, sact = flagship_deposit_inputs(flag, s_flag)
    g, halo, p = flag.grid, flag.config.halo, flag.remesh_params

    def k4(simple):
        return pic_gather_padded(core[3], core[4], chans, sact, halo,
                                 simple=simple)[:1]

    def k6(simple):
        nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                      halo, p, *core, simple=simple)
        return (*nd, *rm)
    other = {}
    for name, fn in (("K4", k4), ("K6", k6)):
        assert_bitwise(f"{name} flagship", fn(False), fn(True))
        s_ms, n_ms = turns_ms(name, lambda: fn(True), lambda: fn(False), 20)
        other[name] = dict(simple_ms=s_ms, ms=n_ms)
        log("probe", f"{name} flagship deposit: simple {s_ms:.4f} ms, new "
                     f"{n_ms:.4f} ms (bitwise equal)")
    res["k4_k6"] = other
    res["clocks_after"] = smi_clocks()
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


# ---------------------------------------------------------------------------
# gridded (NetCDF) winds
# ---------------------------------------------------------------------------

# The ERA5-shaped record of the gridded configuration: 110^2 nodes 27.93 km
# apart (ERA5's 0.25 degree class), so that its wrap period, 110 x 27.93 km,
# is the periodic box's 1536 x 2 km = 3,072 km; 26 hourly frames (a day of
# 145 steps stays inside it); a storm crossing the box, a calm region and
# seeded noise.
REC_N = 110
REC_FRAMES = 26
REC_SEED = 2024
SQRT2 = float(np.sqrt(2.0))
# assert_adaptive's rules for the adaptive gridded K1 checks at 256^2.  The
# window records change sharply at each frame (up to 1 m/s a node), and a
# lane whose substep straddles a frame time meets a kink in its wind: the
# controller's accept or reject there turns on the last ulps, so more lanes
# take another path than over analytic winds (fixed substeps agree within
# 6e-6 all the same).  Measured on the card: tsit5 with B = 2, 96.45% of
# the lanes within rtol 5e-3 in lne (99% is the analytic rule), and with
# B = 1, naccept equal on 96.24% of the active lanes; one lane of 65,536
# (tsit5, B = 1) ended 1.4e-3 cells apart in x, past the near-zero bound
# 1e-3.  So at least 95% of the lanes within rtol 5e-3 (90% taking as many
# substeps), and every lane within 0.1 or 5e-3 absolute.
GRIDDED_SHARE = 0.95
GRIDDED_LOOSE_ATOL = 5e-3
# the gridded kernel entries of the kernels line, and the TPU kernel each
# extends (the lines where it takes the wind planes)
GRIDDED_REPLACES = {"K1": "picles_tpu/ops/advance_pallas.py:56",
                    "K3": "picles_tpu/ops/advance_pallas.py:204",
                    "K5": "picles_tpu/ops/remesh_pallas.py:124",
                    "K6": "picles_tpu/ops/pic_pallas.py:417"}


def record_winds(seed: int = REC_SEED):
    """The record's (u, v) as float32 [time, lat, lon] (the CF layout, lat
    north to south), the node coordinates (m) and the frame times (h): a
    storm, a Gaussian blob of wind about 600 km across whose direction
    turns through it, peaking near 15 m/s and crossing the box eastward at
    8 m/s, over a 4 m/s south-westerly background; a calm region (below
    sqrt(2) m/s) over about a tenth of the box, drifting westward at 3 m/s,
    where particles switch off and are reseeded; 0.5 m/s of seeded noise;
    and a lull (e-folding radius 300 km) over the storm's centre in the
    first frame only, which the storm fills within the hour.  The
    particles seeded off in the lull see winds above 2 m/s
    (``wind_min_squared``) at t + DT, so the first step re-lights them;
    later re-lights (an off particle samples the wind at its own lagged
    t + DT) are rare."""
    L = 2e3 * FLAG_N
    R = 600e3 * L / 3072e3     # 600 km on the 3,072 km box
    xs = np.arange(REC_N) * (L / REC_N)
    ys = xs[::-1].copy()
    hours = np.arange(REC_FRAMES, dtype=np.float64)
    T, Y, X = np.meshgrid(hours * 3600.0, ys, xs, indexing="ij")

    def dist(a, b):    # periodic
        d = np.abs(a - b) % L
        return np.minimum(d, L - d)

    cx = (0.2 * L + 8.0 * T) % L
    sx = (X - cx + 0.5 * L) % L - 0.5 * L
    r2 = dist(X, cx) ** 2 + dist(Y, 0.5 * L) ** 2
    g = np.exp(-r2 / R ** 2)
    u = 4.0 * 0.8 + 11.0 * g
    v = 4.0 * 0.6 + 9.0 * g * np.clip(sx / R, -1.0, 1.0)
    calm = 1.0 - 0.97 * np.exp(-(dist(X, (0.7 * L - 3.0 * T) % L) ** 2
                                 + dist(Y, 0.08 * L) ** 2) / (1.45 * R) ** 2)
    lull = 1.0 - 0.99 * np.exp(-r2 / (0.5 * R) ** 2) * (T == 0.0)
    rng = np.random.default_rng(seed)
    u = (u * calm + 0.5 * rng.standard_normal(u.shape) * calm) * lull
    v = (v * calm + 0.5 * rng.standard_normal(v.shape) * calm) * lull
    return (u.astype(np.float32), v.astype(np.float32), xs, ys,
            350_640.0 + hours)


def write_record(path: str) -> str:
    """The record as an ERA5-named NetCDF-3 file (scipy): lon, lat (north
    to south), time in hours since an epoch, U10N and V10N [time, lat,
    lon]."""
    from scipy.io import netcdf_file

    u, v, xs, ys, hours = record_winds()
    with netcdf_file(path, "w") as f:
        f.createDimension("time", len(hours))
        f.createDimension("lat", len(ys))
        f.createDimension("lon", len(xs))
        for name, ax in (("lon", xs), ("lat", ys), ("time", hours)):
            f.createVariable(name, "f8", (name,))[:] = ax
        f.variables["time"].units = b"hours since 1980-01-01 00:00:00.0"
        for name, a in (("U10N", u), ("V10N", v)):
            f.createVariable(name, "f4", ("time", "lat", "lon"))[:] = a
    return path


_RECORD = {}


def gridded_record(dev):
    """The record written to a NetCDF-3 file in the git-ignored build
    directory and loaded back through the port's loader onto ``dev`` (once
    a process)."""
    if dev not in _RECORD:
        try:
            import h5py  # noqa: F401
            h5 = "installed"
        except ImportError:
            h5 = "not installed (the scipy NetCDF-3 reader)"
        os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
            path = write_record(os.path.join(tmp, "era5_like.nc"))
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            gw = load_gridded_winds_2d(
                path, u_name="U10N", v_name="V10N", x_name="lon",
                y_name="lat", time_scale=3600.0, relative_time=True,
                mode="wrap", device=dev)
            t_load = time.perf_counter() - t0
        u, _, _, _, _ = record_winds()
        assert tuple(gw.u_data.shape) == (REC_FRAMES, REC_N, REC_N)
        assert gw.t0 == 0.0 and gw.dt == 3600.0 and gw.dy > 0
        assert gw.x_nodes is None and gw.y_nodes is None and \
            gw.t_nodes is None
        assert np.array_equal(gw.u_data.cpu().numpy(),
                              np.transpose(u, (0, 2, 1))[:, :, ::-1])
        speed = np.hypot(u, record_winds()[1])
        log("gridded-record", f"{size / 2**20:.2f} MiB NetCDF-3 loaded in "
                              f"{t_load:.3f} s, h5py {h5}; {REC_FRAMES} "
                              f"frames of {REC_N}^2, dx {gw.dx:.1f} m, wind "
                              f"speed {speed.min():.2f}-{speed.max():.2f} "
                              f"m/s, calm (< sqrt 2) share "
                              f"{float((speed < SQRT2).mean()):.3f}")
        _RECORD[dev] = gw
    return _RECORD[dev]


def window_record(n: int, dev, cadence: float, const: bool = False):
    """A record over an n^2 box for the kernel checks: winds varying
    sharply between frames at ``cadence`` on a 10^2 grid, calm (below
    sqrt(2) m/s) over its first three columns so that the remesh switches
    particles off there; or (``const``)
    (10, 10) m/s everywhere on nodes 4 grid spacings apart, where every
    interpolation weight is a multiple of 1/16 and the interpolant is 10
    exactly."""
    rng = np.random.default_rng(7)
    if const:
        m = n // 4 + 1
        u = np.full((4, m, m), 10.0, np.float32)
        v, dx = u.copy(), 8e3
    else:
        base = rng.uniform(6.0, 14.0, (40, 1, 1))
        u = (base + rng.standard_normal((40, 10, 10))).astype(np.float32)
        v = (0.5 * base + rng.standard_normal((40, 10, 10))).astype(np.float32)
        u[:, :3], v[:, :3] = 0.05 * u[:, :3], 0.05 * v[:, :3]
        dx = 2e3 * n / 10
    return GriddedWinds2D(u_data=torch.as_tensor(u, device=dev),
                          v_data=torch.as_tensor(v, device=dev), x0=0.0,
                          dx=dx, y0=0.0, dy=dx, t0=0.0, dt=cadence,
                          mode="wrap")


def kernel_winds(gw, grid, t0):
    """(the kernel wind, the planes of the window at ``t0`` over ``grid``,
    the plain versions' wind over the same planes)."""
    B = gw.n_breakpoints(DT)
    wf = gw.pallas_pwl_fields(grid.x, grid.y, t0, DT)
    return Winds2D(u=gw.u, v=gw.v, kernel=gridded_kernel(B)), wf, \
        pwl_winds(wf)


def phase_gridded_kernels(dev, results):
    """The gridded instances of K1, K3, K5 and K6 against their plain
    versions over the same planes (``pwl_winds``) at 256^2: a 900 s
    cadence (B = 1), a 400 s one (B = 2) and a 200 s one (B = 3: the
    breakpoints past the kernels' register cache, read through the planes'
    far pointer), the window [1500, 2100] s straddling frames.  K1 in
    fixed-substep and adaptive mode, bosh3 and tsit5; K3 on a half-reset
    mask; K5 on a state where every branch fires; K6 against K2 + K5 bit
    for bit and its node planes against scatter_dense."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    n, t0 = 256, 1500.0
    comps, dt0, active, grid = perturbed_state(n, dev, seed=0)
    proj = (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
            float(grid.proj[0, 0, 1, 1]), 0.0)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    t = torch.full_like(comps[0], t0)
    err = {k: 0.0 for k in ("K1", "K3", "K5", "K6")}
    for cadence in (900.0, 400.0, 200.0):
        gw = window_record(n, dev, cadence)
        kw, wf, pw = kernel_winds(gw, grid, torch.tensor(t0, device=dev))
        B = kw.kernel.n_break
        rhs = make_rhs(pw.u, pw.v, consts, flags)
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cfg = SolverConfig(method=method, adaptive=adaptive,
                                   dtmin=1e-4, force_dtmin=True)
                dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
                k = advance_cuda(kw, consts, flags, cfg, DT, comps, t, dt,
                                 active, grid.x, grid.y, proj, wind_fields=wf)
                p = integrate_to(rhs, torch.stack(comps, dim=-1), t, t + DT,
                                 dt, aux, active, cfg)
                torch.cuda.synchronize()
                tag = (f"K1 gridded B={B} {method} "
                       f"{'adaptive' if adaptive else 'fixed'}")
                names = ("lne", "cgx", "cgy", "x", "y")
                assert torch.equal(k.failed, p.failed), f"{tag}: failed"
                extra = ""
                if adaptive:
                    errs = [assert_adaptive(f"{tag} {nm}", kz, p.z[..., i],
                                            min_share=GRIDDED_SHARE,
                                            loose_atol=GRIDDED_LOOSE_ATOL)
                            for i, (nm, kz) in enumerate(zip(names, k[:5]))]
                    assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
                    extra = "; " + assert_controller(
                        tag, k, p, active, min_share=GRIDDED_SHARE - 0.05)
                else:
                    errs = [assert_close(f"{tag} {nm}", kz, p.z[..., i],
                                         1e-5, 1e-6)
                            for i, (nm, kz) in enumerate(zip(names, k[:5]))]
                    assert torch.equal(k.naccept, p.naccept), tag
                    assert torch.equal(k.dt, p.dt), tag
                    err["K1"] = max(err["K1"], max(errs))
                log("gridded-kernels", f"{tag}: max abs err {max(errs):.3e}, "
                                       f"failed {int(k.failed.sum())}{extra}")
        reset = half_reset_mask((n, n), dev, seed=20)
        k = auto_dt_cuda(kw, consts, flags, t, comps, grid.x, grid.y, proj,
                         reset, dt0, 1e-4, DT, wind_fields=wf)
        p = auto_dt_reset(rhs, t, torch.stack(comps, dim=-1), aux, reset,
                          dt0, 1e-4, DT)
        e3 = assert_close(f"K3 gridded B={B}", k, p, 1e-5, 0.0)
        assert torch.equal(bits(k[~reset]), bits(dt0[~reset]))
        # the generic flag set's gridded instance
        nodir = TermFlags(direction=False)
        k = auto_dt_cuda(kw, consts, nodir, t, comps, grid.x, grid.y, proj,
                         reset, dt0, 1e-4, DT, wind_fields=wf)
        p = auto_dt_reset(make_rhs(pw.u, pw.v, consts, nodir), t,
                          torch.stack(comps, dim=-1), aux, reset, dt0, 1e-4,
                          DT)
        e3 = max(e3, assert_close(f"K3 gridded B={B} generic", k, p, 1e-5,
                                  0.0))
        err["K3"] = max(err["K3"], e3)
        m, node, core = remesh_case(dev, n, "wind_sea", True, seed=11)
        core = core[:-1] + (torch.tensor(t0, device=dev),)
        rp = m.remesh_params._replace(winds=kw)
        k5 = remesh_cuda(rp, node, *core, wind_fields=wf)
        e5 = assert_remesh(f"K5 gridded B={B}", k5,
                           remesh_core(rp._replace(winds=pw), node, *core))
        for bit in (1, 2, 4):
            assert int(((k5.branch & bit) != 0).sum()) > 0, bit
        err["K5"] = max(err["K5"], e5)
        chans = TR.particle_to_node(*core[:3])
        sact = (core[6] & core[7]).contiguous()
        halo = ((1, 3), (0, 2))
        nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact,
                                      m.grid.stats, halo, rp, *core,
                                      wind_fields=wf)
        k2, _ = pic_gather(core[3], core[4], chans, sact, m.grid.stats, halo)
        k5b = remesh_cuda(rp, k2, *core, wind_fields=wf)
        S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                             m.grid.stats, halo)
        torch.cuda.synchronize()
        assert_bitwise(f"K6 gridded B={B} vs K2 + K5", (*nd, *rm),
                       (*k2, *k5b))
        for c in range(3):
            err["K6"] = max(err["K6"], assert_close(
                f"K6 gridded B={B} node ch{c}", nd[c], S[..., c], 1e-5,
                1e-6 * float(S[..., c].abs().max())))
        log("gridded-kernels", f"B={B}: K3 max abs err {e3:.3e}; K5 "
                               f"{branch_counts(k5.branch)}, values max abs "
                               f"err {e5:.3e}; K6 bitwise equal to K2 + K5")
    for k, e in err.items():
        results[f"{k} gridded"]["max_abs_err"] = e


def phase_gridded_anchor(flag, s_flag, default, s_def):
    """The constant record at FLAG_N^2 (zero slopes: u = 10 + t 0 = 10
    exactly): K1 on the flagship state (both methods, both modes), K3 on
    the default state, K5 and K6 on the flagship's deposit, each gridded
    instance bit for bit its constant-wind instance."""
    dev = s_flag.state.device
    gw = window_record(FLAG_N, dev, 900.0, const=True)
    g = flag.grid
    kw, wf, _ = kernel_winds(gw, g, s_flag.time)
    P = s_flag.particles
    adv = P.on & flag.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    for method in ("bosh3", "tsit5"):
        for adaptive in (True, False):
            cfg = dataclasses.replace(flag.solver, method=method,
                                      adaptive=adaptive)
            a = advance_cuda(kw, flag.consts, flag.flags, cfg, DT, comps, P.t,
                             P.dt, adv, g.x, g.y, flag.uniform_proj,
                             wind_fields=wf)
            b = advance_cuda(flag.winds, flag.consts, flag.flags, cfg, DT,
                             comps, P.t, P.dt, adv, g.x, g.y,
                             flag.uniform_proj)
            assert_bitwise(f"K1 constant record {method} adaptive="
                           f"{adaptive}", a, b)
    Q = s_def.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    kwd, wfd, _ = kernel_winds(gw, default.grid, s_def.time)
    for reset in (torch.ones_like(Q.on), half_reset_mask(Q.t.shape, dev, 22)):
        a, b = (auto_dt_cuda(w, default.consts, default.flags, Q.t, qc,
                             default.grid.x, default.grid.y,
                             default.uniform_proj, reset, Q.dt,
                             default.settings.dtmin, DT,
                             order=default._rk_order, wind_fields=f)
                for w, f in ((kwd, wfd), (default.winds, ())))
        assert_bitwise("K3 constant record", (a,), (b,))
    core, chans, sact = flagship_deposit_inputs(flag, s_flag)
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats,
                         flag.config.halo)
    rk = flag.remesh_params._replace(winds=kw)
    assert_bitwise("K5 constant record",
                   remesh_cuda(rk, node, *core, wind_fields=wf),
                   remesh_cuda(flag.remesh_params, node, *core))
    a = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                          flag.config.halo, rk, *core, wind_fields=wf)
    b = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                          flag.config.halo, flag.remesh_params, *core)
    assert_bitwise("K6 constant record", (*a[0], *a[1]), (*b[0], *b[1]))
    log("gridded-anchor", f"{FLAG_N}^2 constant record ({len(wf)} planes, "
                          f"slopes 0): K1 (bosh3 and tsit5, adaptive and "
                          f"fixed), K3 (all and half reset), K5 and K6 "
                          f"bitwise equal to their constant-wind instances")


def device_ops_per_step(model, ms, steps: int = 3):
    """Device operations (kernels, copies, fills) per eager step in a
    torch.profiler trace of ``steps`` steps; returns (ops, state)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms = eager_steps(model, ms, steps)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / steps, ms


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn`` in a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def plane_seconds(model, ms, reps: int = 10) -> dict:
    """The per-step planes' cost as the step forms them (the record's
    corners of the nodes kept by the model) and formed afresh (corners
    and all, as before the model kept them), in turns (afresh, kept, kept,
    afresh): device ms a call (CUDA events), device ops a call, and host ms
    a call of the kept form (enqueue, no synchronisation)."""
    g, gw = model.grid, model.gridded_winds
    DT_ = float(model.settings.timestep)

    def kept():
        return model.wind_fields(g, ms.time)

    def fresh():
        return gw.pallas_pwl_fields(g.x, g.y, ms.time, DT_)

    f1, k1 = cuda_time_ms(fresh, reps), cuda_time_ms(kept, reps)
    k2, f2 = cuda_time_ms(kept, reps), cuda_time_ms(fresh, reps)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        kept()
    host_ms = (time.perf_counter() - h0) * 1e3 / reps
    torch.cuda.synchronize()
    return dict(device_ms=(k1 + k2) / 2, fresh_device_ms=(f1 + f2) / 2,
                ops=device_ops(kept), fresh_ops=device_ops(fresh),
                host_ms=host_ms)


def phase_gridded_main_path(dev, gw, results, timing):
    """The gridded configuration at FLAG_N^2 from the NetCDF-3 record, each
    path with the counters set to 0 just before and read just after: the
    production day (fused, K1 and K6 once a step, checkpointed at step 72
    and resumed bit for bit), the default configuration (K1, K2, K3) and
    the "pallas" remesh (K1, K2, K5), 3 steps each.  Returns the production
    model and its last state and the default ones, for
    ``gridded_kernel_times``."""
    n = FLAG_N
    prod = gridded_model(n, dev, gw, "production")
    B = prod._wind_B
    n_wf = 4 + 3 * B
    assert B == 1 and prod.resolved_config().advance_mode == "cuda"
    r = run_day_resumed(prod, "gridded production day")
    full, wall, peak = r["full"], r["wall"], r["peak"]
    size, t_save, t_load = r["size"], r["t_save"], r["t_load"]
    m = check_state("gridded production day", full.state, n_failed=0,
                    n_clamped=0)
    g, c, day = r["graphed_counts"], r["launches"], r["day"]
    e = r["eager_launches"]
    assert g["K1"] == g["K6"] == WARMUP_STEPS + 1, g
    assert e["K6"] == 145 and e["K1"] == e["K6"], e
    assert e["K2"] == e["K3"] == e["K5"] == 0, e
    launches = {"K1": c["K1"], "K6": c["K6"]}
    timing["gridded_day_trace"] = r["trace"]
    log("counters", f"gridded production day through Simulation.run: the "
                    f"host's calls {g}; launches by trace {c}; the day again "
                    f"eagerly: launches {e}")
    log("gridded-main", f"the day again step by step, bitwise equal to "
                        f"Simulation.run's; counters summed over its 145 "
                        f"steps: {day}")
    timing.update(gridded_day_wall_s=wall, gridded_day_steps=145,
                  gridded_day_ms_per_step=wall * 1e3 / 145,
                  gridded_day_pushes_per_s=n * n * 145 / wall,
                  gridded_peak_bytes=peak, gridded_checkpoint_bytes=size)
    log("gridded-main", f"{n}^2 fused, B={B} ({n_wf} planes a step), 1 day "
                        f"storeless (graphed): 145 steps in {wall:.3f} s wall "
                        f"({wall * 1e3 / 145:.3f} ms/step, "
                        f"{n * n * 145 / wall:.4e} pushes/s), peak "
                        f"{peak / 2**30:.3f} GiB; checkpoint at 72 "
                        f"{size / 2**20:.1f} MiB ({t_save:.2f} s / "
                        f"{t_load:.2f} s), resumed bitwise equal; metrics {m}")
    s_prod = full.state
    ops, _ = device_ops_per_step(prod, s_prod)
    pl = plane_seconds(prod, s_prod)
    timing.update(gridded_ops_per_step=ops,
                  gridded_planes_device_ms=pl["device_ms"],
                  gridded_planes_fresh_device_ms=pl["fresh_device_ms"],
                  gridded_planes_ops=pl["ops"],
                  gridded_planes_fresh_ops=pl["fresh_ops"],
                  gridded_planes_host_ms=pl["host_ms"],
                  gridded_day_planes_device_s=pl["device_ms"] * 145 / 1e3)
    log("gridded-main", f"{ops:.1f} device ops per step; the per-step planes "
                        f"{pl['device_ms']:.4f} ms of device time in "
                        f"{pl['ops']} ops ({pl['fresh_device_ms']:.4f} ms in "
                        f"{pl['fresh_ops']} ops with the corners formed "
                        f"afresh, in turns), {pl['host_ms']:.4f} ms of host "
                        f"enqueue a step ({pl['device_ms'] * 145 / 1e3:.3f} "
                        f"s of device time in the day)")

    states = {}
    fired = {}
    for path, steps in (("default", 3), ("pallas", 3)):
        model = gridded_model(n, dev, gw, path)
        ms = model.step(model.init_state())
        mets = [ms.metrics]
        reset_counters()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            ms = model.step(ms)
            mets.append(ms.metrics)
        end.record()
        torch.cuda.synchronize()
        ms_step = start.elapsed_time(end) / steps
        m = check_state(f"gridded {path}", ms, n_failed=0, n_clamped=0)
        for mt in mets:
            assert int(mt.n_failed) == 0 and int(mt.n_clamped) == 0, path
            for k, v in mt.as_dict().items():
                fired[k] = fired.get(k, 0) + v
        c = counters()
        assert c["K1"] == steps, c
        if path == "default":
            assert c["K2"] == c["K3"] == steps and c["K5"] == c["K6"] == 0, c
            launches["K3"] = c["K3"]
        else:
            assert c["K2"] == c["K5"] == steps and c["K3"] == c["K6"] == 0, c
            launches["K5"] = c["K5"]
        launches["K1"] += c["K1"]
        log("counters", f"gridded {path} path launches {c}")
        timing[f"gridded_{path}_ms_per_step"] = ms_step
        timing[f"gridded_{path}_pushes_per_s"] = n * n / (ms_step / 1e3)
        log("gridded-main", f"{n}^2 {path}: {ms_step:.3f} ms/step, "
                            f"{n * n / (ms_step / 1e3):.4e} pushes/s; "
                            f"metrics {m}")
        states[path] = (model, ms)
    log("gridded-main", f"branch counts over the default and pallas runs "
                        f"(4 steps each from the seed): off {fired['n_off']}, "
                        f"re-light {fired['n_relight']}, reseed "
                        f"{fired['n_reseed']}, gather {fired['n_gather']}; "
                        f"over the production day: off {day['n_off']}, "
                        f"re-light {day['n_relight']}, reseed "
                        f"{day['n_reseed']}")
    # the calm region switches particles off from the seed on and the
    # remesh reseeds where it has passed; the first frame's lull re-lights
    # particles in the first step of every path
    for k in ("n_off", "n_relight", "n_reseed"):
        assert day[k] > 0, (k, day)
    for k in ("n_off", "n_relight"):
        assert fired[k] > 0, (k, fired)
    for k, v in launches.items():
        results[f"{k} gridded"]["launches"] = v
        assert v > 0, k
    return (prod, s_prod, *states["default"])


def gridded_kernel_times(prod, s_prod, default, s_def, results):
    """The gridded instances at FLAG_N^2 on the gridded states: K1 on the
    production day's last state (B = 1) and on the default configuration's,
    K3 on the default state with every lane reset, K5 and K6 on the
    production state's deposit; each held against its plain version and
    timed beside it with its bound.  K1, K3 and K5's wrappers launch their
    kernel and nothing else on the card, so CUDA events time them
    (``cuda_time_ms``): late in a process a profiler trace can lose launches
    and misread the rest (a K5 trace of 19 of 20 launches read 0.0389 ms,
    below the kernel's bound, on the card); K6's wrapper adds the clamped
    count, so K6 is taken from a trace (``kernel_ms``)."""
    n = FLAG_N * FLAG_N
    out = {}
    for tag, model, st in (("flagship", prod, s_prod),
                           ("default", default, s_def)):
        P, g = st.particles, model.grid
        adv = P.on & model.active_mask
        comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
        wf = model.wind_fields(g, st.time)
        pw = pwl_winds(wf)
        rhs = make_rhs(pw.u, pw.v, model.consts, model.flags)

        def k1():
            return advance_cuda(model.winds, model.consts, model.flags,
                                model.solver, DT, comps, P.t, P.dt, adv, g.x,
                                g.y, model.uniform_proj, wind_fields=wf)

        def k1_plain():
            return integrate_to(rhs, torch.stack(comps, dim=-1), P.t,
                                P.t + DT, P.dt, model.aux, adv, model.solver)

        k, p = k1(), k1_plain()
        assert torch.equal(k.failed, p.failed), f"K1 gridded {tag}: failed"
        e = max(assert_adaptive(f"K1 gridded {tag} {nm}", kz, p.z[..., i],
                                loose_atol=GRIDDED_LOOSE_ATOL)
                for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x",
                                                  "y"), k[:5])))
        ctl = assert_controller(f"K1 gridded {tag}", k, p, adv)
        b = k1_bound(n, model.solver.method, True, adv,
                     p.naccept + p.nreject, n_wf=len(wf))
        out[f"K1 {tag}"] = dict(ms=cuda_time_ms(k1, 10),
                                plain_ms=cuda_time_ms(k1_plain, 2),
                                max_abs_err=e, **b)
        log("gridded-kernels", f"K1 {tag} state {FLAG_N}^2 "
                               f"({model.solver.method}): {ctl}")
        if tag == "default":
            reset = torch.ones_like(P.on)
            sett = model.settings

            def k3():
                return auto_dt_cuda(model.winds, model.consts, model.flags,
                                    P.t, comps, g.x, g.y, model.uniform_proj,
                                    reset, P.dt, sett.dtmin, DT,
                                    abstol=sett.abstol, reltol=sett.reltol,
                                    order=model._rk_order, wind_fields=wf)

            def k3_plain():
                return auto_dt_reset(rhs, P.t, torch.stack(comps, dim=-1),
                                     model.aux, reset, P.dt, sett.dtmin, DT,
                                     abstol=sett.abstol, reltol=sett.reltol,
                                     order=model._rk_order)

            e3 = assert_close("K3 gridded default state", k3(), k3_plain(),
                              1e-5, 0.0)
            out["K3"] = dict(ms=cuda_time_ms(k3, 20),
                             plain_ms=cuda_time_ms(k3_plain, 5),
                             max_abs_err=e3,
                             **k3_bound(reset, kernel_wind(model.winds)))
    core, chans, sact = flagship_deposit_inputs(prod, s_prod)
    wf = prod.wind_fields(prod.grid, s_prod.time)
    g, halo = prod.grid, prod.config.halo
    rp = prod.remesh_params
    prp = rp._replace(winds=pwl_winds(wf))
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    k5 = remesh_cuda(rp, node, *core, wind_fields=wf)
    e5 = assert_remesh("K5 gridded flagship", k5,
                       remesh_core(prp, node, *core))

    def plain_fused():
        Sp, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                              g.stats, halo)
        return remesh_core(prp, tuple(Sp[..., c] for c in range(3)), *core)

    # K6's remesh tail is K5's over K2's node sums (held just above against
    # remesh_core), so its outputs are held to K5's bit for bit, and its
    # node planes to scatter_dense's as the analytic phase holds them
    nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, rp, *core, wind_fields=wf)
    for a, b in zip(nd, node):
        assert torch.equal(a, b), "K6 gridded: node planes != K2's"
    for f in rm._fields:
        assert torch.equal(getattr(rm, f), getattr(k5, f)), \
            f"K6 gridded flagship: {f} != K2 + K5"
    S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                         g.stats, halo)
    e6 = max(assert_close(f"K6 gridded flagship node ch{c}", nd[c], S[..., c],
                          1e-5, 1e-6 * float(S[..., c].abs().max()))
             for c in range(3))
    del S
    log("K6", f"{FLAG_N}^2 gridded flagship (halo {halo}, B = "
              f"{prod._wind_B}): remesh outputs equal to K2 + K5 bitwise "
              f"({branch_counts(rm.branch)}), K5 values vs plain max abs err "
              f"{e5:.3e}; node planes vs plain max abs err {e6:.3e}")
    out["K5"] = dict(ms=cuda_time_ms(lambda: remesh_cuda(
        rp, node, *core, wind_fields=wf), 20),
        plain_ms=cuda_time_ms(lambda: remesh_core(prp, node, *core), 5),
        max_abs_err=e5, **remesh_bound(n, len(wf)))
    out["K6"] = dict(ms=kernel_ms(lambda: pic_gather_remesh(
        core[3], core[4], chans, sact, g.stats, halo, rp, *core,
        wind_fields=wf), "K6", 20), plain_ms=cuda_time_ms(plain_fused, 5),
        max_abs_err=e6, **deposit_bound(n, n, halo, remesh=True,
                                        n_wf=len(wf)))
    for key, r in out.items():
        kk = key.split()[0] + " gridded"
        if key == "K1 default":
            results[kk].update({"default_" + f: r[f] for f in
                                ("ms", "plain_ms", "bound_ms", "bound_by")})
        else:
            results[kk].update(ms=r["ms"], plain_ms=r["plain_ms"],
                               bound_ms=r["bound_ms"], bound_by=r["bound_by"])
        if not key.startswith("K1"):   # K1's entry: fixed-substep errors
            results[kk]["max_abs_err"] = max(
                results[kk].get("max_abs_err", 0.0), r["max_abs_err"])
        log("kernel-time", f"{key} gridded: {r['ms']:.4f} ms, plain "
                           f"{r['plain_ms']:.4f} ms, bound "
                           f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# The gridded card-vs-CPU check's solver tolerances.  The card's kernels
# read the planes, the CPU's plain path the interpolant: equal in exact
# arithmetic, an ulp of wind apart in float32.  At the default abstol 1e-4
# / reltol 1e-3, young seas from the seed turn that ulp into other substep
# paths: the plain advance alone, over the interpolant and over the planes
# of one window on the CPU, differs by 1.8% in lne on the default
# configuration's first step (bosh3 production 1.9e-4; measured at 64^2).
# At 1e-7 / 1e-6 the same comparison (with host-compiled kernels standing
# in for the card's) agrees within 1.2e-5 over 3 steps, so the 5e-3 of
# phase_card_vs_cpu holds with room to spare.
CARD_VS_CPU_TOLS = dict(abstol=1e-7, reltol=1e-6)


def phase_gridded_card_vs_cpu(gw):
    """64^2 (the record's corner of 128 km): the gridded production and
    default models with the kernels on the card (the planes) against the
    same models on the CPU (the interpolant), 3 steps at the solver
    tolerances CARD_VS_CPU_TOLS, held at phase_card_vs_cpu's 5e-3; every
    counter equal but substeps_max, the most substeps a lane took, within
    2."""
    for path in ("production", "default"):
        mg = gridded_model(64, "cuda", gw, path, tols=CARD_VS_CPU_TOLS)
        mc = gridded_model(64, "cpu", gw, path, tols=CARD_VS_CPU_TOLS)
        assert mc.resolved_config().advance_mode == "torch"
        sg, sc = mg.init_state(), mc.init_state()
        for _ in range(3):
            sg, sc = mg.step(sg), mc.step(sc)
        S = sc.state
        log("gridded-card-vs-cpu", f"{path} 64^2, 3 steps: max abs err "
                                   f"{max_abs(sg.state.cpu(), S):.3e} of "
                                   f"{float(S.abs().max()):.3e}")
        err = assert_close(f"gridded card vs CPU {path}", sg.state.cpu(), S,
                           5e-3, 1e-6 * float(S.abs().max()))
        mg_, mc_ = sg.metrics.as_dict(), sc.metrics.as_dict()
        smax = (mg_.pop("substeps_max"), mc_.pop("substeps_max"))
        assert mg_ == mc_ and abs(smax[0] - smax[1]) <= 2, \
            f"gridded card vs CPU {path}: {mg_} {smax[0]} vs {mc_} {smax[1]}"
        log("gridded-card-vs-cpu", f"{path}: within 5e-3, counters equal, "
                                   f"substeps_max {smax[0]} vs {smax[1]} "
                                   f"(max abs err {err:.3e})")


# ---------------------------------------------------------------------------
# spherical and tripolar grids: per-node projection planes in K1/K3, the
# tripolar north seam in K2/K6
# ---------------------------------------------------------------------------

# The global tripolar configuration: the synthetic supergrid at a quarter
# degree (2880 x 1440, k = 2: a 1440 x 720 T-grid, 1,036,800 nodes) with
# the default pole masks and the continent of
# benchmark/tripolar_global_demo.py, DT = 1200 s, forced by a gridded
# record of tests/test_tripolar.py's jet (``tripolar_record``)
TRI_SUPER = (2880, 1440)
TRI_DT = 1200.0
TRI_STEPS = 72   # a day of TRI_DT
# assert_adaptive's and assert_controller's shares for adaptive K1 with
# projection planes on the perturbed 256^2 curved-grid states.  There the
# plain version alone, its lne (or cg_x) moved by one ulp, keeps only
# 98.60-99.47% of the lanes within rtol 5e-3 and takes as many substeps on
# only 93.70-94.01% of them (time-cosine tsit5; measured on the CPU), and
# the kernel kept 98.64% and 93.56% on the card (fixed substeps within
# 4.8e-6).  So at least 97% of the lanes within rtol 5e-3 and 90% taking
# as many substeps (a safety factor of 0.85 for 0.9 leaves 72-83%).
PROJ_SHARE = 0.97
PROJ_COUNT_SHARE = 0.90
# the new entries of the kernels line: the branch each kernel gains, and
# the TPU kernel's lines it replaces
PROJ_REPLACES = {"K1 proj": "picles_tpu/ops/advance_pallas.py:60",
                 "K3 proj": "picles_tpu/ops/advance_pallas.py:206",
                 "K2 tripolar": "picles_tpu/ops/pic_pallas.py:306",
                 "K6 tripolar": "picles_tpu/ops/pic_pallas.py:438"}


def tripolar_grid(dev, nx_super: int, ny_super: int):
    """The synthetic tripolar grid (k = 2) with its pole masks and
    benchmark/tripolar_global_demo.py's continent (a lon/lat box with a
    ragged northern edge), cut from the float32 node coordinates as the
    demo cuts it."""
    g = synthetic_tripolar_grid(k=2, nx_super=nx_super, ny_super=ny_super,
                                device=dev)
    lon, lat = g.x.cpu().numpy(), g.y.cpu().numpy()
    land = ((lon > 250.0) & (lon < 310.0) & (lat > -40.0)
            & (lat < 55.0 + 10.0 * np.sin(np.radians(3.0 * lon))))
    total = make_boundaries((g.mask.cpu().numpy() != 0) & ~land,
                            Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    return dataclasses.replace(g, mask=torch.as_tensor(
        total.astype(np.int32), device=dev))


def tripolar_record(dev) -> GriddedWinds2D:
    """A T03_PIC_tripolar_realistic-like record in memory:
    tests/test_tripolar.py:116-127's zonal jet at 40N with a time wobble and
    a meridional part, on a 1 degree lon/lat record (lon 0..360, lat
    -80..90) with hourly frames over 25 h."""
    lon = np.linspace(0.0, 360.0, 361)
    lat = np.linspace(-80.0, 90.0, 171)
    t = np.arange(26) * 3600.0
    T, LO, LA = np.meshgrid(t, lon, lat, indexing="ij")
    u = 12.0 * np.exp(-((LA - 40) / 20.0) ** 2) * (1 + 0.2 * np.sin(T / 4e4))
    v = 3.0 * np.sin(np.radians(LO)) * np.exp(-((LA - 40) / 25.0) ** 2)
    return GriddedWinds2D(
        u_data=torch.as_tensor(u.astype(np.float32), device=dev),
        v_data=torch.as_tensor(v.astype(np.float32), device=dev), x0=0.0,
        dx=1.0, y0=-80.0, dy=1.0, t0=0.0, dt=3600.0)


def tripolar_model(grid, gw, path: str, tols=None, **cfg_kw):
    """The tripolar configuration on ``grid`` forced by ``gw``, with the JAX
    tripolar tests' settings (DT = 1200 s, dt = 1e-3, dtmin = 1e-4,
    force_dtmin, the log-energy minimum of a (10, 10) m/s minimal windsea),
    periodic, halo 3: "production" bosh3 with the carried dt and the fused
    remesh (K1, K6), "pallas" with K5 (K1, K2, K5), "default"
    ``WaveGrowth2DConfig()``'s tsit5 with the Hairer reset (K1, K2, K3);
    ``cfg_kw`` more config entries (``scatter_mode``)."""
    ws = FR.MinimalWindsea(10.0, 10.0, TRI_DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=TRI_DT,
                       timestep=TRI_DT, total_time=6 * DAY, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       solver="tsit5" if path == "default" else "bosh3",
                       **(tols or {}))
    cfg = WaveGrowth2DConfig(periodic_boundary=True, halo=3, **cfg_kw)
    if path != "default":
        cfg = dataclasses.replace(
            cfg, dt_reset_mode="carry",
            remesh_mode="fused" if path == "production" else "pallas")
    return WaveGrowth2D(grid, gw, sett, config=cfg)


def one_cell_reach(active: np.ndarray) -> np.ndarray:
    """The nodes a CIC deposit of displacements under one cell can reach
    from the ``active`` nodes of a tripolar grid: the 8-neighbourhood, x
    periodic, with the top row's seam mirror (a ghost row of the top row,
    x flipped) above it."""
    nx, ny = active.shape
    ext = np.concatenate([active, active[(nx - 2 - np.arange(nx)) % nx,
                                         -1:]], axis=1)
    reach = np.zeros_like(ext)
    for dx in (-1, 0, 1):
        sh = np.roll(ext, dx, axis=0)
        reach |= sh
        reach[:, 1:] |= sh[:, :-1]
        reach[:, :-1] |= sh[:, 1:]
    return reach[:, :ny]


def check_tripolar(tag: str, model, ms) -> dict:
    """A finite state, no failed lane and no particle on land.  Energy
    reaches land only where a CIC deposit touches a land node one cell from
    an active node: at a concave coast corner a particle moving diagonally
    deposits on the land node between its two land neighbours (land
    boundary nodes are 4-neighbours of ocean), as picles_tpu's deposit
    does; that energy is logged and held below 1e-6 of the total.  Returns
    the counters, with the land energy's share."""
    m = check_state(tag, ms, n_failed=0)
    land = model.grid.mask == 0
    assert not bool(ms.particles.on[land].any()), f"{tag}: a particle on land"
    e = ms.state[..., 0]
    e_land = e[land].double()
    share = float(e_land.abs().sum() / e.double().abs().sum())
    far = land.cpu().numpy() & ~one_cell_reach(
        model.active_mask.cpu().numpy()) & (e.cpu().numpy() != 0)
    assert not far.any(), \
        f"{tag}: energy on {int(far.sum())} land nodes beyond one cell"
    assert share < 1e-6, f"{tag}: land holds {share:.3e} of the energy"
    m["land_energy_share"] = share
    m["land_nodes_with_energy"] = int((e_land != 0).sum())
    return m


def curved_grids(n: int, dev) -> dict:
    """An n^2 spherical grid (periodic lon, open lat from 70S to 70N) and an
    n^2 synthetic tripolar grid."""
    return {"spherical": spherical_grid_2d(0.0, 360.0 * (n - 1) / n, n,
                                           -70.0, 70.0, n,
                                           periodic_boundary=(True, False),
                                           device=dev),
            "tripolar": synthetic_tripolar_grid(k=2, nx_super=2 * n,
                                                ny_super=2 * n, device=dev)}


def phase_proj(dev, results):
    """K1 and K3 with per-node projection planes (``node_projection``)
    against their plain versions on the perturbed state over 256^2
    spherical and tripolar grids: fixed substeps within rtol 1e-5, adaptive
    by share of lanes (``assert_adaptive``, ``assert_controller``), K3
    within rtol 1e-5 with its unreset lanes' dt kept bit for bit.  Then the
    anchor: the 256^2 box, and the box rotated by 30 degrees (off-diagonal
    m01/m10), given as planes equal the same projection given as the 5
    scalars bit for bit, for K1 (both methods, both modes) and K3 (every
    lane and half reset), constant and gridded winds, the default and a
    generic term-flag set."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    n = 256
    err1 = err3 = 0.0
    names = ("lne", "cgx", "cgy", "x", "y")
    for kind, g in curved_grids(n, dev).items():
        assert uniform_projection(g.proj, g.pc) is None, kind
        planes = node_projection(g.proj, g.pc)
        comps, dt0, active, _ = perturbed_state(n, dev, seed=30, grid=g)
        aux = RHSParams(x=g.x, y=g.y, M=g.proj, pc=g.pc)
        t = torch.full_like(comps[0], 1800.0)
        for wname, winds in (("constant", constant_winds(10.0, 10.0)),
                             ("time-cosine",
                              time_cosine_winds(10.0, 5.0,
                                                period=6 * 3600.0))):
            rhs = make_rhs(winds.u, winds.v, consts, flags)
            for method in ("bosh3", "tsit5"):
                for adaptive in (False, True):
                    cfg = SolverConfig(method=method, adaptive=adaptive,
                                       dtmin=1e-4, force_dtmin=True)
                    dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
                    k = advance_cuda(winds, consts, flags, cfg, DT, comps, t,
                                     dt, active, g.x, g.y, planes)
                    p = integrate_to(rhs, torch.stack(comps, dim=-1), t,
                                     t + DT, dt, aux, active, cfg)
                    torch.cuda.synchronize()
                    tag = (f"K1 proj {kind} {wname} {method} "
                           f"{'adaptive' if adaptive else 'fixed'}")
                    assert torch.equal(k.failed, p.failed), f"{tag}: failed"
                    extra = ""
                    if adaptive:
                        errs = [assert_adaptive(f"{tag} {nm}", kz,
                                                p.z[..., i],
                                                min_share=PROJ_SHARE)
                                for i, (nm, kz) in enumerate(zip(names,
                                                                 k[:5]))]
                        assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
                        extra = "; " + assert_controller(
                            tag, k, p, active, min_share=PROJ_COUNT_SHARE)
                    else:
                        errs = [assert_close(f"{tag} {nm}", kz, p.z[..., i],
                                             1e-5, 1e-6)
                                for i, (nm, kz) in enumerate(zip(names,
                                                                 k[:5]))]
                        assert torch.equal(k.naccept, p.naccept), tag
                        assert torch.equal(k.dt, p.dt), tag
                        err1 = max(err1, max(errs))
                    log("K1 proj", f"{tag}: max abs err {max(errs):.3e}, "
                                   f"substeps max {int(k.naccept.max())}"
                                   f"{extra}")
            for rname, reset in (("all", torch.ones_like(active)),
                                 ("half", half_reset_mask((n, n), dev, 31))):
                k = auto_dt_cuda(winds, consts, flags, t, comps, g.x, g.y,
                                 planes, reset, dt0, 1e-4, DT)
                p = auto_dt_reset(rhs, t, torch.stack(comps, dim=-1), aux,
                                  reset, dt0, 1e-4, DT)
                tag = f"K3 proj {kind} {wname} {rname} reset"
                e3 = assert_close(tag, k, p, 1e-5, 0.0)
                assert torch.equal(bits(k[~reset]), bits(dt0[~reset])), tag
                err3 = max(err3, e3)
                log("K3 proj", f"{tag}: max abs err {e3:.3e}")
    results["K1 proj"]["max_abs_err"] = err1
    results["K3 proj"]["max_abs_err"] = err3

    comps, dt0, active, box = perturbed_state(n, dev, seed=0)
    nb = box.nx
    t0 = 1500.0
    t = torch.full_like(comps[0], t0)
    gw = window_record(nb, dev, 900.0)
    half = half_reset_mask((nb, nb), dev, 32)
    for angle in (0.0, 30.0):
        g = box if angle == 0.0 else cartesian_grid_2d(
            0.0, 2e3 * (nb - 1), nb, 0.0, 2e3 * (nb - 1), nb, angle=angle,
            periodic_boundary=(True, True), device=dev)
        scalars = uniform_projection(g.proj, g.pc)
        assert (scalars[1] != 0.0 and scalars[2] != 0.0) == (angle != 0.0)
        planes = node_projection(g.proj, g.pc)
        kw, wf, _ = kernel_winds(gw, g, torch.tensor(t0, device=dev))
        for fl in (TermFlags(), TermFlags(direction=False, peak_shift=False)):
            for wname, winds, fields in (("constant",
                                          constant_winds(10.0, 10.0), ()),
                                         ("gridded", kw, wf)):
                for method in ("bosh3", "tsit5"):
                    for adaptive in (False, True):
                        cfg = SolverConfig(method=method, adaptive=adaptive,
                                           dtmin=1e-4, force_dtmin=True)
                        a, b = (advance_cuda(winds, consts, fl, cfg, DT,
                                             comps, t, dt0, active, g.x, g.y,
                                             pr, wind_fields=fields)
                                for pr in (planes, scalars))
                        assert_bitwise(f"K1 anchor angle {angle:g} {wname} "
                                       f"{method} adaptive={adaptive} {fl}",
                                       a, b)
                for reset in (torch.ones_like(active), half):
                    a, b = (auto_dt_cuda(winds, consts, fl, t, comps, g.x,
                                         g.y, pr, reset, dt0, 1e-4, DT,
                                         wind_fields=fields)
                            for pr in (planes, scalars))
                    assert_bitwise(f"K3 anchor angle {angle:g} {wname} {fl}",
                                   (a,), (b,))
    log("proj-anchor", f"{nb}^2 box, angle 0 and 30 degrees (m01 "
                       f"{scalars[1]:.3e}): K1 (bosh3 and tsit5, adaptive and "
                       f"fixed) and K3 (all and half reset) with planes "
                       f"bitwise equal to the scalars, constant and gridded "
                       f"winds, default and generic term flags")


def seam_inputs(dev, nx: int, ny: int, halo, seed: int):
    """Displacements over the halo and 0.2 past it, the channels (E
    uniform, the momenta normal), 90% of the particles active."""
    rng = np.random.default_rng(seed)
    (xl, xh), (yl, yh) = normalize_halo(halo)

    def plane(fn, *a):
        return torch.as_tensor(fn(*a, (nx, ny)).astype(np.float32),
                               device=dev)

    xr = plane(rng.uniform, -xl - 0.2, xh + 0.2)
    yr = plane(rng.uniform, -yl - 0.2, yh + 0.2)
    chans = (plane(rng.uniform, 0.0, 1.0), plane(rng.normal, 0.0, 0.1),
             plane(rng.normal, 0.0, 0.1))
    act = torch.as_tensor(rng.uniform(size=(nx, ny)) < 0.9, device=dev)
    return xr, yr, chans, act


SEAM_HALOS = (((0, 3), (0, 3)), 3, ((2, 3), (1, 3)))


def phase_seam(dev, results):
    """K2 on the 1440 x 720 tripolar grid's shape with a TRIPOLAR_NORTH y
    axis against scatter_dense's fold, under the flagship's halo, halo 3
    and the sharded tests' seam halo ((2,3),(1,3)), displacements past the
    halo included: within rtol 1e-5 and 1e-6 of each channel's scale, two
    runs bitwise equal, the clamped count exact, E conserved.  K6 on the
    256^2 remesh state with the same seam: node planes equal to K2's and
    remesh outputs equal to K2 + K5, bit for bit."""
    nx, ny = TRI_SUPER[0] // 2, TRI_SUPER[1] // 2
    tri = GridStats(nx=nx, ny=ny, bx=Boundary.PERIODIC,
                    by=Boundary.TRIPOLAR_NORTH)
    e2 = e6 = 0.0
    for i, halo in enumerate(SEAM_HALOS):
        xr, yr, chans, act = seam_inputs(dev, nx, ny, halo, 40 + i)
        o, st = pic_gather(xr, yr, chans, act, tri, halo)
        o2, _ = pic_gather(xr, yr, chans, act, tri, halo)
        S, st_p = scatter_dense(xr, yr, torch.stack(chans, dim=-1), act, tri,
                                halo)
        torch.cuda.synchronize()
        tag = f"K2 tripolar {nx} x {ny} halo {halo}"
        assert_bitwise(f"{tag} two runs", o, o2)
        for c in range(3):
            e2 = max(e2, assert_close(f"{tag} ch{c}", o[c], S[..., c], 1e-5,
                                      1e-6 * float(S[..., c].abs().max())))
        assert int(st.clamped) == int(st_p.clamped) > 0, tag
        # the seam folds every deposit back in: E is conserved but for
        # what the open south edge drops, part of the sources' in the
        # bottom yl rows
        e_src = chans[0].double() * act
        src, dep = float(e_src.sum()), float(o[0].double().sum())
        yl = normalize_halo(halo)[1][0]
        south = float(e_src[:, :yl].sum())
        assert -1e-6 * src <= src - dep <= south + 1e-6 * src, \
            (tag, dep, src, south)
        log("K2 tripolar", f"{tag}: max abs err {e2:.3e}, clamped "
                           f"{int(st.clamped)}, bitwise repeatable, E "
                           f"deposited {dep / src:.6f} of the sources'")

    seed = 50
    for bt in ("same", "wind_sea"):
        seed += 1
        m, node, core = remesh_case(dev, 256, bt, True, seed)
        tri256 = GridStats(nx=256, ny=256, bx=Boundary.PERIODIC,
                           by=Boundary.TRIPOLAR_NORTH)
        chans = TR.particle_to_node(*core[:3])
        sact = (core[6] & core[7]).contiguous()
        for halo in SEAM_HALOS:
            nd, rm, st = pic_gather_remesh(core[3], core[4], chans, sact,
                                           tri256, halo, m.remesh_params,
                                           *core)
            k2, st2 = pic_gather(core[3], core[4], chans, sact, tri256, halo)
            k5 = remesh_cuda(m.remesh_params, k2, *core)
            S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1),
                                 sact, tri256, halo)
            tag = f"K6 tripolar 256^2 {bt} halo {halo}"
            assert_bitwise(f"{tag} vs K2 + K5", (*nd, *rm), (*k2, *k5))
            assert int(st.clamped) == int(st2.clamped), tag
            for c in range(3):
                e6 = max(e6, assert_close(
                    f"{tag} node ch{c}", nd[c], S[..., c], 1e-5,
                    1e-6 * float(S[..., c].abs().max())))
            log("K6 tripolar", f"{tag}: equal to K2 + K5 bitwise; "
                               f"{branch_counts(rm.branch)}; node planes vs "
                               f"plain max abs err {e6:.3e}")
    results["K2 tripolar"]["max_abs_err"] = e2
    results["K6 tripolar"]["max_abs_err"] = e6


def phase_tripolar_main(dev, results, timing):
    """This slice's main path: the global tripolar configuration at 1440 x
    720 through its entry points, each path with the counters set to 0
    just before and read just after: the production day (72 steps of 1200
    s through Simulation.run, K1 and K6 once a step, checkpointed at step
    36 and resumed bit for bit), the default configuration (K1, K2, K3)
    and the "pallas" remesh (K1, K2, K5), 4 steps each from the seed.
    Every path: finite, no failed lane, no energy and no particle on land;
    n_clamped reported.  Returns (grid, record, production model and its
    last state, default model and its last state)."""
    grid = tripolar_grid(dev, *TRI_SUPER)
    gw = tripolar_record(dev)
    nx, ny = grid.nx, grid.ny
    n = nx * ny
    mask = grid.mask
    log("tripolar-main", f"{nx} x {ny} T-grid ({n} nodes): ocean "
                         f"{int((mask == 1).sum())}, land "
                         f"{int((mask == 0).sum())}, land boundary "
                         f"{int((mask == 2).sum())}; record "
                         f"{tuple(gw.u_data.shape)} hourly")
    prod = tripolar_model(grid, gw, "production")
    rc = prod.resolved_config()
    assert prod.uniform_proj is None and prod._wind_B == 1
    assert rc.advance_mode == "cuda" and rc.scatter_mode == "dense_cuda"
    r = run_day_resumed(prod, "tripolar production day", steps=TRI_STEPS,
                        at=36)
    full, wall, peak = r["full"], r["wall"], r["peak"]
    size, t_save, t_load = r["size"], r["t_save"], r["t_load"]
    g, c, e = r["graphed_counts"], r["launches"], r["eager_launches"]
    m = check_tripolar("tripolar production day", prod, full.state)
    assert g["K1"] == g["K6"] == WARMUP_STEPS + 1, g
    assert e["K6"] == TRI_STEPS and e["K1"] == TRI_STEPS, e
    assert e["K2"] == e["K3"] == e["K5"] == 0, e
    launches = {"K1 proj": c["K1"], "K6 tripolar": c["K6"]}
    timing["tripolar_day_trace"] = r["trace"]
    log("counters", f"tripolar production day through Simulation.run: the "
                    f"host's calls {g}; launches by trace {c}; the day again "
                    f"eagerly, bitwise equal: launches {e}")
    timing.update(tripolar_day_wall_s=wall, tripolar_day_steps=TRI_STEPS,
                  tripolar_day_ms_per_step=wall * 1e3 / TRI_STEPS,
                  tripolar_day_pushes_per_s=n * TRI_STEPS / wall,
                  tripolar_peak_bytes=peak,
                  tripolar_checkpoint_bytes=size,
                  tripolar_n_clamped=m["n_clamped"])
    log("tripolar-main", f"production (bosh3, fused, B = 1), 1 day (graphed): "
                         f"{TRI_STEPS} steps in {wall:.3f} s wall "
                         f"({wall * 1e3 / TRI_STEPS:.3f} ms/step, "
                         f"{n * TRI_STEPS / wall:.4e} pushes/s), peak "
                         f"{peak / 2**30:.3f} GiB; checkpoint at 36 "
                         f"{size / 2**20:.1f} MiB ({t_save:.2f} s / "
                         f"{t_load:.2f} s), resumed bitwise equal; metrics "
                         f"{m}")
    states = {}
    for path in ("default", "pallas"):
        model = tripolar_model(grid, gw, path)
        reset_counters()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ms = model.init_state()
        for _ in range(4):
            ms = model.step(ms)
        end.record()
        torch.cuda.synchronize()
        ms_step = start.elapsed_time(end) / 4
        c = counters()
        mt = check_tripolar(f"tripolar {path}", model, ms)
        assert c["K1"] == c["K2"] == 4, c
        if path == "default":
            assert c["K3"] == 4 and c["K5"] == c["K6"] == 0, c
            launches["K3 proj"] = c["K3"]
        else:
            assert c["K5"] == 4 and c["K3"] == c["K6"] == 0, c
        launches["K1 proj"] += c["K1"]
        launches["K2 tripolar"] = launches.get("K2 tripolar", 0) + c["K2"]
        log("counters", f"tripolar {path} path launches {c}")
        timing[f"tripolar_{path}_ms_per_step"] = ms_step
        timing[f"tripolar_{path}_n_clamped"] = mt["n_clamped"]
        log("tripolar-main", f"{path}: {ms_step:.3f} ms/step over 4 steps "
                             f"from the seed (init included), "
                             f"{n / (ms_step / 1e3):.4e} pushes/s; metrics "
                             f"{mt}")
        states[path] = (model, ms)
    for k, v in launches.items():
        results[k]["launches"] = v
        assert v > 0, k
    return (grid, gw, prod, full.state, *states["default"])


def phase_tripolar_card_vs_cpu():
    """The 1 degree tripolar grid (720 x 360 supergrid: 360 x 180) with its
    continent and the record: the production and default models with the
    kernels on the card against the same models on the CPU, 2 steps at the
    solver tolerances CARD_VS_CPU_TOLS (the card reads the record's planes,
    the CPU its interpolant), within 5e-3 and 1e-6 of the state's scale,
    every counter equal but substeps_max (within 2)."""
    for path in ("production", "default"):
        mg, mc = (tripolar_model(tripolar_grid(d, 720, 360),
                                 tripolar_record(d), path,
                                 tols=CARD_VS_CPU_TOLS)
                  for d in ("cuda", "cpu"))
        assert mc.resolved_config().advance_mode == "torch"
        sg, sc = mg.init_state(), mc.init_state()
        for _ in range(2):
            sg, sc = mg.step(sg), mc.step(sc)
        S = sc.state
        err = assert_close(f"tripolar 1 degree card vs CPU {path}",
                           sg.state.cpu(), S, 5e-3,
                           1e-6 * float(S.abs().max()))
        mg_, mc_ = sg.metrics.as_dict(), sc.metrics.as_dict()
        smax = (mg_.pop("substeps_max"), mc_.pop("substeps_max"))
        assert mg_ == mc_ and abs(smax[0] - smax[1]) <= 2, \
            f"tripolar card vs CPU {path}: {mg_} {smax[0]} vs {mc_} {smax[1]}"
        log("tripolar-card-vs-cpu", f"{path} 360 x 180, 2 steps: max abs err "
                                    f"{err:.3e} of {float(S.abs().max()):.3e}"
                                    f", counters equal, substeps_max "
                                    f"{smax[0]} vs {smax[1]}")


def tripolar_kernel_times(grid, gw, prod, s_prod, default, s_def, results):
    """The four new entries at 1440 x 720 on the main path's own states,
    each held against its plain version and timed beside it with its bound:
    K1 with the planes (and the record's B = 1 planes) on the production
    day's last state, K3 with the planes on the default state with every
    lane reset (CUDA events: their wrappers launch nothing else), K2 with
    the seam on the default state's deposit and K6 with the seam on the
    production state's (profiler traces: their wrappers add the clamped
    count).  The bytes count the projection's 20 a particle and the ghost
    rows' sources."""
    nx, ny = grid.nx, grid.ny
    n = nx * ny
    g = grid
    P = s_prod.particles
    adv = P.on & prod.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    wf = prod.wind_fields(g, s_prod.time)
    planes = prod.projection(g)
    pw = pwl_winds(wf)
    rhs = make_rhs(pw.u, pw.v, prod.consts, prod.flags)

    def k1():
        return advance_cuda(prod.winds, prod.consts, prod.flags, prod.solver,
                            TRI_DT, comps, P.t, P.dt, adv, g.x, g.y, planes,
                            wind_fields=wf)

    def k1_plain():
        return integrate_to(rhs, torch.stack(comps, dim=-1), P.t,
                            P.t + TRI_DT, P.dt, prod.aux, adv, prod.solver)

    k, p = k1(), k1_plain()
    assert torch.equal(k.failed, p.failed), "K1 proj tripolar: failed"
    e1 = max(assert_adaptive(f"K1 proj tripolar {nm}", kz, p.z[..., i],
                             min_share=GRIDDED_SHARE,
                             loose_atol=GRIDDED_LOOSE_ATOL)
             for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                              k[:5])))
    ctl = assert_controller("K1 proj tripolar", k, p, adv)
    out = {"K1 proj": dict(ms=cuda_time_ms(k1, 10),
                           plain_ms=cuda_time_ms(k1_plain, 2),
                           **k1_bound(n, prod.solver.method, True, adv,
                                      p.naccept + p.nreject, n_wf=len(wf),
                                      proj=True))}
    log("K1 proj", f"{nx} x {ny} tripolar production state (bosh3, B = 1): "
                   f"max abs err {e1:.3e}; {ctl}")

    Q = s_def.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    wfd = default.wind_fields(g, s_def.time)
    pwd = pwl_winds(wfd)
    rhsd = make_rhs(pwd.u, pwd.v, default.consts, default.flags)
    reset = torch.ones_like(Q.on)
    sett = default.settings

    def k3():
        return auto_dt_cuda(default.winds, default.consts, default.flags,
                            Q.t, qc, g.x, g.y, default.projection(g), reset,
                            Q.dt, sett.dtmin, TRI_DT, abstol=sett.abstol,
                            reltol=sett.reltol, order=default._rk_order,
                            wind_fields=wfd)

    def k3_plain():
        return auto_dt_reset(rhsd, Q.t, torch.stack(qc, dim=-1), default.aux,
                             reset, Q.dt, sett.dtmin, TRI_DT,
                             abstol=sett.abstol, reltol=sett.reltol,
                             order=default._rk_order)

    e3 = assert_close("K3 proj tripolar default state", k3(), k3_plain(),
                      1e-5, 0.0)
    results["K3 proj"]["max_abs_err"] = max(
        results["K3 proj"].get("max_abs_err", 0.0), e3)
    out["K3 proj"] = dict(ms=cuda_time_ms(k3, 20),
                          plain_ms=cuda_time_ms(k3_plain, 5),
                          **k3_bound(reset, kernel_wind(default.winds),
                                     proj=True))

    # K2: the default configuration's deposit (halo 3, a 7-wide window)
    halo = default.config.halo
    (xl, xh), (yl, yh) = normalize_halo(halo)
    wide = ((max(xl, xh),) * 2, (max(yl, yh),) * 2)
    ghosts = nx * max(yl, yh)
    core, chans, sact = flagship_deposit_inputs(default, s_def)
    node, st = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    S, st_p = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                            g.stats, halo)
    e2 = max(assert_close(f"K2 tripolar default deposit ch{c}", node[c],
                          S[..., c], 1e-5, 1e-6 * float(S[..., c].abs().max()))
             for c in range(3))
    assert int(st.clamped) == int(st_p.clamped)
    del S
    results["K2 tripolar"]["max_abs_err"] = max(
        results["K2 tripolar"].get("max_abs_err", 0.0), e2)
    out["K2 tripolar"] = dict(
        ms=kernel_ms(lambda: pic_gather(core[3], core[4], chans, sact,
                                        g.stats, halo), "K2", 20),
        plain_ms=cuda_time_ms(lambda: scatter_dense(
            core[3], core[4], torch.stack(chans, -1), sact, g.stats, halo),
            5),
        **deposit_bound(n + ghosts, n, wide))

    # K6: the production state's deposit and remesh
    halo = prod.config.halo
    core, chans, sact = flagship_deposit_inputs(prod, s_prod)
    rp = prod.remesh_params
    prp = rp._replace(winds=pw)
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    k5 = remesh_cuda(rp, node, *core, wind_fields=wf)
    assert_remesh("K5 tripolar production", k5,
                  remesh_core(prp, node, *core))
    nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, rp, *core, wind_fields=wf)
    assert_bitwise("K6 tripolar production vs K2 + K5", (*nd, *rm),
                   (*node, *k5))

    def plain_fused():
        Sp, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                              g.stats, halo)
        return remesh_core(prp, tuple(Sp[..., c] for c in range(3)), *core)

    out["K6 tripolar"] = dict(
        ms=kernel_ms(lambda: pic_gather_remesh(
            core[3], core[4], chans, sact, g.stats, halo, rp, *core,
            wind_fields=wf), "K6", 20),
        plain_ms=cuda_time_ms(plain_fused, 5),
        **deposit_bound(n + ghosts, n, wide, remesh=True, n_wf=len(wf)))
    log("K6 tripolar", f"{nx} x {ny} production state (halo {halo}): remesh "
                       f"outputs and node planes equal to K2 + K5 bitwise "
                       f"({branch_counts(rm.branch)})")
    for key, r in out.items():
        results[key].update(r)
        log("kernel-time", f"{key}: {r['ms']:.4f} ms, plain "
                           f"{r['plain_ms']:.4f} ms, bound "
                           f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# ---------------------------------------------------------------------------
# layers: several wave systems on one grid (phase "layers")
# ---------------------------------------------------------------------------

LAYERS = 10          # tests/T06_layers.jl runs layers=10
KERNEL_LAYERS = 3    # layers of the batched kernels' checks
# the layered configurations at FLAG_N^2 and the kernel rows each runs
LAYER_CONFIGS = {"fused": ("K1", "K6"), "pallas": ("K1", "K2", "K5"),
                 "xla": ("K1", "K2"), "default": ("K1", "K2", "K3")}
LAYER_STEPS = 4
LAYER_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def swell_defaults(L: int) -> list:
    """L distinct swell systems, their energies and directions spread out
    (the seeds of tests/test_layers.py:34-43)."""
    out = []
    for k in range(L):
        ang = 2 * np.pi * k / L
        cg = 4.0 + 0.5 * k
        out.append(W2D.ParticleDefaults2D(lne=float(np.log(0.002 * (k + 1))),
                                          cg_x=float(cg * np.cos(ang)),
                                          cg_y=float(cg * np.sin(ang))))
    return out


def layer_config_model(name: str, n: int, dev, layers: int = 1):
    """The flagship under the remesh ``name`` ("fused", "pallas", "xla") or
    the default configuration ("default"), ``layers`` wave systems.  The
    halo is a symmetric 3: swell systems travel every way, and the
    flagship's directional halo would clamp them."""
    if name == "default":
        return default_model(n, dev, layers=layers)
    return flagship_model(n, dev, remesh_mode=name, layers=layers, halo=3)


def stacked(parts) -> torch.Tensor:
    """Per-layer planes as one contiguous ``[L, ...]`` tensor."""
    return torch.stack(list(parts)).contiguous()


def flat(out) -> list:
    """A wrapper's outputs (tensors, tuples of them, named tuples) as one
    list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def layered_launch(tag: str, wrapper, batched, single, L: int):
    """``batched()`` (one launch of ``wrapper``'s kernel over L layers)
    against ``single(k)`` for each layer k (its own launch of the same
    kernel): every output, layer by layer, bit for bit.  Returns the
    batched outputs."""
    before = wrapper.launches
    out = batched()
    assert wrapper.launches == before + 1, \
        f"{tag}: {wrapper.launches - before} launches for {L} layers"
    singles = [single(k) for k in range(L)]
    torch.cuda.synchronize()
    got = flat(out)
    for k, s in enumerate(singles):
        want = flat(s)
        assert len(got) == len(want), tag
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(bits(a[k]), bits(b)):
                raise AssertionError(
                    f"{tag}: output {i} of layer {k} differs from its "
                    f"single-layer launch on "
                    f"{int((bits(a[k]) != bits(b)).sum())} of {b.numel()}")
    log("layer-kernels", f"{tag}: one launch for {L} layers, each layer bit "
                         f"for bit its own launch")
    return out


def layer_kernel_checks(dev, n: int = 256, L: int = KERNEL_LAYERS) -> dict:
    """Each kernel's layered launch against L single-layer launches of the
    same kernel on n^2 grids, bit for bit, in every instance: K1 (bosh3 and
    tsit5, adaptive) and K3 (half the lanes reset) with constant and
    time-cosine winds, gridded winds of B = 1 and B = 3 and per-node
    projection planes (the spherical and tripolar grids); K2 on periodic,
    open and tripolar grids; K4 at three halos; K5 and K6 with their
    half-domain and gridded winds under two boundary types, K6 on the
    tripolar seam too.  The constant instances are held against their plain
    versions over the layered inputs as the single-layer checks hold them
    (K1 in fixed-substep mode within rtol 1e-5); returns each kernel's max
    abs error against its plain version."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    t0 = 1500.0
    clock = torch.tensor(t0, device=dev)
    err = dict.fromkeys(LAYER_KERNELS, 0.0)

    def layered_state(seed, grid=None):
        st = [perturbed_state(n, dev, seed=seed + k, grid=grid)
              for k in range(L)]
        comps = tuple(stacked(s[0][i] for s in st) for i in range(5))
        return (comps, stacked(s[1] for s in st), stacked(s[2] for s in st),
                st[0][3])

    comps, dt0, active, grid = layered_state(60)
    proj = (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
            float(grid.proj[0, 0, 1, 1]), 0.0)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    t = torch.full_like(dt0, t0)
    reset = half_reset_mask((L, n, n), dev, seed=61)
    instances = [("constant", constant_winds(10.0, 10.0), ()),
                 ("time-cosine", time_cosine_winds(10.0, 5.0, 6 * 3600.0),
                  ())]
    for cadence in (900.0, 200.0):
        kw, wf, _ = kernel_winds(window_record(n, dev, cadence), grid, clock)
        instances.append((f"gridded B={kw.kernel.n_break}", kw, wf))
    cases = [(wname, w, wf, comps, dt0, active, grid, proj)
             for wname, w, wf in instances]
    for kind, g in curved_grids(n, dev).items():
        cs, dts, acts, _ = layered_state(62, grid=g)
        cases.append((f"{kind} projection planes", constant_winds(10.0, 10.0),
                      (), cs, dts, acts, g, node_projection(g.proj, g.pc)))
    for wname, w, wf, cs, dts, acts, g, pj in cases:
        tt = torch.full_like(dts, t0)
        for method in ("bosh3", "tsit5"):
            cfg = SolverConfig(method=method, adaptive=True, dtmin=1e-4,
                               force_dtmin=True)
            layered_launch(
                f"K1 {wname} {method}", advance_cuda,
                lambda: advance_cuda(w, consts, flags, cfg, DT, cs, tt, dts,
                                     acts, g.x, g.y, pj, wind_fields=wf),
                lambda k: advance_cuda(w, consts, flags, cfg, DT,
                                       tuple(c[k] for c in cs), tt[k],
                                       dts[k], acts[k], g.x, g.y, pj,
                                       wind_fields=wf), L)
        layered_launch(
            f"K3 {wname}", auto_dt_cuda,
            lambda: auto_dt_cuda(w, consts, flags, tt, cs, g.x, g.y, pj,
                                 reset, dts, 1e-4, DT, wind_fields=wf),
            lambda k: auto_dt_cuda(w, consts, flags, tt[k],
                                   tuple(c[k] for c in cs), g.x, g.y, pj,
                                   reset[k], dts[k], 1e-4, DT,
                                   wind_fields=wf), L)

    # the constant instances against their plain versions, layered
    winds = constant_winds(10.0, 10.0)
    rhs = make_rhs(winds.u, winds.v, consts, flags)
    cfg = SolverConfig(method="tsit5", adaptive=False)
    dtf = torch.full_like(dt0, 37.5)
    k = advance_cuda(winds, consts, flags, cfg, DT, comps, t, dtf, active,
                     grid.x, grid.y, proj)
    p = integrate_to(rhs, torch.stack(comps, dim=-1), t, t + DT, dtf, aux,
                     active, cfg)
    err["K1"] = max(assert_close(f"K1 layered fixed {nm}", kz, p.z[..., i],
                                 1e-5, 1e-6)
                    for i, (nm, kz) in enumerate(zip(
                        ("lne", "cgx", "cgy", "x", "y"), k[:5])))
    assert torch.equal(k.naccept, p.naccept), "K1 layered: naccept"
    k = auto_dt_cuda(winds, consts, flags, t, comps, grid.x, grid.y, proj,
                     reset, dt0, 1e-4, DT)
    p = auto_dt_reset(rhs, t, torch.stack(comps, dim=-1), aux, reset, dt0,
                      1e-4, DT)
    err["K3"] = assert_close("K3 layered", k, p, 1e-5, 0.0)

    # the deposits
    def layered_sources(halo, seed, nx=n, ny=n):
        src = [seam_inputs(dev, nx, ny, halo, seed + k) for k in range(L)]
        return (stacked(s[0] for s in src), stacked(s[1] for s in src),
                tuple(stacked(s[2][c] for s in src) for c in range(3)),
                stacked(s[3] for s in src))

    P_, O_, T_ = Boundary.PERIODIC, Boundary.NONPERIODIC, \
        Boundary.TRIPOLAR_NORTH
    for bx, by, halo in ((P_, P_, ((0, 3), (0, 3))), (P_, P_, 3),
                         (O_, O_, ((1, 2), (2, 1))),
                         *((P_, T_, h) for h in SEAM_HALOS)):
        stats = GridStats(nx=n, ny=n, bx=bx, by=by)
        xr, yr, ch, act = layered_sources(halo, 70)
        tag = f"K2 {bx.name.lower()}/{by.name.lower()} halo {halo}"
        nodes, st = layered_launch(
            tag, pic_gather,
            lambda: pic_gather(xr, yr, ch, act, stats, halo),
            lambda k: pic_gather(xr[k], yr[k], tuple(c[k] for c in ch),
                                 act[k], stats, halo), L)
        S, st_p = scatter_dense(xr, yr, torch.stack(ch, dim=-1), act, stats,
                                halo)
        for c in range(3):
            err["K2"] = max(err["K2"], assert_close(
                f"{tag} ch{c}", nodes[c], S[..., c], 1e-5,
                1e-6 * float(S[..., c].abs().max())))
        assert torch.equal(st.clamped, st_p.clamped), f"{tag}: clamped"
    for halo in (3, ((0, 3), (0, 3)), ((1, 3), (0, 2))):
        xr, yr, ch, act = layered_sources(halo, 80)

        def k4(x, y, c, a):
            out, st = pic_gather_padded(x, y, c, a, halo)
            return tuple(out.unbind(0)), st

        (o, st) = layered_launch(
            f"K4 halo {halo}", pic_gather_padded, lambda: k4(xr, yr, ch, act),
            lambda k: k4(xr[k], yr[k], tuple(c[k] for c in ch), act[k]), L)
        P, st_p = scatter_accumulate_padded(xr, yr, torch.stack(ch, dim=-1),
                                            act, halo)
        for c in range(3):
            scale = float(P[..., c].abs().max())
            err["K4"] = max(err["K4"], assert_close(
                f"K4 layered halo {halo} ch{c}", o[c], P[..., c], 1e-5,
                1e-6 * scale) / scale)
        assert torch.equal(st.clamped, st_p.clamped), f"K4 halo {halo}"

    # the remesh, alone (K5) and in the deposit (K6)
    tri = GridStats(nx=n, ny=n, bx=P_, by=T_)
    for bt in ("wind_sea", "same"):
        cs = [remesh_case(dev, n, bt, True, seed=90 + k) for k in range(L)]
        m = cs[0][0]
        node = tuple(stacked(c[1][i] for c in cs) for i in range(3))
        lanes = tuple(stacked(c[2][i] for c in cs) for i in range(7))
        core = (*lanes, *cs[0][2][7:-1], clock)
        kw, wf, pw = kernel_winds(window_record(n, dev, 900.0), m.grid, clock)
        for wname, rp, wfl in (("half-domain", m.remesh_params, ()),
                               ("gridded B=1",
                                m.remesh_params._replace(winds=kw), wf)):
            def single_core(k):
                return (*(x[k] for x in lanes), *core[7:])

            tag = f"{bt} {wname}"
            k5 = layered_launch(
                f"K5 {tag}", remesh_cuda,
                lambda: remesh_cuda(rp, node, *core, wind_fields=wfl),
                lambda k: remesh_cuda(rp, tuple(x[k] for x in node),
                                      *single_core(k), wind_fields=wfl), L)
            plain_rp = rp if not wfl else rp._replace(winds=pw)
            err["K5"] = max(err["K5"], assert_remesh(
                f"K5 layered {tag}", k5, remesh_core(plain_rp, node, *core)))
            chans = TR.particle_to_node(*lanes[:3])
            sact = (lanes[6] & core[7]).contiguous()
            for stats, halo in ((m.grid.stats, ((1, 3), (0, 2))),
                                (tri, SEAM_HALOS[2])):
                if stats is tri and wfl:
                    continue
                ttag = f"K6 {tag} {'tripolar ' if stats is tri else ''}" \
                       f"halo {halo}"
                nd, rm, st = layered_launch(
                    ttag, pic_gather_remesh,
                    lambda: pic_gather_remesh(lanes[3], lanes[4], chans, sact,
                                              stats, halo, rp, *core,
                                              wind_fields=wfl),
                    lambda k: pic_gather_remesh(
                        lanes[3][k], lanes[4][k],
                        tuple(c[k] for c in chans), sact[k], stats, halo, rp,
                        *single_core(k), wind_fields=wfl), L)
                S, _ = scatter_dense(lanes[3], lanes[4],
                                     torch.stack(chans, -1), sact, stats,
                                     halo)
                for c in range(3):
                    err["K6"] = max(err["K6"], assert_close(
                        f"{ttag} node ch{c}", nd[c], S[..., c], 1e-5,
                        1e-6 * float(S[..., c].abs().max())))
                plain = remesh_core(plain_rp, tuple(S[..., c]
                                                    for c in range(3)), *core)
                assert torch.equal(rm.branch, plain.branch), f"{ttag}: bits"
    return err


def phase_layer_kernels(dev, results):
    """``layer_kernel_checks`` at 256^2 over KERNEL_LAYERS layers: each
    layered kernel bit for bit its single-layer launches, in every
    instance; the layered rows' errors against their plain versions."""
    err = layer_kernel_checks(dev)
    for k, e in err.items():
        results[f"{k} layered"]["max_abs_err"] = e
    log("layer-kernels", f"against the plain versions, layered: max abs err "
                         f"{err}")


def layered_kernel_times(states, results, timing):
    """Each layered kernel on the full-width layered states of phase
    "layers" (FLAG_N^2, LAYERS layers): bit for bit its LAYERS single-layer
    launches, held against its plain version on the same layered inputs
    (the rules of the single-layer rows at this width: K1 adaptive by share
    of lanes, K3 within rtol 1e-5, the deposits' node planes within rtol
    1e-5 of ``scatter_dense`` / ``scatter_accumulate_padded``, K5 and K6's
    remesh by ``assert_remesh``), and timed against the single launches
    (``kernel_ms``, the launches of one call summed), beside the plain
    version's time and the bound of its bytes (the node-shared planes read
    once a node) and operations.  K1 on the flagship ("xla") and the
    default states, K2 on the flagship's deposit, K3 on the default state
    with every lane reset, K4 (padded) and K5 on the "pallas" flagship's,
    K6 on the fused one's."""
    L, N = LAYERS, FLAG_N * FLAG_N
    out = {}

    def record(key, tag, batched, single, plain, b, check, ref=None,
               reps=10, row=True):
        wrapper = KERNEL_FNS[key]
        got = layered_launch(f"{key} {tag} at {FLAG_N}^2", wrapper, batched,
                             single, L)
        err = check(f"{key} layered {tag}", got,
                    plain() if ref is None else ref)
        del got, ref
        ms = kernel_ms(batched, key, reps, row=f"{key} layered")
        singles_ms = kernel_ms(lambda: [single(k) for k in range(L)], key,
                               reps, per_call=L, row=f"{key} layered")
        plain_ms = cuda_time_ms(plain, 1)
        out[f"{key} {tag}"] = dict(ms=ms, singles_ms=singles_ms,
                                   plain_ms=plain_ms, max_abs_err=err, **b)
        if row:
            r = results[f"{key} layered"]
            r.update(ms=ms, singles_ms=singles_ms, plain_ms=plain_ms, **b)
            r["max_abs_err"] = max(r["max_abs_err"], err)
        log("kernel-time", f"{key} layered ({tag}, L = {L}): against the "
                           f"plain version max abs err {err:.3e}; {ms:.4f} "
                           f"ms, {L} single launches {singles_ms:.4f} ms, "
                           f"plain {plain_ms:.4f} ms, bound "
                           f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
                           f"{b['bound_ms'] / ms:.0%} of it")

    def check_k1(tag, k, p):
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        err = max(assert_adaptive(f"{tag} {nm}", kz, p.z[..., i])
                  for i, (nm, kz) in enumerate(zip(
                      ("lne", "cgx", "cgy", "x", "y"), k[:5])))
        share = float((k.naccept == p.naccept).double().mean())
        assert share >= 0.95, f"{tag}: naccept equal on {share:.4%}"
        log("layer-kernels", f"{tag}: naccept equal on {share:.4%} of "
                             f"{k.naccept.numel()} lanes")
        return err

    def check_nodes(tag, nodes, S, relative=False):
        e = 0.0
        for c in range(3):
            scale = float(S[..., c].abs().max())
            e = max(e, assert_close(f"{tag} ch{c}", nodes[c], S[..., c],
                                    1e-5, 1e-6 * scale)
                    / (scale if relative else 1.0))
        return e

    def check_deposit(tag, got, ref, relative=False):
        (nodes, st), (S, st_p) = got, ref
        assert torch.equal(st.clamped, st_p.clamped), f"{tag}: clamped"
        return check_nodes(tag, nodes, S, relative)

    for name in ("xla", "default"):
        model, ms = states[name]
        P = ms.particles
        adv = P.on & model.active_mask
        comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
        g = model.grid
        args = (model.winds, model.consts, model.flags, model.solver, DT)

        def k1_plain():
            return integrate_to(model.rhs, torch.stack(comps, dim=-1), P.t,
                                P.t + DT, P.dt, model.aux, adv, model.solver)

        p = k1_plain()
        record("K1", "flagship state" if name == "xla" else "default state",
               lambda: advance_cuda(*args, comps, P.t, P.dt, adv, g.x, g.y,
                                    model.uniform_proj),
               lambda k: advance_cuda(*args, tuple(c[k] for c in comps),
                                      P.t[k], P.dt[k], adv[k], g.x, g.y,
                                      model.uniform_proj),
               k1_plain,
               k1_bound(L * N, model.solver.method, True, adv,
                        p.naccept + p.nreject, layers=L),
               check_k1, ref=p, reps=10 if name == "xla" else 3,
               row=name == "xla")
        del p
        if name == "default":
            every = torch.ones_like(adv)
            args3 = (model.winds, model.consts, model.flags)
            tols = dict(abstol=model.settings.abstol,
                        reltol=model.settings.reltol, order=5.0)
            record("K3", "every lane reset",
                   lambda: auto_dt_cuda(*args3, P.t, comps, g.x, g.y,
                                        model.uniform_proj, every, P.dt,
                                        1e-4, DT, **tols),
                   lambda k: auto_dt_cuda(*args3, P.t[k],
                                          tuple(c[k] for c in comps), g.x,
                                          g.y, model.uniform_proj, every[k],
                                          P.dt[k], 1e-4, DT, **tols),
                   lambda: auto_dt_reset(model.rhs, P.t,
                                         torch.stack(comps, dim=-1),
                                         model.aux, every, P.dt, 1e-4, DT,
                                         **tols),
                   k3_bound(every, kernel_wind(model.winds), layers=L),
                   lambda tag, k, p: assert_close(tag, k, p, 1e-5, 0.0))
    for name, key in (("xla", "K2"), ("pallas", "K4"), ("pallas", "K5"),
                      ("fused", "K6")):
        model, ms = states[name]
        core, chans, sact = flagship_deposit_inputs(model, ms)
        g, halo, rp = model.grid, model.config.halo, model.remesh_params
        xr, yr = core[3], core[4]

        def single_core(k):
            return (*(x[k] for x in core[:7]), *core[7:])

        def one(k):
            return xr[k], yr[k], tuple(c[k] for c in chans), sact[k]

        dense = torch.stack(chans, dim=-1)
        if key == "K2":
            record("K2", "flagship deposit",
                   lambda: pic_gather(xr, yr, chans, sact, g.stats, halo),
                   lambda k: pic_gather(*one(k), g.stats, halo),
                   lambda: scatter_dense(xr, yr, dense, sact, g.stats, halo),
                   deposit_bound(L * N, L * N, halo, layers=L),
                   check_deposit)
        elif key == "K4":
            (xl, xh), (yl, yh) = normalize_halo(halo)

            def k4(*a):
                o, st = pic_gather_padded(*a, halo)
                return tuple(o.unbind(0)), st

            record("K4", "flagship deposit", lambda: k4(xr, yr, chans, sact),
                   lambda k: k4(*one(k)),
                   lambda: scatter_accumulate_padded(xr, yr, dense, sact,
                                                     halo),
                   deposit_bound(L * N, L * (FLAG_N + xl + xh)
                                 * (FLAG_N + yl + yh), halo, layers=L),
                   lambda tag, got, ref: check_deposit(tag, got, ref, True))
        elif key == "K5":
            node, _ = pic_gather(xr, yr, chans, sact, g.stats, halo)
            record("K5", "flagship deposit",
                   lambda: remesh_cuda(rp, node, *core),
                   lambda k: remesh_cuda(rp, tuple(x[k] for x in node),
                                         *single_core(k)),
                   lambda: remesh_core(rp, node, *core),
                   remesh_bound(L * N, layers=L), assert_remesh)
        else:
            def plain_fused():
                S, _ = scatter_dense(xr, yr, dense, sact, g.stats, halo)
                return S, remesh_core(rp, tuple(S[..., c] for c in range(3)),
                                      *core)

            def check_k6(tag, got, ref):
                (nodes, rm, _), (S, plain) = got, ref
                e = check_nodes(f"{tag} node", nodes, S)
                # the remesh half on the kernel's own node sums; on the
                # plain ones the branches
                assert torch.equal(rm.branch, plain.branch), \
                    f"{tag}: branch differs from the plain version's"
                return max(e, assert_remesh(f"{tag} remesh", rm,
                                            remesh_core(rp, nodes, *core)))

            record("K6", "flagship", lambda: pic_gather_remesh(
                xr, yr, chans, sact, g.stats, halo, rp, *core),
                lambda k: pic_gather_remesh(*one(k), g.stats, halo, rp,
                                            *single_core(k)),
                plain_fused,
                deposit_bound(L * N, L * N, halo, remesh=True, layers=L),
                check_k6)
    timing["layered_kernels"] = out


def phase_layers(dev, gw, results, timing):
    """This slice's main path, layered: the flagship box at FLAG_N^2 (halo
    3, ``layer_config_model``) with LAYERS swell systems
    (``swell_defaults``) through
    ``LayeredWaveGrowth2D``, under each remesh backend and the default
    configuration (LAYER_CONFIGS).  Per configuration: each layer's seed
    bit for bit the single-layer model's ``init_state(defaults=d_k)``;
    LAYER_STEPS eager layered steps with the counters set to 0 just before
    and read just after (each kernel of the configuration launched once a
    step, not once a layer); each layer bit for bit LAYER_STEPS steps of
    the single-layer model; ``step_n_quiet`` over 1 and LAYER_STEPS steps
    (a replayed CUDA graph) bit for bit the eager steps; a trace of 5 bare
    replays counting each kernel once a replay; then ms/step graphed and
    eager at LAYERS layers against the single-layer model's, in turns
    (CUDA events), host enqueue, device ops, eager peak memory and the
    capture's memory.  Then per-layer winds (3 layers: constant (10, 10),
    constant (-8, 4) and the gridded record), each layer bit for bit its
    own model's steps, replays too; a layered day (the fused flagship, 4
    layers, 145 steps through Simulation.run, resumed from a step-72
    checkpoint bit for bit, counted by a trace, and eagerly); a 256^2 day
    of LAYERS layers with a CashStore whose [time, layer, x, y, state]
    frames are the eager steps bit for bit.  Returns the layered states
    the kernel timings use."""
    n, L = FLAG_N, LAYERS
    d = swell_defaults(L)
    out, states = {}, {}
    for name, rows in LAYER_CONFIGS.items():
        lay = layer_config_model(name, n, dev, L).as_layered(d)
        one = layer_config_model(name, n, dev)
        assert isinstance(lay, W2D.LayeredWaveGrowth2D) and lay.graphed, name
        ms0 = lay.init_state()
        for k in range(L):
            assert_state_bitwise(f"layers {name}: layer {k}'s seed",
                                 W2D.layer_of(ms0, k),
                                 one.init_state(defaults=d[k]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        reset_counters()
        eager = [ms0]
        for _ in range(LAYER_STEPS):
            eager.append(lay.step(eager[-1]))
        c = counters()
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - m0
        want = {k: LAYER_STEPS if k in rows else 0 for k in KERNEL_FNS}
        assert c == want, f"layers {name}: launches {c}, want {want}"
        for k in rows:
            results[f"{k} layered"]["launches"] += c[k]
        last = eager[-1]
        assert bool(torch.isfinite(last.state).all()), name
        assert last.metrics.n_failed.tolist() == [0] * L, name
        assert last.metrics.n_clamped.tolist() == [0] * L, name
        for k in range(L):
            s = one.init_state(defaults=d[k])
            for _ in range(LAYER_STEPS):
                s = one.step(s)
            assert_state_bitwise(f"layers {name}: layer {k} against "
                                 f"{LAYER_STEPS} single-layer steps",
                                 W2D.layer_of(last, k), s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        g = lay._capture(ms0)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() - m0
        pool = torch.cuda.memory_reserved() - r0
        for steps in (1, LAYER_STEPS):
            assert_state_bitwise(f"layers {name}: step_n_quiet({steps})",
                                 lay.step_n_quiet(ms0, steps), eager[steps])
        assert lay._graph is g, f"layers {name}: captured more than once"

        def replays():
            for _ in range(5):
                g.graph.replay()

        stats, got = trace_window(replays, 5,
                                  {KERNEL_KEYS[k]: 5 for k in rows}, 6)
        for k in rows:
            results[f"{k} layered"]["graph_launches"] = \
                results[f"{k} layered"].get("graph_launches", 0) \
                + got[KERNEL_KEYS[k]]
        del eager
        # the eager layered step's trace (busy time, idle share)
        eager_stats, _ = trace_window(lambda: eager_steps(lay, last, 5), 5,
                                      {KERNEL_KEYS[k]: 5 for k in rows}, 6)
        turns = {w: [] for w in ("layered graphed", "layered eager",
                                 "single graphed", "single eager")}
        # the single-layer model captured before the turns, as the layered
        # one is
        st = {"layered": last,
              "single": one.step_n_quiet(one.init_state(), 1)}
        for rep in range(TURNS[0]):
            for who in (list(turns) if rep % 2 == 0 else
                        list(reversed(turns))):
                kind, mode = who.split()
                model = lay if kind == "layered" else one
                st[kind], t = time_steps(model, st[kind], TURNS[1],
                                         eager=mode == "eager")
                turns[who].append(t)
        med = {w: float(np.median(v)) for w, v in turns.items()}
        enq = {mode: host_enqueue_ms(lambda: drive(lay, st["layered"],
                                                   TURNS[1], mode == "eager"),
                                     TURNS[1])[0]
               for mode in ("eager", "graphed")}
        ops, _ = device_ops_per_step(lay, st["layered"], 3)
        ops1, _ = device_ops_per_step(one, st["single"], 3)
        out[name] = dict(
            ms_per_step=turns, median=med, host_enqueue_ms_per_step=enq,
            pushes_per_s={w: (L if w.startswith("layered") else 1) * n * n
                          / (v / 1e3) for w, v in med.items()},
            eager_device_ops_per_step=ops, single_eager_device_ops=ops1,
            capture_s=capture_s, capture_held_bytes=held,
            capture_reserved_bytes=pool, eager_peak_bytes=eager_peak,
            replay_trace=stats, eager_trace=eager_stats)
        log("layers", f"{name}: {L} layers, seeds and {LAYER_STEPS} eager "
                      f"steps each layer bit for bit its single-layer "
                      f"model's; launches {c} (once a step); replays "
                      f"(step_n_quiet 1/{LAYER_STEPS}) bitwise equal to the "
                      f"eager steps; trace of 5 replays: {got}, "
                      f"{stats['device_ops_per_step']:.1f} device ops a "
                      f"replay, busy {stats['device_busy_ms_per_step']:.4f} "
                      f"ms, idle share {stats['idle_share']:.4f}; eager "
                      f"trace busy "
                      f"{eager_stats['device_busy_ms_per_step']:.4f} ms a "
                      f"step, idle share {eager_stats['idle_share']:.4f}")
        log("layers", f"{name}: ms/step median (7 x 10 in turns): "
                      + ", ".join(f"{w} {v:.4f}" for w, v in med.items())
                      + f"; pushes/s layered graphed "
                      f"{out[name]['pushes_per_s']['layered graphed']:.4e}, "
                      f"single graphed "
                      f"{out[name]['pushes_per_s']['single graphed']:.4e}; "
                      f"host enqueue a layered step eager {enq['eager']:.4f} "
                      f"graphed {enq['graphed']:.4f} ms; eager device ops a "
                      f"step {ops:.1f} layered, {ops1:.1f} single; eager "
                      f"peak {eager_peak / 2**20:.1f} MiB; capture "
                      f"{capture_s:.3f} s, holds {held / 2**20:.1f} MiB, "
                      f"reserved {pool / 2**20:.1f} MiB more")
        lay.release_graph()
        one.release_graph()
        states[name] = (lay.model, st["layered"])
        del g, st, lay, one, ms0
        torch.cuda.empty_cache()

    # per-layer winds: one model a layer
    winds = [constant_winds(10.0, 10.0), constant_winds(-8.0, 4.0), gw]
    base = flagship_model(n, dev, halo=3, remesh_mode="fused", layers=3)
    lay = base.as_layered(per_layer_winds=winds)
    assert lay.graphed
    ms0 = lay.init_state()
    reset_counters()
    eager = [ms0]
    for _ in range(LAYER_STEPS):
        eager.append(lay.step(eager[-1]))
    c = counters()
    assert c["K1"] == c["K6"] == 3 * LAYER_STEPS, c
    for k, w in enumerate(winds):
        m = flagship_model(n, dev, halo=3, remesh_mode="fused", winds=w)
        s = m.init_state()
        for _ in range(LAYER_STEPS):
            s = m.step(s)
        assert_state_bitwise(f"per-layer winds: layer {k}",
                             W2D.layer_of(eager[-1], k), s)
    assert_state_bitwise("per-layer winds: replays",
                         lay.step_n_quiet(ms0, LAYER_STEPS), eager[-1])
    e = eager[-1].state[..., 0]
    assert not torch.equal(e[0], e[1]) and not torch.equal(e[1], e[2])
    log("layers", f"per-layer winds (3 layers: constant (10, 10), constant "
                  f"(-8, 4), the gridded record): {LAYER_STEPS} eager steps, "
                  f"launches {c} (once a layer a step); each layer bit for "
                  f"bit its own model's steps; replays bitwise equal")
    lay.release_graph()
    del lay, eager, ms0
    torch.cuda.empty_cache()

    # a layered day through Simulation.run, resumed from a checkpoint
    lay4 = layer_config_model("fused", n, dev, 4).as_layered(
        swell_defaults(4))
    r = run_day_resumed(lay4, "layered day (4 layers)")
    full = r["full"]
    assert full.state.metrics.n_failed.tolist() == [0] * 4
    c, e = r["launches"], r["eager_launches"]
    assert c == {"K1": 145, "K2": 0, "K3": 0, "K5": 0, "K6": 145}, c
    # the eager day is the witness of the replays, its launches not the
    # path's: they must equal the trace's
    assert {k: e[k] for k in c} == c and e["K4"] == 0, e
    for k in ("K1", "K6"):
        results[f"{k} layered"]["launches"] += c[k]
    out["day_4_layers"] = dict(wall_s=r["wall"], peak_bytes=r["peak"],
                               checkpoint_bytes=r["size"],
                               trace=r["trace"], counters=r["day"])
    log("layers", f"layered day, 4 layers at {n}^2 (fused): 145 steps in "
                  f"{r['wall']:.3f} s through Simulation.run (graphed), "
                  f"{4 * n * n * 145 / r['wall']:.4e} pushes/s; resumed "
                  f"from step 72 ({r['size'] / 2**20:.1f} MiB) bit for bit; "
                  f"launches by trace {r['launches']}; the day again "
                  f"eagerly, bitwise equal, launches {r['eager_launches']}; "
                  f"counters summed {r['day']}")
    lay4.release_graph()
    del lay4, r, full
    torch.cuda.empty_cache()

    small = 256
    lay = layer_config_model("fused", small, dev, L).as_layered(d)
    stored = Simulation.create(lay, stop_time=DAY)
    t0 = time.perf_counter()
    stored.run(cash_store=True)
    t_stored = time.perf_counter() - t0
    frames = stored.store.as_array()
    assert frames.shape == (146, L, small, small, 3), frames.shape
    ms = lay.init_state()
    assert np.array_equal(frames[0], ms.state.cpu().numpy())
    for i in range(1, 146):
        ms = lay.step(ms)
        assert np.array_equal(frames[i], ms.state.cpu().numpy()), \
            f"stored layered day: frame {i} differs from the eager step"
    out["stored_256_layers_wall_s"] = t_stored
    log("layers", f"{small}^2, {L} layers, 1 day with a CashStore: "
                  f"{frames.shape} frames ([time, layer, x, y, state]) in "
                  f"{t_stored:.3f} s, each bit for bit the eager step's")
    lay.release_graph()
    timing["layers"] = out
    return states


def phase_sharded_layers(dev, gw, results, timing) -> None:
    """Inside phase "sharded-1x1"'s process group (one NCCL rank): the
    "pallas" flagship at FLAG_N^2 with 4 swell layers through
    ``ShardedWaveGrowth2D`` (K1, the layered K4, the self-wrap fold, K5,
    each launched once a step) for 3 steps, with the flagship's halo
    ((0,3),(0,3)) and with halo 3: every layer bit for bit the same layer
    through the sharded single-layer model (the layered K4 and exchange),
    and against the single-device layered step at ``assert_states``'
    bound; then the gridded "pallas" configuration (halo 3) through the
    same (1, 1) mesh against the single-device step alike.  Whether each
    equals the single-device step bit for bit is logged and recorded: K4
    and the fold add a wrapped node's own-block and wrapped terms apart,
    where K2 adds them per dy, so with sources wrapping in from both sides
    the sums can part by an ulp.  The witness of that cause: the gridded
    and the layered configurations with the plain deposit on both sides
    (one sum order), where the sharded step is the single-device step bit
    for bit."""
    n, L = FLAG_N, 4
    d = swell_defaults(L)
    out = {}
    for tag, halo in (("flagship halo", ((0, 3), (0, 3))), ("halo 3", 3)):
        model = flagship_model(n, dev, remesh_mode="pallas", layers=L,
                               halo=halo)
        one = flagship_model(n, dev, remesh_mode="pallas", halo=halo)
        ms0 = model.init_state_layers(d)
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        sh1 = ShardedWaveGrowth2D(one, make_mesh((1, 1)))
        assert sh.layers == L
        reset_counters()
        ms = sh.shard_state(ms0)
        for _ in range(3):
            ms = sh.step(ms)
        c = counters()
        assert c["K1"] == c["K4"] == c["K5"] == 3 and c["K2"] == 0, c
        results["K4 layered"]["launches"] += c["K4"]
        for k in range(L):
            s = sh1.shard_state(one.init_state(defaults=d[k]))
            for _ in range(3):
                s = sh1.step(s)
            assert_state_bitwise(f"sharded layers, {tag}: layer {k} against "
                                 f"the single-layer sharded steps",
                                 W2D.layer_of(ms, k), s)
        ref = ms0
        for _ in range(3):
            ref = model.step_layers(ref)
        err = assert_states(f"sharded layers, {tag}, vs single device", ms,
                            ref)
        same = all(torch.equal(bits(a), bits(b)) for a, b in
                   zip(ms.leaves(), ref.leaves()))
        out[tag] = dict(max_abs_err=err, bitwise=same,
                        n_clamped=ms.metrics.n_clamped.tolist())
        log("sharded-1x1", f"{L} layers at {n}^2, {tag}: launches {c} (once "
                           f"a step); each layer bit for bit its single-layer "
                           f"sharded steps; against the single-device "
                           f"layered step max abs err {err:.3e}, bit for "
                           f"bit: {same}; n_clamped {out[tag]['n_clamped']}")
        del model, one, ms0, sh, sh1, ms, ref
    gm = gridded_model(n, dev, gw, "pallas")
    shg = ShardedWaveGrowth2D(gm, make_mesh((1, 1)))
    a, b = shg.init_state(), gm.init_state()
    for _ in range(3):
        a, b = shg.step(a), gm.step(b)
    err = assert_states("sharded gridded vs single device", a, b)
    same = all(torch.equal(bits(x), bits(y)) for x, y in
               zip(a.leaves(), b.leaves()))
    check_state("sharded gridded", a, n_failed=0)
    out["gridded"] = dict(max_abs_err=err, bitwise=same)
    log("sharded-1x1", f"gridded pallas at {n}^2 (halo 3), 3 steps: against "
                       f"the single-device step max abs err {err:.3e}, bit "
                       f"for bit: {same}")
    del gm, shg, a, b
    # the witness of the cause: with the plain deposit on both sides
    # (scatter_mode="dense": the padded accumulate, then the x and y folds,
    # in one order) the sharded step is the single-device step bit for bit,
    # so the block-local planes (the gridded winds' too) are right and the
    # deposit's sum order is all that parts the kernel runs
    for tag, m in (("gridded", flagship_model(n, dev, halo=3, winds=gw,
                                              remesh_mode="pallas",
                                              scatter_mode="dense")),
                   (f"{L} layers", flagship_model(n, dev, halo=3, layers=L,
                                                  remesh_mode="pallas",
                                                  scatter_mode="dense"))):
        sh = ShardedWaveGrowth2D(m, make_mesh((1, 1)))
        b = m.init_state_layers(d) if m.config.layers > 1 else m.init_state()
        a = sh.shard_state(b)
        reset_counters()
        for _ in range(3):
            a, b = sh.step(a), m.step(b)
        c = counters()
        assert c["K1"] == 6 and c["K5"] == 6 and c["K2"] == c["K4"] == 0, c
        assert_state_bitwise(f"sharded {tag}, plain deposit, against the "
                             f"single-device step", a, b)
        log("sharded-1x1", f"{tag} pallas at {n}^2 (halo 3), the plain "
                           f"deposit on both sides (scatter_mode=\"dense\"), "
                           f"3 steps: the sharded step bit for bit the "
                           f"single-device step; launches {c}")
        out[f"{tag} plain deposit"] = dict(bitwise=True)
        del m, sh, a, b
    timing["sharded_1x1_layers"] = out


# ---------------------------------------------------------------------------
# the 1D growth model (no kernel: plain PyTorch on the card)
# ---------------------------------------------------------------------------

# the B01 regression configurations (tests/test_model_1d_b01.py, after the
# reference's B01_1D_regtest_wave_growth.jl): 31 nodes over 500 km at 10
# m/s, and the collapse at 5, 10 and 20 m/s on 21 nodes over 1000 km
# (U/10)^2; two model days of DT = 600 s
B01_STEPS = 288
B01_CHECKPOINT = 144
G_ACC = 9.81
DEPOSIT_1D_LANES = 2 ** 20
DEPOSIT_1D_NODES = 4096


def b01_model(dev, U10: float = 10.0, nx: int = 31, Lx: float = 500e3,
              tols=None) -> WaveGrowth1D:
    """tests/test_model_1d_b01.py's ``_model``: open ends, the log-energy
    minimum of the 1D minimal windsea, dt = 1e-3, dtmin = 1e-4."""
    ws = FR.MinimalWindsea_1d(U10, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=2 * DAY, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True, **(tols or {}))
    return WaveGrowth1D(one_d_grid(0.0, Lx, nx, periodic=False, device=dev),
                        constant_winds_1d(U10), sett,
                        config=WaveGrowth1DConfig(periodic_boundary=False))


def dulov_energy(t: float, U10: float) -> float:
    """The duration-limited JONSWAP energy through the Dulov tau -> fetch
    map, in float64."""
    tau = G_ACC * t / U10
    Xt = (tau / (FR.DULOV_A * FR.DULOV_XI_0X)) ** (1.0 / (1.0 - FR.DULOV_Q_X))
    fm = 3.5 * (G_ACC / U10) * Xt ** (-0.33)
    aj = 0.033 * (fm * U10 / G_ACC) ** 0.67
    return 0.31 * G_ACC ** 2 * aj * (fm * 2 * np.pi) ** (-4)


def b01_day(model, steps: int = B01_STEPS):
    """``steps`` steps through ``Simulation.run`` with a CashStore; returns
    (the simulation, its frames, its wall seconds)."""
    sim = Simulation.create(model, stop_time=(steps - 1) * DT)
    sim.run(cash_store=True)
    frames = sim.store.as_array()
    assert frames.shape == (steps + 1, model.grid.nx, 3), frames.shape
    assert np.isfinite(frames).all()
    return sim, frames, sim.run_wall_time


def deposit_1d_check(dev, periodic: bool) -> dict:
    """The sign-merge deposit of ``DEPOSIT_1D_LANES`` random lanes (both
    momentum signs, positions past both ends) over ``DEPOSIT_1D_NODES``
    nodes: two runs bit for bit, each sign group's additive deposit within
    1e-6 of the node's absolute sum of a float64 numpy sum of the same
    weights, and the merge their selection, bit for bit; the merge's time
    (CUDA events, the mean of 10 calls)."""
    rng = np.random.default_rng(17 + int(periodic))
    N, nx, dx = DEPOSIT_1D_LANES, DEPOSIT_1D_NODES, 1000.0
    L = dx * (nx - 1)
    x = rng.uniform(-0.1 * L, 1.1 * L, N).astype(np.float32)
    e = rng.uniform(0.1, 1.0, N).astype(np.float32)
    m = (np.where(rng.random(N) < 0.5, -1.0, 1.0)
         * rng.uniform(0.01, 0.1, N)).astype(np.float32)
    ch = np.stack([e, m, np.zeros_like(e)], axis=-1)
    act = rng.random(N) > 0.1
    X, C, A = (torch.as_tensor(a, device=dev) for a in (x, ch, act))
    S = scatter_1d_merge(X, C, A, 0.0, dx, nx, periodic)
    assert torch.equal(bits(S), bits(scatter_1d_merge(X, C, A, 0.0, dx, nx,
                                                      periodic))), \
        "1D deposit: two runs differ"
    # the float64 sum of the port's float32 weights, per sign group
    xn = (x - np.float32(0.0)) / np.float32(dx)
    fl = np.floor(xn)
    wc = xn - fl
    f = fl.astype(np.int64)
    pos = m >= 0
    worst = 0.0
    groups = []
    for grp in (pos, ~pos):
        ref = np.zeros((nx, 3))
        mag = np.zeros((nx, 3))
        for c, w in ((0, np.float32(1.0) - wc), (1, wc)):
            g = f + c
            w = w * (act & grp)
            if periodic:
                g = np.mod(g, nx)
            else:
                w = np.where((g >= 0) & (g < nx), w, 0.0)
                g = np.clip(g, 0, nx - 1)
            q = w[:, None].astype(np.float64) * ch
            for j in range(3):
                ref[:, j] += np.bincount(g, weights=q[:, j], minlength=nx)
                mag[:, j] += np.bincount(g, weights=np.abs(q[:, j]),
                                         minlength=nx)
        got = scatter_1d_add(X, C, A & torch.as_tensor(grp, device=dev), 0.0,
                             dx, nx, periodic)
        err = np.abs(got.double().cpu().numpy() - ref)
        bad = err > 1e-6 * mag
        assert not bad.any(), \
            f"1D deposit: {int(bad.sum())} sums beyond 1e-6 of float64"
        worst = max(worst, float((err / np.where(mag > 0, mag, 1.0)).max()))
        groups.append(got)
    # the merge: at each node the sign group of the larger |momentum|
    take = groups[0][:, 1].abs() >= groups[1][:, 1].abs()
    assert torch.equal(bits(S), bits(torch.where(take[:, None], *groups)))
    assert bool(take.any()) and not bool(take.all())
    return dict(rel_err=worst, ms=cuda_time_ms(
        lambda: scatter_1d_merge(X, C, A, 0.0, dx, nx, periodic), 10))


def phase_1d(dev, timing) -> None:
    """Phase "1d": the 1D growth model on the card (plain PyTorch; the
    model has no kernel in either package), the counters set to 0 just
    before and read just after (all 0).  Two model days (288 steps) of each
    B01 configuration through ``Simulation.run`` with a CashStore: the
    centre node onto the Dulov curve (ratios falling at 4, 8, 12 h, the
    last within 0.7-1.6) and E g^2/U^4 at g t/U = 30000 collapsing within
    25% across 5, 10 and 20 m/s, as tests/test_model_1d_b01.py asserts;
    a checkpoint at step 144 resumed bit for bit to the day's end; the card
    against the CPU on the B01 grid at abstol 1e-7 / reltol 1e-6 over 12
    steps within 1e-4 of the state's scale, the counters equal (the most
    substeps of a lane within 2); the sign-merge deposit, deterministic,
    periodic and open (``deposit_1d_check``)."""
    out = {}
    reset_counters()
    model = b01_model(dev)
    assert not model.graphed
    sim, frames, wall = b01_day(model)
    ratios = [float(frames[k, 15, 0]) / dulov_energy(k * DT, 10.0)
              for k in (24, 48, 72)]
    assert all(r1 > r2 for r1, r2 in zip(ratios, ratios[1:])), ratios
    assert 0.7 < ratios[-1] < 1.6, ratios
    m = check_state("1d B01", sim.state, n_failed=0)
    day2 = float(frames[-1, 15, 0]) / dulov_energy(B01_STEPS * DT, 10.0)
    out.update(b01_ratios=ratios, b01_ratio_day2=day2, b01_wall_s=wall,
               b01_ms_per_step=wall * 1e3 / B01_STEPS, b01_metrics=m)
    log("1d", f"B01 31 nodes / 500 km, 10 m/s: {B01_STEPS} steps through "
              f"Simulation.run (CashStore) in {wall:.3f} s wall "
              f"({wall * 1e3 / B01_STEPS:.3f} ms/step); E / E_Dulov at 4, 8, "
              f"12 h {[round(r, 4) for r in ratios]}, at 48 h {day2:.4f}; "
              f"metrics {m}")
    etils, walls = [], []
    for U in (5.0, 10.0, 20.0):
        mu = b01_model(dev, U, nx=21, Lx=1000e3 * (U / 10.0) ** 2)
        su, fu, w = b01_day(mu)
        n = int(round(30000.0 * U / G_ACC / DT))
        etils.append(float(fu[n, 10, 0]) * G_ACC ** 2 / U ** 4)
        walls.append(w)
        check_state(f"1d collapse {U}", su.state, n_failed=0)
    etils = np.array(etils)
    spread = np.abs(etils / etils.mean() - 1.0)
    assert np.all(spread < 0.25), etils
    c = counters()
    assert not any(c.values()), f"the 1D path launched a kernel: {c}"
    out.update(collapse_etilde=etils.tolist(), collapse_wall_s=walls)
    log("1d", f"collapse at g t/U = 30000 (5, 10, 20 m/s, 21 nodes, "
              f"{B01_STEPS} steps each, {sum(walls):.3f} s wall): E g^2/U^4 "
              f"{etils.tolist()}, spread {spread.max():.4f} of the mean; "
              f"launches {c}")

    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)   # git-ignored
    tmp = tempfile.mkdtemp(dir=cuda_build.BUILD_ROOT)
    leg = Simulation.create(model, stop_time=(B01_CHECKPOINT - 1) * DT)
    leg.run()
    assert int(leg.state.iteration) == B01_CHECKPOINT
    ck = leg.checkpoint(os.path.join(tmp, "b01"))
    rest = Simulation.create(model, stop_time=(B01_STEPS - 1) * DT)
    rest.pickup(ck)
    assert rest.state.state.is_cuda
    rest.run()
    assert_state_bitwise("1d B01 resumed from step 144", rest.state,
                         sim.state)
    shutil.rmtree(tmp, ignore_errors=True)
    log("1d", f"checkpoint at step {B01_CHECKPOINT} resumed to step "
              f"{B01_STEPS}: bit for bit the uninterrupted run")

    mg = b01_model(dev, tols=CARD_VS_CPU_TOLS)
    mc = b01_model("cpu", tols=CARD_VS_CPU_TOLS)
    sg, sc = mg.init_state(), mc.init_state()
    gap = 0.0
    for k in range(12):
        sg, sc = mg.step(sg), mc.step(sc)
        S = sc.state
        gap = max(gap, max_abs(sg.state.cpu(), S) / float(S.abs().max()))
        assert torch.equal(sg.particles.on.cpu(), sc.particles.on), k
        a, b = sg.metrics.as_dict(), sc.metrics.as_dict()
        smax = (a.pop("substeps_max"), b.pop("substeps_max"))
        assert a == b and abs(smax[0] - smax[1]) <= 2, (k, a, b, smax)
    assert gap <= 1e-4, gap
    out["card_vs_cpu_gap"] = gap
    log("1d", f"card vs CPU, B01 grid at abstol 1e-7 / reltol 1e-6, 12 "
              f"steps: max gap {gap:.3e} of the state's scale, on and the "
              f"counters equal")

    for periodic in (True, False):
        d = deposit_1d_check(dev, periodic)
        out[f"deposit_{'periodic' if periodic else 'open'}"] = d
        log("1d", f"sign-merge deposit, {DEPOSIT_1D_LANES} lanes over "
                  f"{DEPOSIT_1D_NODES} nodes, periodic={periodic}: two runs "
                  f"bit for bit; worst sum {d['rel_err']:.3e} of its absolute "
                  f"sum off float64; {d['ms']:.3f} ms a call")
    timing["1d"] = out


# the sharded tripolar step's solver tolerances: K4 and the seam fold sum
# a node's terms in another order than K2, and at reltol 1e-3 the
# controller turns that ulp into other substep paths past assert_states'
# 2e-3 (tests/test_torch_sharded.py measures 1.3e-2 on the CPU)
SHARDED_TRI_TOLS = dict(abstol=1e-7, reltol=1e-6)
SHARDED_TRI_PATHS = {"pallas": "K5", "default": "K3"}


def k4_tripolar(model, ms) -> dict:
    """K4 on the tripolar configuration's own deposit (one advance of the
    sharded state ``ms``, as a step makes it): against its plain version
    and ``_simple`` (``k4_pair``), timed by CUDA events (the wrapper's
    clamped count included) beside the plain version and its bound."""
    core, chans, act = flagship_deposit_inputs(model, ms)
    halo = model.config.halo
    err = k4_pair("tripolar deposit", core[3], core[4], chans, act, halo)
    ms_k = cuda_time_ms(lambda: pic_gather_padded(core[3], core[4], chans,
                                                  act, halo), 20)
    plain = cuda_time_ms(lambda: scatter_accumulate_padded(
        core[3], core[4], torch.stack(chans, dim=-1), act, halo), 5)
    (xl, xh), (yl, yh) = normalize_halo(halo)
    nx, ny = model.grid.nx, model.grid.ny
    b = deposit_bound(nx * ny, (nx + xl + xh) * (ny + yl + yh), halo)
    log("kernel-time", f"K4 on the tripolar deposit ({nx} x {ny}, halo "
                       f"{halo}): {ms_k:.4f} ms (CUDA events), plain "
                       f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms "
                       f"({b['bound_by']}); max abs err {err:.3e} of the "
                       f"scale")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=plain, **b)


def phase_sharded_tripolar(dev, results, timing) -> None:
    """Phase "sharded-tripolar", inside phase "sharded-1x1"'s process group
    (one NCCL rank): the global tripolar configuration (1440 x 720, DT =
    1200 s, halo 3, the gridded jet record, B = 1) through
    ``ShardedWaveGrowth2D`` on a (1, 1) mesh: K1 with the gridded planes
    and the projection planes -> K4 -> the self-wrap fold and the seam fold
    -> K5 gridded ("pallas"), or K3 with the projection planes and the
    PyTorch remesh ("default").  Each path, the counters set to 0 just
    before the sharded run and read just after: 3 steps at the solver
    tolerances ``SHARDED_TRI_TOLS`` against the single-device step at
    ``assert_states``' rtol 2e-3, then 20 more steps (no failed lane, the
    land checks of ``check_tripolar``), K1 == K4 == K5 (or K3) == 23 and
    no K2 or K6.  At the path's own tolerances with the plain deposit on
    both sides (``scatter_mode="dense"``) 3 steps bit for bit the
    single-device ones: the block planes (projection, winds, seam) are the
    grid's, and only the sum order of K4 and the folds parts the kernel
    runs.  Then both steps in turns, 8 times 10 steps each (CUDA
    events), and K4 on the "pallas" path's deposit (``k4_tripolar``)."""
    grid = tripolar_grid(dev, *TRI_SUPER)
    gw = tripolar_record(dev)
    n = grid.nx * grid.ny
    steps = 3 + 20
    out = {}
    for path, kern in SHARDED_TRI_PATHS.items():
        model = tripolar_model(grid, gw, path, tols=SHARDED_TRI_TOLS)
        assert model.uniform_proj is None and model._wind_B == 1
        ref = eager_steps(model, model.init_state(), 3)
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        reset_counters()
        ms = eager_steps(sh, sh.init_state(), 3)
        err = assert_states(f"sharded tripolar {path} vs single device, 3 "
                            f"steps", ms, ref)
        ms = eager_steps(sh, ms, steps - 3)
        c = counters()
        m = check_tripolar(f"sharded tripolar {path}", model, ms)
        other = "K3" if kern == "K5" else "K5"
        assert c["K1"] == c["K4"] == c[kern] == steps, c
        assert c["K2"] == c["K6"] == c[other] == 0, c
        results["K1 proj"]["launches"] += c["K1"]
        results["K4"]["launches"] += c["K4"]
        results["K3 proj" if kern == "K3" else "K5 gridded"]["launches"] += \
            c[kern]
        log("counters", f"sharded tripolar {path} path launches {c}")

        md = tripolar_model(grid, gw, path, scatter_mode="dense")
        shd = ShardedWaveGrowth2D(md, make_mesh((1, 1)))
        a, b = shd.init_state(), md.init_state()
        for _ in range(3):
            a, b = shd.step(a), md.step(b)
        assert_state_bitwise(f"sharded tripolar {path}, plain deposit, "
                             f"against the single-device step", a, b)
        del md, shd, a, b

        runs = {"sharded": [], "single": []}
        for rep in range(8):
            for who in (("sharded", "single") if rep % 2 == 0 else
                        ("single", "sharded")):
                if who == "single":
                    ref, t = time_steps(model, ref, 10, eager=True)
                else:
                    ms, t = time_steps(sh, ms, 10)
                runs[who].append(t)
        ms_step, single = (float(np.median(runs[k]))
                           for k in ("sharded", "single"))
        out[path] = dict(max_abs_err=err, launches=c, metrics=m,
                         ms_per_step=ms_step, single_ms_per_step=single,
                         pushes_per_s=n / (ms_step / 1e3), turns=runs,
                         plain_deposit_bitwise=True)
        if path == "pallas":
            out["K4 tripolar"] = k4_tripolar(model, ms)
        log("sharded-tripolar", f"{path} at {grid.nx} x {grid.ny}: 3 steps "
                                f"vs single device max abs err {err:.3e}, "
                                f"counters equal; {steps} steps, metrics "
                                f"{m}; the plain deposit on both sides bit "
                                f"for bit; {ms_step:.3f} ms/step sharded "
                                f"(1, 1) against {single:.3f} single-device "
                                f"eager (medians of 8 x 10 steps, CUDA "
                                f"events)")
        del model, sh, ms, ref
    timing["sharded_tripolar"] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--profile", metavar="JSON",
                    help="also profile the step at full size and write the "
                         "split of its time to this JSON file")
    ap.add_argument("--probe", metavar="JSON",
                    help="only build, print ptxas and SASS counts, time K1 "
                         "per substep, K3, K4 and K6, write them to this "
                         "JSON file, and stop")
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank of phase sharded-2x2
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if args.sharded_rank is not None:
        return sharded_rank(args.sharded_rank, args.port, args.rank_dir)
    if args.probe:
        phase_probe(args.probe)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, smi = phase_device()
    build = phase_build()
    dev = torch.device("cuda", 0)
    results = {
        "K1": dict(name="advance", route="cuda",
                   source="picles_torch/csrc/advance.cu",
                   replaces="picles_tpu/ops/advance_pallas.py:50"),
        "K2": dict(name="pic_gather", route="cuda",
                   source="picles_torch/csrc/pic_gather.cu",
                   replaces="picles_tpu/ops/pic_pallas.py:91"),
        "K3": dict(name="auto_dt", route="cuda",
                   source="picles_torch/csrc/advance.cu",
                   replaces="picles_tpu/ops/advance_pallas.py:200"),
        "K4": dict(name="pic_gather_padded", route="cuda",
                   source="picles_torch/csrc/pic_gather.cu",
                   replaces="picles_tpu/ops/pic_pallas.py:121"),
        "K5": dict(name="remesh", route="cuda",
                   source="picles_torch/csrc/remesh.cu",
                   replaces="picles_tpu/ops/remesh_pallas.py:116"),
        "K6": dict(name="pic_gather_remesh", route="cuda",
                   source="picles_torch/csrc/pic_gather.cu",
                   replaces="picles_tpu/ops/pic_pallas.py:375"),
    }
    # the gridded instances: the same kernels with the wind's planes
    for k in ("K1", "K3", "K5", "K6"):
        results[f"{k} gridded"] = dict(
            results[k], name=results[k]["name"] + "_gridded",
            replaces=GRIDDED_REPLACES[k], simple_ms=None)
    # the branches of spherical and tripolar grids: K1 and K3 with per-node
    # projection planes, K2 and K6 with the tripolar seam
    for key, rep in PROJ_REPLACES.items():
        k, kind = key.split()
        results[key] = dict(results[k], name=f"{results[k]['name']}_{kind}",
                            replaces=rep, simple_ms=None)
    # the layered launches: the same kernels over a layer dimension
    for k in LAYER_KERNELS:
        results[f"{k} layered"] = dict(
            results[k], name=results[k]["name"] + "_layered", simple_ms=None,
            launches=0)
    timing = {}
    phase_k1(dev, results)
    phase_k3(dev, results)
    phase_k2(dev, results)
    phase_k5_k6(dev, results)
    phase_gridded_kernels(dev, results)
    phase_proj(dev, results)
    phase_seam(dev, results)
    phase_wide_grid(dev, results)
    phase_layer_kernels(dev, results)
    flag, s_flag, default, s_def = phase_main_path(dev, results, timing)
    phase_k3_times(default, s_def, results)
    gw = gridded_record(dev)
    # right after its capture, each graph's trace: late in a process a
    # trace can miss launches
    phase_graphs(dev, gw, results, timing)
    layered = phase_layers(dev, gw, results, timing)
    if args.profile:
        # before the kernels' in-turns timing: a call that had run a few
        # dozen profiler sessions lost one K1 launch from every step trace
        phase_profile(args.profile, gw)
    phase_remesh_backends(dev, results, timing)
    phase_production(dev, results, timing)
    phase_cli(dev, results, timing)
    gridded = phase_gridded_main_path(dev, gw, results, timing)
    tripolar = phase_tripolar_main(dev, results, timing)
    phase_card_vs_cpu()
    phase_gridded_card_vs_cpu(gw)
    phase_tripolar_card_vs_cpu()
    phase_gridded_anchor(flag, s_flag, default, s_def)
    phase_kernel_times(flag, s_flag, default, s_def, results)
    phase_remesh_kernel_times(flag, s_flag, results)
    phase_k4(dev, flag, s_flag, results)
    # after the analytic instances' timing: each profiler trace a process
    # runs makes the next one likelier to miss launches
    gridded_kernel_times(*gridded, results)
    del gridded
    tripolar_kernel_times(*tripolar, results)
    del tripolar
    layered_kernel_times(layered, results, timing)
    del layered
    phase_twin_timing(timing, 20)
    del flag, s_flag, default, s_def
    phase_1d(dev, timing)
    phase_sharded_1x1(dev, gw, results, timing)
    phase_sharded_2x2(timing)

    kernels = [dict(results[k], library_ms=None,
                    short_traces=SHORT_TRACES.get(k, []))
               for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K1 gridded",
                         "K3 gridded", "K5 gridded", "K6 gridded",
                         *PROJ_REPLACES,
                         *(f"{k} layered" for k in LAYER_KERNELS))]
    assert len(kernels) == 20
    for k in kernels:
        assert all(f in k for f in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "simple_ms")), k
        k.setdefault("graph_launches", 0)   # K4: the sharded step is eager
    seconds = time.perf_counter() - t_start
    log("done", f"{seconds:.1f} s in all, build {build.seconds:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, kernels=kernels,
                           timing=timing, build_seconds=build.seconds,
                           ptxas=build.log, seconds=seconds), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
