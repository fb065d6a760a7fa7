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
   over NCCL (K1, K4, the self-wrap fold, K5, the counters' all-reduces),
   whose drivers and ``Simulation.run`` replay a CUDA graph of the sharded
   step, bit for bit its eager steps, timed in turns with the eager
   sharded step and the graphed single-device step; in the same process
   group, graphed alike, the layered step, the global tripolar
   configuration (phase "sharded-tripolar": 1440 x 720, K1 with
   projection and wind planes, K4, the self-wrap and seam folds, K5 or K3)
   and the global jet.  Then four ranks of this
   script on the same card over gloo (a 2 x 2 mesh; eager, staged through
   host memory) hold the collective
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

9. the 1D growth model (phase "1d"): kernel K7, the 1D advance (the
   port's own kernel; the JAX package runs the loop as a lax.while_loop),
   held against its plain version on B01's state and a 2^20-lane probe
   (node, gridded and traced winds, bosh3 and tsit5, fixed substeps and
   adaptive) and bit for bit against its ``_simple`` baseline (the kernel
   it replaced) on every state, timed in turns with it beside its bound;
   the traced kind (a 1D callable that reads its time, compiled into a
   library of its own): each emitted function bit for bit its callable on
   2^20 points, the 1D pulse bit for bit the node kind before its stop;
   two model days of the B01 configurations through ``Simulation.run``,
   graphed (onto the Dulov curve, the collapse across wind speeds), the
   eager K7 day bit for bit the graphed one, the graphed day against the
   plain eager day in turns, a checkpoint resumed bit for bit, the card
   against the CPU; B01 under a moving storm (``slopped_blob``, K7's
   traced kind) two days graphed, bit for bit its eager days, against its
   plain eager day in turns, and ``record_trajectories`` under it; and the
   deterministic sign-merge deposit on 2^20 lanes.

10. a wind given as a steady callable (the node kind of K1, K3, K5 and
    K6: its two node planes): phase "node-winds" holds
    ``Winds2D(u=lambda x, y, t: torch.full_like(x, 10.0), ...)`` bit for
    bit against ``constant_winds(10, 10)`` at 1536^2 under the flagship
    ``xla``, ``pallas`` and ``fused`` and the default configurations, and
    the global demo's two-jet callable bit for bit against a two-frame
    record of its planes at 1440 x 720; phase "global-jet" runs
    benchmark/tripolar_global_demo.py's configuration at 1440 x 720
    through ``Simulation.run`` (a graphed day of the fused path resumed
    from step 36, no energy on land, ms/step graphed and eager for the
    fused, "pallas" and default paths, against the plain advance the
    callable had before), its (1, 1) NCCL sharded step (inside
    "sharded-1x1") and the 2 x 2 gloo leg at 360 x 180; the node kind's
    kernels are held against their plain versions on the jet's states and
    timed; phase "examples" runs ``picles_torch/examples/example_00..05``
    at full size.

11. the modules ported last (phase "rest"): the fetch relations of both
    windsea types on 1536^2 planes on the card against the CPU; the
    deposit's ``scatter(mode="dense_cuda")`` at 1536^2 (K2, bit for bit
    ``pic_gather``) and ``merge_2d_angle``; ``record_trajectories`` on the
    fused flagship at 1536^2, whose history is ``step_n``'s bit for bit
    and whose sub-DT windows are K1 launches counted by trace (a 256^2
    crop held against the plain ``integrate_to``), timed at K = 1 and K =
    4 in turns with the graphed step; ``StepTimer`` and ``profile_trace``
    around graphed steps; and the B02 regression (three resolutions and a
    DT refinement of the gridded non-periodic box through
    ``Simulation.run`` on K1, K2 and K3, counted by trace) with its
    assertions, against the CPU at one resolution.

12. wind callables that read their time (phase "traced-winds": the traced
    kind of K1, K3, K5 and K6, each callable traced and compiled into a
    library of its own): the five libraries built at once; (a) each
    emitted function alone on 2^20 points bit for bit the callable run by
    torch on the card (the pulse and the returning wind of
    tests/test_growing_decaying_winds.py, ``time_cosine_winds`` stripped
    of its descriptor, example 02's jet, and ``every_op_winds``, every
    operation the tracer takes); (b) the traced kernels against their
    plain versions at 1536^2 across the switch times (lanes that step
    over the pulse's stop against the plain version's own one-ulp
    witness), example 02's jet traced bit for bit its node kind, the
    stripped time-cosine against its descriptor; (c) the pulse's fused,
    default and open-box days
    through ``Simulation.run``, graphed, bit for bit their eager days, no
    failed or clamped lane, the open box's upwind nodes off once the wind
    stops, against the plain eager advance in turns, and the returning
    wind re-lighting calm nodes; (d) 4 layers of the pulse and its (1, 1)
    NCCL sharded step (inside "sharded-1x1"), replays bit for bit the
    eager steps; (f) the pulse on the 1440 x 720 tripolar grid: the
    steps before its stop bit for bit ``constant_winds(12, 0)``'s (fused
    and default paths) and a fused day graphed with no failed or clamped
    lane; (e) each traced kernel bit for bit and in turns with the
    same kernel forced by ``constant_winds(12, 0)``, beside its bound and
    its plain version (K1, K3 and K5 by CUDA events).

13. float64 (phase "float64": K1-K6's double instances, the same CUDA
    templates in double, a library of their own built beside the kernels'):
    each against its float64 plain version at 256^2 in every branch
    (``f64_kernel_checks``); the flagship under the fused and "pallas"
    remeshes and the default configuration in float64 at 1536^2 on
    float64 grids, 3 eager steps counted, the graphed steps bit for bit
    them, their replays counted by trace; each double instance on those
    states within 1e-12 (K1 fixed, K3) or 1e-13 (the deposits) of its
    plain version and timed in turns with its float32 instance; the
    graphed steps float64 against float32 in turns; the double gather under
    each shared-memory budget; a float64 card run against the CPU's within
    1e-10 (all in a process of its own, ``--float64-child``, so that its
    traces add to no late-process count); the float64 "pallas" flagship's
    (1, 1) NCCL sharded step (K1, K4, K5) inside "sharded-1x1".  Then
    float64 under every wind (``phase_float64_winds``): the time-cosine
    sampler bit for bit IEEE division, each emitted double function bit
    for bit its callable, the traced kind's double instances of K1, K3, K5
    and K6 and K7's double instances against their plain versions, the
    float64 pulse's, B01's and the storm's days graphed bit for bit eager
    and in turns with float32, the card against the CPU (a float64 steady
    callable's float64 node planes among them), and the (1, 1) NCCL
    float64 pulse.  Phase "build" checks the float instances' PTX for
    float64 and the double instances' for narrowing to float32.

14. the fused box step (phase "epilogue": the step's glue in the
    epilogues of K1 and K6, as ``fused_glue`` chooses it) at 1536^2, with
    no guard firing and with every guard firing (``fire_guards``): K1's
    epilogue against raw K1 and the step's PyTorch glue up to the deposit
    (``_advance_glue``), K6's against raw K6, its planes stacked and the
    glue's branch counts, the fused step against ``_step_glue``; the
    epilogues' launches counted, each timed beside its raw kernel, what it
    replaces, its plain version and its bound (rows "K1 epilogue" and "K6
    epilogue" of the kernels line).

``Simulation.run`` replays the graph too, so paths 2, 3, 4, 5, 7, 9 and 12
run through it (13 through the drivers).  A replay launches the kernels without their wrappers, whose
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
``--profile`` traces the step's time at full size for each
configuration, eager and graphed (step times, host enqueue time, device
busy time and idle share, device time by kernel), in a process of its own
after the build: late in a process a trace can miss launches.  ``--probe JSON`` runs only the measurements
behind the kernels' design (ptxas, SASS counts, substep sweeps, K1's and
K7's lane divergence, K3 and K7 in turns with their baselines).

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
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
from picles_torch.forcing.winds import (GriddedWinds1D, GriddedWinds2D,
                                        WindKind, Winds1D, Winds2D,
                                        gridded_kernel, node_kernel,
                                        node_plane_winds, pwl_winds,
                                        slopped_blob, steady_node_plane_1d,
                                        steady_node_planes, traced_kernel,
                                        traced_kernel_1d)
from picles_torch.grids.mask import make_boundaries
from picles_torch.ops.advance_cuda import (N_COUNTERS, Guards, advance_1d,
                                           advance_cuda, auto_dt_cuda,
                                           auto_dt_reset, kernel_wind,
                                           node_projection,
                                           uniform_projection)
from picles_torch.ops.pic import (normalize_halo, scatter_1d_add,
                                  scatter_1d_merge, scatter_accumulate_padded,
                                  scatter_dense)
from picles_torch.ops.pic_cuda import (pic_gather, pic_gather_padded,
                                       pic_gather_remesh)
from picles_torch.ops.remesh import (GATHER_BIT, OFF_BIT, RESEED_BIT,
                                     remesh_core)
from picles_torch.ops.remesh_cuda import remesh_cuda
from picles_torch.ops.rhs import (RHSParams, make_rhs, make_rhs_consts,
                                  particle_equations_1d)
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
# kernel and PyTorch's clamp and select, which the new kernel replaces; a
# traced wind's library compiles the same kernels in a namespace `traced`
# and the float64 library their double instances in a namespace `f64`
# (rhs.cuh PICLES_KERNELS_BEGIN), which only the traced and f64 keys name
# (``kernel_named``)
KERNEL_KEYS = {"K1": "advance_kernel<", "K1 simple": "advance_simple_kernel<",
               "K2": "pic_gather_tiled_kernel<",
               "K2 simple": "pic_gather_simple_kernel(",
               "K3": "auto_dt_kernel<",
               "K3 simple": ("auto_dt_simple_kernel(", "clamp", "where"),
               "K3 simple only": "auto_dt_simple_kernel(",
               "K4": "pic_gather_tiled_kernel<",
               "K4 simple": "pic_gather_padded_simple_kernel(",
               "K5": "remesh_kernel<",
               "K6": "pic_gather_remesh_tiled_kernel<",
               "K6 simple": "pic_gather_remesh_simple_kernel(",
               "K7": "advance_1d_kernel<",
               "K7 simple": "advance_1d_simple_kernel<",
               "K7 traced": "traced::advance_1d_kernel<",
               "K7 traced simple": "traced::advance_1d_simple_kernel<",
               "K1 traced": "traced::advance_kernel<",
               "K3 traced": "traced::auto_dt_kernel<",
               "K5 traced": "traced::remesh_kernel<",
               "K6 traced": "traced::pic_gather_remesh_tiled_kernel<",
               "K1 f64": "f64::advance_kernel<",
               "K2 f64": "f64::pic_gather_tiled_kernel<",
               "K3 f64": "f64::auto_dt_kernel<",
               "K4 f64": "f64::pic_gather_tiled_kernel<",
               "K5 f64": "f64::remesh_kernel<",
               "K6 f64": "f64::pic_gather_remesh_tiled_kernel<",
               "K7 f64": "f64::advance_1d_kernel<",
               "K1 traced f64": "traced64::advance_kernel<",
               "K3 traced f64": "traced64::auto_dt_kernel<",
               "K5 traced f64": "traced64::remesh_kernel<",
               "K6 traced f64": "traced64::pic_gather_remesh_tiled_kernel<",
               "K7 traced f64": "traced64::advance_1d_kernel<"}


def kernel_named(key: str, name: str) -> bool:
    """Whether the device op ``name`` is a launch of the kernel that
    ``key`` (a KERNEL_KEYS name) names: a key without ``traced::`` names
    none of a traced library's kernels, one without ``f64::`` none of the
    float64 library's, one without ``traced64::`` none of a float64 traced
    library's."""
    return (key in name
            and ("traced::" in name) == key.startswith("traced::")
            and ("f64::" in name) == key.startswith("f64::")
            and ("traced64::" in name) == key.startswith("traced64::"))


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
    profiler sessions, and now and then all of a session's), so each trace
    opens with ``trace_head`` and pads the launches with the host idle on
    both sides (``trace_pad_s``), and a short trace is taken again, up to
    ``tries`` times, with more idle.  If every one is short,
    the means are over the launches the fullest one holds where it holds
    half of each op's, else the time is the whole call's by CUDA events
    (``cuda_time_ms``: the kernel and the wrapper's other device work); it
    is logged and recorded in SHORT_TRACES under ``row`` (by default the
    kernel's id) as [launches held, launches timed, how it was timed]."""
    from torch.profiler import ProfilerActivity, profile

    names = KERNEL_KEYS[key]
    names = (names,) if isinstance(names, str) else names
    want = reps * len(names) * per_call
    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(tries):
        pad = trace_pad_s(attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_head(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        ev = [e for e in dev if any(kernel_named(nm, e.name) for nm in names)]
        assert len(ev) <= want, f"{key}: {len(ev)} of {want} launches"
        best = ev if len(ev) > len(best) else best
        if len(ev) == want:
            if attempt:
                log("kernel-time", f"{key}: trace {attempt + 1} (host idle "
                                   f"{pad:.2f} s each side) holds all "
                                   f"{want} launches")
            break
        log("kernel-time", f"{key}: trace {attempt + 1} (host idle "
                           f"{pad:.2f} s each side) holds {len(ev)} of "
                           f"{want} launches; {trace_head_held(dev)}")
    us = {nm: [e.time_range.elapsed_us() for e in best
               if kernel_named(nm, e.name)] for nm in names}
    if len(best) == want:
        timed_by = None
    elif all(2 * len(u) >= reps * per_call for u in us.values()):
        timed_by = "fullest trace"
    else:
        timed_by = "cuda events"
    if timed_by:
        SHORT_TRACES.setdefault(row or key.split()[0], []).append(
            [len(best), want, timed_by])
    if timed_by == "cuda events":
        ms = cuda_time_ms(fn, reps)
        log("kernel-time", f"{key}: no trace held half its launches; "
                           f"{ms:.4f} ms a call by CUDA events")
        return ms
    return sum(sum(u) / len(u) * per_call / 1e3 for u in us.values())


def trace_pad_s(attempt: int) -> float:
    """Seconds the host idles on each side of a trace's launches
    (``attempt`` counted from 0): 0.05 s, doubled at each retry.  Late in
    a process an unpadded trace lost the device events at the start of
    its window, often all of them (H100, 700 W; PERF.md, PR 16)."""
    return 0.05 * 2 ** attempt


# the device op that opens every timing trace (``trace_head``): PyTorch's
# spin kernel, which no traced run launches; left out of every count
TRACE_HEAD = "spin_kernel"


def trace_head(pad: float) -> None:
    """The head of a profiler trace's window, before the launches it
    times: one short spin kernel, run to its end (a trace can lose the
    first device op of its window), then the host idle ``pad`` s."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(pad)


def trace_head_held(dev: list) -> str:
    """Whether a trace's device ops hold its head (``trace_head``), and
    how many ops it holds: logged with a short trace."""
    held = any(TRACE_HEAD in e.name for e in dev)
    return f"head {'held' if held else 'lost'}, {len(dev)} device ops"


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
# the float64 instances' operations (phase "float64"): 34 TFLOP/s, float64
# outside the tensor cores, half the float32 rate (NVIDIA H100 SXM
# datasheet)
FP64_OPS_PER_S = 34e12
# float operations of one RHS evaluation (rhs.cuh, every term on): 12
# divisions, 6 transcendentals and square roots, about 84 products, sums,
# selects and clamps
RHS_OPS = 102


def bound(nbytes: float, ops: float, real: int = 4) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel's bytes and operations, the
    operations at the rate of the lanes' type (``real`` bytes: float32 or,
    with 8, float64)."""
    rate = FP64_OPS_PER_S if real == 8 else FP32_OPS_PER_S
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def k1_substep_ops(method: str, adaptive: bool, comps: int = 5) -> int:
    """Float operations of one substep of the embedded-RK loop outside the
    RHS (K1: 5 components, K7: 3): the stage and solution sums (dt*a once,
    then a product and a sum per component), the stage times, and for the
    adaptive controller the error sums (a product and a sum per component),
    dt times the error, the scaled norm (8 operations a component), the
    square root and the step-size update (with powf)."""
    m = METHODS[method]
    nz_a = sum(1 for row in m.a for x in row if x != 0.0)
    nz_b = sum(1 for x in m.b if x != 0.0)
    per = 1 + 2 * comps
    ops = per * nz_a + 2 * len(m.c) + per * nz_b + 13
    if adaptive:
        ops += (2 * comps * sum(1 for x in m.bt if x != 0.0) + comps
                + 8 * comps + 2 + 15)
    return ops


def gridded_wind_ops(B: int) -> int:
    """Float operations of one evaluation of the gridded samplers: a + t s
    for u and v (4), then per breakpoint t - b and its max once, a product
    and a sum for each of u and v (6)."""
    return 4 + 6 * B


def k1_bound(n: int, method: str, adaptive: bool, live, iters,
             n_wf: int = 0, proj: bool = False, layers: int = 1,
             traced_ops: int = 0, real: int = 4,
             epilogue: bool = False) -> dict:
    """K1's bound on this run's inputs: 33 bytes in and 33 out a particle,
    the node x (4 bytes, which only an analytic wind reads) or a wind's
    ``n_wf`` planes in (4 bytes each: 4 + 3B gridded, 2 of the node kind)
    and, with per-node projection planes (``proj``), 5 more (20 bytes); per
    live particle one RHS evaluation to start, then per substep
    tried (accepted or rejected) S evaluations (each with the gridded
    samplers; the node kind's pair is loaded once) and the substep's own
    operations.  With ``layers`` the ``n`` particles are that many layers of
    one grid, whose node x and node planes are read once a node.  A traced
    wind (``traced_ops`` operations an evaluation) reads the node x and y
    (8 bytes).  ``real``: the bytes of a lane value (8 for the float64
    instances: the 14 lane planes, the node x and y and the projection
    planes twice as wide, the masks, counts and float32 wind planes
    not).  With its ``epilogue`` (the step's guards: ``Guards``) K1 reads
    the flags ``on`` in place of the advanced mask and writes the flags,
    the deposit's mask and the three channels (e, m_x, m_y) in place of
    ``failed`` and ``naccept`` (76 bytes a lane in float32; the boundary
    mask, read only where the boundary reseeds, is not counted), and a
    lane's epilogue costs ``EPILOGUE_OPS`` more."""
    S = len(METHODS[method].b)
    it = float(iters[live].double().sum())
    rhs = RHS_OPS + traced_ops + (gridded_wind_ops((n_wf - 4) // 3)
                                  if n_wf > 2 else 0)
    ops = (float(live.sum()) + S * it) * rhs \
        + it * k1_substep_ops(method, adaptive)
    node = real * (n_wf == 0) + 4.0 * n_wf + 5.0 * real * proj + real * (
        traced_ops > 0)
    lane = 14.0 * real + (3.0 * real + 4.0 if epilogue else 6.0)
    ops += EPILOGUE_OPS * n * epilogue
    return bound((lane + node / layers) * n, ops, real)


# float operations of K1's epilogue a lane (advance.cu guard_lane, no
# guard firing): the wind's square and its comparison, the NaN and Inf
# tests of three values, the log-energy clamp, exp, |cg|^2 and its floor,
# two products, two divisions and two halvings for the channels, and the
# halo's four comparisons
EPILOGUE_OPS = 24


# float operations of one 1D RHS evaluation (rhs.cuh rhs_1d, every term
# on; 1 / r_g and 1 / e_T come from the host): 4 divisions (k_p's,
# omega_p's, alpha's and the sech's), 5 transcendentals (tanhf, 3 expf,
# powf) and 46 products, sums, absolute values, clamps and selects (the
# two negations are operand modifiers, not counted); and of one read of a
# 1D wind record (rhs.cuh gridded_u_1d: both axes folded, the index pairs
# and weights, four weighted samples summed)
RHS1D_OPS = 55
WIND1D_OPS = 27


def k7_bound(n: int, method: str, adaptive: bool, live, iters,
             record_bytes: int = 0, traced_ops: int = 0,
             real: int = 4) -> dict:
    """K7's bound on this run's inputs: 25 bytes in (z, t, dt, active, and
    the node's wind plane or its x) and 25 out a particle, a record's
    bytes once; per live particle one RHS evaluation to start, then per
    substep tried (accepted or rejected) S evaluations (each with a read of
    the record where the wind is one, or the traced wind's ``traced_ops``
    operations) and the substep's own operations over 3 components.
    ``real``: the bytes of a lane value (8: the float64 instances, 94 bytes
    a particle, the operations at the float64 rate)."""
    S = len(METHODS[method].b)
    it = float(iters[live].double().sum())
    rhs = RHS1D_OPS + (WIND1D_OPS if record_bytes else 0) + traced_ops
    ops = (float(live.sum()) + S * it) * rhs \
        + it * k1_substep_ops(method, adaptive, comps=3)
    return bound((11.0 * real + 6.0) * n + record_bytes, ops, real)


def remesh_branch_bytes(branch: torch.Tensor, wind_bytes: float,
                        real: int = 4) -> float:
    """The bytes the branch table must move at one layer's nodes, by the
    branch each node took in this run (``branch``, the kernel's output:
    remesh.cuh GATHER_BIT, RESEED_BIT, OFF_BIT, 0 outside the particle
    set): at every node its two masks and dt in (a gathered or reseeded
    node's dt is clipped, the others' kept) and its 29 bytes out; outside
    the particle set the particle (lne, cgx, cgy, px, py, on: 21 bytes),
    which it keeps; an off node its particle's five planes (20 bytes); a
    node that does not gather its wind (``wind_bytes``), whose strength
    decides reseed or off.  A gathered node's particle is overwritten, its
    wind not needed.  ``real``: the bytes of a lane value (8: float64, the
    particle planes and dt twice as wide)."""
    b = branch.reshape(-1)
    n = b.numel()
    outside = int((b == 0).sum())
    off = int(((b & 4) != 0).sum())
    no_gather = int(((b & 1) == 0).sum()) - outside
    return ((7.0 * real + 7.0) * n + (5.0 * real + 1.0) * outside
            + 5.0 * real * off + wind_bytes * no_gather)


def deposit_bound(n_src: int, n_out: int, halo, remesh: bool = False,
                  n_wf: int = 0, layers: int = 1, traced_ops: int = 0,
                  branch: torch.Tensor = None, real: int = 4) -> dict:
    """K2/K4/K6 on this run's shapes: per source 5 float planes and the mask
    (21 bytes) and about 13 operations (clamps, floors, weights, c * m); per
    output node 3 floats (12 bytes) and 11 operations a window cell; K6 adds
    the remesh's 60 bytes a node in and out (lne, cgx, cgy, px, py, dt, the
    three masks and x in; six planes, `on` and the branch bits out) and
    about 60 operations; with a wind's ``n_wf`` planes, 4 bytes each in
    place of the node x, and a gridded wind's samplers' operations.  With
    ``layers`` the sources and outputs are that many layers of one grid,
    whose masks and node x (or wind planes) the remesh reads once a
    node.  A traced wind (``traced_ops`` operations, ``n_wf`` = 1: the
    node y) reads the node x too.  With this run's ``branch`` (one layer)
    the remesh's bytes are those its branches need
    (``remesh_branch_bytes``), and the wind's operations count only at the
    nodes that do not gather.  ``real``: the bytes of a lane value (8:
    float64, every plane but the masks, the branch and the float32 wind
    planes twice as wide)."""
    (xl, xh), (yl, yh) = normalize_halo(halo)
    cells = (xl + xh + 1) * (yl + yh + 1)
    plane = real if traced_ops else 4.0   # the traced kind's: the node y
    wind = (plane * n_wf - real) if n_wf else 0.0
    wind += real * (traced_ops > 0)
    node = 2.0 + real + wind   # active, boundary and x (or the wind planes)
    nbytes = (5.0 * real + 1.0) * n_src + 3.0 * real * n_out + (
        (12.0 * real + 6.0 + node / layers) * n_out if remesh else 0.0)
    ops = 13.0 * n_src + 11.0 * cells * n_out + (60.0 * n_out if remesh
                                                 else 0.0)
    if remesh and n_wf > 2:
        ops += gridded_wind_ops((n_wf - 4) // 3) * n_out
    if remesh:
        ops += traced_ops * n_out
    if remesh and branch is not None:
        assert layers == 1 and n_wf <= 2
        need = int(((branch & 1) == 0).sum())
        nbytes = (5.0 * real + 1.0) * n_src + 3.0 * real * n_out \
            + remesh_branch_bytes(branch, plane * n_wf + real * (
                traced_ops > 0), real)
        ops += traced_ops * (need - n_out)
    return bound(nbytes, ops, real)


def remesh_bound(n: int, n_wf: int = 0, layers: int = 1,
                 traced_ops: int = 0, branch: torch.Tensor = None,
                 real: int = 4) -> dict:
    """K5: 72 bytes a node (43 in, 29 out) and about 60 operations; a
    wind's ``n_wf`` planes in place of the node x, and a gridded wind's
    samplers' operations.  With ``layers`` the ``n`` nodes are that many
    layers of one grid, whose masks and node x (or wind planes) are read
    once a node.  A traced wind (``traced_ops`` operations, ``n_wf`` = 1:
    the node y) reads the node x too.  With this run's ``branch`` (one
    layer) the bytes are those its branches need (``remesh_branch_bytes``,
    and the deposited state, 12 bytes, at the nodes of the particle set),
    and the wind's operations count only at the nodes that do not
    gather.  ``real``: the bytes of a lane value (8: float64)."""
    plane = real if traced_ops else 4.0   # the traced kind's: the node y
    wind = (plane * n_wf - real) if n_wf else 0.0
    wind += real * (traced_ops > 0)
    ops = 60.0 + traced_ops + (gridded_wind_ops((n_wf - 4) // 3)
                               if n_wf > 2 else 0)
    node = 2.0 + real + wind   # active, boundary and x (or the wind planes)
    if branch is not None:
        assert layers == 1 and n_wf <= 2
        inside = int((branch != 0).sum())
        need = int(((branch & 1) == 0).sum())
        return bound(real + 3.0 * real * inside + remesh_branch_bytes(
            branch, plane * n_wf + real * (traced_ops > 0), real),
            (60.0 + (gridded_wind_ops((n_wf - 4) // 3) if n_wf > 2 else 0))
            * n + traced_ops * need, real)
    return bound((15.0 * real + 6.0 + node / layers) * n, ops * n, real)


def k3_bound(reset: torch.Tensor, wind, proj: bool = False,
             layers: int = 1, real: int = 4) -> dict:
    """K3 on this run's inputs: per lane the mask (1 byte) in and dt out (4);
    per reset lane the 5 components (20 bytes), the node x where an
    analytic wind reads it, t where the wind varies in t, a gridded wind's
    4 + 3B planes or the node kind's 2 (4 bytes each) and per-node
    projection planes (``proj``,
    20 bytes), 2 RHS evaluations (with the gridded samplers), the norms,
    h0, h1 and the clamp (about 62 operations); per lane that is not reset
    its dt (4 bytes) and no operation.  With ``layers`` the lanes are that
    many layers of one grid, whose node x and node planes are read once a
    node.  A traced wind reads the node x and y and t, and runs its
    operations an evaluation.  ``real``: the bytes of a lane value (8:
    float64)."""
    n, r = reset.numel(), int(reset.sum())
    gridded = wind.kind == WindKind.GRIDDED
    traced = wind.kind == WindKind.TRACED
    n_wf = (4 + 3 * wind.n_break if gridded else
            2 if wind.kind == WindKind.NODE else 0)
    node = real * (wind.kind in (WindKind.HALF_DOMAIN,
                                 WindKind.TIME_COSINE)) \
        + 4.0 * n_wf + 5.0 * real * proj + 2.0 * real * traced
    per_reset = 5.0 * real + real * (wind.kind in (WindKind.TIME_COSINE,
                                                   WindKind.GRIDDED,
                                                   WindKind.TRACED)) \
        + node / layers
    rhs = RHS_OPS + (gridded_wind_ops(wind.n_break) if gridded else 0) + (
        len(wind.traced.ops) if traced else 0)
    return bound((1.0 + real) * n + per_reset * r + real * (n - r),
                 (2 * rhs + 62.0) * r, real)


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


# the integer type of each dtype's bits
BIT_TYPES = {torch.bool: torch.uint8, torch.float64: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (NaN payloads included), for bitwise comparisons."""
    return t.contiguous().view(BIT_TYPES.get(t.dtype, torch.int32))


def assert_bitwise(what: str, new, simple) -> None:
    """Every tensor of ``new`` equal to ``simple``'s bit for bit."""
    for i, (a, b) in enumerate(zip(new, simple)):
        if not torch.equal(bits(a), bits(b)):
            d = int((bits(a) != bits(b)).sum())
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"_simple baseline on {d} of {a.numel()}")


def settings(solver: str, **tols):
    """The flagship's ODE settings with ``solver``; ``tols`` replaces any
    of them (the tolerances, ``force_dtmin``)."""
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    kw = dict(log_energy_minimum=float(ws.lne), saving_step=DT, timestep=DT,
              total_time=6 * 24 * 3600.0, dt=1e-3, dtmin=1e-4,
              force_dtmin=True, solver=solver)
    kw.update(tols)
    return ODESettings(**kw)


def flagship_model(n: int, device, solver="bosh3", dt_reset_mode="carry",
                   halo=((0, 3), (0, 3)), periodic=True, winds=None,
                   tols=None, dtype=torch.float32, **modes):
    """bench.py's production configuration on the port: 2 km spacing,
    periodic box, constant (10, 10) m/s winds (or ``winds``), directional
    halo; the grid and the model in ``dtype``."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(periodic, periodic),
                         device=device, dtype=dtype)
    cfg = WaveGrowth2DConfig(periodic_boundary=periodic,
                             dt_reset_mode=dt_reset_mode, halo=halo,
                             dtype=dtype, **modes)
    return WaveGrowth2D(grid, winds or constant_winds(10.0, 10.0),
                        settings(solver, **(tols or {})), config=cfg)


def default_model(n: int, device, winds=None, tols=None,
                  dtype=torch.float32, **modes):
    """The package default (tsit5, Hairer dt reset, halo 3) on the same
    box, in ``dtype``."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=device,
                         dtype=dtype)
    return WaveGrowth2D(grid, winds or constant_winds(10.0, 10.0),
                        settings("tsit5", **(tols or {})),
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  dtype=dtype, **modes))


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


def ptxas_entries(log_text: str) -> list:
    """(entry, registers, spill store bytes, spill load bytes) of each
    kernel instance in a ptxas -v log."""
    out, props = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            out.append([ln.split("'")[1], 0, 0, 0])
        elif "Function properties for" in ln:
            props = ln.split("for", 1)[1].strip()
        elif out and props == out[-1][0] and "spill stores" in ln:
            w = ln.replace(",", " ").split()
            out[-1][2] = int(w[w.index("stores") - 3])
            out[-1][3] = int(w[w.index("loads") - 3])
        elif out and "Used" in ln and "registers" in ln:
            w = ln.split()
            out[-1][1] = int(w[w.index("registers,") - 1]
                             if "registers," in w
                             else w[w.index("registers") - 1])
    return out


def phase_build():
    """The kernels' library and the float64 library, built at once (one
    nvcc a source), then both PTX checks at once: the float instances hold
    no float64 line but the cosf argument reduction
    (``unexpected_double_ops``), the double instances no narrowing to
    float32 but the time-cosine amplitude's, the 1D record's value's and
    libdevice's double tanh's (``narrowing_summary``).  Logs the
    double instances' registers and spills."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        fut = ex.submit(cuda_build.build_f64)
        res = cuda_build.build()
        res64 = fut.result()
    seconds = time.perf_counter() - t0
    cuda_build.library()
    cuda_build.library_f64()
    lines = res.log.splitlines()
    regs = sorted({ln.split(":", 1)[1].strip() for ln in lines
                   if "registers" in ln})
    n_double = sum("double precision" in ln for ln in lines)
    with ThreadPoolExecutor(2) as ex:
        fut = ex.submit(cuda_build.narrowing_summary)
        bad = cuda_build.unexpected_double_ops()
        narrowing = fut.result()
    narrow = narrowing["other"]
    log("build", f"{seconds:.1f} s, both libraries ({res.path.parent.name}, "
                 f"{res64.path.parent.name}); ptxas: {' | '.join(regs)}; "
                 f"float64 PTX lines: {n_double} warned, all in the cosf "
                 f"argument reduction")
    assert not bad, f"float64 in the kernels' own code: {bad[:5]}"
    ents = ptxas_entries(res64.log)
    spills = [e for e in ents if e[2] or e[3]]
    log("build", f"float64 library: {len(ents)} instances, registers "
                 f"{min(e[1] for e in ents)}-{max(e[1] for e in ents)}, "
                 f"{len(spills)} spilling: {spills}; PTX: float64 -> "
                 f"float32 conversions {narrowing['amplitude']} in "
                 f"{cuda_build.F64_NARROWING_FUNC}, {narrowing['record']} in "
                 f"{cuda_build.F64_NARROWING_FUNCS['record']} (K7's 1D "
                 f"record), {narrowing['tanh']} libdevice's double tanh "
                 f"exponent estimates, {len(narrow)} elsewhere")
    for e in ents:
        log("build", f"  f64 {e[0][:96]}: {e[1]} registers, spill "
                     f"stores {e[2]} B, loads {e[3]} B")
    assert not narrow, f"narrowing in the double instances: {narrow[:5]}"
    res = res._replace(seconds=seconds, log=res.log + res64.log)
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
             proj, baseline: bool = True, witness=None,
             loose_atol: float = 1e-3, stats: dict = None):
    """K1 on these inputs bit for bit its _simple baseline (``baseline``:
    a traced wind has none) and against integrate_to: fixed substeps within
    rtol 1e-5 with dt, failed and naccept equal; adaptive by share of lanes
    (``assert_adaptive``, ``assert_controller``), failed equal.
    ``witness`` (a lane mask) names lanes whose plain version is
    ill-conditioned: their values are held by ``witness_check`` against
    the plain version run again with every component one ulp up (the
    witness, run here), the others as above.  ``loose_atol`` is
    ``assert_adaptive``'s near-zero bound; above its 1e-3 the witness
    runs too, and ``near_zero_check`` holds the lanes between the two
    bounds to the witness's count.  ``stats``: a dict that takes the
    witness's readings under ``tag``.  Returns (max abs err, failed
    lanes)."""
    args = (winds, consts, flags, cfg, DT, comps, t, dt, active, grid.x,
            grid.y, proj)
    k = advance_cuda(*args)
    if baseline:
        assert_bitwise(tag, k, advance_cuda(*args, simple=True))
    rhs = make_rhs(winds.u, winds.v, consts, flags)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    z = torch.stack(comps, dim=-1)
    p = integrate_to(rhs, z, t, t + DT, dt, aux, active, cfg)
    near_zero = cfg.adaptive and loose_atol > 1e-3
    pu = None
    if witness is not None or near_zero:
        pu = integrate_to(rhs, torch.nextafter(z, torch.full_like(
            z, float("inf"))), t, t + DT, dt, aux, active, cfg)
    torch.cuda.synchronize()
    names = ("lne", "cgx", "cgy", "x", "y")
    extra = ""
    ok = torch.ones_like(active) if witness is None else ~witness
    mode = "adaptive" if cfg.adaptive else "fixed"
    w = {}
    if cfg.adaptive:
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        errs = [assert_adaptive(f"{tag} {nm}", kz[ok], p.z[..., i][ok],
                                loose_atol=loose_atol)
                for i, (nm, kz) in enumerate(zip(names, k[:5]))]
        assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
        extra = "; " + assert_controller(tag, k, p, active & ok)
        if near_zero:
            w.update(near_zero_check(tag, k, p, pu, ok & active))
            extra += (f"; beyond rtol 0.1 / atol 1e-3 of the plain version "
                      f"on {w['lanes']} lanes: K1 {w['kernel_beyond']}, the "
                      f"witness {w['witness_beyond']}, none beyond "
                      f"{loose_atol:g}")
    else:
        errs = [assert_close(f"{tag} {nm}", kz[ok], p.z[..., i][ok], 1e-5,
                             1e-6)
                for i, (nm, kz) in enumerate(zip(names, k[:5]))]
        errs.append(assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0))
        assert torch.equal(k.dt, p.dt), f"{tag}: dt not carried as given"
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        assert torch.equal(k.naccept, p.naccept), f"{tag}: naccept differs"
    if witness is not None:
        rtol, atol = WITNESS_TOLS[mode]
        w.update(witness_check(tag, k, p, pu, witness, rtol, atol,
                               WITNESS_MARGIN[mode]))
        extra += "; " + w["summary"]
    if stats is not None and w:
        stats[tag] = w
    nfail = int(k.failed.sum())
    log("K1", f"{tag}: max abs err {max(errs):.3e}, substeps max "
              f"{int(k.naccept.max())}/{int(p.naccept.max())}, "
              f"failed {nfail}{extra}"
              f"{'; bitwise equal to _simple' if baseline else ''}")
    return max(errs), nfail


def near_zero_check(tag, k, p, pu, lanes) -> dict:
    """Adaptive lanes held at a near-zero bound looser than
    ``assert_adaptive``'s 1e-3: on ``lanes``, the count of lanes on which
    K1 parts from the plain version ``p`` beyond rtol 0.1 / atol 1e-3 may
    be at most twice the count on which the witness ``pu`` (the plain
    version run with every component one ulp up) parts from it, plus 3
    (counting noise).  On the H100 at 1536^2 (the stripped time-cosine,
    tsit5 adaptive) K1 parted from the plain version on 12 lanes, the
    witness on 10, the witness one ulp down on 11 and a float64 run on 11,
    and none beyond 5e-3.  Returns the counts."""
    def beyond(a):
        return int((~torch.isclose(a[lanes], p.z[lanes], rtol=0.1, atol=1e-3,
                                   equal_nan=True)).any(-1).sum())

    r = dict(lanes=int(lanes.sum()),
             kernel_beyond=beyond(torch.stack(list(k[:5]), dim=-1)),
             witness_beyond=beyond(pu.z))
    assert r["kernel_beyond"] <= 2 * r["witness_beyond"] + 3, \
        f"{tag}: K1 parts from the plain version beyond rtol 0.1 / atol " \
        f"1e-3 on {r['kernel_beyond']} lanes, the witness on " \
        f"{r['witness_beyond']}"
    return r


# the lanes of K1 that step over a wind's stop (``witness_check``): the
# tolerances of a lane's agreement with the plain version, and how far
# K1's share of agreeing lanes may fall below the witness's (the plain
# version against itself one ulp up, in the same run).  On the H100 at
# 1536^2 the witness kept 98.99% (fixed) and 88.82% (adaptive) of the
# crossing lanes, K1 98.91% and 89.30%: the margins are about five times
# the fixed gap and four times the adaptive one, and widen to three
# binomial deviations of the witness's share on a small sample
WITNESS_TOLS = {"fixed": (1e-5, 1e-6), "adaptive": (5e-3, 1e-4)}
WITNESS_MARGIN = {"fixed": 0.005, "adaptive": 0.02}


def witness_check(tag, k, p, pu, lanes, rtol: float, atol: float,
                  margin: float) -> dict:
    """On ``lanes``, where the plain version ``p`` is ill-conditioned
    (tsit5 substeps across a wind that stops): the lanes on which the
    plain version diverges (a component not finite, or lne below -50) are
    K1's (``k``) too, and of the others the share that agree within
    ``rtol`` and ``atol`` in every component is no more than ``margin``
    (or three binomial deviations of the witness's share, if more) below
    the witness's: ``pu``, the plain version run with every component of
    its input one ulp up, read the same way.  Returns the readings and a
    summary for the log."""
    kz = torch.stack(list(k[:5]), dim=-1)[lanes]
    pz, uz = p.z[lanes], pu.z[lanes]

    def diverged(z):
        return ~torch.isfinite(z).all(-1) | (z[..., 0] < -50.0)

    def share(a, b):
        near = ((a - b).abs() <= atol + rtol * b.abs()).all(-1)
        return float(near.double().mean()) if near.numel() else 1.0

    dk, dp, du = diverged(kz), diverged(pz), diverged(uz)
    assert torch.equal(dk, dp), \
        f"{tag}: K1 diverges on {int(dk.sum())} lanes, the plain version " \
        f"on {int(dp.sum())} ({int((dk != dp).sum())} differ)"
    keep = ~dp & ~du
    ws = share(uz[keep], pz[keep])
    dev3 = 3.0 * (ws * (1.0 - ws) / max(int(keep.sum()), 1)) ** 0.5
    r = dict(lanes=int(lanes.sum()), diverged=int(dp.sum()),
             witness_diverged_differ=int((du != dp).sum()),
             share=share(kz[~dp], pz[~dp]), witness_share=ws, rtol=rtol,
             min_share=ws - max(margin, dev3))
    assert r["share"] >= r["min_share"], \
        f"{tag}: {r['share']:.4%} of the lanes crossing the stop within " \
        f"rtol {rtol:g}, the witness {ws:.4%} (need {r['min_share']:.4%})"
    r["summary"] = (f"{r['lanes']} lanes step over the stop: "
                    f"{r['diverged']} diverge in both, {r['share']:.4%} of "
                    f"the others within rtol {rtol:g} (need "
                    f"{r['min_share']:.4%}); the witness (the plain "
                    f"version one ulp up) {ws:.4%}, its diverged lanes "
                    f"differ on {r['witness_diverged_differ']}")
    return r


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
              "K6": pic_gather_remesh, "K7": advance_1d}


# the wrappers whose traced instances count apart (``traced_launches``)
TRACED_FNS = {"K1 traced": advance_cuda, "K3 traced": auto_dt_cuda,
              "K5 traced": remesh_cuda, "K6 traced": pic_gather_remesh,
              "K7 traced": advance_1d}


def counters():
    return {k: fn.launches for k, fn in KERNEL_FNS.items()}


def all_counters():
    """``counters()`` and the traced instances' (``TRACED_FNS``)."""
    return {**counters(),
            **{k: fn.traced_launches for k, fn in TRACED_FNS.items()}}


def reset_counters():
    for fn in KERNEL_FNS.values():
        fn.launches = 0
    for fn in TRACED_FNS.values():
        fn.traced_launches = 0


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
                ny: int = 0, dtype=torch.float32):
    """A non-periodic n^2 box (n x ny with ``ny``) with half-domain winds
    and a perturbed node state (a third of the nodes below the minimal
    state, dt spread over [1e-6, 3000] s): gather, reseed and off all fire.
    Returns (model, node planes, the remesh's particle planes, masks,
    coordinates and clock), in ``dtype`` (the float32 values widened)."""
    ny = ny or n
    comps, _, _, _ = perturbed_state(n, dev, seed, ny=ny)
    comps = tuple(c.to(dtype) for c in comps)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (ny - 1), ny, device=dev,
                         dtype=dtype)
    sett = ODESettings(log_energy_minimum=settings("bosh3").log_energy_minimum,
                       timestep=DT, dt=37.5, dtmin=1e-4, adaptive=adaptive,
                       solver="bosh3")
    m = WaveGrowth2D(grid, half_domain_winds(10.0, 5.0, 1e3 * (n - 1)), sett,
                     config=WaveGrowth2DConfig(periodic_boundary=False,
                                               boundary_type=boundary_type,
                                               dt_reset_mode="carry",
                                               remesh_mode="pallas",
                                               dtype=dtype))
    rng = np.random.default_rng(seed + 1)

    def plane(a):
        return torch.as_tensor(a.astype(np.float32), device=dev).to(dtype)

    low = plane(np.where(rng.uniform(size=(n, ny)) < 0.3,
                         rng.uniform(0, 1e-4, (n, ny)), 1.0))
    node = tuple((c * low).contiguous()
                 for c in TR.particle_to_node(*comps[:3]))
    dt = plane(np.exp(rng.uniform(np.log(1e-6), np.log(3000.0), (n, ny))))
    on = torch.as_tensor(rng.uniform(size=(n, ny)) < 0.8, device=dev)
    core = (*comps, dt, on, m.active_mask.contiguous(),
            m.boundary_mask.contiguous(), grid.x, grid.y,
            torch.full((), 1800.0, device=dev, dtype=dtype))
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


# ---------------------------------------------------------------------------
# the step's glue in the epilogues of K1 and K6 (the fused path)
# ---------------------------------------------------------------------------

EPILOGUE_REPLACES = {
    "K1 epilogue": "picles_tpu/ops/advance_pallas.py:50 and the step's glue "
                   "after it (picles_tpu/models/wave_growth_2d.py:438-484)",
    "K6 epilogue": "picles_tpu/ops/pic_pallas.py:375 and the step's stack "
                   "and branch counts after it "
                   "(picles_tpu/models/wave_growth_2d.py:595-607)"}
# the counters' slots each epilogue adds to (csrc/remesh.cuh): K1 the
# advance's, the guards' and the clamp's counts and substeps_max, K6 the
# remesh's branches
K1_SLOTS = (0, 1, 2, 3, 4, 5, 9, 10)
K6_SLOTS = (6, 7, 8)
# the epilogues' planes against the PyTorch glue's: within this share of
# each plane's largest value (the windsea's powers and exp evaluated in
# the kernel), float32 and float64
FUSED_RTOL = {torch.float32: 4e-7, torch.float64: 1e-15}
# the log energy of a lane made to fail: finite, but no substep down to
# dtmin meets the tolerance from it
FAIL_LNE = 20.0
EPILOGUE_STEPS = 4


def fire_guards(model, ms, seed: int = 0):
    """``ms`` with every guard of the step made to fire on some lanes while
    every plane the step computes stays finite: active lanes switched off
    (re-lit under the wind) holding NaN lne or an infinite cg_x, which the
    re-light resets; active inner lanes on holding lne = ``FAIL_LNE``,
    whose advance fails at dtmin where the solver does not force it (the
    deposit leaves them out); lanes displaced past the halo; and the
    log-energy maximum at the median of the lanes' log energy.  Returns
    (state, that maximum), for the model's settings."""
    P = ms.particles
    r = torch.rand((4, *P.lne.shape),
                   generator=torch.Generator().manual_seed(seed))
    r = r.to(P.lne.device)
    act = model.active_mask
    off = (r[0] < 0.1) & act
    lne, cgx, px = P.lne.clone(), P.cgx.clone(), P.px.clone()
    lne[off & (r[1] < 0.3)] = float("nan")
    cgx[off & (r[1] >= 0.3) & (r[1] < 0.6)] = float("inf")
    lne[~off & act & ~model.boundary_mask & (r[2] < 0.02)] = FAIL_LNE
    px[~off & (r[3] < 0.02)] = 5.0
    lemax = float(P.lne[P.on].median())
    return dataclasses.replace(ms, particles=dataclasses.replace(
        P, on=P.on & ~off, lne=lne, cgx=cgx, px=px)), lemax


def assert_planes_close(tag: str, pairs, rtol: float, take=None) -> float:
    """Each (name, new, want) plane finite in both and within ``rtol`` of
    ``want``, or of ``want``'s largest value over the lanes ``take`` (all
    where None); returns the largest difference."""
    err = 0.0
    for name, a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype, f"{tag}: {name}"
        assert bool(torch.isfinite(a).all()) and bool(
            torch.isfinite(b).all()), f"{tag}: {name} not finite"
        top = b.abs().max() if take is None else b.abs()[take].max()
        err = max(err, assert_close(f"{tag} {name}", a, b, rtol,
                                    rtol * float(top)))
    return err


def assert_fused_equals_glue(tag: str, f, g, rtol: float) -> float:
    """The fused step's state ``f`` against the PyTorch glue's ``g`` from
    one state: bit for bit the counters, the flags, positions, clocks and
    dt, the model clock and iteration; the log energies, group velocities
    and node state finite in both and within ``rtol`` of each plane's
    largest value.  Returns the largest difference of those planes."""
    for name in ("on", "px", "py", "t", "dt"):
        a, b = getattr(f.particles, name), getattr(g.particles, name)
        assert torch.equal(bits(a), bits(b)), f"{tag}: {name} differs"
    assert torch.equal(bits(f.time), bits(g.time)), f"{tag}: time differs"
    assert torch.equal(f.iteration, g.iteration), f"{tag}: iteration"
    for a, b in zip(f.metrics.leaves(), g.metrics.leaves()):
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape \
            and torch.equal(a, b), \
            f"{tag}: counters {f.metrics.as_dict()} vs {g.metrics.as_dict()}"
    return assert_planes_close(tag, [
        (name, getattr(f.particles, name), getattr(g.particles, name))
        for name in ("lne", "cgx", "cgy")] + [("state", f.state, g.state)],
        rtol)


def epilogue_model(n: int, dev, **modes):
    """The flagship box with the fused remesh (the benchmark's box step) at
    n^2 under a solver that does not force dtmin, so that a lane can fail
    (``fire_guards``); ``modes`` replaces its modes."""
    return flagship_model(n, dev, tols=dict(force_dtmin=False),
                          **{"remesh_mode": "fused", **modes})


def k6_epilogue_bound(n: int, halo) -> dict:
    """K6 with its epilogue on one float32 layer of ``n`` nodes under an
    analytic wind, one particle a node: per source 5 float planes and the
    mask (21 bytes), per node the state written (12), the remesh's six
    planes, three masks and the node x read (31) and its six planes and
    ``on`` written (25), no branch plane: 89 bytes; operations as
    ``deposit_bound``'s."""
    (xl, xh), (yl, yh) = normalize_halo(halo)
    cells = (xl + xh + 1) * (yl + yh + 1)
    return bound(89.0 * n, (13.0 + 11.0 * cells + 60.0) * n)


def step_ops(fn, tries: int = 5) -> int:
    """Device ops of one eager step ``fn`` in a torch.profiler trace that
    holds the step's K1 and K6 launches, taken again with more host idle
    on both sides (``trace_pad_s``) where a trace lost them, as one late in
    a process does (``device_ops`` read 0 ops of a fused step there)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        pad = trace_pad_s(attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_head(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if all(any(kernel_named(KERNEL_KEYS[k], e.name) for e in dev)
               for k in ("K1", "K6")):
            return device_op_count(prof)
        log("epilogue", f"step trace {attempt + 1}: no K1 or K6 launch; "
                        f"{trace_head_held(dev)}")
    raise AssertionError(f"none of {tries} traces held the step's K1 and "
                         f"K6 launches")


def phase_epilogue(dev, results, timing) -> None:
    """K1 and K6 with their epilogues (the fused box step) at FLAG_N^2,
    each held against what it replaces from the same state, with no guard
    firing and with every guard firing (``fire_guards``): K1's against raw
    K1 and the step's PyTorch glue up to the deposit (``_advance_glue``);
    K6's, on the glue's deposit inputs, against raw K6, the stack of its
    node planes and the glue's branch counts; the counters, flags and
    positions bit for bit, the planes within ``FUSED_RTOL``; then the
    whole fused step against ``_step_glue``.  The epilogues' launches are
    counted over eager fused steps; each kernel is timed (its trace) in
    turns with its raw kernel, what it replaces and its plain version by
    CUDA events, beside its bound; an eager step of each path is counted
    in device ops and timed."""
    n = FLAG_N
    m = epilogue_model(n, dev)
    g, act, bnd = m.grid, m.active_mask, m.boundary_mask
    halo, p, proj = m.modes.halo, m.remesh_params, m.projection(g)
    sett = m.settings
    rtol = FUSED_RTOL[torch.float32]
    before = (advance_cuda.epilogue_launches,
              pic_gather_remesh.epilogue_launches)
    quiet = eager_steps(m, m.init_state(), EPILOGUE_STEPS)
    launches = (advance_cuda.epilogue_launches - before[0],
                pic_gather_remesh.epilogue_launches - before[1])
    assert launches == (EPILOGUE_STEPS,) * 2, \
        f"epilogue launches {launches} in {EPILOGUE_STEPS} fused steps"
    err1 = err_step = 0.0
    for case in ("quiet", "fired"):
        ms = quiet
        if case == "fired":
            ms, lemax = fire_guards(m, quiet)
            m.settings = dataclasses.replace(sett, log_energy_maximum=lemax)
        P = ms.particles
        wf = m.wind_fields(g, ms.time)
        a = m._advance_glue(ms, g, act, bnd, wf, proj)
        core = (a.lne, a.cgx, a.cgy, a.px, a.py, a.dt, a.on, act, bnd, g.x,
                g.y, ms.time)
        node, rm, st = pic_gather_remesh(a.px, a.py, a.chans, a.scatter_on,
                                         g.stats, halo, p, *core,
                                         wind_fields=wf)
        want = torch.stack(m._build_metrics(
            None, adv=a.adv, failed=a.failed, nan_mask=a.nan_mask,
            inf_mask=a.inf_mask, emax_mask=a.emax_mask, relight=a.relight,
            gather=(rm.branch & GATHER_BIT) != 0,
            reseed=(rm.branch & RESEED_BIT) != 0,
            off=((rm.branch & OFF_BIT) != 0) & a.on, clamped=st.clamped,
            naccept=a.naccept).leaves()).tolist()

        c1 = torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev)
        k = advance_cuda(m.winds, m.consts, m.flags, m.solver, DT,
                         (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, P.dt, None,
                         g.x, g.y, proj, wind_fields=wf,
                         guards=Guards(P.on, act, bnd, p,
                                       m.settings.log_energy_maximum, halo,
                                       c1))
        tag = f"K1 epilogue {FLAG_N}^2 {case}"
        for name, x, y in (("x", k.x, a.px), ("y", k.y, a.py), ("t", k.t, a.t),
                           ("dt", k.dt, a.dt), ("on", k.on, a.on),
                           ("scatter_on", k.scatter_on, a.scatter_on)):
            assert torch.equal(bits(x), bits(y)), f"{tag}: {name} differs"
        # a failed lane keeps its large log energy, which the deposit
        # leaves out: each plane's scale is that of the deposited lanes
        err1 = max(err1, assert_planes_close(tag, [
            ("lne", k.lne, a.lne), ("cgx", k.cgx, a.cgx),
            ("cgy", k.cgy, a.cgy), ("e", k.e, a.chans[0]),
            ("m_x", k.m_x, a.chans[1]), ("m_y", k.m_y, a.chans[2])], rtol,
            a.scatter_on))
        got = c1.tolist()
        assert [got[i] for i in K1_SLOTS] == [want[i] for i in K1_SLOTS] \
            and not any(got[i] for i in K6_SLOTS), \
            f"{tag}: counters {got}, the glue's {want}"

        c6 = torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev)
        S6, rm6, none = pic_gather_remesh(
            a.px, a.py, a.chans, a.scatter_on, g.stats, halo, p, *core,
            wind_fields=wf, counters=c6)
        tag6 = f"K6 epilogue {FLAG_N}^2 {case}"
        assert none is None and rm6.branch is None, tag6
        assert bool(torch.isfinite(S6).all()), f"{tag6}: state not finite"
        assert torch.equal(bits(S6), bits(torch.stack(node, dim=-1))), \
            f"{tag6}: node state differs from K6's planes stacked"
        for fld in rm._fields[:-1]:
            assert torch.equal(bits(getattr(rm6, fld)),
                               bits(getattr(rm, fld))), f"{tag6}: {fld}"
        got = c6.tolist()
        assert [got[i] for i in K6_SLOTS] == [want[i] for i in K6_SLOTS] \
            and not any(got[i] for i in K1_SLOTS), \
            f"{tag6}: counters {got}, the glue's {want}"

        f = m._step_fused(ms, g, act, bnd)
        gs = m._step_glue(ms, g, act, bnd)
        err_step = max(err_step, assert_fused_equals_glue(
            f"fused step {FLAG_N}^2 {case}", f, gs, rtol))
        c = f.metrics.as_dict()
        fired = {key: c[key] for key in (
            "n_failed", "n_nan_reset", "n_inf_reset", "n_emax_clamp",
            "n_relight", "n_clamped")}
        assert all((v > 0) == (case == "fired") for v in fired.values()), c
        if case == "quiet":
            assert_state_bitwise(f"fused step {FLAG_N}^2 quiet", f, gs)
        log("epilogue", f"{FLAG_N}^2 {case}: K1's epilogue equals raw K1 + "
                        f"the PyTorch glue (flags, positions, clocks, "
                        f"counters bit for bit), K6's equals raw K6 + the "
                        f"stack and branch counts bit for bit, the fused "
                        f"step the glue step; counters {c}")
    m.settings = sett
    results["K1 epilogue"].update(launches=launches[0], max_abs_err=err1)
    results["K6 epilogue"].update(launches=launches[1], max_abs_err=0.0)
    timing["epilogue_step_max_abs_err"] = err_step

    # timing on the quiet state, the benchmark's
    ms = quiet
    P = ms.particles
    wf = m.wind_fields(g, ms.time)
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    adv = P.on & act

    def k1_raw():
        return advance_cuda(m.winds, m.consts, m.flags, m.solver, DT, comps,
                            P.t, P.dt, adv, g.x, g.y, proj, wind_fields=wf)

    def k1_epi():
        c = torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev)
        return advance_cuda(m.winds, m.consts, m.flags, m.solver, DT, comps,
                            P.t, P.dt, None, g.x, g.y, proj, wind_fields=wf,
                            guards=Guards(P.on, act, bnd, p,
                                          sett.log_energy_maximum, halo, c))

    plain = epilogue_model(n, dev, advance_mode="torch")
    r1 = kernel_ms(k1_raw, "K1", 10, row="K1 epilogue")
    e1 = kernel_ms(k1_epi, "K1", 10, row="K1 epilogue")
    e2 = kernel_ms(k1_epi, "K1", 10, row="K1 epilogue")
    r2 = kernel_ms(k1_raw, "K1", 10, row="K1 epilogue")
    sol = integrate_to(m.rhs, torch.stack(comps, dim=-1), P.t, P.t + DT,
                       P.dt, m.aux, adv, m.solver)
    results["K1 epilogue"].update(
        ms=(e1 + e2) / 2, raw_ms=(r1 + r2) / 2,
        replaced_ms=cuda_time_ms(
            lambda: m._advance_glue(ms, g, act, bnd, wf, proj), 10),
        plain_ms=cuda_time_ms(lambda: plain._advance_glue(
            ms, plain.grid, plain.active_mask, plain.boundary_mask, (),
            None), 2),
        **k1_bound(n * n, m.solver.method, m.solver.adaptive, adv,
                   sol.naccept + sol.nreject, epilogue=True))

    a = m._advance_glue(ms, g, act, bnd, wf, proj)
    core = (a.lne, a.cgx, a.cgy, a.px, a.py, a.dt, a.on, act, bnd, g.x, g.y,
            ms.time)

    def remesh_counts(branch):
        return [torch.sum(b, dim=(-2, -1)) for b in (
            (branch & GATHER_BIT) != 0, (branch & RESEED_BIT) != 0,
            ((branch & OFF_BIT) != 0) & a.on)]

    def k6_raw():
        return pic_gather_remesh(a.px, a.py, a.chans, a.scatter_on, g.stats,
                                 halo, p, *core, wind_fields=wf)

    def k6_epi():
        c = torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev)
        return pic_gather_remesh(a.px, a.py, a.chans, a.scatter_on, g.stats,
                                 halo, p, *core, wind_fields=wf, counters=c)

    def k6_replaced():
        nd, rm, _ = k6_raw()
        return torch.stack(nd, dim=-1), remesh_counts(rm.branch)

    def k6_plain():
        S, _ = scatter_dense(a.px, a.py, torch.stack(a.chans, -1),
                             a.scatter_on, g.stats, halo)
        rm = remesh_core(p, tuple(S[..., i] for i in range(3)), *core)
        return S, remesh_counts(rm.branch)

    r1 = kernel_ms(k6_raw, "K6", 20, row="K6 epilogue")
    e1 = kernel_ms(k6_epi, "K6", 20, row="K6 epilogue")
    e2 = kernel_ms(k6_epi, "K6", 20, row="K6 epilogue")
    r2 = kernel_ms(k6_raw, "K6", 20, row="K6 epilogue")
    results["K6 epilogue"].update(
        ms=(e1 + e2) / 2, raw_ms=(r1 + r2) / 2,
        replaced_ms=cuda_time_ms(k6_replaced, 10),
        plain_ms=cuda_time_ms(k6_plain, 5),
        **k6_epilogue_bound(n * n, halo))
    for key in EPILOGUE_REPLACES:
        r = results[key]
        log("kernel-time", f"{key}: {r['ms']:.4f} ms, raw kernel "
                           f"{r['raw_ms']:.4f} ms (in turns), replaced "
                           f"{r['replaced_ms']:.4f} ms, plain "
                           f"{r['plain_ms']:.4f} ms, bound "
                           f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    step = dict(fused_ops=step_ops(lambda: m._step_fused(ms, g, act, bnd)),
                glue_ops=step_ops(lambda: m._step_glue(ms, g, act, bnd)),
                fused_ms=cuda_time_ms(lambda: m._step_fused(ms, g, act, bnd),
                                      10),
                glue_ms=cuda_time_ms(lambda: m._step_glue(ms, g, act, bnd),
                                     10))
    timing["epilogue_step"] = step
    log("epilogue", f"{FLAG_N}^2 eager step: fused {step['fused_ops']} "
                    f"device ops, {step['fused_ms']:.4f} ms; PyTorch glue "
                    f"{step['glue_ops']} ops, {step['glue_ms']:.4f} ms "
                    f"(device, CUDA events)")


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
    host = all_counters()
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
                 "K6": per, "K7": 0}, c
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
        assert c == dict(want, K4=0, K7=0), (rm, c)
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
    launches = all_counters()
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


SHARDED_GRAPH_STEPS = 5   # steps a graphed sharded step is held bit for bit
SHARDED_TURNS = (8, 10)   # in-turns timing: 8 turns of 10 steps each way


def sharded_graph_check(tag: str, sh, ms, rows: dict, results) -> dict:
    """The sharded step ``sh`` (over NCCL, graphed) from ``ms``:
    ``step_n_quiet``, ``step_n``'s rows and ``step_jit`` twice bit for bit
    its eager steps over SHARDED_GRAPH_STEPS steps (the eager steps, the
    warm-up and the capture counted by the launch counters, set to 0 just
    before and read just after: each kernel of ``rows`` SHARDED_GRAPH_STEPS
    + WARMUP_STEPS + 1 times), then the same steps through
    ``Simulation.run`` under a trace (``traced_run``: the capture exists,
    so the host calls no kernel), bit for bit too, with each kernel of
    ``rows`` (kernels line row -> kernel id) counted by name into its row's
    ``graph_launches`` and ``launches``.  Returns the counters, the
    trace's counts and its stats."""
    n = SHARDED_GRAPH_STEPS
    assert sh.graphed, tag
    reset_counters()
    eager = [ms]
    for _ in range(n):
        eager.append(sh.step(eager[-1]))
    assert_state_bitwise(f"{tag}: step_n_quiet({n}) graphed",
                         sh.step_n_quiet(ms, n), eager[-1])
    fin, stack = sh.step_n(ms, n)
    assert_state_bitwise(f"{tag}: step_n graphed", fin, eager[-1])
    assert_bitwise(f"{tag}: step_n's stack", stack,
                   [e.state for e in eager[1:]])
    f = sh.step_jit()
    assert_state_bitwise(f"{tag}: step_jit twice", f(f(ms)), eager[2])
    c = all_counters()
    for row, k in rows.items():
        assert c[k] == n + WARMUP_STEPS + 1, (tag, c)
        results[row]["launches"] += c[k]
    DTm = float(sh.settings.timestep)
    it0 = int(ms.iteration)
    sim, got, stats = traced_run(sh, (it0 + n - 1) * DTm,
                                 {k: n for k in set(rows.values())}, state=ms)
    assert_state_bitwise(f"{tag}: Simulation.run graphed", sim.state,
                         eager[-1])
    for row, k in rows.items():
        results[row]["graph_launches"] = \
            results[row].get("graph_launches", 0) + got[k]
        results[row]["launches"] += got[k]
    log("sharded-graph", f"{tag}: graphed replays bit for bit {n} eager "
                         f"steps (step_n_quiet, step_n rows, step_jit, "
                         f"Simulation.run); launches by trace {got}; replay "
                         f"trace: idle share {stats['idle_share']:.4f}, "
                         f"{stats['device_ops_per_step']:.1f} device ops a "
                         f"step; the host's calls {c}")
    return dict(launches=c, launches_by_trace=got, trace=stats)


def phase_sharded_1x1(dev, gw, results, timing):
    """This slice's main path: the flagship at FLAG_N^2 through
    ShardedWaveGrowth2D on a (1, 1) mesh, NCCL at world size 1, with the
    K5 remesh (K1 -> K4 -> self-wrap fold -> K5, the counters' two
    all-reduces), graphed.  3 eager steps, the counters reset just before
    and read just after, against the single-device step (K2 in place of K4
    and the fold); the graphed step bit for bit its eager steps
    (``sharded_graph_check``: the drivers and ``Simulation.run``, counted
    by trace), then 20 steps through ``Simulation.run`` (graphed, traced);
    then, out of the counted runs, the graphed sharded step, the eager
    sharded step and the graphed single-device step in turns, 10 steps at
    a time, 8 times each (CUDA events)."""
    n = FLAG_N
    model = flagship_model(n, dev, remesh_mode="pallas")
    ref = model.step_n_quiet(model.init_state(), 3)
    init_distributed(0, 1, "nccl", free_port())
    try:
        sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
        assert model.graphed and sh.graphed   # both replay a CUDA graph
        log("sharded-1x1", f"transport: {sh.transport}; graphed")
        reset_counters()
        ms = eager_steps(sh, sh.init_state(), 3)
        err = assert_states("sharded 1x1 vs single device, 3 steps", ms, ref)
        c = counters()
        assert c["K1"] == c["K4"] == c["K5"] == 3, c
        assert c["K2"] == 0 and c["K6"] == 0, c
        results["K4"]["launches"] = c["K4"]
        rows = {"K1": "K1", "K4": "K4", "K5": "K5"}
        graph = sharded_graph_check("sharded 1x1 pallas", sh, ms, rows,
                                    results)
        sim, got, _ = traced_run(sh, (3 + 20 - 1) * DT,
                                 {"K1": 20, "K4": 20, "K5": 20}, state=ms)
        ms = sim.state
        m = check_state("sharded 1x1", ms, n_failed=0, n_clamped=0)
        for k in rows:
            results[k]["graph_launches"] = \
                results[k].get("graph_launches", 0) + got[k]
            results[k]["launches"] += got[k]
        runs = {"sharded graphed": [], "sharded eager": [],
                "single graphed": []}
        order = list(runs)
        for rep in range(SHARDED_TURNS[0]):
            for who in order[rep % 3:] + order[:rep % 3]:
                if who == "single graphed":
                    ref, t = time_steps(model, ref, SHARDED_TURNS[1])
                else:
                    ms, t = time_steps(sh, ms, SHARDED_TURNS[1],
                                       eager=who == "sharded eager")
                runs[who].append(t)
        sh.release_graph()
        model.release_graph()
        del ms, ref, sim
        torch.cuda.empty_cache()
        phase_sharded_layers(dev, gw, results, timing)
        phase_sharded_tripolar(dev, results, timing)
        phase_sharded_jet(dev, results, timing)
        phase_sharded_pulse(dev, results, timing)
        phase_sharded_f64(dev, results)
    finally:
        dist.destroy_process_group()
    med = {k: float(np.median(v)) for k, v in runs.items()}
    ms_step = med["sharded graphed"]
    timing["sharded_1x1_ms_per_step"] = ms_step
    timing["sharded_1x1_pushes_per_s"] = n * n / (ms_step / 1e3)
    timing["sharded_1x1_eager_ms_per_step"] = med["sharded eager"]
    timing["single_pallas_graphed_ms_per_step"] = med["single graphed"]
    timing["sharded_1x1_turns"] = runs
    timing["sharded_1x1_graph"] = graph
    log("sharded-1x1", f"3 steps vs single device: max abs err {err:.3e}, "
                       f"counters equal; 20 graphed steps through "
                       f"Simulation.run, launches by trace {got}; metrics "
                       f"{m}")
    log("sharded-1x1", f"{n}^2: graphed {ms_step:.4f} ms/step "
                       f"({n * n / (ms_step / 1e3):.4e} pushes/s), eager "
                       f"{med['sharded eager']:.4f}, the single-device "
                       f"pallas step graphed {med['single graphed']:.4f} "
                       f"(medians of {SHARDED_TURNS[0]} x "
                       f"{SHARDED_TURNS[1]} steps each in turns, CUDA "
                       f"events)")


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

    # (b) the sharded flagship step (gloo stages through host memory: the
    # drivers loop)
    model = flagship_model(n, dev, remesh_mode="pallas")
    sh = ShardedWaveGrowth2D(model, mesh)
    assert model.graphed and not sh.graphed, "a gloo sharded step graphed"
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

    # (e) the global jet at 1 degree ("pallas"): each block forms its own
    # node planes from the callable
    jm = jet_model(tgrid, "pallas", tols=SHARDED_TRI_TOLS)
    jsh = ShardedWaveGrowth2D(jm, mesh)
    ms = eager_steps(jsh, jsh.init_state(), 3)
    sx, sy = jsh._slices
    assert jm._node_planes[0] is jsh.local_grid
    assert torch.equal(jm._node_planes[1],
                       jet_model(tgrid, "pallas").node_planes(tgrid)[
                           :, sx, sy])
    whole = jsh.gather_state(ms)
    if root:
        ref = eager_steps(jm, jm.init_state(), 3)
        err = assert_states("2x2 jet pallas vs single device, 3 steps",
                            whole, ref)
        m = check_tripolar("2x2 jet pallas", jm, whole)
        res["jet_pallas_max_abs_err"] = err
        log("sharded-2x2", f"global jet pallas {tgrid.nx} x {tgrid.ny} on a "
                           f"(2, 2) mesh, each block's node planes its own "
                           f"slice of the jet: 3 steps vs single device max "
                           f"abs err {err:.3e}, counters equal; metrics {m}")
    if root:
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    return 0


def trace_window(run, steps: int, want: dict, attempts: int = 4):
    """A ``torch.profiler`` trace of ``run()`` (``steps`` steps): device
    busy time (the union of the device ops), idle share of the traced
    window, device ops and time by name per step.  ``want`` maps
    KERNEL_KEYS names to the launches a complete trace holds; a trace
    missing any (late in a process a trace can lose device events) is
    taken again, up to ``attempts`` times.  Each trace opens with
    ``trace_head`` (its spin kernel left out of the stats) and pads the run
    with the host idle on both sides (``trace_pad_s``).  Returns (stats,
    the kernels' counts)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        pad = trace_pad_s(attempt - 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_head(pad)
            run()
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        head = trace_head_held(dev)
        dev = [e for e in dev if TRACE_HEAD not in e.name]
        got = {k: sum(kernel_named(k, e.name) for e in dev) for k in want}
        if got == want:
            break
        log("trace", f"trace {attempt} (host idle {pad:.2f} s each side) "
                     f"holds {got} of {want} launches; {head}; taken again")
    assert got == want, \
        f"no complete trace in {attempts} attempts: {got} of {want}"
    if attempt > 1:
        log("trace", f"trace {attempt} (host idle {pad:.2f} s each side) "
                     f"holds all {want} launches")
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
    flagship through ShardedWaveGrowth2D on a (1, 1) NCCL mesh, eager and
    graphed.  Each capture is freed before the next configuration."""
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
        sh = ShardedWaveGrowth2D(
            flagship_model(n, "cuda", remesh_mode="pallas"),
            make_mesh((1, 1)))
        assert sh.graphed
        res["sharded_1x1_pallas"] = profile_config(
            "sharded 1x1 pallas", sh, 7, eager=True)
        res["sharded_1x1_pallas_graphed"] = profile_config(
            "sharded 1x1 pallas graphed", sh, 7, eager=False)
        sh.release_graph()
        del sh
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def phase_profile_process(path: str) -> None:
    """``phase_profile`` in a process of its own (the script with
    ``--profile-child``), started after the build and waited for: a
    process that has run NCCL and a few dozen profiler sessions can miss
    launches in a trace (one of 5 K1 launches in every step trace after
    the graphs and layers phases; every K1 launch of a later kernel trace
    after the profile), so the profile and the other phases' traces never
    share a process.  Raises if the process fails."""
    sys.stdout.flush()
    sys.stderr.flush()
    code = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--profile-child", path]).returncode
    if code != 0:
        raise RuntimeError(f"the profile process exited with {code}")


def phase_1d_traces(path: str) -> None:
    """The 1D days' replays under a trace, in a process of their own
    (``phase_1d_traces_process``): late in a long process a trace of 12
    replays held 11 K7 launches, in every attempt, on an H100.  For
    B01 (the node kind, K7) and the storm (``b01_storm_model``, K7 traced):
    the two graphed days (``b01_day``), then K7_TRACED_STEPS more steps of
    ``Simulation.run`` under a trace (``traced_run``: every launch by
    name, the host's counters 0), bit for bit as many eager steps, counted.
    Writes each kernel's launches by trace and eager and the trace's stats
    (idle share, device ops a step) to ``path``."""
    dev = torch.device("cuda", 0)
    out = {}
    for key, make in (("K7", b01_model), ("K7 traced", b01_storm_model)):
        model = make(dev)
        assert model.graphed and model.advance_mode == "cuda", key
        sim, _, _ = b01_day(model)
        traced, got, stats = traced_run(
            model, (B01_STEPS + K7_TRACED_STEPS - 1) * DT,
            {key: K7_TRACED_STEPS}, state=sim.state)
        reset_counters()
        assert_state_bitwise(f"1d {key}: the traced replays against as "
                             f"many eager steps", traced.state,
                             eager_steps(model, sim.state, K7_TRACED_STEPS))
        eager = all_counters()[key]
        assert eager == K7_TRACED_STEPS, (key, eager)
        out[key] = dict(stats, by_trace=got[key], eager=eager)
        model.release_graph()
        del model, sim, traced
    with open(path, "w") as f:
        json.dump(out, f)


def phase_1d_traces_process() -> dict:
    """``phase_1d_traces`` in a process of its own (the script with
    ``--trace-1d-child``), started after the build and waited for, as
    ``phase_profile_process`` is; returns what it wrote.  Raises if the
    process fails."""
    sys.stdout.flush()
    sys.stderr.flush()
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)   # git-ignored
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "traces_1d.json")
        code = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--trace-1d-child", path]).returncode
        if code != 0:
            raise RuntimeError(f"the 1D traces' process exited with {code}")
        with open(path) as f:
            out = json.load(f)
    for key, r in out.items():
        log("1d", f"{key}: {K7_TRACED_STEPS} replays of the B01 day's end "
                  f"in a process of their own, launches by trace "
                  f"{r['by_trace']}, bit for bit {r['eager']} eager steps; "
                  f"idle share {r['idle_share']:.4f}, "
                  f"{r['device_ops_per_step']:.1f} device ops a step")
    return out


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


def probe_k7(sass: dict) -> dict:
    """K7's design measurements on the 2^20-lane probe (``k7_probe``):
    the SASS of one substep (the outermost loop of each instance, of the
    new kernel and of ``_simple``; the storm's traced library's too) turned
    into the time a warp's instructions take to issue (count x warps /
    (132 SMs x 4 schedulers x the SM clock)); fixed substeps of DT / m, m =
    1, 2, 5, 10, 30, each bit for bit ``_simple`` and timed (``kernel_ms``),
    the cost a substep the slope; adaptive tsit5 and bosh3 under the node
    kind and tsit5 under the storm in turns with ``_simple``; and the lanes'
    divergence (``warp_divergence``: the slowest lane of a warp over the
    warp's mean, from the plain version's substeps tried and from K7's
    accepted ones) on the probe and on B01 at K7_WIDE_NODES nodes after 12
    steps."""
    dev = torch.device("cuda", 0)
    storm_k = traced_kernel_1d(Winds1D(u=storm_u), dev)
    tb = cuda_build.build_traced(storm_k.traced)
    for ln in tb.log.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            print("  ptxas (the storm's K7)|", ln.strip(), flush=True)
    cuobj = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    tsass = subprocess.run([cuobj, "-sass", str(tb.path)],
                           capture_output=True, text=True, check=True).stdout
    counts = {**sass_loop_count(sass, "advance_1d_kernel"),
              **sass_loop_count(sass, "advance_1d_simple_kernel"),
              **{"traced " + k: v for k, v in
                 sass_loop_count(tsass, "advance_1d").items()}}
    clocks = smi_clocks()
    mhz = float(clocks.split(",")[1].split()[0])
    model = b01_model(dev)
    z, t, dt, act, x, plane, rec = k7_probe(dev)
    warps = z.shape[0] / 32
    out = {"sass": counts, "clocks": clocks,
           "issue_ms_a_substep": {
               k: v.get("loop_instructions", 0) * warps
               / (132 * 4 * mhz * 1e6) * 1e3 for k, v in counts.items()}}
    for k, v in counts.items():
        log("probe", f"K7 SASS {k[:72]}: {v}")
    sweep = {}
    for method in ("tsit5", "bosh3"):
        for m in (1, 2, 5, 10, 30):
            cfg = SolverConfig(method=method, adaptive=False)
            d = torch.full_like(dt, DT / m)
            a = (plane, model, cfg, z, t, d, act, x)
            assert_bitwise(f"K7 probe {method} fixed {m}", k7_launch(*a),
                           k7_launch(*a, simple=True))
            sweep[f"{method} {m}"] = kernel_ms(lambda: k7_launch(*a), "K7",
                                               10)
        per = (sweep[f"{method} 30"] - sweep[f"{method} 1"]) / 29
        sweep[f"{method} ms a substep"] = per
        times = [round(sweep[f"{method} {m}"], 4) for m in (1, 2, 5, 10, 30)]
        log("probe", f"K7 {method} fixed substeps 1/2/5/10/30: {times} ms; "
                     f"{per:.5f} ms a substep")
    out["fixed_sweep"] = sweep
    turns, div = {}, {}
    for tag, wind, method in (("node tsit5", plane, "tsit5"),
                              ("node bosh3", plane, "bosh3"),
                              ("storm tsit5", storm_k, "tsit5")):
        cfg = SolverConfig(method=method, adaptive=True, dtmin=1e-4,
                           force_dtmin=True)
        a = (wind, model, cfg, z, t, dt, act, x)
        k = k7_launch(*a)
        assert_bitwise(f"K7 probe {tag} adaptive", k,
                       k7_launch(*a, simple=True))
        key = "K7 traced" if wind is storm_k else "K7"
        s_ms, n_ms = turns_ms(key, lambda: k7_launch(*a, simple=True),
                              lambda: k7_launch(*a), 10)
        u = storm_u if wind is storm_k else (lambda xx, tt: plane)
        rhs = particle_equations_1d(u, gamma=model.constants.gamma,
                                    params=model.params,
                                    constants=model.constants)
        p = integrate_to(rhs, z, t, t + DT, dt, x, act, cfg)
        it = p.naccept + p.nreject
        turns[tag] = dict(simple_ms=s_ms, ms=n_ms, clocks=smi_clocks())
        div[f"probe {tag}"] = dict(
            plain=warp_divergence(it), k7=warp_divergence(k.naccept),
            warp_max_mean=float(it.reshape(-1, 32).max(1).values.double()
                                .mean()),
            live_mean=float(it[act].double().mean()))
        log("probe", f"K7 probe {tag} adaptive: _simple {s_ms:.4f} ms, new "
                     f"{n_ms:.4f} ms (bit for bit); divergence "
                     f"{div[f'probe {tag}']}")
    mw = b01_model(dev, nx=K7_WIDE_NODES)
    pw = eager_steps(mw, mw.init_state(), 12).particles
    wide = (pw.z.contiguous(), pw.t, pw.dt, pw.on & ~mw.boundary_mask,
            mw.grid.x)
    cfg = SolverConfig(method="tsit5", adaptive=True, dtmin=1e-4,
                       force_dtmin=True)
    k = k7_launch(mw._node_plane, mw, cfg, *wide)
    rhs = particle_equations_1d(lambda xx, tt: mw._node_plane,
                                gamma=mw.constants.gamma, params=mw.params,
                                constants=mw.constants)
    p = integrate_to(rhs, wide[0], wide[1], wide[1] + DT, wide[2], wide[4],
                     wide[3], cfg)
    it = p.naccept + p.nreject
    div[f"B01x{K7_WIDE_NODES} node tsit5"] = dict(
        plain=warp_divergence(it), k7=warp_divergence(k.naccept),
        live_mean=float(it[wide[3]].double().mean()))
    log("probe", f"K7 B01x{K7_WIDE_NODES} node tsit5 adaptive: divergence "
                 f"{div[f'B01x{K7_WIDE_NODES} node tsit5']}")
    out.update(turns=turns, divergence=div)
    return out


def phase_probe(path: str) -> None:
    """The measurements a kernel redesign rests on, each new kernel beside
    its ``_simple`` baseline (in turns, and held to it bit for bit): ptxas
    registers; the SASS of K1's substep loop and of K3's instances, and K3
    on the default state (``probe_k3``); K1 in fixed-substep mode on
    the default and flagship seed states at 1, 2, 5 and 10 substeps (per-lane
    fixed cost and cost per substep) and adaptive from the seed; K1's lane
    divergence on the perturbed 256^2 state and its time on the perturbed
    state at FLAG_N^2; K4 and K6 on the flagship's deposit; K7's
    (``probe_k7``).  Writes everything to ``path`` (and the SASS beside
    it)."""
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
    res["k7"] = probe_k7(sass)
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
        trace_head(trace_pad_s(0))
        ms = eager_steps(model, ms, steps)
        torch.cuda.synchronize()
    return device_op_count(prof) / steps, ms


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn`` in a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_head(trace_pad_s(0))
        fn()
        torch.cuda.synchronize()
    return device_op_count(prof)


def device_op_count(prof) -> int:
    """Device operations in a trace, its head (``trace_head``) left out."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and TRACE_HEAD not in e.name)


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


def cell_reach(active: np.ndarray, cells: int = 1) -> np.ndarray:
    """The nodes a CIC deposit of displacements under ``cells`` cells can
    reach from the ``active`` nodes of a tripolar grid: the
    8-neighbourhood, x periodic, with the top row's seam mirror (a ghost
    row of the top row, x flipped) above it, grown ``cells`` times."""
    nx, ny = active.shape
    reach = active
    for _ in range(cells):
        ext = np.concatenate([reach, reach[(nx - 2 - np.arange(nx)) % nx,
                                           -1:]], axis=1)
        grown = np.zeros_like(ext)
        for dx in (-1, 0, 1):
            sh = np.roll(ext, dx, axis=0)
            grown |= sh
            grown[:, 1:] |= sh[:, :-1]
            grown[:, :-1] |= sh[:, 1:]
        reach = grown[:, :ny]
    return reach


def check_tripolar(tag: str, model, ms, dt: float = None) -> dict:
    """A finite state, no failed lane and no particle on land.  Energy
    reaches land only where a CIC deposit touches a land node one cell from
    an active node: at a concave coast corner a particle moving diagonally
    deposits on the land node between its two land neighbours (land
    boundary nodes are 4-neighbours of ocean), as picles_tpu's deposit
    does; that energy is logged and held below 1e-6 of the total.

    With the step ``dt``, where a step crosses more than a cell the rule is
    the halo's: at the active nodes whose cell is narrower (min(dx, dy))
    than the fastest particle of the state travels in a step (|cg| dt), a
    particle can move up to the halo's cells (beyond it the deposit clamps
    and counts), so its deposit reaches land nodes that far.  The energy on
    land within that reach of such a node is a property of the
    configuration's CFL number that picles_tpu's step shares
    (tests/test_torch_traced_winds.py
    ``test_pulse_crossing_polar_cells_matches_jax_on_land``): it is logged
    (``cfl_*``) and exempt from both rules; every other land node is held to
    them.  Returns the counters, with the land energy's share."""
    m = check_state(tag, ms, n_failed=0)
    land = model.grid.mask == 0
    assert not bool(ms.particles.on[land].any()), f"{tag}: a particle on land"
    e = ms.state[..., 0]
    land_np, e_np = land.cpu().numpy(), e.cpu().numpy()
    active = model.active_mask.cpu().numpy()
    exempt = np.zeros_like(land_np)
    if dt is not None:
        P = ms.particles
        on = P.on & model.active_mask
        v = float(torch.hypot(P.cgx, P.cgy)[on].max())
        width = torch.minimum(model.grid.dx_m, model.grid.dy_m).cpu().numpy()
        crossing = active & (width < v * dt)
        halo = max(max(p) for p in normalize_halo(model.config.halo))
        exempt = land_np & cell_reach(crossing, halo)
        lat = model.grid.y.cpu().numpy()
        beyond = exempt & ~cell_reach(active) & (e_np != 0)
        band = (lat >= lat[beyond].min()) & (lat <= lat[beyond].max()) \
            if beyond.any() else np.zeros_like(active)
        m.update(cfl_speed=v, cfl_step_m=v * dt,
                 cfl_crossing_nodes=int(crossing.sum()),
                 cfl_land_share=float(np.abs(e_np[exempt]).sum()
                                      / np.abs(e_np).astype(np.float64).sum()),
                 cfl_far_nodes=int(beyond.sum()),
                 cfl_far_lat=[float(lat[beyond].min()),
                              float(lat[beyond].max())] if beyond.any()
                 else [],
                 cfl_band_min_width_m=float(width[band & active].min())
                 if (band & active).any() else None)
    held = land & torch.as_tensor(~exempt, device=land.device)
    share = float(e[held].double().abs().sum() / e.double().abs().sum())
    far = land_np & ~exempt & ~cell_reach(active) & (e_np != 0)
    assert not far.any(), \
        f"{tag}: energy on {int(far.sum())} land nodes beyond one cell"
    assert share < 1e-6, f"{tag}: land holds {share:.3e} of the energy"
    m["land_energy_share"] = share
    m["land_nodes_with_energy"] = int((e[land] != 0).sum())
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
        graph = sharded_graph_check(
            f"sharded {L} layers, {tag}", sh, ms,
            {f"{k} layered": k for k in ("K1", "K4", "K5")}, results)
        sh.release_graph()
        out[tag] = dict(max_abs_err=err, bitwise=same, graph=graph,
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
# the 1D growth model: kernel K7 and the graphed step
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
              tols=None, dtype=torch.float32) -> WaveGrowth1D:
    """tests/test_model_1d_b01.py's ``_model``: open ends, the log-energy
    minimum of the 1D minimal windsea, dt = 1e-3, dtmin = 1e-4; the grid
    and the model in ``dtype``."""
    ws = FR.MinimalWindsea_1d(U10, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=2 * DAY, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True, **(tols or {}))
    return WaveGrowth1D(one_d_grid(0.0, Lx, nx, periodic=False, device=dev,
                                   dtype=dtype),
                        constant_winds_1d(U10), sett,
                        config=WaveGrowth1DConfig(periodic_boundary=False,
                                                  dtype=dtype))


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


K7_PROBE_LANES = 2 ** 20
# B01 on 2^16 nodes after 12 steps: the fixed-substep check at size, and
# tsit5's witness (``k7_witness``)
K7_WIDE_NODES = 2 ** 16
# fixed substeps: 30 a model step (at 37.5 s an ulp grew to 4e-4 on B01's
# youngest lane under a record's wind, on the card and in a host build
# against the CPU)
K7_FIXED_DT = 20.0
K7_SHARE = 0.99          # adaptive: lanes within rtol 5e-3
K7_ABS = 5e-6            # fixed substeps: lne and cg_x
K7_X_RTOL = 1e-6         # fixed substeps: x, absolute in meters
K7_TRACED_STEPS = 12
B01_TURNS = 2            # plain, graphed, graphed, plain


# K7's traced kind: the moving Gaussian storm of the Julia source's
# WindEmulator.jl:50-52 (picles_tpu/forcing/winds.py:438 slopped_blob),
# 15 m/s at its peak at 3 h, 80 km wide, passing over B01's 500 km from
# 100 km at 10 m/s; and the 1D pulse (12 m/s until PULSE_1D_STOP, then
# calm: tests/test_growing_decaying_winds.py:16-26 in 1D)
B01_STORM = dict(U10=15.0, V=10.0, T=6 * 3600.0, x_scale=80e3,
                 t_scale=7200.0, x0=100e3)
PULSE_1D_STOP = 7200.0
TRACED_1D_SWITCHES = (0.0, 3600.0, PULSE_1D_STOP, 10800.0)
REC_1D_STEPS = 3         # record_trajectories' steps under the storm


def storm_u(x, t):
    """``slopped_blob`` with B01_STORM."""
    return slopped_blob(x, t, **B01_STORM)


def pulse_1d_u(x, t):
    """The 1D pulse: 12 m/s from 0 to PULSE_1D_STOP, then calm."""
    t = torch.as_tensor(t)
    return torch.where((t >= 0.0) & (t < PULSE_1D_STOP), 12.0, 0.0) + 0.0 * x


def traced_1d_callables() -> dict:
    return {"slopped_blob": Winds1D(u=storm_u), "pulse": Winds1D(u=pulse_1d_u)}


def traced_1d_build(dev, winds: dict):
    """Each 1D callable traced on the card and its library (K7's traced
    instances, ``cuda_build.traced_library_1d``) built, all at once, then
    loaded; the storm's source compiled to PTX and checked for float64.
    Returns (name -> descriptor, the build's wall seconds)."""
    kerns = {k: traced_kernel_1d(w, dev) for k, w in winds.items()}
    assert all(k.kind == WindKind.TRACED and k.traced.one_d
               for k in kerns.values())
    traced = [k.traced for k in kerns.values()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(traced) + 1) as ex:
        builds = list(ex.map(cuda_build.build_traced, traced))
        bad = ex.submit(cuda_build.unexpected_double_ops,
                        kerns["slopped_blob"].traced).result()
    wall = time.perf_counter() - t0
    for tr in traced:
        cuda_build.traced_library_1d(tr)
    assert not bad, f"float64 in K7's traced instances: {bad}"
    regs = [ln.strip() for b in builds for ln in b.log.splitlines()
            if "registers" in ln or "spill" in ln]
    log("1d", f"{len(traced)} traced 1D libraries built in {wall:.1f} s (each "
              f"{[round(b.seconds, 1) for b in builds]} s); ptxas: "
              f"{' | '.join(sorted(set(regs)))}")
    return kerns, wall


def traced_probe_1d_check(dev, winds: dict, kerns: dict, n: int) -> dict:
    """Each emitted 1D function alone (``picles_traced_probe_1d``) on ``n``
    points (x, t), t exactly at each switch time and its float32
    neighbours among them, x zero of either sign, infinite or NaN at a few,
    bit for bit (NaN's bits too) the callable run by torch on the card, and
    the tracer's plain evaluator bit for bit too.  Returns name -> the
    emitted function's operation count."""
    rng = np.random.default_rng(43)
    xs = rng.uniform(-1e5, 6e5, n).astype(np.float32)
    xs[-5:] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    ts = rng.uniform(0.0, 3e4, n).astype(np.float32)
    sw = np.array(TRACED_1D_SWITCHES, np.float32)
    near = np.concatenate([sw, np.nextafter(sw, np.float32(-1e9)),
                           np.nextafter(sw, np.float32(1e9))])
    ts[:near.size] = near
    ts[near.size:near.size + 4096] = np.repeat(sw, 1024)
    x = torch.as_tensor(xs, device=dev)
    t = torch.as_tensor(ts, device=dev)
    out = {}
    for name, w in winds.items():
        tr = kerns[name].traced
        lib = cuda_build.traced_library_1d(tr)
        u = torch.empty_like(x)
        with torch.cuda.device(dev):
            code = lib.picles_traced_probe_1d(
                x.data_ptr(), t.data_ptr(), u.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check_status(code, "traced 1D probe")
        want = torch.broadcast_to(w.u(x, t), x.shape).contiguous()
        for what, got in (("the emitted function", u),
                          ("the plain evaluator", tr.evaluate(x, t)[0])):
            d = int((bits(got) != bits(want)).sum())
            assert d == 0, f"traced 1D {name}: {what} differs from the " \
                           f"callable on {d} of {n} points"
        out[name] = len(tr.ops)
        log("1d", f"{name}: the emitted traced_wind_1d ({len(tr.ops)} "
                  f"operations) and the plain evaluator bit for bit the "
                  f"callable on {n} points, the switch times among them")
    return out


def k7_record(dev, L: float = 500e3) -> GriddedWinds1D:
    """A 1D record over [0, L] and 15 h that varies in x and t (23 nodes,
    30 half-hourly frames), for K7's gridded kind."""
    rng = np.random.default_rng(9)
    return GriddedWinds1D(u_data=torch.as_tensor(
        rng.uniform(6.0, 12.0, (23, 30)).astype(np.float32), device=dev),
        x0=-10e3, dx=L / 20.0, t0=0.0, dt=1800.0)


def k7_wind(x: torch.Tensor) -> torch.Tensor:
    """The probe's steady wind along x: 10 +- 4 m/s over a 200 km wave."""
    return (10.0 + 4.0 * torch.sin(x * (2.0 * np.pi / 200e3))).to(
        torch.float32)


def k7_probe(dev, n: int = K7_PROBE_LANES, L: float = 500e3):
    """K7's probe of ``n`` lanes over [0, L] (x sorted, uniform): each lane
    the windsea of its local wind (``k7_wind``) perturbed in lne (sigma
    0.05) and cg_x (+-5%), at t = 0, 1 h or 1 day, dt over [1e-3, 300] s,
    90% active.  Its winds: the node plane (``k7_wind`` at the lanes), and
    a record of the same wind on 23 nodes every 25 km, with a 0.5 m/s tide
    over 6 h in 60 half-hourly frames.  Returns (z, t, dt, active, x,
    plane, record)."""
    rng = np.random.default_rng(31)

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    x = f(np.sort(rng.uniform(0.0, L, n)))
    plane = k7_wind(x).contiguous()
    ws = FR.get_initial_windsea_1d(plane, DT)
    z = torch.stack([ws.lne + f(rng.normal(0.0, 0.05, n)),
                     ws.cg_bar_x * f(rng.uniform(0.95, 1.05, n)), x],
                    dim=-1).contiguous()
    t = f(rng.choice([0.0, 3600.0, 86400.0], n))
    dt = f(rng.uniform(1e-3, 300.0, n))
    act = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    xr = f(np.arange(23) * (L / 20.0) - 10e3)
    tide = 0.5 * np.sin(2.0 * np.pi * np.arange(60) * 1800.0 / 21600.0)
    rec = GriddedWinds1D(u_data=(k7_wind(xr)[:, None] + f(tide)[None, :])
                         .contiguous(), x0=-10e3, dx=L / 20.0, t0=0.0,
                         dt=1800.0)
    return z, t, dt, act, x, plane, rec


def k7_launch(wind, model, cfg, z, t, dt, act, x, simple: bool = False):
    """One K7 call (``advance_1d``), its launch not counted."""
    counts = (advance_1d.launches, advance_1d.traced_launches)
    out = advance_1d(wind, model.consts, TermFlags(), cfg, DT, z, t, dt, act,
                     x, simple=simple)
    advance_1d.launches, advance_1d.traced_launches = counts
    return out


def k7_case(tag: str, model, wind, winds, method: str, adaptive: bool, z, t,
            dt, act, x, witness: bool = False) -> dict:
    """K7 (``advance_1d``) bit for bit its ``_simple`` baseline (the
    previous kernel) and against its plain version (``integrate_to`` over
    ``particle_equations_1d`` of the callable ``winds``) on the card, on
    the same inputs: fixed substeps of K7_FIXED_DT s with lne and cg_x
    within K7_ABS abs, x within K7_X_RTOL, t, dt, failed and naccept equal;
    adaptive by share of lanes (``assert_adaptive``, ``assert_controller``),
    failed and the end time equal.  With ``witness`` (the traced kind,
    whose wind moves across the lanes), fixed substeps beyond K7_ABS are
    held by ``k7_witness``'s rule where the float32 problem parts lanes:
    K7 no farther from the plain version run in float64 than twice the
    float32 plain version, plus K7_ABS.  The launches are not counted."""
    cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                       force_dtmin=True)
    if not adaptive:
        dt = torch.full_like(dt, K7_FIXED_DT)
    k = k7_launch(wind, model, cfg, z, t, dt, act, x)
    assert_bitwise(f"{tag}: K7 against _simple", k,
                   k7_launch(wind, model, cfg, z, t, dt, act, x, simple=True))
    rhs = particle_equations_1d(winds.u, gamma=model.constants.gamma,
                                params=model.params, constants=model.constants)
    p = integrate_to(rhs, z, t, t + DT, dt, x, act, cfg)
    torch.cuda.synchronize()
    if adaptive:
        assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
        errs = [assert_adaptive(f"{tag} {nm}", k.z[:, c], p.z[:, c])
                for c, nm in enumerate(("lne", "cg_x", "x"))]
        assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
        extra = (assert_controller(tag, k, p, act) if z.shape[0] >= 4096
                 else f"naccept equal on {int((k.naccept == p.naccept).sum())}"
                      f" of {z.shape[0]} lanes")
        err = max(errs[:2])
    else:
        err = max(max_abs(k.z[:, c], p.z[:, c]) for c in (0, 1))
        if witness and err > K7_ABS:
            q = integrate_to(rhs, z.double(), t.double(), t.double() + DT,
                             dt.double(), x.double(), act, cfg)

            def far(a):
                return float((a.z[:, :2].double() - q.z[:, :2]).abs().max())
            k64, p64 = far(k), far(p)
            beyond = int(((k.z[:, :2] - p.z[:, :2]).abs() > K7_ABS)
                         .any(-1).sum())
            assert k64 <= 2.0 * p64 + K7_ABS, (tag, err, k64, p64)
            extra = (f"{beyond} lanes beyond {K7_ABS} of the plain version, "
                     f"held by the witness rule: from float64 K7 "
                     f"{k64:.3e}, plain {p64:.3e}")
        else:
            err = max(assert_close(f"{tag} {nm}", k.z[:, c], p.z[:, c], 0.0,
                                   K7_ABS) for c, nm in ((0, "lne"),
                                                         (1, "cg_x")))
            extra = ""
        xe = assert_close(f"{tag} x", k.z[:, 2], p.z[:, 2], K7_X_RTOL, 0.0)
        for nm in ("t", "dt", "failed", "naccept"):
            assert torch.equal(getattr(k, nm), getattr(p, nm)), \
                f"{tag}: {nm} differs"
        extra = f"x max abs err {xe:.3e} m {extra}"
    log("K7", f"{tag}: bit for bit _simple; max abs err (lne, cg_x) "
              f"{err:.3e}, substeps max {int(k.naccept.max())}/"
              f"{int(p.naccept.max())}, failed {int(k.failed.sum())}; "
              f"{extra}")
    return dict(err=err, k=k, p=p, cfg=cfg, rhs=rhs, dt=dt)


def k7_witness(model, rec, z, t, dt, act, x) -> dict:
    """tsit5 under the record ``rec`` on B01's state at K7_WIDE_NODES nodes,
    where the float32 problem itself parts lanes: fresh seas reseeded for
    B01's 10 m/s under a record that blows harder there.  Fixed substeps of
    K7_FIXED_DT s and adaptive: K7 against its plain version; the plain
    version against itself with z one ulp up (``torch.nextafter``); both
    against the plain version in float64.  With fixed substeps K7 must be
    no farther from the float64 run than twice the float32 plain version,
    plus K7_ABS (a wrong read of the record parts every lane from it);
    the rest is logged.  K7 is bit for bit its ``_simple`` baseline.
    Launches are not counted."""
    rhs = particle_equations_1d(rec.u, gamma=model.constants.gamma,
                                params=model.params, constants=model.constants)
    z_up = torch.nextafter(z, torch.full_like(z, float("inf")))

    def lane_err(a, b):
        return (a.z[:, :2].double() - b.z[:, :2].double()).abs().amax(-1)

    def share(a, b):
        return float(torch.isclose(a.z[:, :2].double(), b.z[:, :2].double(),
                                   rtol=5e-3, atol=1e-4).all(-1).double()
                     .mean())

    out = {}
    for adaptive in (False, True):
        cfg = SolverConfig(method="tsit5", adaptive=adaptive, dtmin=1e-4,
                           force_dtmin=True)
        d = dt if adaptive else torch.full_like(dt, K7_FIXED_DT)
        k = k7_launch(rec, model, cfg, z, t, d, act, x)
        assert_bitwise(f"K7 witness {adaptive}: K7 against _simple", k,
                       k7_launch(rec, model, cfg, z, t, d, act, x,
                                 simple=True))
        p = integrate_to(rhs, z, t, t + DT, d, x, act, cfg)
        pu = integrate_to(rhs, z_up, t, t + DT, d, x, act, cfg)
        q = integrate_to(rhs, z.double(), t.double(), t.double() + DT,
                         d.double(), x.double(), act, cfg)
        e_kp, e_self = lane_err(k, p), lane_err(pu, p)
        r = dict(k_plain_max=float(e_kp.max()),
                 k_plain_lanes=int((e_kp > K7_ABS).sum()),
                 self_max=float(e_self.max()),
                 self_lanes=int((e_self > K7_ABS).sum()),
                 k_f64_max=float(lane_err(k, q).max()),
                 plain_f64_max=float(lane_err(p, q).max()),
                 share_k_plain=share(k, p), share_self=share(pu, p),
                 share_k_f64=share(k, q), share_plain_f64=share(p, q))
        mode = "adaptive" if adaptive else "fixed"
        log("K7", f"witness, B01 {z.shape[0]} lanes, tsit5 {mode}, record: "
                  f"K7 vs plain max {r['k_plain_max']:.3e} "
                  f"({r['k_plain_lanes']} lanes beyond {K7_ABS}, "
                  f"{r['share_k_plain']:.4%} within rtol 5e-3); plain vs "
                  f"plain with z one ulp up max {r['self_max']:.3e} "
                  f"({r['self_lanes']} lanes, {r['share_self']:.4%}); from "
                  f"float64: K7 {r['k_f64_max']:.3e} "
                  f"({r['share_k_f64']:.4%}), plain {r['plain_f64_max']:.3e} "
                  f"({r['share_plain_f64']:.4%})")
        if not adaptive:
            assert r["k_f64_max"] <= 2.0 * r["plain_f64_max"] + K7_ABS, r
        out[mode] = r
    return out


def warp_divergence(iters: torch.Tensor) -> float:
    """The mean over warps (32 lanes in order, those with any work) of the
    slowest lane's substeps over the warp's mean: how much longer a warp
    runs than its lanes' work needs."""
    w = iters.reshape(-1, 32).double()
    mean = w.mean(dim=1)
    keep = mean > 0
    return float((w.max(dim=1).values[keep] / mean[keep]).mean())


def k7_pulse_anchor(dev, model, kern, probe) -> dict:
    """Before the 1D pulse's stop its wind is 12 m/s at every node and
    stage time, so traced K7 (the pulse's library) must equal the node kind
    of ``constant_winds_1d(12)`` (its node plane) bit for bit: on B01's
    state at 3600 s (6 steps from the seed: every stage time of the step
    before 7200 s) and on the probe's lanes started at t = 0, bosh3 and
    tsit5, fixed substeps and adaptive.  Returns the lanes compared."""
    st = eager_steps(model, model.init_state(), 6).particles
    assert float(st.t.max()) <= PULSE_1D_STOP - DT, float(st.t.max())
    z, t, dt, act, x = probe[:5]
    cases = {"B01 at 3600 s": (st.z.contiguous(), st.t, st.dt,
                               st.on & ~model.boundary_mask, model.grid.x),
             "probe at 0 s": (z, torch.zeros_like(t), dt, act, x)}
    lanes = 0
    for name, (z, t, dt, act, x) in cases.items():
        plane = steady_node_plane_1d(constant_winds_1d(12.0), x)
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cfg = SolverConfig(method=method, adaptive=adaptive,
                                   dtmin=1e-4, force_dtmin=True)
                d = dt if adaptive else torch.full_like(dt, K7_FIXED_DT)
                assert_bitwise(
                    f"K7 traced pulse vs constant_winds_1d(12), {name}, "
                    f"{method} {'adaptive' if adaptive else 'fixed'}",
                    k7_launch(kern, model, cfg, z, t, d, act, x),
                    k7_launch(plane, model, cfg, z, t, d, act, x))
        lanes += int(act.sum())
    log("K7", f"the 1D pulse traced before its stop bit for bit the node "
              f"kind of constant_winds_1d(12) ({', '.join(cases)}: "
              f"{lanes} active lanes, bosh3 and tsit5, fixed and adaptive)")
    return dict(lanes=lanes)


def phase_k7(dev, model, state, kerns, winds, results) -> dict:
    """K7 against its plain version on the card and bit for bit its
    ``_simple`` baseline (``k7_case``): the node, gridded and traced
    kinds (the traced wind ``slopped_blob``, B01_STORM), bosh3 and tsit5:
    fixed substeps and adaptive on the B01 model's state (``state``, 31
    lanes; the record ``k7_record``); adaptive on the 2^20-lane probe
    (``k7_probe``: its young seas are stiff for any fixed substep that is
    not tiny).  On B01 at K7_WIDE_NODES nodes after 12 steps: bosh3 with
    fixed substeps, each kind, within K7_ABS (the traced kind by
    ``k7_case``'s witness rule where the float32 problem parts lanes), every
    kind, method and mode bit for bit ``_simple``, and tsit5's witness
    (``k7_witness``: there the plain version parts from itself under a
    one-ulp change of its input as far as K7 parts from it).  The 1D pulse
    traced bit for bit the node kind before its stop
    (``k7_pulse_anchor``).  Then, on the probe, adaptive tsit5 (B01's
    solver): K7 in turns with ``_simple`` (baseline, new, new, baseline,
    by CUDA events) under the node kind and under the storm (the traced
    row, which is also timed in turns with the node kind), each beside
    its plain version and its bound from this run's substeps
    (``k7_bound``); B01 at K7_WIDE_NODES likewise; and the lanes'
    divergence (``warp_divergence``) of each.  ``--probe`` times the same
    rows by their traces (``probe_k7``), early in a process of its own."""
    P = state.particles
    b01 = (P.z.contiguous(), P.t, P.dt, P.on & ~model.boundary_mask,
           model.grid.x)
    probe = k7_probe(dev)
    storm, storm_k = winds["slopped_blob"], kerns["slopped_blob"]
    out, worst, worst_t, timed = {}, 0.0, 0.0, {}
    for sname, (z, t, dt, act, x), plane, rec, modes in (
            ("B01", b01, model._node_plane, k7_record(dev), (False, True)),
            ("probe", probe[:5], probe[5], probe[6], (True,))):
        for kind in ("node", "gridded", "traced"):
            wind = {"node": plane, "gridded": rec, "traced": storm_k}[kind]
            winds_ = {"node": Winds1D(u=lambda xx, tt, _p=plane: _p),
                      "gridded": rec.as_winds(), "traced": storm}[kind]
            for method in ("bosh3", "tsit5"):
                for adaptive in modes:
                    tag = (f"K7 {sname} {kind} {method} "
                           f"{'adaptive' if adaptive else 'fixed'}")
                    r = k7_case(tag, model, wind, winds_, method, adaptive,
                                z, t, dt, act, x, witness=kind == "traced")
                    if not adaptive and kind == "traced":
                        worst_t = max(worst_t, r["err"])
                    elif not adaptive:
                        worst = max(worst, r["err"])
                    out[tag] = r["err"]
                    if sname == "probe" and method == "tsit5":
                        timed[kind] = r
    mw = b01_model(dev, nx=K7_WIDE_NODES)
    pw = eager_steps(mw, mw.init_state(), 12).particles
    wide = (pw.z.contiguous(), pw.t, pw.dt, pw.on & ~mw.boundary_mask,
            mw.grid.x)
    rec = k7_record(dev)
    for kind in ("node", "gridded", "traced"):
        wind = {"node": mw._node_plane, "gridded": rec,
                "traced": storm_k}[kind]
        winds_ = {"node": Winds1D(u=lambda xx, tt, _p=wind: _p),
                  "gridded": rec.as_winds(), "traced": storm}[kind]
        tag = f"K7 B01x{K7_WIDE_NODES} {kind} bosh3 fixed"
        r = k7_case(tag, mw, wind, winds_, "bosh3", False, *wide,
                    witness=kind == "traced")
        if kind == "traced":
            worst_t = max(worst_t, r["err"])
        else:
            worst = max(worst, r["err"])
        out[tag] = r["err"]
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cfg = SolverConfig(method=method, adaptive=adaptive,
                                   dtmin=1e-4, force_dtmin=True)
                d = wide[2] if adaptive else torch.full_like(wide[2],
                                                             K7_FIXED_DT)
                a = (cfg, wide[0], wide[1], d, *wide[3:])
                assert_bitwise(f"K7 B01x{K7_WIDE_NODES} {kind} {method} "
                               f"{adaptive}: K7 against _simple",
                               k7_launch(wind, mw, *a),
                               k7_launch(wind, mw, *a, simple=True))
    log("K7", f"B01 at {K7_WIDE_NODES} nodes: K7 bit for bit _simple in "
              f"every kind, method and mode")
    witness = k7_witness(mw, rec, *wide)
    # B01 at K7_WIDE_NODES, node kind, adaptive tsit5: in turns with the
    # baseline, and its lanes' divergence
    cfg = SolverConfig(method="tsit5", adaptive=True, dtmin=1e-4,
                       force_dtmin=True)
    wa = (mw._node_plane, mw, cfg, *wide)
    rhs_w = particle_equations_1d(
        lambda xx, tt, _p=mw._node_plane: _p, gamma=mw.constants.gamma,
        params=mw.params, constants=mw.constants)
    pw_ = integrate_to(rhs_w, wide[0], wide[1], wide[1] + DT, wide[2],
                       wide[4], wide[3], cfg)
    turns = [cuda_time_ms(lambda: k7_launch(*wa, simple=s), 10)
             for s in (True, False, False, True)]
    wide_t = dict(simple_ms=(turns[0] + turns[3]) / 2,
                  ms=(turns[1] + turns[2]) / 2,
                  divergence=warp_divergence(pw_.naccept + pw_.nreject),
                  divergence_k7_naccept=warp_divergence(
                      k7_launch(*wa).naccept))
    del mw, pw, wide, wa, pw_
    anchor = k7_pulse_anchor(dev, model, kerns["pulse"], probe)
    z, t, dt, act, x, plane, rec = probe

    def row(kind, wind):
        """The probe's adaptive tsit5 under ``wind``: K7 and ``_simple``
        in turns (baseline, new, new, baseline; CUDA events: the wrapper
        launches nothing else, and late in the process a trace's device
        times can fall short, as one did on the H100 at 0.5121 ms against
        0.6870 by events), the plain version, the bound and the lanes'
        divergence."""
        r = timed[kind]
        cfg, rhs, p = r["cfg"], r["rhs"], r["p"]
        args = (wind, model, cfg, z, t, dt, act, x)
        ts = [cuda_time_ms(lambda: k7_launch(*args, simple=s), 10)
              for s in (True, False, False, True)]
        s_ms, n_ms = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
        plain = cuda_time_ms(lambda: integrate_to(rhs, z, t, t + DT, dt, x,
                                                  act, cfg), 3)
        it = p.naccept + p.nreject
        b = k7_bound(z.shape[0], "tsit5", True, act, it, traced_ops=len(
            wind.traced.ops) if kind == "traced" else 0)
        return dict(ms=n_ms, simple_ms=s_ms, plain_ms=plain, **b,
                    divergence=warp_divergence(it),
                    divergence_k7_naccept=warp_divergence(r["k"].naccept),
                    substeps_live_mean=float(p.naccept[act].float().mean()))
    node = row("node", plane)
    traced = row("traced", storm_k)
    # the traced row in turns with the node kind (CUDA events): traced,
    # node, node, traced
    cfg = timed["traced"]["cfg"]
    vs = [cuda_time_ms(lambda: k7_launch(w, model, cfg, z, t, dt, act, x),
                       10) for w in (storm_k, plane, plane, storm_k)]
    traced.update(node_ms=(vs[1] + vs[2]) / 2, traced_events_ms=(
        vs[0] + vs[3]) / 2)
    # the traced kind's own cost: the 1D pulse from t = 0 on the probe is
    # bit for bit the node kind of constant_winds_1d(12) (the same
    # substeps), timed in turns with it (CUDA events)
    twelve = steady_node_plane_1d(constant_winds_1d(12.0), x)
    z0 = torch.zeros_like(t)
    vs = [cuda_time_ms(lambda: k7_launch(w, model, cfg, z, z0, dt, act, x),
                       10) for w in (kerns["pulse"], twelve, twelve,
                                     kerns["pulse"])]
    traced.update(pulse_ms=(vs[0] + vs[3]) / 2,
                  constant_12_ms=(vs[1] + vs[2]) / 2)
    rec_b = k7_bound(z.shape[0], "tsit5", True, act,
                     timed["node"]["p"].naccept + timed["node"]["p"].nreject,
                     record_bytes=rec.u_data.numel() * 4)
    for key, r, err in (("K7", node, worst), ("K7 traced", traced, worst_t)):
        results[key].update(max_abs_err=err, **{
            k: r[k] for k in ("ms", "simple_ms", "plain_ms", "bound_ms",
                              "bound_by")})
        log("K7", f"{key}, probe {z.shape[0]} lanes, adaptive tsit5: "
                  f"{r['ms']:.4f} ms against _simple {r['simple_ms']:.4f} ms "
                  f"in turns (CUDA events), plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); substeps a live lane mean "
                  f"{r['substeps_live_mean']:.2f}; lane divergence "
                  f"{r['divergence']:.4f} (K7's naccept "
                  f"{r['divergence_k7_naccept']:.4f})")
    log("K7", f"K7 traced {traced['traced_events_ms']:.4f} ms against the "
              f"node kind {traced['node_ms']:.4f} ms on the probe, in turns "
              f"(CUDA events); the 1D pulse from t = 0 "
              f"{traced['pulse_ms']:.4f} ms against constant_winds_1d(12)'s "
              f"node kind {traced['constant_12_ms']:.4f} ms (bit for bit, in "
              f"turns); B01 at {K7_WIDE_NODES} nodes, node kind, "
              f"adaptive tsit5: {wide_t['ms']:.4f} ms against _simple "
              f"{wide_t['simple_ms']:.4f} ms in turns (CUDA events), lane "
              f"divergence {wide_t['divergence']:.4f}; the gridded kind's "
              f"bound on the probe's substeps {rec_b['bound_ms']:.4f} ms")
    return dict(cases=out, witness=witness, probe=node, probe_traced=traced,
                wide=wide_t, pulse_anchor=anchor, gridded_bound=rec_b)


def b01_storm_model(dev, advance_mode: str = "auto", dtype=torch.float32,
                    **sett_kw) -> WaveGrowth1D:
    """B01 (``b01_model``, in ``dtype``) under the storm
    ``Winds1D(u=storm_u)``, a callable that reads its time (traced at
    construction on a card); ``sett_kw`` replaces settings."""
    m = b01_model(dev, dtype=dtype)
    return WaveGrowth1D(m.grid, Winds1D(u=storm_u),
                        dataclasses.replace(m.settings, **sett_kw),
                        config=m.config, advance_mode=advance_mode)


def phase_1d_storm(dev, results, traces: dict) -> dict:
    """B01 under the storm (K7's traced kind), the counters set to 0 just
    before and read just after each run: the model builds with
    ``advance_mode == "cuda"`` and ``graphed`` without being asked; two
    days (B01_STEPS steps) through ``Simulation.run`` with a CashStore,
    graphed (the host calls K7 traced in the warm-up and the capture), the
    waves grown by the storm and finite; the same days eagerly, every frame
    bit for bit, no failed lane (summed over the steps), K7 traced once a
    step; the replays' trace of ``traces`` (``phase_1d_traces``, in a
    process of its own); the graphed day's wall against the plain eager
    day's (``advance_mode="torch"``), in turns; ``record_trajectories``
    at K = REST_K sub-windows of REC_1D_STEPS steps from the storm's peak,
    its history bit for bit ``step_n``'s, K7 traced REST_K times a step,
    the first sub-window against the plain ``integrate_to`` by share of
    lanes (``assert_adaptive``)."""
    out = {}
    sm = b01_storm_model(dev)
    assert sm.advance_mode == "cuda" and sm.graphed, \
        (sm.advance_mode, sm.graphed)
    assert sm._traced is not None and sm._node_plane is None
    per = WARMUP_STEPS + 1
    reset_counters()
    sim, frames, wall = b01_day(sm)
    c = all_counters()
    assert c["K7 traced"] == per and c["K7"] == 0, c
    peak = float(frames[:, :, 0].max())
    assert peak > float(frames[0, :, 0].max()), peak
    reset_counters()
    es = sm.init_state()
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(B01_STEPS):
        es = sm.step(es)
        failed += es.metrics.n_failed.to(torch.int64)
        assert torch.equal(bits(es.state),
                           bits(torch.as_tensor(frames[k + 1], device=dev))), \
            f"1d storm: the eager step {k + 1} differs from the graphed day"
    c_eager = all_counters()
    assert c_eager["K7 traced"] == B01_STEPS and c_eager["K7"] == 0, c_eager
    assert int(failed) == 0, int(failed)
    assert_state_bitwise("1d storm: the eager K7 day against the graphed "
                         "day", es, sim.state)
    tr = traces["K7 traced"]
    log("1d", f"the storm (slopped_blob {B01_STORM}) on B01: two days "
              f"through Simulation.run graphed (K7 traced) in {wall:.3f} s "
              f"wall, the eager day bit for bit every frame, no failed lane; "
              f"peak E {peak:.4e}; launches: warm-up and capture "
              f"{c['K7 traced']}, eager {c_eager['K7 traced']}; in the "
              f"traces' process {K7_TRACED_STEPS} replays by trace "
              f"{tr['by_trace']} (bit for bit {tr['eager']} eager steps), "
              f"idle share {tr['idle_share']:.4f}, "
              f"{tr['device_ops_per_step']:.1f} device ops a step")
    plain = b01_storm_model(dev, advance_mode="torch")
    assert not plain.graphed and plain.advance_mode == "torch"
    turns = {"plain eager": [], "graphed": []}
    for who in ("plain eager", "graphed", "graphed", "plain eager"):
        _, f_, w_ = b01_day(plain if who == "plain eager" else sm)
        turns[who].append(w_)
        if who == "plain eager":
            gap = float(np.abs(f_ - frames).max() / np.abs(frames).max())
            out["plain_day_gap"] = gap
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log("1d", f"the storm's B01 day ({B01_STEPS} steps) in turns: graphed "
              f"(K7 traced) {turns['graphed']} s, plain eager "
              f"{turns['plain eager']} s (medians {med['graphed']:.3f} / "
              f"{med['plain eager']:.3f} s); the plain day's frames within "
              f"{out['plain_day_gap']:.3e} of the graphed day's scale")
    # record_trajectories under the storm, from the storm's peak
    ms = sm.step_n_quiet(sm.init_state(), 18)
    reset_counters()
    final, h = record(sm, ms, REC_1D_STEPS, REST_K)
    c_rec = all_counters()
    assert c_rec["K7 traced"] == REC_1D_STEPS * REST_K, c_rec
    ref, states = sm.step_n(ms, REC_1D_STEPS)
    assert torch.equal(bits(h["state"]), bits(states)), \
        "1d storm: record_trajectories' history differs from step_n"
    assert_state_bitwise("1d storm: record_trajectories' final state",
                         final, ref)
    assert h["z_fine"].shape == (REC_1D_STEPS * REST_K, sm.grid.nx, 3)
    # the first sub-window against the plain integrate_to from the same
    # state (adaptive: by share of lanes; fixed substeps are unstable for
    # the young seas the storm meets, on the plain version too)
    P = ms.particles
    active = P.on & ~sm.boundary_mask
    r = integrate_to(sm.rhs, P.z, P.t, P.t + DT / REST_K, P.dt, sm.grid.x,
                     active, sm.solver)
    sub_err = max(assert_adaptive(f"1d storm sub-window 0 {nm}",
                                  h["z_fine"][0][:, c], r.z[:, c])
                  for c, nm in ((0, "lne"), (1, "cg_x")))
    assert_close("1d storm sub-window 0 t", h["t_fine"][0], r.t, 1e-6, 0.0)
    sm.release_graph()
    log("1d", f"record_trajectories under the storm, K = {REST_K}: "
              f"{REC_1D_STEPS} steps, the history bit for bit step_n's, "
              f"launches {c_rec['K7 traced']}; the first sub-window within "
              f"{sub_err:.3e} of integrate_to ({int(active.sum())} lanes)")
    results["K7 traced"]["launches"] += (c["K7 traced"] + c_eager["K7 traced"]
                                         + tr["by_trace"] + tr["eager"]
                                         + c_rec["K7 traced"])
    results["K7 traced"]["graph_launches"] = tr["by_trace"]
    out.update(day_wall_s=wall, day_turns_s=turns, day_median_s=med,
               launches=dict(capture=c["K7 traced"],
                             eager=c_eager["K7 traced"],
                             by_trace=tr["by_trace"],
                             record=c_rec["K7 traced"]),
               traced=tr, peak_energy=peak, sub_window_err=sub_err)
    return out


def b01_plain_model(dev, U10: float = 10.0) -> WaveGrowth1D:
    """B01 (``b01_model``) with the plain advance asked for
    (``advance_mode="torch"``): eager, on the card."""
    m = b01_model(dev, U10)
    return WaveGrowth1D(m.grid, m.winds, m.settings, config=m.config,
                        advance_mode="torch")


def phase_1d(dev, results, timing, traces: dict) -> None:
    """Phase "1d": the 1D growth model on the card.  On B01 the advance is
    kernel K7 and the drivers replay a CUDA graph of the step
    (``model.graphed``).  First the traced kind's two libraries are built
    and each emitted function checked alone (``traced_1d_build``,
    ``traced_probe_1d_check``).  The counters set to 0 just before and
    read just after the main path:
    two model days (288 steps) of each B01 configuration through
    ``Simulation.run`` with a CashStore (graphed: the host calls K7 in the
    warm-up and the capture): the centre node onto the Dulov curve (ratios
    falling at 4, 8, 12 h, the last within 0.7-1.6) and E g^2/U^4 at g t/U
    = 30000 collapsing within 25% across 5, 10 and 20 m/s, as
    tests/test_model_1d_b01.py asserts; the B01 day run again eagerly
    (``model.step`` in a loop, K7 counted once a step), bit for bit the
    graphed day, frames included; the trace of 12 more steps through
    ``Simulation.run`` (K7 by name), bit for bit as many eager steps, of
    ``traces`` (``phase_1d_traces``, in a process of its own).  Then the
    graphed day's wall time against the plain eager day's (``advance_mode="torch"``: the plain
    ``integrate_to``), in turns; a checkpoint at step 144 resumed bit
    for bit to the day's end; the card (K7) against the CPU (the plain
    advance) on the B01 grid at abstol 1e-7 / reltol 1e-6 over 12 steps
    within 1e-4 of the state's scale, the counters equal (the most
    substeps of a lane within 2); B01 under the storm (K7's traced kind,
    ``phase_1d_storm``); K7 against its plain version and its ``_simple``
    baseline, and its times (``phase_k7``); the
    sign-merge deposit, deterministic, periodic and open
    (``deposit_1d_check``)."""
    out = {}
    model = b01_model(dev)
    assert model.graphed and model.advance_mode == "cuda", \
        (model.graphed, model.advance_mode)
    winds1d = traced_1d_callables()
    kerns1d, build_s = traced_1d_build(dev, winds1d)
    out["traced_1d_build_seconds"] = build_s
    out["traced_1d_ops"] = traced_probe_1d_check(dev, winds1d, kerns1d,
                                                 TRACED_PROBE_POINTS)
    reset_counters()
    sim, frames, wall = b01_day(model)
    c_day = counters()
    ratios = [float(frames[k, 15, 0]) / dulov_energy(k * DT, 10.0)
              for k in (24, 48, 72)]
    assert all(r1 > r2 for r1, r2 in zip(ratios, ratios[1:])), ratios
    assert 0.7 < ratios[-1] < 1.6, ratios
    m = check_state("1d B01", sim.state, n_failed=0)
    day2 = float(frames[-1, 15, 0]) / dulov_energy(B01_STEPS * DT, 10.0)
    out.update(b01_ratios=ratios, b01_ratio_day2=day2, b01_wall_s=wall,
               b01_ms_per_step=wall * 1e3 / B01_STEPS, b01_metrics=m)
    log("1d", f"B01 31 nodes / 500 km, 10 m/s: {B01_STEPS} steps through "
              f"Simulation.run (CashStore, graphed, K7) in {wall:.3f} s wall "
              f"({wall * 1e3 / B01_STEPS:.3f} ms/step); E / E_Dulov at 4, 8, "
              f"12 h {[round(r, 4) for r in ratios]}, at 48 h {day2:.4f}; "
              f"metrics {m}; the host's calls {c_day}")
    etils, walls = [], []
    for U in (5.0, 10.0, 20.0):
        mu = b01_model(dev, U, nx=21, Lx=1000e3 * (U / 10.0) ** 2)
        assert mu.graphed
        su, fu, w = b01_day(mu)
        n = int(round(30000.0 * U / G_ACC / DT))
        etils.append(float(fu[n, 10, 0]) * G_ACC ** 2 / U ** 4)
        walls.append(w)
        check_state(f"1d collapse {U}", su.state, n_failed=0)
        mu.release_graph()
    etils = np.array(etils)
    spread = np.abs(etils / etils.mean() - 1.0)
    assert np.all(spread < 0.25), etils
    c = counters()
    per = WARMUP_STEPS + 1
    assert c == dict({k: 0 for k in KERNEL_FNS}, K7=4 * per), c
    out.update(collapse_etilde=etils.tolist(), collapse_wall_s=walls)
    log("1d", f"collapse at g t/U = 30000 (5, 10, 20 m/s, 21 nodes, "
              f"{B01_STEPS} steps each, {sum(walls):.3f} s wall, graphed): "
              f"E g^2/U^4 {etils.tolist()}, spread {spread.max():.4f} of the "
              f"mean; the host's calls {c} (warm-up and capture, once a "
              f"model)")

    # the eager K7 day, bit for bit the graphed one, and a traced run
    reset_counters()
    es = model.init_state()
    for k in range(B01_STEPS):
        es = model.step(es)
        assert torch.equal(bits(es.state),
                           bits(torch.as_tensor(frames[k + 1], device=dev))), \
            f"1d B01: the eager step {k + 1} differs from the graphed day"
    c_eager = counters()
    assert c_eager == dict({k: 0 for k in KERNEL_FNS}, K7=B01_STEPS), c_eager
    assert_state_bitwise("1d B01: the eager K7 day against the graphed day",
                         es, sim.state)
    tr = traces["K7"]
    results["K7"]["launches"] = (c["K7"] + c_eager["K7"] + tr["by_trace"]
                                 + tr["eager"])
    results["K7"]["graph_launches"] = tr["by_trace"]
    out.update(eager_day_launches=c_eager, traced=tr)
    log("1d", f"the eager K7 day: bit for bit the graphed day (every frame, "
              f"the final state), launches {c_eager}; in the traces' "
              f"process {K7_TRACED_STEPS} more steps of Simulation.run, "
              f"launches by trace {tr['by_trace']} (bit for bit "
              f"{tr['eager']} eager steps), idle share "
              f"{tr['idle_share']:.4f}, {tr['device_ops_per_step']:.1f} "
              f"device ops a step")
    del es

    # the graphed day against the plain eager day, in turns
    plain = b01_plain_model(dev)
    assert not plain.graphed and plain.advance_mode == "torch"
    turns = {"plain eager": [], "graphed": []}
    for rep in range(2 * B01_TURNS):
        who = ("plain eager", "graphed", "graphed", "plain eager")[rep % 4]
        s_, f_, w_ = b01_day(plain if who == "plain eager" else model)
        turns[who].append(w_)
        if who == "plain eager":
            pr = [float(f_[k, 15, 0]) / dulov_energy(k * DT, 10.0)
                  for k in (24, 48, 72)]
            assert all(r1 > r2 for r1, r2 in zip(pr, pr[1:])), pr
            assert 0.7 < pr[-1] < 1.6, pr
            out["b01_plain_ratios"] = pr
    med = {k: float(np.median(v)) for k, v in turns.items()}
    out.update(b01_day_turns_s=turns, b01_day_median_s=med)
    log("1d", f"the B01 day ({B01_STEPS} steps, Simulation.run, CashStore) "
              f"in turns: graphed (K7) {turns['graphed']} s, plain eager "
              f"{turns['plain eager']} s (medians {med['graphed']:.3f} / "
              f"{med['plain eager']:.3f} s); the plain day's ratios "
              f"{[round(r, 4) for r in out['b01_plain_ratios']]}")

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
              f"{B01_STEPS} (graphed): bit for bit the uninterrupted run")
    model.release_graph()

    mg = b01_model(dev, tols=CARD_VS_CPU_TOLS)
    mc = b01_model("cpu", tols=CARD_VS_CPU_TOLS)
    assert mg.advance_mode == "cuda" and mc.advance_mode == "torch"
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
    log("1d", f"card (K7) vs CPU (plain), B01 grid at abstol 1e-7 / reltol "
              f"1e-6, 12 steps: max gap {gap:.3e} of the state's scale, on "
              f"and the counters equal")

    out["storm"] = phase_1d_storm(dev, results, traces)
    out["k7"] = phase_k7(dev, model, eager_steps(model, model.init_state(),
                                                 24), kerns1d, winds1d,
                         results)

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
    no K2 or K6; the graphed sharded step bit for bit its eager steps
    (``sharded_graph_check``).  At the path's own tolerances with the
    plain deposit on both sides (``scatter_mode="dense"``) 3 steps bit
    for bit the single-device ones: the block planes (projection, winds,
    seam) are the grid's, and only the sum order of K4 and the folds parts
    the kernel runs.  Then the sharded step graphed and eager and the
    single-device step graphed in turns, 8 times 10 steps each (CUDA events), and K4 on
    the "pallas" path's deposit (``k4_tripolar``)."""
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

        graph = sharded_graph_check(
            f"sharded tripolar {path}", sh, ms,
            {"K1 proj": "K1", "K4": "K4",
             ("K3 proj" if kern == "K3" else "K5 gridded"): kern}, results)
        runs = {"sharded graphed": [], "sharded eager": [],
                "single graphed": []}
        order = list(runs)
        for rep in range(SHARDED_TURNS[0]):
            for who in order[rep % 3:] + order[:rep % 3]:
                if who == "single graphed":
                    ref, t = time_steps(model, ref, SHARDED_TURNS[1])
                else:
                    ms, t = time_steps(sh, ms, SHARDED_TURNS[1],
                                       eager=who == "sharded eager")
                runs[who].append(t)
        med = {k: float(np.median(v)) for k, v in runs.items()}
        ms_step, single = med["sharded graphed"], med["single graphed"]
        out[path] = dict(max_abs_err=err, launches=c, metrics=m,
                         ms_per_step=ms_step, single_ms_per_step=single,
                         eager_ms_per_step=med["sharded eager"],
                         pushes_per_s=n / (ms_step / 1e3), turns=runs,
                         graph=graph, plain_deposit_bitwise=True)
        if path == "pallas":
            out["K4 tripolar"] = k4_tripolar(model, ms)
        log("sharded-tripolar", f"{path} at {grid.nx} x {grid.ny}: 3 steps "
                                f"vs single device max abs err {err:.3e}, "
                                f"counters equal; {steps} steps, metrics "
                                f"{m}; the plain deposit on both sides bit "
                                f"for bit; graphed {ms_step:.4f} ms/step "
                                f"sharded (1, 1), eager "
                                f"{med['sharded eager']:.4f}, the single-"
                                f"device step graphed {single:.4f} (medians "
                                f"of {SHARDED_TURNS[0]} x {SHARDED_TURNS[1]} "
                                f"steps in turns, CUDA events)")
        sh.release_graph()
        model.release_graph()
        del model, sh, ms, ref
    timing["sharded_tripolar"] = out


# ---------------------------------------------------------------------------
# a steady callable as the wind: the node kind (phases "node-winds",
# "global-jet", "examples")
# ---------------------------------------------------------------------------

# the new entries of the kernels line: the TPU kernels' lines that sample
# the callable wind, which the node kind replaces
NODE_REPLACES = {"K1 node": "picles_tpu/ops/advance_pallas.py:78",
                 "K3 node": "picles_tpu/ops/advance_pallas.py:219",
                 "K5 node": "picles_tpu/ops/remesh_pallas.py:60",
                 "K6 node": "picles_tpu/ops/pic_pallas.py:398"}
NODE_STEPS = 3
NODE_CONFIGS = {"flagship xla": ("K1", "K2"),
                "flagship pallas": ("K1", "K2", "K5"),
                "flagship fused": ("K1", "K6"),
                "default": ("K1", "K2", "K3")}
JET_PATHS = {"fused": ("K1", "K6"), "pallas": ("K1", "K2", "K5"),
             "default": ("K1", "K2", "K3")}
JET_STEPS = 72       # a day of TRI_DT
JET_PLAIN_STEPS = 10


def steady_constant(U10: float = 10.0, V10: float = 10.0) -> Winds2D:
    """``constant_winds(U10, V10)``'s samplers as a plain callable, with no
    kernel descriptor: the model takes it as the node kind."""
    return Winds2D(u=lambda x, y, t: torch.full_like(x, U10),
                   v=lambda x, y, t: torch.full_like(x, V10))


def jet_u(x, y, t):
    """benchmark/tripolar_global_demo.py:63-67's two zonal jets."""
    return (12.0 * torch.exp(-(((y - 40.0) / 18.0) ** 2))
            + 9.0 * torch.exp(-(((y + 45.0) / 15.0) ** 2)))


def jet_v(x, y, t):
    return torch.zeros_like(x)


def jet_model(grid, path: str, winds=None, tols=None, **cfg_kw):
    """benchmark/tripolar_global_demo.py:60-80's configuration on ``grid``:
    the two jets as the plain callable ``Winds2D(u=jet_u, v=jet_v)`` (or
    ``winds``), DT = 1200 s, the settings' tsit5 with dt = 1e-3, dtmin =
    1e-4, force_dtmin, the log-energy minimum of a (10, 10) m/s minimal
    windsea, periodic, halo 3; "fused" and "pallas" carry the dt and run the
    remesh kernel (K1 and K6; K1, K2 and K5), "default" is the package's
    config (K1, K2 and K3 on the reset lanes); ``cfg_kw`` more config
    entries (``advance_mode``, ``remesh_mode``)."""
    ws = FR.MinimalWindsea(10.0, 10.0, TRI_DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=TRI_DT,
                       timestep=TRI_DT, total_time=DAY, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True, **(tols or {}))
    cfg = dict(periodic_boundary=True, halo=3)
    if path != "default":
        cfg.update(dt_reset_mode="carry", remesh_mode=path)
    cfg.update(cfg_kw)
    return WaveGrowth2D(grid, winds or Winds2D(u=jet_u, v=jet_v), sett,
                        config=WaveGrowth2DConfig(**cfg))


def node_record(model, grid):
    """A ``GriddedWinds2D`` record of two identical frames of ``model``'s
    node planes over ``grid``, and the grid sampled by it: the record is
    laid over the node indices (x0 = y0 = 0, dx = dy = 1) and its frames
    sit at t = -3600 and 0 s (hourly), and the grid's copy has the node
    indices for x and y.  Its interpolant at a node is then the node's own
    sample exactly at every t >= 0 (the spatial weights are 1 and 0, the
    time index clamps to the last frame), and the kernels read it as B = 1
    planes with zero slopes: u = s + t 0 + 0 max(t - b, 0) = s.  The grid's
    x and y enter the step only where the winds are sampled."""
    planes = model.node_planes(grid)
    frames = torch.stack([planes, planes], dim=1)     # [u/v, frame, nx, ny]
    gw = GriddedWinds2D(u_data=frames[0].contiguous(),
                        v_data=frames[1].contiguous(), x0=0.0, dx=1.0,
                        y0=0.0, dy=1.0, t0=-3600.0, dt=3600.0)
    nx, ny, dev = grid.nx, grid.ny, grid.device
    ix = torch.arange(nx, dtype=torch.float32, device=dev)
    iy = torch.arange(ny, dtype=torch.float32, device=dev)
    return gw, dataclasses.replace(
        grid, x=ix[:, None].expand(nx, ny).contiguous(),
        y=iy[None, :].expand(nx, ny).contiguous())


def node_step_checks(dev, n: int, tri_grid) -> dict:
    """The node kind against the kinds it must equal, bit for bit, from the
    seed, ``NODE_STEPS`` eager steps each, the counters set to 0 just
    before each node-kind run and read just after: (a) at n^2 the
    flagship (``xla``, ``pallas``, ``fused``) and default configurations
    forced by ``steady_constant()`` against the same models forced by
    ``constant_winds(10, 10)``: the kernels are the same, only the wind's
    kind differs; (b) on ``tri_grid`` the jet configurations (``fused``,
    ``pallas``, default) against the same configurations forced by the
    jet's ``node_record`` (K1, K3, K5 and K6's gridded instances).  Returns
    the node-kind runs' launches by kernel id."""
    launches = {}

    def tally(c):
        for k in ("K1", "K3", "K5", "K6"):
            launches[k] = launches.get(k, 0) + c[k]

    for name, kerns in NODE_CONFIGS.items():
        pair = []
        for winds in (constant_winds(10.0, 10.0), steady_constant()):
            if name == "default":
                m = default_model(n, dev, winds=winds)
            else:
                m = flagship_model(n, dev, winds=winds,
                                   remesh_mode=name.split()[1])
            reset_counters()
            pair.append(eager_steps(m, m.init_state(), NODE_STEPS))
        c = counters()
        assert m.winds.kernel.kind == WindKind.NODE, name
        assert all(c[k] == NODE_STEPS for k in kerns), (name, c)
        tally(c)
        assert_state_bitwise(f"node kind vs constant winds, {name}", *pair)
        check_state(f"node kind {name}", pair[1], n_failed=0, n_clamped=0)
        log("node-winds", f"{n}^2 {name}: steady_constant() (the node kind) "
                          f"bit for bit constant_winds(10, 10) over "
                          f"{NODE_STEPS} steps; launches {c}")
    for path, kerns in JET_PATHS.items():
        jm = jet_model(tri_grid, path)
        assert jm.winds.kernel.kind == WindKind.NODE, path
        gw, igrid = node_record(jm, tri_grid)
        rm = jet_model(igrid, path, winds=gw)
        assert rm._wind_B == 1, rm._wind_B
        a = eager_steps(rm, rm.init_state(), NODE_STEPS)
        reset_counters()
        b = eager_steps(jm, jm.init_state(), NODE_STEPS)
        c = counters()
        assert all(c[k] == NODE_STEPS for k in kerns), (path, c)
        tally(c)
        assert_state_bitwise(f"jet (node kind) vs its record, {path}", b, a)
        check_state(f"jet {path}", b, n_failed=0, n_clamped=0)
        log("node-winds", f"{tri_grid.nx} x {tri_grid.ny} jet {path}: the "
                          f"callable (node kind) bit for bit its two-frame "
                          f"record (gridded, B = 1) over {NODE_STEPS} steps; "
                          f"launches {c}")
        del jm, rm, a, b, gw, igrid
    return launches


def phase_node_winds(dev, results):
    """Phase "node-winds": ``node_step_checks`` at FLAG_N^2 and on the
    quarter-degree tripolar grid."""
    t0 = time.perf_counter()
    launches = node_step_checks(dev, FLAG_N, tripolar_grid(dev, *TRI_SUPER))
    for k, v in launches.items():
        results[f"{k} node"]["launches"] += v
    log("node-winds", f"done in {time.perf_counter() - t0:.1f} s")


def phase_global_jet(dev, results, timing):
    """Phase "global-jet", this slice's main path: the global tripolar jet
    (benchmark/tripolar_global_demo.py's configuration, ``jet_model``) at
    1440 x 720 through its entry points.  The fused day (72 steps of 1200
    s) through ``Simulation.run``, graphed, checkpointed at step 36 and
    resumed bit for bit, its launches counted in a trace (K1 = K6 = 72),
    the day again eagerly (``run_day_resumed``); finite, no failed or
    clamped lane, and the land holds no energy.  Then for ``fused``,
    ``pallas`` and default ms/step graphed and eager (medians of 3 x 10
    steps, CUDA events) with their launches (``pallas`` and default also by
    name in a trace of 3 steps of ``Simulation.run``: K1 with K2 and K5,
    or with K2 and K3), and the fused configuration on
    the plain advance (``advance_mode="torch"`` with the PyTorch remesh:
    the only path a callable had on the card before) in turns with the
    fused kernels' eager step, 10 steps each way.  Returns (grid, the fused
    model and its day's last state, the default model and its state)."""
    grid = tripolar_grid(dev, *TRI_SUPER)
    n = grid.nx * grid.ny
    prod = jet_model(grid, "fused")
    assert prod.graphed and prod.winds.kernel.kind == WindKind.NODE
    assert prod.uniform_proj is None
    planes = prod.node_planes(grid)
    assert any(c is not None and c[1] is planes for c in prod.graph_keep())
    r = run_day_resumed(prod, "global jet day", steps=JET_STEPS, at=36)
    full = r["full"].state
    m = check_tripolar("global jet day", prod, full)
    assert m["n_clamped"] == 0 and r["day"]["n_clamped"] == 0, m
    assert r["day"]["n_failed"] == 0, r["day"]
    e = full.state[..., 0]
    land = (grid.mask == 0)
    land_e = float(e[land].double().abs().sum())
    # the demo's own check (benchmark/tripolar_global_demo.py:113-116)
    assert land_e == 0.0, f"global jet day: land energy {land_e:.3e}"
    g, c, ec = r["graphed_counts"], r["launches"], r["eager_launches"]
    assert c["K1"] == c["K6"] == JET_STEPS and ec["K1"] == ec["K6"] == \
        JET_STEPS, (c, ec)
    results["K1 node"]["launches"] += c["K1"]
    results["K6 node"]["launches"] += c["K6"]
    timing.update(global_jet_day_wall_s=r["wall"],
                  global_jet_day_ms_per_step=r["wall"] * 1e3 / JET_STEPS,
                  global_jet_day_pushes_per_s=n * JET_STEPS / r["wall"],
                  global_jet_peak_bytes=r["peak"],
                  global_jet_checkpoint_bytes=r["size"],
                  global_jet_day_trace=r["trace"],
                  global_jet_day_counters=r["day"],
                  global_jet_land_energy=land_e,
                  global_jet_land_share=m["land_energy_share"])
    log("global-jet", f"{grid.nx} x {grid.ny} fused day through "
                      f"Simulation.run (graphed): {JET_STEPS} steps in "
                      f"{r['wall']:.3f} s wall "
                      f"({r['wall'] * 1e3 / JET_STEPS:.3f} ms/step, "
                      f"{n * JET_STEPS / r['wall']:.4e} pushes/s), peak "
                      f"{r['peak'] / 2**30:.3f} GiB; resumed from step 36 "
                      f"bit for bit; launches by trace {c}, the host's "
                      f"{g}, the eager day's {ec} (bit for bit); device busy "
                      f"{r['trace']['device_busy_ms_per_step']:.4f} ms/step, "
                      f"idle share {r['trace']['idle_share']:.4f}; land "
                      f"energy {land_e:.3e} (share "
                      f"{m['land_energy_share']:.3e} on "
                      f"{m['land_nodes_with_energy']} nodes); the day's "
                      f"counters {r['day']}")
    del r
    states = {"fused": full}
    models = {"fused": prod}
    for path, kerns in JET_PATHS.items():
        model = models[path] if path in models else jet_model(grid, path)
        ms = states[path] if path in states else model.init_state()
        reset_counters()
        ms = eager_steps(model, ms, 2)
        c = counters()
        assert all(c[k] == 2 for k in kerns), (path, c)
        assert sum(c.values()) == 2 * len(kerns), (path, c)
        for k in kerns:
            if f"{k} node" in results:
                results[f"{k} node"]["launches"] += c[k]
        ms, _ = time_steps(model, ms, 3)     # the capture
        runs = {"graphed": [], "eager": []}
        for _ in range(3):
            for how in ("graphed", "eager"):
                ms, t = time_steps(model, ms, 10, eager=how == "eager")
                runs[how].append(t)
        mt = check_tripolar(f"global jet {path}", model, ms)
        med = {k: float(np.median(v)) for k, v in runs.items()}
        timing[f"global_jet_{path}_ms_per_step"] = med
        traced = ""
        if path != "fused":    # the fused day was traced above
            want = {k: 3 if k in kerns else 0
                    for k in ("K1", "K2", "K3", "K5", "K6")}
            sim, got, _ = traced_run(
                model, (int(ms.iteration) + 2) * TRI_DT, want, state=ms)
            assert got == want, (path, got)
            ms = sim.state
            for k in kerns:
                if f"{k} node" in results:
                    results[f"{k} node"]["launches"] += got[k]
            traced = f"; 3 steps of Simulation.run, launches by trace {got}"
        log("global-jet", f"{path}: {med['graphed']:.3f} ms/step graphed, "
                          f"{med['eager']:.3f} eager (medians of 3 x 10 "
                          f"steps, CUDA events); 2 eager steps launched "
                          f"{c}{traced}; metrics {mt}")
        states[path], models[path] = ms, model
    plain = jet_model(grid, "fused", advance_mode="torch", remesh_mode="xla")
    assert not plain.graphed and plain.winds.kernel is None
    sp, sk = states["fused"], states["fused"]
    runs = {"plain": [], "kernels": []}
    for who in ("kernels", "plain", "plain", "kernels"):
        if who == "plain":
            sp, t = time_steps(plain, sp, JET_PLAIN_STEPS // 2, eager=True)
        else:
            sk, t = time_steps(prod, sk, JET_PLAIN_STEPS // 2, eager=True)
        runs[who].append(t)
    check_tripolar("global jet on the plain advance", plain, sp)
    med = {k: float(np.mean(v)) for k, v in runs.items()}
    timing["global_jet_plain_vs_kernels_ms_per_step"] = med
    log("global-jet", f"the fused configuration on the plain advance "
                      f"(advance_mode=\"torch\", the PyTorch remesh): "
                      f"{med['plain']:.3f} ms/step against the kernels' "
                      f"eager {med['kernels']:.3f} (means of 2 x "
                      f"{JET_PLAIN_STEPS // 2} steps each, in turns, CUDA "
                      f"events): "
                      f"{med['plain'] / med['kernels']:.1f} x")
    return grid, prod, states["fused"], models["default"], states["default"]


def node_kernel_times(grid, prod, s_prod, default, s_def, results, timing):
    """The node kind's four entries at 1440 x 720 on the global jet's own
    states, each held against its plain version over ``node_plane_winds``
    of the same planes and timed beside it with its bound: K1 on the fused
    day's last state (by share of lanes, ``assert_adaptive`` and
    ``assert_controller``), K3 on the default state with every lane reset
    (within rtol 1e-5), K5 and K6 on the fused state's deposit
    (``assert_remesh``; K6 bit for bit K2 + K5).  K1 and K3 by CUDA events
    (their wrappers launch nothing else), K5 and K6 from profiler traces.
    The bytes count the node pair's 8 a particle.  Then the same four
    calls through the gridded instances over the jet's ``node_record``
    (``node_vs_record``)."""
    nx, ny = grid.nx, grid.ny
    n = nx * ny
    g = grid
    P = s_prod.particles
    adv = P.on & prod.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    wf = prod.wind_fields(g, s_prod.time)
    assert len(wf) == 2
    nw = node_plane_winds(*wf)
    planes = prod.projection(g)
    rhs = make_rhs(nw.u, nw.v, prod.consts, prod.flags)

    def k1():
        return advance_cuda(prod.winds, prod.consts, prod.flags, prod.solver,
                            TRI_DT, comps, P.t, P.dt, adv, g.x, g.y, planes,
                            wind_fields=wf)

    def k1_plain():
        return integrate_to(rhs, torch.stack(comps, dim=-1), P.t,
                            P.t + TRI_DT, P.dt, prod.aux, adv, prod.solver)

    k, p = k1(), k1_plain()
    assert torch.equal(k.failed, p.failed), "K1 node: failed"
    e1 = max(assert_adaptive(f"K1 node jet {nm}", kz, p.z[..., i],
                             min_share=GRIDDED_SHARE,
                             loose_atol=GRIDDED_LOOSE_ATOL)
             for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                              k[:5])))
    ctl = assert_controller("K1 node jet", k, p, adv)
    out = {"K1 node": dict(max_abs_err=e1, ms=cuda_time_ms(k1, 10),
                           plain_ms=cuda_time_ms(k1_plain, 2),
                           **k1_bound(n, prod.solver.method, True, adv,
                                      p.naccept + p.nreject, n_wf=2,
                                      proj=True))}
    log("K1 node", f"{nx} x {ny} global jet day's state "
                   f"({prod.solver.method}): max abs err {e1:.3e}; {ctl}")

    Q = s_def.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    wfd = default.wind_fields(g, s_def.time)
    nwd = node_plane_winds(*wfd)
    rhsd = make_rhs(nwd.u, nwd.v, default.consts, default.flags)
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

    e3 = assert_close("K3 node jet default state", k3(), k3_plain(), 1e-5,
                      0.0)
    out["K3 node"] = dict(max_abs_err=e3, ms=cuda_time_ms(k3, 20),
                          plain_ms=cuda_time_ms(k3_plain, 5),
                          **k3_bound(reset, kernel_wind(default.winds),
                                     proj=True))

    halo = prod.config.halo
    (xl, xh), (yl, yh) = normalize_halo(halo)
    wide = ((max(xl, xh),) * 2, (max(yl, yh),) * 2)
    ghosts = nx * max(yl, yh)
    core, chans, sact = flagship_deposit_inputs(prod, s_prod)
    rp = prod.remesh_params
    prp = rp._replace(winds=nw)
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    k5 = remesh_cuda(rp, node, *core, wind_fields=wf)
    e5 = assert_remesh("K5 node jet", k5, remesh_core(prp, node, *core))
    nd, rm, _ = pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, rp, *core, wind_fields=wf)
    assert_bitwise("K6 node jet vs K2 + K5", (*nd, *rm), (*node, *k5))

    def plain_fused():
        Sp, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                              g.stats, halo)
        return remesh_core(prp, tuple(Sp[..., c] for c in range(3)), *core)

    S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                         g.stats, halo)
    e6 = max([e5] + [assert_close(f"K6 node jet deposit ch{c}", nd[c],
                                  S[..., c], 1e-5,
                                  1e-6 * float(S[..., c].abs().max()))
                     for c in range(3)])
    del S
    out["K5 node"] = dict(
        max_abs_err=e5,
        ms=kernel_ms(lambda: remesh_cuda(rp, node, *core, wind_fields=wf),
                     "K5", 20),
        plain_ms=cuda_time_ms(lambda: remesh_core(prp, node, *core), 5),
        **remesh_bound(n, n_wf=2))
    out["K6 node"] = dict(
        max_abs_err=e6,
        ms=kernel_ms(lambda: pic_gather_remesh(
            core[3], core[4], chans, sact, g.stats, halo, rp, *core,
            wind_fields=wf), "K6", 20),
        plain_ms=cuda_time_ms(plain_fused, 5),
        **deposit_bound(n + ghosts, n, wide, remesh=True, n_wf=2))
    log("K6 node", f"{nx} x {ny} global jet state (halo {halo}): remesh "
                   f"outputs and node planes equal to K2 + K5 bitwise "
                   f"({branch_counts(rm.branch)})")
    for key, r in out.items():
        results[key].update(r)
        log("kernel-time", f"{key}: {r['ms']:.4f} ms, plain "
                           f"{r['plain_ms']:.4f} ms, bound "
                           f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    rec, igrid = node_record(prod, g)
    rprod = jet_model(igrid, "fused", winds=rec)
    rdef = jet_model(igrid, "default", winds=rec)
    rwf = rprod.wind_fields(igrid, s_prod.time)
    rwfd = rdef.wind_fields(igrid, s_def.time)
    assert len(rwf) == len(rwfd) == 7, (len(rwf), len(rwfd))
    rrp = rprod.remesh_params
    pairs = {
        "K1": (k1, lambda: advance_cuda(
            rprod.winds, prod.consts, prod.flags, prod.solver, TRI_DT, comps,
            P.t, P.dt, adv, igrid.x, igrid.y, planes, wind_fields=rwf),
            cuda_time_ms, 10,
            k1_bound(n, prod.solver.method, True, adv, p.naccept + p.nreject,
                     n_wf=7, proj=True)),
        "K3": (k3, lambda: auto_dt_cuda(
            rdef.winds, default.consts, default.flags, Q.t, qc, igrid.x,
            igrid.y, default.projection(g), reset, Q.dt, sett.dtmin, TRI_DT,
            abstol=sett.abstol, reltol=sett.reltol, order=default._rk_order,
            wind_fields=rwfd), cuda_time_ms, 20,
            k3_bound(reset, kernel_wind(rdef.winds), proj=True)),
        "K5": (lambda: remesh_cuda(rp, node, *core, wind_fields=wf),
               lambda: remesh_cuda(rrp, node, *core, wind_fields=rwf),
               functools.partial(kernel_ms, key="K5"), 20,
               remesh_bound(n, n_wf=7)),
        "K6": (lambda: pic_gather_remesh(
            core[3], core[4], chans, sact, g.stats, halo, rp, *core,
            wind_fields=wf)[:2],
               lambda: pic_gather_remesh(
            core[3], core[4], chans, sact, g.stats, halo, rrp, *core,
            wind_fields=rwf)[:2],
               functools.partial(kernel_ms, key="K6"), 20,
               deposit_bound(n + ghosts, n, wide, remesh=True, n_wf=7)),
    }
    cmp = {}
    for kid, (node_fn, rec_fn, timer, reps, rb) in pairs.items():
        a, b = node_fn(), rec_fn()
        if kid == "K6":
            a, b = (*a[0], *a[1]), (*b[0], *b[1])
        elif kid == "K3":
            a, b = (a,), (b,)
        assert_bitwise(f"{kid} node vs its record's gridded instance", a, b)
        t = {"node": [], "record": []}
        for who in ("node", "record", "record", "node"):
            t[who].append(timer(node_fn if who == "node" else rec_fn,
                                reps=reps))
        nb = results[f"{kid} node"]
        cmp[kid] = dict(node_ms=float(np.mean(t["node"])),
                        record_ms=float(np.mean(t["record"])),
                        node_bound_ms=nb["bound_ms"],
                        record_bound_ms=rb["bound_ms"])
        log("node-vs-record", f"{kid}: node {cmp[kid]['node_ms']:.4f} ms "
                              f"(bound {nb['bound_ms']:.4f}), the record's "
                              f"gridded instance (B = 1) "
                              f"{cmp[kid]['record_ms']:.4f} ms (bound "
                              f"{rb['bound_ms']:.4f}); outputs bit for bit; "
                              f"means of 2 in turns")
    timing["node_vs_record"] = cmp


def phase_sharded_jet(dev, results, timing) -> None:
    """Inside phase "sharded-1x1"'s process group (one NCCL rank): the
    global jet ("pallas": K1 with the node planes and the projection
    planes -> K4 -> the self-wrap and seam folds -> K5 with the node planes)
    through ``ShardedWaveGrowth2D`` on a (1, 1) mesh at the solver
    tolerances ``SHARDED_TRI_TOLS``, 3 steps against the single-device
    step at ``assert_states``' rtol 2e-3, the counters set to 0 just before
    and read just after (K1 == K4 == K5 == 3); the block's node planes are
    the grid's; the graphed sharded step bit for bit its eager steps
    (``sharded_graph_check``)."""
    grid = tripolar_grid(dev, *TRI_SUPER)
    model = jet_model(grid, "pallas", tols=SHARDED_TRI_TOLS)
    ref = eager_steps(model, model.init_state(), 3)
    sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
    reset_counters()
    ms = eager_steps(sh, sh.init_state(), 3)
    c = counters()
    assert torch.equal(model.node_planes(sh.local_grid),
                       model.node_planes(grid))
    err = assert_states("sharded jet pallas vs single device, 3 steps", ms,
                        ref)
    m = check_tripolar("sharded jet", model, ms)
    assert c["K1"] == c["K4"] == c["K5"] == 3, c
    assert c["K2"] == c["K3"] == c["K6"] == 0, c
    results["K1 node"]["launches"] += c["K1"]
    results["K5 node"]["launches"] += c["K5"]
    results["K4"]["launches"] += c["K4"]
    graph = sharded_graph_check("sharded jet pallas", sh, ms,
                                {"K1 node": "K1", "K4": "K4",
                                 "K5 node": "K5"}, results)
    sh.release_graph()
    timing["sharded_jet_max_abs_err"] = err
    timing["sharded_jet_graph"] = graph
    log("sharded-jet", f"global jet pallas {grid.nx} x {grid.ny} on a (1, 1) "
                       f"NCCL mesh: 3 steps vs single device max abs err "
                       f"{err:.3e}, counters equal; launches {c}; metrics "
                       f"{m}")


def run_example(name: str, *argv):
    """``picles_torch/examples/<name>`` in this process at its full size
    (no PICLES_SMOKE) on the card, with no outdir; returns its globals."""
    import runpy

    saved = sys.argv
    sys.argv = [name, "--device", "cuda", *argv]
    os.environ.pop("PICLES_SMOKE", None)
    try:
        return runpy.run_path(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "picles_torch",
            "examples", name), run_name="example")
    finally:
        sys.argv = saved


def phase_examples(timing) -> None:
    """Phase "examples": the port's examples 00-05 on the card at their
    full sizes, asserting what tests/test_examples.py asserts of the JAX
    examples, the counters set to 0 just before each and read just after
    (a graphed Simulation.run calls each kernel in its warm-up and capture
    only).  No outdir is given: the figures of examples 00-02, example
    03's HDF5 store and movie are not written (this machine has neither
    matplotlib nor h5py); example 03 keeps its checkpoint in a temporary
    directory.  Example 04 runs one NCCL rank in this process, example 05
    two gloo ranks sharing the card as processes."""
    out = {}

    def run(name, *argv):
        reset_counters()
        t0 = time.perf_counter()
        g = run_example(name, *argv)
        out[name] = dict(wall_s=time.perf_counter() - t0, launches=counters())
        log("examples", f"{name}: {out[name]['wall_s']:.1f} s wall, "
                        f"launches {out[name]['launches']}")
        return g

    g = run("example_00_minimal.py")
    states = g["states"]
    assert np.all(np.isfinite(states)) and states[-1, ..., 0].mean() > 0
    assert g["sim"].n_steps() == len(states) - 1
    g = run("example_01_sphere_swell.py")
    e_last = g["snaps"][-1][..., 0]
    assert np.all(np.isfinite(e_last)) and e_last.sum() > 0
    assert int(g["ms"].metrics.n_failed) == 0
    x = g["grid"].x.cpu().numpy()[:, 0]
    assert x[11] < g["com_lon"] < x[40], g["com_lon"]
    g = run("example_02_tripolar_global.py")
    assert g["model"].winds.kernel.kind == WindKind.NODE
    e, mask = g["e"], g["grid"].mask.cpu().numpy()
    assert np.all(np.isfinite(e)) and e[mask == 1].max() > 0
    assert abs(float(e[mask == 0].sum())) <= 1e-10
    g = run("example_03_checkpoint_restart.py")
    assert np.array_equal(g["final_a"], g["final_b"])
    g = run("example_04_sharded.py")
    assert np.all(np.isfinite(g["states"])) and g["n_failed"] == 0
    assert g["MESH"] == (1, 1) and g["transport"] == "nccl, device tensors"
    assert g["rel"] < 2e-3
    out["example_04_sharded.py"]["rel"] = g["rel"]
    g = run("example_05_multiprocess.py")
    assert np.isfinite(g["field"]).all() and g["n_active"] == 32 * 32
    assert g["field"][..., 0].mean() > 0
    for name, kerns in (("example_00_minimal.py", ("K1", "K2", "K3")),
                        ("example_01_sphere_swell.py", ("K1", "K2", "K3")),
                        ("example_02_tripolar_global.py", ("K1", "K2", "K3")),
                        ("example_03_checkpoint_restart.py",
                         ("K1", "K2", "K3")),
                        ("example_04_sharded.py", ("K1", "K4", "K3"))):
        c = out[name]["launches"]
        assert all(c[k] > 0 for k in kerns), (name, c)
    timing["examples"] = out
    log("examples", "left out without an outdir: examples 00-02's figures, "
                    "example 03's HDF5 store and movie")



# ---------------------------------------------------------------------------
# phase "rest": the modules ported last (fetch relations, the deposit's
# dispatcher and merge rule, trajectories, diagnostics, the B02 regression)
# ---------------------------------------------------------------------------

# the fetch relations held card against CPU: (name, argument planes)
REST_FETCH = (("X_tilde", "XU"), ("t_tilde", "tU"), ("E_tilde", "EU"),
              ("f_p_tilde", "fU"), ("X_tilde_from_tau", "T"),
              ("tau_from_X_tilde", "x"), ("min_fetch", "x"),
              ("c_p_fetch", "xU"), ("H_s_fetch", "xU"), ("E_fetch", "xU"),
              ("E_fetch_tilde", "x"), ("X_tilde_time_and_fetch", "tUX"),
              ("f_m_from_X_tilde", "Ux"), ("alpha_j", "Uf"),
              ("E_JONSWAP", "fa"), ("f_m_from_X", "UX"),
              ("X_tilde_j_U_freq", "Uf"), ("X_j_U_freq", "Uf"),
              ("X_tilde_j_U_tau", "Ut"), ("tau_j", "UX"),
              ("f_m_given_U_tau", "Ut"), ("c_g_U_tau", "Ut"), ("E_j", "Ut"),
              ("PMParameters", "U"), ("JONSWAP_omega", "UpW"),
              ("JONSWAP_frequency", "UPf"), ("PMSpectrum", "Uf"))
REST_SEEDS = ("get_initial_windsea", "MinimalWindsea", "MinimalParticle",
              "MinimalState", "get_initial_windsea_particle_state",
              "get_initial_windsea_1d", "MinimalWindsea_1d")
REST_SPECTRA = ("JONSWAP_omega", "JONSWAP_frequency", "PMSpectrum")
REST_STEPS = 4         # record_trajectories' steps at 1536^2
REST_K = 4             # sub-windows a step at saving_step = DT / 4
REST_CROP = 256        # the fixed-substep check of the sub-window advance
# the graphed fused flagship step as root PERF.md section 5 records it (H100
# 80GB HBM3, 700 W, 7 x 10 steps)
GRAPHED_FLAGSHIP_MS = 1.5144
# tests/test_b02_resolution_convergence.py's box, horizon and sizes
B02_L = 200e3
B02_T = 4 * 3600.0
B02_SIZES = (11, 16, 23)


def fetch_planes(dev, seed: int = 12) -> dict:
    """Seeded float32 planes at 1536^2 for the fetch relations, keyed by
    the letters of REST_FETCH: U wind speed, X fetch (m), x non-dim fetch,
    t and T durations (s, non-dim), E energy, f frequency (Hz), a the
    JONSWAP alpha, p/P a peak (angular, Hz) as a Python number, W angular
    frequency; u and v wind components with exact zeros."""
    rng = np.random.default_rng(seed)
    n = (FLAG_N, FLAG_N)

    def uni(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, n).astype(np.float32),
                               device=dev)

    def logu(lo, hi):
        return torch.as_tensor(np.exp(rng.uniform(np.log(lo), np.log(hi), n)
                                      ).astype(np.float32), device=dev)

    U, f = uni(1.0, 30.0), uni(0.04, 0.6)
    u, v = uni(-25.0, 25.0), uni(-25.0, 25.0)
    u[0, :4], v[0, :4] = 0.0, 0.0
    return dict(U=U, X=logu(1e2, 1e6), x=logu(10.0, 1e6),
                t=uni(600.0, 2 * DAY), T=logu(10.0, 1e6), E=uni(1e-3, 20.0),
                f=f, a=uni(1e-3, 3e-2), p=2 * np.pi * 0.12, P=0.12,
                W=2 * np.pi * f, u=u, v=v)


def spectral_exponent(name: str, args) -> torch.Tensor:
    """|x| of a spectrum's exp(-x) (float64, on the CPU)."""
    U = args[0].double()
    if name == "PMSpectrum":
        return 1.25 * (0.879 * G_ACC / U / (2 * np.pi * args[1].double())) ** 4
    wp, w = args[1], args[2].double()
    if name == "JONSWAP_frequency":
        wp, w = 2 * np.pi * wp, 2 * np.pi * w
    return 1.25 * (wp / w) ** 4


def leaves_of(out) -> list:
    """(leaf, is a log energy) of a fetch relation's output: a tensor, a
    dict, a WindSea or a stacked particle [lne, cg_x, cg_y, 0, 0]."""
    if isinstance(out, dict):
        return [(out[k], False) for k in sorted(out)]
    if hasattr(out, "_fields"):
        return [(getattr(out, k), k == "lne") for k in out._fields]
    return [(out, False)]


# the fetch relations of up to four chained powers (the seeds' E and f_m,
# E_j): CUDA's powf is within 2 ulp, the CPU's within 1, and each power
# multiplies the error of its argument by its exponent (E ~ X^1.1 ~ f_m^-3.33
# in a seed): 1.63e-6 measured on the card (E of the JONSWAP seed)
REST_CHAINED_RTOL = 3e-6


def check_fetch(dev) -> dict:
    """(a) Each fetch relation, and each windsea seed of both types, on the
    1536^2 planes on the card against the same function on their CPU
    copies: within rtol 1e-6, REST_CHAINED_RTOL for the chained powers of
    the seeds and E_j; the spectra within rtol 1e-6 (1 + x), x the
    magnitude of their exp(-x), which multiplies a relative error of x by
    x; a log energy's error relative to max(|lne|, 1), as the absolute
    error of a log is the relative error of its argument (lne near 0,
    where E is near 1, holds E's ulps).  Returns each function's max
    relative error (the spectra's over 1 + x)."""
    planes = fetch_planes(dev)
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in planes.items()}
    worst, bad = {}, {}
    cases = [(name, keys, {}) for name, keys in REST_FETCH]
    cases += [(name, "uT" if name.endswith("_1d") else "uvT",
               {"type": kind})
              for name in REST_SEEDS for kind in ("JONSWAP", "PM")]
    for name, keys, kw in cases:
        tag = f"{name}({kw['type']})" if kw else name
        fn = getattr(FR, name)
        # the seeds take a duration scale in seconds as a number
        card_args = [planes[k] if k != "T" or not kw else 3600.0
                     for k in keys]
        cpu_args = [cpu[k] if k != "T" or not kw else 3600.0 for k in keys]
        got, want = fn(*card_args, **kw), fn(*cpu_args, **kw)
        if name in ("MinimalParticle", "get_initial_windsea_particle_state"):
            got, want = (got.unbind(-1), want.unbind(-1))
            pairs = zip(got, want, (True, False, False, False, False))
        else:
            pairs = ((g, w, lg) for (g, lg), (w, _) in
                     zip(leaves_of(got), leaves_of(want)))
        err = 0.0
        for g, w, is_log in pairs:
            assert g.device.type == "cuda" and g.dtype == w.dtype, tag
            g, w = g.cpu().double(), w.double()
            scale = w.abs().clamp(min=1.0) if is_log else w.abs()
            rel = (g - w).abs() / scale.clamp(min=1e-30)
            rel = torch.where(g == w, 0.0, rel)
            if name in REST_SPECTRA:
                rel = rel / (1.0 + spectral_exponent(name, cpu_args))
            err = max(err, float(rel.max()))
        worst[tag] = err
        rtol = REST_CHAINED_RTOL if kw or name == "E_j" else 1e-6
        if not err <= rtol:
            bad[tag] = (err, rtol)
    log("rest", "(a) max rel err card against CPU at "
                f"{FLAG_N}^2 (spectra over 1 + x): "
                + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    assert not bad, f"fetch relations beyond their rtol: {bad}"
    return worst


def check_scatter_and_merge(dev) -> dict:
    """(b) ``pic.scatter(mode="dense_cuda")`` (and "dense_pallas") at
    1536^2, halo 3, periodic: two launches of K2 counted by trace, each bit
    for bit ``pic_gather``, within K2's rtol 1e-5 (atol 1e-6 of the scale)
    of ``mode="dense"``, the clamped count equal; and ``merge_2d_angle`` on
    the card against the CPU."""
    from picles_torch.ops.pic import merge_2d_angle, scatter as pic_scatter

    rng = np.random.default_rng(5)
    n = FLAG_N
    stats = GridStats(nx=n, ny=n, bx=Boundary.PERIODIC, by=Boundary.PERIODIC)

    def plane(fn, *a):
        return torch.as_tensor(fn(*a, (n, n)).astype(np.float32), device=dev)

    xr, yr = plane(rng.uniform, -3.2, 3.2), plane(rng.uniform, -3.2, 3.2)
    charge = torch.stack([plane(rng.uniform, 0.0, 1.0),
                          plane(rng.normal, 0.0, 0.1),
                          plane(rng.normal, 0.0, 0.1)], dim=-1)
    act = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
    box = {}

    def run():
        box["cuda"] = pic_scatter(xr, yr, charge, act, stats, 3,
                                  mode="dense_cuda")
        box["pallas"] = pic_scatter(xr, yr, charge, act, stats, 3,
                                    mode="dense_pallas")

    reset_counters()
    tstats, got = trace_window(run, 1, {KERNEL_KEYS["K2"]: 2})
    host = counters()
    assert host["K2"] == 2 * tstats["trace_attempts"], host
    ref, rst = pic_gather(xr, yr,
                          tuple(c.contiguous() for c in charge.unbind(-1)),
                          act, stats, 3)
    P, pst = scatter_dense(xr, yr, charge, act, stats, 3)
    err = 0.0
    for mode, (S, st) in box.items():
        assert_bitwise(f"scatter({mode}) against pic_gather",
                       S.unbind(-1), ref)
        assert int(st.clamped) == int(rst.clamped) == int(pst.clamped)
        for c in range(3):
            err = max(err, assert_close(
                f"scatter({mode}) ch{c} against dense", S[..., c], P[..., c],
                1e-5, 1e-6 * float(P[..., c].abs().max())))
    g = torch.as_tensor(rng.normal(0.0, 1.0, (n, n, 3)).astype(np.float32))
    c = torch.as_tensor(rng.normal(0.0, 1.0, (n, n, 3)).astype(np.float32))
    g[..., 0], c[..., 0] = g[..., 0].abs(), c[..., 0].abs()
    g[:8, :, 1:] = 0.0
    m_card = merge_2d_angle(g.to(dev), c.to(dev)).cpu()
    m_cpu = merge_2d_angle(g, c)
    merge_err = assert_close("merge_2d_angle card against CPU", m_card,
                             m_cpu, 1e-6, 0.0)
    merge_bitwise = torch.equal(bits(m_card), bits(m_cpu))
    log("rest", f"(b) scatter dense_cuda/dense_pallas at {n}^2 halo 3: K2 "
                f"traced {got[KERNEL_KEYS['K2']]} launches, bit for bit "
                f"pic_gather, max abs err {err:.3e} against dense, clamped "
                f"{int(rst.clamped)}; merge_2d_angle card vs CPU max abs err "
                f"{merge_err:.3e}, bit for bit: {merge_bitwise}")
    return dict(k2_traced=got[KERNEL_KEYS["K2"]], k2_host=host["K2"],
                scatter_max_abs_err=err, merge_max_abs_err=merge_err,
                merge_bitwise=merge_bitwise)


def record(model, ms, n: int, K: int):
    from picles_torch.utils.particle_tools import record_trajectories

    return record_trajectories(model, ms, n, saving_step=DT / K)


def check_trajectories(dev) -> dict:
    """(c) ``record_trajectories`` on the fused flagship at 1536^2,
    REST_STEPS steps from the seed: at K = 1 the history (each row a copy
    of the graph's replayed state) bit for bit ``step_n``'s; at K = 4 a
    trace holds 4 more K1 launches a step (REST_STEPS (1 + 4) K1, REST_STEPS
    K6) and the history equals K = 1's; on a 256^2 crop in fixed-substep
    mode the sub-window advance (4 launches of K1 a step) within K1's 5e-6
    of the plain ``integrate_to`` on the card.  ms/step at K = 1 and K = 4
    and of the graphed step (``step_n_quiet``) in turns."""
    from picles_torch.utils.particle_tools import particle_z

    model = flagship_model(FLAG_N, dev, remesh_mode="fused")
    assert model.graphed
    ms = model.init_state()
    reset_counters()
    final, h1 = record(model, ms, REST_STEPS, 1)
    c1 = counters()
    assert c1["K1"] == c1["K6"] == WARMUP_STEPS + 1, c1   # warm-up, capture
    ref, states = model.step_n(ms, REST_STEPS)
    assert torch.equal(bits(h1["state"]), bits(states)), \
        "K = 1 history differs from step_n"
    assert_state_bitwise("K = 1 final state against step_n", final, ref)
    assert torch.equal(bits(h1["z"][-1]), bits(particle_z(ref.particles)))
    assert "z_fine" not in h1
    box = []

    def run():
        box.append(record(model, ms, REST_STEPS, REST_K))

    reset_counters()
    _, got = trace_window(run, REST_STEPS,
                          {KERNEL_KEYS["K1"]: REST_STEPS * (1 + REST_K),
                           KERNEL_KEYS["K6"]: REST_STEPS})
    host = counters()
    assert host["K1"] == REST_STEPS * REST_K * len(box) and \
        host["K6"] == 0, host
    f4, h4 = box[-1]
    assert torch.equal(bits(h4["state"]), bits(states))
    assert h4["z_fine"].shape == (REST_STEPS * REST_K, FLAG_N, FLAG_N, 5)
    t_fine = h4["t_fine"][:, 0, 0].cpu().numpy()
    assert np.allclose(t_fine, DT / REST_K * np.arange(1, REST_STEPS
                                                       * REST_K + 1)), t_fine
    del box, h1, h4, f4, final, states

    # the sub-window advance against the plain integrator, fixed substeps
    crop = WaveGrowth2D(
        cartesian_box(2e3 * (REST_CROP - 1), REST_CROP, 2e3 * (REST_CROP - 1),
                      REST_CROP, periodic_boundary=(True, True), device=dev),
        constant_winds(10.0, 10.0),
        dataclasses.replace(settings("bosh3"), dt=30.0, adaptive=False),
        config=WaveGrowth2DConfig(periodic_boundary=True,
                                  dt_reset_mode="carry",
                                  halo=((0, 3), (0, 3)), remesh_mode="fused"))
    s0 = crop.step(crop.init_state())
    _, hc = record(crop, s0, 1, REST_K)
    P = s0.particles
    z, t, dt = particle_z(P), P.t, P.dt
    active = P.on & crop.active_mask
    crop_err = 0.0
    for k in range(REST_K):
        r = integrate_to(crop.rhs, z, t, t + DT / REST_K, dt, crop.aux,
                         active, crop.solver)
        z, t, dt = r.z, r.t, r.dt
        crop_err = max(crop_err, assert_close(
            f"sub-window {k} against integrate_to", hc["z_fine"][k], z, 1e-5,
            5e-6))
        assert_close(f"sub-window {k} t", hc["t_fine"][k], t, 1e-6, 0.0)

    # ms/step in turns: K = 1, K = 4, the graphed step; then reversed
    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REST_STEPS

    runs = {"K=1": lambda: record(model, ms, REST_STEPS, 1),
            "K=4": lambda: record(model, ms, REST_STEPS, REST_K),
            "graphed step": lambda: model.step_n_quiet(ms, REST_STEPS)}
    ms_step = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            ms_step[k].append(timed(runs[k]))
    ms_step = {k: sum(v) / len(v) for k, v in ms_step.items()}
    model.release_graph()
    log("rest", f"(c) record_trajectories, fused flagship {FLAG_N}^2, "
                f"{REST_STEPS} steps: K = 1 bit for bit step_n; K = 4 traced "
                f"{got[KERNEL_KEYS['K1']]} K1 and {got[KERNEL_KEYS['K6']]} "
                f"K6 launches; {REST_CROP}^2 fixed-substep sub-windows within "
                f"{crop_err:.3e} of integrate_to; ms/step (means of 2 in "
                f"turns) K = 1 {ms_step['K=1']:.4f}, K = 4 "
                f"{ms_step['K=4']:.4f}, graphed step "
                f"{ms_step['graphed step']:.4f} (PERF.md: {GRAPHED_FLAGSHIP_MS})")
    return dict(k1_traced=got[KERNEL_KEYS["K1"]],
                k6_traced=got[KERNEL_KEYS["K6"]], k1_host=host["K1"],
                crop_max_abs_err=crop_err, ms_per_step=ms_step,
                graphed_flagship_ms_recorded=GRAPHED_FLAGSHIP_MS)


def check_diagnostics(dev) -> dict:
    """(d) ``StepTimer`` and ``profile_trace`` around 10 graphed steps of
    the fused flagship (``step_jit``): StepTimer's median (wall, to the
    card's synchronize) beside the CUDA-event median of the same calls;
    the Chrome trace written into its directory names K1 and K6."""
    from picles_torch.utils.diagnostics import StepTimer, profile_trace

    model = flagship_model(FLAG_N, dev, remesh_mode="fused")
    step = model.step_jit()
    ms = step(model.init_state())
    timer = StepTimer()
    for _ in range(10):
        with timer.measure(sync_on=ms.state):
            ms = step(ms)
    ev = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ms = step(ms)
        b.record()
        torch.cuda.synchronize()
        ev.append(a.elapsed_time(b))
    timer_ms = timer.summary()["p50_s"] * 1e3
    event_ms = float(np.median(ev))
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        logdir = os.path.join(tmp, "trace")
        with profile_trace(logdir):
            for _ in range(10):
                ms = step(ms)
        files = os.listdir(logdir)
        assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
        with open(os.path.join(logdir, files[0])) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    k1 = sum(kernel_named(KERNEL_KEYS["K1"], nm) for nm in names)
    k6 = sum(kernel_named(KERNEL_KEYS["K6"], nm) for nm in names)
    assert k1 > 0 and k6 > 0, (k1, k6)
    model.release_graph()
    log("rest", f"(d) 10 graphed fused flagship steps (step_jit): StepTimer "
                f"median {timer_ms:.4f} ms, CUDA-event median {event_ms:.4f} "
                f"ms; profile_trace wrote {files[0]} naming K1 {k1} and K6 "
                f"{k6} times")
    return dict(step_timer_median_ms=timer_ms, cuda_event_median_ms=event_ms,
                trace_k1=k1, trace_k6=k6)


def write_b02_winds(path: str) -> str:
    """tests/test_b02_resolution_convergence.py's wind file (a Gaussian
    blob moving +x over 2 T), as NetCDF-3 (scipy) in place of h5py."""
    from scipy.io import netcdf_file

    nt, nyw, nxw = 9, 12, 12
    ts = np.linspace(0, 2 * B02_T, nt)
    xs = np.linspace(0, B02_L, nxw)
    ys = np.linspace(0, B02_L, nyw)
    Tg, Yg, Xg = np.meshgrid(ts, ys, xs, indexing="ij")
    x0 = 0.25 * B02_L + 6.0 * Tg
    u = 2.0 + 10.0 * np.exp(-(((Xg - x0) / (0.3 * B02_L)) ** 2
                              + ((Yg - 0.5 * B02_L) / (0.4 * B02_L)) ** 2))
    with netcdf_file(path, "w") as f:
        for name, ax in (("time", ts), ("latitude", ys), ("longitude", xs)):
            f.createDimension(name, len(ax))
            f.createVariable(name, "f8", (name,))[:] = ax
        for name, a in (("u10", u), ("v10", 0.3 * u)):
            f.createVariable(name, "f4", ("time", "latitude", "longitude")
                             )[:] = a.astype(np.float32)
    return path


def b02_model(gw, nx: int, dt: float, device):
    ws = FR.MinimalWindsea(10.0, 10.0, dt)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=dt,
                       timestep=dt, total_time=B02_T, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True)
    grid = cartesian_box(B02_L, nx, B02_L, nx, periodic_boundary=(False, False),
                         device=device)
    return WaveGrowth2D(grid, gw, sett,
                        config=WaveGrowth2DConfig(periodic_boundary=False))


def b02_hs(sim) -> np.ndarray:
    e = sim.store.store[-1][..., 0]
    assert np.all(np.isfinite(sim.store.as_array()))
    return 4.0 * np.sqrt(np.maximum(e, 0.0))


def check_b02(dev) -> dict:
    """(e) The B02 regression through the kernels: the three resolutions
    at DT and nx = 16 at DT / 2, each through ``Simulation.run`` with a
    CashStore on the graphed gridded step (K1, K2 and K3's gridded
    instances, counted by trace), the JAX test's assertions on the final
    Hs fields; and nx = 16 at DT run on the CPU (the plain versions), its
    field against the card's."""
    from scipy.interpolate import RegularGridInterpolator

    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        path = write_b02_winds(os.path.join(tmp, "b02_winds.nc"))
        gw = load_gridded_winds_2d(path, device=dev)
        gw_cpu = load_gridded_winds_2d(path, device="cpu")
    fields, traced = {}, {}
    want = ("K1", "K2", "K3")
    for nx, dt in [(n, DT) for n in B02_SIZES] + [(16, DT / 2)]:
        m = b02_model(gw, nx, dt, dev)
        assert m.graphed and m.resolved_config().scatter_mode == "dense_cuda"
        m._capture(m.init_state())
        steps = Simulation.create(m, stop_time=B02_T).n_steps()
        sim, got, _ = traced_run(m, B02_T, {k: steps for k in want},
                                 cash_store=True)
        traced[f"{nx}@{dt:g}"] = got
        assert int(sim.state.metrics.n_failed) == 0
        fields[(nx, dt)] = b02_hs(sim)
        m.release_graph()
    probe = np.linspace(0.15 * B02_L, 0.85 * B02_L, 25)
    PX, PY = np.meshgrid(probe, probe, indexing="ij")
    pts = np.stack([PX.ravel(), PY.ravel()], -1)
    hs_p = {nx: RegularGridInterpolator(
        (np.linspace(0, B02_L, nx),) * 2, fields[(nx, DT)])(pts)
        for nx in B02_SIZES}
    norm = np.abs(hs_p[B02_SIZES[-1]]).max()
    assert norm > 0.5, norm
    errs = [float(np.sqrt(np.mean((hs_p[a] - hs_p[b]) ** 2)) / norm)
            for a, b in zip(B02_SIZES[:-1], B02_SIZES[1:])]
    assert errs[1] < errs[0], errs
    assert errs[-1] < 0.03, errs
    a, b = fields[(16, DT)], fields[(16, DT / 2)]
    dt_err = float(np.sqrt(np.mean((a - b) ** 2)) / np.abs(a).max())
    assert dt_err < 0.04, dt_err
    sim = Simulation.create(b02_model(gw_cpu, 16, DT, "cpu"),
                            stop_time=B02_T)
    sim.run(cash_store=True)
    cpu = b02_hs(sim)
    card_cpu_max = float(np.abs(a - cpu).max())
    card_cpu_rms = float(np.sqrt(np.mean((a - cpu) ** 2)) / np.abs(cpu).max())
    assert card_cpu_rms < 0.04, card_cpu_rms   # the DT refinement's bound
    log("rest", f"(e) B02 on the card: successive RMS differences "
                f"{errs[0]:.4f}, {errs[1]:.4f}; DT refinement {dt_err:.4f}; "
                f"nx = 16 card against CPU: max abs Hs difference "
                f"{card_cpu_max:.3e} m, normalized RMS {card_cpu_rms:.3e}; "
                f"launches by trace {traced}")
    return dict(errs=errs, dt_err=dt_err, card_cpu_max_abs_hs=card_cpu_max,
                card_cpu_rms=card_cpu_rms, traced=traced)


def phase_rest(dev, results, timing) -> None:
    """Phase "rest": (a)-(e) above.  K1, K2 and K3 run here on paths of
    their own (the sub-window advance, the dispatcher's deposit, the B02
    gridded steps), each path's launches counted by trace (the host's
    counters set to 0 just before); the counts go into the kernels line as
    ``rest_launches``."""
    t0 = time.perf_counter()
    out = dict(fetch_max_rel_err=check_fetch(dev))
    out["scatter"] = check_scatter_and_merge(dev)
    out["trajectories"] = check_trajectories(dev)
    out["diagnostics"] = check_diagnostics(dev)
    out["b02"] = check_b02(dev)
    b02 = out["b02"]["traced"].values()
    rest = {"K1": out["trajectories"]["k1_traced"]
            + sum(g["K1"] for g in b02),
            "K2": out["scatter"]["k2_traced"] + sum(g["K2"] for g in b02),
            "K3": sum(g["K3"] for g in b02)}
    for k, v in rest.items():
        assert v > 0, f"{k} was not launched in phase rest"
        results[k]["rest_launches"] = v
    out["seconds"] = time.perf_counter() - t0
    timing["rest"] = out
    log("rest", "not run on the card: the orbax checkpoint backend (needs "
                "tensorstore) and the DataFrame converters (need pandas), "
                "which this machine lacks; no check counts them")
    log("rest", f"launches by trace {rest}; {out['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# wind callables that read their time: the traced kind (phase
# "traced-winds")
# ---------------------------------------------------------------------------

TRACED_REPLACES = {"K1 traced": "picles_tpu/ops/advance_pallas.py:79",
                   "K3 traced": "picles_tpu/ops/advance_pallas.py:219",
                   "K5 traced": "picles_tpu/ops/remesh_pallas.py:60",
                   "K6 traced": "picles_tpu/ops/pic_pallas.py:398"}
TRACED_SWITCHES = (0.0, 3600.0, 7200.0, 9000.0)
TRACED_PROBE_POINTS = 1 << 20
PULSE_STEPS = 144      # a day of DT
PULSE_PLAIN_STEPS = 12
RETURN_STEPS = 12
PULSE_LAYERS = 4
# the pulse's configurations: fused (the flagship: bosh3, carried dt, halo
# ((0,3),(0,3))), default (tsit5, the Hairer reset K3 on re-lit lanes,
# halo 3), and the fused flagship on an open box, whose upwind nodes go
# off once the wind stops; the kernels (their rows) each launches a step
PULSE_PATHS = {"fused": ("K1 traced", "K6 traced"),
               "default": ("K1 traced", "K2", "K3 traced"),
               "fused open": ("K1 traced", "K6 traced")}


def pulse_winds(U: float = 12.0, t_on: float = 0.0,
                t_off: float = 2 * 3600.0) -> Winds2D:
    """tests/test_growing_decaying_winds.py:16-26's pulse in torch: U from
    ``t_on`` to ``t_off``, then calm (a callable that reads its time: the
    traced kind)."""
    def u(x, y, t):
        t = torch.as_tensor(t)
        return torch.where((t >= t_on) & (t < t_off), U, 0.0) + 0.0 * x

    return Winds2D(u=u, v=lambda x, y, t: torch.zeros_like(x))


def returning_winds() -> Winds2D:
    """tests/test_growing_decaying_winds.py:70-74's returning wind: calm
    until 1 h, then 12 m/s."""
    return Winds2D(u=lambda x, y, t: torch.where(torch.as_tensor(t) >= 3600.0,
                                                 12.0, 0.0) + 0.0 * x,
                   v=lambda x, y, t: torch.zeros_like(x))


def ex02_jet_u(x, y, t):
    """picles_torch/examples/example_02_tripolar_global.py's zonal jet."""
    return 12.0 * torch.exp(-(((y - 40.0) / 20.0) ** 2))


def every_op_u(x, y, t):
    """The NaN half of ``every_op_winds``: minimum, maximum and clamp
    (both bounds, one, ``clamp_min``, ``clamp_max``) with a NaN operand in
    either place (log and sqrt of negative numbers below x = 1e5 and
    2e5), selected by ``ne``; NaN below x = 1e5."""
    a = x * 1e-5
    b = y / 30.0
    lo = torch.log(a - 1.0)
    sq = torch.sqrt(a - 2.0)
    both = torch.minimum(lo, sq) + torch.maximum(sq, b) \
        + torch.clamp_min(sq, 0.2)
    one = torch.clamp(lo, -1.0, 0.5) + torch.maximum(b, lo) \
        + torch.minimum(lo, b)
    finite = torch.clamp(b, min=-1.0) + torch.clamp(b, max=1.0) \
        + torch.clamp_max(a, 2.5)
    return torch.where(both != both, one, both) + finite


def every_op_v(x, y, t):
    """The finite half of ``every_op_winds``: the transcendentals, each
    exponent the emitter writes apart (2, 3, 0.5, -1, 1, 0 and a general
    one), divisions by a host scalar, by a device value and of a host
    scalar, ``reciprocal``, ``rsub``, ``neg``, the comparisons and the
    logical operations, a bool cast and the fills."""
    a = x * 1e-5
    b = y / 30.0
    h = t / 3600.0
    c = a + 2.0
    w = torch.sin(h) + torch.cos(b) + torch.tanh(a - 1.5) + torch.exp(-a) \
        + torch.log(a + 1.5) + torch.sqrt(torch.abs(b))
    p = b ** 2 + 0.1 * b ** 3 + torch.abs(b) ** 0.5 + c ** -1 + c ** 1.7 \
        + b ** 1 + b ** 0
    r = 3.0 / c - torch.reciprocal(c) + torch.rsub(a, 1.0) - (-b) \
        + h / (b * b + 1.0) + torch.div(b, c)
    on = ((h >= 1.0) & (h < 3.0)) | (~(b > 0.5) ^ (a <= 1.0))
    same = torch.logical_and(torch.eq(b, b), torch.ne(a, 1.5))
    odd = torch.logical_xor(torch.logical_or(on, b < 0.0),
                            torch.logical_not(same))
    f = torch.full_like(x, 0.25) * on.float() + torch.zeros_like(x) \
        + torch.ones_like(x) * torch.where(odd, 1.0, -1.0)
    return w + p + r + f


def every_op_winds() -> Winds2D:
    """A synthetic wind whose graph holds every operation the tracer
    takes (``wind_trace.OPS``), with NaN operands reaching minimum, maximum
    and clamp: the check that the emitter writes each as ATen's CUDA
    kernels compute it.  Not a physical wind."""
    return Winds2D(u=every_op_u, v=every_op_v)


def traced_callables() -> dict:
    """The callables of the phase: the pulse, the returning wind,
    ``time_cosine_winds(10, 5, 6 h, t_off=9000)`` stripped of its
    descriptor, example 02's jet (steady: the model gives it the node
    kind, so it is forced through the tracer at the wrappers) and the
    synthetic ``every_op_winds``."""
    cos = time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)
    return {"pulse": pulse_winds(), "returning": returning_winds(),
            "time_cosine stripped": Winds2D(u=cos.u, v=cos.v),
            "example 02 jet": Winds2D(u=ex02_jet_u, v=jet_v),
            "every op": every_op_winds()}


def traced_build(dev, winds: dict) -> dict:
    """Each callable traced on the card and its library built, all at
    once (a thread a library, nvcc's processes in parallel), then loaded;
    the pulse's and the time-cosine's sources compiled to PTX and checked
    for float64 (``unexpected_double_ops``).  Returns name -> descriptor,
    and the build's wall seconds."""
    kerns = {k: traced_kernel(w, dev) for k, w in winds.items()}
    assert all(k.kind == WindKind.TRACED for k in kerns.values())
    traced = [k.traced for k in kerns.values()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(traced) + 2) as ex:
        builds = list(ex.map(cuda_build.build_traced, traced))
        bad = list(ex.map(cuda_build.unexpected_double_ops,
                          [kerns["pulse"].traced,
                           kerns["time_cosine stripped"].traced]))
    wall = time.perf_counter() - t0
    for tr in traced:
        cuda_build.traced_library(tr)
    assert not any(bad), f"float64 in the traced kernels: {bad}"
    regs = sorted({ln.split(":", 1)[1].strip()
                   for b in builds for ln in b.log.splitlines()
                   if "registers" in ln})
    log("traced-winds", f"{len(traced)} traced libraries built in {wall:.1f} "
                        f"s (each {[round(b.seconds, 1) for b in builds]} "
                        f"s); ptxas: {' | '.join(regs)}; no float64 beyond "
                        f"cosf's argument reduction")
    return kerns, wall


def traced_probe_check(dev, winds: dict, kerns: dict, n: int) -> dict:
    """(a) The emitted function alone (``picles_traced_probe``) on ``n``
    points (x, y, t), t exactly at each switch time and its float32
    neighbours among them, x and y infinite or NaN at a few, bit for bit
    (NaN's bits too) the callable run by torch on the card, and the
    tracer's plain evaluator bit for bit too.  Returns name -> the emitted
    function's operation count."""
    rng = np.random.default_rng(41)
    xs = rng.uniform(-1e5, 3.1e6, n).astype(np.float32)
    ys = rng.uniform(-90.0, 90.0, n).astype(np.float32)
    # the last points: zeros of either sign, the NaN thresholds of
    # ``every_op_u``, infinities and NaN
    xs[-7:] = [0.0, -0.0, 1e5, 2e5, np.inf, -np.inf, np.nan]
    ys[-7:] = [0.0, -0.0, 45.0, -90.0, np.nan, np.inf, -np.inf]
    x = torch.as_tensor(xs, device=dev)
    y = torch.as_tensor(ys, device=dev)
    t = rng.uniform(0.0, 2e4, n).astype(np.float32)
    sw = np.array(TRACED_SWITCHES, np.float32)
    near = np.concatenate([sw, np.nextafter(sw, np.float32(-1e9)),
                           np.nextafter(sw, np.float32(1e9))])
    t[:near.size] = near
    t[near.size:near.size + 4096] = np.repeat(sw, 1024)
    t = torch.as_tensor(t, device=dev)
    out = {}
    for name, w in winds.items():
        tr = kerns[name].traced
        lib = cuda_build.traced_library(tr)
        u, v = torch.empty_like(x), torch.empty_like(x)
        with torch.cuda.device(dev):
            code = lib.picles_traced_probe(
                x.data_ptr(), y.data_ptr(), t.data_ptr(), u.data_ptr(),
                v.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check_status(code, "traced probe")
        want = [torch.broadcast_to(f(x, y, t), x.shape) for f in (w.u, w.v)]
        for what, got in (("the emitted function", (u, v)),
                          ("the plain evaluator", tr.evaluate(x, y, t))):
            for c, a, b in zip("uv", got, want):
                d = int((bits(a) != bits(b.contiguous())).sum())
                assert d == 0, f"traced {name}: {what}'s {c} differs from " \
                               f"the callable on {d} of {n} points"
        out[name] = len(tr.ops)
        log("traced-winds", f"(a) {name}: the emitted function "
                            f"({len(tr.ops)} operations) and the plain "
                            f"evaluator bit for bit the callable on {n} "
                            f"points, the switch times among them")
    return out


def traced_step_state(dev, n: int, winds, steps: int):
    """The fused flagship forced by ``winds`` after ``steps`` eager steps:
    (model, state)."""
    m = flagship_model(n, dev, winds=winds, remesh_mode="fused")
    return m, eager_steps(m, m.init_state(), steps)


def traced_kernel_checks(dev, n: int, winds: dict, kerns: dict,
                         results: dict, timing: dict,
                         only=("K1", "K3", "K5", "K6")) -> dict:
    """(b) K1, K3, K5 and K6 (those of ``only``) in the traced kind at n^2
    against their plain versions (the model's plain paths over the
    callable, which the plain evaluator equals bit for bit): K1 on a
    perturbed state whose lanes start between 0 and 12000 s (across the
    switch times), the pulse and the stripped time-cosine, bosh3 and
    tsit5, fixed substeps within rtol 1e-5 (dt, failed and naccept equal)
    and adaptive by share of lanes (``check_k1``; the pulse's tsit5 lanes
    that step over a switch by ``witness_check``, their readings into
    ``timing["traced_witness"]``); K3 within rtol 1e-5 with
    every lane and half the lanes reset; K5 and K6 on the pulse's fused
    flagship deposit, a band of rows deposited empty, at the clock (wind
    on: the band reseeds) and at 7200 s (calm: it goes off), K5 by
    ``assert_remesh``, K6 bit for bit K2 + K5.  Example 02's jet, traced at
    the wrappers on node y in degrees, bit for bit its node kind in each
    kernel (K1 bosh3 adaptive and tsit5 fixed); K1 and K3 of the stripped
    time-cosine against the ``TIME_COSINE`` descriptor on the same state,
    the gap logged.  Returns the max abs errors by kernel id."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    comps, dt0, active, grid = perturbed_state(n, dev, seed=31)
    proj = uniform_projection(grid.proj, grid.pc)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    rng = np.random.default_rng(32)
    t0 = torch.as_tensor(rng.uniform(0.0, 1.2e4, (n, n)).astype(np.float32),
                         device=dev)
    k = min(1024, n * n // 4)
    t0.view(-1)[:4 * k] = torch.as_tensor(np.repeat(np.array(
        TRACED_SWITCHES, np.float32) - DT / 2, k), device=dev)
    errs = {}
    # example 02's jet on node y in degrees: traced, and its node kind
    jw = winds["example 02 jet"]
    yd = torch.linspace(-80.0, 80.0, n, device=dev)[None, :].expand(
        n, n).contiguous()
    wf = tuple(steady_node_planes(jw, grid.x, yd).unbind(0))
    wt = jw._replace(kernel=kerns["example 02 jet"])
    wn = jw._replace(kernel=node_kernel())
    cos_t = winds["time_cosine stripped"]._replace(
        kernel=kerns["time_cosine stripped"])
    cos_d = time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)
    if "K1" in only:
        errs["K1"] = 0.0
        for wname in ("pulse", "time_cosine stripped"):
            w = winds[wname]._replace(kernel=kerns[wname])
            for method in ("bosh3", "tsit5"):
                for adaptive in (False, True):
                    cfg = SolverConfig(method=method, adaptive=adaptive,
                                       dtmin=1e-4, force_dtmin=True)
                    dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
                    # tsit5 substeps across the pulse's switches: the plain
                    # version is ill-conditioned there (fixed substeps
                    # diverge on 15,897 of 120,166 crossing lanes at 1536^2
                    # on an H100, in the plain version, in K1 and in the
                    # witness alike), so those lanes are held by
                    # ``witness_check`` beside the witness; adaptive lanes
                    # by the gridded winds' near-zero bound, 5e-3, beside
                    # the witness (``near_zero_check``: the float32 problem
                    # parts as many lanes beyond 1e-3 as K1 does)
                    cross = None
                    if wname == "pulse" and method == "tsit5":
                        cross = torch.zeros_like(active)
                        for sw in (0.0, 7200.0):
                            cross |= (t0 < sw) & (t0 + DT > sw)
                    err, _ = check_k1(
                        f"K1 traced {wname} {method} "
                        f"{'adaptive' if adaptive else 'fixed'}", w, consts,
                        flags, cfg, comps, t0, dt, active, grid, proj,
                        baseline=False, witness=cross,
                        loose_atol=GRIDDED_LOOSE_ATOL,
                        stats=timing.setdefault("traced_witness", {}))
                    if not adaptive:
                        errs["K1"] = max(errs["K1"], err)
        for method, adaptive in (("bosh3", True), ("tsit5", False)):
            cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                               force_dtmin=True)
            dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
            args = (consts, flags, cfg, DT, comps, t0, dt, active, grid.x,
                    yd, proj)
            assert_bitwise(f"K1 jet traced vs node kind {method}",
                           advance_cuda(wt, *args),
                           advance_cuda(wn, *args, wind_fields=wf))
        cfg = SolverConfig(method="tsit5", adaptive=False, dtmin=1e-4,
                           force_dtmin=True)
        args = (consts, flags, cfg, DT, comps, t0,
                torch.full_like(dt0, 37.5), active, grid.x, grid.y, proj)
        ka, kb = advance_cuda(cos_t, *args), advance_cuda(cos_d, *args)
        names = ("lne", "cgx", "cgy", "x", "y")
        gap = {nm: max_abs(a, b) for nm, a, b in zip(names, ka[:5], kb[:5])}
        same = float(torch.stack([torch.eq(a, b) for a, b in
                                  zip(ka[:5], kb[:5])]).all(0).double()
                     .mean())
        for i, nm in enumerate(names):
            assert_close(f"K1 time-cosine traced vs descriptor {nm}", ka[i],
                         kb[i], 1e-4, 1e-5)
        timing["traced_vs_time_cosine_k1"] = dict(max_abs=gap,
                                                  lanes_equal=same)
        log("K1 traced", f"{n}^2, lanes from 0 to 12000 s: fixed substeps "
                         f"within rtol 1e-5 (max abs err {errs['K1']:.3e}), "
                         f"adaptive by share of lanes; the jet bit for bit "
                         f"its node kind; the stripped time-cosine (t * 2pi "
                         f"times the float32 reciprocal of the period, as "
                         f"torch on the card) against the TIME_COSINE "
                         f"descriptor (t * 2pi / period), tsit5 fixed: "
                         f"{same:.4%} of lanes bit for bit, max abs gaps "
                         f"{gap}")
    if "K3" in only:
        errs["K3"] = 0.0
        for wname in ("pulse", "time_cosine stripped"):
            w = winds[wname]._replace(kernel=kerns[wname])
            rhs = make_rhs(w.u, w.v, consts, flags)
            for tag, reset in (("all", torch.ones_like(active)),
                               ("half", half_reset_mask((n, n), dev,
                                                        seed=33))):
                k3 = auto_dt_cuda(w, consts, flags, t0, comps, grid.x,
                                  grid.y, proj, reset, dt0, 1e-4, DT)
                p = auto_dt_reset(rhs, t0, torch.stack(comps, dim=-1), aux,
                                  reset, dt0, 1e-4, DT)
                errs["K3"] = max(errs["K3"], assert_close(
                    f"K3 traced {wname} {tag} reset", k3, p, 1e-5, 0.0))
        reset = half_reset_mask((n, n), dev, seed=34)
        a3 = (consts, flags, t0, comps, grid.x, yd, proj, reset, dt0, 1e-4,
              DT)
        assert_bitwise("K3 jet traced vs node kind", (auto_dt_cuda(wt, *a3),),
                       (auto_dt_cuda(wn, *a3, wind_fields=wf),))
        reset = torch.ones_like(active)
        a3 = (consts, flags, t0, comps, grid.x, grid.y, proj, reset, dt0,
              1e-4, DT)
        gap = assert_close("K3 time-cosine traced vs descriptor",
                           auto_dt_cuda(cos_t, *a3), auto_dt_cuda(cos_d, *a3),
                           1e-4, 0.0)
        timing["traced_vs_time_cosine_k3"] = dict(max_abs=gap)
        log("K3 traced", f"{n}^2: within rtol 1e-5 of the plain version "
                         f"(max abs err {errs['K3']:.3e}); the jet bit for "
                         f"bit its node kind; the stripped time-cosine "
                         f"against the TIME_COSINE descriptor: max abs gap "
                         f"{gap:.3e}")
    if "K5" in only or "K6" in only:
        pm, ps = traced_step_state(dev, n, winds["pulse"], 2)
        assert pm.winds.kernel.kind == WindKind.TRACED
        core, chans, sact = flagship_deposit_inputs(pm, ps)
        # no energy deposited from the first third of the rows: their
        # nodes fail the gather and reseed from the wind (at the clock,
        # the pulse on) or go off (at 7200 s, calm)
        band = torch.arange(n, device=dev)[:, None] < n // 3
        chans = tuple(torch.where(band, 0.0, c) for c in chans)
        rp = pm.remesh_params
        prp = rp._replace(winds=winds["pulse"])
        ga = (core[3], core[4], chans, sact, pm.grid.stats, pm.config.halo)
        node, _ = pic_gather(*ga)
        S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                             pm.grid.stats, pm.config.halo)
        errs["K5"] = 0.0
        e2 = max(assert_close(f"K2 of the pulse ch{c}", node[c], S[..., c],
                              1e-5, 1e-6 * float(S[..., c].abs().max()))
                 for c in range(3))
        for clock in (ps.time, torch.full((), 7200.0, device=dev)):
            cc = (*core[:-1], clock)
            k5 = remesh_cuda(rp, node, *cc)
            errs["K5"] = max(errs["K5"], assert_remesh(
                f"K5 traced pulse at {float(clock):g} s", k5,
                remesh_core(prp, node, *cc)))
            nd, rm, _ = pic_gather_remesh(*ga, rp, *cc)
            assert_bitwise(f"K6 traced pulse at {float(clock):g} s vs "
                           f"K2 + K5", (*nd, *rm), (*node, *k5))
            br = branch_counts(k5.branch)
            assert (" reseed 0 " in br) == (float(clock) >= 7200.0) and \
                (" off 0" in br) != (float(clock) >= 7200.0), br
            log("K5 traced", f"pulse at the clock {float(clock):g} s: {br}; "
                             f"K6 bit for bit K2 + K5")
        errs["K6"] = max(errs["K5"], e2)
        cd = (*core[:10], yd, core[11])
        rt, rn = rp._replace(winds=wt), rp._replace(winds=wn)
        assert_bitwise("K5 jet traced vs node kind",
                       remesh_cuda(rt, node, *cd),
                       remesh_cuda(rn, node, *cd, wind_fields=wf))
        a, b = (pic_gather_remesh(*ga, rt, *cd),
                pic_gather_remesh(*ga, rn, *cd, wind_fields=wf))
        assert_bitwise("K6 jet traced vs node kind", (*a[0], *a[1]),
                       (*b[0], *b[1]))
        log("K6 traced", "the jet traced bit for bit its node kind in K5 "
                         "and K6")
    for k, e in errs.items():
        results[f"{k} traced"]["max_abs_err"] = e
    return errs


def pulse_model(path: str, n: int, dev, winds=None, **modes):
    """The pulse (or ``winds``) under ``path`` of PULSE_PATHS at n^2."""
    winds = winds or pulse_winds()
    if path == "default":
        return default_model(n, dev, winds=winds, **modes)
    return flagship_model(n, dev, winds=winds, remesh_mode="fused",
                          periodic=path == "fused", **modes)


def pulse_main_path(dev, n: int, results, timing) -> None:
    """(c) The pulse at n^2 under PULSE_PATHS: a day of PULSE_STEPS steps
    through ``Simulation.run``, graphed, its launches counted by name in a
    trace (``traced_run``), then the day eagerly (``eager_day``: bit for
    bit the graphed day, the counters summed: no failed and no clamped
    lane; the open box's upwind nodes go off once the wind stops), finite;
    ms a step graphed against the eager plain advance
    (``advance_mode="torch"``) of the same configuration, PULSE_PLAIN_STEPS
    steps each, in turns.  Then the returning wind (calm until 1 h) on the
    fused flagship, RETURN_STEPS eager steps with the counters set to 0
    just before and read just after: the calm nodes re-light."""
    out = {}
    for path, kerns in PULSE_PATHS.items():
        m = pulse_model(path, n, dev)
        assert m.winds.kernel.kind == WindKind.TRACED and m.graphed, path
        m.step_n_quiet(m.init_state(), 1)   # the capture, out of the trace
        want = {k: PULSE_STEPS for k in kerns}
        sim, got, stats = traced_run(m, (PULSE_STEPS - 1) * DT, want)
        assert got == want, f"pulse {path}: launches by trace {got}"
        day, eager = eager_day(m, sim.state, PULSE_STEPS)
        check_state(f"pulse {path}", sim.state)
        assert day["n_failed"] == 0 and day["n_clamped"] == 0, (path, day)
        for row in kerns:
            assert eager[row] == PULSE_STEPS, (path, eager)
            results[row]["launches"] += eager[row]
            results[row]["graph_launches"] = \
                results[row].get("graph_launches", 0) + got[row]
        if path == "fused open":
            assert day["n_off"] > 0, f"pulse {path}: no node went off"
        plain = pulse_model(path, n, dev, advance_mode="torch")
        assert not plain.graphed
        s_g = m.step_n_quiet(m.init_state(), PULSE_PLAIN_STEPS)
        s_p = eager_steps(plain, plain.init_state(), PULSE_PLAIN_STEPS)
        t = {"graphed": [], "plain": []}
        for who in ("plain", "graphed", "graphed", "plain"):
            if who == "graphed":
                s_g, ms = time_steps(m, s_g, PULSE_PLAIN_STEPS)
            else:
                s_p, ms = time_steps(plain, s_p, PULSE_PLAIN_STEPS,
                                     eager=True)
            t[who].append(ms)
        out[path] = dict(day=day, launches_by_trace=got,
                         eager_launches={k: eager[k] for k in eager
                                         if eager[k]},
                         idle_share=stats["idle_share"],
                         device_busy_ms_per_step=stats[
                             "device_busy_ms_per_step"],
                         graphed_ms_per_step=float(np.mean(t["graphed"])),
                         plain_eager_ms_per_step=float(np.mean(t["plain"])))
        m.release_graph()
        log("traced-winds", f"(c) pulse {path} {n}^2: a day through "
                            f"Simulation.run graphed, launches by trace "
                            f"{got}, bit for bit the eager day; counters "
                            f"summed {day}; graphed "
                            f"{out[path]['graphed_ms_per_step']:.4f} ms/step "
                            f"against the plain eager advance "
                            f"{out[path]['plain_eager_ms_per_step']:.4f} "
                            f"ms/step (means of 2 x {PULSE_PLAIN_STEPS} "
                            f"steps in turns); idle share "
                            f"{stats['idle_share']:.4f}")
        del m, plain, sim, s_g, s_p
    rm = pulse_model("fused", n, dev, winds=returning_winds())
    ms = rm.init_state()
    assert not bool(ms.particles.on.any())
    reset_counters()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(RETURN_STEPS):
        ms = rm.step(ms)
        total += ms.metrics.n_reseed.to(torch.int64) + \
            ms.metrics.n_relight.to(torch.int64)
    c = all_counters()
    assert c["K1 traced"] == c["K6 traced"] == RETURN_STEPS, c
    results["K1 traced"]["launches"] += c["K1 traced"]
    results["K6 traced"]["launches"] += c["K6 traced"]
    check_state("returning wind", ms, n_failed=0, n_clamped=0)
    assert int(total) > 0 and bool(ms.particles.on.all()), int(total)
    out["returning"] = dict(relit=int(total), launches=c)
    log("traced-winds", f"(c) the returning wind, {RETURN_STEPS} eager "
                        f"steps: {int(total)} nodes re-lit, every node on "
                        f"at the end; launches {c}")
    # K5 traced on the main path: the pulse with the "pallas" remesh
    pm = flagship_model(n, dev, winds=pulse_winds(), remesh_mode="pallas")
    reset_counters()
    ms = eager_steps(pm, pm.init_state(), 3)
    c = all_counters()
    assert c["K1 traced"] == c["K2"] == c["K5 traced"] == 3, c
    check_state("pulse pallas", ms, n_failed=0, n_clamped=0)
    results["K1 traced"]["launches"] += c["K1 traced"]
    results["K5 traced"]["launches"] += c["K5 traced"]
    timing["traced_pulse"] = out


def pulse_layered_check(dev, n: int, results) -> None:
    """(d) PULSE_LAYERS layers of the pulse (the fused flagship, halo 3)
    through ``LayeredWaveGrowth2D``: 3 eager steps with the counters set to
    0 just before and read just after (K1 and K6 once a step), bit for bit
    ``step_n_quiet``'s replays."""
    m = flagship_model(n, dev, winds=pulse_winds(), remesh_mode="fused",
                       layers=PULSE_LAYERS, halo=3).as_layered()
    assert m.graphed
    ms0 = m.init_state()
    reset_counters()
    eager = eager_steps(m, ms0, 3)
    c = all_counters()
    assert c["K1 traced"] == c["K6 traced"] == 3, c
    assert_state_bitwise("layered pulse: step_n_quiet(3) graphed",
                         m.step_n_quiet(ms0, 3), eager)
    for k in ("K1", "K6"):
        results[f"{k} traced"]["launches"] += c[f"{k} traced"]
    m.release_graph()
    log("traced-winds", f"(d) {PULSE_LAYERS} layers of the pulse at {n}^2: "
                        f"3 replays bit for bit 3 eager steps; launches {c}")


# steps of TRI_DT from the seed whose stage times all fall before the
# pulse's stop (7200 s): the sixth step's last stage samples the wind at
# 7200 s, where it is calm
PULSE_TRI_ANCHOR_STEPS = 5


def pulse_tripolar_check(dev, results, timing) -> None:
    """(f) The pulse on the global tripolar configuration (1440 x 720:
    per-node projection planes, the pole masks and the continent, the seam
    folded in K6; DT = TRI_DT), with the counters set to 0 just before and
    read just after each run: the production (fused) and default paths
    from the seed, PULSE_TRI_ANCHOR_STEPS eager steps, each bit for bit the
    same configuration forced by ``constant_winds(12, 0)`` (before the
    stop the pulse is (12, 0) at every node and stage time); then the
    production day (TRI_STEPS steps through ``Simulation.run``), graphed,
    its launches by trace (``traced_run``), bit for bit its eager day
    (``eager_day``), no failed and no clamped lane summed over the day;
    each state held to ``check_tripolar`` with the step: unlike the
    tripolar main path's jet, which is calm near the grid's poles, the
    pulse blows over the grid's narrowest cells (2 km near its top rows),
    which its swell crosses in less than a step, so energy there reaches
    land nodes beyond one cell, as picles_tpu's step puts it there."""
    grid = tripolar_grid(dev, *TRI_SUPER)
    out = {}
    for path, rows in (("production", ("K1 traced", "K6 traced")),
                       ("default", ("K1 traced", "K2", "K3 traced"))):
        mp = tripolar_model(grid, pulse_winds(), path)
        assert mp.winds.kernel.kind == WindKind.TRACED and mp.graphed, path
        assert mp.uniform_proj is None
        reset_counters()
        sp = eager_steps(mp, mp.init_state(), PULSE_TRI_ANCHOR_STEPS)
        c = all_counters()
        mc = tripolar_model(grid, constant_winds(12.0, 0.0), path)
        sc = eager_steps(mc, mc.init_state(), PULSE_TRI_ANCHOR_STEPS)
        assert_state_bitwise(f"tripolar pulse {path}: {PULSE_TRI_ANCHOR_STEPS}"
                             f" steps against constant_winds(12, 0)", sp, sc)
        for r in rows:
            assert c[r] == PULSE_TRI_ANCHOR_STEPS, (path, c)
            results["K2 tripolar" if r == "K2" else r]["launches"] += c[r]
        out[path] = check_tripolar(f"tripolar pulse {path}", mp, sp,
                                   dt=TRI_DT)
        log("traced-winds", f"(f) the pulse on the {grid.nx} x {grid.ny} "
                            f"tripolar grid, {path}: {PULSE_TRI_ANCHOR_STEPS}"
                            f" steps bit for bit constant_winds(12, 0); "
                            f"launches {c}; {out[path]}")
        del mp, mc, sp, sc
    mp = tripolar_model(grid, pulse_winds(), "production")
    reset_counters()
    mp.step_n_quiet(mp.init_state(), 1)   # the capture, out of the trace
    cap = all_counters()
    want = {"K1 traced": TRI_STEPS, "K6 traced": TRI_STEPS}
    sim, got, stats = traced_run(mp, (TRI_STEPS - 1) * TRI_DT, want)
    assert got == want, f"tripolar pulse day: launches by trace {got}"
    day, eager = eager_day(mp, sim.state, TRI_STEPS)
    m = check_tripolar("tripolar pulse day", mp, sim.state, dt=TRI_DT)
    log("traced-winds", f"(f) the pulse's production day on the tripolar "
                        f"grid: counters summed {day}; {m}")
    assert day["n_failed"] == 0 and day["n_clamped"] == 0, day
    for r in want:
        assert eager[r] == TRI_STEPS, eager
        results[r]["launches"] += cap[r] + eager[r]
        results[r]["graph_launches"] = \
            results[r].get("graph_launches", 0) + got[r]
    mp.release_graph()
    out["day"] = dict(counters=day, launches_by_trace=got, metrics=m,
                      idle_share=stats["idle_share"])
    timing["traced_pulse_tripolar"] = out
    log("traced-winds", f"(f) the pulse's production day on the tripolar "
                        f"grid ({TRI_STEPS} steps of {TRI_DT:g} s) through "
                        f"Simulation.run graphed: launches by trace {got}, "
                        f"bit for bit the eager day, no failed or clamped "
                        f"lane")


def phase_sharded_pulse(dev, results, timing) -> None:
    """(d) Inside phase "sharded-1x1"'s process group (one NCCL rank): the
    pulse's "pallas" flagship through ``ShardedWaveGrowth2D`` on a (1, 1)
    mesh (K1 traced -> K4 -> the self-wrap fold -> K5 traced), 3 eager
    steps against the single-device step at ``assert_states``' rtol, the
    counters set to 0 just before and read just after; the graphed sharded
    step bit for bit its eager steps (``sharded_graph_check``)."""
    model = flagship_model(FLAG_N, dev, winds=pulse_winds(),
                           remesh_mode="pallas")
    ref = eager_steps(model, model.init_state(), 3)
    sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
    reset_counters()
    ms = eager_steps(sh, sh.init_state(), 3)
    c = all_counters()
    err = assert_states("sharded pulse pallas vs single device, 3 steps", ms,
                        ref)
    assert c["K1 traced"] == c["K4"] == c["K5 traced"] == 3, c
    for k in ("K1", "K5"):
        results[f"{k} traced"]["launches"] += c[f"{k} traced"]
    results["K4"]["launches"] += c["K4"]
    graph = sharded_graph_check("sharded pulse pallas", sh, ms,
                                {"K1 traced": "K1 traced", "K4": "K4",
                                 "K5 traced": "K5 traced"}, results)
    sh.release_graph()
    timing["sharded_pulse_max_abs_err"] = err
    timing["sharded_pulse_graph"] = graph
    log("sharded-pulse", f"the pulse on a (1, 1) NCCL mesh: 3 steps vs "
                         f"single device max abs err {err:.3e}; launches {c}")


def traced_kernel_times(dev, n: int, winds: dict, kerns: dict,
                        results: dict, timing: dict) -> None:
    """(e) Each traced kernel's time at n^2 beside its bound and its plain
    version's time, on the pulse's fused flagship state at 3600 s (the
    wind on): there the pulse's u and v are 12 and 0 at every node, so each
    traced kernel is bit for bit the same kernel forced by
    ``constant_winds(12, 0)`` (the anchor), and the two are timed in turns
    (traced, constant, constant, traced).  K1, K3 (every lane reset, on
    the default configuration's state) and K5 by CUDA events (their
    wrappers launch nothing else), K6 from profiler traces (its wrapper
    also sums the clamped count), each traced row's short traces on its
    row.  The traced kinds read the node x and y (8 bytes a particle) and
    run the traced wind's operations per evaluation; the remesh's bytes
    are those of the branches this state takes (``remesh_branch_bytes``:
    every node gathers, so it needs neither its wind nor its particle)."""
    w = winds["pulse"]._replace(kernel=kerns["pulse"])
    ops = len(kerns["pulse"].traced.ops)
    const = constant_winds(12.0, 0.0)
    pm, ps = traced_step_state(dev, n, winds["pulse"], 6)
    assert float(ps.time) == 3600.0
    P = ps.particles
    adv = P.on & pm.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    g = pm.grid
    proj = pm.projection(g)
    rhs = make_rhs(w.u, w.v, pm.consts, pm.flags)

    def k1(winds):
        return lambda: advance_cuda(winds, pm.consts, pm.flags, pm.solver,
                                    DT, comps, P.t, P.dt, adv, g.x, g.y,
                                    proj)

    def k1_plain():
        return integrate_to(rhs, torch.stack(comps, dim=-1), P.t, P.t + DT,
                            P.dt, pm.aux, adv, pm.solver)

    assert_bitwise("K1 traced pulse (on) vs constant_winds(12, 0)",
                   k1(w)(), k1(const)())
    p = k1_plain()
    out = {"K1 traced": dict(plain_ms=cuda_time_ms(k1_plain, 2), **k1_bound(
        n * n, pm.solver.method, pm.solver.adaptive, adv,
        p.naccept + p.nreject, traced_ops=ops))}
    # kernel id -> traced call, constant call, their timers, calls a timing
    pairs = {"K1 traced": (k1(w), k1(const), cuda_time_ms, cuda_time_ms,
                           10)}

    dm = pulse_model("default", n, dev)
    ds = eager_steps(dm, dm.init_state(), 6)
    Q = ds.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    reset = torch.ones_like(Q.on)
    sett = dm.settings
    rhsd = make_rhs(dm.winds.u, dm.winds.v, dm.consts, dm.flags)

    gd = dm.grid

    def k3(winds):
        return lambda: auto_dt_cuda(winds, dm.consts, dm.flags, Q.t, qc,
                                    gd.x, gd.y, dm.projection(gd), reset,
                                    Q.dt, sett.dtmin, DT, abstol=sett.abstol,
                                    reltol=sett.reltol, order=dm._rk_order)

    def k3_plain():
        return auto_dt_reset(rhsd, Q.t, torch.stack(qc, dim=-1), dm.aux,
                             reset, Q.dt, sett.dtmin, DT, abstol=sett.abstol,
                             reltol=sett.reltol, order=dm._rk_order)

    wd = dm.winds
    assert_bitwise("K3 traced pulse (on) vs constant_winds(12, 0)",
                   (k3(wd)(),), (k3(const)(),))
    out["K3 traced"] = dict(plain_ms=cuda_time_ms(k3_plain, 5),
                            **k3_bound(reset, kernel_wind(wd)))
    pairs["K3 traced"] = (k3(wd), k3(const), cuda_time_ms, cuda_time_ms, 20)

    core, chans, sact = flagship_deposit_inputs(pm, ps)
    rp = pm.remesh_params
    rc = rp._replace(winds=const)
    prp = rp._replace(winds=winds["pulse"])
    halo = pm.config.halo
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    k5 = remesh_cuda(rp, node, *core)
    assert_bitwise("K5 traced pulse (on) vs constant_winds(12, 0)", k5,
                   remesh_cuda(rc, node, *core))
    log("kernel-time", f"K5 traced: the pulse's state at 3600 s: "
                       f"{branch_counts(k5.branch)}")
    a = pic_gather_remesh(core[3], core[4], chans, sact, g.stats, halo, rp,
                          *core)
    b = pic_gather_remesh(core[3], core[4], chans, sact, g.stats, halo, rc,
                          *core)
    assert_bitwise("K6 traced pulse (on) vs constant_winds(12, 0)",
                   (*a[0], *a[1]), (*b[0], *b[1]))

    def plain_fused():
        Sp, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                              g.stats, halo)
        return remesh_core(prp, tuple(Sp[..., c] for c in range(3)), *core)

    out["K5 traced"] = dict(
        plain_ms=cuda_time_ms(lambda: remesh_core(prp, node, *core), 5),
        **remesh_bound(n * n, n_wf=1, traced_ops=ops, branch=k5.branch))
    out["K6 traced"] = dict(plain_ms=cuda_time_ms(plain_fused, 5),
                            **deposit_bound(n * n, n * n, halo, remesh=True,
                                            n_wf=1, traced_ops=ops,
                                            branch=a[1].branch))
    pairs["K5 traced"] = (lambda: remesh_cuda(rp, node, *core),
                          lambda: remesh_cuda(rc, node, *core),
                          cuda_time_ms, cuda_time_ms, 20)
    pairs["K6 traced"] = (
        lambda: pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, rp, *core),
        lambda: pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                  halo, rc, *core),
        functools.partial(kernel_ms, key="K6 traced", row="K6 traced"),
        functools.partial(kernel_ms, key="K6"), 20)
    anchor = {}
    for key, (traced_fn, const_fn, timer, const_timer, reps) in \
            pairs.items():
        t = {"traced": [], "constant": []}
        for who in ("traced", "constant", "constant", "traced"):
            if who == "traced":
                t[who].append(timer(traced_fn, reps=reps))
            else:
                t[who].append(const_timer(const_fn, reps=reps))
        out[key]["ms"] = float(np.mean(t["traced"]))
        anchor[key] = dict(traced_ms=out[key]["ms"],
                           constant_ms=float(np.mean(t["constant"])))
    for key, r in out.items():
        results[key].update(r)
        log("kernel-time", f"{key}: {r['ms']:.4f} ms (constant (12, 0) "
                           f"{anchor[key]['constant_ms']:.4f} ms, bit for "
                           f"bit), plain {r['plain_ms']:.4f} ms, bound "
                           f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    timing["traced_vs_constant"] = anchor


def phase_traced_winds(dev, results, timing) -> None:
    """Phase "traced-winds": wind callables that read their time, traced
    and compiled into K1, K3, K5 and K6 (the traced kind): the libraries'
    build, (a) the emitted functions alone, (b) the traced kernels against
    their plain versions and anchors, (c) the pulse's main path at
    FLAG_N^2, (d) 4 layers of the pulse (the (1, 1) NCCL pulse runs inside
    "sharded-1x1", ``phase_sharded_pulse``), (f) the pulse on the global
    tripolar grid, (e) the kernels' times."""
    t0 = time.perf_counter()
    winds = traced_callables()
    kerns, build_s = traced_build(dev, winds)
    again = WaveGrowth2D(cartesian_box(2e3, 2, 2e3, 2, device=dev),
                         pulse_winds(), settings("bosh3"))
    assert again.winds.kernel.traced.digest == kerns["pulse"].traced.digest
    assert cuda_build.build_traced(kerns["pulse"].traced).seconds == 0
    ops = traced_probe_check(dev, winds, kerns, TRACED_PROBE_POINTS)
    traced_kernel_checks(dev, FLAG_N, winds, kerns, results, timing)
    pulse_main_path(dev, FLAG_N, results, timing)
    pulse_layered_check(dev, FLAG_N, results)
    pulse_tripolar_check(dev, results, timing)
    traced_kernel_times(dev, FLAG_N, winds, kerns, results, timing)
    timing["traced_build_seconds"] = build_s
    timing["traced_ops"] = ops
    log("traced-winds", f"done in {time.perf_counter() - t0:.1f} s (the "
                        f"traced libraries' build {build_s:.1f} s)")


# ---------------------------------------------------------------------------
# float64 (phase "float64"): the double instances of K1-K6
# ---------------------------------------------------------------------------

F64 = torch.float64
# The double instances against their float64 plain versions on the card, of
# each plane's scale: K1 in fixed substeps and K3 (the same operations in
# float64; the card's and ATen's exp, log, pow and tanh may part in the last
# ulp); the deposit's node planes (K2, K4, K6: the same sums in another
# order); the remesh's gathered and reseeded values (K5, K6; bits, flags,
# dt and positions exact).  The adaptive advance by ``assert_controller``.
F64_RTOL = 1e-12
F64_DEPOSIT_RTOL = 1e-13
F64_REMESH_RTOL = 1e-13
# a float64 model on the card against the same model on the CPU, 3 steps:
# the node state and the particle planes within this of their scale, the
# counters equal (ROADMAP §3's card test); the carried dt, the controller's
# proposal, whose error estimate cancels, within F64_CARD_CPU_DT_RTOL
F64_CARD_CPU_RTOL = 1e-10
F64_CARD_CPU_DT_RTOL = 1e-8
F64_CARD_CPU_N = 128
F64_STEPS = 3
# the float64 rows of the kernels line: the TPU kernel each double instance
# replaces, in its float64 branch (each takes its dtype from its inputs)
F64_REPLACES = {
    "K1": "picles_tpu/ops/advance_pallas.py:50 (float64: the dtype of its "
          "inputs, :296 and :374; winds cast to it, :81-82; the clock floor "
          "in its epsilon, :105-108)",
    "K2": "picles_tpu/ops/pic_pallas.py:91 (float64: the dtype of its "
          "inputs, :173)",
    "K3": "picles_tpu/ops/advance_pallas.py:200 (float64: the dtype of its "
          "inputs, :374; winds cast to it, :221-222)",
    "K4": "picles_tpu/ops/pic_pallas.py:121 (float64: the dtype of its "
          "inputs, :262)",
    "K5": "picles_tpu/ops/remesh_pallas.py:116 (float64: the dtype of its "
          "inputs, :188; winds cast to it, :62-63)",
    "K6": "picles_tpu/ops/pic_pallas.py:375 (float64: the dtype of its "
          "inputs, :462)",
    "K7": "the port's own; no pl.pallas_call (picles_tpu/ops/tsit5.py:184-"
          "280 integrate_to, jitted in float64 under x64 by "
          "models/wave_growth_1d.py:201-251)",
}
F64_FNS = {"K1": advance_cuda, "K2": pic_gather, "K3": auto_dt_cuda,
           "K4": pic_gather_padded, "K5": remesh_cuda,
           "K6": pic_gather_remesh, "K7": advance_1d}
# the traced kind's double instances (a float64 callable's library): the
# TPU kernel each replaces in its float64 branch, the closure called on the
# lanes' float64 arrays and its value cast to their dtype
F64_TRACED_REPLACES = {
    "K1 traced f64": "picles_tpu/ops/advance_pallas.py:78-82 (float64: the "
                     "closure on the lanes' float64 arrays, cast to them)",
    "K3 traced f64": "picles_tpu/ops/advance_pallas.py:217-222 (float64)",
    "K5 traced f64": "picles_tpu/ops/remesh_pallas.py:58-63 (float64)",
    "K6 traced f64": "picles_tpu/ops/pic_pallas.py:398 (float64: remesh_core "
                     "inside the fused kernel)",
    "K7 traced f64": "the port's own; no pl.pallas_call (picles_tpu/ops/"
                     "tsit5.py:184-280 under x64, u(x, t) read at each stage "
                     "time on float64 lanes)"}
TRACED_F64_FNS = {"K1 traced f64": advance_cuda,
                  "K3 traced f64": auto_dt_cuda,
                  "K5 traced f64": remesh_cuda,
                  "K6 traced f64": pic_gather_remesh,
                  "K7 traced f64": advance_1d}


def f64_counters() -> dict:
    """The double instances' counts (``f64_launches``) and the float64
    traced instances' (``traced_f64_launches``)."""
    return {**{f"{k} f64": fn.f64_launches for k, fn in F64_FNS.items()},
            **{k: fn.traced_f64_launches
               for k, fn in TRACED_F64_FNS.items()}}


def reset_f64_counters() -> None:
    for fn in F64_FNS.values():
        fn.f64_launches = 0
    for fn in TRACED_F64_FNS.values():
        fn.traced_f64_launches = 0


def f64_scale_err(tag: str, a, b, rtol: float) -> float:
    """max |a - b| over max |b| of two float64 planes (NaN where both are
    NaN counts as equal), held to ``rtol``; returns it."""
    assert a.dtype == b.dtype == F64, f"{tag}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{tag}: {a.shape} vs {b.shape}"
    scale = float(torch.nan_to_num(b.abs(), nan=0.0, posinf=0.0).max())
    err = max_abs(a, b) / (scale or 1.0)
    assert err <= rtol, f"{tag}: {err:.3e} of the scale (bound {rtol:g})"
    return err


def f64_consts():
    params, cid, _ = ODEParameters.create()
    return make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)


def f64_k1_check(tag, winds, consts, flags, cfg, comps, t, dt, active, grid,
                 proj, plain_winds=None, wind_fields=()):
    """K1's double instance against ``integrate_to`` in float64 on the same
    inputs (``plain_winds``: the plain version's wind where it differs, a
    gridded or node wind's planes): fixed substeps each component and t
    within F64_RTOL of its scale, dt, failed and naccept equal; adaptive by
    ``assert_adaptive`` and ``assert_controller``, failed equal.  Returns
    (the components' max scaled error, the kernel's and the plain
    version's results)."""
    k = advance_cuda(winds, consts, flags, cfg, DT, comps, t, dt, active,
                     grid.x, grid.y, proj, wind_fields=wind_fields)
    pw = plain_winds or winds
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    p = integrate_to(make_rhs(pw.u, pw.v, consts, flags),
                     torch.stack(comps, dim=-1), t, t + DT, dt, aux, active,
                     cfg)
    torch.cuda.synchronize()
    assert k.lne.dtype == F64 and k.t.dtype == F64, k.lne.dtype
    assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
    names = ("lne", "cgx", "cgy", "x", "y")
    if cfg.adaptive:
        for i, (nm, kz) in enumerate(zip(names, k[:5])):
            assert_adaptive(f"{tag} {nm}", kz, p.z[..., i])
        extra = assert_controller(tag, k, p, active)
        scale = [float(p.z[..., i].abs().max()) or 1.0 for i in range(5)]
        err = max(max_abs(kz, p.z[..., i]) / scale[i]
                  for i, kz in enumerate(k[:5]))
    else:
        err = max(f64_scale_err(f"{tag} {nm}", kz, p.z[..., i], F64_RTOL)
                  for i, (nm, kz) in enumerate(zip(names, k[:5])))
        f64_scale_err(f"{tag} t", k.t, p.t, F64_RTOL)
        assert torch.equal(k.dt, p.dt), f"{tag}: dt not carried as given"
        assert torch.equal(k.naccept, p.naccept), f"{tag}: naccept differs"
        extra = "naccept equal"
    log("float64", f"{tag}: max err {err:.3e} of the scale, failed "
                   f"{int(k.failed.sum())}/{int(p.failed.sum())}; {extra}")
    return err, k, p


def f64_k3_check(tag, winds, consts, flags, comps, t, dt, reset, grid, proj,
                 plain_winds=None, wind_fields=()) -> float:
    """K3's double instance against ``auto_dt_reset`` in float64: within
    F64_RTOL of the scale, the unreset lanes' dt bit for bit."""
    k = auto_dt_cuda(winds, consts, flags, t, comps, grid.x, grid.y, proj,
                     reset, dt, 1e-4, DT, wind_fields=wind_fields)
    pw = plain_winds or winds
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    p = auto_dt_reset(make_rhs(pw.u, pw.v, consts, flags), t,
                      torch.stack(comps, dim=-1), aux, reset, dt, 1e-4, DT)
    torch.cuda.synchronize()
    err = f64_scale_err(tag, k, p, F64_RTOL)
    assert torch.equal(bits(k[~reset]), bits(dt[~reset])), \
        f"{tag}: an unreset lane's dt changed"
    log("float64", f"{tag}: max err {err:.3e} of the scale, "
                   f"{int(reset.sum())} lanes reset")
    return err


def f64_k2_check(tag, xr, yr, chans, act, stats, halo) -> float:
    """K2's double instance twice (bit for bit) and ``scatter_dense`` in
    float64: each channel within F64_DEPOSIT_RTOL of its scale, the
    clamped count equal."""
    o, st = pic_gather(xr, yr, chans, act, stats, halo)
    o2, _ = pic_gather(xr, yr, chans, act, stats, halo)
    S, st_p = scatter_dense(xr, yr, torch.stack(chans, dim=-1), act, stats,
                            halo)
    torch.cuda.synchronize()
    err = max(f64_scale_err(f"{tag} ch{c}", o[c], S[..., c],
                            F64_DEPOSIT_RTOL) for c in range(3))
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(o, o2)), \
        f"{tag}: two runs differ"
    assert int(st.clamped) == int(st_p.clamped), f"{tag}: clamped"
    log("float64", f"{tag}: max err {err:.3e} of the scale, clamped "
                   f"{int(st.clamped)}, two runs bit for bit")
    return err


def f64_k4_check(tag, xr, yr, chans, act, halo) -> float:
    """K4's double instance twice (bit for bit) and
    ``scatter_accumulate_padded`` in float64, within F64_DEPOSIT_RTOL."""
    out, st = pic_gather_padded(xr, yr, chans, act, halo)
    out2, _ = pic_gather_padded(xr, yr, chans, act, halo)
    P, st_p = scatter_accumulate_padded(xr, yr, torch.stack(chans, dim=-1),
                                        act, halo)
    torch.cuda.synchronize()
    assert out.dtype == F64 and torch.equal(bits(out), bits(out2)), \
        f"{tag}: two runs differ"
    err = max(f64_scale_err(f"{tag} ch{c}", out[c], P[..., c],
                            F64_DEPOSIT_RTOL) for c in range(3))
    assert int(st.clamped) == int(st_p.clamped), f"{tag}: clamped"
    log("float64", f"{tag}: max err {err:.3e} of the scale, two runs bit "
                   f"for bit")
    return err


def f64_remesh_values(tag, k, p) -> float:
    """``assert_remesh`` in float64: bits, flags, dt and positions equal,
    the values within F64_REMESH_RTOL."""
    for f in ("branch", "on", "dt", "px", "py"):
        a, b = getattr(k, f), getattr(p, f)
        assert torch.equal(a, b), \
            f"{tag}: {f} differs on {int((a != b).sum())} lanes"
    return max(assert_close(f"{tag} {f}", getattr(k, f), getattr(p, f),
                            F64_REMESH_RTOL, 0.0)
               for f in ("lne", "cgx", "cgy"))


def f64_k5_k6_check(tag, m, node, core, stats=None, halo=((1, 3), (0, 2)),
                    wind_fields=(), plain_params=None):
    """K5's double instance against ``remesh_core`` in float64
    (``f64_remesh_values``) and K6's twice (bit for bit), bit for bit K2 +
    K5's, its node planes within F64_DEPOSIT_RTOL of ``scatter_dense`` and
    its bits and ``on`` those of ``remesh_core`` over them.  ``stats``: the
    deposit's grid (the model's by default); ``plain_params``: the plain
    version's remesh parameters where its wind differs (a gridded or node
    wind's planes).  Returns the two errors."""
    rp = m.remesh_params
    pp = plain_params or rp
    k = remesh_cuda(rp, node, *core, wind_fields=wind_fields)
    p = remesh_core(pp, node, *core)
    torch.cuda.synchronize()
    e5 = f64_remesh_values(f"K5 {tag}", k, p)
    lne, cgx, cgy, px, py = core[:5]
    chans = TR.particle_to_node(lne, cgx, cgy)
    sact = (core[6] & core[7]).contiguous()
    stats = stats or m.grid.stats
    nd, rm, st = pic_gather_remesh(px, py, chans, sact, stats, halo, rp,
                                   *core, wind_fields=wind_fields)
    nd2, rm2, _ = pic_gather_remesh(px, py, chans, sact, stats, halo, rp,
                                    *core, wind_fields=wind_fields)
    k2, _ = pic_gather(px, py, chans, sact, stats, halo)
    k5 = remesh_cuda(rp, k2, *core, wind_fields=wind_fields)
    S, st_p = scatter_dense(px, py, torch.stack(chans, -1), sact, stats, halo)
    plain = remesh_core(pp, tuple(S[..., c] for c in range(3)), *core)
    torch.cuda.synchronize()
    for a, b, c in zip(nd, k2, nd2):
        assert torch.equal(bits(a), bits(b)), f"K6 {tag}: node plane != K2's"
        assert torch.equal(bits(a), bits(c)), f"K6 {tag}: two runs differ"
    for f in rm._fields:
        for other, what in ((k5, "K2 + K5"), (rm2, "a second run")):
            a, b = getattr(rm, f), getattr(other, f)
            same = torch.equal(bits(a), bits(b)) if a.is_floating_point() \
                else torch.equal(a, b)
            assert same, f"K6 {tag}: {f} differs from {what}"
    e6 = max(f64_scale_err(f"K6 {tag} node ch{c}", nd[c], S[..., c],
                           F64_DEPOSIT_RTOL) for c in range(3))
    assert torch.equal(rm.branch, plain.branch), f"K6 {tag}: bits"
    assert torch.equal(rm.on, plain.on), f"K6 {tag}: on"
    assert int(st.clamped) == int(st_p.clamped), f"K6 {tag}: clamped"
    log("float64", f"K5/K6 {tag}: {branch_counts(k.branch)}; K5 values "
                   f"max err {e5:.3e}; K6 = K2 + K5 bit for bit, two runs "
                   f"bit for bit, node planes max err {e6:.3e} of the scale")
    return e5, e6


def f64_kernel_checks(dev, n: int) -> dict:
    """Every branch of the double instances against its float64 plain
    version at n^2: K1 (fixed substeps, tsit5; adaptive, bosh3) and K3
    under constant, half-domain and time-cosine winds (its cut-off inside
    the step), a steady callable's node planes and a gridded record (B =
    1); K1 and K3 with per-node projection planes (a float64 spherical
    grid); K2 and K6 across the tripolar seam; K1, K2 and K5 over 2 layers
    (``blockIdx.y``), bit for bit each layer's own launch; K5 and K6 where
    gather, reseed and off fire, under each boundary type.  Returns the
    max errors by kernel."""
    consts, flags = f64_consts(), TermFlags()
    c32, dt32, active, _ = perturbed_state(n, dev, seed=16)
    comps = tuple(c.to(F64).contiguous() for c in c32)
    dt0 = dt32.to(F64)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=dev,
                         dtype=F64)
    proj = uniform_projection(grid.proj, grid.pc)
    t = torch.full_like(comps[0], 1500.0)
    reset = half_reset_mask((n, n), dev, seed=16)
    err = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0.0)
    fixed = SolverConfig(method="tsit5", adaptive=False, dtmin=1e-4)
    adapt = SolverConfig(method="bosh3", adaptive=True, dtmin=1e-4)
    steady = Winds2D(u=lambda x, y, t: 10.0 + 2.0 * torch.sin(y / 3e4),
                     v=lambda x, y, t: 4.0 + 0.0 * x)
    planes = steady_node_planes(steady, grid.x, grid.y, F64)
    gw, wf, pwl = kernel_winds(window_record(n, dev, 900.0), grid, 1500.0)
    cases = [
        ("constant", constant_winds(10.0, 10.0), None, ()),
        ("half-domain", half_domain_winds(10.0, 5.0, 1e3 * (n - 1)), None,
         ()),
        ("time-cosine", time_cosine_winds(10.0, 5.0, period=6 * 3600.0,
                                          t_off=1800.0), None, ()),
        ("node", steady._replace(kernel=node_kernel()),
         node_plane_winds(planes[0], planes[1]), tuple(planes.unbind(0))),
        ("gridded", gw, pwl, tuple(wf)),
    ]
    for wname, winds, plain, fields in cases:
        for cfg, dt in ((fixed, torch.full_like(dt0, 37.5)), (adapt, dt0)):
            mode = "adaptive" if cfg.adaptive else "fixed"
            e, k, _ = f64_k1_check(f"K1 f64 {wname} {cfg.method} {mode}",
                                   winds, consts, flags, cfg, comps, t, dt,
                                   active, grid, proj, plain, fields)
            err["K1"] = max(err["K1"], e if not cfg.adaptive else 0.0)
            if wname == "constant" and cfg.adaptive:
                moved = k   # the deposits' input: advanced positions
        err["K3"] = max(err["K3"], f64_k3_check(
            f"K3 f64 {wname}", winds, consts, flags, comps, t, dt0, reset,
            grid, proj, plain, fields))
    # per-node projection planes: a float64 spherical grid
    sph = spherical_grid_2d(0.0, 360.0 * (n - 1) / n, n, -70.0, 70.0, n,
                            periodic_boundary=(True, False), device=dev,
                            dtype=F64)
    sproj = node_projection(sph.proj, sph.pc, F64)
    assert sproj.dtype == F64
    winds = constant_winds(10.0, 10.0)
    e, _, _ = f64_k1_check("K1 f64 spherical planes tsit5 fixed", winds,
                           consts, flags, fixed, comps, t,
                           torch.full_like(dt0, 37.5), active, sph, sproj)
    err["K1"] = max(err["K1"], e)
    err["K3"] = max(err["K3"], f64_k3_check(
        "K3 f64 spherical planes", winds, consts, flags, comps, t, dt0,
        reset, sph, sproj))
    # layers: two layers in one launch, each bit for bit its own launch
    L = 2
    c2 = tuple(torch.stack([c, c * (1.0 + 1e-3 * (i + 1))]).contiguous()
               for i, c in enumerate(comps))
    lay = lambda a: torch.stack([a, a]).contiguous()   # noqa: E731
    args = (winds, consts, flags, fixed, DT)
    kb = advance_cuda(*args, c2, lay(t), lay(torch.full_like(dt0, 37.5)),
                      lay(active), grid.x, grid.y, proj)
    for i in range(L):
        ks = advance_cuda(*args, tuple(c[i].contiguous() for c in c2), t,
                          torch.full_like(dt0, 37.5), active, grid.x, grid.y,
                          proj)
        assert_bitwise(f"K1 f64 layer {i}", tuple(x[i] for x in kb), ks)
    # deposits: the state's positions after the constant wind's advance
    k = moved
    chans = TR.particle_to_node(k.lne, k.cgx, k.cgy)
    for halo in (((0, 3), (0, 3)), 3):
        err["K2"] = max(err["K2"], f64_k2_check(
            f"K2 f64 halo {halo}", k.x, k.y, chans, active, grid.stats,
            halo))
    err["K4"] = max(err["K4"], f64_k4_check(
        "K4 f64 halo ((0,3),(0,3))", k.x, k.y, chans, active,
        ((0, 3), (0, 3))))
    kb2, _ = pic_gather(lay(k.x), lay(k.y), tuple(lay(c) for c in chans),
                        lay(active), grid.stats, 3)
    ks2, _ = pic_gather(k.x, k.y, chans, active, grid.stats, 3)
    assert_bitwise("K2 f64 layers", tuple(x[0] for x in kb2), ks2)
    assert_bitwise("K2 f64 layers", tuple(x[1] for x in kb2), ks2)
    # the tripolar seam
    tri = synthetic_tripolar_grid(k=2, nx_super=2 * n, ny_super=2 * n,
                                  device=dev, dtype=F64)
    assert tri.stats.by == Boundary.TRIPOLAR_NORTH
    for halo in (3, ((0, 3), (0, 3))):
        err["K2"] = max(err["K2"], f64_k2_check(
            f"K2 f64 tripolar halo {halo}", k.x, k.y, chans, active,
            tri.stats, halo))
    # the remesh: every branch under each boundary type, the seam, layers
    seed = 40
    for bt in ("same", "wind_sea", "mininmal"):
        for adaptive in (True, False):
            seed += 1
            m, node, core = remesh_case(dev, n, bt, adaptive, seed,
                                        dtype=F64)
            e5, e6 = f64_k5_k6_check(
                f"f64 {bt} clip_dt={m.remesh_params.clip_dt}", m, node, core)
            err["K5"], err["K6"] = max(err["K5"], e5), max(err["K6"], e6)
    m, node, core = remesh_case(dev, n, "same", True, 50, dtype=F64)
    e5, e6 = f64_k5_k6_check("f64 tripolar seam", m, node, core,
                             stats=tri.stats, halo=3)
    err["K5"], err["K6"] = max(err["K5"], e5), max(err["K6"], e6)
    kl = remesh_cuda(m.remesh_params, tuple(lay(c) for c in node),
                     *(lay(c) for c in core[:7]), *core[7:])
    k0 = remesh_cuda(m.remesh_params, node, *core)
    for i in range(L):
        assert_bitwise(f"K5 f64 layer {i}", tuple(x[i] for x in kl), k0)
    # the remesh's gridded and node winds
    for wname, winds, plain, fields in cases[3:]:
        m, node, core = remesh_case(dev, n, "same", True, 60, dtype=F64)
        pw = m.remesh_params._replace(winds=plain)
        m.remesh_params = m.remesh_params._replace(winds=winds)
        e5, e6 = f64_k5_k6_check(f"f64 {wname} wind", m, node, core,
                                 wind_fields=fields, plain_params=pw)
        err["K5"], err["K6"] = max(err["K5"], e5), max(err["K6"], e6)
    return err


def f64_turns(f32_fn, f64_fn, reps: int):
    """(float32 ms, float64 ms) of one call each, by CUDA events
    (``cuda_time_ms``), in turns: float32, float64, float64, float32, the
    two runs of each averaged."""
    a1 = cuda_time_ms(f32_fn, reps)
    b1 = cuda_time_ms(f64_fn, reps)
    b2 = cuda_time_ms(f64_fn, reps)
    a2 = cuda_time_ms(f32_fn, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def f64_row(results, key, f32_fn, f64_fn, plain_fn, b, reps=10,
            plain_reps=2) -> None:
    """Time kernel ``key``'s double instance in turns with its float32
    instance on the same inputs cast to float32 (CUDA events: ``events_ms``
    and ``f32_events_ms``), and its float64 plain version; record them
    beside its bound ``b`` (``bound`` with the lanes' bytes doubled and the
    float64 rate).  The deposit wrappers (K2, K4, K6) count the clamped
    displacements beside their kernel, so their ``ms`` and ``f32_ms`` are
    the kernels' own device times from traces (``kernel_ms``), taken in
    turns too; the others' are the events'."""
    f32_ev, ev = f64_turns(f32_fn, f64_fn, reps)
    row = dict(events_ms=ev, f32_events_ms=f32_ev, ms=ev, f32_ms=f32_ev)
    if key.split()[0] in ("K2", "K4", "K6"):
        s1 = kernel_ms(f32_fn, key, reps)
        n1 = kernel_ms(f64_fn, f"{key} f64", reps)
        n2 = kernel_ms(f64_fn, f"{key} f64", reps)
        s2 = kernel_ms(f32_fn, key, reps)
        row.update(ms=(n1 + n2) / 2, f32_ms=(s1 + s2) / 2)
    ms, f32_ms = row["ms"], row["f32_ms"]
    plain_ms = cuda_time_ms(plain_fn, plain_reps)
    results[f"{key} f64"].update(plain_ms=plain_ms, bound_ms=b["bound_ms"],
                                 bound_by=b["bound_by"], **row)
    log("kernel-time", f"{key} f64: {ms:.4f} ms, its float32 instance "
                       f"{f32_ms:.4f} ms ({ms / f32_ms:.2f}x; CUDA events "
                       f"in turns {ev:.4f} / {f32_ev:.4f}), plain float64 "
                       f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                       f"({b['bound_by']}, {b['bound_ms'] / ms:.0%})")


# the double gather's shared-memory budgets measured (bytes a block): the
# float32 instances' 64 KB, and up to the card's 227 KB a block
F64_BUDGETS = (64 * 1024, 96 * 1024, 128 * 1024, 160 * 1024)


def f64_budget_sweep(xr, yr, chans, act, stats, halos) -> dict:
    """K2's double instance under each budget of F64_BUDGETS
    (``picles_gather_budget_f64``), at each halo: bit for bit the same
    sums under every budget (the order of the sums is the plan's own), the
    device time by CUDA events (two passes, each budget in turn).  Leaves
    the compiled budget (pic_gather.cu SMEM_BUDGET_F64) in place.
    Returns ms by budget and halo."""
    lib = cuda_build.library_f64()
    default = lib.picles_gather_budget_f64(0)
    out, ref = {}, {}
    try:
        for _ in range(2):
            for b in F64_BUDGETS:
                lib.picles_gather_budget_f64(b)
                for halo in halos:
                    o, _ = pic_gather(xr, yr, chans, act, stats, halo)
                    key = str(halo)
                    if key in ref:
                        assert all(torch.equal(bits(x), bits(y))
                                   for x, y in zip(o, ref[key])), \
                            f"K2 f64 budget {b}: sums differ"
                    ref.setdefault(key, o)
                    out.setdefault(f"{b // 1024} KB {key}", []).append(
                        cuda_time_ms(lambda: pic_gather(xr, yr, chans, act,
                                                        stats, halo), 20))
    finally:
        lib.picles_gather_budget_f64(default)
    log("float64", "K2 f64 by the shared-memory budget a block (ms, CUDA "
                   "events, two passes; sums bit for bit alike): " +
        "; ".join(f"{k}: {v[0]:.4f}, {v[1]:.4f}" for k, v in out.items()))
    return out


def f64_main_models(n: int, dev) -> dict:
    """The float64 main path's models at n^2 on float64 grids: the
    flagship under the fused remesh (K1, K6) and the "pallas" one (K1, K2,
    K5), and the default configuration (K1, K2, K3)."""
    return {"flagship fused": flagship_model(n, dev, dtype=F64,
                                             remesh_mode="fused"),
            "default": default_model(n, dev, dtype=F64),
            "flagship pallas": flagship_model(n, dev, dtype=F64,
                                              remesh_mode="pallas")}


# the double instances a float64 step of each main-path model launches
F64_STEP_KERNELS = {"flagship fused": ("K1", "K6"),
                    "default": ("K1", "K2", "K3"),
                    "flagship pallas": ("K1", "K2", "K5")}


def f64_card_vs_cpu(dev, n: int = F64_CARD_CPU_N) -> dict:
    """The float64 fused flagship and default models at n^2: 3 graphed
    steps on the card against 3 steps of the same models on the CPU (the
    plain versions): the node state and the particle planes within
    F64_CARD_CPU_RTOL of their scale, the carried dt within
    F64_CARD_CPU_DT_RTOL, every counter equal.  Returns the errors."""
    out = {}
    for name in ("flagship fused", "default"):
        mg = f64_main_models(n, dev)[name]
        mc = f64_main_models(n, "cpu")[name]
        assert mg.graphed and not mc.graphed
        sg = mg.step_n_quiet(mg.init_state(), F64_STEPS)
        sc = mc.init_state()
        for _ in range(F64_STEPS):
            sc = mc.step(sc)
        mg.release_graph()
        e = max(f64_scale_err(f"card vs CPU float64 {name} state ch{c}",
                              sg.state[..., c].cpu(), sc.state[..., c],
                              F64_CARD_CPU_RTOL) for c in range(3))
        for f in ("lne", "cgx", "cgy", "px", "py"):
            e = max(e, f64_scale_err(
                f"card vs CPU float64 {name} {f}",
                getattr(sg.particles, f).cpu(), getattr(sc.particles, f),
                F64_CARD_CPU_RTOL))
        e_dt = f64_scale_err(f"card vs CPU float64 {name} dt",
                             sg.particles.dt.cpu(), sc.particles.dt,
                             F64_CARD_CPU_DT_RTOL)
        mg_, mc_ = sg.metrics.as_dict(), sc.metrics.as_dict()
        assert mg_ == mc_, f"card vs CPU float64 {name}: {mg_} vs {mc_}"
        out[name] = dict(err=e, dt_err=e_dt)
        log("float64", f"card (graphed) vs CPU, {name} {n}^2, {F64_STEPS} "
                       f"steps: max err {e:.3e} of the scale, dt "
                       f"{e_dt:.3e}, counters equal {mg_}")
    return out


# ---------------------------------------------------------------------------
# float64 under every wind (phase "float64", part 2): the traced kind's
# double instances of K1, K3, K5, K6, K7's double instance and the float64
# winds made JAX's
# ---------------------------------------------------------------------------

# The double instances of the traced kind against their float64 plain
# versions: K3's estimate runs the same operations in float64 with the same
# libdevice functions (ATen's double pow alone parts, by an ulp, under
# nvcc's default FMA contraction, which K3's Hairer pow does not reach on
# these states), held within F64_K3_RTOL of its scale
F64_K3_RTOL = 1e-15
# the 2D pulse on the card against the CPU (3 steps) and the 1D float64 run
F64_PULSE_CPU_N = 128
F64_1D_CPU_NODES = 31
F64_1D_CPU_STEPS = 6
F64_1D_FIXED_DT = 10.0
# the global jet's form for the node planes' check (U0 cos(lat) on a float64
# spherical grid): its float64 values kept by the float64 node planes
F64_JET_U0 = 20.0


def f64_blob_u(x, y, t):
    """``slopped_blob`` over the box (B01_STORM's storm, x in m)."""
    return slopped_blob(x, t, **B01_STORM)


def f64_traced_callables() -> dict:
    """The 2D callables traced in float64: the pulse and ``slopped_blob``
    (held bit for bit on the card), the time-cosine sampler (its float32
    arithmetic on float32(t): the graph's casts) and ``every_op_winds``
    (every operation of ``wind_trace.OPS`` in double)."""
    cos = time_cosine_winds(10.0, 5.0, 6 * 3600.0, t_off=9000.0)
    return {"pulse": pulse_winds(),
            "slopped_blob": Winds2D(u=f64_blob_u,
                                    v=lambda x, y, t: torch.zeros_like(x)),
            "time_cosine": Winds2D(u=cos.u, v=cos.v),
            "every op": every_op_winds()}


def f64_traced_kernels(dev, winds: dict):
    """Each 2D callable of ``winds`` and the 1D storm traced on the card in
    float64 (``traced_kernel(..., dtype=torch.float64)``), and the float32
    pulse (the float32 instances the double rows are timed against).
    Returns (name -> descriptor, the storm's descriptor, the float32
    pulse's)."""
    kerns = {k: traced_kernel(w, dev, F64) for k, w in winds.items()}
    storm = traced_kernel_1d(Winds1D(u=storm_u), dev, F64)
    assert all(k.traced.dtype == F64 for k in (*kerns.values(), storm))
    return kerns, storm, traced_kernel(pulse_winds(), dev)


def f64_traced_build(kerns: dict, storm, pulse32):
    """The float64 traced libraries (each of ``kerns`` and the storm's)
    and the float32 pulse's built, all at once (a thread a library, nvcc's
    processes in parallel; no CUDA call, so it runs beside the phase's
    checks); each float64 library's double instances hold no narrowing to
    float32 outside the out-of-line functions (``narrowing_summary``), and
    ``traced_f32_...`` ones only in a graph that casts (the time-cosine).
    Returns (the build's wall seconds, the narrowing by name)."""
    traced = [k.traced for k in kerns.values()] + [storm.traced]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(traced) + 1) as ex:
        builds = list(ex.map(cuda_build.build_traced,
                             traced + [pulse32.traced]))[:-1]
        narrow = list(ex.map(cuda_build.narrowing_summary, traced))
    wall = time.perf_counter() - t0
    names = list(kerns) + ["storm 1D"]
    out = {}
    for name, tr, nr in zip(names, traced, narrow):
        assert not nr["other"], f"{name}: narrowing {nr['other'][:4]}"
        assert (nr["traced"] > 0) == (tr.narrowings > 0), (name, nr)
        out[name] = {k: v for k, v in nr.items() if k != "other"}
    assert out["time_cosine"]["casts"] == 2, out
    ents = [e for b in builds for e in ptxas_entries(b.log)]
    spills = [e for e in ents if e[2] or e[3]]
    log("float64", f"{len(traced)} float64 traced libraries built in "
                   f"{wall:.1f} s (each {[round(b.seconds, 1) for b in builds]}"
                   f" s); registers {min(e[1] for e in ents)}-"
                   f"{max(e[1] for e in ents)}, {len(spills)} spilling: "
                   f"{spills}; narrowing {out}")
    for e in ents:
        log("build", f"  traced f64 {e[0][:96]}: {e[1]} registers, spill "
                     f"stores {e[2]} B, loads {e[3]} B")
    return wall, out


def f64_probe_points(dev, n: int):
    """``n`` float64 points (x, y, t): t at the pulse's switch times and
    their float64 neighbours among them, the rest uniform."""
    rng = np.random.default_rng(47)
    x = torch.as_tensor(rng.uniform(-1e5, 6e5, n), device=dev)
    y = torch.as_tensor(rng.uniform(-90.0, 90.0, n), device=dev)
    ts = rng.uniform(0.0, 3e4, n)
    sw = np.array(TRACED_SWITCHES)
    near = np.concatenate([sw, np.nextafter(sw, -1e9), np.nextafter(sw, 1e9)])
    ts[:near.size] = near
    ts[near.size:near.size + 4096] = np.repeat(sw, 1024)
    return x, y, torch.as_tensor(ts, device=dev)


def f64_traced_probe_check(dev, winds: dict, kerns: dict, storm, n: int
                           ) -> dict:
    """Each emitted double function alone (``picles_traced_probe_f64``,
    ``picles_traced_probe_1d_f64``) on ``n`` float64 points against its
    callable run by torch on the card, each value cast to float64 as the
    kernels cast it: bit for bit for the pulse, ``slopped_blob``, the
    time-cosine and the 1D storm; ``every_op_winds`` within an ulp (the
    double pow by a general exponent: libdevice's, compiled here without
    FMA contraction, parts from ATen's by an ulp in a few lanes), its
    differing lanes counted.  The plain evaluator bit for bit the callable.
    Returns name -> (operations, differing lanes)."""
    x, y, t = f64_probe_points(dev, n)
    out = {}

    def compare(name, got, want, exact):
        d = int((bits(got) != bits(want)).sum())
        assert torch.equal(torch.isnan(got), torch.isnan(want)), name
        if exact:
            assert d == 0, f"traced f64 {name}: {d} of {n} points differ"
        else:
            scale = float(want.abs().nan_to_num(posinf=0.0).max())
            err = float((got - want).abs().nan_to_num().max())
            assert err <= 4 * np.finfo(np.float64).eps * scale, (name, err)
        return d

    for name, w in winds.items():
        tr = kerns[name].traced
        lib = cuda_build.traced_library(tr)
        u, v = torch.empty_like(x), torch.empty_like(x)
        with torch.cuda.device(dev):
            code = lib.picles_traced_probe_f64(
                x.data_ptr(), y.data_ptr(), t.data_ptr(), u.data_ptr(),
                v.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check_status(code, "traced f64 probe")
        want = [torch.broadcast_to(f(x, y, t), x.shape).to(F64).contiguous()
                for f in (w.u, w.v)]
        d = 0
        for c, a, b, e in zip("uv", (u, v), want, tr.evaluate(x, y, t)):
            d += compare(f"{name} {c}", a, b, name != "every op")
            assert torch.equal(bits(torch.broadcast_to(e, x.shape).to(F64)
                                    .contiguous()), bits(b)), (name, c)
        out[name] = dict(ops=len(tr.ops), differing=d)
    u = torch.empty_like(x)
    lib = cuda_build.traced_library_1d(storm.traced)
    with torch.cuda.device(dev):
        code = lib.picles_traced_probe_1d_f64(
            x.data_ptr(), t.data_ptr(), u.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_status(code, "traced 1D f64 probe")
    want = torch.broadcast_to(storm_u(x, t), x.shape).to(F64).contiguous()
    out["storm 1D"] = dict(ops=len(storm.traced.ops),
                           differing=compare("storm 1D", u, want, True))
    log("float64", f"the emitted double functions on {n} float64 points: "
                   f"{out} (differing lanes against the callable on the "
                   f"card; the pulse, slopped_blob, the time-cosine and the "
                   f"storm bit for bit)")
    return out


def time_cosine_division_check(dev, n: int) -> dict:
    """``time_cosine_winds``' sampler on ``n`` float32 times up to 10 days
    bit for bit cos(2 pi t / p) with the period divided as IEEE division,
    as the JAX package divides it and the kernels' ``cosine_amplitude``
    does (a division by a 0-dim tensor on the card), where ATen's division
    by a host scalar, t * (1 / p), parts by a float32 ulp in some lanes
    (counted).  Returns the counts."""
    rng = np.random.default_rng(53)
    t = torch.as_tensor(rng.uniform(0.0, 864000.0, n).astype(np.float32),
                        device=dev)
    period = 6 * 3600.0
    w = time_cosine_winds(1.0, 0.0, period)
    got = w.u(t, t, t)
    div = torch.cos(2.0 * math.pi * t / torch.full((), period,
                                                    device=dev))
    recip = torch.cos(2.0 * math.pi * t / period)
    torch.cuda.synchronize()
    same = int((bits(got) != bits(div)).sum())
    assert same == 0, f"time_cosine_winds differs from IEEE division on " \
                      f"{same} of {n} times"
    parted = int((bits(recip) != bits(div)).sum())
    log("float64", f"time_cosine_winds' amplitude on {n} float32 times bit "
                   f"for bit cos(2 pi t / p) by IEEE division; ATen's host "
                   f"scalar division (t * (1 / p)) parts on {parted}")
    return dict(times=n, reciprocal_parts=parted)


def f64_traced_state(dev, n: int, path: str = "fused", steps: int = 6):
    """The float64 pulse under ``path`` (``pulse_model``) at n^2 after
    ``steps`` eager steps (the wind on: its traced double instances):
    (model, state)."""
    m = pulse_model(path, n, dev, dtype=F64)
    assert m.winds.kernel.traced.dtype == F64 and m.graphed
    return m, eager_steps(m, m.init_state(), steps)


def f64_traced_kernel_checks(dev, n: int, winds: dict, kerns: dict,
                             results: dict,
                             only=("K1", "K3", "K5", "K6"),
                             wind_names=("pulse",)) -> dict:
    """The traced kind's double instances (those of ``only``) at n^2 on
    the float64 pulse's states against their float64 plain versions (the
    callable itself): K1 (``f64_k1_check``) on the fused state with its
    lanes across the pulse's stop, under the winds of ``wind_names`` (the
    pulse; the card tests add ``slopped_blob`` and the time-cosine), bosh3
    and tsit5 in fixed substeps of 37.5 s within
    F64_RTOL of each component's scale (dt, failed and naccept equal) and
    adaptive by ``assert_controller``; K3 on the default state, every lane
    and half reset, within F64_K3_RTOL of its scale, the unreset lanes'
    dt bit for bit; K5 on the fused deposit at the clock (the wind on: a
    band of rows deposited empty reseeds) and at 7200 s (calm: it goes
    off) bit for bit its plain version in every field, K6 bit for bit K2 +
    K5.  Returns the max scaled errors by kernel."""
    consts, flags = f64_consts(), TermFlags()
    errs = {}
    fm, fs = f64_traced_state(dev, n)
    P = fs.particles
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    act = P.on & fm.active_mask
    g = fm.grid
    proj = fm.uniform_proj
    rng = np.random.default_rng(61)
    # lanes started from 0 to 12000 s, the switch times among them
    t0 = torch.as_tensor(rng.uniform(0.0, 1.2e4, (n, n)), device=dev)
    k = min(1024, n * n // 4)
    t0.view(-1)[:4 * k] = torch.as_tensor(np.repeat(np.array(
        TRACED_SWITCHES) - DT / 2, k), device=dev)
    if "K1" in only:
        errs["K1"] = 0.0
        for wname in wind_names:
            w = winds[wname]._replace(kernel=kerns[wname])
            for method in ("bosh3", "tsit5"):
                for adaptive in (False, True):
                    cfg = SolverConfig(method=method, adaptive=adaptive,
                                       dtmin=1e-4, force_dtmin=True)
                    dt = P.dt if adaptive else torch.full_like(P.dt, 37.5)
                    e, _, _ = f64_k1_check(
                        f"K1 traced f64 {wname} {method} "
                        f"{'adaptive' if adaptive else 'fixed'}", w, consts,
                        flags, cfg, comps, t0, dt, act, g, proj,
                        plain_winds=winds[wname])
                    if not adaptive:
                        errs["K1"] = max(errs["K1"], e)
    if "K3" in only:
        dm, ds = f64_traced_state(dev, n, "default", 3)
        Q = ds.particles
        qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
        errs["K3"] = 0.0
        for wname in wind_names:
            w = winds[wname]._replace(kernel=kerns[wname])
            for tag, reset in (("all", torch.ones_like(Q.on)),
                               ("half", half_reset_mask((n, n), dev,
                                                        seed=62))):
                k3 = auto_dt_cuda(w, consts, flags, t0, qc, dm.grid.x,
                                  dm.grid.y, dm.uniform_proj, reset, Q.dt,
                                  1e-4, DT)
                aux = RHSParams(x=dm.grid.x, y=dm.grid.y, M=dm.grid.proj,
                                pc=dm.grid.pc)
                p = auto_dt_reset(make_rhs(w.u, w.v, consts, flags), t0,
                                  torch.stack(qc, dim=-1), aux, reset, Q.dt,
                                  1e-4, DT)
                errs["K3"] = max(errs["K3"], f64_scale_err(
                    f"K3 traced f64 {wname} {tag} reset", k3, p,
                    F64_K3_RTOL))
                assert torch.equal(bits(k3[~reset]), bits(Q.dt[~reset]))
        log("K3 traced f64", f"{n}^2: within {F64_K3_RTOL:g} of the scale "
                             f"(max {errs['K3']:.3e}); unreset dt bit for "
                             f"bit")
    if "K5" in only or "K6" in only:
        core, chans, sact = flagship_deposit_inputs(fm, fs)
        band = torch.arange(n, device=dev)[:, None] < n // 3
        chans = tuple(torch.where(band, 0.0, c) for c in chans)
        rp = fm.remesh_params
        prp = rp._replace(winds=winds["pulse"])
        ga = (core[3], core[4], chans, sact, g.stats, fm.config.halo)
        node, _ = pic_gather(*ga)
        errs["K5"] = errs["K6"] = 0.0
        for clock in (fs.time, torch.full((), 7200.0, device=dev,
                                          dtype=F64)):
            cc = (*core[:-1], clock)
            k5 = remesh_cuda(rp, node, *cc)
            assert_bitwise(f"K5 traced f64 pulse at {float(clock):g} s vs "
                           f"its plain version", k5,
                           remesh_core(prp, node, *cc))
            nd, rm, _ = pic_gather_remesh(*ga, rp, *cc)
            assert_bitwise(f"K6 traced f64 pulse at {float(clock):g} s vs "
                           f"K2 + K5", (*nd, *rm), (*node, *k5))
            br = branch_counts(k5.branch)
            assert (" reseed 0 " in br) == (float(clock) >= 7200.0) and \
                (" off 0" in br) != (float(clock) >= 7200.0), br
            log("K5 traced f64", f"pulse at {float(clock):g} s: {br}; K5 "
                                 f"bit for bit its plain version, K6 bit "
                                 f"for bit K2 + K5")
    for kk, e in errs.items():
        results[f"{kk} traced f64"]["max_abs_err"] = e
    return errs


def f64_k7_probe(dev, n: int = K7_PROBE_LANES):
    """K7's probe (``k7_probe``) in float64: the same lanes widened, the
    node plane the probe's wind computed in float64 at the float64 lanes
    (a steady callable's float64 values), the record its float32 data.
    Returns (z, t, dt, active, x, plane, record, the plane's callable)."""
    z, t, dt, act, x, _, rec = k7_probe(dev, n)
    x64 = x.double()

    def wind(xx, tt):
        return 10.0 + 4.0 * torch.sin(xx * (2.0 * np.pi / 200e3))

    plane = steady_node_plane_1d(Winds1D(u=wind), x64, F64)
    return (z.double().contiguous(), t.double(), dt.double(), act, x64,
            plane, rec, Winds1D(u=lambda xx, tt: plane))


def f64_k7_case(tag: str, model, wind, winds, method: str, adaptive: bool,
                z, t, dt, act, x) -> dict:
    """K7's double instance against its float64 plain version
    (``integrate_to`` over ``particle_equations_1d`` of ``winds``): fixed
    substeps of K7_FIXED_DT s with lne, cg_x and x within F64_RTOL of their
    scale, t, dt, failed and naccept equal; adaptive by ``assert_adaptive``
    and (4096 lanes or more) ``assert_controller``, failed equal.  The
    launch is not counted."""
    cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                       force_dtmin=True)
    if not adaptive:
        dt = torch.full_like(dt, K7_FIXED_DT)
    before = (advance_1d.f64_launches, advance_1d.traced_f64_launches)
    k = advance_1d(wind, model.consts, TermFlags(), cfg, DT, z, t, dt, act,
                   x)
    advance_1d.f64_launches, advance_1d.traced_f64_launches = before
    rhs = particle_equations_1d(winds.u, gamma=model.constants.gamma,
                                params=model.params, constants=model.constants)
    p = integrate_to(rhs, z, t, t + DT, dt, x, act, cfg)
    torch.cuda.synchronize()
    assert k.z.dtype == F64 and torch.equal(k.failed, p.failed), tag
    if adaptive:
        err = max(assert_adaptive(f"{tag} {nm}", k.z[:, c], p.z[:, c])
                  for c, nm in ((0, "lne"), (1, "cg_x")))
        extra = (assert_controller(tag, k, p, act) if z.shape[0] >= 4096
                 else f"naccept equal on {int((k.naccept == p.naccept).sum())}"
                      f" of {z.shape[0]} lanes")
    else:
        err = max(f64_scale_err(f"{tag} {nm}", k.z[:, c], p.z[:, c],
                                F64_RTOL)
                  for c, nm in ((0, "lne"), (1, "cg_x"), (2, "x")))
        for nm in ("t", "dt", "failed", "naccept"):
            assert torch.equal(getattr(k, nm), getattr(p, nm)), \
                f"{tag}: {nm} differs"
        extra = "t, dt, failed and naccept equal"
    log("K7 f64", f"{tag}: max err {err:.3e} of the scale, substeps max "
                  f"{int(k.naccept.max())}/{int(p.naccept.max())}, failed "
                  f"{int(k.failed.sum())}; {extra}")
    return dict(err=err, k=k, p=p, cfg=cfg, rhs=rhs, dt=dt)


def f64_k7_checks(dev, storm, results, probe_lanes: int = K7_PROBE_LANES,
                  b01_steps: int = 24) -> dict:
    """K7's double instances against their float64 plain versions
    (``f64_k7_case``): on the float64 probe (``f64_k7_probe``) the node
    kind, adaptive tsit5 and bosh3; on the float64 B01 state after
    ``b01_steps`` steps (its own float64 model, K7 graphed) the node,
    gridded (``k7_record``) and traced (the storm's float64 library)
    kinds, bosh3 and tsit5, fixed substeps and adaptive.  Returns the
    cases' errors and the probe's timed cases."""
    model = b01_model(dev, dtype=F64)
    st = eager_steps(model, model.init_state(), b01_steps).particles
    b01 = (st.z.contiguous(), st.t, st.dt, st.on & ~model.boundary_mask,
           model.grid.x)
    probe = f64_k7_probe(dev, probe_lanes)
    rec = k7_record(dev)
    out, worst, worst_t, timed = {}, 0.0, 0.0, {}
    for kind in ("node", "gridded", "traced"):
        wind = {"node": model._node_plane, "gridded": rec,
                "traced": storm}[kind]
        winds_ = {"node": Winds1D(u=lambda xx, tt, _p=model._node_plane: _p),
                  "gridded": rec.as_winds(),
                  "traced": Winds1D(u=storm_u)}[kind]
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                tag = (f"K7 f64 B01 {kind} {method} "
                       f"{'adaptive' if adaptive else 'fixed'}")
                r = f64_k7_case(tag, model, wind, winds_, method, adaptive,
                                *b01)
                if not adaptive:
                    if kind == "traced":
                        worst_t = max(worst_t, r["err"])
                    else:
                        worst = max(worst, r["err"])
                out[tag] = r["err"]
    z, t, dt, act, x, plane, prec, pw = probe
    for kind, wind, winds_ in (("node", plane, pw),
                               ("gridded", prec, prec.as_winds()),
                               ("traced", storm, Winds1D(u=storm_u))):
        r = f64_k7_case(f"K7 f64 probe {kind} tsit5 adaptive", model, wind,
                        winds_, "tsit5", True, z, t, dt, act, x)
        timed[kind] = r
    results["K7 f64"]["max_abs_err"] = worst
    results["K7 traced f64"]["max_abs_err"] = worst_t
    return dict(cases=out, timed=timed, probe=probe, model=model)


def f64_k7_rows(k7: dict, storm, results) -> dict:
    """The K7 double rows on the float64 probe, adaptive tsit5: each in
    turns with its float32 instance on the same lanes cast to float32
    (``f64_turns``, CUDA events), beside its float64 plain version and its
    bound (``k7_bound`` with the float64 lanes' bytes and rate): the node
    kind ("K7 f64"; the gridded kind beside it, under the probe's record)
    and the storm ("K7 traced f64" against the float32 storm's library)."""
    model = k7["model"]
    z, t, dt, act, x, plane, rec, _ = k7["probe"]
    m32 = b01_model(z.device)
    z32, t32, dt32, x32 = (a.float().contiguous() for a in (z, t, dt, x))
    storm32 = traced_kernel_1d(Winds1D(u=storm_u), z.device)
    out = {}
    for key, kind, w64, w32 in (("K7 f64", "node", plane, k7_wind(x32)),
                                ("K7 f64 gridded", "gridded", rec, rec),
                                ("K7 traced f64", "traced", storm, storm32)):
        r = k7["timed"][kind]
        cfg, rhs = r["cfg"], r["rhs"]

        def launch(w, m, *a):
            before = (advance_1d.launches, advance_1d.f64_launches,
                      advance_1d.traced_launches,
                      advance_1d.traced_f64_launches)
            res = advance_1d(w, m.consts, TermFlags(), cfg, DT, *a)
            (advance_1d.launches, advance_1d.f64_launches,
             advance_1d.traced_launches,
             advance_1d.traced_f64_launches) = before
            return res

        f32_ms, ms = f64_turns(
            lambda: launch(w32, m32, z32, t32, dt32, act, x32),
            lambda: launch(w64, model, z, t, dt, act, x), 5)
        plain = cuda_time_ms(lambda: integrate_to(rhs, z, t, t + DT, dt, x,
                                                  act, cfg), 1)
        it = r["p"].naccept + r["p"].nreject
        b = k7_bound(z.shape[0], "tsit5", True, act, it,
                     record_bytes=rec.u_data.numel() * 4 if kind ==
                     "gridded" else 0,
                     traced_ops=len(storm.traced.ops) if kind == "traced"
                     else 0, real=8)
        out[key] = dict(ms=ms, f32_ms=f32_ms, plain_ms=plain, **b,
                        substeps_live_mean=float(
                            r["p"].naccept[act].double().mean()))
        log("kernel-time", f"{key}: {ms:.4f} ms, its float32 instance "
                           f"{f32_ms:.4f} ms in turns ({ms / f32_ms:.2f}x), "
                           f"plain float64 {plain:.4f} ms, bound "
                           f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
                           f"{out[key]['substeps_live_mean']:.2f} substeps "
                           f"a live lane")
    for key in ("K7 f64", "K7 traced f64"):
        results[key].update({k: out[key][k] for k in (
            "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by")})
    results["K7 f64"]["gridded"] = out["K7 f64 gridded"]
    return out


def f64_day_turns(m64, m32, steps: int, reps: int = 2) -> dict:
    """Each model's day (``steps`` steps through ``Simulation.run``,
    graphed, no frame stored) in turns, float32, float64, float64,
    float32: the wall seconds of each and their medians."""
    for m in (m64, m32):
        m.step_n_quiet(m.init_state(), 1)   # captured before the turns
    turns = {"float32": [], "float64": []}
    for who in ("float32", "float64", "float64", "float32")[:2 * reps]:
        m = m64 if who == "float64" else m32
        sim = Simulation.create(m, stop_time=(steps - 1) * DT)
        sim.run()
        turns[who].append(sim.run_wall_time)
    return dict(turns_s=turns, median_s={k: float(np.median(v))
                                         for k, v in turns.items()})


def f64_graphed_day(tag: str, m, steps: int, rows: tuple, results,
                    trace_steps: int) -> dict:
    """``steps`` graphed steps of the float64 model ``m`` through
    ``Simulation.run``, then the same steps eagerly from the seed with the
    counters set to 0 just before and read just after (``eager_day``: bit
    for bit the graphed run, no failed or clamped lane summed over the
    steps, each double instance of ``rows`` once a step), then
    ``trace_steps`` replays more under a trace (``trace_window``: each
    counted by name, the host's counters 0); launches added to the rows.
    Returns the counters, the launches and the trace's stats."""
    sim = Simulation.create(m, stop_time=(steps - 1) * DT)
    sim.run()
    reset_f64_counters()
    day, _ = eager_day(m, sim.state, steps)
    c = f64_counters()
    want = {KERNEL_KEYS[r]: trace_steps for r in rows}
    reset_f64_counters()
    stats, got = trace_window(lambda: m.step_n_quiet(sim.state, trace_steps),
                              trace_steps, want)
    got = {r: got[KERNEL_KEYS[r]] for r in rows}
    assert not any(f64_counters().values()), "the host launched kernels"
    for r in rows:
        assert c[r] == steps, (tag, c)
        results[r]["launches"] += c[r] + got[r]
        results[r]["graph_launches"] = \
            results[r].get("graph_launches", 0) + got[r]
    assert day["n_failed"] == 0, (tag, day)
    assert day.get("n_clamped", 0) == 0, (tag, day)
    log("float64", f"{tag}: {steps} graphed steps through Simulation.run bit "
                   f"for bit the eager steps (launches "
                   f"{({r: c[r] for r in rows})}); counters summed {day}; "
                   f"{trace_steps} replays by trace {got}, idle share "
                   f"{stats['idle_share']:.4f}, "
                   f"{stats['device_ops_per_step']:.1f} device ops a step")
    return dict(day=day, eager_launches={r: c[r] for r in rows},
                launches_by_trace=got, idle_share=stats["idle_share"],
                device_ops_per_step=stats["device_ops_per_step"])


def f64_jet_u(x, y, t):
    """The global jet's form: U0 cos(lat), float64 arithmetic on a float64
    spherical grid (y in degrees)."""
    return F64_JET_U0 * torch.cos(torch.deg2rad(y)) + 0.0 * x


def f64_spherical_model(n: int, dev, winds):
    """A float64 spherical grid (per-node projection planes) forced by
    ``winds`` in the fused flagship's configuration (bosh3, the carried dt,
    K1 and K6, halo 3)."""
    grid = spherical_grid_2d(0.0, 360.0 * (n - 1) / n, n, -70.0, 70.0, n,
                             periodic_boundary=(True, False), device=dev,
                             dtype=F64)
    return WaveGrowth2D(grid, winds, settings("bosh3"),
                        config=WaveGrowth2DConfig(
                            periodic_boundary=False, dtype=F64, halo=3,
                            remesh_mode="fused", dt_reset_mode="carry"))


F64_CARD_CPU_CASES = ("pulse fused", "jet node planes", "1D node",
                      "1D gridded", "1D traced")


def f64_winds_card_vs_cpu(dev, n2d: int = F64_PULSE_CPU_N,
                          nx: int = F64_1D_CPU_NODES,
                          names=F64_CARD_CPU_CASES) -> dict:
    """The card (the double instances, graphed) against the CPU (the plain
    versions) for each float64 wind this phase adds, within
    F64_CARD_CPU_RTOL of each plane's scale (the carried dt within
    F64_CARD_CPU_DT_RTOL), the counters equal, of ``names``: the traced
    pulse, fused and default, at n2d^2, F64_STEPS steps; the fused
    configuration on a float64 spherical grid under the global jet's form
    (a steady callable in float64 arithmetic: the node planes keep its
    float64 values; rounded to float32 they part by some 1e-7); the
    float64 1D model on ``nx``
    nodes, F64_1D_CPU_STEPS steps under the node kind (B01) and a record,
    and under the storm (traced) in fixed substeps of F64_1D_FIXED_DT s
    (adaptive, the controller carries the card's and the CPU's double exp
    apart by an ulp here and there, which it grows: that gap is logged,
    with the counters equal).  ``names``: only these cases.  Returns the
    errors."""
    out = {}
    pairs = {
        "pulse fused": lambda d: pulse_model("fused", n2d, d, dtype=F64),
        "pulse default": lambda d: pulse_model("default", n2d, d, dtype=F64),
        "jet node planes": lambda d: f64_spherical_model(
            n2d, d, Winds2D(u=f64_jet_u,
                            v=lambda x, y, t: 3.0 + 0.0 * y))}
    for name, make in pairs.items():
        if name not in names:
            continue
        rtol = F64_CARD_CPU_RTOL
        mg, mc = make(dev), make("cpu")
        assert mg.graphed and not mc.graphed
        if name.startswith("jet"):
            assert mg.winds.kernel.kind == WindKind.NODE
            assert mg.node_planes(mg.grid).dtype == F64
        sg = mg.step_n_quiet(mg.init_state(), F64_STEPS)
        sc = eager_steps(mc, mc.init_state(), F64_STEPS)
        mg.release_graph()
        e = max(f64_scale_err(f"card vs CPU float64 {name} state ch{c}",
                              sg.state[..., c].cpu(), sc.state[..., c],
                              rtol) for c in range(3))
        for f in ("lne", "cgx", "cgy", "px", "py"):
            e = max(e, f64_scale_err(
                f"card vs CPU float64 {name} {f}",
                getattr(sg.particles, f).cpu(), getattr(sc.particles, f),
                rtol))
        e_dt = f64_scale_err(f"card vs CPU float64 {name} dt",
                             sg.particles.dt.cpu(), sc.particles.dt,
                             max(rtol, F64_CARD_CPU_DT_RTOL))
        a, b = sg.metrics.as_dict(), sc.metrics.as_dict()
        assert a == b, f"card vs CPU float64 {name}: {a} vs {b}"
        out[name] = dict(err=e, dt_err=e_dt)
    for kind in ("node", "gridded", "traced"):
        if f"1D {kind}" not in names:
            continue

        def make1d(d, kind=kind, adaptive=kind != "traced"):
            m = b01_model(d, nx=nx, dtype=F64)
            if kind == "node":
                return m
            w = (Winds1D(u=storm_u) if kind == "traced"
                 else k7_record(d).as_winds())
            sett = m.settings if adaptive else dataclasses.replace(
                m.settings, adaptive=False, dt=F64_1D_FIXED_DT)
            return WaveGrowth1D(m.grid, w, sett, config=m.config)

        def gap(mg, mc, tag, rtol):
            assert mg.graphed and mg.advance_mode == "cuda" \
                and not mc.graphed
            sg = mg.step_n_quiet(mg.init_state(), F64_1D_CPU_STEPS)
            sc = eager_steps(mc, mc.init_state(), F64_1D_CPU_STEPS)
            mg.release_graph()
            e = max(f64_scale_err(f"{tag} {nm}", a, b, rtol)
                    for nm, a, b in (("state", sg.state.cpu(), sc.state),
                                     ("z", sg.particles.z.cpu(),
                                      sc.particles.z)))
            a, b = sg.metrics.as_dict(), sc.metrics.as_dict()
            smax = (a.pop("substeps_max"), b.pop("substeps_max"))
            assert a == b and abs(smax[0] - smax[1]) <= 2, (tag, a, b, smax)
            return e

        tag = f"card vs CPU float64 1D {kind}"
        out[f"1D {kind}"] = dict(err=gap(make1d(dev), make1d("cpu"), tag,
                                         F64_CARD_CPU_RTOL))
        if kind == "traced":
            out["1D traced adaptive"] = dict(gap=gap(
                make1d(dev, adaptive=True), make1d("cpu", adaptive=True),
                f"{tag} adaptive", 1.0))
    log("float64", f"card (graphed) vs CPU, float64 winds: {out}")
    return out


def phase_float64_winds(dev, traced, build, results, timing) -> None:
    """Float64 under every wind (phase "float64", after ``phase_float64``'s
    checks; ``traced`` the callables' descriptors (``f64_traced_kernels``),
    ``build`` the future of ``f64_traced_build``, started at the phase's
    start).  (a) ``time_cosine_winds``' sampler divides as IEEE
    division (``time_cosine_division_check``); the float64 traced
    libraries' narrowing; each emitted double function alone
    (``f64_traced_probe_check``).  (b) The traced double instances at
    FLAG_N^2 against their plain versions (``f64_traced_kernel_checks``).
    (c) The float64 pulse's main path, the counters set to 0 just before
    and read just after: the fused day (PULSE_STEPS steps) and the default
    and "pallas" configurations' F64_STEPS steps (``f64_graphed_day``:
    graphed through ``Simulation.run``, bit for bit eager, then replays
    counted by trace), the fused day in turns with its float32 day.  (d) K7's double instances
    against their plain versions (``f64_k7_checks``); B01's and the storm's
    float64 days (two model days, ``f64_graphed_day``) in turns with their
    float32 days.  (e) The rows' times (``f64_traced_rows``,
    ``f64_k7_rows``).  (f) The card against the CPU
    (``f64_winds_card_vs_cpu``)."""
    t0 = time.perf_counter()
    marks = {}

    def mark(part):
        marks[part] = time.perf_counter() - t0 - sum(marks.values())

    out = dict(time_cosine=time_cosine_division_check(dev, 1 << 20))
    winds = f64_traced_callables()
    kerns, storm, _ = traced
    build_s, narrowing = build.result()
    mark("waiting for the build")
    out.update(build_seconds=build_s, narrowing=narrowing)
    out["probe"] = f64_traced_probe_check(dev, winds, kerns, storm,
                                          TRACED_PROBE_POINTS)
    n = FLAG_N
    out["kernel_errors"] = f64_traced_kernel_checks(dev, n, winds, kerns,
                                                    results)
    mark("(a) probes, (b) kernel checks")
    days = {}
    for path, rows, steps in (
            ("fused", ("K1 traced f64", "K6 traced f64"), PULSE_STEPS),
            ("default", ("K1 traced f64", "K2 f64", "K3 traced f64"),
             F64_STEPS),
            ("pallas", ("K1 traced f64", "K2 f64", "K5 traced f64"),
             F64_STEPS)):
        m = (pulse_model(path, n, dev, dtype=F64) if path != "pallas" else
             flagship_model(n, dev, winds=pulse_winds(), remesh_mode="pallas",
                            dtype=F64))
        assert m.winds.kernel.traced.dtype == F64 and m.graphed
        days[path] = f64_graphed_day(f"float64 pulse {path}", m, steps, rows,
                                     results, min(steps, 12))
        if path == "fused":
            m32 = pulse_model("fused", n, dev)
            days[path]["turns"] = f64_day_turns(m, m32, PULSE_STEPS)
            m32.release_graph()
            del m32
        m.release_graph()
        del m
    out["pulse"] = days
    mark("(c) the pulse's days")
    k7 = f64_k7_checks(dev, storm, results)
    one_d = {}
    for name, rows, make in (
            ("B01", ("K7 f64",), lambda dt: b01_model(dev, dtype=dt)),
            ("storm", ("K7 traced f64",),
             lambda dt: b01_storm_model(dev, dtype=dt))):
        m64, m32 = make(F64), make(torch.float32)
        assert m64.graphed and m64.advance_mode == "cuda"
        one_d[name] = f64_graphed_day(f"float64 1D {name}", m64, B01_STEPS,
                                      rows, results, K7_TRACED_STEPS)
        one_d[name]["turns"] = f64_day_turns(m64, m32, B01_STEPS)
        m64.release_graph()
        m32.release_graph()
    out["1d"] = one_d
    mark("(d) K7 checks, the 1D days")
    out["rows"] = f64_traced_rows(dev, n, winds, kerns, results)
    out["k7_rows"] = f64_k7_rows(k7, storm, results)
    mark("(e) the rows' times")
    del k7
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = f64_winds_card_vs_cpu(dev)
    mark("(f) card against CPU")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = marks
    timing["float64_winds"] = out
    log("float64", f"float64 under every wind: done in {out['seconds']:.1f} "
                   f"s ({marks}); pulse fused day graphed "
                   f"{days['fused']['turns']['median_s']} s, B01 "
                   f"{one_d['B01']['turns']['median_s']} s, storm "
                   f"{one_d['storm']['turns']['median_s']} s (medians in "
                   f"turns)")


def f64_traced_rows(dev, n: int, winds: dict, kerns: dict, results) -> dict:
    """The traced double rows at n^2 on the float64 pulse's states at 3600
    s (the wind on): each in turns with the float32 pulse's traced instance
    on the same values cast to float32 (``f64_turns``, CUDA events; K6 by
    traces, ``kernel_ms``, its wrapper also sums the clamped count),
    beside its float64 plain version and its bound (``bound`` with the
    float64 lanes' bytes: ``k1_bound``, ``k3_bound`` every lane reset,
    ``remesh_bound`` and ``deposit_bound`` by this state's branches)."""
    fm, fs = f64_traced_state(dev, n)
    dm, ds = f64_traced_state(dev, n, "default", 6)
    assert float(fs.time) == float(ds.time) == 3600.0
    f32 = {name: pulse_model(name, n, dev) for name in ("fused", "default")}
    ops = len(kerns["pulse"].traced.ops)
    out = {}

    def down(xs):
        return tuple(a.float().contiguous() if a.is_floating_point() else a
                     for a in xs)

    P = fs.particles
    adv = P.on & fm.active_mask
    cf = (P.lne, P.cgx, P.cgy, P.px, P.py)
    g = fm.grid
    m32 = f32["fused"]
    cf32, t32, dt32 = down(cf), *down((P.t, P.dt))
    p = integrate_to(fm.rhs, torch.stack(cf, -1), P.t, P.t + DT, P.dt,
                     fm.aux, adv, fm.solver)
    f64_row(results, "K1 traced",
            lambda: advance_cuda(m32.winds, m32.consts, m32.flags,
                                 m32.solver, DT, cf32, t32, dt32, adv,
                                 m32.grid.x, m32.grid.y, m32.uniform_proj),
            lambda: advance_cuda(fm.winds, fm.consts, fm.flags, fm.solver,
                                 DT, cf, P.t, P.dt, adv, g.x, g.y,
                                 fm.uniform_proj),
            lambda: integrate_to(fm.rhs, torch.stack(cf, -1), P.t, P.t + DT,
                                 P.dt, fm.aux, adv, fm.solver),
            k1_bound(n * n, fm.solver.method, fm.solver.adaptive, adv,
                     p.naccept + p.nreject, traced_ops=ops, real=8),
            reps=10, plain_reps=1)
    Q = ds.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    reset = torch.ones_like(Q.on)
    d32 = f32["default"]
    qc32, qt32, qdt32 = down(qc), *down((Q.t, Q.dt))
    gd = dm.grid
    sett = dm.settings
    kw = dict(abstol=sett.abstol, reltol=sett.reltol, order=dm._rk_order)
    f64_row(results, "K3 traced",
            lambda: auto_dt_cuda(d32.winds, d32.consts, d32.flags, qt32, qc32,
                                 d32.grid.x, d32.grid.y, d32.uniform_proj,
                                 reset, qdt32, sett.dtmin, DT, **kw),
            lambda: auto_dt_cuda(dm.winds, dm.consts, dm.flags, Q.t, qc,
                                 gd.x, gd.y, dm.uniform_proj, reset, Q.dt,
                                 sett.dtmin, DT, **kw),
            lambda: auto_dt_reset(dm.rhs, Q.t, torch.stack(qc, -1), dm.aux,
                                  reset, Q.dt, sett.dtmin, DT, **kw),
            k3_bound(reset, dm.winds.kernel, real=8), reps=20, plain_reps=2)
    core, chans, sact = flagship_deposit_inputs(fm, fs)
    core32 = down(core[:6]) + core[6:9] + down(core[9:])
    chans32 = down(chans)
    halo = fm.config.halo
    node, _ = pic_gather(core[3], core[4], chans, sact, g.stats, halo)
    node32 = down(node)
    k5 = remesh_cuda(fm.remesh_params, node, *core)
    f64_row(results, "K5 traced",
            lambda: remesh_cuda(m32.remesh_params, node32, *core32),
            lambda: remesh_cuda(fm.remesh_params, node, *core),
            lambda: remesh_core(fm.remesh_params, node, *core),
            remesh_bound(n * n, n_wf=1, traced_ops=ops, branch=k5.branch,
                         real=8), reps=20, plain_reps=3)
    a = pic_gather_remesh(core[3], core[4], chans, sact, g.stats, halo,
                          fm.remesh_params, *core)

    def k6_plain():
        S, _ = scatter_dense(core[3], core[4], torch.stack(chans, -1), sact,
                             g.stats, halo)
        return remesh_core(fm.remesh_params,
                           tuple(S[..., i] for i in range(3)), *core)

    f64_row(results, "K6 traced",
            lambda: pic_gather_remesh(core32[3], core32[4], chans32, sact,
                                      g.stats, halo, m32.remesh_params,
                                      *core32),
            lambda: pic_gather_remesh(core[3], core[4], chans, sact, g.stats,
                                      halo, fm.remesh_params, *core),
            k6_plain,
            deposit_bound(n * n, n * n, halo, remesh=True, n_wf=1,
                          traced_ops=ops, branch=a[1].branch, real=8),
            reps=20, plain_reps=3)
    for key in F64_TRACED_REPLACES:
        if key in results and "ms" in results[key]:
            out[key] = {k: results[key][k] for k in (
                "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by")}
    for m in f32.values():
        m.release_graph()
    return out


def phase_float64(dev, results, timing) -> None:
    """The double instances of K1-K6 (the float64 library), then the
    float64 main path (phase "float64").

    (a) ``f64_kernel_checks`` at 256^2: every branch against its float64
    plain version.  (b) The float64 models at FLAG_N^2 on float64 grids
    (``f64_main_models``): 3 eager steps of each, the counters set to 0
    just before and read just after (every double instance of the path
    launched, no float32 one), no failed or clamped lane; the graphed step
    (``step_n_quiet``) bit for bit the eager steps, its replays' launches
    counted by trace.  (c) On those states each double instance against
    its float64 plain version: K1 in fixed substeps within F64_RTOL and
    adaptive by ``assert_controller`` with failed equal, K3 within
    F64_RTOL, K2 (both halos), K4 and K6's node planes within
    F64_DEPOSIT_RTOL and bit for bit across two launches, K5 and K6's
    remesh by ``f64_remesh_values``; then each timed in turns with its
    float32 instance (CUDA events) beside its plain version and its bound.
    (d) The graphed flagship and default steps, float64 against float32 in
    turns; the double gather under each shared-memory budget
    (``f64_budget_sweep``); the card against the CPU
    (``f64_card_vs_cpu``).  (e) Float64 under every wind
    (``phase_float64_winds``), whose traced libraries build from the
    phase's start beside (a)-(d)."""
    t_phase = time.perf_counter()
    traced = f64_traced_kernels(dev, f64_traced_callables())
    pool = ThreadPoolExecutor(1)
    build = pool.submit(f64_traced_build, *traced)
    err = f64_kernel_checks(dev, 256)
    n = FLAG_N
    models = f64_main_models(n, dev)
    for name, m in models.items():
        cfg = m.resolved_config()
        assert (cfg.advance_mode, cfg.scatter_mode) == ("cuda",
                                                        "dense_cuda"), cfg
        assert m.graphed and m.config.dtype == F64, name
    reset_counters()
    reset_f64_counters()
    states = {}
    for name, m in models.items():
        s = m.init_state()
        for _ in range(F64_STEPS):
            s = m.step(s)
            check_state(f"float64 {name}", s, n_failed=0, n_clamped=0)
        assert s.state.dtype == F64
        states[name] = s
    c, c32 = f64_counters(), all_counters()
    assert not any(c32.values()), f"float32 instances launched: {c32}"
    for k in ("K1", "K2", "K3", "K5", "K6"):
        want = F64_STEPS * sum(k in ks for ks in F64_STEP_KERNELS.values())
        assert c[f"{k} f64"] == want, (k, c)
        results[f"{k} f64"]["launches"] += c[f"{k} f64"]
    log("float64", f"main path, {F64_STEPS} eager steps of each model at "
                   f"{n}^2: launches {c}")
    graphs = {}
    for name, m in models.items():
        g = m.step_n_quiet(m.init_state(), F64_STEPS)
        assert_state_bitwise(f"float64 {name} graphed vs eager", g,
                             states[name])
        want = {KERNEL_KEYS[f"{k} f64"]: 2 for k in F64_STEP_KERNELS[name]}
        reset_counters()
        reset_f64_counters()
        stats, got = trace_window(lambda: m.step_n_quiet(g, 2), 2, want)
        assert not any(f64_counters().values()), "the host launched kernels"
        for k in F64_STEP_KERNELS[name]:
            r = results[f"{k} f64"]
            r["graph_launches"] = r.get("graph_launches", 0) + 2
            r["launches"] += 2
        graphs[name] = dict(idle_share=stats["idle_share"],
                            device_ops_per_step=stats["device_ops_per_step"])
    log("float64", f"graphed steps bit for bit the eager ones; replays by "
                   f"trace {graphs}")

    # (c) each double instance on the main path's states
    consts, flags = f64_consts(), TermFlags()
    flag, default = models["flagship fused"], models["default"]
    sf, sd = states["flagship fused"], states["default"]
    P, Q = sf.particles, sd.particles
    adv_f = P.on & flag.active_mask
    adv_d = Q.on & default.active_mask
    cf = (P.lne, P.cgx, P.cgy, P.px, P.py)
    cd = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    gf, gd = flag.grid, default.grid
    e_fix, _, _ = f64_k1_check(
        f"K1 f64 flagship {n}^2 state fixed", flag.winds, consts, flags,
        dataclasses.replace(flag.solver, adaptive=False), cf, P.t,
        torch.full_like(P.dt, 37.5), adv_f, gf, flag.uniform_proj)
    _, kf, pf = f64_k1_check(
        f"K1 f64 flagship {n}^2 state adaptive", flag.winds, consts, flags,
        flag.solver, cf, P.t, P.dt, adv_f, gf, flag.uniform_proj)
    e_fix_d, _, _ = f64_k1_check(
        f"K1 f64 default {n}^2 state fixed", default.winds, consts, flags,
        dataclasses.replace(default.solver, adaptive=False), cd, Q.t,
        torch.full_like(Q.dt, 37.5), adv_d, gd, default.uniform_proj)
    _, kd, pd = f64_k1_check(
        f"K1 f64 default {n}^2 state adaptive", default.winds, consts, flags,
        default.solver, cd, Q.t, Q.dt, adv_d, gd, default.uniform_proj)
    err["K1"] = max(err["K1"], e_fix, e_fix_d)
    reset = half_reset_mask((n, n), dev, seed=17)
    err["K3"] = max(err["K3"], f64_k3_check(
        f"K3 f64 default {n}^2 state", default.winds, consts, flags, cd,
        Q.t, Q.dt, reset, gd, default.uniform_proj))
    halo_f = flag.config.halo
    chf = TR.particle_to_node(kf.lne, kf.cgx, kf.cgy)
    chd = TR.particle_to_node(kd.lne, kd.cgx, kd.cgy)
    err["K2"] = max(err["K2"], f64_k2_check(
        f"K2 f64 flagship {n}^2 halo {halo_f}", kf.x, kf.y, chf, adv_f,
        gf.stats, halo_f), f64_k2_check(
        f"K2 f64 default {n}^2 halo 3", kd.x, kd.y, chd, adv_d, gd.stats, 3))
    err["K4"] = max(err["K4"], f64_k4_check(
        f"K4 f64 flagship {n}^2", kf.x, kf.y, chf, adv_f, halo_f))
    node, _ = pic_gather(kf.x, kf.y, chf, adv_f, gf.stats, halo_f)
    core = (kf.lne, kf.cgx, kf.cgy, kf.x, kf.y, kf.dt, P.on,
            flag.active_mask, flag.boundary_mask, gf.x, gf.y, sf.time)
    e5, e6 = f64_k5_k6_check(f"f64 flagship {n}^2 state", flag, node, core,
                             halo=halo_f)
    err["K5"], err["K6"] = max(err["K5"], e5), max(err["K6"], e6)
    for k, e in err.items():
        results[f"{k} f64"]["max_abs_err"] = e

    # timing: each double instance in turns with its float32 instance on
    # the same values cast to float32
    f32 = {name: m for name, m in zip(
        ("flagship fused", "default"),
        (flagship_model(n, dev, remesh_mode="fused"), default_model(n, dev)))}
    flag32, def32 = f32["flagship fused"], f32["default"]

    def down(xs):
        return tuple(x.float().contiguous() if x.is_floating_point() else x
                     for x in xs)

    cf32, cd32 = down(cf), down(cd)
    Pt32, Pdt32, Qt32, Qdt32 = down((P.t, P.dt, Q.t, Q.dt))
    f64_row(results, "K1",
            lambda: advance_cuda(flag32.winds, flag32.consts, flags,
                                 flag32.solver, DT, cf32, Pt32, Pdt32, adv_f,
                                 flag32.grid.x, flag32.grid.y,
                                 flag32.uniform_proj),
            lambda: advance_cuda(flag.winds, consts, flags, flag.solver, DT,
                                 cf, P.t, P.dt, adv_f, gf.x, gf.y,
                                 flag.uniform_proj),
            lambda: integrate_to(flag.rhs, torch.stack(cf, dim=-1), P.t,
                                 P.t + DT, P.dt, flag.aux, adv_f,
                                 flag.solver),
            k1_bound(n * n, flag.solver.method, True, adv_f,
                     pf.naccept + pf.nreject, real=8))
    results["K1 f64"]["default_state"] = dict(zip(
        ("f32_ms", "ms"), f64_turns(
            lambda: advance_cuda(def32.winds, def32.consts, flags,
                                 def32.solver, DT, cd32, Qt32, Qdt32, adv_d,
                                 def32.grid.x, def32.grid.y,
                                 def32.uniform_proj),
            lambda: advance_cuda(default.winds, consts, flags,
                                 default.solver, DT, cd, Q.t, Q.dt, adv_d,
                                 gd.x, gd.y, default.uniform_proj), 5)))
    results["K1 f64"]["default_state"].update(k1_bound(
        n * n, default.solver.method, True, adv_d, pd.naccept + pd.nreject,
        real=8), plain_ms=cuda_time_ms(
            lambda: integrate_to(default.rhs, torch.stack(cd, dim=-1), Q.t,
                                 Q.t + DT, Q.dt, default.aux, adv_d,
                                 default.solver), 1))
    log("kernel-time", f"K1 f64 default state: "
                       f"{results['K1 f64']['default_state']}")
    chd32 = down(chd)
    kdx32, kdy32 = down((kd.x, kd.y))
    f64_row(results, "K2",
            lambda: pic_gather(kdx32, kdy32, chd32, adv_d, gd.stats, 3),
            lambda: pic_gather(kd.x, kd.y, chd, adv_d, gd.stats, 3),
            lambda: scatter_dense(kd.x, kd.y, torch.stack(chd, dim=-1),
                                  adv_d, gd.stats, 3),
            deposit_bound(n * n, n * n, 3, real=8), reps=20, plain_reps=3)
    f64_row(results, "K3",
            lambda: auto_dt_cuda(def32.winds, def32.consts, flags, Qt32,
                                 cd32, def32.grid.x, def32.grid.y,
                                 def32.uniform_proj, reset, Qdt32, 1e-4, DT),
            lambda: auto_dt_cuda(default.winds, consts, flags, Q.t, cd,
                                 gd.x, gd.y, default.uniform_proj, reset,
                                 Q.dt, 1e-4, DT),
            lambda: auto_dt_reset(default.rhs, Q.t, torch.stack(cd, dim=-1),
                                  default.aux, reset, Q.dt, 1e-4, DT),
            k3_bound(reset, kernel_wind(default.winds), real=8), reps=20,
            plain_reps=3)
    chf32 = down(chf)
    kfx32, kfy32 = down((kf.x, kf.y))
    (xl, xh), (yl, yh) = normalize_halo(halo_f)
    f64_row(results, "K4",
            lambda: pic_gather_padded(kfx32, kfy32, chf32, adv_f, halo_f),
            lambda: pic_gather_padded(kf.x, kf.y, chf, adv_f, halo_f),
            lambda: scatter_accumulate_padded(kf.x, kf.y,
                                              torch.stack(chf, dim=-1), adv_f,
                                              halo_f),
            deposit_bound(n * n, (n + xl + xh) * (n + yl + yh), halo_f,
                          real=8), reps=20, plain_reps=3)
    node32 = down(node)
    core32 = down(core[:6]) + core[6:9] + down(core[9:])
    k5 = remesh_cuda(flag.remesh_params, node, *core)
    f64_row(results, "K5",
            lambda: remesh_cuda(flag32.remesh_params, node32, *core32),
            lambda: remesh_cuda(flag.remesh_params, node, *core),
            lambda: remesh_core(flag.remesh_params, node, *core),
            remesh_bound(n * n, branch=k5.branch, real=8), reps=20,
            plain_reps=3)
    sact = (P.on & flag.active_mask).contiguous()

    def k6(m, c, ch, cr):
        return pic_gather_remesh(c[3], c[4], ch, sact, m.grid.stats, halo_f,
                                 m.remesh_params, *cr)

    def k6_plain():
        S, _ = scatter_dense(kf.x, kf.y, torch.stack(chf, dim=-1), sact,
                             gf.stats, halo_f)
        return remesh_core(flag.remesh_params,
                           tuple(S[..., i] for i in range(3)), *core)

    f64_row(results, "K6", lambda: k6(flag32, core32, chf32, core32),
            lambda: k6(flag, core, chf, core), k6_plain,
            deposit_bound(n * n, n * n, halo_f, remesh=True,
                          branch=k5.branch, real=8), reps=20, plain_reps=3)

    # (d) the graphed steps, float64 against float32 in turns
    steps = {}
    for name in ("flagship fused", "default"):
        m64, m32 = models[name], f32[name]
        s64, s32 = states[name], m32.step_n_quiet(m32.init_state(), 3)
        runs = {"float32": [], "float64": []}
        for rep in range(4):
            for who in (("float32", "float64") if rep % 2 == 0
                        else ("float64", "float32")):
                if who == "float64":
                    s64, t = time_steps(m64, s64, 10)
                else:
                    s32, t = time_steps(m32, s32, 10)
                runs[who].append(t)
        check_state(f"float64 {name} timed", s64, n_failed=0, n_clamped=0)
        steps[name] = {k: float(np.median(v)) for k, v in runs.items()}
        steps[name]["turns"] = runs
        m32.release_graph()
        log("float64", f"{name} {n}^2 graphed: float64 "
                       f"{steps[name]['float64']:.4f} ms/step, float32 "
                       f"{steps[name]['float32']:.4f} (medians of 4 x 10 "
                       f"steps in turns, CUDA events)")
    for m in models.values():
        m.release_graph()
    del f32, flag32, def32
    torch.cuda.empty_cache()
    timing["float64_gather_budget"] = f64_budget_sweep(
        kd.x, kd.y, chd, adv_d, gd.stats, (((0, 3), (0, 3)), 3))
    timing["float64_graphed_ms_per_step"] = steps
    timing["float64_replays"] = graphs
    timing["float64_card_vs_cpu"] = f64_card_vs_cpu(dev)
    phase_float64_winds(dev, traced, build, results, timing)
    pool.shutdown()
    timing["float64_phase_seconds"] = time.perf_counter() - t_phase
    log("float64", f"done in {timing['float64_phase_seconds']:.1f} s")


def phase_float64_child(path: str) -> None:
    """``phase_float64`` in a process of its own (the script with
    ``--float64-child``, ``phase_float64_process``): its profiler sessions
    (the replays' traces, the deposit rows' kernel times) then add to no
    count of the main process's, where late in a process a trace loses
    launches.  Writes the double instances' rows, the timing and any short
    traces to ``path``."""
    dev = torch.device("cuda", 0)
    results = {key: dict(launches=0) for key in (
        *(f"{k} f64" for k in F64_REPLACES), *F64_TRACED_REPLACES)}
    timing = {}
    phase_float64(dev, results, timing)
    with open(path, "w") as f:
        json.dump(dict(results=results, timing=timing,
                       short_traces=SHORT_TRACES), f)


def phase_float64_process(results, timing) -> None:
    """``phase_float64_child`` in a process of its own, started after the
    build and waited for; its rows (launches added) and timing merged into
    ``results`` and ``timing``.  Raises if the process fails."""
    sys.stdout.flush()
    sys.stderr.flush()
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)   # git-ignored
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "float64.json")
        code = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--float64-child", path]).returncode
        if code != 0:
            raise RuntimeError(f"the float64 phase's process exited with "
                               f"{code}")
        with open(path) as f:
            out = json.load(f)
    for key, row in out["results"].items():
        results[key]["launches"] += row.pop("launches")
        results[key].update(row)
    timing.update(out["timing"])
    for key, short in out["short_traces"].items():
        SHORT_TRACES.setdefault(key, []).extend(short)


def phase_sharded_f64(dev, results) -> None:
    """The float64 "pallas" flagship through ``ShardedWaveGrowth2D`` on the
    (1, 1) NCCL mesh (inside phase "sharded-1x1"'s process group): K1, K4
    (the padded deposit's double instance) and K5, 3 eager steps, the
    counters set to 0 just before and read just after, against the float64
    single-device step at ``assert_states``' bound; the graphed sharded
    step bit for bit its eager steps.  Then the float64 pulse likewise
    (the traced kind's double instances of K1 and K5, which the sharded
    step takes with no code of its own)."""
    n = FLAG_N
    model = flagship_model(n, dev, dtype=F64, remesh_mode="pallas")
    ref = eager_steps(model, model.init_state(), 3)
    sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
    assert sh.graphed
    reset_counters()
    reset_f64_counters()
    ms = eager_steps(sh, sh.init_state(), 3)
    c, c32 = f64_counters(), all_counters()
    assert not any(c32.values()), c32
    assert c["K1 f64"] == c["K4 f64"] == c["K5 f64"] == 3, c
    assert c["K2 f64"] == c["K6 f64"] == c["K3 f64"] == 0, c
    for k in ("K1", "K4", "K5"):
        results[f"{k} f64"]["launches"] += c[f"{k} f64"]
    err = assert_states("sharded 1x1 float64 vs single device, 3 steps", ms,
                        ref)
    g = sh.step_n_quiet(sh.init_state(), 3)
    assert_state_bitwise("sharded 1x1 float64 graphed vs eager", g, ms)
    check_state("sharded 1x1 float64", ms, n_failed=0, n_clamped=0)
    sh.release_graph()
    model.release_graph()
    log("sharded-1x1", f"float64: 3 eager steps (K1 {c['K1 f64']}, K4 "
                       f"{c['K4 f64']}, K5 {c['K5 f64']} launches) vs the "
                       f"single device max abs err {err:.3e}; the graphed "
                       f"step bit for bit")
    # the float64 pulse (the traced kind's double instances): K1 traced f64
    # -> K4 f64 -> the fold -> K5 traced f64
    model = flagship_model(n, dev, winds=pulse_winds(), remesh_mode="pallas",
                           dtype=F64)
    assert model.winds.kernel.traced.dtype == F64
    ref = eager_steps(model, model.init_state(), 3)
    sh = ShardedWaveGrowth2D(model, make_mesh((1, 1)))
    assert sh.graphed
    reset_counters()
    reset_f64_counters()
    ms = eager_steps(sh, sh.init_state(), 3)
    c = f64_counters()
    assert not any(all_counters().values())
    assert c["K1 traced f64"] == c["K4 f64"] == c["K5 traced f64"] == 3, c
    for k in ("K1 traced f64", "K4 f64", "K5 traced f64"):
        results[k]["launches"] += c[k]
    err = assert_states("sharded 1x1 float64 pulse vs single device, 3 "
                        "steps", ms, ref)
    assert_state_bitwise("sharded 1x1 float64 pulse graphed vs eager",
                         sh.step_n_quiet(sh.init_state(), 3), ms)
    check_state("sharded 1x1 float64 pulse", ms, n_failed=0, n_clamped=0)
    sh.release_graph()
    model.release_graph()
    log("sharded-1x1", f"float64 pulse: 3 eager steps (K1 traced f64 "
                       f"{c['K1 traced f64']}, K4 {c['K4 f64']}, K5 traced "
                       f"f64 {c['K5 traced f64']} launches) vs the single "
                       f"device max abs err {err:.3e}; the graphed step bit "
                       f"for bit")


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
    ap.add_argument("--profile-child", metavar="JSON",
                    help=argparse.SUPPRESS)   # phase_profile's process
    ap.add_argument("--trace-1d-child", metavar="JSON",
                    help=argparse.SUPPRESS)   # phase_1d_traces' process
    ap.add_argument("--float64-child", metavar="JSON",
                    help=argparse.SUPPRESS)   # phase_float64's process
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
    if args.profile_child:
        phase_profile(args.profile_child, gridded_record(
            torch.device("cuda", 0)))
        return 0
    if args.trace_1d_child:
        phase_1d_traces(args.trace_1d_child)
        return 0
    if args.float64_child:
        phase_float64_child(args.float64_child)
        return 0
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
        # the port's own kernel: the JAX package's 1D advance is a
        # lax.while_loop outside Pallas
        "K7": dict(name="advance_1d", route="cuda",
                   source="picles_torch/csrc/advance_1d.cu",
                   replaces="the port's own; no pl.pallas_call "
                            "(picles_tpu/ops/tsit5.py:278 lax.while_loop)",
                   simple_ms=None, launches=0),
    }
    # K7's traced kind: a 1D callable that reads its time, compiled into a
    # library of its own
    results["K7 traced"] = dict(results["K7"], name="advance_1d_traced",
                                replaces="the port's own; no pl.pallas_call "
                                         "(picles_tpu/ops/tsit5.py:217 "
                                         "lax.while_loop, u(x, t) read at "
                                         "each stage time)")
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
    # the node kind: a steady callable's two node planes in K1, K3, K5, K6
    for key, rep in NODE_REPLACES.items():
        k = key.split()[0]
        results[key] = dict(results[k], name=results[k]["name"] + "_node",
                            replaces=rep, simple_ms=None, launches=0)
    # the traced kind: a callable that reads its time, compiled into a
    # library of its own
    for key, rep in TRACED_REPLACES.items():
        k = key.split()[0]
        results[key] = dict(results[k], name=results[k]["name"] + "_traced",
                            replaces=rep, simple_ms=None, launches=0)
    # the layered launches: the same kernels over a layer dimension
    for k in LAYER_KERNELS:
        results[f"{k} layered"] = dict(
            results[k], name=results[k]["name"] + "_layered", simple_ms=None,
            launches=0)
    # K1 and K6 with their epilogues: the step's glue between them (the
    # fused path)
    for key, rep in EPILOGUE_REPLACES.items():
        k = key.split()[0]
        results[key] = dict(results[k], name=results[k]["name"] +
                            "_epilogue", replaces=rep, simple_ms=None,
                            launches=0)
    # the double instances: the same templates in float64, a library of
    # their own
    for k, rep in F64_REPLACES.items():
        results[f"{k} f64"] = dict(results[k], name=results[k]["name"] +
                                   "_f64", replaces=rep, simple_ms=None,
                                   launches=0)
    # the traced kind's double instances: a float64 callable's library
    for key, rep in F64_TRACED_REPLACES.items():
        k = key.split()[0]
        results[key] = dict(results[k], name=results[k]["name"] +
                            "_traced_f64", replaces=rep, simple_ms=None,
                            launches=0)
    timing = {}
    traces_1d = phase_1d_traces_process()
    phase_float64_process(results, timing)
    if args.profile:
        phase_profile_process(args.profile)
    phase_k1(dev, results)
    phase_k3(dev, results)
    phase_k2(dev, results)
    phase_k5_k6(dev, results)
    phase_gridded_kernels(dev, results)
    phase_proj(dev, results)
    phase_seam(dev, results)
    phase_wide_grid(dev, results)
    phase_layer_kernels(dev, results)
    # early: its step traces count device ops, which late traces lose
    phase_epilogue(dev, results, timing)
    flag, s_flag, default, s_def = phase_main_path(dev, results, timing)
    phase_k3_times(default, s_def, results)
    gw = gridded_record(dev)
    # right after its capture, each graph's trace: late in a process a
    # trace can miss launches
    phase_graphs(dev, gw, results, timing)
    layered = phase_layers(dev, gw, results, timing)
    phase_rest(dev, results, timing)
    phase_remesh_backends(dev, results, timing)
    phase_production(dev, results, timing)
    phase_cli(dev, results, timing)
    gridded = phase_gridded_main_path(dev, gw, results, timing)
    tripolar = phase_tripolar_main(dev, results, timing)
    phase_node_winds(dev, results)
    jet = phase_global_jet(dev, results, timing)
    phase_traced_winds(dev, results, timing)
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
    node_kernel_times(*jet, results, timing)
    del jet
    layered_kernel_times(layered, results, timing)
    del layered
    phase_twin_timing(timing, 20)
    del flag, s_flag, default, s_def
    phase_sharded_1x1(dev, gw, results, timing)
    phase_sharded_2x2(timing)
    phase_examples(timing)
    phase_1d(dev, results, timing, traces_1d)

    kernels = [dict(results[k], library_ms=None,
                    short_traces=SHORT_TRACES.get(k, []))
               for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K1 gridded",
                         "K3 gridded", "K5 gridded", "K6 gridded",
                         *PROJ_REPLACES,
                         *(f"{k} layered" for k in LAYER_KERNELS),
                         *NODE_REPLACES, "K7", *TRACED_REPLACES,
                         "K7 traced", *(f"{k} f64" for k in F64_REPLACES),
                         *F64_TRACED_REPLACES, *EPILOGUE_REPLACES)]
    assert len(kernels) == 44
    for k in kernels:
        assert all(f in k for f in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "simple_ms")), k
        k.setdefault("graph_launches", 0)
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
