"""WaveGrowth2D: one model step on tensors (PyTorch port of
``picles_tpu/models/wave_growth_2d.py``).

One model step ``DT``:

  1. ADVANCE every active particle over DT (adaptive embedded RK), then the
     guards: off-particle wind re-light, NaN/Inf windsea resets,
     log-energy clamp;
  2. DEPOSIT (E, m_x, m_y) by CIC onto the nodes, with the boundary fold;
  3. REMESH: per-node gather / reseed / off, then the dt reset;
  4. tick the clock.

Where a step runs K1 and then K6 on a card (``fused_glue``: the fused
remesh under a wind other than gridded) it is those two launches and the
clock's tick: the glue between them (the guards of 1., the deposit's mask
and channels, the counters) runs in the two kernels' epilogues
(``_step_fused``).  Every other path runs that glue in PyTorch
(``_step_glue``), the pure-PyTorch twin of the JAX step.

Kernels: the advance runs kernel K1 (``ops/advance_cuda.py``) or its plain
version ``tsit5.integrate_to``; the deposit kernel K2 (``ops/pic_cuda.py``)
or ``pic.scatter_dense``; the Hairer dt reset (``dt_reset_mode="auto"``)
kernel K3, which clamps and selects the estimate too, or its plain version
``advance_cuda.auto_dt_reset``.  The remesh is ``remesh.remesh_core`` in
PyTorch (``remesh_mode="xla"``), kernel K5 (``"pallas"``,
``ops/remesh_cuda.py``) or kernel K6, the deposit and the remesh in one pass
(``"fused"``, ``ops/pic_cuda.py``); on CPU tensors the two kernel modes run
the plain versions, as the JAX package runs its kernels in interpret mode.
Every quantity stays on the grid's device and the step never reads it back
or copies a host value to it, so a step on the card queues without host
round-trips, and the drivers capture it in a CUDA graph
(``models/drivers.py``; ``graphed``).

On spherical and tripolar grids the projection and the great-circle
coefficient vary from node to node: the model stacks them once per grid
into the kernels' planes (``projection``), and on a tripolar grid the
deposit kernels fold the north seam themselves.

A ``Winds2D`` without a kernel descriptor (a callable written as the JAX
examples write it) runs on the kernels too.  Where the model runs a kernel,
it tries at construction, in order: the steady probe, which calls ``u``
and ``v`` once under a probe of their time
(``forcing.winds.steady_node_planes``): a steady callable becomes the node
kind, whose two node planes (u, v) are formed once per grid
(``wind_fields``) and handed to K1, K3 and K5/K6; else the tracer
(``forcing/wind_trace.py``): a callable that reads its time becomes the
traced kind, compiled into a library of the kernels' traced instances at
its first launch, which read the node x and y and evaluate it at every
stage time.  A callable the tracer cannot lower raises, naming the
operation (``advance_mode="torch"`` runs it).  Every plain path (seeding,
the re-light, the PyTorch remesh and advance) goes on calling the callable.

Gridded winds (a ``GriddedWinds2D``, or its ``as_winds()``) move to the
grid's device.  The kernels take them as the exact piecewise-linear-in-t
planes of each step window (``GriddedWinds2D.pallas_pwl_fields``), formed
once per step on the device from the grid ``step_core`` is given and the
clock, and handed to K1, K3 and K5/K6; every plain path (seeding, the
re-light, the PyTorch remesh and advance) samples the interpolant, as the
JAX model does.

The model's dtype (``config.dtype``, float32 or float64) is that of every
particle and node plane, of the seeding and of the remesh's windsea
(``core/fetch_relations.py`` computes in it, as the JAX package does with
x64 on), and picks the kernels' instances: each of K1-K6 has a float64
instance (the same CUDA template, ``csrc/rhs.cuh``), which reads the grid's
planes (node x and y, projection) in float64, so a float64 model on the
kernels takes a float64 grid, as JAX builds it under x64.  The winds take
the model's dtype as JAX's kernels cast them to the lanes' dtype: a steady
callable's node planes hold its values cast to float64 (its float64
arithmetic kept), a callable that reads its time is traced on float64
placeholders into a double function and a library of its own (the traced
kind's double instances of K1, K3, K5 and K6), and a gridded record's
planes stay the record's float32, widened in the kernels.

``step_core`` takes the grid planes and masks it steps over, a deposit hook
and a counter-reduction hook, so ``parallel/sharded.py`` runs the same step
on one block of a decomposed grid.

Layers (``config.layers``, the reference's fourth State dimension: several
wave systems, swell partitions beside the wind sea, each a full particle
system on one grid with one clock) put a leading ``[L]`` axis on the node
state, the particle planes and the counters (``init_state_layers``,
``step_layers``).  The same ``step_core`` steps them: the grid planes, the
masks and a gridded wind's planes stay ``[nx, ny]`` and broadcast, each
kernel launches once for every layer (its layer dimension), and the
counters reduce over each layer's plane.  ``LayeredWaveGrowth2D``
(``as_layered``) is the driver-facing view, also with one wind a layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ODESettings
from ..forcing.winds import (GriddedWinds2D, WindKind, Winds2D,
                             gridded_kernel, node_kernel, steady_node_planes,
                             traced_kernel)
from ..grids.base import Boundary, Grid2D
from ..ops import pic
from ..ops import transforms as TR
from ..ops.advance_cuda import (N_COUNTERS, Guards, advance_cuda,
                                auto_dt_cuda, auto_dt_reset, kernel_library,
                                node_projection, uniform_projection)
from ..ops.pic_cuda import pic_gather_remesh
from ..ops.remesh import (GATHER_BIT, OFF_BIT, RESEED_BIT, RemeshParams,
                          remesh_core, seed_values, winds_at)
from ..ops.remesh_cuda import remesh_cuda
from ..ops.rhs import RHSParams, TermFlags, make_rhs_consts, particle_equations
from ..ops.tsit5 import METHODS, SolverConfig, integrate_to
from .drivers import StepDrivers
from .state import ModelState2D, Particles2D, StepMetrics

SQRT2 = math.sqrt(2.0)

ADVANCE_MODES = ("auto", "torch", "cuda")
# the dtypes a model computes in, each with kernel instances of its own
KERNEL_DTYPES = (torch.float32, torch.float64)
# the modes that run no kernel (a float64 model on a float32 grid needs them)
PLAIN_MODES = ('advance_mode="torch", scatter_mode="dense" and '
               'remesh_mode="xla"')
SCATTER_MODES = ("auto", "dense", "dense_cuda", "xla")
REMESH_MODES = ("xla", "pallas", "fused")


@dataclasses.dataclass(frozen=True)
class ParticleDefaults2D:
    """Fixed particle initial state."""

    lne: float
    cg_x: float
    cg_y: float
    x: float = 0.0
    y: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveGrowth2DConfig:
    """Static model configuration.

    ``advance_mode``: "auto" | "torch" | "cuda"; ``scatter_mode``: "auto" |
    "dense" | "dense_cuda" | "xla".  "auto" resolves on the device of the
    grid's tensors: the CUDA kernels for CUDA tensors, the plain PyTorch
    versions for CPU tensors.  An explicit mode always wins, and a CUDA mode
    on CPU tensors raises.  ``dt_reset_mode``: "auto" (Hairer estimate on
    every reset lane) or "carry" (keep the adapted dt).  ``remesh_mode``:
    "xla" (PyTorch), "pallas" (kernel K5) or "fused" (kernel K6, the
    remesh inside the gather deposit; needs ``scatter_mode`` "auto" or
    "dense_cuda"); both kernel modes need ``dt_reset_mode="carry"`` and run
    their plain versions on CPU tensors.  ``halo``: CIC displacement
    capacity, an int or ((x_lo, x_hi), (y_lo, y_hi)).
    """

    periodic_boundary: bool = True
    ode_init_type: Union[str, ParticleDefaults2D] = "wind_sea"
    boundary_type: str = "same"   # "wind_sea" | "mininmal" | "same"
    scatter_mode: str = "auto"
    advance_mode: str = "auto"
    dt_reset_mode: str = "auto"
    remesh_mode: str = "xla"
    halo: Union[int, Tuple[Tuple[int, int], Tuple[int, int]]] = 3
    layers: int = 1
    dtype: torch.dtype = torch.float32


def resolve_modes(cfg: WaveGrowth2DConfig, device: torch.device
                  ) -> WaveGrowth2DConfig:
    """``cfg`` with "auto" kernel modes resolved for tensors on ``device``,
    checked.  The remesh modes keep their names: on a CUDA device "pallas"
    and "fused" run kernels K5 and K6, on the CPU their plain versions.
    The kernels have float32 and float64 instances: ``cfg.dtype`` float64
    resolves as float32 does, to its float64 instances."""
    on_cuda = torch.device(device).type == "cuda"
    if cfg.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype must be one of {KERNEL_DTYPES}, got "
                         f"{cfg.dtype}")
    if cfg.advance_mode not in ADVANCE_MODES:
        raise ValueError(f"advance_mode must be one of {ADVANCE_MODES}, got "
                         f"{cfg.advance_mode!r}")
    if cfg.scatter_mode not in SCATTER_MODES:
        raise ValueError(f"scatter_mode must be one of {SCATTER_MODES}, got "
                         f"{cfg.scatter_mode!r}")
    if cfg.remesh_mode not in REMESH_MODES:
        raise ValueError(f"remesh_mode must be one of {REMESH_MODES}, got "
                         f"{cfg.remesh_mode!r}")
    if cfg.remesh_mode != "xla" and cfg.dt_reset_mode != "carry":
        raise ValueError(f'remesh_mode="{cfg.remesh_mode}" requires '
                         'dt_reset_mode="carry"')
    if cfg.remesh_mode == "fused" and cfg.scatter_mode not in ("auto",
                                                               "dense_cuda"):
        raise ValueError(
            'remesh_mode="fused" IS the gather deposit (the remesh runs '
            'inside kernel K6); set scatter_mode="auto" or "dense_cuda", '
            f"not {cfg.scatter_mode!r}")
    upd = {}
    if cfg.advance_mode == "auto":
        upd["advance_mode"] = "cuda" if on_cuda else "torch"
    if cfg.scatter_mode == "auto":
        upd["scatter_mode"] = "dense_cuda" if on_cuda else "dense"
    out = dataclasses.replace(cfg, **upd) if upd else cfg
    if not on_cuda and (out.advance_mode == "cuda"
                        or out.scatter_mode == "dense_cuda"):
        raise ValueError(
            f"advance_mode={out.advance_mode!r} / scatter_mode="
            f"{out.scatter_mode!r} name a CUDA kernel, but the grid's "
            f"tensors are on {device}")
    return out


class GluedAdvance(NamedTuple):
    """The advance and the step's guards in PyTorch (``_advance_glue``):
    the lanes as the deposit takes them, the deposit's mask and channels
    (e, m_x, m_y), and the masks the counters sum."""

    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor            # on | relight
    scatter_on: torch.Tensor
    chans: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    adv: torch.Tensor           # on & active: the lanes advanced
    failed: torch.Tensor
    nan_mask: torch.Tensor
    inf_mask: torch.Tensor
    emax_mask: torch.Tensor
    relight: torch.Tensor
    was_reset: torch.Tensor     # relight | nan | inf | emax
    naccept: torch.Tensor


class WaveGrowth2D(StepDrivers):
    """Model: grid, winds, ODE settings and config; exposes ``init_state``
    and ``step``.  The device is the grid's.  ``winds``: a ``Winds2D`` or a
    ``GriddedWinds2D`` (directly or as its ``as_winds()``).  ``rhs``: a
    right-hand side ``rhs(t, z, aux)`` in place of the one the winds and
    term flags give (``ops/rhs.py`` ``particle_equations``); it runs on the
    plain advance only (``advance_mode="torch"``), as K1 compiles its
    right-hand side from the wind's descriptor and the flags."""

    def __init__(self, grid: Grid2D, winds,
                 ode_settings: ODESettings,
                 ode_params: Optional[ODEParameters] = None,
                 constants: Optional[IDConstants] = None,
                 flags: TermFlags = TermFlags(),
                 minimal_particle=None, minimal_state=None,
                 config: WaveGrowth2DConfig = WaveGrowth2DConfig(),
                 rhs: Optional[Callable] = None):
        if config.layers < 1:
            raise ValueError(f"layers must be at least 1, got {config.layers}")
        if config.dt_reset_mode not in ("auto", "carry"):
            raise ValueError(f"unknown dt_reset_mode {config.dt_reset_mode!r}")
        self.grid = grid
        self.device = grid.device
        # a gridded record, passed directly or as the bound samplers of its
        # as_winds(), moves to the grid's device; the kernels read it as B
        # breakpoints' planes (B from the record's cadence and DT)
        gw = winds if isinstance(winds, GriddedWinds2D) else getattr(
            getattr(winds, "u", None), "__self__", None)
        self.gridded_winds: Optional[GriddedWinds2D] = None
        self._wind_B = 0
        self._corners = None   # (grid, its corners), for wind_fields
        self._proj_planes = None   # (grid, its planes), for projection
        self._node_planes = None   # (grid, its wind planes), node kind
        if isinstance(gw, GriddedWinds2D):
            gw = gw.to(self.device)
            self.gridded_winds = gw
            self._wind_B = gw.n_breakpoints(ode_settings.timestep)
            winds = Winds2D(u=gw.u, v=gw.v,
                            kernel=gridded_kernel(self._wind_B))
        self.winds = winds
        self.settings = ode_settings
        self.config = config
        self._rhs_override = rhs is not None
        if self._rhs_override and (config.advance_mode == "cuda" or (
                config.advance_mode == "auto" and self.device.type == "cuda")):
            raise ValueError(
                "a custom `rhs` runs on the plain advance only: kernel K1 "
                "compiles its right-hand side from the wind's descriptor and "
                'the TermFlags; pass advance_mode="torch"')
        self.modes = resolve_modes(config, self.device)
        if ode_params is None:
            ode_params, constants, _ = ODEParameters.create()
        self.params = ode_params
        self.constants = constants or IDConstants.create(r_g=ode_params.r_g)
        self.flags = flags
        self.consts = make_rhs_consts(gamma=self.constants.gamma,
                                      constants=self.constants,
                                      params=self.params)
        self.rhs = rhs if rhs is not None else particle_equations(
            winds.u, winds.v, gamma=self.constants.gamma, params=self.params,
            constants=self.constants, flags=flags)

        DT = ode_settings.timestep
        dtype = config.dtype
        # the step's DT in the model's dtype, as a host float
        self._DT = float(torch.tensor(DT, dtype=dtype))
        # the minimal windsea of a (2, 2) m/s wind in the model's dtype, as
        # host floats: the remesh compares against them every step
        if minimal_particle is None:
            minimal_particle = FR.MinimalParticle(2.0, 2.0, DT, dtype=dtype)
        if minimal_state is None:
            minimal_state = FR.MinimalState(2.0, 2.0, DT, dtype=dtype)
        self.minimal_particle = torch.as_tensor(minimal_particle, dtype=dtype)
        self.minimal_state = torch.as_tensor(minimal_state, dtype=dtype)
        self._minimal_e = float(self.minimal_state[0])
        self._minimal_m2 = float(self.minimal_state[1])

        self.solver = SolverConfig(abstol=ode_settings.abstol,
                                   reltol=ode_settings.reltol,
                                   dtmin=ode_settings.dtmin,
                                   force_dtmin=ode_settings.force_dtmin,
                                   maxiters=ode_settings.maxiters,
                                   method=ode_settings.solver,
                                   adaptive=ode_settings.adaptive)
        self._rk_order = METHODS[ode_settings.solver].order

        if config.periodic_boundary and (grid.stats.bx == Boundary.NONPERIODIC
                                         or grid.stats.by == Boundary.NONPERIODIC):
            import warnings

            warnings.warn(
                "config.periodic_boundary=True on a grid with a "
                "non-periodic axis: the open-edge ring (mask==3) will be "
                "treated as active interior instead of boundary nodes; "
                "pass periodic_boundary=False for mixed-periodicity "
                "domains", stacklevel=2)
        self.active_mask = grid.ocean_point_mask(config.periodic_boundary)
        self.boundary_mask = grid.boundary_point_mask(config.periodic_boundary)
        self.aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
        self.uniform_proj = uniform_projection(grid.proj, grid.pc)

        # kernel or plain version of the remesh modes: the device decides,
        # as it resolves the "auto" modes
        self._remesh_kernels = (self.device.type == "cuda"
                                and config.remesh_mode != "xla")
        # the drivers replay a CUDA graph of the step where every kernel of
        # the advance runs on the card (models/drivers.py)
        self._graphed = (self.device.type == "cuda"
                         and self.modes.advance_mode == "cuda")
        if (self.modes.advance_mode == "cuda" or self._remesh_kernels) \
                and winds.kernel is None:
            # a steady callable runs on the kernels as its node planes, one
            # that reads its time as its traced graph (or raises)
            planes = steady_node_planes(winds, grid.x, grid.y, dtype)
            if planes is not None:
                winds = winds._replace(kernel=node_kernel())
                self._node_planes = (grid, planes)
            else:
                winds = winds._replace(
                    kernel=traced_kernel(winds, grid.x.device, dtype))
            self.winds = winds
        if (self.modes.advance_mode == "cuda" or self._remesh_kernels):
            if grid.x.dtype != dtype:
                raise ValueError(
                    f"the kernels read the grid's planes in the model's "
                    f"dtype {dtype}, but the grid's are {grid.x.dtype}: "
                    f"build the grid with dtype={dtype} (as JAX builds it "
                    f"under its x64 setting), or pass {PLAIN_MODES}")

        if config.ode_init_type == "mininmal":
            self.defaults: Optional[ParticleDefaults2D] = \
                ParticleDefaults2D(-11.0, 1e-3, 0.0)
        elif isinstance(config.ode_init_type, ParticleDefaults2D):
            self.defaults = config.ode_init_type
        elif config.ode_init_type == "wind_sea":
            self.defaults = None
        else:
            raise ValueError("ode_init_type must be 'wind_sea', 'mininmal' "
                             "or a ParticleDefaults2D")

        # boundary_type: what boundary nodes reseed to.  "same" is the inert
        # boundary; "wind_sea" / "mininmal" are the open-boundary inflow
        # (boundary particles are reseeded every remesh and deposit as-is).
        if config.boundary_type == "wind_sea":
            self.boundary_defaults: Optional[ParticleDefaults2D] = None
            self._boundary_source = True
        elif config.boundary_type == "mininmal":
            bws = FR.MinimalWindsea(1.0, 1.0, 5 * 60.0, dtype=config.dtype)
            self.boundary_defaults = ParticleDefaults2D(
                float(bws.lne), float(bws.cg_bar_x), float(bws.cg_bar_y))
            self._boundary_source = True
        elif config.boundary_type == "same":
            self.boundary_defaults = self.defaults
            self._boundary_source = False
        else:
            raise ValueError("boundary_type must be 'wind_sea', 'mininmal' "
                             "or 'same'")
        self._boundary_differs = (self.boundary_defaults is not self.defaults
                                  and not (self.boundary_defaults is None
                                           and self.defaults is None))

        # every layer reseeds with the model's defaults, whatever it was
        # seeded with (as JAX's vmapped step closes over them)
        self.remesh_params = RemeshParams(
            winds=winds, defaults=triple(self.defaults),
            bdefaults=(triple(self.boundary_defaults)
                       if self._boundary_differs else "same"),
            boundary_source=self._boundary_source,
            timestep=float(ode_settings.timestep),
            minimal_e=self._minimal_e, minimal_m2=self._minimal_m2,
            wind_min_squared=float(ode_settings.wind_min_squared),
            dtmin=float(ode_settings.dtmin),
            # fixed-substep mode carries the configured dt unclipped; the
            # Hairer reset replaces it after the remesh
            clip_dt=(ode_settings.adaptive
                     and config.dt_reset_mode == "carry"))

    def resolved_config(self) -> WaveGrowth2DConfig:
        """``self.config`` with "auto" modes resolved for the grid's device."""
        return self.modes

    def wind_fields(self, grid: Grid2D, clock: torch.Tensor):
        """The kernels' wind planes of the step window starting at
        ``clock`` over ``grid``'s nodes: ``pallas_pwl_fields`` of a gridded
        record (on the device, no read back), a steady callable's node
        planes (``node_planes``), none for analytic winds.  The record's
        spatial corners of the nodes are kept for the last grid seen (the
        model's own, or a sharded step's block)."""
        if self.winds.kernel is not None and \
                self.winds.kernel.kind == WindKind.NODE:
            return self.node_planes(grid).unbind(0)
        gw = self.gridded_winds
        if gw is None:
            return ()
        if self._corners is None or self._corners[0] is not grid:
            self._corners = (grid, gw.corners(grid.x, grid.y))
        return gw.pallas_pwl_fields(grid.x, grid.y, clock,
                                    float(self.settings.timestep),
                                    corners=self._corners[1])

    def graph_keep(self) -> tuple:
        """The per-grid caches a captured step reads (``wind_fields``'
        corners and node planes, ``projection``'s planes): a sharded step
        on another grid replaces them, and the capture keeps its own
        alive; on a card, a traced wind's library too."""
        kern = self.winds.kernel
        lib = (kernel_library(kern, self.config.dtype)[0]
               if self.device.type == "cuda" and kern is not None
               and kern.kind == WindKind.TRACED else None)
        return (self._corners, self._node_planes, self._proj_planes, lib)

    def node_planes(self, grid: Grid2D) -> torch.Tensor:
        """A steady callable's (u, v) at ``grid``'s nodes, one contiguous
        ``[2, nx, ny]`` tensor of the model's dtype, formed once and kept
        for the last grid seen (the model's own, from the construction's
        probe, or a sharded step's block)."""
        if self._node_planes is None or self._node_planes[0] is not grid:
            planes = steady_node_planes(self.winds, grid.x, grid.y,
                                        self.config.dtype)
            if planes is None:
                raise ValueError("the winds read their time t on this grid; "
                                 "they were steady on the model's own")
            self._node_planes = (grid, planes)
        return self._node_planes[1]

    def projection(self, grid: Grid2D):
        """The kernels' projection over ``grid``: the 5 uniform scalars of
        a regular grid, else the grid's per-node planes
        (``node_projection``), formed once and kept for the last grid seen
        (the model's own, or a sharded step's block)."""
        if self.uniform_proj is not None:
            return self.uniform_proj
        if self._proj_planes is None or self._proj_planes[0] is not grid:
            self._proj_planes = (grid, node_projection(grid.proj, grid.pc,
                                                       self.config.dtype))
        return self._proj_planes[1]

    # ------------------------------------------------------------------
    # seeding
    # ------------------------------------------------------------------

    def _reset_values(self, u, v, defaults="model"):
        """The reseed: windsea from local winds when no defaults are set,
        otherwise the fixed defaults; (lne, cgx, cgy) planes.  ``defaults``:
        "model" (the model's own), None (windsea) or a
        ``ParticleDefaults2D``."""
        d = (self.remesh_params.defaults if defaults == "model"
             else triple(defaults))
        return seed_values(d, u, v, self.settings.timestep)

    def init_state(self, defaults="model") -> ModelState2D:
        """Seed one particle per node from the winds at t = 0.
        ``defaults``: "model" seeds as the configuration says
        (``ode_init_type``); None (windsea) or a ``ParticleDefaults2D``
        overrides it (the per-layer seeding of ``init_state_layers``)."""
        cfg = self.config
        g = self.grid
        dev = self.device
        d = self.defaults if defaults == "model" else defaults
        u0, v0 = winds_at(self.winds, g.x, g.y, torch.zeros_like(g.x),
                          cfg.dtype)
        wind_speed = torch.sqrt(u0 * u0 + v0 * v0)

        land = g.mask == 0
        if d is None:
            strong = wind_speed > SQRT2
            sea = FR.get_initial_windsea(u0, v0, self.settings.timestep)
            wmin = FR.MinimalWindsea(u0, v0, self.settings.timestep)
            lne = torch.where(strong, sea.lne, wmin.lne).to(cfg.dtype)
            cgx = torch.where(strong, sea.cg_bar_x, wmin.cg_bar_x).to(cfg.dtype)
            cgy = torch.where(strong, sea.cg_bar_y, wmin.cg_bar_y).to(cfg.dtype)
            on = strong & ~land
        else:
            lne, cgx, cgy = self._reset_values(u0, v0, defaults=d)
            on = ~land

        e, mx, my = TR.particle_to_node(lne, cgx, cgy)
        state = torch.stack([e, mx, my], dim=-1) * on[..., None].to(cfg.dtype)

        zero = torch.zeros(g.x.shape, dtype=cfg.dtype, device=dev)
        particles = Particles2D(
            lne=lne, cgx=cgx, cgy=cgy, px=zero, py=zero.clone(),
            t=zero.clone(),
            dt=torch.full(g.x.shape, self.settings.dt, dtype=cfg.dtype,
                          device=dev),
            on=on)
        return ModelState2D(state=state.to(cfg.dtype), particles=particles,
                            time=torch.zeros((), dtype=cfg.dtype, device=dev),
                            iteration=torch.zeros((), dtype=torch.int32,
                                                  device=dev),
                            metrics=StepMetrics.zeros(dev))

    # ------------------------------------------------------------------
    # one model step
    # ------------------------------------------------------------------

    def step(self, ms: ModelState2D) -> ModelState2D:
        """One DT: advance -> deposit -> remesh -> tick."""
        return self.step_core(ms, self.grid, self.active_mask,
                              self.boundary_mask)

    # ------------------------------------------------------------------
    # layers
    # ------------------------------------------------------------------

    def init_state_layers(self, per_layer_defaults=None) -> ModelState2D:
        """Seed ``config.layers`` wave systems along a leading axis, the
        counters ``[L]`` too.  ``per_layer_defaults``: one
        ``ParticleDefaults2D``, None (windsea) or "model" a layer, each
        layer seeded with its own; without it every layer is a copy of
        ``init_state()``.  Every layer reseeds with the model's defaults."""
        L = self.config.layers
        if per_layer_defaults is None:
            return stack_layers([self.init_state()] * L)
        if len(per_layer_defaults) != L:
            raise ValueError(f"need {L} per-layer defaults, "
                             f"got {len(per_layer_defaults)}")
        return stack_layers([self.init_state(defaults=d)
                             for d in per_layer_defaults])

    def step_layers(self, ms: ModelState2D) -> ModelState2D:
        """One DT of every layer of a layered state (shared clock; the
        counters ``[L]`` in and out): the same step, each kernel launched
        once for all layers."""
        if ms.state.dim() != 4 or ms.state.shape[0] != self.config.layers:
            raise ValueError(f"a layered state is [{self.config.layers}, nx, "
                             f"ny, 3], got {tuple(ms.state.shape)}")
        return self.step(ms)

    def with_winds(self, winds) -> "WaveGrowth2D":
        """A model sharing this one's grid, settings, constants and config,
        forced by other winds (per-layer winds)."""
        if self._rhs_override:
            raise ValueError(
                "with_winds cannot rebuild a model constructed with a "
                "custom `rhs` (the override closes over its own winds); "
                "build the per-layer models explicitly instead.")
        return WaveGrowth2D(self.grid, winds, self.settings,
                            ode_params=self.params, constants=self.constants,
                            flags=self.flags,
                            minimal_particle=self.minimal_particle,
                            minimal_state=self.minimal_state,
                            config=self.config)

    def as_layered(self, per_layer_defaults=None,
                   per_layer_winds=None) -> "LayeredWaveGrowth2D":
        """The driver-facing layered view: ``Simulation`` and the stores
        run it as they run a model and store ``[time, layer, x, y,
        state]``."""
        return LayeredWaveGrowth2D(self, per_layer_defaults, per_layer_winds)

    def fields(self, ms: ModelState2D) -> dict:
        """The model's output fields (the reference's ``fields(model)``)."""
        return dict(State=ms.state)

    def step_core(self, ms: ModelState2D, grid: Grid2D,
                  active: torch.Tensor, boundary: torch.Tensor,
                  scatter_fn: Optional[Callable] = None,
                  reduce_counts: Optional[Callable] = None) -> ModelState2D:
        """The step over explicit (possibly block-local) grid planes and
        masks.  ``scatter_fn(xrel, yrel, chans, act) -> (planes, stats)``
        replaces the deposit (the sharded step's exchange); ``reduce_counts
        (counts, substeps_max) -> (counts, substeps_max)`` reduces the packed
        int32 counters across blocks (SUM, and MAX for ``substeps_max``).
        Everything else is elementwise and reads only ``grid``.

        Where the step runs K1 and then K6 (``fused_glue``) it is those two
        launches: the glue between them runs in their epilogues
        (``_step_fused``); everywhere else it runs in PyTorch
        (``_step_glue``)."""
        cfg = self.modes
        if cfg.remesh_mode == "fused" and scatter_fn is not None:
            raise ValueError(
                'remesh_mode="fused" is single-device only: the sharded '
                "deposit must exchange its halos between the accumulate and "
                'the remesh. Use remesh_mode="xla" or "pallas" under '
                "ShardedWaveGrowth2D.")
        kern = self.winds.kernel
        if fused_glue(cfg, None if kern is None else kern.kind, scatter_fn):
            return self._step_fused(ms, grid, active, boundary,
                                    reduce_counts)
        return self._step_glue(ms, grid, active, boundary, scatter_fn,
                               reduce_counts)

    def _step_fused(self, ms: ModelState2D, grid: Grid2D,
                    active: torch.Tensor, boundary: torch.Tensor,
                    reduce_counts: Optional[Callable] = None
                    ) -> ModelState2D:
        """The step as K1 with its epilogue (the selects, re-light, guards,
        log-energy clamp, the deposit's mask and channels), K6 with its own
        (the node state in its ``[..., nx, ny, 3]`` layout) and the clock's
        tick; both kernels add to one zeroed int32 row of counters a layer,
        which is the step's ``StepMetrics``.  The same arithmetic as
        ``_step_glue`` on this path."""
        P = ms.particles
        layered = P.lne.dim() > grid.x.dim()
        counters = torch.zeros(
            (*P.lne.shape[:1], N_COUNTERS) if layered else (N_COUNTERS,),
            dtype=torch.int32, device=P.lne.device)
        wf = self.wind_fields(grid, ms.time)
        g = advance_cuda(
            self.winds, self.consts, self.flags, self.solver, self._DT,
            (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, P.dt, None, grid.x,
            grid.y, self.projection(grid), wind_fields=wf,
            guards=Guards(P.on, active, boundary, self.remesh_params,
                          self.settings.log_energy_maximum, self.modes.halo,
                          counters))
        S, rm, _ = pic_gather_remesh(
            g.x, g.y, (g.e, g.m_x, g.m_y), g.scatter_on, grid.stats,
            self.modes.halo, self.remesh_params, g.lne, g.cgx, g.cgy, g.x,
            g.y, g.dt, g.on, active, boundary, grid.x, grid.y, ms.time,
            wind_fields=wf, counters=counters)
        particles = Particles2D(lne=rm.lne, cgx=rm.cgx, cgy=rm.cgy, px=rm.px,
                                py=rm.py, t=g.t, dt=rm.dt, on=rm.on)
        return ModelState2D(state=S, particles=particles,
                            time=ms.time + self._DT,
                            iteration=ms.iteration + 1,
                            metrics=counter_metrics(counters, reduce_counts))

    def _step_glue(self, ms: ModelState2D, grid: Grid2D,
                   active: torch.Tensor, boundary: torch.Tensor,
                   scatter_fn: Optional[Callable] = None,
                   reduce_counts: Optional[Callable] = None) -> ModelState2D:
        """The step with its glue in PyTorch: the advance (K1 or its plain
        version) and the guards (``_advance_glue``), the deposit and remesh
        (kernels or plain versions), the counters' reductions;
        ``step_core``'s arguments.  The port's pure-PyTorch twin of the JAX
        step, and the path of every configuration ``fused_glue`` leaves
        out."""
        cfg = self.modes
        sett = self.settings
        DT = self._DT
        aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)

        # a gridded wind's planes of this step, once for every kernel
        kernels = cfg.advance_mode == "cuda" or self._remesh_kernels
        wf = self.wind_fields(grid, ms.time) if kernels else ()
        proj = self.projection(grid) if cfg.advance_mode == "cuda" else None
        a = self._advance_glue(ms, grid, active, boundary, wf, proj)

        # ---------------- DEPOSIT + REMESH ----------------
        # the remesh samples the winds at the pre-tick clock time
        core = (a.lne, a.cgx, a.cgy, a.px, a.py, a.dt, a.on, active, boundary,
                grid.x, grid.y, ms.time)
        if cfg.remesh_mode == "fused" and self._remesh_kernels:
            node, rm, sc_stats = pic_gather_remesh(
                a.px, a.py, a.chans, a.scatter_on, grid.stats, cfg.halo,
                self.remesh_params, *core, wind_fields=wf)
        else:
            if scatter_fn is None:
                node, sc_stats = pic.scatter_channels(
                    a.px, a.py, a.chans, a.scatter_on, grid.stats, cfg.halo,
                    cfg.scatter_mode)
            else:
                node, sc_stats = scatter_fn(a.px, a.py, a.chans,
                                            a.scatter_on)
            if self._remesh_kernels:
                rm = remesh_cuda(self.remesh_params,
                                 tuple(c.contiguous() for c in node), *core,
                                 wind_fields=wf)
            else:
                rm = remesh_core(self.remesh_params, node, *core)
        gather = (rm.branch & GATHER_BIT) != 0
        reseed = (rm.branch & RESEED_BIT) != 0

        # Hairer dt reset for every lane whose state was replaced: the
        # estimate clamped to [dtmin, DT] where reset, the remesh's dt
        # elsewhere
        dt = rm.dt
        if sett.adaptive and cfg.dt_reset_mode == "auto":
            was_reset = a.was_reset | gather | reseed
            comps = (rm.lne, rm.cgx, rm.cgy, rm.px, rm.py)
            tols = dict(abstol=sett.abstol, reltol=sett.reltol,
                        order=self._rk_order)
            if cfg.advance_mode == "cuda":
                dt = auto_dt_cuda(self.winds, self.consts, self.flags, a.t,
                                  comps, grid.x, grid.y, proj,
                                  was_reset, dt, sett.dtmin, DT,
                                  wind_fields=wf, **tols)
            else:
                dt = auto_dt_reset(self.rhs, a.t, torch.stack(comps, dim=-1),
                                   aux, was_reset, dt, sett.dtmin, DT, **tols)

        metrics = self._build_metrics(
            reduce_counts, adv=a.adv, failed=a.failed, nan_mask=a.nan_mask,
            inf_mask=a.inf_mask, emax_mask=a.emax_mask, relight=a.relight,
            gather=gather, reseed=reseed,
            # on -> off transitions: `on` is the flag before the remesh
            off=((rm.branch & OFF_BIT) != 0) & a.on,
            clamped=sc_stats.clamped, naccept=a.naccept)

        particles = Particles2D(lne=rm.lne, cgx=rm.cgx, cgy=rm.cgy, px=rm.px,
                                py=rm.py, t=a.t, dt=dt, on=rm.on)
        S = torch.stack(node, dim=-1)
        return ModelState2D(state=S, particles=particles,
                            time=ms.time + DT,
                            iteration=ms.iteration + 1,
                            metrics=metrics)

    def _advance_glue(self, ms: ModelState2D, grid: Grid2D,
                      active: torch.Tensor, boundary: torch.Tensor, wf,
                      proj) -> GluedAdvance:
        """The first half of ``_step_glue``: the advance (K1 or its plain
        version) and the PyTorch glue up to the deposit, the selects,
        re-light, NaN and Inf guards, log-energy clamp, the deposit's mask
        and channels; ``wf`` and ``proj`` the step's wind and projection
        planes.  What K1's epilogue computes on the fused path."""
        cfg = self.modes
        sett = self.settings
        DT = self._DT
        P = ms.particles
        aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)

        # ---------------- ADVANCE ----------------
        adv = P.on & active
        comps0 = (P.lne, P.cgx, P.cgy, P.px, P.py)
        if cfg.advance_mode == "cuda":
            res = advance_cuda(self.winds, self.consts, self.flags,
                               self.solver, DT, comps0, P.t, P.dt, adv,
                               grid.x, grid.y, proj, wind_fields=wf)
            res_c = (res.lne, res.cgx, res.cgy, res.x, res.y)
        else:
            res = integrate_to(self.rhs, torch.stack(comps0, dim=-1), P.t,
                               P.t + DT, P.dt, aux, adv, self.solver)
            res_c = tuple(res.z[..., i] for i in range(5))
        failed = res.failed & adv
        lne, cgx, cgy, px, py = (torch.where(adv, rc, c0)
                                 for rc, c0 in zip(res_c, comps0))
        t = torch.where(adv, res.t, P.t)
        dt = torch.where(adv, res.dt, P.dt)
        on = P.on

        # off-particle re-light at the (lagged) end of the step
        off = ~P.on & active
        u_end, v_end = winds_at(self.winds, grid.x, grid.y, P.t + DT,
                                cfg.dtype)
        wind2_end = u_end * u_end + v_end * v_end
        relight = off & (wind2_end >= sett.wind_min_squared)

        # guards; not applied to failed lanes
        guardable = active & ~failed

        def isbad(f):
            return f(lne) | f(cgx) | f(cgy)

        nan_mask = guardable & isbad(torch.isnan)
        inf_mask = guardable & ~nan_mask & isbad(torch.isinf)
        bad = nan_mask | inf_mask

        # re-light and NaN/Inf guard both reset to the local windsea at
        # t_start + DT, positions (0, 0)
        reset_adv = relight | bad
        lne_r, cgx_r, cgy_r = self._reset_values(u_end, v_end)
        lne = torch.where(reset_adv, lne_r, lne)
        cgx = torch.where(reset_adv, cgx_r, cgx)
        cgy = torch.where(reset_adv, cgy_r, cgy)
        px = torch.where(reset_adv, 0.0, px)
        py = torch.where(reset_adv, 0.0, py)
        on = on | relight

        emax_mask = guardable & ~bad & (lne > sett.log_energy_maximum)
        lne = torch.where(emax_mask, sett.log_energy_maximum, lne)
        was_reset_adv = relight | bad | emax_mask

        bsrc = boundary if self._boundary_source else torch.zeros_like(boundary)

        # the deposit's mask and channels
        scatter_on = (on & active & ~failed) | (on & bsrc)
        e, mx, my = TR.particle_to_node(lne, cgx, cgy)
        return GluedAdvance(lne, cgx, cgy, px, py, t, dt, on, scatter_on,
                            (e, mx, my), adv, failed, nan_mask, inf_mask,
                            emax_mask, relight, was_reset_adv, res.naccept)

    @staticmethod
    def _build_metrics(reduce_counts, *, adv, failed, nan_mask, inf_mask,
                       emax_mask, relight, gather, reseed, off, clamped,
                       naccept) -> StepMetrics:
        """The counters, packed: the nine mask counts and ``n_clamped`` in
        one int32 tensor in ``StepMetrics`` order (``[10]``, ``[L, 10]``
        layered: each mask reduced over its plane), ``substeps_max`` apart,
        so a sharded step reduces them in two collectives."""
        masks = (adv, failed, nan_mask, inf_mask, emax_mask, relight, gather,
                 reseed, off)
        plane = (-2, -1)
        counts = torch.stack([torch.sum(m, dim=plane) for m in masks]
                             + [clamped.to(torch.int64)], dim=-1
                             ).to(torch.int32)
        smax = torch.amax(naccept, dim=plane).to(torch.int32)
        if reduce_counts is not None:
            counts, smax = reduce_counts(counts, smax)
        return StepMetrics(*counts.unbind(-1), substeps_max=smax)


def fused_glue(modes: WaveGrowth2DConfig, wind_kind,
               scatter_fn: Optional[Callable] = None) -> bool:
    """Whether a step runs its glue in the epilogues of K1 and K6 (its
    fused path): exactly where it runs those two kernels, with ``modes``
    (resolved: a CUDA mode only on a card) advancing on K1 and remeshing
    with K6 (single device: no ``scatter_fn``), under a wind other than
    gridded, whose re-light samples the record at each lane's own time."""
    return (modes.advance_mode == "cuda" and modes.remesh_mode == "fused"
            and scatter_fn is None and wind_kind != WindKind.GRIDDED)


def counter_metrics(counters: torch.Tensor,
                    reduce_counts: Optional[Callable] = None) -> StepMetrics:
    """The step's ``StepMetrics`` of its counters' rows (``[N_COUNTERS]``,
    or ``[L, N_COUNTERS]`` layered): the ten counts in their order, then
    ``substeps_max``, views of the rows; ``reduce_counts`` as
    ``step_core``'s."""
    counts, smax = counters[..., :-1], counters[..., -1]
    if reduce_counts is not None:
        counts, smax = reduce_counts(counts, smax)
    return StepMetrics(*counts.unbind(-1), substeps_max=smax)


def triple(d):
    """A ``ParticleDefaults2D``'s (lne, cg_x, cg_y), None for windsea."""
    return None if d is None else (d.lne, d.cg_x, d.cg_y)


def layer_of(ms: ModelState2D, i: int) -> ModelState2D:
    """Layer ``i`` of a layered state, as a single-layer state (views)."""
    return ModelState2D(
        state=ms.state[i],
        particles=Particles2D(*(x[i] for x in ms.particles.leaves())),
        time=ms.time, iteration=ms.iteration,
        metrics=StepMetrics(*(x[i] for x in ms.metrics.leaves())))


def stack_layers(parts) -> ModelState2D:
    """Single-layer states stacked into one layered state (their clock
    and iteration are the first's)."""
    def stack(cls, trees):
        return cls(*(torch.stack(xs) for xs in
                     zip(*(t.leaves() for t in trees))))

    return ModelState2D(
        state=torch.stack([p.state for p in parts]),
        particles=stack(Particles2D, [p.particles for p in parts]),
        time=parts[0].time, iteration=parts[0].iteration,
        metrics=stack(StepMetrics, [p.metrics for p in parts]))


class LayeredWaveGrowth2D(StepDrivers):
    """The driver-facing surface of a ``WaveGrowth2D`` with ``config.layers
    > 1`` (the reference's 4D State): ``init_state``, ``step`` and
    ``fields`` over ``[L, nx, ny, 3]`` states, so ``Simulation`` and its
    stores run it as they run a model and store ``[time, layer, x, y,
    state]``.

    ``per_layer_defaults`` seeds each layer (``init_state_layers``).  With
    ``per_layer_winds`` (one wind a layer) each layer is stepped by its own
    model variant (``with_winds``) on its slice of the state and the
    results are stacked: each kernel then launches once a layer.  The
    drivers replay one CUDA graph of the layered step where the models are
    graphed (``models/drivers.py``)."""

    def __init__(self, model: WaveGrowth2D, per_layer_defaults=None,
                 per_layer_winds=None):
        self.model = model
        self.per_layer_defaults = per_layer_defaults
        self.settings = model.settings
        self.grid = model.grid
        self.device = model.device
        self.layers = model.config.layers
        if per_layer_winds is not None:
            if len(per_layer_winds) != self.layers:
                raise ValueError(f"need {self.layers} per-layer winds, "
                                 f"got {len(per_layer_winds)}")
            self.layer_models = [model.with_winds(w) for w in per_layer_winds]
        else:
            self.layer_models = None
        self._graphed = all(m.graphed for m in self._models())

    def _models(self) -> list:
        return self.layer_models or [self.model]

    def graph_keep(self) -> tuple:
        """Every layer model's caches (``WaveGrowth2D.graph_keep``)."""
        return tuple(m.graph_keep() for m in self._models())

    def init_state(self) -> ModelState2D:
        if self.layer_models is not None:
            defaults = self.per_layer_defaults or ["model"] * self.layers
            return stack_layers([m.init_state(defaults=d)
                                 for m, d in zip(self.layer_models, defaults)])
        return self.model.init_state_layers(self.per_layer_defaults)

    def step(self, ms: ModelState2D) -> ModelState2D:
        if self.layer_models is not None:
            return stack_layers([m.step(layer_of(ms, i))
                                 for i, m in enumerate(self.layer_models)])
        return self.model.step_layers(ms)

    def fields(self, ms: ModelState2D) -> dict:
        return dict(State=ms.state)
