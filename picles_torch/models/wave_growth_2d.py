"""WaveGrowth2D: one model step on tensors (PyTorch port of
``picles_tpu/models/wave_growth_2d.py``).

One model step ``DT``:

  1. ADVANCE every active particle over DT (adaptive embedded RK), then the
     guards: off-particle wind re-light, NaN/Inf windsea resets,
     log-energy clamp;
  2. DEPOSIT (E, m_x, m_y) by CIC onto the nodes, with the boundary fold;
  3. REMESH: per-node gather / reseed / off, then the dt reset;
  4. tick the clock.

Kernels: the advance runs kernel K1 (``ops/advance_cuda.py``) or its plain
version ``tsit5.integrate_to``; the deposit kernel K2 (``ops/pic_cuda.py``)
or ``pic.scatter_dense``; the Hairer dt reset (``dt_reset_mode="auto"``)
kernel K3 or ``tsit5.auto_dt``.  The remesh is elementwise PyTorch.  Every
quantity stays on the grid's device and the step never reads it back, so a
step on the card queues without host round-trips.

Not ported yet: layers, per-layer winds, the Pallas/fused remesh tails
(``remesh_mode="pallas" | "fused"``) and the sharded step's hooks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ODESettings
from ..forcing.winds import Winds2D
from ..grids.base import Boundary, Grid2D
from ..ops import pic
from ..ops import transforms as TR
from ..ops.advance_cuda import (advance_cuda, auto_dt_cuda, kernel_wind,
                                uniform_projection)
from ..ops.rhs import RHSParams, TermFlags, make_rhs_consts, particle_equations
from ..ops.tsit5 import METHODS, SolverConfig, auto_dt, integrate_to
from .drivers import StepDrivers
from .state import ModelState2D, Particles2D, StepMetrics

SQRT2 = math.sqrt(2.0)

ADVANCE_MODES = ("auto", "torch", "cuda")
SCATTER_MODES = ("auto", "dense", "dense_cuda", "xla")


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
    every reset lane) or "carry" (keep the adapted dt).  ``halo``: CIC
    displacement capacity, an int or ((x_lo, x_hi), (y_lo, y_hi)).
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
    """``cfg`` with "auto" kernel modes resolved for tensors on ``device``."""
    on_cuda = torch.device(device).type == "cuda"
    if cfg.advance_mode not in ADVANCE_MODES:
        raise ValueError(f"advance_mode must be one of {ADVANCE_MODES}, got "
                         f"{cfg.advance_mode!r}")
    if cfg.scatter_mode not in SCATTER_MODES:
        raise ValueError(f"scatter_mode must be one of {SCATTER_MODES}, got "
                         f"{cfg.scatter_mode!r}")
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


class WaveGrowth2D(StepDrivers):
    """Model: grid, winds, ODE settings and config; exposes ``init_state``
    and ``step``.  The device is the grid's."""

    def __init__(self, grid: Grid2D, winds: Winds2D,
                 ode_settings: ODESettings,
                 ode_params: Optional[ODEParameters] = None,
                 constants: Optional[IDConstants] = None,
                 flags: TermFlags = TermFlags(),
                 minimal_particle=None, minimal_state=None,
                 config: WaveGrowth2DConfig = WaveGrowth2DConfig()):
        if config.remesh_mode in ("pallas", "fused"):
            raise NotImplementedError(
                f'remesh_mode="{config.remesh_mode}" (TPU kernels K5/K6) is '
                "not ported yet: ROADMAP item 13")
        if config.remesh_mode != "xla":
            raise ValueError(f"unknown remesh_mode {config.remesh_mode!r}")
        if config.layers != 1:
            raise NotImplementedError("layers are not ported yet: ROADMAP "
                                      "item 15")
        if config.dt_reset_mode not in ("auto", "carry"):
            raise ValueError(f"unknown dt_reset_mode {config.dt_reset_mode!r}")
        self.grid = grid
        self.device = grid.device
        self.winds = winds
        self.settings = ode_settings
        self.config = config
        self.modes = resolve_modes(config, self.device)
        if ode_params is None:
            ode_params, constants, _ = ODEParameters.create()
        self.params = ode_params
        self.constants = constants or IDConstants.create(r_g=ode_params.r_g)
        self.flags = flags
        self.consts = make_rhs_consts(gamma=self.constants.gamma,
                                      constants=self.constants,
                                      params=self.params)
        self.rhs = particle_equations(
            winds.u, winds.v, gamma=self.constants.gamma, params=self.params,
            constants=self.constants, flags=flags)

        DT = ode_settings.timestep
        dtype = config.dtype
        # the minimal windsea of a (2, 2) m/s wind, as host floats of the
        # float32 values: the remesh compares against them every step
        if minimal_particle is None:
            minimal_particle = FR.MinimalParticle(2.0, 2.0, DT)
        if minimal_state is None:
            minimal_state = FR.MinimalState(2.0, 2.0, DT)
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

        if self.modes.advance_mode == "cuda":
            kernel_wind(winds)   # raises for winds outside the kernel set
            if self.uniform_proj is None:
                raise NotImplementedError(
                    "per-node projection planes (spherical/tripolar grids) "
                    "are not in the CUDA advance yet: ROADMAP item 12")

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
            bws = FR.MinimalWindsea(1.0, 1.0, 5 * 60.0)
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

    def resolved_config(self) -> WaveGrowth2DConfig:
        """``self.config`` with "auto" modes resolved for the grid's device."""
        return self.modes

    # ------------------------------------------------------------------
    # seeding
    # ------------------------------------------------------------------

    def _winds_at(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self.grid
        u, v = self.winds(g.x, g.y, t)
        shp = g.x.shape
        return (torch.broadcast_to(u.to(self.config.dtype), shp),
                torch.broadcast_to(v.to(self.config.dtype), shp))

    def _reset_values(self, u, v, defaults="model"):
        """Windsea from local winds when no defaults are set, otherwise the
        fixed defaults; returns (lne, cgx, cgy) planes."""
        dtype = self.config.dtype
        d = self.defaults if defaults == "model" else defaults
        if d is None:
            ws = FR.get_initial_windsea(u, v, self.settings.timestep)
            return (ws.lne.to(dtype), ws.cg_bar_x.to(dtype),
                    ws.cg_bar_y.to(dtype))
        return tuple(torch.full(u.shape, val, dtype=dtype, device=u.device)
                     for val in (d.lne, d.cg_x, d.cg_y))

    def init_state(self) -> ModelState2D:
        """Seed one particle per node from the winds at t = 0."""
        cfg = self.config
        g = self.grid
        dev = self.device
        d = self.defaults
        u0, v0 = self._winds_at(torch.zeros_like(g.x))
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

    def step_core(self, ms: ModelState2D, grid: Grid2D,
                  active: torch.Tensor, boundary: torch.Tensor
                  ) -> ModelState2D:
        cfg = self.modes
        sett = self.settings
        DT = float(torch.tensor(sett.timestep, dtype=cfg.dtype))
        P = ms.particles

        # ---------------- ADVANCE ----------------
        adv = P.on & active
        comps0 = (P.lne, P.cgx, P.cgy, P.px, P.py)
        if cfg.advance_mode == "cuda":
            res = advance_cuda(self.winds, self.consts, self.flags,
                               self.solver, DT, comps0, P.t, P.dt, adv,
                               grid.x, grid.y, self.uniform_proj)
            res_c = (res.lne, res.cgx, res.cgy, res.x, res.y)
        else:
            res = integrate_to(self.rhs, torch.stack(comps0, dim=-1), P.t,
                               P.t + DT, P.dt, self.aux, adv, self.solver)
            res_c = tuple(res.z[..., i] for i in range(5))
        failed = res.failed & adv
        lne, cgx, cgy, px, py = (torch.where(adv, rc, c0)
                                 for rc, c0 in zip(res_c, comps0))
        t = torch.where(adv, res.t, P.t)
        dt = torch.where(adv, res.dt, P.dt)
        on = P.on

        # off-particle re-light at the (lagged) end of the step
        off = ~P.on & active
        u_end, v_end = self._winds_at(P.t + DT)
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

        # ---------------- DEPOSIT ----------------
        scatter_on = (on & active & ~failed) | (on & bsrc)
        e, mx, my = TR.particle_to_node(lne, cgx, cgy)
        (e_n, mx_n, my_n), sc_stats = pic.scatter_channels(
            px, py, (e, mx, my), scatter_on, grid.stats, cfg.halo,
            cfg.scatter_mode)

        # ---------------- REMESH ----------------
        # winds at the pre-tick clock time
        u_i, v_i = self._winds_at(torch.broadcast_to(ms.time, t.shape))
        wind2_i = u_i * u_i + v_i * v_i

        m2_n = mx_n * mx_n + my_n * my_n
        part = active | bsrc
        gather = (part & ~boundary
                  & (e_n >= self._minimal_e)
                  & (m2_n >= self._minimal_m2))
        wind_ok = wind2_i >= sett.wind_min_squared
        reseed = part & ~gather & wind_ok
        go_off = part & ~gather & ~reseed

        lne_g, cgx_g, cgy_g = TR.node_to_particle(e_n, mx_n, my_n)
        lne_s, cgx_s, cgy_s = self._reset_values(u_i, v_i)
        if self._boundary_differs:
            lne_b, cgx_b, cgy_b = self._reset_values(
                u_i, v_i, defaults=self.boundary_defaults)
            lne_s = torch.where(boundary, lne_b, lne_s)
            cgx_s = torch.where(boundary, cgx_b, cgx_s)
            cgy_s = torch.where(boundary, cgy_b, cgy_s)

        lne = torch.where(gather, lne_g, torch.where(reseed, lne_s, lne))
        cgx = torch.where(gather, cgx_g, torch.where(reseed, cgx_s, cgx))
        cgy = torch.where(gather, cgy_g, torch.where(reseed, cgy_s, cgy))
        px = torch.where(gather | reseed, 0.0, px)
        py = torch.where(gather | reseed, 0.0, py)
        on_before_remesh = on
        on = torch.where(part, gather | reseed, on)

        # dt reset for every lane whose state was replaced
        was_reset = was_reset_adv | gather | reseed
        if not sett.adaptive:
            pass   # fixed-substep mode carries the configured dt unclipped
        elif cfg.dt_reset_mode == "carry":
            dt = torch.clamp(dt, sett.dtmin, DT)
        else:
            comps = (lne, cgx, cgy, px, py)
            if cfg.advance_mode == "cuda":
                dt_auto = auto_dt_cuda(self.winds, self.consts, self.flags, t,
                                       comps, grid.x, grid.y,
                                       self.uniform_proj, abstol=sett.abstol,
                                       reltol=sett.reltol,
                                       order=self._rk_order)
            else:
                dt_auto = auto_dt(self.rhs, t, torch.stack(comps, dim=-1),
                                  self.aux, abstol=sett.abstol,
                                  reltol=sett.reltol, order=self._rk_order)
            dt = torch.where(was_reset, torch.clamp(dt_auto, sett.dtmin, DT),
                             dt)

        metrics = self._build_metrics(
            adv=adv, failed=failed, nan_mask=nan_mask, inf_mask=inf_mask,
            emax_mask=emax_mask, relight=relight, gather=gather,
            reseed=reseed, off=go_off & on_before_remesh,
            clamped=sc_stats.clamped, naccept=res.naccept)

        particles = Particles2D(lne=lne, cgx=cgx, cgy=cgy, px=px, py=py,
                                t=t, dt=dt, on=on)
        S = torch.stack([e_n, mx_n, my_n], dim=-1)
        return ModelState2D(state=S, particles=particles,
                            time=ms.time + DT,
                            iteration=ms.iteration + 1,
                            metrics=metrics)

    @staticmethod
    def _build_metrics(*, adv, failed, nan_mask, inf_mask, emax_mask, relight,
                       gather, reseed, off, clamped, naccept) -> StepMetrics:
        def count(x):
            return torch.sum(x).to(torch.int32)

        return StepMetrics(
            n_active=count(adv), n_failed=count(failed),
            n_nan_reset=count(nan_mask), n_inf_reset=count(inf_mask),
            n_emax_clamp=count(emax_mask), n_relight=count(relight),
            n_gather=count(gather), n_reseed=count(reseed),
            n_off=count(off), n_clamped=clamped.to(torch.int32),
            substeps_max=torch.max(naccept).to(torch.int32))
