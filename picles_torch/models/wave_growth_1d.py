"""WaveGrowth1D: the 1D growth-curve model (PyTorch port of
``picles_tpu/models/wave_growth_1d.py``), the B01 regression path that
holds the physics against the Dulov et al. 2020 duration-limited growth
law.

It differs from the 2D model in these ways:

- a particle is ``[lne, cg_x, x]`` with x absolute, in meters, on a regular
  ``Grid1D``;
- the node state is ``(e, m_x, 0)`` with ``m_x = E / (2 cg_x)``, signed;
- the deposit is the sign-merge CIC (``pic.scatter_1d_merge``);
- on an open grid the two end nodes are boundary lanes: they never advance
  and are switched off;
- the e-max guard resets the whole particle to the windsea, where the 2D
  model clamps lne only.

The advance is kernel K7 (``ops/advance_cuda.advance_1d``, the port's own
kernel: the JAX package runs this loop as a device-side ``lax.while_loop``
outside Pallas) on a CUDA device, in the model's dtype (float32, or float64
as JAX jits the loop under x64: K7's double instances) and with any wind
the JAX model takes: a steady callable (its node plane in the model's
dtype, ``forcing.winds.steady_node_plane_1d``, probed once at
construction; ``constant_winds_1d`` is one), a callable that reads its
time (traced once at construction in the model's dtype,
``forcing.winds.traced_kernel_1d``, into a library of K7's traced
instances built at its first launch; one the tracer cannot lower raises,
naming the operation and ``advance_mode="torch"``) or a ``GriddedWinds1D``
record, which the model keeps.  Then every other stage of the step (the
guards, the sign-merge deposit ``pic.segment_sum``, the remesh, the plain
Hairer ``auto_dt``, the counters; each evaluates the callable itself in
torch on the device) is PyTorch on the device that never reads it back,
and ``graphed`` is true: the drivers (``step_n`` and the rest,
``models/drivers.py``) replay a CUDA graph of the step.  The plain advance
runs on a card only when the caller asks for it with
``advance_mode="torch"`` (a constructor keyword, since the JAX config has
no mode field).  The plain advance is ``tsit5.integrate_to``, which tests
on the host whether its loop is done, once an iteration, so the drivers
loop over ``step``; it is the CPU's advance.  ``advance_mode`` ("cuda" or
"torch", ``resolve_advance_1d``) says which was chosen.  The deposit sums
without atomics, so the step is deterministic on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ODESettings
from ..forcing.winds import (GriddedWinds1D, WindKernel, WindKind,
                             steady_node_plane_1d, traced_kernel_1d)
from ..grids.base import Grid1D, one_d_grid  # noqa: F401  (JAX's home of it)
from ..ops import pic
from ..ops import transforms as TR
from ..ops.advance_cuda import advance_1d, kernel_library_1d
from ..ops.rhs import TermFlags, make_rhs_consts, particle_equations_1d
from ..ops.tsit5 import METHODS, SolverConfig, auto_dt, integrate_to
from .drivers import StepDrivers
from .state import ModelState1D, Particles1D, StepMetrics

SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class ParticleDefaults1D:
    """A fixed 1D particle initial state."""

    lne: float
    cg_x: float
    x: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveGrowth1DConfig:
    """``merge_rule``: the sign-merge deposit (the reference's 1D path),
    else the additive one."""

    periodic_boundary: bool = True
    ode_init_type: Union[str, ParticleDefaults1D] = "wind_sea"
    boundary_type: str = "same"
    merge_rule: bool = True
    dtype: torch.dtype = torch.float32


ADVANCE_MODES_1D = ("auto", "cuda", "torch")


def resolve_advance_1d(device, dtype: torch.dtype,
                       wind_kind: Optional[WindKind],
                       advance_mode: str = "auto") -> str:
    """The 1D model's advance for tensors on ``device``: "cuda" (kernel K7)
    or "torch" (the plain ``integrate_to``).  "auto" is K7 on a CUDA device
    and the plain advance on the CPU; "torch" is the plain advance on
    either.  K7 takes float32 and float64 (its double instances) and a wind
    of the node, gridded or traced kind (every wind the model takes: a
    callable the tracer refuses raises before this); another dtype
    raises."""
    if advance_mode not in ADVANCE_MODES_1D:
        raise ValueError(f"advance_mode must be one of {ADVANCE_MODES_1D}, "
                         f"got {advance_mode!r}")
    on_cuda = torch.device(device).type == "cuda"
    if advance_mode == "torch" or (advance_mode == "auto" and not on_cuda):
        return "torch"
    if not on_cuda:
        raise ValueError(f'advance_mode="cuda" names kernel K7, but the '
                         f"grid's tensors are on {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernel K7 computes in float32 or float64, not "
                         f'{dtype}; pass advance_mode="torch" for the plain '
                         f"advance")
    if wind_kind not in (WindKind.NODE, WindKind.GRIDDED, WindKind.TRACED):
        raise ValueError(f"kernel K7 takes a wind of the node, gridded or "
                         f"traced kind, not {wind_kind!r}")
    return "cuda"


class WaveGrowth1D(StepDrivers):
    """The 1D model: grid, wind ``u(x, t)`` (a ``Winds1D`` or a
    ``GriddedWinds1D``, moved to the grid's device), ODE settings and
    config; exposes ``init_state`` and ``step``.  The device is the grid's.
    ``advance_mode``: "auto" | "cuda" | "torch" (``resolve_advance_1d``);
    the resolved mode and ``graphed`` are fixed when the model is built.
    """

    def __init__(self, grid: Grid1D, winds, ode_settings: ODESettings,
                 ode_params: Optional[ODEParameters] = None,
                 constants: Optional[IDConstants] = None,
                 flags: TermFlags = TermFlags(),
                 minimal_particle=None, minimal_state=None,
                 config: WaveGrowth1DConfig = WaveGrowth1DConfig(),
                 advance_mode: str = "auto"):
        self.grid = grid
        self.device = grid.device
        # a gridded record, passed directly or as its as_winds()' bound
        # sampler, moves to the grid's device
        gw = winds if isinstance(winds, GriddedWinds1D) else getattr(
            getattr(winds, "u", None), "__self__", None)
        self.gridded_winds: Optional[GriddedWinds1D] = None
        if isinstance(gw, GriddedWinds1D):
            self.gridded_winds = gw.to(self.device)
            winds = self.gridded_winds.as_winds()
        self.winds = winds
        self.settings = ode_settings
        self.config = config
        if ode_params is None:
            ode_params, constants, _ = ODEParameters.create()
        self.params = ode_params
        self.constants = constants or IDConstants.create(r_g=ode_params.r_g)
        self.flags = flags
        self.rhs = particle_equations_1d(winds.u, gamma=self.constants.gamma,
                                         params=self.params,
                                         constants=self.constants,
                                         flags=flags)

        DT = ode_settings.timestep
        dtype = config.dtype
        # the step's DT in the model's dtype, as a host float
        self._DT = float(torch.tensor(DT, dtype=dtype))
        # the minimal windsea of a (2, 0) m/s wind, in the model's dtype
        if minimal_particle is None:
            minimal_particle = FR.MinimalParticle(2.0, 0.0, DT, dtype=dtype)
        if minimal_state is None:
            minimal_state = FR.MinimalState(2.0, 0.0, DT, dtype=dtype)
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

        # the advance (resolve_advance_1d), and K7's wind: the record, a
        # steady callable's node plane or a callable's traced graph (probed
        # and traced only where K7 may run, the steady probe first)
        self._node_plane: Optional[torch.Tensor] = None
        self._traced: Optional[WindKernel] = None
        kind = None
        if self.gridded_winds is not None:
            kind = WindKind.GRIDDED
        elif advance_mode != "torch" and \
                torch.device(self.device).type == "cuda":
            self._node_plane = steady_node_plane_1d(winds, grid.x, dtype)
            if self._node_plane is not None:
                kind = WindKind.NODE
            else:
                self._traced = traced_kernel_1d(winds, self.device, dtype)
                kind = WindKind.TRACED
        self._advance_mode = resolve_advance_1d(self.device, config.dtype,
                                                kind, advance_mode)
        self._graphed = self._advance_mode == "cuda"
        if self._graphed and grid.x.dtype != dtype:
            raise ValueError(
                f"kernel K7 reads the node x in the model's dtype {dtype}, "
                f"but the grid's is {grid.x.dtype}: build the grid with "
                f'dtype={dtype}, or pass advance_mode="torch"')
        self.consts = make_rhs_consts(gamma=self.constants.gamma,
                                      params=self.params,
                                      constants=self.constants)

        bnd = torch.zeros(grid.nx, dtype=torch.bool, device=self.device)
        if not config.periodic_boundary:
            bnd[0] = bnd[-1] = True
        self.boundary_mask = bnd

        if config.ode_init_type == "mininmal":
            self.defaults: Optional[ParticleDefaults1D] = \
                ParticleDefaults1D(-11.0, 1e-3)
        elif isinstance(config.ode_init_type, ParticleDefaults1D):
            self.defaults = config.ode_init_type
        elif config.ode_init_type == "wind_sea":
            self.defaults = None
        else:
            # an unknown string (the correctly spelled "minimal" too) must
            # not fall through to windsea seeding
            raise ValueError(
                f"ode_init_type {config.ode_init_type!r}: expected "
                f"'wind_sea', 'mininmal' (sic, the reference spelling) or "
                f"ParticleDefaults1D")

        # the 1D remesh has no boundary reseed (boundary particles always
        # switch off), so boundary_type is validated and its defaults kept,
        # but they are inert, as in the reference
        if config.boundary_type == "mininmal":
            self.boundary_defaults: Optional[ParticleDefaults1D] = \
                ParticleDefaults1D(-11.0, 1e-3)
        elif config.boundary_type == "wind_sea":
            self.boundary_defaults = None
        elif config.boundary_type == "same":
            self.boundary_defaults = self.defaults
        else:
            raise ValueError("boundary_type must be 'wind_sea', 'mininmal' "
                             "or 'same'")

    @property
    def advance_mode(self) -> str:
        """"cuda" where the advance is kernel K7, else "torch"
        (``resolve_advance_1d``)."""
        return self._advance_mode

    def graph_keep(self) -> tuple:
        """K7's wind: the node plane, the record, or the traced wind and
        its library (built by the warm-up's launches)."""
        lib = (kernel_library_1d(self._traced, self.config.dtype)[0]
               if self._traced is not None else None)
        return (self._node_plane, self.gridded_winds, self._traced, lib)

    # ------------------------------------------------------------------

    def _wind(self, x, t) -> torch.Tensor:
        """The wind at nodes ``x`` and time(s) ``t``, broadcast to x's
        shape, in the model's dtype."""
        return torch.broadcast_to(self.winds.u(x, t).to(self.config.dtype),
                                  x.shape)

    def _node_wind(self, t) -> torch.Tensor:
        """The wind at the grid's nodes at time(s) ``t``: on K7's path a
        steady callable's node plane (its values there at any time), else
        ``_wind``."""
        if self._node_plane is not None:
            return self._node_plane
        return self._wind(self.grid.x, t)

    def advance(self, z, t, dt, active, span: float):
        """The particles ``(z, t, dt)`` advanced over ``span`` seconds on
        the ``active`` lanes (the step's advance over DT, and the
        sub-windows of ``utils.particle_tools.record_trajectories``): K7
        where ``advance_mode`` is "cuda", else the plain loop.  Returns
        (z, t, dt, failed, naccept)."""
        if self._advance_mode == "cuda":
            wind = (self.gridded_winds if self.gridded_winds is not None
                    else self._traced if self._traced is not None
                    else self._node_plane)
            return advance_1d(wind, self.consts, self.flags, self.solver,
                              span, z.contiguous(), t, dt, active,
                              self.grid.x)
        return integrate_to(self.rhs, z, t, t + span, dt, self.grid.x,
                            active, self.solver)

    def _reset_values(self, u, x_node) -> torch.Tensor:
        """The reseed ``[nx, 3]``: the signed windsea of the local wind, or
        the fixed defaults; the position is the node's."""
        if self.defaults is None:
            ws = FR.get_initial_windsea_1d(u, self.settings.timestep,
                                           dtype=self.config.dtype)
            z = torch.stack([ws.lne, ws.cg_bar_x, x_node], dim=-1)
        else:
            d = self.defaults
            z = torch.stack([torch.full_like(x_node, d.lne),
                             torch.full_like(x_node, d.cg_x), x_node], dim=-1)
        return z.to(self.config.dtype)

    def init_state(self) -> ModelState1D:
        """One particle a node from the wind at t = 0: the windsea where
        |u| > sqrt 2 (on), else the minimal particle of the 2-argument
        ``MinimalParticle(u, 0, DT)`` (off), as the reference's 1D seed
        calls it; fixed defaults seed every node on."""
        cfg = self.config
        x = self.grid.x
        u0 = self._wind(x, torch.zeros_like(x))
        if self.defaults is None:
            strong = torch.abs(u0) > SQRT2
            ws = FR.get_initial_windsea_1d(u0, self.settings.timestep,
                                           dtype=cfg.dtype)
            z_sea = torch.stack([ws.lne, ws.cg_bar_x, x], dim=-1)
            mp = FR.MinimalParticle(u0, torch.zeros_like(u0),
                                    self.settings.timestep, dtype=cfg.dtype)
            z_min = torch.stack([mp[..., 0], mp[..., 1], x], dim=-1)
            z = torch.where(strong[..., None], z_sea, z_min).to(cfg.dtype)
            on = strong
        else:
            z = self._reset_values(u0, x)
            on = torch.ones(x.shape, dtype=torch.bool, device=self.device)

        e, m_x = TR.particle_to_node_1d(z[..., 0], z[..., 1])
        state = torch.stack([e, m_x, torch.zeros_like(e)], dim=-1) \
            * on[..., None].to(e.dtype)
        particles = Particles1D(
            z=z, t=torch.zeros(x.shape, dtype=cfg.dtype, device=self.device),
            dt=torch.full(x.shape, self.settings.dt, dtype=cfg.dtype,
                          device=self.device),
            on=on)
        return ModelState1D(
            state=state.to(cfg.dtype), particles=particles,
            time=torch.zeros((), dtype=cfg.dtype, device=self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
            metrics=StepMetrics.zeros(self.device))

    # ------------------------------------------------------------------

    def step(self, ms: ModelState1D) -> ModelState1D:
        """One DT: advance, guards, sign-merge deposit, remesh, dt reset."""
        cfg = self.config
        sett = self.settings
        DT = self._DT
        P = ms.particles
        x_node = self.grid.x
        boundary = self.boundary_mask

        # advance the lanes that are on and not boundary lanes
        adv = P.on & ~boundary
        res = self.advance(P.z, P.t, P.dt, adv, DT)
        failed = res.failed & adv
        z = torch.where(adv[..., None], res.z, P.z)
        t = torch.where(adv, res.t, P.t)
        dt = torch.where(adv, res.dt, P.dt)
        # boundary lanes switch off
        on = P.on & ~boundary

        # off lanes re-light in the wind at the (lagged) end of the step
        off = ~P.on & ~boundary
        u_end = self._node_wind(P.t + DT)
        relight = off & (u_end * u_end >= sett.wind_min_squared)
        z = torch.where(relight[..., None], self._reset_values(u_end, x_node),
                        z)
        on = on | relight

        # guards: NaN, Inf and e-max reset the whole particle
        guardable = ~failed & ~boundary
        nan_mask = guardable & torch.isnan(z).any(dim=-1)
        inf_mask = guardable & ~nan_mask & torch.isinf(z).any(dim=-1)
        emax_mask = guardable & (z[..., 0] > sett.log_energy_maximum)
        bad = nan_mask | inf_mask | emax_mask
        z = torch.where(bad[..., None], self._reset_values(u_end, x_node), z)

        # deposit from the absolute positions
        scatter_on = on & ~failed & ~boundary
        e, m_x = TR.particle_to_node_1d(z[..., 0], z[..., 1])
        charge = torch.stack([e, m_x, torch.zeros_like(e)], dim=-1)
        st = self.grid.stats
        scatter = pic.scatter_1d_merge if cfg.merge_rule else pic.scatter_1d_add
        S = scatter(z[..., 2], charge, scatter_on, st.xmin, st.dx, st.nx,
                    cfg.periodic_boundary)

        # remesh: gather, reseed or off, the wind at the pre-tick clock
        u_i = self._node_wind(torch.broadcast_to(ms.time, t.shape))
        e_n, m_n = S[..., 0], S[..., 1]
        gather = (~boundary & (e_n >= self._minimal_e)
                  & (m_n * m_n >= self._minimal_m2))
        reseed = ~boundary & ~gather & (u_i * u_i >= sett.wind_min_squared)
        go_off = ~boundary & ~gather & ~reseed

        lne_g, cgx_g = TR.node_to_particle_1d(e_n, m_n)
        z_gather = torch.stack([lne_g, cgx_g, x_node], dim=-1)
        z = torch.where(gather[..., None], z_gather, z)
        z = torch.where(reseed[..., None], self._reset_values(u_i, x_node), z)
        on_before_remesh = on
        on = torch.where(~boundary, gather | reseed, on)

        # the Hairer estimate over every lane, taken where the particle was
        # replaced and clipped to [dtmin, DT]; fixed substeps keep dt
        was_reset = relight | bad | gather | reseed
        if sett.adaptive:
            dt_auto = auto_dt(self.rhs, t, z, x_node, order=self._rk_order,
                              abstol=sett.abstol, reltol=sett.reltol)
            dt = torch.where(was_reset,
                             torch.clamp(dt_auto, sett.dtmin, DT), dt)

        def count(m):
            return torch.sum(m).to(torch.int32)

        metrics = StepMetrics(
            n_active=count(adv), n_failed=count(failed),
            n_nan_reset=count(nan_mask), n_inf_reset=count(inf_mask),
            n_emax_clamp=count(emax_mask), n_relight=count(relight),
            n_gather=count(gather), n_reseed=count(reseed),
            # transitions only: on before the remesh, switched off by it
            n_off=count(go_off & on_before_remesh),
            n_clamped=torch.zeros((), dtype=torch.int32, device=self.device),
            substeps_max=torch.amax(res.naccept).to(torch.int32))
        return ModelState1D(state=S,
                            particles=Particles1D(z=z, t=t, dt=dt, on=on),
                            time=ms.time + DT, iteration=ms.iteration + 1,
                            metrics=metrics)
