"""wave_growth_2d: the port's ``WaveGrowth2D`` in float32, and its plain
reference ``reference.Model``.

A configuration names its family (``"family"`` in ``configs/<config>.json``);
the family builds both sides from the configuration's keys (DT, the solver
and its tolerances, dtmin, the initial dt, the log-energy floor's wind, the
halo, the periodic boundary, the dt reset and the remesh mode), makes the
mix's members for its state and says what the comparison compares.  A model
of another family or precision is a file of its own beside this one.

A member is the windsea seeded from the wind at t = 0 (the minimal windsea
and off where the wind is below sqrt(2) m/s, as the port seeds), then
perturbed from the seed as the mix's ``pool`` says: log-energy plus N(0,
``lne_sigma``), each group-velocity component times U(``cg_scale``),
positions U(``p_range``) cells, the carried dt U(``dt_range``) s, and a
share ``active_share`` of the particles active.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from wavebench import generator
from wavebench import reference as R


def halo(cfg: dict):
    h = cfg["halo"]
    return h if isinstance(h, int) else tuple(tuple(p) for p in h)


def settings(cfg: dict, traffic: dict):
    """(the port's ODESettings, the reference's Settings)."""
    import picles_torch as pt

    DT = float(cfg["DT"])
    lne_min = float(R.minimal_windsea(*cfg["log_energy_minimum_wind"],
                                      DT).lne)
    prog = pt.ODESettings(
        log_energy_minimum=lne_min, saving_step=DT, timestep=DT,
        total_time=float(traffic["horizon_s"]), dt=cfg["initial_dt"],
        dtmin=cfg["dtmin"], force_dtmin=cfg["force_dtmin"],
        solver=cfg["solver"], abstol=cfg["abstol"], reltol=cfg["reltol"])
    ref = R.Settings(DT=DT, halo=halo(cfg), solver=R.Solver(
        method=cfg["solver"], abstol=cfg["abstol"], reltol=cfg["reltol"],
        dtmin=cfg["dtmin"], force_dtmin=cfg["force_dtmin"]))
    return prog, ref


def program(cfg: dict, grid, wind, prog_settings):
    """The port's model on its ``grid`` under its ``wind``."""
    import picles_torch as pt

    return pt.WaveGrowth2D(
        grid, wind, prog_settings, config=pt.WaveGrowth2DConfig(
            periodic_boundary=cfg["periodic_boundary"], halo=halo(cfg),
            dt_reset_mode=cfg["dt_reset_mode"],
            remesh_mode=cfg["remesh_mode"]))


def reference(grid: R.Grid, wind: R.Wind, ref_settings) -> R.Model:
    return R.Model(grid, wind, ref_settings)


def projected(grid: R.Grid) -> bool:
    """Whether the advance reads a projection that varies from node to
    node (a curved grid), from the reference's grid."""
    M, pc = grid.M.reshape(-1, 4), grid.pc.reshape(-1)
    return not (bool((M == M[0]).all()) and bool((pc == pc[0]).all()))


def seeded(model: R.Model) -> R.State:
    """The windsea seeded from the wind at t = 0 on every ocean node, the
    minimal windsea (and off) where the wind is at most sqrt(2) m/s."""
    g = model.grid
    DT = model.sett.DT
    u0, v0 = R.winds_at(model.wind.sample, g.x, g.y, torch.zeros_like(g.x))
    strong = torch.sqrt(u0 * u0 + v0 * v0) > R.SQRT2
    ws = R.windsea(u0, v0, DT)
    wm = R.minimal_windsea(u0, v0, DT)
    lne = torch.where(strong, ws.lne, wm.lne)
    cgx = torch.where(strong, ws.cg_x, wm.cg_x)
    cgy = torch.where(strong, ws.cg_y, wm.cg_y)
    on = strong & (g.mask != 0)
    zero = torch.zeros_like(lne)
    return R.State(lne=lne, cgx=cgx, cgy=cgy, px=zero, py=zero.clone(),
                   t=zero.clone(), dt=zero.clone(), on=on, S=None,
                   time=torch.zeros((), device=lne.device))


def members(spec: dict, model: R.Model, seed: int):
    """The mix's members (``reference.State``), one at a time, each from
    its own stream of the seed."""
    base = seeded(model)
    dev = base.lne.device
    for k in range(int(spec["members"])):
        gen = generator.generator(seed, dev, 2, k)

        def unif(lo_hi):
            lo, hi = lo_hi
            return lo + (hi - lo) * torch.rand(base.lne.shape, generator=gen,
                                               device=dev)

        lne = base.lne + spec["lne_sigma"] * torch.randn(
            base.lne.shape, generator=gen, device=dev)
        cgx = base.cgx * unif(spec["cg_scale"])
        cgy = base.cgy * unif(spec["cg_scale"])
        px, py = unif(spec["p_range"]), unif(spec["p_range"])
        dt = unif(spec["dt_range"])
        on = base.on & (torch.rand(base.lne.shape, generator=gen, device=dev)
                        < spec["active_share"])
        e, mx, my = R.particle_to_node(lne, cgx, cgy)
        S = torch.stack([e, mx, my], dim=-1) * on[..., None].to(e.dtype)
        yield R.State(lne=lne, cgx=cgx, cgy=cgy, px=px, py=py,
                      t=torch.zeros_like(lne), dt=dt, on=on, S=S,
                      time=torch.zeros((), device=dev))


def program_state(s: R.State):
    """A member as the port's ``ModelState2D`` (its own tensors)."""
    import picles_torch as pt

    dev = s.lne.device
    return pt.ModelState2D(
        state=s.S.clone(),
        particles=pt.Particles2D(*(x.clone() for x in (
            s.lne, s.cgx, s.cgy, s.px, s.py, s.t, s.dt, s.on))),
        time=s.time.clone(),
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
        metrics=pt.StepMetrics.zeros(dev))


def final(s: R.State) -> torch.Tensor:
    """What the comparison reads of a reference state: the node state
    ``[nx, ny, 3]``, (E, m_x, m_y)."""
    return s.S


def compared(port_final, ref_final: R.State):
    """(the port's, the reference's) final node state."""
    return port_final.state, final(ref_final)


def control(ref: R.Model, member: R.State, steps: int) -> R.State:
    """The control: the reference with its particle and node state rounded
    to bfloat16 after every step (the nearest precision below float32 with
    no matmul to put in TF32)."""
    return ref.run(member, steps, state_round=torch.bfloat16)[0]


def witness(ref: R.Model, member: R.State, steps: int) -> R.State:
    """The reference from the member with its log-energy one ulp up: how
    far the configuration itself carries a last-ulp difference."""
    lne = torch.nextafter(member.lne, torch.full_like(member.lne, math.inf))
    return ref.run(dataclasses.replace(member, lne=lne), steps)[0]
