"""The remesh branch table, plain PyTorch version (counterpart of
``picles_tpu/ops/remesh_pallas.py`` ``remesh_core``).

Per node, after the deposit:

- **gather** the node state when the node takes part, is not a boundary
  node, and its energy and momentum reach the minimal state;
- otherwise **reseed** from the local windsea (or fixed defaults) when the
  wind at the model clock is strong enough;
- otherwise switch the particle **off**.

Gathered and reseeded particles restart at their home node; the carried dt
is clipped into ``[dtmin, DT]`` unless the solver runs fixed substeps.  The
result carries the ``on`` flag and a bitfield of the branch taken.

This is the plain version of kernel K5 (``csrc/remesh.cu``) and of the
remesh half of K6 (``csrc/pic_gather.cu``); the model's XLA remesh tail runs
it on both devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core import fetch_relations as FR
from ..forcing.winds import Winds2D
from .transforms import node_to_particle

# branch bitfield values
GATHER_BIT = 1
RESEED_BIT = 2
OFF_BIT = 4

Defaults = Optional[Tuple[float, float, float]]


class RemeshParams(NamedTuple):
    """The remesh's static parameters.

    ``defaults``: None reseeds from the local windsea, a tuple (lne, cgx,
    cgy) reseeds to fixed values.  ``bdefaults``: what boundary nodes reseed
    to: "same" (as the interior), None (windsea) or a tuple.
    ``boundary_source``: boundary nodes join the branch table (open-boundary
    inflow).  ``clip_dt``: clip the carried dt into [dtmin, timestep]
    (False in fixed-substep mode)."""

    winds: Winds2D
    defaults: Defaults
    bdefaults: Union[str, Defaults]
    boundary_source: bool
    timestep: float
    minimal_e: float
    minimal_m2: float
    wind_min_squared: float
    dtmin: float
    clip_dt: bool


class RemeshResult(NamedTuple):
    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor       # bool
    branch: torch.Tensor   # int32 bitfield (GATHER/RESEED/OFF bits)


def winds_at(winds: Winds2D, xn, yn, clock) -> Tuple[torch.Tensor, ...]:
    """(u, v) float32 planes at the clock: a 0-dim model time (planes of
    ``xn``'s shape), or one time a particle (``[L, *xn.shape]`` for layers,
    each value the one its node gives at its time)."""
    shape = torch.broadcast_shapes(xn.shape, clock.shape)
    u, v = winds(xn, yn, torch.broadcast_to(clock, shape))
    return (torch.broadcast_to(u.to(torch.float32), shape),
            torch.broadcast_to(v.to(torch.float32), shape))


def seed_values(defaults: Defaults, u, v, timestep: float):
    """(lne, cgx, cgy) planes: the windsea of (u, v) over ``timestep`` when
    ``defaults`` is None, else the fixed values."""
    if defaults is None:
        ws = FR.get_initial_windsea(u, v, timestep)
        return ws.lne, ws.cg_bar_x, ws.cg_bar_y
    return tuple(torch.full(u.shape, val, dtype=torch.float32,
                            device=u.device) for val in defaults)


def remesh_core(p: RemeshParams, node, lne, cgx, cgy, px, py, dt, on,
                active, boundary, xn, yn, clock) -> RemeshResult:
    """The branch table on ``[nx, ny]`` planes.  ``node`` = (e, m_x, m_y)
    after the deposit; ``on``/``active``/``boundary`` bool; ``clock`` the
    0-dim model time at which the winds are sampled.  ``node`` and the
    particle planes may be ``[L, nx, ny]`` (layers): the masks and the winds
    broadcast over them."""
    e_n, mx_n, my_n = node
    u, v = winds_at(p.winds, xn, yn, clock)
    wind2 = u * u + v * v
    m2_n = mx_n * mx_n + my_n * my_n
    part = (active | boundary) if p.boundary_source else active
    gather = (part & ~boundary & (e_n >= p.minimal_e)
              & (m2_n >= p.minimal_m2))
    reseed = part & ~gather & (wind2 >= p.wind_min_squared)
    go_off = part & ~gather & ~reseed

    lne_g, cgx_g, cgy_g = node_to_particle(e_n, mx_n, my_n)
    lne_s, cgx_s, cgy_s = seed_values(p.defaults, u, v, p.timestep)
    if p.bdefaults != "same":
        lne_b, cgx_b, cgy_b = seed_values(p.bdefaults, u, v, p.timestep)
        lne_s = torch.where(boundary, lne_b, lne_s)
        cgx_s = torch.where(boundary, cgx_b, cgx_s)
        cgy_s = torch.where(boundary, cgy_b, cgy_s)

    moved = gather | reseed
    dt_r = torch.clamp(dt, p.dtmin, p.timestep) if p.clip_dt else dt
    branch = (gather.to(torch.int32) * GATHER_BIT
              + reseed.to(torch.int32) * RESEED_BIT
              + go_off.to(torch.int32) * OFF_BIT)
    return RemeshResult(
        lne=torch.where(gather, lne_g, torch.where(reseed, lne_s, lne)),
        cgx=torch.where(gather, cgx_g, torch.where(reseed, cgx_s, cgx)),
        cgy=torch.where(gather, cgy_g, torch.where(reseed, cgy_s, cgy)),
        px=torch.where(moved, 0.0, px), py=torch.where(moved, 0.0, py),
        dt=dt_r, on=torch.where(part, moved, on), branch=branch)
