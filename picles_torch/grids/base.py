"""Grid data model (PyTorch port of ``picles_tpu/grids/base.py``).

One dataclass of dense per-node tensors for every grid family, plus a
hashable static ``GridStats``.  Every plane is ``[nx, ny]``, contiguous
along y; ``proj`` is ``[nx, ny, 2, 2]``.

Mask convention: 0 land, 1 ocean, 2 land boundary, 3 grid boundary.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Boundary(enum.IntEnum):
    """Axis boundary types."""

    PERIODIC = 0
    NONPERIODIC = 1
    TRIPOLAR_NORTH = 2


@dataclasses.dataclass(frozen=True)
class GridStats:
    """Static grid metadata."""

    nx: int
    ny: int
    bx: Boundary
    by: Boundary
    xmin: float = 0.0
    xmax: float = 0.0
    ymin: float = 0.0
    ymax: float = 0.0
    dx: float = 1.0
    dy: float = 1.0
    angle: float = 0.0
    kind: str = "cartesian"


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Dense grid: node coordinates ``x, y``, metric spacings ``dx_m, dy_m``,
    ``area``, ``angle``, int32 ``mask``, projection matrices ``proj``
    (m/s -> grid-index/s) and great-circle coefficient ``pc``."""

    x: torch.Tensor
    y: torch.Tensor
    dx_m: torch.Tensor
    dy_m: torch.Tensor
    area: torch.Tensor
    angle: torch.Tensor
    mask: torch.Tensor
    proj: torch.Tensor
    pc: torch.Tensor
    stats: GridStats = None

    @property
    def nx(self) -> int:
        return self.stats.nx

    @property
    def ny(self) -> int:
        return self.stats.ny

    @property
    def device(self) -> torch.device:
        return self.x.device

    def ocean_point_mask(self, periodic_boundary: bool) -> torch.Tensor:
        """Nodes that carry active particles: ocean plus, when the domain is
        periodic, the grid-boundary ring."""
        if periodic_boundary:
            return (self.mask == 1) | (self.mask == 3)
        return self.mask == 1

    def boundary_point_mask(self, periodic_boundary: bool) -> torch.Tensor:
        """Per-particle ``boundary`` flag: land-boundary nodes always,
        grid-boundary nodes only when the domain is non-periodic."""
        if periodic_boundary:
            return self.mask == 2
        return self.mask >= 2
