"""Cartesian 2D grid (PyTorch port of ``picles_tpu/grids/cartesian.py``).

The projection kernel converting m/s into grid-index/s is materialized as a
per-node [2, 2] tensor, constant over the grid.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .base import Boundary, Grid2D, GridStats
from .mask import make_boundaries


def projection_kernel_cartesian(dx: float, dy: float, angle_deg: float) -> np.ndarray:
    """Projection m/s -> grid-index/s for a grid whose i-axis is rotated
    ``angle`` degrees from physical x: M = [[c/dx, s/dx], [-s/dy, c/dy]]
    (the JAX package's corrected rotated form)."""
    if angle_deg == 0.0:
        return np.array([[1.0 / dx, 0.0], [0.0, 1.0 / dy]])
    c = math.cos(angle_deg * math.pi / 180.0)
    s = math.sin(angle_deg * math.pi / 180.0)
    return np.array([[c / dx, s / dx], [-s / dy, c / dy]])


def cartesian_grid_2d(xmin: float, xmax: float, nx: int,
                      ymin: float, ymax: float, ny: int, *,
                      device, dtype=torch.float32,
                      mask: Optional[np.ndarray] = None,
                      total_mask: Optional[np.ndarray] = None,
                      angle: float = 0.0,
                      periodic_boundary: Tuple[bool, bool] = (False, False)
                      ) -> Grid2D:
    """``nx`` points span [xmin, xmax] inclusive; dx = (xmax - xmin)/(nx - 1).
    The planes are built in float64 with numpy and rounded once to
    ``dtype``, as the JAX package builds them."""
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    bx = Boundary.PERIODIC if periodic_boundary[0] else Boundary.NONPERIODIC
    by = Boundary.PERIODIC if periodic_boundary[1] else Boundary.NONPERIODIC

    x = np.linspace(xmin, xmax, nx)
    y = np.linspace(ymin, ymax, ny)
    XX, YY = np.meshgrid(x, y, indexing="ij")

    if total_mask is None:
        if mask is None:
            mask = np.ones((nx, ny), dtype=bool)
        total_mask = make_boundaries(mask, bx, by)
    total_mask = np.asarray(total_mask, dtype=np.int32)

    M = projection_kernel_cartesian(dx, dy, angle)
    proj = np.ascontiguousarray(np.broadcast_to(M, (nx, ny, 2, 2)))
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def t(a):
        return torch.as_tensor(np.asarray(a, np_dtype), device=device)

    def full(v):
        return torch.full((nx, ny), float(np_dtype.type(v)), dtype=dtype,
                          device=device)

    stats = GridStats(nx=nx, ny=ny, bx=bx, by=by, xmin=xmin, xmax=xmax,
                      ymin=ymin, ymax=ymax, dx=dx, dy=dy, angle=angle,
                      kind="cartesian")
    return Grid2D(
        x=t(XX), y=t(YY), dx_m=full(dx), dy_m=full(dy), area=full(dx * dy),
        angle=full(angle * math.pi / 180.0),
        mask=torch.as_tensor(total_mask, device=device),
        proj=t(proj), pc=full(0.0), stats=stats)


def cartesian_box(dimx: float, nx: int, dimy: float, ny: int, *,
                  device, dtype=torch.float32, angle: float = 0.0,
                  periodic_boundary: Tuple[bool, bool] = (False, False)
                  ) -> Grid2D:
    """Box constructor: ``cartesian_box(100e3, 51, 100e3, 51, device=...)``."""
    return cartesian_grid_2d(0.0, dimx, nx, 0.0, dimy, ny, device=device,
                             dtype=dtype, angle=angle,
                             periodic_boundary=periodic_boundary)
