"""Spherical (lon/lat) 2D grid (PyTorch port of
``picles_tpu/grids/spherical.py``).

Metric spacings in meters come from centred differences of the coordinate
arrays with cos-latitude scaling (R = 6371 km).  The projection is the
per-node ``M = diag(1/dx_m, 1/dy_m)`` (m/s -> grid-index/s) and ``pc`` the
great-circle coefficient, so neither is uniform over the grid: the kernels
take them as per-node planes.

The planes are built in float64 with numpy, as the JAX package builds them,
and rounded once to ``dtype``: the two packages' grids are equal bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .base import Boundary, Grid2D, GridStats
from .mask import make_boundaries

EARTH_RADIUS = 6371.0e3   # meters
PC_EARTH_RADIUS = 6.3710e6  # radius used by the great-circle correction


def cal_dx_degree(XX: np.ndarray) -> np.ndarray:
    """Centred-difference lon spacing in degrees (one-sided at the edges)."""
    dx = np.zeros_like(XX)
    dx[1:-1, :] = (XX[2:, :] - XX[:-2, :]) / 2
    dx[0, :] = XX[1, :] - XX[0, :]
    dx[-1, :] = XX[-1, :] - XX[-2, :]
    return dx


def cal_dy_degree(YY: np.ndarray) -> np.ndarray:
    """Centred-difference lat spacing in degrees (one-sided at the edges)."""
    dy = np.zeros_like(YY)
    dy[:, 1:-1] = (YY[:, 2:] - YY[:, :-2]) / 2
    dy[:, 0] = YY[:, 1] - YY[:, 0]
    dy[:, -1] = YY[:, -1] - YY[:, -2]
    return dy


def cal_dx_meters(XX: np.ndarray, YY: np.ndarray) -> np.ndarray:
    """Lon spacing in meters, scaled by cos(lat)."""
    r_meridian = EARTH_RADIUS * np.cos(YY * math.pi / 180.0)
    return cal_dx_degree(XX) * math.pi / 180.0 * r_meridian


def cal_dy_meters(YY: np.ndarray) -> np.ndarray:
    """Lat spacing in meters."""
    return cal_dy_degree(YY) * math.pi / 180.0 * EARTH_RADIUS


def propagation_correction_coef(lat_deg: np.ndarray,
                                R: float = PC_EARTH_RADIUS) -> np.ndarray:
    """Great-circle steering coefficient sign(lat) min(|tan(lat)|, 60) / R,
    multiplied by cg_x in the RHS to rotate the group velocity."""
    t = np.tan(lat_deg * math.pi / 180.0)
    return np.sign(lat_deg) * np.minimum(np.sign(lat_deg) * t, 60.0) / R


def spherical_grid_2d(xmin: float, xmax: float, nx: int,
                      ymin: float, ymax: float, ny: int, *,
                      device, dtype=torch.float32,
                      mask: Optional[np.ndarray] = None,
                      total_mask: Optional[np.ndarray] = None,
                      angle: float = 0.0,
                      periodic_boundary: Tuple[bool, bool] = (False, False)
                      ) -> Grid2D:
    """A lon/lat grid, coordinates in degrees (lon = x, lat = y), ``nx``
    points spanning [xmin, xmax] inclusive."""
    dx_deg = (xmax - xmin) / (nx - 1)
    dy_deg = (ymax - ymin) / (ny - 1)
    bx = Boundary.PERIODIC if periodic_boundary[0] else Boundary.NONPERIODIC
    by = Boundary.PERIODIC if periodic_boundary[1] else Boundary.NONPERIODIC

    x = np.linspace(xmin, xmax, nx)
    y = np.linspace(ymin, ymax, ny)
    XX, YY = np.meshgrid(x, y, indexing="ij")

    dxm = cal_dx_meters(XX, YY)
    dym = cal_dy_meters(YY)

    if total_mask is None:
        if mask is None:
            mask = np.ones((nx, ny), dtype=bool)
        total_mask = make_boundaries(mask, bx, by)

    proj = np.zeros((nx, ny, 2, 2))
    proj[..., 0, 0] = 1.0 / dxm
    proj[..., 1, 1] = 1.0 / dym

    stats = GridStats(nx=nx, ny=ny, bx=bx, by=by, xmin=xmin, xmax=xmax,
                      ymin=ymin, ymax=ymax, dx=dx_deg, dy=dy_deg, angle=angle,
                      kind="spherical")
    return grid_of(XX, YY, dxm, dym, dxm * dym, np.zeros((nx, ny)),
                   total_mask, proj, propagation_correction_coef(YY), stats,
                   device=device, dtype=dtype)


def grid_of(x, y, dx_m, dy_m, area, angle, total_mask, proj, pc,
            stats: GridStats, *, device, dtype) -> Grid2D:
    """A ``Grid2D`` from float64 numpy planes, each rounded once to
    ``dtype`` on ``device`` and contiguous (a transposed NetCDF variable is
    not); the mask as int32."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def t(a, dt=np_dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    return Grid2D(x=t(x), y=t(y), dx_m=t(dx_m), dy_m=t(dy_m), area=t(area),
                  angle=t(angle), mask=t(total_mask, np.int32),
                  proj=t(proj), pc=t(pc), stats=stats)
