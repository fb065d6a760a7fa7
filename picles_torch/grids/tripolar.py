"""Tripolar (MOM6) grid (PyTorch port of ``picles_tpu/grids/tripolar.py``).

``mom6_grid_from_supergrid(x, y, dx, dy, area, angle_dx, k, ...)`` extracts
the stride-k C-grid points of a MOM6 supergrid and aggregates its cell
metrics onto them; ``load_mom6_grid(path, k)`` reads those arrays from a
NetCDF supergrid file (``utils/io.read_netcdf_vars``: NetCDF-4 through h5py,
NetCDF-3 through scipy, also where h5py is not installed);
``synthetic_tripolar_supergrid`` is the analytic stand-in the tests and the
card checks run on (a regular lon/lat grid below a join latitude, a rotated,
converging northern cap above it, with the north-seam mirror symmetry).

The y axis is ``TRIPOLAR_NORTH``: a deposit crossing the top row folds back
onto it with x mirrored (``ops/pic.py``, the deposit kernels' ghost rows).
The projection is the per-node rotation
``M = [[cos a/dx, sin a/dy], [-sin a/dx, cos a/dy]]`` with ``a`` the local
grid angle, and ``pc`` the great-circle coefficient at the node's latitude.
The planes are built in float64 with numpy and rounded once to ``dtype``,
as the JAX package builds them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .base import Boundary, Grid2D, GridStats
from .mask import make_boundaries, mask_circle
from .spherical import grid_of, propagation_correction_coef


# ---------------------------------------------------------------------------
# supergrid -> C-grid pipeline
# ---------------------------------------------------------------------------

def extract_grid_points(x, y, angle_dx, k: int, mask=None):
    """C-grid point extraction with stride k; returns a dict with the T, U,
    V and Q point locations, the T-point angle and the mask (or None)."""
    x = np.asarray(x)
    y = np.asarray(y)
    angle_dx = np.asarray(angle_dx)
    if x.shape != y.shape:
        raise ValueError("x and y have different shapes")
    khalf = k // 2
    ci = slice(khalf, x.shape[0], k)
    cj = slice(khalf, x.shape[1], k)
    qi = slice(0, x.shape[0], k)
    qj = slice(0, x.shape[1], k)

    out = dict(
        t_lon=x[ci, cj], t_lat=y[ci, cj],
        u_lon=x[qi, cj], u_lat=y[qi, cj],
        v_lon=x[ci, qj], v_lat=y[ci, qj],
        q_lon=x[qi, qj], q_lat=y[qi, qj],
        angle=angle_dx[ci, cj], k=k, khalf=khalf)
    if mask is not None:
        mask = np.asarray(mask)
        if k == 2:
            out["mask"] = mask == 1
        elif k in (4, 6, 8):
            out["mask"] = mask[::k // 2, ::k // 2] == 1
        else:
            raise ValueError("k must be 2, 4, 6 or 8")
    else:
        out["mask"] = None
    return out


def calculate_distances(area, dx, dy, k: int, khalf: int):
    """Aggregate supergrid cell metrics onto the stride-k T cells, with the
    north-seam mirror rows."""
    area = np.asarray(area, dtype=np.float64)
    dx = np.asarray(dx, dtype=np.float64)
    dy = np.asarray(dy, dtype=np.float64)

    tarea = sum(area[i::k, j::k] for i in range(k) for j in range(k))
    dxt = sum(dx[j::k, khalf::k] for j in range(k))
    dyt = sum(dy[khalf::k, i::k] for i in range(k))
    dxCv = sum(dx[j::k, k::k] for j in range(k))
    dyCu = sum(dy[k::k, i::k] for i in range(k))

    dxr = np.roll(dx, -khalf, axis=0)
    dxCu = sum(dxr[j::k, khalf::k] for j in range(k))

    dyr = np.roll(dy, -khalf, axis=1)
    # north seam periodicity
    dyr[:, -1] = dyr[::-1, -4]
    dyr[:, -2] = dyr[::-1, -3]
    dyCv = sum(dyr[khalf::k, i::k] for i in range(k))

    return dict(tarea=tarea, dxt=dxt, dyt=dyt, dxCv=dxCv, dyCu=dyCu,
                dxCu=dxCu, dyCv=dyCv)


def tripolar_mask_pols(mask: np.ndarray, lons, lats, dyCv,
                       radius_deg: float) -> np.ndarray:
    """Mask the three tripolar poles (the two seam poles and the centre of
    the top row) and a southern band."""
    mask = np.asarray(mask, dtype=bool).copy()
    nx, ny = mask.shape
    for pp in [(0, ny - 1), (nx - 1, ny - 1), (round(nx / 2) - 1, ny - 1)]:
        mask = mask_circle(mask, np.asarray(lons), np.asarray(lats), pp,
                           radius_deg)
    dx_deg = float(np.mean(dyCv)) / 110e3
    ny_mask = int(math.ceil(radius_deg / dx_deg))
    mask[:, :ny_mask] = False
    return mask


def mom6_grid_from_supergrid(x, y, dx, dy, area, angle_dx, k: int = 2, *,
                             device, dtype=torch.float32, mask=None,
                             total_mask=None, mask_radius=3) -> Grid2D:
    """The tripolar ``Grid2D`` of supergrid arrays (``[x, y]`` layout)."""
    G = extract_grid_points(x, y, angle_dx, k, mask=mask)
    GA = calculate_distances(area, dx, dy, G["k"], G["khalf"])

    t_lon, t_lat = G["t_lon"], G["t_lat"]
    nx, ny = t_lon.shape
    dxm, dym = GA["dxCu"], GA["dyCv"]

    m = G["mask"]
    if m is None:
        m = np.ones((nx, ny), dtype=bool)
        m = tripolar_mask_pols(m, t_lon, t_lat, dym, mask_radius)
    if total_mask is None:
        total_mask = make_boundaries(m, Boundary.PERIODIC,
                                     Boundary.TRIPOLAR_NORTH)

    ang = np.asarray(G["angle"], dtype=np.float64)
    ca, sa = np.cos(np.radians(ang)), np.sin(np.radians(ang))
    proj = np.zeros((nx, ny, 2, 2))
    proj[..., 0, 0] = ca / dxm
    proj[..., 0, 1] = sa / dym
    proj[..., 1, 0] = -sa / dxm
    proj[..., 1, 1] = ca / dym

    stats = GridStats(nx=nx, ny=ny, bx=Boundary.PERIODIC,
                      by=Boundary.TRIPOLAR_NORTH,
                      xmin=float(t_lon.min()), xmax=float(t_lon.max()),
                      ymin=float(t_lat.min()), ymax=float(t_lat.max()),
                      dx=float(np.mean(dxm)), dy=float(np.mean(dym)),
                      kind="tripolar")
    return grid_of(t_lon, t_lat, dxm, dym, GA["tarea"], np.radians(ang),
                   total_mask, proj,
                   propagation_correction_coef(np.asarray(t_lat)), stats,
                   device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# NetCDF loader
# ---------------------------------------------------------------------------

def load_mom6_grid(grid_file: str, k: int = 2, *, device,
                   mask_file: Optional[str] = None,
                   mask_radius: float = 5.0,
                   dtype=torch.float32) -> Grid2D:
    """Read a MOM6 supergrid NetCDF file (``ocean_hgrid`` style: variables
    x, y, dx, dy, area, angle_dx, stored ``[ny, nx]``) and build the grid;
    ``mask_file`` an optional NetCDF file with a ``mask`` variable."""
    from ..utils.io import read_netcdf_vars as _read

    v = _read(grid_file, ["x", "y", "dx", "dy", "area", "angle_dx"])
    arrs = {n: a.T if a.ndim == 2 else a for n, a in v.items()}
    mask = None
    if mask_file is not None:
        mask = _read(mask_file, ["mask"])["mask"].T
    return mom6_grid_from_supergrid(arrs["x"], arrs["y"], arrs["dx"],
                                    arrs["dy"], arrs["area"],
                                    arrs["angle_dx"], k, device=device,
                                    dtype=dtype, mask=mask,
                                    mask_radius=mask_radius)


# ---------------------------------------------------------------------------
# synthetic fixture
# ---------------------------------------------------------------------------

def synthetic_tripolar_supergrid(nx_super: int = 64, ny_super: int = 48, *,
                                 lat_min: float = -75.0,
                                 lat_join: float = 55.0,
                                 lat_max: float = 89.0):
    """An analytic supergrid with tripolar-like geometry: regular lon/lat
    below ``lat_join``; above it the rows rotate progressively (nonzero
    angle_dx, antisymmetric in x about the centre) and converge in dx like a
    polar cap, with the seam mirror dy[i, top] == dy[nx-1-i, top].  Returns
    (x, y, dx, dy, area, angle_dx), all ``[nx_super, ny_super]``: enough for
    the extraction pipeline, which only strides."""
    R = 6371.0e3
    xs = np.linspace(0.0, 360.0, nx_super, endpoint=False)
    ys = np.linspace(lat_min, lat_max, ny_super)
    X, Y = np.meshgrid(xs, ys, indexing="ij")

    frac = np.clip((Y - lat_join) / (lat_max - lat_join), 0.0, 1.0)
    ang = 30.0 * frac * np.sin(np.radians(X))

    dlon = 360.0 / nx_super
    dlat = (lat_max - lat_min) / (ny_super - 1)
    dx = R * np.cos(np.radians(np.clip(Y, -89.9, 89.9))) * np.radians(dlon)
    dx = np.maximum(dx, 1e3)
    dy = R * np.radians(dlat) * np.ones_like(Y)
    dy *= (1.0 - 0.3 * frac)
    dy[:, -1] = dy[::-1, -4]
    dy[:, -2] = dy[::-1, -3]
    area = dx * dy
    return X, Y, dx, dy, area, ang


def synthetic_tripolar_grid(k: int = 2, *, device, dtype=torch.float32,
                            **kw) -> Grid2D:
    """The synthetic supergrid (``kw``: its arguments) as a ``Grid2D``."""
    X, Y, dx, dy, area, ang = synthetic_tripolar_supergrid(**kw)
    return mom6_grid_from_supergrid(X, Y, dx, dy, area, ang, k,
                                    device=device, dtype=dtype)
