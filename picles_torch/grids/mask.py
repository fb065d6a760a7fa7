"""Mask utilities (numpy only; counterpart of ``picles_tpu/grids/mask.py``).

Mask convention: 0 land, 1 ocean, 2 land boundary, 3 grid boundary.
"""

from __future__ import annotations

import numpy as np

from .base import Boundary


def interior_boundary(mask: np.ndarray) -> np.ndarray:
    """Land nodes adjacent (4-neighbourhood, periodic shifts) to ocean.
    mask: bool, True = ocean."""
    mask = np.asarray(mask, dtype=bool)
    b = np.zeros_like(mask)
    for shift in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
        b |= np.roll(mask, shift, axis=(0, 1)) & ~mask
    return b


def make_boundaries(mask: np.ndarray, bx: Boundary, by: Boundary) -> np.ndarray:
    """Total mask {0 land, 1 ocean, 2 land-boundary, 3 grid-boundary}.
    Non-periodic edges are forced to 3."""
    mask = np.asarray(mask, dtype=bool)
    total = mask.astype(np.int32) + 2 * interior_boundary(mask).astype(np.int32)
    if bx == Boundary.NONPERIODIC:
        total[0, :] = 3
        total[-1, :] = 3
    if by == Boundary.NONPERIODIC:
        total[:, 0] = 3
        total[:, -1] = 3
    return total


def mask_circle(mask: np.ndarray, xx: np.ndarray, yy: np.ndarray,
                pp_ij, radius: float) -> np.ndarray:
    """Punch a circular land hole into an ocean mask; returns a new mask."""
    mask = np.asarray(mask, dtype=bool).copy()
    px, py = xx[pp_ij[0], pp_ij[1]], yy[pp_ij[0], pp_ij[1]]
    inside = (xx - px) ** 2 + (yy - py) ** 2 < radius ** 2
    mask[inside] = False
    return mask
